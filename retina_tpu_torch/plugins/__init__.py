"""Data-plane plugins (port of retina_tpu/plugins/, reference pkg/plugin).

Importing this package registers every ported plugin with the registry
(the reference's ``init()`` + ``registry.Add`` self-registration,
registry.go:42-47): the default set (packetparser, dropreason,
packetforward, dns), the conntrack GC that rides with packetparser, and the
mock plugin of the manager's tests. The host-stat plugins (tcpretrans,
linuxutil, infiniband), the socket frame codecs (framing,
externalevents), ciliumeventobserver and windows are not ported yet.
"""

from retina_tpu_torch.plugins import registry
from retina_tpu_torch.plugins.api import (
    EventSink,
    Plugin,
    QueueSink,
    UnsupportedPlatform,
)

# Self-registration imports (each module calls registry.add at import).
from retina_tpu_torch.plugins import (  # noqa: F401
    conntrack_gc,
    dns,
    dropreason,
    mockplugin,
    packetforward,
    packetparser,
)

__all__ = [
    "EventSink",
    "Plugin",
    "QueueSink",
    "UnsupportedPlatform",
    "registry",
]
