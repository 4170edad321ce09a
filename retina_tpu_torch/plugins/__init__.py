"""Data-plane plugins (port of retina_tpu/plugins/, reference pkg/plugin).

Importing this package registers every ported plugin with the registry
(the reference's ``init()`` + ``registry.Add`` self-registration,
registry.go:42-47): the default set (packetparser, dropreason,
packetforward, dns), the conntrack GC that rides with packetparser, the
host-stat plugins (linuxutil, tcpretrans, infiniband), the socket feeds
(externalevents over ``framing.py``'s record frames, ciliumeventobserver
over Cilium's gob monitor stream) and the mock plugin of the manager's
tests. Name the others in ``enabled_plugins`` to run them. The Windows
plugins (windows.py) are not ported (ROADMAP §1 item 7).
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
    ciliumeventobserver,
    conntrack_gc,
    dns,
    dropreason,
    externalevents,
    infiniband,
    linuxutil,
    mockplugin,
    packetforward,
    packetparser,
    tcpretrans,
)

__all__ = [
    "EventSink",
    "Plugin",
    "QueueSink",
    "UnsupportedPlatform",
    "registry",
]
