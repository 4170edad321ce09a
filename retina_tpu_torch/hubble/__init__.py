"""Hubble-analog flow control plane (port of retina_tpu/hubble/; reference
pkg/hubble, pkg/monitoragent).

The reference's second control plane streams enriched flows over gRPC
(:4244 relay, unix socket locally) from a ring-buffer observer fed by the
monitor agent. Same architecture here:

- monitoragent: drains the plugins' external channel, fans out to
  consumers (pkg/monitoragent).
- flow: record → flow-dict decoding with identity enrichment (pkg/hubble/
  parser layer34 + seven/DNS).
- observer: fixed-capacity flow ring with follow cursors (the Cilium
  container.Ring analog) + filter evaluation.
- proto: the Cilium wire's protobuf messages, built at first use.
- server/client: the gRPC flow relay (Observer, Peer and the fleet tier's
  Fleet/Ship), on a legacy msgpack surface and the Cilium protobuf one.
- relay: the cluster relay over the agents' servers.

None of these imports ``grpc`` or ``google.protobuf`` at module import.
"""

from retina_tpu_torch.hubble.monitoragent import MonitorAgent
from retina_tpu_torch.hubble.observer import FlowObserver
from retina_tpu_torch.hubble.server import HubbleServer
