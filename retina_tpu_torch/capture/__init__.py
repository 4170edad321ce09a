"""Distributed packet-capture subsystem (port of retina_tpu/capture/;
reference pkg/capture).

- translator: Capture spec → per-node capture jobs + tcpdump filter
  synthesis (crd_to_job.go).
- manager: node-side capture execution + metadata + tarball
  (capture_manager.go).
- providers: tcpdump subprocess / netsh / AF_PACKET socket / event-stream
  replay (provider/network_capture_unix.go, network_capture_win.go).
- outputs: hostPath / PVC-path / blob / S3 sinks (outputlocation/).
- remote: the blob and S3 artifact stores over plain REST.
- managed: managed storage provisioning (outputlocation/managed/).
- k8s_jobs: one batch/v1 Job per remote node and its runner.
"""

from retina_tpu_torch.capture.manager import CaptureManager
from retina_tpu_torch.capture.translator import (
    CaptureJob,
    synthesize_filter,
    translate_capture_to_jobs,
)
