"""Node-side capture manager (copy of retina_tpu/capture/manager.py).

The flow of one capture job: capture packets through the provider (the
best available one, ``best_provider``, when none is given), collect
network metadata (best-effort command dumps), tar.gz everything and ship
it to every enabled output location.
"""

from __future__ import annotations

import datetime
import logging
import os
import subprocess
import tarfile
import tempfile

from retina_tpu_torch.capture.outputs import outputs_from_spec
from retina_tpu_torch.capture.providers import best_provider
from retina_tpu_torch.capture.translator import CaptureJob

_log = logging.getLogger("retina_tpu_torch.capture.manager")

# Metadata commands; each is best-effort: an absent tool leaves an error
# note in its file.
_METADATA_CMDS = {
    "ip-addr.txt": ["ip", "addr"],
    "ip-route.txt": ["ip", "route"],
    "iptables.txt": ["iptables-save"],
    "proc-net-dev.txt": ["cat", "/proc/net/dev"],
    "proc-net-tcp.txt": ["cat", "/proc/net/tcp"],
    "conntrack.txt": ["conntrack", "-L"],
}


class CaptureManager:
    def __init__(self, provider=None):
        self._provider = provider

    def capture_network(self, job: CaptureJob, work_dir: str) -> str:
        """Run the packet capture; returns the capture file's path."""
        provider = self._provider or best_provider()
        stamp = datetime.datetime.now().strftime("%Y%m%d%H%M%S")
        suffix = getattr(provider, "suffix", ".pcap")
        pcap = os.path.join(work_dir, f"{job.job_name()}-{stamp}{suffix}")
        _log.info("capturing on %s: provider=%s filter=%r duration=%ds",
                  job.node_name, provider.name, job.filter_expr, job.duration_s)
        provider.capture(pcap, filter_expr=job.filter_expr, duration_s=job.duration_s,
                         max_size_mb=job.max_size_mb, packet_size=job.packet_size_bytes)
        return pcap

    def collect_metadata(self, work_dir: str) -> list[str]:
        """Network state dumps, best-effort."""
        meta_dir = os.path.join(work_dir, "metadata")
        os.makedirs(meta_dir, exist_ok=True)
        written = []
        for fname, cmd in _METADATA_CMDS.items():
            path = os.path.join(meta_dir, fname)
            try:
                out = subprocess.run(cmd, capture_output=True, timeout=10).stdout
            except (OSError, subprocess.TimeoutExpired) as e:
                out = f"unavailable: {e}".encode()
            with open(path, "wb") as fh:
                fh.write(out)
            written.append(path)
        return written

    def run_job(self, job: CaptureJob) -> list[str]:
        """Capture -> metadata -> tarball -> outputs; returns the artifact
        paths."""
        with tempfile.TemporaryDirectory(prefix="retina-capture-") as wd:
            pcap = self.capture_network(job, wd)
            if job.include_metadata:
                self.collect_metadata(wd)
            tarball = os.path.join(
                wd, os.path.splitext(os.path.basename(pcap))[0] + ".tar.gz")
            with tarfile.open(tarball, "w:gz") as tf:
                tf.add(pcap, arcname=os.path.basename(pcap))
                meta_dir = os.path.join(wd, "metadata")
                if os.path.isdir(meta_dir):
                    tf.add(meta_dir, arcname="metadata")
            sinks = outputs_from_spec(job.output)
            if not sinks:
                raise RuntimeError("no enabled output location")
            return [s.output(tarball) for s in sinks]
