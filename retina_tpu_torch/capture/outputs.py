"""Capture output locations (copy of the host-path output of
retina_tpu/capture/outputs.py; the PVC, blob and S3 outputs are not
ported yet)."""

from __future__ import annotations

import logging
import os
import shutil

_log = logging.getLogger("retina_tpu_torch.capture.output")


class HostPathOutput:
    """Copy the artifact into a directory of the node."""

    name = "hostpath"

    def __init__(self, path: str):
        self.path = path

    def enabled(self) -> bool:
        return bool(self.path)

    def output(self, src_file: str) -> str:
        os.makedirs(self.path, exist_ok=True)
        dst = os.path.join(self.path, os.path.basename(src_file))
        shutil.copy2(src_file, dst)
        _log.info("capture artifact: %s", dst)
        return dst


def outputs_from_spec(output: dict) -> list:
    """The enabled output sinks of a CaptureOutput-shaped dict."""
    sinks = [HostPathOutput(output.get("host_path", ""))]
    return [s for s in sinks if s.enabled()]
