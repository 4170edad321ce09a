"""Capture output locations (port of retina_tpu/capture/outputs.py).

Reference analog: pkg/capture/outputlocation/ — hostPath (hostpath.go),
PVC (pvc.go), Azure blob SAS upload (blob.go), S3 (s3.go). Every location
implements {Name, Enabled, Output(srcFile)}. Blob/S3 speak the storage
REST APIs directly (capture/remote.py) instead of requiring cloud SDKs,
so Enabled() depends only on configuration (SAS URL present; bucket +
AWS env credentials present).
"""

from __future__ import annotations

import os
import shutil

from retina_tpu_torch.log import logger

_log = logger("capture.output")


class HostPathOutput:
    """outputlocation/hostpath.go."""

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


class PvcOutput(HostPathOutput):
    """outputlocation/pvc.go — a PVC is a mounted path node-side; the
    operator resolves the claim to its mount point."""

    name = "pvc"

    def __init__(self, claim: str, mount_root: str = "/mnt"):
        super().__init__(os.path.join(mount_root, claim) if claim else "")
        self.claim = claim


class BlobOutput:
    """outputlocation/blob.go — Azure blob container-SAS upload, spoken
    as plain REST (capture/remote.py) so no SDK gate exists."""

    name = "blob"

    def __init__(self, sas_url_secret: str = ""):
        self.sas_url = sas_url_secret

    def enabled(self) -> bool:
        if not self.sas_url:
            return False
        if not self.sas_url.startswith(("http://", "https://")):
            # In-cluster specs carry a Secret NAME here; the Job injects
            # the actual SAS URL as BLOB_URL env (k8s_jobs.job_manifest)
            # and the workload passes it through. A bare name reaching
            # this point means no resolution happened — disable loudly
            # rather than dial a secret name as a URL.
            _log.warning(
                "blob output %r is not a URL (unresolved secret name?); "
                "disabled", self.sas_url,
            )
            return False
        return True

    def output(self, src_file: str) -> str:
        from retina_tpu_torch.capture.remote import BlobStore

        url = BlobStore(self.sas_url).upload(
            os.path.basename(src_file), src_file
        )
        _log.info("capture artifact uploaded: %s", url)
        return url


class S3Output:
    """outputlocation/s3.go — S3 PutObject upload via SigV4 REST
    (capture/remote.py); credentials from the standard AWS env."""

    name = "s3"

    def __init__(self, bucket: str = "", region: str = "",
                 key_prefix: str = "retina/captures", endpoint: str = ""):
        self.bucket, self.region = bucket, region
        # Normalized: a user's trailing slash must not produce '//' keys
        # that the CLI verbs' prefix matching can never find.
        self.key_prefix = key_prefix.rstrip("/") or "retina/captures"
        self.endpoint = endpoint

    def _store(self):
        from retina_tpu_torch.capture.remote import S3Store

        return S3Store(self.bucket, self.region, endpoint=self.endpoint)

    def enabled(self) -> bool:
        if not self.bucket:
            return False
        if not self._store().credentialed():
            _log.warning("s3 output configured but AWS credentials missing")
            return False
        return True

    def output(self, src_file: str) -> str:
        key = f"{self.key_prefix}/{os.path.basename(src_file)}"
        url = self._store().upload(key, src_file)
        _log.info("capture artifact uploaded: %s", url)
        return url


def outputs_from_spec(output: dict) -> list:
    """Build enabled output sinks from a CaptureOutput-shaped dict."""
    sinks = [
        HostPathOutput(output.get("host_path", "")),
        PvcOutput(output.get("persistent_volume_claim", "")),
        BlobOutput(output.get("blob_upload_secret", "")),
        S3Output(**{
            k: v for k, v in (output.get("s3_upload") or {}).items()
            if k in ("bucket", "region", "key_prefix", "endpoint")
        }),
    ]
    return [s for s in sinks if s.enabled()]
