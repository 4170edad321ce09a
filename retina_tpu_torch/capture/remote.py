"""Remote capture artifact stores over plain REST — no cloud SDKs (port of
retina_tpu/capture/remote.py).

Reference analog: pkg/capture/outputlocation/blob.go + s3.go upload via
the Azure/AWS SDKs, and cli/cmd/capture/download.go lists+downloads from
blob storage with the storage SDK. Neither SDK is needed: a capture
artifact lifecycle is four verbs (list/upload/download/delete) over HTTP —

- :class:`BlobStore`: Azure Blob REST against a container SAS URL
  (x-ms-blob-type PUT, restype=container&comp=list, bare GET/DELETE).
  The SAS query string IS the credential, exactly like the reference's
  ``BLOB_URL`` env contract (download.go:19).
- :class:`S3Store`: S3 REST with SigV4 request signing from the standard
  AWS env credentials (AWS_ACCESS_KEY_ID/AWS_SECRET_ACCESS_KEY,
  optional AWS_SESSION_TOKEN), endpoint-overridable for S3-compatible
  stores and tests.

Both are exercised in tests against a local fake HTTP server
(tests/test_torch_capture_remote.py).
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import hmac
import os
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET

from retina_tpu_torch.log import logger

_log = logger("capture.remote")


@dataclasses.dataclass
class RemoteArtifact:
    name: str
    size: int
    last_modified: str


class RemoteStoreError(RuntimeError):
    pass


def _request(
    req: urllib.request.Request,
    timeout: float = 60.0,
    stream_to: str | None = None,
) -> bytes:
    """Run one request; with ``stream_to`` the body is streamed to that
    file path in chunks (capture tarballs can exceed the capture pod's
    memory limit — never buffer them whole)."""
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            if stream_to is None:
                return resp.read()
            import shutil

            with open(stream_to, "wb") as fh:
                shutil.copyfileobj(resp, fh, length=1 << 20)
            return b""
    except urllib.error.HTTPError as e:
        detail = e.read()[:300].decode(errors="replace")
        raise RemoteStoreError(
            f"{req.get_method()} {req.full_url.split('?')[0]}: "
            f"HTTP {e.code} {detail}"
        ) from e
    except urllib.error.URLError as e:
        raise RemoteStoreError(f"{req.full_url.split('?')[0]}: {e}") from e


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


# ---------------------------------------------------------------------------
# Azure Blob over a container SAS URL


class BlobStore:
    """Container-level SAS URL client (the BLOB_URL contract)."""

    def __init__(self, sas_url: str):
        u = urllib.parse.urlsplit(sas_url)
        if not u.scheme or not u.netloc or not u.path.strip("/"):
            raise ValueError(
                "blob SAS URL must be https://<account>/<container>?<sas>"
            )
        self.base = f"{u.scheme}://{u.netloc}{u.path.rstrip('/')}"
        self.sas = u.query

    def _url(self, name: str = "", params: str = "") -> str:
        path = f"{self.base}/{urllib.parse.quote(name)}" if name else self.base
        qs = "&".join(p for p in (params, self.sas) if p)
        return f"{path}?{qs}" if qs else path

    def list(self, prefix: str = "") -> list[RemoteArtifact]:
        out: list[RemoteArtifact] = []
        marker = ""
        while True:
            params = "restype=container&comp=list"
            if prefix:
                params += f"&prefix={urllib.parse.quote(prefix, safe='')}"
            if marker:
                params += f"&marker={urllib.parse.quote(marker, safe='')}"
            body = _request(urllib.request.Request(self._url(params=params)))
            root = ET.fromstring(body)
            for blob in root.iter():
                if _strip_ns(blob.tag) != "Blob":
                    continue
                fields = {_strip_ns(c.tag): c for c in blob}
                props = {
                    _strip_ns(c.tag): (c.text or "")
                    for c in fields.get("Properties", [])
                }
                out.append(RemoteArtifact(
                    name=fields["Name"].text or "",
                    size=int(props.get("Content-Length", 0) or 0),
                    last_modified=props.get("Last-Modified", ""),
                ))
            # Pagination: a non-empty NextMarker means more pages
            # (5000-blob page cap on real Azure).
            marker = ""
            for el in root.iter():
                if _strip_ns(el.tag) == "NextMarker":
                    marker = el.text or ""
            if not marker:
                return out

    def upload(self, name: str, src_path: str) -> str:
        size = os.path.getsize(src_path)
        with open(src_path, "rb") as fh:
            req = urllib.request.Request(
                self._url(name), data=fh, method="PUT",
                headers={"x-ms-blob-type": "BlockBlob",
                         "Content-Type": "application/octet-stream",
                         "Content-Length": str(size)},
            )
            _request(req)
        return f"{self.base}/{name}"

    def download(self, name: str, dst_path: str) -> str:
        _request(urllib.request.Request(self._url(name)), stream_to=dst_path)
        return dst_path

    def delete(self, name: str) -> None:
        _request(urllib.request.Request(self._url(name), method="DELETE"))


# ---------------------------------------------------------------------------
# S3 with SigV4


class S3Store:
    """Minimal SigV4 S3 client (PutObject/GetObject/DeleteObject/ListV2)."""

    def __init__(
        self,
        bucket: str,
        region: str = "us-east-1",
        endpoint: str = "",
        access_key: str | None = None,
        secret_key: str | None = None,
        session_token: str | None = None,
    ):
        self.bucket = bucket
        self.region = region or "us-east-1"
        self.endpoint = (
            endpoint.rstrip("/")
            or f"https://{bucket}.s3.{self.region}.amazonaws.com"
        )
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = (
            secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        )
        self.session_token = (
            session_token or os.environ.get("AWS_SESSION_TOKEN", "")
        )

    def credentialed(self) -> bool:
        return bool(self.access_key and self.secret_key)

    # -- SigV4 (AWS General Reference, "Signature Version 4") ---------
    def _sign(
        self, method: str, enc_path: str, query_pairs: list[tuple[str, str]],
        payload_hash: str, now: datetime.datetime,
    ) -> dict[str, str]:
        """``enc_path`` is the percent-encoded path EXACTLY as sent (the
        canonical URI is that encoding, not a re-encoding of it); query
        values canonicalize with '/' escaped (quote safe='')."""
        host = urllib.parse.urlsplit(self.endpoint).netloc
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        headers = {
            "host": host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        if self.session_token:
            headers["x-amz-security-token"] = self.session_token
        signed = ";".join(sorted(headers))
        canonical_query = "&".join(
            f"{urllib.parse.quote(k, safe='')}="
            f"{urllib.parse.quote(v, safe='')}"
            for k, v in sorted(query_pairs)
        )
        canonical = "\n".join([
            method,
            enc_path,
            canonical_query,
            "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
            signed,
            payload_hash,
        ])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical.encode()).hexdigest(),
        ])

        def h(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = h(h(h(h(b"AWS4" + self.secret_key.encode(), datestamp),
                  self.region), "s3"), "aws4_request")
        sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}"
        )
        headers.pop("host")  # urllib sets it; signing included it
        return headers

    _UNSIGNED = "UNSIGNED-PAYLOAD"

    def _call(
        self, method: str, key: str = "",
        query_pairs: list[tuple[str, str]] | None = None,
        data=None, content_length: int | None = None,
        stream_to: str | None = None,
    ) -> bytes:
        query_pairs = query_pairs or []
        enc_path = "/" + urllib.parse.quote(key, safe="/")
        # Streaming bodies hash as UNSIGNED-PAYLOAD (standard SigV4
        # option over HTTPS) so a multi-hundred-MB tarball never has to
        # be buffered just to compute its digest.
        if data is None:
            payload_hash = hashlib.sha256(b"").hexdigest()
        else:
            payload_hash = self._UNSIGNED
        now = datetime.datetime.now(datetime.timezone.utc)
        headers = self._sign(method, enc_path, query_pairs, payload_hash, now)
        if content_length is not None:
            headers["Content-Length"] = str(content_length)
        # Same percent-encoding as the canonical query in _sign (space ->
        # %20, never '+'): SigV4 servers recompute the canonical string
        # from the bytes on the wire, so urlencode's quote_plus would
        # break the signature for any key/prefix/token with a space.
        qs = "&".join(
            f"{urllib.parse.quote(k, safe='')}="
            f"{urllib.parse.quote(v, safe='')}"
            for k, v in query_pairs
        )
        url = f"{self.endpoint}{enc_path}" + (f"?{qs}" if qs else "")
        req = urllib.request.Request(
            url, data=data, method=method, headers=headers
        )
        return _request(req, stream_to=stream_to)

    def list(self, prefix: str = "") -> list[RemoteArtifact]:
        out: list[RemoteArtifact] = []
        token = ""
        while True:
            pairs = [("list-type", "2")]
            if prefix:
                pairs.append(("prefix", prefix))
            if token:
                pairs.append(("continuation-token", token))
            root = ET.fromstring(self._call("GET", query_pairs=pairs))
            for item in root.iter():
                if _strip_ns(item.tag) != "Contents":
                    continue
                fields = {_strip_ns(c.tag): (c.text or "") for c in item}
                out.append(RemoteArtifact(
                    name=fields.get("Key", ""),
                    size=int(fields.get("Size", 0) or 0),
                    last_modified=fields.get("LastModified", ""),
                ))
            # ListObjectsV2 pages at 1000 keys.
            token = ""
            for el in root.iter():
                if _strip_ns(el.tag) == "NextContinuationToken":
                    token = el.text or ""
            if not token:
                return out

    def upload(self, key: str, src_path: str) -> str:
        size = os.path.getsize(src_path)
        with open(src_path, "rb") as fh:
            self._call("PUT", key=key, data=fh, content_length=size)
        return f"s3://{self.bucket}/{key}"

    def download(self, key: str, dst_path: str) -> str:
        self._call("GET", key=key, stream_to=dst_path)
        return dst_path

    def delete(self, key: str) -> None:
        self._call("DELETE", key=key)
