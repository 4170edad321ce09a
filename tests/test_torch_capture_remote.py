"""The port's remote capture artifact stores (``retina_tpu_torch/capture/
remote.py``), its blob and S3 outputs and the CLI's ``capture list``,
``download`` and ``delete`` verbs, against the reference's.

Every case of the reference's ``tests/test_capture_remote.py`` runs on both
packages, against a fake object store on 127.0.0.1 (``chip_smoke.
FakeStorage``, one server per dialect, lists paged at two names). The port
is held to the reference on the same inputs: byte-equal SigV4 headers at a
fixed clock, the same requests on the wire, and the same exit codes and
output of the CLI verbs over the same store."""

from __future__ import annotations

import datetime
import hashlib
import os
import urllib.request

import pytest

from _torch_kube import IMPLS, mod
from chip_smoke import FakeStorage


@pytest.fixture
def storage():
    servers: list[FakeStorage] = []

    def make(dialect: str) -> FakeStorage:
        servers.append(FakeStorage(dialect))
        return servers[-1]

    yield make
    for s in servers:
        s.close()


def remote(impl):
    return mod(impl, "capture.remote")


def outputs(impl):
    return mod(impl, "capture.outputs")


def cli(impl):
    return mod(impl, "cli")


# -- the blob store ------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_blob_full_lifecycle(impl, storage, tmp_path):
    st = storage("blob")
    store = remote(impl).BlobStore(f"{st.url}/captures?sv=2024&sig=abc")
    src = tmp_path / "cap-node1.tar.gz"
    src.write_bytes(b"pcap-bytes" * 100)
    assert store.upload("cap-node1.tar.gz", str(src)).endswith("/captures/cap-node1.tar.gz")
    # The SAS query rides every request: it is the credential.
    assert all("sig=abc" in p for _, p, _ in st.requests)
    assert [(a.name, a.size) for a in store.list(prefix="cap-")] == [("cap-node1.tar.gz", 1000)]
    dst = store.download("cap-node1.tar.gz", str(tmp_path / "out.tgz"))
    assert (tmp_path / "out.tgz").read_bytes() == src.read_bytes()
    assert dst == str(tmp_path / "out.tgz")
    store.delete("cap-node1.tar.gz")
    assert store.list() == []


@pytest.mark.parametrize("impl", IMPLS)
def test_blob_upload_sets_block_blob_header(impl, storage, tmp_path):
    st = storage("blob")
    f = tmp_path / "a.tar.gz"
    f.write_bytes(b"x")
    remote(impl).BlobStore(f"{st.url}/captures?sig=s").upload("a.tar.gz", str(f))
    method, _, headers = st.requests[-1]
    assert method == "PUT"
    assert {k.lower(): v for k, v in headers.items()}.get("x-ms-blob-type") == "BlockBlob"


@pytest.mark.parametrize("impl", IMPLS)
def test_blob_http_error_surfaces(impl, storage, tmp_path):
    r = remote(impl)
    store = r.BlobStore(f"{storage('blob').url}/captures?sig=s")
    with pytest.raises(r.RemoteStoreError, match="404"):
        store.download("missing.tar.gz", str(tmp_path / "x"))


@pytest.mark.parametrize("impl", IMPLS)
def test_blob_rejects_container_less_url(impl):
    with pytest.raises(ValueError):
        remote(impl).BlobStore("https://acct.blob.core.windows.net/?sig=s")


@pytest.mark.parametrize("impl", IMPLS)
def test_blob_list_follows_next_marker(impl, storage, tmp_path):
    store = remote(impl).BlobStore(f"{storage('blob').url}/captures?sig=p")
    f = tmp_path / "a"
    f.write_bytes(b"1")
    for i in range(5):
        store.upload(f"cap-{i}.tar.gz", str(f))
    assert len(store.list(prefix="cap-")) == 5


@pytest.mark.parametrize("impl", IMPLS)
def test_unreachable_store_raises_remote_store_error(impl):
    r = remote(impl)
    with pytest.raises(r.RemoteStoreError, match="127.0.0.1:1"):
        r.BlobStore("http://127.0.0.1:1/c?sig=s").list()


# -- the S3 store -------------------------------------------------------------
def s3(impl, url, **kw):
    return remote(impl).S3Store("caps", "us-west-2", endpoint=url, access_key="AKIATEST",
                                secret_key="secret", **kw)


@pytest.mark.parametrize("impl", IMPLS)
def test_s3_full_lifecycle(impl, storage, tmp_path):
    store = s3(impl, storage("s3").url)
    src = tmp_path / "cap.tar.gz"
    src.write_bytes(b"data" * 64)
    assert store.upload("retina/captures/cap.tar.gz", str(src)) == \
        "s3://caps/retina/captures/cap.tar.gz"
    assert [(a.name, a.size) for a in store.list(prefix="retina/")] == [
        ("retina/captures/cap.tar.gz", 256)]
    store.download("retina/captures/cap.tar.gz", str(tmp_path / "back.tgz"))
    assert (tmp_path / "back.tgz").read_bytes() == src.read_bytes()
    store.delete("retina/captures/cap.tar.gz")
    assert store.list() == []


@pytest.mark.parametrize("impl", IMPLS)
def test_s3_requests_are_sigv4_signed(impl, storage, tmp_path):
    st = storage("s3")
    f = tmp_path / "a.tgz"
    f.write_bytes(b"y")
    s3(impl, st.url).upload("a.tgz", str(f))
    headers = {k.lower(): v for k, v in st.requests[-1][2].items()}
    auth = headers.get("authorization", "")
    assert auth.startswith("AWS4-HMAC-SHA256 Credential=AKIATEST/")
    assert "us-west-2/s3/aws4_request" in auth and "Signature=" in auth
    assert "x-amz-content-sha256" in headers and "x-amz-date" in headers


@pytest.mark.parametrize("impl", IMPLS)
def test_s3_credentialed_gate(impl, monkeypatch):
    for var in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_SESSION_TOKEN"):
        monkeypatch.delenv(var, raising=False)
    r = remote(impl)
    assert not r.S3Store("b").credentialed()
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "k")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "s")
    assert r.S3Store("b").credentialed()
    assert r.S3Store("b", region="").endpoint == "https://b.s3.us-east-1.amazonaws.com"


@pytest.mark.parametrize("impl", IMPLS)
def test_s3_list_follows_continuation_token(impl, storage, tmp_path):
    store = remote(impl).S3Store("b", "r", endpoint=storage("s3").url, access_key="k",
                                 secret_key="s")
    f = tmp_path / "a"
    f.write_bytes(b"1")
    for i in range(5):
        store.upload(f"p/cap-{i}.tar.gz", str(f))
    assert len(store.list(prefix="p/")) == 5


@pytest.mark.parametrize("impl", IMPLS)
def test_s3_wire_query_matches_sigv4_canonical_encoding(impl, monkeypatch):
    """The query on the wire has the canonical query's percent-encoding
    (space -> %20, '+' -> %2B, '/' -> %2F), never quote_plus's '+'."""
    r = remote(impl)
    seen: list[str] = []

    def fake_request(req: urllib.request.Request, stream_to=None):
        seen.append(req.full_url)
        return b"<?xml version='1.0'?><ListBucketResult></ListBucketResult>"

    monkeypatch.setattr(r, "_request", fake_request)
    r.S3Store("b", region="r", endpoint="http://127.0.0.1:1", access_key="k",
              secret_key="s").list(prefix="my captures/file+name v2")
    assert len(seen) == 1
    q = seen[0].split("?", 1)[1]
    assert "prefix=my%20captures%2Ffile%2Bname%20v2" in q and "+" not in q


SIGN_CASES = [
    ("PUT", "/retina/captures/cap-a-node1.tar.gz", [], "UNSIGNED-PAYLOAD", ""),
    ("GET", "/", [("list-type", "2"), ("prefix", "my captures/x+y"),
                  ("continuation-token", "a/b c")], hashlib.sha256(b"").hexdigest(), ""),
    ("DELETE", "/k%20with%20space", [], hashlib.sha256(b"").hexdigest(), "session/tok+en"),
]


@pytest.mark.parametrize("case", range(len(SIGN_CASES)))
def test_sigv4_headers_are_byte_equal_to_the_reference(case):
    method, path, pairs, payload, token = SIGN_CASES[case]
    now = datetime.datetime(2026, 10, 18, 12, 34, 56, tzinfo=datetime.timezone.utc)
    headers = {impl: remote(impl).S3Store(
        "caps", "eu-central-1", endpoint="https://caps.s3.example:8443", access_key="AKIAX",
        secret_key="wJalr/K7MDENG", session_token=token)._sign(method, path, pairs, payload, now)
        for impl in IMPLS}
    assert headers["port"] == headers["reference"]
    assert headers["port"]["Authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=AKIAX/20261018/eu-central-1/s3/aws4_request, "
        "SignedHeaders=host;x-amz-content-sha256;x-amz-date")
    assert ("x-amz-security-token" in headers["port"]) == bool(token)


def test_requests_on_the_wire_equal_the_reference(storage, tmp_path, monkeypatch):
    """One lifecycle through each package's stores at a fixed clock: the
    same methods, paths and headers reach the server."""
    fixed = datetime.datetime(2026, 1, 2, 3, 4, 5, tzinfo=datetime.timezone.utc)

    class Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return fixed

    f = tmp_path / "cap-x-node1.tar.gz"
    f.write_bytes(b"abc" * 10)
    wire = {}
    blob, s3st = storage("blob"), storage("s3")  # one endpoint: the signatures cover it
    for impl in IMPLS:
        monkeypatch.setattr(remote(impl).datetime, "datetime", Clock)
        for st in (blob, s3st):
            st.store.clear()
            st.requests.clear()
        stores = (remote(impl).BlobStore(f"{blob.url}/c?sig=q"), s3(impl, s3st.url))
        for store in stores:
            for i in range(3):
                store.upload(f"p/cap-{i}.tar.gz", str(f))
            store.list(prefix="p/")
            store.download("p/cap-1.tar.gz", str(tmp_path / f"{impl}.tgz"))
            store.delete("p/cap-0.tar.gz")
        wire[impl] = [[(m, p.replace(st.url, ""), {k: v for k, v in h.items()
                                                   if k.lower() not in ("host", "user-agent")})
                       for m, p, h in st.requests] for st in (blob, s3st)]
    monkeypatch.undo()
    assert wire["port"] == wire["reference"]
    assert len(wire["port"][0]) == 3 + 2 + 1 + 1


# -- the outputs ---------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_blob_output_uploads(impl, storage, tmp_path):
    st = storage("blob")
    out = outputs(impl).BlobOutput(f"{st.url}/captures?sig=q")
    assert out.enabled()
    f = tmp_path / "cap.tar.gz"
    f.write_bytes(b"z")
    assert out.output(str(f)).endswith("/captures/cap.tar.gz")
    assert st.store["cap.tar.gz"] == b"z"


@pytest.mark.parametrize("impl", IMPLS)
def test_s3_output_uploads(impl, storage, tmp_path, monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "k")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "s")
    st = storage("s3")
    out = outputs(impl).S3Output("caps", "us-east-1", endpoint=st.url)
    assert out.enabled()
    f = tmp_path / "cap.tar.gz"
    f.write_bytes(b"w")
    assert out.output(str(f)) == "s3://caps/retina/captures/cap.tar.gz"
    assert st.store["retina/captures/cap.tar.gz"] == b"w"


@pytest.mark.parametrize("impl", IMPLS)
def test_outputs_from_spec_enables_remote_sinks(impl, monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "k")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "s")
    sinks = outputs(impl).outputs_from_spec({
        "blob_upload_secret": "https://acct/captures?sig=x",
        "s3_upload": {"bucket": "b", "region": "r"}})
    assert {s.name for s in sinks} == {"blob", "s3"}


# -- the CLI's capture verbs --------------------------------------------------
def run(impl, argv, capsys):
    args = cli(impl).build_parser().parse_args(argv)
    rc = args.fn(args)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("impl", IMPLS)
def test_list_download_delete_blob(impl, storage, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("BLOB_URL", raising=False)
    sas = f"{storage('blob').url}/captures?sig=x"
    store = remote(impl).BlobStore(sas)
    f = tmp_path / "cap-a-node1.tar.gz"
    f.write_bytes(b"one")
    store.upload("cap-a-node1.tar.gz", str(f))
    store.upload("cap-a-node2.tar.gz", str(f))
    rc, out, _ = run(impl, ["capture", "list", "--blob-url", sas], capsys)
    assert rc == 0 and "cap-a-node1.tar.gz" in out and "cap-a-node2.tar.gz" in out
    dl = tmp_path / "dl"
    dl.mkdir()
    rc, _, _ = run(impl, ["capture", "download", "--blob-url", sas, "--file", "cap-a",
                          "--output", str(dl)], capsys)
    assert rc == 0
    assert sorted(p.name for p in dl.iterdir()) == ["cap-a-node1.tar.gz", "cap-a-node2.tar.gz"]
    rc, _, _ = run(impl, ["capture", "delete", "--blob-url", sas, "--file", "cap-a"], capsys)
    assert rc == 0 and store.list() == []


@pytest.mark.parametrize("impl", IMPLS)
def test_blob_url_env_fallback(impl, storage, tmp_path, capsys, monkeypatch):
    sas = f"{storage('blob').url}/captures?sig=env"
    monkeypatch.setenv("BLOB_URL", sas)
    f = tmp_path / "c.tar.gz"
    f.write_bytes(b"v")
    remote(impl).BlobStore(sas).upload("c.tar.gz", str(f))
    rc, out, _ = run(impl, ["capture", "list"], capsys)
    assert rc == 0 and "c.tar.gz" in out


@pytest.mark.parametrize("impl", IMPLS)
def test_download_no_match_fails(impl, storage, capsys, monkeypatch):
    monkeypatch.delenv("BLOB_URL", raising=False)
    rc, _, err = run(impl, ["capture", "download", "--blob-url",
                            f"{storage('blob').url}/captures?sig=x", "--file", "nope"], capsys)
    assert rc == 1 and "no remote artifacts match" in err


@pytest.mark.parametrize("impl", IMPLS)
def test_no_location_errors_instead_of_cwd_delete(impl, tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("BLOB_URL", raising=False)
    victim = tmp_path / "precious.tar.gz"
    victim.write_bytes(b"keep me")
    monkeypatch.chdir(tmp_path)
    rc, _, err = run(impl, ["capture", "delete", "--file", "precious.tar.gz"], capsys)
    assert rc == 2 and victim.exists() and "no capture location" in err


@pytest.mark.parametrize("impl", IMPLS)
def test_explicit_host_path_beats_blob_url_env(impl, storage, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BLOB_URL", f"{storage('blob').url}/captures?sig=e")
    (tmp_path / "local.tar.gz").write_bytes(b"x")
    rc, out, _ = run(impl, ["capture", "list", "--host-path", str(tmp_path)], capsys)
    assert rc == 0 and "local.tar.gz" in out


@pytest.mark.parametrize("impl", IMPLS)
def test_download_creates_output_dir(impl, storage, tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("BLOB_URL", raising=False)
    sas = f"{storage('blob').url}/captures?sig=d"
    f = tmp_path / "cap.tar.gz"
    f.write_bytes(b"z")
    remote(impl).BlobStore(sas).upload("cap.tar.gz", str(f))
    dst = tmp_path / "new" / "dir"
    rc, _, _ = run(impl, ["capture", "download", "--blob-url", sas, "--file", "cap",
                          "--output", str(dst)], capsys)
    assert rc == 0 and (dst / "cap.tar.gz").read_bytes() == b"z"


def test_capture_verbs_print_what_the_reference_prints(storage, tmp_path, capsys, monkeypatch):
    """list, download and delete over the blob store, the S3 store (with
    its key prefix) and a host path, and their refusals: the same exit
    codes, the same output and the same store afterwards."""
    monkeypatch.delenv("BLOB_URL", raising=False)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "k")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "s")
    art = tmp_path / "art.tar.gz"
    art.write_bytes(b"artifact" * 9)
    got = {}
    for impl in IMPLS:
        blob, s3st = storage("blob"), storage("s3")
        host = tmp_path / impl / "host"
        host.mkdir(parents=True)
        for n in ("cap-a-node1.tar.gz", "cap-a-node2.tar.gz", "cap-b-node1.tar.gz"):
            (host / n).write_bytes(b"h")
            blob.store[n] = b"b" * len(n)
            s3st.store[f"team/x/{n}"] = b"s"
        s3st.store["elsewhere/cap-a.tar.gz"] = b"o"
        out_dir = tmp_path / impl / "dl"
        where = {
            "blob": ["--blob-url", f"{blob.url}/c?sig=1"],
            "s3": ["--s3-bucket", "caps", "--s3-region", "r", "--s3-prefix", "team/x/",
                   "--s3-endpoint", s3st.url],
            "host": ["--host-path", str(host)],
        }
        trace = []
        for name, loc in where.items():
            for argv in (["list"], ["list", "--prefix", "cap-b"],
                         ["download", "--file", "cap-a", "--output", str(out_dir / name)],
                         ["download", "--file", "missing"],
                         ["delete", "--file", "cap-b-node1.tar.gz"], ["delete", "--file", "zzz"],
                         ["list"]):
                rc, out, err = run(impl, ["capture", *argv, *loc], capsys)
                trace.append((name, argv[0], rc, out.replace(str(tmp_path / impl), "<t>")
                              .replace(blob.url, "<blob>").replace(s3st.url, "<s3>"),
                              err.replace(str(tmp_path / impl), "<t>")))
        trace.append(run(impl, ["capture", "list"], capsys))
        trace.append(sorted(os.listdir(out_dir / "blob")) + sorted(os.listdir(out_dir / "s3")))
        trace.append((sorted(blob.store), sorted(s3st.store), sorted(os.listdir(host))))
        got[impl] = trace
    port, ref = got["port"], got["reference"]
    # Host-path listings carry each file's mtime; drop the column.
    strip = [(n, v, rc, "\n".join(line.rsplit("\t", 1)[0] for line in out.splitlines())
              if n == "host" else out, err) for n, v, rc, out, err in port[:-3]]
    strip_ref = [(n, v, rc, "\n".join(line.rsplit("\t", 1)[0] for line in out.splitlines())
                  if n == "host" else out, err) for n, v, rc, out, err in ref[:-3]]
    assert strip == strip_ref and port[-3:] == ref[-3:]
    assert port[-3][0] == 2 and "no capture location" in port[-3][2]
    assert [x[2] for x in strip[:7]] == [0, 0, 0, 1, 0, 1, 0]
