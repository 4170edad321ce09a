"""The port's capture paths (``retina_tpu_torch/capture/{translator,
providers,manager,outputs,managed}.py``) against the reference's.

Every case of the reference's translator, provider, manager, output and
managed-storage tests (``tests/test_capture_operator.py``,
``tests/test_capture_managed.py``) runs on both packages, and the port is
held to the reference on the same inputs: the same jobs (or the same
validation error) from ``translate_capture_to_jobs`` over a seeded set of
Captures, the same tcpdump command line, netsh call sequence and AF_PACKET
pcap bytes, the same replay pcap, tarball and sinks, and the same calls to
the cloud seam."""

from __future__ import annotations

import dataclasses
import os
import random
import subprocess
import tarfile
import time
import types

import numpy as np
import pytest

from _torch_kube import IMPLS, mod


def pkg(impl: str):
    """The modules of one package the tests use."""
    return types.SimpleNamespace(**{
        short: mod(impl, name) for short, name in (
            ("tr", "capture.translator"), ("pr", "capture.providers"),
            ("mg", "capture.manager"), ("out", "capture.outputs"),
            ("managed", "capture.managed"), ("crd", "crd.types"), ("common", "common"),
            ("schema", "events.schema"), ("pcap", "sources.pcapdecode"))})


def nodes3(p):
    return [p.common.RetinaNode(name=f"node{i}", ip=f"10.10.0.{i}") for i in range(3)]


def pods(p):
    ep = p.common.RetinaEndpoint
    return [
        ep(name="web-0", namespace="default", ips=("10.0.0.5",), labels=(("app", "web"),),
           node="node1"),
        ep(name="web-1", namespace="default", ips=("10.0.0.6",), labels=(("app", "web"),),
           node="node2"),
        ep(name="db-0", namespace="prod", ips=("10.0.0.7",), labels=(("app", "db"),),
           node="node1"),
    ]


def capture(p, name="c", namespace="default", output=None, **target):
    c = p.crd
    return c.Capture(name=name, namespace=namespace, spec=c.CaptureSpec(
        target=c.CaptureTarget(**target),
        output=c.CaptureOutput(**(output if output is not None else {"host_path": "/tmp/x"}))))


def make_source(p):
    s = p.schema

    def source():
        rec = np.zeros((100, s.NUM_FIELDS), np.uint32)
        rec[:, s.F.SRC_IP] = s.ip_to_u32("10.0.0.5")
        rec[:, s.F.DST_IP] = s.ip_to_u32("10.0.0.9")
        rec[:, s.F.PORTS] = (40000 << 16) | 80
        rec[:, s.F.META] = s.PROTO_TCP << 24
        rec[:50, s.F.SRC_IP] = s.ip_to_u32("172.16.0.1")  # filtered out
        return rec

    return source


def once(block):
    """A source that yields ``block``, then empty blocks a tenth of a
    second apart."""
    calls = iter([block])

    def source():
        nxt = next(calls, None)
        if nxt is None:
            time.sleep(0.1)
            return block[:0]
        return nxt

    return source


# -- translator ------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_filter_synthesis(impl):
    sf = pkg(impl).tr.synthesize_filter
    assert sf(["10.0.0.5", "10.0.0.6"]) == "(host 10.0.0.5 or host 10.0.0.6)"
    assert sf(["10.0.0.5"], extra_filter="tcp", ports=[80, 443]) == \
        "(host 10.0.0.5) and (port 80 or port 443) and (tcp)"
    assert sf([]) == ""


@pytest.mark.parametrize("impl", IMPLS)
def test_translate_node_names(impl):
    p = pkg(impl)
    jobs = p.tr.translate_capture_to_jobs(capture(p, node_names=["node0", "node2"]),
                                          nodes3(p), [])
    assert sorted(j.node_name for j in jobs) == ["node0", "node2"]
    assert jobs[0].job_name() == "capture-c-node0"
    with pytest.raises(p.crd.ValidationError):
        p.tr.translate_capture_to_jobs(capture(p, "c2", node_names=["ghost"]), nodes3(p), [])


@pytest.mark.parametrize("impl", IMPLS)
def test_translate_pod_selector_scopes_nodes_and_filter(impl):
    p = pkg(impl)
    jobs = p.tr.translate_capture_to_jobs(capture(p, pod_selector={"app": "web"}),
                                          nodes3(p), pods(p))
    assert sorted(j.node_name for j in jobs) == ["node1", "node2"]
    # the filter covers exactly the selected pods' IPs (same-namespace scope)
    assert "host 10.0.0.5" in jobs[0].filter_expr
    assert "host 10.0.0.6" in jobs[0].filter_expr
    assert "10.0.0.7" not in jobs[0].filter_expr


@pytest.mark.parametrize("impl", IMPLS)
def test_translate_node_selector(impl):
    p = pkg(impl)
    jobs = p.tr.translate_capture_to_jobs(
        capture(p, node_selector={"zone": "a"}), nodes3(p), [],
        node_labels={"node0": {"zone": "a"}, "node1": {"zone": "b"}})
    assert [j.node_name for j in jobs] == ["node0"]


def random_captures(impl: str, seed: int):
    """A seeded mix of Captures (names, selectors, outputs, filters; some
    invalid), pods over four nodes in two namespaces, and the labels."""
    p = pkg(impl)
    rng = random.Random(seed)
    nodes = [p.common.RetinaNode(name=f"n{i}", ip=f"10.1.0.{i}") for i in range(4)]
    node_labels = {f"n{i}": {"zone": f"z{i % 2}", "pool": f"p{i // 2}"} for i in range(4)}
    ns_labels = {"default": {"team": "a"}, "prod": {"team": "b"}}
    eps = [p.common.RetinaEndpoint(
        name=f"pod-{i}", namespace=("default", "prod")[i % 2],
        ips=(f"10.2.{i // 200}.{i % 200 + 1}",) + ((f"fd00::{i:x}",) if i % 7 == 0 else ()),
        labels=(("app", f"a{i % 5}"), ("tier", ("web", "db")[i % 3 == 0])),
        node=f"n{rng.randrange(4)}" if i % 11 else "") for i in range(60)]
    caps = []
    for j in range(60):
        kind = rng.randrange(5)
        target = [
            {"node_names": rng.sample(["n0", "n1", "n2", "n3", "ghost"], rng.randrange(1, 3))},
            {"node_selector": {"zone": f"z{rng.randrange(3)}"}},
            {"pod_selector": {"app": f"a{rng.randrange(6)}"}},
            {"pod_selector": {"tier": "db"}, "namespace_selector": {"team": rng.choice("abc")}},
            {},
        ][kind]
        output = rng.choice([{"host_path": "/var/cap"}, {}, {"s3_upload": {"bucket": "b"}},
                             {"blob_upload_secret": "sec", "persistent_volume_claim": "pvc"}])
        cap = capture(p, f"cap-{j}", rng.choice(["default", "prod"]), output, **target)
        cap.spec.tcpdump_filter = rng.choice(["", "tcp", "port 53"])
        cap.spec.duration_s = rng.choice([1, 30, 600])
        caps.append(cap)
    return p, caps, nodes, eps, node_labels, ns_labels


def test_translation_equals_the_reference_over_seeded_captures():
    results = {}
    for impl in IMPLS:
        p, caps, nodes, eps, node_labels, ns_labels = random_captures(impl, 25)
        out = []
        for cap in caps:
            try:
                jobs = p.tr.translate_capture_to_jobs(cap, nodes, eps, node_labels=node_labels,
                                                      namespace_labels=ns_labels)
                out.append([dataclasses.asdict(j) for j in jobs])
            except p.crd.ValidationError as e:
                out.append(f"ValidationError: {e}")
        results[impl] = out
    assert results["port"] == results["reference"]
    # The mix covers jobs and each kind of rejection.
    flat = results["port"]
    assert sum(isinstance(r, list) for r in flat) >= 10
    errors = [m for m in flat if isinstance(m, str)]
    assert any("unknown nodes" in m for m in errors)
    assert any("at least one output location" in m for m in errors)


# -- providers -------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_replay_provider_writes_filtered_pcap(impl, tmp_path):
    p = pkg(impl)
    out = str(tmp_path / "cap.pcap")
    p.pr.ReplayProvider(source=make_source(p)).capture(
        out, filter_expr="(host 10.0.0.5)", duration_s=1, max_size_mb=1)
    res = p.pcap.decode_pcap_file(out)
    assert res.n_decoded > 0
    srcs = set(res.records[:, 2].tolist())
    assert p.schema.ip_to_u32("172.16.0.1") not in srcs
    assert p.schema.ip_to_u32("10.0.0.5") in srcs


def test_replay_pcap_equals_the_reference(tmp_path):
    """One fixed block through both ReplayProviders: equal pcap bytes."""
    blobs = {}
    for impl in IMPLS:
        p = pkg(impl)
        block = make_source(p)()
        block[:, p.schema.F.TS_LO] = np.arange(100, dtype=np.uint32) * 1000
        out = str(tmp_path / f"{impl}.pcap")
        p.pr.ReplayProvider(source=once(block)).capture(out, filter_expr="(host 10.0.0.5)",
                                                        duration_s=1, max_size_mb=1)
        blobs[impl] = open(out, "rb").read()
    assert blobs["port"] == blobs["reference"] and len(blobs["port"]) > 24


@pytest.mark.parametrize("impl", IMPLS)
def test_netsh_filter_from_ips(impl):
    f = pkg(impl).pr.netsh_filter_from_ips
    assert f([]) == ""
    assert f(["10.0.0.1", "10.0.0.2"]) == "IPv4.Address=(10.0.0.1,10.0.0.2)"
    assert f(["10.0.0.1", "fd00::5"]) == "IPv4.Address=(10.0.0.1) IPv6.Address=(fd00::5)"
    assert f(["fd00::5"]) == "IPv6.Address=(fd00::5)"


@pytest.mark.parametrize("impl", IMPLS)
def test_tcpdump_filter_to_netsh(impl):
    f = pkg(impl).pr.tcpdump_filter_to_netsh
    assert f("(host 10.0.0.1 or host 10.0.0.2)") == "IPv4.Address=(10.0.0.1,10.0.0.2)"
    assert f("(host 10.0.0.1 or host fd00::5) and port 80") == \
        "IPv4.Address=(10.0.0.1) IPv6.Address=(fd00::5)"
    assert f("port 80") == ""
    assert f("") == ""


class FakeRun:
    def __init__(self, show_status_rc=1, fail_start=False, fail_stop=False):
        self.calls: list[list[str]] = []
        self.show_status_rc = show_status_rc
        self.fail_start = fail_start
        self.fail_stop = fail_stop

    def __call__(self, args, timeout):
        self.calls.append((args, timeout))
        rc = 0
        if args[:4] == ["netsh", "trace", "show", "status"]:
            rc = self.show_status_rc
            self.show_status_rc = 1  # the stale session is stopped after that
        elif "start" in args and self.fail_start:
            rc = 1
        elif args == ["netsh", "trace", "stop"] and self.fail_stop:
            rc = 1
        return types.SimpleNamespace(returncode=rc, stdout="", stderr="")


@pytest.mark.parametrize("impl", IMPLS)
def test_netsh_provider_happy_path(impl):
    run, slept = FakeRun(), []
    prov = pkg(impl).pr.NetshProvider(runner=run, sleep=slept.append)
    assert prov.suffix == ".etl"
    prov.capture("/tmp/cap.etl", filter_expr="(host 10.0.0.1 or host fd00::1)", duration_s=7,
                 max_size_mb=50)
    assert slept == [7]
    start = next(c for c, _ in run.calls if "start" in c)
    assert "tracefile=/tmp/cap.etl" in start
    assert "IPv4.Address=(10.0.0.1)" in start and "IPv6.Address=(fd00::1)" in start
    assert "maxSize=50" in start
    assert run.calls[-1][0] == ["netsh", "trace", "stop"]


@pytest.mark.parametrize("impl", IMPLS)
def test_netsh_provider_wraps_runner_errors(impl):
    pr = pkg(impl).pr

    def timeout_runner(args, timeout):
        raise subprocess.TimeoutExpired(args, timeout)

    with pytest.raises(pr.CaptureError, match="did not terminate"):
        pr.NetshProvider(runner=timeout_runner, sleep=lambda s: None).capture(
            "/t.etl", duration_s=1)

    def missing_runner(args, timeout):
        raise FileNotFoundError("cmd")

    with pytest.raises(pr.CaptureError, match="not available"):
        pr.NetshProvider(runner=missing_runner, sleep=lambda s: None).capture(
            "/t.etl", duration_s=1)


@pytest.mark.parametrize("impl", IMPLS)
def test_netsh_provider_stops_stale_session_and_raises_on_failure(impl):
    pr = pkg(impl).pr
    run = FakeRun(show_status_rc=0)  # a stale session runs: it is stopped first
    pr.NetshProvider(runner=run, sleep=lambda s: None).capture("/tmp/x.etl", duration_s=1)
    assert [c for c, _ in run.calls].count(["netsh", "trace", "stop"]) == 2
    with pytest.raises(pr.CaptureError, match="start failed"):
        pr.NetshProvider(runner=FakeRun(fail_start=True), sleep=lambda s: None).capture(
            "/tmp/x.etl", duration_s=1)
    with pytest.raises(pr.CaptureError, match="stop failed"):
        pr.NetshProvider(runner=FakeRun(fail_stop=True), sleep=lambda s: None).capture(
            "/tmp/x.etl", duration_s=1)


def test_netsh_calls_equal_the_reference():
    calls = {}
    for impl in IMPLS:
        pr = pkg(impl).pr
        trace = []
        for kw, fake in ((dict(filter_expr="(host 10.0.0.1 or host fd00::2) and (port 53)",
                               duration_s=3, max_size_mb=20), FakeRun(show_status_rc=0)),
                         (dict(filter_expr="port 80", max_size_mb=0), FakeRun()),
                         (dict(), FakeRun(fail_stop=True))):
            slept = []
            try:
                pr.NetshProvider(runner=fake, sleep=slept.append).capture("/c.etl", **kw)
                trace.append("ok")
            except pr.CaptureError as e:
                trace.append(str(e))
            trace.append((fake.calls, slept))
        calls[impl] = trace
    assert calls["port"] == calls["reference"]


def test_tcpdump_command_equals_the_reference(monkeypatch):
    """The tcpdump argv (and its error wrapping) of both providers."""
    seen: list = []
    outcome = {"exc": None}

    def fake_run(cmd, **kw):
        seen.append((cmd, kw))
        if outcome["exc"] is not None:
            raise outcome["exc"]
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    results = {}
    for impl in IMPLS:
        pr = pkg(impl).pr
        seen.clear()
        trace = []
        for exc in (None, FileNotFoundError("tcpdump"),
                    subprocess.CalledProcessError(1, "tcpdump", stderr=b"no such device"),
                    subprocess.TimeoutExpired("tcpdump", 1)):
            outcome["exc"] = exc
            try:
                pr.TcpdumpProvider().capture("/c.pcap", filter_expr="(host 10.0.0.1)",
                                             iface="eth0", duration_s=9, max_size_mb=3,
                                             packet_size=96)
                trace.append("ok")
            except pr.CaptureError as e:
                trace.append(str(e))
        outcome["exc"] = None
        pr.TcpdumpProvider().capture("/d.pcap")  # the defaults: any interface, 60 s, 100 MB
        results[impl] = (trace, list(seen))
    assert results["port"] == results["reference"]
    cmd = results["port"][1][0][0]
    assert cmd[:9] == ["tcpdump", "-i", "eth0", "-w", "/c.pcap", "-W", "1", "-G", "9"]
    assert cmd[-1] == "(host 10.0.0.1)" and "-s" in cmd and "-C" in cmd


class FakeRawSocket:
    """An AF_PACKET socket that hands out a fixed list of frames, then
    times out."""

    frames: list[bytes] = []

    def __init__(self, *args):
        self.args, self.bound, self._frames = args, None, list(self.frames)

    def bind(self, addr):
        self.bound = addr

    def settimeout(self, t):
        pass

    def recv(self, n):
        import socket

        if self._frames:
            return self._frames.pop(0)
        time.sleep(0.01)
        raise socket.timeout()

    def close(self):
        pass


def test_socket_provider_pcap_equals_the_reference(tmp_path, monkeypatch):
    import socket

    FakeRawSocket.frames = [bytes(range(i, i + 60 + i)) for i in range(20)]
    monkeypatch.setattr(socket, "socket", FakeRawSocket)
    ticks = iter(range(10**9, 10**12, 1_000_003))
    monkeypatch.setattr(time, "time_ns", lambda: next(ticks))
    blobs = {}
    for impl in IMPLS:
        out = tmp_path / f"{impl}.pcap"
        pkg(impl).pr.SocketProvider().capture(str(out), iface="eth0", duration_s=0.3,
                                              max_size_mb=1, packet_size=64)
        blobs[impl] = out.read_bytes()
    monkeypatch.undo()
    data = blobs["port"]
    assert data[:4] == (0xA1B23C4D).to_bytes(4, "little")
    # header + 20 records, each 16 bytes + the frame cut at 64
    assert len(data) == 24 + sum(16 + min(64, len(f)) for f in FakeRawSocket.frames)
    # The timestamps differ only by the shared clock's order of calls.
    def strip_ts(b: bytes) -> bytes:
        out, i = [b[:24]], 24
        while i < len(b):
            n = int.from_bytes(b[i + 8:i + 12], "little")
            out.append(b[i + 8:i + 16 + n])
            i += 16 + n
        return b"".join(out)

    assert strip_ts(blobs["port"]) == strip_ts(blobs["reference"])


@pytest.mark.parametrize("impl", IMPLS)
def test_best_provider_picks_by_capability(impl, monkeypatch):
    pr = pkg(impl).pr
    avail = {"TcpdumpProvider": True, "NetshProvider": True, "SocketProvider": True}
    for cls in avail:
        monkeypatch.setattr(getattr(pr, cls), "available",
                            staticmethod(lambda cls=cls: avail[cls]))
    picks = []
    for cls in (*avail, None):
        picks.append(type(pr.best_provider(source=lambda: None)).__name__)
        if cls is not None:
            avail[cls] = False
    assert picks == ["TcpdumpProvider", "NetshProvider", "SocketProvider", "ReplayProvider"]


# -- manager -----------------------------------------------------------------------
def job(p, tmp_path, **kw):
    return p.tr.CaptureJob(**{**dict(
        capture_name="t", namespace="default", node_name="local", filter_expr="",
        duration_s=1, max_size_mb=1, packet_size_bytes=0,
        output={"host_path": str(tmp_path / "out")}), **kw})


@pytest.mark.parametrize("impl", IMPLS)
def test_capture_manager_end_to_end(impl, tmp_path):
    p = pkg(impl)
    artifacts = p.mg.CaptureManager(provider=p.pr.ReplayProvider(
        source=make_source(p))).run_job(job(p, tmp_path))
    assert len(artifacts) == 1 and os.path.exists(artifacts[0])
    with tarfile.open(artifacts[0]) as tf:
        names = tf.getnames()
    assert any(n.endswith(".pcap") for n in names)
    assert any("metadata" in n for n in names)  # ip/route/iptables dumps


@pytest.mark.parametrize("impl", IMPLS)
def test_capture_manager_uses_provider_suffix(impl, tmp_path):
    p = pkg(impl)

    class EtlProvider:
        name = "fake-etl"
        suffix = ".etl"

        def capture(self, out_path, **kw):
            with open(out_path, "wb") as fh:
                fh.write(b"ETL")

    arts = p.mg.CaptureManager(provider=EtlProvider()).run_job(
        job(p, tmp_path, capture_name="win", namespace="d", node_name="n",
            include_metadata=False, output={"host_path": str(tmp_path)}))
    assert arts and arts[0].endswith(".tar.gz")
    with tarfile.open(arts[0]) as tf:
        assert any(n.endswith(".etl") for n in tf.getnames())


@pytest.mark.parametrize("impl", IMPLS)
def test_capture_manager_without_a_provider_takes_the_best(impl, tmp_path, monkeypatch):
    """``CaptureManager()`` runs ``best_provider()`` at each capture."""
    p = pkg(impl)
    made = []

    class Recorder:
        name, suffix = "rec", ".pcap"

        def capture(self, out_path, **kw):
            made.append(kw)
            open(out_path, "wb").close()

    monkeypatch.setattr(p.mg, "best_provider", lambda: Recorder())
    p.mg.CaptureManager().run_job(job(p, tmp_path, filter_expr="(host 1.2.3.4)",
                                      include_metadata=False, packet_size_bytes=64))
    assert made == [dict(filter_expr="(host 1.2.3.4)", duration_s=1, max_size_mb=1,
                         packet_size=64)]


def test_capture_tarball_equals_the_reference(tmp_path):
    """The same job through both managers: the same tarball members, the
    pcap's bytes equal."""
    members = {}
    for impl in IMPLS:
        p = pkg(impl)
        block = make_source(p)()
        prov = p.pr.ReplayProvider(source=once(block))
        (art,) = p.mg.CaptureManager(provider=prov).run_job(
            job(p, tmp_path, output={"host_path": str(tmp_path / impl)}))
        with tarfile.open(art) as tf:
            names = sorted(tf.getnames())
            pcap = next(n for n in names if n.endswith(".pcap"))
            members[impl] = ([n.split("-2")[0] if n.endswith(".pcap") else n for n in names],
                             tf.extractfile(pcap).read())
    assert members["port"] == members["reference"]


# -- outputs -----------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_outputs_selection(impl, monkeypatch):
    out = pkg(impl).out
    for var in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_SESSION_TOKEN"):
        monkeypatch.delenv(var, raising=False)
    assert [s.name for s in out.outputs_from_spec({"host_path": "/tmp/z"})] == ["hostpath"]
    assert not out.BlobOutput("").enabled()
    assert not out.S3Output("").enabled()
    assert not out.S3Output("b", "us-east-1").enabled()  # no AWS credentials
    assert not out.BlobOutput("capture-blob-secret").enabled()  # a secret name, not a URL
    pvc = out.PvcOutput("claim", mount_root="/mnt")
    assert pvc.enabled() and pvc.path == "/mnt/claim" and pvc.name == "pvc"
    assert not out.PvcOutput("").enabled()
    assert out.S3Output("b", key_prefix="a/b/").key_prefix == "a/b"


def test_outputs_from_spec_equal_the_reference(monkeypatch):
    specs = [{}, {"host_path": "/h"}, {"persistent_volume_claim": "c"},
             {"blob_upload_secret": "https://acct/c?sig=1"}, {"blob_upload_secret": "name"},
             {"s3_upload": {"bucket": "b", "region": "r", "key_prefix": "p/", "endpoint": "e",
                            "secret_name": "ignored"}},
             {"host_path": "/h", "persistent_volume_claim": "c",
              "blob_upload_secret": "http://x/c?s", "s3_upload": {"bucket": "b"}}]
    got = {}
    for creds in (False, True):
        for var in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY"):
            if creds:
                monkeypatch.setenv(var, "k")
            else:
                monkeypatch.delenv(var, raising=False)
        for impl in IMPLS:
            out = pkg(impl).out
            got.setdefault(impl, []).append([
                [(s.name, {k: v for k, v in vars(s).items()}) for s in out.outputs_from_spec(sp)]
                for sp in specs])
    assert got["port"] == got["reference"]
    assert [n for n, _ in got["port"][1][-1]] == ["hostpath", "pvc", "blob", "s3"]


# -- managed storage -------------------------------------------------------------
class FakeCloud:
    """Records every provisioning call (the AZClients fake)."""

    def __init__(self, existing_accounts=None):
        self.accounts = list(existing_accounts or [])
        self.created, self.policies, self.containers = [], [], []
        self.immutability, self.sas_calls = [], []

    def list_accounts(self):
        return self.accounts

    def create_account(self, name, params):
        self.created.append((name, params))
        self.accounts.append({"name": name, "tags": params.get("tags", {})})

    def set_management_policy(self, account, policy):
        self.policies.append((account, policy))

    def create_container(self, account, container):
        self.containers.append((account, container))

    def set_immutability_policy(self, account, container, days):
        self.immutability.append((account, container, days))

    def container_sas_url(self, account, container, expiry_s, permissions):
        self.sas_calls.append((account, container, expiry_s, permissions))
        return f"https://{account}.blob.example/{container}?sig=fake&sp={permissions}"


@pytest.mark.parametrize("impl", IMPLS)
def test_managed_setup_creates_tagged_account_with_lifecycle_policy(impl):
    m = pkg(impl).managed
    cloud = FakeCloud()
    mgr = m.StorageAccountManager(cloud)
    mgr.setup()
    assert mgr.account.startswith(m.ACCOUNT_PREFIX)
    name, params = cloud.created[0]
    assert params["tags"] == {"createdBy": "retina"}
    assert 3 <= len(name) <= 24 and name.islower()
    acct, policy = cloud.policies[0]
    assert acct == name
    assert policy["delete_after_days"] == m.RETAIN_BLOB_DAYS
    assert policy["blob_types"] == ["blockBlob"]


@pytest.mark.parametrize("impl", IMPLS)
def test_managed_setup_reuses_existing_tagged_account(impl):
    cloud = FakeCloud(existing_accounts=[{"name": "unrelated123", "tags": {}},
                                         {"name": "retinacapture999",
                                          "tags": {"createdBy": "retina"}}])
    mgr = pkg(impl).managed.StorageAccountManager(cloud)
    mgr.setup()
    assert mgr.account == "retinacapture999"
    assert cloud.created == [] and cloud.policies


@pytest.mark.parametrize("impl", IMPLS)
def test_managed_container_per_namespace_with_immutability_created_once(impl):
    m = pkg(impl).managed
    cloud = FakeCloud()
    mgr = m.StorageAccountManager(cloud)
    mgr.setup()
    for ns in ("team-a", "team-a", "team-b"):
        mgr.create_container_sas_url(ns, duration_s=60)
    assert [c for _a, c in cloud.containers] == ["retina-capture-team-a",
                                                 "retina-capture-team-b"]
    assert all(d == m.IMMUTABILITY_DAYS for _a, _c, d in cloud.immutability)


@pytest.mark.parametrize("impl", IMPLS)
def test_managed_sas_is_write_only_with_expiry_floor(impl):
    m = pkg(impl).managed
    cloud = FakeCloud()
    mgr = m.StorageAccountManager(cloud)
    mgr.setup()
    mgr.create_container_sas_url("ns", duration_s=30)
    mgr.create_container_sas_url("ns", duration_s=3600)
    (_, _, exp_short, perm1), (_, _, exp_long, perm2) = cloud.sas_calls
    assert perm1 == perm2 == "w"
    assert exp_short == m.EXPIRY_FLOOR_S and exp_long == 7200
    with pytest.raises(RuntimeError, match="not set up"):
        m.StorageAccountManager(FakeCloud()).create_container_sas_url("ns", 1)


@pytest.mark.parametrize("impl", IMPLS)
def test_managed_manager_factory_disabled_without_client(impl):
    assert pkg(impl).managed.managed_manager_or_none(None) is None


def test_managed_calls_equal_the_reference(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    logs = {}
    for impl in IMPLS:
        m = pkg(impl).managed
        trace = []
        for existing, per_ns in (([], True), ([{"name": "x", "tags": {"createdBy": "retina"}}],
                                              False)):
            cloud = FakeCloud(existing)
            mgr = m.managed_manager_or_none(cloud) if per_ns else m.StorageAccountManager(
                cloud, unique_container_per_namespace=False)
            if not per_ns:
                mgr.setup()
            urls = [mgr.create_container_sas_url(ns, d) for ns, d in
                    (("a", 1), ("b", 400), ("a", 5000))]
            trace.append((mgr.account, urls, cloud.created, cloud.policies, cloud.containers,
                          cloud.immutability, cloud.sas_calls))
        logs[impl] = trace
    assert logs["port"] == logs["reference"]
