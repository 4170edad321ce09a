"""The port's debug surface (``obs/debug.py``) against the reference's.

Every route case of the reference's ``TestDebugEndpoints`` runs on both
packages through a ``pkg`` parameter: ``GET /debug/trace`` (Chrome JSON,
valid after the ring wraps, 400 on a bad ``last``, 405 on POST) and ``POST
/debug/profile`` (405 on GET, a session's artifacts, the cooldown's and
SHEDDING's 503). The same spans give the same trace body on both; the error
replies are equal code for code and body for body; a session's reply has the
reference's keys, ``jax_trace`` recorded as ``torch_trace``. The port alone:
its torch.profiler export, a session refused as busy while another
torch.profiler session is live, and the artifact pruning. The
``profile_*`` and ``soak_*`` checks of both ``Config`` classes raise the same
errors, and both daemons attach the routes to the agent mux.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
import torch

import retina_tpu.config as ref_config
import retina_tpu.obs.debug as ref_debug
import retina_tpu.obs.recorder as ref_recorder
import retina_tpu.runtime.overload as ref_overload
import retina_tpu.server as ref_server
import retina_tpu.utils.metric_names as ref_mn
import retina_tpu_torch.config as port_config
import retina_tpu_torch.obs.debug as port_debug
import retina_tpu_torch.obs.recorder as port_recorder
import retina_tpu_torch.runtime.overload as port_overload
import retina_tpu_torch.server as port_server
import retina_tpu_torch.utils.metric_names as port_mn
from retina_tpu_torch import exporter, metrics

PKGS = {
    "reference": SimpleNamespace(
        Config=ref_config.Config, Server=ref_server.Server,
        DebugObservability=ref_debug.DebugObservability,
        thread_stacks=ref_debug.thread_stacks, FlightRecorder=ref_recorder.FlightRecorder,
        SHEDDING=ref_overload.SHEDDING, mn=ref_mn, trace_key="jax_trace"),
    "port": SimpleNamespace(
        Config=port_config.Config, Server=port_server.Server,
        DebugObservability=port_debug.DebugObservability,
        thread_stacks=port_debug.thread_stacks, FlightRecorder=port_recorder.FlightRecorder,
        SHEDDING=port_overload.SHEDDING, mn=port_mn, trace_key="torch_trace"),
}


@pytest.fixture(autouse=True)
def fresh_port_metrics():
    exporter.reset_for_tests()
    metrics.reset_for_tests()
    yield


def _request(port, path, method="GET", timeout=60.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=b"" if method == "POST" else None,
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class _Overload:
    def __init__(self, state):
        self.state = state


@pytest.fixture
def debug_srv(tmp_path):
    servers = []

    def make(pkg, overload=None, recorder=None, **cfg_kw):
        p = PKGS[pkg]
        cfg_kw.setdefault("profile_cooldown_s", 0.2)
        cfg = p.Config(
            profile_artifact_dir=str(tmp_path / pkg / "prof"),
            profile_max_seconds=0.5,
            **cfg_kw,
        )
        srv = p.Server("127.0.0.1:0")
        srv.start()
        servers.append(srv)
        # A recorder of the test's own: the process-wide one also takes the
        # spans of any engine another test left running.
        dbg = p.DebugObservability(cfg, recorder=recorder or p.FlightRecorder(),
                                   overload=overload)
        dbg.attach(srv)
        return srv, dbg

    yield make
    for s in servers:
        s.stop()


# -- the reference's route cases, on both packages -------------------------

@pytest.mark.parametrize("pkg", PKGS)
class TestDebugEndpoints:
    def test_trace_endpoint_serves_chrome_json(self, debug_srv, pkg):
        mn = PKGS[pkg].mn
        srv, dbg = debug_srv(pkg)
        dbg.recorder.record(mn.STAGE_HARVEST, 1.0, trace_id=5, t1=1.5)
        code, body = _request(srv.port, "/debug/trace?last=10")
        assert code == 200
        doc = json.loads(body)
        names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
        assert mn.STAGE_HARVEST in names

    def test_trace_endpoint_valid_json_after_ring_wrap(self, debug_srv, pkg):
        mn = PKGS[pkg].mn
        srv, dbg = debug_srv(pkg)
        dbg.recorder._metrics_broken = True
        for i in range(20_000):  # many wraps of the default ring
            dbg.recorder.record(mn.STAGE_PUBLISH, i + 1.0, trace_id=i, t1=i + 1.5)
        code, body = _request(srv.port, "/debug/trace")
        assert code == 200
        doc = json.loads(body)  # raises = endpoint served torn JSON
        xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert 0 < len(xs) <= dbg.recorder.capacity
        assert all(e["dur"] >= 0 for e in xs)

    def test_trace_bad_last_is_400(self, debug_srv, pkg):
        srv, _ = debug_srv(pkg)
        code, _ = _request(srv.port, "/debug/trace?last=bogus")
        assert code == 400

    def test_trace_post_is_405(self, debug_srv, pkg):
        srv, _ = debug_srv(pkg)
        code, _ = _request(srv.port, "/debug/trace", method="POST")
        assert code == 405

    def test_profile_get_is_405(self, debug_srv, pkg):
        srv, _ = debug_srv(pkg)
        code, _ = _request(srv.port, "/debug/profile")
        assert code == 405

    def test_profile_session_writes_artifacts(self, debug_srv, pkg):
        srv, dbg = debug_srv(pkg)
        code, body = _request(srv.port, "/debug/profile?seconds=0.1", method="POST")
        assert code == 200, body
        doc = json.loads(body)
        assert doc["seconds"] == pytest.approx(0.1)
        assert doc[PKGS[pkg].trace_key] is True
        assert os.path.isfile(os.path.join(doc["artifact_dir"], "threads.txt"))
        assert dbg.sessions == 1

    def test_profile_cooldown_503(self, debug_srv, pkg):
        srv, _ = debug_srv(pkg)
        code, _ = _request(srv.port, "/debug/profile?seconds=0.1", method="POST")
        assert code == 200
        code, body = _request(srv.port, "/debug/profile?seconds=0.1", method="POST")
        assert code == 503
        assert json.loads(body)["error"] == "cooldown"

    def test_profile_shedding_503(self, debug_srv, pkg):
        srv, _ = debug_srv(pkg, overload=_Overload(PKGS[pkg].SHEDDING))
        code, body = _request(srv.port, "/debug/profile?seconds=0.1", method="POST")
        assert code == 503
        assert json.loads(body)["error"] == "shedding"

    def test_thread_stacks_sees_main(self, pkg):
        stacks = PKGS[pkg].thread_stacks()
        assert any("MainThread" in name for name in stacks)


# -- the port against the reference on the same inputs ---------------------

def _both(debug_srv, **kw):
    out = {}
    for pkg in PKGS:
        rec = PKGS[pkg].FlightRecorder()
        rec._metrics_broken = True
        out[pkg] = debug_srv(pkg, recorder=rec, **kw)
    return out


def test_trace_bodies_equal_the_reference(debug_srv):
    both = _both(debug_srv)
    for pkg, (_, dbg) in both.items():
        mn = PKGS[pkg].mn
        for i, stage in enumerate((mn.STAGE_COMBINE, mn.STAGE_DEVICE_STEP,
                                   mn.STAGE_WINDOW_CLOSE, mn.STAGE_HARVEST) * 3):
            dbg.recorder.record(stage, 10.0 + i, trace_id=i // 4, t1=10.25 + i * 1.5)
    for q in ("", "?last=0", "?last=3", "?last=100", "?last=-2"):
        (rc, rb), (pc, pb) = (_request(srv.port, "/debug/trace" + q)
                              for srv, _ in both.values())
        assert rc == pc == 200
        assert json.loads(pb) == json.loads(rb), q


@pytest.mark.parametrize("path,method", [
    ("/debug/trace?last=bogus", "GET"),
    ("/debug/trace", "POST"),
    ("/debug/profile", "GET"),
    ("/debug/profile?seconds=bogus", "POST"),
])
def test_error_replies_equal_the_reference(debug_srv, path, method):
    both = _both(debug_srv)
    (rc, rb), (pc, pb) = (_request(srv.port, path, method) for srv, _ in both.values())
    assert pc == rc and pc in (400, 405)
    assert pb == rb


def test_shedding_and_cooldown_replies_equal_the_reference(debug_srv):
    shed = {pkg: debug_srv(pkg, overload=_Overload(PKGS[pkg].SHEDDING))[0] for pkg in PKGS}
    (rc, rb), (pc, pb) = (_request(s.port, "/debug/profile", "POST") for s in shed.values())
    assert rc == pc == 503 and pb == rb
    both = _both(debug_srv, profile_cooldown_s=30.0)
    replies = {}
    for pkg, (srv, _) in both.items():
        first = _request(srv.port, "/debug/profile?seconds=0.1", "POST")
        second = _request(srv.port, "/debug/profile?seconds=0.1", "POST")
        replies[pkg] = (first[0], second[0], json.loads(second[1]))
    (r1, r2, rdoc), (p1, p2, pdoc) = replies["reference"], replies["port"]
    assert (r1, r2) == (p1, p2) == (200, 503)
    assert pdoc.keys() == rdoc.keys() and pdoc["error"] == rdoc["error"] == "cooldown"
    assert 29.0 <= pdoc["retry_after_s"] <= 30.0


@pytest.mark.parametrize("asked,granted", [("0.1", 0.1), ("0", 0.1), ("-3", 0.1),
                                           ("100", 0.5)])
def test_profile_reply_keys_and_clamp_equal_the_reference(debug_srv, asked, granted):
    both = _both(debug_srv)
    docs = {}
    for pkg, (srv, _) in both.items():
        code, body = _request(srv.port, f"/debug/profile?seconds={asked}", "POST")
        assert code == 200, body
        docs[pkg] = json.loads(body)
    ref, port = docs["reference"], docs["port"]
    assert set(port) == (set(ref) - {"jax_trace"}) | {"torch_trace"}
    assert port["seconds"] == ref["seconds"] == pytest.approx(granted)
    assert port["torch_trace"] is ref["jax_trace"] is True
    assert "MainThread" in port["threads"] and "MainThread" in ref["threads"]


# -- the port alone ---------------------------------------------------------

def test_profile_exports_a_torch_chrome_trace(debug_srv):
    srv, _ = debug_srv("port")
    stop = threading.Event()

    def busy():  # CPU ops for the session to record, from another thread
        x = torch.ones(64, 64)
        while not stop.is_set():
            x = (x @ x).clamp(max=1.0)

    t = threading.Thread(target=busy, daemon=True)
    t.start()
    try:
        code, body = _request(srv.port, "/debug/profile?seconds=0.3", "POST")
    finally:
        stop.set()
        t.join(10)
    assert code == 200, body
    doc = json.loads(body)
    with open(os.path.join(doc["artifact_dir"], port_debug.TRACE_FILE)) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]


def test_profile_answers_busy_while_another_session_is_live(debug_srv):
    from torch.profiler import ProfilerActivity, profile

    srv, dbg = debug_srv("port", profile_cooldown_s=0.0)
    with profile(activities=[ProfilerActivity.CPU]):
        code, body = _request(srv.port, "/debug/profile?seconds=0.1", "POST")
    assert code == 503 and json.loads(body) == {"error": "busy", "retry": True}
    assert dbg.sessions == 0
    assert not os.path.exists(dbg.cfg.profile_artifact_dir) or not os.listdir(
        dbg.cfg.profile_artifact_dir)
    code, body = _request(srv.port, "/debug/profile?seconds=0.1", "POST")
    assert code == 200 and json.loads(body)["torch_trace"] is True
    assert dbg.sessions == 1


def test_profile_prunes_to_the_newest_artifacts(debug_srv):
    srv, dbg = debug_srv("port", profile_max_artifacts=2, profile_cooldown_s=0.0)
    root = dbg.cfg.profile_artifact_dir
    for stale in ("profile-0000000001-1", "profile-0000000002-1", "profile-0000000003-1"):
        os.makedirs(os.path.join(root, stale))
    code, body = _request(srv.port, "/debug/profile?seconds=0.1", "POST")
    assert code == 200
    kept = sorted(os.listdir(root))
    assert kept == ["profile-0000000003-1", os.path.basename(json.loads(body)["artifact_dir"])]


# -- the profile_* and soak_* fields ---------------------------------------

PROFILE_SOAK = ("profile_artifact_dir", "profile_max_seconds", "profile_cooldown_s",
                "profile_max_artifacts", "soak_seconds", "soak_phase_seconds",
                "soak_recovery_deadline_s", "soak_rss_slope_mb_per_min",
                "soak_fd_generations_per_phase", "soak_artifact_dir")


def test_profile_and_soak_defaults_equal_the_reference():
    ref, port = ref_config.Config(), port_config.Config()
    assert {f: getattr(port, f) for f in PROFILE_SOAK} == {
        f: getattr(ref, f) for f in PROFILE_SOAK}


@pytest.mark.parametrize("bad", [
    {"profile_max_seconds": 0}, {"profile_max_seconds": -1.0},
    {"profile_cooldown_s": -0.5}, {"profile_max_artifacts": 0},
    {"soak_seconds": 0}, {"soak_recovery_deadline_s": -1.0},
    {"soak_rss_slope_mb_per_min": 0.0}, {"soak_phase_seconds": -1.0},
    {"soak_fd_generations_per_phase": 0},
])
def test_profile_and_soak_checks_equal_the_reference(bad):
    with pytest.raises(ValueError) as ref_err:
        ref_config.Config(**bad).validate()
    with pytest.raises(ValueError) as port_err:
        port_config.Config(**bad).validate()
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("ok", [{"profile_cooldown_s": 0.0}, {"soak_phase_seconds": 0.0},
                                {"profile_max_artifacts": 1}])
def test_profile_and_soak_edges_pass_on_both(ok):
    ref_config.Config(**ok).validate()
    port_config.Config(**ok).validate()


# -- the daemon's attach ------------------------------------------------------

SMALL = dict(batch_capacity=1 << 10, n_pods=1 << 8, cms_width=1 << 10, topk_slots=1 << 7,
             hll_precision=8, entropy_buckets=1 << 8, conntrack_slots=1 << 10,
             identity_slots=1 << 10, flow_dict_slots=1 << 10, window_seconds=0.3,
             metrics_interval_s=0.2, api_server_addr="127.0.0.1:0",
             enabled_plugins=["dropreason"], profile_cooldown_s=30.0,
             profile_max_seconds=0.5,
             # The routes' attach is under test, not the controller: a busy
             # host would shed and refuse the profile (SHEDDING's 503 is
             # held above with a stub controller).
             overload_enabled=False)


@pytest.mark.parametrize("pkg", PKGS)
def test_daemon_attaches_the_debug_routes(tmp_path, pkg):
    if pkg == "port":
        from retina_tpu_torch.daemon import Daemon
        from retina_tpu_torch.events.synthetic import TrafficGen

        cfg = port_config.Config(device_platform="cpu", **SMALL)
        make = lambda: Daemon(cfg, apiserver_host="127.0.0.1")  # noqa: E731
    else:
        from retina_tpu.daemon import Daemon
        from retina_tpu.events.synthetic import TrafficGen

        cfg = ref_config.Config(**SMALL)
        make = lambda: Daemon(cfg)  # noqa: E731
    cfg.profile_artifact_dir = str(tmp_path / "prof")
    d = make()
    stop = threading.Event()
    t = threading.Thread(target=d.start, args=(stop,), daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 60
        port = None
        while port is None and time.monotonic() < deadline:
            if d.cm.server is not None and d.cm.engine.started.is_set():
                try:
                    port = d.cm.server.port
                except AssertionError:
                    pass
            time.sleep(0.05)
        assert port is not None, "agent did not come up"
        gen = TrafficGen(n_flows=200, n_pods=64, seed=1)
        mn = PKGS[pkg].mn
        deadline = time.monotonic() + 60
        names: set = set()
        while time.monotonic() < deadline and not {mn.STAGE_DEVICE_STEP,
                                                   mn.STAGE_WINDOW_CLOSE} <= names:
            d.cm.engine.sink.write_records(gen.batch(512), "test")
            time.sleep(0.2)
            code, body = _request(port, "/debug/trace?last=500")
            assert code == 200
            names = {e["name"] for e in json.loads(body)["traceEvents"] if e["ph"] == "X"}
        assert {mn.STAGE_DEVICE_STEP, mn.STAGE_WINDOW_CLOSE} <= names, names
        code, body = _request(port, "/debug/profile?seconds=0.2", "POST")
        assert code == 200, body
        doc = json.loads(body)
        assert doc[PKGS[pkg].trace_key] is True
        assert os.path.isfile(os.path.join(doc["artifact_dir"], "threads.txt"))
        code, body = _request(port, "/debug/profile?seconds=0.2", "POST")
        assert code == 503 and json.loads(body)["error"] == "cooldown"
        code, body = _request(port, "/debug/vars")
        assert code == 200 and json.loads(body)["obs"]["enabled"] is True
    finally:
        stop.set()
        t.join(60)
