"""The port's e2e scenario framework (``e2e/``) against the reference's.

The six scenarios of the reference's ``tests/test_e2e_scenarios.py`` run
through the port's ``Runner`` and its agent on the CPU (``chip_smoke.py``'s
``e2e_scenarios``, which the chip run drives on the card): each boots a
``Daemon`` at ``small_agent_config(device_platform="cpu")``, feeds records
through the plugin sink and asserts through the agent's HTTP scrape, with the
reference's values. ``parse_exposition`` gives equal samples on both packages
over both exporters' exposition text; ``PrometheusChecker``, ``Job`` and the
steps behave alike on both. The pure cases of ``tests/test_perf_regression.py``
and its live-agent regression run on the port's harness, and
``e2e/kind.py`` refuses without its opt-in and without its tools.
"""

from __future__ import annotations

import http.server
import os
import socket
import threading
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
import retina_tpu.e2e as ref_e2e
import retina_tpu.e2e.kind as ref_kind
import retina_tpu.e2e.perf as ref_perf
import retina_tpu.e2e.prometheus as ref_prom
import retina_tpu.e2e.steps as ref_steps
import retina_tpu.exporter as ref_exporter
import retina_tpu.metrics as ref_metrics
import retina_tpu_torch.e2e as port_e2e
import retina_tpu_torch.e2e.kind as port_kind
import retina_tpu_torch.e2e.perf as port_perf
import retina_tpu_torch.e2e.prometheus as port_prom
import retina_tpu_torch.e2e.steps as port_steps
from retina_tpu_torch import exporter, metrics

PKGS = {
    "reference": SimpleNamespace(e2e=ref_e2e, prom=ref_prom, steps=ref_steps, perf=ref_perf,
                                 kind=ref_kind),
    "port": SimpleNamespace(e2e=port_e2e, prom=port_prom, steps=port_steps, perf=port_perf,
                            kind=port_kind),
}


@pytest.fixture(autouse=True)
def fresh_port_metrics():
    exporter.reset_for_tests()
    metrics.reset_for_tests()
    yield


@pytest.fixture
def one_torch_thread():
    """The agent's plain versions on one intra-op thread: at these shapes
    more threads only spin, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the six scenarios through the port's agent ------------------------------

SCENARIOS = dict(chip_smoke.e2e_scenarios(device_platform="cpu"))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_through_the_port_agent(name, one_torch_thread):
    ctx = port_e2e.Runner(SCENARIOS[name]()).run()
    assert ctx["daemon"].cm.engine.device.type == "cpu"
    assert not ctx["thread"].is_alive()  # BootAgent's cleanup stopped the agent


def test_scenarios_are_the_reference_six():
    import re

    with open(os.path.join(os.path.dirname(__file__), "test_e2e_scenarios.py")) as f:
        names = re.findall(r"^def test_scenario_(\w+)\(", f.read(), re.M)
    rename = {"drop_metrics": "drop", "dns_and_flags_metrics": "dns_and_flags"}
    assert sorted(SCENARIOS) == sorted(rename.get(n, n) for n in names)
    assert len(names) == 6


def test_small_agent_config_equals_the_reference():
    ref, port = ref_steps.small_agent_config(), port_steps.small_agent_config()
    fields = ("api_server_addr", "enabled_plugins", "event_source", "mesh_devices",
              "batch_capacity", "n_pods", "cms_width", "topk_slots", "hll_precision",
              "entropy_buckets", "conntrack_slots", "identity_slots", "window_seconds",
              "metrics_interval_s", "bypass_lookup_ip_of_interest")
    assert {f: getattr(port, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    assert port.device_platform == ""  # the card unless the caller names the CPU
    assert port_steps.small_agent_config(device_platform="cpu").device_platform == "cpu"


def test_exports_equal_the_reference():
    assert port_e2e.__all__ == ref_e2e.__all__


# -- parse_exposition and PrometheusChecker ------------------------------------

HANDMADE = """# HELP x_total a counter
# TYPE x_total counter
x_total 3
x_total{a="1",b="two"} 4.5
y{pod="p-1",namespace="default",le_ms="31"} 1e3

bad line here
z{only="x"} NaN
inf_metric +Inf
neg{a=""} -2
"""


def _port_text() -> str:
    m = metrics.get_metrics()
    m.windows_closed.inc(3)
    m.anomaly_windows.labels(dimension="src_ip").inc()
    m.lost_events.labels(stage="feed", plugin="packetparser").inc(7)
    m.stage_seconds.labels(stage="device_step").observe(0.004)
    return exporter.get_exporter().gather_text().decode()


def _ref_text() -> str:
    ref_exporter.reset_for_tests()
    ref_metrics.reset_for_tests()
    try:
        m = ref_metrics.get_metrics()
        m.windows_closed.inc(3)
        m.anomaly_windows.labels(dimension="src_ip").inc()
        m.lost_events.labels(stage="feed", plugin="packetparser").inc(7)
        m.stage_seconds.labels(stage="device_step").observe(0.004)
        return ref_exporter.get_exporter().gather_text().decode()
    finally:
        ref_exporter.reset_for_tests()
        ref_metrics.reset_for_tests()


def _tuples(samples):
    return [(s.name, s.labels, s.value if s.value == s.value else "nan") for s in samples]


@pytest.mark.parametrize("source", ["port", "reference", "handmade"])
def test_parse_exposition_equals_the_reference(source):
    text = {"port": _port_text, "reference": _ref_text, "handmade": lambda: HANDMADE}[source]()
    ref = ref_prom.parse_exposition(text)
    port = port_prom.parse_exposition(text)
    assert _tuples(port) == _tuples(ref)
    assert len(port) > 3
    if source != "handmade":
        names = {s.name for s in port}
        assert "networkobservability_tpu_windows_closed" in {
            n.removesuffix("_total") for n in names}


def test_port_and_reference_expositions_parse_to_equal_samples():
    def pick(text):
        keep = ("windows_closed", "anomaly_windows", "lost_events")
        return sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                      for s in port_prom.parse_exposition(text)
                      if any(k in s.name for k in keep)
                      and not s.name.endswith("_created"))  # a creation timestamp

    assert pick(_port_text()) == pick(_ref_text())


@pytest.fixture
def scrape_server():
    bodies: list[bytes] = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = bodies[0] if len(bodies) == 1 else bodies.pop(0)
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield bodies, f"http://127.0.0.1:{srv.server_address[1]}/metrics"
    srv.shutdown()
    srv.server_close()


@pytest.mark.parametrize("pkg", PKGS)
def test_checker_retries_until_the_value_lands(scrape_server, pkg):
    bodies, url = scrape_server
    bodies += [b"m{p=\"a\"} 1\n", b"m{p=\"a\"} 2\n", b"m{p=\"a\"} 5\nm{p=\"b\"} 9\n"]
    chk = PKGS[pkg].prom.PrometheusChecker(url, timeout_s=10, interval_s=0.01)
    s = chk.check_metric("m", {"p": "a"}, 5.0)
    assert (s.name, s.labels, s.value) == ("m", {"p": "a"}, 5.0)
    assert chk.check_metric("m", {"p": "b"}, lambda v: v > 8).value == 9.0
    assert chk.sum_metric("m") == 14.0 and chk.sum_metric("nope") == 0.0


@pytest.mark.parametrize("pkg", PKGS)
def test_checker_fails_at_its_deadline_with_near_misses(scrape_server, pkg):
    bodies, url = scrape_server
    bodies.append(b"m{p=\"a\"} 1\n")
    p = PKGS[pkg]
    chk = p.prom.PrometheusChecker(url, timeout_s=0.3, interval_s=0.05)
    with pytest.raises(p.e2e.StepFailed, match=r"closest: \{'p': 'a'\}=1.0"):
        chk.check_metric("m", {"p": "a"}, 2.0)


# -- the framework ---------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("fail_at", [None, "prevalidate", "run"])
def test_job_order_and_cleanup_equal_the_reference(pkg, fail_at):
    e2e = PKGS[pkg].e2e
    seen: list[str] = []

    def step(name, bad=None):
        class S(e2e.Step):
            def prevalidate(self, ctx):
                seen.append(f"pre:{name}")
                if bad == "prevalidate":
                    raise e2e.StepFailed(name)

            def run(self, ctx):
                seen.append(f"run:{name}")
                ctx[name] = True
                if bad == "run":
                    raise e2e.StepFailed(name)

            def cleanup(self, ctx):
                seen.append(f"clean:{name}")
                raise RuntimeError("cleanup errors are logged, never raised")

        S.name = name
        return S()

    job = e2e.Job("j").add(step("a"), step("b", fail_at), step("c"))
    if fail_at is None:
        ctx = e2e.Runner(job).run()
        assert ctx["job"] == "j" and ctx["a"] and ctx["c"]
    else:
        with pytest.raises(e2e.StepFailed, match="b"):
            e2e.Runner(job).run()
    want = {
        None: ["pre:a", "pre:b", "pre:c", "run:a", "run:b", "run:c",
               "clean:c", "clean:b", "clean:a"],
        "prevalidate": ["pre:a", "pre:b"],
        "run": ["pre:a", "pre:b", "pre:c", "run:a", "run:b", "clean:b", "clean:a"],
    }[fail_at]
    assert seen == want


@pytest.mark.parametrize("pkg", PKGS)
def test_scrape_assert_refuses_absent_with_a_value(pkg):
    with pytest.raises(ValueError, match="mutually exclusive"):
        PKGS[pkg].e2e.ScrapeAssert("m", absent=True, value=1.0)


# -- the agent-overhead harness (perf.py) ------------------------------------------

def _can_af_packet() -> bool:
    if os.geteuid() != 0 or not hasattr(socket, "AF_PACKET"):
        return False
    try:
        socket.socket(socket.AF_PACKET, socket.SOCK_RAW, socket.htons(3)).close()
        return True
    except OSError:
        return False


@pytest.mark.parametrize("before,after,want", [(100.0, 90.0, 10.0), (100.0, 110.0, -10.0),
                                               (0.0, 50.0, 0.0), (3.0, 1.0, 66.67)])
def test_pct_regression_equals_the_reference(before, after, want):
    assert port_perf._pct_regression(before, after) == ref_perf._pct_regression(
        before, after) == want


def test_perf_result_shape_equals_the_reference():
    import dataclasses

    kw = dict(throughput_mbps=1.0, pps=2.0, cpu_seconds=0.1, received=3)
    assert dataclasses.asdict(port_perf.PerfResult(**kw)) == dataclasses.asdict(
        ref_perf.PerfResult(**kw))
    assert port_perf._WORKLOAD == ref_perf._WORKLOAD


def test_workload_reports_real_traffic():
    r = port_perf.run_workload(duration_s=1.0)
    assert r.received > 200 and r.throughput_mbps > 0.2 and r.cpu_seconds > 0


def test_baseline_only_without_agent():
    res = port_perf.run_regression(duration_s=1.0, agent_factory=None)
    assert {"benchmark", "duration_s", "payload_bytes", "host_cpus"} == set(res)


@pytest.mark.skipif(not _can_af_packet(), reason="needs root + AF_PACKET (linux)")
def test_full_regression_with_the_live_port_agent(one_torch_thread):
    res = port_perf.run_regression(
        duration_s=2.0,
        agent_factory=lambda: port_perf.default_agent_factory({
            "batch_capacity": 1 << 12, "n_pods": 1 << 8, "cms_width": 1 << 10,
            "topk_slots": 1 << 7, "hll_precision": 8, "entropy_buckets": 1 << 8,
            "conntrack_slots": 1 << 10, "identity_slots": 1 << 10, "mesh_devices": 1,
            "device_platform": "cpu"}))
    assert {"benchmark", "result", "regression", "agent"} <= set(res)
    assert res["agent"]["events_observed"] > 20_000
    assert res["agent"]["reader"] in ("tpacket_v3_ring", "raw_socket")
    assert res["agent"]["cpu_seconds"] >= 0
    for key in ("throughput_pct", "pps_pct", "workload_cpu_pct"):
        assert isinstance(res["regression"][key], float)


# -- the kind harness's refusals -------------------------------------------------------

def _kind_job(kind):
    from retina_tpu_torch.e2e.framework import Job

    return Job("kind").add(kind.CreateKindCluster(), kind.BuildAndLoadImage(),
                           kind.InstallChart(), kind.WaitAgentReady())


def test_kind_refuses_without_its_opt_in(monkeypatch):
    monkeypatch.delenv("RETINA_KIND_E2E", raising=False)
    ran = []
    monkeypatch.setattr(port_kind, "sh", lambda *a, **k: ran.append(a))
    with pytest.raises(port_e2e.StepFailed, match="RETINA_KIND_E2E=1"):
        port_e2e.Runner(_kind_job(port_kind)).run()
    assert ran == []  # refused before any command


def test_kind_refuses_without_its_tools(monkeypatch, tmp_path):
    monkeypatch.setenv("RETINA_KIND_E2E", "1")
    monkeypatch.setenv("PATH", str(tmp_path))  # no kind, kubectl or docker
    with pytest.raises(port_e2e.StepFailed, match="kind not found"):
        port_e2e.Runner(_kind_job(port_kind)).run()


def test_kind_install_refuses_without_the_deploy_verb():
    assert "deploy" not in port_kind.cli_verbs()
    with pytest.raises(port_e2e.StepFailed, match="deploy verb"):
        port_kind.InstallChart().prevalidate({})


def test_kind_values_equal_the_reference():
    assert port_kind.KIND_VALUES == ref_kind.KIND_VALUES
