"""The port's node agent on the CPU, as users start it.

``Daemon`` at small shapes with ``device_platform="cpu"``: each in-repo
capture through the packetparser's pcap source, its scraped pod-level
forward and drop packet/byte series equal to the decoded capture's sums
exactly, the other routes (/readyz, /healthz, /debug/vars with top_flows,
/timetravel/query), and ``cli top`` and ``cli trace`` reading it; a
synthetic run whose engine equals its own synchronous replay (the dispatch
and close log of ``chip_smoke.instrument``, never the reference's threaded
engine), whose shutdown checkpoint loads into a fresh engine and resumes a
second agent with an equal state; ``python -m retina_tpu_torch agent`` in a
subprocess exiting 0 on SIGTERM; the agent in the three fleet roles
(``fleet_enabled``, ``fleet_aggregator``, ``fleetquery_enabled``) answering
``/fleet/query`` from its merged epochs; and the agent refusing to start
with no card and no ``device_platform``, and with each part it does not
have yet.
Every join, ``urlopen`` and subprocess has its own timeout.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import retina_tpu_torch.daemon as daemon_mod
from retina_tpu_torch import cli, exporter, metrics
from retina_tpu_torch.common import RetinaEndpoint
from retina_tpu_torch.config import load_config
from retina_tpu_torch.crd.types import TracesConfiguration, TracesSpec
from retina_tpu_torch.daemon import Daemon
from retina_tpu_torch.engine import SketchEngine
from retina_tpu_torch.events.schema import (
    DIR_INGRESS,
    VERDICT_DROPPED,
    VERDICT_FORWARDED,
    F,
    u32_to_ip,
)
from retina_tpu_torch.events.synthetic import pod_ip
from retina_tpu_torch.plugins.dropreason import DROP_REASONS
from retina_tpu_torch.sources.pcapdecode import decode_pcap_bytes
from retina_tpu_torch.utils import ktime

REPO = Path(__file__).resolve().parents[1]
CAPTURES = sorted((REPO / "tests" / "fixtures" / "real").glob("*.pcap"))
SMALL = dict(batch_capacity=1 << 10, n_pods=1 << 8, cms_width=1 << 10, topk_slots=1 << 7,
             hll_precision=8, entropy_buckets=1 << 8, conntrack_slots=1 << 10,
             identity_slots=1 << 10, flow_dict_slots=1 << 10, transfer_min_bucket=1 << 6,
             invertible_width=1 << 8, invertible_hi_width=1 << 6, window_seconds=0.5,
             metrics_interval_s=0.2, feed_workers=1)
SERIES = re.compile(r'^(\w+)\{([^}]*)\} (\S+)$')


@pytest.fixture(autouse=True)
def fresh_port_metrics():
    exporter.reset_for_tests()
    metrics.reset_for_tests()
    yield


def get(port: int, path: str) -> tuple[int, str]:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.read().decode()


def wait_for(pred, bound: float, what: str) -> None:
    deadline = time.monotonic() + bound
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def series(text: str, name: str) -> dict[tuple, float]:
    out = {}
    for line in text.splitlines():
        m = SERIES.match(line)
        if m and m.group(1) == name:
            labels = tuple(sorted(re.findall(r'(\w+)="([^"]*)"', m.group(2))))
            out[labels] = float(m.group(3))
    return out


def config(**kw):
    return load_config(None, overrides=dict(SMALL, device_platform="cpu",
                                            api_server_addr="127.0.0.1:0", **kw), env={})


@contextlib.contextmanager
def running(d: Daemon, boot_s: float = 120.0):
    """Start ``d`` on a thread, wait for /readyz, always stop it."""
    stop = threading.Event()
    t = threading.Thread(target=d.start, args=(stop,), name="daemon", daemon=True)
    t.start()
    try:
        wait_for(lambda: d.cm._ready.is_set() or not t.is_alive(), boot_s, "the agent's ready")
        assert t.is_alive(), "the agent died while booting"
        yield d.cm.server.port
    finally:
        stop.set()
        t.join(60)
        assert not t.is_alive(), "the agent did not stop"


def register(d: Daemon, ips: list[str]) -> dict[str, str]:
    """One pod an IP, as the identity watchers would; returns ip -> pod
    name once the engine's identity table and the filter hold them."""
    names = {}
    for i, ip in enumerate(sorted(ips)):
        names[ip] = f"pod-{i}"
        d.cm.cache.update_endpoint(RetinaEndpoint(name=names[ip], namespace="default",
                                                  ips=(ip,)))
    want = d.cm.cache.ip_index_map()
    wait_for(lambda: d.cm.engine._ident_dict == want, 30, "the identity rebuild")
    wait_for(lambda: d.cm.filtermanager.ip_count() >= len(ips), 30, "the filter push")
    return names


def expected_pod_sums(rec: np.ndarray, names: dict[str, str]):
    """The pipeline's pod attribution: the destination's pod for ingress
    rows, the source's otherwise; forward (packets, bytes) by direction and
    drop (packets, bytes) by reason."""
    ingress = ((rec[:, F.META] >> 4) & 0xF) == DIR_INGRESS
    local = np.where(ingress, rec[:, F.DST_IP], rec[:, F.SRC_IP])
    fwd, drop = {}, {}
    for r, ing, ip in zip(rec, ingress, local):
        pod = names[u32_to_ip(int(ip))]
        pk, by = int(r[F.PACKETS]), int(r[F.BYTES])
        if r[F.VERDICT] == VERDICT_FORWARDED:
            key = (pod, "ingress" if ing else "egress")
            fwd[key] = tuple(a + b for a, b in zip(fwd.get(key, (0, 0)), (pk, by)))
        elif r[F.VERDICT] == VERDICT_DROPPED:
            key = (pod, DROP_REASONS.get(int(r[F.DROP_REASON]), str(int(r[F.DROP_REASON]))))
            drop[key] = tuple(a + b for a, b in zip(drop.get(key, (0, 0)), (pk, by)))
    return fwd, drop


def scraped_pod_sums(text: str):
    def by(count, nbytes, label):
        out = {}
        for labels, v in series(text, count).items():
            d = dict(labels)
            b = series(text, nbytes)[labels]
            if v or b:
                out[(d["podname"], d[label])] = (int(v), int(b))
        return out

    return (by("networkobservability_adv_forward_count", "networkobservability_adv_forward_bytes",
               "direction"),
            by("networkobservability_adv_drop_count", "networkobservability_adv_drop_bytes",
               "reason"))


@pytest.mark.parametrize("capture", CAPTURES, ids=lambda p: p.stem)
def test_pcap_agent_counters_equal_the_decoded_capture(capture, tmp_path, capsys):
    rec = decode_pcap_bytes(capture.read_bytes()).records
    ips = sorted({u32_to_ip(int(x)) for x in np.concatenate([rec[:, F.SRC_IP], rec[:, F.DST_IP]])})
    cfg = config(event_source="pcap", pcap_path=str(capture), pcap_loop=False,
                 overload_enabled=False, timetravel_enabled=True, detectors_enabled=True,
                 snapshot_dir=str(tmp_path))
    d = Daemon(cfg, apiserver_host="127.0.0.1")
    names = register(d, ips)
    d.traces_module.reconcile(TracesConfiguration(spec=TracesSpec(
        trace_targets=[{"name": "loopback", "ips": ["127.0.0.1"]}])))
    want_fwd, want_drop = expected_pod_sums(rec, names)
    with running(d) as port:
        assert get(port, "/readyz") == (200, "ok") and get(port, "/healthz") == (200, "ok")
        eng = d.cm.engine
        wait_for(lambda: eng.counts.events == len(rec), 60, "the capture to be stepped")
        assert eng.apiserver_ip == 0x7F000001  # the watcher fed K14's input
        got = None

        def scraped() -> bool:
            nonlocal got
            got = scraped_pod_sums(get(port, "/metrics")[1])
            return got == (want_fwd, want_drop)

        wait_for(scraped, 30, f"the scrape to hold the capture's sums {(want_fwd, want_drop)}"
                              f" (last {got})")
        text = get(port, "/metrics")[1]
        assert "retina_build_info" in text and "networkobservability_tpu_uptime_seconds" in text
        wait_for(lambda: eng.timetravel_ring.stats()["appended"] >= 1, 30, "a ring slot")
        code, body = get(port, "/timetravel/query?last=8")
        doc = json.loads(body)
        assert code == 200 and doc["windows"] >= 1 and doc["topk"]["keys"]
        dv = json.loads(get(port, "/debug/vars")[1])
        assert dv["top_flows"] and dv["engine"]["events_in"] == len(rec)
        assert dv["plugin_supervision"].keys() == {"conntrack", "dns", "dropreason",
                                                   "packetforward", "packetparser"}
        assert cli.main(["top", "flows", "--server", f"127.0.0.1:{port}"]) == 0
        rows = [r.split("\t") for r in capsys.readouterr().out.splitlines()]
        assert rows and rows == [[str(c) for c in r] for r in dv["top_flows"]]
        assert cli.main(["trace", "--server", f"127.0.0.1:{port}"]) == 0
        out = capsys.readouterr().out
        assert "== loopback" in out and "127.0.0.1" in out
        assert cli.main(["trace", "--stats", "--server", f"127.0.0.1:{port}"]) == 0
        assert json.loads(capsys.readouterr().out)["events_sampled"] > 0
    assert (tmp_path / "sketch_state.npz").exists()
    assert eng.windows["closed"] >= 1
    assert metrics.get_metrics().windows_closed._value >= 1


def test_agent_equals_its_synchronous_replay_and_resumes_from_its_checkpoint(tmp_path):
    cfg = config(synthetic_rate=100_000, synthetic_flows=2000, snapshot_dir=str(tmp_path),
                 snapshot_interval_s=0.5, timetravel_enabled=True, detectors_enabled=True)
    d = Daemon(cfg, apiserver_host="127.0.0.1")
    register(d, [u32_to_ip(pod_ip(i)) for i in range(1, 64)])
    log, published, summaries = [], [], []
    chip_smoke.instrument(d.cm.engine, log, published, summaries)
    with running(d) as port:
        eng = d.cm.engine
        wait_for(lambda: eng.counts.events >= 150_000, 60, "synthetic events")
        get(port, "/metrics")
    assert not eng.errors and not eng.lost_events.get("dispatch")
    assert sum(1 for e in log if e[0] == "window") >= 2
    ref = SketchEngine(cfg, device="cpu")
    ref.update_identities(d.cm.cache.ip_index_map())
    ref.update_filter_ips(set(d.cm.filtermanager._refs))
    ref.set_apiserver_ips([0x7F000001])
    rlog, rpub, rsum = [], [], []
    chip_smoke.instrument(ref, rlog, rpub, rsum)
    for entry in log:
        if entry[0] == "step":
            ref._dispatch_sharded(*entry[1:])
        else:
            ref._close_window()
    ref._harvest_window(timeout=60)
    for (leaf, x), (_, y) in zip(chip_smoke.named_leaves(eng.state),
                                 chip_smoke.named_leaves(ref.state)):
        if x.dtype.is_floating_point:
            torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-6, msg=leaf)
        else:
            assert torch.equal(x, y), leaf
    assert len(rsum) == len(summaries)
    assert len(rpub) == len(published)
    for (wx, _), (wy, _) in zip(published, rpub):
        for k in ("entropy_bits", "anomaly", "zscore"):
            np.testing.assert_allclose(np.asarray(wy[k]), np.asarray(wx[k]), rtol=1e-5, atol=1e-6)
    now = 4_000_000_000 // 2
    want = eng.snapshot(max_age_s=0, now_s=now)

    def same(snap) -> None:
        # The state's readout; "steps" and "events_in" are the engine's own
        # counters, which a replay or a checkpoint does not carry.
        keep = sorted(set(want) - {"steps", "events_in"})
        assert keep == sorted(set(snap) - {"steps", "events_in"})
        for (leaf, x), (_, y) in zip(chip_smoke.named_leaves_dict({k: want[k] for k in keep}),
                                     chip_smoke.named_leaves_dict({k: snap[k] for k in keep})):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), leaf

    same(ref.snapshot(max_age_s=0, now_s=now))
    # The shutdown checkpoint loads into a fresh engine ...
    fresh = SketchEngine(cfg, device="cpu")
    assert fresh.load_snapshot_state(str(tmp_path / "sketch_state.npz"))
    same(fresh.snapshot(max_age_s=0, now_s=now))
    # ... and a second agent on the same snapshot_dir resumes from it.
    metrics.reset_for_tests()
    exporter.reset_for_tests()
    d2 = Daemon(load_config(None, overrides=dict(
        SMALL, device_platform="cpu", api_server_addr="127.0.0.1:0", enabled_plugins=[],
        snapshot_dir=str(tmp_path)), env={}))
    with running(d2):
        same(d2.cm.engine.snapshot(max_age_s=0, now_s=now))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_python_m_agent_exits_0_on_sigterm(tmp_path):
    port = _free_port()
    args = [sys.executable, "-m", "retina_tpu_torch", "agent", "--set", "device_platform=cpu",
            "--set", f"api_server_addr=127.0.0.1:{port}", "--set", "synthetic_rate=20000",
            "--set", "synthetic_flows=1000", "--set", f"snapshot_dir={tmp_path}"]
    for k, v in SMALL.items():
        args += ["--set", f"{k}={v}"]
    env = {k: v for k, v in os.environ.items() if not k.startswith("RETINA_")}
    proc = subprocess.Popen(args, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        def ready() -> bool:
            assert proc.poll() is None, "the agent exited while booting"
            try:
                return get(port, "/readyz")[0] == 200
            except OSError:
                return False

        wait_for(ready, 120, "the agent's /readyz")
        assert "networkobservability_tpu_uptime_seconds" in get(port, "/metrics")[1]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, out[-3000:]
    assert "agent shut down" in out
    assert (tmp_path / "sketch_state.npz").exists()


def test_agent_without_a_card_or_device_platform_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(None, overrides={"api_server_addr": "127.0.0.1:0"}, env={})
    assert cfg.device_platform == ""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Daemon(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        daemon_mod.run_agent(overrides={"api_server_addr": "127.0.0.1:0"},
                             install_signals=False)


@pytest.mark.parametrize("override,item", [
    ({"enable_hubble": True, "kubeconfig": "/etc/kube/config"}, "item 7"),
    ({"kubeconfig": "/etc/kube/config"}, "item 7"),
    ({"distributed_coordinator": "10.0.0.1:1234"}, "item 5"),
    ({"in_cluster": True}, "item 7"),
])
def test_agent_refuses_each_unported_part(override, item, monkeypatch):
    if override.pop("in_cluster", False):
        monkeypatch.setattr(daemon_mod, "in_cluster_available", lambda: True)
    cfg = config(**override)
    with pytest.raises(ValueError, match=f"not ported yet: .*ROADMAP §1 {item}"):
        Daemon(cfg)


def test_refuse_unported_no_longer_names_the_fleet_roles(monkeypatch):
    monkeypatch.setattr(daemon_mod, "in_cluster_available", lambda: False)
    daemon_mod.refuse_unported(config(fleet_enabled=True, fleet_aggregator=True,
                                      fleetquery_enabled=True))
    with pytest.raises(ValueError) as err:
        daemon_mod.refuse_unported(config(
            fleet_aggregator=True, fleetquery_enabled=True, enable_hubble=True,
            kubeconfig="/etc/kube/config", distributed_coordinator="10.0.0.1:1234"))
    msg = str(err.value)
    assert "fleet_aggregator" not in msg and "fleetquery" not in msg
    assert "enable_hubble" not in msg
    for part in ("kubeconfig", "distributed_coordinator"):
        assert part in msg, part


def scraped_value(text: str, name: str) -> float | None:
    """The value of an unlabeled series of an exposition."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.rsplit(" ", 1)[1])
    return None


def test_agent_in_the_fleet_roles_answers_fleet_query_from_its_merged_epochs():
    """The co-located topology: the node ships each window close to its own
    aggregator over the in-process bus, which merges it (one node expected)
    into its epoch ring; GET /fleet/query answers from that ring what the
    engine's own ring folds to over the same epochs, and /metrics carries
    the fleet_* series."""
    from retina_tpu_torch.fleet.aggregator import format_key
    from retina_tpu_torch.timetravel.fold import RangeFold, range_extract, range_topk

    capture = REPO / "tests" / "fixtures" / "real" / "loopback_mixed_real.pcap"
    rec = decode_pcap_bytes(capture.read_bytes()).records
    ips = sorted({u32_to_ip(int(x)) for x in np.concatenate([rec[:, F.SRC_IP], rec[:, F.DST_IP]])})
    cfg = config(event_source="pcap", pcap_path=str(capture), pcap_loop=False,
                 overload_enabled=False, timetravel_enabled=True, fleet_enabled=True,
                 fleet_aggregator=True, fleetquery_enabled=True, fleet_expected_nodes=1,
                 fleet_node_name="node-0")
    d = Daemon(cfg, apiserver_host="127.0.0.1")
    assert d.fleet_aggregator is not None and d.fleetquery is not None
    assert set(d.query_service.rings) == {"engine", "fleet"}
    register(d, ips)
    with running(d) as port:
        eng, agg = d.cm.engine, d.fleet_aggregator
        wait_for(lambda: eng.counts.events == len(rec), 60, "the capture to be stepped")
        wait_for(lambda: eng.timetravel_ring.stats()["appended"] >= 1
                 and agg.epoch_ring.span() == eng.timetravel_ring.span(), 30,
                 "the aggregator to merge the engine's closes")
        code, body = get(port, "/fleet/query?last=4")
        doc = json.loads(body)
        assert code == 200 and doc["windows"] >= 1, doc
        assert doc["coverage"] == {"nodes_answered": 1, "nodes_total": 1, "partial": False}
        slots = eng.timetravel_ring.select(doc["t0"], doc["t1"])
        assert [s[0] for s in slots] == doc["epochs"]
        seeds = slots[0][3]
        merged = (slots[0][1] if len(slots) == 1
                  else RangeFold("cpu").fold([s[1] for s in slots], seeds))
        ex = range_extract(merged, seeds, "cpu")
        assert doc["cardinality"] == pytest.approx(ex["cardinality"])
        assert doc["entropy_bits"] == pytest.approx(ex["entropy_bits"])
        keys, counts = range_topk(merged, seeds, fam="flow", k=cfg.fleetquery_topk,
                                  est=ex.get("flow_est"), device="cpu")
        assert [(e["key"], e["count"]) for e in doc["topk"]["keys"]] == [
            (format_key(r), int(c)) for r, c in zip(keys, counts)] and keys.size
        assert agg.rollups[-1]["nodes"] == ["node-0"] and agg.stats()["epochs_merged"] >= 1
        text = ""

        def reporting() -> bool:
            nonlocal text
            text = get(port, "/metrics")[1]
            return scraped_value(text, "networkobservability_fleet_nodes_reporting") == 1.0

        wait_for(reporting, 30, "fleet_nodes_reporting 1 on /metrics")
        assert scraped_value(text, "networkobservability_fleet_windows_merged_counter_total") >= 1
        assert "networkobservability_fleet_top_flow_packets{" in text
        assert scraped_value(text, "networkobservability_fleet_snapshots_shipped_counter_total") >= 1
        code, body = get(port, "/timetravel/query?ring=fleet&last=4")
        assert code == 200 and json.loads(body)["windows"] == doc["windows"]
        dv = json.loads(get(port, "/debug/vars")[1])
        assert dv["fleetquery"]["ring"] == "fleet" and dv["fleetquery"]["queries"] >= 1


def test_in_cluster_available_reads_the_service_account(tmp_path, monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    assert not daemon_mod.in_cluster_available(str(tmp_path))
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.96.0.1")
    assert not daemon_mod.in_cluster_available(str(tmp_path))
    (tmp_path / "token").write_text("t")
    assert daemon_mod.in_cluster_available(str(tmp_path))


def test_ktime_offset_matches_the_reference_clock():
    from retina_tpu.utils import ktime as ref_ktime

    mono = time.monotonic_ns()
    assert ktime.boot_offset_ns() == ktime.boot_offset_ns()
    assert abs(ktime.monotonic_to_wall_ns(mono) - ref_ktime.monotonic_to_wall_ns(mono)) < 10**9
    assert abs(ktime.monotonic_to_wall_ns(mono) - time.time_ns()) < 10**9
