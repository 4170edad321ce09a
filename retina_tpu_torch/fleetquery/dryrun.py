"""Fleet query and detector-trio dryrun (port of
retina_tpu/fleetquery/dryrun.py).

Two arcs in one process:

1. **Federated query storm.** ``nodes`` simulated fleet members
   (LocalNodeClient over per-node SnapshotRings holding the same synthetic
   windows) behind one FleetQueryService. Scrape threads hammer
   ``FleetQueryService.handle`` (the HTTP handler) with a 1,000-query
   storm; at the midpoint 10% of the nodes are killed (answers must degrade
   to explicit partial coverage, never to errors) and the last stretch runs
   under a forced SHEDDING state (cache-only backoff). The scorecard pins
   the p99.

2. **Detector trio closed loops.** For each built-in detector (synflood,
   portscan, dnstunnel) a fresh DetectorBank, SnapshotRing and AutoCapture
   run benign warmup windows, then one window carrying the matching attack
   mixed into benign background. The matching detector, and only it, must
   fire at the attack window, win arbitration, and drive the detect ->
   range-query -> invertible-decode -> targeted-capture loop; attribution
   recall is measured against the exact attack key set. A benign sweep over
   every benign preset pins zero false firings.

The folds, the detector banks (K11, the bank's close) and the window
builds (K2-K4, K6) run on ``device`` (the card unless the caller names
another).
"""

from __future__ import annotations

import json
import tempfile
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from retina_tpu_torch._device import resolve_device
from retina_tpu_torch.capture.manager import CaptureManager
from retina_tpu_torch.capture.providers import ReplayProvider
from retina_tpu_torch.config import Config
from retina_tpu_torch.detect import DetectorBank, build_default_bank
from retina_tpu_torch.events.synthetic import TrafficGen, preset_params
from retina_tpu_torch.fleet.dryrun import INV_SEEDS
from retina_tpu_torch.fleetquery.service import FleetQueryService, LocalNodeClient
from retina_tpu_torch.runtime.overload import NOMINAL, SHEDDING
from retina_tpu_torch.timetravel.autocapture import AutoCapture
from retina_tpu_torch.timetravel.dryrun import (
    _EPOCH0,
    _keys_from_records,
    _Overload,
    _window_arrays,
)
from retina_tpu_torch.timetravel.fold import RangeFold
from retina_tpu_torch.timetravel.query import QueryService
from retina_tpu_torch.timetravel.ring import SnapshotRing

# Benign presets that must never fire a detector (the false-positive gate).
_BENIGN_PRESETS = ("zipf", "uniform", "elephant_mice")


def _make_config(nodes: int, windows: int, out_dir: str) -> Config:
    return Config(
        node_name="fleetquery-dryrun",
        window_seconds=0.25,
        gen_preset="zipf",
        timetravel_enabled=True,
        timetravel_ring_windows=windows + 8,
        fleetquery_enabled=True,
        fleetquery_node_deadline_s=0.2,
        fleetquery_hedge_delay_s=0.01,
        fleetquery_fanout=max(2, nodes),
        fleetquery_cache_ttl_s=0.25,
        detectors_enabled=True,
        autocapture_enabled=True,
        autocapture_cooldown_s=300.0,
        autocapture_lookback_windows=2,
        autocapture_lookahead_windows=1,
        autocapture_max_sources=64,
        autocapture_duration_s=1.0,
        autocapture_max_size_mb=4,
        autocapture_output_dir=out_dir,
    )


# -- arc 1: the federated query storm ---------------------------------------------


def _run_storm(cfg: Config, nodes: int, windows: int, storm_threads: int,
               storm_requests: int, seed: int, fold: RangeFold,
               log: Callable[[str], None]) -> dict[str, Any]:
    gen = TrafficGen(n_flows=512, n_pods=16, seed=seed, **preset_params("zipf"))
    ov = _Overload()
    svc = FleetQueryService(cfg, overload=ov, fold=fold)

    # Every node holds the same window set (every node closes every window
    # in a healthy fleet); the slots are shared host arrays.
    slots = [_window_arrays(gen.batch(2048), fold.device) for _ in range(windows)]
    for i in range(nodes):
        ring = SnapshotRing(windows + 4, name=f"node{i:03d}")
        for w, slot in enumerate(slots):
            ring.append_host(_EPOCH0 + w, slot, cfg.window_seconds, INV_SEEDS)
        # A deterministic latency spread; two stragglers sit past the hedge
        # delay (so hedging engages) but well under the node deadline.
        latency = 0.03 if i in (3, 11 % nodes) else 0.0005 * (1 + i % 5)
        svc.add_client(LocalNodeClient(f"node{i:03d}", ring, svc.fold, latency))

    newest = _EPOCH0 + windows - 1
    shapes = [
        {"t0": [str(_EPOCH0 + windows - 5)], "t1": [str(newest)]},
        {"t0": [str(newest - 3)], "t1": [str(newest)]},
        {"t0": [str(newest - 2)], "t1": [str(newest)], "fam": ["svc"]},
        {"last": ["3"]},
    ]

    # Warm-up: each node's span cache in turn (a real fleet folds the node
    # spans on 64 machines in parallel), then one pass over the storm's
    # shapes (the result cache). The reference also compiles its chunk
    # folds here; the port compiles nothing per shape.
    t_warm0 = time.monotonic()
    spans = {(newest - 4, newest), (newest - 3, newest), (newest - 2, newest),
             (newest - 2, newest + 1)}  # the last is last=3
    for c in svc.clients:
        for e0, e1 in spans:
            c.query(e0, e1, deadline_s=30.0)
    for q in shapes:
        svc.handle(q)
    warm_s = time.monotonic() - t_warm0

    n_kill = max(1, nodes // 10)
    lat_lock = threading.Lock()
    lats: list[float] = []
    codes: dict[int, int] = {}
    statuses: dict[str, int] = {}
    coverages: set[tuple[int, int]] = set()

    def scraper(tid: int) -> None:
        for j in range(storm_requests):
            if tid == 0 and j == storm_requests // 2:
                for c in svc.clients[:n_kill]:
                    c.dead = True
                log(f"killed {n_kill}/{nodes} nodes mid-storm")
            if tid == 0 and j == (storm_requests * 9) // 10:
                ov.state = SHEDDING  # the final stretch sheds
            q = shapes[(tid + j) % len(shapes)]
            t0 = time.monotonic()
            code, body, _ctype = svc.handle(q)
            dt = time.monotonic() - t0
            doc = json.loads(body)
            cov = doc.get("coverage") or {}
            with lat_lock:
                lats.append(dt)
                codes[code] = codes.get(code, 0) + 1
                s = ("busy" if code == 503 else "stale" if doc.get("stale") else
                     "partial" if cov.get("partial") else "ok")
                statuses[s] = statuses.get(s, 0) + 1
                if cov.get("partial"):
                    coverages.add((cov["nodes_answered"], cov["nodes_total"]))
            time.sleep(0.005)  # paced like scrape traffic

    threads = [threading.Thread(target=scraper, args=(t,), daemon=True)
               for t in range(storm_threads)]
    t_storm0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    storm_s = time.monotonic() - t_storm0
    ov.state = NOMINAL
    svc.close()

    p50, p99 = ((float(np.percentile(lats, 50)), float(np.percentile(lats, 99)))
                if lats else (float("inf"), float("inf")))
    return {
        "nodes": nodes,
        "killed": n_kill,
        "queries": len(lats),
        "codes": codes,
        "statuses": statuses,
        "hedges": svc.hedges,
        "node_errors": dict(svc.node_errors),
        "partial_coverages": sorted(coverages),
        "p50_ms": round(p50 * 1e3, 2),
        "p99_ms": round(p99 * 1e3, 2),
        "prewarm_seconds": round(warm_s, 2),
        "storm_seconds": round(storm_s, 2),
        "checks": {
            "p99_ok": p99 <= 0.1,
            "no_errors": all(c in (200, 503) for c in codes),
            # The steady post-kill answer is the survivors over the roster.
            "partial_coverage_observed": (nodes - n_kill, nodes) in coverages,
            "hedged": svc.hedges >= 1,
            "node_loss_counted": sum(v for k, v in svc.node_errors.items()
                                     if k in ("dead", "timeout")) >= 1,
        },
    }


# -- arc 2: the detector closed loops -------------------------------------------------


def _attack_mix(name: str, gen: TrafficGen) -> tuple[np.ndarray, np.ndarray]:
    """(attack records, window records): the attack mixed into enough benign
    background that only the matching detector's signature is present."""
    if name == "synflood":
        atk = gen.ddos_batch(24576, target_pod=1, n_sources=48)
        bg = gen.batch(8192)
    elif name == "portscan":
        atk = gen.portscan_batch(24576, n_scanners=4, n_ports=24)
        bg = gen.batch(32768)
    elif name == "dnstunnel":
        atk = gen.tunnel_batch(24576, n_clients=48)
        bg = gen.batch(4096)
    else:
        raise ValueError(name)
    return atk, np.concatenate([bg, atk])


def _detector_scenario(cfg: Config, name: str, fold: RangeFold, seed: int,
                       log: Callable[[str], None], windows: int = 8,
                       attack_at: int = 5) -> dict[str, Any]:
    dev = fold.device
    gen = TrafficGen(
        n_flows=256, n_pods=16, seed=seed,
        # The tunnel detector contrasts against a real benign DNS baseline.
        dns_fraction=0.25 if name == "dnstunnel" else 0.01,
    )
    ring = SnapshotRing(cfg.timetravel_ring_windows, name="engine")
    qs = QueryService(cfg, fold=fold)
    qs.add_ring(ring)

    feed_lock = threading.Lock()

    def capture_source() -> np.ndarray:
        with feed_lock:
            atk, _mix = _attack_mix(name, gen)
            return np.concatenate([gen.batch(256), atk[:768]])

    manager = CaptureManager(ReplayProvider(source=capture_source))
    ac = AutoCapture(cfg, qs, manager, ring_name="engine")
    ac.start()
    bank: DetectorBank = build_default_bank(cfg, sink=ac.notify, device=dev)

    attack_epoch = _EPOCH0 + attack_at
    attack_keys: set[tuple[int, ...]] = set()
    fired: list[Any] = []
    for i in range(windows):
        epoch = _EPOCH0 + i
        with feed_lock:
            if i == attack_at:
                atk, rec = _attack_mix(name, gen)
                attack_keys = {tuple(int(x) for x in row)
                               for row in np.unique(_keys_from_records(atk), axis=0)}
            else:
                rec = gen.batch(4096)
        fired += bank.observe(epoch, rec, now_s=float(i))
        ring.append_host(epoch, _window_arrays(rec, dev), cfg.window_seconds, INV_SEEDS)
    fired += bank.flush(now_s=float(windows))

    # The loop closes: wait for the capture the winner's sink queued.
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and not ac.captures:
        time.sleep(0.05)
    capture = ac.captures[-1] if ac.captures else None
    ac.stop()

    res = qs.query_range("engine", attack_epoch - 2, attack_epoch + 2)
    dec = (res or {}).get("decode")
    recall = 0.0
    if dec is not None and attack_keys:
        decoded = {tuple(int(x) for x in row) for row in dec["keys"]}
        recall = len(decoded & attack_keys) / len(attack_keys)

    at_attack = [d for d in fired if d.epoch == attack_epoch]
    off_attack = [d for d in fired if d.epoch != attack_epoch]
    scores = {d.name: round(d.last_score, 3) for d in bank.detectors}
    out = {
        "detector": name,
        "attack_epoch": attack_epoch,
        "fired": [(d.detector, d.epoch) for d in fired],
        "final_scores": scores,
        "n_attack_keys": len(attack_keys),
        "recall": round(recall, 4),
        "capture": None if capture is None else {
            "attributed_keys": capture["attributed_keys"],
            "sources": len(capture["sources"]),
            "artifact_bytes": capture["artifact_bytes"],
        },
        "checks": {
            "fired_at_attack": any(d.detector == name for d in at_attack),
            "no_off_window_firings": not off_attack,
            "won_arbitration": [d.detector for d in at_attack] == [name],
            "recall_ok": recall >= 0.95,
            "capture_ok": capture is not None and capture["artifact_bytes"] > 0,
        },
    }
    log(f"detector {name}: fired={out['fired']} scores={scores} recall={recall:.3f} over "
        f"{len(attack_keys)} keys, capture={'yes' if capture else 'NO'}")
    return out


def _benign_sweep(cfg: Config, seed: int, device: torch.device, windows: int = 8,
                  ) -> dict[str, Any]:
    """Every benign preset through a fresh bank: zero firings."""
    firings: dict[str, list] = {}
    for preset in _BENIGN_PRESETS:
        gen = TrafficGen(n_flows=256, n_pods=16, seed=seed, **preset_params(preset))
        bank = build_default_bank(cfg, device=device)
        fired: list = []
        for i in range(windows):
            fired += bank.observe(_EPOCH0 + i, gen.batch(4096), now_s=float(i))
        fired += bank.flush(now_s=float(windows))
        firings[preset] = [(d.detector, d.epoch) for d in fired]
    return {"firings": firings, "checks": {"benign_quiet": not any(firings.values())}}


def run_fleetquery_dryrun(
    nodes: int = 64,
    windows: int = 6,
    storm_threads: int = 8,
    storm_requests: int = 125,
    seed: int = 0,
    log: Callable[[str], None] = lambda s: None,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """Run both arcs; returns the scorecard dict (``ok`` rolls up every
    check)."""
    dev = resolve_device(device)
    out_dir = tempfile.mkdtemp(prefix="retina-fleetquery-")
    cfg = _make_config(nodes, windows, out_dir)
    fold = RangeFold(dev)

    storm = _run_storm(cfg, nodes, windows, storm_threads, storm_requests, seed, fold, log)
    log(f"storm: {storm['queries']} queries p50 {storm['p50_ms']}ms p99 {storm['p99_ms']}ms, "
        f"{storm['hedges']} hedges, statuses {storm['statuses']}")

    detectors: dict[str, dict] = {}
    for i, name in enumerate(("synflood", "portscan", "dnstunnel")):
        detectors[name] = _detector_scenario(cfg, name, fold, seed + 100 + i, log)
    benign = _benign_sweep(cfg, seed + 7, dev)

    checks: dict[str, bool] = {f"storm_{k}": v for k, v in storm["checks"].items()}
    for name, sc in detectors.items():
        checks.update({f"{name}_{k}": v for k, v in sc["checks"].items()})
    checks.update(benign["checks"])
    res: dict[str, Any] = {
        "storm": {k: v for k, v in storm.items() if k != "checks"},
        "detectors": {n: {k: v for k, v in sc.items() if k != "checks"}
                      for n, sc in detectors.items()},
        "benign": benign["firings"],
        "checks": checks,
        "ok": all(checks.values()),
    }
    log(f"fleetquery dryrun ok={res['ok']}")
    return res
