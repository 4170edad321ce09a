"""Time-travel closed-loop dryrun (port of retina_tpu/timetravel/dryrun.py).

The whole detection -> attribution -> evidence arc in one process:

1. A synthetic feed (``events/synthetic.py`` TrafficGen, ``zipf`` preset)
   closes ``windows`` windows into a SnapshotRing; window ``burst_at``
   carries a volumetric attack (``ddos_batch``: ``n_attack`` sources
   flooding one pod), which spikes the src-IP entropy.
2. The detector (``ops/entropy.py`` EntropyWindow's bits, K16, and
   AnomalyEWMA) observes each window's entropy vector and fires at the
   burst window; the flag calls AutoCapture.notify as the engine's anomaly
   hook does.
3. AutoCapture range-queries ``[W - 2, W + 2)`` (K8, K9), attributes the
   burst sources through the span-summed invertible decode (K15, K10) and
   records a targeted capture through the capture subsystem
   (CaptureManager and ReplayProvider on a live record source): full rows
   of only the attributed hosts.
4. While a feeder keeps the ring's live edge moving, scrape threads hammer
   ``QueryService.handle`` (the HTTP handler), half the storm under a
   forced SHEDDING state, and the scorecard pins the p99.

Acceptance: burst detected at the burst window, decode recall >= 0.95
against the exact attack key set, the artifact holds only rows of the
attributed hosts (and the attack), query p99 bounded, the feed never
stalled behind the query tier.

The ring slots are the fleet dryrun's sketch catalog plus the counter-only
invertible regions (``fleet/dryrun.py``), built on ``device`` (the card
unless the caller names another).
"""

from __future__ import annotations

import tarfile
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
from retina_tpu_torch.events.schema import F, u32_to_ip
from retina_tpu_torch.events.synthetic import TrafficGen, preset_params
from retina_tpu_torch.fleet.dryrun import INV_SEEDS, _invertible_arrays, _sketch_arrays
from retina_tpu_torch.ops.entropy import AnomalyEWMA, EntropyWindow
from retina_tpu_torch.runtime.overload import NOMINAL, SHEDDING
from retina_tpu_torch.sources.pcapdecode import decode_pcap_bytes
from retina_tpu_torch.timetravel.autocapture import AutoCapture
from retina_tpu_torch.timetravel.fold import ENTROPY_DIMS
from retina_tpu_torch.timetravel.query import QueryService
from retina_tpu_torch.timetravel.ring import SnapshotRing
from retina_tpu_torch.u32 import from_numpy

# Window-epoch base: non-zero, so the dryrun exercises epoch arithmetic.
_EPOCH0 = 1000


class _Overload:
    """The OverloadController surface the query tier reads (``.state``);
    the storm flips it to SHEDDING."""

    def __init__(self) -> None:
        self.state = NOMINAL


def _keys_from_records(rec: np.ndarray) -> np.ndarray:
    """(N, NUM_FIELDS) records -> (N, 4) flow keys (src_ip, dst_ip, proto,
    dst_port): column 3 is dst_port so the entropy groups line up with
    ``fold.ENTROPY_DIMS``."""
    return np.stack([
        rec[:, F.SRC_IP],
        rec[:, F.DST_IP],
        rec[:, F.META] >> np.uint32(24),
        rec[:, F.PORTS] & np.uint32(0xFFFF),
    ], axis=1).astype(np.uint32)


# Fixed per-window key-batch shape (the reference's: it keeps one compiled
# build). Padding repeats key row 0 at weight 0: invisible to CMS, top-k
# and entropy (zero weight) and to HLL (a duplicate).
_KEY_PAD = 1 << 12


def _window_arrays(rec: np.ndarray, device: torch.device | str | None = None,
                   ) -> dict[str, np.ndarray]:
    """One window's ring slot: the full sketch catalog plus the counter-only
    invertible regions, from one window of records."""
    keys, w = np.unique(_keys_from_records(rec), axis=0, return_counts=True)
    assert len(keys) <= _KEY_PAD, "raise _KEY_PAD for this feed"
    pad = _KEY_PAD - len(keys)
    keys = np.concatenate([keys, np.repeat(keys[:1], pad, axis=0)])
    w = np.concatenate([w, np.zeros(pad, w.dtype)])
    arrays = _sketch_arrays(keys, w.astype(np.float64), device)
    # The invertible regions at the seeds the decode expects; the plain
    # CMS flow_cms replaces the heavy-hitter one, so the decode's
    # verification reads the estimator the planes were fed from.
    arrays.update(_invertible_arrays(keys, w, np.zeros(len(w), bool), device))
    return arrays


def run_query_dryrun(
    windows: int = 8,
    burst_at: int = 4,
    n_attack: int = 48,
    bg_events: int = 1024,
    burst_events: int = 98_304,
    storm_threads: int = 6,
    storm_requests: int = 30,
    seed: int = 0,
    log: Callable[[str], None] = lambda s: None,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """Run the closed-loop simulation; returns the scorecard dict."""
    assert 2 <= burst_at <= windows - 2, "need lookback+lookahead room"
    dev = resolve_device(device)
    gen = TrafficGen(n_flows=512, n_pods=16, seed=seed, **preset_params("zipf"))
    out_dir = tempfile.mkdtemp(prefix="retina-ttdryrun-")
    cfg = Config(
        node_name="tt-dryrun",
        window_seconds=0.25,
        gen_preset="zipf",
        timetravel_enabled=True,
        timetravel_ring_windows=windows + 8,
        timetravel_query_cache_ttl_s=0.25,
        autocapture_enabled=True,
        autocapture_cooldown_s=300.0,
        autocapture_lookback_windows=2,
        autocapture_lookahead_windows=1,
        autocapture_max_sources=n_attack + 16,
        autocapture_duration_s=1.0,
        autocapture_max_size_mb=4,
        autocapture_output_dir=out_dir,
    )
    ov = _Overload()
    ring = SnapshotRing(cfg.timetravel_ring_windows, name="engine")
    qs = QueryService(cfg, overload=ov, device=dev)
    qs.add_ring(ring)

    # The live record source of the capture window: the attack is still in
    # flight when the evidence is taken. Counts what it produced, so the
    # scorecard can show the artifact is a targeted subset.
    feed_rows = [0]
    feed_lock = threading.Lock()

    def capture_source() -> np.ndarray:
        with feed_lock:
            block = np.concatenate([
                gen.batch(256),
                gen.ddos_batch(768, target_pod=1, n_sources=n_attack),
            ])
            feed_rows[0] += len(block)
        return block

    manager = CaptureManager(ReplayProvider(source=capture_source))
    ac = AutoCapture(cfg, qs, manager, ring_name="engine")
    ac.start()

    # -- phase 1: windows through the ring and the detector ---------------
    burst_epoch = _EPOCH0 + burst_at
    attack_keys: set[tuple[int, ...]] = set()
    det = AnomalyEWMA.zeros(len(ENTROPY_DIMS), device=dev)
    detected_epoch = -1
    detected_dims: list[str] = []
    t_build0 = time.monotonic()
    for i in range(windows):
        epoch = _EPOCH0 + i
        with feed_lock:
            rec = gen.batch(bg_events)
            if i == burst_at:
                atk = gen.ddos_batch(burst_events, target_pod=1, n_sources=n_attack)
                attack_keys = {tuple(int(x) for x in row)
                               for row in np.unique(_keys_from_records(atk), axis=0)}
                rec = np.concatenate([rec, atk])
        slot = _window_arrays(rec, dev)
        ring.append_host(epoch, slot, cfg.window_seconds, INV_SEEDS)
        h = EntropyWindow(counts=from_numpy(slot["entropy"], dev),
                          seed=INV_SEEDS["entropy"]).entropy_bits()
        det, flags, z = det.observe(h, z_thresh=8.0, min_windows=3)
        flags = flags.cpu().numpy()
        if flags.any() and detected_epoch < 0:
            detected_epoch = epoch
            detected_dims = [d for d, f in zip(ENTROPY_DIMS, flags) if f]
            ac.notify(epoch, detected_dims)
            log(f"burst detected at epoch {epoch} on {','.join(detected_dims)} "
                f"(z={float(z.max()):.1f})")
    build_s = time.monotonic() - t_build0

    # -- phase 2: the loop closes (attribution and targeted capture) ------
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline and not ac.captures:
        time.sleep(0.05)
    capture = ac.captures[-1] if ac.captures else None

    # Attribution recall off the query tier, over the range the capture
    # pivoted to: [W - 2, W + 2).
    res = qs.query_range("engine", burst_epoch - 2, burst_epoch + 2)
    dec = (res or {}).get("decode")
    recall = 0.0
    if dec is not None and attack_keys:
        decoded = {tuple(int(x) for x in row) for row in dec["keys"]}
        recall = len(decoded & attack_keys) / len(attack_keys)

    # -- phase 3: the artifact audit ----------------------------------------
    art: dict[str, Any] = {"rows": 0, "only_attributed": False, "attack_rows": 0,
                           "bytes": 0, "path": None}
    if capture is not None and capture["artifacts"]:
        path = capture["artifacts"][0]
        attr_ips = {ip for ip, _ in capture["sources"]}
        attack_ips = {u32_to_ip(k[0]) for k in attack_keys}
        with tarfile.open(path) as tf:
            member = next(m for m in tf.getmembers() if m.name.endswith(".pcap"))
            fh = tf.extractfile(member)
            assert fh is not None
            pcap = decode_pcap_bytes(fh.read())
        rows = pcap.records
        srcs = [u32_to_ip(int(r)) for r in rows[:, F.SRC_IP]]
        dsts = [u32_to_ip(int(r)) for r in rows[:, F.DST_IP]]
        art = {
            "rows": int(len(rows)),
            "only_attributed": bool(rows.size) and all(
                s in attr_ips or d in attr_ips for s, d in zip(srcs, dsts)),
            "attack_rows": int(sum(s in attack_ips for s in srcs)),
            "bytes": int(capture["artifact_bytes"]),
            "path": path,
            "filter_hosts": len(attr_ips),
            "feed_rows_offered": int(feed_rows[0]),
        }

    # -- phase 4: a query storm while the feed keeps running ---------------
    # The storm's shapes first, as the daemon's boot would.
    for span in (2, 3, 4):
        qs.handle({"t0": [str(burst_epoch - 2)], "t1": [str(burst_epoch - 2 + span)]})
        qs.handle({"last": [str(span)]})

    feed_stop = threading.Event()
    feed_appends = [0]
    # A prebuilt slot pool: the feeder churns the ring's live edge at full
    # window rate (20 ms), not the sketch build.
    with feed_lock:
        pool = [_window_arrays(gen.batch(bg_events), dev) for _ in range(4)]

    def feeder() -> None:
        e = _EPOCH0 + windows
        while not feed_stop.is_set():
            ring.append_host(e, pool[e % len(pool)], cfg.window_seconds, INV_SEEDS)
            feed_appends[0] += 1
            e += 1
            feed_stop.wait(0.02)

    lat_lock = threading.Lock()
    lats: list[float] = []
    codes: dict[int, int] = {}

    def scraper(tid: int) -> None:
        for j in range(storm_requests):
            if j == storm_requests // 2:
                ov.state = SHEDDING  # the second half of the storm sheds
            q = [
                {"t0": [str(burst_epoch - 2)], "t1": [str(burst_epoch + 2)]},
                {"last": ["3"]},
                {"last": ["2"], "fam": ["svc"]},
                {"t0": [str(burst_epoch - 1)], "t1": [str(burst_epoch + 1)]},
            ][(tid + j) % 4]
            t0 = time.monotonic()
            code, _body, _ctype = qs.handle(q)
            dt = time.monotonic() - t0
            with lat_lock:
                lats.append(dt)
                codes[code] = codes.get(code, 0) + 1
            time.sleep(0.01)  # paced like scrape traffic

    ft = threading.Thread(target=feeder, daemon=True)
    ft.start()
    threads = [threading.Thread(target=scraper, args=(t,), daemon=True)
               for t in range(storm_threads)]
    t_storm0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    storm_s = time.monotonic() - t_storm0
    feed_stop.set()
    ft.join(timeout=5.0)
    ov.state = NOMINAL
    ac.stop()

    p50, p99 = ((float(np.percentile(lats, 50)), float(np.percentile(lats, 99)))
                if lats else (float("inf"), float("inf")))
    checks = {
        "detected_at_burst": detected_epoch == burst_epoch,
        "recall_ok": recall >= 0.95,
        "capture_ok": capture is not None and art["rows"] > 0,
        "only_attributed": bool(art["only_attributed"]),
        "attack_in_artifact": art["attack_rows"] > 0,
        "artifact_bounded": 0 < art["bytes"] <= cfg.autocapture_max_size_mb * 1024 * 1024,
        "p99_ok": p99 <= 0.5,
        "no_errors": all(c in (200, 503) for c in codes),
        "feed_kept_up": feed_appends[0] >= 10,
    }
    res_out: dict[str, Any] = {
        "windows": windows,
        "burst_epoch": burst_epoch,
        "detected_epoch": detected_epoch,
        "detected_dims": detected_dims,
        "n_attack_keys": len(attack_keys),
        "recall": round(recall, 4),
        "capture": {k: v for k, v in art.items() if k != "path"},
        "artifact": art["path"],
        "queries": len(lats),
        "query_codes": codes,
        "query_p50_ms": round(p50 * 1e3, 2),
        "query_p99_ms": round(p99 * 1e3, 2),
        "storm_seconds": round(storm_s, 2),
        "feed_appends_during_storm": feed_appends[0],
        "window_build_seconds": round(build_s, 2),
        "checks": checks,
        "ok": all(checks.values()),
    }
    log(f"query dryrun: detect@{detected_epoch} (burst@{burst_epoch}), recall {recall:.3f} "
        f"over {len(attack_keys)} attack keys, artifact {art['rows']} rows / {art['bytes']}B "
        f"({art['attack_rows']} attack), storm p50 {p50 * 1e3:.1f}ms p99 {p99 * 1e3:.1f}ms "
        f"over {len(lats)} queries ({feed_appends[0]} windows closed during storm), "
        f"ok={res_out['ok']}")
    return res_out
