"""The port's feed-path host side and its wire against the JAX reference (CPU).

- The host functions (pack, timestamps, known and dense rows, buckets,
  partitioning, the numpy combine, the Python flow dictionary) equal the
  reference's exactly.
- The port's native copy (``retina_tpu_torch/native``) equals its own numpy
  twins and the reference's native library bit for bit, except the combine
  against its numpy twin, which is compared as a key -> (packets, bytes,
  latest ts) map (the numpy twin sorts by hash and may split a group on a
  hash collision).
- The card side's plain versions (``unpack_records_plain``,
  ``dense_known_unpack_plain``) equal the reference's jnp functions, and the
  port engine's three ingest functions equal the reference engine's own
  ingest jits on the same wire, base and table: the windows, their validity
  counts and the descriptor table, exactly.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import retina_tpu.native as jnative
from retina_tpu.config import Config as JConfig
from retina_tpu.engine import SketchEngine as JEngine
from retina_tpu.events.synthetic import TrafficGen
from retina_tpu.parallel import combine as jcombine
from retina_tpu.parallel import flowdict as jflowdict
from retina_tpu.parallel import partition as jpartition
from retina_tpu.parallel import wire as jwire
from retina_tpu_torch import native
from retina_tpu_torch.config import Config
from retina_tpu_torch.engine import SketchEngine
from retina_tpu_torch.events.schema import F, NUM_FIELDS
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.parallel import combine, flowdict, partition, wire
from retina_tpu_torch.u32 import from_numpy, to_numpy

ID_BITS = (1, 12, 18, 21, 32)
NATIVE_WAIT_S = 120.0  # bound on waiting out another worker's build of the reference library


@pytest.fixture
def reference_native():
    """The reference's native library, loaded: the comparisons below are of
    its row order. The reference builds it at first use with ``make`` into
    one fixed path, and a worker that loses a concurrent build to another
    test process latches ``_build_failed`` and falls back to the numpy
    combine for its whole life, which sorts its rows. Clear that latch and
    retry until the other build has finished; fail if it never loads."""
    deadline = time.monotonic() + NATIVE_WAIT_S
    while True:
        with jnative._lock:
            jnative._build_failed = False
        if jnative.get_lib() is not None:
            return jnative
        if time.monotonic() > deadline:
            pytest.fail(f"the reference's native library did not load in {NATIVE_WAIT_S} s")
        time.sleep(0.5)


pytestmark = pytest.mark.usefixtures("reference_native")


def random_records(rng, n: int) -> np.ndarray:
    """Random records with unstamped rows, values past every saturation
    bound of MISC, and timestamps on both sides of a u32 boundary."""
    rec = rng.integers(0, 1 << 32, (n, NUM_FIELDS), dtype=np.uint64).astype(np.uint32)
    rec[: n // 8, F.TS_LO] = 0
    rec[: n // 8, F.TS_HI] = 0
    rec[n // 8: n // 4, F.VERDICT] = 9
    rec[n // 8: n // 4, F.DROP_REASON] = 400
    rec[n // 8: n // 4, F.EVENT_TYPE] = 77
    rec[n // 8: n // 4, F.IFINDEX] = 1 << 20
    rec[n // 4:, F.TS_HI] = 7
    rec[n // 4:, F.TS_LO] = 0xFFFFFF00 + rng.integers(0, 0x200, n - n // 4).astype(np.uint32)
    return rec


def traffic(seed: int, n: int, n_flows: int = 300) -> np.ndarray:
    return TrafficGen(n_flows=n_flows, n_pods=48, seed=seed).batch(n)


def key_map(rows: np.ndarray) -> dict:
    """descriptor -> (packets, bytes, latest ts), summed over split groups."""
    out: dict = {}
    for r in rows:
        k = tuple(int(r[c]) for c in combine.KEY_COLS)
        ts = (int(r[F.TS_HI]) << 32) | int(r[F.TS_LO])
        p, b, t = out.get(k, (0, 0, 0))
        out[k] = (min(p + int(r[F.PACKETS]), 0xFFFFFFFF),
                  min(b + int(r[F.BYTES]), 0xFFFFFFFF), max(t, ts))
    return out


# -- host functions against the reference ------------------------------------


def test_timestamps_and_pack_match_reference():
    rng = np.random.default_rng(1)
    rec = random_records(rng, 4096)
    assert wire.batch_ts_base(rec) == jwire.batch_ts_base(rec)
    base = jwire.batch_ts_base(rec)
    np.testing.assert_array_equal(wire.ts_rel(rec, base), jwire.ts_rel(rec, base))
    for r in (rec, rec[None], rec[:0]):
        for b in (None, np.uint64(base + (1 << 40))):  # an explicit base past some rows
            got, ref = wire.pack_records(r, b), jwire.pack_records(r, b)
            np.testing.assert_array_equal(got[0], ref[0])
            assert (int(got[1]), int(got[2])) == (int(ref[1]), int(ref[2]))
    # The native packer (2-D) against the reference's numpy lanes (3-D).
    out, lo, hi = wire.pack_records(rec)
    ref, rlo, rhi = jwire.pack_records(rec[None])
    np.testing.assert_array_equal(out, ref[0])
    assert (int(lo), int(hi)) == (int(rlo), int(rhi))
    np.testing.assert_array_equal(wire.unpack_records_numpy(out, lo, hi),
                                  jwire.unpack_records_numpy(out, lo, hi))


@pytest.mark.parametrize("id_bits", ID_BITS)
def test_known_and_dense_rows_match_reference(id_bits):
    rng = np.random.default_rng(id_bits)
    n = 777
    rows = traffic(id_bits, n)
    ids = rng.integers(0, 1 << id_bits, n, dtype=np.uint64).astype(np.uint32)
    rows[:, F.PACKETS] = rng.integers(0, 1 << wire.DENSE_PK_BITS, n)
    rows[:, F.BYTES] = rng.integers(0, 1 << wire.DENSE_BY_BITS, n)
    words = [np.zeros(wire.dense_words(n, id_bits), np.uint32) for _ in range(2)]
    wire.dense_known_rows(rows, ids, id_bits, words[0])
    jwire.dense_known_rows(rows, ids, id_bits, words[1])
    np.testing.assert_array_equal(words[0], words[1])
    assert wire.dense_words(n, id_bits) == jwire.dense_words(n, id_bits)
    assert wire.dense_row_bits(id_bits) == jwire.dense_row_bits(id_bits)
    for a, b in zip(wire.dense_known_unpack_numpy(words[0], n, id_bits),
                    jwire.dense_known_unpack_numpy(words[0], n, id_bits)):
        np.testing.assert_array_equal(a, b)
    if id_bits < 32:
        rows[:, F.PACKETS] = rng.integers(0, 1 << (32 - id_bits), n)
        two = [np.zeros((n, 2), np.uint32) for _ in range(2)]
        wire.known_rows(rows, ids, np.uint32(id_bits), two[0])
        jwire.known_rows(rows, ids, np.uint32(id_bits), two[1])
        np.testing.assert_array_equal(two[0], two[1])


def test_next_bucket_matches_reference():
    for n in list(range(0, 300)) + [4095, 4096, 4097, 6144, 6145, 131071, 197150, 1 << 21]:
        assert partition._next_bucket(n) == jpartition._next_bucket(n), n


@pytest.mark.parametrize("n_devices", [1, 4])
def test_partition_events_matches_reference(n_devices):
    rec = traffic(3, 3000)
    rec[::7, F.PACKETS] = 5
    for capacity, min_bucket in ((4096, None), (4096, 64), (1024, 64), (2048, 4096)):
        for r in (rec, rec[:0], rec[:1024]):
            got = partition.partition_events(r, n_devices, capacity, min_bucket)
            ref = jpartition.partition_events(r, n_devices, capacity, min_bucket)
            np.testing.assert_array_equal(got.records, ref.records)
            np.testing.assert_array_equal(got.n_valid, ref.n_valid)
            assert (got.lost, got.events, got.sample_k) == (ref.lost, ref.events, ref.sample_k)
    np.testing.assert_array_equal(partition.canonical_conn_hash(rec),
                                  jpartition.canonical_conn_hash(rec))


def test_combine_numpy_matches_reference():
    rec = np.concatenate([traffic(4, 4000, n_flows=200), random_records(np.random.default_rng(4), 64)])
    rec[::9, F.PACKETS] = 0xFFFFFFF0  # saturating sums
    got = combine.combine_records_numpy(rec)
    np.testing.assert_array_equal(got, jcombine.combine_records_numpy(rec))
    assert len(got) < len(rec)
    assert combine.KEY_COLS == jcombine.KEY_COLS


def _dict_runs(make_a, make_b, capacity, n_flows, batches, n=400, seed=0):
    a, b = make_a(capacity), make_b(capacity)
    gen = TrafficGen(n_flows=n_flows, n_pods=16, seed=seed + capacity)
    for _ in range(batches):
        rec = gen.batch(n)
        ids_a, new_a = a.lookup_or_assign(rec)
        ids_b, new_b = b.lookup_or_assign(rec)
        np.testing.assert_array_equal(ids_a, ids_b)
        np.testing.assert_array_equal(new_a, new_b)
        assert (len(a), a.generation) == (len(b), b.generation)
    return a


@pytest.mark.parametrize("capacity, n_flows, batches", [(1 << 10, 80, 3), (64, 200, 3),
                                                       (16, 400, 2)])
def test_host_flow_dict_matches_reference(capacity, n_flows, batches):
    d = _dict_runs(flowdict.HostFlowDict, jflowdict.HostFlowDict, capacity, n_flows, batches)
    assert flowdict.flow_dict_stats(d) == jflowdict.flow_dict_stats(d)


def test_host_flow_dict_overflow_clear_and_sentinel():
    d = flowdict.HostFlowDict(capacity=16)
    rec = random_records(np.random.default_rng(5), 200)  # 200 distinct descriptors
    ids, new = d.lookup_or_assign(rec[:8])
    assert new.all() and ids.min() >= 1 and d.generation == 0
    ids, new = d.lookup_or_assign(rec)  # cannot fit: clear, then ids for 15
    assert d.generation == 1 and len(d) == 15
    np.testing.assert_array_equal(ids, np.r_[np.arange(1, 16), np.zeros(185)])
    assert new.all()
    assert flowdict.flow_dict_stats(None) == {"enabled": False}


# -- the native copy -----------------------------------------------------------


def test_native_sources_are_the_reference_copies():
    for name in native.SOURCES:
        ref = native.SRC_DIR.parents[1] / "retina_tpu" / "native" / name
        assert (native.SRC_DIR / name).read_bytes() == ref.read_bytes(), name
    assert native.library_path().parent.name == ".torch_kernels"
    assert native.native_abi_version() == native.NATIVE_ABI_VERSION == jnative.native_abi_version()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "libmissing.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()
    bad = tmp_path / "cxx"
    bad.write_text("#!/bin/sh\necho broken >&2\nexit 3\n")
    bad.chmod(0o755)
    monkeypatch.setenv("CXX", str(bad))
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build()
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError):
        flowdict.make_flow_dict(64)


@pytest.mark.parametrize("capacity, n_flows, batches", [(1 << 10, 80, 3), (64, 200, 3),
                                                       (16, 400, 2)])
def test_native_flow_dict_matches_twin_and_reference(capacity, n_flows, batches):
    d = _dict_runs(flowdict.make_flow_dict, flowdict.HostFlowDict, capacity, n_flows, batches)
    d.close()
    d = _dict_runs(native.NativeFlowDict, jnative.NativeFlowDict, capacity, n_flows, batches,
                   seed=1)
    d.close()


def test_native_pack_matches_twin_and_reference():
    rec = random_records(np.random.default_rng(7), 4096)
    out, base = native.pack_native(rec)
    ref, rbase = jnative.pack_native(rec)
    np.testing.assert_array_equal(out, ref)
    assert base == rbase
    lanes, lo, hi = jwire.pack_records(rec[None])
    np.testing.assert_array_equal(out, lanes[0])
    assert base == (int(hi) << 32) | int(lo)
    base2 = base + (1 << 40)
    np.testing.assert_array_equal(native.pack_native(rec, base2)[0],
                                  jnative.pack_native(rec, base2)[0])
    out, base = native.pack_native(rec[:0])
    assert out.shape == (0, 12) and base == 0


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("id_bits", [12, 18, 21])
def test_native_flow_wire_matches_twin_and_reference(dense, id_bits):
    rng = np.random.default_rng(id_bits + dense)
    n = 3000
    rows = random_records(rng, n)
    ids = rng.integers(0, 1 << id_bits, n, dtype=np.uint64).astype(np.uint32)
    pk_bits = wire.DENSE_PK_BITS if dense else 32 - id_bits
    keep = rng.random(n) < 0.5  # some rows fit the narrow lanes
    rows[keep, F.PACKETS] &= (1 << pk_bits) - 1
    rows[keep, F.BYTES] &= (1 << wire.DENSE_BY_BITS) - 1
    sel = (rng.random(n) < 0.3) | (rows[:, F.PACKETS] >= (1 << pk_bits))
    if dense:
        sel |= rows[:, F.BYTES] >= (1 << wire.DENSE_BY_BITS)
    sel8 = sel.astype(np.uint8)
    n_new, n_known = int(sel.sum()), n - int(sel.sum())
    base = int(wire.batch_ts_base(rows))

    def outs():
        known = (np.zeros(wire.dense_words(n_known, id_bits), np.uint32) if dense
                 else np.zeros((n_known, 2), np.uint32))
        return np.zeros((n_new, 13), np.uint32), known

    args = (wire.DENSE_PK_BITS, wire.DENSE_BY_BITS) if dense else ()
    got, ref = outs(), outs()
    if dense:
        assert native.flowwire_dense_native(rows, ids, sel8, base, id_bits, *args, *got) == n_new
        assert jnative.flowwire_dense_native(rows, ids, sel8, base, id_bits, *args, *ref) == n_new
    else:
        assert native.flowwire_native(rows, ids, sel8, base, id_bits, *got) == n_new
        assert jnative.flowwire_native(rows, ids, sel8, base, id_bits, *ref) == n_new
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    # The numpy twins build the same wire.
    twin = outs()
    packed, _, _ = wire.pack_records(rows[sel][None], base=np.uint64(base))
    twin[0][:, 0] = ids[sel]
    twin[0][:, 1:] = packed[0]
    if dense:
        wire.dense_known_rows(rows[~sel], ids[~sel], id_bits, twin[1])
    else:
        wire.known_rows(rows[~sel], ids[~sel], np.uint32(id_bits), twin[1])
    np.testing.assert_array_equal(got[0], twin[0])
    np.testing.assert_array_equal(got[1], twin[1])


@pytest.mark.parametrize("threads", [1, 3])
def test_native_combine_matches_reference_and_twin(monkeypatch, threads):
    monkeypatch.setattr(native, "_combine_threads", threads)
    monkeypatch.setattr(jnative, "_combine_threads", threads)
    gen = TrafficGen(n_flows=3000, n_pods=32, seed=21)
    blocks = [gen.batch(max(k, 1))[:k] for k in (512, 1, 730, 0, 256, 8192, 3)]
    blocks.append(random_records(np.random.default_rng(2), 500))
    flat = np.concatenate(blocks)
    got = native.combine_native(flat)
    np.testing.assert_array_equal(got, jnative.combine_native(flat))
    assert key_map(got) == key_map(combine.combine_records_numpy(flat)) == key_map(flat)
    multi = native.combine_native_blocks(blocks)
    np.testing.assert_array_equal(multi, jnative.combine_native_blocks(blocks))
    if threads == 1:
        np.testing.assert_array_equal(multi, native.combine_native(flat))
    # The feed path's entry point, past the striped threshold when threaded.
    big = blocks + [gen.batch(1 << 16)]
    got = combine.combine_blocks(big)
    np.testing.assert_array_equal(got, jcombine.combine_blocks(big))
    assert key_map(got) == key_map(np.concatenate(big))
    striped = native.combine_native_blocks_striped(big, 4)
    np.testing.assert_array_equal(striped, jnative.combine_native_blocks_striped(big, 4))
    single = combine.combine_records(flat[:1])
    assert single is not None and len(single) == 1


# -- the card side's plain versions ---------------------------------------------


def test_unpack_plain_matches_reference_device_unpack():
    rng = np.random.default_rng(11)
    packed = rng.integers(0, 1 << 32, (2048, 12), dtype=np.uint64).astype(np.uint32)
    packed[::5, 0] = 0  # unstamped rows
    packed[1::5, 0] = 0xFFFFFFFF  # saturated spreads: the low word carries
    for lo, hi in ((0xFFFFFF00, 9), (0, 0), (0x12345678, 0xFFFFFFFF)):
        ref = np.asarray(jwire.unpack_records_device(jnp.asarray(packed), jnp.uint32(lo),
                                                     jnp.uint32(hi)))
        got = to_numpy(wire.unpack_records_plain(from_numpy(packed, "cpu"), lo, hi))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, wire.unpack_records_numpy(packed, lo, hi))


@pytest.mark.parametrize("id_bits", ID_BITS)
def test_dense_unpack_plain_matches_reference_device_unpack(id_bits):
    rng = np.random.default_rng(100 + id_bits)
    n = 1500
    words = rng.integers(0, 1 << 32, wire.dense_words(n, id_bits),
                         dtype=np.uint64).astype(np.uint32)
    ref = jwire.dense_known_unpack_device(jnp.asarray(words), n, id_bits)
    got = wire.dense_known_unpack_plain(from_numpy(words, "cpu"), n, id_bits)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))


# -- the three ingest functions against the reference engine's jits -------------


def _engines(slots: int, dense: bool, cap: int = 256, coalesce: int = 4):
    kw = dict(batch_capacity=cap, feed_coalesce_windows=coalesce, flow_dict_slots=slots,
              wire_dense_known=dense, transfer_min_bucket=64, identity_slots=1 << 8,
              n_pods=64, cms_width=1 << 10, topk_slots=1 << 6, hll_precision=8,
              entropy_buckets=1 << 8, conntrack_slots=1 << 8)
    jcfg, cfg = JConfig(), Config()
    for k, v in kw.items():
        setattr(jcfg, k, v)
        setattr(cfg, k, v)
    return JEngine(jcfg, devices=[jax.devices("cpu")[0]]), SketchEngine(cfg, device="cpu")


def _meta(lo, hi, now, lost, flag, n_valid):
    return jnp.asarray(np.array([lo, hi, now, lost, flag, n_valid], np.uint32))


def _compare_windows(jwins, jnvs, wins):
    assert len(jwins) == len(wins)
    for jw, jn, (w, n) in zip(jwins, jnvs, wins):
        np.testing.assert_array_equal(to_numpy(w), np.asarray(jw)[0])
        assert int(np.asarray(jn)[0]) == n


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("bucket, n_valid",
                         [(1024, 1000), (640, 640), (100, 37), (257, 257), (1000, 1000)])
def test_ingest_matches_reference_jit(packed, bucket, n_valid):
    jeng, eng = _engines(1 << 8, True)
    rng = np.random.default_rng(bucket)
    wire_np = rng.integers(0, 1 << 32, (bucket, 12 if packed else 16),
                           dtype=np.uint64).astype(np.uint32)
    wire_np[n_valid:] = 0
    wire_np[::7, 0] = 0
    lo, hi = 0xFFFFFF00, 3
    jwins, jnvs, now, lost = jeng._ingest_fn(bucket, packed)(
        jnp.asarray(wire_np[None]), _meta(lo, hi, 77, 5, 0, n_valid))
    assert (int(now), int(lost)) == (77, 5)
    kops.reset_launch_counts()
    wins = eng._ingest(bucket, packed, from_numpy(wire_np, "cpu"), lo, hi, n_valid)
    _compare_windows(jwins, jnvs, wins)
    assert kops.launch_counts()["ingest_packed"] == 0


def _new_wire(rng, bucket, n_valid, slots):
    """[id | 12 random lanes]; ids repeat (escalated rows, the sentinel),
    rows past n_valid are zero, as the engine ships them."""
    w = rng.integers(0, 1 << 32, (bucket, 13), dtype=np.uint64).astype(np.uint32)
    w[:, 0] = rng.integers(0, min(slots, 40), bucket)
    w[::3, 0] = 0
    w[::11, 1] = 0  # unstamped
    w[n_valid:] = 0
    return w


@pytest.mark.parametrize("slots", [2, 1 << 12, 1 << 18])
@pytest.mark.parametrize("bucket, n_valid", [(1024, 1000), (256, 256), (257, 257), (1000, 667)])
def test_ingest_new_matches_reference_jit(slots, bucket, n_valid):
    jeng, eng = _engines(slots, True)
    rng = np.random.default_rng(slots + bucket)
    w = _new_wire(rng, bucket, n_valid, slots)
    table = rng.integers(0, 1 << 32, (slots, 12), dtype=np.uint64).astype(np.uint32)
    lo, hi = 0xFFFFF000, 11
    jwins, jnvs, _, _, jtable = jeng._ingest_new_fn(bucket)(
        jnp.asarray(w[None]), _meta(lo, hi, 1, 0, 1, n_valid), jnp.asarray(table[None]))
    eng._desc_tables[0] = from_numpy(table, "cpu")
    eng._desc_winners[0] = torch.zeros(slots, dtype=torch.int32)
    wins = eng._ingest_new(bucket, from_numpy(w, "cpu"), lo, hi, n_valid)
    _compare_windows(jwins, jnvs, wins)
    np.testing.assert_array_equal(to_numpy(eng._desc_tables[0]), np.asarray(jtable)[0])


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("slots", [2, 1 << 12, 1 << 18, 1 << 13, 1 << 21])
def test_ingest_known_matches_reference_jit(dense, slots):
    jeng, eng = _engines(slots, dense)
    id_bits = eng._fd_id_bits
    assert id_bits == jeng._fd_id_bits
    rng = np.random.default_rng(slots + dense)
    bucket, n_valid = 1024, 900
    rows = np.zeros((n_valid, NUM_FIELDS), np.uint32)
    pk_bits = wire.DENSE_PK_BITS if dense else 32 - id_bits
    rows[:, F.PACKETS] = rng.integers(0, 1 << pk_bits, n_valid)
    rows[:, F.BYTES] = rng.integers(0, 1 << (wire.DENSE_BY_BITS if dense else 32), n_valid,
                                    dtype=np.uint64)
    ids = rng.integers(0, slots, n_valid).astype(np.uint32)
    if dense:
        w = np.zeros(wire.dense_words(bucket, id_bits), np.uint32)
        wire.dense_known_rows(rows, ids, id_bits, w)
    else:
        w = np.zeros((bucket, 2), np.uint32)
        wire.known_rows(rows, ids, np.uint32(id_bits), w[:n_valid])
    table = rng.integers(0, 1 << 32, (slots, 12), dtype=np.uint64).astype(np.uint32)
    for flag, (lo, hi) in ((1, (0xFFFFFFF0, 4)), (0, (0, 0))):
        jwins, jnvs, _, _ = jeng._ingest_known_fn(bucket)(
            jnp.asarray(w[None]), _meta(lo, hi, 1, 0, flag, n_valid), jnp.asarray(table[None]))
        eng._desc_tables[0] = from_numpy(table, "cpu")
        wins = eng._ingest_known(bucket, from_numpy(w, "cpu"), flag, lo, hi, n_valid)
        _compare_windows(jwins, jnvs, wins)


def _new_ids(pattern: str, bucket: int, rng) -> np.ndarray:
    """Ids of a new wire that meet the kernel's 256-row tiles at their edges:
    every row one id; ids that repeat across tile boundaries (row % 300,
    then reversed, so a tile's last row and a later tile's first share
    one)."""
    if pattern == "one id":
        return np.full(bucket, 5, np.uint32)
    ids = (np.arange(bucket) % 300).astype(np.uint32)
    return ids if pattern == "across tiles" else ids[::-1].copy()


@pytest.mark.parametrize("pattern", ["one id", "across tiles", "across tiles reversed"])
@pytest.mark.parametrize("bucket, n_valid", [(1000, 1000), (768, 512)])
def test_ingest_new_id_patterns_match_reference_jit(pattern, bucket, n_valid):
    """The last row in batch order writes a repeated id's slot wherever the
    id's rows fall among the tiles; (768, 512) is a wire a third of which is
    padding (id 0, zero lanes)."""
    slots = 1 << 12
    jeng, eng = _engines(slots, True)
    rng = np.random.default_rng(bucket + len(pattern))
    w = rng.integers(0, 1 << 32, (bucket, 13), dtype=np.uint64).astype(np.uint32)
    w[:, 0] = _new_ids(pattern, bucket, rng)
    w[n_valid:] = 0
    table = rng.integers(0, 1 << 32, (slots, 12), dtype=np.uint64).astype(np.uint32)
    lo, hi = 0xFFFFF000, 11
    jwins, jnvs, _, _, jtable = jeng._ingest_new_fn(bucket)(
        jnp.asarray(w[None]), _meta(lo, hi, 1, 0, 1, n_valid), jnp.asarray(table[None]))
    eng._desc_tables[0] = from_numpy(table, "cpu")
    eng._desc_winners[0] = torch.zeros(slots, dtype=torch.int32)
    wins = eng._ingest_new(bucket, from_numpy(w, "cpu"), lo, hi, n_valid)
    _compare_windows(jwins, jnvs, wins)
    np.testing.assert_array_equal(to_numpy(eng._desc_tables[0]), np.asarray(jtable)[0])


def _known_32(jeng, eng, dense, bucket, ids, rng):
    """A known-side wire at id_bits 32 (a dense row of 64 bits, a v3 row with
    no packet lane) of rows with these ids and random packets and bytes,
    through the reference's jit and the port on one random table: (the
    reference's windows, its counts, the port's windows)."""
    slots = eng.cfg.flow_dict_slots
    jeng._fd_id_bits = eng._fd_id_bits = 32
    n_valid = ids.size
    rows = np.zeros((n_valid, NUM_FIELDS), np.uint32)
    rows[:, F.PACKETS] = rng.integers(0, 1 << wire.DENSE_PK_BITS, n_valid) if dense else 0
    rows[:, F.BYTES] = rng.integers(0, 1 << (wire.DENSE_BY_BITS if dense else 32), n_valid,
                                    dtype=np.uint64)
    if dense:
        w = np.zeros(wire.dense_words(bucket, 32), np.uint32)
        wire.dense_known_rows(rows, ids, 32, w)
    else:
        w = np.zeros((bucket, 2), np.uint32)
        wire.known_rows(rows, ids, np.uint32(32), w[:n_valid])
    table = rng.integers(0, 1 << 32, (slots, 12), dtype=np.uint64).astype(np.uint32)
    jwins, jnvs, _, _ = jeng._ingest_known_fn(bucket)(
        jnp.asarray(w[None]), _meta(0xFFFFFFF0, 4, 1, 0, 1, n_valid), jnp.asarray(table[None]))
    eng._desc_tables[0] = from_numpy(table, "cpu")
    wins = eng._ingest_known(bucket, from_numpy(w, "cpu"), 1, 0xFFFFFFF0, 4, n_valid)
    return jwins, jnvs, wins


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("bucket, n_valid", [(257, 257), (1000, 1000), (1, 1)])
def test_ingest_known_at_32_id_bits_matches_reference_jit(dense, bucket, n_valid):
    """id_bits 32, buckets that end inside a tile; ids past the small table
    read its last slot. Those ids stay below 2^31, where the two rules agree:
    test_ingest_known_ids_past_2_31_read_last_slot pins the rest."""
    jeng, eng = _engines(1 << 10, dense)
    rng = np.random.default_rng(bucket + dense)
    ids = rng.integers(0, 1 << 31, n_valid, dtype=np.uint64).astype(np.uint32)
    ids[::2] %= 1 << 10
    _compare_windows(*_known_32(jeng, eng, dense, bucket, ids, rng))


@pytest.mark.parametrize("dense", [True, False])
def test_ingest_known_ids_past_2_31_read_last_slot(dense):
    """An id of 2^31 or more (only id_bits 32 carries one) reads the table's
    last slot in the port, as every id past the table does; the reference's
    gather reads it as slot 0 (a u32 index past int32), the divergence that
    ROADMAP §3 records. Both rules are pinned on the same rows: the port
    equals the reference with those ids set to the last slot, and the
    reference equals itself with them set to 0."""
    slots, bucket = 1 << 10, 300
    ids = np.random.default_rng(31).integers(0, 1 << 32, bucket, dtype=np.uint64)
    ids = ids.astype(np.uint32)
    ids[::3] %= slots
    high = ids >= 1 << 31
    assert high.any() and (~high & (ids >= slots)).any() and (ids < slots).any()
    jeng, eng = _engines(slots, dense)
    jwins, jnvs, wins = _known_32(jeng, eng, dense, bucket, ids, np.random.default_rng(1))
    jlast, jnv_last, _ = _known_32(jeng, eng, dense, bucket,
                                   np.where(high, slots - 1, ids).astype(np.uint32),
                                   np.random.default_rng(1))
    jzero, _, _ = _known_32(jeng, eng, dense, bucket, np.where(high, 0, ids).astype(np.uint32),
                            np.random.default_rng(1))
    _compare_windows(jlast, jnv_last, wins)
    for a, b in zip(jwins, jzero):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(jwins, jlast))


def test_ingest_windows_cover_coalesced_buckets():
    """A bucket of several windows: every window is (cap, 16), the last
    zero past the bucket, and the counts clip per window."""
    eng = _engines(1 << 8, True, cap=256, coalesce=4)[1]
    w = np.ones((640, 12), np.uint32)
    wins = eng._ingest(640, True, from_numpy(w, "cpu"), 0, 0, 600)
    assert [n for _, n in wins] == [256, 256, 88]
    assert all(t.shape == (256, 16) for t, _ in wins)
    assert not wins[-1][0][128:].any() and wins[-1][0][:128].any()
