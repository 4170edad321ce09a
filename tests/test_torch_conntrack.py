"""The port's ConntrackTable.process against the reference's on the same
numpy inputs (CPU, plain version).

Every output is compared exactly after every call: the table's keys and
vals, report_mask, is_reply and both payloads. The cases are the reference
test file's hand-built scenarios, TrafficGen batches through 2^8 slots (so
connections of one batch often share a slot) over a clock that crosses the
lifetimes, the report interval and the 16-bit wrap, masked and garbage
rows past n_valid, and fingerprints with fp_lo >= 2^31 sharing slots.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retina_tpu.events.schema import F, TCP_ACK, TCP_FIN, TCP_RST, TCP_SYN, pack_ports
from retina_tpu.events.synthetic import TrafficGen as JTrafficGen
from retina_tpu.ops.conntrack import CT_REPORT_INTERVAL
from retina_tpu.ops.conntrack import ConntrackTable as JTable
from retina_tpu_torch.ops.conntrack import LANES, ConntrackTable, fingerprint
from retina_tpu_torch.u32 import from_numpy, to_numpy

COLS = ("src_ip", "dst_ip", "ports", "proto", "tcp_flags", "bytes_")


class Pair:
    """One reference table and one port table fed the same calls."""

    def __init__(self, n_slots: int, seed: int = 0):
        self.ref = JTable.zeros(n_slots, seed=seed)
        self.port = ConntrackTable.zeros(n_slots, seed=seed, device="cpu")

    def call(self, cols: dict[str, np.ndarray], now: int, mask: np.ndarray | None = None,
             packets: np.ndarray | None = None):
        b = len(cols["src_ip"])
        mask = np.ones(b, bool) if mask is None else mask
        self.ref, *jout = self.ref.process(
            **{k: jnp.asarray(cols[k].astype(np.uint32)) for k in COLS},
            now_s=jnp.uint32(now), mask=jnp.asarray(mask),
            packets_=None if packets is None else jnp.asarray(packets.astype(np.uint32)),
        )
        self.port, *tout = self.port.process(
            **{k: from_numpy(cols[k].astype(np.uint32), "cpu") for k in COLS},
            now_s=now, mask=torch.from_numpy(mask),
            packets_=None if packets is None else from_numpy(packets.astype(np.uint32), "cpu"),
        )
        np.testing.assert_array_equal(to_numpy(self.port.keys), np.asarray(self.ref.keys))
        np.testing.assert_array_equal(to_numpy(self.port.vals), np.asarray(self.ref.vals))
        for name, j, t in zip(LANES, jout, tout):
            j = np.asarray(j)
            if j.dtype == bool:
                assert t.dtype == torch.bool, name
                np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
            else:
                assert t.dtype == torch.int32, name
                np.testing.assert_array_equal(to_numpy(t), j, err_msg=name)
        return [np.asarray(j) for j in jout]


def _conn(src, dst, sport, dport, flags, proto=6, n=1, nbytes=100):
    full = lambda v: np.full(n, v, np.int64)  # noqa: E731
    return dict(src_ip=full(src), dst_ip=full(dst), ports=full(pack_ports(sport, dport)),
                proto=full(proto), tcp_flags=full(flags), bytes_=full(nbytes))


def _cat(*parts):
    return {k: np.concatenate([p[k] for p in parts]) for k in COLS}


# The reference test file's scenarios, as (n_slots, [(batch, now), ...]).
SCENARIOS = {
    "syn_reports": (1 << 10, [(_conn(1, 2, 1000, 80, TCP_SYN), 100)]),
    "interval": (1 << 10, [(_conn(1, 2, 1000, 80, TCP_SYN), 100)]
                 + [(_conn(1, 2, 1000, 80, TCP_ACK), t)
                    for t in range(101, 101 + 2 * CT_REPORT_INTERVAL)]),
    "in_batch_dedup": (1 << 10, [(_conn(1, 2, 1000, 80, TCP_SYN), 100),
                                 (_conn(1, 2, 1000, 80, TCP_ACK, n=100), 131)]),
    "reply": (1 << 10, [(_conn(1, 2, 1000, 80, TCP_SYN), 10),
                        (_conn(2, 1, 80, 1000, TCP_ACK), 11)]),
    "fin_then_expiry": (1 << 10, [(_conn(1, 2, 1000, 80, TCP_SYN), 10),
                                  (_conn(1, 2, 1000, 80, TCP_FIN), 11),
                                  (_conn(1, 2, 1000, 80, TCP_ACK), 1000)]),
    "distinct_connections": (1 << 12, [(_conn(1, 2, 1000, 80, TCP_ACK), 50),
                                       (_conn(3, 4, 1000, 80, TCP_ACK), 50),
                                       (_conn(1, 2, 1000, 80, TCP_ACK), 51)]),
    "payload": (1 << 10, [(_conn(1, 2, 1000, 80, TCP_SYN), 100)]
                + [(_conn(1, 2, 1000, 80, TCP_ACK), t) for t in range(101, 106)]
                + [(_conn(1, 2, 1000, 80, TCP_ACK), 100 + CT_REPORT_INTERVAL)]),
    "hairpin": (1 << 10, [(_conn(7, 7, 1000, 80, TCP_SYN), 10),
                          (_conn(7, 7, 80, 1000, TCP_ACK), 11)]),
    "udp_expiry": (1 << 10, [(_conn(1, 2, 53, 53, 0, proto=17), 100),
                             (_conn(3, 4, 1000, 80, TCP_ACK), 100),
                             (_conn(1, 2, 53, 53, 0, proto=17), 200),
                             (_conn(3, 4, 1000, 80, TCP_ACK), 200)]),
    "batch_order_positions": (1 << 10, [(_cat(
        _conn(1, 2, 1000, 80, TCP_ACK, nbytes=10), _conn(1, 2, 1000, 80, TCP_ACK, nbytes=10),
        _conn(3, 4, 2000, 443, TCP_ACK, nbytes=10), _conn(1, 2, 1000, 80, TCP_ACK, nbytes=10),
        _conn(3, 4, 2000, 443, TCP_ACK, nbytes=10)), 100)]),
    "clock_skew": (1 << 10, [(_conn(1, 2, 1000, 80, TCP_ACK), 101),
                             (_conn(1, 2, 1000, 80, TCP_ACK), 100)]),
    "rst_and_mixed_directions": (1 << 10, [(_cat(
        _conn(5, 9, 4000, 22, TCP_SYN), _conn(9, 5, 22, 4000, TCP_ACK),
        _conn(5, 9, 4000, 22, TCP_RST)), 7), (_conn(9, 5, 22, 4000, TCP_ACK, n=3), 8)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_reference_scenarios(name):
    n_slots, calls = SCENARIOS[name]
    pair = Pair(n_slots)
    outs = [pair.call(batch, now) for batch, now in calls]
    if name == "batch_order_positions":
        rep, _, pk, by = outs[0]
        assert list(rep) == [False, False, False, True, True]
        assert (pk[3], by[3], pk[4], by[4]) == (3, 30, 2, 20)
    if name == "interval":
        assert sum(int(o[0][0]) for o in outs[1:]) == 2


def _traffic(seed, n, rng_seed):
    gen = JTrafficGen(n_flows=300, n_pods=40, seed=seed)
    rec = gen.batch(n)
    rng = np.random.default_rng(rng_seed)
    flags = np.where(rng.random(n) < 0.03, TCP_FIN, 0) | np.where(rng.random(n) < 0.02,
                                                                 TCP_RST, 0)
    cols = dict(src_ip=rec[:, F.SRC_IP], dst_ip=rec[:, F.DST_IP], ports=rec[:, F.PORTS],
                proto=rec[:, F.META] >> np.uint32(24),
                tcp_flags=((rec[:, F.META] >> np.uint32(16)) & np.uint32(0xFF)) | flags,
                bytes_=rec[:, F.BYTES])
    # Reply direction for a third of the rows.
    flip = rng.random(n) < 0.33
    cols["src_ip"], cols["dst_ip"] = (np.where(flip, cols["dst_ip"], cols["src_ip"]),
                                      np.where(flip, cols["src_ip"], cols["dst_ip"]))
    p = cols["ports"]
    cols["ports"] = np.where(flip, ((p & 0xFFFF) << 16) | (p >> 16), p).astype(np.uint32)
    packets = rng.integers(1, 1 << 31, n).astype(np.uint32)  # sums wrap mod 2^32
    return cols, packets


# now_s over the report interval, both lifetimes, the 14- and 16-bit wraps
# and a clock that steps back.
CLOCK = [100, 101, 131, 200, 465, 600, 16_480, 65_530, 65_700, 65_690, 70_000]


@pytest.mark.parametrize("packets", [True, False], ids=["packets", "one_per_row"])
def test_traffic_through_shared_slots_over_the_clock(packets):
    pair = Pair(1 << 8, seed=8)
    for t, now in enumerate(CLOCK):
        cols, pk = _traffic(seed=t % 3, n=512, rng_seed=t)
        pair.call(cols, now, packets=pk if packets else None)
    assert int(pair.port.active_connections(CLOCK[-1])) > 0


def test_masked_and_garbage_rows_past_n_valid():
    pair = Pair(1 << 8, seed=3)
    rng = np.random.default_rng(4)
    for t, now in enumerate(CLOCK[:5]):
        cols, pk = _traffic(seed=1, n=400, rng_seed=10 + t)
        n_valid = 250 + 30 * t
        for k in COLS:
            cols[k][n_valid:] = rng.integers(0, 1 << 32, 400 - n_valid, dtype=np.uint64)
        pk[n_valid:] = rng.integers(0, 1 << 32, 400 - n_valid, dtype=np.uint64)
        mask = np.arange(400) < n_valid
        mask[::7] = False  # filtered rows inside the valid range
        rep, reply, rp, rb = pair.call(cols, now, mask=mask, packets=pk)
        assert not rep[~mask].any() and not reply[~mask].any()
        assert not rp[~mask].any() and not rb[~mask].any()


def test_shared_slot_written_by_largest_unsigned_key():
    """Connections of one batch sharing a slot, with fp_lo on both sides of
    2^31: the one with the largest unsigned (fp_lo, fp_hi) owns the slot."""
    n_slots, seed = 1 << 4, 8
    rng = np.random.default_rng(12)
    cols = dict(src_ip=rng.integers(1, 1 << 32, 64, dtype=np.uint64),
                dst_ip=rng.integers(1, 1 << 32, 64, dtype=np.uint64),
                ports=rng.integers(0, 1 << 32, 64, dtype=np.uint64),
                proto=np.full(64, 6, np.int64), tcp_flags=np.full(64, TCP_ACK, np.int64),
                bytes_=np.full(64, 60, np.int64))
    lo, hi, _ = fingerprint(*(torch.from_numpy(cols[k].astype(np.int64))
                              for k in ("src_ip", "dst_ip", "ports", "proto")), seed)
    lo, hi = lo.numpy(), hi.numpy()
    slot = (lo ^ hi) & (n_slots - 1)
    shared = [s for s in range(n_slots)
              if (lo[slot == s] >= 1 << 31).any() and (lo[slot == s] < 1 << 31).any()]
    assert shared, "the draw has no slot shared across the sign bit"
    pair = Pair(n_slots, seed=seed)
    pair.call(cols, 100)
    keys = to_numpy(pair.port.keys)
    for s in shared:
        k = max(zip(lo[slot == s], hi[slot == s]))
        assert tuple(keys[s]) == k
