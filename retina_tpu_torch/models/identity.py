"""IP -> pod-index identity map (port of retina_tpu/models/identity.py).

Device side: one packed (S, 2) u32 table of [ip key, pod index] rows, a
2-choice cuckoo table; ``ip == 0`` marks an empty slot. A lookup is two row
gathers and two compares. On the main path the lookups run inside K1
(``kernels/csrc/step_rows.cu``); ``lookup_plain`` is their plain version.

Host side: ``HostIdentityTable``, a numpy cuckoo table with incremental
insert/remove whose table is bit-identical to the reference's for the same
inserts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from retina_tpu_torch._device import resolve_device
from retina_tpu_torch.ops.hashing import hash_cols, hash_cols_np, reduce_range, reduce_range_np
from retina_tpu_torch.u32 import from_numpy, widen

_SEED_A = 0x1DE47
_SEED_B = 0xB0A711
_MAX_KICKS = 512


def _slots_np(ips: np.ndarray, n_slots: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    ips = np.asarray(ips, np.uint32)
    a = reduce_range_np(hash_cols_np([ips], np.uint32(_SEED_A) + np.uint32(seed)), n_slots)
    b = reduce_range_np(hash_cols_np([ips], np.uint32(_SEED_B) + np.uint32(seed)), n_slots)
    return a, b


def lookup_plain(table: torch.Tensor, seed: int, ip: torch.Tensor) -> torch.Tensor:
    """(B,) IPs -> (B,) int64 pod indices (0 = unknown)."""
    s = table.shape[0]
    h1 = reduce_range(hash_cols([ip], (_SEED_A + seed) & 0xFFFFFFFF), s)
    h2 = reduce_range(hash_cols([ip], (_SEED_B + seed) & 0xFFFFFFFF), s)
    t = widen(table)
    ip = widen(ip)
    r1, r2 = t[h1], t[h2]
    out = torch.where(r1[:, 0] == ip, r1[:, 1], 0)
    return torch.where(r2[:, 0] == ip, r2[:, 1], out)


@dataclasses.dataclass
class IdentityMap:
    """(S, 2) packed [ip key, pod index] rows; ip==0 marks an empty slot."""

    table: torch.Tensor  # (S, 2) int32
    seed: int = 0

    @classmethod
    def zeros(cls, n_slots: int = 1 << 16, seed: int = 0,
              device: torch.device | str | None = None) -> "IdentityMap":
        if n_slots & (n_slots - 1):
            raise ValueError("n_slots must be a power of two")
        return cls(torch.zeros((n_slots, 2), dtype=torch.int32,
                               device=resolve_device(device)), seed)

    @property
    def n_slots(self) -> int:
        return int(self.table.shape[0])

    @classmethod
    def build_host(cls, ip_to_index: dict[int, int], n_slots: int = 1 << 16,
                   seed: int = 0, device: torch.device | str | None = None) -> "IdentityMap":
        """Host-side construction from an ip -> pod-index dict."""
        host = HostIdentityTable(n_slots=n_slots, seed=seed)
        items = [(ip, idx) for ip, idx in ip_to_index.items() if ip != 0]
        if len(items) > host.capacity:
            raise ValueError(
                f"identity map overfull: {len(items)} pods into {n_slots} slots"
            )
        for ip, idx in items:
            host.insert(ip, idx)
        return host.to_device(device)

    def lookup(self, ip: torch.Tensor) -> torch.Tensor:
        """(B,) IPs -> (B,) int64 pod indices (0 = unknown)."""
        return lookup_plain(self.table, self.seed, ip)


class HostIdentityTable:
    """Host numpy mirror of an IdentityMap with incremental churn."""

    def __init__(self, n_slots: int = 1 << 16, seed: int = 0):
        if n_slots & (n_slots - 1):
            raise ValueError("n_slots must be a power of two")
        self.n_slots = n_slots
        self.seed = seed
        self.table = np.zeros((n_slots, 2), np.uint32)
        self.n_keys = 0

    @property
    def capacity(self) -> int:
        """Max keys (50% load factor keeps cuckoo eviction chains short)."""
        return self.n_slots // 2

    def _slots(self, ip: int) -> tuple[int, int]:
        a, b = _slots_np(np.array([ip], np.uint32), self.n_slots, self.seed)
        return int(a[0]), int(b[0])

    def insert(self, ip: int, index: int) -> None:
        """Insert/overwrite one mapping (cuckoo with bounded eviction)."""
        if ip == 0:
            return
        cur_ip, cur_idx = np.uint32(ip), np.uint32(index)
        s1, s2 = self._slots(int(cur_ip))
        for s in (s1, s2):
            if self.table[s, 0] == cur_ip:
                self.table[s, 1] = cur_idx
                return
        if self.n_keys >= self.capacity:
            raise ValueError(
                f"identity map overfull: {self.n_keys + 1} pods into "
                f"{self.n_slots} slots"
            )
        target = s1
        for _ in range(_MAX_KICKS):
            if self.table[target, 0] == 0:
                self.table[target] = (cur_ip, cur_idx)
                self.n_keys += 1
                return
            evict_ip, evict_idx = self.table[target]
            self.table[target] = (cur_ip, cur_idx)
            cur_ip, cur_idx = evict_ip, evict_idx
            a, b = self._slots(int(cur_ip))
            target = b if target == a else a
        # Eviction cycle: rebuild with a bumped seed, then place the key.
        self._reseed()
        self.insert(int(cur_ip), int(cur_idx))

    def _reseed(self) -> None:
        entries = self.table[self.table[:, 0] != 0]
        self.seed += 1
        self.table = np.zeros((self.n_slots, 2), np.uint32)
        self.n_keys = 0
        for ip, idx in entries:
            self.insert(int(ip), int(idx))

    def remove(self, ip: int) -> None:
        s1, s2 = self._slots(ip)
        for s in (s1, s2):
            if self.table[s, 0] == np.uint32(ip):
                self.table[s] = (0, 0)
                self.n_keys -= 1
                return

    def get(self, ip: int) -> int | None:
        s1, s2 = self._slots(ip)
        for s in (s1, s2):
            if self.table[s, 0] == np.uint32(ip):
                return int(self.table[s, 1])
        return None

    def to_device(self, device: torch.device | str | None = None) -> IdentityMap:
        return IdentityMap(table=from_numpy(self.table, resolve_device(device)),
                           seed=self.seed)
