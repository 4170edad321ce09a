"""Connection table state (port of the state half of retina_tpu/ops/conntrack.py).

The scrape snapshot reads ``active_connections``, so the table and its
gauge are here. ``process`` (fingerprint, stable sort, segmented scan,
report decision, row scatters) is not ported yet: see ROADMAP.md, the
conntrack item of the port's queue.
"""

from __future__ import annotations

import dataclasses

import torch

from retina_tpu_torch.u32 import widen

CT_REPORT_INTERVAL = 30
CT_TCP_LIFETIME = 360
CT_NON_TCP_LIFETIME = 60
DEFAULT_SLOTS = 1 << 18
CLOCK_SKEW_SLACK = 256


@dataclasses.dataclass
class ConntrackTable:
    """Direct-mapped connection table.

    keys: (S, 2) u32 [fp_lo, fp_hi]; (0, 0) marks an empty slot.
    vals: (S, 4) u32 [meta, packets, bytes, spare] where meta =
          seen16 | report14 << 16 | init_is_a << 30 | is_tcp << 31.
    """

    keys: torch.Tensor
    vals: torch.Tensor
    seed: int = 0

    @classmethod
    def zeros(cls, n_slots: int = DEFAULT_SLOTS, seed: int = 0,
              device: torch.device | str = "cpu") -> "ConntrackTable":
        if n_slots & (n_slots - 1):
            raise ValueError("n_slots must be a power of two")
        return cls(
            keys=torch.zeros((n_slots, 2), dtype=torch.int32, device=device),
            vals=torch.zeros((n_slots, 4), dtype=torch.int32, device=device),
            seed=seed,
        )

    @property
    def n_slots(self) -> int:
        return int(self.keys.shape[0])

    def process(self, *args, **kwargs):
        raise NotImplementedError(
            "ConntrackTable.process is not ported yet (ROADMAP.md, port queue: "
            "conntrack process)"
        )

    def active_connections(self, now_s: int) -> torch.Tensor:
        """int32 count of non-expired resident connections."""
        live = (self.keys[:, 0] | self.keys[:, 1]) != 0
        meta = widen(self.vals[:, 0])
        seen16 = meta & 0xFFFF
        is_tcp = (meta >> 31) > 0
        lifetime = torch.where(is_tcp, CT_TCP_LIFETIME, CT_NON_TCP_LIFETIME)
        idle = ((int(now_s) & 0xFFFFFFFF) - seen16) & 0xFFFF
        fresh = (idle <= lifetime) | (idle > 0xFFFF - CLOCK_SKEW_SLACK)
        return (live & fresh).sum().to(torch.int32)
