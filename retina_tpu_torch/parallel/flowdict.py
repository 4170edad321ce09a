"""Host-side flow-descriptor dictionary (copy of retina_tpu/parallel/flowdict.py).

Across flush quanta the same descriptors recur (flows are long-lived).
Every distinct descriptor gets a stable id once: its 12 packed lanes cross
the host-to-card link once (a "new" row) and land in the card's descriptor
table at that slot, and every later occurrence crosses as a few bytes of
[id, packets, bytes] (the known wire, parallel/wire.py) against the table.

Capacity contract: ids are slots in the card's table. When a batch would
overflow it, the dictionary CLEARS and bumps its generation, and every
flow is new again (a one-quantum re-upload burst, not an error). Slot 0 is
never assigned: rows beyond capacity get id 0 and ship as full rows that
write the sacrificial slot 0. The engine never references an id the
current generation did not assign, and the new side of a flush runs before
its known side, so a slot is always written before it is read.

``make_flow_dict`` returns the native dictionary (``native/flowdict.cpp``)
and raises if it cannot; ``HostFlowDict`` is its Python twin, the
reference the tests hold it against.
"""

from __future__ import annotations

import numpy as np

from retina_tpu_torch.parallel.combine import KEY_COLS

_KEY_COLS = np.asarray(KEY_COLS, np.int64)


class HostFlowDict:
    """descriptor bytes -> stable card-table slot id."""

    def __init__(self, capacity: int = 1 << 20):
        self.capacity = int(capacity)
        self.generation = 0
        self._ids: dict[bytes, int] = {}

    def __len__(self) -> int:
        return len(self._ids)

    def clear(self) -> None:
        self._ids.clear()
        self.generation += 1

    def lookup_or_assign(self, records: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(N, >=16) records -> (ids (N,) u32, is_new (N,) bool).

        Fresh ids go to unseen descriptors in row order. If the batch would
        overflow capacity the dictionary clears first; descriptors beyond
        capacity get id 0 with ``is_new`` True.
        """
        n = len(records)
        ids = np.zeros(n, np.uint32)
        is_new = np.zeros(n, bool)
        if n == 0:
            return ids, is_new
        descs = np.ascontiguousarray(records[:, _KEY_COLS].astype(np.uint32, copy=False))
        keys = descs.view(np.dtype((np.void, descs.shape[1] * 4))).ravel()
        table = self._ids
        # Pessimistic overflow check: clearing mid-batch would reference
        # ids of a generation that no longer exists.
        if len(table) + n > self.capacity:
            fresh = set(keys.tolist()) - table.keys()
            if len(table) + len(fresh) > self.capacity:
                self.clear()
                table = self._ids
        next_id = len(table) + 1  # slot 0 is the overflow sentinel
        for i, k in enumerate(keys.tolist()):
            got = table.get(k)
            if got is None:
                is_new[i] = True
                if next_id < self.capacity:
                    table[k] = next_id
                    ids[i] = next_id
                    next_id += 1
            else:
                ids[i] = got
        return ids, is_new


def flow_dict_stats(fd) -> dict:
    """Residency summary of either dictionary (None when there is none)."""
    if fd is None:
        return {"enabled": False}
    return {
        "enabled": True,
        "entries": len(fd),
        "capacity": int(fd.capacity),
        "generation": int(fd.generation),
    }


def make_flow_dict(capacity: int):
    """The native dictionary; raises if the native library cannot load."""
    from retina_tpu_torch.native import NativeFlowDict

    return NativeFlowDict(capacity)
