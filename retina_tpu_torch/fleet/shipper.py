"""Window epochs of the fleet tier (from retina_tpu/fleet/shipper.py).

Only ``window_epoch`` is ported: the engine stamps each window-close export
with it. The shipper itself (queue, spool, backoff, the gRPC relay) waits
for the port's transport.
"""

from __future__ import annotations

import time


def window_epoch(window_s: float, now: float | None = None) -> int:
    """Wall-clock window epoch, aligned across nodes whose clocks are
    NTP-close (a skew below window_s/2 lands in the right bucket; the
    aggregator's straggler timeout absorbs the rest)."""
    now = time.time() if now is None else now
    return int(now // max(window_s, 1e-6))
