"""Looping pcap replay (port of retina_tpu/sources/pcapreplay.py).

- **Timestamp rebasing**: each pass re-emits the capture shifted forward by
  ``pass_index * (capture_span + one median inter-packet gap)``, so
  TS_LO/TS_HI advance monotonically across loop seams.
- **Graceful degradation**: truncated or garbage pcap bytes decode to an
  empty or partial record set with a counted drop instead of raising: a bad
  capture file is an operational input, not a programming error.

Built on ``sources/pcapdecode.py`` (``decode_pcap_bytes``).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterator

import numpy as np

from retina_tpu_torch.events.schema import NUM_FIELDS, F
from retina_tpu_torch.sources.pcapdecode import (
    PCAP_MAGIC_NS,
    PCAP_MAGIC_US,
    PcapDecodeResult,
    decode_pcap_bytes,
)

_SWAPPED = {int.from_bytes(m.to_bytes(4, "little"), "big") for m in (PCAP_MAGIC_US, PCAP_MAGIC_NS)}


def _undecoded_tail(data: bytes) -> int:
    """Bytes after the last complete pcap record: nonzero for a capture cut
    mid-record (or mid-header); 0 for a clean file or an unrecognizable
    blob."""
    if not data:
        return 0
    if len(data) < 24:
        return len(data)  # not even a global header
    magic = struct.unpack_from("<I", data)[0]
    if magic in (PCAP_MAGIC_US, PCAP_MAGIC_NS):
        fmt = "<IIII"
    elif magic in _SWAPPED:
        fmt = ">IIII"
    else:
        return 0
    unpack = struct.Struct(fmt).unpack_from
    off = 24
    while off + 16 <= len(data):
        _, _, incl, _ = unpack(data, off)
        if off + 16 + incl > len(data):
            break
        off += 16 + incl
    return len(data) - off


@dataclasses.dataclass
class SafeDecode:
    """Outcome of a tolerant decode: always usable, never raises."""

    result: PcapDecodeResult
    dropped: int  # packets (or whole blobs) that could not decode
    error: str = ""  # non-empty when the blob itself was undecodable


def safe_decode_bytes(data: bytes, **kw) -> SafeDecode:
    """Decode pcap bytes, degrading instead of raising: a truncated tail
    counts one drop; garbage yields an empty result with ``dropped=1`` and
    the error."""
    try:
        res = decode_pcap_bytes(data, **kw)
    except Exception as e:  # operator input: degrade, do not crash
        empty = PcapDecodeResult(records=np.zeros((0, NUM_FIELDS), np.uint32),
                                 dns_names={}, n_packets_total=0, n_decoded=0)
        return SafeDecode(empty, dropped=1, error=f"{type(e).__name__}: {e}")
    dropped = res.n_packets_total - res.n_decoded
    if _undecoded_tail(data):
        dropped += 1  # the truncated trailing record
    return SafeDecode(res, dropped=dropped)


def _ts_ns(records: np.ndarray) -> np.ndarray:
    """(N,) uint64 timestamps from the TS_LO/TS_HI u32 lanes."""
    return (records[:, F.TS_HI].astype(np.uint64) << np.uint64(32)) | records[
        :, F.TS_LO].astype(np.uint64)


class PcapReplaySource:
    """Block iterator over decoded records with per-pass timestamp
    rebasing; the source array is never mutated."""

    def __init__(self, records: np.ndarray, block: int = 8192):
        self.records = records
        self.block = max(1, int(block))
        if len(records):
            ts = _ts_ns(records)
            span = int(ts.max()) - int(ts.min())
            # Seam gap: the median inter-packet gap (1 us floor).
            gaps = np.diff(np.sort(ts)).astype(np.int64)
            gap = int(np.median(gaps)) if len(gaps) else 0
            self.pass_stride_ns = span + max(gap, 1_000)
        else:
            self.pass_stride_ns = 0
        self.passes_done = 0

    def __len__(self) -> int:
        return len(self.records)

    def _rebase(self, block: np.ndarray, shift_ns: int) -> np.ndarray:
        if shift_ns == 0:
            return block
        out = block.copy()
        ts = _ts_ns(out) + np.uint64(shift_ns)
        out[:, F.TS_LO] = (ts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        out[:, F.TS_HI] = (ts >> np.uint64(32)).astype(np.uint32)
        return out

    def blocks(self) -> Iterator[np.ndarray]:
        """One full pass of block-sized slices, rebased for the current pass
        index; call again for the next pass."""
        shift = self.passes_done * self.pass_stride_ns
        for pos in range(0, len(self.records), self.block):
            yield self._rebase(self.records[pos: pos + self.block], shift)
        self.passes_done += 1
