"""The port's native host helpers: a build at first use and ctypes bindings.

Every source is a copy of the reference's in ``retina_tpu/native/`` (the C
interface and ``rt_abi_version``, defined in ``decoder.cpp``, are the same):

- ``combine.cpp``, ``flowdict.cpp``, ``pack.cpp``: the feed path's host
  side (the descriptor combiner, the flow dictionary, the wire packers);
- ``decoder.cpp``: pcap bytes to (N, 16) event records,
  :func:`decode_pcap_native`, bit-identical to the numpy decoder of
  ``sources/pcapdecode.py``;
- ``ring.cpp``: :class:`NativeRing`, a single-producer single-consumer
  record ring in private memory or an mmap'd file shared across processes;
- ``afpacket.cpp``: :class:`AfPacketRing`, the TPACKET_V3 live capture
  that packetparser reads on a node.

The library builds on first use with ``g++ -O3 -std=c++17 -fPIC -shared
-pthread`` into ``.torch_kernels/`` beside the package (gitignored), named by
a hash of the sources and flags, so an edited source rebuilds. Importing
this module needs no compiler. Unlike the reference's loader, a build or
load that fails raises: there is no Python fallback here. The numpy twins
(``parallel/combine.py``, ``parallel/flowdict.py``, ``parallel/wire.py``)
are the references the tests hold the library against, not stand-ins.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from retina_tpu_torch.events.schema import NUM_FIELDS
from retina_tpu_torch.kernels.build import BUILD_DIR

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("decoder.cpp", "ring.cpp", "combine.cpp", "afpacket.cpp", "flowdict.cpp",
           "pack.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
# ABI the bindings below expect (decoder.cpp rt_abi_version; the reference's
# NATIVE_ABI_VERSION for the same interface).
NATIVE_ABI_VERSION = 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_U32P = ctypes.POINTER(ctypes.c_uint32)


def compiler() -> str:
    """Path of the C++ compiler: $CXX, else g++ on $PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or ""
    if not cxx or not (os.path.isfile(cxx) or shutil.which(cxx)):
        raise RuntimeError("g++ not found: the native host helpers cannot be built")
    return cxx


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libretina_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the current one exists; raise on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), *(str(SRC_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    sz, vp, u32, u8p = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_uint32, ctypes.POINTER(
        ctypes.c_uint8)
    blocks = [ctypes.POINTER(_U32P), ctypes.POINTER(sz), sz, _U32P, sz]
    sigs = {
        "rt_combine": (ctypes.c_long, [_U32P, sz, _U32P]),
        "rt_combine_hint": (ctypes.c_long, [_U32P, sz, _U32P, sz]),
        "rt_combine_mt": (ctypes.c_long, [_U32P, sz, _U32P, sz, ctypes.c_uint]),
        "rt_combine_multi": (ctypes.c_long, blocks),
        "rt_combine_stripe": (ctypes.c_long, blocks + [u32, u32]),
        "rt_flowdict_new": (vp, [u32]),
        "rt_flowdict_free": (None, [vp]),
        "rt_flowdict_clear": (None, [vp]),
        "rt_flowdict_len": (u32, [vp]),
        "rt_flowdict_generation": (u32, [vp]),
        "rt_flowdict_assign": (u32, [vp, _U32P, sz, _U32P, u8p]),
        "rt_ts_base": (ctypes.c_uint64, [_U32P, sz]),
        "rt_pack": (None, [_U32P, sz, ctypes.c_uint64, _U32P]),
        "rt_flowwire": (ctypes.c_long, [_U32P, sz, _U32P, u8p, ctypes.c_uint64, u32,
                                        _U32P, _U32P]),
        "rt_flowwire_dense": (ctypes.c_long, [_U32P, sz, _U32P, u8p, ctypes.c_uint64,
                                              u32, u32, u32, _U32P, _U32P]),
        "rt_abi_version": (u32, []),
        "rt_decode_pcap": (ctypes.c_long, [ctypes.c_char_p, sz, u32, _U32P, sz,
                                           ctypes.POINTER(sz)]),
        "rt_afp_open": (vp, [ctypes.c_char_p, u32, u32]),
        "rt_afp_poll": (ctypes.c_long, [vp, u32, u32, _U32P, sz,
                                        ctypes.POINTER(ctypes.c_uint64), u8p, sz,
                                        ctypes.POINTER(sz)]),
        "rt_afp_drops": (ctypes.c_uint64, [vp]),
        "rt_afp_close": (None, [vp]),
        "rt_ring_bytes": (sz, [ctypes.c_uint64, u32]),
        "rt_ring_init": (ctypes.c_int, [vp, ctypes.c_uint64, u32]),
        "rt_ring_check": (ctypes.c_int, [vp, u32]),
        "rt_ring_push": (ctypes.c_uint64, [vp, _U32P, ctypes.c_uint64]),
        "rt_ring_pop": (ctypes.c_uint64, [vp, _U32P, ctypes.c_uint64]),
        "rt_ring_size": (ctypes.c_uint64, [vp]),
        "rt_ring_dropped": (ctypes.c_uint64, [vp]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def get_lib() -> ctypes.CDLL:
    """The loaded library, building it on first use. Raises if it cannot."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            abi = int(lib.rt_abi_version())
            if abi != NATIVE_ABI_VERSION:
                raise RuntimeError(
                    f"native library ABI {abi} != expected {NATIVE_ABI_VERSION}")
            _lib = lib
        return _lib


def native_abi_version() -> int:
    return int(get_lib().rt_abi_version())


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U32P)


def decode_pcap_native(data: bytes, obs_point: int = 2) -> tuple[np.ndarray, int]:
    """C++ pcap decode (decoder.cpp rt_decode_pcap): ((N, 16) u32 records,
    packets in the capture). DNS names are not extracted here (the host's
    name pass in ``sources/pcapdecode.py`` does that); the DNS qtype, rcode
    and qname-hash lanes are filled as the numpy decoder fills them. Raises
    ValueError on bytes that are not a pcap."""
    lib = get_lib()
    # Every record is at least a 16 B header and a 54 B packet; the buffer
    # doubles while the library reports it too small.
    max_records = max(len(data) // 70 + 64, 1024)
    while True:
        out = np.zeros((max_records, NUM_FIELDS), np.uint32)
        total = ctypes.c_size_t(0)
        n = lib.rt_decode_pcap(data, len(data), obs_point, _ptr(out), max_records,
                               ctypes.byref(total))
        if n == -1:
            raise ValueError("not a pcap file")
        if n == -2:
            max_records *= 2
            continue
        return out[:n], int(total.value)


# Distinct-group count of the previous combine: it sizes the next probe
# table (combine.cpp rt_combine_hint grows it when the hint undershoots;
# the result is identical either way).
_combine_hint_groups = 0


def _default_combine_threads() -> int:
    """RETINA_COMBINE_THREADS, else cores-1 capped at 4."""
    env = os.environ.get("RETINA_COMBINE_THREADS", "")
    if env.isdigit():
        return max(1, int(env))
    return max(1, min(4, (os.cpu_count() or 1) - 1))


_combine_threads = _default_combine_threads()


def get_combine_threads() -> int:
    """Current combiner thread count (combine_blocks takes the striped
    multi-consumer combine above 1)."""
    return _combine_threads


def set_combine_threads(n: int) -> None:
    """Process-wide combiner thread count (Config.host_combine_threads);
    0 restores the default."""
    global _combine_threads
    _combine_threads = int(n) if n > 0 else _default_combine_threads()


def _check_blocks(blocks: list) -> int:
    total = 0
    for b in blocks:
        if (b.ndim != 2 or b.shape[1] != NUM_FIELDS or b.dtype != np.uint32
                or not b.flags.c_contiguous):
            raise ValueError("combine blocks must be C-contiguous (N, 16) uint32 arrays")
        total += len(b)
    return total


def combine_native(records: np.ndarray) -> np.ndarray:
    """C++ descriptor combine (combine.cpp rt_combine_mt): the combined
    (G, 16) rows in order of first appearance; the input itself when
    nothing merges. Same key -> (packets, bytes, latest ts) map as
    ``parallel.combine.combine_records_numpy``."""
    global _combine_hint_groups
    lib = get_lib()
    n = len(records)
    if n <= 1:
        return records
    if records.ndim != 2 or records.shape[1] != NUM_FIELDS or records.dtype != np.uint32:
        raise ValueError(f"expected (N, {NUM_FIELDS}) uint32 records, got "
                         f"{records.shape} {records.dtype}")
    if not records.flags.c_contiguous:
        records = np.ascontiguousarray(records)
    out = np.empty_like(records)
    g = lib.rt_combine_mt(_ptr(records), n, _ptr(out), 4 * _combine_hint_groups,
                          _combine_threads)
    if g < 0:
        raise RuntimeError("rt_combine_mt failed")
    _combine_hint_groups = int(g)
    if g == n:
        return records
    return out[:g]


def combine_native_blocks(blocks: list) -> np.ndarray:
    """C++ multi-block combine (rt_combine_multi): one pass over a list of
    (n_i, 16) blocks without concatenating them; bit-identical to
    ``combine_native(np.concatenate(blocks))``."""
    global _combine_hint_groups
    lib = get_lib()
    if not blocks:
        raise ValueError("no blocks to combine")
    total = _check_blocks(blocks)
    if total == 0:
        return blocks[0][:0]
    ptrs = (_U32P * len(blocks))(*[_ptr(b) for b in blocks])
    ns = (ctypes.c_size_t * len(blocks))(*[len(b) for b in blocks])
    out = np.empty((total, NUM_FIELDS), np.uint32)
    g = lib.rt_combine_multi(ptrs, ns, len(blocks), _ptr(out), 4 * _combine_hint_groups)
    if g < 0:
        raise RuntimeError("rt_combine_multi failed")
    _combine_hint_groups = int(g)
    return out[:g]


def combine_native_blocks_striped(blocks: list, n_stripes: int) -> np.ndarray:
    """Striped multi-consumer combine (rt_combine_stripe): T threads each
    combine one key-hash stripe of the block list into a private buffer
    (the ctypes calls release the GIL); the output concatenates the
    stripes, so the row order differs from the single-pass combine while
    the key -> (packets, bytes, latest ts) map is the same."""
    global _combine_hint_groups
    lib = get_lib()
    if not blocks or n_stripes < 2:
        raise ValueError("the striped combine needs blocks and at least 2 stripes")
    total = _check_blocks(blocks)
    if total == 0:
        return blocks[0][:0]
    n_stripes = min(int(n_stripes), 16)
    ptrs = (_U32P * len(blocks))(*[_ptr(b) for b in blocks])
    ns = (ctypes.c_size_t * len(blocks))(*[len(b) for b in blocks])
    # Per-stripe buffers sized for the worst case (every row in one
    # stripe): np.empty reserves address space, untouched pages cost no RAM.
    outs = [np.empty((total, NUM_FIELDS), np.uint32) for _ in range(n_stripes)]
    counts = [0] * n_stripes
    hint = (4 * _combine_hint_groups) // n_stripes

    def run(s: int) -> None:
        counts[s] = lib.rt_combine_stripe(ptrs, ns, len(blocks), _ptr(outs[s]), hint, s,
                                          n_stripes)

    workers = [threading.Thread(target=run, args=(s,), daemon=True)
               for s in range(1, n_stripes)]
    for w in workers:
        w.start()
    run(0)
    for w in workers:
        w.join()
    if any(c < 0 for c in counts):
        raise RuntimeError("rt_combine_stripe failed")
    _combine_hint_groups = sum(int(c) for c in counts)
    return np.concatenate([outs[s][: int(counts[s])] for s in range(n_stripes)], axis=0)


def _check_wire_inputs(rows, ids, sel_new) -> int:
    n = len(rows)
    if (rows.ndim != 2 or rows.shape[1] != NUM_FIELDS or rows.dtype != np.uint32
            or not rows.flags.c_contiguous or ids.dtype != np.uint32
            or not ids.flags.c_contiguous or sel_new.dtype != np.uint8
            or not sel_new.flags.c_contiguous or len(ids) != n or len(sel_new) != n):
        raise ValueError("flow wire inputs: C-contiguous (N, 16) uint32 rows, (N,) uint32 "
                         "ids and (N,) uint8 selection")
    return n


def flowwire_native(rows: np.ndarray, ids: np.ndarray, sel_new: np.ndarray, base: int,
                    id_bits: int, new_out: np.ndarray, known_out: np.ndarray) -> int:
    """C++ v3 flow-dict wire build (pack.cpp rt_flowwire): one pass splits
    ``rows`` by ``sel_new`` into the new wire ([id | 12 packed lanes] into
    ``new_out``) and the known wire ([id | packets << id_bits, bytes] into
    ``known_out``). Returns the new-row count."""
    n = _check_wire_inputs(rows, ids, sel_new)
    if (new_out.dtype != np.uint32 or known_out.dtype != np.uint32
            or not new_out.flags.c_contiguous or not known_out.flags.c_contiguous
            or new_out.ndim != 2 or new_out.shape[1] != 13
            or known_out.ndim != 2 or known_out.shape[1] != 2):
        raise ValueError("flow wire outputs: C-contiguous (Bn, 13) and (Bk, 2) uint32")
    # The C++ side writes n_new*13 + n_known*2 words unchecked.
    n_sel = int(sel_new.sum())
    if len(new_out) < n_sel or len(known_out) < n - n_sel:
        raise ValueError("flow wire outputs are too small")
    return int(get_lib().rt_flowwire(
        _ptr(rows), n, _ptr(ids), sel_new.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint64(int(base)), ctypes.c_uint32(int(id_bits)),
        _ptr(new_out), _ptr(known_out)))


def flowwire_dense_native(rows: np.ndarray, ids: np.ndarray, sel_new: np.ndarray,
                          base: int, id_bits: int, pk_bits: int, by_bits: int,
                          new_out: np.ndarray, known_words: np.ndarray) -> int:
    """C++ v4 dense flow-dict wire build (pack.cpp rt_flowwire_dense): like
    ``flowwire_native``, but known rows go into the ZEROED 1-D
    ``known_words`` stream at (id_bits + pk_bits + by_bits) bits a row
    (``parallel.wire.dense_known_rows`` is the numpy twin). Returns the
    new-row count."""
    n = _check_wire_inputs(rows, ids, sel_new)
    row_bits = int(id_bits) + int(pk_bits) + int(by_bits)
    if (row_bits > 64 or new_out.dtype != np.uint32 or known_words.dtype != np.uint32
            or not new_out.flags.c_contiguous or not known_words.flags.c_contiguous
            or new_out.ndim != 2 or new_out.shape[1] != 13 or known_words.ndim != 1):
        raise ValueError("dense flow wire: C-contiguous (Bn, 13) and (W,) uint32 outputs, "
                         "rows of at most 64 bits")
    n_sel = int(sel_new.sum())
    need = ((n - n_sel) * row_bits + 31) // 32 + 1
    if len(new_out) < n_sel or len(known_words) < need:
        raise ValueError("dense flow wire outputs are too small")
    return int(get_lib().rt_flowwire_dense(
        _ptr(rows), n, _ptr(ids), sel_new.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint64(int(base)), ctypes.c_uint32(int(id_bits)),
        ctypes.c_uint32(int(pk_bits)), ctypes.c_uint32(int(by_bits)),
        _ptr(new_out), _ptr(known_words)))


def pack_native(records: np.ndarray, base: Optional[int] = None) -> tuple[np.ndarray, int]:
    """C++ wire packer (pack.cpp): (n, 16) u32 -> ((n, 12) u32, base).
    Same result as ``parallel.wire.pack_records``' numpy lanes."""
    if records.ndim != 2 or records.dtype != np.uint32 or records.shape[1] != NUM_FIELDS:
        raise ValueError(f"expected (N, {NUM_FIELDS}) uint32 records, got "
                         f"{records.shape} {records.dtype}")
    lib = get_lib()
    if not records.flags.c_contiguous:
        records = np.ascontiguousarray(records)
    n = len(records)
    if base is None:
        base = int(lib.rt_ts_base(_ptr(records), n)) if n else 0
    out = np.empty((n, 12), np.uint32)
    if n:
        lib.rt_pack(_ptr(records), n, ctypes.c_uint64(int(base)), _ptr(out))
    return out, int(base)


class NativeFlowDict:
    """Persistent descriptor -> id dictionary (flowdict.cpp): the native
    twin of ``parallel.flowdict.HostFlowDict``, with the same contract."""

    def __init__(self, capacity: int = 1 << 18):
        self._lib = get_lib()
        self.capacity = int(capacity)
        self._h = self._lib.rt_flowdict_new(self.capacity)
        if not self._h:
            raise RuntimeError("flowdict allocation failed")

    @property
    def generation(self) -> int:
        return int(self._lib.rt_flowdict_generation(self._h))

    def __len__(self) -> int:
        return int(self._lib.rt_flowdict_len(self._h))

    def clear(self) -> None:
        self._lib.rt_flowdict_clear(self._h)

    def lookup_or_assign(self, records: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(N, >=16) records -> (ids (N,) u32, is_new (N,) bool)."""
        n = len(records)
        ids = np.zeros(n, np.uint32)
        is_new = np.zeros(n, np.uint8)
        if n:
            if records.ndim != 2 or records.shape[1] < NUM_FIELDS:
                raise ValueError(
                    f"expected (N, >={NUM_FIELDS}) records, got {records.shape}")
            if records.dtype != np.uint32 or records.shape[1] != NUM_FIELDS:
                records = records[:, :NUM_FIELDS].astype(np.uint32)
            if not records.flags.c_contiguous:
                records = np.ascontiguousarray(records)
            self._lib.rt_flowdict_assign(
                self._h, _ptr(records), n, _ptr(ids),
                is_new.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return ids, is_new.astype(bool)

    def close(self) -> None:
        if self._h:
            self._lib.rt_flowdict_free(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


class AfPacketRing:
    """TPACKET_V3 live capture (afpacket.cpp), the perf ring's analog.

    ``poll(timeout_ms)`` returns ((N, 16) records, frames seen, the DNS
    frames as a [u16 len][frame] blob); kernel drops are a monotonic
    counter, ``drops()``. Raises RuntimeError when the ring cannot open (no
    CAP_NET_RAW, not Linux, no such interface): the caller then runs its
    socket loop, as the reference's does."""

    # A 1 MiB block holds at most ~11k minimum-size frames: room for two full
    # blocks a poll makes the mid-block resume the exception.
    POLL_RECORDS = 1 << 15
    DNS_BUF_BYTES = 1 << 16

    def __init__(self, iface: str = "", block_size: int = 1 << 20, block_nr: int = 32,
                 obs_point: int = 2):
        self._lib = get_lib()
        self.obs_point = obs_point
        self._h = self._lib.rt_afp_open(iface.encode(), block_size, block_nr)
        if not self._h:
            raise RuntimeError(f"AF_PACKET TPACKET_V3 ring open failed (iface={iface!r}; "
                               "needs Linux and CAP_NET_RAW)")
        self._buf = np.empty((self.POLL_RECORDS, NUM_FIELDS), np.uint32)
        self._dns_buf = (ctypes.c_uint8 * self.DNS_BUF_BYTES)()

    def poll(self, timeout_ms: int = 100) -> tuple[np.ndarray, int, bytes]:
        if self._h is None:
            raise RuntimeError("AF_PACKET ring is closed")
        seen = ctypes.c_uint64(0)
        dns_used = ctypes.c_size_t(0)
        n = self._lib.rt_afp_poll(self._h, timeout_ms, self.obs_point, _ptr(self._buf),
                                  self.POLL_RECORDS, ctypes.byref(seen), self._dns_buf,
                                  self.DNS_BUF_BYTES, ctypes.byref(dns_used))
        if n < 0:
            raise RuntimeError("AF_PACKET poll failed")
        return self._buf[:n].copy(), int(seen.value), bytes(self._dns_buf[: dns_used.value])

    def drops(self) -> int:
        if self._h is None:
            raise RuntimeError("AF_PACKET ring is closed")
        return int(self._lib.rt_afp_drops(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.rt_afp_close(self._h)
            self._h = None


class NativeRing:
    """Single-producer single-consumer record ring (ring.cpp) over private
    memory, or over an mmap'd file that another process opens with
    ``create=False``. A push that finds the ring full drops the rows that do
    not fit and counts them (``dropped``)."""

    def __init__(self, capacity: int = 1 << 14, path: Optional[str] = None,
                 create: bool = True):
        self._lib = lib = get_lib()
        self.capacity = capacity
        nbytes = lib.rt_ring_bytes(capacity, NUM_FIELDS)
        self._file = None
        if path is None:
            self._mm = mmap.mmap(-1, nbytes)
        else:
            mode = "r+b" if (os.path.exists(path) and not create) else "w+b"
            self._file = open(path, mode)
            if create or os.path.getsize(path) < nbytes:
                self._file.truncate(nbytes)
            self._mm = mmap.mmap(self._file.fileno(), nbytes)
        self._buf = ctypes.c_char.from_buffer(self._mm)
        self._addr = ctypes.addressof(self._buf)
        if create:
            if lib.rt_ring_init(self._addr, capacity, NUM_FIELDS) != 0:
                self.close()
                raise ValueError("capacity must be a power of two")
        elif lib.rt_ring_check(self._addr, NUM_FIELDS) != 0:
            self.close()
            raise ValueError(f"not a retina ring: {path}")

    def push(self, records: np.ndarray) -> int:
        """Rows pushed (the rest dropped and counted)."""
        rec = np.ascontiguousarray(records, np.uint32)
        if rec.ndim != 2 or rec.shape[1] != NUM_FIELDS:
            raise ValueError(f"expected (N, {NUM_FIELDS}) records, got {rec.shape}")
        return int(self._lib.rt_ring_push(self._addr, _ptr(rec), len(rec)))

    def pop(self, max_records: int = 8192) -> np.ndarray:
        out = np.empty((max_records, NUM_FIELDS), np.uint32)
        n = int(self._lib.rt_ring_pop(self._addr, _ptr(out), max_records))
        return out[:n]

    def __len__(self) -> int:
        return int(self._lib.rt_ring_size(self._addr))

    @property
    def dropped(self) -> int:
        return int(self._lib.rt_ring_dropped(self._addr))

    def close(self) -> None:
        # Release the exported buffer before closing the mmap.
        del self._buf
        self._mm.close()
        if self._file is not None:
            self._file.close()
