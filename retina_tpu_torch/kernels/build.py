"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first GPU use into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes). All sources compile at once, one nvcc process each.
The libraries go to ``.torch_kernels/`` beside the package (listed in
``.gitignore``), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads from disk. Importing this
module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_kernels"
KERNELS = (
    "step_rows", "hh_update", "hll_update", "entropy_update", "conntrack", "inv_update",
    "ingest", "fold", "topk_join", "cms_query", "detect", "latency", "inv_decode",
    "window_close", "snapshot_readout",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then $PATH, then /usr/local/cuda."""
    candidates = [
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel that has no current library, all in parallel.

    Raises RuntimeError with nvcc's output if any build fails. The
    compiler's report (``-Xptxas -v``: registers, spills) is kept in
    ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in KERNELS if not library_path(n).exists()}
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        out = todo[name]
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: library_path(n) for n in KERNELS}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building all kernels on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all()
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
