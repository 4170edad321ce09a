"""Monotonic→wall clock conversion (copy of retina_tpu/utils/ktime.py; reference internal/ktime).

Event sources stamp records with a monotonic nanosecond clock (the eBPF
analog is bpf_ktime_get_ns); exporters want wall time. The boot offset is
computed once per process, as in the reference (used at
packetparser_linux.go:585).
"""

from __future__ import annotations

import time

_offset_ns: int | None = None


def boot_offset_ns() -> int:
    """wall_ns - monotonic_ns, sampled once."""
    global _offset_ns
    if _offset_ns is None:
        _offset_ns = time.time_ns() - time.monotonic_ns()
    return _offset_ns


def monotonic_to_wall_ns(mono_ns: int) -> int:
    return mono_ns + boot_offset_ns()
