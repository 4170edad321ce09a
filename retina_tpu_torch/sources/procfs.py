"""/proc parsers for host-stat plugins (the part of
retina_tpu/sources/procfs.py the drop-reason plugin reads; the interface
and InfiniBand readers come with the plugins that read them).

Reference analog: pkg/plugin/linuxutil/netstat_stats_linux.go:20-21 parses
``/proc/net/netstat`` + ``/proc/net/snmp``; ethtool_stats_linux.go reads
per-NIC counters via ioctl (here: ``/sys/class/net/<if>/statistics``);
infiniband_stats_linux.go walks ``/sys/class/infiniband``.
"""

from __future__ import annotations

import os
from pathlib import Path


def parse_kv_pairs_file(path: str) -> dict[str, dict[str, int]]:
    """Parse the netstat/snmp two-line format:
    ``Proto: name1 name2...`` / ``Proto: v1 v2...`` → {proto: {name: val}}.
    """
    out: dict[str, dict[str, int]] = {}
    try:
        lines = Path(path).read_text().splitlines()
    except OSError:
        return out
    for head, vals in zip(lines[::2], lines[1::2]):
        hp, _, hnames = head.partition(":")
        vp, _, vvals = vals.partition(":")
        if hp != vp:
            continue
        names = hnames.split()
        values = []
        for v in vvals.split():
            try:
                values.append(int(v))
            except ValueError:
                values.append(0)
        out[hp] = dict(zip(names, values))
    return out


def read_netstat(proc_root: str = "/proc") -> dict[str, dict[str, int]]:
    return parse_kv_pairs_file(f"{proc_root}/net/netstat")


def read_snmp(proc_root: str = "/proc") -> dict[str, dict[str, int]]:
    return parse_kv_pairs_file(f"{proc_root}/net/snmp")


def read_softnet_drops(proc_root: str = "/proc") -> int:
    """Sum of per-CPU softnet drop counters (column 2, hex)."""
    total = 0
    try:
        for line in Path(f"{proc_root}/net/softnet_stat").read_text().splitlines():
            cols = line.split()
            if len(cols) >= 2:
                total += int(cols[1], 16)
    except OSError:  # noqa: RT101 — softnet_stat absent on this kernel
        pass
    return total
