"""/proc and /sys parsers for host-stat plugins (a copy of
retina_tpu/sources/procfs.py).

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

def read_iface_stats(sys_root: str = "/sys") -> dict[str, dict[str, int]]:
    """{iface: {stat: value}} from /sys/class/net/*/statistics (the
    ethtool-stats analog — same per-NIC counters without the ioctl)."""
    out: dict[str, dict[str, int]] = {}
    base = Path(f"{sys_root}/class/net")
    try:
        ifaces = sorted(os.listdir(base))
    except OSError:
        return out
    for iface in ifaces:
        stats_dir = base / iface / "statistics"
        stats: dict[str, int] = {}
        try:
            for stat in os.listdir(stats_dir):
                try:
                    stats[stat] = int((stats_dir / stat).read_text())
                except (OSError, ValueError):
                    continue
        except OSError:
            continue
        if stats:
            out[iface] = stats
    return out


def read_infiniband_counters(
    sys_root: str = "/sys",
) -> dict[tuple[str, str], dict[str, int]]:
    """{(device, port): {counter: value}} from /sys/class/infiniband."""
    out: dict[tuple[str, str], dict[str, int]] = {}
    base = Path(f"{sys_root}/class/infiniband")
    try:
        devices = sorted(os.listdir(base))
    except OSError:
        return out
    for dev in devices:
        ports_dir = base / dev / "ports"
        try:
            ports = sorted(os.listdir(ports_dir))
        except OSError:
            continue
        for port in ports:
            counters: dict[str, int] = {}
            cdir = ports_dir / port / "counters"
            try:
                for c in os.listdir(cdir):
                    try:
                        counters[c] = int((cdir / c).read_text())
                    except (OSError, ValueError):
                        continue
            except OSError:
                continue
            if counters:
                out[(dev, port)] = counters
    return out


def read_infiniband_status_params(
    sys_root: str = "/sys",
) -> dict[str, dict[str, str]]:
    """{iface: {param: value}} from /sys/class/net/*/debug (status params
    the reference reads, infiniband_stats_linux.go)."""
    out: dict[str, dict[str, str]] = {}
    base = Path(f"{sys_root}/class/net")
    try:
        ifaces = sorted(os.listdir(base))
    except OSError:
        return out
    for iface in ifaces:
        dbg = base / iface / "debug"
        params: dict[str, str] = {}
        try:
            for p in os.listdir(dbg):
                try:
                    params[p] = (dbg / p).read_text().strip()
                except OSError:
                    continue
        except OSError:
            continue
        if params:
            out[iface] = params
    return out
