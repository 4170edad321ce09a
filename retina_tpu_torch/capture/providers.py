"""Capture providers: who actually writes the pcap (port of
retina_tpu/capture/providers.py).

Reference analog: pkg/capture/provider/network_capture_unix.go — wraps
tcpdump with duration/size limits; Windows netsh variant
(network_capture_win.go). Four providers here; ``best_provider`` picks the
first available, in this order:

1. TcpdumpProvider — subprocess tcpdump (same flags the reference uses),
   when the binary exists.
2. NetshProvider — ``netsh trace`` on Windows.
3. SocketProvider — in-process AF_PACKET raw capture; needs root.
4. ReplayProvider — captures from the agent's own record stream by
   re-encoding a window of its records as packets into a synthesized
   pcap: the faithful capture when the agent's packets never touch this
   host's NICs. Its ``engine=`` path watches the engine's feed loop
   through an observer (``SketchEngine.add_observer``) for up to
   ``duration_s``; its ``source=`` path pulls blocks from a callable.
   Always available.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import threading
import time
from typing import Callable

import numpy as np

from retina_tpu_torch.events.schema import F, u32_to_ip
from retina_tpu_torch.log import logger

_log = logger("capture.provider")


class CaptureError(RuntimeError):
    pass


class TcpdumpProvider:
    """tcpdump wrapper (network_capture_unix.go CaptureNetworkPacket)."""

    name = "tcpdump"

    @staticmethod
    def available() -> bool:
        return shutil.which("tcpdump") is not None

    def capture(
        self,
        out_path: str,
        filter_expr: str = "",
        iface: str = "any",
        duration_s: int = 60,
        max_size_mb: int = 100,
        packet_size: int = 0,
    ) -> None:
        cmd = ["tcpdump", "-i", iface, "-w", out_path, "-W", "1",
               "-G", str(duration_s)]
        if packet_size:
            cmd += ["-s", str(packet_size)]
        if max_size_mb:
            cmd += ["-C", str(max_size_mb)]
        if filter_expr:
            cmd.append(filter_expr)
        try:
            subprocess.run(
                cmd, timeout=duration_s + 30, check=True, capture_output=True
            )
        except FileNotFoundError as e:
            raise CaptureError("tcpdump not installed") from e
        except subprocess.CalledProcessError as e:
            raise CaptureError(
                f"tcpdump failed: {e.stderr.decode(errors='replace')[:300]}"
            ) from e
        except subprocess.TimeoutExpired as e:
            raise CaptureError("tcpdump did not terminate") from e


def netsh_filter_from_ips(ips: list[str]) -> str:
    """Pod IPs → netsh capture filter (crd_to_job.go:501-538
    getNetshFilterWithPodIPAddress): netsh takes address groups per
    family, e.g. ``IPv4.Address=(10.0.0.1,10.0.0.2)``."""
    v4 = [ip for ip in ips if ip and ":" not in ip]
    v6 = [ip for ip in ips if ip and ":" in ip]
    groups = []
    if v4:
        groups.append(f"IPv4.Address=({','.join(v4)})")
    if v6:
        groups.append(f"IPv6.Address=({','.join(v6)})")
    return " ".join(groups)


def tcpdump_filter_to_netsh(filter_expr: str) -> str:
    """tcpdump filter (what the translator synthesizes for every node)
    → netsh address groups. netsh has no tcpdump syntax: only the
    ``host <ip>`` terms survive (per-family address groups); port and
    protocol terms have no netsh capture-filter equivalent and are
    dropped — the reference similarly filters Windows captures by pod
    IP only (crd_to_job.go:448 netshFilter from PodIpAddresses)."""
    tokens = filter_expr.replace("(", " ").replace(")", " ").split()
    ips = [tokens[i + 1] for i, t in enumerate(tokens[:-1])
           if t == "host"]
    return netsh_filter_from_ips(ips)


class NetshProvider:
    """Windows ``netsh trace`` wrapper
    (network_capture_win.go:63-150): stop any stale trace session,
    ``netsh trace start capture=yes`` into the .etl file with an
    optional address filter and maxSize, sleep the duration, ``netsh
    trace stop``. The command runner is injectable so the control flow
    is testable off-Windows; only availability is win32-gated."""

    name = "netsh"
    suffix = ".etl"  # manager names the capture file with this

    def __init__(self, runner=None, sleep=time.sleep):
        self._run = runner or self._default_runner
        self._sleep = sleep
        self._log = logger("capture.netsh")

    @staticmethod
    def _default_runner(args: list[str], timeout: float):
        return subprocess.run(["cmd", "/C"] + args, capture_output=True,
                              text=True, timeout=timeout)

    def _cmd(self, args: list[str], timeout: float):
        """Runner wrapped into the CaptureError contract the other
        providers keep (providers.py TcpdumpProvider)."""
        try:
            return self._run(args, timeout)
        except FileNotFoundError as e:
            raise CaptureError("netsh/cmd not available") from e
        except subprocess.TimeoutExpired as e:
            raise CaptureError(
                f"netsh did not terminate: {' '.join(args)}"
            ) from e

    @staticmethod
    def available() -> bool:
        import sys

        return sys.platform == "win32" and shutil.which("netsh") is not None

    @staticmethod
    def _err(res) -> str:
        return ((res.stderr or "") + (res.stdout or ""))[:300]

    def _session_running(self) -> bool:
        # `netsh trace show status` exits 1 when no session runs
        # (network_capture_win.go:153-165).
        res = self._cmd(["netsh", "trace", "show", "status"], 30)
        return res.returncode == 0

    def capture(
        self,
        out_path: str,
        filter_expr: str = "",
        iface: str = "any",  # netsh traces all interfaces
        duration_s: int = 60,
        max_size_mb: int = 100,
        packet_size: int = 0,
    ) -> None:
        if self._session_running():
            self._log.info("stopping stale netsh trace session")
            self._cmd(["netsh", "trace", "stop"], 120)
        args = ["netsh", "trace", "start", "capture=yes",
                "report=disabled", "overwrite=yes",
                f"tracefile={out_path}"]
        netsh_filter = tcpdump_filter_to_netsh(filter_expr)
        if filter_expr and not netsh_filter:
            self._log.warning(
                "filter %r has no netsh equivalent; capturing unfiltered",
                filter_expr,
            )
        if netsh_filter:
            # Address groups are separate argv entries
            # (network_capture_win.go:86-93).
            args += netsh_filter.split(" ")
        if max_size_mb:
            args.append(f"maxSize={max_size_mb}")
        res = self._cmd(args, 60)
        if res.returncode != 0:
            raise CaptureError(
                f"netsh trace start failed: {self._err(res)}"
            )
        try:
            self._sleep(duration_s)
        finally:
            stop = self._cmd(["netsh", "trace", "stop"], 300)
            if stop.returncode != 0:
                raise CaptureError(
                    f"netsh trace stop failed: {self._err(stop)}"
                )


class SocketProvider:
    """AF_PACKET raw-socket capture (root)."""

    name = "socket"

    @staticmethod
    def available() -> bool:
        import socket

        if not hasattr(socket, "AF_PACKET"):
            return False
        try:
            s = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                              socket.htons(3))
            s.close()
            return True
        except (PermissionError, OSError):
            return False

    def capture(
        self,
        out_path: str,
        filter_expr: str = "",
        iface: str = "",
        duration_s: int = 60,
        max_size_mb: int = 100,
        packet_size: int = 0,
    ) -> None:
        import socket
        import struct

        s = socket.socket(socket.AF_PACKET, socket.SOCK_RAW, socket.htons(3))
        if iface and iface != "any":
            s.bind((iface, 0))
        s.settimeout(0.2)
        deadline = time.monotonic() + duration_s
        max_bytes = max_size_mb * 1024 * 1024
        written = 0
        with open(out_path, "wb") as fh:
            fh.write(struct.pack("<IHHiIII", 0xA1B23C4D, 2, 4, 0, 0,
                                 65535, 1))
            while time.monotonic() < deadline and written < max_bytes:
                try:
                    frame = s.recv(65535)
                except (TimeoutError, socket.timeout):
                    continue
                if packet_size:
                    frame = frame[:packet_size]
                now = time.time_ns()
                fh.write(struct.pack("<IIII", now // 10**9, now % 10**9,
                                     len(frame), len(frame)))
                fh.write(frame)
                written += 16 + len(frame)
        s.close()


class ReplayProvider:
    """Capture a record stream into a pcap."""

    name = "replay"

    def __init__(self, engine=None, source: Callable[[], np.ndarray] | None = None):
        self._engine = engine
        self._source = source

    @staticmethod
    def available() -> bool:
        return True

    def capture(self, out_path: str, filter_expr: str = "", iface: str = "",
                duration_s: int = 60, max_size_mb: int = 100, packet_size: int = 0) -> None:
        from retina_tpu_torch.sources.pcapdecode import synthesize_pcap

        records: list[np.ndarray] = []
        max_events = max_size_mb * 1024 * 1024 // 80
        if self._engine is not None:
            done, closed = threading.Event(), threading.Event()
            lock = threading.Lock()

            def obs(rec: np.ndarray, plugin: str) -> None:
                with lock:
                    if closed.is_set():
                        return
                    if sum(len(r) for r in records) < max_events:
                        records.append(rec.copy())
                    else:
                        done.set()

            self._engine.add_observer(obs)
            done.wait(duration_s)
            # Observers are append-only, as the reference's: this one goes
            # inert when the window ends.
            with lock:
                closed.set()
        elif self._source is not None:
            t_end = time.monotonic() + min(duration_s, 5)
            while time.monotonic() < t_end and sum(len(r) for r in records) < max_events:
                records.append(self._source())
        if not records:
            raise CaptureError("no events observed during capture window")
        rec = np.concatenate(records)[:max_events]
        pkts = [
            dict(
                src_ip=int(r[F.SRC_IP]), dst_ip=int(r[F.DST_IP]),
                sport=int(r[F.PORTS]) >> 16, dport=int(r[F.PORTS]) & 0xFFFF,
                proto=int(r[F.META]) >> 24,
                tcp_flags=(int(r[F.META]) >> 16) & 0xFF,
                ts_ns=(int(r[F.TS_HI]) << 32) | int(r[F.TS_LO]),
                tsval=int(r[F.TSVAL]), tsecr=int(r[F.TSECR]),
            )
            for r in rec
        ]
        if filter_expr:
            pkts = _apply_filter(pkts, filter_expr)
        with open(out_path, "wb") as fh:
            fh.write(synthesize_pcap(pkts))


def _apply_filter(pkts: list[dict], expr: str) -> list[dict]:
    """Host and port filter evaluation for replay captures (the
    expressions of translator.synthesize_filter)."""
    hosts = set(re.findall(r"host (\d+\.\d+\.\d+\.\d+)", expr))
    ports = {int(p) for p in re.findall(r"port (\d+)", expr)}

    def keep(p: dict) -> bool:
        ok = True
        if hosts:
            ok &= (u32_to_ip(p["src_ip"]) in hosts or u32_to_ip(p["dst_ip"]) in hosts)
        if ports:
            ok &= p["sport"] in ports or p["dport"] in ports
        return ok

    return [p for p in pkts if keep(p)]


def best_provider(engine=None, source=None):
    """Best-available provider (the reference picks tcpdump vs netsh by
    OS; we pick by capability)."""
    if TcpdumpProvider.available():
        return TcpdumpProvider()
    if NetshProvider.available():
        return NetshProvider()
    if SocketProvider.available():
        return SocketProvider()
    return ReplayProvider(engine=engine, source=source)
