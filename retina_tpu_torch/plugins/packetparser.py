"""packetparser: the flow-event firehose plugin (port of
retina_tpu/plugins/packetparser.py).

Reference analog: pkg/plugin/packetparser — tc classifiers parse every
packet on the host device + pod veths into ``struct packet`` records that
stream to userspace over a perf ring and become flows
(packetparser_linux.go:556-652). Here the packet-parse step is the
host-side decoder (sources/pcapdecode.py, the C++ native decoder first),
and the plugin's start loop streams decoded record blocks into the
sink at a paced rate. Conntrack sampling/enrichment runs on-device inside
the pipeline step rather than in a kernel map (ops/conntrack.py).

Sources (cfg.event_source):
- ``synthetic``: TrafficGen Zipf flows (the trafficgen analog) at
  cfg.synthetic_rate events/s.
- ``pcap``: replay cfg.pcap_path (optionally looped), preserving record
  order; DNS names feed the host string table via pubsub.
- ``live``: the TPACKET_V3 ring (native/afpacket.cpp, root only), whose C
  decoder writes records straight from the kernel's blocks; where the ring
  cannot be opened, an AF_PACKET raw socket decoded in batches.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from retina_tpu_torch.config import Config
from retina_tpu_torch.events.synthetic import TrafficGen, preset_params
from retina_tpu_torch.plugins import registry
from retina_tpu_torch.plugins.api import Plugin, UnsupportedPlatform

BLOCK = 8192  # records per emitted block


@registry.register
class PacketParserPlugin(Plugin):
    name = "packetparser"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self._gen: TrafficGen | None = None
        self._pregen: list[np.ndarray] | None = None
        self._replay = None  # PcapReplaySource (event_source=pcap)
        self.dns_names: dict[int, str] = {}
        self._sock = None
        self._regime_switches = 0
        # The live source's reader once it runs: "tpacket_v3_ring" or
        # "raw_socket" (the loop where the ring cannot open).
        self.live_reader = ""

    # -- lifecycle ---------------------------------------------------
    def generate(self) -> None:
        src = self.cfg.event_source
        if src not in ("synthetic", "pcap", "live"):
            raise ValueError(f"packetparser: unknown event_source {src!r}")
        if src == "pcap" and not self.cfg.pcap_path:
            raise ValueError("packetparser: event_source=pcap needs pcap_path")

    def compile(self) -> None:
        """Decode/prepare the source up front (the clang-compile analog:
        pay parse cost before Start, never in the hot loop).

        Synthetic block pre-generation does NOT happen here: generating
        a 2M-event ring takes ~20s on a small host, breaching the
        pluginmanager's 10s reconcile SLA (the contract this repo itself
        enforces — pluginmanager.go:25-28). The ring fills lazily inside
        the Start feed loop instead.
        """
        src = self.cfg.event_source
        if src == "synthetic":
            self._gen = TrafficGen(
                n_flows=self.cfg.synthetic_flows, n_pods=self.cfg.n_pods,
                **preset_params(self.cfg.gen_preset),
            )
            if self.cfg.gen_preset != "default":
                self.log.info(
                    "generator preset %r: %s", self.cfg.gen_preset,
                    preset_params(self.cfg.gen_preset),
                )
            if self.cfg.synthetic_pregen > 0:
                self._pregen = []
        elif src == "pcap":
            from retina_tpu_torch.sources.pcapreplay import (
                PcapReplaySource, safe_decode_bytes,
            )

            with open(self.cfg.pcap_path, "rb") as fh:
                sd = safe_decode_bytes(fh.read())
            # Degrade, never crash: a truncated tail decodes its
            # prefix; an undecodable blob replays as empty. Either way
            # the gap is a COUNTED drop — compile() raising here would
            # take the whole source down over an operator-supplied
            # file (sources/pcapreplay.py).
            if sd.dropped:
                self.count_lost("decode", sd.dropped)
            if sd.error:
                self.log.error(
                    "pcap %s undecodable (%s): replaying empty, "
                    "drop counted", self.cfg.pcap_path, sd.error,
                )
            res = sd.result
            self._replay = PcapReplaySource(res.records, block=BLOCK)
            self.dns_names = res.dns_names
            self.log.info(
                "pcap decoded: %d/%d packets from %s",
                res.n_decoded, res.n_packets_total, self.cfg.pcap_path,
            )

    def _publish_dns_names(self, names: dict[int, str]) -> None:
        """Feed the DnsPlugin string table (externalevents does the same
        for its frames) so hubble l7_dns.query / top_dns labels resolve
        for pcap and live sources, not just external frames."""
        if not names:
            return
        from retina_tpu_torch.plugins.dns import TOPIC_DNS_NAMES
        from retina_tpu_torch.pubsub import get_pubsub

        get_pubsub().publish(TOPIC_DNS_NAMES, dict(names))

    def set_regime(self, preset: str) -> None:
        """Swap the synthetic generator's traffic regime LIVE (the soak
        harness rotates heavy-tail regimes mid-run). Atomic reference
        assignment: the feed loop reads ``self._gen`` once per block,
        so the switch lands on a block boundary with no lock. No-op
        for non-synthetic sources; the pre-generated ring (if any) is
        intentionally left alone — a soak runs with
        ``synthetic_pregen=0`` so every block reflects the active
        regime.
        """
        if self.cfg.event_source != "synthetic" or self._gen is None:
            return
        self._regime_switches += 1
        self._gen = TrafficGen(
            n_flows=self.cfg.synthetic_flows, n_pods=self.cfg.n_pods,
            seed=self._regime_switches,
            **preset_params(preset),
        )
        self.log.info("traffic regime -> %r (%s)", preset,
                      preset_params(preset))

    def init(self) -> None:
        if self.cfg.event_source == "live":
            self._open_socket()

    def _open_socket(self) -> None:
        import socket

        try:
            self._sock = socket.socket(
                socket.AF_PACKET, socket.SOCK_RAW, socket.htons(3)  # ETH_P_ALL
            )
        except (PermissionError, AttributeError, OSError) as e:
            raise UnsupportedPlatform(
                f"live capture needs AF_PACKET + root: {e}"
            ) from e
        if self.cfg.capture_iface:
            self._sock.bind((self.cfg.capture_iface, 0))
        self._sock.settimeout(0.1)

    # -- feed loop ---------------------------------------------------
    def start(self, stop: threading.Event) -> None:
        # Publish any names decoded during compile() only now: Start runs
        # after every plugin's Init, so the DnsPlugin subscription exists
        # (publishing from compile() would race plugin reconcile order).
        self._publish_dns_names(self.dns_names)
        src = self.cfg.event_source
        if src == "synthetic":
            self._run_synthetic(stop)
        elif src == "pcap":
            self._run_pcap(stop)
        else:
            self._run_live(stop)

    def _run_synthetic(self, stop: threading.Event) -> None:
        assert self._gen is not None
        per_block_s = BLOCK / max(self.cfg.synthetic_rate, 1.0)
        next_t = time.monotonic()
        i = 0
        # Lazy ring fill: generate in large chunks (per-call cost of the
        # Zipf sampler is O(n_flows)) sliced into emit-sized blocks,
        # interleaved with emitting — the ring completes within the
        # first ~total/rate seconds of feed instead of stalling
        # reconcile past its SLA.
        ring_total = self.cfg.synthetic_pregen * BLOCK
        chunk = BLOCK * 16
        while not stop.is_set():
            if self._pregen is not None:
                if len(self._pregen) * BLOCK < ring_total:
                    a = self._gen.batch(
                        min(chunk, ring_total - len(self._pregen) * BLOCK)
                    )
                    new = [
                        a[j : j + BLOCK] for j in range(0, len(a), BLOCK)
                    ]
                    self._pregen += new
                    if len(self._pregen) * BLOCK >= ring_total:
                        self.log.info(
                            "pre-generated %d blocks (%d events)",
                            len(self._pregen), ring_total,
                        )
                block = self._pregen[i % len(self._pregen)]
                i += 1
            else:
                block = self._gen.batch(BLOCK)
            accepted = self.emit(block)
            # Burst emit: behind schedule with a complete ring, push up
            # to 7 more pre-generated blocks before re-reading the
            # clock — at unpaced rates the per-iteration Python
            # overhead (clock reads, stop checks, ring fill branch) is
            # the source's dominant cost, and the sharded feed workers
            # downstream can absorb whole bursts. A paced feed never
            # qualifies: it is at most one block behind by design.
            if (
                accepted
                and self._pregen is not None
                and len(self._pregen) * BLOCK >= ring_total
                and time.monotonic() >= next_t + per_block_s
            ):
                for _ in range(7):
                    if not self.emit(self._pregen[i % len(self._pregen)]):
                        break  # sink full: counted, stop pushing
                    i += 1
                    next_t += per_block_s
            next_t += per_block_s
            delay = next_t - time.monotonic()
            if delay > 0:
                stop.wait(delay)
            elif accepted == 0:
                # Sink full and unpaced: yield instead of busy-spinning
                # (the loss is already counted; a hot loop here only
                # starves the feed thread of the GIL).
                stop.wait(0.001)
            else:
                next_t = time.monotonic()  # behind: don't accumulate debt

    def _run_pcap(self, stop: threading.Event) -> None:
        replay = self._replay
        assert replay is not None
        if len(replay) == 0:
            self.log.warning("pcap replay: no decodable packets")
            stop.wait()
            return
        # Looping replay (sources/pcapreplay.py): each pass re-emits
        # the capture with TS lanes rebased one capture-span forward,
        # so replayed time advances monotonically across loop seams
        # instead of jumping back to the capture start.
        while not stop.is_set():
            for block in replay.blocks():
                if stop.is_set():
                    return
                self.emit(block)
                if self.cfg.synthetic_rate > 0:
                    stop.wait(len(block) / self.cfg.synthetic_rate)
            if not self.cfg.pcap_loop:
                self.log.info("pcap replay complete")
                return

    def _run_live_native(self, stop: threading.Event) -> bool:
        """TPACKET_V3 mmap ring capture (native/afpacket.cpp): the kernel
        hands over whole blocks of frames and the C decoder writes records
        directly, with no per-packet syscall or Python cost. Returns False
        when the ring cannot be opened (no CAP_NET_RAW, no such interface),
        so the caller runs the socket loop, as the reference does; a native
        library that cannot be built raises."""
        from retina_tpu_torch.events.schema import OP_FROM_NETWORK
        from retina_tpu_torch.native import AfPacketRing, get_lib
        from retina_tpu_torch.sources.pcapdecode import dns_names_from_frames

        get_lib()
        try:
            ring = AfPacketRing(iface=self.cfg.capture_iface, obs_point=OP_FROM_NETWORK)
        except RuntimeError as e:
            self.log.info("native AF_PACKET ring unavailable (%s); using socket loop", e)
            return False
        # The init()-opened raw socket would keep receiving (and the kernel
        # keep cloning) every packet for the process's life: the ring
        # replaces it.
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        self.log.info("live capture via TPACKET_V3 ring (iface=%r)",
                      self.cfg.capture_iface or "all")
        self.live_reader = "tpacket_v3_ring"
        last_drops = 0
        try:
            while not stop.is_set():
                rec, _seen, dns_frames = ring.poll(timeout_ms=100)
                if len(rec):
                    self.emit(rec)
                if dns_frames:
                    names = dns_names_from_frames(dns_frames)
                    if names:
                        self.dns_names.update(names)
                        self._publish_dns_names(names)
                drops = ring.drops()
                if drops > last_drops:
                    self.count_lost("kernel", drops - last_drops)
                    last_drops = drops
        finally:
            ring.close()
        return True

    def _run_live(self, stop: threading.Event) -> None:
        if self._run_live_native(stop):
            return
        from retina_tpu_torch.sources.pcapdecode import decode_pcap_bytes

        assert self._sock is not None
        self.live_reader = "raw_socket"
        import socket as socket_mod
        import struct as struct_mod

        # Wrap raw frames in an in-memory pcap so one decoder serves all
        # sources.
        hdr = struct_mod.pack(
            "<IHHiIII", 0xA1B23C4D, 2, 4, 0, 0, 65535, 1
        )
        while not stop.is_set():
            frames: list[bytes] = []
            deadline = time.monotonic() + 0.05
            while time.monotonic() < deadline and len(frames) < BLOCK:
                try:
                    frames.append(self._sock.recv(65535))
                except (TimeoutError, socket_mod.timeout):
                    break
                except OSError:
                    return
            if not frames:
                continue
            now = time.time_ns()
            parts = [hdr]
            for fr in frames:
                parts.append(
                    struct_mod.pack(
                        "<IIII", now // 10**9, now % 10**9, len(fr), len(fr)
                    )
                )
                parts.append(fr)
            res = decode_pcap_bytes(b"".join(parts))
            if res.dns_names:
                self.dns_names.update(res.dns_names)
                self._publish_dns_names(res.dns_names)
            self.emit(res.records)

    def stop(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
