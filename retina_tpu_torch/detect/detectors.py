"""The three builtin detectors (port of retina_tpu/detect/detectors.py).

Thresholds, priorities, dims and ``extras`` paths are the reference's:
every benign preset of the generator scores far below each
``fire_thresh``; each matching attack regime far above it. Scores run on
the detector's device through K11-K13 (``programs.py``); a bank judges the
three together (``bank_input`` and ``kops.bank_close``, ``base.BATCHED``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from retina_tpu_torch.detect import features, programs
from retina_tpu_torch.detect.base import BATCHED, Detector, register
from retina_tpu_torch.kernels import ops as kops
from retina_tpu_torch.u32 import from_numpy


@register
class SynFloodDetector(Detector):
    """SYN:ACK asymmetry over the tcpflag lanes. Highest priority: a
    volumetric flood is where capture evidence decays fastest."""

    name = "synflood"
    priority = 3
    dims = ("src_ip",)
    fire_thresh = 3.0  # benign steady state is ~0.05 SYN per ACK
    min_score = 1.5
    MIN_TCP = 64.0  # packets; below this a window has no TCP story

    def begin_window(self) -> None:
        self._lanes = np.zeros((programs.SYNFLOOD_LANES,), np.float32)

    def add_records(self, rec: np.ndarray, extras: Optional[dict] = None) -> None:
        if extras is not None and "tcpflag_lanes" in extras:
            self._lanes += np.asarray(extras["tcpflag_lanes"], np.float32)
        else:
            self._lanes += features.tcpflag_lanes(rec)

    def bank_input(self) -> np.ndarray | None:
        """The window's (9,) tcpflag lanes; None below MIN_TCP packets."""
        return None if self._lanes[8] < self.MIN_TCP else self._lanes

    def score(self) -> float | None:
        lanes = self.bank_input()
        if lanes is None:
            return None
        return float(programs.synflood_program(from_numpy(lanes, self.device))[0])


@register
class PortScanDetector(Detector):
    """Distinct dst ports per source hash-group (HLL bank). Benign feeds
    touch a handful of service ports a group; a vertical sweep
    concentrates dozens under one source's group."""

    name = "portscan"
    priority = 2
    dims = ("dst_port",)
    fire_thresh = 12.0  # benign mixes peak ~5 ports a group; sweeps >= 24
    min_score = 8.0

    def begin_window(self) -> None:
        self._blocks: list[np.ndarray] = []

    def add_records(self, rec: np.ndarray, extras: Optional[dict] = None) -> None:
        self._blocks.append(np.asarray(rec))

    def bank_input(self) -> torch.Tensor | None:
        """K11's (groups,) estimates of the window on the detector's device
        (launched, not waited for); None with no records."""
        if not self._blocks:
            return None
        rec = self._blocks[0] if len(self._blocks) == 1 else np.concatenate(self._blocks)
        if not len(rec):
            return None
        keys, w = features.padded_flow_keys(rec)
        return programs.portscan_program(from_numpy(keys, self.device),
                                         from_numpy(w, self.device))

    def score(self) -> float | None:
        est = self.bank_input()
        return None if est is None else float(torch.max(est))


@register
class DnsTunnelDetector(Detector):
    """Entropy over qname lengths, from the F.DNS low byte on the record
    tap or from a qname histogram in ``extras["qname_hist"]``."""

    name = "dnstunnel"
    priority = 1
    dims = ("src_ip",)
    fire_thresh = 4.2  # benign lengths cluster in <= 9 bins (< 3.2 bits)
    min_score = 3.6
    MIN_DNS = 32.0  # queries; below this the histogram is noise

    def begin_window(self) -> None:
        self._hist = np.zeros((1, programs.DNSTUNNEL_BINS), np.float32)

    def add_records(self, rec: np.ndarray, extras: Optional[dict] = None) -> None:
        if extras is not None and "qname_hist" in extras:
            self._hist = self._hist + np.asarray(extras["qname_hist"], np.float32).reshape(1, -1)
        else:
            self._hist = self._hist + features.qname_length_hist(rec)

    def bank_input(self) -> np.ndarray | None:
        """The window's (1, nbins) qname-length histogram; None below
        MIN_DNS queries."""
        return None if float(self._hist.sum()) < self.MIN_DNS else self._hist

    def score(self) -> float | None:
        hist = self.bank_input()
        if hist is None:
            return None
        return float(programs.dnstunnel_program(from_numpy(hist, self.device))[0])


BATCHED.update({SynFloodDetector: kops.BANK_SYNFLOOD, PortScanDetector: kops.BANK_PORTSCAN,
                DnsTunnelDetector: kops.BANK_DNSTUNNEL})
