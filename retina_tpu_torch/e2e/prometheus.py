"""Prometheus exposition parsing + retrying metric assertions (port of
retina_tpu/e2e/prometheus.py).

Reference analog: test/e2e/framework/prometheus/prometheus.go:25-50 —
CheckMetric scrapes the endpoint, parses the exposition format, matches a
metric name + label subset, and retries with backoff until the deadline
(metrics lag traffic, so one-shot checks race the pipeline).
"""

from __future__ import annotations

import dataclasses
import time
import urllib.request
from typing import Callable, Iterable

from retina_tpu_torch.e2e.framework import StepFailed


@dataclasses.dataclass
class Sample:
    name: str
    labels: dict[str, str]
    value: float


def parse_exposition(text: str) -> list[Sample]:
    """Minimal exposition-format parser (families + label sets + values).

    Handles the subset the exporter emits: `name{l1="v1",...} value` and
    bare `name value` lines; HELP/TYPE comments skipped.
    """
    out: list[Sample] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            metric, _, val = line.rpartition(" ")
            if "{" in metric:
                name, _, rest = metric.partition("{")
                rest = rest.rstrip("}")
                labels: dict[str, str] = {}
                # label values may contain escaped quotes; the exporter
                # never emits them, so a simple split is exact here.
                for part in filter(None, rest.split('",')):
                    k, _, v = part.partition('="')
                    labels[k.strip().lstrip(",")] = v.rstrip('"')
            else:
                name, labels = metric, {}
            out.append(Sample(name=name.strip(), labels=labels,
                              value=float(val)))
        except ValueError:
            continue
    return out


class PrometheusChecker:
    """Scrape-and-assert with retry against a live /metrics endpoint."""

    def __init__(self, url: str, timeout_s: float = 30.0,
                 interval_s: float = 0.25):
        self.url = url
        self.timeout_s = timeout_s
        self.interval_s = interval_s

    def scrape(self) -> list[Sample]:
        text = urllib.request.urlopen(self.url, timeout=5).read().decode()
        return parse_exposition(text)

    @staticmethod
    def _match(samples: Iterable[Sample], name: str,
               labels: dict[str, str] | None) -> list[Sample]:
        labels = labels or {}
        return [
            s for s in samples
            if s.name == name
            and all(s.labels.get(k) == v for k, v in labels.items())
        ]

    def check_metric(
        self,
        name: str,
        labels: dict[str, str] | None = None,
        value: Callable[[float], bool] | float | None = None,
    ) -> Sample:
        """Wait until a sample with ``name`` + label subset (+ value
        predicate) appears; return it. Raises StepFailed at deadline with
        the closest near-misses for diagnosis (prometheus.go's retry +
        verbose mismatch logging)."""
        if value is None:
            pred = lambda v: True
        elif callable(value):
            pred = value
        else:
            pred = lambda v, want=float(value): v == want
        deadline = time.monotonic() + self.timeout_s
        last: list[Sample] = []
        while time.monotonic() < deadline:
            try:
                samples = self.scrape()
            except Exception:
                time.sleep(self.interval_s)
                continue
            hits = self._match(samples, name, labels)
            for h in hits:
                if pred(h.value):
                    return h
            last = hits or [s for s in samples if s.name == name][:5]
            time.sleep(self.interval_s)
        raise StepFailed(
            f"metric {name}{labels or {}} with required value not found "
            f"within {self.timeout_s}s; closest: "
            + "; ".join(f"{s.labels}={s.value}" for s in last[:5])
        )

    def sum_metric(self, name: str,
                   labels: dict[str, str] | None = None) -> float:
        """Sum of all currently-matching samples (0.0 if none)."""
        try:
            return sum(s.value for s in self._match(self.scrape(), name, labels))
        except Exception:
            return 0.0
