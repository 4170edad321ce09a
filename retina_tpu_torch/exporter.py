"""Prometheus registries and text exposition (port of retina_tpu/exporter.py).

The reference builds its registries on ``prometheus_client`` and renders
them with its own fast writer (``render_exposition``). The port depends on
no third-party metrics library (torch and numpy only), so this module
holds its own ``Registry``, ``Gauge``, ``Counter`` and ``Histogram``
with the part of ``prometheus_client``'s interface the agent's modules use
(``labels(...)``, ``set``, ``inc``, ``dec``, ``observe``, ``remove``,
``clear``; a counter's and a histogram's ``_created`` series; duplicate
names refused) and writes the same text format (version 0.0.4): for the
same calls the exposition is byte for byte the reference's.

As in the reference, ``Exporter`` holds three registries: **default**
(node-level metrics, for the process's life), **advanced** (pod-level,
replaced by ``reset_advanced`` when a MetricsConfiguration reconcile
changes the metric set, with ``on_reset`` callbacks) and **hubble** (served
on its own); ``gather_text`` renders default then advanced.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable, Iterator

from retina_tpu_torch.log import logger

_log = logger("exporter")

_INF = float("inf")


def _escape_label(v: str) -> str:
    if "\\" in v:
        v = v.replace("\\", "\\\\")
    if "\n" in v:
        v = v.replace("\n", "\\n")
    if '"' in v:
        v = v.replace('"', '\\"')
    return v


def _float_str(d: float) -> str:
    """Go's float formatting as Prometheus writes it (+Inf, NaN, e+0N)."""
    d = float(d)
    if d == _INF:
        return "+Inf"
    if d == -_INF:
        return "-Inf"
    if d != d:
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _sample_line(name: str, labels: dict[str, str], value: float) -> str:
    if labels:
        lbl = ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items()))
        return f"{name}{{{lbl}}} {_float_str(value)}\n"
    return f"{name} {_float_str(value)}\n"


# A sample: (name suffix, extra labels, value).
Sample = tuple[str, dict[str, str], float]


class _Metric:
    """A metric family, or one child of it (a labelled series)."""

    _type = ""
    _suffixes: tuple[str, ...] = ("",)

    def __init__(self, name: str, documentation: str, labelnames: Iterable[str] = (),
                 registry: "Registry | None" = None, _labelvalues: tuple[str, ...] = (),
                 **kwargs: Any) -> None:
        self._name = name
        self._documentation = documentation
        self._labelnames = tuple(labelnames)
        self._labelvalues = _labelvalues
        self._kwargs = kwargs
        self._lock = threading.Lock()
        if self._labelnames and not self._labelvalues:
            self._children: dict[tuple[str, ...], _Metric] = {}
        else:
            self._init_value()
        if registry is not None and not self._labelvalues:
            registry.register(self)

    def _init_value(self) -> None:
        raise NotImplementedError

    def _observable(self) -> None:
        if self._labelnames and not self._labelvalues:
            raise ValueError(f"{self._type} metric is missing label values")

    def labels(self, *labelvalues: Any, **labelkwargs: Any) -> Any:
        """The child series of these label values (created at first use)."""
        if not self._labelnames:
            raise ValueError(f"No label names were set when constructing {self._type}:"
                             f"{self._name}")
        if self._labelvalues:
            raise ValueError(f"{self._type}:{self._name} already has labels set; "
                             "can not chain calls to .labels()")
        if labelvalues and labelkwargs:
            raise ValueError("Can't pass both *args and **kwargs")
        if labelkwargs:
            if sorted(labelkwargs) != sorted(self._labelnames):
                raise ValueError("Incorrect label names")
            key = tuple(str(labelkwargs[n]) for n in self._labelnames)
        else:
            if len(labelvalues) != len(self._labelnames):
                raise ValueError("Incorrect label count")
            key = tuple(str(v) for v in labelvalues)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = type(self)(
                    self._name, self._documentation, self._labelnames, None, key,
                    **self._kwargs)
            return child

    def remove(self, *labelvalues: Any) -> None:
        if not self._labelnames:
            raise ValueError(f"No label names were set when constructing {self._type}:"
                             f"{self._name}")
        if len(labelvalues) != len(self._labelnames):
            raise ValueError(f"Incorrect label count (expected {len(self._labelnames)}, "
                             f"got {labelvalues})")
        with self._lock:
            self._children.pop(tuple(str(v) for v in labelvalues), None)

    def clear(self) -> None:
        with self._lock:
            self._children = {}

    def _child_samples(self) -> list[Sample]:
        raise NotImplementedError

    def samples(self) -> Iterator[Sample]:
        """(suffix, labels, value) of every series, children in creation order."""
        if self._labelnames and not self._labelvalues:
            with self._lock:
                children = list(self._children.items())
            for values, child in children:
                series = dict(zip(self._labelnames, values))
                for suffix, extra, value in child._child_samples():
                    yield suffix, {**series, **extra} if extra else series, value
        else:
            yield from self._child_samples()


class Gauge(_Metric):
    _type = "gauge"

    def _init_value(self) -> None:
        self._value = 0.0

    def set(self, value: float) -> None:
        self._observable()
        v = float(value)
        with self._lock:
            self._value = v

    def inc(self, amount: float = 1) -> None:
        self._observable()
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1) -> None:
        self.inc(-amount)

    def _child_samples(self) -> list[Sample]:
        return [("", {}, self._value)]


class Counter(_Metric):
    _type = "counter"
    _suffixes = ("", "_total", "_created")

    def __init__(self, name: str, documentation: str, labelnames: Iterable[str] = (),
                 registry: "Registry | None" = None, _labelvalues: tuple[str, ...] = (),
                 ) -> None:
        if name.endswith("_total"):
            name = name[:-6]
        super().__init__(name, documentation, labelnames, registry, _labelvalues)

    def _init_value(self) -> None:
        self._value = 0.0
        self._created = time.time()

    def inc(self, amount: float = 1) -> None:
        self._observable()
        if amount < 0:
            raise ValueError("Counters can only be incremented by non-negative amounts.")
        with self._lock:
            self._value += amount

    def _child_samples(self) -> list[Sample]:
        return [("_total", {}, self._value), ("_created", {}, self._created)]


class Histogram(_Metric):
    _type = "histogram"
    _suffixes = ("", "_bucket", "_count", "_sum", "_created")

    def __init__(self, name: str, documentation: str, labelnames: Iterable[str] = (),
                 registry: "Registry | None" = None, _labelvalues: tuple[str, ...] = (),
                 buckets: Iterable[float] = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25,
                                             0.5, 0.75, 1.0, 2.5, 5.0, 7.5, 10.0),
                 ) -> None:
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds):
            raise ValueError("Buckets not in sorted order")
        if bounds and bounds[-1] != _INF:
            bounds.append(_INF)
        if len(bounds) < 2:
            raise ValueError("Must have at least two buckets")
        self._bounds = bounds
        self._le = [_float_str(b) for b in bounds]
        super().__init__(name, documentation, labelnames, registry, _labelvalues,
                         buckets=tuple(buckets))

    def _init_value(self) -> None:
        self._counts = [0.0] * len(self._bounds)
        self._sum = 0.0
        self._created = time.time()

    def observe(self, amount: float) -> None:
        self._observable()
        with self._lock:
            self._sum += amount
            for i, bound in enumerate(self._bounds):
                if amount <= bound:
                    self._counts[i] += 1
                    break

    def _child_samples(self) -> list[Sample]:
        out: list[Sample] = []
        acc = 0.0
        with self._lock:
            counts, total = list(self._counts), self._sum
        for le, c in zip(self._le, counts):
            acc += c
            out.append(("_bucket", {"le": le}, acc))
        out.append(("_count", {}, acc))
        if self._bounds[0] >= 0:
            out.append(("_sum", {}, total))
        out.append(("_created", {}, self._created))
        return out


class Registry:
    """Metric families in registration order; a name is registered once."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._names: set[str] = set()

    def register(self, metric: _Metric) -> None:
        names = {metric._name + s for s in metric._suffixes}
        with self._lock:
            dup = names & self._names
            if dup:
                raise ValueError(f"Duplicated timeseries in the registry: {sorted(dup)}")
            self._names |= names
            self._metrics[metric._name] = metric

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())


def render_exposition(registry: Registry) -> bytes:
    """The Prometheus text format (version 0.0.4) of one registry: per family
    its HELP and TYPE lines and its samples, a counter named with
    ``_total``, and the ``_created`` samples last under a gauge of their
    own, as ``prometheus_client.generate_latest`` writes them."""
    output: list[str] = []
    for metric in registry.metrics():
        base = metric._name
        mname = base + "_total" if metric._type == "counter" else base
        doc = metric._documentation.replace("\\", r"\\").replace("\n", r"\n")
        output.append(f"# HELP {mname} {doc}\n")
        output.append(f"# TYPE {mname} {metric._type}\n")
        created: list[str] = []
        for suffix, labels, value in metric.samples():
            line = _sample_line(base + suffix, labels, value)
            if suffix == "_created":
                created.append(line)
            else:
                output.append(line)
        if created:
            output.append(f"# HELP {base}_created {doc}\n")
            output.append(f"# TYPE {base}_created gauge\n")
            output.extend(created)
    return "".join(output).encode("utf-8")


class Exporter:
    """The default, advanced and hubble registries."""

    def __init__(self) -> None:
        self.default_registry = Registry()
        self.advanced_registry = Registry()
        # Served by its own mux and never by gather_text, so that scraping
        # both does not count its series twice.
        self.hubble_registry = Registry()
        self._reset_cbs: list[Callable[[], None]] = []
        self._lock = threading.Lock()

    def reset_advanced(self) -> None:
        """Replace the advanced registry (a reconcile changed the metrics)."""
        with self._lock:
            self.advanced_registry = Registry()
            cbs = list(self._reset_cbs)
        _log.info("advanced metrics registry reset")
        for cb in cbs:
            cb()

    def on_reset(self, cb: Callable[[], None]) -> None:
        with self._lock:
            self._reset_cbs.append(cb)

    def gather_text(self) -> bytes:
        """The exposition of the default registry, then the advanced one."""
        with self._lock:
            regs = (self.default_registry, self.advanced_registry)
        return b"".join(render_exposition(r) for r in regs)

    def new_gauge(self, name: str, labels: list[str], help_: str = "") -> Gauge:
        return Gauge(name, help_ or name, labels, registry=self.default_registry)

    def new_counter(self, name: str, labels: list[str], help_: str = "") -> Counter:
        return Counter(name, help_ or name, labels, registry=self.default_registry)

    def new_histogram(self, name: str, labels: list[str], buckets: list[float],
                      help_: str = "") -> Histogram:
        return Histogram(name, help_ or name, labels, registry=self.default_registry,
                         buckets=buckets)

    def gather_hubble_text(self) -> bytes:
        return render_exposition(self.hubble_registry)

    def new_hubble_gauge(self, name: str, labels: list[str], help_: str = "") -> Gauge:
        return Gauge(name, help_ or name, labels, registry=self.hubble_registry)

    def new_hubble_counter(self, name: str, labels: list[str], help_: str = "") -> Counter:
        return Counter(name, help_ or name, labels, registry=self.hubble_registry)

    def new_adv_gauge(self, name: str, labels: list[str], help_: str = "") -> Gauge:
        with self._lock:
            reg = self.advanced_registry
        return Gauge(name, help_ or name, labels, registry=reg)

    def new_adv_counter(self, name: str, labels: list[str], help_: str = "") -> Counter:
        with self._lock:
            reg = self.advanced_registry
        return Counter(name, help_ or name, labels, registry=reg)


_singleton: Exporter | None = None
_lock = threading.Lock()


def get_exporter() -> Exporter:
    global _singleton
    with _lock:
        if _singleton is None:
            _singleton = Exporter()
        return _singleton


def reset_for_tests() -> None:
    """Fresh registries, so that tests do not collide on metric names."""
    global _singleton
    with _lock:
        _singleton = None
