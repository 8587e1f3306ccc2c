"""Metrics registry: counters, gauges, histograms, text exposition;
port of ``repro.serving.obs.metrics``.

One home for every number the serving stack produces. Instruments are
registered by ``(name, labels)`` and are get-or-create — calling
``registry.counter("kernel_calls_total", op="w4_matmul", route="ref")``
twice returns the same ``Counter``. ``snapshot()`` flattens the whole
registry into a plain dict (the launcher's ``--report-json`` payload);
``to_text()`` dumps a Prometheus-style exposition (``--metrics-out``).

Engine / weight-bank / scheduler counters are *sampled* into gauges once
per tick by ``Observability.sample`` rather than incremented at-site:
the sources keep their existing lock disciplines (the bank mutates its
counters under its own lock from two threads) and the registry can never
introduce a lock-order hazard or perturb scheduling. Numbers born in the
obs layer itself — kernel route counts/timings, trace bookkeeping — live
here natively as counters/histograms.

All mutation is thread-safe: one registry lock guards instrument
creation, each instrument carries its own lock for updates (the kernel
profiler observes from whatever thread runs an eager op; bank samples
arrive from the engine thread while the prefetch worker runs).
"""
from __future__ import annotations

import threading

# Default histogram buckets: log-spaced seconds, micro to minute scale
# (covers kernel calls, bank fetches, forwards, and segment builds).
DEFAULT_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 5.0,
                   30.0, 60.0)


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock=None):
        self.value = 0
        self._lock = lock if lock is not None else threading.Lock()

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-written value (per-tick samples of engine/bank/sched state)."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock=None):
        self.value = 0.0
        self._lock = lock if lock is not None else threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self.value = v


class Histogram:
    """Fixed-bucket histogram with exact sum/count (cumulative ``le``
    bucket counts in the exposition, like Prometheus)."""

    __slots__ = ("buckets", "counts", "sum", "count", "_lock")

    def __init__(self, buckets=DEFAULT_BUCKETS, lock=None):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)   # +inf overflow
        self.sum = 0.0
        self.count = 0
        self._lock = lock if lock is not None else threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


class MetricsRegistry:
    def __init__(self, lock_factory=None):
        # lock_factory: lockcheck instrumentation seam — wraps the
        # registry lock and every instrument lock it hands out, so lock-
        # order tests see the full obs lock population (see weight_bank)
        self._lock_factory = lock_factory
        self._lock = (lock_factory("metrics._lock")
                      if lock_factory is not None else threading.Lock())
        # name -> (kind, help, {labels_tuple: instrument})
        self._families: dict[str, tuple] = {}

    def _inst_lock(self, name: str):
        if self._lock_factory is None:
            return None
        return self._lock_factory(f"metrics.{name}")

    def _get(self, name: str, kind: str, help_: str, labels: dict,
             factory):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (kind, help_, {})
                self._families[name] = fam
            elif fam[0] != kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{fam[0]}, not {kind}")
            inst = fam[2].get(key)
            if inst is None:
                inst = fam[2][key] = factory()
            return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(name, "counter", help, labels,
                         lambda: Counter(lock=self._inst_lock(name)))

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(name, "gauge", help, labels,
                         lambda: Gauge(lock=self._inst_lock(name)))

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS, **labels) -> Histogram:
        return self._get(name, "histogram", help, labels,
                         lambda: Histogram(buckets,
                                           lock=self._inst_lock(name)))

    def set(self, name: str, value, **labels) -> None:
        """Shorthand: gauge get-or-create + set."""
        self.gauge(name, **labels).set(value)

    # -- read side -----------------------------------------------------------

    def _items(self):
        with self._lock:
            return [(name, kind, help_, dict(series))
                    for name, (kind, help_, series) in
                    sorted(self._families.items())]

    def snapshot(self) -> dict:
        """Flat ``{name{labels}: value}`` dict (histograms contribute
        ``_count``/``_sum``/``_mean`` entries) — the JSON-report view."""
        out = {}
        for name, kind, _help, series in self._items():
            for labels, inst in sorted(series.items()):
                full = name + _label_str(labels)
                if kind == "histogram":
                    out[full + "_count"] = inst.count
                    out[full + "_sum"] = inst.sum
                    out[full + "_mean"] = inst.mean
                else:
                    out[full] = inst.value
        return out

    def to_text(self) -> str:
        """Prometheus-style exposition dump."""
        lines = []
        for name, kind, help_, series in self._items():
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, inst in sorted(series.items()):
                if kind == "histogram":
                    cum = 0
                    for le, c in zip(inst.buckets, inst.counts):
                        cum += c
                        lab = _label_str(labels + (("le", le),))
                        lines.append(f"{name}_bucket{lab} {cum}")
                    lab = _label_str(labels + (("le", "+Inf"),))
                    lines.append(f"{name}_bucket{lab} {inst.count}")
                    lines.append(f"{name}_sum{_label_str(labels)} "
                                 f"{inst.sum}")
                    lines.append(f"{name}_count{_label_str(labels)} "
                                 f"{inst.count}")
                else:
                    lines.append(f"{name}{_label_str(labels)} {inst.value}")
        return "\n".join(lines) + "\n"
