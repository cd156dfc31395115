"""Metrics registry: counters, gauges, and bounded histograms: port of
``repro/obs/metrics.py`` (pure Python there and here; the port keeps its
own copy so that it imports nothing of ``repro``).

Spans (``repro_torch.obs.tracer``) answer *where time went*; metrics answer
*how the system behaved* — queue depths, slot occupancy, request
latencies, gradient norms, recompile counts.  All instruments are
get-or-create by name on a :class:`MetricsRegistry`:

    m = MetricsRegistry()
    m.counter("embed.completed").inc()
    m.gauge("embed.queue_depth").set(len(queue))
    m.histogram("embed.latency_s").observe(req.latency_s)
    m.snapshot()        # plain dict, JSON-ready

Histograms keep a **bounded** sample reservoir (ring overwrite past
``max_samples``) so long-running services never grow unbounded, while
count/sum/min/max stay exact; percentiles (p50/p95/p99) are computed over
the retained window.  Registries merge (:meth:`MetricsRegistry.merge`):
counters add, gauges take the other's latest value, histograms pool their
retained samples — the worker-aggregation primitive.
"""
from __future__ import annotations

import math


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> int:
        self.value += n
        return self.value

    def merge(self, other: "Counter") -> None:
        self.value += other.value


class Gauge:
    """Last-set instantaneous value; tracks the high-water mark."""

    __slots__ = ("name", "value", "max_value", "n_sets")

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0.0
        self.max_value: float = -math.inf
        self.n_sets = 0

    def set(self, v: float) -> float:
        self.value = float(v)
        self.n_sets += 1
        if self.value > self.max_value:
            self.max_value = self.value
        return self.value

    def merge(self, other: "Gauge") -> None:
        if other.n_sets:
            self.value = other.value
            self.n_sets += other.n_sets
        if other.max_value > self.max_value:
            self.max_value = other.max_value


class Histogram:
    """Bounded-reservoir value distribution.

    Exact ``count`` / ``sum`` / ``min`` / ``max`` over every observation;
    quantiles over the last ``max_samples`` observations (ring overwrite),
    so memory stays O(max_samples) for the life of a service.
    """

    __slots__ = ("name", "max_samples", "count", "total", "min", "max",
                 "_samples", "_next")

    def __init__(self, name: str, max_samples: int = 4096):
        if max_samples < 1:
            raise ValueError(f"max_samples={max_samples} must be >= 1")
        self.name = name
        self.max_samples = max_samples
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: list[float] = []
        self._next = 0                     # ring cursor once full

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._samples) < self.max_samples:
            self._samples.append(v)
        else:
            self._samples[self._next] = v
            self._next = (self._next + 1) % self.max_samples

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def percentile(self, q: float) -> float:
        """q in [0, 100], linear interpolation over retained samples."""
        if not self._samples:
            return math.nan
        xs = sorted(self._samples)
        if len(xs) == 1:
            return xs[0]
        pos = (q / 100.0) * (len(xs) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def summary(self) -> dict:
        if not self.count:
            return dict(count=0)
        return dict(
            count=self.count, mean=self.mean, min=self.min, max=self.max,
            p50=self.percentile(50), p95=self.percentile(95),
            p99=self.percentile(99),
        )

    def merge(self, other: "Histogram") -> None:
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        for v in other._samples:
            if len(self._samples) < self.max_samples:
                self._samples.append(v)
            else:
                self._samples[self._next] = v
                self._next = (self._next + 1) % self.max_samples


class MetricsRegistry:
    """Named instruments, get-or-create; snapshot() is JSON-ready."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, max_samples: int = 4096) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, max_samples)
        return h

    def counter_values(self, prefix: str = "") -> dict:
        """Current values of counters whose name starts with ``prefix``
        (e.g. ``counter_values("recompiles.")`` -> per-probe trace counts)."""
        return {name: c.value for name, c in sorted(self._counters.items())
                if name.startswith(prefix)}

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold ``other`` in: counters add, gauges take other's last set
        value (high-water marks max), histograms pool retained samples."""
        for name, c in other._counters.items():
            self.counter(name).merge(c)
        for name, g in other._gauges.items():
            self.gauge(name).merge(g)
        for name, h in other._histograms.items():
            self.histogram(name, h.max_samples).merge(h)
        return self

    def snapshot(self) -> dict:
        out: dict = {}
        for name, c in sorted(self._counters.items()):
            out[name] = c.value
        for name, g in sorted(self._gauges.items()):
            out[name] = dict(value=g.value, max=g.max_value)
        for name, h in sorted(self._histograms.items()):
            out[name] = h.summary()
        return out

    def clear(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()
