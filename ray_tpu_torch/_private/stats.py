"""Process-local metrics: counters, gauges and histograms (reference:
src/ray/stats/metric.h Count/Gauge/Histogram + metric_defs.cc).

Each runtime process keeps one registry. A process reads its own
(`snapshot()`); a Trainer reads its worker's through
TrainWorker.read_counter/read_metric. No metrics daemon and no export
path (the reference pushes to OpenCensus/Prometheus exporters)."""

from __future__ import annotations

import logging
import threading
from bisect import bisect_right

logger = logging.getLogger("ray_tpu_torch.stats")


class Metric:
    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        existing = _REGISTRY.register(self)
        if existing is not self:
            # same-named re-registration: the FIRST instance stays the
            # registered truth; this instance becomes a proxy to it so
            # neither side's updates are lost
            self._delegate_to(existing)

    def _delegate_to(self, existing: "Metric") -> None:  # pragma: no cover
        pass


class Count(Metric):
    """Monotonic counter (reference: metric.h Count)."""

    def __init__(self, name: str, description: str = ""):
        self._value = 0.0
        self._lock = threading.Lock()
        super().__init__(name, description)

    def inc(self, by: float = 1.0):
        with self._lock:
            self._value += by

    def snapshot(self):
        with self._lock:
            return {"type": "count", "value": self._value}

    def _delegate_to(self, existing):
        self.inc = existing.inc
        self.snapshot = existing.snapshot


class Gauge(Metric):
    """Last-set value (reference: metric.h Gauge)."""

    def __init__(self, name: str, description: str = ""):
        self._value = 0.0
        self._lock = threading.Lock()
        super().__init__(name, description)

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def snapshot(self):
        with self._lock:
            return {"type": "gauge", "value": self._value}

    def _delegate_to(self, existing):
        self.set = existing.set
        self.snapshot = existing.snapshot


class Histogram(Metric):
    """Fixed-boundary histogram (reference: metric.h Histogram)."""

    def __init__(self, name: str, boundaries: list[float],
                 description: str = ""):
        self.boundaries = sorted(boundaries)
        self._counts = [0] * (len(self.boundaries) + 1)
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()
        super().__init__(name, description)

    def observe(self, value: float):
        i = bisect_right(self.boundaries, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._n += 1

    def snapshot(self):
        # Locked: without it a snapshot can read a torn (counts, sum, n)
        # triple while observe() is mid-update on another thread.
        with self._lock:
            return {"type": "histogram", "boundaries": self.boundaries,
                    "counts": list(self._counts), "sum": self._sum,
                    "count": self._n}

    def _delegate_to(self, existing):
        self.boundaries = existing.boundaries
        self.observe = existing.observe
        self.snapshot = existing.snapshot


class Registry:
    def __init__(self):
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: Metric) -> Metric:
        """Register `metric`, returning the canonical instance for its
        name: the existing one when a same-typed metric is already
        registered (with a warning — the caller's instance proxies to
        it), else `metric` itself. A same-named metric of a DIFFERENT
        type replaces (the old registration was wrong), still warned."""
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and existing is not metric:
                if type(existing) is type(metric):
                    logger.warning(
                        "metric %r registered twice; keeping the "
                        "existing instance (prior values preserved)",
                        metric.name)
                    return existing
                logger.warning(
                    "metric %r re-registered as %s (was %s); replacing",
                    metric.name, type(metric).__name__,
                    type(existing).__name__)
            self._metrics[metric.name] = metric
            return metric

    def snapshot(self) -> dict:
        with self._lock:
            return {name: m.snapshot() for name, m in self._metrics.items()}


_REGISTRY = Registry()


def snapshot() -> dict:
    return _REGISTRY.snapshot()


# Log-spaced seconds boundaries shared by the per-hop latency histograms
# (task queue-wait/lease/exec/reply/e2e).
LATENCY_BOUNDARIES_S = [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                        0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0]
