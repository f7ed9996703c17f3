"""Process-local metrics: counters, gauges and histograms (reference:
src/ray/stats/metric.h Count/Gauge/Histogram + metric_defs.cc); port
of ray_tpu/_private/stats.py.

Each runtime process keeps one registry. A process reads its own
(`snapshot()`); a Trainer reads its worker's through
TrainWorker.read_counter/read_metric, Serve its replicas' through their
actors. No metrics daemon and no export path (the reference pushes to
OpenCensus/Prometheus exporters).

Histograms carry **exemplars** (the OpenMetrics idea): observe() may
attach a trace id, and each bucket keeps its most recent and its
max-valued exemplar — so a p99 read off the snapshot links to one real
outlier's trace."""

from __future__ import annotations

import logging
import threading
import time
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
            # neither side's updates are lost (a replaced counter used
            # to silently drop all prior increments)
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
        # Locked: an unlocked float store racing add() could be lost OR
        # land mid-read of a snapshot (set/add/snapshot all serialize).
        with self._lock:
            self._value = float(value)

    def add(self, delta: float):
        """Thread-safe relative update — for gauges tracking a live count
        (e.g. in-flight transfer chunks) incremented/decremented from
        many worker threads."""
        with self._lock:
            self._value += delta

    def snapshot(self):
        with self._lock:
            return {"type": "gauge", "value": self._value}

    def _delegate_to(self, existing):
        self.set = existing.set
        self.add = existing.add
        self.snapshot = existing.snapshot


class Histogram(Metric):
    """Fixed-boundary histogram (reference: metric.h Histogram), with
    optional per-bucket trace-id exemplars."""

    def __init__(self, name: str, boundaries: list[float],
                 description: str = ""):
        self.boundaries = sorted(boundaries)
        self._counts = [0] * (len(self.boundaries) + 1)
        self._sum = 0.0
        self._n = 0
        # bucket index -> {"last": exemplar, "max": exemplar}; exemplar =
        # {"trace_id", "value", "ts"}. Bounded by construction: <=2 per
        # bucket, only buckets that ever saw an exemplar have an entry.
        self._exemplars: dict[int, dict] = {}
        self._lock = threading.Lock()
        super().__init__(name, description)

    def observe(self, value: float, exemplar: str | None = None):
        """Record one observation; `exemplar` is the hex trace id of the
        call that produced it (threaded from the traced seams), kept as
        the bucket's most recent and — separately — max-valued link."""
        i = bisect_right(self.boundaries, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._n += 1
            if exemplar:
                ex = {"trace_id": exemplar, "value": float(value),
                      "ts": time.time()}
                slot = self._exemplars.get(i)
                if slot is None:
                    slot = self._exemplars[i] = {}
                slot["last"] = ex
                cur_max = slot.get("max")
                if cur_max is None or value >= cur_max["value"]:
                    slot["max"] = ex

    def snapshot(self):
        # Locked: without it a snapshot can read a torn (counts, sum, n)
        # triple while observe() is mid-update on another thread.
        with self._lock:
            snap = {"type": "histogram", "boundaries": self.boundaries,
                    "counts": list(self._counts), "sum": self._sum,
                    "count": self._n}
            if self._exemplars:
                # str bucket keys: the snapshot crosses JSON surfaces
                snap["exemplars"] = {
                    str(i): {k: dict(v) for k, v in slot.items()}
                    for i, slot in self._exemplars.items()}
            return snap

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
# (task queue-wait/lease/exec/reply/e2e, serve router queue/e2e).
LATENCY_BOUNDARIES_S = [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                        0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0]


def percentile(hist_snapshot: dict, q: float,
               with_saturation: bool = False):
    """Estimate the q-quantile (0..1) from a histogram SNAPSHOT — the
    upper boundary of the bucket containing the quantile. Quantiles
    landing in the unbounded overflow bucket CLAMP to the top boundary
    (Prometheus histogram_quantile convention; inf would not survive
    the JSON surfaces) — a clamped reading means "at least this much".

    `with_saturation=True` returns `(value, saturated)` instead, where
    `saturated` is True exactly when the quantile landed in the
    overflow bucket — the signal a consumer needs to tell saturation
    from a real reading."""
    counts = hist_snapshot.get("counts") or []
    boundaries = hist_snapshot.get("boundaries") or []
    total = hist_snapshot.get("count", 0)
    if not total or not counts:
        return (0.0, False) if with_saturation else 0.0
    target = q * total
    acc = 0
    value, saturated = 0.0, False
    for i, c in enumerate(counts):
        acc += c
        if acc >= target:
            saturated = i >= len(boundaries)
            value = (boundaries[i] if i < len(boundaries)
                     else boundaries[-1] if boundaries else 0.0)
            break
    else:
        saturated = True
        value = boundaries[-1] if boundaries else 0.0
    return (value, saturated) if with_saturation else value
