"""Gauges and fixed-log-bucket histograms (trimmed copy).

Copy of ``tpu_cooccurrence/observability/registry.py`` without the
Prometheus exposition (the port serves no ``/metrics`` yet): the job
records per-window stage seconds here and logs their tail summaries at
the end of a run; the dense scorer counts its fused and chained window
dispatches in gauges.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence


def log_buckets(lo: float, hi: float, base: float = 2.0) -> List[float]:
    """Log-spaced bucket upper bounds covering ``[lo, hi]``."""
    if not (lo > 0 and hi > lo and base > 1):
        raise ValueError(f"bad bucket spec lo={lo} hi={hi} base={base}")
    k = math.floor(math.log(lo, base))
    if base ** k < lo:
        k += 1
    bounds = []
    while True:
        b = base ** k
        bounds.append(b)
        if b >= hi:
            return bounds
        k += 1


#: Seconds: ~61 us .. 64 s (21 buckets).
SECONDS_BUCKETS = log_buckets(2.0 ** -14, 2.0 ** 6)


class Gauge:
    """A single instantaneous value (last write wins)."""

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, delta: float) -> None:
        with self._lock:
            self._value += float(delta)

    def get(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-log-bucket histogram with bucket-resolved percentiles."""

    def __init__(self, name: str, bounds: Sequence[float],
                 help: str = "") -> None:
        self.name = name
        self.help = help
        self.bounds = list(bounds)
        self._counts = [0] * (len(self.bounds) + 1)  # +Inf tail
        self.count = 0
        self.sum = 0.0
        self.max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        i = next((i for i, b in enumerate(self.bounds) if value <= b),
                 len(self.bounds))
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += value
            self.max = max(self.max, value)

    def percentile(self, p: float) -> float:
        """Upper bound of the bucket holding the ``p``-quantile rank,
        capped by the largest value observed."""
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = math.ceil(self.count * p / 100.0)
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= rank:
                    if i < len(self.bounds):
                        return min(self.bounds[i], self.max)
                    return self.max
            return self.max

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if self.count == 0:
                return {"count": 0}
            base = {"count": self.count, "sum": round(self.sum, 6),
                    "max": round(self.max, 6)}
        for p, key in ((50, "p50"), (95, "p95"), (99, "p99")):
            base[key] = round(self.percentile(p), 6)
        return base


class MetricsRegistry:
    """Named gauges and histograms, get-or-create."""

    def __init__(self) -> None:
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def gauge(self, name: str, help: str = "") -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, help)
            return g

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None,
                  help: str = "") -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(
                    name, list(bounds) if bounds else SECONDS_BUCKETS, help)
            return h

    def summaries(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            hists = list(self._histograms.values())
        return {h.name: h.summary() for h in hists if h.count}


#: Process-wide registry.
REGISTRY = MetricsRegistry()
