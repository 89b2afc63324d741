"""Typed metrics registry: counters, gauges, histograms, one snapshot.

The port's copy of the JAX package's ``obs/metrics_registry.py``: a
process-wide :class:`MetricsRegistry` of typed metrics that the port's
signals write through at their increment sites (the serving engine's
``serve.*`` counters and latency histograms, ``note_dispatch``'s
``dispatch.<label>`` counters), with ``snapshot()`` as a dict and
``to_json()`` for export, in the reference's JSON.

Write-through contract: registry writes are host-side integer/float
bookkeeping only — no launches, no threads, no IO — so they never
perturb a result.  ``reset()`` zeroes the process view.

Metric naming: dotted lowercase paths, subsystem first —
``serve.dispatches``, ``dispatch.<label>``.

Pure stdlib.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Union

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "REGISTRY", "registry", "nearest_rank"]


def nearest_rank(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list (no numpy — the
    obs modules stay stdlib).  The ONE implementation both the
    histogram metrics and the trace summaries use; 0.0 on empty."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class Counter:
    """Monotonic event count (increments only)."""

    kind = "counter"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> Union[int, float]:
        return self.value


class Gauge:
    """Last-written level (set/add; e.g. the effective scan chunk)."""

    kind = "gauge"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v) -> None:
        self.value = v

    def add(self, v) -> None:
        self.value = (self.value or 0) + v

    def snapshot(self):
        return self.value


class Histogram:
    """Streaming distribution summary: count/sum/min/max plus a bounded
    reservoir for percentile estimates (uniform over the first
    ``reservoir`` observations, then systematic thinning — deterministic,
    no RNG, good enough for operator-facing p50/p99)."""

    kind = "histogram"
    __slots__ = ("name", "count", "sum", "min", "max",
                 "_reservoir", "_cap", "_stride")

    def __init__(self, name: str, reservoir: int = 512):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._reservoir: List[float] = []
        self._cap = int(reservoir)
        self._stride = 1

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if (self.count - 1) % self._stride == 0:
            self._reservoir.append(v)
            if len(self._reservoir) > self._cap:
                # Thin deterministically: keep every other sample and
                # double the stride — the reservoir stays a uniform
                # systematic sample of the stream.
                self._reservoir = self._reservoir[::2]
                self._stride *= 2

    def percentile(self, q: float) -> Optional[float]:
        if not self._reservoir:
            return None
        return nearest_rank(sorted(self._reservoir), q)

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "mean": self.sum / self.count if self.count else None,
                "p50": self.percentile(0.50),
                "p99": self.percentile(0.99)}


class MetricsRegistry:
    """Name -> typed metric, get-or-create semantics.

    A name is permanently bound to its first-requested type; asking for
    the same name as a different type raises (two call sites silently
    sharing a name across types would corrupt both readings)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is already registered as a "
                    f"{type(m).__name__}, not a {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, reservoir: int = 512) -> Histogram:
        return self._get(name, Histogram, reservoir)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, dict]:
        """``{name: {"kind", "value"}}`` over every registered metric —
        the operator-facing dict (and the heartbeat's counter block)."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: {"kind": m.kind, "value": m.snapshot()}
                for m in metrics}

    def identity(self) -> dict:
        """The producing process's fleet coordinates —
        ``process_index``/``process_count``/``host`` — so exported
        snapshots from N hosts stay attributable.  Uncached: the
        registry is process-global and outlives telemetry scopes."""
        from kmeans_tpu_torch.obs.identity import identity
        return identity()

    def to_json(self, indent: Optional[int] = None) -> str:
        """Snapshot as JSON, stamped with the producer's fleet identity
        under ``__identity__`` (a reserved name no metric can take:
        metric names are dotted lowercase paths by convention)."""
        out = dict(self.snapshot())
        out["__identity__"] = self.identity()
        return json.dumps(out, indent=indent, sort_keys=True)

    def reset(self) -> None:
        """Drop every metric (bench/test isolation).  Live references
        held by call sites keep counting into detached objects, so
        reset between workloads, not mid-flight."""
        with self._lock:
            self._metrics.clear()


#: The process-wide registry every instrumented site writes through.
REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry (function form, so call sites
    can be monkeypatched in tests without touching the module global)."""
    return REGISTRY
