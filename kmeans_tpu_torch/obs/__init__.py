"""Observability of the port: span tracing (``obs.trace``), the typed
metrics registry (``obs.metrics_registry``), the process identity
(``obs.identity``), serving-quality drift detection (``obs.drift``,
numpy, loaded lazily) and the memory planner (``obs.memory``).  The rest
of the JAX package's ``obs/`` (heartbeats, reports, cost records, the
fleet tools) comes with ROADMAP.md, A.13."""

from kmeans_tpu_torch.obs import identity
from kmeans_tpu_torch.obs.metrics_registry import (REGISTRY, Counter, Gauge,
                                                   Histogram,
                                                   MetricsRegistry,
                                                   registry)
from kmeans_tpu_torch.obs.trace import (SPAN_NAMES, TraceReadError, Tracer,
                                        chrome_events, event, get_tracer,
                                        read_jsonl, span, summarize,
                                        tracing)

__all__ = [
    "SPAN_NAMES", "TraceReadError", "Tracer", "chrome_events", "event",
    "get_tracer", "read_jsonl", "span", "summarize", "tracing",
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "registry", "identity", "drift", "memory",
]


def __getattr__(name):
    # Lazy: drift imports numpy and memory imports torch; the package
    # stays stdlib at import.  importlib, not the from-form, which would
    # re-enter this hook.
    if name in ("drift", "memory"):
        import importlib
        return importlib.import_module(f"kmeans_tpu_torch.obs.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
