"""Observability of the port: span tracing (``obs.trace``), the typed
metrics registry (``obs.metrics_registry``), the process identity
(``obs.identity``), fit heartbeats (``obs.heartbeat``: ``heartbeat``,
``note_progress``), the fleet readers (``obs.fleet``: merged timelines,
merged heartbeats, the straggler report), serving-quality drift detection
(``obs.drift``, numpy, loaded lazily) and the memory planner
(``obs.memory``, torch, loaded lazily).  The rest of the JAX package's
``obs/`` (cost records, reports) comes with ROADMAP.md, A.13.

``obs.heartbeat`` is the scope function, as in the JAX package (the
module stays importable as ``kmeans_tpu_torch.obs.heartbeat``)."""

from kmeans_tpu_torch.obs import fleet, identity
from kmeans_tpu_torch.obs.heartbeat import (Heartbeat, get_heartbeat,
                                            heartbeat, note_progress)
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
    "registry", "Heartbeat", "get_heartbeat", "heartbeat",
    "note_progress", "fleet", "identity", "drift", "memory",
]


def __getattr__(name):
    # Lazy: drift imports numpy and memory imports torch; the package
    # stays stdlib at import.  importlib, not the from-form, which would
    # re-enter this hook.
    if name in ("drift", "memory"):
        import importlib
        return importlib.import_module(f"kmeans_tpu_torch.obs.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
