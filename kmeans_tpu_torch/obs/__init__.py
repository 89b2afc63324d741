"""Observability of the port: span tracing (``obs.trace``), the typed
metrics registry (``obs.metrics_registry``), the process identity
(``obs.identity``), fit heartbeats (``obs.heartbeat``: ``heartbeat``,
``note_progress``), device-cost records measured on torch.profiler and the
allocator (``obs.cost``), the fleet readers and the collective-bytes bill
(``obs.fleet``), the memory planner (``obs.memory``), serving-quality
drift detection (``obs.drift``, numpy, loaded lazily) and the
time-to-first-iteration and cost reports (``obs.report``, loaded lazily).
Quick start::

    from kmeans_tpu_torch import obs

    with obs.tracing("fit.jsonl") as tr, obs.cost.collecting() as col:
        model.fit(X)
    print(obs.format_phase_table(obs.time_to_first_iteration(
        tr.records())))
    for rec in col.records():
        print(rec.cache, rec.flops, rec.peak_bytes, rec.device_ms)

``obs.heartbeat`` is the scope function, as in the JAX package (the
module stays importable as ``kmeans_tpu_torch.obs.heartbeat``).  The
package is stdlib at import: ``memory`` imports torch at its first use as
``obs.memory``, ``drift`` numpy, and the report's names load ``report``
when first read."""

from kmeans_tpu_torch.obs import cost, fleet, identity
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
    "note_progress", "cost", "memory", "fleet", "identity", "drift",
    "report", "ttfi_ladder", "time_to_first_iteration",
    "format_phase_table", "merge_cost", "format_cost_table",
]

_LAZY_REPORT = ("ttfi_ladder", "time_to_first_iteration",
                "format_phase_table", "TTFI_PHASES", "merge_cost",
                "format_cost_table", "device_cost_report")


def __getattr__(name):
    # Lazy: drift imports numpy, memory torch, report the profiling
    # helpers; the package stays stdlib at import.  importlib, not the
    # from-form, which would re-enter this hook.
    import importlib
    if name in _LAZY_REPORT:
        return getattr(importlib.import_module(
            "kmeans_tpu_torch.obs.report"), name)
    if name in ("drift", "memory", "report"):
        return importlib.import_module(f"kmeans_tpu_torch.obs.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
