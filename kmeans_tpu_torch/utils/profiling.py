"""Dispatch accounting: the part of the JAX package's
``utils/profiling.py`` that the serving engine and the tests read.

``note_dispatch(label)`` records one host->device dispatch under a stable
label: it increments ``dispatch.<label>`` in
``obs.metrics_registry.REGISTRY``, lands as an instant ``dispatch.note``
event on an active trace, and appends to the active
:func:`log_dispatches` scope.  ``dispatch_counts()`` reads the registry's
``dispatch.*`` counters.  CUDA-event timing and ``measure_phase_ladder``
are ROADMAP.md, A.13.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

from kmeans_tpu_torch.obs import metrics_registry as _metrics
from kmeans_tpu_torch.obs import trace as _obs_trace

__all__ = ["note_dispatch", "log_dispatches", "dispatch_counts"]

_DISPATCH_LOG: Optional[list] = None


def note_dispatch(label: str) -> None:
    """Record one host->device dispatch: the registry's
    ``dispatch.<label>`` counter, a span-timeline event when a tracer is
    active, and the active ``log_dispatches`` scope."""
    if _DISPATCH_LOG is not None:
        _DISPATCH_LOG.append(label)
    _metrics.REGISTRY.counter(f"dispatch.{label}").inc()
    _obs_trace.event("dispatch.note", label=label)


@contextlib.contextmanager
def log_dispatches():
    """Collect the labels noted inside the scope (nested scopes shadow:
    the inner one collects, the outer resumes afterwards)::

        with log_dispatches() as log:
            engine.verify_quantized("m", rows)
        assert log.count("verify-quantized/f32-oracle") == 1
    """
    global _DISPATCH_LOG
    prev, _DISPATCH_LOG = _DISPATCH_LOG, []
    try:
        yield _DISPATCH_LOG
    finally:
        _DISPATCH_LOG = prev


def dispatch_counts() -> Dict[str, int]:
    """``{label: count}`` of every ``dispatch.<label>`` counter of the
    process registry (since its last ``reset``)."""
    return {name[len("dispatch."):]: int(v["value"])
            for name, v in _metrics.REGISTRY.snapshot().items()
            if name.startswith("dispatch.") and v["kind"] == "counter"}
