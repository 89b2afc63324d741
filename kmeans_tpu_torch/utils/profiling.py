"""Timing, profiling and dispatch accounting.

Counterpart of the JAX package's ``utils/profiling.py``:

* :class:`Timer` times on ``torch.cuda.Event`` pairs recorded on the
  current stream of a CUDA device (the stream the kernels launch on), and
  on ``time.perf_counter`` on the CPU; :func:`timed_call` the same for a
  function's mean;
* :func:`trace` is a ``torch.profiler`` scope that writes a Chrome trace;
* :func:`measure_phase_ladder`, :data:`PHASE_DECISION_SHARE`,
  :func:`phase_ceiling_table` and :func:`sanitize_json` decompose a pass
  into phases by a ladder of prefix programs
  (``parallel.distributed.make_estep_phase_fn``), the reference's rules;
* ``note_dispatch(label)`` records one host->device dispatch under a
  stable label: it increments ``dispatch.<label>`` in
  ``obs.metrics_registry.REGISTRY``, lands as an instant ``dispatch.note``
  event on an active trace, and appends to the active
  :func:`log_dispatches` scope.  ``dispatch_counts()`` reads the
  registry's ``dispatch.*`` counters.

* :func:`compile_caches` and :func:`recompilation_sentinel` read the
  places where the port makes a program: the step caches
  (``utils.cache.LRUCache``: ``models.kmeans._STEP_CACHE``,
  ``models.gmm._STEP_CACHE``, ``models.init._PIPE_CACHE``), the loaded
  kernel libraries (``ops._build._LIBS``) and the CUDA graphs the device
  loops captured (``parallel.distributed.CAPTURES``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

from kmeans_tpu_torch.obs import metrics_registry as _metrics
from kmeans_tpu_torch.obs import trace as _obs_trace

__all__ = ["Timer", "trace", "timed_call", "measure_phase_ladder",
           "PHASE_DECISION_SHARE", "phase_ceiling_table", "sanitize_json",
           "note_dispatch", "log_dispatches", "dispatch_counts",
           "RecompilationError", "compile_caches", "recompilation_sentinel"]


def _cuda_device(sync_on):
    """The CUDA device of ``sync_on`` (a tensor, a device, or a nest of
    tensors), or None."""
    import torch
    if sync_on is None:
        return None
    if isinstance(sync_on, torch.device):
        return sync_on if sync_on.type == "cuda" else None
    if isinstance(sync_on, torch.Tensor):
        return sync_on.device if sync_on.is_cuda else None
    if isinstance(sync_on, (list, tuple)):
        for v in sync_on:
            dev = _cuda_device(v)
            if dev is not None:
                return dev
    return None


class Timer:
    """Accumulating timer.  ``measure(sync_on=...)``: where ``sync_on``
    names a CUDA device (a tensor on it, or the device), the interval is
    read from two ``torch.cuda.Event`` objects recorded on that device's
    current stream around the body, read after the end event completes;
    otherwise ``time.perf_counter`` around the body."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    @contextlib.contextmanager
    def measure(self, sync_on=None):
        dev = _cuda_device(sync_on)
        if dev is None:
            start = time.perf_counter()
            yield
            self.total += time.perf_counter() - start
            self.count += 1
            return
        import torch
        stream = torch.cuda.current_stream(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        yield
        b.record(stream)
        b.synchronize()
        self.total += a.elapsed_time(b) / 1e3
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A ``torch.profiler`` scope over the CPU and, where there is one, the
    CUDA device, written as a Chrome trace ``trace.json`` under
    ``log_dir``; a no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import os

    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed_call(fn, *args, warmup: int = 1, iters: int = 3):
    """(mean seconds, last result) of ``fn(*args)`` over ``iters`` calls
    after ``warmup`` ones, each call's end awaited (CUDA events on a CUDA
    result's device, ``perf_counter`` otherwise)."""
    result = None
    for _ in range(warmup):
        result = fn(*args)
    timer = Timer()
    for _ in range(iters):
        dev = _cuda_device(result)
        with timer.measure(sync_on=dev):
            result = fn(*args)
    return timer.total / max(iters, 1), result


# --------------------------------------------------- phase decomposition
# A pass cannot be timed phase by phase from inside (its launches overlap
# on the card), so the decomposition runs a LADDER of cumulative-prefix
# programs (phase 1 only; phases 1-2; the whole pass), measures each rung
# with the same callable, and gives each phase the per-rep DIFFERENCE
# between its rung and the one before.  Reps interleave across rungs so
# that drift moves every rung together.


def measure_phase_ladder(rungs, *, reps: int = 5):
    """Measure a cumulative-phase ladder (the reference's rules).

    ``rungs`` is an ordered list of ``(label, measure)`` pairs where
    ``measure()`` returns the seconds of the program that runs every phase
    up to and including ``label``.  The first phase's cost is its rung's;
    each later phase's is the per-rep difference to the rung before,
    clamped at 0 in ``seconds``; ``spread`` is ``(max - min) / median`` of
    the unclamped differences (inf where the median is not positive but
    the reps vary, 0 where they are all zero).  Returns ``{"phase",
    "seconds", "cumulative", "spread"}`` rows."""
    import numpy as np

    labels = [label for label, _ in rungs]
    samples = {label: [] for label in labels}
    for _ in range(reps):
        for label, measure in rungs:
            samples[label].append(float(measure()))
    out = []
    prev = None
    for label in labels:
        cur = np.asarray(samples[label])
        raw = cur if prev is None else cur - prev
        med_raw = float(np.median(raw))
        span = float(raw.max() - raw.min())
        if med_raw > 0:
            spread = span / med_raw
        else:
            spread = float("inf") if span > 0 else 0.0
        out.append({"phase": label,
                    "seconds": max(med_raw, 0.0),
                    "cumulative": float(np.median(cur)),
                    "spread": spread})
        prev = cur
    return out


#: The phase table's decision rule (the reference's, committed before a
#: measurement): a phase with at least this share of the pass is
#: "actionable".
PHASE_DECISION_SHARE = 0.15


def phase_ceiling_table(ladder, *, flops_per_iter=None,
                        peak_tflops=None, cost_record=None,
                        comm_model=None,
                        decision_share: float = PHASE_DECISION_SHARE):
    """A :func:`measure_phase_ladder` result as the reference's
    measured-ceiling table: per phase ``ms``, ``share`` of the whole pass
    (the last rung's cumulative median), ``spread``,
    ``implied_ceiling_speedup`` (``full / (full - phase)``),
    ``implied_ceiling_mfu`` (with ``flops_per_iter`` and ``peak_tflops``)
    and ``actionable`` (``share >= decision_share``).  ``cost_record``
    adds the roofline columns (``obs.cost.roofline_fields``);
    ``comm_model`` (``obs.fleet.comm_bytes_model``) puts the collective
    bytes on the last row."""
    full = float(ladder[-1]["cumulative"])
    roofline = None
    if cost_record is not None and flops_per_iter:
        from kmeans_tpu_torch.obs.cost import roofline_fields
        roofline = roofline_fields(flops_per_iter, full, cost_record,
                                   peak_tflops)
    rows = []
    for r in ladder:
        sec = float(r["seconds"])
        share = sec / full if full > 0 else 0.0
        remaining = max(full - sec, 1e-12)
        speedup = full / remaining if full > 0 else 1.0
        mfu = None
        if flops_per_iter and peak_tflops and full > 0:
            mfu = (flops_per_iter / remaining) / (peak_tflops * 1e12)
        row = {
            "phase": r["phase"],
            "ms": sec * 1e3,
            "share": share,
            "spread": r["spread"],
            "implied_ceiling_speedup": speedup,
            "implied_ceiling_mfu": mfu,
            "actionable": bool(share >= decision_share),
        }
        if roofline is not None:
            row.update(roofline)
        rows.append(row)
    if comm_model is not None and rows:
        rows[-1]["comm_bytes_per_iter"] = \
            comm_model["per_iteration_bytes"]
        rows[-1]["comm_wire_bytes_per_device"] = \
            comm_model["wire_bytes_per_device_per_iteration"]
    return rows


def sanitize_json(obj):
    """Non-finite floats replaced by None, recursively: strict JSON has no
    inf or nan, and a noise-only phase reports ``spread=inf``."""
    import math

    if isinstance(obj, dict):
        return {k: sanitize_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_json(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj

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


# ---------------------------------------------- recompilation sentinel
# The runtime guard that a warm path reuses its programs: snapshot every
# place where the port makes one, run the body, fail on growth.

#: Modules imported before the caches are discovered, so the sentinel sees
#: every step cache even where the caller imported none of them.
#: Discovery is dynamic (any ``LRUCache`` attribute of a loaded
#: ``kmeans_tpu_torch`` module), so a new cache is covered once its module
#: loads.
_CACHE_MODULES = (
    "kmeans_tpu_torch.models.kmeans",     # _STEP_CACHE
    "kmeans_tpu_torch.models.gmm",        # _STEP_CACHE (the mixture)
    "kmeans_tpu_torch.models.init",       # _PIPE_CACHE (k-means||)
)

#: The two other places where the port makes a program, watched beside the
#: caches: a kernel library loaded (key: source and ``-D`` defines) and a
#: CUDA graph captured by a device loop (key: the loop's class; the value
#: counts captures).
LIBRARIES = "kmeans_tpu_torch.ops._build._LIBS"
CAPTURES = "kmeans_tpu_torch.parallel.distributed.CAPTURES"


class RecompilationError(AssertionError):
    """A step cache, the loaded libraries or the captured graphs grew
    inside a ``recompilation_sentinel`` scope: a path made again a program
    the warm path should have reused."""


def compile_caches() -> dict:
    """Every module-level :class:`~kmeans_tpu_torch.utils.cache.LRUCache` of
    the loaded package, as ``{'module.attr': cache}`` (each cache once,
    under its defining name)."""
    import importlib
    import sys

    from kmeans_tpu_torch.utils.cache import LRUCache

    for name in _CACHE_MODULES:
        importlib.import_module(name)
    out = {}
    seen_ids = set()
    for name in sorted(n for n in sys.modules
                       if n.startswith("kmeans_tpu_torch")):
        mod = sys.modules.get(name)
        if mod is None:
            continue
        for attr, val in sorted(vars(mod).items()):
            if isinstance(val, LRUCache) and id(val) not in seen_ids:
                seen_ids.add(id(val))
                out[f"{name}.{attr}"] = val
    return out


def _program_keys() -> Dict[str, list]:
    """The keys of every watched place: each cache's keys, the loaded
    libraries' keys, and one ``(loop class, i)`` per graph captured."""
    from kmeans_tpu_torch.ops import _build
    from kmeans_tpu_torch.parallel import distributed

    keys = {name: list(c.keys()) for name, c in compile_caches().items()}
    keys[LIBRARIES] = list(_build._LIBS)
    keys[CAPTURES] = [(cls, i) for cls, count in
                      sorted(distributed.CAPTURES.items())
                      for i in range(count)]
    return keys


@contextlib.contextmanager
def recompilation_sentinel(allowed_new: int = 0):
    """Assert that no program is made inside the ``with`` body::

        model.predict(X)                 # warm the caches
        with recompilation_sentinel():
            model.predict(X)             # must reuse every entry

    Yields a dict; on exit ``record['new']`` maps each watched place that
    grew to the keys added in the scope (empty on the healthy path) and
    ``record['caches']`` names every place watched (the step caches,
    :data:`LIBRARIES` and :data:`CAPTURES`).  More than ``allowed_new`` new
    entries in all raise :class:`RecompilationError` naming each place and
    key.  Under a tracer every new key is also a zero-length ``compile``
    span (``via='sentinel'``)."""
    before = {name: set(keys) for name, keys in _program_keys().items()}
    record = {"new": {}, "caches": sorted(before)}
    yield record
    new = {}
    total = 0
    for name, keys in _program_keys().items():
        added = [k for k in keys if k not in before.get(name, ())]
        if added:
            new[name] = added
            total += len(added)
    record["new"] = new
    tr = _obs_trace.get_tracer()
    if tr is not None:
        for name, keys in sorted(new.items()):
            for k in keys:
                tr.instant_span("compile", cache=name, key=repr(k)[:160],
                                via="sentinel")
    if total > allowed_new:
        lines = [f"  {name}: +{len(keys)} entries:" + "".join(
            f"\n    {repr(k)[:120]}" for k in keys)
            for name, keys in sorted(new.items())]
        raise RecompilationError(
            f"{total} new compile-cache entr"
            f"{'y' if total == 1 else 'ies'} inside a "
            f"recompilation_sentinel scope (allowed {allowed_new}): a warm "
            f"path made a program again:\n" + "\n".join(lines))
