"""Device-cost capture: one measured record per program a builder made.

Counterpart of the JAX package's ``obs/cost.py``.  There XLA reports a
compiled program's cost (``cost_analysis`` / ``memory_analysis``); the
port's programs are Python callables that launch torch operations and the
hand kernels of ``ops``, so the port measures what the reference reads:

* **device time and kernels** -- the captured call runs under
  ``torch.profiler.profile(activities=[CUDA])``; the record keeps every
  device activity's name, count and milliseconds (``kernels``,
  ``device_ms``), and the hand kernels' launch counts
  (``ops._build.LAUNCHES``, ``launches``);
* **operations** -- ``torch.utils.flop_counter.FlopCounterMode`` counts the
  aten products; a hand kernel launched through ``ctypes`` is invisible to
  it, so each launch adds the operations that
  ``ops.hopper_kernels.declared_operations`` declares for its shape
  (``ops._build.OPS``).  ``flops`` is their sum and ``flops_source`` says
  which part is there (``"aten"``, ``"declared"``, ``"aten+declared"``);
* **memory** -- on a CUDA device the allocator's peak over the call above
  what was allocated before it is ``temp_bytes``; the tensors the call
  reads and writes are ``arg_bytes`` and ``out_bytes``; ``peak_bytes`` is
  their sum, as in the reference.  The CPU keeps no allocator statistics:
  there ``peak_bytes`` is None, ``error`` says why and ``available`` is
  False (the reference's rule: flops and peak both reported), the degraded
  form of the reference's backends that cannot report;
* **collectives** -- ``parallel.mesh.all_reduce``, the port's one
  collective funnel, tallies every call's payload bytes
  (``mesh.COLLECTIVES``); the record keeps the call's delta
  (``collective_bytes``, ``collectives``).

Capture contract (the reference's): off by default, and :func:`instrument`
with no collector installed is one ``None`` check returning its value;
under :func:`collecting` a step cache's miss (``utils.cache.LRUCache``:
the models' ``_STEP_CACHE`` and ``_PIPE_CACHE``) wraps the builder's
product in a one-shot proxy whose first call is measured, its record named
by the cache.  A hit is not measured again: clear the caches before a
scope that must see a program built.  Measuring launches nothing and
changes no value: a fit under ``collecting()`` is bit-equal to the same fit
without it, with the same launch counts.  A measurement that fails gives a
record with ``available=False`` and never fails the fit.

Where the measured call is a device loop (``parallel.distributed``'s
``make_fit_fn`` and the other loop builders), the proxy does not measure
the whole call: a CUDA graph must not be captured under the profiler.  It
leaves a request that the loop's next launch takes
(``_Replay._launch``): the eager first iteration that precedes the graph
capture, or the first replay of a graph captured earlier (on the CPU, the
first eager iteration).  So a loop's record is one iteration, as the
reference's loop bodies are counted once.

Caveats: ``torch.cuda.reset_peak_memory_stats`` is process-wide, so a
capture while another thread allocates on the same device counts that
thread's bytes too; the first profiler session of a process starts CUPTI,
which takes seconds, so a capture's first call is not a timing.  On an
H100 with torch 2.11 the profiler's records of a session were complete in
a fresh process but lost, in part or whole, once the process had run
about a minute of kernel traffic between sessions (ROADMAP B.15): a
record whose profile holds no device activity says so in ``error``; its
flops, memory and collective bytes do not come from the profiler.

Pure stdlib at import (torch loads at capture time).
"""

from __future__ import annotations

import contextlib
import json
import threading
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from kmeans_tpu_torch.obs import trace as _trace
from kmeans_tpu_torch.obs.metrics_registry import REGISTRY

__all__ = ["CostRecord", "CostCollector", "collecting", "get_collector",
           "instrument", "measure_call",
           "analytic_step_flops", "crosscheck", "roofline_fields",
           "gmm_flops_per_iter", "kmeans_flops_per_iter",
           "FLOPS_AGREEMENT_RTOL"]

#: The committed analytic-against-measured FLOPs band (the reference's):
#: |reported / analytic - 1| <= 10 % on the kmeans and gmm-diag step
#: programs in the torch 'matmul' mode.
FLOPS_AGREEMENT_RTOL = 0.10


@dataclass
class CostRecord:
    """One program's measured device cost.  The reference's fields, and
    the port's measurements beside them (``device_ms``, ``kernels``,
    ``launches``, ``flops_aten``, ``flops_declared``, ``flops_source``).
    ``None`` means not measured.  ``key`` is the repr of the cache's key:
    the builder's name and its arguments (``utils.cache.builder_key``)."""

    cache: str
    key: str
    role: Optional[int] = None
    backend: str = "?"
    n_devices: int = 1
    available: bool = False
    error: Optional[str] = None
    flops: Optional[float] = None
    transcendentals: Optional[float] = None
    bytes_accessed: Optional[float] = None
    arg_bytes: Optional[int] = None
    out_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    alias_bytes: Optional[int] = None
    code_bytes: Optional[int] = None
    peak_bytes: Optional[int] = None  # arg + out + temp
    collective_bytes: Optional[float] = None
    collectives: Optional[int] = None
    device_ms: Optional[float] = None
    kernels: Optional[List[dict]] = None
    launches: Dict[str, int] = field(default_factory=dict)
    flops_aten: Optional[float] = None
    flops_declared: Optional[float] = None
    flops_source: Optional[str] = None
    region: Optional[str] = None    # 'call' | 'warm-up' | 'replay' | 'eager'

    def arithmetic_intensity(self) -> Optional[float]:
        """flops / bytes-accessed; None where either is not measured (the
        port measures no bytes accessed)."""
        if self.flops is None or not self.bytes_accessed:
            return None
        return self.flops / self.bytes_accessed

    def to_dict(self) -> dict:
        d = asdict(self)
        d["ai"] = self.arithmetic_intensity()
        return d


# ------------------------------------------------------------ collector

#: Process-wide active collector (None = capture off, the default).
_COLLECTOR: Optional["CostCollector"] = None


class CostCollector:
    """Sink for :class:`CostRecord`\\ s, one per (cache, key, role);
    thread-safe.  Each accepted record writes through the registry
    (``cost.captured`` / ``cost.unavailable``, the ``cost.peak_bytes``
    gauge) and, under a tracer, a ``cost.record`` event."""

    def __init__(self):
        self.closed = False
        self._lock = threading.Lock()
        self._records: List[CostRecord] = []
        self._seen: set = set()

    def seen(self, ident) -> bool:
        with self._lock:
            return ident in self._seen

    def add(self, rec: CostRecord) -> bool:
        ident = (rec.cache, rec.key, rec.role)
        with self._lock:
            if self.closed or ident in self._seen:
                return False
            self._seen.add(ident)
            self._records.append(rec)
        REGISTRY.counter("cost.captured" if rec.available
                         else "cost.unavailable").inc()
        if rec.available and rec.peak_bytes is not None:
            g = REGISTRY.gauge("cost.peak_bytes")
            if g.value is None or rec.peak_bytes > g.value:
                g.set(rec.peak_bytes)
        _trace.event("cost.record", **{
            k: v for k, v in rec.to_dict().items() if v is not None})
        return True

    def records(self) -> List[CostRecord]:
        with self._lock:
            return list(self._records)

    def by_cache(self) -> Dict[str, List[CostRecord]]:
        out: Dict[str, List[CostRecord]] = {}
        for rec in self.records():
            out.setdefault(rec.cache, []).append(rec)
        return out

    def max_metrics(self) -> dict:
        """The largest available peak bytes and flops over the records:
        the heartbeat's ``mem_peak_bytes`` / ``program_flops``."""
        recs = self.records()
        peaks = [r.peak_bytes for r in recs
                 if r.available and r.peak_bytes is not None]
        flops = [r.flops for r in recs
                 if r.available and r.flops is not None]
        return {"mem_peak_bytes": max(peaks) if peaks else None,
                "program_flops": max(flops) if flops else None}

    def write_jsonl(self, path) -> None:
        with open(path, "w") as f:
            for rec in self.records():
                f.write(json.dumps(rec.to_dict(), default=str) + "\n")


def get_collector() -> Optional[CostCollector]:
    """The active collector, or None (capture off, the default)."""
    return _COLLECTOR


@contextlib.contextmanager
def collecting(path=None, collector: Optional[CostCollector] = None):
    """Install a collector for the ``with`` body (nested scopes shadow);
    on exit restore the previous one, close this one and write its records
    as JSONL to ``path`` when given::

        with obs.cost.collecting() as col:
            model.fit(X)
        for rec in col.records():
            print(rec.cache, rec.flops, rec.peak_bytes, rec.kernels)
    """
    global _COLLECTOR
    col = collector if collector is not None else CostCollector()
    prev, _COLLECTOR = _COLLECTOR, col
    try:
        yield col
    finally:
        _COLLECTOR = prev
        col.closed = True
        if path is not None:
            col.write_jsonl(path)


# ------------------------------------------------------------ measuring

#: Held while a call is measured: a program called inside a measured one
#: (a loop's step) is not measured again, and no two profilers nest.
_MEASURE_LOCK = threading.Lock()


def _tensors(obj, out: dict, depth: int = 0) -> None:
    """The tensors in ``obj`` by storage address: tuples, lists, dicts,
    named tuples, and a dataset's ``points`` and ``weights``."""
    import torch
    if depth > 4 or obj is None:
        return
    if isinstance(obj, torch.Tensor):
        try:
            out.setdefault(obj.untyped_storage().data_ptr(), obj)
        except RuntimeError:
            pass
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out, depth + 1)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out, depth + 1)
    elif hasattr(obj, "points") and hasattr(obj, "weights"):
        _tensors((obj.points, obj.weights), out, depth + 1)


def _nbytes(tensors: dict) -> int:
    return int(sum(t.untyped_storage().nbytes() for t in tensors.values()))


def _device_of(tensors: dict):
    for t in tensors.values():
        return t.device
    return None


def _kernel_name(name: str) -> str:
    """A device activity's name without its return type, anonymous
    namespace, template arguments and parameters
    (``fused_assign_reduce_kernel``, ``at::native::reduce_kernel``); a copy
    or a fill keeps its own (``Memcpy HtoD (Pageable -> Device)``)."""
    short = name.replace("(anonymous namespace)::", "")
    if short.startswith("void "):
        short = short[5:]
    if short.startswith(("Memcpy", "Memset")):
        return short
    cut = [i for i in (short.find("<"), short.find("(")) if i > 0]
    return short[:min(cut)] if cut else short


def _profiled_kernels(prof) -> List[dict]:
    """Each device activity of a profile by :func:`_kernel_name`: count and
    milliseconds, the heaviest first."""
    import torch
    agg: Dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        tr = evt.time_range
        row = agg.setdefault(_kernel_name(evt.name), [0, 0.0])
        row[0] += 1
        row[1] += (tr.end - tr.start) / 1e3
    return sorted(({"name": n, "launches": c, "ms": ms}
                   for n, (c, ms) in agg.items()),
                  key=lambda r: -r["ms"])


def _flop_counter():
    """The aten operation counter of a capture."""
    from torch.utils.flop_counter import FlopCounterMode
    return FlopCounterMode(display=False)


def measure_call(run, *, cache: str, key: str = "",
                 role: Optional[int] = None, args=(), outputs=None,
                 region: str = "call", n_devices: int = 1):
    """Run ``run()`` once, measured; returns ``(result, CostRecord)``.
    ``args`` holds the tensors the call reads; ``outputs`` those it
    writes (None: its result's).  A failure of the measurement itself
    gives ``available=False``; a failure of ``run`` propagates."""
    import torch

    from kmeans_tpu_torch.ops import _build
    from kmeans_tpu_torch.parallel import mesh as _mesh

    rec = CostRecord(cache=cache, key=key, role=role, region=region,
                     n_devices=int(n_devices))
    ins: dict = {}
    _tensors(args, ins)
    device = _device_of(ins)
    cuda = device is not None and device.type == "cuda"
    rec.backend = "cuda" if cuda else "cpu"
    launches0, ops0 = dict(_build.LAUNCHES), dict(_build.OPS)
    comm0 = dict(_mesh.COLLECTIVES)
    errors: List[str] = []
    prof = None
    scope = contextlib.ExitStack()
    try:
        if cuda:
            torch.cuda.synchronize(device)
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            prof = scope.enter_context(torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]))
        counter = scope.enter_context(_flop_counter())
    except Exception as e:  # noqa: BLE001 -- capture never fails a fit
        scope.close()
        rec.error = f"capture: {type(e).__name__}: {e}"
        return run(), rec
    with scope:
        result = run()
        if cuda:
            torch.cuda.synchronize(device)
    try:
        rec.launches = {n: c - launches0.get(n, 0)
                        for n, c in _build.LAUNCHES.items()
                        if c - launches0.get(n, 0)}
        declared = float(sum(v - ops0.get(n, 0)
                             for n, v in _build.OPS.items()))
        aten = float(counter.get_total_flops())
        rec.flops_aten, rec.flops_declared = aten, declared
        rec.flops = aten + declared
        rec.flops_source = "+".join(
            name for name, v in (("aten", aten), ("declared", declared))
            if v) or "aten"
        rec.collective_bytes = float(_mesh.COLLECTIVES["bytes"]
                                     - comm0["bytes"])
        rec.collectives = int(_mesh.COLLECTIVES["count"] - comm0["count"])
        outs: dict = {}
        _tensors(result if outputs is None else outputs, outs)
        rec.arg_bytes = _nbytes(ins)
        rec.out_bytes = _nbytes({p: t for p, t in outs.items()
                                 if p not in ins})
        if cuda:
            rec.temp_bytes = max(
                int(torch.cuda.max_memory_allocated(device)) - int(base), 0)
            rec.peak_bytes = rec.arg_bytes + rec.out_bytes + rec.temp_bytes
            rec.kernels = _profiled_kernels(prof)
            rec.device_ms = float(sum(k["ms"] for k in rec.kernels))
            if not rec.kernels:
                errors.append("profiler: no device activity recorded")
        else:
            errors.append(f"memory: the {rec.backend} device keeps no "
                          f"allocator statistics")
    except Exception as e:  # noqa: BLE001 -- capture never fails a fit
        errors.append(f"capture: {type(e).__name__}: {e}")
    rec.available = rec.flops is not None and rec.peak_bytes is not None
    rec.error = "; ".join(errors) if errors else None
    return result, rec


def _capturing_graph() -> bool:
    import torch
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


# ------------------------------------------------------- capture proxy

#: A device loop's pending measurement (see the module's docstring): the
#: proxy leaves it, the loop's next launch takes it.
_REQUEST: Optional[dict] = None


def take_request() -> Optional[dict]:
    """The pending loop measurement, once; None (one check) when there is
    none."""
    global _REQUEST
    req = _REQUEST
    if req is None:
        return None
    _REQUEST = None
    return req


def measure_launch(req: dict, run, *, args, outputs, region: str):
    """A device loop's launch ``run()`` measured for the request ``req``
    (:func:`take_request`); the record goes to the request's collector."""
    if not _MEASURE_LOCK.acquire(blocking=False):
        return run()
    try:
        result, rec = measure_call(run, cache=req["cache"], key=req["key"],
                                   role=req["role"], args=args,
                                   outputs=outputs, region=region)
    finally:
        _MEASURE_LOCK.release()
    _add(req["collector"], rec)
    return result


def _add(col: CostCollector, rec: CostRecord) -> None:
    try:
        col.add(rec)
    except Exception:  # noqa: BLE001 -- a broken collector never fails a fit
        pass


class _CapturedProgram:
    """One-shot capturing proxy around a builder's product: the first call
    is measured (a loop's: its first launch, see :func:`take_request`),
    every call delegates to the wrapped callable unchanged.  Attribute
    access falls through."""

    __slots__ = ("_fn", "_cache", "_key", "_role", "_collector", "_done",
                 "_loop")

    def __init__(self, fn, cache: str, key: str, role: Optional[int],
                 collector: CostCollector, loop: bool):
        self._fn = fn
        self._cache = cache
        self._key = key
        self._role = role
        self._collector = collector
        self._done = False
        self._loop = loop

    def __call__(self, *args, **kwargs):
        global _REQUEST
        if self._done:
            return self._fn(*args, **kwargs)
        self._done = True
        col = self._collector
        if col.closed or col.seen((self._cache, self._key, self._role)) \
                or _MEASURE_LOCK.locked() or _capturing_graph():
            return self._fn(*args, **kwargs)
        if self._loop:
            _REQUEST = {"cache": self._cache, "key": self._key,
                        "role": self._role, "collector": col}
            try:
                return self._fn(*args, **kwargs)
            finally:
                _REQUEST = None
        if not _MEASURE_LOCK.acquire(blocking=False):
            return self._fn(*args, **kwargs)
        try:
            result, rec = measure_call(
                lambda: self._fn(*args, **kwargs), cache=self._cache,
                key=self._key, role=self._role, args=(args, kwargs))
        finally:
            _MEASURE_LOCK.release()
        _add(col, rec)
        return result

    def __getattr__(self, name):
        return getattr(self._fn, name)


def instrument(cache_name: str, key, value, *, loop: bool = False):
    """A step cache's new entry (``utils.cache.LRUCache``'s miss) wrapped
    for capture when a collector is active; ``value`` untouched otherwise
    (one ``None`` check).  The record's ``cache`` is ``cache_name``, its
    ``key`` the repr of the cache's key.  A tuple keeps its
    structure, each callable member wrapped with its index as ``role``.
    ``loop``: the product is a device loop, measured at its first
    launch."""
    col = _COLLECTOR
    if col is None:
        return value
    key_repr = repr(key)
    if isinstance(value, tuple):
        return tuple(
            _CapturedProgram(v, cache_name, key_repr, i, col, loop)
            if callable(v) else v for i, v in enumerate(value))
    if callable(value):
        return _CapturedProgram(value, cache_name, key_repr, None, col, loop)
    return value


def program(loop: bool = False):
    """Decorator of the ``parallel`` program builders: the builder runs
    under a ``trace`` span (``obs.trace.traced_builder``), and a device
    loop's product is tagged ``_cost_loop`` so that the cache that keeps it
    (``utils.cache.LRUCache``, whose miss calls :func:`instrument`)
    measures it at its first launch."""
    import functools

    def deco(builder):
        @functools.wraps(builder)
        def build(*args, **kwargs):
            product = builder(*args, **kwargs)
            if loop:
                product._cost_loop = True
            return product
        return _trace.traced_builder(build)
    return deco


# ------------------------------------------------------------- roofline

def gmm_flops_per_iter(n: int, d: int, k: int,
                       cov_type: str = "diag") -> float:
    """The real operations of one EM iteration's E pass (the reference's
    ``benchmarks.gmm_flops_per_iter``): 'diag' / 'spherical' 8 n D k;
    'full' 4 n k D^2 + 4 n D k; 'tied' 2 n D^2 + 4 n D k."""
    if cov_type in ("diag", "spherical"):
        return 8.0 * n * d * k
    if cov_type == "full":
        return 4.0 * n * k * d * d + 4.0 * n * d * k
    if cov_type == "tied":
        return 2.0 * n * d * d + 4.0 * n * d * k
    raise ValueError(f"unknown covariance type {cov_type!r}")


def kmeans_flops_per_iter(n: int, d: int, k: int) -> float:
    """The real operations of one Lloyd iteration (the reference's
    ``benchmarks.kmeans_flops_per_iter``): the 2 n D k distance product
    and the 2 n D k one-hot product."""
    return 4.0 * n * d * k


def analytic_step_flops(family: str, n: int, d: int, k: int, *,
                        chunk: Optional[int] = None, n_devices: int = 1,
                        cov_type: str = "diag") -> float:
    """The reference's hand formula of one step pass: per-rank rows,
    bounded by ``chunk`` where given."""
    rows = -(-int(n) // max(1, int(n_devices)))
    if chunk:
        rows = min(rows, int(chunk))
    if family == "gmm":
        return gmm_flops_per_iter(rows, d, k, cov_type)
    if family in ("kmeans", "spherical", "bisecting", "minibatch"):
        return kmeans_flops_per_iter(rows, d, k)
    raise ValueError(f"unknown family {family!r}")


def crosscheck(analytic_flops: float, record: CostRecord,
               rtol: float = FLOPS_AGREEMENT_RTOL) -> dict:
    """Analytic against measured FLOPs: ``ratio`` = reported / analytic,
    ``agree`` within ``rtol``."""
    ratio = (record.flops / analytic_flops
             if record.flops is not None and analytic_flops > 0 else None)
    return {"analytic_flops": analytic_flops,
            "reported_flops": record.flops,
            "ratio": ratio,
            "agree": bool(ratio is not None
                          and abs(ratio - 1.0) <= rtol),
            "rtol": rtol}


def roofline_fields(analytic_flops: float, seconds: Optional[float],
                    record: Optional[CostRecord] = None,
                    peak_tflops: Optional[float] = None) -> dict:
    """The roofline columns: ``analytic_flops``, ``ai`` (the record's
    flops over bytes accessed, None where not measured) and
    ``mfu_analytic`` (analytic flops over ``seconds`` against
    ``peak_tflops``; None without a peak)."""
    ai = record.arithmetic_intensity() if record is not None else None
    mfu = None
    if peak_tflops and seconds and seconds > 0:
        mfu = analytic_flops / seconds / (peak_tflops * 1e12)
    return {"analytic_flops": analytic_flops, "ai": ai,
            "mfu_analytic": mfu}
