"""Span tracing: timestamped lifecycle phases, JSONL + Chrome export.

The port's copy of the JAX package's ``obs/trace.py``: the same
:class:`Tracer`, span taxonomy, record schema and export formats, so a
trace written by either package reads with the other's tools (the JSONL
header keeps the reference's ``"format": "kmeans_tpu.trace.v1"``).

* ``place`` / ``stage`` — a dataset's placement on its device and each
  copy of rows to it (``parallel.sharding``, ``data.io``,
  ``data.synthetic``, the prefetch producer's ``stage(via='prefetch')``);
* ``trace`` — a program builder of ``parallel`` assembling its program
  (:func:`traced_builder`);
* ``compile`` — a kernel library's ``nvcc`` build (``via='nvcc'``) or
  load (``via='load'``, ``ops._build``), and a device loop's CUDA graph
  capture (``via='graph-capture'``, ``parallel.distributed``);
* ``seed`` — the initial centroids or mixture parameters;
* ``dispatch`` — one host->device dispatch the host then waits on, the
  readback of its result inside the span (``lloyd/step``, ``em/step``,
  ``stream/block``, ``fit/multi``, ``minibatch/step``, ``fit/segment``,
  the engine's dispatches); ``note_dispatch`` labels
  (``utils.profiling``) land as instant events;
* ``segment`` — one checkpoint segment of a fit, its dispatch attempts
  nested (``models.fault_tolerance``);
* ``checkpoint.save`` / ``checkpoint.restore`` (``utils.checkpoint``);
* ``io.block`` — one block read from a stream or a file (``data.io``);
* ``serve.request`` / ``serve.flush`` — serving-engine dispatches and
  micro-batch queue flushes (``serving.engine``, ``serving.batching``);
* ``collective`` — a host-side cross-process wait (the fleet barrier,
  ``parallel.multihost.fleet_barrier``).

Disabled-path contract: with no tracer installed, :func:`span` returns a
shared null context manager and :func:`event` returns at once — no
allocation, no lock, no record.  Tracing never touches model
arithmetic, so served labels are the same with it on or off.

Pure stdlib.  Records carry the producing process's identity
(``obs.identity``: the ``torch.distributed`` rank where a process group
is up).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from kmeans_tpu_torch.obs import identity as _identity
from kmeans_tpu_torch.obs.metrics_registry import nearest_rank

__all__ = ["Tracer", "span", "event", "tracing", "get_tracer",
           "read_jsonl", "summarize", "SPAN_NAMES", "TraceReadError",
           "traced_builder"]

#: The span taxonomy (documentation + the CLI's table ordering; call
#: sites may add dotted sub-names like ``checkpoint.save``).  The
#: ``collective`` span wraps host-side cross-process
#: collectives (``process_allgather``, the fleet barrier) — the
#: ``collective-span`` lint rule enforces coverage in ``parallel/``.
SPAN_NAMES = (
    "place", "stage", "compile", "trace", "seed", "dispatch", "segment",
    "checkpoint.save", "checkpoint.restore", "io.block",
    "serve.request", "serve.flush", "collective",
)


class TraceReadError(ValueError):
    """A trace JSONL file is unreadable or malformed (the CLI's exit-2
    classification)."""


class _NullSpan:
    """The disabled-path context manager: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

#: Process-wide active tracer (None = telemetry off, the default).
#: Installed/restored by :func:`tracing`; read by the module-level
#: fast paths.  A plain attribute (not thread-local): one fit's spans
#: may come from several threads (the prefetch producer stages blocks),
#: and they must all land in the same trace.
_TRACER: Optional["Tracer"] = None


class Tracer:
    """Process-wide span recorder.

    Records are plain dicts (JSON-ready).  Span nesting is tracked with
    a PER-THREAD stack, so spans opened on the prefetch producer thread
    nest among themselves and never corrupt the fit thread's stack.
    Timestamps are ``time.perf_counter()`` relative to the tracer's
    start (monotonic, sub-µs); ``wall0`` anchors them to wall time for
    cross-process correlation.
    """

    def __init__(self):
        self.wall0 = time.time()
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._records: List[dict] = []
        self._tls = threading.local()
        self._next_id = 0
        self._ident: Optional[dict] = None
        # Incremental per-name SELF-time accumulators: +dur on close,
        # -dur from the enclosing span's name — so phase_totals() is
        # O(names), not a re-walk of every record (the heartbeat reads
        # it per boundary; a full summarize() there would make
        # tracing+heartbeat quadratic in iterations).
        self._phase_self: Dict[str, float] = {}

    # ------------------------------------------------------------ time
    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def identity(self) -> dict:
        """This tracer's fleet identity (process_index/count, host) —
        resolved lazily on first use (by which time a multi-host
        program has set up its process group: the mesh needs it
        before any fit runs) and cached for the tracer's lifetime, so
        per-record stamping costs three dict inserts, not a lookup."""
        if self._ident is None:
            self._ident = _identity.identity()
        return self._ident

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # ----------------------------------------------------------- spans
    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """One timed, nested span.  Exceptions propagate (the span still
        closes, stamped ``error`` with the exception type) — tracing a
        failing fit must record the failure, never mask it."""
        stack = self._stack()
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        parent = stack[-1] if stack else None
        # Fleet identity: every record carries its producer's
        # coordinates so merged multi-host streams stay attributable
        # record-by-record (the file header alone would be lost on
        # re-slicing).  Cached — three dict inserts per span.
        rec = {"kind": "span", "name": name, "id": sid,
               "parent": parent["id"] if parent else None,
               "depth": len(stack),
               "tid": threading.get_ident(),
               **self.identity(),
               "t0": self._now(), "t1": None, "dur": None}
        if attrs:
            rec["attrs"] = _jsonable(attrs)
        stack.append(rec)
        try:
            yield rec
        except BaseException as e:
            rec["error"] = type(e).__name__
            raise
        finally:
            stack.pop()
            rec["t1"] = self._now()
            rec["dur"] = rec["t1"] - rec["t0"]
            with self._lock:
                self._records.append(rec)
                ps = self._phase_self
                ps[name] = ps.get(name, 0.0) + rec["dur"]
                if parent is not None:
                    # The enclosing span will add its FULL duration
                    # when it closes; subtracting the child here keeps
                    # the accumulator a self-time total.
                    pname = parent["name"]
                    ps[pname] = ps.get(pname, 0.0) - rec["dur"]

    def event(self, name: str, **attrs) -> None:
        """One instant (zero-duration) event at the current nesting."""
        stack = self._stack()
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._records.append({
                "kind": "event", "name": name, "id": sid,
                "parent": stack[-1]["id"] if stack else None,
                "depth": len(stack), "tid": threading.get_ident(),
                **self.identity(),
                "t0": self._now(), "t1": None, "dur": 0.0,
                **({"attrs": _jsonable(attrs)} if attrs else {})})

    def instant_span(self, name: str, **attrs) -> None:
        """A zero-length SPAN (not an event): what the recompilation
        sentinel emits for cache growth it detected after the fact, so
        a sentinel violation appears on the timeline as a ``compile``
        span naming the cache even though the miss itself was not
        traced."""
        with self.span(name, **attrs):
            pass

    # --------------------------------------------------------- reading
    def records(self) -> List[dict]:
        """Snapshot of all closed records (spans close at exit; an open
        span is not yet visible)."""
        with self._lock:
            return list(self._records)

    def phase_totals(self) -> Dict[str, float]:
        """name -> total SELF seconds (nested child time excluded) —
        the heartbeat's elapsed-per-phase payload.  O(names) from the
        incremental accumulators, never a record re-walk; a name whose
        enclosing span is still open may read transiently low (its
        children already subtracted) — clamped at 0, and exact again
        once the parent closes.  ``summarize(records())`` is the exact
        post-hoc computation."""
        with self._lock:
            return {name: max(v, 0.0)
                    for name, v in self._phase_self.items()}

    # --------------------------------------------------------- exports
    def write_jsonl(self, path) -> None:
        """One JSON record per line; first line is a header record
        carrying the wall-clock anchor and pid."""
        with open(path, "w") as f:
            self._dump_jsonl(f)

    def to_jsonl(self) -> str:
        buf = io.StringIO()
        self._dump_jsonl(buf)
        return buf.getvalue()

    def _dump_jsonl(self, f) -> None:
        f.write(json.dumps({"kind": "header", "wall0": self.wall0,
                            "pid": os.getpid(), **self.identity(),
                            "format": "kmeans_tpu.trace.v1"}) + "\n")
        for rec in self.records():
            f.write(json.dumps(rec) + "\n")

    def write_chrome(self, path) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": chrome_events(self.records()),
                       "displayTimeUnit": "ms"}, f)


def _jsonable(attrs: dict) -> dict:
    """Attrs must serialize; anything exotic is repr'd (truncated) so a
    span can never make the export throw."""
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = repr(v)[:120]
    return out


def chrome_events(records: List[dict]) -> List[dict]:
    """Chrome ``trace_event`` array from trace records: complete events
    (``ph='X'``) for spans, instant events (``ph='i'``) for events —
    the schema chrome://tracing and Perfetto load directly.

    Fleet rendering: records from a multi-process fit carry
    ``process_index``/``host``; each host then becomes its OWN Chrome
    process (``pid`` = process_index, a ``process_name`` metadata event
    labels it with the host name), so a merged timeline shows one track
    group per host.  Single-process records keep ``pid`` = the OS pid —
    the single-process schema, unchanged."""
    os_pid = os.getpid()
    out = []
    hosts = {}                      # pid -> host label (fleet records)
    for rec in records:
        if rec.get("kind") == "header":
            continue
        if rec.get("process_count", 1) > 1:
            pid = int(rec.get("process_index", 0))
            hosts.setdefault(
                pid, f"{rec.get('host', '?')} (p{pid})")
        else:
            pid = rec.get("process_index") if "process_index" in rec \
                and _is_merged(rec) else os_pid
            pid = os_pid if pid is None else pid
        base = {"name": rec["name"], "pid": pid, "tid": rec["tid"],
                "ts": round(rec["t0"] * 1e6, 3),
                "args": rec.get("attrs", {})}
        if rec["kind"] == "span":
            out.append({**base, "ph": "X",
                        "dur": round((rec["dur"] or 0.0) * 1e6, 3)})
        else:
            out.append({**base, "ph": "i", "s": "t"})
    out.sort(key=lambda e: e["ts"])
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": label}}
            for pid, label in sorted(hosts.items())]
    return meta + out


def _is_merged(rec: dict) -> bool:
    """True for records a fleet merge re-stamped (they carry the
    merged-stream marker) — their process_index is a track id even when
    the source fit was single-process-per-host."""
    return bool(rec.get("fleet_merged"))


# --------------------------------------------------- module fast paths

def get_tracer() -> Optional[Tracer]:
    """The active tracer, or None (telemetry off — the default)."""
    return _TRACER


def active() -> bool:
    return _TRACER is not None


def span(name: str, **attrs):
    """Context manager recording a span under the active tracer; the
    shared no-op context when tracing is off (no allocation)."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return t.span(name, **attrs)


def event(name: str, **attrs) -> None:
    """Instant event under the active tracer; no-op when tracing is off."""
    t = _TRACER
    if t is not None:
        t.event(name, **attrs)


def traced_builder(fn):
    """Decorator of the ``parallel`` program builders: the builder runs
    under a ``trace`` span (``builder=<its name>``) when a tracer is
    active; one extra Python call and nothing else when off.  The kernels'
    library load and a device loop's graph capture happen at the first
    call of the product, inside the first ``dispatch``."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t = _TRACER
        if t is None:
            return fn(*args, **kwargs)
        with t.span("trace", builder=fn.__name__):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def tracing(path=None, chrome=None, tracer: Optional[Tracer] = None,
            per_process: object = "auto"):
    """Install a tracer for the ``with`` body (nested scopes shadow,
    like ``log_dispatches``); on exit restore the previous one and
    write the JSONL/Chrome exports when paths were given.

    Multi-host sinks: under ``process_count > 1`` every host
    runs this scope, and N hosts appending to ONE path would tear the
    file — so by default (``per_process='auto'``) each process writes
    to the suffixed ``identity.per_process_path`` (``trace.jsonl`` ->
    ``trace.p3.jsonl``; ``obs.fleet``/``trace summarize`` glob these
    back together).  ``per_process=False`` is the primary-only
    alternative: ONLY process 0 writes, at the verbatim path — a
    one-host sample of the fleet, for operators who want a single file
    and accept losing the other hosts' spans.  ``per_process=True``
    forces the suffix even single-process (harness use).  Single
    process + 'auto' keeps the verbatim path.

    Usage::

        with obs.tracing("fit.jsonl") as tr:
            model.fit(X)
        # fit.jsonl now holds the span records; also:
        table = obs.time_to_first_iteration(tr.records())
    """
    global _TRACER
    if per_process not in ("auto", True, False):
        # Validate up front (the Heartbeat rule): silently degrading a
        # typo'd policy to every-host-writes-the-verbatim-path would
        # reintroduce the torn-shared-file collision this knob fixes.
        raise ValueError(f"per_process must be 'auto', True or False, "
                         f"got {per_process!r}")
    t = tracer if tracer is not None else Tracer()
    prev, _TRACER = _TRACER, t
    try:
        yield t
    finally:
        _TRACER = prev
        ident = t.identity()
        suffix = per_process is True or (
            per_process == "auto" and ident["process_count"] > 1)
        primary_only = per_process is False \
            and ident["process_count"] > 1
        writer = not (primary_only and ident["process_index"] != 0)
        if path is not None and writer:
            t.write_jsonl(_identity.per_process_path(
                path, ident["process_index"]) if suffix else path)
        if chrome is not None and writer:
            t.write_chrome(_identity.per_process_path(
                chrome, ident["process_index"]) if suffix else chrome)


# ----------------------------------------------------------- analysis

def read_jsonl(path) -> List[dict]:
    """Load a trace JSONL file back into records.

    Raises :class:`TraceReadError` for unreadable files, non-JSON
    lines, or records missing the span schema — the CLI's exit-2
    classification (a partial file from a crashed writer is malformed,
    not silently half-summarized)."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError as e:
        raise TraceReadError(f"cannot read trace file {path}: {e}") from e
    records = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            raise TraceReadError(
                f"{path}:{i + 1}: not a JSON record ({e.msg})") from e
        if not isinstance(rec, dict) or "kind" not in rec:
            raise TraceReadError(
                f"{path}:{i + 1}: not a trace record (missing 'kind')")
        if rec["kind"] in ("span", "event") and any(
                field not in rec for field in ("name", "t0", "id")):
            # 'id' is load-bearing downstream (self_times keys on it);
            # a truncated/hand-edited record without it must classify
            # as malformed here, not KeyError deep in summarize.
            raise TraceReadError(
                f"{path}:{i + 1}: malformed {rec['kind']} record "
                f"(missing name/t0/id)")
        records.append(rec)
    if not any(r.get("kind") in ("span", "event") for r in records):
        raise TraceReadError(f"{path}: no span or event records")
    return records


def self_times(records: List[dict]) -> Dict[int, float]:
    """span id -> EXCLUSIVE seconds (duration minus direct children):
    the double-count-free attribution nested spans need (a ``stage``
    span inside a prefetch ``stage`` span must not count twice)."""
    spans = [r for r in records if r.get("kind") == "span"]
    child_dur: Dict[int, float] = {}
    for s in spans:
        p = s.get("parent")
        if p is not None:
            child_dur[p] = child_dur.get(p, 0.0) + (s.get("dur") or 0.0)
    return {s["id"]: max((s.get("dur") or 0.0)
                         - child_dur.get(s["id"], 0.0), 0.0)
            for s in spans}


def summarize(records: List[dict]) -> Dict[str, dict]:
    """Per-phase rollup: ``{name: {count, total, p50, p99, events}}``
    with ``total``/percentiles over SELF time (nested child time
    excluded, :func:`self_times`) in seconds.  Instant events roll up
    as counts under their own names."""
    selfs = self_times(records)
    by_name: Dict[str, List[float]] = {}
    ev_counts: Dict[str, int] = {}
    for rec in records:
        if rec.get("kind") == "span":
            by_name.setdefault(rec["name"], []).append(selfs[rec["id"]])
        elif rec.get("kind") == "event":
            ev_counts[rec["name"]] = ev_counts.get(rec["name"], 0) + 1
    out: Dict[str, dict] = {}
    for name, vals in by_name.items():
        vals = sorted(vals)
        out[name] = {"count": len(vals), "total": sum(vals),
                     "p50": nearest_rank(vals, 0.50),
                     "p99": nearest_rank(vals, 0.99),
                     "events": 0}
    for name, n in ev_counts.items():
        row = out.setdefault(name, {"count": 0, "total": 0.0,
                                    "p50": 0.0, "p99": 0.0, "events": 0})
        row["events"] += n
    return out


def run_scoped(fn: Callable, *args, **kwargs):
    """(result, records): run ``fn`` under a fresh tracer and return its
    records — the programmatic one-shot the report helpers build on."""
    with tracing() as t:
        result = fn(*args, **kwargs)
    return result, t.records()
