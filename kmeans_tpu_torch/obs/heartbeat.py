"""Fit heartbeats: periodic progress records for orchestration.

Counterpart of the JAX package's ``obs/heartbeat.py``: a health and
progress channel ("is the fit alive, how far along, what is it doing")
that adds no launch and no synchronization to the fit, opt-in and free
when off:

* Models report progress at the boundaries where the host already holds
  the state: a host-loop iteration's end, a device-loop fit's end, a
  bisecting split, a checkpoint write
  (``AutoCheckpointMixin._write_autockpt``) and a fit's end, through
  :func:`note_progress`, a no-op unless a :class:`Heartbeat` is
  installed.  Every record is built from host attributes the boundary
  already has: no ``.item()``, no synchronize, no extra launch.
* A :class:`Heartbeat` turns those reports into records on a JSONL file
  and/or a callback.  With ``interval_s`` a background thread re-emits the
  latest record on that cadence (stamped ``"tick": true``), the liveness
  signal during a long device segment; it is joined at ``close()``.

Record schema (one JSON object per emission)::

    {"ts": <wall seconds>, "mono": <monotonic seconds>,
     "family": "kmeans", "model_class": "KMeans", "k": 64,
     "phase": "iteration" | "checkpoint" | "split" | "fit" | "finished",
     "iteration": 12, "segment": 3, "shift": 1.3e-3,
     "inertia": 8.1e4, "effective_chunk": 65536, "oom_backoffs": 0,
     "dispatch_counts": {...},        # registry dispatch.* counters
     "phase_elapsed": {...},          # tracer per-phase self seconds
     "mem_peak_bytes": 1234, "program_flops": 5.6e9,  # cost collector
     "tick": true                     # only on timer re-emissions
    }

Fields are best-effort: a family without an attribute leaves it out.  The
device-cost fields ``mem_peak_bytes`` and ``program_flops`` are the active
cost collector's largest available figures (``obs.cost``), absent without
a collector or before a record is available.  Pure stdlib; never imports
the models or torch.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Callable, Optional

from kmeans_tpu_torch.obs import cost as _cost
from kmeans_tpu_torch.obs import identity as _identity
from kmeans_tpu_torch.obs import trace as _trace
from kmeans_tpu_torch.obs.metrics_registry import registry as _registry

__all__ = ["Heartbeat", "heartbeat", "note_progress", "get_heartbeat"]

#: The process-wide active heartbeat (None = off, the default).
_ACTIVE: Optional["Heartbeat"] = None

#: Model attribute -> record field: host state a boundary already holds.
_MODEL_FIELDS = (
    ("iterations_run", "iteration"),
    ("n_iter_", "iteration"),
    ("effective_chunk_", "effective_chunk"),
    ("oom_backoffs_", "oom_backoffs"),
    ("io_retries_used_", "io_retries"),
    ("checkpoint_segments_", "checkpoint_segments"),
    ("shift_", "shift"),
    ("lower_bound_", "lower_bound"),
)


def _model_record(model) -> dict:
    """Best-effort progress fields from a model's host attributes."""
    rec = {"model_class": type(model).__name__}
    spec_family = {"GaussianMixture": "gmm"}
    rec["family"] = spec_family.get(rec["model_class"], "kmeans")
    k = getattr(model, "k", None) or getattr(model, "n_components", None)
    if k is not None:
        rec["k"] = int(k)
    for attr, field in _MODEL_FIELDS:
        v = getattr(model, attr, None)
        if v is not None and field not in rec:
            try:
                rec[field] = float(v) if field in ("shift", "lower_bound") \
                    else int(v)
            except (TypeError, ValueError):
                pass
    hist = getattr(model, "sse_history", None)
    if hist:
        rec["inertia"] = float(hist[-1])
        if len(hist) >= 2 and "shift" not in rec:
            rec["sse_delta"] = float(hist[-1] - hist[-2])
    # Rows this process handles per iteration, where a fit recorded them:
    # the heartbeat derives rows_per_sec from consecutive beats.
    rows = getattr(model, "_progress_rows", None)
    if rows:
        rec["rows"] = int(rows)
    return rec


def note_progress(model=None, **fields) -> None:
    """Report one progress point to the active heartbeat; one None check
    when none is installed (every boundary calls it unconditionally)."""
    hb = _ACTIVE
    if hb is None:
        return
    rec = _model_record(model) if model is not None else {}
    rec.update(fields)
    hb.beat(rec)


def get_heartbeat() -> Optional["Heartbeat"]:
    return _ACTIVE


class Heartbeat:
    """Progress-record sink: a JSONL file and/or a callback, optionally a
    timer.

    Parameters
    ----------
    path : JSONL output (opened at the first record, flushed per record,
        closed by ``close()``); None = no file.
    callback : ``callback(record)`` per emission; an exception is counted
        (``callback_errors``) and swallowed: a broken observer never
        kills a healthy fit.
    interval_s : with a value, a background thread re-emits the latest
        record every ``interval_s`` seconds (``tick: true``) between
        boundary reports.  None (default): boundaries only, no thread.
    min_period_s : boundary reports are throttled to one per this many
        seconds (0 = every one); the latest record wins, and ``close()``
        flushes it.
    per_process : the file policy under several processes, resolved at
        the first emission.  ``'auto'``: with ``process_count > 1`` the
        path takes the per-process suffix (``hb.jsonl`` ->
        ``hb.p3.jsonl``); ``False``: only process 0 writes the file
        (callbacks fire everywhere); ``True``: always the suffix.

    Every record also carries the process's ``process_index``,
    ``process_count`` and ``host``, and, where the fit recorded its rows
    per iteration, ``rows_per_sec`` from consecutive boundary beats.
    """

    def __init__(self, path=None, callback: Optional[Callable] = None,
                 *, interval_s: Optional[float] = None,
                 min_period_s: float = 0.0, per_process: object = "auto"):
        if interval_s is not None and interval_s <= 0:
            raise ValueError(f"interval_s must be positive or None, got "
                             f"{interval_s!r}")
        if per_process not in ("auto", True, False):
            raise ValueError(f"per_process must be 'auto', True or "
                             f"False, got {per_process!r}")
        self.path = path
        self.per_process = per_process
        self.resolved_path = None       # set at the first file open
        self.callback = callback
        self.interval_s = interval_s
        self.min_period_s = float(min_period_s)
        self.emitted = 0
        self.callback_errors = 0
        self.sink_errors = 0
        self._file = None
        self._file_failed = False
        # _lock guards the bookkeeping only; emission (file IO and the
        # callback) runs under the REENTRANT _emit_lock, so a slow or
        # re-entrant observer never stalls a beat or deadlocks.
        self._lock = threading.Lock()
        self._emit_lock = threading.RLock()
        self._ident: Optional[dict] = None
        # (iteration, mono) of the last rate-bearing beat per model class.
        self._rate: dict = {}
        self._latest: Optional[dict] = None
        self._latest_unflushed = False
        self._last_emit = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        if interval_s is not None:
            self._thread = threading.Thread(
                target=self._tick_loop, name="kmeans_tpu_torch-heartbeat",
                daemon=True)
            self._thread.start()

    # -------------------------------------------------------- emission
    def beat(self, record: dict) -> None:
        """One boundary report: stamp it, keep it as the latest, emit it
        (throttled by ``min_period_s``)."""
        now = time.monotonic()
        rec = dict(record)
        rec.setdefault("ts", time.time())
        rec.setdefault("mono", now)
        if self._ident is None:
            self._ident = _identity.identity()
        for k, v in self._ident.items():
            rec.setdefault(k, v)
        mc = rec.get("model_class")
        if "iteration" in rec and "rows" in rec:
            prev = self._rate.get(mc)
            if prev is not None and rec["iteration"] > prev[0] \
                    and now > prev[1]:
                rec.setdefault("rows_per_sec",
                               (rec["iteration"] - prev[0]) * rec["rows"]
                               / (now - prev[1]))
            self._rate[mc] = (rec["iteration"], now)
        tr = _trace.get_tracer()
        if tr is not None:
            rec.setdefault("phase_elapsed", tr.phase_totals())
        col = _cost.get_collector()
        if col is not None:
            mx = col.max_metrics()
            for name in ("mem_peak_bytes", "program_flops"):
                if mx[name] is not None:
                    rec.setdefault(name, mx[name])
        counts = {name: m["value"]
                  for name, m in _registry().snapshot().items()
                  if name.startswith("dispatch.")}
        if counts:
            rec.setdefault("dispatch_counts", counts)
        with self._lock:
            if self._closed:
                return
            self._latest = rec
            if self.min_period_s and \
                    now - self._last_emit < self.min_period_s:
                self._latest_unflushed = True
                return
            self._last_emit = now
            self._latest_unflushed = False
        self._emit(rec)             # IO and callback outside the lock

    def _emit(self, rec: dict) -> None:
        """Deliver one record to the sinks, serialized by the reentrant
        ``_emit_lock`` (lines never interleave; a callback that calls
        ``note_progress`` recurses instead of deadlocking).  Both sinks
        are isolated: a failure is counted (``sink_errors``,
        ``callback_errors``) and a failed file sink is not retried."""
        with self._emit_lock:
            self.emitted += 1
            # A beat that raced close() does not reopen the closed file.
            if self.path is not None and not self._file_failed \
                    and not self._closed:
                if self._file is None and self.resolved_path is None:
                    self.resolved_path = self._resolve_path()
                    if self.resolved_path is None:
                        # Process 0 only, and this is another process:
                        # the file sink is off on purpose, not an error.
                        self._file_failed = True
                try:
                    if not self._file_failed:
                        if self._file is None:
                            self._file = open(self.resolved_path, "a")
                        # default=str: numpy scalars and paths serialize.
                        self._file.write(
                            json.dumps(rec, default=str) + "\n")
                        self._file.flush()
                except Exception:   # noqa: BLE001 — observer isolation
                    self.sink_errors += 1
                    self._file_failed = True
            if self.callback is not None:
                try:
                    self.callback(rec)
                except Exception:   # noqa: BLE001 — observer isolation
                    self.callback_errors += 1

    def _resolve_path(self) -> Optional[str]:
        """The file path under the ``per_process`` policy; None = this
        process writes no file."""
        ident = self._ident if self._ident is not None \
            else _identity.identity()
        self._ident = ident
        if self.per_process is True or (
                self.per_process == "auto"
                and ident["process_count"] > 1):
            return _identity.per_process_path(self.path,
                                              ident["process_index"])
        if self.per_process is False and ident["process_count"] > 1 \
                and ident["process_index"] != 0:
            return None
        return str(self.path)

    def _tick_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            with self._lock:
                if self._closed or self._latest is None:
                    continue
                rec = dict(self._latest)
                rec["tick"] = True
                rec["ts"] = time.time()
                rec["mono"] = time.monotonic()
                self._last_emit = time.monotonic()
                self._latest_unflushed = False
            self._emit(rec)

    # ------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Flush the last throttled record, stop and JOIN the timer
        thread, close the file.  Idempotent."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._lock:
            if self._closed:
                return
            tail = self._latest if self._latest_unflushed else None
            self._latest_unflushed = False
        if tail is not None:
            self._emit(tail)
        with self._lock:
            self._closed = True
        with self._emit_lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@contextlib.contextmanager
def heartbeat(hb_or_path=None, **kwargs):
    """Install a heartbeat for the ``with`` body (an inner scope shadows an
    outer one); the heartbeat is CLOSED on exit when this scope made it::

        with obs.heartbeat("progress.jsonl", interval_s=5.0):
            model.fit(X, checkpoint_every=8, checkpoint_path=p)
    """
    global _ACTIVE
    own = not isinstance(hb_or_path, Heartbeat)
    if not own and kwargs:
        # A built Heartbeat carries its own settings; ignoring kwargs here
        # would drop an interval_s the caller expects ticks from.
        raise ValueError(
            f"heartbeat() got keyword arguments {sorted(kwargs)} "
            f"alongside an existing Heartbeat instance — configure the "
            f"instance at construction, or pass a path/None here")
    hb = Heartbeat(hb_or_path, **kwargs) if own else hb_or_path
    prev, _ACTIVE = _ACTIVE, hb
    try:
        yield hb
    finally:
        _ACTIVE = prev
        if own:
            hb.close()
