"""Micro-batching request queue for the serving engine.

The port's copy of the JAX package's ``serving/batching.py``: concurrent
small ``predict`` / ``score`` requests against the SAME resident model
coalesce into one padded dispatch, which amortizes the per-call launch
and transfer cost.  The queue is model-agnostic: it coalesces opaque row
blocks per ``(model_id, op)`` key and hands one concatenated block to an
injected ``dispatch`` callable — the engine (``serving.engine``) owns
every device concern.

Contract (pinned by tests/test_torch_serving_queue.py, case by case the
JAX package's tests/test_serving_queue.py):

* **Per-model coalescing only.**  A flushed batch holds rows of exactly
  one ``(model_id, op)`` key.
* **Flush on full or on timer.**  A group flushes as soon as its pending
  rows reach the largest bucket (in the submitting thread — deterministic
  without the worker), or once its OLDEST request has waited
  ``max_wait_ms`` (by the worker, or an explicit ``service(now=...)``
  call — how the tests drive the timer with an injected clock).
* **Order-preserving slices.**  Each future receives exactly its own
  rows' slice of the dispatch result.
* **Error isolation.**  A request that fails validation errors its OWN
  future at submit time.  A dispatch-time failure of a coalesced batch
  re-dispatches each member request alone, so one poisoned request fails
  alone.
* **Clean shutdown.**  ``close()`` drains pending groups, joins the
  worker and is idempotent; later requests fail with
  :class:`ServingClosedError`.

``clock=`` is injectable; ``start=False`` runs no worker thread (flush on
full still works inline; timers fire only through ``service``).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from kmeans_tpu_torch.obs import trace as _obs_trace

__all__ = ["MicroBatchQueue", "ServingFuture", "ServingClosedError",
           "DEFAULT_BUCKETS", "THREAD_NAME", "bucket_for",
           "check_buckets"]

# Bucketed batch sizes: a dispatch pads its rows up to the smallest
# bucket that fits (compile once per bucket instead of once per distinct
# request size).  Oversize batches round up to a multiple of the largest
# bucket.
DEFAULT_BUCKETS = (8, 64, 512, 4096)

#: Name of the flush worker thread.
THREAD_NAME = "kmeans_tpu_torch-serving-flush"


class ServingClosedError(RuntimeError):
    """The queue (or engine) was closed before this request could run."""


class ServingFuture:
    """Minimal completion handle for one submitted request.

    ``result(timeout=None)`` blocks until the request's batch is
    dispatched and returns this request's own slice of the output (or
    re-raises the request's error).  Thread-safe; a future resolves
    exactly once.
    """

    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("serving request not completed within "
                               f"{timeout!r} s")
        if self._error is not None:
            raise self._error
        return self._value

    def exception(self, timeout: Optional[float] = None):
        """The request's error (None on success) — without raising."""
        if not self._event.wait(timeout):
            raise TimeoutError("serving request not completed within "
                               f"{timeout!r} s")
        return self._error

    # -- producer side (queue internal) --
    def _set_result(self, value) -> None:
        self._value = value
        self._event.set()

    def _set_error(self, err: BaseException) -> None:
        self._error = err
        self._event.set()


class _Pending:
    """One queued request: validated rows + its future + enqueue time."""

    __slots__ = ("rows", "m", "future", "t")

    def __init__(self, rows: np.ndarray, future: ServingFuture, t: float):
        self.rows = rows
        self.m = int(rows.shape[0])
        self.future = future
        self.t = t


def check_buckets(buckets) -> Tuple[int, ...]:
    """Validate a bucket ladder: strictly positive ints, deduped,
    ascending."""
    bs = tuple(sorted({int(b) for b in buckets}))
    if not bs or bs[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets!r}")
    return bs


def bucket_for(m: int, buckets: Tuple[int, ...]) -> int:
    """Padded dispatch size for ``m`` rows: the smallest bucket that
    fits, else the next multiple of the largest bucket (oversize
    requests stay bounded to a few distinct compiled shapes)."""
    for b in buckets:
        if m <= b:
            return b
    top = buckets[-1]
    return -(-m // top) * top


class MicroBatchQueue:
    """Coalesce concurrent requests per ``(model_id, op)`` into one
    dispatch.

    Parameters
    ----------
    dispatch : callable ``(model_id, op, rows) -> array``
        Runs one coalesced batch; must return an array whose axis 0
        aligns 1:1 with the input rows (the queue slices per request).
    buckets : ascending batch-size ladder (informational here — the
        ENGINE pads to buckets; the queue uses ``buckets[-1]`` as the
        flush-on-full threshold and the per-dispatch row cap).
    max_wait_ms : float
        Longest a request may sit waiting for co-batchable traffic
        before its group flushes (the latency/throughput knob).
    clock : callable () -> float, default ``time.monotonic``
        Injectable time source — deterministic timer tests drive
        ``service(now=...)`` against a fake clock.
    start : bool
        Start the background flush worker.  ``False`` = no thread:
        flush-on-full still runs inline in ``submit``; timer flushes
        happen only on explicit ``service()`` calls.
    validate : callable ``(model_id, op, rows) -> np.ndarray`` or None
        Maps/validates raw request rows to the canonical (m, D) block
        BEFORE enqueueing; an exception here fails ONLY this request's
        future (submit-time poison isolation).
    """

    def __init__(self, dispatch: Callable, *,
                 buckets=DEFAULT_BUCKETS, max_wait_ms: float = 2.0,
                 clock: Optional[Callable[[], float]] = None,
                 start: bool = True, validate: Optional[Callable] = None):
        self._dispatch = dispatch
        self._buckets = check_buckets(buckets)
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self._max_wait = float(max_wait_ms) / 1e3
        self._clock = clock if clock is not None else time.monotonic
        self._validate = validate
        self._cv = threading.Condition()
        self._groups: Dict[tuple, List[_Pending]] = {}
        self._closed = False
        # Observability: dispatches run, requests/rows coalesced, and a
        # per-dispatch request-count histogram (the engine layers its
        # bucket-fill histogram on top).
        self.dispatches = 0
        self.requests = 0
        self.rows = 0
        self.coalesce_hist: Dict[int, int] = {}
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._run, name=THREAD_NAME,
                daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- submit

    def submit(self, model_id, rows, *, op: str = "predict"
               ) -> ServingFuture:
        """Enqueue one request; returns its :class:`ServingFuture`.

        Validation errors (shape/dtype/non-finite rows, unknown model —
        whatever the injected ``validate`` raises) resolve THIS future
        with the error immediately: a poisoned request never taints a
        batch."""
        fut = ServingFuture()
        try:
            block = self._validate(model_id, op, rows) \
                if self._validate is not None else np.asarray(rows)
        except Exception as e:              # noqa: BLE001 — per-request
            fut._set_error(e)
            return fut
        full_batch = None
        with self._cv:
            if self._closed:
                fut._set_error(ServingClosedError(
                    "serving queue is closed"))
                return fut
            key = (model_id, op)
            group = self._groups.setdefault(key, [])
            group.append(_Pending(block, fut, self._clock()))
            self.requests += 1
            if sum(p.m for p in group) >= self._buckets[-1]:
                # Flush-on-full runs in the SUBMITTING thread (outside
                # the lock): deterministic without the worker, and the
                # submitter pays for the dispatch it completed.
                full_batch = self._take_batch(group)
                if not group:
                    del self._groups[key]
            else:
                self._cv.notify()
        if full_batch is not None:
            self._run_batch(key, full_batch)
        return fut

    # ------------------------------------------------------------- flush

    def _take_batch(self, group: List[_Pending]) -> List[_Pending]:
        """Pop the FIFO prefix whose rows fit in one dispatch (cap =
        the largest bucket); a single oversize request rides alone."""
        cap = self._buckets[-1]
        batch = [group.pop(0)]
        total = batch[0].m
        while group and total + group[0].m <= cap:
            p = group.pop(0)
            batch.append(p)
            total += p.m
        return batch

    def service(self, now: Optional[float] = None) -> int:
        """Flush every group that is due (oldest request waited
        ``max_wait_ms``) or already full.  Returns the number of
        dispatches run.  The worker calls this with the real clock;
        tests call it directly with an injected ``now``."""
        if now is None:
            now = self._clock()
        batches = []
        with self._cv:
            for key in list(self._groups):
                group = self._groups[key]
                while group and (
                        group[0].t + self._max_wait <= now
                        or sum(p.m for p in group) >= self._buckets[-1]):
                    batches.append((key, self._take_batch(group)))
                if not group:
                    del self._groups[key]
        for key, batch in batches:
            self._run_batch(key, batch)
        return len(batches)

    def _next_deadline(self) -> Optional[float]:
        """Earliest group deadline (caller holds the lock)."""
        ts = [g[0].t for g in self._groups.values() if g]
        return (min(ts) + self._max_wait) if ts else None

    def _run_batch(self, key: tuple, batch: List[_Pending]) -> None:
        model_id, op = key
        rows = batch[0].rows if len(batch) == 1 else \
            np.concatenate([p.rows for p in batch], axis=0)
        # Counters mutate under the lock: flush-on-full (submitter
        # thread) and timer flushes (worker) run _run_batch
        # concurrently, and stats() snapshots read these from yet other
        # threads.
        with self._cv:
            self.dispatches += 1
            self.rows += rows.shape[0]
            self.coalesce_hist[len(batch)] = \
                self.coalesce_hist.get(len(batch), 0) + 1
        try:
            # 'serve.flush' span: one queue flush — the
            # coalesced dispatch it runs emits its own nested
            # 'serve.request' span from the engine.
            with _obs_trace.span("serve.flush", model=str(model_id),
                                 op=op, coalesced=len(batch),
                                 rows=int(rows.shape[0])):
                out = self._dispatch(model_id, op, rows)
        except Exception as batch_err:      # noqa: BLE001 — isolated below
            if len(batch) == 1:
                batch[0].future._set_error(batch_err)
                return
            # Error isolation: re-dispatch each member alone so only the
            # poisoned request(s) fail; a transient batch fault costs one
            # isolation round.
            for p in batch:
                with self._cv:
                    self.dispatches += 1
                try:
                    p.future._set_result(self._dispatch(model_id, op,
                                                        p.rows))
                except Exception as e:      # noqa: BLE001 — per-request
                    p.future._set_error(e)
            return
        off = 0
        for p in batch:
            p.future._set_result(out[off: off + p.m])
            off += p.m

    def stats(self) -> dict:
        """Consistent counter snapshot (copies taken under the lock —
        safe against concurrent flushes)."""
        with self._cv:
            return {"dispatches": self.dispatches,
                    "requests": self.requests,
                    "rows": self.rows,
                    "coalesce_hist": dict(sorted(
                        self.coalesce_hist.items()))}

    # ------------------------------------------------------------- worker

    def _run(self) -> None:
        while True:
            with self._cv:
                if self._closed and not self._groups:
                    return
                deadline = self._next_deadline()
                if deadline is None:
                    self._cv.wait()
                else:
                    self._cv.wait(timeout=max(deadline - self._clock(),
                                              0.0))
                if self._closed and not self._groups:
                    return
            self.service()

    # ----------------------------------------------------------- shutdown

    def pending(self) -> int:
        with self._cv:
            return sum(len(g) for g in self._groups.values())

    def close(self) -> None:
        """Drain-and-join: flush every pending group (no future is left
        unresolved), stop and join the worker.  Idempotent — the
        ``data.prefetch`` shutdown discipline."""
        with self._cv:
            if self._closed and not self._groups and (
                    self._thread is None or not self._thread.is_alive()):
                return
            self._closed = True
            self._cv.notify_all()
        # Drain in THIS thread (service with an infinite 'now' flushes
        # every group regardless of age); the worker may race us to
        # individual batches — both paths pop under the lock, so each
        # batch dispatches exactly once.
        self.service(now=math.inf)
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:       # interpreter shutdown — nothing to do
            pass
