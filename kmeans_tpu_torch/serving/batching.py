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

**A mesh of more than one rank** (:class:`MeshSequencer`).  Each rank of a
mesh is a process, and every rank must issue the same collectives in the
same order: the SPMD contract of the engine, whose callers build the same
engines and submit the same requests on every rank.  What a queue decides
by time or by thread scheduling (which pending requests form the next
batch, and when) would differ between ranks.  So on such a mesh every
collective of the serving path runs on ONE thread per rank, the
sequencer's, in the order rank (0, 0) (the primary) chooses:

* Work that issues collectives is a task with a key that every rank
  computes alike (its kind, its owner's id and the request's content).
  The primary runs its tasks in arrival order and sends each key ahead of
  it (``parallel.mesh.share``); the other ranks run the task with that key,
  waiting for it to arrive locally.  Tasks of equal content have equal keys
  and are taken in their local order: they compute the same thing.
  Inside a task, a decision of the primary (a batch, a route, a guard's
  verdict, a learner's update) reaches the others by one more ``share`` at
  the same point of every rank's sequence.
* The queue's flushes are such tasks: the primary's timer and its
  flush-on-full only ask for a flush, the flush itself takes the primary's
  due batches and sends their requests' keys, and every rank runs those
  batches in that order.  A follower's queue forms no batch of its own and
  starts no timer; ``service`` and ``close`` are tasks too.

Threads other than the sequencer's never issue a collective, so no two
threads of a rank pair their collectives across ranks in different orders.
A world of one rank, and no mesh, have a :class:`LocalSequencer`
(:func:`sequencer_for`): every task runs inline on its caller's thread and
``share`` is the caller's own decision, so the callers take one path with
no thread and no exchange; the queue keeps the behaviour above.
"""

from __future__ import annotations

import collections
import hashlib
import itertools
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from kmeans_tpu_torch.obs import trace as _obs_trace

__all__ = ["MicroBatchQueue", "ServingFuture", "ServingClosedError",
           "DEFAULT_BUCKETS", "THREAD_NAME", "bucket_for",
           "check_buckets", "MeshSequencer", "LocalSequencer",
           "sequencer_for", "SEQUENCE_WAIT_S", "in_order"]

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
    """One queued request: validated rows + its future + enqueue time (and
    its sequence key on a mesh of more than one rank)."""

    __slots__ = ("rows", "m", "future", "t", "key", "model_id_op")

    def __init__(self, rows: np.ndarray, future: ServingFuture, t: float,
                 key: int = 0):
        self.rows = rows
        self.m = int(rows.shape[0])
        self.future = future
        self.t = t
        self.key = key


#: Seconds a follower rank's sequencer waits for a task the primary ran to
#: arrive on its own rank (the ranks did not make the same calls past it).
SEQUENCE_WAIT_S = 120.0

#: Seconds of idleness after which the primary sends an empty header, so
#: the other ranks' pending exchange never reaches its process group's
#: timeout.
SEQUENCE_IDLE_S = 60.0

#: Name of the sequencer thread.
SEQUENCER_THREAD = "kmeans_tpu_torch-serving-sequencer"

_STOP, _TASK, _IDLE = 1, 2, 3


def rows_digest(*parts, rows=None) -> bytes:
    """A digest of ``parts`` (their ``repr``) and the bytes, shape and type
    of ``rows``: the content part of a sequence key."""
    h = hashlib.blake2b(repr(parts).encode(), digest_size=16)
    if rows is not None:
        a = np.ascontiguousarray(rows)
        h.update(repr((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    return h.digest()


def in_order(seq, fn: Callable, *parts, rows=None):
    """``fn()``, as the sequencer's task keyed by ``parts`` and ``rows``:
    inline on its own thread, and always with a :class:`LocalSequencer`."""
    if seq.on_thread():
        return fn()
    return seq.run(seq.key(*parts, rows=rows), fn)


class LocalSequencer:
    """The sequencer of a world of one rank, or of no mesh: this process is
    the primary, every task runs inline on its caller's thread and
    ``share(decide)`` is ``decide()``; no thread, no exchange."""

    primary = True
    ranked = False
    digest = ""

    def __init__(self):
        self._ids = itertools.count()

    def new_id(self) -> int:
        return next(self._ids)

    def on_thread(self) -> bool:
        return True

    def run(self, key: int, fn: Callable):
        return fn()

    def share(self, decide: Callable) -> list:
        return list(decide())

    def stop(self) -> None:
        pass


def sequencer_for(mesh):
    """A :class:`MeshSequencer` on a mesh of more than one rank, else a
    :class:`LocalSequencer` (``mesh`` None too)."""
    from kmeans_tpu_torch.parallel.mesh import mesh_shape
    if mesh is None:
        return LocalSequencer()
    data, model = mesh_shape(mesh)
    return MeshSequencer(mesh) if data * model > 1 else LocalSequencer()


class _Task:
    __slots__ = ("key", "fn", "future")

    def __init__(self, key: int, fn: Callable, future):
        self.key = key
        self.fn = fn
        self.future = future


class MeshSequencer:
    """The one thread of a rank that runs the serving path's collectives,
    in rank (0, 0)'s order (the module docstring).

    ``run(key, fn)`` runs ``fn`` as the task ``key`` and returns its result
    (inline when called on the sequencer's thread); ``post`` queues it and
    returns a :class:`ServingFuture`.  ``handler(key, fn)`` registers a task
    the primary starts by itself (``kick(key)``), which the other ranks run
    from the key alone.  Inside a task, ``share(decide)`` gives every rank
    the primary's ``decide()`` (a list of ints).  ``key(*parts, rows=)``
    makes a key from content: two equal requests swap places between ranks
    at most, which changes nothing they compute.  ``digest`` covers every
    task key run and every value shared, in order: two ranks that followed
    the same sequence show the same digest.  ``stop`` gives the
    sequencer's group back for the next one."""

    ranked = True

    def __init__(self, mesh):
        from kmeans_tpu_torch.parallel.mesh import decision_group, is_primary
        self.mesh = mesh
        self.primary = is_primary(mesh)
        # The headers and decisions travel on a gloo group of their own:
        # a follower waiting for the next header holds none of the mesh's
        # groups.
        self._group = decision_group(mesh)
        self._cv = threading.Condition()
        self._ready: collections.deque = collections.deque()
        self._local: Dict[int, collections.deque] = {}
        self._handlers: Dict[int, Callable] = {}
        self._ids = itertools.count()
        self._stopping = False
        self._stopped_cleanly = False
        self._log = hashlib.blake2b(digest_size=8)
        self.tasks = 0
        self._thread = threading.Thread(target=self._run,
                                        name=SEQUENCER_THREAD, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- keys

    def new_id(self) -> int:
        """An id for an owner of tasks (an engine, a queue, a fleet): owners
        are made in the same order on every rank."""
        return next(self._ids)

    @staticmethod
    def key(*parts, rows=None) -> int:
        """The key of a task with this content (nonzero, 63 bits)."""
        h = rows_digest(*parts, rows=rows)[:8]
        return (int.from_bytes(h, "little") >> 1) or 1

    @property
    def digest(self) -> str:
        with self._cv:
            return self._log.hexdigest()

    def _note(self, values) -> None:
        with self._cv:
            self._log.update(repr(list(values)).encode())

    # ------------------------------------------------------------ tasks

    def on_thread(self) -> bool:
        return threading.current_thread() is self._thread

    def post(self, key: int, fn: Callable) -> ServingFuture:
        fut = ServingFuture()
        with self._cv:
            if self._stopping:
                fut._set_error(ServingClosedError("serving is closed"))
                return fut
            task = _Task(key, fn, fut)
            if self.primary:
                self._ready.append(task)
            else:
                self._local.setdefault(key, collections.deque()).append(
                    task)
            self._cv.notify_all()
        return fut

    def run(self, key: int, fn: Callable):
        if self.on_thread():
            return fn()
        return self.post(key, fn).result()

    def handler(self, key: int, fn: Callable) -> None:
        with self._cv:
            self._handlers[key] = fn

    def kick(self, key: int) -> None:
        """The primary starts the registered task ``key``; elsewhere
        nothing (the primary's header brings it)."""
        if self.primary:
            with self._cv:
                if not self._stopping:
                    self._ready.append(_Task(key, self._handlers[key], None))
                    self._cv.notify_all()

    def share(self, decide: Callable) -> list:
        """The primary's ``decide()`` on every rank (on the sequencer's
        thread, inside a task)."""
        from kmeans_tpu_torch.parallel.mesh import share
        values = share(decide() if self.primary else None, self.mesh,
                       self._group)
        self._note(values)
        return values

    def notify(self) -> None:
        """Wake a follower's sequencer waiting for a local arrival."""
        with self._cv:
            self._cv.notify_all()

    def wait_for(self, ready: Callable[[], bool], what: str) -> None:
        """A follower's wait, on the sequencer's thread, until ``ready()``
        (read under this sequencer's lock, which ``notify`` wakes)."""
        deadline = time.monotonic() + SEQUENCE_WAIT_S
        with self._cv:
            while not ready():
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f"{what} did not arrive on this rank within "
                        f"{SEQUENCE_WAIT_S} s of the primary running it: "
                        f"every rank must make the same serving calls")
                self._cv.wait(min(left, 1.0))

    # ------------------------------------------------------------- loop

    def _next_primary(self):
        with self._cv:
            while not self._ready:
                if self._stopping:
                    return None
                if not self._cv.wait(SEQUENCE_IDLE_S) and not self._ready:
                    return "idle"
            return self._ready.popleft()

    def _run(self) -> None:
        from kmeans_tpu_torch.parallel.mesh import share
        while True:
            try:
                if self.primary:
                    task = self._next_primary()
                    head = [_STOP, 0] if task is None else \
                        [_IDLE, 0] if task == "idle" else [_TASK, task.key]
                    share(head, self.mesh, self._group)
                else:
                    head = share(None, self.mesh, self._group)
                    task = None
                if head[0] == _STOP:
                    self._stopped_cleanly = True
                    self._drop(ServingClosedError("serving is closed"))
                    return
                if head[0] == _IDLE:
                    continue
                self._note(head)
                if task is None:
                    task = self._take(head[1])
            except BaseException as e:     # noqa: BLE001 — the sequence
                # is broken: fail what waits, and stop.
                self._drop(e)
                return
            self.tasks += 1
            try:
                out = task.fn()
            except BaseException as e:     # noqa: BLE001 — the task's
                if task.future is None:
                    # A task the primary started by itself (a flush)
                    # failed: the ranks' sequences may have parted.
                    self._drop(e)
                    return
                task.future._set_error(e)
                continue
            if task.future is not None:
                task.future._set_result(out)

    def _take(self, key: int) -> _Task:
        with self._cv:
            fn = self._handlers.get(key)
        if fn is not None:
            return _Task(key, fn, None)
        self.wait_for(lambda: bool(self._local.get(key)), f"task {key}")
        with self._cv:
            task = self._local[key].popleft()
            if not self._local[key]:
                del self._local[key]
            return task

    def _drop(self, err: BaseException) -> None:
        """Fail every task still waiting, and take no more."""
        with self._cv:
            self._stopping = True
            pending = list(self._ready) + [t for q in self._local.values()
                                           for t in q]
            self._ready.clear()
            self._local.clear()
        for task in pending:
            if task.future is not None:
                task.future._set_error(err)

    def stop(self) -> None:
        """After the tasks queued so far: the primary sends the stop, every
        rank's thread ends (joined here), and a group whose sequence ended
        with that stop goes back to ``parallel.mesh.release_group`` for the
        next sequencer on the mesh.  Idempotent."""
        from kmeans_tpu_torch.parallel.mesh import release_group
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self.on_thread():
            return
        self._thread.join()
        with self._cv:
            group, self._group = self._group, None
        if group is not None and self._stopped_cleanly:
            release_group(self.mesh, group)


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
    sequencer : :class:`MeshSequencer`, :class:`LocalSequencer` or None
        On a mesh of more than one rank, the rank's sequencer: batches are
        the primary's (the module docstring), and only the primary runs a
        timer (``start``).  A local sequencer, or None, changes nothing.
    """

    def __init__(self, dispatch: Callable, *,
                 buckets=DEFAULT_BUCKETS, max_wait_ms: float = 2.0,
                 clock: Optional[Callable[[], float]] = None,
                 start: bool = True, validate: Optional[Callable] = None,
                 sequencer: Optional[MeshSequencer] = None):
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
        # A LocalSequencer runs the queue as if it had none.
        if sequencer is not None and not sequencer.ranked:
            sequencer = None
        self._seq = sequencer
        self._flush_asked = False
        if sequencer is not None:
            self._uid = sequencer.new_id()
            self._flush_key = sequencer.key("flush", self._uid)
            sequencer.handler(self._flush_key, self._flush_in_order)
            start = start and sequencer.primary
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._run if sequencer is None else self._run_primary,
                name=THREAD_NAME, daemon=True)
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
        seq = self._seq
        if seq is not None:
            return self._submit_keyed(seq, model_id, op, block, fut)
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

    def _submit_keyed(self, seq: MeshSequencer, model_id, op: str,
                      block: np.ndarray, fut: ServingFuture
                      ) -> ServingFuture:
        """``submit`` on a mesh of more than one rank: the request waits
        under its key for the primary's flush; a full group asks the
        primary's sequencer for one."""
        key = seq.key("q", self._uid, model_id, op, rows=block)
        ask = False
        with self._cv:
            if self._closed:
                fut._set_error(ServingClosedError(
                    "serving queue is closed"))
                return fut
            group = self._groups.setdefault((model_id, op), [])
            group.append(_Pending(block, fut, self._clock(), key))
            self.requests += 1
            if seq.primary and not self._flush_asked \
                    and sum(p.m for p in group) >= self._buckets[-1]:
                self._flush_asked = ask = True
            self._cv.notify()
        if ask:
            seq.kick(self._flush_key)
        seq.notify()
        return fut

    def _due_batches(self, now: float) -> List[Tuple[tuple, list]]:
        """Pop every batch that is due at ``now`` or full (caller holds the
        lock)."""
        batches = []
        for key in list(self._groups):
            group = self._groups[key]
            while group and (
                    group[0].t + self._max_wait <= now
                    or sum(p.m for p in group) >= self._buckets[-1]):
                batches.append((key, self._take_batch(group)))
            if not group:
                del self._groups[key]
        return batches

    def _flush_in_order(self, now: Optional[float] = None) -> int:
        """A flush on a mesh of more than one rank (a task of the
        sequencer, on every rank): the primary takes its due batches and
        shares their requests' keys; every rank runs those batches, in that
        order, each rank's own requests under those keys."""
        seq = self._seq
        mine: List[Tuple[tuple, list]] = []

        def decide():
            t = self._clock() if now is None else now
            with self._cv:
                self._flush_asked = False
                mine.extend(self._due_batches(t))
                self._cv.notify_all()         # the timer may ask again
            out = [len(mine)]
            for _, batch in mine:
                out.append(len(batch))
                out.extend(p.key for p in batch)
            return out

        values = seq.share(decide)
        batches = mine if seq.primary else self._take_keyed(values)
        for key, batch in batches:
            self._run_batch(key, batch)
        return len(batches)

    def _take_keyed(self, values: list) -> List[Tuple[tuple, list]]:
        """A follower's batches from the primary's keys: each request taken
        from its group once it has arrived."""
        out, i = [], 1
        for _ in range(values[0]):
            n = values[i]
            keys = values[i + 1:i + 1 + n]
            i += 1 + n
            self._seq.wait_for(lambda: self._holds(keys),
                               f"a queued request of batch {keys}")
            with self._cv:
                batch = [self._pop_key(k) for k in keys]
            out.append(((batch[0].model_id_op), batch))
        return out

    def _holds(self, keys) -> bool:
        """Whether every request of the batch has arrived: as many pending
        requests of each key as the batch names (equal requests have equal
        keys)."""
        with self._cv:
            have = collections.Counter(p.key for g in self._groups.values()
                                       for p in g)
        return not collections.Counter(keys) - have

    def _pop_key(self, key: int) -> "_Pending":
        """Take the pending request ``key`` out of its group (caller holds
        the lock); its group key rides on it as ``model_id_op``."""
        for gkey, group in list(self._groups.items()):
            for j, p in enumerate(group):
                if p.key == key:
                    del group[j]
                    if not group:
                        del self._groups[gkey]
                    p.model_id_op = gkey
                    return p
        raise KeyError(key)

    def _run_primary(self) -> None:
        """The primary's timer on a mesh: asks its sequencer for a flush
        when a group is due, once until that flush has taken its batches."""
        while True:
            with self._cv:
                if self._closed:
                    return
                deadline = None if self._flush_asked \
                    else self._next_deadline()
                if deadline is None:
                    self._cv.wait()
                    continue
                left = deadline - self._clock()
                if left > 0:
                    self._cv.wait(left)
                    continue
                self._flush_asked = True
            self._seq.kick(self._flush_key)

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
        if self._seq is not None:
            return in_order(self._seq, lambda: self._flush_in_order(now),
                            "service", self._uid)
        if now is None:
            now = self._clock()
        with self._cv:
            batches = self._due_batches(now)
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
        ``data.prefetch`` shutdown discipline.  On a mesh of more than one
        rank the drain is a task of the sequencer (the primary's batches),
        and a request still pending after it fails with
        :class:`ServingClosedError`."""
        if self._seq is not None:
            with self._cv:
                if self._closed:
                    return
            in_order(self._seq, self._close_in_order, "close", self._uid)
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            return
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

    def _close_in_order(self) -> None:
        self._flush_in_order(now=math.inf)
        with self._cv:
            self._closed = True
            left = [p for g in self._groups.values() for p in g]
            self._groups.clear()
            self._cv.notify_all()
        for p in left:
            p.future._set_error(ServingClosedError(
                "serving queue is closed"))

    def __del__(self):
        if getattr(self, "_seq", None) is not None:
            return                # closed by its engine, in sequence
        try:
            self.close()
        except Exception:       # interpreter shutdown — nothing to do
            pass
