"""Bounded input pipeline: overlap the reading and staging of the next block
with the compute of the current one.

Counterpart of ``kmeans_tpu/data/prefetch.py`` (``check_prefetch``,
``prefetch_iter``, ``close_source``, ``abort_source``,
``_PrefetchIterator``); the port keeps its own copy.  The streaming surfaces
(``KMeans.fit_stream``, ``GaussianMixture.fit_stream``, the predict,
transform and score streams) consume host blocks one at a time.  Without
prefetch each block's disk read and host-to-device copy runs in series with
the device step that consumes it.  :func:`prefetch_iter` is the one
input-pipeline primitive: a bounded background producer (a thread and a
``queue.Queue(maxsize=prefetch)``) that reads block i+1 from the source and
runs the caller's ``stage`` callback on it (the consumers put their decode
and their copy to the device there: ``parallel.sharding.BlockStager``) while
block i's step computes.

Contract:

* **Order-preserving and semantics-free.**  Items come in source order;
  ``stage`` runs once per item, in that order.  Only where the work happens
  moves (a thread), never what is computed, so a ``prefetch=0`` and a
  ``prefetch>0`` run of the same fit give the same bits.
* **prefetch=0 is the synchronous path**: no thread, no queue; ``stage``
  runs inline.
* **Errors surface at the consumer.**  An exception raised by the source or
  by ``stage`` in the producer thread is raised again by the consumer's
  ``next()`` at the position where the failing item would have come.
* **No leaked threads.**  Closing the iterator early (``close()``,
  ``break``, garbage collection of a partial epoch) signals the producer,
  drains the queue so that a blocked ``put`` wakes, and joins the thread
  before returning.  Every ``put`` polls a stop event, so the producer never
  blocks for ever.

Memory: up to ``prefetch`` staged items wait in the queue and one is in
flight in the producer, so a streamed fit holds at most ``prefetch + 2``
blocks (the one being consumed included).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

from kmeans_tpu_torch.obs import trace as _obs_trace

__all__ = ["prefetch_iter", "check_prefetch", "close_source",
           "abort_source", "stage_beside", "THREAD_NAME"]

#: Name of every producer thread (tests count the live ones).
THREAD_NAME = "kmeans_tpu_torch-prefetch"

# Poll period of the producer's stop-aware puts: short enough that close()
# never waits noticeably, long enough to cost nothing while the queue has
# room.
_PUT_POLL_S = 0.05


def check_prefetch(prefetch) -> int:
    """Validate a ``prefetch`` knob: an int >= 0 (0 = synchronous)."""
    p = int(prefetch)
    if p < 0 or p != prefetch:
        raise ValueError(f"prefetch must be an int >= 0, got {prefetch!r}")
    return p


def prefetch_iter(source: Iterable, prefetch: int,
                  stage: Optional[Callable] = None) -> Iterator:
    """Iterate ``source`` with ``prefetch`` items staged ahead.

    ``stage(item)`` (optional) maps each raw item to what the consumer
    receives; with ``prefetch > 0`` it runs in the producer thread, so put
    the per-item work there (reading, decoding, the copy to the device).
    ``prefetch=0`` applies ``stage`` inline, with no thread."""
    prefetch = check_prefetch(prefetch)
    if prefetch == 0:
        return _sync_iter(source, stage)
    return _PrefetchIterator(source, prefetch, stage)


def stage_beside(item, stage: Callable, work: Callable[[], object]):
    """``stage(item)`` on a producer thread (:func:`prefetch_iter` with one
    item) while this thread runs ``work()``; returns ``stage(item)``.  The
    overlapped set-up of a fit: the upload beside the step functions and
    the kernel library's load.  An error of either side is raised here."""
    it = prefetch_iter([item], 1, stage=stage)
    try:
        work()
        return next(it)
    finally:
        close_source(it)


def close_source(it) -> None:
    """Close a closeable iterator (a generator, or a nested
    :class:`_PrefetchIterator`); a no-op for plain iterators.  An abandoned
    wrapper or a peeked stream must reap its source's thread at once, not at
    some later garbage collection."""
    close = getattr(it, "close", None)
    if close is not None:
        close()


def abort_source(it) -> None:
    """Wake a source blocked in an interruptible wait (a
    ``data.io._ResilientBlockIter`` in its backoff sleep) so that the thread
    driving it can end now; a no-op for sources without ``abort()``.  Safe
    to call from another thread while the source is being iterated (it only
    sets an event); :func:`close_source` is the join-side clean-up."""
    ab = getattr(it, "abort", None)
    if ab is not None:
        ab()


def _sync_iter(source, stage):
    it = iter(source)
    try:
        for item in it:
            yield stage(item) if stage is not None else item
    finally:
        close_source(it)


class _PrefetchIterator:
    """Generator-protocol iterator backed by one producer thread.  A class,
    not a generator function, so that ``close()`` is an explicit,
    idempotent join point and an abandoned iterator's ``__del__`` still
    reaps the thread."""

    def __init__(self, source, prefetch: int, stage):
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._source = iter(source)
        self._thread = threading.Thread(
            target=self._produce, args=(self._source, stage),
            name=THREAD_NAME, daemon=True)
        self._done = False
        self._thread.start()

    # ------------------------------------------------------- producer side

    def _put(self, msg) -> bool:
        """Stop-aware put: never blocks past a close().  False when the
        consumer signalled stop (the message is dropped)."""
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=_PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, it, stage) -> None:
        try:
            for item in it:
                # The producer's share runs under a 'stage' span from this
                # thread, so a timeline shows block i+1's copy beside the
                # consumer's dispatch of block i.
                if stage is not None:
                    with _obs_trace.span("stage", via="prefetch"):
                        staged = stage(item)
                else:
                    staged = item
                if not self._put(("item", staged)):
                    return                      # closed early
                del staged                      # the queue owns it now
            self._put(("done", None))
        except BaseException as e:              # noqa: BLE001 — raised
            self._put(("error", e))             # again at the consumer

    # ------------------------------------------------------- consumer side

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        while True:
            try:
                kind, val = self._q.get(timeout=_PUT_POLL_S)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    # The producer ended without a terminal message and the
                    # queue is drained: stop rather than hang.
                    try:
                        kind, val = self._q.get_nowait()
                        break
                    except queue.Empty:
                        self.close()
                        raise StopIteration from None
        if kind == "item":
            return val
        self.close()
        if kind == "error":
            raise val
        raise StopIteration                     # kind == "done"

    def close(self) -> None:
        """Signal the producer, drain the queue, join the thread.
        Idempotent; called on exhaustion, error, early ``close()`` or
        ``break``, and garbage collection."""
        if self._done:
            return
        self._done = True
        self._stop.set()
        # Wake the source first: a producer inside a retry backoff sleep
        # must give up now, or the join below would wait the schedule out.
        abort_source(self._source)
        # Drain, so that a producer blocked in put() sees the stop event at
        # its next poll.
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join()
        # Nobody runs the source after the join; close it too (nested
        # prefetchers and generators must not linger until collected).
        close_source(self._source)

    def __del__(self):
        try:
            self.close()
        except Exception:       # interpreter shutdown: nothing to do
            pass
