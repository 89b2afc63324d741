"""Out-of-core input: block streams with retries, and datasets read from
memory-mapped files.

Counterpart of ``kmeans_tpu/data/io.py`` (``IOStats``, ``check_io_knobs``,
``retry_call``, ``resilient_blocks``, ``_ReadaheadReader``,
``iter_npy_blocks``, ``from_npy``, ``from_raw``).

* **Retries.**  Any ``OSError`` counts as transient (``utils.faults.
  TransientIOError`` is the subclass the tests raise).  Retries are bounded
  and the backoff schedule is deterministic (``io_backoff * 2**(attempt -
  1)`` seconds), so a retried fit gives the bits of one that was not: a
  retry only reads again, it never reorders or drops data.
* **Block streams.**  :func:`resilient_blocks` wraps a ``make_blocks``
  factory (a fresh, deterministic iterable per call, the streaming
  surfaces' contract): a failed ``next()`` is retried by calling the
  factory again and skipping the blocks already delivered; every block is
  scanned for non-finite values (``on_nonfinite='error'`` names it,
  ``'skip'`` drops and counts it).
* **Files.**  :func:`from_npy` and :func:`from_raw` map the file.
  Without a mesh the whole file is read into one host array and goes to
  one device (``parallel.sharding.to_device``), as in the JAX package; the
  dataset records the chunk its loader chose.  Under a mesh each rank reads
  only its own contiguous block of rows, ``ceil(n / data)`` of them (the
  block layout of ``parallel.sharding``), in slices through a read-ahead
  thread ('mono') or slab by slab through the pinned ring of
  ``BlockStager`` ('slab', ``parallel.sharding.place_slabs``), and the
  mapped file stays the dataset's host copy, so seeded row draws (Forgy,
  'resample') read only the rows they pick.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from kmeans_tpu_torch.data.prefetch import (check_prefetch, close_source,
                                            prefetch_iter)
from kmeans_tpu_torch.obs import metrics_registry as _obs_metrics
from kmeans_tpu_torch.obs import trace as _obs_trace
from kmeans_tpu_torch.parallel import mesh as _mesh
from kmeans_tpu_torch.parallel.sharding import (ShardedDataset,
                                                _validate_sample_weight,
                                                check_ingest,
                                                choose_chunk_size,
                                                place_slabs, resolve_ingest,
                                                to_device)


class IOStats:
    """Per-fit IO fault counters (``io_retries_used_`` and
    ``blocks_skipped_``).  ``blocks_skipped`` is the count of the last
    complete pass over the stream (the bad blocks of a deterministic
    source); ``blocks_skipped_total`` adds up every pass."""

    def __init__(self):
        self.retries_used = 0
        self.blocks_skipped = 0
        self.blocks_skipped_total = 0


def check_io_knobs(io_retries, io_backoff) -> Tuple[int, float]:
    """Validate the retry knobs: retries an int >= 0, backoff a float >= 0
    seconds (0 retries at once, as deterministic tests do)."""
    r = int(io_retries)
    if r < 0 or r != io_retries:
        raise ValueError(f"io_retries must be an int >= 0, got "
                         f"{io_retries!r}")
    b = float(io_backoff)
    if not (b >= 0.0):
        raise ValueError(f"io_backoff must be >= 0 seconds, got "
                         f"{io_backoff!r}")
    return r, b


def _interruptible_sleep(delay: float,
                         abort: Optional[threading.Event]) -> bool:
    """Sleep ``delay`` seconds; with an ``abort`` event, wake early and
    return True when it fires (the caller then gives the retry up)."""
    if delay <= 0:
        return bool(abort is not None and abort.is_set())
    if abort is None:
        time.sleep(delay)
        return False
    return abort.wait(delay)


def retry_call(fn: Callable, *, retries: int, backoff: float,
               stats: Optional[IOStats] = None,
               abort: Optional[threading.Event] = None,
               what: str = "read"):
    """``fn()``, its transient (``OSError``) failures retried up to
    ``retries`` times with the deterministic exponential backoff.  The last
    failure, and any other error, propagates unchanged."""
    attempt = 0
    while True:
        try:
            return fn()
        except OSError:
            if attempt >= retries:
                raise
            attempt += 1
            if stats is not None:
                stats.retries_used += 1
            _obs_metrics.REGISTRY.counter("io.retries").inc()
            if _interruptible_sleep(backoff * (2.0 ** (attempt - 1)),
                                    abort):
                raise


def _retrying_reader(read_rows: Callable, retries: int, backoff: float,
                     stats: IOStats) -> Callable:
    """A ``read_rows(lo, hi)`` callback under the retry policy: a slice of a
    mapped file reads the same bytes again, so a retry is a plain read."""
    def read(lo: int, hi: int) -> np.ndarray:
        return retry_call(lambda: read_rows(lo, hi), retries=retries,
                          backoff=backoff, stats=stats,
                          what=f"rows [{lo}, {hi})")
    return read


class _ResilientBlockIter:
    """One pass over a ``make_blocks`` stream with transient-error retry and
    the non-finite quarantine.

    A failed ``next()`` calls the factory again and skips the blocks already
    delivered (a generator that raised is dead); failures while skipping
    take attempts from the same bounded budget.  Every block (and its
    weights, for ``(block, weights)`` items) is scanned for non-finite
    values: ``on_nonfinite='error'`` raises naming the block's position,
    ``'skip'`` drops the block and counts it.  The scan runs in the producer
    thread under prefetch.  ``abort()`` (``prefetch._PrefetchIterator.
    close``) wakes a pending backoff sleep."""

    def __init__(self, make_blocks: Callable[[], Iterable], retries: int,
                 backoff: float, on_nonfinite: str,
                 stats: Optional[IOStats]):
        self._make = make_blocks
        self._retries = retries
        self._backoff = backoff
        self._on_nonfinite = on_nonfinite
        self._stats = stats
        self._abort = threading.Event()
        self._it = iter(make_blocks())
        self._pos = 0                    # raw blocks delivered this pass
        self._skipped = 0

    def __iter__(self):
        return self

    def _next_raw(self):
        attempt = 0
        fast_forward = 0
        while True:
            try:
                for _ in range(fast_forward):
                    next(self._it)
                fast_forward = 0
                item = next(self._it)
                self._pos += 1
                return item
            except StopIteration:
                raise
            except OSError as e:
                if attempt >= self._retries:
                    raise
                attempt += 1
                if self._stats is not None:
                    self._stats.retries_used += 1
                _obs_metrics.REGISTRY.counter("io.retries").inc()
                if _interruptible_sleep(
                        self._backoff * (2.0 ** (attempt - 1)),
                        self._abort):
                    raise e
                close_source(self._it)
                self._it = iter(self._make())
                fast_forward = self._pos

    def __next__(self):
        while True:
            try:
                # One block read, its retries included.
                with _obs_trace.span("io.block", index=self._pos):
                    item = self._next_raw()
            except StopIteration:
                if self._stats is not None:
                    self._stats.blocks_skipped = self._skipped
                raise
            block = item[0] if isinstance(item, tuple) else item
            bad = not np.all(np.isfinite(np.asarray(block)))
            if not bad and isinstance(item, tuple) \
                    and item[1] is not None:
                bad = not np.all(np.isfinite(np.asarray(item[1])))
            if not bad:
                return item
            if self._on_nonfinite == "error":
                raise ValueError(
                    f"non-finite values in streamed block "
                    f"{self._pos - 1}; pass on_nonfinite='skip' to "
                    f"quarantine bad blocks (counted in "
                    f"blocks_skipped_)")
            self._skipped += 1
            if self._stats is not None:
                self._stats.blocks_skipped_total += 1
            _obs_metrics.REGISTRY.counter("io.blocks_skipped").inc()

    def abort(self) -> None:
        self._abort.set()

    def close(self) -> None:
        close_source(self._it)


_NONFINITE_POLICIES = ("error", "skip")



def resilient_blocks(make_blocks: Callable[[], Iterable], *,
                     io_retries: int = 0, io_backoff: float = 0.05,
                     on_nonfinite: str = "error",
                     stats: Optional[IOStats] = None
                     ) -> Callable[[], Iterable]:
    """A ``make_blocks`` factory under the transient-retry and non-finite
    quarantine policy (:class:`_ResilientBlockIter`).  Every streamed fit
    routes its source through it, so every pass (init, scatter, epochs,
    scoring) sees the same cleaned stream."""
    if on_nonfinite not in _NONFINITE_POLICIES:
        raise ValueError(f"on_nonfinite must be one of "
                         f"{_NONFINITE_POLICIES}, got {on_nonfinite!r}")
    io_retries, io_backoff = check_io_knobs(io_retries, io_backoff)

    def make():
        return _ResilientBlockIter(make_blocks, io_retries, io_backoff,
                                   on_nonfinite, stats)
    return make


class _ReadaheadReader:
    """Read-ahead for a ``read_rows(lo, hi)`` callback: after every read the
    next ``depth`` contiguous ranges of the same size below ``end`` are read
    in one background thread, so the read of slice i+1 overlaps the copy of
    slice i.  A range asked for out of order is a miss, read at once (the
    pending ones are dropped); the bytes are the same either way.  Memory:
    up to ``depth`` more slices on the host."""

    def __init__(self, read_rows, end: int, depth: int):
        import concurrent.futures
        self._read = read_rows
        self._end = end
        self._depth = depth
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="kmeans_tpu_torch-readahead")
        self._pending: dict = {}       # (lo, hi) -> Future

    def __call__(self, lo: int, hi: int) -> np.ndarray:
        fut = self._pending.pop((lo, hi), None)
        if fut is None and self._pending:
            for stale in self._pending.values():
                stale.cancel()
            self._pending.clear()
        out = fut.result() if fut is not None else self._read(lo, hi)
        self._schedule(hi, hi - lo)
        return out

    def _schedule(self, start: int, size: int) -> None:
        for _ in range(self._depth):
            lo, hi = start, min(start + size, self._end)
            if hi <= lo or len(self._pending) >= self._depth:
                break
            if (lo, hi) not in self._pending:
                self._pending[(lo, hi)] = self._pool.submit(
                    self._read, lo, hi)
            start = hi

    def close(self) -> None:
        """Drop what is pending and end the thread."""
        for fut in self._pending.values():
            fut.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=True)


def _from_source(read_rows, n: int, d: int, mesh, *, device, dtype,
                 chunk_size: Optional[int], k_hint: int,
                 budget_elems: Optional[int], sample_weight,
                 host_handle, prefetch: int, io_retries: int,
                 io_backoff: float, ingest: str = "mono") -> ShardedDataset:
    """This rank's block of rows [d_idx * b, (d_idx + 1) * b) of the source,
    ``b = ceil(n / data)``, padded with rows of weight 0 to ``b`` rows; the
    ranks of one data index read the same rows.  'mono' reads the block in
    slices of the dataset's chunk through the read-ahead reader (which
    never reads past the block) into one host array and copies it to the
    device once; 'slab' reads and copies it slab by slab
    (``parallel.sharding.place_slabs``, its producer thread reading
    ``prefetch`` slabs ahead).  ``io_stats`` on the result counts the
    retries; ``slabs`` the host-to-device copies of the rows."""
    dtype = np.dtype(dtype)
    io_retries, io_backoff = check_io_knobs(io_retries, io_backoff)
    prefetch = check_prefetch(prefetch)
    io_stats = IOStats()
    data_shards, model_shards = _mesh.mesh_shape(mesh)
    d_idx = _mesh.coords(mesh)[0]
    block = -(-max(n, 1) // data_shards)
    lo, hi = min(d_idx * block, n), min((d_idx + 1) * block, n)
    sw = None if sample_weight is None else _validate_sample_weight(
        sample_weight, n, dtype)
    chunk = chunk_size or choose_chunk_size(
        block, max(k_hint, model_shards), d, budget_elems=budget_elems)
    if io_retries:
        # Retry inside the read-ahead wrapper, so that its thread's reads
        # recover too.
        read_rows = _retrying_reader(read_rows, io_retries, io_backoff,
                                     io_stats)
    if ingest == "slab":
        points, weights, slabs = place_slabs(
            read_rows, lo, hi, block, d, device, dtype, sw,
            prefetch=prefetch)
    else:
        reader = _ReadaheadReader(read_rows, hi, prefetch) if prefetch \
            else None
        rows = np.zeros((block, d), dtype=dtype)
        try:
            for s in range(lo, hi, chunk):
                e = min(s + chunk, hi)
                rows[s - lo: e - lo] = (reader or read_rows)(s, e)
        finally:
            if reader is not None:
                reader.close()
        mask = np.zeros(block, dtype=dtype)
        mask[: hi - lo] = 1.0 if sw is None else sw[lo:hi]
        # The one copy of 'mono', on the ingest timeline as the slabs are.
        with _obs_trace.span("stage", rows=block, bytes=int(rows.nbytes),
                             ingest="mono"):
            _obs_metrics.REGISTRY.counter("ingest.bytes").inc(
                int(rows.nbytes))
            _obs_metrics.REGISTRY.counter("ingest.slabs").inc()
            points = torch.from_numpy(rows).to(device)
            weights = torch.from_numpy(mask).to(device)
        slabs = 1
    ds = ShardedDataset(
        points, weights, mesh, n=n, offset=lo, local_rows=hi - lo,
        chunk=chunk, explicit_chunk=chunk_size is not None,
        host=host_handle, host_weights=sw)
    ds.io_stats = io_stats
    ds.slabs = slabs
    return ds


def _load(mm, mesh, *, device, chunk_size, dtype, k_hint, budget_elems,
          sample_weight, prefetch, io_retries, io_backoff, ingest):
    from kmeans_tpu_torch.models.kmeans import resolve_device
    mode = resolve_ingest(check_ingest(ingest))
    device = resolve_device(device)
    n, d = mm.shape
    if mesh is None:
        # The JAX package's one-device branch: the whole file in one host
        # array and one copy (the mode and the read-ahead do not apply),
        # the chunk chosen for k_hint unless given.
        ds = to_device(np.array(mm, dtype=dtype), device, dtype,
                       sample_weight=sample_weight)
        ds.chunk = chunk_size or choose_chunk_size(n, k_hint, d)
        ds.explicit_chunk = chunk_size is not None
        ds.io_stats = IOStats()
        return ds

    def read_rows(lo: int, hi: int) -> np.ndarray:
        return np.asarray(mm[lo:hi], dtype=dtype)

    return _from_source(read_rows, n, d, mesh, device=device, dtype=dtype,
                        chunk_size=chunk_size, k_hint=k_hint,
                        budget_elems=budget_elems,
                        sample_weight=sample_weight, host_handle=mm,
                        prefetch=prefetch, io_retries=io_retries,
                        io_backoff=io_backoff, ingest=mode)


def from_npy(path, mesh=None, *, device=None,
             chunk_size: Optional[int] = None, dtype=np.float32,
             k_hint: int = 16, budget_elems: Optional[int] = None,
             sample_weight: Optional[np.ndarray] = None,
             prefetch: int = 2, io_retries: int = 0,
             io_backoff: float = 0.05, ingest: str = "auto"):
    """A dataset from a 2-D ``.npy`` file.

    ``mesh=None`` reads the whole file into one host array and places it
    on one device (``device``: None is the card, as in every entry point of
    the package), as the JAX package does; the dataset carries the chunk
    ``chunk_size or choose_chunk_size(n, k_hint, D)`` (``explicit_chunk``
    when given), which a fit takes.  Under a mesh the file is never loaded
    whole: each rank reads only its own block of rows (a
    ``ShardedDataset`` whose host copy is the mapped file), and
    ``budget_elems`` sets the element budget of the chunk's tile (pass
    ``sharding.EM_CHUNK_BUDGET`` for a mixture).  There ``prefetch``
    slices are read ahead in a background thread (0: no thread),
    ``io_retries`` / ``io_backoff`` retry transient slice reads with the
    deterministic backoff, counted in the result's
    ``io_stats.retries_used``, and ``ingest`` picks the placement:
    'mono' (also 'auto', ``sharding.resolve_ingest``) or 'slab'
    (``sharding.place_slabs``), the same bytes either way."""
    mm = np.load(path, mmap_mode="r")
    if mm.ndim != 2:
        raise ValueError(f"expected a 2-D array in {path}, got shape "
                         f"{mm.shape}")
    return _load(mm, mesh, device=device, chunk_size=chunk_size,
                 dtype=dtype, k_hint=k_hint, budget_elems=budget_elems,
                 sample_weight=sample_weight, prefetch=prefetch,
                 io_retries=io_retries, io_backoff=io_backoff,
                 ingest=ingest)


def from_raw(path, shape: Tuple[int, int], mesh=None, *, device=None,
             file_dtype=np.float32, chunk_size: Optional[int] = None,
             dtype=np.float32, k_hint: int = 16,
             budget_elems: Optional[int] = None, offset: int = 0,
             sample_weight: Optional[np.ndarray] = None,
             prefetch: int = 2, io_retries: int = 0,
             io_backoff: float = 0.05, ingest: str = "auto"):
    """A dataset from a headerless binary file of ``shape`` row-major
    ``file_dtype`` values starting at byte ``offset``, as
    :func:`from_npy`."""
    n, d = shape
    mm = np.memmap(path, dtype=file_dtype, mode="r", offset=offset,
                   shape=(n, d))
    return _load(mm, mesh, device=device, chunk_size=chunk_size,
                 dtype=dtype, k_hint=k_hint, budget_elems=budget_elems,
                 sample_weight=sample_weight, prefetch=prefetch,
                 io_retries=io_retries, io_backoff=io_backoff,
                 ingest=ingest)


def iter_npy_blocks(path, block_rows: int, *, dtype=None,
                    prefetch: int = 0, io_retries: int = 0,
                    io_backoff: float = 0.05):
    """A ``make_blocks`` factory for the streams: each call yields the
    consecutive (<= ``block_rows``, D) slices of a 2-D ``.npy`` file through
    a memory map, so the file may exceed both device and host memory.

    ``prefetch`` (default 0) reads that many blocks ahead in a background
    thread (``data.prefetch.prefetch_iter``), for a consumption loop of the
    caller's own; the model streams already read ahead themselves, and
    stacking both doubles the blocks held.  ``io_retries`` / ``io_backoff``
    retry each block's read, counted in the factory's ``io_stats``.

    Usage::

        km.fit_stream(iter_npy_blocks("big.npy", 1_000_000))
    """
    if block_rows <= 0:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    prefetch = check_prefetch(prefetch)
    io_retries, io_backoff = check_io_knobs(io_retries, io_backoff)
    io_stats = IOStats()

    def iter_blocks():
        arr = np.load(path, mmap_mode="r")
        if arr.ndim != 2:
            raise ValueError(f"{path} must contain a 2-D array, "
                             f"got shape {arr.shape}")
        for start in range(0, arr.shape[0], block_rows):
            with _obs_trace.span("io.block", offset=start,
                                 rows=min(block_rows,
                                          arr.shape[0] - start)):
                block = retry_call(
                    lambda: np.asarray(arr[start: start + block_rows]),
                    retries=io_retries, backoff=io_backoff,
                    stats=io_stats,
                    what=f"block rows [{start}, {start + block_rows})")
            yield block if dtype is None else block.astype(dtype)

    def make_blocks():
        return prefetch_iter(iter_blocks(), prefetch)

    make_blocks.io_stats = io_stats
    return make_blocks
