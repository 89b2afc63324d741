"""Device-resident datasets: on one device, or in blocks over a mesh.

Counterpart of ``kmeans_tpu/parallel/sharding.py`` (``ShardedDataset``,
``to_device``, ``from_process_local``, ``choose_chunk_size``,
``clamp_chunk_for_k``, ``backoff_chunk``, ``pad_points``): the points and
their per-row weights are placed on the device once and stay there for the
whole fit.
When the data came from the host, the host copy is kept, which makes row
sampling (Forgy seeding, empty-cluster resampling) a host draw with the same
NumPy generators as the JAX package: the same seed picks the same rows in
both.  Without a host copy the rows are drawn on the device by
:func:`permuted_draws`, the one engine of the host loop and the device loop.
On one device no padding is needed: the torch passes take a short last chunk
and the kernels mask their own ragged edge.

Under a (data, model) mesh (``parallel.mesh``) a :class:`ShardedDataset`
holds, on each rank, its contiguous block of the rows padded to a multiple
of the data axis; pad rows carry weight 0, which every kernel and pass keeps
inert, and the ranks of one data index hold the same block.
:func:`from_process_local` builds one where each rank passes only its own
rows (uneven counts allowed); it has no host copy.
"""

from __future__ import annotations

import copy
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from kmeans_tpu_torch.obs import metrics_registry as _obs_metrics
from kmeans_tpu_torch.obs import trace as _obs_trace
from kmeans_tpu_torch.parallel import mesh as _mesh

#: Below this many (n * k) elements the whole dataset is one chunk.
SINGLE_CHUNK_ELEMS = 1 << 26


def choose_chunk_size(n: int, k: int, d: int,
                      budget_elems: Optional[int] = None) -> int:
    """Rows per chunk of the plain torch pass: the chunk exists only to bound
    the live (chunk, k) distance temporary.  One chunk when n * k is small,
    else about 2^25 tile elements, at most 2^17 rows, a multiple of 8.  An
    explicit ``budget_elems`` (the mixture's ``EM_CHUNK_BUDGET``) replaces
    the 2^25 and opts out of the one-chunk rule, as in the JAX package."""
    if budget_elems is None:
        if n * max(k, 1) <= SINGLE_CHUNK_ELEMS:
            return int(max(128, -(-n // 8) * 8))
        budget_elems = 1 << 25
    chunk = max(128, min(n, budget_elems // max(k, 1), 1 << 17))
    return int(max(8, (chunk // 8) * 8))


def clamp_chunk_for_k(chunk: int, k: int,
                      budget_elems: int = SINGLE_CHUNK_ELEMS,
                      max_chunk: Optional[int] = None) -> int:
    """Bound the (chunk, k) temporary when the real k exceeds the hint a
    dataset's chunk was chosen with: the largest multiple-of-8 divisor of
    ``chunk`` whose (chunk', k) tile fits ``budget_elems`` (and
    ``max_chunk``).  The JAX package's rule, unchanged: a no-op when the
    tile fits, when ``chunk`` is at most 128 rows or not a multiple of 8;
    where no multiple-of-8 divisor lies between 128 and the budget, the
    smallest one of at least 128 rows, with a ``UserWarning``."""
    fits = chunk * max(k, 1) <= budget_elems and \
        (max_chunk is None or chunk <= max_chunk)
    if fits or chunk <= 128 or chunk % 8:
        return chunk
    target = max(8, budget_elems // max(k, 1))
    if max_chunk is not None:
        target = min(target, max(8, max_chunk))
    base = chunk // 8
    best = 1          # largest divisor*8 within target
    small = base      # smallest divisor*8 that is >= 128
    i = 1
    while i * i <= base:
        if base % i == 0:
            for cand in (i, base // i):
                if cand * 8 <= target and cand > best:
                    best = cand
                if cand * 8 >= 128 and cand < small:
                    small = cand
        i += 1
    if best * 8 >= 128:
        return best * 8
    import warnings
    warnings.warn(
        f"clamp_chunk_for_k: the committed chunk {chunk} has no "
        f"multiple-of-8 divisor between 128 and the {target}-row "
        f"budget for k={k}; using {small * 8} rows (budget overshoot) "
        f"instead of degenerate {best * 8}-row scan tiles — reshard the "
        f"dataset or load it with the real k_hint / an explicit "
        f"chunk_size to avoid the oversized tile", UserWarning,
        stacklevel=3)
    return small * 8


#: The smallest chunk :func:`backoff_chunk` goes down to (the floor of
#: :func:`choose_chunk_size`): below it the chunk is no remedy for an
#: out-of-memory error.
MIN_CHUNK = 128


def backoff_chunk(chunk: int, floor: int = MIN_CHUNK) -> Optional[int]:
    """The next chunk after an out-of-memory error: the largest divisor of
    ``chunk`` that is at most ``chunk // 2`` and at least ``floor``, a
    multiple of 8 where one exists (the JAX package's rule, a divisor like
    :func:`clamp_chunk_for_k`'s so that a mesh's blocks, padded to whole
    chunks, need no new padding).  None when no smaller chunk is left."""
    if chunk <= floor:
        return None
    best_grid = best_any = None
    i = 1
    while i * i <= chunk:
        if chunk % i == 0:
            for cand in (i, chunk // i):
                if floor <= cand <= chunk // 2:
                    if cand % 8 == 0 and (best_grid is None
                                          or cand > best_grid):
                        best_grid = cand
                    if best_any is None or cand > best_any:
                        best_any = cand
        i += 1
    return best_grid if best_grid is not None else best_any


def pad_points(x: np.ndarray, multiple: int, min_rows: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Rows of (n, D) padded with zeros to a multiple of ``multiple`` (after
    raising the target to ``min_rows``): ``(padded, 0/1 weights)``, the
    pad rows of weight 0."""
    n = x.shape[0]
    target = max(n, int(min_rows))
    pad = target - n + ((-target) % multiple)
    w = np.ones(n + pad, dtype=x.dtype)
    if pad:
        x = np.concatenate([x, np.zeros((pad, x.shape[1]), dtype=x.dtype)])
        w[n:] = 0.0
    return x, w


#: Boundaries of the fit-shape and candidate-width ladders at
#: {1, 1.25, 1.5, 1.75} x 2^e, and their floors: the JAX package's
#: ``BUCKET_RUNGS``, ``BUCKET_FLOOR`` and ``CANDIDATE_FLOOR``.  A fit with
#: ``bucket='auto'`` pads its rows (weight 0, inert) to the next boundary
#: at or above ``BUCKET_FLOOR``, so nearby dataset sizes share one padded
#: shape and chunk, and therefore one step function of the models'
#: ``_STEP_CACHE``; the padding is at most 25 %.  The two-level step's
#: member lists are (C, L) tables whose width L is the largest cell's size
#: bucketed from ``CANDIDATE_FLOOR``, so that the width changes seldom as
#: cells drift.
BUCKET_RUNGS = (1.0, 1.25, 1.5, 1.75)
BUCKET_FLOOR = 256
CANDIDATE_FLOOR = 32


def _ladder(n: int, floor: int) -> int:
    n = int(n)
    if n <= floor:
        return floor
    e = int(np.floor(np.log2(n / floor)))
    # A float log may land one exponent off at an exact boundary.
    for ee in (e - 1, e, e + 1):
        for r in BUCKET_RUNGS:
            b = int(round(floor * r * (2 ** ee)))
            if b >= n:
                return b
    return int(round(floor * (2 ** (e + 2))))  # pragma: no cover


def bucket_rows(n: int) -> int:
    """The smallest boundary of the fit-shape ladder that is >= ``n`` (the
    JAX package's ``bucket_rows``)."""
    return _ladder(n, BUCKET_FLOOR)


def check_bucket(bucket):
    """The ``bucket`` knob of every family, validated: ``'auto'`` or an int
    >= 0 (0: the exact shape, the bit-exact oracle); the JAX package's
    grammar and messages."""
    if isinstance(bucket, str):
        if bucket != "auto":
            raise ValueError(f"bucket must be 'auto' or an int >= 0, "
                             f"got {bucket!r}")
        return bucket
    if int(bucket) < 0 or int(bucket) != bucket:
        raise ValueError(f"bucket must be 'auto' or an int >= 0, "
                         f"got {bucket!r}")
    return int(bucket)


def bucket_target(bucket, n: int) -> int:
    """The padded row count of a validated ``bucket`` knob: ``n`` at 0, the
    ladder's boundary at ``'auto'``, the next multiple of an explicit
    int."""
    if bucket == "auto":
        return bucket_rows(n)
    if bucket:
        return -(-int(n) // bucket) * bucket
    return int(n)


def bucket_candidates(n: int) -> int:
    """The smallest boundary of the candidate-width ladder that is >= ``n``
    (the JAX package's ``bucket_candidates``)."""
    return _ladder(n, CANDIDATE_FLOOR)


#: How host rows become a rank's device block (the JAX package's
#: ``INGEST_MODES``): 'mono', one host-to-device copy of the padded block;
#: 'slab', the block cut into slabs copied through the pinned ring of
#: :class:`BlockStager`, slab i+1's host copy overlapping slab i's transfer.
#: Both place the same bytes.
INGEST_MODES = ("auto", "mono", "slab")


def check_ingest(ingest) -> str:
    """Validate the ``ingest`` knob: 'auto' | 'mono' | 'slab'."""
    if ingest not in INGEST_MODES:
        raise ValueError(f"ingest must be one of {INGEST_MODES}, "
                         f"got {ingest!r}")
    return ingest


def resolve_ingest(ingest) -> str:
    """``ingest`` with 'auto' resolved: 'mono' on every device.  The JAX
    package sends 'auto' to 'slab' on accelerators by a rule that asks for
    a 1.2x win of slab over mono on a 1 GiB ingest; here 'auto' takes slab
    only once that win is measured on the card (``chip_smoke.py`` phase
    ``ingest`` records the ratio; PERF.md).  Explicit modes pass
    through."""
    return "mono" if check_ingest(ingest) == "auto" else ingest


def place_slabs(read_rows: Callable[[int, int], np.ndarray], lo: int,
                hi: int, block: int, d: int, device, dtype,
                sample_weight: Optional[np.ndarray] = None, *,
                prefetch: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The slab placement: a rank's block of the global rows ``[lo, hi)``,
    zero rows of weight 0 after them up to ``block`` rows, written into one
    device buffer slab by slab.  Returns ``(points, weights, slabs)``.

    The slab holds ``target_bytes`` of rows (``obs.memory.plan_ingest``:
    64 MiB, at most 1/8 of the card's free bytes).  Each slab is read with
    ``read_rows(a, b)`` (global rows), copied into a pinned slot of a
    :class:`BlockStager` ring and from there, on the stager's copy stream,
    into its rows of the buffer; with ``prefetch > 0`` the reads and host
    copies run ``prefetch`` slabs ahead in a background thread
    (``data.prefetch``).  The ring has ``prefetch + 2`` slots, so slab
    i+1's host copy overlaps slab i's transfer, and the host holds a few
    slabs, never the block.  ``sample_weight`` holds the global rows'
    weights (None: 1).  The bytes are those of the one-copy placement
    ('mono'), padding included."""
    from kmeans_tpu_torch.data.prefetch import prefetch_iter
    from kmeans_tpu_torch.obs.memory import plan_ingest
    dtype = np.dtype(dtype)
    tdtype = torch_dtype(dtype)
    device = torch.device(device)
    target = plan_ingest(block, d, dtype=dtype.name,
                         device=device)["target_bytes"]
    rows = max(1, target // max(1, d * dtype.itemsize))
    points = torch.empty((block, d), dtype=tdtype, device=device)
    weights = torch.empty((block,), dtype=tdtype, device=device)
    stager = BlockStager(device, dtype, prefetch)

    def stage(span):
        a, b = span                         # rows of the block
        real = max(0, min(b, hi - lo) - a)
        if real == b - a:
            x = np.asarray(read_rows(lo + a, lo + b), dtype=dtype)
        else:                               # the block's padded tail
            x = np.zeros((b - a, d), dtype=dtype)
            if real:
                x[:real] = read_rows(lo + a, lo + a + real)
        w = np.zeros(b - a, dtype=dtype)
        w[:real] = 1.0 if sample_weight is None else \
            sample_weight[lo + a: lo + a + real]
        return stager.stage(x, w, out=(points[a:b], weights[a:b]),
                            slab=(a // rows, len(spans)))

    spans = [(a, min(a + rows, block)) for a in range(0, block, rows)]
    for staged in prefetch_iter(iter(spans), prefetch, stage):
        stager.take(staged)
    _obs_metrics.REGISTRY.counter("ingest.slabs").inc(len(spans))
    return points, weights, len(spans)


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a NumPy dtype (float32 or float64)."""
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def _validate_sample_weight(sample_weight, n: int, dtype) -> np.ndarray:
    """Shape (n,), finite, non-negative; cast to the dataset dtype."""
    sw = np.asarray(sample_weight, dtype=dtype)
    if sw.shape != (n,):
        raise ValueError(
            f"sample_weight must have shape ({n},), got {sw.shape}")
    if np.any(sw < 0) or not np.all(np.isfinite(sw)):
        raise ValueError("sample_weight must be finite and >= 0")
    return sw


#: Steps of the keyed bijection behind :func:`permuted_draws`; each step
#: XORs one half of the index with a hash of the other half and its key.
PERMUTE_STEPS = 6
#: Passes of cycle walking before a draw is given up.  The walk runs on a
#: domain less than twice the candidates, so a draw still outside after
#: this many passes has probability below 2^-64 (2^-64 for two candidates,
#: (3/4)^64 for one, which :func:`permuted_draws` does not walk).
WALK_LIMIT = 64
_M31 = 0x7FFFFFFF


def draw_keys(seed_seq) -> np.ndarray:
    """The keys of one permutation: ``PERMUTE_STEPS`` words of 31 bits from
    ``np.random.SeedSequence(seed_seq)``, int64."""
    words = np.random.SeedSequence(seed_seq).generate_state(PERMUTE_STEPS)
    return words.astype(np.int64) & _M31


def _hash31(v: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """A 31-bit mix of ``v`` (< 2^31) and ``key``.  Every product is of a
    31-bit value and a 30-bit constant, so int64 never overflows."""
    h = (v ^ key) & _M31
    h = (h * 0x2C1B3C6D) & _M31
    h = h ^ (h >> 15)
    h = (h * 0x297A2D39) & _M31
    return h ^ (h >> 13)


def _permute(x: torch.Tensor, keys: torch.Tensor, lo_bits: int,
             hi_bits: int) -> torch.Tensor:
    """A keyed bijection of ``[0, 2^(lo_bits + hi_bits))``: each step XORs
    one half with a hash of the other, so each step, and the whole, can be
    undone.  ``keys`` (..., PERMUTE_STEPS, 1) broadcasts against ``x``."""
    hi, lo = x >> lo_bits, x & ((1 << lo_bits) - 1)
    for step in range(PERMUTE_STEPS):
        key = keys[..., step, :]
        if step % 2 == 0:
            hi = hi ^ (_hash31(lo, key) & ((1 << hi_bits) - 1))
        else:
            lo = lo ^ (_hash31(hi, key) & ((1 << lo_bits) - 1))
    return (hi << lo_bits) | lo


def permuted_draws(n_pos: int, j: torch.Tensor,
                   keys: torch.Tensor) -> torch.Tensor:
    """Draw ``j`` (int64, any shape) of a keyed pseudo-random permutation of
    ``[0, n_pos)``: distinct values for distinct ``j`` under one key, and
    draw ``j`` does not depend on how many are drawn.  ``keys`` is
    (PERMUTE_STEPS,) for one permutation, or (T, PERMUTE_STEPS) for one
    per row of a (T, m) ``j``.  ``-1`` where ``j >= n_pos`` (the candidates
    are used up) or where the walk did not end (see ``WALK_LIMIT``).

    The bijection runs on ``[0, 2^b)``, ``2^b`` the least power of two not
    below ``n_pos`` (at least 4); a value at or above ``n_pos`` is mapped
    again (cycle walking) until it falls inside, which keeps the map a
    bijection of ``[0, n_pos)``.  Fixed shapes, int64 torch ops only, no
    generator: the same draws on every device.  The walk stops as soon as
    every value is inside, which reads one flag to the host per pass."""
    keys = keys.to(device=j.device, dtype=torch.int64)[..., None]
    live = j < n_pos
    if n_pos == 1:
        return torch.where(live, torch.zeros_like(j), torch.full_like(j, -1))
    bits = max(2, (n_pos - 1).bit_length())
    lo_bits = bits // 2
    hi_bits = bits - lo_bits
    x = _permute(torch.where(live, j, torch.zeros_like(j)), keys, lo_bits,
                 hi_bits)
    for _ in range(WALK_LIMIT - 1):
        outside = x >= n_pos
        if not bool(outside.any()):
            break
        x = torch.where(outside, _permute(x, keys, lo_bits, hi_bits), x)
    return torch.where(live & (x < n_pos), x, torch.full_like(x, -1))


class Dataset:
    """Points (n, D) and weights (n,) on one device, with an optional host
    copy of both (``host_weights`` None means all ones).  A dataset placed
    with ``min_rows`` (a shape bucket, :func:`to_device`) holds more device
    rows than ``n``: the real rows lead, the rest are zeros of weight 0,
    inert in every statistic; the host copy has the real rows only.

    :meth:`memo` keeps what is computed once per dataset and read by every
    fit on it (``sum w ||x||^2``, the positive-weight rows, the device
    loop's captured graphs); the points and weights must not change while
    it holds them."""

    #: No mesh: the one device's points are all the rows (see
    #: :class:`ShardedDataset`).
    mesh = None
    process_local = False

    def __init__(self, points: torch.Tensor, weights: torch.Tensor,
                 host: Optional[np.ndarray] = None,
                 host_weights: Optional[np.ndarray] = None,
                 chunk: Optional[int] = None, explicit_chunk: bool = False,
                 n: Optional[int] = None):
        self.points = points
        self.weights = weights
        self.n, self.d = points.shape
        if n is not None:
            self.n = int(n)
        self._host = host
        self._host_weights = host_weights
        self.chunk = None if chunk is None else int(chunk)
        self.explicit_chunk = explicit_chunk
        self._memo: dict = {}

    def memo(self, key, make: Callable):
        """``make()``, computed at the first call for ``key`` and kept."""
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def forget(self, key) -> None:
        """Drop what :meth:`memo` keeps for ``key`` (nothing if absent)."""
        self._memo.pop(key, None)

    @property
    def device(self) -> torch.device:
        return self.points.device

    def effective_chunk(self, k: int) -> int:
        """The torch passes' chunk for a model of ``k`` clusters (or
        ``k * D`` for 'direct'): the chunk the dataset was placed with
        (``chunk``, chosen by its loader), unless the (chunk, k) tile would
        outgrow the budget (:func:`clamp_chunk_for_k`); an explicit chunk
        passes through.  A dataset placed without one (None: a model's own
        ``cache`` on one device) takes :func:`choose_chunk_size` for ``k``."""
        if self.chunk is None:
            return choose_chunk_size(self.points.shape[0], k, self.d)
        if self.explicit_chunk:
            return self.chunk
        return clamp_chunk_for_k(self.chunk, k)

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(str(self.points.dtype).replace("torch.", ""))

    @property
    def host(self) -> Optional[np.ndarray]:
        """Host copy of the data, when the dataset was built from one."""
        return self._host

    @property
    def host_weights(self) -> Optional[np.ndarray]:
        return self._host_weights

    def positive_index(self) -> torch.Tensor:
        """Indices (int64, on the device) of the rows with weight > 0: the
        candidates of the device draws.  Found once per dataset."""
        return self.memo("positive_index", lambda: torch.nonzero(
            self.weights > 0).flatten())

    def positive_count(self) -> int:
        """Rows with weight > 0, over every rank of a mesh."""
        return int(self.positive_index().numel())

    def gather_positive(self, ordinals: torch.Tensor) -> torch.Tensor:
        """Rows (m, D) on the device of the positive-weight rows numbered
        ``ordinals`` (int64 (m,), in row order; zeros where an ordinal is
        ``-1``).  Nothing is read to the host, so a captured iteration can
        call it."""
        pos = self.positive_index()
        if pos.numel() == 0:
            return torch.zeros((ordinals.shape[0], self.d),
                               dtype=self.points.dtype, device=self.device)
        rows = self.points.index_select(0, pos.index_select(
            0, ordinals.clamp(0, pos.numel() - 1)))
        return torch.where((ordinals >= 0)[:, None], rows,
                           torch.zeros_like(rows))

    def gather_rows(self, values: torch.Tensor) -> np.ndarray:
        """Per-row values of the dataset's device rows (labels,
        log-densities; any trailing shape) for its ``n`` real rows, as a
        host array."""
        return values[: self.n].cpu().numpy()

    def positive_rows(self) -> np.ndarray:
        """Indices of rows with weight > 0: the candidates for seeding and
        for empty-cluster resampling (a zero-weight row must never become a
        centroid)."""
        if self._host is not None:
            if self._host_weights is None:
                return np.arange(self.n)
            return np.flatnonzero(self._host_weights > 0)
        return self.positive_index().cpu().numpy()

    def take(self, idx) -> np.ndarray:
        """Rows by index, as a host array."""
        if self._host is not None:
            return np.asarray(self._host[idx])
        index = torch.as_tensor(np.asarray(idx), device=self.device)
        return self.points[index].cpu().numpy()

    def _weights_like(self, sw: np.ndarray) -> torch.Tensor:
        """The device weights of this dataset's rows for (n,) host weights
        ``sw``: all of them on one device, padding rows at 0."""
        if self.points.shape[0] != self.n:
            block = np.zeros(self.points.shape[0], dtype=sw.dtype)
            block[: self.n] = sw
            sw = block
        return torch.from_numpy(np.ascontiguousarray(sw)).to(self.device)

    def with_weights(self, sample_weight) -> "Dataset":
        """The same device points with other per-row weights (n,), which
        replace the current ones: the JAX package's ``with_weights``.  The
        points are shared, not copied (``BisectingKMeans`` fits each split
        on the whole data with the other rows at weight 0).  The result has
        a memo of its own: what the parent keeps (``sum w ||x||^2``, its
        positive rows, its captured loops) was computed with the parent's
        weights."""
        if self.process_local:
            raise ValueError("with_weights needs a dataset of global rows; "
                             "a process-local dataset holds only its own")
        if isinstance(sample_weight, torch.Tensor):
            sample_weight = sample_weight.detach().cpu().numpy()
        sw = _validate_sample_weight(sample_weight, self.n, self.dtype)
        new = copy.copy(self)
        nbytes = int(self.points.shape[0]) * self.dtype.itemsize
        with _obs_trace.span("stage", rows=int(self.points.shape[0]),
                             bytes=nbytes):
            _obs_metrics.REGISTRY.counter("ingest.bytes").inc(nbytes)
            new.weights = self._weights_like(sw)
        new._host_weights = sw if self._host is not None else None
        new._memo = {}
        return new

    def sample_positive_rows(self, m: int, seed_seq) -> np.ndarray:
        """Up to ``m`` distinct positive-weight rows, uniformly, seeded by
        ``seed_seq`` (entropy for ``np.random.SeedSequence``).

        With a host copy this is the JAX package's host draw, row for row.
        Without one the draws are :func:`permuted_draws` under
        ``draw_keys(seed_seq)``, the engine of the device loop's refill:
        deterministic for a seed, the same rows on both loops, but other
        rows than the JAX package's device-side draw would pick."""
        if self._host is not None:
            rng = np.random.default_rng(seed_seq)
            candidates = self.positive_rows()
            take = min(m, len(candidates))
            idx = candidates[rng.choice(len(candidates), size=take,
                                        replace=False)]
            return self.take(idx)
        n_pos = self.positive_count()
        take = min(m, n_pos)
        if take == 0:
            return np.empty((0, self.d))
        draws = permuted_draws(
            n_pos, torch.arange(take, device=self.device),
            torch.from_numpy(draw_keys(seed_seq)))
        rows = self.gather_positive(draws)[draws >= 0]
        return rows.cpu().numpy().astype(np.float64)


class ShardedDataset(Dataset):
    """This rank's block of a dataset placed over a (data, model) mesh.

    ``points`` and ``weights`` are the rank's block; ``offset`` is the
    global row number of its first row, ``n`` the real rows over all ranks
    and ``local_rows`` the real rows of the block (they lead it; the rest
    is padding of weight 0).  ``host`` is the whole dataset on the host
    when every rank passed it as host data (:func:`to_device`), None when
    it came as a tensor on the device or process by process
    (:func:`from_process_local`, then ``process_local`` is true).
    ``chunk`` is the torch passes' chunk the dataset was placed with
    (``explicit_chunk``: given by the caller), and :meth:`effective_chunk`
    bounds it for a model's real k."""

    def __init__(self, points, weights, mesh, *, n: int, offset: int,
                 local_rows: int, chunk: int, explicit_chunk: bool = False,
                 host=None, host_weights=None, process_local: bool = False):
        super().__init__(points, weights, host=host,
                         host_weights=host_weights, chunk=chunk,
                         explicit_chunk=explicit_chunk)
        self.mesh = mesh
        self.n = int(n)
        self.offset = int(offset)
        self.local_rows = int(local_rows)
        self.process_local = process_local

    def _weights_like(self, sw: np.ndarray) -> torch.Tensor:
        """This rank's block of (n,) host weights, padding rows at 0."""
        block = np.zeros(self.points.shape[0], dtype=sw.dtype)
        block[: self.local_rows] = sw[self.offset: self.offset
                                      + self.local_rows]
        return torch.from_numpy(block).to(self.device)

    def _require_host(self, op: str) -> None:
        if self._host is None:
            raise ValueError(
                f"{op} needs a host copy or a fully-addressable array; on "
                "multi-host process-local datasets use init='kmeans++' "
                "(on-device D2 seeding) or an explicit init array, and "
                "empty_cluster='keep' or 'farthest' (host 'resample' "
                "cannot gather rows)")

    def positive_rows(self) -> np.ndarray:
        self._require_host("positive_rows")
        return super().positive_rows()

    def take(self, idx) -> np.ndarray:
        self._require_host("row gather")
        return super().take(idx)

    def positive_layout(self):
        """``(local positive rows, ordinal of the first, count over the
        mesh)``: the positive-weight rows of all ranks are numbered in
        global row order, those of a block after the blocks of lower data
        index.  Found once per dataset, with one ``all_reduce``."""
        def make():
            pos = self.positive_index()
            d_idx = _mesh.coords(self.mesh)[0]
            counts = torch.zeros(_mesh.mesh_shape(self.mesh)[0],
                                 dtype=torch.int64, device=self.device)
            counts[d_idx] = pos.numel()
            counts = _mesh.all_reduce(counts, self.mesh, (_mesh.DATA_AXIS,))
            counts = counts.cpu().numpy()
            return pos, int(counts[:d_idx].sum()), int(counts.sum())
        return self.memo("positive_layout", make)

    def positive_count(self) -> int:
        return self.positive_layout()[2]

    def gather_positive(self, ordinals: torch.Tensor) -> torch.Tensor:
        """As :meth:`Dataset.gather_positive`, the rows replicated on every
        rank: each rank gathers the rows its block holds, zeros elsewhere,
        and one ``all_reduce`` over the data axis adds them (each row is
        held by one block of the axis)."""
        pos, first, _ = self.positive_layout()
        local = ordinals - first
        mine = (ordinals >= 0) & (local >= 0) & (local < pos.numel())
        if pos.numel() == 0:
            rows = torch.zeros((ordinals.shape[0], self.d),
                               dtype=self.points.dtype, device=self.device)
        else:
            rows = self.points.index_select(0, pos.index_select(
                0, local.clamp(0, pos.numel() - 1)))
            rows = torch.where(mine[:, None], rows, torch.zeros_like(rows))
        return _mesh.all_reduce(rows, self.mesh, (_mesh.DATA_AXIS,))

    def gather_rows(self, values: torch.Tensor) -> np.ndarray:
        """Per-row values of the block (labels, log-densities; any
        trailing shape) for the block's real rows, as a host array: every
        row's on every rank for a dataset of global rows (one SUM
        ``all_reduce`` over the data axis of the blocks, zeros elsewhere),
        the rank's own rows for a process-local one."""
        if self.process_local:
            return values[: self.local_rows].cpu().numpy()
        n_pad = self.points.shape[0] * _mesh.mesh_shape(self.mesh)[0]
        full = torch.zeros((n_pad,) + tuple(values.shape[1:]),
                           dtype=values.dtype, device=values.device)
        full[self.offset: self.offset + values.shape[0]] = values
        return _mesh.all_reduce(full, self.mesh,
                                (_mesh.DATA_AXIS,))[: self.n].cpu().numpy()


def _host_array(X, dtype) -> np.ndarray:
    if isinstance(X, torch.Tensor):
        X = X.detach().cpu().numpy()
    host = np.ascontiguousarray(np.asarray(X, dtype=dtype))
    if host.ndim != 2:
        raise ValueError(f"X must be 2-D (n, D), got shape {host.shape}")
    return host


def _check_dataset(X: Dataset, device, dtype, sample_weight, mesh) -> None:
    if X.mesh is not mesh:
        raise ValueError(f"the dataset was placed with mesh={X.mesh!r}, "
                         f"the model runs on mesh={mesh!r}")
    if X.device != device:
        raise ValueError(f"Dataset is on {X.device}, model on {device}")
    if X.dtype != dtype:
        raise ValueError(f"Dataset dtype {X.dtype} != model dtype {dtype}")
    if sample_weight is not None:
        raise ValueError("pass sample_weight when caching the dataset, "
                         "not on a pre-built Dataset")


def to_device(X, device: torch.device, dtype, sample_weight=None,
              mesh=None, chunk: Optional[int] = None,
              k_hint: int = 16, ingest: str = "auto",
              min_rows: int = 0) -> Dataset:
    """Place (n, D) data on ``device`` once; a :class:`Dataset` passes
    through.  Host data (NumPy, lists) keeps its host copy; a tensor that
    already lies on ``device`` is used as it is and no host copy is made.
    ``sample_weight`` (n,) makes every statistic weighted.

    With a ``mesh`` every rank passes the same global ``X``, as the JAX
    package's ``fit(X)`` does, and the rank's block goes to its device
    (:class:`ShardedDataset`); host data keeps its host copy there too, a
    tensor on ``device`` is sliced where it lies.  ``chunk`` (None: chosen
    for ``k_hint`` clusters) is the chunk of the torch passes it
    records.  ``ingest`` (:func:`resolve_ingest`) picks how a host block
    reaches the device under a mesh, 'mono' or 'slab' (:func:`place_slabs`),
    the same bytes either way; without a mesh, or for a tensor already on
    the device, there is one copy and the mode is ignored, as in the JAX
    package.  ``min_rows`` (a shape bucket, :func:`bucket_target`) pads the
    device rows with zeros of weight 0 to at least that many (under a mesh,
    the global rows before they are split); ``n`` stays the real count and
    the host copy holds the real rows only."""
    mode = resolve_ingest(ingest)
    dtype = np.dtype(dtype)
    if isinstance(X, Dataset):
        _check_dataset(X, device, dtype, sample_weight, mesh)
        return X
    shape = tuple(getattr(X, "shape", ()) or np.shape(X))
    with _obs_trace.span("place", rows=int(shape[0]) if shape else 0,
                         ingest=mode):
        return _place(X, device, dtype, sample_weight, mesh, chunk, k_hint,
                      mode, int(min_rows))


def _place(X, device, dtype, sample_weight, mesh, chunk, k_hint,
           mode, min_rows: int = 0) -> Dataset:
    tdtype = torch_dtype(dtype)
    if mesh is not None:
        on_device = isinstance(X, torch.Tensor) and X.device == device
        return _to_mesh(X.to(tdtype) if on_device else _host_array(X, dtype),
                        device, dtype, sample_weight, mesh, chunk, k_hint,
                        mode, min_rows)
    if isinstance(X, torch.Tensor) and X.device == device:
        host, shape = None, tuple(X.shape)
    else:
        host = _host_array(X, dtype)
        shape = host.shape
    if len(shape) != 2:
        raise ValueError(f"X must be 2-D (n, D), got shape {shape}")
    n = int(shape[0])
    rows = max(n, min_rows)
    nbytes = 0 if host is None else int(host.nbytes)
    with _obs_trace.span("stage", rows=n, bytes=nbytes, ingest="mono"):
        _obs_metrics.REGISTRY.counter("ingest.bytes").inc(nbytes)
        _obs_metrics.REGISTRY.counter("ingest.slabs").inc()
        if rows == n:
            points = (X.to(tdtype).contiguous() if host is None
                      else torch.from_numpy(host).to(device))
        else:
            # The bucket's padding: zero rows after the real ones, one
            # device buffer written in place.
            points = torch.zeros((rows, shape[1]), dtype=tdtype,
                                 device=device)
            points[:n].copy_(X if host is None else torch.from_numpy(host))
    if sample_weight is None:
        sw = None
        weights = torch.ones(rows, dtype=tdtype, device=device)
    else:
        if isinstance(sample_weight, torch.Tensor):
            sample_weight = sample_weight.cpu().numpy()
        sw = _validate_sample_weight(sample_weight, n, dtype)
        weights = torch.from_numpy(sw).to(device)
        if rows != n:
            weights = torch.cat([weights, weights.new_zeros(rows - n)])
    if rows != n:
        weights[n:] = 0
    # Without a host copy, seeding and resampling read the device's weights.
    return Dataset(points, weights, host=host,
                   host_weights=sw if host is not None else None, n=n)


def _to_mesh(X, device, dtype, sample_weight, mesh,
             chunk: Optional[int], k_hint: int,
             ingest: str = "mono", min_rows: int = 0) -> ShardedDataset:
    """The rank's block of the global rows, padded with rows of weight 0
    to a multiple of the data axis (only the last blocks hold padding).
    ``X`` is a host array, kept as the host copy and placed by ``ingest``
    ('mono' or 'slab'), or a tensor already on ``device``, sliced there
    with no host copy (as on one device)."""
    if X.ndim != 2:
        raise ValueError(f"X must be 2-D (n, D), got shape {tuple(X.shape)}")
    n, d = X.shape
    data_shards = _mesh.mesh_shape(mesh)[0]
    d_idx = _mesh.coords(mesh)[0]
    block = -(-max(n, 1, int(min_rows)) // data_shards)
    lo, hi = d_idx * block, max(min((d_idx + 1) * block, n), d_idx * block)
    host = X if isinstance(X, np.ndarray) else None
    sw = None
    if sample_weight is not None:
        if isinstance(sample_weight, torch.Tensor):
            sample_weight = sample_weight.cpu().numpy()
        sw = _validate_sample_weight(sample_weight, n, dtype)
    explicit = chunk is not None
    chunk = chunk or choose_chunk_size(block, k_hint, d)
    if host is not None and ingest == "slab":
        points, weights, _ = place_slabs(
            lambda a, b: host[a:b], lo, hi, block, d, device, dtype, sw)
    else:
        nbytes = block * d * dtype.itemsize if host is not None else 0
        with _obs_trace.span("stage", ingest="mono", rows=block,
                             bytes=nbytes):
            _obs_metrics.REGISTRY.counter("ingest.bytes").inc(nbytes)
            _obs_metrics.REGISTRY.counter("ingest.slabs").inc()
            if host is not None:
                rows, mask = pad_points(host[lo:hi], block, min_rows=block)
                points = torch.from_numpy(
                    np.ascontiguousarray(rows)).to(device)
            else:
                points = torch.zeros((block, d), dtype=X.dtype,
                                     device=device)
                points[: hi - lo] = X[lo:hi]
                mask = np.zeros(block, dtype=dtype)
                mask[: hi - lo] = 1.0
        if sw is not None:
            mask[: hi - lo] = sw[lo:hi]
        weights = torch.from_numpy(mask).to(device)
    return ShardedDataset(
        points, weights, mesh, n=n, offset=lo,
        local_rows=hi - lo, chunk=chunk, explicit_chunk=explicit,
        host=host, host_weights=sw if host is not None else None)


def from_process_local(X_local, mesh, *, device=None, dtype=np.float32,
                       chunk_size: Optional[int] = None, k_hint: int = 16,
                       sample_weight=None) -> ShardedDataset:
    """A dataset over ``mesh`` where each rank passes only its own rows:
    no process ever holds the whole array.  Counts may be uneven; the ranks
    of one data index (the model axis) must pass the same rows.  The
    rows of the block of data index i follow those of lower indices in the
    global order.

    The result has no host copy: Forgy and host resampling raise (use
    ``init='kmeans++'``, which then draws on the devices of the mesh, or
    an explicit init array); ``predict`` and ``labels_`` on it return the
    rank's own rows.  In a world of one rank it is :func:`to_device`, host
    copy kept, as in the JAX package.  ``device`` None is the rank's card."""
    if mesh is None:
        raise ValueError("from_process_local requires a mesh")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    dtype = np.dtype(dtype)
    X_local = np.ascontiguousarray(np.asarray(X_local, dtype=dtype))
    if X_local.ndim != 2:
        raise ValueError(f"X_local must be 2-D (n, D), got {X_local.shape}")
    n_local, d = X_local.shape
    if _mesh.world_size() == 1:
        return to_device(X_local, device, dtype, sample_weight=sample_weight,
                         mesh=mesh, chunk=chunk_size, k_hint=k_hint)
    data_shards = _mesh.mesh_shape(mesh)[0]
    d_idx = _mesh.coords(mesh)[0]
    counts = torch.zeros(data_shards + 2, dtype=torch.int64, device=device)
    counts[d_idx] = n_local
    counts[data_shards], counts[data_shards + 1] = n_local, -n_local
    _mesh.all_reduce(counts[data_shards:], mesh, (_mesh.MODEL_AXIS,), "max")
    if int(counts[data_shards]) != -int(counts[data_shards + 1]):
        raise ValueError("the ranks of one data index must pass the same "
                         "rows to from_process_local")
    counts = _mesh.all_reduce(counts[:data_shards].clone(), mesh,
                              (_mesh.DATA_AXIS,)).cpu().numpy()
    rows, mask = pad_points(X_local, 1, min_rows=1)
    if sample_weight is not None:
        mask[:n_local] = _validate_sample_weight(sample_weight, n_local,
                                                 dtype)
    chunk = chunk_size or choose_chunk_size(int(counts.max()), k_hint, d)
    nbytes = int(rows.nbytes + mask.nbytes)
    with _obs_trace.span("stage", rows=int(rows.shape[0]), bytes=nbytes):
        _obs_metrics.REGISTRY.counter("ingest.bytes").inc(nbytes)
        points = torch.from_numpy(rows).to(device)
        weights = torch.from_numpy(mask).to(device)
    return ShardedDataset(
        points, weights,
        mesh, n=int(counts.sum()), offset=int(counts[:d_idx].sum()),
        local_rows=n_local, chunk=chunk,
        explicit_chunk=chunk_size is not None, process_local=True)


# --------------------------------------------------------- streamed blocks


class StagedBlock(NamedTuple):
    """One block of a stream on its way to the device: this rank's rows
    (``points``), their weights (None: every row at weight 1), the rows of
    the block (all ranks') and the copy's event (None on the CPU)."""
    points: torch.Tensor
    weights: Optional[torch.Tensor]
    rows: int
    event: Optional["torch.cuda.Event"]


class _Slot:
    """One pinned host buffer of the ring and the event of its last copy."""

    def __init__(self):
        self.x: Optional[torch.Tensor] = None
        self.w: Optional[torch.Tensor] = None
        self.event: Optional["torch.cuda.Event"] = None


class BlockStager:
    """Moves the host blocks of a stream to the device, the counterpart of
    the ``shard_points`` call in every ``stage`` callback of the JAX
    package's streams.

    :meth:`stage` is the producer's share (it runs in the prefetch thread
    when ``prefetch > 0``): under a mesh it keeps this rank's contiguous
    share of the block, ``ceil(m / data)`` rows (the last shares padded with
    rows of weight 0), then places it on the device.  :meth:`take` is the
    consumer's share, on the thread and stream that launch the step.

    On a CUDA device one stager serves a whole stream call with a ring of
    ``prefetch + 2`` pinned host slots (each sized to the largest block it
    has carried: allocated at its first use and grown only for a larger
    block), a dedicated copy stream and one CUDA event per slot.  The
    producer waits for the slot's previous copy to complete, copies the
    block into it (``np.copyto`` into the pinned tensor's NumPy view),
    issues the ``non_blocking`` host-to-device copy on the copy stream (the
    current stream is per thread, so it enters ``torch.cuda.stream`` itself)
    and records the slot's event.  The consumer makes its current stream
    wait on that event and marks the device tensors as used by that stream
    (``record_stream``), so that the caching allocator does not hand their
    memory to the next copy while a kernel still reads them.  The ring
    holds one slot more than the blocks that can be in flight, so a slot is
    rewritten only after the consumer has taken the block it carried.  No
    block is pinned afresh.  On the CPU the block is the host array itself
    (``torch.from_numpy``): no stream, no copy."""

    def __init__(self, device, dtype, prefetch: int, mesh=None):
        self.device = torch.device(device)
        self.dtype = np.dtype(dtype)
        self.mesh = mesh
        self._cuda = self.device.type == "cuda"
        self._ring = [_Slot() for _ in range(int(prefetch) + 2)]
        self._next = 0
        self._stream = None

    def share(self, block: np.ndarray, bw: Optional[np.ndarray]):
        """This rank's rows of ``block`` and their weights (None: all 1).
        Without a mesh, the whole block."""
        if self.mesh is None:
            return block, bw
        data_shards = _mesh.mesh_shape(self.mesh)[0]
        d_idx = _mesh.coords(self.mesh)[0]
        m = block.shape[0]
        rows = -(-max(m, 1) // data_shards)
        lo = min(d_idx * rows, m)
        hi = min(lo + rows, m)
        x = block[lo:hi]
        w = None if bw is None else bw[lo:hi]
        if hi - lo < rows:
            x, mask = pad_points(x, 1, min_rows=rows)
            if w is not None:
                mask[: hi - lo] = w
            w = mask
        return x, w

    def stage(self, block: np.ndarray, bw: Optional[np.ndarray] = None,
              out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              slab: Optional[Tuple[int, int]] = None) -> StagedBlock:
        """The producer's share: this rank's rows of the decoded block (in
        the stager's dtype) on their way to the device.  ``out``, a pair of
        device views (rows, weights) of the block's shape, receives the
        copy in place of new tensors (the slab placement,
        :func:`place_slabs`, which passes ``slab`` = (index, count); ``bw``
        is then required).  Under a tracer a ``stage`` span (its rows and
        bytes, and the slab's index and count); the registry counts the
        bytes in ``ingest.bytes`` and each block in ``ingest.slabs`` (a
        placement's slabs are counted by :func:`place_slabs`)."""
        x, w = self.share(block, bw)
        attrs = dict(rows=int(x.shape[0]), bytes=int(x.nbytes))
        if slab is not None:
            attrs.update(slab=int(slab[0]), slabs=int(slab[1]))
        with _obs_trace.span("stage", **attrs):
            _obs_metrics.REGISTRY.counter("ingest.bytes").inc(int(x.nbytes))
            if slab is None:
                _obs_metrics.REGISTRY.counter("ingest.slabs").inc()
            return self._copy(x, w, block, out)

    def _copy(self, x, w, block, out) -> StagedBlock:
        if not self._cuda:
            if out is not None:
                out[0].copy_(_tensor_of(x))
                out[1].copy_(_tensor_of(w))
                return StagedBlock(out[0], out[1], block.shape[0], None)
            return StagedBlock(_tensor_of(x), None if w is None
                               else _tensor_of(w), block.shape[0], None)
        slot = self._ring[self._next]
        self._next = (self._next + 1) % len(self._ring)
        tdtype = torch_dtype(self.dtype)
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            if slot.event is None:
                slot.event = torch.cuda.Event()
            else:
                slot.event.synchronize()     # its last copy has landed
            m = x.shape[0]
            if slot.x is None or slot.x.shape[0] < m:
                slot.x = torch.empty(x.shape, dtype=tdtype, pin_memory=True)
            np.copyto(slot.x[:m].numpy(), x)
            if w is not None:
                if slot.w is None or slot.w.shape[0] < m:
                    slot.w = torch.empty((m,), dtype=tdtype,
                                         pin_memory=True)
                np.copyto(slot.w[:m].numpy(), w)
            if out is not None:
                # The views' memory may have been freed by work still queued
                # on the consumer's stream: the copy waits for it (and the
                # consumer for the copy, in take).
                self._stream.wait_stream(torch.cuda.current_stream(
                    self.device))
            with torch.cuda.stream(self._stream):
                if out is None:
                    points = torch.empty(x.shape, dtype=tdtype,
                                         device=self.device)
                else:
                    points = out[0]
                points.copy_(slot.x[:m], non_blocking=True)
                weights = None
                if w is not None:
                    weights = torch.empty((m,), dtype=tdtype,
                                          device=self.device) \
                        if out is None else out[1]
                    weights.copy_(slot.w[:m], non_blocking=True)
                slot.event.record(self._stream)
        return StagedBlock(points, weights, block.shape[0], slot.event)

    def take(self, staged: StagedBlock) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        """The consumer's share: ``(points, weights)`` ready for a step on
        the current stream."""
        points, weights = staged.points, staged.weights
        if staged.event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(staged.event)
            points.record_stream(current)
            if weights is not None:
                weights.record_stream(current)
        if weights is None:
            weights = torch.ones(points.shape[0], dtype=points.dtype,
                                 device=points.device)
        return points, weights


def _tensor_of(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``a`` (a copy when ``a`` is read-only, such as a
    slice of a memory-mapped file)."""
    return torch.from_numpy(a if a.flags.writeable else a.copy())


# ------------------------------------------------------------ the EM pass

#: Element budget of the (chunk, k) log-density tile of the plain EM pass,
#: and its row cap: the JAX package's ``EM_CHUNK_BUDGET`` and
#: ``EM_MAX_CHUNK`` (``models/gmm.py``).
EM_CHUNK_BUDGET = 1 << 23
EM_MAX_CHUNK = 32768


def choose_em_chunk(n: int, k: int) -> int:
    """Rows per chunk of the plain torch E pass and of the predict pass:
    a (chunk, k) tile of at most ``EM_CHUNK_BUDGET`` elements, at most
    ``EM_MAX_CHUNK`` and at least 128 rows, a multiple of 8."""
    chunk = max(128, min(max(n, 1), EM_CHUNK_BUDGET // max(k, 1),
                         EM_MAX_CHUNK))
    return int(chunk // 8 * 8)


def weighted_mean(points: torch.Tensor, weights: torch.Tensor,
                  mesh=None) -> torch.Tensor:
    """The mixture's centering shift, the JAX package's ``_mean_jit``:
    ``(w @ x) / max(sum w, tiny)`` over the points rounded to float32, in
    the weights' dtype, with the total weight summed in float32.  The guard
    is float32's ``tiny``, not 1.0: clamping at 1.0 would scale the shift
    down whenever the total weight is below 1.  Under a ``mesh`` both sums
    are of every rank's block (SUM ``all_reduce`` over the data axis)."""
    x = points.to(torch.float32).to(weights.dtype)
    total = _mesh.all_reduce(weights.to(torch.float32).sum().reshape(1),
                             mesh, (_mesh.DATA_AXIS,))[0]
    total = torch.clamp_min(total, torch.finfo(torch.float32).tiny)
    return _mesh.all_reduce(weights @ x, mesh, (_mesh.DATA_AXIS,)) / total
