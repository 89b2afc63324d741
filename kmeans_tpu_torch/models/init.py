"""Centroid initialisation: Forgy, k-means++ and k-means||.

Counterpart of ``kmeans_tpu/models/init.py`` (``forgy_init``,
``kmeanspp_init``, ``_weighted_kmeanspp_host``, ``kmeans_parallel_init``
with its pipeline and host engine, ``resolve_init``).  Forgy's and
k-means++'s random draws happen on the host with the same NumPy generators
as the JAX package (``np.random.RandomState(seed)`` for Forgy,
``np.random.default_rng(seed)`` for k-means++), so the same seed gives the
same initial centroids in both packages whenever the data has a host copy.
On data too large for the host (or without a host copy) k-means++ keeps its
distances on the device and draws there too
(:func:`_weighted_kmeanspp_device`), from the same host uniforms, so it picks
the same rows.  Over a mesh (a ``parallel.sharding.ShardedDataset``) whose
host copy is absent or too large, the draws run on the devices of the mesh
(:func:`_kmeanspp_sharded_draws`), the same rows as one device would draw.
Every version keeps its ``mind2`` by one helper, :func:`update_mind2`,
which works in fixed blocks of rows and never makes an (n, D) temporary.
k-means|| (:func:`kmeans_parallel_init`) runs on the dataset's device with
a seeded ``torch.Generator``: its folds and its mass pass go through
kernel 2 (2b) in the kernel modes.  The streamed inits of ``fit_stream``
(``STREAM_INITIALIZERS``) draw over a whole block stream: Forgy by seeded
reservoirs (the JAX package's rows), k-means|| by passes whose distances
are kernel 2 per block (:func:`streamed_kmeans_parallel_init`).

All entry points accept a host ``(n, D)`` array or a
``parallel.sharding.Dataset`` (row access through ``.take``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kmeans_tpu_torch.obs import trace as _obs_trace
from kmeans_tpu_torch.parallel import mesh as _mesh
from kmeans_tpu_torch.parallel.sharding import (BlockStager,
                                                _validate_sample_weight,
                                                torch_dtype)
from kmeans_tpu_torch.utils.cache import LRUCache, cached_build
from kmeans_tpu_torch.utils.validation import check_finite_array


class _ArraySource:
    """Gives a host ndarray the Dataset's row-access interface.  Optional
    ``weights`` make ``positive_rows`` honour per-row sample weights."""

    def __init__(self, X: np.ndarray, weights: Optional[np.ndarray] = None):
        self._X = np.asarray(X)
        self.n, self.d = self._X.shape
        self.dtype = self._X.dtype
        self._w = None if weights is None else np.asarray(weights)

    def take(self, idx):
        return self._X[idx]

    def positive_rows(self):
        if self._w is None:
            return np.arange(self.n)
        return np.flatnonzero(self._w > 0)

    @property
    def host(self):
        return self._X

    @property
    def host_weights(self):
        return self._w


def as_source(X, weights=None):
    if hasattr(X, "take") and hasattr(X, "n"):
        return X
    return _ArraySource(X, weights)


def forgy_init(X, k: int, seed: int, *, validate: bool = True) -> np.ndarray:
    """Seeded sample of k distinct rows, uniform over the positive-weight
    rows (a zero-weight row would start an empty cluster)."""
    src = as_source(X)
    if getattr(src, "host", None) is None and hasattr(src, "points"):
        # No host copy: the same draw numbers the positive rows on the
        # device (over every rank of a mesh); data loaded process by
        # process has no global row space to draw from, as in the JAX
        # package.
        if src.process_local:
            src.positive_rows()             # raises the pointed error
        n_pos = src.positive_count()
        if n_pos < k:
            raise ValueError(f"Not enough data points ({n_pos}) to "
                             f"initialize {k} clusters")
        pick = np.random.RandomState(seed).choice(n_pos, size=k,
                                                  replace=False)
        centroids = src.gather_positive(torch.from_numpy(pick).to(
            src.device)).cpu().numpy()
        if validate:
            check_finite_array(centroids, "Data contains NaN or Inf values")
        return centroids
    candidates = src.positive_rows()
    if len(candidates) < k:
        raise ValueError(
            f"Not enough data points ({len(candidates)}) to initialize "
            f"{k} clusters")
    rng = np.random.RandomState(seed)
    idx = candidates[rng.choice(len(candidates), size=k, replace=False)]
    centroids = np.asarray(src.take(idx))
    if validate:
        check_finite_array(centroids, "Data contains NaN or Inf values")
    return centroids


#: Host arrays up to this many elements keep the D^2 distance maintenance in
#: float64 NumPy; larger ones run it on the dataset's device.
_HOST_KMEANSPP_ELEMS = 1 << 22

#: Rows of each block of :func:`update_mind2`: its largest temporary is
#: (MIND2_BLOCK_ROWS, D), 128 MiB at D = 128 in float32.
MIND2_BLOCK_ROWS = 1 << 18


def update_mind2(mind2: torch.Tensor, points: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """``mind2 <- min(mind2, ||points - c||^2)`` in place, and returned.

    The rows go in blocks of ``MIND2_BLOCK_ROWS``, each a difference
    squared in place and summed by row (the per-row arithmetic of the
    whole-array form it replaced, so the same rows are drawn), and no
    (n, D) temporary is made.  Every block has the same shape (the last is
    the last ``MIND2_BLOCK_ROWS`` rows, overlapping the one before it; a
    second minimum with the same centre changes nothing), so a row gets the
    same arithmetic at every n: the per-draw host version, the device draws
    and each rank of a mesh agree row for row."""
    n = points.shape[0]
    rows = min(n, MIND2_BLOCK_ROWS)
    for lo in range(0, n, max(rows, 1)):
        lo = min(lo, n - rows)
        diff = points[lo:lo + rows] - c[None, :]
        seg = mind2[lo:lo + rows]
        torch.minimum(seg, diff.mul_(diff).sum(dim=1), out=seg)
    return mind2


def _weighted_kmeanspp_host(X: np.ndarray, w: np.ndarray, k: int,
                            rng: np.random.Generator,
                            points: Optional[torch.Tensor] = None
                            ) -> np.ndarray:
    """Weighted D^2 seeding with host-side draws: the centres of
    :func:`_kmeanspp_host_draws`."""
    idx = _kmeanspp_host_draws(X, w, k, rng, points)
    if X is not None:
        return np.asarray(X[idx])
    return points.index_select(
        0, torch.from_numpy(idx).to(points.device)).cpu().numpy()


def _kmeanspp_host_draws(X: Optional[np.ndarray], w: np.ndarray, k: int,
                         rng: np.random.Generator,
                         points: Optional[torch.Tensor] = None
                         ) -> np.ndarray:
    """Weighted D^2 seeding; the categorical draws are host-side.

    ``X`` is the host array, or None when only the device tensor ``points``
    exists.  The distance maintenance runs in float64 NumPy for small host
    arrays and in torch on ``points`` otherwise; each draw then pulls the
    (n,) distance vector to the host.  Returns the k row indices.
    ``kmeanspp_init`` runs it on small host arrays; on ``points`` it is
    the plain version of :func:`_kmeanspp_device_draws`."""
    n = w.shape[0]
    if int((w > 0).sum()) < k:
        raise ValueError(
            f"Not enough data points ({int((w > 0).sum())}) to initialize "
            f"{k} clusters")
    on_host = X is not None and (points is None
                                 or X.size <= _HOST_KMEANSPP_ELEMS)

    def row(i):
        return X[i] if X is not None else points[int(i)].cpu().numpy()

    idx = np.empty(k, dtype=np.int64)
    idx[0] = rng.choice(n, p=w / w.sum())           # first draw ~ weights
    if on_host:
        x = X.astype(np.float64, copy=False)
        mind2 = np.full((n,), np.inf)
    else:
        mind2 = torch.full((n,), float("inf"), dtype=points.dtype,
                           device=points.device)
    for i in range(1, k):
        if on_host:
            diff = x - row(idx[i - 1]).astype(np.float64)
            mind2 = np.minimum(mind2, (diff * diff).sum(axis=1))
            p = w * np.maximum(mind2, 0.0)
        else:
            update_mind2(mind2, points, torch.as_tensor(
                row(idx[i - 1]), device=points.device))
            p = w * np.maximum(mind2.cpu().numpy().astype(np.float64), 0.0)
        total = p.sum()
        if not np.isfinite(total) or total <= 0:
            idx[i] = rng.choice(n, p=w / w.sum())  # degenerate: coincident
        else:
            idx[i] = rng.choice(n, p=p / total)
    return idx


def _cdf(p: torch.Tensor) -> torch.Tensor:
    """``numpy.random.Generator.choice``'s CDF of the masses ``p``: ``p``
    over its total, its cumulative sum, over that sum's last entry."""
    cdf = torch.cumsum(p / p.sum(), 0)
    return cdf / cdf[-1]


def _weighted_kmeanspp_device(points: torch.Tensor, weights: torch.Tensor,
                              k: int, rng: np.random.Generator
                              ) -> np.ndarray:
    """Weighted D^2 seeding with the draws on the device: the centres of
    :func:`_kmeanspp_device_draws`, copied to the host once."""
    return points.index_select(
        0, _kmeanspp_device_draws(points, weights, k, rng)).cpu().numpy()


def _kmeanspp_device_draws(points: torch.Tensor, weights: torch.Tensor,
                           k: int, rng: np.random.Generator) -> torch.Tensor:
    """The k row indices (int64, on the device) of weighted D^2 seeding
    with the draws on the device: the same rows as
    :func:`_kmeanspp_host_draws` on the same ``points``, without its
    per-draw copy of the (n,) distances to the host.

    ``Generator.choice(n, p=p)`` takes one ``random()`` and returns
    ``searchsorted(cdf, u, side='right')``, so all k uniforms are taken
    from ``rng`` first (the host version takes one per draw, in the same
    order) and each draw inverts the float64 CDF of ``w * max(mind2, 0)``
    on the device (:func:`_cdf`).  The degenerate branch (a total that is
    not finite or not positive: coincident points) draws by the weights,
    chosen by ``torch.where``; both branches take their one uniform.  The
    distances are maintained as in the host version, so the two differ
    only where a uniform falls within rounding of a CDF step (the device's
    parallel sum and scan against NumPy's).  The centres are gathered on
    the device; nothing is read to the host inside the loop."""
    n = points.shape[0]
    w = weights.to(torch.float64)
    positive = int((w > 0).sum())
    if positive < k:
        raise ValueError(f"Not enough data points ({positive}) to "
                         f"initialize {k} clusters")
    u = torch.from_numpy(rng.random(k)).to(points.device)
    cdf_w = _cdf(w)
    last = torch.tensor(n - 1, device=points.device)
    idx = torch.empty(k, dtype=torch.int64, device=points.device)
    idx[0] = torch.searchsorted(cdf_w, u[0:1], right=True)[0]
    mind2 = torch.full((n,), float("inf"), dtype=points.dtype,
                       device=points.device)
    for i in range(1, k):
        update_mind2(mind2, points, points.index_select(0, idx[i - 1:i])[0])
        p = w * torch.clamp_min(mind2.to(torch.float64), 0.0)
        total = p.sum()
        usable = torch.isfinite(total) & (total > 0)
        by_d2 = torch.searchsorted(_cdf(p), u[i:i + 1], right=True)[0]
        by_w = torch.searchsorted(cdf_w, u[i:i + 1], right=True)[0]
        # A non-finite CDF may search past the end; that draw is not taken.
        idx[i] = torch.where(usable, torch.minimum(by_d2, last), by_w)
    return idx


def _segment_draw(p: torch.Tensor, u: torch.Tensor, mesh):
    """Invert the CDF of the masses ``p`` of every rank's block at ``u``
    (one float64 tensor of shape (1,)): ``(owner, local row, usable)``.

    The blocks' totals, one per data index, come back by one SUM
    ``all_reduce``; the data index whose segment of their normalised
    cumulative sum holds ``u`` (``searchsorted``, right side, as one
    device's draw) owns the draw, and its block's own CDF (:func:`_cdf`)
    at ``u`` rescaled into the segment gives the row.  ``usable`` is false
    where the total is not finite or not positive.  Nothing is read to the
    host."""
    data_shards = _mesh.mesh_shape(mesh)[0]
    d_idx = _mesh.coords(mesh)[0]
    totals = torch.zeros(data_shards, dtype=torch.float64, device=p.device)
    totals[d_idx] = p.sum()
    totals = _mesh.all_reduce(totals, mesh, (_mesh.DATA_AXIS,))
    total = totals.sum()
    usable = torch.isfinite(total) & (total > 0)
    bounds = torch.cumsum(totals / total, 0)
    bounds = bounds / bounds[-1]
    owner = torch.searchsorted(bounds, u, right=True).clamp_max(
        data_shards - 1)
    lo = torch.where(owner > 0, bounds.index_select(
        0, (owner - 1).clamp_min(0)), torch.zeros_like(u))
    width = bounds.index_select(0, owner) - lo
    local_u = (u - lo) / torch.where(width > 0, width, torch.ones_like(u))
    row = torch.searchsorted(_cdf(p), local_u, right=True).clamp_max(
        p.shape[0] - 1)
    return owner[0], row[0], usable


def _kmeanspp_sharded_draws(ds, k: int, rng: np.random.Generator
                            ) -> torch.Tensor:
    """The k centres (k, D), on the device of every rank, of weighted D^2
    seeding over a mesh (``ds`` a ``ShardedDataset``): the draws of
    :func:`_kmeanspp_device_draws` over the mesh's rows.

    The k uniforms come from ``rng`` in the same order.  Each rank keeps the
    ``mind2`` of its block by :func:`update_mind2`, the arithmetic of one
    device; each draw inverts the CDF block by block (:func:`_segment_draw`)
    and the owning rank contributes the row, which one SUM ``all_reduce``
    over the data axis brings to every rank.  The blockwise CDF rounds
    otherwise than the one-pass CDF of one device, so a uniform within
    rounding of a CDF step may pick the neighbouring row; elsewhere the
    rows are the same."""
    mesh, points = ds.mesh, ds.points
    dev = points.device
    w = ds.weights.to(torch.float64)
    positive = ds.positive_count()
    if positive < k:
        raise ValueError(f"Not enough data points ({positive}) to "
                         f"initialize {k} clusters")
    d_idx = _mesh.coords(mesh)[0]
    u = torch.from_numpy(rng.random(k)).to(dev)
    by_w = _segment_draw(w, u[0:1], mesh)

    def take(owner, row) -> torch.Tensor:
        c = points.index_select(0, row.reshape(1))[0]
        c = torch.where(owner == d_idx, c, torch.zeros_like(c))
        return _mesh.all_reduce(c, mesh, (_mesh.DATA_AXIS,))

    centers = torch.empty((k, ds.d), dtype=points.dtype, device=dev)
    centers[0] = take(by_w[0], by_w[1])
    mind2 = torch.full((points.shape[0],), float("inf"), dtype=points.dtype,
                       device=dev)
    for i in range(1, k):
        update_mind2(mind2, points, centers[i - 1])
        p = w * torch.clamp_min(mind2.to(torch.float64), 0.0)
        owner, row, usable = _segment_draw(p, u[i:i + 1], mesh)
        owner_w, row_w, _ = _segment_draw(w, u[i:i + 1], mesh)
        centers[i] = take(torch.where(usable, owner, owner_w),
                          torch.where(usable, row, row_w))
    return centers


def kmeanspp_init(X, k: int, seed: int, *, validate: bool = True
                  ) -> np.ndarray:
    """k-means++ seeding (D^2 weighting, scaled by the sample weights).

    ``validate=False`` skips the full-array finite scan, for callers that
    already validated the data."""
    src = as_source(X)
    host = getattr(src, "host", None)
    points = getattr(src, "points", None)
    mesh = getattr(src, "mesh", None)
    if host is not None:
        sw = getattr(src, "host_weights", None)
        w = (np.ones(host.shape[0]) if sw is None
             else np.asarray(sw, dtype=np.float64))
        # Full scan, not just the chosen rows: a NaN anywhere poisons the
        # D^2 weights.
        if validate:
            check_finite_array(host, "Data contains NaN or Inf values")
    elif validate:
        finite = torch.isfinite(points).all().to(torch.int32).reshape(1)
        if not int(_mesh.all_reduce(finite, mesh, (_mesh.DATA_AXIS,),
                                    "min")):
            raise ValueError("Data contains NaN or Inf values")
    rng = np.random.default_rng(seed)
    device_draws = points is not None and (
        host is None or host.size > _HOST_KMEANSPP_ELEMS)
    if device_draws and mesh is not None:
        return _kmeanspp_sharded_draws(src, k, rng).cpu().numpy()
    if device_draws:
        return _weighted_kmeanspp_device(points, src.weights, k, rng)
    return _weighted_kmeanspp_host(host, w, k, rng,
                                   points=None if mesh else points)


# ---------------------------------------------------------------- k-means||

#: Coordinates of the unused slots of the k-means|| candidate buffer: far
#: beyond any real row and finite in float32 after squaring (the JAX
#: package's ``_CAND_SENTINEL``), so a sentinel slot never wins a minimum
#: and earns no cell mass, and every pass over the buffer runs unmasked.
_CAND_SENTINEL = 1e12

#: The modes whose folds and mass pass run the assignment kernel (kernel 2,
#: or 2b in 'kernel_bf16').
_KERNEL_MODES = ("kernel", "kernel_bf16")


def _tile_rows(n: int, width: int) -> int:
    """Rows of a (rows, width) distance tile of the torch passes: about
    2^23 elements (the JAX package's fold and mass chunks)."""
    return int(min(n, max(128, (1 << 23) // max(width, 64) // 8 * 8)))


def _assign(points: torch.Tensor, cands: torch.Tensor, mode: str,
            need_min: bool):
    """Labels (int64) and minimum squared distances of the rows against
    the candidates: kernel 2 (2b) in the kernel modes, else the chunked
    'matmul' pass (float32 products, ``ops.assign.pairwise_sq_dists``)."""
    from kmeans_tpu_torch.ops.assign import pairwise_sq_dists
    from kmeans_tpu_torch.ops.hopper_kernels import hopper_assign
    if mode in _KERNEL_MODES:
        labels, mind2 = hopper_assign(points.to(torch.float32),
                                      cands.to(torch.float32),
                                      bf16=mode == "kernel_bf16")
        return labels.to(torch.int64), mind2
    n = points.shape[0]
    rows = _tile_rows(n, cands.shape[0])
    labels = torch.empty(n, dtype=torch.int64, device=points.device)
    mind2 = torch.empty(n, dtype=torch.promote_types(points.dtype,
                                                     torch.float32),
                        device=points.device) if need_min else None
    for lo in range(0, n, rows):
        d2 = pairwise_sq_dists(points[lo:lo + rows], cands, mode="matmul")
        labels[lo:lo + rows] = torch.argmin(d2, dim=1)
        if need_min:
            mind2[lo:lo + rows] = d2.min(dim=1).values
    return labels, mind2


def fold_candidates(points: torch.Tensor, mind2: torch.Tensor,
                    cands: torch.Tensor, *, mode: str = "matmul"
                    ) -> torch.Tensor:
    """``mind2 <- min(mind2, d^2(points, cands))``, in place and returned:
    one distance pass over the rows for all the candidates (the JAX
    package's ``_fold_candidates``).  Sentinel rows lose every minimum, so
    the buffer needs no mask.  The kernel modes read kernel 2's (2b's)
    ``mind2``; the torch modes the float32 'matmul' tile."""
    _, m = _assign(points, cands, mode, need_min=True)
    torch.minimum(mind2, m.to(mind2.dtype), out=mind2)
    return mind2


def segment_sum(labels: torch.Tensor, w: torch.Tensor, m: int
                ) -> torch.Tensor:
    """``sum of w`` per label 0..m-1, float64, in an order that does not
    depend on the device's scheduling: the rows sorted by label (a stable
    sort), one cumulative sum, differences at the label boundaries.  (An
    ``index_add_`` on the card adds in the order its atomics land.)"""
    order = torch.argsort(labels, stable=True)
    sorted_labels = labels.index_select(0, order)
    cs = torch.cumsum(w.to(torch.float64).index_select(0, order), 0)
    cs = torch.cat([cs.new_zeros(1), cs])
    ids = torch.arange(m, device=labels.device, dtype=sorted_labels.dtype)
    lo = torch.searchsorted(sorted_labels, ids)
    hi = torch.searchsorted(sorted_labels, ids, right=True)
    return cs.index_select(0, hi) - cs.index_select(0, lo)


def cell_mass(points: torch.Tensor, weights: torch.Tensor,
              cands: torch.Tensor, *, mode: str = "matmul", mesh=None
              ) -> torch.Tensor:
    """The weighted count of rows nearest each candidate (float64 (m,)),
    summed over the data axis of ``mesh``: one assignment pass (kernel 2 or
    2b in the kernel modes) and :func:`segment_sum`."""
    labels, _ = _assign(points, cands, mode, need_min=False)
    mass = segment_sum(labels, weights, cands.shape[0])
    if mesh is not None:
        mass = _mesh.all_reduce(mass, mesh, (_mesh.DATA_AXIS,))
    return mass


def gumbel(shape, gen: torch.Generator, dtype, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` from ``gen``."""
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def kmeanspp_gumbel(points: torch.Tensor, weights: torch.Tensor, k: int,
                    noise: torch.Tensor) -> torch.Tensor:
    """Weighted D^2 seeding by Gumbel-max draws (the JAX package's
    ``_kmeanspp_body``): draw i is ``argmax(log p + noise[i])`` with ``p``
    the weights for the first draw and ``w * mind2`` after it; where every
    mass is 0 (coincident points) a draw falls back to the weights.
    ``noise`` (k, n) holds the draws' Gumbel noise, so the centres (k, D)
    follow from the draws given.  Runs on ``points``' device; nothing is
    read to the host."""
    n, d = points.shape
    neg_inf = torch.full((), float("-inf"), dtype=points.dtype,
                         device=points.device)
    w_logits = torch.where(weights > 0,
                           torch.log(torch.clamp_min(weights, 1e-38)),
                           neg_inf)

    def draw(logits, g):
        logits = torch.where(torch.isfinite(logits).any(), logits, w_logits)
        return torch.argmax(logits + g).reshape(1)

    centers = torch.zeros((k, d), dtype=points.dtype, device=points.device)
    centers[0] = points.index_select(0, draw(w_logits, noise[0]))[0]
    mind2 = torch.full((n,), float("inf"), dtype=points.dtype,
                       device=points.device)
    for i in range(1, k):
        diff = points - centers[i - 1][None, :]
        mind2 = torch.minimum(mind2, (diff * diff).sum(dim=1))
        p = weights * mind2
        logits = torch.where(p > 0, torch.log(p), neg_inf)
        centers[i] = points.index_select(0, draw(logits, noise[i]))[0]
    return centers


def refine_centers(cands: torch.Tensor, mass: torch.Tensor,
                   centers: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` weighted Lloyd steps on the candidate table (the JAX
    pipeline's ``refine``): each candidate to its nearest centre by the
    'matmul' tile, one-hot sums weighted by ``mass``, a centre without
    mass kept."""
    from kmeans_tpu_torch.ops.assign import _accum_dtype, pairwise_sq_dists
    acc = _accum_dtype(cands.dtype)
    x = cands.to(acc)
    ids = torch.arange(centers.shape[0], device=cands.device)
    m = mass.to(acc)
    for _ in range(steps):
        best = torch.argmin(pairwise_sq_dists(x, centers.to(acc)), dim=1)
        oh = (best[:, None] == ids[None, :]).to(acc) * m[:, None]
        sums = oh.T @ x
        counts = oh.sum(dim=0)
        centers = torch.where(
            (counts > 0)[:, None],
            (sums / torch.clamp_min(counts, 1.0)[:, None]).to(centers.dtype),
            centers)
    return centers


def _per_row(src, n_local: int):
    """A function that takes a draw made for every global row (a tensor of
    ``src.n`` entries) to this block's rows, 0 on its padding rows: the
    draws of a row are then the same whatever the number of ranks or the
    bucket's padding, and a mesh seeds as one device does."""
    if getattr(src, "mesh", None) is None:
        pad = n_local - int(src.n)
        if pad <= 0:
            return lambda t: t
        return lambda t: torch.cat([t, t.new_zeros(pad)])
    first, real = int(src.offset), int(src.local_rows)

    def take(t):
        mine = t[first:first + real]
        if real == n_local:
            return mine
        return torch.cat([mine, mine.new_zeros(n_local - real)])
    return take


def _row_of_max(score: torch.Tensor, points: torch.Tensor, mesh):
    """The row (D,) of the largest ``score`` over every rank, replicated:
    the local first maximum, the largest over the data axis (MAX), the
    lowest data index holding it (MIN), its row (SUM, zeros elsewhere)."""
    j = torch.argmax(score).reshape(1)
    row = points.index_select(0, j)[0]
    if mesh is None:
        return row
    best = score.index_select(0, j)
    top = _mesh.all_reduce(best.clone(), mesh, (_mesh.DATA_AXIS,), "max")
    d_idx, shards = _mesh.coords(mesh)[0], _mesh.mesh_shape(mesh)[0]
    cand = torch.where(best == top, torch.full_like(j, d_idx),
                       torch.full_like(j, shards))
    win = _mesh.all_reduce(cand, mesh, (_mesh.DATA_AXIS,), "min")
    return _mesh.all_reduce(torch.where(win == d_idx, row,
                                        torch.zeros_like(row)),
                            mesh, (_mesh.DATA_AXIS,))


def _top_candidates(score, points, cap: int, mesh):
    """The ``cap`` largest scores over every rank and their rows (the JAX
    package's per-shard ``top_k`` then exact cross-shard combine, with the
    combine a SUM of zero-embedded blocks: every global top-cap entry is in
    its own rank's top-cap)."""
    vals, idx = torch.topk(score, cap)
    rows = points.index_select(0, idx)
    if mesh is None:
        return vals, rows
    d_idx, shards = _mesh.coords(mesh)[0], _mesh.mesh_shape(mesh)[0]
    all_vals = vals.new_zeros((shards, cap))
    all_rows = rows.new_zeros((shards, cap, rows.shape[1]))
    all_vals[d_idx] = vals
    all_rows[d_idx] = rows
    all_vals = _mesh.all_reduce(all_vals, mesh, (_mesh.DATA_AXIS,))
    all_rows = _mesh.all_reduce(all_rows, mesh, (_mesh.DATA_AXIS,))
    vals, j = torch.topk(all_vals.reshape(-1), cap)
    return vals, all_rows.reshape(-1, rows.shape[1]).index_select(0, j)


def _parallel_pipeline(src, points, weights, k: int, seed: int, *,
                       rounds: int, cap: int, ell: float, refine: int,
                       mode: str):
    """The k-means|| pipeline on the device (the JAX package's
    ``_build_parallel_pipeline``): a weight-proportional first draw, then
    ``rounds`` Bernoulli rounds of up to ``cap`` candidates each into a
    fixed buffer (sentinels in the slots left over), each round's new rows
    folded into ``mind2``, the cell mass of the buffer, and a weighted
    k-means++ reduce plus ``refine`` Lloyd steps on the buffer.  Every
    random number comes from one ``torch.Generator`` seeded with ``seed``
    on the device, drawn per global row; nothing is read to the host until
    the centres.  Returns ``(centres, buffer, valid, mass)``."""
    mesh = getattr(src, "mesh", None)
    dev = points.device
    n_local, d = points.shape
    acc = torch.promote_types(points.dtype, torch.float32)
    w = weights.to(acc)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    per_row, total = _per_row(src, n_local), int(src.n)
    cap_total = 1 + rounds * cap

    neg_inf = torch.full((), float("-inf"), dtype=acc, device=dev)
    w_logits = torch.where(w > 0, torch.log(torch.clamp_min(w, 1e-38)),
                           neg_inf)
    c0 = _row_of_max(w_logits + per_row(gumbel(total, gen, acc, dev)),
                     points, mesh)
    buf = torch.full((cap_total, d), _CAND_SENTINEL, dtype=points.dtype,
                     device=dev)
    buf[0] = c0
    valid = torch.zeros(cap_total, dtype=torch.bool, device=dev)
    valid[0] = True
    mind2 = fold_candidates(points, torch.full((n_local,), float("inf"),
                                               dtype=acc, device=dev),
                            buf[:1], mode=mode)
    tiny = torch.finfo(acc).tiny
    for r in range(rounds):
        phi = (w * mind2).sum()
        if mesh is not None:
            phi = _mesh.all_reduce(phi.reshape(1), mesh,
                                   (_mesh.DATA_AXIS,))[0]
        p = torch.clamp_max(ell * w * mind2 / torch.clamp_min(phi, tiny),
                            1.0)
        u = per_row(torch.rand(total, generator=gen, dtype=acc, device=dev))
        score = torch.where((u < p) & (w > 0), 1.0 + u,
                            torch.zeros_like(u))
        vals, rows = _top_candidates(score, points, cap, mesh)
        ok = vals > 0
        rows = torch.where(ok[:, None], rows,
                           torch.full_like(rows, _CAND_SENTINEL))
        fold_candidates(points, mind2, rows, mode=mode)
        buf[1 + r * cap: 1 + (r + 1) * cap] = rows
        valid[1 + r * cap: 1 + (r + 1) * cap] = ok
    mass = cell_mass(points, w, buf, mode=mode, mesh=mesh)
    mass_pos = torch.where(valid, torch.clamp_min(mass, 1e-12),
                           torch.zeros_like(mass)).to(buf.dtype)
    centers = kmeanspp_gumbel(buf, mass_pos, k,
                              gumbel((k, cap_total), gen, buf.dtype, dev))
    centers = refine_centers(buf, mass_pos, centers, refine)
    return centers, buf, valid, mass


#: The k-means|| pipelines, by (mesh, k, rounds, cap, refine, mode): the
#: JAX package's ``init._PIPE_CACHE``.
_PIPE_CACHE = LRUCache(32, name="init._PIPE_CACHE")


def make_parallel_pipeline_fn(mesh=None, *, k: int, rounds: int, cap: int,
                              refine: int, mode: str):
    """The k-means|| pipeline at these settings:
    ``(src, points, weights, seed, ell) -> (centres, buffer, valid, mass)``
    (:func:`_parallel_pipeline`), the builder that :data:`_PIPE_CACHE`
    keeps (the JAX package's ``_build_parallel_pipeline``)."""
    def pipeline(src, points, weights, seed: int, ell: float):
        return _parallel_pipeline(src, points, weights, k, seed,
                                  rounds=rounds, cap=cap, ell=ell,
                                  refine=refine, mode=mode)
    return pipeline


def _distinct_backfill(centers: np.ndarray, src, k: int, seed: int
                       ) -> np.ndarray:
    """Duplicate rows of a (k, D) centre table replaced by seeded uniform
    positive-weight rows (the JAX package's ``_distinct_backfill``, the
    same generator ``default_rng([seed, 0xBF11])``): reached only on tiny
    or degenerate data, where the rounds cannot find k distinct
    candidates.  Without row access (process-local data) the table is
    returned as it is."""
    _, first = np.unique(centers, axis=0, return_index=True)
    if len(first) >= k:
        return centers
    try:
        cand_idx = src.positive_rows()
    except ValueError:
        return centers
    keep = np.zeros(k, bool)
    keep[first] = True
    dup = np.flatnonzero(~keep)
    rng = np.random.default_rng([seed, 0xBF11])
    take = cand_idx[rng.choice(len(cand_idx),
                               size=min(len(dup), len(cand_idx)),
                               replace=False)]
    rows = np.asarray(src.take(take))
    centers[dup[: len(rows)]] = rows
    return centers


def _parallel_round(weights, mind2, phi, u, ell: float, cap: int):
    """One Bernoulli round of the host engine (the JAX package's
    ``_parallel_round``): each row sampled with probability ``min(1, ell w
    mind2 / phi)`` from the uniforms ``u``; up to ``cap`` of the sampled
    rows, ``(indices, valid)``."""
    tiny = torch.finfo(mind2.dtype).tiny
    p = torch.clamp_max(ell * weights * mind2 / max(float(phi), tiny), 1.0)
    sampled = (u < p) & (weights > 0)
    score = torch.where(sampled, 1.0 + u, torch.zeros_like(u))
    vals, idx = torch.topk(score, cap)
    return idx, vals > 0


def _kmeans_parallel_host(src, points, weights, k: int, seed: int, *,
                          rounds: int, cap: int, ell: float, mode: str,
                          return_candidates: bool = False):
    """The ``device=False`` engine (the JAX package's
    ``_kmeans_parallel_host``): the rounds' candidates kept on the host
    (one copy per round), made distinct, backfilled uniformly where fewer
    than k, weighted by their cell mass and reduced by the host's weighted
    k-means++ (``np.random.default_rng(seed)``, which also draws the first
    candidate).  The rounds' uniforms come from a ``torch.Generator``
    seeded with ``seed``."""
    candidates_idx = src.positive_rows()
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=points.device).manual_seed(int(seed))
    sw = getattr(src, "host_weights", None)
    if sw is None:
        first = int(candidates_idx[rng.integers(len(candidates_idx))])
    else:
        pw = np.asarray(sw, dtype=np.float64)[candidates_idx]
        first = int(candidates_idx[rng.choice(len(candidates_idx),
                                              p=pw / pw.sum())])
    acc = torch.promote_types(points.dtype, torch.float32)
    w = weights.to(acc)
    cand_rows = [np.asarray(src.take(np.array([first])))]
    cand_valid = [np.ones(1, bool)]
    mind2 = fold_candidates(
        points, torch.full((points.shape[0],), float("inf"), dtype=acc,
                           device=points.device),
        torch.from_numpy(cand_rows[0]).to(points.device, points.dtype),
        mode=mode)
    for _ in range(rounds):
        phi = (torch.where(w > 0, mind2 * w, torch.zeros_like(w))).sum()
        u = torch.rand(points.shape[0], generator=gen, dtype=acc,
                       device=points.device)
        idx, ok = _parallel_round(w, mind2, phi, u, ell, cap)
        rows = points.index_select(0, idx)
        cand_rows.append(rows.cpu().numpy())
        cand_valid.append(ok.cpu().numpy())
        fold_candidates(points, mind2, torch.where(
            ok[:, None], rows, torch.full_like(rows, _CAND_SENTINEL)),
            mode=mode)
    cands = np.concatenate(cand_rows)[np.concatenate(cand_valid)]
    cands = np.unique(cands, axis=0)
    if len(cands) < k:                       # tiny data: backfill uniformly
        extra = src.take(candidates_idx[rng.choice(
            len(candidates_idx), size=k - len(cands), replace=False)])
        cands = np.concatenate([cands, np.asarray(extra)])
    mass = cell_mass(points, w, torch.from_numpy(cands).to(
        points.device, points.dtype), mode=mode).cpu().numpy()
    mass = np.maximum(mass, 1e-12)
    centers = _weighted_kmeanspp_host(cands.astype(np.float64), mass, k,
                                      rng).astype(cands.dtype)
    if return_candidates:
        return centers, cands, mass
    return centers


def kmeans_parallel_init(X, k: int, seed: int, *, rounds: int = 5,
                         oversampling: Optional[float] = None,
                         validate: bool = True, device=True,
                         cap: Optional[int] = None, refine: int = 4,
                         return_candidates: bool = False,
                         mode: Optional[str] = None) -> np.ndarray:
    """k-means|| seeding (Bahmani et al. 2012), the JAX package's
    ``kmeans_parallel_init``: ``rounds`` passes that each Bernoulli-sample
    about ``oversampling`` x k (default 2k) candidates by their D^2 cost,
    then the candidates weighted by their cell mass and reduced to k
    centres by weighted k-means++, instead of k-means++'s k passes.

    ``device=True`` runs the pipeline (:func:`_parallel_pipeline`) on the
    dataset's device (over the data axis of a mesh), and a host array on
    the card, as every entry point of the port; a device (``'cpu'``,
    ``'cuda:1'``) places a host array there instead.  ``False`` runs the
    host engine (:func:`_kmeans_parallel_host`, torch on the CPU over the
    host copy; over a mesh every rank alike).  ``cap`` is the
    candidates kept per round (default ``clamp(2k, 256, 2048)``, at most the
    rows of a block), and the rounds are raised until they can hold 1.5 k.
    ``refine`` weighted Lloyd steps polish the reduce (device engine).
    ``mode`` is the distance mode of the folds and the mass pass: in
    'kernel' and 'kernel_bf16' they run kernel 2 and 2b, in the torch modes
    the float32 'matmul' tile (None: 'kernel' on a CUDA device, else
    'matmul').  The random streams are the
    port's own (``torch.Generator``): the same seed gives the same
    centres, not the JAX package's.  ``return_candidates=True`` also
    returns the valid candidates and their cell masses."""
    src = as_source(X)
    points = getattr(src, "points", None)
    weights = getattr(src, "weights", None)
    if points is None or (device is False and getattr(src, "mesh", None)):
        # A host array, or the host engine over a mesh (torch on the CPU
        # over the whole host copy, every rank the same draws).  The device
        # engine takes a host array to the card unless asked otherwise.
        from kmeans_tpu_torch.models.kmeans import resolve_device
        src.positive_rows()              # a mesh without a host copy raises
        on = torch.device("cpu") if device is False else resolve_device(
            None if device is True else device)
        points = torch.from_numpy(np.ascontiguousarray(src.host)).to(on)
        weights = (torch.ones(src.n, dtype=points.dtype, device=on)
                   if src.host_weights is None
                   else torch.from_numpy(np.asarray(
                       src.host_weights, dtype=src.host.dtype)).to(on))
    n_pos = (src.positive_count() if hasattr(src, "positive_count")
             else len(src.positive_rows()))
    if n_pos < k:
        raise ValueError(f"Not enough data points ({n_pos}) to initialize "
                         f"{k} clusters")
    host = getattr(src, "host", None)
    if validate:
        if host is not None:
            check_finite_array(host, "Data contains NaN or Inf values")
        else:
            finite = torch.isfinite(points).all().to(torch.int32).reshape(1)
            if not int(_mesh.all_reduce(finite, getattr(src, "mesh", None),
                                        (_mesh.DATA_AXIS,), "min")):
                raise ValueError("Data contains NaN or Inf values")
    if mode is None:
        mode = "kernel" if points.is_cuda else "matmul"
    n_local = points.shape[0]
    ell = float(oversampling if oversampling is not None else 2 * k)
    cap = int(min(max(2 * k, 256), 2048, n_local)) if cap is None \
        else int(min(max(int(cap), 1), n_local))
    rounds = max(rounds, -(-int(1.5 * k) // cap))  # at least 1.5 k samples
    if device is False:
        return _kmeans_parallel_host(src, points, weights, k, seed,
                                     rounds=rounds, cap=cap, ell=ell,
                                     mode=mode,
                                     return_candidates=return_candidates)
    pipeline = cached_build(_PIPE_CACHE, make_parallel_pipeline_fn,
                            getattr(src, "mesh", None), k=k, rounds=rounds,
                            cap=cap, refine=refine, mode=mode)
    centers, buf, valid, mass = pipeline(src, points, weights, seed, ell)
    centers = _distinct_backfill(centers.cpu().numpy(), src, k, seed)
    if validate:
        check_finite_array(centers, "Data contains NaN or Inf values")
    if return_candidates:
        v = valid.cpu().numpy()
        return centers, buf.cpu().numpy()[v], mass.cpu().numpy()[v]
    return centers


# ------------------------------------------------------------- streaming
# The initialisers of ``fit_stream``: the data is only ever seen a block at
# a time, so each strategy has a streamed form that draws over the whole
# stream, not its first block (the reference's ``takeSample`` draws over
# the whole distributed dataset).  All take a list of seeds and share each
# pass over the data among the restarts (R x compute, 1 x IO).  Stream items
# are (m, D) blocks or (block, weights) pairs; ``_split_block`` decodes
# both.


class _EpochReservoir:
    """Seeded Algorithm-R reservoir over streamed rows: a uniform sample
    without replacement of up to ``cap`` rows (the JAX package's
    ``_EpochReservoir``, the same draws).  It serves ``fit_stream``'s
    'resample' policy and the streamed initialisers: a cap-k reservoir over
    one whole pass is ``takeSample(False, k, seed)`` over the stream."""

    def __init__(self, cap: int, d: int, rng: np.random.Generator):
        self.cap = cap
        self.rng = rng
        self.rows = np.zeros((cap, d), np.float64)
        self.seen = 0

    @property
    def filled(self) -> int:
        return min(self.seen, self.cap)

    def offer(self, block: np.ndarray) -> None:
        # Only the rows that enter the reservoir are converted to float64
        # (by the assignment), not the whole block.
        b = np.asarray(block)
        nfill = max(0, min(self.cap - self.seen, len(b)))
        if nfill:
            self.rows[self.seen: self.seen + nfill] = b[:nfill]
        rest = len(b) - nfill
        if rest:
            # Vectorised Algorithm R: the row of global index t replaces a
            # slot iff randint(0, t + 1) < cap.  NumPy's fancy assignment
            # applies duplicates in order (the last wins), which is the
            # sequential algorithm exactly.
            t = self.seen + nfill + np.arange(rest)
            j = self.rng.integers(0, t + 1)
            hit = j < self.cap
            self.rows[j[hit]] = b[nfill:][hit]
        self.seen += len(b)

    def sample(self, m: int, rng: np.random.Generator) -> np.ndarray:
        take = min(m, self.filled)
        if take == 0:
            return np.empty((0, self.rows.shape[1]))
        idx = rng.choice(self.filled, size=take, replace=False)
        return self.rows[idx]


def _block_of(item):
    """The block of a stream item, for the streams that do not read weights
    (predict, transform): a pair's arity is checked, its weights dropped."""
    if isinstance(item, tuple):
        if len(item) != 2:
            raise ValueError(
                f"stream items must be (m, D) blocks or (block, weights) "
                f"pairs, got a {len(item)}-tuple")
        return item[0]
    return item


def _split_block(item, d: int, dtype):
    """Decode one stream item, a bare (m, D) array or a (block, weights)
    pair: ``(block contiguous in dtype, weights (m,) in that dtype or
    None)``, the weights under the in-memory ``sample_weight`` rules."""
    if isinstance(item, tuple):
        if len(item) != 2:
            raise ValueError(
                f"stream items must be (m, D) blocks or (block, weights) "
                f"pairs, got a {len(item)}-tuple")
        block, w = item
    else:
        block, w = item, None
    if isinstance(block, torch.Tensor):
        block = block.detach().cpu().numpy()
    block = np.ascontiguousarray(np.asarray(block, dtype=dtype))
    if block.ndim != 2 or block.shape[1] != d:
        raise ValueError(f"block shape {block.shape} != (*, {d})")
    if w is not None:
        if isinstance(w, torch.Tensor):
            w = w.detach().cpu().numpy()
        w = _validate_sample_weight(w, block.shape[0], block.dtype)
    return block, w


def _reservoir_pass(make_blocks, cap: int, k: int, d: int, seeds,
                    salt: int):
    """One pass, one seeded cap-row reservoir per restart over the
    positive-weight rows of the whole stream; the n < k error.  Returns
    ``(reservoirs, rows)``."""
    from kmeans_tpu_torch.data.prefetch import close_source
    res = [_EpochReservoir(cap, d, np.random.default_rng([s, salt]))
           for s in seeds]
    n = 0
    it = iter(make_blocks())
    try:
        for item in it:
            block, bw = _split_block(item, d, np.float64)
            b = block if bw is None else block[bw > 0]
            n += len(b)
            for r in res:
                r.offer(b)
    finally:
        close_source(it)
    if n < k:
        raise ValueError(
            f"Not enough data points ({n}) to initialize {k} clusters")
    return res, n


def streamed_forgy_init(make_blocks, k: int, seeds, d: int, dtype):
    """One pass: per seed, a cap-k reservoir, a uniform k-row sample
    without replacement of the whole stream's positive-weight rows (the JAX
    package's rows).  Returns ``(list of (k, d) arrays, rows)``."""
    res, n = _reservoir_pass(make_blocks, k, k, d, seeds, 0xF0261)
    outs = []
    for r in res:
        c = r.rows[: r.filled].astype(dtype)
        check_finite_array(c, "Data contains NaN or Inf values")
        outs.append(c)
    return outs, n


def streamed_init_sample(make_blocks, k: int, seeds, d: int, dtype, *,
                         cap: Optional[int] = None):
    """One pass: per seed, a uniform sample of up to ``cap`` positive-weight
    rows of the whole stream (default ``clamp(16 k, 2048, 32768)``, at
    least k), randomly permuted, for a callable init.  Returns ``(list of
    (m, d) arrays, rows)``."""
    cap = int(cap if cap is not None else min(max(16 * k, 2048), 32768))
    cap = max(cap, k)
    res, n = _reservoir_pass(make_blocks, cap, k, d, seeds, 0xCA11AB1E)
    outs = []
    for r, s in zip(res, seeds):
        # The slots are in fill order (early rows in early slots): permute,
        # so that a positional callable still gets a uniform draw.
        rows = r.rows[: r.filled]
        perm = np.random.default_rng([s, 0x5EED]).permutation(len(rows))
        c = rows[perm].astype(dtype)
        check_finite_array(c, "Data contains NaN or Inf values")
        outs.append(c)
    return outs, n


def _stream_round_block(points: torch.Tensor, w: torch.Tensor,
                        cands: torch.Tensor, phi_prev: float, ell: float,
                        u: Optional[torch.Tensor], cap: int, mode: str):
    """One block's share of one streamed k-means|| round: the minimum
    squared distance of each row to the candidates (kernel 2 or 2b in the
    kernel modes), the block's weighted cost ``sum w d^2`` (the next
    round's phi), and, given the uniforms ``u``, the rows sampled with
    probability ``min(1, ell w d^2 / phi_prev)``: up to ``cap`` of them, as
    a host array (None without ``u``)."""
    _, mind2 = _assign(points, cands, mode, need_min=True)
    acc = torch.promote_types(points.dtype, torch.float32)
    d2w = torch.clamp_min(mind2.to(acc), 0.0) * w.to(acc)
    phi_b = float(d2w.sum())
    if u is None:
        return None, phi_b
    p = torch.clamp_max(ell * d2w / max(phi_prev, torch.finfo(acc).tiny),
                        1.0)
    score = torch.where((u < p) & (w > 0), 1.0 + u, torch.zeros_like(u))
    vals, idx = torch.topk(score, min(cap, score.shape[0]))
    idx = idx[vals > 0]
    rows = points.index_select(0, idx).to(torch.float64).cpu().numpy()
    return rows, phi_b


def streamed_kmeans_parallel_init(make_blocks, k: int, seeds, d: int,
                                  dtype, *, rounds: int = 5,
                                  oversampling: Optional[float] = None,
                                  mode: Optional[str] = None, device=None):
    """Streamed k-means|| (Bahmani et al. 2012) over a block stream, the
    JAX package's ``streamed_kmeans_parallel_init``:

    * one pass draws the first candidate by a cap-1 reservoir (the JAX
      package's row) and counts the rows;
    * one pass sums the initial cost phi;
    * ``rounds`` passes sample about ``oversampling`` (2k) rows each by
      their D^2 cost against the candidates, with the phi of the previous
      pass (one candidate set stale, as in the JAX package);
    * one pass weighs the distinct candidates by their cell mass (and fills
      a cap-k backfill reservoir for a restart with fewer than k), then the
      host's weighted k-means++ (``np.random.default_rng(seed)``) reduces
      them to k centres.

    The blocks go to ``device`` (None: the card) in ``dtype``; the distance
    passes are kernel 2 (2b) in the kernel modes (``mode``: None is
    'kernel' on a CUDA device, else 'matmul'), the torch tile otherwise.
    The Bernoulli draws come from a ``torch.Generator`` per restart, seeded
    from ``SeedSequence([seed, 0xF1258])`` and drawn block by block, so the
    same stream gives the same centres; they are not the JAX package's
    draws, which this matches by quality.  Returns ``(list of (k, d)
    arrays, rows)``."""
    from kmeans_tpu_torch.data.prefetch import close_source
    from kmeans_tpu_torch.models.kmeans import resolve_device
    device = resolve_device(device)
    if mode is None:
        mode = "kernel" if device.type == "cuda" else "matmul"
    R = len(seeds)
    ell = float(oversampling if oversampling is not None else 2 * k)
    cap = int(min(max(2 * k, 256), 2048))
    res = [_EpochReservoir(1, d, np.random.default_rng([s, 0xF1257]))
           for s in seeds]
    n = 0
    it = iter(make_blocks())                       # first candidate, rows
    try:
        for item in it:
            block, bw = _split_block(item, d, np.float64)
            b = block if bw is None else block[bw > 0]
            n += len(b)
            for r in res:
                r.offer(b)
    finally:
        close_source(it)
    if n < k:
        raise ValueError(
            f"Not enough data points ({n}) to initialize {k} clusters")
    cands = [r.rows[:1].copy() for r in res]
    stager = BlockStager(device, dtype, 0)

    def epoch_blocks():
        """The blocks on the device with their weights, and the host
        block (the backfill reservoirs read it)."""
        it = iter(make_blocks())
        try:
            for item in it:
                block, bw = _split_block(item, d, dtype)
                points, w = stager.take(stager.stage(block, bw))
                yield block, bw, points, w
        finally:
            close_source(it)

    def on_device(c: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            c.astype(dtype))).to(device)

    phi = np.zeros(R)
    for _, _, points, w in epoch_blocks():          # pass: initial phi
        for r in range(R):
            phi[r] += _stream_round_block(points, w, on_device(cands[r]),
                                          np.inf, 0.0, None, cap, mode)[1]
    acc = torch.promote_types(torch_dtype(dtype), torch.float32)
    gens = [torch.Generator(device=device).manual_seed(int(
        np.random.SeedSequence([s, 0xF1258]).generate_state(1)[0]))
        for s in seeds]
    for _ in range(rounds):                          # sampling passes
        new = [[] for _ in range(R)]
        phi_next = np.zeros(R)
        tables = [on_device(c) for c in cands]
        for _, _, points, w in epoch_blocks():
            for r in range(R):
                u = torch.rand(points.shape[0], generator=gens[r],
                               dtype=acc, device=device)
                rows, phi_b = _stream_round_block(
                    points, w, tables[r], float(phi[r]), ell, u, cap, mode)
                if len(rows):
                    new[r].append(rows)
                phi_next[r] += phi_b
        for r in range(R):
            if new[r]:
                cands[r] = np.concatenate([cands[r]] + new[r])
        phi = phi_next
    cands = [np.unique(c, axis=0) for c in cands]

    # Cell-mass pass, with cap-k backfill reservoirs for the restarts that
    # came up short.
    masses = [np.zeros(len(c)) for c in cands]
    short = [r for r in range(R) if len(cands[r]) < k]
    back = {r: _EpochReservoir(k, d,
                               np.random.default_rng([seeds[r], 0xF1259]))
            for r in short}
    tables = [on_device(c) for c in cands]
    for block, bw, points, w in epoch_blocks():
        for r in range(R):
            masses[r] += cell_mass(points, w, tables[r],
                                   mode=mode).cpu().numpy()
        if short:
            real = block if bw is None else block[bw > 0]
            for r in short:
                back[r].offer(real)
    outs = []
    for r in range(R):
        c = cands[r]
        if len(c) < k:
            extra = back[r].sample(
                k - len(c), np.random.default_rng([seeds[r], 0xF1260]))
            c = np.concatenate([c, extra])
            masses[r] = np.concatenate([masses[r], np.ones(len(extra))])
        centers = _weighted_kmeanspp_host(
            c.astype(np.float64), np.maximum(masses[r][: len(c)], 1e-12),
            k, np.random.default_rng(seeds[r]))
        centers = centers.astype(dtype)
        check_finite_array(centers, "Data contains NaN or Inf values")
        outs.append(centers)
    return outs, n


STREAM_INITIALIZERS = {"forgy": streamed_forgy_init,
                       "random": streamed_forgy_init,
                       "k-means++": streamed_kmeans_parallel_init,
                       "kmeans++": streamed_kmeans_parallel_init,
                       "k-means||": streamed_kmeans_parallel_init,
                       "kmeans||": streamed_kmeans_parallel_init}


INITIALIZERS = {"forgy": forgy_init, "random": forgy_init,
                "k-means++": kmeanspp_init, "kmeans++": kmeanspp_init,
                "k-means||": kmeans_parallel_init,
                "kmeans||": kmeans_parallel_init}


def resolve_init(init, X, k: int, seed: int, *,
                 validate: bool = True, cap: Optional[int] = None,
                 mode: Optional[str] = None, device=True) -> np.ndarray:
    """Dispatch: strategy name, callable ``init(X, k, seed)``, or an
    explicit (k, D) array.  ``cap`` (``KMeans(init_cap=...)``), ``mode``
    (the model's distance mode) and ``device`` (where k-means|| places host
    rows: the model's device; True is the card) go to k-means||; ``cap``
    with any other strategy raises, as in the JAX package."""
    src = as_source(X)
    dtype = np.dtype(str(src.dtype))
    parallel = isinstance(init, str) and \
        INITIALIZERS.get(init) is kmeans_parallel_init
    if cap is not None and not parallel:
        raise ValueError(
            "init_cap sizes the k-means|| candidate buffer and only "
            "applies to init='k-means||'; got init="
            + (repr(init) if isinstance(init, str) else "a non-strategy "
               "init (array/callable)"))
    if callable(init):
        host = getattr(src, "host", None)
        with _obs_trace.span("seed", strategy="callable", k=k):
            return np.asarray(
                init(host if host is not None else src, k, seed),
                dtype=dtype)
    if isinstance(init, str):
        try:
            fn = INITIALIZERS[init]
        except KeyError:
            raise ValueError(f"unknown init strategy: {init!r}; "
                             f"options: {sorted(INITIALIZERS)}") from None
        kw = {"cap": cap, "mode": mode, "device": device} if parallel \
            else {}
        with _obs_trace.span("seed", strategy=init, k=k):
            return np.asarray(fn(src, k, seed, validate=validate, **kw),
                              dtype=dtype)
    arr = np.asarray(init, dtype=dtype)
    if arr.shape != (k, src.d):
        raise ValueError(f"explicit init must have shape ({k}, "
                         f"{src.d}), got {arr.shape}")
    check_finite_array(arr, "Data contains NaN or Inf values")
    return arr
