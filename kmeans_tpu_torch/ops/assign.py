"""Assignment and reduction in plain torch ops (the K-Means hot loop).

Counterpart of ``kmeans_tpu/ops/assign.py`` and the semantic oracle of the
CUDA kernels in ``ops.hopper_kernels``.  This is ``distance_mode='matmul'``
(and ``'direct'``): squared distances in the expanded form
``||x||^2 + ||c||^2 - 2 x @ c.T`` so that the O(n*k*D) work is one matrix
product per chunk, cluster sums as a one-hot (chunk, k)^T @ (chunk, D)
product (deterministic, unlike a scatter with atomics), and SSE, per-cluster
SSE and the farthest point folded into the same pass.  ``'matmul_bf16'``
feeds both products bf16-rounded inputs and sums them in the accumulation
type (:func:`round_bf16`).  Points are walked in chunks of rows, so no
(n, k) matrix is ever whole in memory.

Ties go to the lowest index (``torch.argmin`` returns the first minimum),
as NumPy's and the JAX package's argmin do.

The guarded bf16 rung (``'matmul_bf16_guarded'``, :data:`GUARDED_MODE`) is
not a tile mode: its tile is the ``'matmul_bf16'`` one
(:func:`distance_stage`), and the guard acts on the argmin in
:func:`consume_chunk` (:func:`guarded_assign_chunk`).

The distance tile takes centroids with a leading member axis, (R, k, D):
every member's (chunk, k) tile is then one batched product over the
shared points (the packed predict of
``parallel.distributed.make_multi_predict_fn``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class StepStats(NamedTuple):
    """Statistics of one assignment pass; every field has a fixed shape."""

    sums: torch.Tensor             # (k, D) per-cluster coordinate sums
    counts: torch.Tensor           # (k,)  per-cluster weighted counts
    sse: torch.Tensor              # ()    sum of min squared distances
    farthest_dist: torch.Tensor    # ()    max over points of min distance^2
    farthest_point: torch.Tensor   # (D,)  the point achieving farthest_dist
    sse_per_cluster: torch.Tensor  # (k,)  per-cluster sum of min sq distances


def _accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulate in at least float32 (float64 stays float64)."""
    return torch.promote_types(dtype, torch.float32)


def round_bf16(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even) and widened to ``dtype``.

    "bf16 products, float32 sums" is computed as a ``dtype`` product of
    tensors rounded this way: the product of two bf16 values is exact in
    float32, so the arithmetic is the same on every backend.  A bf16
    ``matmul`` is not used: its accumulation type differs by backend."""
    return t.to(torch.bfloat16).to(dtype)


def pairwise_sq_dists(x: torch.Tensor, centroids: torch.Tensor,
                      mode: str = "matmul") -> torch.Tensor:
    """Squared Euclidean distances, (n, k) for x (n, D), centroids (k, D),
    or (R, n, k) for centroids (R, k, D).

    ``mode='matmul'`` uses the expanded form, one (n, D) @ (D, k) product,
    clamped at 0 (cancellation can go tiny-negative).  ``'matmul_bf16'``
    takes the cross term from bf16-rounded x and centroids (the norms stay
    those of the unrounded inputs).  ``mode='direct'`` materialises the
    (n, k, D) differences: no cancellation, for small problems and parity
    tests.  The guarded rung is no tile mode (see :func:`distance_stage`),
    so its name raises like any unknown one, as in the JAX package."""
    acc = _accum_dtype(x.dtype)
    if mode == "direct":
        diff = x[:, None, :].to(acc) - centroids.unsqueeze(-3).to(acc)
        return (diff * diff).sum(dim=-1)
    if mode not in ("matmul", "matmul_bf16"):
        raise ValueError(f"unknown distance mode: {mode!r}")
    x = x.to(acc)
    c = centroids.to(acc)
    x2 = (x * x).sum(dim=-1, keepdim=True)                 # (n, 1)
    c2 = (c * c).sum(dim=-1).unsqueeze(-2)                 # (.., 1, k)
    if mode == "matmul_bf16":
        xc = round_bf16(x, acc) @ round_bf16(c, acc).transpose(-1, -2)
    else:
        xc = x @ c.transpose(-1, -2)
    return torch.clamp_min(x2 + c2 - 2.0 * xc, 0.0)


def assign_chunk(x: torch.Tensor, centroids: torch.Tensor,
                 mode: str = "matmul", need_min: bool = True):
    """Nearest centroid per point: (labels int32 (n,), min sq-dist (n,) or
    None when ``need_min`` is false)."""
    d2 = pairwise_sq_dists(x, centroids, mode=mode)
    best = torch.argmin(d2, dim=1).to(torch.int32)     # lowest index on ties
    mind2 = d2.min(dim=1).values if need_min else None
    return best, mind2


# ------------------------------------------------------- guarded bf16 rung

#: The guard of the bf16 rung: a bf16 label is kept only where its argmin
#: margin (second-best minus best distance) clears this share of the row's
#: distance scale ``||x||^2 + max_k ||c_k||^2``.  bf16 inputs round at about
#: 2^-8, so a distance difference carries about 2^-6 of the scale in error;
#: the bound is that doubled.  Flagged rows take the argmin of a float32
#: ('matmul') pass.
BF16_GUARD_RTOL = 2.0 ** -5

#: The distance-mode name of the guarded rung.  Not a
#: :func:`pairwise_sq_dists` mode: the guard acts on the argmin, in
#: :func:`consume_chunk`; the tile computes at the 'matmul_bf16' rate.
GUARDED_MODE = "matmul_bf16_guarded"


def value_mode(mode: str) -> str:
    """The mode whose distance values a mode reports where the values are
    the output (``transform``, ``score``, the packed multi-model predict):
    the guarded rung protects the argmin, and its values are the float32
    class, 'matmul'.  Every other mode is its own."""
    return "matmul" if mode == GUARDED_MODE else mode


def margin_chunk(x: torch.Tensor, d2: torch.Tensor, c2max: torch.Tensor):
    """Per-row argmin safety data of a (n, k) distance tile: ``(best,
    margin, scale)``, ``margin`` the second-best minus the best distance,
    ``scale`` = ``||x||^2 + max_k ||c_k||^2`` (what the bf16 cross term's
    error is relative to)."""
    acc = _accum_dtype(x.dtype)
    best = torch.argmin(d2, dim=1).to(torch.int32)
    d1 = d2.min(dim=1).values
    ids = torch.arange(d2.shape[1], device=d2.device, dtype=torch.int32)
    masked = torch.where(best[:, None] == ids[None, :],
                         torch.full_like(d2, float("inf")), d2)
    d2nd = masked.min(dim=1).values
    xa = x.to(acc)
    scale = (xa * xa).sum(dim=1) + c2max
    return best, (d2nd - d1).to(acc), scale


def guarded_assign_chunk(x: torch.Tensor, d2_bf16: torch.Tensor,
                         centroids: torch.Tensor, *,
                         tie_rtol: float = BF16_GUARD_RTOL,
                         real_mask: Optional[torch.Tensor] = None,
                         valid: Optional[torch.Tensor] = None):
    """The guarded argmin of one chunk: ``(labels int32 (n,), flagged
    int32 ())``.

    ``d2_bf16`` is the chunk's 'matmul_bf16' tile.  A row whose margin is
    within ``tie_rtol`` of its scale is flagged and takes the argmin of a
    float32 ('matmul') tile of the chunk.  That tile is computed for every
    chunk and selected row by row (``torch.where``): a captured CUDA graph
    holds no data-dependent branch, and a host-side test of the flags would
    read a value to the host per chunk.  The labels are those of the JAX
    package's rung, whose ``lax.cond`` skips the float32 tile on chunks
    without a flag.  ``flagged`` counts the flagged rows (the audit), not
    the labels that changed.

    ``real_mask`` (k,) keeps sentinel centroid rows (1e12 padding) out of
    the scale; ``valid`` (n,) keeps rows out of the flags (rows of weight
    0 contribute to no statistic)."""
    acc = _accum_dtype(x.dtype)
    c = centroids.to(acc)
    c2 = (c * c).sum(dim=1)
    if real_mask is not None:
        c2 = torch.where(real_mask, c2, torch.zeros_like(c2))
    best, margin, scale = margin_chunk(x, d2_bf16, c2.max())
    near = margin <= tie_rtol * scale
    if valid is not None:
        near = near & valid
    exact = torch.argmin(pairwise_sq_dists(x, centroids, mode="matmul"),
                         dim=1).to(torch.int32)
    return torch.where(near, exact, best), near.sum(dtype=torch.int32)


def _winner_sq_dists(x: torch.Tensor, centroids: torch.Tensor,
                     best: torch.Tensor, acc) -> torch.Tensor:
    """Float32-class squared distance of each row to its winner: the
    clamped expanded form of the 'matmul' tile, one row dot per point
    instead of k.  Equal to the 'matmul' tile's minimum up to the dot's
    summation order (the rtol class)."""
    xa = x.to(acc)
    cb = centroids.to(acc).index_select(0, best.to(torch.int64))
    x2 = (xa * xa).sum(dim=-1)
    c2 = (cb * cb).sum(dim=-1)
    return torch.clamp_min(x2 + c2 - 2.0 * (xa * cb).sum(dim=-1), 0.0)


# -------------------------------------------------------------- the pass


def init_stats(k: int, d: int, acc: torch.dtype, device) -> StepStats:
    """Zeroed accumulator (the farthest distance starts at -1)."""
    return StepStats(
        sums=torch.zeros((k, d), dtype=acc, device=device),
        counts=torch.zeros((k,), dtype=acc, device=device),
        sse=torch.zeros((), dtype=acc, device=device),
        farthest_dist=torch.full((), -1.0, dtype=acc, device=device),
        farthest_point=torch.zeros((d,), dtype=acc, device=device),
        sse_per_cluster=torch.zeros((k,), dtype=acc, device=device),
    )


def distance_stage(xc: torch.Tensor, centroids: torch.Tensor, *,
                   mode: str = "matmul") -> torch.Tensor:
    """Stage A of a chunk: its distance tile.  The guarded rung's tile is
    the 'matmul_bf16' one (its guard acts in stage B)."""
    tile = "matmul_bf16" if mode == GUARDED_MODE else mode
    return pairwise_sq_dists(xc, centroids, mode=tile)


def consume_chunk(carry: StepStats, d2: torch.Tensor, xc: torch.Tensor,
                  wc: torch.Tensor, centroids: torch.Tensor, *,
                  mode: str = "matmul", real_mask=None,
                  need_sse: bool = True, need_farthest: bool = True,
                  need_sse_pc: bool = True):
    """Stage B of a chunk: fold one (chunk, D) tile of points, whose
    distance tile ``d2`` is already computed, into the running statistics:
    argmin over the tile, one-hot products for sums and counts, fused SSE,
    per-cluster SSE and farthest point.  Returns ``(StepStats,
    flagged)``, ``flagged`` the guarded rung's flagged rows (int32 0
    otherwise).  Rows of weight 0 contribute nothing.  The ``need_*``
    flags skip the optional statistics (their fields keep their initial
    values).

    ``'matmul_bf16'`` rounds both factors of the sums' product to bf16
    (the weighted one-hot and the points); the counts stay unrounded.  The
    guarded rung takes its labels from :func:`guarded_assign_chunk`, sums
    them at full precision (so sums and counts are those of 'matmul' on
    the same labels) and reads the winner's float32-class distance for the
    statistics of the minimum (:func:`_winner_sq_dists`).  ``real_mask``
    marks real centroid rows for the guard's scale."""
    acc = carry.sums.dtype
    k = centroids.shape[0]
    need_min = need_sse or need_farthest or need_sse_pc
    flagged = torch.zeros((), dtype=torch.int32, device=xc.device)
    if mode == GUARDED_MODE:
        best, flagged = guarded_assign_chunk(
            xc, d2, centroids, real_mask=real_mask, valid=wc > 0)
        mind2 = (_winner_sq_dists(xc, centroids, best, acc)
                 if need_min else None)
    else:
        best = torch.argmin(d2, dim=1)                     # lowest-index ties
        mind2 = d2.min(dim=1).values if need_min else None
    wc = wc.to(acc)
    ids = torch.arange(k, device=xc.device)
    onehot = (best[:, None] == ids[None, :]).to(acc) * wc[:, None]  # (c, k)
    if mode == "matmul_bf16":
        sums = carry.sums + round_bf16(onehot, acc).T @ round_bf16(xc, acc)
    else:
        sums = carry.sums + onehot.T @ xc.to(acc)          # (k, D)
    counts = carry.counts + onehot.sum(dim=0)
    sse = carry.sse + (mind2 * wc).sum() if need_sse else carry.sse
    sse_pc = (carry.sse_per_cluster + onehot.T @ mind2.to(acc)
              if need_sse_pc else carry.sse_per_cluster)
    if need_farthest:
        neg_inf = torch.full_like(mind2, float("-inf"))
        masked = torch.where(wc > 0, mind2, neg_inf)
        # index_select, not [i]: a tensor index would read it to the host,
        # which a captured graph cannot do.
        i = torch.argmax(masked).reshape(1)
        far_d = masked.index_select(0, i)[0]
        far_p = xc.index_select(0, i)[0].to(acc)
        better = far_d > carry.farthest_dist
        far_d = torch.where(better, far_d, carry.farthest_dist)
        far_p = torch.where(better, far_p, carry.farthest_point)
    else:
        far_d, far_p = carry.farthest_dist, carry.farthest_point
    return StepStats(sums, counts, sse, far_d, far_p, sse_pc), flagged


def accumulate_chunk(carry: StepStats, xc: torch.Tensor, wc: torch.Tensor,
                     centroids: torch.Tensor, *, mode: str = "matmul",
                     need_sse: bool = True, need_farthest: bool = True,
                     need_sse_pc: bool = True) -> StepStats:
    """Distance tile of one chunk, then :func:`consume_chunk` (its flag
    count dropped)."""
    d2 = distance_stage(xc, centroids, mode=mode)
    return consume_chunk(carry, d2, xc, wc, centroids, mode=mode,
                         need_sse=need_sse, need_farthest=need_farthest,
                         need_sse_pc=need_sse_pc)[0]


def reduce_chunks(points: torch.Tensor, weights: torch.Tensor,
                  centroids: torch.Tensor, *, chunk_size: int,
                  mode: str = "matmul", need_sse: bool = True,
                  need_farthest: bool = True, need_sse_pc: bool = True,
                  pipeline: int = 0, real_mask=None):
    """:func:`assign_reduce` with the guarded rung's flag count:
    ``(StepStats, flagged)``."""
    k, d = centroids.shape
    acc = _accum_dtype(points.dtype)
    stats = init_stats(k, d, acc, points.device)
    flagged = torch.zeros((), dtype=torch.int32, device=points.device)
    kw = dict(mode=mode, real_mask=real_mask, need_sse=need_sse,
              need_farthest=need_farthest, need_sse_pc=need_sse_pc)
    chunks = [(points[lo:lo + chunk_size], weights[lo:lo + chunk_size])
              for lo in range(0, points.shape[0], chunk_size)]
    if not pipeline:
        for xc, wc in chunks:
            stats, f = consume_chunk(
                stats, distance_stage(xc, centroids, mode=mode), xc, wc,
                centroids, **kw)
            flagged = flagged + f
        return stats, flagged
    d2 = None
    for i, (xc, _) in enumerate(chunks):
        d2_next = distance_stage(xc, centroids, mode=mode)
        if d2 is not None:
            stats, f = consume_chunk(stats, d2, *chunks[i - 1], centroids,
                                     **kw)
            flagged = flagged + f
        d2 = d2_next
    if d2 is not None:
        stats, f = consume_chunk(stats, d2, *chunks[-1], centroids, **kw)
        flagged = flagged + f
    return stats, flagged


def assign_reduce(points: torch.Tensor, weights: torch.Tensor,
                  centroids: torch.Tensor, *, chunk_size: int,
                  mode: str = "matmul", need_sse: bool = True,
                  need_farthest: bool = True,
                  need_sse_pc: bool = True, pipeline: int = 0) -> StepStats:
    """One fused pass: assign every point, reduce all per-iteration stats.

    Chunks are folded in row order; the last chunk may be short (no padding
    is needed here, unlike under a compiled scan).  ``pipeline`` picks the
    chunk schedule, as the JAX package's ``_local_stats`` does: 0 computes
    each chunk's distance tile (stage A) and folds it (stage B) back to
    back; 1 skews them by one chunk, stage A of chunk i issued before stage
    B of chunk i - 1, so that the two can overlap.  Each chunk's arithmetic
    and the fold order are the same, so the two schedules give the same
    bits."""
    return reduce_chunks(points, weights, centroids, chunk_size=chunk_size,
                         mode=mode, need_sse=need_sse,
                         need_farthest=need_farthest,
                         need_sse_pc=need_sse_pc, pipeline=pipeline)[0]


def assign_labels(points: torch.Tensor, centroids: torch.Tensor, *,
                  chunk_size: int, mode: str = "matmul") -> torch.Tensor:
    """Labels only, int32 (n,): the pass behind ``predict``.  The guarded
    rung runs its guard here too."""
    n = points.shape[0]
    labels = torch.empty(n, dtype=torch.int32, device=points.device)
    for lo in range(0, n, chunk_size):
        xc = points[lo:lo + chunk_size]
        if mode == GUARDED_MODE:
            labels[lo:lo + chunk_size] = guarded_assign_chunk(
                xc, distance_stage(xc, centroids, mode=mode), centroids)[0]
        else:
            labels[lo:lo + chunk_size] = assign_chunk(
                xc, centroids, mode=mode, need_min=False)[0]
    return labels
