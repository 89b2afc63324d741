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
"""

from __future__ import annotations

from typing import NamedTuple

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
    """Squared Euclidean distances, (n, k) for x (n, D), centroids (k, D).

    ``mode='matmul'`` uses the expanded form, one (n, D) @ (D, k) product,
    clamped at 0 (cancellation can go tiny-negative).  ``'matmul_bf16'``
    takes the cross term from bf16-rounded x and centroids (the norms stay
    those of the unrounded inputs).  ``mode='direct'`` materialises the
    (n, k, D) differences: no cancellation, for small problems and parity
    tests."""
    acc = _accum_dtype(x.dtype)
    if mode == "direct":
        diff = x[:, None, :].to(acc) - centroids[None, :, :].to(acc)
        return (diff * diff).sum(dim=-1)
    if mode == "matmul_bf16_guarded":
        raise NotImplementedError(
            f"distance mode {mode!r} is not ported yet: ROADMAP.md, A.1 "
            f"'the guarded mode of ops/assign.py'")
    if mode not in ("matmul", "matmul_bf16"):
        raise ValueError(f"unknown distance mode: {mode!r}")
    x = x.to(acc)
    c = centroids.to(acc)
    x2 = (x * x).sum(dim=-1, keepdim=True)                 # (n, 1)
    c2 = (c * c).sum(dim=-1)[None, :]                      # (1, k)
    if mode == "matmul_bf16":
        xc = round_bf16(x, acc) @ round_bf16(c, acc).T
    else:
        xc = x @ c.T
    return torch.clamp_min(x2 + c2 - 2.0 * xc, 0.0)


def assign_chunk(x: torch.Tensor, centroids: torch.Tensor,
                 mode: str = "matmul", need_min: bool = True):
    """Nearest centroid per point: (labels int32 (n,), min sq-dist (n,) or
    None when ``need_min`` is false)."""
    d2 = pairwise_sq_dists(x, centroids, mode=mode)
    best = torch.argmin(d2, dim=1).to(torch.int32)     # lowest index on ties
    mind2 = d2.min(dim=1).values if need_min else None
    return best, mind2


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


def consume_chunk(carry: StepStats, d2: torch.Tensor, xc: torch.Tensor,
                  wc: torch.Tensor, centroids: torch.Tensor, *,
                  need_sse: bool = True, need_farthest: bool = True,
                  need_sse_pc: bool = True, bf16: bool = False) -> StepStats:
    """Fold one (chunk, D) tile of points, whose distance tile ``d2`` is
    already computed, into the running statistics: argmin over the tile,
    one-hot products for sums and counts, fused SSE, per-cluster SSE and
    farthest point.  Rows of weight 0 contribute nothing.  The ``need_*``
    flags skip the optional statistics (their fields keep their initial
    values).  ``bf16`` rounds both factors of the sums' product to bf16
    (the weighted one-hot and the points); the counts stay unrounded."""
    acc = carry.sums.dtype
    k = centroids.shape[0]
    need_min = need_sse or need_farthest or need_sse_pc
    best = torch.argmin(d2, dim=1)                         # lowest-index ties
    mind2 = d2.min(dim=1).values if need_min else None
    wc = wc.to(acc)
    ids = torch.arange(k, device=xc.device)
    onehot = (best[:, None] == ids[None, :]).to(acc) * wc[:, None]  # (c, k)
    if bf16:
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
    return StepStats(sums, counts, sse, far_d, far_p, sse_pc)


def accumulate_chunk(carry: StepStats, xc: torch.Tensor, wc: torch.Tensor,
                     centroids: torch.Tensor, *, mode: str = "matmul",
                     need_sse: bool = True, need_farthest: bool = True,
                     need_sse_pc: bool = True) -> StepStats:
    """Distance tile of one chunk, then :func:`consume_chunk`."""
    d2 = pairwise_sq_dists(xc, centroids, mode=mode)
    return consume_chunk(carry, d2, xc, wc, centroids, need_sse=need_sse,
                         need_farthest=need_farthest,
                         need_sse_pc=need_sse_pc,
                         bf16=mode == "matmul_bf16")


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
    k, d = centroids.shape
    acc = _accum_dtype(points.dtype)
    stats = init_stats(k, d, acc, points.device)
    kw = dict(need_sse=need_sse, need_farthest=need_farthest,
              need_sse_pc=need_sse_pc)
    chunks = [(points[lo:lo + chunk_size], weights[lo:lo + chunk_size])
              for lo in range(0, points.shape[0], chunk_size)]
    if not pipeline:
        for xc, wc in chunks:
            stats = accumulate_chunk(stats, xc, wc, centroids, mode=mode,
                                     **kw)
        return stats
    kw["bf16"] = mode == "matmul_bf16"
    d2 = None
    for i, (xc, _) in enumerate(chunks):
        d2_next = pairwise_sq_dists(xc, centroids, mode=mode)
        if d2 is not None:
            stats = consume_chunk(stats, d2, *chunks[i - 1], centroids, **kw)
        d2 = d2_next
    if d2 is not None:
        stats = consume_chunk(stats, d2, *chunks[-1], centroids, **kw)
    return stats


def assign_labels(points: torch.Tensor, centroids: torch.Tensor, *,
                  chunk_size: int, mode: str = "matmul") -> torch.Tensor:
    """Labels only, int32 (n,): the pass behind ``predict``."""
    n = points.shape[0]
    labels = torch.empty(n, dtype=torch.int32, device=points.device)
    for lo in range(0, n, chunk_size):
        labels[lo:lo + chunk_size] = assign_chunk(
            points[lo:lo + chunk_size], centroids, mode=mode,
            need_min=False)[0]
    return labels
