"""The training and predict step on one device.

One-device counterpart of ``kmeans_tpu/parallel/distributed.py``
(``_weighted_sqnorm_total``, ``_sse_from_stats``, the ``model_shards <= 1``
branch of ``_pallas_local_stats``, the chunk scan of ``_local_stats``,
``make_step_fn``, ``make_predict_fn``).  No mesh and no collectives: the
statistics of the one device are the global ones.

``mode='kernel'`` runs the fused CUDA kernel of ``ops.hopper_kernels`` (its
plain version when the tensors lie on the CPU) and ``'kernel_bf16'`` its bf16
tensor-core kernel; ``'matmul'``, ``'matmul_bf16'`` and ``'direct'`` run the
chunked torch pass of ``ops.assign``.
"""

from __future__ import annotations

from typing import Callable

import torch

from kmeans_tpu_torch.ops.assign import (StepStats, _accum_dtype,
                                         assign_labels, assign_reduce,
                                         init_stats)
from kmeans_tpu_torch.ops.hopper_kernels import (fused_assign_reduce,
                                                 hopper_assign)

KERNEL_MODES = ("kernel", "kernel_bf16")
TORCH_MODES = ("matmul", "matmul_bf16", "direct")


def _weighted_sqnorm_total(points: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """The first term of :func:`_sse_from_stats`: ``sum_i w_i ||x_i||^2``."""
    x = points.to(torch.float32)
    return (weights.to(torch.float32) * (x * x).sum(dim=1)).sum()


def _sse_from_stats(x2w, centroids, sums, counts, acc) -> torch.Tensor:
    """SSE derived algebraically from the pass statistics:

        SSE = sum_i w_i ||x_i||^2  -  2 sum_k <c_k, S_k>  +  sum_k n_k ||c_k||^2

    (expand ||x - c_{b(i)}||^2 and group by cluster; S_k / n_k are the
    weighted per-cluster sums and counts).  Costs O(k*D) instead of a reduce
    over the kernel's per-point ``mind2``.  Clamped at 0: the difference of
    large terms can go tiny-negative near a perfect fit."""
    c = centroids.to(torch.float32)
    cross = (c * sums.to(torch.float32)).sum()
    cnorm = (counts.to(torch.float32) * (c * c).sum(dim=1)).sum()
    return torch.clamp_min(x2w - 2.0 * cross + cnorm, 0.0).to(acc)


def _kernel_local_stats(points, weights, centroids, *, bf16: bool = False,
                        need_sse: bool = True, need_farthest: bool = True,
                        need_sse_pc: bool = True, x2w=None) -> StepStats:
    """One pass through the fused kernel (its bf16 form with ``bf16``), then
    the statistics it does not produce itself, in torch ops on (n,) and
    (k, D) tensors.  The per-point ``mind2`` is only asked of the kernel
    when something reads it."""
    acc = _accum_dtype(points.dtype)
    k, d = centroids.shape
    w = weights.to(torch.float32)
    need_point = need_farthest or need_sse_pc or (need_sse and x2w is None)
    labels, mind2, sums, counts = fused_assign_reduce(
        points, w, centroids, bf16=bf16, with_mind2=need_point)
    zero = init_stats(k, d, acc, points.device)
    if not need_sse:
        sse = zero.sse
    elif x2w is not None:
        sse = _sse_from_stats(x2w, centroids, sums, counts, acc)
    else:
        sse = (mind2 * w).sum().to(acc)
    if need_sse_pc:
        sse_pc = torch.zeros(k, dtype=acc, device=points.device).index_add_(
            0, labels.to(torch.int64), (mind2 * w).to(acc))
    else:
        sse_pc = zero.sse_per_cluster
    if need_farthest:
        live = w > 0
        masked = torch.where(live, mind2, torch.full_like(mind2,
                                                          float("-inf")))
        i = torch.argmax(masked)
        far_d = torch.where(live.any(), masked[i],
                            torch.full_like(masked[i], -1.0)).to(acc)
        far_p = points[i].to(acc)
    else:
        far_d, far_p = zero.farthest_dist, zero.farthest_point
    return StepStats(sums.to(acc), counts.to(acc), sse, far_d, far_p, sse_pc)


def local_stats(points, weights, centroids, *, chunk_size: int, mode: str,
                need_sse: bool = True, need_farthest: bool = True,
                need_sse_pc: bool = True, x2w=None) -> StepStats:
    """The statistics of one pass over the device's points."""
    if mode in KERNEL_MODES:
        return _kernel_local_stats(
            points, weights, centroids, bf16=mode == "kernel_bf16",
            need_sse=need_sse,
            need_farthest=need_farthest, need_sse_pc=need_sse_pc, x2w=x2w)
    if mode not in TORCH_MODES:
        raise ValueError(f"unknown distance mode: {mode!r}")
    return assign_reduce(points, weights, centroids, chunk_size=chunk_size,
                         mode=mode, need_sse=need_sse,
                         need_farthest=need_farthest,
                         need_sse_pc=need_sse_pc)


def make_step_fn(*, chunk_size: int, mode: str = "matmul") -> Callable:
    """The step: ``(points, weights, centroids) -> StepStats``.

    In the kernel modes the SSE comes from the algebraic form
    (:func:`_sse_from_stats`), as in the JAX package's per-dispatch path: it
    does not inherit the low bias of a minimum over rounded distances.  In
    ``'kernel_bf16'`` the sums carry bf16-rounded products, so the SSE is of
    that class too (the JAX package's ``_sse_from_stats`` says the same)."""

    def step(points, weights, centroids) -> StepStats:
        x2w = None
        if mode in KERNEL_MODES:
            x2w = _weighted_sqnorm_total(points, weights)
        return local_stats(points, weights, centroids,
                           chunk_size=chunk_size, mode=mode, x2w=x2w)

    return step


def make_predict_fn(*, chunk_size: int, mode: str = "matmul") -> Callable:
    """The label assignment: ``(points, centroids) -> labels`` int32 (n,).
    The kernel modes run the assignment-only kernel: the fused one would
    also scatter sums that nobody reads."""

    def predict(points, centroids) -> torch.Tensor:
        if mode in KERNEL_MODES:
            return hopper_assign(points, centroids,
                                 bf16=mode == "kernel_bf16")[0]
        if mode not in TORCH_MODES:
            raise ValueError(f"unknown distance mode: {mode!r}")
        return assign_labels(points, centroids, chunk_size=chunk_size,
                             mode=mode)

    return predict
