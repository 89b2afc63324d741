"""Fused K-Means assignment kernels for Hopper, and their plain versions.

Counterpart of ``kmeans_tpu/ops/pallas_kernels.py``.  The two entry points
launch the CUDA C++ kernels of ``csrc/assign_kernels.cu``:

* :func:`fused_assign_reduce` — one pass over the points: nearest centroid
  of every row, optional minimum squared distance, and the weighted
  per-cluster sums and counts.  The (n, k) distances never reach device
  memory.
* :func:`hopper_assign` — labels and minimum squared distance only.

Arithmetic, shared with the plain versions below:

* ``score = h - x @ c.T`` with ``h = 0.5 * ||c||^2``; the row-constant
  ``||x||^2``, the factor 2 and the clamp cannot change the argmin, so the
  squared distance is rebuilt per row afterwards:
  ``mind2 = max(2 * min(score) + ||x||^2, 0)``.
* The lowest index wins among equal minima.
* A row with a NaN score (a row holding NaN, or Inf against centroids of both
  signs) gets label 0; so does a row whose scores never drop below ``+inf``.
* Rows of weight 0 add nothing to sums or counts.
* float32 products and float32 accumulation.

The sums are deterministic: each persistent block adds into a table of its
own in a fixed order and a second kernel adds the tables in block order, so
two calls on the same inputs give the same bits.

A tensor on the CPU goes to the plain version.  A CUDA tensor launches the
kernel or raises: nothing here falls back.  ``LAUNCHES`` counts the kernel
launches, one per call that reached the card.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from kmeans_tpu_torch.ops import _build

#: Kernel launches so far, by kernel name: the package's one table
#: (``_build.LAUNCHES``), shared with the other kernel modules.
LAUNCHES: Dict[str, int] = _build.LAUNCHES
LAUNCHES.update(fused_assign_reduce=0, hopper_assign=0)
reset_launch_counts = _build.reset_launch_counts

_LIB_NAME = "assign_kernels"
_TILE_ROWS = 128                  # rows of a block's tile (BM in the source)
_BLOCKS_PER_SM = 2                # persistent blocks resident on each SM
#: Budget for the fused kernel's per-block tables; fewer blocks run when
#: blocks * k * (D + 1) floats would exceed it.
_PARTIAL_BUDGET_BYTES = 2 << 30
_REF_TILE_ELEMS = 1 << 24         # (rows, k) scores a plain version holds


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB_NAME)
    if not getattr(lib, "_kmeans_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kmeans_assign_launch.argtypes = [p, p, p, p, p, ll, i, i, i, p]
        lib.kmeans_assign_launch.restype = i
        lib.kmeans_fused_assign_reduce_launch.argtypes = [
            p, p, p, p, p, p, p, p, p, ll, i, i, i, p]
        lib.kmeans_fused_assign_reduce_launch.restype = i
        lib._kmeans_bound = True
    return lib


def _check(points: torch.Tensor, centroids: torch.Tensor,
           weights: Optional[torch.Tensor], bf16: bool,
           dtypes=(torch.float32,)) -> None:
    """Shapes, types, devices and layout the kernels take; raises on any
    other.  ``dtypes`` widens the type for a plain version."""
    if bf16:
        raise NotImplementedError(
            "bf16=True (bf16 products, float32 accumulation) is not ported "
            "yet: ROADMAP.md, B.3 'The bf16=True variant of kernels 1 and 2'")
    if points.ndim != 2 or centroids.ndim != 2:
        raise ValueError(
            f"points and centroids must be 2-D, got shapes "
            f"{tuple(points.shape)} and {tuple(centroids.shape)}")
    if points.shape[1] != centroids.shape[1]:
        raise ValueError(
            f"points width {points.shape[1]} != centroid width "
            f"{centroids.shape[1]}")
    if centroids.shape[0] < 1 or points.shape[1] < 1:
        raise ValueError("need at least one centroid and one feature")
    tensors = [("points", points), ("centroids", centroids)]
    if weights is not None:
        if weights.shape != (points.shape[0],):
            raise ValueError(
                f"weights must have shape ({points.shape[0]},), got "
                f"{tuple(weights.shape)}")
        tensors.append(("weights", weights))
    for name, t in tensors:
        if t.dtype not in dtypes or t.dtype != points.dtype:
            raise TypeError(
                f"{name} must be "
                f"{' or '.join(str(d).replace('torch.', '') for d in dtypes)}"
                f" like points, got {t.dtype}")
        if t.device != points.device:
            raise ValueError(
                f"{name} is on {t.device}, points on {points.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _blocks(device: torch.device, n: int, table_floats: int = 0) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = min(_BLOCKS_PER_SM * sms, -(-n // _TILE_ROWS))
    if table_floats:
        blocks = min(blocks, _PARTIAL_BUDGET_BYTES // (4 * table_floats))
    return max(1, blocks)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def _as_weights(weights: torch.Tensor) -> torch.Tensor:
    """(n, 1) weights, the JAX package's column layout, as (n,)."""
    if weights.ndim == 2 and weights.shape[1] == 1:
        return weights.reshape(-1)
    return weights


# ------------------------------------------------------------ plain versions


def _half_sqnorm(centroids: torch.Tensor) -> torch.Tensor:
    return 0.5 * (centroids * centroids).sum(dim=1)


def _assign_rows(x: torch.Tensor, centroids: torch.Tensor, h: torch.Tensor,
                 with_mind2: bool):
    """Labels and (optionally) mind2 of one block of rows, in torch ops."""
    k = centroids.shape[0]
    score = h[None, :] - x @ centroids.T                    # (rows, k)
    m = score.min(dim=1).values                             # NaN if any NaN
    ids = torch.arange(k, device=x.device, dtype=torch.int32)
    big = torch.tensor(2 ** 30, device=x.device, dtype=torch.int32)
    # Lowest index among the equal minima, made explicit.
    lowest = torch.where(score == m[:, None], ids[None, :], big).min(
        dim=1).values
    # The running pair starts at (+inf, 0) and moves only on a strict "<".
    ok = m < float("inf")
    labels = torch.where(ok, lowest, torch.zeros_like(lowest))
    if not with_mind2:
        return labels, None
    best = torch.where(ok, m, torch.full_like(m, float("inf")))
    raw = 2.0 * best + (x * x).sum(dim=1)
    mind2 = torch.where(raw < 0, torch.zeros_like(raw), raw)  # NaN stays NaN
    return labels, mind2


def _row_block(k: int) -> int:
    return max(_TILE_ROWS, _REF_TILE_ELEMS // max(k, 1))


def assign_reference(points: torch.Tensor, centroids: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`hopper_assign`: the same arithmetic in torch
    ops, in blocks of rows so that no (n, k) matrix is ever whole."""
    _check(points, centroids, None, False)
    n = points.shape[0]
    h = _half_sqnorm(centroids)
    labels = torch.empty(n, dtype=torch.int32, device=points.device)
    mind2 = torch.empty(n, dtype=torch.float32, device=points.device)
    step = _row_block(centroids.shape[0])
    for lo in range(0, n, step):
        lab, m2 = _assign_rows(points[lo:lo + step], centroids, h, True)
        labels[lo:lo + step] = lab
        mind2[lo:lo + step] = m2
    return labels, mind2


def fused_assign_reduce_reference(points: torch.Tensor,
                                  weights: torch.Tensor,
                                  centroids: torch.Tensor, *,
                                  with_mind2: bool = True):
    """Plain version of :func:`fused_assign_reduce`: ``(labels, mind2 or
    None, sums, counts)`` by torch ops; sums and counts by ``index_add_``."""
    weights = _as_weights(weights)
    _check(points, centroids, weights, False)
    n, d = points.shape
    k = centroids.shape[0]
    dev = points.device
    h = _half_sqnorm(centroids)
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    mind2 = torch.empty(n, dtype=torch.float32, device=dev) \
        if with_mind2 else None
    sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
    counts = torch.zeros((k,), dtype=torch.float32, device=dev)
    step = _row_block(k)
    for lo in range(0, n, step):
        x = points[lo:lo + step]
        w = weights[lo:lo + step]
        lab, m2 = _assign_rows(x, centroids, h, with_mind2)
        labels[lo:lo + step] = lab
        if with_mind2:
            mind2[lo:lo + step] = m2
        live = w != 0                           # zero-weight rows: inert
        wx = torch.where(live[:, None], w[:, None] * x, torch.zeros_like(x))
        idx = lab.to(torch.int64)
        sums.index_add_(0, idx, wx)
        counts.index_add_(0, idx, w)
    return labels, mind2, sums, counts


# ------------------------------------------------------------------ wrappers


def hopper_assign(points: torch.Tensor, centroids: torch.Tensor, *,
                  bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of the JAX package's ``pallas_assign``: ``(labels (n,)
    int32, mind2 (n,) float32)``, no weights and no accumulation.

    Launches ``assign_kernel`` on the current stream for CUDA tensors and
    does not synchronise; CPU tensors go to :func:`assign_reference`."""
    _check(points, centroids, None, bf16)
    if not points.is_cuda:
        return assign_reference(points, centroids)
    n, d = points.shape
    k = centroids.shape[0]
    dev = points.device
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    mind2 = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return labels, mind2
    lib = _lib()
    with torch.cuda.device(dev):
        h = torch.empty(k, dtype=torch.float32, device=dev)
        err = lib.kmeans_assign_launch(
            points.data_ptr(), centroids.data_ptr(), h.data_ptr(),
            labels.data_ptr(), mind2.data_ptr(), n, d, k, _blocks(dev, n),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "hopper_assign")
    LAUNCHES["hopper_assign"] += 1
    return labels, mind2


def fused_assign_reduce(points: torch.Tensor, weights: torch.Tensor,
                        centroids: torch.Tensor, *, bf16: bool = False,
                        with_mind2: bool = True):
    """``(labels (n,) int32, mind2 (n,) float32 or None, sums (k, D),
    counts (k,))`` in one pass over the points.

    ``with_mind2=False`` computes and writes no minimum distance at all and
    returns ``None`` in its place.  Launches ``fused_assign_reduce_kernel``
    and ``reduce_partials_kernel`` on the current stream for CUDA tensors
    and does not synchronise; CPU tensors go to
    :func:`fused_assign_reduce_reference`."""
    weights = _as_weights(weights)
    _check(points, centroids, weights, bf16)
    if not points.is_cuda:
        return fused_assign_reduce_reference(points, weights, centroids,
                                             with_mind2=with_mind2)
    n, d = points.shape
    k = centroids.shape[0]
    dev = points.device
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    mind2 = torch.empty(n, dtype=torch.float32, device=dev) \
        if with_mind2 else None
    if n == 0:
        return (labels, mind2,
                torch.zeros((k, d), dtype=torch.float32, device=dev),
                torch.zeros((k,), dtype=torch.float32, device=dev))
    lib = _lib()
    table = k * (d + 1)
    blocks = _blocks(dev, n, table)
    with torch.cuda.device(dev):
        h = torch.empty(k, dtype=torch.float32, device=dev)
        partial = torch.zeros(blocks * table, dtype=torch.float32, device=dev)
        sums = torch.empty((k, d), dtype=torch.float32, device=dev)
        counts = torch.empty((k,), dtype=torch.float32, device=dev)
        err = lib.kmeans_fused_assign_reduce_launch(
            points.data_ptr(), weights.data_ptr(), centroids.data_ptr(),
            h.data_ptr(), labels.data_ptr(),
            mind2.data_ptr() if with_mind2 else None,
            partial.data_ptr(), sums.data_ptr(), counts.data_ptr(),
            n, d, k, blocks, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "fused_assign_reduce")
    LAUNCHES["fused_assign_reduce"] += 1
    return labels, mind2, sums, counts
