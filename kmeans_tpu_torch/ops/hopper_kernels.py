"""Fused K-Means assignment kernels for Hopper, and their plain versions.

Counterpart of ``kmeans_tpu/ops/pallas_kernels.py``.  The two entry points
launch the CUDA C++ kernels of ``csrc/assign_kernels.cu`` (float32 products)
or, with ``bf16=True``, of ``csrc/assign_bf16.cu`` (bf16 products on the
tensor cores):

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
* float32 products and float32 accumulation; with ``bf16=True`` both
  products take bf16-rounded inputs (x and c for the distances, w and x for
  the sums: ``sums = sum bf16(w) bf16(x)``) and accumulate in float32,
  while ``h``, ``||x||^2`` and the counts (``sum w``) stay float32 from the
  unrounded inputs.  That is the JAX package's ``matmul_bf16`` rule, and
  its Pallas kernel's wherever D is a multiple of 128.

The sums are deterministic: each persistent block adds into a table of its
own in a fixed order and a second kernel adds the tables in block order, so
two calls on the same inputs give the same bits.

A tensor on the CPU goes to the plain version.  A CUDA tensor launches the
kernel or raises: nothing here falls back.  ``LAUNCHES`` counts the kernel
launches, one per call that reached the card, under the kernel's name
(``_bf16`` appended for the bf16 kernels); the variant lab
(``experiments/exp_pallas_kernel.py``) counts each of its builds under
``kernel_variant:<name>``, an entry it adds at the build's first launch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from kmeans_tpu_torch.ops import _build
from kmeans_tpu_torch.ops.assign import round_bf16

#: Kernel launches so far, by kernel name: the package's one table
#: (``_build.LAUNCHES``), shared with the other kernel modules.
LAUNCHES: Dict[str, int] = _build.LAUNCHES
LAUNCHES.update(fused_assign_reduce=0, hopper_assign=0,
                fused_assign_reduce_bf16=0, hopper_assign_bf16=0)
reset_launch_counts = _build.reset_launch_counts

#: The source of each kernel class, and its two C entry points (assignment,
#: fused pass).  Both take the same arguments.
LIB_NAMES = {False: "assign_kernels", True: "assign_bf16"}
_ENTRIES = {False: ("kmeans_assign_launch",
                    "kmeans_fused_assign_reduce_launch"),
            True: ("kmeans_assign_bf16_launch",
                   "kmeans_fused_assign_reduce_bf16_launch")}
_TILE_ROWS = 128                  # rows of a block's tile at the default
_BLOCKS_PER_SM = 2                # persistent blocks of 2 * 128 threads
#: Budget for the fused kernel's per-block tables; fewer blocks run when
#: blocks * k * (D + 1) floats would exceed it.
_PARTIAL_BUDGET_BYTES = 2 << 30
_REF_TILE_ELEMS = 1 << 24         # (rows, k) scores a plain version holds


def bind(lib: ctypes.CDLL, bf16: bool) -> ctypes.CDLL:
    """Argument types of a built library of either source."""
    if not getattr(lib, "_kmeans_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        assign, fused = (getattr(lib, name) for name in _ENTRIES[bf16])
        assign.argtypes = [p, p, p, p, p, ll, i, i, i, p]
        assign.restype = i
        fused.argtypes = [p, p, p, p, p, p, p, p, p, ll, i, i, i, p]
        fused.restype = i
        lib.kmeans_tile_rows.argtypes = []
        lib.kmeans_tile_rows.restype = i
        lib.kmeans_scratch_bytes.argtypes = [i, i]
        lib.kmeans_scratch_bytes.restype = ll
        lib._kmeans_bound = True
    return lib


def _lib(bf16: bool) -> ctypes.CDLL:
    return bind(_build.load(LIB_NAMES[bf16]), bf16)


def _check(points: torch.Tensor, centroids: torch.Tensor,
           weights: Optional[torch.Tensor],
           dtypes=(torch.float32,)) -> None:
    """Shapes, types, devices and layout the kernels take; raises on any
    other.  ``dtypes`` widens the type for a plain version."""
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


def _blocks(device: torch.device, n: int, table_floats: int = 0,
            tile_rows: int = _TILE_ROWS) -> int:
    """Persistent blocks of a launch: as many as fit on the card (blocks of
    ``2 * tile_rows`` threads, 512 threads on each SM), no more than there
    are row tiles, and within the per-block tables' budget."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = _BLOCKS_PER_SM * _TILE_ROWS // tile_rows
    blocks = min(per_sm * sms, -(-n // tile_rows))
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
                 with_mind2: bool, bf16: bool = False):
    """Labels and (optionally) mind2 of one block of rows, in torch ops."""
    k = centroids.shape[0]
    if bf16:
        xc = round_bf16(x, x.dtype) @ round_bf16(centroids, x.dtype).T
    else:
        xc = x @ centroids.T
    score = h[None, :] - xc                                 # (rows, k)
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


def assign_reference(points: torch.Tensor, centroids: torch.Tensor, *,
                     bf16: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`hopper_assign`: the same arithmetic in torch
    ops, in blocks of rows so that no (n, k) matrix is ever whole."""
    _check(points, centroids, None)
    n = points.shape[0]
    h = _half_sqnorm(centroids)
    labels = torch.empty(n, dtype=torch.int32, device=points.device)
    mind2 = torch.empty(n, dtype=torch.float32, device=points.device)
    step = _row_block(centroids.shape[0])
    for lo in range(0, n, step):
        lab, m2 = _assign_rows(points[lo:lo + step], centroids, h, True,
                               bf16)
        labels[lo:lo + step] = lab
        mind2[lo:lo + step] = m2
    return labels, mind2


def fused_assign_reduce_reference(points: torch.Tensor,
                                  weights: torch.Tensor,
                                  centroids: torch.Tensor, *,
                                  bf16: bool = False,
                                  with_mind2: bool = True):
    """Plain version of :func:`fused_assign_reduce`: ``(labels, mind2 or
    None, sums, counts)`` by torch ops; sums and counts by ``index_add_``."""
    weights = _as_weights(weights)
    _check(points, centroids, weights)
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
        lab, m2 = _assign_rows(x, centroids, h, with_mind2, bf16)
        labels[lo:lo + step] = lab
        if with_mind2:
            mind2[lo:lo + step] = m2
        live = w != 0                           # zero-weight rows: inert
        if bf16:
            wx = round_bf16(w, w.dtype)[:, None] * round_bf16(x, x.dtype)
        else:
            wx = w[:, None] * x
        wx = torch.where(live[:, None], wx, torch.zeros_like(x))
        idx = lab.to(torch.int64)
        sums.index_add_(0, idx, wx)
        counts.index_add_(0, idx, w)
    return labels, mind2, sums, counts


# ------------------------------------------------------------------ launches


def _scratch(lib: ctypes.CDLL, d: int, k: int, dev) -> torch.Tensor:
    """The kernels' scratch (h, and the bf16 kernels' rounded centroids)."""
    nbytes = lib.kmeans_scratch_bytes(d, k)
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def launch_assign(lib: ctypes.CDLL, bf16: bool, points: torch.Tensor,
                  centroids: torch.Tensor, counter: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the assignment kernel of ``lib`` (a built library of
    the ``bf16`` source) on CUDA tensors that :func:`_check` accepted;
    adds one to ``LAUNCHES[counter]``."""
    n, d = points.shape
    k = centroids.shape[0]
    dev = points.device
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    mind2 = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return labels, mind2
    entry = getattr(lib, _ENTRIES[bf16][0])
    rows = lib.kmeans_tile_rows()
    with torch.cuda.device(dev):
        scratch = _scratch(lib, d, k, dev)
        err = entry(points.data_ptr(), centroids.data_ptr(),
                    scratch.data_ptr(), labels.data_ptr(), mind2.data_ptr(),
                    n, d, k, _blocks(dev, n, tile_rows=rows),
                    torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, counter)
    LAUNCHES[counter] += 1
    return labels, mind2


def launch_fused(lib: ctypes.CDLL, bf16: bool, points: torch.Tensor,
                 weights: torch.Tensor, centroids: torch.Tensor, counter: str,
                 with_mind2: bool = True):
    """One launch of the fused pass of ``lib`` (two kernels: the pass and
    the sum of the blocks' tables), as :func:`launch_assign`."""
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
    entry = getattr(lib, _ENTRIES[bf16][1])
    table = k * (d + 1)
    blocks = _blocks(dev, n, table, lib.kmeans_tile_rows())
    with torch.cuda.device(dev):
        scratch = _scratch(lib, d, k, dev)
        partial = torch.zeros(blocks * table, dtype=torch.float32, device=dev)
        sums = torch.empty((k, d), dtype=torch.float32, device=dev)
        counts = torch.empty((k,), dtype=torch.float32, device=dev)
        err = entry(points.data_ptr(), weights.data_ptr(),
                    centroids.data_ptr(), scratch.data_ptr(),
                    labels.data_ptr(),
                    mind2.data_ptr() if with_mind2 else None,
                    partial.data_ptr(), sums.data_ptr(), counts.data_ptr(),
                    n, d, k, blocks,
                    torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, counter)
    LAUNCHES[counter] += 1
    return labels, mind2, sums, counts


# ------------------------------------------------------------------ wrappers


def hopper_assign(points: torch.Tensor, centroids: torch.Tensor, *,
                  bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of the JAX package's ``pallas_assign``: ``(labels (n,)
    int32, mind2 (n,) float32)``, no weights and no accumulation.

    Launches ``assign_kernel`` (``assign_bf16_kernel`` with ``bf16``) on
    the current stream for CUDA tensors and does not synchronise; CPU
    tensors go to :func:`assign_reference`."""
    _check(points, centroids, None)
    if not points.is_cuda:
        return assign_reference(points, centroids, bf16=bf16)
    return launch_assign(_lib(bf16), bf16, points, centroids,
                         "hopper_assign_bf16" if bf16 else "hopper_assign")


def fused_assign_reduce(points: torch.Tensor, weights: torch.Tensor,
                        centroids: torch.Tensor, *, bf16: bool = False,
                        with_mind2: bool = True):
    """``(labels (n,) int32, mind2 (n,) float32 or None, sums (k, D),
    counts (k,))`` in one pass over the points.

    ``with_mind2=False`` computes and writes no minimum distance at all and
    returns ``None`` in its place.  Launches ``fused_assign_reduce_kernel``
    (``fused_assign_reduce_bf16_kernel`` with ``bf16``) and
    ``reduce_partials_kernel`` on the current stream for CUDA tensors and
    does not synchronise; CPU tensors go to
    :func:`fused_assign_reduce_reference`."""
    weights = _as_weights(weights)
    _check(points, centroids, weights)
    if not points.is_cuda:
        return fused_assign_reduce_reference(points, weights, centroids,
                                             bf16=bf16,
                                             with_mind2=with_mind2)
    return launch_fused(
        _lib(bf16), bf16, points, weights, centroids,
        "fused_assign_reduce_bf16" if bf16 else "fused_assign_reduce",
        with_mind2)
