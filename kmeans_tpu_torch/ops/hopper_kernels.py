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
* float32-accurate products (on the card, three TF32 tensor-core products
  per product, 3xTF32) and float32 accumulation; with ``bf16=True`` both
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
_BLOCKS_PER_SM = 2                # persistent blocks of a 128-row tile
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
        if bf16:
            lib.kmeans_blocks_per_sm.argtypes = [i]
            lib.kmeans_blocks_per_sm.restype = i
            lib.kmeans_tile_centroids.argtypes = []
            lib.kmeans_tile_centroids.restype = i
            lib.kmeans_prep_centroids_bf16.argtypes = [p, p, i, i, p]
            lib.kmeans_prep_centroids_bf16.restype = i
            lib._per_sm = {}
        lib._kmeans_bound = True
    return lib


def mode_library(mode: str) -> Optional[str]:
    """The library that a K-Means distance mode launches: kernels 1 and 2
    ('kernel') are one source, 1b and 2b ('kernel_bf16') the other; None
    for the torch modes."""
    if mode in ("kernel", "kernel_bf16"):
        return LIB_NAMES[mode == "kernel_bf16"]
    return None


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


def _blocks(device: torch.device, n: int, table_floats: int,
            tile_rows: int, per_sm: int) -> int:
    """Persistent blocks of a launch: ``per_sm`` on each SM (the float32
    kernels: two of 128 threads at up to 255 registers; the bf16 kernels:
    what their library reports, :func:`_per_sm`), no more than
    there are row tiles, and within the per-block tables' budget."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = min(per_sm * sms, -(-n // tile_rows))
    if table_floats:
        blocks = min(blocks, _PARTIAL_BUDGET_BYTES // (4 * table_floats))
    return max(1, blocks)


def _per_sm(lib: ctypes.CDLL, bf16: bool, d: int) -> int:
    """Persistent blocks on each SM: two for the float32 kernels; for the
    bf16 ones what their library reports at width ``d`` (their shared
    memory depends on it), raising where none fits."""
    if not bf16:
        return _BLOCKS_PER_SM
    per_sm = lib._per_sm.get(d)
    if per_sm is None:
        per_sm = lib._per_sm[d] = lib.kmeans_blocks_per_sm(d)
    if per_sm < 1:
        raise RuntimeError(f"the bf16 kernels fit no block on an SM at "
                           f"D = {d}")
    return per_sm


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


# The layout of bf16(c) in the bf16 kernels' scratch, as
# prep_centroids_kernel writes it (csrc/assign_bf16.cu): after h (k floats,
# padded to 16 bytes), ceil(k / tile_k) tile images of tile_k centroid rows;
# an image holds ceil(D / 64) chunks of 64 features one after the other, a
# chunk holds its tile_k rows at 128 bytes each, and the 16-byte unit u
# (features 8u .. 8u + 7 of the chunk) of row r sits at unit u ^ (r % 8) of
# the row.  Zero past k and past D.


def tile_image_index(k: int, d: int, tile_k: int) -> torch.Tensor:
    """Position, among the bf16 elements of the tile images, of each entry
    of bf16(c) zero-padded to (ceil(k / tile_k) * tile_k, ceil(D / 64) * 64):
    an int64 tensor of that shape."""
    tiles, chunks = -(-k // tile_k), -(-d // 64)
    row = torch.arange(tiles * tile_k)[:, None]
    col = torch.arange(chunks * 64)[None, :]
    tile, r = row // tile_k, row % tile_k
    chunk, unit, e = col // 64, (col % 64) // 8, col % 8
    byte = (tile * tile_k * chunks * 128 + chunk * tile_k * 128 + r * 128
            + (unit ^ (r % 8)) * 16 + e * 2)
    return byte // 2


def tile_images(centroids: torch.Tensor, tile_k: int) -> torch.Tensor:
    """bf16(c) laid out as the tile images (flat, bf16)."""
    k, d = centroids.shape
    index = tile_image_index(k, d, tile_k).to(centroids.device)
    padded = torch.zeros(index.shape, dtype=torch.bfloat16,
                         device=centroids.device)
    padded[:k, :d] = centroids.to(torch.bfloat16)
    out = torch.empty(index.numel(), dtype=torch.bfloat16,
                      device=centroids.device)
    out[index.reshape(-1)] = padded.reshape(-1)
    return out


def read_tile_images(images: torch.Tensor, k: int, d: int,
                     tile_k: int) -> torch.Tensor:
    """The zero-padded bf16(c) back from its tile images (flat, bf16)."""
    return images[tile_image_index(k, d, tile_k).to(images.device)]


def split_bf16_scratch(scratch: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, tile images) of the bf16 kernels' scratch (uint8)."""
    h_bytes = (4 * k + 15) // 16 * 16
    return (scratch[:4 * k].view(torch.float32),
            scratch[h_bytes:].view(torch.bfloat16))


def declared_operations(kind: str, n: int, d: int, k: int
                        ) -> Tuple[int, int]:
    """``(product, total)``: the operations one launch of a hand kernel does
    on n rows of width D against k centroids (components), counted once
    here for the cost records (``obs.cost``) and the bounds of
    ``chip_smoke.py``.  ``kind``:

    * ``'assign'`` (kernels 2, 2b): the 2 n k D product, ``h - x.c``
      (n k), ``||x||^2`` (2 n D) and ``h`` (2 k D);
    * ``'fused'`` (kernels 1, 1b): those, and the scatter of the weighted
      rows and their weights (2 n D + n);
    * ``'estep'`` (``diag_estep``): the two depth-2D products (8 n k D),
      the softmax (max, subtract, exp, scale, sum: 5 n k), and the
      centering and squares (2 n D);
    * ``'estep_rows'`` (``diag_estep_rows``, launch (a) of a model axis,
      k the block's components): the logp product (4 n k D), the row max
      and sum (max, subtract, exp, sum: 4 n k), the centering and squares;
    * ``'estep_moments'`` (``diag_estep_moments``, launch (b)): the logp
      product again and the moment product (8 n k D), the softmax from the
      given max and sum (subtract, exp, scale, sum: 4 n k), the centering
      and squares.

    ``product`` is the part that runs on the tensor cores."""
    if kind == "estep":
        product = 8 * n * k * d
        return product, product + 5 * n * k + 2 * n * d
    if kind in ("estep_rows", "estep_moments"):
        product = (4 if kind == "estep_rows" else 8) * n * k * d
        return product, product + 4 * n * k + 2 * n * d
    if kind not in ("assign", "fused"):
        raise ValueError(f"unknown kernel kind {kind!r}")
    product = 2 * n * k * d
    total = product + n * k + 2 * n * d + 2 * k * d
    if kind == "fused":
        total += 2 * n * d + n
    return product, total


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
                    n, d, k, _blocks(dev, n, 0, rows, _per_sm(lib, bf16, d)),
                    torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, counter)
    _build.count_launch(counter,
                        ops=declared_operations("assign", n, d, k)[1])
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
    blocks = _blocks(dev, n, table, lib.kmeans_tile_rows(),
                     _per_sm(lib, bf16, d))
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
    _build.count_launch(counter,
                        ops=declared_operations("fused", n, d, k)[1])
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
