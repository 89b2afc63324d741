"""Centroid initialisation: Forgy and k-means++.

Counterpart of ``kmeans_tpu/models/init.py`` (``forgy_init``,
``kmeanspp_init``, ``_weighted_kmeanspp_host``, ``resolve_init``).  Every
random draw happens on the host with the same NumPy generators as the JAX
package (``np.random.RandomState(seed)`` for Forgy,
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

All entry points accept a host ``(n, D)`` array or a
``parallel.sharding.Dataset`` (row access through ``.take``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kmeans_tpu_torch.parallel import mesh as _mesh
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


INITIALIZERS = {"forgy": forgy_init, "random": forgy_init,
                "k-means++": kmeanspp_init, "kmeans++": kmeanspp_init}

_LATER_INITIALIZERS = ("k-means||", "kmeans||")


def resolve_init(init, X, k: int, seed: int, *,
                 validate: bool = True) -> np.ndarray:
    """Dispatch: strategy name, callable ``init(X, k, seed)``, or an
    explicit (k, D) array."""
    src = as_source(X)
    dtype = np.dtype(str(src.dtype))
    if callable(init):
        host = getattr(src, "host", None)
        return np.asarray(init(host if host is not None else src, k, seed),
                          dtype=dtype)
    if isinstance(init, str):
        if init in _LATER_INITIALIZERS:
            raise NotImplementedError(
                f"init={init!r} is not ported yet: ROADMAP.md, A.5 "
                f"'Batched restarts and k-means|| seeding'")
        try:
            fn = INITIALIZERS[init]
        except KeyError:
            raise ValueError(f"unknown init strategy: {init!r}; "
                             f"options: {sorted(INITIALIZERS)}") from None
        return np.asarray(fn(src, k, seed, validate=validate), dtype=dtype)
    arr = np.asarray(init, dtype=dtype)
    if arr.shape != (k, src.d):
        raise ValueError(f"explicit init must have shape ({k}, "
                         f"{src.d}), got {arr.shape}")
    check_finite_array(arr, "Data contains NaN or Inf values")
    return arr
