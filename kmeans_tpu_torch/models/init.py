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
the same rows.

All entry points accept a host ``(n, D)`` array or a
``parallel.sharding.Dataset`` (row access through ``.take``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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
            c = torch.as_tensor(row(idx[i - 1]), device=points.device)
            diff = points - c[None, :]
            mind2 = torch.minimum(mind2, (diff * diff).sum(dim=1))
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
        c = points.index_select(0, idx[i - 1:i])[0]
        diff = points - c[None, :]
        mind2 = torch.minimum(mind2, (diff * diff).sum(dim=1))
        p = w * torch.clamp_min(mind2.to(torch.float64), 0.0)
        total = p.sum()
        usable = torch.isfinite(total) & (total > 0)
        by_d2 = torch.searchsorted(_cdf(p), u[i:i + 1], right=True)[0]
        by_w = torch.searchsorted(cdf_w, u[i:i + 1], right=True)[0]
        # A non-finite CDF may search past the end; that draw is not taken.
        idx[i] = torch.where(usable, torch.minimum(by_d2, last), by_w)
    return idx


def kmeanspp_init(X, k: int, seed: int, *, validate: bool = True
                  ) -> np.ndarray:
    """k-means++ seeding (D^2 weighting, scaled by the sample weights).

    ``validate=False`` skips the full-array finite scan, for callers that
    already validated the data."""
    src = as_source(X)
    host = getattr(src, "host", None)
    points = getattr(src, "points", None)
    if host is not None:
        sw = getattr(src, "host_weights", None)
        w = (np.ones(host.shape[0]) if sw is None
             else np.asarray(sw, dtype=np.float64))
        # Full scan, not just the chosen rows: a NaN anywhere poisons the
        # D^2 weights.
        if validate:
            check_finite_array(host, "Data contains NaN or Inf values")
    else:
        w = src.weights.cpu().numpy().astype(np.float64)
        if validate and not bool(torch.isfinite(points).all()):
            raise ValueError("Data contains NaN or Inf values")
    rng = np.random.default_rng(seed)
    if points is not None and (host is None
                               or host.size > _HOST_KMEANSPP_ELEMS):
        return _weighted_kmeanspp_device(points, src.weights, k, rng)
    return _weighted_kmeanspp_host(host, w, k, rng, points=points)


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
