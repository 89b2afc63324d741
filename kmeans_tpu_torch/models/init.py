"""Centroid initialisation: Forgy and k-means++.

Counterpart of ``kmeans_tpu/models/init.py`` (``forgy_init``,
``kmeanspp_init``, ``_weighted_kmeanspp_host``, ``resolve_init``).  Every
random draw happens on the host with the same NumPy generators as the JAX
package (``np.random.RandomState(seed)`` for Forgy,
``np.random.default_rng(seed)`` for k-means++), so the same seed gives the
same initial centroids in both packages whenever the data has a host copy.

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
    """Weighted D^2 seeding; the categorical draws are host-side.

    ``X`` is the host array, or None when only the device tensor ``points``
    exists.  The distance maintenance runs in float64 NumPy for small host
    arrays and in torch on ``points`` otherwise; each draw then pulls the
    (n,) distance vector to the host."""
    n = w.shape[0]
    if int((w > 0).sum()) < k:
        raise ValueError(
            f"Not enough data points ({int((w > 0).sum())}) to initialize "
            f"{k} clusters")
    on_host = X is not None and (points is None
                                 or X.size <= _HOST_KMEANSPP_ELEMS)

    def row(i):
        return X[i] if X is not None else points[int(i)].cpu().numpy()

    d = X.shape[1] if X is not None else points.shape[1]
    dtype = X.dtype if X is not None else row(0).dtype
    centers = np.empty((k, d), dtype=dtype)
    centers[0] = row(rng.choice(n, p=w / w.sum()))  # first draw ~ weights
    if on_host:
        x = X.astype(np.float64, copy=False)
        mind2 = np.full((n,), np.inf)
    else:
        mind2 = torch.full((n,), float("inf"), dtype=points.dtype,
                           device=points.device)
    for i in range(1, k):
        if on_host:
            diff = x - centers[i - 1].astype(np.float64)
            mind2 = np.minimum(mind2, (diff * diff).sum(axis=1))
            p = w * np.maximum(mind2, 0.0)
        else:
            c = torch.as_tensor(centers[i - 1], device=points.device)
            diff = points - c[None, :]
            mind2 = torch.minimum(mind2, (diff * diff).sum(dim=1))
            p = w * np.maximum(mind2.cpu().numpy().astype(np.float64), 0.0)
        total = p.sum()
        if not np.isfinite(total) or total <= 0:
            idx = rng.choice(n, p=w / w.sum())  # degenerate: coincident pts
        else:
            idx = rng.choice(n, p=p / total)
        centers[i] = row(idx)
    return centers


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
    return _weighted_kmeanspp_host(host, w, k, np.random.default_rng(seed),
                                   points=points)


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
