"""Spherical K-Means: clustering by cosine similarity.

Counterpart of ``kmeans_tpu/models/spherical.py``, for embeddings such as
word vectors (GloVe-class data), where the direction of a row matters and
its length does not.  For unit rows the squared Euclidean distance is
``2 - 2 cos``, so the nearest centroid by the K-Means kernels is the most
similar one by cosine; the model is :class:`KMeans` with two projections:

* the rows are divided by their norms once, in float64, when the data is
  placed on the device (``cache``), and block by block in every stream
  (``fit_stream`` and the inference streams); a row of norm 0 stays at
  the origin;
* after every mean update each centroid is put back on the unit sphere (the
  mean direction), in ``_postprocess_centroids`` on the host loop and in
  ``parallel.distributed.project_centroids`` on the device loop.

Everything else is the base model's: the kernels (1, 1b, 2, 2b), the
empty-cluster policies, restarts, the mesh, checkpoints and ``sweep``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kmeans_tpu_torch.models.kmeans import KMeans, _host_rows, _later
from kmeans_tpu_torch.parallel import distributed as dist
from kmeans_tpu_torch.parallel.sharding import Dataset


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    """Rows divided by their norms (float64); a zero row stays zero."""
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(norms, np.finfo(np.float64).tiny)


def _normalize_tensor(x: torch.Tensor) -> torch.Tensor:
    """:func:`_normalize_rows` of a tensor, on its device, in float64."""
    x = x.to(torch.float64)
    norms = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp_min(norms, torch.finfo(torch.float64).tiny)


class SphericalKMeans(KMeans):
    """K-Means on the unit sphere (cosine-similarity clustering).

    The constructor of :class:`KMeans`, ``host_loop`` included: the sphere
    projection has a device form, so ``host_loop=False`` (and ``n_init``
    restarts and ``sweep`` in one device loop) run it on the device.

    * ``fit``, ``predict``, ``score`` and ``transform`` normalise their
      rows, so raw vectors may be passed; a :class:`Dataset` must come from
      this model's ``cache`` (any other raises ``ValueError``).
    * ``centroids`` are unit vectors (mean directions).
    * ``sse_history``, ``inertia_`` and ``score`` are sums of ``w (2 - 2
      cos)``, the squared chordal distance.
    * ``transform`` gives chordal distances; cosine is ``1 - d**2 / 2``.
    """

    _device_project = "sphere"

    def __init__(self, k: int = 3, max_iter: int = 100,
                 tolerance: float = 1e-4, seed: int = 42,
                 compute_sse: bool = False, **kwargs):
        super().__init__(k=k, max_iter=max_iter, tolerance=tolerance,
                         seed=seed, compute_sse=compute_sse, **kwargs)

    def cache(self, X, sample_weight=None) -> Dataset:
        """Place the L2-normalised rows on the device (rows of norm 0 stay
        at the origin) and mark the dataset as unit rows."""
        if isinstance(X, Dataset):
            if not getattr(X, "_unit_rows", False):
                raise ValueError(
                    "SphericalKMeans requires row-normalized data: cache it "
                    "with SphericalKMeans.cache(X) (or pass the raw array) "
                    "instead of a Dataset built elsewhere")
            return super().cache(X, sample_weight)
        if isinstance(X, torch.Tensor) and X.device == self.device:
            if X.ndim != 2:
                raise ValueError(f"X must be 2-D (n, D), got shape "
                                 f"{tuple(X.shape)}")
            rows = _normalize_tensor(X)        # the dtype: by to_device
        else:
            rows = _normalize_rows(_host_rows(X, np.float64)).astype(
                self.dtype)
        ds = super().cache(rows, sample_weight)
        ds._unit_rows = True
        return ds

    def _postprocess_centroids(self, centroids: np.ndarray,
                               prev: Optional[np.ndarray] = None
                               ) -> np.ndarray:
        """The spherical Lloyd step: each centroid becomes its mean
        direction; a mean of norm 0 keeps the previous centroid (at init,
        ``prev`` None, the row itself).

        It runs :func:`parallel.distributed.project_centroids` on the
        model's device, on the means rounded to the model's dtype: the
        device loop's arithmetic, so both loops give the same bits."""
        c = torch.from_numpy(np.ascontiguousarray(
            np.asarray(centroids, self.dtype))).to(self.device)
        p = c if prev is None else torch.from_numpy(np.ascontiguousarray(
            np.asarray(prev, self.dtype))).to(self.device)
        return dist._host_copy(dist.project_centroids(c, p,
                                                      project="sphere"))

    # The device form of the hook above (``_device_project``); a subclass
    # that overrides the hook loses the tag and runs on the host loop.
    _postprocess_centroids._device_equivalent = "sphere"

    def _sweep_metric_rows(self, X) -> np.ndarray:
        """The metric criteria score the normalised rows, the geometry the
        sweep's labels were assigned in."""
        return np.ascontiguousarray(_normalize_rows(
            _host_rows(X, np.float64)).astype(self.dtype))

    # ------------------------------------------------------------ streaming
    # The streams take raw host blocks that never pass through ``cache``:
    # wrap them, so that a row's length cannot break the cosine geometry.

    def _normalized_blocks(self, make_blocks):
        """``make_blocks`` with every block's rows normalised (in float64,
        then the model's dtype); a pair's weights pass through."""
        def wrapped():
            for item in make_blocks():
                if isinstance(item, tuple):      # (block, weights)
                    b, w = item
                    yield (_normalize_rows(_host_rows(b, np.float64))
                           .astype(self.dtype), w)
                else:
                    yield _normalize_rows(_host_rows(
                        item, np.float64)).astype(self.dtype)
        return wrapped

    def fit_stream(self, make_blocks, *, d=None, resume=False,
                   prefetch: int = 2, checkpoint_every: int = 0,
                   checkpoint_path=None, io_retries: int = 0,
                   io_backoff: float = 0.05,
                   on_nonfinite: str = "error") -> "SphericalKMeans":
        """``KMeans.fit_stream`` on the normalised rows.  The retries and
        the non-finite scan wrap the normalisation, so a replayed read is
        normalised again and the scan sees what the fit consumes."""
        return super().fit_stream(self._normalized_blocks(make_blocks),
                                  d=d, resume=resume, prefetch=prefetch,
                                  checkpoint_every=checkpoint_every,
                                  checkpoint_path=checkpoint_path,
                                  io_retries=io_retries,
                                  io_backoff=io_backoff,
                                  on_nonfinite=on_nonfinite)

    def _iter_stream_blocks(self, make_blocks, *, with_weights: bool,
                            prefetch: int = 0, stage_extra=None):
        """The one choke point of every inference stream (predict,
        transform, score all read normalised rows through it); with
        ``prefetch > 0`` the normalisation runs in the producer thread."""
        return super()._iter_stream_blocks(
            self._normalized_blocks(make_blocks), with_weights=with_weights,
            prefetch=prefetch, stage_extra=stage_extra)

    def _quality_rows(self, X):
        raise _later("_quality_rows", "...", "A.13 'Observability'")
