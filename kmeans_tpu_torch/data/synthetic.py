"""Synthetic data: blobs on the host or made directly on the device,
standard-normal and uniform points (``make_gaussian``, ``make_uniform``,
the JAX package's), and datasets generated on the device row by row
(:func:`device_shards`, with its host oracle :func:`host_equivalent`).

Counterpart of ``kmeans_tpu/data/synthetic.py``.  There each row is drawn
with threefry under ``fold_in(seed, row)``; here each value is a
counter-based integer hash of ``(seed, global row, column, draw)``
(MurmurHash3's finaliser, ``parallel.distributed._fmix32``) turned into
float values by exactly rounded operations only (integer to float, product
by a power of two, sums, one product and one sum for the range): so the
same seed gives the same bits on the CPU and on the card, on every mesh,
and :func:`host_equivalent` is the bit-exact oracle of
:func:`device_shards`.  The values are not the JAX package's (ROADMAP.md,
"Differences by design"); they agree with them in distribution.

* 'uniform': ``low + (high - low) * u``, ``u`` a multiple of 2^-24 in
  [0, 1).
* 'normal': the sum of 12 such uniforms minus 6 (mean 0, variance 1; the
  classic approximation, bounded by 6 in absolute value).
* 'blobs': ``centers[row % k]`` plus a 'normal' row.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from kmeans_tpu_torch.obs import metrics_registry as _obs_metrics
from kmeans_tpu_torch.obs import trace as _obs_trace

#: Distributions of :func:`device_shards` and :func:`host_equivalent`.
SYNTH_KINDS = ("normal", "uniform", "blobs")
#: Uniforms summed per 'normal' value.
NORMAL_DRAWS = 12
#: Values generated per slice of rows (bounds the int64 temporaries).
_GEN_ELEMS = 1 << 24


def make_blobs(n_samples: int, centers: int, n_features: int, *,
               cluster_std: float = 1.0, center_box=(-10.0, 10.0),
               random_state: int = 0, dtype=np.float32
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Isotropic Gaussian blobs on the host: ``(X (n, D), y (n,))``."""
    rng = np.random.default_rng(random_state)
    means = rng.uniform(center_box[0], center_box[1],
                        size=(centers, n_features))
    y = rng.integers(0, centers, size=n_samples)
    X = means[y] + cluster_std * rng.standard_normal((n_samples, n_features))
    return X.astype(dtype), y.astype(np.int32)


def make_blobs_device(n_samples: int, centers: int, n_features: int, *,
                      device, cluster_std: float = 1.0,
                      center_box=(-10.0, 10.0), seed: int = 0,
                      dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same blobs made on ``device`` from a seeded ``torch.Generator``,
    with no host copy and no upload: ``(X (n, D), y (n,))`` as tensors."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    lo, hi = center_box
    means = lo + (hi - lo) * torch.rand((centers, n_features), generator=gen,
                                        device=device, dtype=dtype)
    y = torch.randint(0, centers, (n_samples,), generator=gen, device=device)
    X = torch.randn((n_samples, n_features), generator=gen, device=device,
                    dtype=dtype)
    X.mul_(cluster_std).add_(means[y])
    return X, y.to(torch.int32)


def make_gaussian(n_samples: int, n_features: int, random_state: int = 0,
                  dtype=np.float32) -> np.ndarray:
    """Standard-normal points (n, D) on the host, the JAX package's
    ``make_gaussian``: ``np.random.RandomState(random_state).randn``."""
    rng = np.random.RandomState(random_state)
    return rng.randn(n_samples, n_features).astype(dtype)


def make_uniform(n_samples: int, n_features: int, low: float = -1.0,
                 high: float = 1.0, random_state: int = 0,
                 dtype=np.float32) -> np.ndarray:
    """A uniform cloud on the host, the JAX package's ``make_uniform``:
    ``np.random.default_rng(random_state).uniform``."""
    rng = np.random.default_rng(random_state)
    return rng.uniform(low, high,
                       size=(n_samples, n_features)).astype(dtype)


def _centers_arg(kind: str, centers, d: int, dtype):
    """(centers or None, k), validated as the JAX package does."""
    if kind not in SYNTH_KINDS:
        raise ValueError(f"kind must be one of {SYNTH_KINDS}, got {kind!r}")
    if kind != "blobs":
        return None, 1
    if centers is None:
        raise ValueError("kind='blobs' requires an explicit (k, d) "
                         "centers array")
    if isinstance(centers, torch.Tensor):         # placed by the caller
        if centers.dim() != 2 or centers.shape[1] != d:
            raise ValueError(f"centers must be (k, {d}), got "
                             f"{tuple(centers.shape)}")
        return centers, centers.shape[0]
    centers = np.ascontiguousarray(np.asarray(centers, dtype=dtype))
    if centers.ndim != 2 or centers.shape[1] != d:
        raise ValueError(f"centers must be (k, {d}), got {centers.shape}")
    return centers, centers.shape[0]


def _keys(seed: int) -> Tuple[int, int]:
    """Two 32-bit words of the generator's key, from ``seed``."""
    words = np.random.SeedSequence([int(seed), 0x5359]).generate_state(2)
    return int(words[0]), int(words[1])


def _uniforms(row_words: torch.Tensor, col_words: torch.Tensor,
              tdtype: torch.dtype) -> torch.Tensor:
    """(m, d) multiples of 2^-24 in [0, 1): the hash of each row's word and
    each column's word."""
    from kmeans_tpu_torch.parallel.distributed import _fmix32
    h = _fmix32(row_words[:, None] ^ col_words[None, :])
    return (h >> 8).to(tdtype) * (2.0 ** -24)


def generate_rows(start: int, rows: int, n: int, d: int, *, kind: str,
                  seed: int, dtype, low: float = -1.0, high: float = 1.0,
                  centers: Optional[np.ndarray] = None,
                  device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Global rows ``[start, start + rows)`` of the synthetic dataset on
    ``device``: ``(points (rows, d), weights (rows,))``.  Each value depends
    only on ``(seed, row, column)``; rows at or past ``n`` are zero points
    of weight 0 (the padding of a mesh's last block).  ``centers`` ('blobs')
    is the (k, d) host array, placed here under a ``stage`` span, or that
    array already on ``device`` (:func:`device_shards` places it under its
    own)."""
    from kmeans_tpu_torch.parallel.distributed import _fmix32
    from kmeans_tpu_torch.parallel.sharding import torch_dtype
    dtype = np.dtype(dtype)
    tdtype = torch_dtype(dtype)
    device = torch.device(device)
    cents, k = _centers_arg(kind, centers, d, dtype)
    if start + rows > 2 ** 31:
        raise ValueError("device_shards draws up to 2^31 rows")
    k_row, k_col = _keys(seed)
    draws = 1 if kind == "uniform" else NORMAL_DRAWS
    cols = torch.arange(d * draws, dtype=torch.int64, device=device)
    col_words = _fmix32(cols ^ k_col).reshape(draws, d)
    cents_t = cents
    if isinstance(cents, np.ndarray):
        with _obs_trace.span("stage", rows=k, bytes=int(cents.nbytes)):
            cents_t = torch.from_numpy(cents).to(device)
    points = torch.empty((rows, d), dtype=tdtype, device=device)
    step = max(1, _GEN_ELEMS // max(d, 1))
    for lo in range(0, rows, step):
        hi = min(lo + step, rows)
        idx = torch.arange(start + lo, start + hi, dtype=torch.int64,
                           device=device)
        row_words = _fmix32(idx ^ k_row)
        if kind == "uniform":
            u = _uniforms(row_words, col_words[0], tdtype)
            x = u * (high - low) + low
        else:
            x = _uniforms(row_words, col_words[0], tdtype)
            for t in range(1, draws):
                x = x + _uniforms(row_words, col_words[t], tdtype)
            x = x - float(draws) / 2.0
            if kind == "blobs":
                x = cents_t.index_select(0, idx % k) + x
        real = (idx < n)[:, None]
        points[lo:hi] = torch.where(real, x, torch.zeros_like(x))
    idx = torch.arange(start, start + rows, dtype=torch.int64, device=device)
    weights = (idx < n).to(tdtype)
    return points, weights


def host_equivalent(n_samples: int, n_features: int, *,
                    kind: str = "normal", seed: int = 0, dtype=np.float32,
                    low: float = -1.0, high: float = 1.0,
                    centers: Optional[np.ndarray] = None) -> np.ndarray:
    """The host oracle of :func:`device_shards`: the same rows, made on the
    CPU as one (n, d) array, bit for bit those of every mesh's blocks."""
    x, _ = generate_rows(0, int(n_samples), int(n_samples), int(n_features),
                         kind=kind, seed=seed, dtype=dtype, low=low,
                         high=high, centers=centers, device="cpu")
    return x.numpy()


def device_shards(n_samples: int, n_features: int, *, mesh=None,
                  kind: str = "normal", seed: int = 0, dtype=np.float32,
                  chunk_size: Optional[int] = None, k_hint: int = 16,
                  min_rows: int = 0, low: float = -1.0, high: float = 1.0,
                  centers: Optional[np.ndarray] = None, device=None):
    """An (n, d) synthetic dataset made on the device, with no host copy
    and no upload: a ``Dataset`` on one device, or under a ``mesh`` a
    ``ShardedDataset`` whose blocks each rank makes on its own card
    (``ceil(n / data)`` rows each, the rows past n zero points of weight
    0, the layout of ``parallel.sharding``).  Every row depends only on
    ``(seed, row)``, so every mesh holds the same rows and
    :func:`host_equivalent` is the bit-exact oracle.  ``chunk_size`` (None:
    chosen for ``k_hint`` clusters) is the chunk the dataset records.
    Seed a fit on it with an explicit table or with 'k-means++' (drawn on
    the device); it has no host copy to draw Forgy rows from.  ``device``:
    None is the card.  ``min_rows`` (the JAX package's bucket padding,
    ``parallel.sharding.bucket_target``) pads the rows to at least that
    many with zero points of weight 0, inert in every statistic (on one
    device after the real rows, under a mesh before they are split);
    ``n`` stays ``n_samples`` and the chunk is chosen for the padded
    rows."""
    from kmeans_tpu_torch.models.kmeans import resolve_device
    from kmeans_tpu_torch.parallel import mesh as _mesh
    from kmeans_tpu_torch.parallel.sharding import (Dataset, ShardedDataset,
                                                    choose_chunk_size)
    _centers_arg(kind, centers, int(n_features), dtype)
    n, d = int(n_samples), int(n_features)
    device = resolve_device(device)
    data_shards = _mesh.mesh_shape(mesh)[0]
    block = -(-max(n, 1, int(min_rows)) // data_shards)
    chunk = chunk_size or choose_chunk_size(block, k_hint, d)
    # The rows are made where they live: the host moves no rows (the
    # centres of 'blobs' only), and the span lands the generation on the
    # ingest timeline (the reference's).
    with _obs_trace.span("stage", rows=n, bytes=0, ingest="synthetic"):
        _obs_metrics.REGISTRY.counter("ingest.slabs").inc()
        cents, _ = _centers_arg(kind, centers, d, dtype)
        kw = dict(kind=kind, seed=seed, dtype=dtype, low=low, high=high,
                  device=device, centers=None if cents is None
                  else torch.from_numpy(cents).to(device))
        if mesh is None:
            x, w = generate_rows(0, max(n, int(min_rows)), n, d, **kw)
            return Dataset(x, w, chunk=chunk,
                           explicit_chunk=chunk_size is not None, n=n)
        lo = _mesh.coords(mesh)[0] * block
        x, w = generate_rows(lo, block, n, d, **kw)
    return ShardedDataset(x, w, mesh, n=n, offset=min(lo, n),
                          local_rows=max(0, min(block, n - lo)), chunk=chunk,
                          explicit_chunk=chunk_size is not None)
