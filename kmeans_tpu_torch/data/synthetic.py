"""Synthetic data: blobs on the host or made directly on the device, and
standard-normal points (``make_gaussian``, the JAX package's)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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
