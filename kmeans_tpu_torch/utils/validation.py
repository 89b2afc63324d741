"""Parameter and numerical validation (own copy of the JAX package's
``utils/validation.py``; same checks, same messages).

Constructor checks raise ``ValueError`` (k, max_iter, tolerance positive);
all-finite checks guard the initial centroids and every iteration's new
centroids.
"""

from __future__ import annotations

import numpy as np


def validate_params(k: int, max_iter: int, tolerance: float) -> None:
    """Raise ValueError on non-positive hyperparameters."""
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    if max_iter <= 0:
        raise ValueError(f"max_iter must be positive, got {max_iter}")
    if tolerance <= 0:
        raise ValueError(f"tolerance must be positive, got {tolerance}")


def check_finite_array(arr, message: str) -> None:
    """Raise ValueError if the array contains NaN/Inf."""
    if not np.all(np.isfinite(np.asarray(arr))):
        raise ValueError(message)
