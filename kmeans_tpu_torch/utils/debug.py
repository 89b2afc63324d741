"""Determinism checking: identical fits must give identical bits.

Counterpart of ``kmeans_tpu/utils/debug.py``.  Every path of the port is
deterministic for a given configuration: the seeds are derived (Forgy and
the empty-cluster resample draw from ``np.random.default_rng`` of the seed
and the iteration), and the hand kernels promise bit-identical repeats
(``ops.hopper_kernels``: fixed reduction orders, no atomics in the sums;
``parallel.distributed.cluster_sums``: a one-hot product per block in a
fixed order).  :func:`check_determinism` proves it for one setup, the
counterpart of running a race detector over a parallel program: fresh
models from one factory, fitted on the same data, must give bit-identical
trajectories and labels.

It promises nothing across configurations: another mesh, chunk or distance
mode sums in another order; compare those with a tolerance.  Where a path
sums by a scatter-add (``index_add_`` on the card: the two-level step's
sums), the order of its additions is not fixed, and the checker reports
what it sees.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class DeterminismReport(dict):
    """A dict (``deterministic``, ``runs``, ``details``) with a readable
    summary."""

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        status = "DETERMINISTIC" if self["deterministic"] else "DIVERGED"
        return f"<{status} over {self['runs']} runs: {self['details']}>"


def check_determinism(model_factory: Callable[[], object], X,
                      *, runs: int = 2,
                      sample_weight: Optional[np.ndarray] = None
                      ) -> DeterminismReport:
    """Fit ``runs`` fresh models from ``model_factory`` on the same data and
    compare their trajectories bit for bit.

    ``model_factory`` builds a new, identically configured model per call
    (``lambda: KMeans(k=8, seed=0, verbose=False, device='cpu')``); the
    K-Means family and ``GaussianMixture`` are covered (:func:`_snapshot`).
    ``X`` is fitted as given (a copy of a host array per run; a tensor or a
    ``Dataset`` as it is).  ``report['deterministic']`` is the verdict and
    ``report['details']`` names the first field that diverged."""
    if runs < 2:
        raise ValueError(f"runs must be >= 2, got {runs}")
    if isinstance(X, (list, tuple)):
        X = np.asarray(X)
    ref = None
    for r in range(runs):
        model = model_factory()
        if getattr(model, "verbose", False):
            raise ValueError("use verbose=False models (log output is not "
                             "part of the determinism contract)")
        fit_kwargs = {}
        if sample_weight is not None:
            import inspect
            if "sample_weight" not in inspect.signature(
                    model.fit).parameters:
                raise ValueError(
                    f"{type(model).__name__}.fit does not accept "
                    "sample_weight; omit it for this model")
            fit_kwargs["sample_weight"] = sample_weight
        model.fit(X.copy() if isinstance(X, np.ndarray) else X,
                  **fit_kwargs)
        snap = _snapshot(model, X)
        if ref is None:
            ref = snap
            continue
        for field, val in snap.items():
            a = np.asarray(ref[field])
            b = np.asarray(val)
            if a.shape != b.shape or not np.array_equal(a, b):
                where = ""
                if a.shape == b.shape and a.ndim:
                    bad = np.flatnonzero((a != b).reshape(-1))
                    where = f" (first mismatch at flat index {bad[0]})"
                elif not a.ndim:
                    where = f": {a} vs {b}"
                return DeterminismReport(
                    deterministic=False, runs=r + 1,
                    details=f"{field} diverged on run {r}{where}")
    return DeterminismReport(deterministic=True, runs=runs,
                             details="all trajectories bit-identical")


def _snapshot(model, X) -> dict:
    """A bit-comparable snapshot of a fitted model: the K-Means family's
    centroids, SSE history, iterations and labels; the mixture's means,
    covariances, weights, lower bound, iterations and labels."""
    if hasattr(model, "centroids"):              # the K-Means family
        return {
            "centroids": np.asarray(model.centroids).copy(),
            "sse_history": np.asarray(model.sse_history,
                                      dtype=np.float64),
            "iterations": model.iterations_run,
            "labels": np.asarray(model.predict(X)).copy(),
        }
    return {                                     # GaussianMixture
        "means": np.asarray(model.means_).copy(),
        "covariances": np.asarray(model.covariances_).copy(),
        "weights": np.asarray(model.weights_).copy(),
        "lower_bound": np.float64(model.lower_bound_),
        "iterations": model.n_iter_,
        "labels": np.asarray(model.predict(X)).copy(),
    }
