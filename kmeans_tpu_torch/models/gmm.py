"""Gaussian mixture on NVIDIA GPUs: EM for all four covariance types
(scikit-learn-style API).

Counterpart of ``kmeans_tpu/models/gmm.py``, on one device or over the data
axis of a mesh (each rank's E pass on its block of the rows, the statistics
summed over the axis).  The data is placed on the device once.  Two loops:

* the host loop (``host_loop=True``, the default): each EM iteration is one
  E-step on the device (``parallel.gmm_step``; for float32 'diag' and
  'spherical' on the card one launch of the fused CUDA kernel
  ``diag_estep``) that returns the responsibility sums, the first and
  second moments and the log-likelihood, and the M-step in float64 on the
  host.  'full' and 'tied' factor their covariances on the host in float64
  (``_prec_chol_guarded``: a covariance just past positive definite is
  rescued by the jitter ladder, ``cov_jitter_retries_``);
* the device loop (``host_loop=False``): the whole iteration on the device,
  the M-step in the model's dtype, one captured CUDA graph per iteration on
  the card (``parallel.gmm_step.make_gmm_fit_fn``); ``n_init > 1`` for
  'diag' and 'spherical' runs every restart in one such loop
  (``make_gmm_multi_fit_fn``), and so does ``sweep``.  The two loops agree
  by tolerance, not bit for bit (the M-step's dtype differs), as in the JAX
  package.

``fit_stream`` is the host loop over a stream of host blocks that never
resides on the device at once: one E pass per block (``diag_estep`` or the
torch pass), the statistics summed in float64 on the host, the float64
M-step; ``predict_stream`` and ``score_samples_stream`` label and score
block by block.

Every E pass works in a frame centered on the data's weighted mean
(``shift_``), so that ``S2/R - mu^2`` does not cancel for data far from the
origin; the shift is added back to the means.

The model runs on the card unless the caller asks for the CPU:
``device=None`` means ``cuda`` and raises where there is none.  The E-step
kernel computes in float32 and has a diagonal form only, so the dtype and
the covariance type pick the E-step (:func:`estep_mode`).

Behaviour kept from the JAX package: the constructor's arguments and
validation; ``init_params`` 'kmeans' / 'k-means++' (an internal ``KMeans``
seeded with k-means++, 20 Lloyd iterations or 1) and 'random' (Forgy rows),
with the same host NumPy draws; explicit ``weights_init`` / ``means_init``
/ ``precisions_init``; the hard-assignment init E-step; the float64 M-step
with sklearn's update rules and floors; ``lower_bound_`` the mean
per-sample log-likelihood, stopping on ``|change| < tol``, a hard error on a
non-finite one; ``n_init`` restarts, the highest final ``lower_bound_``
wins, a failed restart dropped and the survivors kept; ``sample`` with the
same draws; ``sweep`` over the component count by BIC or AIC; the ``.npz``
checkpoint in the same vocabulary, so that either package loads the other's
files; and the fault tolerance of ``models.fault_tolerance``
(``checkpoint_every`` / ``checkpoint_path``, ``fit(resume=True | <path>)``,
the out-of-memory chunk backoff of the device loop, the rollback on a
non-finite log-likelihood).  The device loop's checkpoints carry its raw
tables in the JAX package's ``dev_*`` entries (centered means, the loop's
covariance layout, log-weights, the convergence baseline, in the
accumulation dtype), so that a killed and resumed device fit gives the bits
of the uninterrupted one.  ``covariances_`` has sklearn's shape per type:
(k, D) 'diag', (k,) 'spherical', (D, D) 'tied', (k, D, D) 'full'.
"""

from __future__ import annotations

import contextlib
import math
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from kmeans_tpu_torch.models.fault_tolerance import AutoCheckpointMixin
from kmeans_tpu_torch.models.init import forgy_init
from kmeans_tpu_torch.models.kmeans import KMeans, _later, resolve_device
from kmeans_tpu_torch.obs import trace as obs_trace
from kmeans_tpu_torch.obs.heartbeat import note_progress as obs_note_progress
from kmeans_tpu_torch.parallel.gmm_step import (
    COV_TYPES, EStats, EStatsFull, make_gmm_fit_fn, make_gmm_multi_fit_fn,
    make_gmm_predict_fn, make_gmm_step_fn, make_gmm_step_full_fn,
    make_gmm_step_tied_fn, total_scatter)
from kmeans_tpu_torch.parallel.mesh import (DATA_AXIS, all_reduce,
                                            check_mesh, group_up,
                                            is_primary, make_mesh,
                                            mesh_shape)
from kmeans_tpu_torch.parallel.multihost import fleet_barrier
from kmeans_tpu_torch.parallel.sharding import (BlockStager, Dataset,
                                                bucket_target, check_bucket,
                                                check_ingest, choose_em_chunk,
                                                to_device, weighted_mean)
from kmeans_tpu_torch.utils import checkpoint as ckpt
from kmeans_tpu_torch.utils.cache import LRUCache, cached_build
from kmeans_tpu_torch.utils.validation import check_finite_array

#: Softmax sharpness of the hard-assignment init pass: with a precision this
#: large the nearest mean's log-density dominates by far more than the
#: float32 range, so the responsibilities are one-hot.
_HARD_INV_VAR = 1e6

#: Constructor arguments of the JAX package that the port does not have
#: yet: name -> (the values that name what the port does anyway, ROADMAP
#: item).  Any other value raises NotImplementedError.
_LATER_ARGS = {
    "model_shards": ((1,), "A.18 'GaussianMixture on the model axis'"),
}

#: The mixture's step functions (E-steps, device EM loops, posterior
#: passes), keyed by builder and arguments: the JAX package's
#: ``gmm._STEP_CACHE``.  A device EM loop's captured graph lives in its
#: dataset's memo, not here.
_STEP_CACHE = LRUCache(64, name="gmm._STEP_CACHE")


def _cached(builder, *args, **kwargs):
    """``builder(*args, **kwargs)``, a ``parallel.gmm_step`` builder,
    through :data:`_STEP_CACHE`."""
    return cached_build(_STEP_CACHE, builder, *args, **kwargs)

_ILL_DEFINED = ("Fitting the mixture model failed because some components "
                "have ill-defined empirical covariance (for instance caused "
                "by singleton or collapsed samples). Try to decrease the "
                "number of components, or increase reg_covar.")


def estep_mode(device_type: str, dtype, covariance_type: str) -> str:
    """The E-step a mixture runs: 'kernel' (the fused CUDA kernel, a
    float32 engine with a diagonal form only) for float32 'diag' and
    'spherical' mixtures on a CUDA device, else 'torch' (the chunked torch
    pass, in the model's dtype, on its device): float64 on the card, every
    type on the CPU, and 'tied' and 'full' on every device.  A mode rule of
    the dtype and the covariance type, not a fallback: a float64 mixture
    asked for float64 arithmetic, and no kernel of the reference covers
    'tied' or 'full' (their passes are torch ops and cuBLAS products)."""
    if device_type == "cuda" and np.dtype(dtype) == np.float32 \
            and covariance_type in ("diag", "spherical"):
        return "kernel"
    return "torch"


def _is_allowed(value, allowed) -> bool:
    return any(value is a or (type(value) is type(a) and value == a)
               for a in allowed)


class _StreamRestart:
    """One restart of a streamed EM fit."""

    def __init__(self):
        self.done = False
        self.failed = False
        self.prev = -np.inf
        self.ll = -np.inf
        self.n_iter = 0


class GaussianMixture(AutoCheckpointMixin):
    """Gaussian mixture with 'diag', 'spherical', 'tied' or 'full'
    covariances, fitted by EM on one device or the data axis of a mesh.

    Parameters follow ``sklearn.mixture.GaussianMixture`` where they
    overlap (``n_components``, ``covariance_type``, ``tol``, ``reg_covar``,
    ``max_iter``, ``n_init``, ``init_params``, ``weights_init``,
    ``means_init``, ``precisions_init``); ``seed``, ``dtype``,
    ``chunk_size`` and ``verbose`` follow this package's ``KMeans``.
    ``device``: None (the card) | 'cuda' | 'cuda:N' | 'cpu'.  ``mesh``: as
    in ``KMeans``, its data axis only.

    ``host_loop``: True (the host loop, float64 M-step) or False (the
    device loop, one captured CUDA graph per EM iteration on the card);
    'auto' is refused, as in the JAX package.  ``pipeline``: 'auto' | 0 |
    1, the chunk schedule of the torch E pass (the port's ``KMeans`` rule:
    both give the same bits; 'auto' is 0 until the card measures 1; the
    kernel has its own schedule).

    ``ingest``: 'auto' | 'mono' | 'slab', how a host array reaches the
    ranks of a mesh, as in ``KMeans`` (the same bytes either way).

    ``bucket``: 0 | 'auto' | int, the fit-shape bucket of ``KMeans``: the
    placed rows padded with inert rows of weight 0 to the bucket's count,
    the E pass's chunk from the padded count.  ``overlap``: 'auto' | 0 |
    1, ``KMeans``' overlapped set-up: the upload of a host array on a
    producer thread while this thread takes the E-step from
    ``_STEP_CACHE`` and loads ``diag_estep``'s library in the kernel mode
    (the same bits; 'auto' is 1 on a CUDA device).

    ``model_shards`` is taken only at 1 (no model axis); a mesh with a
    model axis and any other value raise ``NotImplementedError`` naming
    the ROADMAP item that brings them.

    ``estep_path_`` records what the last fit ran (:func:`estep_mode`):
    'kernel' (the fused CUDA kernel), or the torch pass's schedule,
    'serial' or 'pipelined'.  ``loop_path_``: 'host', 'device' or
    'device-multi'.  ``iter_times_`` holds the wall seconds of each EM
    iteration of the winning restart (the device loop: its mean per
    iteration).  ``cov_jitter_retries_`` counts the host loop's jitter
    ladder rescues ('tied', 'full').  ``checkpoint_segments_``,
    ``oom_backoffs_`` and ``effective_chunk_`` as in ``KMeans``.
    """

    _ckpt_k_attr = "n_components"

    _PARAM_NAMES = ("n_components", "covariance_type", "tol", "reg_covar",
                    "max_iter", "n_init", "init_params", "weights_init",
                    "means_init", "precisions_init", "seed", "dtype",
                    "mesh", "model_shards", "chunk_size", "host_loop",
                    "pipeline", "bucket", "overlap", "ingest", "verbose",
                    "device")

    def __init__(self, n_components: int = 1, *,
                 covariance_type: str = "diag", tol: float = 1e-3,
                 reg_covar: float = 1e-6, max_iter: int = 100,
                 n_init: int = 1, init_params: str = "kmeans",
                 weights_init=None, means_init=None, precisions_init=None,
                 seed: int = 42, dtype=None, mesh=None,
                 model_shards: int = 1, chunk_size: Optional[int] = None,
                 host_loop: bool = True, pipeline="auto", bucket=0,
                 overlap="auto", ingest: str = "auto",
                 verbose: bool = False, device=None):
        if covariance_type not in COV_TYPES:
            raise ValueError(
                "covariance_type must be one of 'diag', 'spherical', "
                f"'tied', 'full'; got {covariance_type!r}")
        if n_components < 1:
            raise ValueError(f"n_components must be >= 1, "
                             f"got {n_components}")
        if max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {max_iter}")
        if int(n_init) < 1:
            raise ValueError(f"n_init must be >= 1, got {n_init}")
        if tol < 0 or reg_covar < 0:
            raise ValueError("tol and reg_covar must be >= 0")
        if init_params not in ("kmeans", "k-means++", "kmeans++", "random"):
            raise ValueError(f"unknown init_params {init_params!r}")
        if isinstance(host_loop, str):
            raise ValueError("GaussianMixture host_loop must be True or "
                             f"False ('auto' is KMeans-only), got "
                             f"{host_loop!r}")
        if pipeline not in ("auto", 0, 1, True, False):
            raise ValueError(f"pipeline must be 'auto', 0, or 1; got "
                             f"{pipeline!r}")
        if overlap not in ("auto", 0, 1, True, False):
            raise ValueError(f"overlap must be 'auto', 0, or 1; got "
                             f"{overlap!r}")
        mesh = check_mesh(mesh)
        if mesh is not None and mesh_shape(mesh)[1] > 1:
            model_shards = mesh_shape(mesh)[1]
        bucket = check_bucket(bucket)
        later = dict(model_shards=model_shards)
        for name, value in later.items():
            allowed, item = _LATER_ARGS[name]
            if not _is_allowed(value, allowed):
                raise _later(name, value, item)
        self.n_components = n_components
        self.covariance_type = covariance_type
        self.tol = tol
        self.reg_covar = reg_covar
        self.max_iter = max_iter
        self.n_init = int(n_init)
        self.init_params = init_params
        self.weights_init = weights_init
        self.means_init = means_init
        self.precisions_init = precisions_init
        self.seed = seed
        self.dtype = np.dtype(dtype) if dtype is not None \
            else np.dtype(np.float32)
        if self.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
            raise ValueError(f"dtype must be float32 or float64, got "
                             f"{self.dtype}")
        self.mesh = mesh
        self.model_shards = model_shards
        self.chunk_size = chunk_size
        self.host_loop = bool(host_loop)
        self.pipeline = pipeline if pipeline == "auto" else int(pipeline)
        self.bucket = bucket
        self.overlap = overlap if overlap == "auto" else int(overlap)
        self.ingest = check_ingest(ingest)
        self.verbose = verbose
        self.device = resolve_device(device)

        self.estep_path_: Optional[str] = None
        self.loop_path_: Optional[str] = None
        # The serving-quality reference restored from a checkpoint.
        self._quality_profile: Optional[dict] = None
        self.weights_: Optional[np.ndarray] = None
        self.means_: Optional[np.ndarray] = None
        self.covariances_: Optional[np.ndarray] = None
        self.shift_: Optional[np.ndarray] = None
        self.converged_: bool = False
        self.n_iter_: int = 0
        self.lower_bound_: float = -np.inf
        self.best_restart_: int = 0
        self.restart_lower_bounds_: Optional[np.ndarray] = None
        self.iter_times_: List[float] = []
        self.cov_jitter_retries_: int = 0
        self.checkpoint_segments_: Optional[int] = None
        self.oom_backoffs_ = 0
        self.effective_chunk_: Optional[int] = None
        self.io_retries_used_ = 0
        self.blocks_skipped_ = 0
        self._total_scatter: Optional[np.ndarray] = None
        # The device loop's raw carry (``dev_*`` in a checkpoint), or None.
        self._dev_tables: Optional[dict] = None

    # ------------------------------------------------------------- plumbing

    def _mode(self) -> str:
        """The E-step of this model: :func:`estep_mode`."""
        return estep_mode(self.device.type, self.dtype,
                          self.covariance_type)

    def _resolve_pipeline(self, mode: str) -> int:
        """The torch pass's chunk schedule: 0 in the kernel mode (the kernel
        has its own) and for 'auto' (until the card has measured the
        skewed schedule), else the knob."""
        if mode == "kernel" or self.pipeline == "auto":
            return 0
        return int(self.pipeline)

    def _note_estep_path(self, mode: str) -> int:
        """Set ``estep_path_`` to what runs and return the schedule."""
        pipeline = self._resolve_pipeline(mode)
        self.estep_path_ = ("kernel" if mode == "kernel" else
                            "pipelined" if pipeline else "serial")
        return pipeline

    def _resolve_mesh(self):
        """As ``KMeans._resolve_mesh``: the given mesh, else the whole
        world's where a process group is up, else None."""
        if self.mesh is None and group_up():
            self.mesh = make_mesh()
        return self.mesh

    def _dataset(self, X, sample_weight=None) -> Dataset:
        """X on the device once (the rank's block under a mesh); data that
        did not come as a :class:`Dataset` must be finite."""
        mesh = self._resolve_mesh()
        shape = (X.n, X.d) if isinstance(X, Dataset) else np.shape(X)
        min_rows = 0 if isinstance(X, Dataset) or len(shape) != 2 \
            else self._bucket_target(shape[0])
        ds = to_device(X, self.device, self.dtype,
                       sample_weight=sample_weight, mesh=mesh,
                       chunk=self.chunk_size, k_hint=self._tile_k(shape[-1]),
                       ingest=self.ingest, min_rows=min_rows)
        if not isinstance(X, Dataset):
            if ds.host is not None:
                check_finite_array(ds.host, "Data contains NaN or Inf values")
            else:
                finite = torch.isfinite(ds.points).all().to(
                    torch.int32).reshape(1)
                if not int(all_reduce(finite, mesh, (DATA_AXIS,), "min")):
                    raise ValueError("Data contains NaN or Inf values")
        return ds

    def _bucket_target(self, n: int) -> int:
        """The padded row count of the fit-shape bucket
        (``parallel.sharding.bucket_target``)."""
        return bucket_target(self.bucket, n)

    def _resolve_overlap(self) -> int:
        """``overlap`` resolved as ``KMeans._resolve_overlap``: 'auto' is 1
        on a CUDA device, 0 on the CPU."""
        if self.overlap == "auto":
            return int(self.device.type == "cuda")
        return int(self.overlap)

    def _staged_dataset(self, X, sample_weight=None) -> Dataset:
        """The EM fit's dataset.  With ``overlap`` on and (n, D) host rows
        (not a :class:`Dataset` or a tensor), without a mesh of more than
        one rank, the upload runs in the producer thread of
        ``data.prefetch.prefetch_iter`` while this thread warms the E-step
        (:meth:`_warm_em`); the same bits as the serial path."""
        mesh = self._resolve_mesh()
        if not self._resolve_overlap() \
                or isinstance(X, (Dataset, torch.Tensor)) \
                or len(np.shape(X)) != 2 \
                or (mesh is not None and math.prod(mesh_shape(mesh)) > 1):
            return self._dataset(X, sample_weight)
        from kmeans_tpu_torch.data.prefetch import stage_beside
        return stage_beside(X, lambda B: self._dataset(B, sample_weight),
                            lambda: self._warm_em(*np.shape(X)))

    def _em_chunk(self, n: int, d: int) -> int:
        """The chunk :meth:`_chunk` gives the dataset placed from (n, D)
        host rows: that of the bucketed count."""
        rows = max(self._bucket_target(n), n, 1)
        mesh = self._resolve_mesh()
        if mesh is not None:
            rows = -(-rows // mesh_shape(mesh)[0])
        return self.chunk_size or choose_em_chunk(rows, self._tile_k(d))

    def _warm_em(self, n: int, d: int) -> None:
        """The consumer half of the overlapped prelude: the E-step of the
        fit about to run from ``_STEP_CACHE`` (a hit at the fit's own call),
        and, in the kernel mode on a CUDA device, ``diag_estep``'s
        library loaded (with a store active, read from it first)."""
        mode = self._mode()
        self._make_step(self.mesh, self._em_chunk(n, d), mode,
                        self._resolve_pipeline(mode))
        if mode == "kernel" and self.device.type == "cuda":
            from kmeans_tpu_torch.ops import _build
            from kmeans_tpu_torch.ops.estep_kernels import LIB_NAME
            _build.load(LIB_NAME)

    def _tile_k(self, d: int) -> int:
        """The width of a chunk's log-density temporary: k, or k * D for
        'full' (its transform tile is (chunk, k, D))."""
        return self.n_components * (d if self.covariance_type == "full"
                                    else 1)

    def _chunk(self, ds: Dataset) -> int:
        return self.chunk_size or choose_em_chunk(ds.points.shape[0],
                                                  self._tile_k(ds.d))

    def _step_fn(self, ds: Dataset, mode: str, pipeline: int):
        """The E-step of this covariance type on ``ds``."""
        return self._make_step(ds.mesh, self._chunk(ds), mode, pipeline)

    def _make_step(self, mesh, chunk: int, mode: str, pipeline: int):
        """The E-step of this covariance type over rows of ``mesh`` in
        chunks of ``chunk`` rows: ``diag_estep`` in the kernel mode."""
        ct = self.covariance_type
        if ct == "full":
            return _cached(make_gmm_step_full_fn, mesh, chunk_size=chunk,
                           pipeline=pipeline)
        if ct == "tied":
            return _cached(make_gmm_step_tied_fn, mesh, chunk_size=chunk,
                           pipeline=pipeline)
        return _cached(make_gmm_step_fn, mesh, chunk_size=chunk, mode=mode,
                       pipeline=pipeline)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """A copy of a host table on the device (the array may be
        read-only)."""
        return torch.tensor(np.asarray(a, dtype=self.dtype),
                            device=self.device)

    def _shift(self) -> np.ndarray:
        """The centering shift (the data's weighted mean), zeros pre-fit."""
        if self.shift_ is None:
            return np.zeros(self.means_.shape[1], np.float64)
        return self.shift_

    def _diag_view(self) -> np.ndarray:
        """(k, D) diagonal variances: 'diag' as it is, 'spherical'
        broadcast over D."""
        if self.covariance_type == "spherical":
            return np.broadcast_to(self.covariances_[:, None],
                                   (self.n_components,
                                    self.means_.shape[1]))
        return self.covariances_

    @staticmethod
    def _prec_chol(cov: np.ndarray):
        """Precision Cholesky (sklearn's parameterisation) of one or a
        batch of covariance matrices, in float64 on the host: ``Sigma = L
        L^T -> P = L^-T``, so ``Sigma^-1 = P P^T`` and ``log_det_half = sum
        log diag(P)``.  Raises sklearn's ill-defined-covariance error on a
        matrix that is not positive definite."""
        try:
            L = np.linalg.cholesky(cov)
        except np.linalg.LinAlgError:
            raise ValueError(_ILL_DEFINED) from None
        eye = np.broadcast_to(np.eye(cov.shape[-1]), cov.shape)
        p_chol = np.swapaxes(np.linalg.solve(L, eye), -1, -2)   # L^-T
        log_det_half = -np.sum(
            np.log(np.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
        return p_chol, log_det_half

    def _prec_chol_guarded(self, cov: np.ndarray):
        """The fit path's precision Cholesky: on a batch that is not
        positive definite, each offending component is retried with the
        jitter ladder ``reg_covar * 10^j`` (j = 1..3) on its diagonal, each
        rescue counted in ``cov_jitter_retries_`` (with a warning); the
        ladder exhausted (or ``reg_covar == 0``) raises the
        ill-defined-covariance error naming the components.  A healthy
        batch takes :meth:`_prec_chol` untouched."""
        try:
            return self._prec_chol(cov)
        except ValueError:
            pass
        single = cov.ndim == 2          # tied: one shared (D, D)
        batch = np.array(cov[None] if single else cov, dtype=np.float64,
                         copy=True)
        d = batch.shape[-1]
        bad = []
        for idx in range(batch.shape[0]):
            for j in range(4):          # j = 0 is the retry without jitter
                jitter = self.reg_covar * (10.0 ** j) if j else 0.0
                try:
                    np.linalg.cholesky(batch[idx] + jitter * np.eye(d))
                except np.linalg.LinAlgError:
                    continue
                if j:
                    self.cov_jitter_retries_ += 1
                    batch[idx] += jitter * np.eye(d)
                break
            else:
                bad.append(idx)
        if bad:
            names = ("the shared tied covariance" if single else
                     f"component(s) {bad}")
            raise ValueError(
                f"Fitting the mixture model failed because some "
                f"components have ill-defined empirical covariance "
                f"({names} stayed non-PD through the jitter ladder "
                f"reg_covar * 10^j, j <= 3, reg_covar="
                f"{self.reg_covar!r}). Try to decrease the number of "
                f"components, or increase reg_covar.") from None
        warnings.warn(
            f"non-PD covariance rescued by the jitter ladder "
            f"(cov_jitter_retries_={self.cov_jitter_retries_}); "
            f"consider a larger reg_covar", UserWarning, stacklevel=3)
        return self._prec_chol(batch[0] if single else batch)

    def _params_dev(self, guard_cholesky: bool = False):
        """E-step tables on the device, per covariance type, after
        ``shift``:

        * 'diag' / 'spherical': ``(means_c, inv_var, log_det, log_w)``;
          precision and log-determinant from the same covariance, floored
          at the compute dtype's ``tiny``;
        * 'tied': ``(means_t = mu_c @ P, P (D, D), log_det_half (), log_w)``;
        * 'full': ``(means_c, P (k, D, D), log_det_half (k,), log_w)``.

        ``guard_cholesky`` (the fit paths) factors through the jitter
        ladder; inference raises on a covariance that does not factor."""
        shift = self._shift()
        log_w = np.log(np.maximum(self.weights_, 1e-300))
        ct = self.covariance_type
        mc = self.means_ - shift
        if ct in ("diag", "spherical"):
            cv = np.maximum(self._diag_view(), max(
                self.reg_covar, float(np.finfo(self.dtype).tiny)))
            var = self._put(cv)
            return (self._put(shift), self._put(mc), 1.0 / var,
                    torch.log(var).sum(dim=1), self._put(log_w))
        factor = self._prec_chol_guarded if guard_cholesky \
            else self._prec_chol
        p_chol, ldh = factor(np.asarray(self.covariances_, np.float64))
        if ct == "tied":
            return (self._put(shift), self._put(mc @ p_chol),
                    self._put(p_chol), self._put(np.asarray(ldh)),
                    self._put(log_w))
        return (self._put(shift), self._put(mc), self._put(p_chol),
                self._put(ldh), self._put(log_w))

    def _hard_tables(self, means: np.ndarray, shift: np.ndarray):
        """E-step tables of the hard-assignment init pass, per covariance
        type: a precision far above the data's scale makes the
        responsibilities one-hot."""
        k, d = means.shape
        ct = self.covariance_type
        mc = means - shift
        zeros = self._put(np.zeros(k))
        if ct in ("diag", "spherical"):
            return (self._put(shift), self._put(mc),
                    self._put(np.full((k, d), _HARD_INV_VAR)), zeros, zeros)
        sqh = float(np.sqrt(_HARD_INV_VAR))
        if ct == "tied":
            # The precision Cholesky sqrt(h) I: the means transform to
            # mu_c sqrt(h).
            return (self._put(shift),
                    self._put((mc.astype(self.dtype) * sqh)),
                    self._put(np.eye(d) * sqh), self._put(np.zeros(())),
                    zeros)
        return (self._put(shift), self._put(mc),
                self._put(np.broadcast_to(np.eye(d) * sqh, (k, d, d))),
                zeros, zeros)

    @staticmethod
    def _host(st):
        """The statistics as float64 host arrays, in one copy from the
        device: ``EStatsFull`` stays itself, any other four (a kernel's
        tuple too) become ``EStats``."""
        kind = EStatsFull if isinstance(st, EStatsFull) else EStats
        flat = torch.cat([t.reshape(-1) for t in st]).to(
            torch.float64).cpu().numpy()
        out, lo = [], 0
        for t in st:
            out.append(flat[lo:lo + t.numel()].reshape(tuple(t.shape)))
            lo += t.numel()
        return kind(*out)

    # ----------------------------------------------------------------- init

    def _restart_seeds(self) -> list:
        """Restart 0 uses ``seed``; an explicit ``means_init`` makes every
        restart identical, so it collapses to one."""
        if self.means_init is not None:
            return [self.seed]
        extra = np.random.SeedSequence(self.seed).generate_state(
            self.n_init - 1) if self.n_init > 1 else []
        return [self.seed] + [int(s) for s in extra]

    def _init_params(self, ds: Dataset, step_fn, seed: int) -> float:
        # The 'seed' span holds the whole parameter seeding, the inner
        # KMeans fit's own spans nested in it (the reference's).
        with obs_trace.span("seed", strategy=str(self.init_params),
                            k=self.n_components):
            return self._init_params_inner(ds, step_fn, seed)

    def _init_params_inner(self, ds: Dataset, step_fn, seed: int) -> float:
        d = ds.d
        k = self.n_components
        if self.means_init is not None:
            means = np.asarray(self.means_init, np.float64)
            if means.shape != (k, d):
                raise ValueError(f"means_init shape {means.shape} != "
                                 f"({k}, {d})")
        elif self.init_params == "random":
            # sklearn's 'random' draws random responsibilities; seeding the
            # means at random rows is the analogue the JAX package uses.
            means = np.asarray(forgy_init(ds, k, seed, validate=False),
                               np.float64)
        else:
            # 'kmeans' refines k-means++ seeds with 20 Lloyd iterations,
            # 'k-means++' keeps the seeds (one iteration).  The internal
            # KMeans is a K-Means of the model's dtype: kernel 1 on the
            # card in float32, 'matmul' in float64 and on the CPU.
            km = KMeans(k=k, seed=seed, init="kmeans++",
                        max_iter=20 if self.init_params == "kmeans" else 1,
                        verbose=False, compute_labels=False,
                        empty_cluster="resample", dtype=self.dtype,
                        distance_mode="auto", device=self.device,
                        mesh=ds.mesh)
            km.fit(ds)
            means = np.asarray(km.centroids, np.float64)
        # One hard-assignment E-step gives the one-hot statistics sklearn
        # also starts from; the M-step turns them into weights and
        # covariances.  Explicit weights / precisions override.
        shift = self._shift()
        hard = step_fn(ds.points, ds.weights,
                       *self._hard_tables(means, shift))
        w_total, (pi, mu_c, var) = self._m_step(self._host(hard))
        self.means_ = (mu_c + shift) if self.means_init is None else means
        self.weights_ = (pi if self.weights_init is None
                         else np.asarray(self.weights_init, np.float64))
        self.covariances_ = (self._cov_from_precisions_init()
                             if self.precisions_init is not None else var)
        self.weights_ = self.weights_ / self.weights_.sum()
        return w_total

    def _cov_from_precisions_init(self) -> np.ndarray:
        """Covariances from an explicit ``precisions_init``."""
        prec = np.asarray(self.precisions_init, np.float64)
        if self.covariance_type in ("diag", "spherical"):
            return 1.0 / prec
        return np.linalg.inv(prec)      # tied (D, D) / full (k, D, D)

    # ------------------------------------------------------------------- EM

    def _m_step(self, st):
        """float64 host M-step from centered-frame statistics (sklearn's
        update rules, per covariance type); the returned means are centered
        too."""
        R = np.asarray(st.resp_sum, np.float64)
        S1 = np.asarray(st.xsum, np.float64)
        w_total = float(R.sum())
        Rc = np.maximum(R, 10 * np.finfo(np.float64).tiny)
        mu = S1 / Rc[:, None]
        ct = self.covariance_type
        # tiny floor: reg_covar = 0 must not leave exact-zero variances.
        floor = max(self.reg_covar, np.finfo(np.float64).tiny)
        if ct in ("diag", "spherical"):
            S2 = np.asarray(st.x2sum, np.float64)
            var = S2 / Rc[:, None] - mu ** 2 + self.reg_covar
            var = np.maximum(var, floor)
            if ct == "spherical":
                var = var.mean(axis=1)
        else:
            d = mu.shape[1]
            if ct == "full":
                T = np.asarray(st.scatter, np.float64)
                var = T / Rc[:, None, None] - mu[:, :, None] * mu[:, None, :]
            else:
                # sklearn's rule: (total scatter - sum_k R_k mu_k mu_k^T) / W
                var = (self._total_scatter - np.einsum("k,kd,ke->de", R, mu,
                                                       mu)) \
                    / max(w_total, 1e-300)
            diag = (..., np.arange(d), np.arange(d))
            var[diag] += self.reg_covar
            var[diag] = np.maximum(var[diag], floor)
        pi = np.maximum(R / max(w_total, 1e-300), 1e-300)
        return w_total, (pi / pi.sum(), mu, var)

    def fit(self, X, sample_weight=None, *, resume=False,
            checkpoint_every: int = 0,
            checkpoint_path=None) -> "GaussianMixture":
        """Fit by EM on an (n, D) array-like, a tensor or a
        :class:`Dataset`.  ``sample_weight`` (n,) weights every statistic
        (the second positional argument, as in the JAX package).
        ``resume=True`` continues EM from the current parameters for up to
        ``max_iter`` more iterations (``n_init`` must be 1), by either loop:
        the iteration count and the convergence baseline (``lower_bound_``)
        carry over; the device loop starts from its raw tables where the
        model has them (a device fit, or a checkpoint with ``dev_*``
        entries), else from the fitted attributes.  ``resume=<path>``
        loads that checkpoint first (``.prev`` when the file is torn).
        ``checkpoint_every=N`` with ``checkpoint_path`` writes a rotating
        checkpoint every N EM iterations and at the last: the device loop
        runs in segments that replay one captured graph and hand each other
        their tables as they are, so a segmented or a killed-and-resumed
        device fit gives the bits of the uninterrupted one; the float64
        host loop resumes from its fitted attributes exactly."""
        checkpoint_every = self._check_ckpt(checkpoint_every,
                                            checkpoint_path)
        ckpt_kw = dict(checkpoint_every=checkpoint_every,
                       checkpoint_path=checkpoint_path)
        self.cov_jitter_retries_ = 0
        resume = self._resolve_resume(resume)
        ds = self._staged_dataset(X, sample_weight)
        self.io_retries_used_ = getattr(getattr(ds, "io_stats", None),
                                        "retries_used", 0)
        # The clock anchor of merged timelines (a no-op without a tracer).
        fleet_barrier("fit-start", ds.mesh)
        mode = self._mode()
        pipeline = self._note_estep_path(mode)
        step_fn = self._step_fn(ds, mode, pipeline)
        self.shift_ = weighted_mean(ds.points, ds.weights, ds.mesh).to(
            torch.float64).cpu().numpy()
        if self.covariance_type == "tied":
            # The tied M-step's total scatter depends on the data and the
            # shift only: one pass per fit.
            self._total_scatter = total_scatter(
                ds.points, ds.weights, self._put(self.shift_), ds.mesh).to(
                torch.float64).cpu().numpy()
        if resume and self.means_ is not None:
            if self.n_init != 1:
                raise ValueError("fit(resume=True) requires n_init == 1 "
                                 "(the restart sweep re-initializes)")
            self._fit_one(ds, step_fn, self.seed, resume=True, **ckpt_kw)
            return self
        seeds = self._restart_seeds()
        self.best_restart_ = 0
        self.restart_lower_bounds_ = None
        if len(seeds) > 1 and not self.host_loop \
                and self.covariance_type in ("diag", "spherical"):
            return self._fit_on_device_multi(ds, step_fn, seeds)
        best = None
        lls = []
        last_err = None
        for r, seed in enumerate(seeds):
            try:
                self._fit_one(ds, step_fn, seed, **ckpt_kw)
            except (ValueError, np.linalg.LinAlgError) as e:
                # A failed restart keeps the earlier ones; a single restart
                # raises at once.
                if len(seeds) == 1:
                    raise
                warnings.warn(f"GMM restart {r + 1}/{len(seeds)} failed "
                              f"({e}); continuing with the remaining "
                              f"restarts", UserWarning, stacklevel=2)
                last_err = e
                lls.append(-np.inf)
                continue
            if len(seeds) == 1:
                return self
            lls.append(self.lower_bound_)
            if best is None or self.lower_bound_ > best["lower_bound_"]:
                # The raw device tables go with the winner.
                best = {name: getattr(self, name) for name in (
                    "weights_", "means_", "covariances_", "converged_",
                    "n_iter_", "lower_bound_", "iter_times_", "_dev_tables")}
                best["restart"] = r
        if best is None:
            raise last_err
        self.best_restart_ = best.pop("restart")
        for name, value in best.items():
            setattr(self, name, value)
        self.restart_lower_bounds_ = np.asarray(lls, np.float64)
        return self

    def _fit_one(self, ds: Dataset, step_fn, seed: int,
                 resume: bool = False, checkpoint_every: int = 0,
                 checkpoint_path=None) -> None:
        """One restart.  The host loop: one E-step on the device per
        iteration; its statistics come to the host as float64, which is
        also the iteration's synchronisation point; a checkpoint at the
        absolute cadence ``it % checkpoint_every == 0`` and at the last
        iteration.  ``host_loop=False``: :meth:`_fit_on_device`."""
        if not resume:
            if self._init_params(ds, step_fn, seed) <= 0:
                raise ValueError("total sample weight must be positive")
        if not self.host_loop:
            return self._fit_on_device(
                ds, base_iter=self.n_iter_ if resume else 0, resume=resume,
                checkpoint_every=checkpoint_every,
                checkpoint_path=checkpoint_path)
        self.loop_path_ = "host"
        self.converged_ = False
        self.iter_times_ = []
        # The host loop's exact carry is its fitted attributes.
        self._dev_tables = None
        self.checkpoint_segments_ = 0 if checkpoint_every else None
        base = self.n_iter_ if resume else 0
        prev = self.lower_bound_ if resume else -np.inf
        shift = self._shift()
        for it in range(base + 1, base + self.max_iter + 1):
            t0 = time.perf_counter()
            # The span holds the E-step and the readback of its
            # statistics (the iteration's sync point).
            with obs_trace.span("dispatch", tag="em/step", iteration=it):
                st = step_fn(ds.points, ds.weights,
                             *self._params_dev(guard_cholesky=True))
                host = self._host(st)
            # The float64 total of the responsibility sums normalises the
            # lower bound on fresh and resumed fits alike.
            w_total, (pi, mu_c, var) = self._m_step(host)
            if w_total <= 0:
                raise ValueError("total sample weight must be positive")
            self.weights_, self.means_ = pi, mu_c + shift
            self.covariances_ = var
            self.lower_bound_ = float(host.loglik) / w_total
            self.n_iter_ = it
            self.iter_times_.append(time.perf_counter() - t0)
            if self.verbose and is_primary(self.mesh):
                print(f"EM iteration {it}: mean log-likelihood = "
                      f"{self.lower_bound_:.6f} "
                      f"[{self.iter_times_[-1] * 1e3:.1f} ms]", flush=True)
            if not np.isfinite(self.lower_bound_):
                self._raise_divergence("log-likelihood", it)
            # Heartbeat: this EM iteration's state is on the host.
            obs_note_progress(self, phase="iteration")
            if checkpoint_every and it % checkpoint_every == 0:
                self.checkpoint_segments_ += 1
                self._write_autockpt(checkpoint_path, it)
            if abs(self.lower_bound_ - prev) < self.tol:
                self.converged_ = True
                break
            prev = self.lower_bound_
        if checkpoint_every and self.n_iter_ % checkpoint_every:
            self.checkpoint_segments_ += 1
            self._write_autockpt(checkpoint_path, self.n_iter_)

    def _start_tables(self, shift: np.ndarray):
        """The device loop's starting tables in the model's dtype, from the
        fitted attributes: centered means, the covariance ('diag' and
        'spherical' floored at ``max(reg_covar, tiny)``, 'spherical'
        broadcast over D) and the log-weights."""
        tiny = float(np.finfo(self.dtype).tiny)
        mc = (self.means_ - shift).astype(self.dtype)
        if self.covariance_type in ("diag", "spherical"):
            cov = np.maximum(self._diag_view(),
                             max(self.reg_covar, tiny)).astype(self.dtype)
        else:
            cov = np.asarray(self.covariances_, self.dtype)
        log_w = np.log(np.maximum(self.weights_, 1e-300)).astype(self.dtype)
        return mc, cov, log_w

    def _resume_tables(self, shift: np.ndarray):
        """``(means_c, cov, log_w, prev)`` a resumed device fit starts from:
        the raw carry where the model has one of its covariance type and
        shape, else the fitted attributes (:meth:`_start_tables`) and
        ``lower_bound_``."""
        raw = self._dev_tables
        k, d = self.n_components, self.means_.shape[1]
        if raw is not None and raw["cov_type"] == self.covariance_type \
                and np.ndim(raw["means_c"]) == 2 \
                and np.shape(raw["means_c"])[0] >= k \
                and np.shape(raw["means_c"])[1] == d:
            cov = np.asarray(raw["cov"])
            return (np.asarray(raw["means_c"])[:k],
                    cov if self.covariance_type == "tied" else cov[:k],
                    np.asarray(raw["log_w"])[:k], float(raw["prev_ll"]))
        return self._start_tables(shift) + (float(self.lower_bound_),)

    def _pack_dev_tables(self, means_c, cov, log_w, prev: float) -> dict:
        """The device loop's carry as host arrays of its own dtype (the
        ``dev_*`` entries of a checkpoint)."""
        k = self.n_components
        cov = cov.cpu().numpy()
        return {"cov_type": self.covariance_type,
                "means_c": means_c.cpu().numpy()[:k],
                "cov": cov if self.covariance_type == "tied" else cov[:k],
                "log_w": log_w.cpu().numpy()[:k], "prev_ll": float(prev)}

    def _fit_on_device(self, ds: Dataset, *, base_iter: int = 0,
                       resume: bool = False, checkpoint_every: int = 0,
                       checkpoint_path=None) -> None:
        """Every EM iteration on the device (``host_loop=False``): the JAX
        package's ``_fit_on_device`` for all four covariance types
        (``parallel.gmm_step.make_gmm_fit_fn``).  ``base_iter`` offsets
        ``n_iter_`` on resume.  The fit (or each segment of
        ``checkpoint_every`` iterations) goes through
        ``_dispatch_oom_safe``; a segment hands the next its tables as they
        are (no host cast) and its baseline, and the checkpoint between
        them holds the same raw carry (``_dev_tables``).  A non-finite
        log-likelihood rolls back to the last checkpoint of this fit and
        raises ``NumericalDivergenceError`` naming its iteration."""
        mode = self._mode()
        pipeline = self._resolve_pipeline(mode)
        shift = self._shift()
        if resume:
            mc, cov, log_w, prev = self._resume_tables(shift)
        else:
            mc, cov, log_w = self._start_tables(shift)
            prev = -np.inf
        self.loop_path_ = "device"
        self.checkpoint_segments_ = 0 if checkpoint_every else None
        chunk = self._chunk(ds)
        self.effective_chunk_ = chunk
        shift_dev = self._put(shift)
        tables = (self._put(mc), self._put(cov), self._put(log_w))
        hist_parts = []
        it_done, seg_idx = 0, 0
        t0 = time.perf_counter()
        while True:
            seg = (min(checkpoint_every, self.max_iter - it_done)
                   if checkpoint_every else self.max_iter - it_done)

            def dispatch(c, _tables=tables, _prev=prev, _it0=it_done,
                         _seg=seg):
                fit_fn = _cached(
                    make_gmm_fit_fn,
                    ds.mesh, chunk_size=c, max_iter=self.max_iter,
                    tol=float(self.tol), reg_covar=float(self.reg_covar),
                    cov_type=self.covariance_type, mode=mode,
                    pipeline=pipeline)
                return fit_fn(ds, shift_dev, *_tables, _prev, start=_it0,
                              stop=_it0 + _seg)

            res, chunk = self._dispatch_oom_safe(dispatch, chunk, seg_idx)
            seg_idx += 1
            n = res.n_iter
            if n and not np.all(np.isfinite(res.ll_hist)):
                self._raise_divergence("log-likelihood",
                                       base_iter + it_done + n)
            hist_parts.append(res.ll_hist)
            it_done += n
            prev = res.prev
            self._ingest_device_tables(res.means_c, res.cov, res.log_w,
                                       shift)
            self._dev_tables = self._pack_dev_tables(
                res.means_c, res.cov, res.log_w, prev)
            self.converged_ = res.converged
            self.n_iter_ = base_iter + it_done
            if n:
                self.lower_bound_ = float(res.ll_hist[-1])
            if not checkpoint_every:
                break
            self.checkpoint_segments_ += 1
            self._write_autockpt(checkpoint_path, self.n_iter_)
            if res.converged or it_done >= self.max_iter:
                break
            tables = (res.means_c, res.cov, res.log_w)   # no host cast
        elapsed = time.perf_counter() - t0
        self.iter_times_ = [elapsed / max(it_done, 1)] * it_done
        if self.verbose and is_primary(self.mesh):
            print(f"EM device loop: {it_done} iterations, mean "
                  f"log-likelihood = {self.lower_bound_:.6f}", flush=True)

    def _fit_on_device_multi(self, ds: Dataset, step_fn,
                             seeds) -> "GaussianMixture":
        """Every restart in one device loop ('diag', 'spherical'): each
        restart's init runs first (a failed one is dropped with a warning
        and the survivors kept), then the members ride
        ``make_gmm_multi_fit_fn``; the winner is the highest final lower
        bound, a member that went non-finite never wins."""
        R = len(seeds)
        k = self.n_components
        shift = self._shift()
        tables = []
        alive = []
        init_err = None
        for r, seed in enumerate(seeds):
            try:
                if self._init_params(ds, step_fn, seed) <= 0:
                    raise ValueError("total sample weight must be positive")
            except (ValueError, np.linalg.LinAlgError) as e:
                warnings.warn(f"GMM restart {r + 1}/{R} failed at init "
                              f"({e}); continuing with the remaining "
                              f"restarts", UserWarning, stacklevel=2)
                init_err = e
                continue
            alive.append(r)
            tables.append(self._start_tables(shift))
        if not alive:
            raise init_err
        mode = self._mode()
        fit_fn = _cached(
            make_gmm_multi_fit_fn,
            ds.mesh, chunk_sizes=[self._chunk(ds)], max_iter=self.max_iter,
            tol=float(self.tol), reg_covar=float(self.reg_covar),
            cov_type=self.covariance_type, mode=mode,
            pipeline=self._resolve_pipeline(mode))
        t0 = time.perf_counter()
        res = fit_fn(ds, self._put(shift),
                     *(self._put(np.stack(t)) for t in zip(*tables)),
                     ks=[k] * len(alive))
        elapsed = time.perf_counter() - t0
        lls = np.full((R,), -np.inf)
        lls[np.asarray(alive)] = res.final_lls
        if not np.any(np.isfinite(lls)):
            raise ValueError(
                "non-finite log-likelihood in every batched restart")
        n_failed = int(np.sum(~np.isfinite(res.final_lls)))
        if n_failed:
            warnings.warn(f"{n_failed} of {len(alive)} batched GMM restarts "
                          f"diverged (non-finite log-likelihood); "
                          f"continuing with the survivors", UserWarning,
                          stacklevel=2)
        b = res.best
        n = int(res.n_iters[b])
        self._ingest_device_tables(res.means_c[b], res.cov[b], res.log_w[b],
                                   shift)
        self._dev_tables = self._pack_dev_tables(
            res.means_c[b], res.cov[b], res.log_w[b],
            float(res.ll_hist[b, n - 1]) if n else -np.inf)
        self.converged_ = bool(res.converged[b])
        self.n_iter_ = n
        self.lower_bound_ = float(res.ll_hist[b, n - 1]) if n else -np.inf
        self.best_restart_ = alive[b]
        self.restart_lower_bounds_ = lls
        self.iter_times_ = [elapsed / max(int(res.n_iters.max()), 1)] * n
        self.loop_path_ = "device-multi"
        if self.verbose and is_primary(self.mesh):
            print(f"EM batched restarts: best {self.best_restart_ + 1} of "
                  f"{R}, mean log-likelihood = {self.lower_bound_:.6f}",
                  flush=True)
        return self

    def _ingest_device_tables(self, means_c, cov, log_w, shift) -> None:
        """The device loop's tables as the fitted attributes: the shift
        added back in float64, 'spherical' collapsed to (k,), 'tied' its
        shared (D, D)."""
        k = self.n_components
        self.means_ = means_c.to(torch.float64).cpu().numpy()[:k] + shift
        cv = cov.to(torch.float64).cpu().numpy()
        ct = self.covariance_type
        self.covariances_ = (cv[:k, 0] if ct == "spherical" else
                             cv if ct == "tied" else cv[:k])
        w = np.exp(log_w.to(torch.float64).cpu().numpy()[:k])
        self.weights_ = w / w.sum()

    # ----------------------------------------------------------------- sweep

    def sweep(self, X, *, k_range, criterion: str = "bic",
              sample_weight=None, batched=True):
        """Model selection over the component count (the JAX package's
        ``GaussianMixture.sweep``): fit every (k, restart) member, score each
        by ``criterion`` ('bic' | 'aic', lowest wins) and return a
        ``sweep.SweepResult``.

        ``batched=True`` runs every member in one device loop
        (``parallel.gmm_step.make_gmm_multi_fit_fn``): each member's tables
        padded to k_max with inert components (zero mean, unit variance,
        ``-inf`` log-weight) and each member the single fit's iteration at
        its own k, so a member's lower bounds are those of its single
        device-loop fit; then one fresh E pass per member scores its final
        parameters (the weighted mean log-likelihood that BIC and AIC take).
        Member seeding runs each member's own init first.  The batched loop
        needs the diagonal density: 'full' and 'tied' run the sequential
        path with a warning.  ``batched=0`` is the oracle: one device-loop
        fit per member on the same dataset, scored by ``bic`` / ``aic``.
        Within each k the highest final lower bound wins; the criterion
        then picks k.  The inits must be data-driven."""
        from kmeans_tpu_torch import sweep as sweep_mod

        if self.means_init is not None or self.precisions_init is not None \
                or self.weights_init is not None:
            raise ValueError("sweep() needs data-driven inits (explicit "
                             "means/weights/precisions pin k)")
        ks = sweep_mod.parse_k_range(k_range)
        sweep_mod.check_criterion(criterion, sweep_mod.GMM_CRITERIA)
        k_max = ks[-1]
        ct = self.covariance_type
        if batched and ct not in ("diag", "spherical"):
            warnings.warn(
                f"batched GMM sweep needs the diag/spherical density; "
                f"covariance_type={ct!r} runs the sequential path",
                UserWarning, stacklevel=2)
            batched = False
        engine = sweep_mod.clone_for(self, n_components=k_max,
                                     verbose=False)
        ds = engine._dataset(X, sample_weight)
        if k_max >= ds.n:
            raise ValueError(f"k_max={k_max} must be < n={ds.n}")
        mode = engine._mode()
        pipeline = engine._note_estep_path(mode)
        shift = weighted_mean(ds.points, ds.weights, ds.mesh).to(
            torch.float64).cpu().numpy()
        seeds = engine._restart_seeds()
        members = [(k, s) for k in ks for s in seeds]
        R, n_init = len(members), len(seeds)
        n, d = ds.n, ds.d
        if batched:
            means0 = np.zeros((R, k_max, d), self.dtype)
            var0 = np.ones((R, k_max, d), self.dtype)
            log_w0 = np.full((R, k_max), -np.inf, self.dtype)
            chunks = []
            for i, (k_m, s) in enumerate(members):
                gm = sweep_mod.clone_for(self, n_components=k_m, seed=s,
                                         n_init=1, verbose=False,
                                         mesh=ds.mesh)
                gm.shift_ = shift
                if gm._init_params(ds, gm._step_fn(ds, mode, pipeline),
                                   s) <= 0:
                    raise ValueError("total sample weight must be positive")
                means0[i, :k_m], var0[i, :k_m], log_w0[i, :k_m] = \
                    gm._start_tables(shift)
                chunks.append(gm._chunk(ds))
            fit_fn = _cached(
                make_gmm_multi_fit_fn,
                ds.mesh, chunk_sizes=chunks, max_iter=self.max_iter,
                tol=float(self.tol), reg_covar=float(self.reg_covar),
                cov_type=ct, mode=mode, pipeline=pipeline,
                return_scores=True)
            res = fit_fn(ds, engine._put(shift), engine._put(means0),
                         engine._put(var0), engine._put(log_w0),
                         ks=[k for k, _ in members])
            n_disp = 1
            flls, n_it, conv = res.final_lls, res.n_iters, res.converged
            crit_vals = np.asarray(
                [self._criterion_value(criterion, res.final_scores[i], k_m,
                                       d, n)
                 for i, (k_m, _) in enumerate(members)])
            fitted = None
        else:
            flls = np.full((R,), -np.inf)
            crit_vals = np.full((R,), np.inf)
            n_it = np.zeros((R,), np.int64)
            fitted = []
            for i, (k_m, s) in enumerate(members):
                gm = sweep_mod.clone_for(self, n_components=k_m, seed=s,
                                         n_init=1, verbose=False,
                                         host_loop=False, mesh=ds.mesh)
                gm.fit(ds)
                flls[i] = gm.lower_bound_
                n_it[i] = gm.n_iter_
                crit_vals[i] = (gm.bic(ds) if criterion == "bic"
                                else gm.aic(ds))
                fitted.append(gm)
            n_disp = 2 * R
        if not np.any(np.isfinite(flls)):
            raise ValueError(
                "non-finite log-likelihood in every sweep member")
        lls, best_r, win_idx = sweep_mod.within_k_winners(
            flls, len(ks), n_init, maximize=True)
        crit = crit_vals.reshape(len(ks), n_init)
        idx = np.arange(len(ks))
        scores = np.where(np.isfinite(lls[idx, best_r]), crit[idx, best_r],
                          np.inf)
        selected_k, sel, m_sel = sweep_mod.selected_member(
            ks, scores, criterion, win_idx)
        if batched:
            best = sweep_mod.clone_for(self, n_components=selected_k,
                                       mesh=ds.mesh)
            best.shift_ = shift
            best._ingest_device_tables(res.means_c[m_sel], res.cov[m_sel],
                                       res.log_w[m_sel], shift)
            best.converged_ = bool(conv[m_sel])
            best.n_iter_ = int(n_it[m_sel])
            best.lower_bound_ = float(flls[m_sel])
            best.loop_path_ = "device-sweep"
            best.estep_path_ = engine.estep_path_
        else:
            best = fitted[m_sel]
        best.best_restart_ = int(best_r[sel])
        best.restart_lower_bounds_ = np.asarray(lls[sel], np.float64)
        return sweep_mod.SweepResult(
            family="gmm", criterion=criterion, k_range=ks,
            scores=np.asarray(scores, np.float64),
            member_scores=lls.astype(np.float64),
            selected_k=selected_k, selected_restart=int(best_r[sel]),
            best_model=best, n_dispatches=n_disp, batched=bool(batched),
            n_iters=np.asarray(n_it).reshape(len(ks), n_init))

    def _criterion_value(self, criterion: str, mean_ll: float, k: int,
                         d: int, n: int) -> float:
        """BIC or AIC from a member's mean log-likelihood (the ``bic`` /
        ``aic`` formulas at the member's k)."""
        if not np.isfinite(mean_ll):
            return np.inf
        pen = self._n_parameters_for(k, d, self.covariance_type)
        if criterion == "bic":
            return -2.0 * mean_ll * n + pen * math.log(n)
        return -2.0 * mean_ll * n + 2.0 * pen

    # ------------------------------------------------------------ streaming

    def fit_stream(self, make_blocks, *, d: Optional[int] = None,
                   resume=False, prefetch: int = 2,
                   checkpoint_every: int = 0, checkpoint_path=None,
                   io_retries: int = 0, io_backoff: float = 0.05,
                   on_nonfinite: str = "error") -> "GaussianMixture":
        """Exact EM over data larger than the device (the JAX package's
        ``fit_stream``): ``make_blocks()`` returns a fresh iterable of (m,
        D) host blocks, or ``(block, weights)`` pairs, and is called again
        for every pass; one epoch is one E-step.  Each block goes through
        the model's E-step (``diag_estep`` for float32 'diag' and
        'spherical' on the card, the torch pass otherwise) and its
        statistics come to the host in one copy per block and restart,
        summed in float64 in block order; the M-step is the float64 host
        M-step.  The trajectory is that of an in-memory host-loop fit of the
        concatenated blocks up to the summation order.  Under a mesh every
        rank keeps its share of each block and the statistics reduce over
        the data axis.

        The passes before the epochs: the weighted centering shift (float64
        on the host), the total scatter for 'tied', the init
        (``means_init``: none; 'random': one reservoir pass; 'k-means++': a
        streamed k-means||; 'kmeans': that, then each restart's own
        ``KMeans.fit_stream`` of 20 epochs), and one hard-assignment epoch.
        ``n_init`` restarts share each epoch's pass (the 'kmeans' refinement
        excepted) and the highest final ``lower_bound_`` wins.  ``prefetch``,
        ``resume`` (``n_init == 1``; up to ``max_iter`` more epochs),
        ``checkpoint_every``, ``io_retries``, ``io_backoff`` and
        ``on_nonfinite`` as in ``KMeans.fit_stream``; the init passes stay
        synchronous."""
        from kmeans_tpu_torch.data.io import IOStats, resilient_blocks
        from kmeans_tpu_torch.data.prefetch import (check_prefetch,
                                                    close_source,
                                                    prefetch_iter)
        from kmeans_tpu_torch.models.init import (
            _split_block, streamed_forgy_init, streamed_kmeans_parallel_init)
        prefetch = check_prefetch(prefetch)
        checkpoint_every = self._check_ckpt(checkpoint_every,
                                            checkpoint_path)
        self.cov_jitter_retries_ = 0
        resume = self._resolve_resume(resume) and self.means_ is not None
        if resume and self.n_init != 1:
            raise ValueError("fit_stream resume requires n_init == 1")
        io_stats = IOStats()
        make_blocks = resilient_blocks(
            make_blocks, io_retries=io_retries, io_backoff=io_backoff,
            on_nonfinite=on_nonfinite, stats=io_stats)
        self.checkpoint_segments_ = 0 if checkpoint_every else None
        if d is None:
            peek_it = iter(make_blocks())
            try:
                item = next(peek_it)
            except StopIteration:
                raise ValueError(
                    "make_blocks() yielded no rows — it must return a "
                    "FRESH iterable on every call") from None
            finally:
                close_source(peek_it)
            peek = np.asarray(item[0] if isinstance(item, tuple) else item,
                              dtype=self.dtype)
            if peek.ndim != 2:
                raise ValueError(f"blocks must be 2-D (m, D), got shape "
                                 f"{peek.shape}")
            d = peek.shape[1]
            del peek, item
        mesh = self._resolve_mesh()
        fleet_barrier("fit-stream-start", mesh)
        ct = self.covariance_type
        k = self.n_components
        mode = self._mode()
        pipeline = self._note_estep_path(mode)
        self.loop_path_ = "host"

        # Pass: the weighted centering shift and the positive rows, float64
        # on the host.
        sx = np.zeros(d)
        sw_total = 0.0
        n_rows = n_pos = 0
        with contextlib.closing(prefetch_iter(
                make_blocks(), prefetch,
                lambda item: _split_block(item, d, np.float64))) as it:
            for block, bw in it:
                n_rows += block.shape[0]
                if bw is None:
                    sx += block.sum(axis=0)
                    sw_total += block.shape[0]
                    n_pos += block.shape[0]
                else:
                    sx += (block * bw[:, None]).sum(axis=0)
                    sw_total += float(bw.sum())
                    n_pos += int((bw > 0).sum())
        if n_rows == 0:
            raise ValueError("make_blocks() yielded no rows — it must "
                             "return a FRESH iterable on every call")
        if n_pos == 0:
            raise ValueError("total sample weight must be positive")
        if n_pos < k:
            raise ValueError(f"Not enough data points ({n_pos}) to "
                             f"initialize {k} clusters")
        self.shift_ = sx / sw_total
        shift = self.shift_
        stager = BlockStager(self.device, self.dtype, prefetch, mesh)
        step_fn = None

        def stage_block(item):
            block, bw = _split_block(item, d, self.dtype)
            return stager.stage(block, bw)

        def epoch_stats(tables_list):
            """One pass: each table set's E statistics, summed in float64
            on the host in block order."""
            nonlocal step_fn
            acc = [None] * len(tables_list)
            with contextlib.closing(prefetch_iter(
                    make_blocks(), prefetch, stage_block)) as it:
                for staged in it:
                    points, weights = stager.take(staged)
                    if step_fn is None:         # chunk of the first block
                        step_fn = self._make_step(
                            mesh, self.chunk_size or choose_em_chunk(
                                points.shape[0], self._tile_k(d)),
                            mode, pipeline)
                    outs = [step_fn(points, weights, *t)
                            for t in tables_list]
                    for i, st in enumerate(outs):
                        host = self._host(st)
                        acc[i] = host if acc[i] is None else type(host)(
                            *[a + b for a, b in zip(acc[i], host)])
                    del points, weights, staged, outs
            if acc[0] is None:
                raise ValueError(
                    "make_blocks() yielded no rows — it must return a "
                    "FRESH iterable on every call (one epoch per EM "
                    "iteration)")
            return acc

        if ct == "tied":
            # The tied M-step's total scatter: one pass per fit.
            total = np.zeros((d, d))
            shift_dev = self._put(shift)
            with contextlib.closing(prefetch_iter(
                    make_blocks(), prefetch, stage_block)) as it:
                for staged in it:
                    points, weights = stager.take(staged)
                    total += total_scatter(points, weights, shift_dev,
                                           mesh).to(torch.float64).cpu(
                                               ).numpy()
                    del points, weights, staged
            self._total_scatter = total

        if resume:
            # EM continues from the fitted float64 parameters; the passes
            # above give the same shift and scatter again, and the epoch
            # count goes on from ``n_iter_``.
            base_iter = self.n_iter_
            params = [(np.asarray(self.weights_, np.float64),
                       np.asarray(self.means_, np.float64),
                       np.asarray(self.covariances_, np.float64))]
            states = [_StreamRestart()]
            states[0].prev = states[0].ll = self.lower_bound_
            states[0].n_iter = base_iter
            return self._fit_stream_epochs(
                shift, params, states, base_iter, epoch_stats, io_stats,
                checkpoint_every, checkpoint_path)

        seeds = self._restart_seeds()
        if self.means_init is not None:
            means = np.asarray(self.means_init, np.float64)
            if means.shape != (k, d):
                raise ValueError(f"means_init shape {means.shape} != "
                                 f"({k}, {d})")
            means_list = [means]
        elif self.init_params == "random":
            outs, _ = streamed_forgy_init(make_blocks, k, seeds, d,
                                          self.dtype)
            means_list = [np.asarray(m, np.float64) for m in outs]
        else:
            km_mode = "kernel" if self.device.type == "cuda" and \
                self.dtype == np.dtype(np.float32) else "matmul"
            outs, _ = streamed_kmeans_parallel_init(
                make_blocks, k, seeds, d, self.dtype, mode=km_mode,
                device=self.device)
            means_list = [np.asarray(m, np.float64) for m in outs]
            if self.init_params == "kmeans":
                # Each restart's own streamed Lloyd refinement, 'resample'
                # as the in-memory init's KMeans.
                refined = []
                for m, s in zip(means_list, seeds):
                    km = KMeans(k=k, seed=s, init=m.astype(self.dtype),
                                max_iter=20, verbose=False, mesh=mesh,
                                compute_labels=False,
                                empty_cluster="resample", dtype=self.dtype,
                                device=self.device)
                    km.fit_stream(make_blocks, d=d, prefetch=prefetch)
                    refined.append(np.asarray(km.centroids, np.float64))
                means_list = refined

        # The hard-assignment epoch gives each restart its first
        # parameters.
        hard_stats = epoch_stats([self._hard_tables(m, shift)
                                  for m in means_list])
        states = [_StreamRestart() for _ in means_list]
        params = []
        w_total0 = None
        for m, st in zip(means_list, hard_stats):
            w_total0, (pi, mu_c, var) = self._m_step(st)
            mu = (mu_c + shift) if self.means_init is None else m
            if self.weights_init is not None:
                pi = np.asarray(self.weights_init, np.float64)
                pi = pi / pi.sum()
            if self.precisions_init is not None:
                var = self._cov_from_precisions_init()
            params.append((pi, mu, var))
        if w_total0 is not None and w_total0 <= 0:
            raise ValueError("total sample weight must be positive")
        return self._fit_stream_epochs(
            shift, params, states, 0, epoch_stats, io_stats,
            checkpoint_every, checkpoint_path)

    def _fit_stream_epochs(self, shift, params, states, base_iter,
                           epoch_stats, io_stats, checkpoint_every,
                           checkpoint_path) -> "GaussianMixture":
        """The interleaved EM epochs and the winner, for fresh and resumed
        streamed fits.  ``base_iter`` offsets the epoch number (absolute,
        so the checkpoint cadence and a resumed baseline go on as in the
        uninterrupted fit).  A restart that fails is dropped with a warning
        while others remain; one restart raises."""
        last_err = None
        self.iter_times_ = []

        def fail_restart(i, err):
            nonlocal last_err
            if len(states) == 1:
                raise err
            warnings.warn(f"GMM restart {i + 1}/{len(states)} failed "
                          f"({err}); continuing with the remaining "
                          f"restarts", UserWarning, stacklevel=3)
            states[i].failed = states[i].done = True
            states[i].ll = -np.inf
            last_err = err

        for it in range(base_iter + 1, base_iter + self.max_iter + 1):
            live, tables = [], []
            for i, s in enumerate(states):
                if s.done:
                    continue
                self.weights_, self.means_, self.covariances_ = params[i]
                try:
                    tables.append(self._params_dev(guard_cholesky=True))
                except (ValueError, np.linalg.LinAlgError) as e:
                    fail_restart(i, e)
                    continue
                live.append(i)
            if not live:
                break
            t0 = time.perf_counter()
            stats = epoch_stats(tables)
            self.iter_times_.append(time.perf_counter() - t0)
            for j, i in enumerate(live):
                st = states[i]
                w_total, (pi, mu_c, var) = self._m_step(stats[j])
                params[i] = (pi, mu_c + shift, var)
                st.ll = float(stats[j].loglik) / w_total
                st.n_iter = it
                if self.verbose and i == live[0] and is_primary(self.mesh):
                    print(f"EM iteration {it}: mean log-likelihood = "
                          f"{st.ll:.6f} "
                          f"[{self.iter_times_[-1] * 1e3:.1f} ms]",
                          flush=True)
                if not np.isfinite(st.ll):
                    if len(states) == 1:
                        self._raise_divergence("log-likelihood", it)
                    fail_restart(i, ValueError(
                        f"non-finite log-likelihood at EM iteration "
                        f"{it}"))
                    continue
                if abs(st.ll - st.prev) < self.tol:
                    st.done = True
                st.prev = st.ll
            # Epoch-boundary checkpoint (one restart): the post-epoch
            # parameters, a resume point for the same trajectory.
            if checkpoint_every and it % checkpoint_every == 0 \
                    and not states[0].failed:
                self.weights_, self.means_, self.covariances_ = params[0]
                self.lower_bound_ = states[0].ll
                self.converged_ = states[0].done
                self.n_iter_ = states[0].n_iter
                self._dev_tables = None
                self.checkpoint_segments_ += 1
                self._write_autockpt(checkpoint_path, it)

        if all(s.failed for s in states):
            raise last_err
        lls = [s.ll for s in states]
        best = int(np.argmax(lls))
        self.weights_, self.means_, self.covariances_ = params[best]
        self.lower_bound_ = states[best].ll
        self.converged_ = states[best].done
        self.n_iter_ = states[best].n_iter
        self.best_restart_ = best
        self.restart_lower_bounds_ = (np.asarray(lls, np.float64)
                                      if len(states) > 1 else None)
        self._dev_tables = None
        self.io_retries_used_ = io_stats.retries_used
        self.blocks_skipped_ = io_stats.blocks_skipped
        if checkpoint_every and self.n_iter_ % checkpoint_every:
            self.checkpoint_segments_ += 1
            self._write_autockpt(checkpoint_path, self.n_iter_)
        return self

    def predict_stream(self, make_blocks, *, prefetch: int = 2):
        """Component labels of a stream of blocks, one int32 (m,) array per
        block.  ``prefetch`` as in ``fit_stream``."""
        self._check_fitted()
        return (lab for lab, _, _ in
                self._posterior_stream(make_blocks, prefetch=prefetch))

    def score_samples_stream(self, make_blocks, *, prefetch: int = 2):
        """Per-sample log-likelihood log p(x), float64, one array per
        block."""
        self._check_fitted()
        return (lse for _, _, lse in
                self._posterior_stream(make_blocks, prefetch=prefetch))

    def _posterior_stream(self, make_blocks, prefetch: int = 0):
        """The posterior pass block by block: ``(labels, log_resp, lse)``
        per block.  Every rank of a mesh takes whole blocks (a row needs
        only the replicated tables)."""
        from kmeans_tpu_torch.data.prefetch import (check_prefetch,
                                                    prefetch_iter)
        from kmeans_tpu_torch.models.init import _block_of, _split_block
        d = self.means_.shape[1]
        stager = BlockStager(self.device, self.dtype,
                             check_prefetch(prefetch))
        tables = None

        def stage(item):
            block, _ = _split_block(_block_of(item), d, self.dtype)
            return stager.stage(block)

        with contextlib.closing(prefetch_iter(make_blocks(), prefetch,
                                              stage)) as it:
            for staged in it:
                points, _ = stager.take(staged)
                if tables is None:
                    tables = self._params_dev()
                predict_fn = _cached(
                    make_gmm_predict_fn,
                    chunk_size=self.chunk_size or choose_em_chunk(
                        points.shape[0], self._tile_k(d)),
                    cov_type=self.covariance_type)
                labels, logr, lse = predict_fn(points, *tables)
                out = (labels.cpu().numpy(),
                       logr.to(torch.float64).cpu().numpy(),
                       lse.to(torch.float64).cpu().numpy())
                del points, staged, labels, logr, lse
                yield out

    # --------------------------------------------------------------- serving

    def fitted_state(self) -> dict:
        """Serving handle (the JAX package's dictionary): a mixture is not
        stackable (per-component covariances have no packed form), so
        packed routing dispatches it on its own."""
        self._check_fitted()
        return {
            "family": "gmm",
            "model_class": type(self).__name__,
            "k": int(self.n_components),
            "d": int(self.means_.shape[1]),
            "dtype": np.dtype(self.dtype).str,
            "stackable": False,
            "normalize_inputs": False,
            "ops": ("predict", "predict_proba", "score_samples"),
        }

    def quality_profile(self, X=None) -> Optional[dict]:
        """Fit-time serving-quality reference profile: the mixing weights
        as the assignment histogram and the per-row negative
        log-likelihood (``-lower_bound_``) as the score reference; with
        ``X``, both from one posterior pass over that data; else the
        profile restored from a checkpoint."""
        from kmeans_tpu_torch.obs import drift as obs_drift
        if X is not None:
            self._check_fitted()
            labels = self.predict(X)
            lse = self.score_samples(X)
            return obs_drift.build_profile(
                family="gmm", model_class=type(self).__name__,
                k=self.n_components,
                counts=np.bincount(np.asarray(labels),
                                   minlength=self.n_components),
                score_kind="neg_log_lik",
                score_per_row=float(-np.mean(lse)),
                n_rows=float(np.asarray(labels).size))
        if self.weights_ is not None:
            return obs_drift.build_profile(
                family="gmm", model_class=type(self).__name__,
                k=self.n_components, counts=self.weights_,
                score_kind="neg_log_lik",
                score_per_row=(float(-self.lower_bound_)
                               if np.isfinite(self.lower_bound_)
                               else None))
        return self._quality_profile

    # -------------------------------------------------------------- predict

    def _check_fitted(self) -> None:
        if self.means_ is None:
            raise ValueError("Model must be fitted before prediction")

    def _posterior(self, X, which, params=None):
        """Output ``which`` of one posterior pass (0 labels, 1 log
        responsibilities, 2 per-row log-likelihood; a tuple of indices
        gives a tuple) as host arrays, the values in float64: every row's
        under a mesh, the rank's own rows on a process-local dataset.
        ``params``: the device tables of :meth:`_params_dev`, which a
        caller may keep (the serving engine; None: made now)."""
        self._check_fitted()
        ds = self._dataset(X)
        predict_fn = _cached(make_gmm_predict_fn, chunk_size=self._chunk(ds),
                             cov_type=self.covariance_type)
        out = predict_fn(ds.points, *(params if params is not None
                                      else self._params_dev()))

        def host(i):
            o = out[i].to(torch.float64) if i else out[i]
            return ds.gather_rows(o)

        return tuple(host(i) for i in which) if isinstance(which, tuple) \
            else host(which)

    def predict(self, X) -> np.ndarray:
        """Component labels, int32 (n,)."""
        return self._posterior(X, 0)

    def fit_predict(self, X, y=None, *, sample_weight=None) -> np.ndarray:
        """Fit, then label the same data; it is placed on the device once."""
        ds = self._dataset(X, sample_weight)
        return self.fit(ds).predict(ds)

    def predict_proba(self, X) -> np.ndarray:
        """Responsibilities, float64 (n, k)."""
        return np.exp(self._posterior(X, 1))

    def score_samples(self, X) -> np.ndarray:
        """Per-sample log-likelihood log p(x), float64 (n,)."""
        return self._posterior(X, 2)

    def score(self, X, y=None) -> float:
        """Mean per-sample log-likelihood (sklearn convention)."""
        return float(np.mean(self.score_samples(X)))

    def sample(self, n_samples: int = 1):
        """Draw ``(X, component_labels)`` from the fitted mixture, with the
        JAX package's host draws (``np.random.default_rng(seed)``)."""
        self._check_fitted()
        rng = np.random.default_rng(self.seed)
        comp = rng.choice(self.n_components, size=n_samples,
                          p=self.weights_ / self.weights_.sum())
        d = self.means_.shape[1]
        z = rng.standard_normal((n_samples, d))
        ct = self.covariance_type
        if ct in ("diag", "spherical"):
            X = self.means_[comp] + z * np.sqrt(self._diag_view()[comp])
        else:
            # x = mu + L z with Sigma = L L^T.
            L = np.linalg.cholesky(np.asarray(self.covariances_,
                                              np.float64))
            X = self.means_[comp] + (
                np.einsum("nde,ne->nd", L[comp], z) if ct == "full"
                else z @ L.T)
        return X.astype(self.dtype), comp.astype(np.int32)

    # ----------------------------------------------------- model selection

    @property
    def precisions_cholesky_(self) -> np.ndarray:
        """sklearn's parameterisation: P with Sigma^-1 = P P^T for 'tied'
        and 'full', 1 / sqrt(variance) for 'diag' and 'spherical'."""
        self._check_fitted()
        if self.covariance_type in ("diag", "spherical"):
            return 1.0 / np.sqrt(self.covariances_)
        return self._prec_chol(np.asarray(self.covariances_,
                                          np.float64))[0]

    @property
    def precisions_(self) -> np.ndarray:
        self._check_fitted()
        if self.covariance_type in ("diag", "spherical"):
            return 1.0 / self.covariances_
        p = self.precisions_cholesky_
        return p @ np.swapaxes(p, -1, -2)

    @staticmethod
    def _n_parameters_for(k: int, d: int, cov_type: str) -> int:
        """Free parameters per covariance type (sklearn's count, the BIC /
        AIC penalty), at any k."""
        cov_params = {"diag": k * d, "spherical": k,
                      "tied": d * (d + 1) // 2,
                      "full": k * d * (d + 1) // 2}[cov_type]
        return (k - 1) + k * d + cov_params

    def _n_parameters(self) -> int:
        return self._n_parameters_for(self.n_components,
                                      self.means_.shape[1],
                                      self.covariance_type)

    @staticmethod
    def _n_rows(X) -> int:
        if isinstance(X, (Dataset, torch.Tensor)):
            return int(X.n if isinstance(X, Dataset) else X.shape[0])
        return np.asarray(X).shape[0]

    def bic(self, X) -> float:
        n = self._n_rows(X)
        return -2.0 * self.score(X) * n + self._n_parameters() * math.log(n)

    def aic(self, X) -> float:
        n = self._n_rows(X)
        return -2.0 * self.score(X) * n + 2.0 * self._n_parameters()

    # ------------------------------------------------------------ checkpoint

    def _state_dict(self) -> dict:
        """Serialisable state in the JAX package's checkpoint vocabulary,
        with the model's own ``host_loop`` and ``pipeline`` (no model axis:
        ``model_shards=1``), the jitter ladder's count and the topology
        block (``meta_mesh_*``)."""
        fitted = self.means_ is not None
        state = {
            "model_class": type(self).__name__,
            "n_components": self.n_components,
            "covariance_type": self.covariance_type,
            "tol": self.tol, "reg_covar": self.reg_covar,
            "max_iter": self.max_iter, "n_init": self.n_init,
            "init_params": self.init_params, "seed": self.seed,
            "model_shards": 1, "chunk_size": self.chunk_size,
            "host_loop": self.host_loop, "pipeline": self.pipeline,
            "bucket": self.bucket, "overlap": self.overlap,
            "ingest": self.ingest, "verbose": self.verbose,
            "dtype": str(self.dtype),
            "weights_": np.asarray(self.weights_) if fitted
            else np.zeros((0,)),
            "means_": np.asarray(self.means_) if fitted
            else np.zeros((0, 0)),
            "covariances_": np.asarray(self.covariances_) if fitted
            else np.zeros((0, 0)),
            "shift_": np.asarray(self._shift()) if fitted
            else np.zeros((0,)),
            "converged_": bool(self.converged_),
            "n_iter_": int(self.n_iter_),
            "lower_bound_": float(self.lower_bound_),
            "best_restart_": int(self.best_restart_),
            "restart_lower_bounds_":
                np.asarray(self.restart_lower_bounds_)
                if self.restart_lower_bounds_ is not None
                else np.zeros((0,)),
            "cov_jitter_retries_": int(self.cov_jitter_retries_),
        }
        state.update(self._ckpt_meta())
        state["quality_profile"] = self.quality_profile()
        # Explicit init arrays are configuration: a loaded model that is
        # fitted again seeds as the original did.
        for name in ("weights_init", "means_init", "precisions_init"):
            value = getattr(self, name)
            if value is not None:
                state[f"cfg_{name}"] = np.asarray(value)
        # The device loop's raw carry, the JAX package's ``dev_*`` entries:
        # a device fit resumed from them gives the uninterrupted bits.
        raw = self._dev_tables
        if raw is not None:
            state["dev_means_c"] = np.asarray(raw["means_c"])
            state["dev_cov"] = np.asarray(raw["cov"])
            state["dev_log_w"] = np.asarray(raw["log_w"])
            state["dev_prev_ll"] = float(raw["prev_ll"])
            state["dev_cov_type"] = raw["cov_type"]
        return state

    @classmethod
    def _from_state(cls, state: dict, device=None,
                    mesh=None) -> "GaussianMixture":
        """A model from a checkpoint dictionary written by either package.
        Arguments the port does not have are dropped with one warning; the
        device loop's raw tables (``dev_*``) are read too."""
        dropped = []
        for name, (allowed, _) in _LATER_ARGS.items():
            if name in state and not _is_allowed(state[name], allowed):
                dropped.append(f"{name}={state[name]!r}")
        if dropped:
            warnings.warn(
                "kmeans_tpu_torch does not have these arguments of the saved "
                "model and dropped them: " + ", ".join(dropped),
                UserWarning, stacklevel=3)
        inits = {name: state[f"cfg_{name}"]
                 for name in ("weights_init", "means_init",
                              "precisions_init")
                 if f"cfg_{name}" in state}
        chunk = state.get("chunk_size")
        pipeline = state.get("pipeline", "auto")

        def str_or_int(value):
            # A saved int comes back from the .npz as a 0-d array.
            return value if isinstance(value, str) else int(value)

        model = cls(n_components=int(state["n_components"]),
                    covariance_type=str(state["covariance_type"]),
                    tol=float(state["tol"]),
                    reg_covar=float(state["reg_covar"]),
                    max_iter=int(state["max_iter"]),
                    n_init=int(state.get("n_init", 1)),
                    init_params=str(state["init_params"]),
                    seed=int(state["seed"]),
                    chunk_size=None if chunk is None else int(chunk),
                    host_loop=bool(state.get("host_loop", True)),
                    pipeline=("auto" if str(pipeline) == "auto"
                              else int(pipeline)),
                    bucket=str_or_int(state.get("bucket", 0)),
                    overlap=str_or_int(state.get("overlap", "auto")),
                    ingest=str(state.get("ingest", "auto")),
                    verbose=bool(state["verbose"]),
                    dtype=np.dtype(str(state["dtype"])), device=device,
                    mesh=mesh, **inits)
        model._restore_fitted(state)
        return model

    def _restore_fitted(self, state: dict) -> None:
        """The fitted state of a checkpoint (either package's) onto this
        model, the raw device tables (``dev_*``) too: ``load``,
        ``fit(resume=<path>)`` and a rollback come here."""
        self._quality_profile = state.get("quality_profile")
        if np.asarray(state["means_"]).size:
            self.weights_ = np.asarray(state["weights_"], np.float64)
            self.means_ = np.asarray(state["means_"], np.float64)
            self.covariances_ = np.asarray(state["covariances_"],
                                           np.float64)
            self.shift_ = np.asarray(state["shift_"], np.float64)
            self.converged_ = bool(state["converged_"])
            self.n_iter_ = int(state["n_iter_"])
            self.lower_bound_ = float(state["lower_bound_"])
            self.best_restart_ = int(state.get("best_restart_", 0))
            self.cov_jitter_retries_ = int(state.get("cov_jitter_retries_",
                                                     0))
            rlb = state.get("restart_lower_bounds_")
            self.restart_lower_bounds_ = (
                np.asarray(rlb, np.float64)
                if rlb is not None and np.asarray(rlb).size else None)
        # A stale carry of an earlier fit must not survive a restore.
        self._dev_tables = None
        if "dev_means_c" in state:
            ct = str(state.get("dev_cov_type", self.covariance_type))
            k = self.n_components
            cov = np.asarray(state["dev_cov"])
            self._dev_tables = {
                "cov_type": ct,
                "means_c": np.asarray(state["dev_means_c"])[:k],
                "cov": cov if ct == "tied" else cov[:k],
                "log_w": np.asarray(state["dev_log_w"])[:k],
                "prev_ll": float(state["dev_prev_ll"]),
            }

    def save(self, path) -> None:
        """Write the fitted state and the explicit init arrays as one
        ``.npz`` checkpoint, on the primary rank under a mesh (every rank
        calls it)."""
        ckpt.save_state_primary(path, self._state_dict(), self.mesh)

    @classmethod
    def load(cls, path, device=None, mesh=None) -> "GaussianMixture":
        """Load a checkpoint written by this package or by the JAX package,
        on any mesh.  ``device`` and ``mesh`` as in the constructor."""
        return cls._from_state(ckpt.load_state(path), device=device,
                               mesh=mesh)

    # -------------------------------------------------------------- params

    def get_params(self, deep: bool = True) -> dict:
        params = {name: getattr(self, name) for name in self._PARAM_NAMES}
        params["device"] = str(self.device)
        return params

    def set_params(self, **params) -> "GaussianMixture":
        """New values go through ``__init__``, so they get the
        constructor's validation; fitted state is kept."""
        for name in params:
            if name not in self._PARAM_NAMES:
                raise ValueError(f"invalid parameter {name!r} for "
                                 f"GaussianMixture")
        merged = self.get_params()
        merged.update(params)
        saved = dict(self.__dict__)
        try:
            self.__init__(**merged)
        except Exception:
            self.__dict__.clear()
            self.__dict__.update(saved)
            raise
        for name, value in saved.items():
            if name not in self._PARAM_NAMES:
                self.__dict__[name] = value
        return self
