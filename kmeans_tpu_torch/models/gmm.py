"""Gaussian mixture on NVIDIA GPUs: EM for 'diag' and 'spherical'
covariances (scikit-learn-style API).

Counterpart of ``kmeans_tpu/models/gmm.py`` for its host-loop path, on one
device or over the data axis of a mesh (each rank's E pass on its block of
the rows, the statistics summed over the axis).  The data is placed on the
device once; each EM iteration is one E-step on the
device (``parallel.gmm_step``; on the card one launch of the fused CUDA
kernel ``diag_estep``) that returns the responsibility sums, the first and
second moments and the log-likelihood, and the host does the M-step in
float64.  Every E pass works in a frame centered on the data's weighted
mean (``shift_``), so that ``S2/R - mu^2`` does not cancel for data far from
the origin; the shift is added back to the means.

The model runs on the card unless the caller asks for the CPU:
``device=None`` means ``cuda`` and raises where there is none.  The E-step
kernel computes in float32, so the dtype picks the E-step
(:func:`estep_mode`): a float32 mixture on the card runs the kernel, a
float64 one the chunked torch pass in float64 on the card.

Behaviour kept from the JAX package: the constructor's arguments and
validation; ``init_params`` 'kmeans' / 'k-means++' (an internal ``KMeans``
seeded with k-means++, 20 Lloyd iterations or 1) and 'random' (Forgy rows),
with the same host NumPy draws; explicit ``weights_init`` / ``means_init``
/ ``precisions_init``; the hard-assignment init E-step; the float64 M-step
with sklearn's update rules and floors; ``lower_bound_`` the mean
per-sample log-likelihood, stopping on ``|change| < tol``, a hard error on a
non-finite one; ``n_init`` restarts in sequence, the highest final
``lower_bound_`` wins; ``sample`` with the same draws; the ``.npz``
checkpoint in the same vocabulary, so that either package loads the other's
files.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from kmeans_tpu_torch.models.init import forgy_init
from kmeans_tpu_torch.models.kmeans import (KMeans,
                                             NumericalDivergenceError,
                                             _later, resolve_device)
from kmeans_tpu_torch.parallel.gmm_step import (EStats, make_gmm_predict_fn,
                                                make_gmm_step_fn)
from kmeans_tpu_torch.parallel.mesh import (DATA_AXIS, all_reduce,
                                            check_mesh, group_up,
                                            is_primary, make_mesh,
                                            mesh_shape)
from kmeans_tpu_torch.parallel.sharding import (Dataset, ShardedDataset,
                                                choose_em_chunk, to_device,
                                                weighted_mean)
from kmeans_tpu_torch.utils import checkpoint as ckpt
from kmeans_tpu_torch.utils.validation import check_finite_array

#: Softmax sharpness of the hard-assignment init pass: with a precision this
#: large the nearest mean's log-density dominates by far more than the
#: float32 range, so the responsibilities are one-hot.
_HARD_INV_VAR = 1e6

_COV_TYPES = ("diag", "spherical", "tied", "full")
_A8 = "A.8 'GaussianMixture'"

#: Constructor arguments of the JAX package that the port does not have
#: yet: name -> (the values that name what the port does anyway, ROADMAP
#: item).  Any other value raises NotImplementedError.
_LATER_ARGS = {
    "model_shards": ((1,), "A.18 'GaussianMixture on the model axis'"),
    "host_loop": ((True,), _A8 + ": the device EM loop"),
    "pipeline": (("auto", 0, False), _A8 + ": the device EM loop"),
    "bucket": ((0,), "A.14 'Orchestrator, warm start, lint, CLIs and "
                     "bench'"),
    "overlap": (("auto", 0, False), "A.14 'Orchestrator, warm start, "
                                    "lint, CLIs and bench'"),
    "ingest": (("auto", "mono"), "A.10 'Streaming and ingest'"),
}


def estep_mode(device_type: str, dtype, covariance_type: str) -> str:
    """The E-step a mixture runs: 'kernel' (the fused CUDA kernel, a
    float32 engine) for float32 'diag' and 'spherical' mixtures on a CUDA
    device, else 'torch' (the chunked torch pass, in the model's dtype, on
    its device).  A rule of the dtype, not a fallback: a float64 mixture
    asked for float64 arithmetic."""
    if device_type == "cuda" and np.dtype(dtype) == np.float32 \
            and covariance_type in ("diag", "spherical"):
        return "kernel"
    return "torch"


def _is_allowed(value, allowed) -> bool:
    return any(value is a or (type(value) is type(a) and value == a)
               for a in allowed)


class GaussianMixture:
    """Gaussian mixture with diagonal ('diag') or per-component scalar
    ('spherical') covariances, fitted by EM on one device.

    Parameters follow ``sklearn.mixture.GaussianMixture`` where they
    overlap (``n_components``, ``covariance_type``, ``tol``, ``reg_covar``,
    ``max_iter``, ``n_init``, ``init_params``, ``weights_init``,
    ``means_init``, ``precisions_init``); ``seed``, ``dtype``,
    ``chunk_size`` and ``verbose`` follow this package's ``KMeans``.
    ``device``: None (the card) | 'cuda' | 'cuda:N' | 'cpu'.  ``mesh``: as
    in ``KMeans``, its data axis only.

    The JAX package's other arguments (``model_shards``, ``host_loop``,
    ``pipeline``, ``bucket``, ``overlap``, ``ingest``) are taken only at the
    values that name what this port does (no model axis, the host loop, the
    serial E pass); 'tied' and 'full', a mesh with a model axis, and any
    other value raise ``NotImplementedError`` naming the ROADMAP item that
    brings them.

    ``estep_path_`` records what the last fit ran (:func:`estep_mode`):
    'kernel' (the fused CUDA kernel) for float32 on the card, 'serial' (the
    chunked torch pass) for float64 on the card and on the CPU.
    ``iter_times_`` holds the wall seconds of each EM iteration of the
    winning restart.
    """

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
        if covariance_type not in _COV_TYPES:
            raise ValueError(
                "covariance_type must be one of 'diag', 'spherical', "
                f"'tied', 'full'; got {covariance_type!r}")
        if covariance_type in ("tied", "full"):
            raise _later("covariance_type", covariance_type,
                         _A8 + ": 'tied' and 'full'")
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
        later = dict(model_shards=model_shards,
                     host_loop=bool(host_loop), pipeline=pipeline,
                     bucket=bucket, overlap=overlap, ingest=ingest)
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
        self.ingest = ingest
        self.verbose = verbose
        self.device = resolve_device(device)

        self.estep_path_: Optional[str] = None
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

    # ------------------------------------------------------------- plumbing

    def _mode(self) -> str:
        """The E-step of this model: :func:`estep_mode`."""
        return estep_mode(self.device.type, self.dtype,
                          self.covariance_type)

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
        ds = to_device(X, self.device, self.dtype,
                       sample_weight=sample_weight, mesh=mesh,
                       chunk=self.chunk_size, k_hint=self.n_components)
        if not isinstance(X, Dataset):
            if ds.host is not None:
                check_finite_array(ds.host, "Data contains NaN or Inf values")
            else:
                finite = torch.isfinite(ds.points).all().to(
                    torch.int32).reshape(1)
                if not int(all_reduce(finite, mesh, (DATA_AXIS,), "min")):
                    raise ValueError("Data contains NaN or Inf values")
        return ds

    def _chunk(self, ds: Dataset) -> int:
        return self.chunk_size or choose_em_chunk(ds.points.shape[0],
                                                  self.n_components)

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

    def _params_dev(self):
        """E-step tables on the device: ``(shift, means_c, inv_var,
        log_det, log_weights)``.  Precision and log-determinant come from
        the same covariance, floored at the compute dtype's ``tiny``."""
        shift = self._shift()
        log_w = np.log(np.maximum(self.weights_, 1e-300))
        cv = np.maximum(self._diag_view(),
                        max(self.reg_covar, float(np.finfo(self.dtype).tiny)))
        var = self._put(cv)
        return (self._put(shift), self._put(self.means_ - shift), 1.0 / var,
                torch.log(var).sum(dim=1), self._put(log_w))

    def _hard_tables(self, means: np.ndarray, shift: np.ndarray):
        """E-step tables of the hard-assignment init pass: a precision far
        above the data's scale makes the responsibilities one-hot."""
        k, d = means.shape
        return (self._put(shift), self._put(means - shift),
                self._put(np.full((k, d), _HARD_INV_VAR)),
                self._put(np.zeros(k)), self._put(np.zeros(k)))

    @staticmethod
    def _host(st: EStats) -> EStats:
        return EStats(*(t.to(torch.float64).cpu().numpy() for t in st))

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
            # 'k-means++' keeps the seeds (one iteration).
            km = KMeans(k=k, seed=seed, init="kmeans++",
                        max_iter=20 if self.init_params == "kmeans" else 1,
                        verbose=False, compute_labels=False,
                        empty_cluster="resample", dtype=self.dtype,
                        distance_mode=("auto" if self._mode() == "kernel"
                                       else "matmul"),
                        device=self.device, mesh=ds.mesh)
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
        self.covariances_ = (1.0 / np.asarray(self.precisions_init,
                                              np.float64)
                             if self.precisions_init is not None else var)
        self.weights_ = self.weights_ / self.weights_.sum()
        return w_total

    # ------------------------------------------------------------------- EM

    def _m_step(self, st: EStats):
        """float64 host M-step from centered-frame statistics (sklearn's
        update rules); the returned means are centered too."""
        R = np.asarray(st.resp_sum, np.float64)
        S1 = np.asarray(st.xsum, np.float64)
        w_total = float(R.sum())
        Rc = np.maximum(R, 10 * np.finfo(np.float64).tiny)
        mu = S1 / Rc[:, None]
        # tiny floor: reg_covar = 0 must not leave exact-zero variances.
        floor = max(self.reg_covar, np.finfo(np.float64).tiny)
        S2 = np.asarray(st.x2sum, np.float64)
        var = S2 / Rc[:, None] - mu ** 2 + self.reg_covar
        var = np.maximum(var, floor)
        if self.covariance_type == "spherical":
            var = var.mean(axis=1)
        pi = np.maximum(R / max(w_total, 1e-300), 1e-300)
        return w_total, (pi / pi.sum(), mu, var)

    def fit(self, X, sample_weight=None, *, resume=False,
            checkpoint_every: int = 0,
            checkpoint_path=None) -> "GaussianMixture":
        """Fit by EM on an (n, D) array-like, a tensor or a
        :class:`Dataset`.  ``sample_weight`` (n,) weights every statistic
        (the second positional argument, as in the JAX package).
        ``resume=True`` continues EM from the current parameters for up to
        ``max_iter`` more iterations (``n_init`` must be 1)."""
        if not isinstance(resume, bool):
            raise _later("resume", resume,
                         "A.9 'Fault tolerance': resuming from a path")
        if checkpoint_every or checkpoint_path is not None:
            raise _later("checkpoint_every", checkpoint_every,
                         "A.9 'Fault tolerance'")
        ds = self._dataset(X, sample_weight)
        mode = self._mode()
        step_fn = make_gmm_step_fn(ds.mesh, chunk_size=self._chunk(ds),
                                   mode=mode)
        self.estep_path_ = "kernel" if mode == "kernel" else "serial"
        self.shift_ = weighted_mean(ds.points, ds.weights, ds.mesh).to(
            torch.float64).cpu().numpy()
        if resume and self.means_ is not None:
            if self.n_init != 1:
                raise ValueError("fit(resume=True) requires n_init == 1 "
                                 "(the restart sweep re-initializes)")
            self._fit_one(ds, step_fn, self.seed, resume=True)
            return self
        seeds = self._restart_seeds()
        self.best_restart_ = 0
        self.restart_lower_bounds_ = None
        best = None
        lls = []
        last_err = None
        for r, seed in enumerate(seeds):
            try:
                self._fit_one(ds, step_fn, seed)
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
                best = {name: getattr(self, name) for name in (
                    "weights_", "means_", "covariances_", "converged_",
                    "n_iter_", "lower_bound_", "iter_times_")}
                best["restart"] = r
        if best is None:
            raise last_err
        self.best_restart_ = best.pop("restart")
        for name, value in best.items():
            setattr(self, name, value)
        self.restart_lower_bounds_ = np.asarray(lls, np.float64)
        return self

    def _fit_one(self, ds: Dataset, step_fn, seed: int,
                 resume: bool = False) -> None:
        """One restart: the host loop.  One E-step on the device per
        iteration; its statistics come to the host as float64, which is also
        the iteration's synchronisation point."""
        if not resume:
            if self._init_params(ds, step_fn, seed) <= 0:
                raise ValueError("total sample weight must be positive")
        self.converged_ = False
        self.iter_times_ = []
        base = self.n_iter_ if resume else 0
        prev = self.lower_bound_ if resume else -np.inf
        shift = self._shift()
        for it in range(base + 1, base + self.max_iter + 1):
            t0 = time.perf_counter()
            st = step_fn(ds.points, ds.weights, *self._params_dev())
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
                raise NumericalDivergenceError(it, "log-likelihood")
            if abs(self.lower_bound_ - prev) < self.tol:
                self.converged_ = True
                break
            prev = self.lower_bound_

    # ------------------------------------------------- not ported (raising)

    def fit_stream(self, *args, **kwargs):
        raise _later("fit_stream", "...", "A.10 'Streaming and ingest'")

    def predict_stream(self, *args, **kwargs):
        raise _later("predict_stream", "...", "A.10 'Streaming and ingest'")

    def score_samples_stream(self, *args, **kwargs):
        raise _later("score_samples_stream", "...",
                     "A.10 'Streaming and ingest'")

    def sweep(self, *args, **kwargs):
        raise _later("sweep", "...", _A8 + ": the batched restart sweep")

    def fitted_state(self):
        raise _later("fitted_state", "...", "A.12 'Serving'")

    def quality_profile(self, X=None):
        raise _later("quality_profile", "...", "A.13 'Observability'")

    # -------------------------------------------------------------- predict

    def _check_fitted(self) -> None:
        if self.means_ is None:
            raise ValueError("Model must be fitted before prediction")

    def _posterior(self, X, which: int):
        """Output ``which`` of the posterior pass (0 labels, 1 log
        responsibilities, 2 per-row log-likelihood) as a host array: every
        row's under a mesh, the rank's own rows on a process-local
        dataset."""
        self._check_fitted()
        ds = self._dataset(X)
        predict_fn = make_gmm_predict_fn(chunk_size=self._chunk(ds))
        out = predict_fn(ds.points, *self._params_dev())[which]
        if which:
            out = out.to(torch.float64)
        if isinstance(ds, ShardedDataset):
            return ds.gather_rows(out)
        return out.cpu().numpy()

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
        X = self.means_[comp] + z * np.sqrt(self._diag_view()[comp])
        return X.astype(self.dtype), comp.astype(np.int32)

    # ----------------------------------------------------- model selection

    @property
    def precisions_cholesky_(self) -> np.ndarray:
        """sklearn's parameterisation: 1 / sqrt(variance)."""
        self._check_fitted()
        return 1.0 / np.sqrt(self.covariances_)

    @property
    def precisions_(self) -> np.ndarray:
        self._check_fitted()
        return 1.0 / self.covariances_

    def _n_parameters(self) -> int:
        """Free parameters (sklearn's count, the BIC / AIC penalty)."""
        k, d = self.n_components, self.means_.shape[1]
        cov = k * d if self.covariance_type == "diag" else k
        return (k - 1) + k * d + cov

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
        """Serialisable state in the JAX package's checkpoint vocabulary:
        the host loop is written as ``model_shards=1, host_loop=True``, so
        that the JAX package loads the file, with the topology block
        (``meta_mesh_*``)."""
        fitted = self.means_ is not None
        state = {
            "model_class": type(self).__name__,
            "n_components": self.n_components,
            "covariance_type": self.covariance_type,
            "tol": self.tol, "reg_covar": self.reg_covar,
            "max_iter": self.max_iter, "n_init": self.n_init,
            "init_params": self.init_params, "seed": self.seed,
            "model_shards": 1, "chunk_size": self.chunk_size,
            "host_loop": True, "pipeline": self.pipeline,
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
        }
        state.update(ckpt.topology_meta(self.mesh, self.dtype))
        # Explicit init arrays are configuration: a loaded model that is
        # fitted again seeds as the original did.
        for name in ("weights_init", "means_init", "precisions_init"):
            value = getattr(self, name)
            if value is not None:
                state[f"cfg_{name}"] = np.asarray(value)
        return state

    @classmethod
    def _from_state(cls, state: dict, device=None,
                    mesh=None) -> "GaussianMixture":
        """A model from a checkpoint dictionary written by either package.
        Arguments the port does not have are dropped with one warning; the
        JAX package's device-loop tables (``dev_*``) are read as absent."""
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
        model = cls(n_components=int(state["n_components"]),
                    covariance_type=str(state["covariance_type"]),
                    tol=float(state["tol"]),
                    reg_covar=float(state["reg_covar"]),
                    max_iter=int(state["max_iter"]),
                    n_init=int(state.get("n_init", 1)),
                    init_params=str(state["init_params"]),
                    seed=int(state["seed"]),
                    chunk_size=None if chunk is None else int(chunk),
                    verbose=bool(state["verbose"]),
                    dtype=np.dtype(str(state["dtype"])), device=device,
                    mesh=mesh, **inits)
        if np.asarray(state["means_"]).size:
            model.weights_ = np.asarray(state["weights_"], np.float64)
            model.means_ = np.asarray(state["means_"], np.float64)
            model.covariances_ = np.asarray(state["covariances_"],
                                            np.float64)
            model.shift_ = np.asarray(state["shift_"], np.float64)
            model.converged_ = bool(state["converged_"])
            model.n_iter_ = int(state["n_iter_"])
            model.lower_bound_ = float(state["lower_bound_"])
            model.best_restart_ = int(state.get("best_restart_", 0))
            rlb = state.get("restart_lower_bounds_")
            model.restart_lower_bounds_ = (
                np.asarray(rlb, np.float64)
                if rlb is not None and np.asarray(rlb).size else None)
        return model

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
