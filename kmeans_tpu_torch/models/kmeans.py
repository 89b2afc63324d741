"""K-Means estimator on one NVIDIA GPU (scikit-learn-style API).

Counterpart of ``kmeans_tpu/models/kmeans.py`` for its main path:
``KMeans(k, max_iter, tolerance, seed, compute_sse).fit(X)``, then
``predict``, ``centroids`` and ``sse_history``.

Execution model: the data is placed on the device once
(``parallel.sharding.Dataset``) and stays there for the whole fit.  Each
Lloyd iteration is one step on the device (``parallel.distributed``; in the
default mode one launch of the fused CUDA kernel) that returns the
per-cluster sums and counts, the SSE and the farthest point; the host loop
does only the O(k*D) work: the mean division in float64, the empty-cluster
policy, the convergence test on the largest centroid shift, and logging.

The model runs on the card unless the caller asks for the CPU:
``device=None`` means ``cuda`` and raises where there is none.

Behaviour kept from the JAX package: seeded Forgy / k-means++ initialisation
with the same host-side NumPy draws; SSE measured against the iteration's
STARTING centroids, with a warning on a rise above 1e-6; a hard error on
non-finite centroids or a non-finite SSE; deterministic empty-cluster
resampling seeded per iteration with
``np.random.default_rng([seed, iteration + 1])``; best of ``n_init``
restarts by the true final inertia; the ``.npz`` checkpoint format.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from kmeans_tpu_torch.models.init import resolve_init
from kmeans_tpu_torch.ops.assign import StepStats
from kmeans_tpu_torch.parallel import distributed as dist
from kmeans_tpu_torch.parallel.sharding import (Dataset, choose_chunk_size,
                                                to_device)
from kmeans_tpu_torch.utils import checkpoint as ckpt
from kmeans_tpu_torch.utils.logging import IterationLogger
from kmeans_tpu_torch.utils.validation import validate_params

_EMPTY_POLICIES = ("resample", "farthest", "keep")
_DISTANCE_MODES = ("auto", "kernel", "kernel_bf16", "matmul", "matmul_bf16",
                   "direct")
#: The checkpoint format's (and the JAX package's) names of the kernel modes.
_FORMAT_MODES = {"kernel": "pallas", "kernel_bf16": "pallas_bf16"}

#: Distance modes of the JAX package that the port does not have yet.
_LATER_MODES = {
    "matmul_bf16_guarded": "A.1 'the guarded mode of ops/assign.py'",
}

#: Constructor arguments of the JAX package that the port does not have yet:
#: name -> (the values that name what the port does anyway, ROADMAP item).
#: Any other value raises NotImplementedError.
_LATER_ARGS = {
    "mesh": ((None,), "A.4 'Multi-GPU data parallelism'"),
    "model_shards": ((1,), "A.4 'Multi-GPU data parallelism'"),
    "host_loop": ((True, "auto"), "A.3 'Device-side Lloyd loop'"),
    "pipeline": (("auto", 0), "A.3 'Device-side Lloyd loop'"),
    "bucket": ((0,), "A.14 'Orchestrator, warm start, lint, CLIs and "
                      "bench'"),
    "overlap": (("auto", 0), "A.14 'Orchestrator, warm start, lint, CLIs "
                             "and bench'"),
    "ingest": (("auto", "mono"), "A.10 'Streaming and ingest'"),
    "k_shard": (("auto", 0), "A.11 'Massive k and PQ'"),
    "assign": (("auto", "dense"), "A.11 'Massive k and PQ'"),
    "coarse_cells": ((None,), "A.11 'Massive k and PQ'"),
    "nprobe": ((None,), "A.11 'Massive k and PQ'"),
    "init_cap": ((None,), "A.5 'Batched restarts and k-means|| seeding'"),
}


class NumericalDivergenceError(ValueError):
    """The fit went non-finite.  Carries ``iteration`` and ``quantity``
    ('centroids' | 'log-likelihood'), with the JAX package's messages."""

    _PHRASE = {
        "centroids": "NaN or Inf detected in centroids at iteration {i}",
        "log-likelihood": "non-finite log-likelihood at EM iteration {i}",
    }

    def __init__(self, iteration: int, quantity: str = "centroids"):
        self.iteration = int(iteration)
        self.quantity = quantity
        super().__init__(self._PHRASE[quantity].format(i=iteration))


def _later(name: str, value, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name}={value!r} is not ported to kmeans_tpu_torch yet: "
        f"ROADMAP.md, {item}")


def _check_later_args(later: dict) -> None:
    for name, value in later.items():
        if name not in _LATER_ARGS:
            raise TypeError(
                f"KMeans() got an unexpected keyword argument {name!r}")
        allowed, item = _LATER_ARGS[name]
        if not any(value is a or (type(value) is type(a) and value == a)
                   for a in allowed):
            raise _later(name, value, item)


def resolve_device(device) -> torch.device:
    """``None`` is the card: ``cuda``, and an error where there is none.
    Only an explicit ``device='cpu'`` runs on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "kmeans_tpu_torch runs on an NVIDIA GPU by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU on purpose")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was asked for and "
                f"torch.cuda.is_available() is False")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class KMeans:
    """K-Means on one device.

    Parameters
    ----------
    k, max_iter, tolerance, seed, compute_sse :
        number of clusters; iteration cap; convergence threshold on the
        largest centroid shift; random seed (initialisation and
        empty-cluster resampling); whether to record ``sse_history``.
    init : 'forgy' | 'k-means++' (or 'kmeans++') | callable | (k, D) array.
    n_init : int or 'auto'.  Independent restarts; restart 0 uses ``seed``
        itself, the rest seeds derived by ``np.random.SeedSequence(seed)``;
        the restart whose final centroids have the lowest inertia wins.
    compute_labels : materialise ``labels_`` at the end of ``fit`` with one
        extra assignment pass.
    empty_cluster : 'resample' | 'farthest' | 'keep'.
    dtype : float32 (default) or float64.  In float64 the kernel modes
        compute on float32 casts of the points and centroids (the kernels
        are a float32 engine, as the JAX package's are), while the mean
        division and ``centroids`` stay float64; 'auto' is then 'matmul'.
    chunk_size : rows per chunk of the plain torch pass (None: automatic).
    distance_mode : 'auto' | 'kernel' | 'kernel_bf16' | 'matmul' |
        'matmul_bf16' | 'direct'.  'kernel' is the fused CUDA kernel
        (float32), 'kernel_bf16' its bf16 form on the tensor cores (bf16
        products, float32 sums: approximate assignments for throughput);
        'pallas' and 'pallas_bf16', the JAX package's names of those modes
        (and the checkpoints'), are read as 'kernel' and 'kernel_bf16'.
        'matmul_bf16' is the torch pass with the same bf16 rule.  On a CUDA
        device 'auto' is 'kernel' in float32, on the CPU or in float64 it is
        'matmul'; it is never a bf16 mode.
    verbose : per-iteration log lines.
    device : None (the card) | 'cuda' | 'cuda:N' | 'cpu'.

    The JAX package's other constructor arguments (``mesh``,
    ``model_shards``, ``host_loop``, ``pipeline``, ``bucket``, ``overlap``,
    ``ingest``, ``k_shard``, ``assign``, ``coarse_cells``, ``nprobe``,
    ``init_cap``) are taken only at the value that names what this port does
    (one device, host loop, dense assignment); any other value raises
    ``NotImplementedError`` naming the ROADMAP item that brings it.
    """

    def __init__(self, k: int = 3, max_iter: int = 100,
                 tolerance: float = 1e-4, seed: int = 42,
                 compute_sse: bool = False, *,
                 init: Union[str, np.ndarray, Callable] = "forgy",
                 n_init: Union[int, str] = 1,
                 compute_labels: bool = True,
                 empty_cluster: str = "resample",
                 dtype=None,
                 chunk_size: Optional[int] = None,
                 distance_mode: str = "auto",
                 verbose: bool = True,
                 device=None,
                 **later):
        _check_later_args(later)
        self.k = k
        self.max_iter = max_iter
        self.tolerance = tolerance
        self.seed = seed
        self.compute_sse = compute_sse
        self.init = init
        if isinstance(n_init, str):
            if n_init != "auto":
                raise ValueError(f"n_init must be an int >= 1 or 'auto', "
                                 f"got {n_init!r}")
            # sklearn's rule: 1 for the D^2-seeded inits, 10 for random
            # draws and callables.
            n_init = (1 if isinstance(init, str)
                      and init in ("k-means++", "kmeans++") else 10)
        if int(n_init) < 1:
            raise ValueError(f"n_init must be >= 1, got {n_init}")
        self.n_init = int(n_init)
        self.compute_labels = compute_labels
        if empty_cluster not in _EMPTY_POLICIES:
            raise ValueError(f"empty_cluster must be one of {_EMPTY_POLICIES},"
                             f" got {empty_cluster!r}")
        self.empty_cluster = empty_cluster
        self.dtype = np.dtype(dtype) if dtype is not None \
            else np.dtype(np.float32)
        if self.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
            raise ValueError(f"dtype must be float32 or float64, got "
                             f"{self.dtype}")
        self.chunk_size = chunk_size
        distance_mode = {v: k for k, v in _FORMAT_MODES.items()}.get(
            distance_mode, distance_mode)
        if distance_mode in _LATER_MODES:
            raise _later("distance_mode", distance_mode,
                         _LATER_MODES[distance_mode])
        if distance_mode not in _DISTANCE_MODES:
            raise ValueError(f"distance_mode must be one of "
                             f"{_DISTANCE_MODES}, got {distance_mode!r}")
        self.distance_mode = distance_mode
        self.verbose = verbose
        validate_params(k, max_iter, tolerance)
        self.device = resolve_device(device)

        self.centroids: Optional[np.ndarray] = None
        self.sse_history: List[float] = []
        self.iterations_run = 0
        self.cluster_sizes_: Optional[np.ndarray] = None
        self.iter_times_: List[float] = []            # wall secs/iteration
        self.best_restart_: int = 0
        self.restart_inertias_: Optional[np.ndarray] = None
        self._fit_ds: Optional[Dataset] = None        # retained for labels_
        self._labels_cache: Optional[np.ndarray] = None
        self._labels_error: Optional[str] = None

    # ----------------------------------------------------------------- setup

    def _mode(self) -> str:
        """``distance_mode`` with 'auto' resolved: the kernel on a CUDA
        device at every shape in float32; the torch pass on the CPU, and in
        float64, whose user asked for float64 arithmetic (the JAX package's
        ``resolve_auto`` rule for x64 data)."""
        if self.distance_mode != "auto":
            return self.distance_mode
        return "kernel" if self.device.type == "cuda" and \
            self.dtype == np.dtype(np.float32) else "matmul"

    def _chunk_for(self, n: int, d: int) -> int:
        tile_k = self.k * d if self._mode() == "direct" else self.k
        return self.chunk_size or choose_chunk_size(n, tile_k, d)

    def cache(self, X, sample_weight=None) -> Dataset:
        """Place X on the device once as a :class:`Dataset`; pass the result
        to ``fit`` / ``predict`` / ``score`` to skip the upload on every
        call.  ``sample_weight`` (n,) makes every statistic weighted."""
        return to_device(X, self.device, self.dtype,
                         sample_weight=sample_weight)

    def _prepare(self, X, sample_weight=None):
        ds = self.cache(X, sample_weight)
        chunk = self._chunk_for(ds.n, ds.d)
        mode = self._mode()
        return (ds, dist.make_step_fn(chunk_size=chunk, mode=mode),
                dist.make_predict_fn(chunk_size=chunk, mode=mode))

    def _put_centroids(self, centroids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(centroids, dtype=self.dtype))).to(self.device)

    # ------------------------------------------------------------------- fit

    def fit(self, X, y=None, *, sample_weight=None, resume=False,
            checkpoint_every: int = 0, checkpoint_path=None) -> "KMeans":
        """Fit on an (n, D) array-like, a tensor or a cached
        :class:`Dataset`.  Returns self; ``y`` is ignored.  ``sample_weight``
        (n,) weights every statistic."""
        if resume:
            raise _later("resume", resume, "A.9 'Fault tolerance'")
        if checkpoint_every or checkpoint_path is not None:
            raise _later("checkpoint_every", checkpoint_every,
                         "A.9 'Fault tolerance'")
        self._fit(X, sample_weight)
        if self.compute_labels:
            _ = self.labels_
        else:
            self._fit_ds = None
        return self

    def fit_stream(self, *args, **kwargs):
        raise _later("fit_stream", "...", "A.10 'Streaming and ingest'")

    def _restart_seeds(self) -> list:
        """Per-restart seeds.  Restart 0 is ``seed`` itself; an explicit
        (k, D) array makes every restart identical, so it collapses to one."""
        if not isinstance(self.init, str) and not callable(self.init):
            return [self.seed]
        extra = np.random.SeedSequence(self.seed).generate_state(
            self.n_init - 1) if self.n_init > 1 else []
        return [self.seed] + [int(s) for s in extra]

    def _init_centroids(self, ds: Dataset, seed: int) -> np.ndarray:
        centroids = resolve_init(self.init, ds, self.k, seed)
        return self._postprocess_centroids(
            np.asarray(centroids, dtype=np.float64)).astype(self.dtype)

    def _final_inertia(self, ds: Dataset, step_fn) -> float:
        """True SSE of the CURRENT centroids: one more pass
        (``sse_history[-1]`` lags one iteration)."""
        stats = step_fn(ds.points, ds.weights,
                        self._put_centroids(self.centroids))
        return float(stats.sse)

    def _fit(self, X, sample_weight) -> "KMeans":
        log = IterationLogger(self.verbose)
        ds, step_fn, _ = self._prepare(X, sample_weight)
        if self.compute_labels:
            self._fit_ds, self._labels_cache = ds, None
            self._labels_error = None
        else:
            self._fit_ds, self._labels_cache = None, None
            self._labels_error = (
                "labels_ was not materialized because "
                "compute_labels=False; call predict(X) instead")
        log.startup(self.k, self.max_iter, self.tolerance, self.compute_sse)
        self.best_restart_ = 0
        self.restart_inertias_ = None

        seeds = self._restart_seeds()
        best = None
        inertias = []
        for r, seed in enumerate(seeds):
            centroids = self._init_centroids(ds, seed)
            self.sse_history = []
            self.iterations_run = 0
            self.iter_times_ = []
            self._run_restart(ds, step_fn, centroids, seed, log)
            if len(seeds) == 1:
                return self
            inertia = self._final_inertia(ds, step_fn)
            log.restart(r, len(seeds), inertia)
            inertias.append(inertia)
            if best is None or inertia < best["inertia"]:
                best = {"inertia": inertia, "restart": r,
                        "centroids": self.centroids,
                        "sse_history": self.sse_history,
                        "iterations_run": self.iterations_run,
                        "cluster_sizes_": self.cluster_sizes_,
                        "iter_times_": self.iter_times_}
        self.centroids = best["centroids"]
        self.sse_history = best["sse_history"]
        self.iterations_run = best["iterations_run"]
        self.cluster_sizes_ = best["cluster_sizes_"]
        self.iter_times_ = best["iter_times_"]
        self.best_restart_ = best["restart"]
        self.restart_inertias_ = np.asarray(inertias, dtype=np.float64)
        return self

    def _run_restart(self, ds: Dataset, step_fn, centroids: np.ndarray,
                     seed: int, log: IterationLogger) -> "KMeans":
        """One restart: the host loop.  One step on the device per
        iteration; its sums, and its counts with the SSE behind them, come
        to the host as float64, which is also the iteration's
        synchronisation point."""
        cents_dev = self._put_centroids(centroids)
        for iteration in range(self.max_iter):
            iter_start = time.perf_counter()
            stats: StepStats = step_fn(ds.points, ds.weights, cents_dev)
            sums = stats.sums.to(torch.float64).cpu().numpy()
            tail = torch.cat([stats.counts.to(torch.float64),
                              stats.sse.to(torch.float64).reshape(1)])
            tail = tail.cpu().numpy()
            centroids, max_shift = self._finish_lloyd_iteration(
                centroids, sums, tail[:-1], float(tail[-1]), stats, ds,
                iteration, log, seed, iter_start)
            if max_shift < self.tolerance:
                log.converged(iteration + 1)
                break
            cents_dev = self._put_centroids(centroids)
        return self

    def _finish_lloyd_iteration(self, centroids, sums, counts, sse_val,
                                stats, ds, iteration, log, seed, iter_start):
        """Host-side finish of one Lloyd iteration: mean division in
        float64, empty-cluster handling, the postprocess hook, SSE
        bookkeeping and the rise warning, the non-finite guard, the shift,
        the log line and the fitted-state writes.  Returns
        ``(new_centroids, max_shift)``.

        The guard raises on non-finite centroids, or on a non-finite SSE
        (``sse_val``, the step's, recorded only with ``compute_sse``): the
        kernels keep a zero-weight row that holds NaN or Inf out of the sums
        and counts, where the JAX package's one-hot product carries it into
        every centroid; ``sum w ||x||^2`` behind the SSE still carries its
        ``0 * NaN``, so both raise at the same iteration."""
        nonempty = counts > 0
        new_centroids = np.where(
            nonempty[:, None],
            sums / np.maximum(counts, 1.0)[:, None],
            centroids.astype(np.float64))
        new_centroids = self._handle_empty(
            new_centroids, nonempty, ds, stats, iteration, log, seed=seed)
        new_centroids = self._postprocess_centroids(
            new_centroids, prev=centroids.astype(np.float64))
        new_centroids = new_centroids.astype(self.dtype)

        if self.compute_sse:          # SSE against the starting centroids
            self.sse_history.append(sse_val)
            if len(self.sse_history) > 1 and \
                    sse_val > self.sse_history[-2] + 1e-6:
                log.warn_sse_increase(self.sse_history[-2], sse_val)

        if not (np.all(np.isfinite(new_centroids))
                and math.isfinite(sse_val)):
            raise NumericalDivergenceError(iteration + 1)

        shifts = np.linalg.norm(
            new_centroids.astype(np.float64) -
            centroids.astype(np.float64), axis=1)
        max_shift = float(np.max(shifts))

        sizes = counts.astype(np.int64)
        log.iteration(iteration, max_shift, sizes,
                      self.sse_history[-1] if
                      (self.compute_sse and self.sse_history) else None)

        self.centroids = np.asarray(new_centroids)
        self.cluster_sizes_ = sizes
        self.iterations_run = iteration + 1
        self.iter_times_.append(time.perf_counter() - iter_start)
        return new_centroids, max_shift

    def _postprocess_centroids(self, centroids: np.ndarray,
                               prev: Optional[np.ndarray] = None
                               ) -> np.ndarray:
        """Subclass hook applied to freshly computed centroids (after init,
        and after each mean update and empty-cluster handling, before the
        convergence test).  Plain Lloyd: identity."""
        return centroids

    def _handle_empty(self, new_centroids: np.ndarray, nonempty: np.ndarray,
                      ds: Dataset, stats: StepStats, iteration: int,
                      log: IterationLogger, *,
                      seed: Optional[int] = None) -> np.ndarray:
        """Empty-cluster recovery.  ``seed`` is the active restart's seed,
        so that restarts resample independently."""
        if seed is None:
            seed = self.seed
        empty_ids = np.flatnonzero(~nonempty)
        if empty_ids.size == 0:
            return new_centroids
        log.warn_empty(empty_ids.size)
        if self.empty_cluster == "keep":
            return new_centroids
        filled = list(empty_ids)
        if self.empty_cluster == "farthest":
            # The point farthest from its nearest centroid replaces the
            # first empty cluster.
            if float(stats.farthest_dist) >= 0:
                far = stats.farthest_point.to(torch.float64).cpu().numpy()
                new_centroids[filled[0]] = far[: ds.d]
                filled = filled[1:]
        if filled:
            # Deterministic replacement sampling over the positive-weight
            # rows (a zero-weight replacement would stay empty forever).
            rows = ds.sample_positive_rows(len(filled),
                                           [seed, iteration + 1])
            for slot, row in zip(filled[: len(rows)], rows):
                new_centroids[slot] = row
            # Slots beyond the returned samples keep their old centroid.
        return new_centroids

    # --------------------------------------------------------------- predict

    def _require_fitted(self) -> None:
        if self.centroids is None:
            raise ValueError("Model must be fitted before prediction")

    def predict(self, X) -> np.ndarray:
        """Labels, int32 (n,), for an (n, D) array-like, tensor or
        :class:`Dataset`."""
        self._require_fitted()
        ds, _, predict_fn = self._prepare(X)
        labels = predict_fn(ds.points, self._put_centroids(self.centroids))
        return labels.cpu().numpy()

    def fit_predict(self, X, y=None) -> np.ndarray:
        # labels_ is materialised by fit() from the same X.
        return self.fit(X).labels_

    def score(self, X, y=None) -> float:
        """Negative SSE of X under the fitted centroids."""
        self._require_fitted()
        ds, step_fn, _ = self._prepare(X)
        stats = step_fn(ds.points, ds.weights,
                        self._put_centroids(self.centroids))
        return -float(stats.sse)

    @property
    def cluster_centers_(self) -> Optional[np.ndarray]:
        return self.centroids

    @property
    def n_iter_(self) -> int:
        return self.iterations_run

    @property
    def inertia_(self) -> Optional[float]:
        return self.sse_history[-1] if self.sse_history else None

    @property
    def labels_(self) -> np.ndarray:
        """Training-set labels under the fitted centroids.  ``fit`` computes
        them with one assignment pass and then lets go of its dataset, so
        that device memory is not held past the end of ``fit``."""
        if self._labels_cache is None:
            if self._labels_error:
                raise AttributeError(self._labels_error)
            if self.centroids is None or self._fit_ds is None:
                raise AttributeError(
                    "labels_ is only available after fit()")
            self._labels_cache = self.predict(self._fit_ds)
            self._fit_ds = None
        return self._labels_cache

    # ------------------------------------------------------------ checkpoint

    def _state_dict(self) -> dict:
        """Serialisable state in the vocabulary of the shared checkpoint
        format: constructor arguments and fitted attributes.  The kernel
        modes are written as 'pallas' and 'pallas_bf16', the format's names
        for them, and the one-device
        host loop as ``model_shards=1, host_loop=True``, so that the JAX
        package loads the file.  A callable ``init`` is recorded as 'forgy'
        (centroids are restored, so it never runs again)."""
        state = {
            "model_class": type(self).__name__,
            "centroids": np.asarray(self.centroids)
            if self.centroids is not None else np.zeros((0, 0)),
            "k": self.k, "max_iter": self.max_iter,
            "tolerance": self.tolerance, "seed": self.seed,
            "compute_sse": self.compute_sse,
            "n_init": self.n_init,
            "compute_labels": self.compute_labels,
            "empty_cluster": self.empty_cluster,
            "distance_mode": _FORMAT_MODES.get(self.distance_mode,
                                               self.distance_mode),
            "model_shards": 1,
            "chunk_size": self.chunk_size,
            "host_loop": True,
            "verbose": self.verbose,
            "sse_history": list(map(float, self.sse_history)),
            "iterations_run": self.iterations_run,
            "dtype": str(self.dtype),
        }
        if isinstance(self.init, str):
            state["init"] = self.init
        elif not callable(self.init):
            state["init_array"] = np.asarray(self.init)
        return state

    @classmethod
    def _from_state(cls, state: dict, device=None) -> "KMeans":
        """A model from a checkpoint dictionary written by either package.
        Constructor arguments that the port does not have are dropped, with
        one warning that lists those whose value the port cannot honour."""
        init = state.get("init_array", state.get("init", "forgy"))
        dropped = []
        for name, (allowed, _) in _LATER_ARGS.items():
            if name in state and not any(
                    state[name] is a or state[name] == a for a in allowed):
                dropped.append(f"{name}={state[name]!r}")
        if dropped:
            warnings.warn(
                "kmeans_tpu_torch does not have these arguments of the saved "
                "model and dropped them: " + ", ".join(dropped),
                UserWarning, stacklevel=3)
        chunk = state.get("chunk_size")
        model = cls(k=int(state["k"]), max_iter=int(state["max_iter"]),
                    tolerance=float(state["tolerance"]),
                    seed=int(state["seed"]),
                    compute_sse=bool(state["compute_sse"]), init=init,
                    n_init=int(state.get("n_init", 1)),
                    compute_labels=bool(state.get("compute_labels", True)),
                    empty_cluster=str(state["empty_cluster"]),
                    distance_mode=str(state["distance_mode"]),
                    chunk_size=None if chunk is None else int(chunk),
                    verbose=bool(state["verbose"]),
                    dtype=np.dtype(str(state["dtype"])), device=device)
        cents = np.asarray(state["centroids"])
        model.centroids = cents.astype(model.dtype) if cents.size else None
        model.sse_history = [float(s) for s in state["sse_history"]]
        model.iterations_run = int(state["iterations_run"])
        return model

    def save(self, path) -> None:
        """Write the fitted state as one ``.npz`` checkpoint."""
        ckpt.save_state(path, self._state_dict())

    @classmethod
    def load(cls, path, device=None) -> "KMeans":
        """Load a checkpoint written by this package or by the JAX package.
        ``device`` as in the constructor."""
        return cls._from_state(ckpt.load_state(path), device=device)
