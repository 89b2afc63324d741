"""Mini-batch K-Means (Sculley's updates on sampled batches).

Counterpart of ``kmeans_tpu/models/minibatch.py``: each iteration draws a
batch of rows, computes its per-cluster sums and counts with the full-batch
pass (kernel 1, or 1b, on the gathered batch in the kernel modes), and
moves every centre that the batch reached towards the batch's mean by
``counts / seen``, ``seen`` its lifetime count.  For n far larger than one
pass per iteration justifies.

Two sampling engines (``sampling=``):

* ``'device'`` (the default): the dataset is placed on the device once (a
  host copy is not needed) and each iteration draws its batch there, from
  ``(seed, iteration)`` by integer hashing
  (``parallel.distributed.minibatch_rows``: one row per rotated stratum, the
  JAX package's rule; not its draws, which are ``jax.random``'s).  The
  update runs on the device too: ``host_loop=False`` replays one captured
  CUDA graph per iteration, ``host_loop=True`` launches the same iteration
  eagerly and reads it back for the log, so both give the same bits.
* ``'host'``: per iteration ``np.random.default_rng([seed, i]).choice`` on
  the host and an upload of the batch, the JAX package's draws row for
  row; the update in float64 on the host (``_apply_batch_stats``).  For X
  larger than the device's memory: one batch is resident at a time.

Dead centres (``reassignment_ratio``, 0.01 by default as in scikit-learn):
every ``10 k / batch + 1`` iterations a centre whose lifetime count is
below the ratio times the largest takes a row of the current batch.

Checkpoints (``checkpoint_every``, ``resume``) as in ``KMeans``, in all
three engines: the per-iteration engine and the host engine write at the
absolute cadence, the captured loop runs in segments that replay one graph
(``make_minibatch_fit_fn(start=, stop=, seen0=)``).  Every draw is keyed by
``(seed, iteration)`` and the lifetime counts ``seen`` ride the checkpoint,
so a resumed fit draws and updates as the uninterrupted one.

Under a mesh the dataset is placed in blocks (``ShardedDataset``); as in
the JAX package, each block of the data axis draws ``ceil(batch / data)``
rows of its own per iteration and the statistics of the whole batch, and
its reassignment candidates, are reduced over the mesh, so no rank holds
the whole batch; the host engine places each batch over the mesh and
reduces its statistics like ``KMeans``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from kmeans_tpu_torch.models.init import as_source, resolve_init
from kmeans_tpu_torch.models.kmeans import (KMeans, _cached,
                                            _dispatch_rtt, _hint_once,
                                            _host_rows)
from kmeans_tpu_torch.obs import trace as obs_trace
from kmeans_tpu_torch.obs.heartbeat import note_progress as obs_note_progress
from kmeans_tpu_torch.parallel import distributed as dist
from kmeans_tpu_torch.parallel.multihost import fleet_barrier
from kmeans_tpu_torch.parallel.mesh import (DATA_AXIS, all_reduce,
                                            is_primary, mesh_shape)
from kmeans_tpu_torch.parallel.sharding import (Dataset,
                                                _validate_sample_weight,
                                                to_device)
from kmeans_tpu_torch.utils.logging import IterationLogger

_SAMPLING = ("device", "host")


class MiniBatchKMeans(KMeans):
    """Mini-batch K-Means on one device or a mesh.

    The constructor of :class:`KMeans` plus ``batch_size`` (rows per
    iteration), ``sampling`` ('device' | 'host') and ``reassignment_ratio``
    (>= 0; 0 turns the reassignment off).  ``n_init`` candidate inits are
    scored by one pass each (the full data on the device, a seeded subset
    of 3 batches for host data) and the best one is trained
    (``init_inertias_``, ``best_init_``); ``n_init='auto'`` is 3.  The
    guarded bf16 rung runs where the JAX package runs it: the host-sampling
    fit and ``partial_fit`` take the guarded full-batch step; the
    device-sampling engine refuses it when it fits
    (``parallel.distributed._check_minibatch_mode``).

    After ``fit``: ``centroids``, ``cluster_sizes_`` (the last batch's
    counts), ``sse_history`` (each batch's SSE scaled by the total weight
    over the batch's, with ``compute_sse``), ``iterations_run``, and
    ``labels_`` on first access (one pass of kernel 2).
    """

    _PARAM_NAMES = KMeans._PARAM_NAMES + ("batch_size", "sampling",
                                          "reassignment_ratio")
    _sweepable = False

    def __init__(self, k: int = 3, max_iter: int = 100,
                 tolerance: float = 1e-4, seed: int = 42,
                 compute_sse: bool = False, *, batch_size: int = 4096,
                 sampling: str = "device",
                 reassignment_ratio: float = 0.01, **kwargs):
        super().__init__(k, max_iter, tolerance, seed, compute_sse, **kwargs)
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if sampling not in _SAMPLING:
            raise ValueError(f"sampling must be one of {_SAMPLING}, "
                             f"got {sampling!r}")
        if reassignment_ratio < 0:
            raise ValueError(f"reassignment_ratio must be >= 0, got "
                             f"{reassignment_ratio}")
        self.batch_size = batch_size
        self.sampling = sampling
        self.reassignment_ratio = float(reassignment_ratio)
        self.init_inertias_: Optional[np.ndarray] = None
        self.best_init_ = 0
        self._seen: Optional[np.ndarray] = None
        self._centroids_f64: Optional[np.ndarray] = None
        self._total_w: Optional[float] = None

    def _auto_n_init(self) -> int:
        """scikit-learn's ``n_init='auto'`` of MiniBatchKMeans: 3 (the
        candidates are scored, not trained)."""
        return 3

    def _reassign_every(self, batch: int) -> int:
        """The reassignment period: the least n with ``n * batch > 10 k``
        (scikit-learn's strict rule)."""
        return 10 * self.k // max(batch, 1) + 1

    def _set_fit_data(self, data) -> None:
        """Point the lazy ``labels_`` at the data of this fit."""
        self._labels_cache = None
        if self.compute_labels:
            self._fit_ds, self._labels_error = data, None
        else:
            self._fit_ds = None
            self._labels_error = ("labels_ was not materialized because "
                                  "compute_labels=False; call predict(X) "
                                  "instead")

    # ------------------------------------------------------------------- fit

    def fit(self, X, y=None, *, sample_weight=None, resume=False,
            checkpoint_every: int = 0,
            checkpoint_path=None) -> "MiniBatchKMeans":
        """Fit with mini-batch updates.  ``sample_weight`` (n,) scales every
        batch statistic; rows are drawn uniformly (scikit-learn's rule).
        ``labels_`` is computed on first access.  ``resume`` (True or a
        checkpoint path) and ``checkpoint_every`` / ``checkpoint_path`` as in
        ``KMeans.fit``: iteration i's draws are a function of ``(seed, i)``,
        so a segmented or resumed fit gives the uninterrupted fit's bits."""
        ckpt_kw = dict(checkpoint_every=self._check_ckpt(checkpoint_every,
                                                         checkpoint_path),
                       checkpoint_path=checkpoint_path)
        resume = self._resolve_resume(resume)
        if self.sampling == "host":
            return self._fit_host(X, sample_weight, resume, **ckpt_kw)
        return self._fit_device(X, sample_weight, resume, **ckpt_kw)

    def _resume_or_init(self, init_src, resume: bool):
        """``(centroids float64, start iteration, seen)`` of a fit: the
        carried state on resume (``_centroids_f64``, the exact carry, where
        there is one), else the selected init from iteration 0."""
        if resume and self.centroids is not None:
            carried = self._centroids_f64
            cents = (np.asarray(carried, np.float64) if carried is not None
                     else np.asarray(self.centroids, np.float64))
            seen = (np.asarray(self._seen, np.float64)
                    if self._seen is not None else np.zeros(self.k))
            return cents, self.iterations_run, seen
        centroids = self._select_init(init_src)
        self.sse_history = []
        self.iterations_run = 0
        return centroids, 0, np.zeros(self.k)

    def _publish(self, cents: torch.Tensor, seen, counts, iteration: int,
                 sse_history) -> None:
        """The fitted state at an iteration boundary of the device engine
        (the loop's carry, exact in float64)."""
        self.centroids = cents.cpu().numpy().astype(self.dtype)
        self._centroids_f64 = self.centroids.astype(np.float64)
        self._seen = np.asarray(seen, np.float64)
        self.cluster_sizes_ = np.asarray(counts).astype(np.int64)
        self.iterations_run = iteration
        self.sse_history = list(sse_history) if self.compute_sse else []

    def _select_init(self, init_src) -> np.ndarray:
        """scikit-learn's ``n_init`` for mini-batches: draw one init per
        restart seed, score each by one pass (over a dataset on the device,
        its exact SSE; over host rows, a seeded subset of ``max(3 batch,
        3 k)`` rows) and return the lowest, float64.  One candidate is not
        scored."""
        cands = [np.asarray(resolve_init(self.init, init_src, self.k, s,
                                         cap=self.init_cap,
                                         mode=self._mode(),
                                         device=self.device), np.float64)
                 for s in self._restart_seeds()]
        self.init_inertias_, self.best_init_ = None, 0
        if len(cands) == 1:
            return cands[0]
        if isinstance(init_src, Dataset):
            ds = init_src
        else:
            src = as_source(init_src)
            X, hw = np.asarray(src.host), src.host_weights
            n = X.shape[0]
            take = min(n, max(3 * self.batch_size, 3 * self.k))
            idx = np.random.default_rng([self.seed, 0x1717]).choice(
                n, size=take, replace=False)
            ds = to_device(np.ascontiguousarray(X[idx]), self.device,
                           self.dtype, sample_weight=(
                               None if hw is None else np.asarray(hw)[idx]),
                           mesh=self._resolve_mesh())
        step = _cached(dist.make_step_fn, ds.mesh,
                       chunk_size=self._chunk_for(ds), mode=self._mode(),
                       need_farthest=False, need_sse_pc=False)
        x2w = self._x2w(ds)
        inertias = [float(step(ds.points, ds.weights,
                               self._put_centroids(c), x2w).sse)
                    for c in cands]
        self.init_inertias_ = np.asarray(inertias, np.float64)
        self.best_init_ = int(np.argmin(inertias))
        return cands[self.best_init_]

    def _resolve_host_loop_mb(self) -> bool:
        """``host_loop`` of the device engine, 'auto' by the JAX package's
        rule: the per-iteration engine unless one dispatch round trip is
        over 5 ms (a batch's pass is sub-millisecond, so such a round trip
        dominates it); then the captured loop if ``verbose`` is off."""
        if self.host_loop is True or self.host_loop is False:
            return self.host_loop
        rtt = _dispatch_rtt(self.device)
        mesh = self._resolve_mesh()
        if mesh is not None:
            # Every rank takes the same path: the slowest round trip rules.
            rtt = float(all_reduce(torch.tensor([rtt], dtype=torch.float64,
                                                device=self.device),
                                   mesh, op="max")[0])
            if self.device.type == "cuda" and \
                    torch.distributed.get_backend() != "nccl":
                return True         # the captured loop needs NCCL here
        self.auto_rtt_ = rtt
        if rtt <= 5e-3:
            return True
        where = (f"host_loop='auto': dispatch RTT {rtt * 1e3:.0f} ms "
                 f"dominates the mini-batch step on this device")
        if not self.verbose:
            _hint_once("auto_switched_mb",
                       f"{where}: running the fit as the device loop "
                       f"(host_loop=False, the same bits); pass "
                       f"host_loop=True to keep the per-iteration engine")
            return False
        _hint_once("auto_hint_mb",
                   f"{where}; set host_loop=False, or verbose=False to let "
                   f"'auto' switch")
        return True

    def _mb_fit_getter(self, mesh, bs_local: int, mode: str, host: bool):
        """The loop of the device sampling engine at a chunk, from
        ``_STEP_CACHE``: one key for the fit and for the overlapped
        prelude's warm (:meth:`_warm_mb`)."""
        data = mesh_shape(mesh)[0]

        def fit_fn_at(c):
            return _cached(
                dist.make_minibatch_fit_fn,
                mesh, batch=bs_local, mode=mode, k=self.k,
                max_iter=self.max_iter, tolerance=float(self.tolerance),
                history_sse=self.compute_sse,
                reassignment_ratio=self.reassignment_ratio,
                reassign_every=self._reassign_every(bs_local * data),
                chunk_size=c, host_loop=host)
        return fit_fn_at

    def _warm_mb(self, n: int, d: int) -> None:
        """The consumer half of the overlapped prelude (``KMeans._staged``)
        of an (n, D) fit: its loop from ``_STEP_CACHE`` (a hit at the fit's
        own call) and its kernel library's load (kernel 1 or 1b)."""
        mesh = self._resolve_mesh()
        bs_local = -(-min(self.batch_size, n) // mesh_shape(mesh)[0])
        self._mb_fit_getter(mesh, bs_local, self._mode(),
                            self._resolve_host_loop_mb())(
            self.chunk_size or bs_local)
        self._warm_kernels()

    def _fit_device(self, X, sample_weight, resume: bool = False,
                    checkpoint_every: int = 0,
                    checkpoint_path=None) -> "MiniBatchKMeans":
        """The device sampling engine: the dataset placed once, every
        iteration's draw, pass and update on the device."""
        dist._check_minibatch_mode(self._mode())
        ds = self._staged(X, sample_weight,
                          lambda: self._warm_mb(*np.shape(X)))
        fleet_barrier("fit-start", ds.mesh)
        bs = min(self.batch_size, ds.n)
        # Every block of the data axis draws the same count, rounded up.
        data = mesh_shape(ds.mesh)[0]
        bs_local = -(-bs // data)
        log = IterationLogger(self.verbose and is_primary(ds.mesh))
        self._set_fit_data(ds)
        centroids, start_iter, seen = self._resume_or_init(ds, resume)
        if start_iter == 0:
            self.iter_times_ = []
        log.startup(self.k, self.max_iter, self.tolerance, self.compute_sse)
        mode = self._mode()
        self.estep_path_ = ("fused-pallas" if mode in dist.KERNEL_MODES
                            else "serial")
        self.bf16_guard_corrected_rows_ = None
        host = self._resolve_host_loop_mb()
        self.loop_path_ = "host" if host else "device"
        self.checkpoint_segments_ = 0 if checkpoint_every else None
        chunk = self.chunk_size or bs_local
        self.effective_chunk_ = chunk
        fit_fn_at = self._mb_fit_getter(ds.mesh, bs_local, mode, host)

        self._total_w = float(all_reduce(
            ds.weights.to(torch.float64).sum().reshape(1), ds.mesh,
            (DATA_AXIS,))[0])
        if start_iter >= self.max_iter:
            return self
        base_hist = list(self.sse_history)
        acc = dist._accum_dtype(ds.points.dtype)
        cents_dev = self._put_centroids(centroids)
        seen_dev = torch.from_numpy(seen).to(device=self.device, dtype=acc)
        if host:
            res, elapsed = self._run_per_iteration(
                fit_fn_at(chunk), ds, cents_dev, seen_dev, start_iter, log,
                base_hist, checkpoint_every, checkpoint_path)
            n = res.n_iters
            sse_hist, shift_hist = res.sse_history, res.shift_history
        else:
            res, sse_hist, shift_hist, elapsed = self._run_segments(
                fit_fn_at, ds, chunk, cents_dev, seen_dev, start_iter,
                base_hist, checkpoint_every, checkpoint_path)
            n = sse_hist.shape[0]
            self.iter_times_.extend([elapsed / max(n, 1)] * n)
        if not res.finite:
            self._raise_divergence("centroids", start_iter + n)
        self._publish(res.centroids, res.seen, res.counts, start_iter + n,
                      base_hist + [float(s) for s in sse_hist])
        last_shift = float(shift_hist[-1]) if n else 0.0
        if not host:
            log.iteration(self.iterations_run - 1, last_shift,
                          list(self.cluster_sizes_),
                          self.sse_history[-1] if self.sse_history else None)
        if n and last_shift < self.tolerance:
            log.converged(self.iterations_run)
        if checkpoint_every and self.iterations_run % checkpoint_every \
                and host:
            self.checkpoint_segments_ += 1
            self._write_autockpt(checkpoint_path, self.iterations_run)
        return self

    def _run_per_iteration(self, fit_fn, ds, cents_dev, seen_dev,
                           start_iter, log, base_hist, checkpoint_every,
                           checkpoint_path):
        """The per-iteration engine: the loop's iteration launched eagerly
        one at a time, a log line after each and, at the absolute cadence,
        a checkpoint of the loop's carry.  Returns ``(result, seconds)``;
        the iteration times go to ``iter_times_``."""
        t_last = [time.perf_counter()]

        def on_iteration(loop, i):
            # One read of the iteration's counts, SSE estimate and shift:
            # the per-iteration engine's log line.
            tail = torch.cat([loop.counts, loop.sse_hist[i:i + 1],
                              loop.shift.reshape(1)]).to(torch.float64)
            tail = tail.cpu().numpy()
            log.iteration(i, float(tail[-1]), tail[:-2].astype(np.int64),
                          float(tail[-2]) if self.compute_sse else None)
            now = time.perf_counter()
            self.iter_times_.append(now - t_last[0])
            t_last[0] = now
            if checkpoint_every and (i + 1) % checkpoint_every == 0 \
                    and bool(torch.isfinite(loop.cents).all()):
                hist = loop.sse_hist[start_iter:i + 1].to(torch.float64)
                self._publish(loop.cents, dist._host_copy(loop.seen),
                              dist._host_copy(loop.counts), i + 1,
                              base_hist + hist.cpu().tolist())
                self.checkpoint_segments_ += 1
                self._write_autockpt(checkpoint_path, i + 1)

        start = time.perf_counter()
        res = fit_fn(ds, cents_dev, self.seed, on_iteration=on_iteration,
                     start=start_iter, seen0=seen_dev)
        return res, time.perf_counter() - start

    def _run_segments(self, fit_fn_at, ds, chunk, cents_dev, seen_dev,
                      start_iter, base_hist, checkpoint_every,
                      checkpoint_path):
        """The captured loop, the whole fit or segments of
        ``checkpoint_every`` iterations, each through
        ``_dispatch_oom_safe`` (an out-of-memory error replays it at a
        smaller chunk of the batch pass), the carry (centroids and ``seen``)
        handed from segment to segment as a resume would take it.  Returns
        ``(last result, sse history, shift history, seconds)``."""
        sse_parts, shift_parts = [], []
        it0, seg_idx = start_iter, 0
        t0 = time.perf_counter()
        while True:
            seg = (min(checkpoint_every, self.max_iter - it0)
                   if checkpoint_every else self.max_iter - it0)

            def dispatch(c, _it0=it0, _seg=seg, _cents=cents_dev,
                         _seen=seen_dev):
                return fit_fn_at(c)(ds, _cents, self.seed, start=_it0,
                                    stop=_it0 + _seg, seen0=_seen)

            res, chunk = self._dispatch_oom_safe(dispatch, chunk, seg_idx)
            seg_idx += 1
            n = res.n_iters
            it0 += n
            sse_parts.append(res.sse_history)
            shift_parts.append(res.shift_history)
            if not checkpoint_every:
                break
            self.checkpoint_segments_ += 1
            if not res.finite:              # no checkpoint of a NaN state
                self._raise_divergence("centroids", it0)
            converged = n < seg or (n > 0
                                    and shift_parts[-1][-1] < self.tolerance)
            self._publish(res.centroids, res.seen, res.counts, it0,
                          base_hist + [float(s) for part in sse_parts
                                       for s in part])
            self._write_autockpt(checkpoint_path, it0)
            if converged or it0 >= self.max_iter:
                break
            cents_dev = self._put_centroids(self.centroids)
            seen_dev = torch.from_numpy(self._seen).to(
                device=self.device, dtype=seen_dev.dtype)
        return (res, np.concatenate(sse_parts), np.concatenate(shift_parts),
                time.perf_counter() - t0)

    def _fit_host(self, X, sample_weight, resume: bool = False,
                  checkpoint_every: int = 0,
                  checkpoint_path=None) -> "MiniBatchKMeans":
        """The host sampling engine: per iteration a host draw of the
        batch (``np.random.default_rng([seed, i]).choice``) and its
        upload; the weights stay on the host."""
        hw = None
        if isinstance(X, Dataset):
            if X.host is None:
                raise ValueError("sampling='host' needs host data to draw "
                                 "batches; pass a NumPy array or use "
                                 "sampling='device'")
            if sample_weight is not None:
                raise ValueError("pass sample_weight when caching the "
                                 "dataset, not on a pre-built Dataset")
            hw, X = X.host_weights, X.host
        X = np.ascontiguousarray(_host_rows(X, self.dtype))
        n = X.shape[0]
        if sample_weight is not None:
            if isinstance(sample_weight, torch.Tensor):
                sample_weight = sample_weight.cpu().numpy()
            hw = _validate_sample_weight(sample_weight, n, self.dtype)
        bs = min(self.batch_size, n)
        total_w = float(hw.sum()) if hw is not None else float(n)
        self._total_w = total_w
        fleet_barrier("fit-start", self._resolve_mesh())
        self._set_fit_data(X)
        log = IterationLogger(self.verbose
                              and is_primary(self._resolve_mesh()))
        centroids, start_iter, seen = self._resume_or_init(
            as_source(X, hw), resume)
        if start_iter == 0:
            self.iter_times_ = []
        log.startup(self.k, self.max_iter, self.tolerance, self.compute_sse)
        self.estep_path_ = ("fused-pallas" if self._mode()
                            in dist.KERNEL_MODES else "serial")
        self.loop_path_ = "host"
        self.checkpoint_segments_ = 0 if checkpoint_every else None
        for iteration in range(start_iter, self.max_iter):
            t0 = time.perf_counter()
            # Batch i is a pure function of (seed, i); rows are drawn
            # uniformly and the weights scale the statistics.
            idx = np.random.default_rng([self.seed, iteration]).choice(
                n, size=bs, replace=False)
            centroids, seen, max_shift = self._incremental_update(
                X[idx], centroids, seen, iteration, log,
                batch_weight=hw[idx] if hw is not None else None,
                total_w=total_w)
            self.iter_times_.append(time.perf_counter() - t0)
            if checkpoint_every and (iteration + 1) % checkpoint_every == 0:
                self.checkpoint_segments_ += 1
                self._write_autockpt(checkpoint_path, iteration + 1)
            if max_shift < self.tolerance:
                log.converged(iteration + 1)
                break
        if checkpoint_every and self.iterations_run % checkpoint_every:
            self.checkpoint_segments_ += 1
            self._write_autockpt(checkpoint_path, self.iterations_run)
        return self

    def _incremental_update(self, batch: np.ndarray, centroids: np.ndarray,
                            seen: np.ndarray, iteration: int,
                            log: IterationLogger, sse_scale: float = 1.0,
                            batch_weight=None, total_w=None):
        """One update from one host batch: its pass on the device (kernel
        1 in the kernel modes), then :meth:`_apply_batch_stats`.
        ``total_w`` scales the SSE estimate by the total weight over the
        batch's; the reassignment candidates are drawn on the host from
        this batch under ``[seed, iteration, 0xC4ED]``."""
        ds = to_device(np.ascontiguousarray(batch), self.device, self.dtype,
                       sample_weight=batch_weight, mesh=self._resolve_mesh())
        step = _cached(dist.make_step_fn, ds.mesh,
                       chunk_size=self._chunk_for(ds), mode=self._mode(),
                       need_farthest=False, need_sse_pc=False)
        with obs_trace.span("dispatch", tag="minibatch/step",
                            iteration=iteration):
            stats = step(ds.points, ds.weights,
                         self._put_centroids(centroids), None)
            tail = torch.cat([stats.sums.reshape(-1), stats.counts,
                              stats.sse.reshape(1)]).to(torch.float64)
            tail = tail.cpu().numpy()
        k, d = self.k, batch.shape[1]
        sums, counts = tail[: k * d].reshape(k, d), tail[k * d: k * d + k]
        if total_w is not None:
            sse_scale = total_w / max(float(counts.sum()), 1.0)
        candidates = None
        do_re = self.reassignment_ratio > 0 and \
            (iteration + 1) % self._reassign_every(batch.shape[0]) == 0
        if do_re:
            rng = np.random.default_rng([self.seed, iteration, 0xC4ED])
            # Only rows of positive weight may become centres.
            elig = (np.arange(batch.shape[0]) if batch_weight is None
                    else np.flatnonzero(np.asarray(batch_weight) > 0))
            take = min(self.k, len(elig))
            if take:
                idx = elig[rng.choice(len(elig), size=take, replace=False)]
                candidates = batch[idx].astype(np.float64)
        return self._apply_batch_stats(sums, counts, centroids, seen,
                                       iteration, log, sse=float(tail[-1]),
                                       sse_scale=sse_scale,
                                       candidates=candidates,
                                       do_reassign=do_re)

    def _apply_batch_stats(self, sums: np.ndarray, counts: np.ndarray,
                           centroids: np.ndarray, seen: np.ndarray,
                           iteration: int, log: IterationLogger, *,
                           sse: float, sse_scale: float, candidates=None,
                           do_reassign: bool = False):
        """The Sculley update of one batch in float64 on the host (the
        carry ``_centroids_f64``): ``seen += counts``, each centre that the
        batch reached moved by ``counts / seen`` towards the batch mean;
        then, when ``do_reassign``, the centres below ``reassignment_ratio
        * max(seen)`` take the candidates in slot order and the least count
        of the kept centres.  Returns ``(centroids, seen, max_shift)``."""
        seen += counts
        eta = np.divide(counts, np.maximum(seen, 1.0))[:, None]
        batch_mean = sums / np.maximum(counts, 1.0)[:, None]
        new_centroids = np.where(counts[:, None] > 0,
                                 (1.0 - eta) * centroids + eta * batch_mean,
                                 centroids)
        if do_reassign and candidates is not None \
                and self.reassignment_ratio > 0:
            flagged = seen < self.reassignment_ratio * seen.max()
            slots = np.flatnonzero(flagged)[:len(candidates)]
            if slots.size:
                log.warn_reassign(slots.size)
                new_centroids[slots] = candidates[: slots.size]
                kept = seen[~flagged]
                seen[slots] = kept.min() if kept.size else 0.0
        if not np.all(np.isfinite(new_centroids)):
            self._raise_divergence("centroids", iteration + 1)
        if self.compute_sse:
            self.sse_history.append(sse * sse_scale)
        max_shift = float(np.max(np.linalg.norm(new_centroids - centroids,
                                                axis=1)))
        log.iteration(iteration, max_shift, counts.astype(np.int64),
                      self.sse_history[-1] if
                      (self.compute_sse and self.sse_history) else None)
        self.centroids = new_centroids.astype(self.dtype)
        self._centroids_f64 = np.asarray(new_centroids, dtype=np.float64)
        self.cluster_sizes_ = counts.astype(np.int64)
        self.iterations_run = iteration + 1
        self._seen = seen.copy()
        # Heartbeat: both host updates end here, their state on the host.
        obs_note_progress(self, phase="iteration", shift=max_shift)
        return new_centroids, seen, max_shift

    def partial_fit(self, X, y=None, *,
                    sample_weight=None) -> "MiniBatchKMeans":
        """One update from a batch the caller gives (scikit-learn's
        streaming API); the first call draws the init from the batch.
        ``labels_`` is then of this batch."""
        if sample_weight is not None:
            raise ValueError("partial_fit does not support sample_weight; "
                             "fold weights into batch construction")
        # Not a checkpointed fit: a divergence raises in place and keeps
        # the incremental progress, never restoring an earlier fit's file.
        self._active_ckpt_path = None
        self._ckpt_written_this_fit = False
        X = np.ascontiguousarray(_host_rows(X, self.dtype))
        log = IterationLogger(self.verbose
                              and is_primary(self._resolve_mesh()))
        if self.centroids is None:
            centroids = np.asarray(resolve_init(
                self.init, X, self.k, self.seed, device=self.device),
                np.float64)
            self.sse_history, self.iterations_run = [], 0
            self._seen = np.zeros(self.k)
        else:
            centroids = np.asarray(self.centroids, dtype=np.float64)
            if X.shape[1] != centroids.shape[1]:
                raise ValueError(
                    f"X has {X.shape[1]} features, but model was fitted "
                    f"with {centroids.shape[1]}")
        self._total_w = None
        seen = np.asarray(self._seen, dtype=np.float64)
        self._incremental_update(X, centroids, seen, self.iterations_run, log)
        self._set_fit_data(X)
        return self

    def fit_stream(self, make_blocks, *, d=None, resume=False,
                   prefetch=2, **kwargs):
        """Refused by design, as in the JAX package: the inherited
        exact-Lloyd ``fit_stream`` would bypass the mini-batch updates.
        Stream blocks through ``partial_fit``, or use ``KMeans.fit_stream``
        for an exact out-of-core fit."""
        raise NotImplementedError(
            "MiniBatchKMeans does not support fit_stream (it would run "
            "exact full-batch Lloyd, not mini-batch updates); stream blocks "
            "through partial_fit, or use KMeans.fit_stream for an exact "
            "out-of-core fit")

    def _learn_clone(self) -> "MiniBatchKMeans":
        """Detached working copy for serve-and-learn
        (``serving/learn.py``): ``partial_fit`` on the clone never touches
        this model, which keeps serving while the clone takes the
        reservoir's batches on another thread.

        The clone shares what is not mutated in place (the constructor
        settings, the device and the mesh) and gets fresh copies of the
        training state.  ``_seen`` is the aliasing hazard: ``partial_fit``
        reads it through ``np.asarray(..., float64)``, which does not copy
        a float64 array, and ``_apply_batch_stats`` adds the batch's
        counts to it in place, so a shared array would move this model's
        lifetime counts in the middle of an update.  Not ``copy.copy``:
        ``__getstate__`` would materialise ``labels_``, a predict over the
        whole fit data inside the update.  The device table cache is
        serving state and stays out of the clone, and ``verbose`` is off
        (the update's iteration lines would interleave with serving)."""
        if self.centroids is None:
            raise ValueError("_learn_clone requires a fitted model")
        clone = object.__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone.centroids = np.array(self.centroids, copy=True)
        carried = self._centroids_f64
        clone._centroids_f64 = (np.array(carried, np.float64, copy=True)
                                if carried is not None else None)
        clone._seen = np.array(self._seen if self._seen is not None
                               else np.zeros(self.k), dtype=np.float64,
                               copy=True)
        clone.sse_history = list(self.sse_history)
        if self.cluster_sizes_ is not None:
            clone.cluster_sizes_ = np.array(self.cluster_sizes_, copy=True)
        clone._cents_cache = None
        clone._fit_ds = None
        clone._labels_cache = None
        clone.verbose = False
        return clone

    def _profile_counts(self):
        """The quality profile's assignment mass: the lifetime per-center
        counts (``_seen``), not the last batch's ``cluster_sizes_``."""
        seen = getattr(self, "_seen", None)
        if seen is not None and float(np.sum(seen)) > 0:
            return np.asarray(seen, np.float64)
        return self.cluster_sizes_

    def _profile_rows(self):
        """The score-per-row denominator: the dataset weight recorded at
        fit time (``inertia_`` is the total-weight-scaled estimate), else
        the base rule (``partial_fit`` leaves it None)."""
        if self._total_w:
            return float(self._total_w)
        return super()._profile_rows()

    # ------------------------------------------------------------ checkpoint

    def _state_dict(self) -> dict:
        state = super()._state_dict()
        state["profile_total_w"] = self._total_w
        state["batch_size"] = self.batch_size
        state["sampling"] = self.sampling
        state["reassignment_ratio"] = self.reassignment_ratio
        state["seen_counts"] = np.asarray(
            self._seen if self._seen is not None else np.zeros(self.k))
        if self._centroids_f64 is not None:
            state["centroids_f64"] = np.asarray(self._centroids_f64,
                                                np.float64)
        return state

    @classmethod
    def _load_kwargs(cls, state: dict) -> dict:
        # A checkpoint from before reassignment existed never reassigned.
        return {"batch_size": int(state["batch_size"]),
                "sampling": state.get("sampling", "device"),
                "reassignment_ratio":
                    float(state.get("reassignment_ratio", 0.0))}

    def _restore_state(self, state: dict) -> None:
        total = state.get("profile_total_w")
        self._total_w = float(total) if total is not None else None
        self._seen = np.asarray(state["seen_counts"], np.float64)
        carried = state.get("centroids_f64")
        self._centroids_f64 = (np.asarray(carried, np.float64)
                               if carried is not None else None)
