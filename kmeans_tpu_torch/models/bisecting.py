"""Bisecting (divisive hierarchical) K-Means.

Counterpart of ``kmeans_tpu/models/bisecting.py``: start from one cluster
that holds every row and split the "worst" cluster with a 2-means fit until
k clusters exist (scikit-learn's ``BisectingKMeans``).

Each split runs on the whole dataset with the other rows at weight 0
(``Dataset.with_weights``: a new (n,) weight vector, the points stay where
they are), so every pass keeps its shapes and no rows are gathered.  Per
split, on the device: the inner ``KMeans(k=2)`` fit (kernel 1 per
iteration in the kernel modes), the hierarchical membership of every row
(one pass of kernel 2 at k = 2) and both children's SSE and weight (one
pass of kernel 1 at k = 2, its per-cluster SSE summed in a fixed order by
``parallel.distributed.cluster_sums``, so the same data gives the same tree
on every run).  The tree itself is kept on the host.

``checkpoint_every=N`` writes a rotating checkpoint every N splits that
holds the split tree (the (n,) labels and the per-leaf tables, as the JAX
package's do), and ``fit(X, resume=<path>)`` rebuilds the tree from it and
goes on splitting: every later split is a function of the seed, the
absolute split index and the tree, so the result is that of the
uninterrupted fit.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from kmeans_tpu_torch.models.kmeans import KMeans, _cached
from kmeans_tpu_torch.obs.heartbeat import note_progress as obs_note_progress
from kmeans_tpu_torch.parallel import distributed as dist
from kmeans_tpu_torch.parallel.mesh import is_primary
from kmeans_tpu_torch.parallel.multihost import fleet_barrier
from kmeans_tpu_torch.parallel.sharding import (ShardedDataset,
                                                choose_chunk_size)
from kmeans_tpu_torch.utils.logging import IterationLogger
from kmeans_tpu_torch.utils.validation import check_finite_array

_STRATEGIES = ("biggest_sse", "largest_cluster")


def _rows_on_host(ds, values: torch.Tensor) -> np.ndarray:
    """Per-row values of the dataset's device rows, all n of them, on the
    host."""
    return ds.gather_rows(values)


class BisectingKMeans(KMeans):
    """Divisive hierarchical K-Means.

    The constructor of :class:`KMeans` plus ``bisecting_strategy``:
    'biggest_sse' (split the cluster of the largest SSE, scikit-learn's
    'biggest_inertia') or 'largest_cluster' (the heaviest one).
    ``empty_cluster`` (default 'resample'), ``n_init``, ``init`` (a
    strategy; an array or a callable seeds the 2-means by 'k-means++'),
    ``distance_mode`` and ``host_loop`` go to each split's 2-means fit.

    After ``fit``: ``centroids`` (k, D); ``labels_``, the memberships the
    splits made (``predict`` assigns to the nearest leaf, which may differ
    on rows near a boundary); ``cluster_sse_`` and ``cluster_sizes_``, each
    leaf's SSE and weight; ``sse_history``, the total SSE after each split
    (with ``compute_sse``); ``iterations_run``, the splits made;
    ``split_iterations_``, the iterations of each split's 2-means fit (of
    the splits this call made: a resumed fit lists its own);
    ``checkpoint_segments_``, the checkpoints written.
    """

    _PARAM_NAMES = KMeans._PARAM_NAMES + ("bisecting_strategy",)
    _sweepable = False

    def __init__(self, k: int = 3, max_iter: int = 100,
                 tolerance: float = 1e-4, seed: int = 42,
                 compute_sse: bool = False, *,
                 bisecting_strategy: str = "biggest_sse", **kwargs):
        if bisecting_strategy not in _STRATEGIES:
            raise ValueError(f"bisecting_strategy must be one of "
                             f"{_STRATEGIES}, got {bisecting_strategy!r}")
        self.bisecting_strategy = bisecting_strategy
        kwargs.setdefault("empty_cluster", "resample")
        super().__init__(k=k, max_iter=max_iter, tolerance=tolerance,
                         seed=seed, compute_sse=compute_sse, **kwargs)
        self.cluster_sse_: Optional[np.ndarray] = None
        self._tree_state: Optional[dict] = None

    def _inner_init(self):
        """The 2-means init: the model's strategy (an array or a callable
        is made for k clusters, not 2)."""
        return self.init if isinstance(self.init, str) else "k-means++"

    def _base_weights(self, ds) -> np.ndarray:
        """The dataset's weights (n,) as float64 on the host."""
        if ds.host_weights is not None:
            return np.asarray(ds.host_weights, np.float64)
        if ds.host is not None:
            return np.ones(ds.n, np.float64)
        return _rows_on_host(ds, ds.weights).astype(np.float64)

    def _split_seed(self, split: int) -> int:
        return int(np.random.SeedSequence([self.seed, split]).generate_state(
            1)[0] % (2 ** 31))

    def _fit(self, X, sample_weight, *, resume: bool = False,
             checkpoint_every: int = 0,
             checkpoint_path=None) -> "BisectingKMeans":
        tree = self._tree_state
        if resume and tree is None:
            raise ValueError(
                "BisectingKMeans resume needs a split-boundary "
                "checkpoint: fit with checkpoint_every=N + "
                "checkpoint_path, then fit(X, resume=<path>) — a plain "
                "save() holds no mid-tree state")
        log = IterationLogger(self.verbose and
                              is_primary(self._resolve_mesh()))
        ds = self.cache(X, sample_weight)
        fleet_barrier("fit-start", ds.mesh)
        mode = self._mode()
        chunk = self._chunk_for(ds)
        step_fn = _cached(dist.make_step_fn, ds.mesh, chunk_size=chunk,
                          mode=mode, need_sse=False, need_farthest=False,
                          need_sse_pc=True)
        predict_fn = _cached(dist.make_predict_fn, ds.mesh, chunk_size=chunk,
                             mode=mode)
        self._note_estep_path(mode)
        self.loop_path_ = None
        self._fit_ds, self._labels_error = None, None
        n = ds.n
        if ds.host is not None:
            check_finite_array(ds.host, "Data contains NaN or Inf values")
        base_w = self._base_weights(ds)
        pos = base_w > 0
        if int(pos.sum()) < self.k:
            raise ValueError(
                f"Not enough data points ({int(pos.sum())}) to "
                f"initialize {self.k} clusters")
        log.startup(self.k, self.max_iter, self.tolerance, self.compute_sse)
        self.checkpoint_segments_ = 0 if checkpoint_every else None
        self.split_iterations_ = []
        if resume:
            # The tree at the checkpointed boundary.
            if tree["labels"].shape != (n,):
                raise ValueError(
                    f"checkpointed split tree was built on "
                    f"{tree['labels'].shape[0]} rows; resume got {n} — "
                    f"pass the same dataset the fit started on")
            start_split = int(tree["splits_done"])
            labels = np.asarray(tree["labels"], np.int32).copy()
            cents = {i: np.asarray(c, np.float64)
                     for i, c in enumerate(tree["cents"])}
            sse = {i: float(v) for i, v in enumerate(tree["sse"])}
            wsize = {i: float(v) for i, v in enumerate(tree["wsize"])}
            members = {i: int(v) for i, v in enumerate(tree["members"])}
            self.iter_times_ = []
        else:
            start_split = 0
            self.sse_history, self.iter_times_ = [], []
            self.iterations_run = 0
            self._tree_state = None         # no stale tree in checkpoints
            labels = np.zeros(n, dtype=np.int32)
            # Per-leaf state by leaf id: child 0 of a split keeps its
            # parent's id, child 1 takes the next one, so the ids stay
            # 0..leaves-1.
            cents = {0: None}
            sse = {0: np.inf}                # the root is split first
            wsize = {0: float(base_w.sum())}
            members = {0: int(pos.sum())}
        for split in range(start_split, self.k - 1):
            t0 = time.perf_counter()
            splittable = [c for c in cents if members[c] >= 2
                          and (np.isinf(sse[c]) or sse[c] > 0)]
            if not splittable:
                raise RuntimeError(
                    f"Cannot bisect further: {len(cents)} clusters exist but "
                    f"no cluster has >= 2 distinct members (k={self.k})")
            crit = sse if self.bisecting_strategy == "biggest_sse" else wsize
            target = max(splittable, key=lambda c: crit[c])
            mask = labels == target
            ds_t = ds.with_weights(base_w * mask)
            inner = KMeans(
                k=2, max_iter=self.max_iter, tolerance=self.tolerance,
                seed=self._split_seed(split), compute_sse=False,
                init=self._inner_init(), n_init=self.n_init,
                empty_cluster=self.empty_cluster, dtype=self.dtype,
                mesh=ds.mesh, chunk_size=self.chunk_size,
                distance_mode=self.distance_mode, host_loop=self.host_loop,
                pipeline=self.pipeline, verbose=False, device=self.device)
            inner._validate_init = False     # the rows were scanned above
            inner._eager_labels = False      # the membership comes below
            inner.fit(ds_t)
            self.split_iterations_.append(inner.iterations_run)
            if self.loop_path_ is None:
                self.loop_path_ = inner.loop_path_
            two = self._put_centroids(inner.centroids)
            # Every member of the target goes to its nearest child.
            child = _rows_on_host(ds, predict_fn(ds.points, two))
            new_id = len(cents)
            labels[mask & (child == 1)] = new_id
            # One pass gives both children's SSE and weight.
            stats = step_fn(ds_t.points, ds_t.weights, two)
            tail = torch.cat([stats.sse_per_cluster[:2],
                              stats.counts[:2]]).to(torch.float64)
            sse_pc, counts = np.split(tail.cpu().numpy(), 2)
            cents[target] = np.asarray(inner.centroids)[0]
            cents[new_id] = np.asarray(inner.centroids)[1]
            sse[target], sse[new_id] = float(sse_pc[0]), float(sse_pc[1])
            wsize[target], wsize[new_id] = float(counts[0]), float(counts[1])
            members[target] = int((pos & (labels == target)).sum())
            members[new_id] = int((pos & (labels == new_id)).sum())
            self.iter_times_.append(time.perf_counter() - t0)
            total = float(sum(v for v in sse.values() if np.isfinite(v)))
            if self.compute_sse:
                self.sse_history.append(total)
            log._emit(f"Split {split + 1}: cluster {target} -> ({target}, "
                      f"{new_id}), sizes = ({counts[0]:.0f}, "
                      f"{counts[1]:.0f})"
                      + (f", total SSE = {total:.4f}"
                         if self.compute_sse else ""))
            self.iterations_run = split + 1
            # Heartbeat: one record per split, the tree on the host.
            obs_note_progress(self, phase="split", segment=split + 1,
                              clusters=len(cents))
            if checkpoint_every and (split + 1) % checkpoint_every == 0:
                self._snapshot_tree(split + 1, labels, cents, sse, wsize,
                                    members)
                self.checkpoint_segments_ += 1
                self._write_autockpt(checkpoint_path, split + 1)
        if len(cents) == 1:
            self._fit_mean(ds, step_fn, cents, sse, wsize)
        self.centroids = np.stack([np.asarray(cents[i], dtype=self.dtype)
                                   for i in range(len(cents))])
        if not np.all(np.isfinite(self.centroids)):
            self._raise_divergence("centroids", self.iterations_run)
        self._labels_cache = labels
        self.cluster_sse_ = np.array([sse[i] for i in range(len(cents))])
        self.cluster_sizes_ = np.array([wsize[i] for i in range(len(cents))])
        if checkpoint_every and self.iterations_run % checkpoint_every:
            # Off the cadence: the finished tree is on disk too.
            self._snapshot_tree(self.iterations_run, labels, cents, sse,
                                wsize, members)
            self.checkpoint_segments_ += 1
            self._write_autockpt(checkpoint_path, self.iterations_run)
        return self

    def _snapshot_tree(self, splits_done: int, labels, cents, sse, wsize,
                       members) -> None:
        """The split tree at a boundary: what a resume rebuilds it from."""
        leaves = len(cents)
        self._tree_state = {
            "splits_done": int(splits_done),
            "labels": np.asarray(labels, np.int32).copy(),
            "cents": np.stack([np.asarray(cents[i], np.float64)
                               for i in range(leaves)]),
            "sse": np.asarray([sse[i] for i in range(leaves)], np.float64),
            "wsize": np.asarray([wsize[i] for i in range(leaves)],
                                np.float64),
            "members": np.asarray([members[i] for i in range(leaves)],
                                  np.int64),
        }

    def _fit_mean(self, ds, step_fn, cents, sse, wsize) -> None:
        """k = 1: the weighted mean from one pass at a zero centroid (its
        sums are the data's), then its SSE by one 'direct' pass: the
        variance identity and the expanded distance both cancel in float32
        for data far from the origin."""
        zero = self._put_centroids(np.zeros((1, ds.d), dtype=self.dtype))
        stats = step_fn(ds.points, ds.weights, zero)
        s = stats.sums.to(torch.float64).cpu().numpy()[0]
        c = float(stats.counts.to(torch.float64).cpu().numpy()[0])
        cents[0] = (s / max(c, 1.0)).astype(self.dtype)
        chunk = (ds.effective_chunk(ds.d) if isinstance(ds, ShardedDataset)
                 else choose_chunk_size(ds.n, ds.d, ds.d))
        exact = _cached(dist.make_step_fn, ds.mesh, chunk_size=chunk,
                        mode="direct", need_sse=False, need_farthest=False,
                        need_sse_pc=True)
        st = exact(ds.points, ds.weights, self._put_centroids(cents[0][None]))
        sse[0] = float(st.sse_per_cluster.to(torch.float64).cpu()[0])
        wsize[0] = c
        if self.compute_sse:
            self.sse_history.append(sse[0])

    # ------------------------------------------------------------ checkpoint

    def _state_dict(self) -> dict:
        """The base state, the strategy and, on the checkpoints of a
        checkpointed fit, the split tree (``tree_*``, the JAX package's
        names): the (n,) labels and the per-leaf tables."""
        state = super()._state_dict()
        state["bisecting_strategy"] = self.bisecting_strategy
        tree = self._tree_state
        if tree is not None:
            state["tree_labels"] = tree["labels"]
            state["tree_cents"] = tree["cents"]
            state["tree_sse"] = tree["sse"]
            state["tree_wsize"] = tree["wsize"]
            state["tree_members"] = tree["members"]
            state["tree_splits_done"] = int(tree["splits_done"])
        return state

    def _restore_state(self, state: dict) -> None:
        """The split tree of a checkpoint, or none (a stale tree of an
        earlier fit must not survive a restore)."""
        self._tree_state = None
        if "tree_labels" in state:
            self._tree_state = {
                "splits_done": int(state["tree_splits_done"]),
                "labels": np.asarray(state["tree_labels"], np.int32),
                "cents": np.asarray(state["tree_cents"], np.float64),
                "sse": np.asarray(state["tree_sse"], np.float64),
                "wsize": np.asarray(state["tree_wsize"], np.float64),
                "members": np.asarray(state["tree_members"], np.int64),
            }

    @classmethod
    def _load_kwargs(cls, state: dict) -> dict:
        return {"bisecting_strategy": state.get("bisecting_strategy",
                                                "biggest_sse")}

    def fit_stream(self, make_blocks, *, d=None, resume=False,
                   prefetch=2, **kwargs):
        """Refused by design, as in the JAX package: the split tree's
        2-means fits need random access to the rows, which a stream cannot
        serve, and the inherited ``fit_stream`` would run flat Lloyd."""
        raise NotImplementedError(
            "BisectingKMeans does not support fit_stream (the split tree "
            "needs the full dataset resident); use KMeans.fit_stream for a "
            "flat out-of-core fit")
