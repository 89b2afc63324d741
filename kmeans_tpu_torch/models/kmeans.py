"""K-Means estimator on NVIDIA GPUs (scikit-learn-style API).

Counterpart of ``kmeans_tpu/models/kmeans.py``, on one device or over a
(data, model) mesh of ranks (``parallel.mesh``, one process per GPU):
``KMeans(k, max_iter, tolerance, seed, compute_sse).fit(X)``, then
``predict``, ``transform``, ``score``, ``centroids`` and ``sse_history``,
with the estimator protocol (``get_params``, ``set_params``,
``get_feature_names_out``, pickling).

Execution model: the data is placed on the device once
(``parallel.sharding.Dataset``) and stays there for the whole fit.  Each
Lloyd iteration is one step on the device (``parallel.distributed``; in the
default mode one launch of the fused CUDA kernel) that returns the
per-cluster sums and counts and the SSE (and the farthest point where the
empty-cluster policy reads it).  The host loop (``host_loop=True``, and
'auto' wherever dispatch is fast) does the O(k*D) work on the host: the
mean division in float64, the empty-cluster policy, the convergence test on
the largest centroid shift, and logging.  The device loop
(``host_loop=False``, ``parallel.distributed.make_fit_fn``) does all of it
on the device, a replayed CUDA graph per iteration, and the host only reads
a done flag.

``fit_stream`` (and ``predict_stream``, ``score_stream``,
``transform_stream``) take the data as a stream of host blocks that never
resides on the device at once: each block is copied to the card in a
background thread (``data.prefetch``, ``parallel.sharding.BlockStager``)
and goes through the same step as ``fit``, its statistics summed in
float64 on the host in block order.

The model runs on the card unless the caller asks for the CPU:
``device=None`` means ``cuda`` (the rank's own card under a mesh) and raises
where there is none.

Under a mesh every rank runs the same program on the same arguments: each
holds its block of the rows (``parallel.sharding.ShardedDataset``) and,
with ``model_shards > 1``, scores them against its block of the table; the
step's statistics come back replicated (``parallel.distributed``), so every
rank computes the same update and stops at the same iteration.  ``mesh=None``
is one device when no process group is up, and the mesh of the whole world
(``make_mesh(model=model_shards)``) when one is, as in the JAX package.

Behaviour kept from the JAX package: seeded Forgy / k-means++ initialisation
with the same host-side NumPy draws; SSE measured against the iteration's
STARTING centroids, with a warning on a rise above 1e-6; a hard error on
non-finite centroids or a non-finite SSE; deterministic empty-cluster
resampling seeded per iteration with
``np.random.default_rng([seed, iteration + 1])``; best of ``n_init``
restarts by the true final inertia; the ``.npz`` checkpoint format; and the
fault tolerance of ``models.fault_tolerance``: ``checkpoint_every`` /
``checkpoint_path`` (the device loop runs in segments, a rotating
checkpoint between them; the host loop writes in place), ``fit(resume=True
| <path>)``, the out-of-memory chunk backoff and the rollback on
divergence.
"""

from __future__ import annotations

import contextlib
import copy
import math
import time
import warnings
from typing import Callable, List, Optional, Union

import numpy as np
import torch

# NumericalDivergenceError stays importable from this module.
from kmeans_tpu_torch.models.fault_tolerance import (  # noqa: F401
    AutoCheckpointMixin, NumericalDivergenceError)
from kmeans_tpu_torch.models.init import resolve_init
from kmeans_tpu_torch.obs import trace as obs_trace
from kmeans_tpu_torch.obs.heartbeat import note_progress as obs_note_progress
from kmeans_tpu_torch.ops.assign import StepStats
from kmeans_tpu_torch.parallel import distributed as dist
from kmeans_tpu_torch.parallel.mesh import (all_reduce, check_mesh,
                                            group_up, is_primary,
                                            make_mesh, mesh_shape)
from kmeans_tpu_torch.parallel.multihost import fleet_barrier
from kmeans_tpu_torch.parallel.sharding import (BlockStager, Dataset,
                                                _tensor_of, bucket_candidates,
                                                bucket_target, check_bucket,
                                                check_ingest,
                                                choose_chunk_size,
                                                clamp_chunk_for_k, to_device)
from kmeans_tpu_torch.utils import checkpoint as ckpt
from kmeans_tpu_torch.utils.cache import LRUCache, cached_build
from kmeans_tpu_torch.utils.logging import IterationLogger
from kmeans_tpu_torch.utils.validation import validate_params

_EMPTY_POLICIES = ("resample", "farthest", "keep")
_DISTANCE_MODES = ("auto", "kernel", "kernel_bf16", "matmul", "matmul_bf16",
                   "matmul_bf16_guarded", "direct")
#: The checkpoint format's (and the JAX package's) names of the kernel modes.
_FORMAT_MODES = {"kernel": "pallas", "kernel_bf16": "pallas_bf16"}

#: Constructor arguments of the JAX package that the port does not have yet:
#: name -> (the values that name what the port does anyway, ROADMAP item).
#: Any other value raises NotImplementedError.  Empty since ``bucket`` and
#: ``overlap`` were ported; the machinery stays for the families' use and
#: for a checkpoint's arguments that ``_from_state`` must drop.
_LATER_ARGS: dict = {}

#: The step functions of the K-Means family (and of the serving engine and
#: the quantizer, which run the family's passes), keyed by builder and
#: arguments (``utils.cache.builder_key``): the JAX package's
#: ``kmeans._STEP_CACHE``.  A device loop's captured graph is not here: it
#: lives in its dataset's memo.
_STEP_CACHE = LRUCache(64, name="kmeans._STEP_CACHE")


def _cached(builder, *args, **kwargs):
    """``builder(*args, **kwargs)``, a ``parallel`` program builder, through
    :data:`_STEP_CACHE`."""
    return cached_build(_STEP_CACHE, builder, *args, **kwargs)


#: Torch mode of each distance mode for the passes whose output is the
#: distance itself (``transform``): no kernel returns distances, and the
#: guarded rung's values are the float32 class (``ops.assign.value_mode``).
_VALUE_MODES = {"auto": "matmul", "kernel": "matmul",
                "kernel_bf16": "matmul_bf16",
                "matmul_bf16_guarded": "matmul"}


class DispatchLatencyHint(UserWarning):
    """One-time hint: per-iteration host dispatch dominates the fit on this
    device, and ``host_loop='auto'`` did or did not switch to the device
    loop (the JAX package's warning of the same name)."""


#: Hints already given, and measured round trips by device: the
#: ``host_loop='auto'`` probe runs once per device and process.
_HINTS_EMITTED: set = set()
_RTT_CACHE: dict = {}


def _hint_once(kind: str, msg: str) -> None:
    if kind not in _HINTS_EMITTED:
        _HINTS_EMITTED.add(kind)
        warnings.warn(msg, DispatchLatencyHint, stacklevel=4)


def _dispatch_rtt(device: torch.device) -> float:
    """Seconds of one host -> device -> host round trip of a trivial op
    (min of 3 after a warm-up, cached per device): the latency a host loop
    pays per iteration and the device loop does not."""
    key = str(device)
    if key not in _RTT_CACHE:
        x = torch.zeros((), device=device)
        float(x + 1.0)
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            float(x + 1.0)
            reps.append(time.perf_counter() - t0)
        _RTT_CACHE[key] = min(reps)
    return _RTT_CACHE[key]


def _host_rows(X, dtype) -> np.ndarray:
    """An (n, D) host array in ``dtype`` from an array-like or a tensor."""
    if isinstance(X, torch.Tensor):
        X = X.detach().cpu().numpy()
    X = np.asarray(X, dtype=dtype)
    if X.ndim != 2:
        raise ValueError(f"X must be 2-D (n, D), got shape {X.shape}")
    return X


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


def resolve_distance_mode(distance_mode: str, device, dtype) -> str:
    """``distance_mode`` with 'auto' resolved (``KMeans._mode``): the
    kernel on a CUDA device in float32; the torch pass on the CPU, and in
    float64."""
    if distance_mode != "auto":
        return distance_mode
    return "kernel" if torch.device(device).type == "cuda" and \
        np.dtype(dtype) == np.dtype(np.float32) else "matmul"


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


class KMeans(AutoCheckpointMixin):
    """K-Means on one device.

    Parameters
    ----------
    k, max_iter, tolerance, seed, compute_sse :
        number of clusters; iteration cap; convergence threshold on the
        largest centroid shift; random seed (initialisation and
        empty-cluster resampling); whether to record ``sse_history``.
    init : 'forgy' | 'k-means++' (or 'kmeans++') | 'k-means||' (or
        'kmeans||') | callable | (k, D) array.  'k-means||' runs
        ``models.init.kmeans_parallel_init``, its folds and its mass pass
        through kernel 2 (2b) in the kernel modes.
    init_cap : None or int >= 1.  The k-means|| candidates kept per round
        (None: clamp(2k, 256, 2048)); only with init='k-means||'.
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
        'matmul_bf16' | 'matmul_bf16_guarded' | 'direct'.  'kernel' is the
        fused CUDA kernel
        (float32), 'kernel_bf16' its bf16 form on the tensor cores (bf16
        products, float32 sums: approximate assignments for throughput);
        'pallas' and 'pallas_bf16', the JAX package's names of those modes
        (and the checkpoints'), are read as 'kernel' and 'kernel_bf16'.
        'matmul_bf16' is the torch pass with the same bf16 rule.
        'matmul_bf16_guarded' is the guarded bf16 rung (``ops.assign``):
        bf16 distance tiles, and a row whose argmin margin lies within
        ``BF16_GUARD_RTOL`` of its distance scale takes the argmin of a
        float32 tile, so its labels, sums and counts are those of
        'matmul'; refused under a model axis and with 'farthest'; the
        device loop publishes ``bf16_guard_corrected_rows_``.  On a CUDA
        device 'auto' is 'kernel' in float32, on the CPU or in float64 it is
        'matmul'; it is never a bf16 mode.
    host_loop : True | False | 'auto'.  True: the host loop, one step
        on the device per iteration and the rest on the host.  False: the
        device loop (``parallel.distributed.make_fit_fn``): the whole
        iteration on the device, a CUDA graph replayed per iteration on the
        card; ``iter_times_`` then holds the fit's mean per iteration, and
        the SSE history comes back at the end.  'auto' (the JAX package's
        rule): the host loop, unless one measured dispatch round trip is
        over 5 ms and over 25 % of a measured step, and the fit has
        ``verbose=False``, hooks the device loop computes
        (``_device_hooks``), and no host-drawn 'resample'; on a local card
        it is the host loop.  ``host_loop=False`` with a hook that has no
        device form raises ``ValueError``.
    pipeline : 'auto' | 0 | 1.  The chunk schedule of the torch modes
        (``ops.assign.assign_reduce``); both give the same bits.  'auto' is
        0 until a measurement on the card picks 1; the kernel modes ignore
        it.
    ingest : 'auto' | 'mono' | 'slab'.  How a host array reaches the
        devices of a mesh (``parallel.sharding.resolve_ingest``): one copy
        of each rank's block, or slabs through a pinned ring; the same
        bytes either way, and 'auto' is 'mono'.  Without a mesh there is
        one copy whatever the mode.
    k_shard : 'auto' | int >= 0.  The massive-k tier's k-sharded step
        (``parallel.distributed.make_kshard_step_fn``): under a model axis
        of M ranks, ``k_shard=M`` keeps each rank's statistics to its
        (k/M, D) block, gathered in host memory for the M-step; 0 is the
        dense model-axis step, its bit-exact partner.
    assign : 'auto' | 'dense' | 'two_level'.  'two_level' routes every row
        through a coarse quantizer of ``coarse_cells`` cells (a dense
        k-means of the table, trained once per fit) to the member lists of
        its ``nprobe`` nearest cells, and takes the exact nearest of those
        candidates (``parallel.distributed.make_two_level_step_fn``); data
        axis only.  ``coarse_cells`` None is about sqrt(k) (at most k),
        ``nprobe`` None an eighth of the cells; ``nprobe >= coarse_cells``
        makes every centroid a candidate.  ``predict`` of a model with
        ``assign='two_level'`` takes the same route.
        'auto' for ``k_shard`` and ``assign`` asks ``obs.memory.plan_fit``
        whether what the dense fit has still to allocate fits in 80 % of
        the card's free bytes, and takes the dense step if so, else
        ``k_shard`` under a model axis or 'two_level' without one; on the
        CPU both resolve to the dense step.  ``fit_stream`` and ``sweep``
        run the dense step only (an explicit large-k knob raises).
        The large-k steps run in the host loop (``host_loop=False``
        raises) and in the matmul-class torch modes: there 'auto' is
        'matmul', and 'kernel' or 'kernel_bf16' raises ``ValueError`` (a
        mode rule; the coarse quantizer's own dense fit keeps the kernel).
    verbose : per-iteration log lines.
    device : None (the card) | 'cuda' | 'cuda:N' | 'cpu'.
    mesh : None | a ``DeviceMesh`` from ``parallel.mesh.make_mesh``.  None
        is one device without a process group, else the whole world's mesh
        with ``model_shards`` on the model axis.
    model_shards : ranks of the model axis when ``mesh`` is None (a given
        mesh carries its own).

    bucket : 0 (default) | 'auto' | int.  The fit-shape bucket (the JAX
        package's): 'auto' pads the placed rows with zeros of weight 0 (inert
        in every statistic) up to the next boundary of
        ``parallel.sharding.bucket_rows`` ({1, 1.25, 1.5, 1.75} x 2^e rows,
        at most 25 % more), an int to its next multiple, and the chunk of
        the torch passes derives from the padded count; so nearby dataset
        sizes share one step function of ``_STEP_CACHE`` (a second fit in
        the same bucket adds none; the device loop still captures its graph
        once per dataset, since the graph holds the dataset's addresses).
        0 places the rows as they are, the bit-exact oracle.
    overlap : 'auto' (default) | 0 | 1.  With 1 a fit on a host array stages
        its upload on a producer thread (``data.prefetch``) while this
        thread takes the step functions from ``_STEP_CACHE`` and loads the
        kernel library of the mode (``ops._build``; with a store active,
        ``utils.aot``): the copy and the library's build or load run side
        by side.  The same bits as 0; 'auto' is 1 on a CUDA device and 0 on
        the CPU; a mesh of more than one rank stays serial.

    After ``fit``: ``loop_path_`` is 'host' or 'device' (``n_init`` > 1 on
    the device loop runs every restart in one loop,
    ``parallel.distributed.make_multi_fit_fn``); ``estep_path_`` the
    schedule that ran ('fused-pallas' in the kernel modes, else 'serial' or
    'pipelined'); ``auto_rtt_`` the round trip that 'auto' measured (None
    unless it measured one); ``bf16_guard_corrected_rows_`` the rows the
    guarded rung flagged over a device-loop fit (None otherwise);
    ``checkpoint_segments_`` the checkpoints a checkpointed fit wrote (None
    without ``checkpoint_every``); ``oom_backoffs_`` and
    ``effective_chunk_`` the device loop's out-of-memory backoffs and the
    chunk it ended at; ``k_shard_resolved_`` and ``assign_resolved_``
    what those knobs resolved to for the last fit, and
    ``_two_level_route_`` the (coarse table, member lists) of the last
    two-level fit, which ``predict`` and the checkpoint reuse.
    """

    #: The device form of ``_postprocess_centroids`` (None: the identity),
    #: a ``project`` of ``parallel.distributed.project_centroids``.  A
    #: family whose hook has one declares it here AND tags the hook with
    #: ``_device_equivalent``: that pair lets the device loop run it
    #: (``_device_hooks``); a subclass that overrides the hook again loses
    #: the tag and stays on the host loop.
    _device_project: Optional[str] = None
    #: Whether ``sweep`` applies: the families whose fit is not batched
    #: Lloyd (mini-batch, bisecting) opt out.
    _sweepable = True

    _PARAM_NAMES = ("k", "max_iter", "tolerance", "seed", "compute_sse",
                    "init", "n_init", "compute_labels", "empty_cluster",
                    "dtype", "mesh", "model_shards", "chunk_size",
                    "distance_mode", "host_loop", "pipeline", "bucket",
                    "overlap", "ingest", "k_shard", "assign",
                    "coarse_cells", "nprobe", "init_cap", "verbose",
                    "device")

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
                 host_loop: Union[bool, str] = "auto",
                 pipeline: Union[str, int] = "auto",
                 verbose: bool = True,
                 device=None,
                 mesh=None,
                 model_shards: int = 1,
                 ingest: str = "auto",
                 k_shard: Union[str, int] = "auto",
                 assign: str = "auto",
                 coarse_cells: Optional[int] = None,
                 nprobe: Optional[int] = None,
                 init_cap: Optional[int] = None,
                 bucket: Union[str, int] = 0,
                 overlap: Union[str, int] = "auto",
                 **later):
        _check_later_args(later)
        # The fit-shape bucket and the overlapped set-up: the JAX package's
        # grammar and messages.
        self.bucket = check_bucket(bucket)
        if overlap not in ("auto", 0, 1, True, False):
            raise ValueError(f"overlap must be 'auto', 0, or 1; got "
                             f"{overlap!r}")
        self.overlap = overlap if overlap == "auto" else int(overlap)
        self.mesh = check_mesh(mesh)
        if int(model_shards) < 1:
            raise ValueError(f"model_shards must be >= 1, got "
                             f"{model_shards}")
        if mesh is not None and model_shards not in (1, mesh_shape(mesh)[1]):
            raise ValueError(f"model_shards={model_shards} disagrees with "
                             f"the mesh's model axis "
                             f"({mesh_shape(mesh)[1]})")
        self.model_shards = int(model_shards)
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
            # sklearn's rule: 1 for the D^2-seeded inits (k-means|| too,
            # as in the JAX package), else ``_auto_n_init()`` (10; 3 for
            # MiniBatchKMeans).
            n_init = (1 if isinstance(init, str)
                      and init in ("k-means++", "kmeans++", "k-means||",
                                   "kmeans||")
                      else self._auto_n_init())
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
        if distance_mode not in _DISTANCE_MODES:
            raise ValueError(f"distance_mode must be one of "
                             f"{_DISTANCE_MODES}, got {distance_mode!r}")
        dist._check_guarded(distance_mode,
                            mesh_shape(mesh)[1] if mesh is not None
                            else int(model_shards), empty_cluster)
        self.distance_mode = distance_mode
        if init_cap is not None and int(init_cap) < 1:
            raise ValueError(f"init_cap must be >= 1 or None, "
                             f"got {init_cap}")
        self.init_cap = None if init_cap is None else int(init_cap)
        if pipeline not in ("auto", 0, 1, True, False):
            raise ValueError(f"pipeline must be 'auto', 0, or 1; got "
                             f"{pipeline!r}")
        self.pipeline = pipeline if pipeline == "auto" else int(pipeline)
        self.ingest = check_ingest(ingest)
        # The massive-k knobs, with the JAX package's grammar and messages:
        # k_shard=0 and assign='dense' are the dense oracles.
        if isinstance(k_shard, str):
            if k_shard != "auto":
                raise ValueError(f"k_shard must be 'auto' or an int >= 0, "
                                 f"got {k_shard!r}")
            self.k_shard = k_shard
        else:
            if int(k_shard) < 0:
                raise ValueError(f"k_shard must be >= 0, got {k_shard}")
            self.k_shard = int(k_shard)
        if assign not in ("auto", "dense", "two_level"):
            raise ValueError(f"assign must be 'auto', 'dense', or "
                             f"'two_level', got {assign!r}")
        self.assign = assign
        if coarse_cells is not None and int(coarse_cells) < 1:
            raise ValueError(f"coarse_cells must be >= 1 or None, "
                             f"got {coarse_cells}")
        self.coarse_cells = (None if coarse_cells is None
                             else int(coarse_cells))
        if nprobe is not None and int(nprobe) < 1:
            raise ValueError(f"nprobe must be >= 1 or None, got {nprobe}")
        self.nprobe = None if nprobe is None else int(nprobe)
        if isinstance(host_loop, str):
            if host_loop != "auto":
                raise ValueError(f"host_loop must be True, False, or "
                                 f"'auto', got {host_loop!r}")
        else:
            host_loop = bool(host_loop)
        self.host_loop = host_loop
        self.verbose = verbose
        validate_params(k, max_iter, tolerance)
        self.device = resolve_device(device)
        self.loop_path_: Optional[str] = None
        self.estep_path_: Optional[str] = None
        self.auto_rtt_: Optional[float] = None
        self.bf16_guard_corrected_rows_: Optional[int] = None
        self.checkpoint_segments_: Optional[int] = None
        self.oom_backoffs_ = 0
        self.effective_chunk_: Optional[int] = None
        # IO faults a fit recovered from: retried reads (of the stream, or
        # of a file a dataset was read from) and quarantined blocks.
        self.io_retries_used_ = 0
        self.blocks_skipped_ = 0
        # The massive-k route of the last fit: what k_shard and assign
        # resolved to, and the two-level (coarse, members) tables, with
        # predict's cache of them.
        self.k_shard_resolved_: Optional[int] = None
        self.assign_resolved_: Optional[str] = None
        self._two_level_route_ = None
        self._route_cache = None
        # Inner fits (BisectingKMeans' 2-means) skip the init's scan for
        # non-finite rows (the parent scanned once) and the eager labels_
        # pass (the parent computes the membership itself).
        self._validate_init = True
        self._eager_labels = True

        self.centroids: Optional[np.ndarray] = None
        self.sse_history: List[float] = []
        self.iterations_run = 0
        self.cluster_sizes_: Optional[np.ndarray] = None
        # The serving-quality reference restored from a checkpoint;
        # quality_profile() prefers the fitted attributes when they exist.
        self._quality_profile: Optional[dict] = None
        self.iter_times_: List[float] = []            # wall secs/iteration
        self.best_restart_: int = 0
        self.restart_inertias_: Optional[np.ndarray] = None
        self._fit_ds: Optional[Dataset] = None        # retained for labels_
        self._labels_cache: Optional[np.ndarray] = None
        self._labels_error: Optional[str] = None
        # (centroids object, device, its device copy): the served table,
        # placed once per published table (``_cents_dev``).
        self._cents_cache: Optional[tuple] = None

    # ----------------------------------------------------------------- setup

    def _auto_n_init(self) -> int:
        """``n_init='auto'`` for random draws and callables: sklearn's 10
        restarts."""
        return 10

    def _mode(self) -> str:
        """``distance_mode`` with 'auto' resolved: the kernel on a CUDA
        device at every shape in float32; the torch pass on the CPU, and in
        float64, whose user asked for float64 arithmetic (the JAX package's
        ``resolve_auto`` rule for x64 data)."""
        return resolve_distance_mode(self.distance_mode, self.device,
                                     self.dtype)

    def _large_k_mode(self) -> str:
        """The distance mode of a large-k step (k-sharded or two-level):
        'auto' is 'matmul' there on every device, a mode rule (the steps
        run the matmul-class torch modes; the JAX package's 'auto' gives
        'matmul' at such k too, its kernel's table outgrowing VMEM).  An
        explicit mode passes through, and ``make_kshard_step_fn`` and
        ``make_two_level_step_fn`` refuse the kernel modes with the JAX
        package's ``ValueError``."""
        return "matmul" if self.distance_mode == "auto" \
            else self.distance_mode

    def _resolve_pipeline(self, mode: str) -> int:
        """The chunk schedule that runs: 0 in the kernel modes (the kernel
        has its own), 0 for 'auto' until the card has measured the
        pipelined schedule, else the knob."""
        if mode in dist.KERNEL_MODES or self.pipeline == "auto":
            return 0
        return int(self.pipeline)

    def _note_estep_path(self, mode: str) -> int:
        """Set ``estep_path_`` to what runs, in the JAX package's words, and
        return the resolved pipeline flag."""
        if mode in dist.KERNEL_MODES:
            self.estep_path_ = "fused-pallas"
            return 0
        p = self._resolve_pipeline(mode)
        self.estep_path_ = "pipelined" if p else "serial"
        return p

    def _resolve_mesh(self):
        """The mesh the model runs on: the given one; without one, the
        whole world's (``make_mesh(model=model_shards)``) where a process
        group is up, else None (one device).  Built at first use and kept,
        as in the JAX package."""
        if self.mesh is None and (self.model_shards > 1 or group_up()):
            self.mesh = make_mesh(model=self.model_shards)
        return self.mesh

    def _tile_k(self, d: int) -> int:
        """The width of a chunk's distance tile: k, or k * D for
        'direct'."""
        return self.k * d if self._mode() == "direct" else self.k

    def _chunk_for(self, ds: Dataset) -> int:
        """Rows per chunk of the torch passes over the rank's rows: the
        model's ``chunk_size``, else the chunk the dataset was placed with,
        bounded for this model's tile (``Dataset.effective_chunk``; a
        dataset placed without one takes ``choose_chunk_size``)."""
        if self.chunk_size:
            return self.chunk_size
        return ds.effective_chunk(self._tile_k(ds.d))

    def _bucket_target(self, n: int) -> int:
        """The padded row count of the fit-shape bucket
        (``parallel.sharding.bucket_target``)."""
        return bucket_target(self.bucket, n)

    def _chunk_for_shape(self, n: int, d: int) -> int:
        """The chunk that :meth:`_chunk_for` will give the dataset that
        :meth:`cache` places from (n, D) host rows, known before any data
        moves: the chunk of the bucketed count."""
        if self.chunk_size:
            return self.chunk_size
        rows = max(self._bucket_target(n), n, 1)
        tile = self._tile_k(d)
        mesh = self._resolve_mesh()
        if mesh is None:
            return choose_chunk_size(rows, tile, d)
        block = -(-rows // mesh_shape(mesh)[0])
        return clamp_chunk_for_k(choose_chunk_size(block, tile, d), tile)

    def cache(self, X, sample_weight=None) -> Dataset:
        """Place X on the device once as a :class:`Dataset` (under a mesh,
        the rank's block of it, every rank passing the same X); pass the
        result to ``fit`` / ``predict`` / ``score`` to skip the upload on
        every call.  ``sample_weight`` (n,) makes every statistic
        weighted.  With ``bucket`` the device rows are padded to the
        bucket's count with inert rows of weight 0."""
        if isinstance(X, Dataset):
            d, min_rows = X.d, 0
        else:
            shape = np.shape(X)
            d = shape[-1]
            min_rows = self._bucket_target(shape[0]) if len(shape) == 2 \
                else 0
        return to_device(X, self.device, self.dtype,
                         sample_weight=sample_weight,
                         mesh=self._resolve_mesh(), chunk=self.chunk_size,
                         k_hint=self._tile_k(d), ingest=self.ingest,
                         min_rows=min_rows)

    def _resolve_overlap(self) -> int:
        """``overlap`` resolved: 'auto' is 1 on a CUDA device (the upload
        and the kernels' library load are the two terms of the time to the
        first iteration there) and 0 on the CPU."""
        if self.overlap == "auto":
            return int(self.device.type == "cuda")
        return int(self.overlap)

    def _overlaps(self, X) -> bool:
        """Whether :meth:`_prepare` stages ``X`` on a producer thread: with
        ``overlap`` on, for (n, D) host rows (not a :class:`Dataset`, not
        a tensor: neither has an upload to hide), without a mesh of more
        than one rank."""
        if not self._resolve_overlap() or isinstance(X, (Dataset,
                                                         torch.Tensor)):
            return False
        if len(np.shape(X)) != 2:
            return False
        mesh = self._resolve_mesh()
        return mesh is None or math.prod(mesh_shape(mesh)) == 1

    def _step_fns(self, mesh, chunk: int, need_farthest: bool,
                  pipeline: int):
        """The step and the predict pass of this model's mode at
        ``chunk``, from ``_STEP_CACHE``."""
        return (self._step_fn(mesh, chunk, need_farthest=need_farthest,
                              need_sse_pc=False, pipeline=pipeline),
                self._predict_pass(mesh, chunk))

    def _step_fn(self, mesh, chunk: int, mode: Optional[str] = None,
                 **flags):
        """The step of ``mode`` (None: this model's) at ``chunk``, with the
        step's ``flags`` (``need_sse`` ...), from ``_STEP_CACHE``: the one
        place the family builds its dense (chunk, k) steps, beside the
        planner checks that route a large k around them
        (:meth:`_resolve_large_k`)."""
        return _cached(dist.make_step_fn, mesh, chunk_size=chunk,
                       mode=self._mode() if mode is None else mode, **flags)

    def _predict_pass(self, mesh, chunk: int):
        """The predict pass of this model's mode at ``chunk``, from
        ``_STEP_CACHE``."""
        return _cached(dist.make_predict_fn, mesh, chunk_size=chunk,
                       mode=self._mode())

    def _warm_kernels(self) -> None:
        """Load the kernel library that this fit will launch: kernel 1 (1b)
        for every iteration and kernel 2 (2b) for ``labels_`` are one
        library (``ops._build``); nothing in a torch mode or on the CPU.
        With a store of built libraries active (``utils.aot``) the load
        reads it before it starts ``nvcc``."""
        from kmeans_tpu_torch.ops import _build, hopper_kernels
        lib = hopper_kernels.mode_library(self._mode())
        if lib is not None and self.device.type == "cuda":
            _build.load(lib)

    def _staged(self, X, sample_weight, warm: Callable[[], object]
                ) -> Dataset:
        """``cache(X, sample_weight)``; with ``overlap`` on
        (:meth:`_overlaps`) the upload runs in the producer thread of
        ``data.prefetch.prefetch_iter`` (its 'place' and 'stage' spans on
        that thread) while this thread runs ``warm()``: the fit's step
        functions from ``_STEP_CACHE`` and its kernel library's load."""
        if not self._overlaps(X):
            return self.cache(X, sample_weight)
        from kmeans_tpu_torch.data.prefetch import stage_beside
        return stage_beside(X, lambda x: self.cache(x, sample_weight), warm)

    def _prepare(self, X, sample_weight=None, *, need_farthest=False,
                 pipeline: int = 0):
        """The dataset, its step and its predict pass.  The step computes
        the SSE (the host loop's divergence guard reads it) and, with
        ``need_farthest``, the farthest point; nothing else.  With
        ``overlap`` on, the step functions for the chunk of the bucketed
        shape come from ``_STEP_CACHE`` and the kernel library loads while
        the data is staged (:meth:`_staged`)."""
        def warm():
            n, d = np.shape(X)
            self._step_fns(self.mesh, self._chunk_for_shape(n, d),
                           need_farthest, pipeline)
            self._warm_kernels()

        ds = self._staged(X, sample_weight, warm)
        return (ds,) + self._step_fns(ds.mesh, self._chunk_for(ds),
                                      need_farthest, pipeline)

    def _x2w(self, ds: Dataset,
             large_k: bool = False) -> Optional[torch.Tensor]:
        """The block's ``sum w ||x||^2`` where the step reads it (the
        kernel modes' SSE without centroid sharding; not a large-k step),
        computed once per dataset."""
        return (dist.dataset_sqnorm(ds) if self._mode() in dist.KERNEL_MODES
                and mesh_shape(ds.mesh)[1] == 1 and not large_k else None)

    def _put_centroids(self, centroids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(centroids, dtype=self.dtype))).to(self.device)

    def _cents_dev(self) -> torch.Tensor:
        """The fitted table on the model's device, placed once per table
        object.  ``centroids`` is read ONCE: the cache is keyed on that
        object and the same object is uploaded, so a reader racing
        ``serving.learn.publish_tables`` (which seeds this cache, then
        rebinds ``centroids``) gets the old table or the new one with its
        own key, never one table under the other's key.  The cache lives
        on the model, so every engine serving it (fleet replicas share
        the model object) sees a publication at once."""
        cents = self.centroids
        cached = getattr(self, "_cents_cache", None)   # older pickles
        if cached is not None and cached[0] is cents \
                and cached[1] == self.device:
            return cached[2]
        dev = self._put_centroids(cents)
        self._cents_cache = (cents, self.device, dev)
        return dev

    # ------------------------------------------------------------------- fit

    def fit(self, X, y=None, *, sample_weight=None, resume=False,
            checkpoint_every: int = 0, checkpoint_path=None) -> "KMeans":
        """Fit on an (n, D) array-like, a tensor or a cached
        :class:`Dataset`.  Returns self; ``y`` is ignored.  ``sample_weight``
        (n,) weights every statistic.

        ``resume=True`` continues from the current ``centroids`` and
        ``iterations_run`` (after ``load``, or a fit that stopped) up to
        ``max_iter``; ``resume=<path>`` loads that checkpoint first (from
        ``<path>.prev``, with a warning, when the file is torn).
        ``checkpoint_every=N`` with ``checkpoint_path`` writes a rotating
        checkpoint every N iterations, at the absolute cadence ``(iteration
        + 1) % N == 0`` and at the last iteration: the device loop runs in
        segments of N iterations that replay one captured graph, the host
        loop writes in place.  A segmented fit, and a fit killed at a
        boundary and resumed from its file, give the bits of the
        uninterrupted one.  Needs ``n_init == 1``."""
        checkpoint_every = self._check_ckpt(checkpoint_every,
                                            checkpoint_path)
        resume = self._resolve_resume(resume)
        self._fit(X, sample_weight, resume=resume,
                  checkpoint_every=checkpoint_every,
                  checkpoint_path=checkpoint_path)
        if self.compute_labels and self._eager_labels:
            _ = self.labels_
        else:
            self._fit_ds = None
        # The heartbeat's terminal beat: a live straggler read sees this
        # fit finished, not silent (obs.fleet.TERMINAL_PHASES).
        obs_note_progress(self, phase="finished")
        return self

    def fit_stream(self, make_blocks, *, d: Optional[int] = None,
                   resume=False, prefetch: int = 2,
                   checkpoint_every: int = 0, checkpoint_path=None,
                   io_retries: int = 0, io_backoff: float = 0.05,
                   on_nonfinite: str = "error") -> "KMeans":
        """Exact full-batch Lloyd over data larger than the device (the JAX
        package's ``fit_stream``).

        ``make_blocks()`` returns a fresh iterable of (m, D) host blocks, or
        of ``(block, weights)`` pairs (the weights fold into every
        statistic as ``sample_weight`` does); it is called again for every
        pass (one epoch of blocks is one Lloyd iteration).  Each block goes
        through the same step as ``fit`` (``make_step_fn`` in the model's
        mode: kernel 1 or 1b in the kernel modes), and its (k, D + 1)
        statistics, SSE and farthest point come to the host in one copy per
        block and restart, summed in float64 in block order: the
        trajectory is that of an in-memory fit of the concatenated blocks up
        to the summation order.  It is the host loop whatever ``host_loop``
        says, and the dense step: an explicit ``k_shard`` or
        ``assign='two_level'`` raises, as in the JAX package.  Under a mesh every rank runs ``make_blocks()`` and keeps its
        contiguous share of each block; the statistics reduce as in
        ``fit``.  ``d`` declares the feature count (else a first block is
        read and the source closed).

        Initialisation draws over the whole stream: 'forgy' and 'random' by
        one reservoir pass (the JAX package's rows), 'k-means++' and
        'k-means||' by the streamed k-means|| (``models.init.
        streamed_kmeans_parallel_init``), a callable on a seeded uniform
        sample of the stream (``streamed_init_sample``), an array as it
        is.  ``n_init > 1`` runs the restarts interleaved over one shared
        pass per epoch; the winner has the lowest final inertia (one more
        scoring pass).  'resample' draws its rows from a reservoir of the
        epoch seeded ``[seed, iteration, 0x5EED]``, offered the blocks on
        the consumer's side in block order.

        ``prefetch`` (default 2): the next blocks are read, decoded and
        copied to the device (``parallel.sharding.BlockStager``) in a
        background thread while the current block's step runs; 0 is the
        synchronous path, and both give the same bits.  At most ``prefetch
        + 2`` blocks are on the device.  ``resume`` (True or a checkpoint
        path; ``n_init == 1``) continues from the current centroids;
        ``checkpoint_every`` writes a rotating checkpoint every N epochs;
        ``io_retries`` / ``io_backoff`` retry transient block reads
        (``data.io.resilient_blocks``), and ``on_nonfinite`` ('error' |
        'skip') names or drops a non-finite block.  Afterwards:
        ``io_retries_used_``, ``blocks_skipped_``,
        ``checkpoint_segments_``; ``labels_`` is not available (predict
        each block)."""
        from kmeans_tpu_torch.data.io import IOStats, resilient_blocks
        from kmeans_tpu_torch.data.prefetch import (check_prefetch,
                                                    close_source,
                                                    prefetch_iter)
        from kmeans_tpu_torch.models.init import (
            STREAM_INITIALIZERS, _EpochReservoir, _split_block,
            streamed_init_sample, streamed_kmeans_parallel_init)
        if self.k_shard not in ("auto", 0) or self.assign == "two_level":
            raise ValueError(
                "fit_stream runs the dense assignment path only (its "
                "per-block statistics already bound device memory by "
                "the block size); drop the explicit k_shard/assign "
                "large-k knobs, or use fit on an in-memory dataset")
        prefetch = check_prefetch(prefetch)
        checkpoint_every = self._check_ckpt(checkpoint_every,
                                            checkpoint_path)
        resume = self._resolve_resume(resume)
        io_stats = IOStats()
        make_blocks = resilient_blocks(
            make_blocks, io_retries=io_retries, io_backoff=io_backoff,
            on_nonfinite=on_nonfinite, stats=io_stats)
        self.checkpoint_segments_ = 0 if checkpoint_every else None
        mesh = self._resolve_mesh()
        fleet_barrier("fit-stream-start", mesh)
        log = IterationLogger(self.verbose and is_primary(mesh))
        muted = IterationLogger(False)
        log.startup(self.k, self.max_iter, self.tolerance, self.compute_sse)
        mode = self._mode()
        pipeline = self._note_estep_path(mode)
        self.loop_path_ = "host"
        self.bf16_guard_corrected_rows_ = None

        explicit_init = not isinstance(self.init, str) \
            and not callable(self.init)
        if d is None:
            # Close the source: a prefetching one must have its thread
            # reaped when the peek abandons it after one item.
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

        resume = bool(resume) and self.centroids is not None
        if resume and self.n_init != 1:
            raise ValueError("fit_stream resume requires n_init == 1")
        if resume:
            seeds = [self.seed]
            cents_list = [np.asarray(self.centroids, dtype=self.dtype)]
            start_iter = self.iterations_run
        else:
            start_iter = 0
            seeds = self._restart_seeds()
            if explicit_init:
                raw = [resolve_init(self.init, np.empty((0, d), self.dtype),
                                    self.k, self.seed)]
            elif callable(self.init):
                samples, _ = streamed_init_sample(make_blocks, self.k,
                                                  seeds, d, self.dtype)
                raw = [np.asarray(self.init(sample, self.k, s))
                       for sample, s in zip(samples, seeds)]
            else:
                try:
                    stream_fn = STREAM_INITIALIZERS[self.init]
                except KeyError:
                    raise ValueError(
                        f"unknown init strategy: {self.init!r}; options: "
                        f"{sorted(STREAM_INITIALIZERS)}") from None
                kw = (dict(mode=mode, device=self.device)
                      if stream_fn is streamed_kmeans_parallel_init else {})
                raw, _ = stream_fn(make_blocks, self.k, seeds, d,
                                   self.dtype, **kw)
            cents_list = [self._postprocess_centroids(
                np.asarray(c, np.float64)).astype(self.dtype)
                for c in raw]

        class _StreamMeta:
            """``_handle_empty``'s view of a stream: replacement rows come
            from the epoch's seeded reservoir (None under 'keep' and
            'farthest', which draw none)."""

            def __init__(self, d):
                self.d = d
                self.reservoir: Optional[_EpochReservoir] = None

            def sample_positive_rows(self, m, seed_seq):
                if self.reservoir is None:
                    return np.empty((0, self.d))
                return self.reservoir.sample(
                    m, np.random.default_rng(seed_seq))

        class _RestartState:
            def __init__(self, seed, cents):
                self.seed = seed
                self.cents = cents
                self.sse_history = []
                self.iter_times = []
                self.done = False
                self.iters = 0
                self.sizes = None
                self.meta = _StreamMeta(d)

        states = [_RestartState(s, c) for s, c in zip(seeds, cents_list)]
        if resume:
            # The restart adopts the model's histories and counters, so a
            # resume with its budget spent changes nothing.
            states[0].sse_history = self.sse_history
            states[0].iter_times = self.iter_times_
            states[0].iters = self.iterations_run
            states[0].sizes = self.cluster_sizes_
        R = len(states)
        k = self.k
        want_reservoir = self.empty_cluster == "resample"
        need_far = self.empty_cluster == "farthest"
        stager = BlockStager(self.device, self.dtype, prefetch, mesh)
        step_fn = None

        def stage(item):
            """The producer's share of one block (the background thread
            when ``prefetch > 0``): decode, this rank's share, the copy to
            the device."""
            block, bw = _split_block(item, d, self.dtype)
            return block, bw, stager.stage(block, bw)

        def epoch(active, cents_dev, iteration, score_only=False):
            """One pass over the stream: every active restart's statistics
            from the same blocks, summed in float64 in block order."""
            nonlocal step_fn
            sums = [np.zeros((k, d)) for _ in active]
            counts = [np.zeros((k,)) for _ in active]
            sse = [0.0] * len(active)
            far = [(-1.0, None)] * len(active)
            n_seen = 0
            with contextlib.closing(prefetch_iter(make_blocks(), prefetch,
                                                  stage)) as it:
                for block, bw, staged in it:
                    points, weights = stager.take(staged)
                    if step_fn is None:         # chunk of the first block
                        chunk = self.chunk_size or choose_chunk_size(
                            points.shape[0], self._tile_k(d), d)
                        step_fn = _cached(
                            dist.make_step_fn,
                            mesh, chunk_size=chunk, mode=mode,
                            need_farthest=need_far, need_sse_pc=False,
                            pipeline=pipeline)
                    if want_reservoir and not score_only:
                        # Positive-weight rows only; offered here, in block
                        # order, so the draws do not depend on prefetch.
                        offer = block if bw is None else block[bw > 0]
                        for st_r in active:
                            st_r.meta.reservoir.offer(offer)
                    n_seen += block.shape[0]
                    # The span holds the block's steps and the readback
                    # of their statistics (the sync point).
                    with obs_trace.span("dispatch", tag="stream/block",
                                        restarts=len(active)):
                        outs = [step_fn(points, weights, c)
                                for c in cents_dev]
                        flats = [torch.cat([
                            st.sums.reshape(-1), st.counts,
                            st.sse.reshape(1),
                            st.farthest_dist.reshape(1),
                            st.farthest_point.reshape(-1)]).to(
                                torch.float64).cpu().numpy()
                            for st in outs]
                    for i, flat in enumerate(flats):
                        sums[i] += flat[: k * d].reshape(k, d)
                        counts[i] += flat[k * d: k * d + k]
                        sse[i] += float(flat[k * d + k])
                        if flat[k * d + k + 1] > far[i][0]:
                            far[i] = (float(flat[k * d + k + 1]),
                                      flat[k * d + k + 2:])
                    del points, weights, staged, outs, flats
            if n_seen == 0:
                raise ValueError(
                    f"make_blocks() yielded no rows on iteration "
                    f"{iteration + 1} — it must return a FRESH iterable "
                    f"on every call (one epoch per Lloyd iteration)")
            return sums, counts, sse, far, n_seen

        for iteration in range(start_iter, self.max_iter):
            active = [st for st in states if not st.done]
            if not active:
                break
            iter_start = time.perf_counter()
            if want_reservoir:
                for st_r in active:
                    st_r.meta.reservoir = _EpochReservoir(
                        k, d, np.random.default_rng(
                            [st_r.seed, iteration, 0x5EED]))
            cents_dev = [self._put_centroids(st_r.cents) for st_r in active]
            sums, counts, sse, far, n_seen = epoch(active, cents_dev,
                                                   iteration)
            if iteration == start_iter and n_seen < k:
                raise ValueError(f"Not enough data points ({n_seen}) to "
                                 f"initialize {k} clusters")
            for i, st_r in enumerate(active):
                far_d, far_p = far[i]
                agg = StepStats(None, None, None,
                                torch.tensor(far_d, dtype=torch.float64),
                                torch.from_numpy(
                                    far_p if far_p is not None
                                    else np.zeros((d,))), None)
                # _finish_lloyd_iteration writes the model's bookkeeping:
                # point it at this restart's lists.
                self.sse_history = st_r.sse_history
                self.iter_times_ = st_r.iter_times
                st_r.cents, max_shift = self._finish_lloyd_iteration(
                    st_r.cents, sums[i], counts[i],
                    sse[i] if self.compute_sse else 0.0, agg, st_r.meta,
                    iteration, log if st_r is states[0] else muted,
                    st_r.seed, iter_start)
                st_r.iters = self.iterations_run
                st_r.sizes = self.cluster_sizes_
                if max_shift < self.tolerance:
                    st_r.done = True
                    if st_r is states[0]:
                        log.converged(iteration + 1)
            # Epoch-boundary checkpoint (one restart): the model's state is
            # this epoch's, and the reservoirs are seeded per absolute
            # epoch, so a resume from any boundary is exact.
            if checkpoint_every and (iteration + 1) % checkpoint_every == 0:
                self.checkpoint_segments_ += 1
                self._write_autockpt(checkpoint_path, iteration + 1)

        if R > 1:
            cents_dev = [self._put_centroids(st_r.cents) for st_r in states]
            _, _, finals, _, _ = epoch(states, cents_dev, self.max_iter,
                                       score_only=True)
            best = int(np.argmin(finals))
            for r in range(R):
                log.restart(r, R, finals[r], winner=(r == best))
            self.best_restart_ = best
            self.restart_inertias_ = np.asarray(finals, np.float64)
            winner = states[best]
        else:
            self.best_restart_ = 0
            self.restart_inertias_ = None
            winner = states[0]
        self.centroids = np.asarray(winner.cents)
        self.sse_history = winner.sse_history
        self.iter_times_ = winner.iter_times
        self.iterations_run = winner.iters
        self.cluster_sizes_ = winner.sizes
        self.io_retries_used_ = io_stats.retries_used
        self.blocks_skipped_ = io_stats.blocks_skipped
        if checkpoint_every and self.iterations_run % checkpoint_every:
            self.checkpoint_segments_ += 1
            self._write_autockpt(checkpoint_path, self.iterations_run)
        self._fit_ds, self._labels_cache = None, None
        self._labels_error = ("labels_ is not materialized by fit_stream "
                              "(the dataset never resides in memory); call "
                              "predict on each block")
        obs_note_progress(self, phase="finished")
        return self

    def _restart_seeds(self) -> list:
        """Per-restart seeds.  Restart 0 is ``seed`` itself; an explicit
        (k, D) array makes every restart identical, so it collapses to one."""
        if not isinstance(self.init, str) and not callable(self.init):
            return [self.seed]
        extra = np.random.SeedSequence(self.seed).generate_state(
            self.n_init - 1) if self.n_init > 1 else []
        return [self.seed] + [int(s) for s in extra]

    def _init_centroids(self, ds: Dataset, seed: int,
                        k: Optional[int] = None) -> np.ndarray:
        """Seeds of one restart (at ``k``, the model's by default): the
        init strategy, k-means|| through this model's distance mode."""
        centroids = resolve_init(self.init, ds, self.k if k is None else k,
                                 seed, validate=self._validate_init,
                                 cap=self.init_cap, mode=self._mode())
        return self._postprocess_centroids(
            np.asarray(centroids, dtype=np.float64)).astype(self.dtype)

    def _sse(self, ds: Dataset, step=None) -> float:
        """SSE of ``ds`` under the CURRENT centroids, by a step that
        computes nothing else (or by the fit's own ``step``, a large-k
        one): a restart's true final inertia (``sse_history[-1]`` lags one
        iteration) and ``score``."""
        large_k = step is not None
        if step is None:
            step = _cached(dist.make_step_fn, ds.mesh,
                           chunk_size=self._chunk_for(ds),
                           mode=self._mode(), need_farthest=False,
                           need_sse_pc=False)
        return float(step(ds.points, ds.weights,
                          self._put_centroids(self.centroids),
                          self._x2w(ds, large_k)).sse)

    def _resolve_host_loop(self, ds: Dataset, step_fn,
                           large_k: bool = False) -> bool:
        """``host_loop`` for this fit, with 'auto' resolved by the JAX
        package's rule: the host loop unless one measured dispatch round
        trip is over 5 ms AND over 25 % of a measured step; then the device
        loop where it is interchangeable with the host loop (hooks that it
        computes, ``verbose=False``, and no 'resample' on a dataset whose host
        loop draws on the host), else the host loop with a one-time
        :class:`DispatchLatencyHint`.  The 5 ms floor keeps a local card,
        where a round trip takes microseconds, on the host loop."""
        if large_k:
            # A large-k step runs in the host loop only (an explicit
            # host_loop=False was refused by _route_large_k).
            return True
        if self.host_loop is True or self.host_loop is False:
            return self.host_loop
        rtt = _dispatch_rtt(self.device)
        if ds.mesh is not None:
            # Every rank takes the same path: the slowest round trip rules.
            rtt = float(all_reduce(torch.tensor([rtt], dtype=torch.float64,
                                                device=self.device),
                                   ds.mesh, op="max")[0])
            if ds.points.is_cuda and \
                    torch.distributed.get_backend() != "nccl":
                return True         # the device loop needs NCCL here
        self.auto_rtt_ = rtt
        if rtt <= 5e-3:
            return True

        def measure_step():
            cents = self._put_centroids(np.zeros((self.k, ds.d), self.dtype))
            x2w = self._x2w(ds)
            float(step_fn(ds.points, ds.weights, cents, x2w).sse)
            t0 = time.perf_counter()
            float(step_fn(ds.points, ds.weights, cents, x2w).sse)
            return time.perf_counter() - t0

        # lint: ok(cache-key) — measurement cache: a miss only re-measures
        # one step, it can never serve a wrong compiled program (the key
        # spans every static the probe reads).
        step_s = ds.memo(("auto_step_seconds", self._mode(), self.k),
                         measure_step)
        frac = rtt / max(step_s, 1e-12)
        if frac <= 0.25:
            return True
        device_hooks = self._device_hooks()
        resample_safe = self.empty_cluster != "resample" or ds.host is None
        where = (f"host_loop='auto': dispatch RTT {rtt * 1e3:.0f} ms is "
                 f"{frac:.0%} of a measured step on this device")
        if device_hooks and resample_safe and not self.verbose:
            _hint_once("auto_switched",
                       f"{where}: running the fit as the device loop "
                       f"(host_loop=False); pass host_loop=True to keep "
                       f"the per-iteration host loop")
            return False
        if not device_hooks:
            _hint_once("auto_hint_hooks",
                       f"{where}, but {type(self).__name__}'s host-side "
                       f"hooks need the per-iteration host loop")
        elif not resample_safe:
            _hint_once("auto_hint_resample",
                       f"{where}, but empty_cluster='resample' on a dataset "
                       f"with a host copy draws its rows on the host, so "
                       f"'auto' stays on the host loop; host_loop=False "
                       f"moves the draws to the device engine")
        else:
            _hint_once("auto_hint",
                       f"{where}, so most of each iteration's wall time is "
                       f"host dispatch; set host_loop=False, or "
                       f"verbose=False to let 'auto' switch")
        return True

    def _device_hooks(self) -> bool:
        """Whether the device loop computes what the host loop's hooks do:
        the base Lloyd hooks, or a ``_postprocess_centroids`` tagged with
        the class's ``_device_project``."""
        pp = type(self)._postprocess_centroids
        pp_ok = pp is KMeans._postprocess_centroids or (
            self._device_project is not None
            and getattr(pp, "_device_equivalent", None)
            == self._device_project)
        return pp_ok and all(
            getattr(type(self), name) is getattr(KMeans, name)
            for name in ("_handle_empty", "_finish_lloyd_iteration"))

    # ------------------------------------------------------------ massive k

    def _resolve_large_k(self, ds: Dataset, data_shards: int,
                         model_shards: int, chunk: int):
        """``(k_shard, assign)`` for this fit, the JAX package's rule: an
        explicit value is checked and kept; 'auto' compares what the dense
        fit has still to allocate (``obs.memory.dense_room``, which the
        ``plan`` and ``ckpt-info`` commands ask too: its temporary bytes
        and the table, and the rows unless they are on the device already)
        with 80 % of the card's free bytes (``device_memory_info``, which
        counts the allocator's idle cache as free) and keeps the
        dense step when it fits, else shards the table under a model axis
        or takes 'two_level' without one.  A device that reports no free bytes (the
        CPU) keeps the dense step.  Under a mesh the ranks agree on the
        least room any of them has (a MIN ``all_reduce``)."""
        ks, asg = self.k_shard, self.assign
        if ks == "auto" or asg == "auto":
            from kmeans_tpu_torch.obs import memory as _mem
            mode = self._mode()
            fits = _mem.dense_room(
                ds.n, ds.d, self.k, data_shards=data_shards,
                model_shards=model_shards, dtype=self.dtype.name,
                chunk=chunk, pipeline=self._resolve_pipeline(mode),
                mode=mode, device=self.device,
                rows_placed=ds.points.device.type
                == torch.device(self.device).type)["fits"]
            if ds.mesh is not None:
                fits = bool(all_reduce(torch.tensor(
                    [int(fits)], device=self.device), ds.mesh,
                    op="min")[0])
            ks, asg = _mem.auto_route(ks, asg, fits, model_shards)
        ks = int(ks)
        if ks:
            if model_shards <= 1:
                raise ValueError(
                    f"k_shard={ks} requires a model-sharded mesh "
                    f"(model_shards > 1); this mesh has no TP axis — "
                    f"use k_shard=0, or build the mesh with model= "
                    f"shards")
            if ks != model_shards:
                raise ValueError(
                    f"k_shard={ks} does not match the mesh's "
                    f"model_shards={model_shards}: the table shards on "
                    f"the EXISTING TP axis, so the only supported "
                    f"values are 0 (the dense oracle) and "
                    f"{model_shards}")
        if asg == "two_level" and model_shards != 1:
            raise ValueError(
                "assign='two_level' composes with data parallelism "
                "only (model_shards == 1); on a TP mesh use k_shard "
                "instead — the two tiers address the same memory wall "
                "and do not stack")
        return ks, asg

    def _route_large_k(self, ds: Dataset, step_fn):
        """``(step, large_k)``: the step the fit loops on, ``step_fn`` (the
        dense oracle) or the k-sharded step with its host gather or the
        two-level step, by the resolved knobs, and whether it is a large-k
        one.  Both large-k steps run in the host loop (the two-level member
        lists are rebuilt on the host every iteration; the k-sharded
        statistics are gathered in host memory), so ``host_loop=False``
        raises with the reason, and their distance mode is
        :meth:`_large_k_mode`."""
        self._two_level_route_ = None
        data_shards, model_shards = mesh_shape(ds.mesh)
        chunk = self._chunk_for(ds)
        ks, asg = self._resolve_large_k(ds, data_shards, model_shards,
                                        chunk)
        self.k_shard_resolved_, self.assign_resolved_ = ks, asg
        if not ks and asg == "dense":
            return step_fn, False
        if self.host_loop is False:
            raise ValueError(
                f"host_loop=False cannot run the large-k paths "
                f"(resolved k_shard={ks}, assign={asg!r}): they are "
                f"per-iteration host-loop programs; drop "
                f"host_loop=False, or force the dense oracle "
                f"(k_shard=0, assign='dense')")
        mode = self._large_k_mode()
        if ks:
            kstep = _cached(
                dist.make_kshard_step_fn,
                ds.mesh, chunk_size=chunk, mode=mode,
                need_farthest=self.empty_cluster == "farthest",
                need_sse_pc=False)

            def step(points, weights, cents, x2w=None):
                return dist.gather_kshard_stats(
                    kstep(points, weights, cents), ds.mesh, self.k)
        else:
            step = self._two_level_step(ds, mode)
        self._note_estep_path(mode)
        return step, True

    def _two_level_params(self):
        """(coarse cells C, probes per row): about sqrt(k) cells (at most
        k) and an eighth of them probed unless given; ``nprobe >= C``
        probes every cell."""
        C = self.coarse_cells or max(2, int(round(np.sqrt(self.k))))
        C = min(int(C), self.k)
        npb = self.nprobe or max(1, -(-C // 8))
        return C, min(int(npb), C)

    def _train_coarse(self, cents: np.ndarray, C: int) -> np.ndarray:
        """The coarse quantizer: a dense k-means of the (k, D) table into C
        cells (k-means++ seeding, 25 iterations), on this model's device
        and mesh; kernel 1 on the card in float32.  Trained once per fit
        from the starting table, then fixed; only the member lists follow
        the table (:meth:`_build_members`)."""
        km = KMeans(k=C, max_iter=25, tolerance=1e-4, seed=self.seed,
                    compute_sse=False, init="k-means++",
                    compute_labels=False, empty_cluster="keep",
                    dtype=self.dtype, mesh=self.mesh, host_loop=True,
                    assign="dense", k_shard=0, verbose=False,
                    device=self.device)
        km._eager_labels = False
        km._validate_init = False
        km.fit(np.asarray(cents, np.float64).astype(self.dtype))
        return np.asarray(km.centroids, np.float64)

    def _build_members(self, cents: np.ndarray,
                       coarse: np.ndarray) -> np.ndarray:
        """(C, L) member lists, the JAX package's rule: each centroid files
        under its nearest coarse cell (float64 on the host); L is the
        largest cell's size on the candidate ladder
        (``sharding.bucket_candidates``), ``k`` pads the tails, each list
        is sorted ascending (so the candidate search's lexicographic merge
        keeps the dense argmin's lowest-index rule), and an empty cell
        carries its nearest centroid."""
        k, C = cents.shape[0], coarse.shape[0]
        d2 = (np.sum(cents ** 2, axis=1)[:, None]
              - 2.0 * cents @ coarse.T
              + np.sum(coarse ** 2, axis=1)[None, :])
        owner = np.argmin(d2, axis=1)
        lists = [np.flatnonzero(owner == c) for c in range(C)]
        for c in range(C):
            if lists[c].size == 0:
                lists[c] = np.array([int(np.argmin(d2[:, c]))])
        L = bucket_candidates(max(lst.size for lst in lists))
        members = np.full((C, L), k, np.int32)
        for c, lst in enumerate(lists):
            members[c, : lst.size] = np.sort(lst).astype(np.int32)
        return members

    def _two_level_chunk(self, ds: Dataset, C: int, L: int,
                         nprobe: int) -> int:
        """Rows per chunk of the two-level passes: the model's
        ``chunk_size``, else a chunk whose wider tile, the (chunk, C)
        coarse distances or a cell's (rows, L) at the mean rows per cell
        (``chunk * nprobe / C``), keeps to ``choose_chunk_size``'s budget.
        (The JAX package scans the dataset's chunk, which its padding
        fixes; the port's passes take any chunk, and one sized for k would
        visit every cell once per few thousand rows.)"""
        return self.chunk_size or choose_chunk_size(
            ds.points.shape[0], max(C, -(-L * nprobe // C)), ds.d)

    def _two_level_step(self, ds: Dataset, mode: str):
        """The two-level step with the dense step's calling convention
        (``step(points, weights, centroids, x2w=None) -> StepStats``): it
        trains the coarse quantizer at its first call, rebuilds the member
        lists from the current table at every call, and runs
        ``make_two_level_step_fn``."""
        C, npb = self._two_level_params()
        state = {"coarse": None}

        def step(points, weights, cents_dev, x2w=None):
            cents = cents_dev.to(torch.float64).cpu().numpy()[: self.k]
            if state["coarse"] is None:
                state["coarse"] = self._train_coarse(cents, C)
            coarse = state["coarse"]
            members = self._build_members(cents, coarse)
            self._two_level_route_ = (coarse, members)
            fn = _cached(
                dist.make_two_level_step_fn,
                ds.mesh, chunk_size=self._two_level_chunk(
                    ds, C, members.shape[1], npb),
                nprobe=npb, mode=mode,
                need_farthest=self.empty_cluster == "farthest",
                need_sse_pc=False)
            return fn(points, weights, cents_dev, coarse, members)

        return step

    def _two_level_tables(self):
        """(coarse, members) of the current table, kept while the table is
        the same object: the fit's coarse cells where this model has them
        (a fit, or a checkpoint that carried them), else a coarse
        quantizer trained now from the table."""
        cache = self._route_cache
        if cache is not None and cache[0] is self.centroids:
            return cache[1], cache[2]
        C, _ = self._two_level_params()
        cents = np.asarray(self.centroids, np.float64)
        route = self._two_level_route_
        coarse = (route[0] if route is not None
                  and route[0].shape[0] == C
                  else self._train_coarse(cents, C))
        members = self._build_members(cents, coarse)
        self._route_cache = (self.centroids, coarse, members)
        return coarse, members

    def _predict_two_level_labels(self, ds: Dataset) -> torch.Tensor:
        """Labels of the rank's rows by the two-level candidate search
        (``assign='two_level'``): the fit step's search, labels only."""
        coarse, members = self._two_level_tables()
        C, npb = self._two_level_params()
        fn = _cached(
            dist.make_two_level_predict_fn,
            ds.mesh, chunk_size=self._two_level_chunk(ds, C,
                                                      members.shape[1], npb),
            nprobe=npb, mode=self._large_k_mode())
        return fn(ds.points, self._put_centroids(self.centroids), coarse,
                  members)

    def _fit(self, X, sample_weight, *, resume: bool = False,
             checkpoint_every: int = 0, checkpoint_path=None) -> "KMeans":
        log = IterationLogger(self.verbose and
                             is_primary(self._resolve_mesh()))
        pipeline = self._note_estep_path(self._mode())
        ds, step_fn, _ = self._prepare(
            X, sample_weight, need_farthest=self.empty_cluster == "farthest",
            pipeline=pipeline)
        # The massive-k route: the k-sharded or two-level step in place of
        # the dense one (the dense oracle keeps step_fn).
        step_fn, large_k = self._route_large_k(ds, step_fn)
        # The clock anchor of merged timelines (a no-op without a tracer).
        fleet_barrier("fit-start", ds.mesh)
        self.io_retries_used_ = getattr(getattr(ds, "io_stats", None),
                                        "retries_used", 0)
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
        self.bf16_guard_corrected_rows_ = None

        seeds = self._restart_seeds()
        host = self._resolve_host_loop(ds, step_fn, large_k)
        if not host and not self._device_hooks():
            raise ValueError(
                f"host_loop=False: {type(self).__name__}'s host-side hooks "
                f"have no device form; use host_loop=True")
        self.loop_path_ = "host" if host else "device"
        ckpt_kw = dict(checkpoint_every=checkpoint_every,
                       checkpoint_path=checkpoint_path)
        if resume and self.centroids is not None:
            centroids = np.asarray(self.centroids, dtype=self.dtype)
            if host:
                return self._run_restart(ds, step_fn, centroids, self.seed,
                                         log, self.iterations_run,
                                         large_k=large_k, **ckpt_kw)
            return self._fit_on_device(ds, centroids, self.seed, pipeline,
                                       log, self.iterations_run, **ckpt_kw)
        if len(seeds) > 1 and not host:
            return self._fit_on_device_multi(ds, seeds, pipeline, log)
        best = None
        inertias = []
        for r, seed in enumerate(seeds):
            centroids = self._init_centroids(ds, seed)
            self.sse_history = []
            self.iterations_run = 0
            self.iter_times_ = []
            if host:
                self._run_restart(ds, step_fn, centroids, seed, log, 0,
                                  large_k=large_k, **ckpt_kw)
            else:
                self._fit_on_device(ds, centroids, seed, pipeline, log, 0,
                                    **ckpt_kw)
            if len(seeds) == 1:
                return self
            inertia = self._sse(ds, step_fn if large_k else None)
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
                     seed: int, log: IterationLogger, start_iter: int = 0,
                     checkpoint_every: int = 0, checkpoint_path=None,
                     large_k: bool = False) -> "KMeans":
        """One restart: the host loop, from iteration ``start_iter``.  One
        step on the device per iteration; its sums, and its counts with the
        SSE behind them, come to the host as float64, which is also the
        iteration's synchronisation point.  With ``checkpoint_every`` a
        rotating checkpoint is written at the absolute cadence (a resumed
        fit keeps the uninterrupted one's schedule) and after the last
        iteration when that is off the cadence.  ``large_k``: ``step_fn``
        is a large-k step, which reads no ``sum w ||x||^2``."""
        self.checkpoint_segments_ = 0 if checkpoint_every else None
        cents_dev = self._put_centroids(centroids)
        x2w = self._x2w(ds, large_k)
        for iteration in range(start_iter, self.max_iter):
            iter_start = time.perf_counter()
            # The span holds the step and the readback of its statistics,
            # the iteration's sync point: around the launches alone it
            # would time their enqueue.
            with obs_trace.span("dispatch", tag="lloyd/step",
                                iteration=iteration):
                stats: StepStats = step_fn(ds.points, ds.weights,
                                           cents_dev, x2w)
                sums = stats.sums.to(torch.float64).cpu().numpy()
                tail = torch.cat([stats.counts.to(torch.float64),
                                  stats.sse.to(torch.float64).reshape(1)])
                tail = tail.cpu().numpy()
            centroids, max_shift = self._finish_lloyd_iteration(
                centroids, sums, tail[:-1], float(tail[-1]), stats, ds,
                iteration, log, seed, iter_start)
            if checkpoint_every and (iteration + 1) % checkpoint_every == 0:
                self.checkpoint_segments_ += 1
                self._write_autockpt(checkpoint_path, iteration + 1)
            if max_shift < self.tolerance:
                log.converged(iteration + 1)
                break
            cents_dev = self._put_centroids(centroids)
        if checkpoint_every and self.iterations_run % checkpoint_every:
            self.checkpoint_segments_ += 1
            self._write_autockpt(checkpoint_path, self.iterations_run)
        return self

    def _fit_on_device(self, ds: Dataset, centroids: np.ndarray, seed: int,
                       pipeline: int, log: IterationLogger,
                       start_iter: int = 0, checkpoint_every: int = 0,
                       checkpoint_path=None) -> "KMeans":
        """One restart as the device loop (``host_loop=False``) from
        iteration ``start_iter``: every iteration on the device
        (``parallel.distributed.make_fit_fn``), the host waiting only for
        the done flag.  On a CUDA device the loop runs as a captured graph
        or raises: it never falls back to the host loop.

        Each segment (the whole fit, or ``checkpoint_every`` iterations)
        goes through ``_dispatch_oom_safe``: an out-of-memory error replays
        it from its boundary at a smaller chunk, in the same mode.  In the
        torch modes the chunk bounds the (chunk, k) distance tile; the
        kernel modes take every row in one launch and no chunk reaches
        them, so there the replay changes nothing the kernel allocates.
        Every segment replays the graph captured for the fit
        (``make_fit_fn(start=, stop=)``), and a boundary's centroids go to
        the next segment through ``_put_centroids``, as a resume's do, so
        the segments give the bits of one run."""
        mode = self._mode()
        chunk = self._chunk_for(ds)
        self.checkpoint_segments_ = 0 if checkpoint_every else None
        self.effective_chunk_ = chunk
        if start_iter >= self.max_iter:
            return self
        base_hist = list(self.sse_history)
        cents_dev = self._put_centroids(centroids)
        sse_parts, shift_parts = [], []
        flagged, launched = None, 0
        it0, seg_idx = start_iter, 0
        fit_start = time.perf_counter()
        while True:
            seg = (min(checkpoint_every, self.max_iter - it0)
                   if checkpoint_every else self.max_iter - it0)

            def dispatch(c, _it0=it0, _seg=seg, _cents=cents_dev):
                fit_fn = _cached(
                    dist.make_fit_fn,
                    ds.mesh, chunk_size=c, mode=mode,
                    max_iter=self.max_iter, tolerance=float(self.tolerance),
                    empty_policy=self.empty_cluster,
                    history_sse=self.compute_sse, pipeline=pipeline,
                    project=self._device_project)
                return fit_fn(ds, _cents, seed, start=_it0, stop=_it0 + _seg)

            result, chunk = self._dispatch_oom_safe(dispatch, chunk, seg_idx)
            seg_idx += 1
            launched += result.launched
            if result.flagged is not None:
                flagged = (flagged or 0) + result.flagged
            n = result.n_iters
            it0 += n
            sse_parts.append(result.sse_history)
            shift_parts.append(result.shift_history)
            if not checkpoint_every:
                break
            self.checkpoint_segments_ += 1
            if not result.finite:           # no checkpoint of a NaN state
                self._raise_divergence("centroids", it0)
            converged = n < seg or (n > 0
                                    and shift_parts[-1][-1] < self.tolerance)
            # The boundary state, published so that the checkpoint is a
            # resume point.
            cents_host = result.centroids.cpu().numpy().astype(self.dtype)
            self.centroids = cents_host
            self.cluster_sizes_ = result.counts.astype(np.int64)
            self.iterations_run = it0
            if self.compute_sse:
                self.sse_history = base_hist + [
                    float(s) for part in sse_parts for s in part]
            self._write_autockpt(checkpoint_path, it0)
            if converged or it0 >= self.max_iter:
                break
            cents_dev = self._put_centroids(cents_host)
        self.sse_history = base_hist
        if flagged is not None:
            self.bf16_guard_corrected_rows_ = flagged
        self._finish_device_fit(dist.FitResult(
            result.centroids, it0 - start_iter, np.concatenate(sse_parts),
            np.concatenate(shift_parts), result.counts, result.finite,
            launched, flagged), time.perf_counter() - fit_start, log,
            start_iter)
        return self

    def _fit_on_device_multi(self, ds: Dataset, seeds: list, pipeline: int,
                             log: IterationLogger) -> "KMeans":
        """Every restart in one device loop
        (``parallel.distributed.make_multi_fit_fn``): one iteration of every
        restart per launch, the winner by the true final inertia, as the
        restarts one after another would pick it.  ``iter_times_`` holds
        the loop's wall time over the iterations it launched."""
        fit_fn = _cached(
            dist.make_multi_fit_fn,
            ds.mesh, chunk_size=self._chunk_for(ds), mode=self._mode(),
            k_real=self.k, max_iter=self.max_iter,
            tolerance=float(self.tolerance),
            empty_policy=self.empty_cluster, n_init=len(seeds),
            history_sse=self.compute_sse, return_all=True,
            pipeline=pipeline, project=self._device_project)
        inits = np.stack([self._init_centroids(ds, s) for s in seeds])
        self.sse_history, self.iter_times_ = [], []
        start = time.perf_counter()
        with obs_trace.span("dispatch", tag="fit/multi",
                            restarts=len(seeds)):
            res = fit_fn(ds, self._put_centroids(inits), seeds)
        elapsed = time.perf_counter() - start
        self.bf16_guard_corrected_rows_ = res.flagged
        bad = np.flatnonzero(~res.finite)
        if bad.size:
            self._raise_divergence("centroids", int(res.n_iters[bad[0]]))
        b = res.best
        n = int(res.n_iters[b])
        self.best_restart_ = b
        self.restart_inertias_ = res.inertias
        self._finish_device_fit(dist.FitResult(
            res.centroids[b], n, res.sse_history[b, :n],
            res.shift_history[b, :n], res.counts[b], True, res.launched),
            elapsed * n / max(res.launched, 1), log)
        log.restart(b, len(seeds), float(res.inertias[b]), winner=True)
        return self

    def _finish_device_fit(self, result: "dist.FitResult", elapsed: float,
                           log: IterationLogger, start_iter: int = 0) -> None:
        """The host's part of a device-loop fit of ``result.n_iters``
        iterations from ``start_iter``: the fit's wall time split evenly
        over its iterations, the divergence error naming the iteration the
        host loop would name (after the rollback to a checkpoint of this
        fit), the SSE history with its rise warning, and one log line for
        the final state."""
        n = result.n_iters
        self.iter_times_.extend([elapsed / max(n, 1)] * n)
        if not result.finite:
            self._raise_divergence("centroids", start_iter + n)
        self.centroids = result.centroids.cpu().numpy().astype(self.dtype)
        self.cluster_sizes_ = result.counts.astype(np.int64)
        self.iterations_run = start_iter + n
        if self.compute_sse:
            for sse in result.sse_history:
                self.sse_history.append(float(sse))
                if len(self.sse_history) > 1 and \
                        self.sse_history[-1] > self.sse_history[-2] + 1e-6:
                    log.warn_sse_increase(self.sse_history[-2],
                                          self.sse_history[-1])
        last_shift = float(result.shift_history[-1]) if n else 0.0
        log.iteration(self.iterations_run - 1, last_shift,
                      list(self.cluster_sizes_),
                      self.sse_history[-1] if
                      (self.compute_sse and self.sse_history) else None)
        # A device-loop fit has no iteration boundary on the host (and,
        # unsegmented, no checkpoint one): its end is its progress beat.
        obs_note_progress(self, phase="fit", shift=last_shift)
        if n and last_shift < self.tolerance:
            log.converged(self.iterations_run)

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
            # Rolled back to the last checkpoint of this fit, if any.
            self._raise_divergence("centroids", iteration + 1)

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
        # Heartbeat: host state this iteration already read back.
        obs_note_progress(self, phase="iteration", shift=max_shift)
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

    # ----------------------------------------------------------------- sweep

    def _sweep_metric_rows(self, X) -> np.ndarray:
        """The host rows that the metric criteria score, in the model's
        dtype."""
        return np.ascontiguousarray(_host_rows(X, self.dtype))

    def sweep(self, X, *, k_range, criterion: str = "inertia",
              sample_weight=None, batched=True):
        """Model selection over k (the JAX package's ``KMeans.sweep``): fit
        every (k, restart) member, score each k's winner by ``criterion``,
        and return a ``sweep.SweepResult`` with the curve and the fitted
        winner.

        ``k_range``: a range or iterable of k, or the grammar "2:33"
        (half-open), "2:33:2", "2,4,8".  ``criterion``: 'inertia' (the
        elbow of the curve; fewer than 3 points take the lowest),
        'silhouette' or 'calinski_harabasz' (highest) or 'davies_bouldin'
        (lowest), scored on the winners' labels of the rows
        (``metrics.batched_criterion_scores``).  Silhouette is the full
        O(n^2 D) score; for large n score the winners with
        ``metrics.batched_criterion_scores(..., sample_size=)``.  A winner
        whose labels occupy fewer than 2 clusters scores NaN and is never
        selected.  Restarts within each k come from ``n_init`` and
        ``seed`` as in ``fit``; the lowest true final inertia wins a k.

        ``batched=True`` runs every member in one device loop
        (``parallel.distributed.make_multi_fit_fn`` with a per-member k:
        members padded to k_max with sentinel rows; in the kernel modes
        each member's kernel runs at its own k), then the winners' labels
        in one batched pass (``make_multi_predict_fn``).  ``batched=0`` is
        the oracle: one device-loop fit per member on the same dataset.
        The init must be a strategy or a callable, and the members are
        dense fits (an explicit ``k_shard`` or ``assign='two_level'``
        raises, as in the JAX package); metric criteria need
        host rows and score unweighted rows.  The returned model has not
        materialised ``labels_``: call ``predict``."""
        from kmeans_tpu_torch import metrics as metrics_mod
        from kmeans_tpu_torch import sweep as sweep_mod

        if not type(self)._sweepable:
            raise NotImplementedError(
                f"sweep() is defined for the full-batch Lloyd families "
                f"(KMeans, SphericalKMeans), not {type(self).__name__}")
        if not (isinstance(self.init, str) or callable(self.init)):
            raise ValueError(
                "sweep() needs a string or callable init (an explicit "
                "(k, D) init array pins k); got an array init")
        if self.k_shard not in ("auto", 0) or self.assign == "two_level":
            raise ValueError(
                "sweep() runs its members on the dense multi-fit path; "
                "the large-k k_shard/assign routes do not compose with "
                "the padded member axis — sweep with the dense oracle "
                "and fit the winner's k with the large-k knobs")
        ks = sweep_mod.parse_k_range(k_range)
        sweep_mod.check_criterion(criterion, sweep_mod.KMEANS_CRITERIA)
        if criterion != "inertia" and ks[0] < 2:
            raise ValueError(f"criterion {criterion!r} needs k >= 2 "
                             f"(got k range starting at {ks[0]})")
        k_max = ks[-1]
        # The engine owns the dataset and the chunks at k_max; the members
        # inherit every other setting.
        engine = sweep_mod.clone_for(self, k=k_max, verbose=False,
                                     compute_labels=False)
        ds = engine.cache(X, sample_weight)
        if k_max >= ds.n:
            raise ValueError(f"k_max={k_max} must be < n={ds.n}")
        seeds = engine._restart_seeds()
        members = [(k, s) for k in ks for s in seeds]
        n_init = len(seeds)
        self.estep_path_ = None
        self.bf16_guard_corrected_rows_ = None
        if batched:
            states = self._sweep_fit_batched(engine, ds, members, k_max)
            n_disp = 1
        else:
            states = self._sweep_fit_sequential(ds, members)
            n_disp = 2 * len(members)     # a fit and a scoring pass each
        cents, n_iters, sse_hist, counts, finals = states
        inertias, best_r, win_idx = sweep_mod.within_k_winners(
            finals, len(ks), n_init)
        winners = [np.asarray(cents[m][: ks[i]], dtype=self.dtype)
                   for i, m in enumerate(win_idx)]
        if criterion == "inertia":
            scores = inertias[np.arange(len(ks)), best_r]
        else:
            labels = self._sweep_labels(engine, ds, winners, k_max,
                                        batched)
            model_shards = mesh_shape(ds.mesh)[1]
            n_disp += 1 if (batched and model_shards == 1) else len(ks)
            x_host = X.host if isinstance(X, Dataset) else X
            if x_host is None:
                raise ValueError(
                    f"criterion {criterion!r} scores host rows; pass an "
                    f"array (or a dataset cached from one), or use "
                    f"criterion='inertia' for device-only data")
            rows = self._sweep_metric_rows(x_host)
            if batched:
                scores = metrics_mod.batched_criterion_scores(
                    rows, labels, criterion, mesh=ds.mesh,
                    device=self.device)
                n_disp += metrics_mod.SWEEP_SCORE_DISPATCHES[criterion]
            else:
                single = {"silhouette": metrics_mod.silhouette_score,
                          "calinski_harabasz":
                              metrics_mod.calinski_harabasz_score,
                          "davies_bouldin":
                              metrics_mod.davies_bouldin_score}[criterion]

                def score_or_nan(lab):
                    # As the batched path: a winner whose labels collapsed
                    # below 2 clusters scores NaN.
                    try:
                        return single(rows, lab, mesh=ds.mesh,
                                      device=self.device)
                    except ValueError:
                        return np.nan

                scores = np.asarray([score_or_nan(lab) for lab in labels],
                                    np.float64)
                n_disp += len(ks) * metrics_mod.SWEEP_SCORE_DISPATCHES[
                    criterion]

        selected_k, sel, m_sel = sweep_mod.selected_member(
            ks, scores, criterion, win_idx)
        best = sweep_mod.clone_for(self, k=selected_k, mesh=ds.mesh)
        best.centroids = np.asarray(cents[m_sel][:selected_k],
                                    dtype=self.dtype)
        best.iterations_run = int(n_iters[m_sel])
        best.cluster_sizes_ = np.asarray(counts[m_sel][:selected_k],
                                         np.int64)
        if self.compute_sse:
            best.sse_history = [float(s) for s in
                                sse_hist[m_sel][: int(n_iters[m_sel])]]
        best.best_restart_ = int(best_r[sel])
        best.restart_inertias_ = np.asarray(inertias[sel], np.float64)
        best.loop_path_ = "device-sweep" if batched else "sequential-sweep"
        best.estep_path_ = self.estep_path_
        best.bf16_guard_corrected_rows_ = self.bf16_guard_corrected_rows_
        best._fit_ds, best._labels_cache = None, None
        best._labels_error = ("labels_ is not materialized by sweep(); "
                              "call predict(X) on the selected model")
        return sweep_mod.SweepResult(
            family="kmeans", criterion=criterion, k_range=ks,
            scores=np.asarray(scores, np.float64),
            member_scores=inertias.astype(np.float64),
            selected_k=selected_k, selected_restart=int(best_r[sel]),
            best_model=best, n_dispatches=n_disp, batched=bool(batched),
            n_iters=np.asarray(n_iters).reshape(len(ks), n_init),
            winner_centroids=winners)

    def _member_chunk(self, ds: Dataset, members: int) -> int:
        """Rows per chunk of a pass that stages a (members, chunk, k) tile:
        the single tile's budget shared by the members (an explicit
        ``chunk_size`` passes through)."""
        if self.chunk_size:
            return self.chunk_size
        return ds.effective_chunk(members * self._tile_k(ds.d))

    def _sweep_fit_batched(self, engine: "KMeans", ds: Dataset, members,
                           k_max: int):
        """Every sweep member in one device loop: each member's seeds
        padded to k_max with sentinel rows (``dist.PAD_CENTROID_VALUE``),
        its k riding ``make_multi_fit_fn(k_reals=...)``.  The members run
        one after another, so the chunk is a k_max fit's."""
        mode = engine._mode()
        pipeline = engine._note_estep_path(mode)
        fit_fn = _cached(
            dist.make_multi_fit_fn,
            ds.mesh, chunk_size=engine._chunk_for(ds),
            mode=mode, k_real=k_max, max_iter=self.max_iter,
            tolerance=float(self.tolerance),
            empty_policy=self.empty_cluster, n_init=len(members),
            history_sse=self.compute_sse,
            k_reals=[k for k, _ in members], return_all=True,
            pipeline=pipeline, project=self._device_project)
        inits = np.full((len(members), k_max, ds.d),
                        dist.PAD_CENTROID_VALUE, self.dtype)
        for i, (k_m, seed) in enumerate(members):
            inits[i, :k_m] = engine._init_centroids(ds, seed, k=k_m)
        res = fit_fn(ds, engine._put_centroids(inits),
                     [s for _, s in members])
        self.estep_path_ = engine.estep_path_
        self.bf16_guard_corrected_rows_ = res.flagged
        inertias = np.where(res.finite, res.inertias, np.nan)
        return (res.centroids.to(torch.float64).cpu().numpy(), res.n_iters,
                res.sse_history, res.counts, inertias)

    def _sweep_fit_sequential(self, ds: Dataset, members):
        """The ``batched=0`` oracle: one device-loop fit per member on the
        same dataset, and its true final inertia."""
        from kmeans_tpu_torch import sweep as sweep_mod
        k_max = max(k for k, _ in members)
        R = len(members)
        cents = np.full((R, k_max, ds.d), dist.PAD_CENTROID_VALUE,
                        np.float64)
        n_iters = np.zeros((R,), np.int64)
        sse_hist = np.zeros((R, self.max_iter), np.float64)
        counts = np.zeros((R, k_max), np.float64)
        finals = np.full((R,), np.inf, np.float64)
        for i, (k_m, s) in enumerate(members):
            m = sweep_mod.clone_for(self, k=k_m, n_init=1, seed=s,
                                    verbose=False, compute_labels=False,
                                    host_loop=False, mesh=ds.mesh)
            m.fit(ds)
            self.estep_path_ = m.estep_path_
            if m.bf16_guard_corrected_rows_ is not None:
                self.bf16_guard_corrected_rows_ = (
                    (self.bf16_guard_corrected_rows_ or 0)
                    + m.bf16_guard_corrected_rows_)
            cents[i, :k_m] = np.asarray(m.centroids, np.float64)
            n_iters[i] = m.iterations_run
            hist = np.asarray(m.sse_history, np.float64)
            sse_hist[i, : hist.size] = hist
            counts[i, :k_m] = np.asarray(m.cluster_sizes_, np.float64)
            finals[i] = m._sse(ds)
        return cents, n_iters, sse_hist, counts, finals

    def _sweep_labels(self, engine: "KMeans", ds: Dataset, winner_cents,
                      k_max: int, batched) -> np.ndarray:
        """The labels of every per-k winner, (n_k, n): one batched pass
        (``make_multi_predict_fn``, each winner padded to k_max) without a
        model axis, else one assignment pass per winner."""
        n_k = len(winner_cents)
        mode = engine._mode()
        if batched and mesh_shape(ds.mesh)[1] == 1:
            mp_fn = _cached(
                dist.make_multi_predict_fn,
                ds.mesh, chunk_size=engine._member_chunk(ds, n_k),
                mode=mode, n_models=n_k)
            stack = np.full((n_k, k_max, ds.d), dist.PAD_CENTROID_VALUE,
                            self.dtype)
            for i, c in enumerate(winner_cents):
                stack[i, : c.shape[0]] = c
            labels = mp_fn(ds.points, engine._put_centroids(stack))
            return ds.gather_rows(labels.T.contiguous()).T
        predict_fn = _cached(dist.make_predict_fn, ds.mesh,
                             chunk_size=engine._chunk_for(ds), mode=mode)
        out = []
        for c in winner_cents:
            labels = predict_fn(ds.points, engine._put_centroids(
                np.asarray(c, self.dtype)))
            out.append(ds.gather_rows(labels))
        return np.stack(out)

    # --------------------------------------------------------------- predict

    def _require_fitted(self) -> None:
        if self.centroids is None:
            raise ValueError("Model must be fitted before prediction")

    def predict(self, X) -> np.ndarray:
        """Labels, int32 (n,), for an (n, D) array-like, tensor or
        :class:`Dataset`.  Under a mesh every rank gets every row's label;
        on a process-local dataset (``sharding.from_process_local``) the
        labels of the rank's own rows."""
        self._require_fitted()
        ds, _, predict_fn = self._prepare(X)
        if self.assign == "two_level" and mesh_shape(ds.mesh)[1] == 1:
            # The route of a two-level model; 'auto' and 'dense' keep the
            # dense assignment, and a model axis the dense TP pass.
            labels = self._predict_two_level_labels(ds)
        else:
            labels = predict_fn(ds.points,
                                self._put_centroids(self.centroids))
        return ds.gather_rows(labels)

    def fit_predict(self, X, y=None) -> np.ndarray:
        # labels_ is materialised by fit() from the same X.
        return self.fit(X).labels_

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.fit(X).transform(X)

    def transform(self, X, *, block_rows: Optional[int] = None
                  ) -> np.ndarray:
        """Euclidean distances to each centroid, (n, k) in the model's
        dtype.  Rows go to the device in host blocks of ``block_rows``
        (None: about 2^26 elements of input and output per block), so the
        device holds one block at a time; only the returned host array
        grows with n."""
        self._require_fitted()
        X = _host_rows(X, self.dtype)
        out = np.empty((X.shape[0], self.k), dtype=self.dtype)
        start = 0
        for tile in self.transform_stream(lambda: iter([X]),
                                          block_rows=block_rows):
            out[start: start + tile.shape[0]] = tile
            start += tile.shape[0]
        return out

    def transform_stream(self, make_blocks, *,
                         block_rows: Optional[int] = None,
                         prefetch: int = 2):
        """Streaming ``transform``: yields (m, k) distance tiles for the
        successive row blocks of ``make_blocks()``, blocks longer than
        ``block_rows`` split.  ``prefetch`` (default 2) reads and decodes
        the next blocks in a background thread; the tiles go to the device
        on the consumer's side (0: synchronous, the same bits)."""
        self._require_fitted()
        return self._transform_stream_blocks(make_blocks, block_rows,
                                             prefetch)

    def _transform_stream_blocks(self, make_blocks, block_rows,
                                 prefetch: int = 0):
        mode = _VALUE_MODES.get(self.distance_mode, self.distance_mode)
        d = self.centroids.shape[1]
        block = block_rows or max(8192, (1 << 26) // max(self.k + d, 1))
        for raw, _, _, cents in self._iter_stream_blocks(
                make_blocks, with_weights=False, prefetch=prefetch):
            for start in range(0, raw.shape[0], block):
                xb = raw[start: start + block]
                transform = _cached(
                    dist.make_transform_fn,
                    self._resolve_mesh(), mode=mode,
                    chunk_size=self.chunk_size or choose_chunk_size(
                        xb.shape[0], self._tile_k(d), d))
                points = _tensor_of(np.ascontiguousarray(xb)).to(
                    self.device)
                yield transform(points, cents).cpu().numpy()

    def _iter_stream_blocks(self, make_blocks, *, with_weights: bool,
                            prefetch: int = 0, stage_extra=None):
        """The scaffolding of every inference stream (predict, transform,
        score): decode each item (a pair's weights kept or dropped by
        ``with_weights``), check its width against the model, put the
        centroids on the device once, and raise the fresh-iterable error on
        an empty stream.  Yields ``(block, weights or None, extra,
        centroids)``.  With ``prefetch > 0`` the decode and
        ``stage_extra(block, weights)`` (the caller's copy to the device)
        run in a background thread ``prefetch`` blocks ahead; ``extra`` is
        what it returned (None without it).  A subclass that transforms the
        rows (``SphericalKMeans``) overrides this one method."""
        from kmeans_tpu_torch.data.prefetch import (check_prefetch,
                                                    prefetch_iter)
        from kmeans_tpu_torch.models.init import _block_of, _split_block
        prefetch = check_prefetch(prefetch)
        d = self.centroids.shape[1]
        cents = None
        empty = True

        def stage(item):
            raw = item if with_weights else _block_of(item)
            block, bw = _split_block(raw, d, self.dtype)
            extra = stage_extra(block, bw) if stage_extra is not None \
                else None
            return block, bw, extra

        # closing: a consumer that abandons the generator joins the
        # producer thread at once.
        with contextlib.closing(prefetch_iter(make_blocks(), prefetch,
                                              stage)) as it:
            for block, bw, extra in it:
                empty = False
                if cents is None:
                    cents = self._put_centroids(self.centroids)
                yield block, bw, extra, cents
        if empty:
            raise ValueError(
                "make_blocks() yielded no rows — it must return a FRESH "
                "iterable on every call")

    def predict_stream(self, make_blocks, *, prefetch: int = 2):
        """Labels of a stream of blocks, one int32 (m,) array per block:
        kernel 2 (2b) per block in the kernel modes.  ``prefetch`` as in
        ``fit_stream``.  Every rank of a mesh labels whole blocks.
        Usage: ``np.concatenate(list(km.predict_stream(blocks)))``."""
        self._require_fitted()
        return self._predict_stream_blocks(make_blocks, prefetch)

    def _predict_stream_blocks(self, make_blocks, prefetch: int = 0):
        from kmeans_tpu_torch.data.prefetch import check_prefetch
        stager = BlockStager(self.device, self.dtype,
                             check_prefetch(prefetch))
        predict_fn = None
        for block, _, staged, cents in self._iter_stream_blocks(
                make_blocks, with_weights=False, prefetch=prefetch,
                stage_extra=stager.stage):
            points, _ = stager.take(staged)
            if predict_fn is None:
                predict_fn = _cached(
                    dist.make_predict_fn,
                    self._resolve_mesh(), mode=self._mode(),
                    chunk_size=self.chunk_size or choose_chunk_size(
                        points.shape[0], self._tile_k(block.shape[1]),
                        block.shape[1]))
            labels = predict_fn(points, cents).cpu().numpy()
            del points, staged
            yield labels

    def score_stream(self, make_blocks, *, prefetch: int = 2) -> float:
        """Negative SSE of a stream of blocks (or ``(block, weights)``
        pairs) under the fitted centroids: one pass, kernel 1 (1b) per
        block in the kernel modes, the SSE summed on the host in block
        order.  Under a mesh each rank takes its share of each block.  An
        empty stream raises."""
        from kmeans_tpu_torch.data.prefetch import check_prefetch
        self._require_fitted()
        mesh = self._resolve_mesh()
        stager = BlockStager(self.device, self.dtype,
                             check_prefetch(prefetch), mesh)
        step_fn = None
        sse = 0.0
        for block, _, staged, cents in self._iter_stream_blocks(
                make_blocks, with_weights=True, prefetch=prefetch,
                stage_extra=stager.stage):
            points, weights = stager.take(staged)
            if step_fn is None:
                step_fn = _cached(
                    dist.make_step_fn,
                    mesh, mode=self._mode(), need_farthest=False,
                    need_sse_pc=False,
                    chunk_size=self.chunk_size or choose_chunk_size(
                        points.shape[0], self._tile_k(block.shape[1]),
                        block.shape[1]))
            sse += float(step_fn(points, weights, cents).sse)
            del points, weights, staged
        return -sse

    def fitted_state(self) -> dict:
        """Serving handle: what ``serving.engine`` needs to hold this model
        resident — the family tag, table shape, dtype, whether same-shape
        models may pack into one dispatch, whether requests are
        row-normalized first (``SphericalKMeans``), and the served ops.
        The JAX package's dictionary; raises before ``fit``."""
        if self.centroids is None:
            raise ValueError("Model must be fitted before serving")
        return {
            "family": "kmeans",
            "model_class": type(self).__name__,
            "k": int(self.k),
            "d": int(np.asarray(self.centroids).shape[1]),
            "dtype": np.dtype(self.dtype).str,
            # A two-level model routes through its own coarse/member
            # tables: it cannot ride the packed multi-model dispatch.
            "stackable": self.assign != "two_level",
            "normalize_inputs": False,
            "assign": ("two_level" if self.assign == "two_level"
                       else "dense"),
            "ops": ("predict", "transform", "score_rows"),
        }

    def _profile_counts(self) -> Optional[np.ndarray]:
        """Training assignment mass per cluster for the quality profile's
        histogram: the fit's weighted cluster sizes (``MiniBatchKMeans``
        takes its lifetime counts)."""
        return self.cluster_sizes_

    def _profile_rows(self) -> Optional[float]:
        """Weighted row count behind ``inertia_``: the score-per-row
        denominator and the profile's ``n_rows``."""
        if self.cluster_sizes_ is None:
            return None
        total = float(np.asarray(self.cluster_sizes_, np.float64).sum())
        return total if total > 0 else None

    def _quality_rows(self, X) -> np.ndarray:
        """Rows in the geometry ``quality_profile(X=...)`` scores distances
        in (``SphericalKMeans`` normalizes them)."""
        return np.asarray(_host_rows(X, np.float64), np.float64)

    def quality_profile(self, X=None) -> Optional[dict]:
        """Fit-time serving-quality reference profile (``obs.drift
        .build_profile``, the JAX package's dictionary): the training
        assignment histogram, the training score per row (inertia / row)
        and the per-cluster SSE where the fit computed it
        (``BisectingKMeans``' ``cluster_sse_``).

        Sources, in order: an explicit ``X`` (one ``predict`` pass and
        float64 host distances); the fitted attributes; the profile
        restored from a checkpoint.  None when there is none."""
        from kmeans_tpu_torch.obs import drift as obs_drift
        if X is not None:
            if self.centroids is None:
                raise ValueError("Model must be fitted before building "
                                 "a quality profile from data")
            rows = self._quality_rows(X)
            labels = np.asarray(self.predict(X))
            cents = np.asarray(self.centroids, np.float64)
            d2 = np.sum((rows - cents[labels]) ** 2, axis=1)
            per_cluster = np.zeros(self.k, np.float64)
            np.add.at(per_cluster, labels, d2)
            return obs_drift.build_profile(
                family="kmeans", model_class=type(self).__name__,
                k=self.k,
                counts=np.bincount(labels, minlength=self.k),
                score_kind="sse", score_per_row=float(d2.mean()),
                per_cluster_sse=per_cluster,
                n_rows=float(labels.size))
        counts = self._profile_counts()
        if self.centroids is not None and counts is not None:
            inertia = self.inertia_
            rows = self._profile_rows()
            return obs_drift.build_profile(
                family="kmeans", model_class=type(self).__name__,
                k=self.k, counts=counts, score_kind="sse",
                score_per_row=(inertia / rows
                               if inertia is not None and rows
                               else None),
                per_cluster_sse=getattr(self, "cluster_sse_", None),
                n_rows=rows)
        return self._quality_profile

    def score(self, X, y=None) -> float:
        """Negative SSE of X under the fitted centroids."""
        self._require_fitted()
        return -self._sse(self.cache(X))

    # ------------------------------------------------- estimator protocol

    def get_params(self, deep: bool = True) -> dict:
        """Constructor parameters (the scikit-learn estimator protocol).
        The JAX package's arguments that the port takes only at one value
        report that value; ``device`` is a string."""
        params = {}
        for name in self._PARAM_NAMES:
            if name in _LATER_ARGS:
                params[name] = _LATER_ARGS[name][0][0]
            elif name == "device":
                params[name] = str(self.device)
            else:
                params[name] = getattr(self, name)
        return params

    def set_params(self, **params) -> "KMeans":
        """New values go through ``__init__``, so they get the
        constructor's validation; fitted state is kept, and on an error
        the model is left as it was."""
        for name in params:
            if name not in self._PARAM_NAMES:
                raise ValueError(f"unknown parameter {name!r} for "
                                 f"{type(self).__name__}; valid: "
                                 f"{sorted(self._PARAM_NAMES)}")
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

    def get_feature_names_out(self, input_features=None) -> np.ndarray:
        """Names of ``transform``'s columns, one distance per centroid."""
        name = type(self).__name__.lower()
        return np.asarray([f"{name}{i}" for i in range(self.k)],
                          dtype=object)

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

    @labels_.setter
    def labels_(self, value) -> None:
        self._labels_cache = value

    def __getstate__(self) -> dict:
        """Pickling: ``labels_`` is materialised first, then the retained
        dataset (device memory) is dropped."""
        if self._labels_cache is None and self._fit_ds is not None \
                and self.centroids is not None:
            _ = self.labels_
        state = dict(self.__dict__)
        state["_fit_ds"] = None
        state["_cents_cache"] = None        # a device copy, not state
        return state

    def __deepcopy__(self, memo):
        """A deep copy shares the retained dataset (device memory) and
        copies everything else."""
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        for name, value in self.__dict__.items():
            new.__dict__[name] = (value if name == "_fit_ds"
                                  else None if name == "_cents_cache"
                                  else copy.deepcopy(value, memo))
        return new

    # ------------------------------------------------------------ checkpoint

    def _state_dict(self) -> dict:
        """Serialisable state in the vocabulary of the shared checkpoint
        format: constructor arguments and fitted attributes.  The kernel
        modes are written as 'pallas' and 'pallas_bf16', the format's names
        for them, so that the JAX package loads the file, with the model's
        own ``host_loop`` and ``pipeline``, and the topology block of the
        reference (``meta_mesh_*``: the mesh it was written on, None for
        one device).  A callable ``init`` is recorded as 'forgy'
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
            "model_shards": self.model_shards,
            "chunk_size": self.chunk_size,
            "host_loop": self.host_loop,
            "pipeline": self.pipeline,
            "bucket": self.bucket,
            "overlap": self.overlap,
            "ingest": self.ingest,
            "k_shard": self.k_shard,
            "assign": self.assign,
            "coarse_cells": self.coarse_cells,
            "nprobe": self.nprobe,
            "init_cap": self.init_cap,
            "verbose": self.verbose,
            "sse_history": list(map(float, self.sse_history)),
            "iterations_run": self.iterations_run,
            "dtype": str(self.dtype),
        }
        state.update(self._ckpt_meta())
        # The serving-quality reference rides the JSON meta block, so a
        # loaded model carries its own reference window.
        state["quality_profile"] = self.quality_profile()
        # The two-level coarse table is fitted state (trained once per fit,
        # then fixed): a model loaded without it would train another one
        # from its final table and route rows to other candidates.
        if self._two_level_route_ is not None:
            state["two_level_coarse"] = np.asarray(
                self._two_level_route_[0], np.float64)
        if isinstance(self.init, str):
            state["init"] = self.init
        elif not callable(self.init):
            state["init_array"] = np.asarray(self.init)
        return state

    @classmethod
    def _from_state(cls, state: dict, device=None, mesh=None) -> "KMeans":
        """A model from a checkpoint dictionary written by either package,
        on ``mesh`` (the topology it was written on is information only:
        the state is the whole table).  Constructor arguments that the port
        does not have are dropped, with one warning that lists those whose
        value the port cannot honour."""
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

        def int_or(value):
            return value if value is None or isinstance(value, str) \
                else int(value)

        model = cls(k=int(state["k"]), max_iter=int(state["max_iter"]),
                    tolerance=float(state["tolerance"]),
                    seed=int(state["seed"]),
                    compute_sse=bool(state["compute_sse"]), init=init,
                    n_init=int(state.get("n_init", 1)),
                    compute_labels=bool(state.get("compute_labels", True)),
                    empty_cluster=str(state["empty_cluster"]),
                    distance_mode=str(state["distance_mode"]),
                    chunk_size=None if chunk is None else int(chunk),
                    host_loop=state.get("host_loop", "auto"),
                    pipeline=state.get("pipeline", "auto"),
                    bucket=int_or(state.get("bucket", 0)),
                    overlap=int_or(state.get("overlap", "auto")),
                    ingest=str(state.get("ingest", "auto")),
                    k_shard=int_or(state.get("k_shard", "auto")),
                    assign=str(state.get("assign", "auto")),
                    coarse_cells=int_or(state.get("coarse_cells")),
                    nprobe=int_or(state.get("nprobe")),
                    verbose=bool(state["verbose"]),
                    dtype=np.dtype(str(state["dtype"])), device=device,
                    mesh=mesh, init_cap=(
                        None if state.get("init_cap") is None
                        else int(state["init_cap"])),
                    **cls._load_kwargs(state))
        model._restore_fitted(state)
        return model

    def _restore_fitted(self, state: dict) -> None:
        """The fitted state of a checkpoint (either package's), onto this
        model: centroids, SSE history, iterations, and the family's own
        (``_restore_state``).  ``load`` and ``fit(resume=<path>)`` both
        come here, and so does a rollback."""
        cents = np.asarray(state["centroids"])
        self.centroids = cents.astype(self.dtype) if cents.size else None
        self.sse_history = [float(s) for s in state["sse_history"]]
        self.iterations_run = int(state["iterations_run"])
        self._quality_profile = state.get("quality_profile")
        # The two-level route from the saved coarse table (the member lists
        # follow from it and the table); without one, predict trains one.
        coarse = state.get("two_level_coarse")
        self._two_level_route_ = self._route_cache = None
        if coarse is not None and np.size(coarse) and \
                self.centroids is not None:
            coarse = np.asarray(coarse, np.float64)
            self._two_level_route_ = (coarse, self._build_members(
                np.asarray(self.centroids, np.float64), coarse))
        self._restore_state(state)

    @classmethod
    def _load_kwargs(cls, state: dict) -> dict:
        """A family's own constructor arguments in a checkpoint."""
        return {}

    def _restore_state(self, state: dict) -> None:
        """A family's own fitted state in a checkpoint (none here)."""

    def save(self, path) -> None:
        """Write the fitted state as one ``.npz`` checkpoint.  Under a mesh
        every rank calls it; the primary rank writes, and every rank
        returns once the file is complete."""
        ckpt.save_state_primary(path, self._state_dict(), self.mesh)

    @classmethod
    def load(cls, path, device=None, mesh=None) -> "KMeans":
        """Load a checkpoint written by this package or by the JAX package,
        on any mesh (``mesh`` as in the constructor).  ``device`` as in the
        constructor."""
        return cls._from_state(ckpt.load_state(path), device=device,
                               mesh=mesh)
