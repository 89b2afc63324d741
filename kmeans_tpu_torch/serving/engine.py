"""Resident model server: fitted models held on the card, requests padded
to a small ladder of bucket shapes, served through the assignment kernels.

Counterpart of the JAX package's ``serving/engine.py``:

* **Resident models.**  ``add_model`` / ``load`` hold a fitted model's
  table on the engine's device once: a K-Means-family table in the
  model's own cache (``KMeans._cents_dev``, keyed by the ``centroids``
  object it read, so a refit or a published update is picked up, and
  every engine serving the model shares it), a mixture's E-step tables
  in the resident's.  The model itself is re-pointed to the engine's
  device and mesh, so direct calls and dispatches agree.
* **Bucketed shapes.**  A request pads to the smallest bucket of the
  ladder (default 8/64/512/4096; oversize rounds up to a multiple of the
  top), so each (model, bucket) builds its step function once.
* **Staging reuse** (``donate``; the JAX package donates the staging
  buffer to the compiled program).  With ``donate`` on (``'auto'``: on a
  CUDA device) each bucket shape keeps one pinned host buffer and one
  device buffer, filled in place on every dispatch; off, every dispatch
  allocates its own.  The labels are the same either way.
* **Micro-batching** (``serving.batching``): concurrent small requests for
  one model coalesce into one padded dispatch.
* **Packed routing.**  Same-shape K-Means-family models stack on a model
  axis (``distributed.make_multi_predict_fn``), so a routed mixed-model
  batch is one dispatch.
* **Serve-and-learn** (``learn=``, ``serving.learn``): a monitored
  ``MiniBatchKMeans`` resident updates in place from its own traffic when
  its drift monitor fires, published by one atomic swap.
* **Quantized paths.**  ``quantize='bf16'`` assigns through the bf16 cross
  term with the near-tie guard (``make_assign_margin_fn``; flagged rows
  relabeled by the float32 predict), so labels equal the float32 path by
  construction; ``quantize='pq'`` answers by ADC against a product-
  quantized table (``ProductQuantizer.adc_assign``).

The dense K-Means ``predict`` route is ``distributed.make_predict_fn`` in
the model's own mode: on a CUDA device in the kernel modes that is kernel 2
(``ops.hopper_kernels.hopper_assign``), or 2b for ``'kernel_bf16'``, one
launch per dispatch; ``score_rows`` takes the same kernel's ``mind2``
(``make_score_rows_fn``).  On a CUDA tensor a wrapper launches its kernel
or raises; the engine catches no launch error.  Parity: served labels are
bit-equal to the model's own ``predict`` on the same rows (the same step
functions, modes and table).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kmeans_tpu_torch.models.kmeans import _cached, resolve_device
from kmeans_tpu_torch.obs import drift as obs_drift
from kmeans_tpu_torch.obs import metrics_registry as obs_metrics
from kmeans_tpu_torch.obs import trace as obs_trace
from kmeans_tpu_torch.ops.assign import BF16_GUARD_RTOL as BF16_TIE_RTOL
from kmeans_tpu_torch.ops.assign import value_mode
from kmeans_tpu_torch.parallel import distributed as dist
from kmeans_tpu_torch.parallel.mesh import check_mesh, mesh_shape
from kmeans_tpu_torch.parallel.sharding import (Dataset, ShardedDataset,
                                                choose_chunk_size, to_device,
                                                torch_dtype)
from kmeans_tpu_torch.serving.batching import (DEFAULT_BUCKETS,
                                               MicroBatchQueue,
                                               ServingFuture, bucket_for,
                                               check_buckets)
from kmeans_tpu_torch.serving.registry import ModelRegistry
from kmeans_tpu_torch.utils.profiling import note_dispatch

__all__ = ["ServingEngine", "ResidentModel", "BF16_TIE_RTOL"]

#: The ``learn=`` overrides an engine accepts (``serving.learn``'s
#: committed rules, and the snapshot directory).
_LEARN_KEYS = {"dir", "batch_rows", "max_batches", "reservoir_rows",
               "min_rows", "update_budget", "rollback_budget",
               "cooldown_windows", "regression_ratio", "eval_windows"}

#: The bf16 form of each float32-class mode a quantized resident serves
#: ``score_rows`` through ('direct' has none; the guarded rung is already
#: guarded).  ``predict`` takes the guarded route whatever the mode.
_BF16_MODES = {"matmul": "matmul_bf16", "kernel": "kernel_bf16"}

#: Fitted-table attributes summed into a resident model's footprint.
_TABLE_ATTRS = ("centroids", "means_", "covariances_", "weights_",
                "precisions_cholesky_")


def _model_table_bytes(model) -> int:
    """Host-side bytes of a fitted model's parameter tables — the
    per-device residency cost of serving it."""
    total = 0
    for attr in _TABLE_ATTRS:
        arr = getattr(model, attr, None)
        nbytes = getattr(arr, "nbytes", None)
        if nbytes is not None:
            total += int(nbytes)
    return total


def refuse_multi_rank(mesh, what: str) -> None:
    """Raise for ``what`` on a mesh of more than one rank.  Every rank of
    a mesh runs the same collectives in the same order; a router choosing
    by latencies measured in its own process, or a learner thread started
    when its own rank's monitor fires, would let the ranks diverge and
    hang.  Raised before any collective runs."""
    data, model = mesh_shape(mesh)
    if data * model > 1:
        raise NotImplementedError(
            f"{what} on a mesh of {data * model} ranks is not ported to "
            f"kmeans_tpu_torch yet: ROADMAP.md, A.21 'Serving fleet and "
            f"serve-and-learn on a multi-rank mesh'")


class ResidentModel:
    """One resident model: the fitted estimator, its serving spec, its
    device table (``table_dev``), its learner and its counters."""

    def __init__(self, model_id: str, model, spec: dict, quantize):
        self.model_id = model_id
        self.model = model
        self.spec = spec
        self.quantize = quantize
        # Drift monitor; None when the engine runs with quality off.
        self.monitor: Optional[obs_drift.QualityMonitor] = None
        # serving.learn.ModelLearner; None without learn= or for a model
        # that cannot update in place.
        self.learner = None
        # bucket -> latency histogram, resolved once per (model, bucket).
        self._lat_hists: Dict[int, object] = {}
        self.requests = 0
        self.rows = 0
        self.dispatches = 0
        # Rows the bf16 near-tie guard relabeled at float32.
        self.bf16_corrected_rows = 0
        # quantize='pq': the table's quantizer and codes, built at add time.
        self.pq = None
        self.pq_codes: Optional[np.ndarray] = None
        self.pq_corrected_rows = 0
        self.table_bytes = _model_table_bytes(model)
        self._table: Optional[tuple] = None

    def preprocess(self, rows: np.ndarray) -> np.ndarray:
        """What the model's own ``predict`` does to a raw array
        (``SphericalKMeans`` normalizes rows in float64 first)."""
        dtype = np.dtype(self.spec["dtype"])
        if self.spec["normalize_inputs"]:
            from kmeans_tpu_torch.models.spherical import _normalize_rows
            return _normalize_rows(
                np.asarray(rows, np.float64)).astype(dtype)
        return np.asarray(rows, dtype=dtype)

    def table_dev(self):
        """The model's table on its device, placed once per fitted table.
        K-Means family: ``KMeans._cents_dev``, which reads ``centroids``
        once and keys the model's cache on the object it uploads (a
        publication by ``serving.learn.publish_tables`` is seen by every
        engine serving the model).  A mixture: the E-step tables of
        ``GaussianMixture._params_dev``, cached here under the fitted
        arrays it was built from; the arrays are read before and after the
        build, and a build they changed under is redone, so the tables
        never pair with another version's key."""
        model = self.model
        if self.spec["family"] != "gmm":
            return model._cents_dev()
        while True:
            tokens = (model.means_, model.covariances_, model.weights_)
            cached = self._table
            if cached is not None and all(
                    a is b for a, b in zip(cached[0], tokens)):
                return cached[1]
            dev = model._params_dev()
            if all(a is b for a, b in zip(tokens, (
                    model.means_, model.covariances_, model.weights_))):
                self._table = (tokens, dev)
                return dev


class _Staging:
    """One bucket shape's reused buffers: a pinned host buffer and a device
    buffer (``donate``), filled in place under ``lock``, which a dispatch
    holds until its results are on the host.  Reentrant: the bf16 guard's
    fix-up may stage its rows in the same bucket shape, after the outer
    dispatch's results were read back."""

    def __init__(self, rows: int, d: int, dtype, device):
        tdtype = torch_dtype(dtype)
        self.lock = threading.RLock()
        self.host = torch.zeros((rows, d), dtype=tdtype,
                                pin_memory=device.type == "cuda")
        self.dev = torch.zeros((rows, d), dtype=tdtype, device=device)
        self.weights = torch.ones(rows, dtype=tdtype, device=device)

    @property
    def nbytes(self) -> int:
        return int(self.host.nbytes + self.dev.nbytes + self.weights.nbytes)


class ServingEngine:
    """Multi-model online serving on one device or a mesh.

    Parameters
    ----------
    device : None | str | torch.device
        Where resident tables live and dispatches run, as in the
        estimators: ``None`` is the card (and raises where there is none);
        ``device='cpu'`` runs the kernels' plain versions.
    mesh : DeviceMesh or None
        The mesh every resident model serves on (``parallel.mesh
        .make_mesh``); every rank calls the engine with the same rows.
    buckets : ascending request-batch size ladder.
    max_wait_ms : float
        Micro-batch flush timer of the ``submit`` path.
    clock, start : forwarded to :class:`MicroBatchQueue` (injectable clock
        / no worker thread, for deterministic tests).
    donate : 'auto' | bool
        Reuse one pinned host buffer and one device buffer per bucket shape
        (see the module docstring); 'auto' = on a CUDA device.
    quality : 'auto' | bool
        Per-model drift monitoring, fed with the outputs each dispatch
        already computed (labels bit-equal with it on or off).  'auto' is
        on for the card (or when ``quality_dir`` is given), off on the CPU,
        as the JAX package resolves it for an accelerator.
    quality_dir, quality_window, quality_tag : the drift sinks
        (``quality.<model_id>[.<tag>].jsonl``), rows per window, and the
        sink suffix.
    learn : False | True | dict
        Serve-and-learn (``serving.learn``).  ``True`` attaches a
        :class:`~kmeans_tpu_torch.serving.learn.ModelLearner` to every
        resident that can update in place (a monitored K-Means-family
        model with ``partial_fit``, not ``quantize='pq'``, not two-level)
        with the committed rules; a dict turns learning on and overrides
        rules (``_LEARN_KEYS``; ``dir`` is the snapshot directory,
        default ``quality_dir`` or a temporary one).  Needs quality
        monitoring: the trigger is the drift monitor.  On a mesh of more
        than one rank it raises ``NotImplementedError`` (ROADMAP.md,
        A.21).
    """

    def __init__(self, *, device=None, mesh=None, buckets=DEFAULT_BUCKETS,
                 max_wait_ms: float = 2.0, clock=None, start: bool = True,
                 donate="auto", quality="auto", quality_dir=None,
                 quality_window: Optional[int] = None,
                 quality_tag: Optional[str] = None,
                 learn=False):
        self.device = resolve_device(device)
        self.mesh = check_mesh(mesh)
        self.buckets = check_buckets(buckets)
        self.registry = ModelRegistry()
        self._residents: Dict[str, ResidentModel] = {}
        if donate == "auto":
            donate = self.device.type == "cuda"
        self._donate = bool(donate)
        self._staging: Dict[tuple, _Staging] = {}
        # Step functions by key (mode, chunk, ...), built once.
        self._fns: Dict[tuple, Callable] = {}
        # (model ids) -> (centroid identity tokens, device (M, k, D) stack).
        self._pack_cache: Dict[tuple, tuple] = {}
        self._lock = threading.Lock()
        # warmup() probes run through the real dispatch path; this flag
        # keeps them out of the stats and the audit counters.
        self._tls = threading.local()
        # Bucket-fill histogram: bucket -> [dispatches, real rows].
        self._fill: Dict[int, List[int]] = {}
        if quality not in ("auto", True, False):
            raise ValueError(f"quality must be 'auto', True or False, "
                             f"got {quality!r}")
        if quality == "auto":
            quality = quality_dir is not None or self.device.type == "cuda"
        self._quality = bool(quality)
        self._quality_dir = str(quality_dir) if quality_dir is not None \
            else None
        self._quality_window = int(quality_window) \
            if quality_window is not None else obs_drift.DRIFT_WINDOW_ROWS
        self._quality_tag = str(quality_tag) if quality_tag is not None \
            else None
        # Serve-and-learn: None (off) or the dict of rule overrides.
        if learn in (False, None):
            self._learn_cfg = None
        else:
            if learn is not True and not isinstance(learn, dict):
                raise ValueError(f"learn must be False, True or a dict "
                                 f"of overrides, got {learn!r}")
            cfg = {} if learn is True else dict(learn)
            unknown = set(cfg) - _LEARN_KEYS
            if unknown:
                raise ValueError(f"unknown learn config keys "
                                 f"{sorted(unknown)}; allowed: "
                                 f"{sorted(_LEARN_KEYS)}")
            if not self._quality:
                raise ValueError(
                    "learn requires quality monitoring: the "
                    "serve-and-learn trigger IS the drift monitor "
                    "(pass quality=True, or a quality_dir)")
            refuse_multi_rank(self.mesh, "ServingEngine(learn=...)")
            self._learn_cfg = cfg
        self._learn_dir: Optional[str] = None   # resolved at first attach
        # Called with (model_id, op) before every dispatch — direct,
        # queued and packed; a raise here fails that dispatch.
        self.dispatch_guard = None
        self.dispatches = 0
        self.packed_dispatches = 0
        self.queue = MicroBatchQueue(
            self._dispatch, buckets=self.buckets,
            max_wait_ms=max_wait_ms, clock=clock, start=start,
            validate=self._validate)

    # -------------------------------------------------------- residency

    def add_model(self, model_id: str, model, *,
                  quantize: Optional[str] = None,
                  profile: Optional[dict] = None) -> ResidentModel:
        """Make a FITTED model resident.  ``quantize='bf16'`` serves its
        assignment through the guarded bf16 path; ``quantize='pq'``
        compresses its table with a product quantizer trained now and
        serves ``predict`` by ADC (labels: the exact argmin over the
        decoded table).  ``profile`` overrides the drift monitor's
        reference (default: the model's ``quality_profile()``)."""
        if quantize not in (None, "bf16", "pq"):
            raise ValueError(f"quantize must be None, 'bf16' or 'pq', "
                             f"got {quantize!r}")
        if quantize is not None and mesh_shape(self.mesh)[1] != 1:
            raise ValueError(
                f"quantize={quantize!r} requires a data-parallel mesh "
                "(neither the guarded bf16 assignment nor the PQ-ADC "
                "route has a TP centroid-sharding form); serve this "
                "model unquantized or use model_shards=1")
        spec = self.registry.register(model_id, model)
        if spec.get("assign") == "two_level":
            if mesh_shape(self.mesh)[1] != 1:
                self.registry.remove(model_id)
                raise ValueError(
                    "a two-level (assign='two_level') model requires a "
                    "data-parallel serving mesh (model_shards == 1): "
                    "the coarse->candidates route addresses the same "
                    "memory wall as TP centroid sharding and the two "
                    "tiers do not stack")
            if quantize is not None:
                self.registry.remove(model_id)
                raise ValueError(
                    "quantize does not compose with assign='two_level' "
                    "— the quantized fast paths score the DENSE table, "
                    "the two-level route a candidate subset; serve one "
                    "approximation at a time")
        # One device and mesh for everything resident: direct model calls
        # and dispatches run the same passes on the same table.
        model.device = self.device
        model.mesh = self.mesh
        if spec["family"] == "gmm":
            quantize = None       # quantized assign is K-Means-family
        rm = ResidentModel(model_id, model, spec, quantize)
        if quantize == "pq":
            from kmeans_tpu_torch.models.pq import ProductQuantizer
            rm.pq, rm.pq_codes = ProductQuantizer.for_table(
                np.asarray(model.centroids), mesh=self.mesh,
                seed=int(getattr(model, "seed", 0)), device=self.device)
        if self._quality:
            if profile is None:
                qp = getattr(model, "quality_profile", None)
                profile = qp() if callable(qp) else None
            sink_name = f"quality.{model_id}.jsonl" \
                if self._quality_tag is None \
                else f"quality.{model_id}.{self._quality_tag}.jsonl"
            sink = os.path.join(self._quality_dir, sink_name) \
                if self._quality_dir is not None else None
            rm.monitor = obs_drift.QualityMonitor(
                model_id, spec["k"], profile=profile,
                window_rows=self._quality_window, sink_path=sink)
        self._attach_learner(rm)
        self._residents[model_id] = rm
        return rm

    def _attach_learner(self, rm: ResidentModel) -> None:
        """Attach a serve-and-learn learner when the engine runs with
        ``learn=`` and the model can update in place: monitored (the
        trigger), ``updatable`` in its spec (a K-Means-family model with
        ``partial_fit``), not ``quantize='pq'`` (its codes were trained
        against the table at add time) and not two-level (its route has
        no ``partial_fit``).  Other residents serve unchanged, with
        ``update_status()[model_id] is None``."""
        if self._learn_cfg is None or rm.monitor is None:
            return
        if not rm.spec.get("updatable") or rm.quantize == "pq":
            return
        if rm.spec.get("assign") == "two_level":
            return
        from kmeans_tpu_torch.serving import learn as serve_learn
        if self._learn_dir is None:
            self._learn_dir = self._learn_cfg.get("dir") \
                or self._quality_dir
            if self._learn_dir is None:
                import tempfile
                self._learn_dir = tempfile.mkdtemp(prefix="kmeans-learn-")
        kwargs = {k: v for k, v in self._learn_cfg.items() if k != "dir"}
        rm.learner = serve_learn.ModelLearner(
            self, rm,
            snapshot_path=serve_learn.snapshot_path_for(
                self._learn_dir, rm.model_id, self._quality_tag),
            **kwargs)

    def load(self, path, model_id: Optional[str] = None, *,
             quantize: Optional[str] = None) -> str:
        """Load a checkpoint of either package (any family, any mesh it
        was written on) onto the engine's device and make it resident.
        The checkpoint's quality profile becomes the drift reference."""
        mid, model = self.registry.load(path, model_id, device=self.device,
                                        mesh=self.mesh)
        self.registry.remove(mid)
        self.add_model(mid, model, quantize=quantize)
        return mid

    def remove(self, model_id: str) -> None:
        self.registry.remove(model_id)
        rm = self._residents.pop(model_id)
        # The learner first, joined: an update in flight finishes (or
        # gives up unpublished) before the monitor's sink closes.
        if rm.learner is not None:
            rm.learner.close(join=True)
        if rm.monitor is not None:
            rm.monitor.close()
        with self._lock:
            self._pack_cache = {ids: v for ids, v in
                                self._pack_cache.items()
                                if model_id not in ids}

    def models(self) -> List[str]:
        return self.registry.ids()

    def _rm(self, model_id: str) -> ResidentModel:
        try:
            return self._residents[model_id]
        except KeyError:
            raise KeyError(
                f"no resident model {model_id!r}; resident: "
                f"{sorted(self._residents)}") from None

    # ------------------------------------------------------- validation

    def _validate(self, model_id, op: str, rows) -> np.ndarray:
        """Canonicalize one request's rows; every failure here is
        per-request (the queue isolates it at submit time)."""
        rm = self._rm(model_id)
        if op not in rm.spec["ops"]:
            raise ValueError(
                f"op {op!r} not served for model {model_id!r} "
                f"(family {rm.spec['family']}); available: "
                f"{rm.spec['ops']}")
        if isinstance(rows, torch.Tensor):
            rows = rows.detach().cpu().numpy()
        rows = np.asarray(rows)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[1] != rm.spec["d"]:
            raise ValueError(
                f"request rows must be (m, {rm.spec['d']}) for model "
                f"{model_id!r}, got shape {rows.shape}")
        if rows.shape[0] == 0:
            raise ValueError("request must contain at least one row")
        block = rm.preprocess(rows)
        if not np.all(np.isfinite(block)):
            raise ValueError(
                f"request for model {model_id!r} contains non-finite "
                f"values")
        return block

    # --------------------------------------------------------- dispatch

    def _warming(self) -> bool:
        return getattr(self._tls, "warming", False)

    def _record(self, rm: ResidentModel, bucket: int, m: int,
                n_requests: int = 1) -> None:
        if self._warming():
            return
        with self._lock:
            self.dispatches += 1
            rm.dispatches += 1
            rm.requests += n_requests
            rm.rows += m
            fill = self._fill.setdefault(bucket, [0, 0])
            fill[0] += 1
            fill[1] += m
        reg = obs_metrics.REGISTRY
        reg.counter("serve.dispatches").inc()
        reg.counter("serve.requests").inc(n_requests)
        reg.counter("serve.rows").inc(m)

    def _observe_quality(self, rm: ResidentModel, bucket: int,
                         dt_s: Optional[float], *, rows: int = 0,
                         labels=None, score=None, near_ties: int = 0,
                         guarded_rows: int = 0) -> None:
        """Feed one dispatch's already-computed outputs into the model's
        drift monitor and its (model, bucket) latency histogram: host-side
        reads only, never a launch, skipped for warm-up probes."""
        if rm.monitor is None or self._warming():
            return
        if dt_s is not None:
            hist = rm._lat_hists.get(bucket)
            if hist is None:
                hist = obs_metrics.REGISTRY.histogram(
                    f"serve.latency_ms.{rm.model_id}.b{bucket}")
                rm._lat_hists[bucket] = hist
            hist.observe(dt_s * 1e3)
        rm.monitor.observe(rows, labels=labels, score=score,
                           near_ties=near_ties,
                           guarded_rows=guarded_rows)

    def _feed_learner(self, rm: ResidentModel, rows: np.ndarray) -> None:
        """The learner's tap: keep this dispatch's rows (already on the
        host) and run the O(1) trigger check.  Host-side only and never a
        launch, warm-up probes left out, as the quality feed beside it."""
        ln = rm.learner
        if ln is None or self._warming():
            return
        ln.offer(rows)
        ln.poke()

    def _fn(self, key: tuple, make: Callable) -> Callable:
        """The step function under ``key``, made at first use by ``make``
        (which takes it from ``models.kmeans._STEP_CACHE``, shared with
        the models and the other engines of the process)."""
        fn = self._fns.get(key)
        if fn is None:
            with self._lock:
                fn = self._fns.setdefault(key, make())
        return fn

    def _kmeans_modes(self, rm: ResidentModel) -> Tuple[str, str]:
        """(assign mode, transform mode): the model's own resolved mode,
        with its bf16 form for a ``quantize='bf16'`` resident."""
        mode = rm.model._mode()
        if rm.quantize == "bf16":
            mode = _BF16_MODES.get(mode, mode)
        tmode = value_mode({"kernel": "matmul",
                            "kernel_bf16": "matmul_bf16"}.get(mode, mode))
        return mode, tmode

    def _predict_fn(self, chunk: int, mode: str) -> Callable:
        return self._fn(("predict", chunk, mode),
                        lambda: _cached(
                            dist.make_predict_fn, self.mesh,
                            chunk_size=chunk, mode=mode))

    def _serve_chunk(self, rm: ResidentModel, B: int) -> int:
        """The torch passes' chunk for a bucket-B dispatch: the automatic
        rule at the bucket shape, never the model's training
        ``chunk_size`` (labels are per row, whatever the chunk)."""
        data_shards, model_shards = mesh_shape(self.mesh)
        return choose_chunk_size(
            -(-B // data_shards),
            max(rm.model._tile_k(rm.spec["d"]), model_shards),
            rm.spec["d"])

    def _stage(self, rm: ResidentModel, rows: np.ndarray
               ) -> Tuple[np.ndarray, int, int]:
        """Pad validated rows into this request batch's bucket buffer."""
        m = rows.shape[0]
        B = bucket_for(m, self.buckets)
        buf = np.zeros((B, rm.spec["d"]), dtype=np.dtype(rm.spec["dtype"]))
        buf[:m] = rows
        return buf, m, B

    def _place(self, buf: np.ndarray, chunk: int):
        """``(dataset, release)``: the bucket buffer as a dataset on the
        engine's device (the rank's block under a mesh), and the call that
        frees its staging buffers once the results are on the host.  With
        ``donate`` on one device the bucket shape's pinned host and device
        buffers are filled in place (held under their lock until
        ``release``); otherwise the rows are placed anew."""
        if self.mesh is not None:
            return to_device(buf, self.device, buf.dtype, mesh=self.mesh,
                             chunk=chunk), lambda: None
        if not self._donate:
            pts = torch.from_numpy(buf).to(self.device)
            return Dataset(pts, torch.ones(buf.shape[0], dtype=pts.dtype,
                                           device=self.device)), \
                lambda: None
        key = (buf.shape[0], buf.shape[1], buf.dtype.str)
        st = self._staging.get(key)
        if st is None:
            with self._lock:
                st = self._staging.setdefault(
                    key, _Staging(buf.shape[0], buf.shape[1], buf.dtype,
                                  self.device))
        st.lock.acquire()
        try:
            st.host.numpy()[:] = buf
            st.dev.copy_(st.host, non_blocking=True)
        except BaseException:
            st.lock.release()
            raise
        return Dataset(st.dev, st.weights), st.lock.release

    @staticmethod
    def _host(ds: Dataset, values: torch.Tensor) -> np.ndarray:
        """Per-row results of every row as a host array."""
        if isinstance(ds, ShardedDataset):
            return ds.gather_rows(values)
        return values.cpu().numpy()

    def _dispatch(self, model_id, op: str, rows: np.ndarray) -> np.ndarray:
        """One coalesced batch -> per-row result array (axis 0 aligned
        with ``rows``; the queue slices per request)."""
        guard = self.dispatch_guard
        if guard is not None:
            guard(model_id, op)
        rm = self._rm(model_id)
        if rm.spec["family"] == "gmm":
            return self._dispatch_gmm(rm, op, rows)
        return self._dispatch_kmeans(rm, op, rows)

    def _dispatch_kmeans(self, rm: ResidentModel, op: str,
                         rows: np.ndarray) -> np.ndarray:
        buf, m, B = self._stage(rm, rows)
        mode, tmode = self._kmeans_modes(rm)
        chunk = self._serve_chunk(rm, B)
        corrected = 0
        guarded = 0
        t0 = time.perf_counter()
        with obs_trace.span("serve.request", model=rm.model_id, op=op,
                            rows=m, bucket=B):
            cents = rm.table_dev()
            if op == "predict" and rm.quantize == "pq":
                out, corrected = self._assign_pq(rm, buf, m)
                guarded = m
                if corrected and not self._warming():
                    with self._lock:
                        rm.pq_corrected_rows += corrected
            elif op == "transform":
                tfn = self._fn(("transform", chunk, tmode),
                               lambda: _cached(
                                   dist.make_transform_fn, self.mesh,
                                   chunk_size=chunk, mode=tmode))
                out = tfn(torch.from_numpy(buf).to(self.device),
                          cents).cpu().numpy()[:m, :rm.spec["k"]]
            else:
                ds, release = self._place(buf, chunk)
                try:
                    if op == "predict" and rm.quantize == "bf16":
                        out, corrected = self._assign_bf16_guarded(
                            rm, buf, ds, cents, chunk, m)
                        guarded = m
                        if corrected and not self._warming():
                            with self._lock:
                                rm.bf16_corrected_rows += corrected
                    elif op == "predict" and \
                            rm.spec.get("assign") == "two_level":
                        out = self._assign_two_level(rm, ds, m)
                    elif op == "predict":
                        out = self._host(ds, self._predict_fn(chunk, mode)(
                            ds.points, cents))[:m]
                    elif op == "score_rows":
                        smode = value_mode(mode)
                        sfn = self._fn(("score_rows", chunk, smode),
                                       lambda: _cached(
                                           dist.make_score_rows_fn,
                                           self.mesh, chunk_size=chunk,
                                           mode=smode))
                        out = self._host(ds, sfn(ds.points, cents))[:m]
                    else:                   # unreachable past _validate
                        raise ValueError(f"unknown op {op!r}")
                finally:
                    release()
        self._record(rm, B, m)
        self._observe_quality(
            rm, B, time.perf_counter() - t0, rows=m,
            labels=out if op == "predict" else None,
            score=out if op == "score_rows" else None,
            near_ties=corrected, guarded_rows=guarded)
        self._feed_learner(rm, rows)
        return out

    def _assign_bf16_guarded(self, rm: ResidentModel, buf: np.ndarray,
                             ds: Dataset, cents, chunk: int, m: int
                             ) -> Tuple[np.ndarray, int]:
        """The quantized path with exact tie-breaking: bf16 distances
        decide every row whose argmin margin clears ``BF16_TIE_RTOL`` of
        its distance scale; the flagged rows are relabeled by the model's
        own float32 predict in a bucket of their own.  Labels equal the
        float32 path's by construction.  Returns (labels, corrected); the
        caller owns the audit counter."""
        with obs_trace.span("dispatch", tag="serve/bf16-margin", rows=m):
            fn = self._fn(("assign-margin", chunk),
                          lambda: _cached(
                              dist.make_assign_margin_fn, self.mesh,
                              chunk_size=chunk, mode="matmul_bf16"))
            labels, margin, scale = fn(ds.points, cents)
            labels = np.array(self._host(ds, labels)[:m])
            margin = self._host(ds, margin)[:m]
            scale = self._host(ds, scale)[:m]
        near = np.flatnonzero(margin <= BF16_TIE_RTOL * scale)
        if near.size:
            note_dispatch("bf16-guard-fix")
            with obs_trace.span("dispatch", tag="serve/bf16-guard-fix",
                                rows=int(near.size)):
                sub_buf, n_sub, B_sub = self._stage(
                    rm, np.ascontiguousarray(buf[near]))
                sub_chunk = self._serve_chunk(rm, B_sub)
                sub_ds, release = self._place(sub_buf, sub_chunk)
                try:
                    exact = self._host(sub_ds, self._predict_fn(
                        sub_chunk, rm.model._mode())(sub_ds.points, cents))
                finally:
                    release()
                labels[near] = exact[:n_sub]
        return labels, int(near.size)

    def _assign_pq(self, rm: ResidentModel, buf: np.ndarray, m: int
                   ) -> Tuple[np.ndarray, int]:
        """The ``quantize='pq'`` predict route: ADC sums against the
        compressed table, near-ties re-resolved against the decoded table
        (``ProductQuantizer.adc_assign``)."""
        with obs_trace.span("dispatch", tag="serve/pq-adc", rows=m):
            labels, corrected = rm.pq.adc_assign(buf[:m], rm.pq_codes)
        return labels, int(corrected)

    def _assign_two_level(self, rm: ResidentModel, ds: Dataset,
                          m: int) -> np.ndarray:
        """The two-level predict route of an ``assign='two_level'`` model:
        its own coarse and member tables through
        ``make_two_level_predict_fn`` (the model's
        ``_predict_two_level_labels``)."""
        note_dispatch("serve/two-level")
        with obs_trace.span("dispatch", tag="serve/two-level", rows=m):
            return self._host(
                ds, rm.model._predict_two_level_labels(ds))[:m]

    def _dispatch_gmm(self, rm: ResidentModel, op: str,
                      rows: np.ndarray) -> np.ndarray:
        """Mixture ops ride the model's own posterior pass on its resident
        E-step tables: parity with ``GaussianMixture.predict`` is by
        construction."""
        buf, m, B = self._stage(rm, rows)
        t0 = time.perf_counter()
        with obs_trace.span("serve.request", model=rm.model_id, op=op,
                            rows=m, bucket=B):
            labels, logr, lse = rm.model._posterior(
                buf, (0, 1, 2), params=rm.table_dev())
        self._record(rm, B, m)
        self._observe_quality(rm, B, time.perf_counter() - t0, rows=m,
                              labels=labels[:m], score=-lse[:m])
        if op == "predict":
            return labels[:m]
        if op == "predict_proba":
            return np.exp(logr)[:m]
        return lse[:m]                      # 'score_samples'

    # ----------------------------------------------------- public calls

    def call(self, model_id, rows, *, op: str = "predict") -> np.ndarray:
        """Immediate (un-queued) dispatch of one request — the latency
        floor, the path for a strictly serial caller."""
        return self._dispatch(model_id, op,
                              self._validate(model_id, op, rows))

    def predict(self, model_id, rows) -> np.ndarray:
        """Immediate (un-queued) dispatch — the latency floor."""
        return self.call(model_id, rows)

    def submit(self, model_id, rows, *, op: str = "predict"
               ) -> ServingFuture:
        """Queue one request for micro-batching; returns a future whose
        ``result()`` is this request's own rows' slice."""
        return self.queue.submit(model_id, rows, op=op)

    def score(self, model_id, rows) -> float:
        """Model-family score of one request batch: K-Means negative SSE
        (float64 host sum of the rows' nearest squared distances); mixture
        mean per-sample log-likelihood."""
        rm = self._rm(model_id)
        if rm.spec["family"] == "gmm":
            lse = self._dispatch(model_id, "score_samples",
                                 self._validate(model_id,
                                                "score_samples", rows))
            return float(np.mean(lse))
        mind2 = self._dispatch(model_id, "score_rows",
                               self._validate(model_id, "score_rows",
                                              rows))
        return -float(np.sum(np.asarray(mind2, np.float64)))

    def predict_multi(self, requests: Sequence[Tuple[str, np.ndarray]]
                      ) -> List[np.ndarray]:
        """Routed mixed-model batch: one (model_id, rows) pair per
        request, results in request order.  Requests whose models share a
        pack group (same (k, D, dtype) K-Means family, no model axis) are
        served by ONE packed dispatch; the rest per model."""
        blocks = [self._validate(mid, "predict", rows)
                  for mid, rows in requests]
        _, model_shards = mesh_shape(self.mesh)
        groups: Dict[tuple, List[int]] = {}
        singles: List[int] = []
        for i, (mid, _) in enumerate(requests):
            key = self.registry.group_key(self._rm(mid).spec)
            if key is None or model_shards != 1:
                singles.append(i)
            else:
                groups.setdefault(key, []).append(i)
        out: List[Optional[np.ndarray]] = [None] * len(requests)
        for key, idxs in groups.items():
            ids = []
            for i in idxs:
                if requests[i][0] not in ids:
                    ids.append(requests[i][0])
            if len(ids) < 2:
                singles.extend(idxs)
                continue
            packed = self._dispatch_packed(
                ids, [(requests[i][0], blocks[i]) for i in idxs])
            for i, lab in zip(idxs, packed):
                out[i] = lab
        for i in singles:
            out[i] = self._dispatch(requests[i][0], "predict", blocks[i])
        return out

    def _pack_stack(self, ids: Tuple[str, ...]) -> torch.Tensor:
        """Device (M, k, D) centroid stack of a pack, cached and rebuilt
        when any member's ``centroids`` object changes.  Each member's
        ``centroids`` is read once: the stack is built from the objects it
        is keyed on."""
        rms = [self._rm(mid) for mid in ids]
        tokens = tuple(rm.model.centroids for rm in rms)
        with self._lock:
            cached = self._pack_cache.get(ids)
            if cached is not None and all(
                    a is b for a, b in zip(cached[0], tokens)):
                return cached[1]
        dtype = np.dtype(rms[0].spec["dtype"])
        stack = torch.from_numpy(np.stack([
            np.asarray(cents, dtype=dtype) for cents in tokens])).to(
                self.device)
        with self._lock:
            self._pack_cache[ids] = (tokens, stack)
        return stack

    def _dispatch_packed(self, ids: List[str],
                         items: List[Tuple[str, np.ndarray]]
                         ) -> List[np.ndarray]:
        """One batched-model dispatch over every item's rows; per-item
        label arrays in item order.  The pack serves at the members'
        float32-class mode: ``make_multi_predict_fn`` has no near-tie
        guard, and takes the matmul form of the kernel modes."""
        guard = self.dispatch_guard
        if guard is not None:
            guard(tuple(ids), "predict_multi")
        ids = tuple(ids)
        slot = {mid: j for j, mid in enumerate(ids)}
        rms = {mid: self._rm(mid) for mid in ids}
        rows = np.concatenate([b for _, b in items], axis=0)
        first = rms[ids[0]]
        buf, m, B = self._stage(first, rows)
        mode = first.model._mode()
        chunk = self._serve_chunk(first, B)
        t0 = time.perf_counter()
        with obs_trace.span("serve.request", op="predict_multi",
                            models=len(ids), rows=m, bucket=B):
            fn = self._fn(("multipredict", chunk, mode, len(ids)),
                          lambda: _cached(
                              dist.make_multi_predict_fn, self.mesh,
                              chunk_size=chunk, mode=mode,
                              n_models=len(ids)))
            stack = self._pack_stack(ids)
            ds, release = self._place(buf, chunk)
            try:
                labels_all = fn(ds.points, stack)
                labels_all = (np.stack([ds.gather_rows(lab)
                                        for lab in labels_all])
                              if isinstance(ds, ShardedDataset)
                              else labels_all.cpu().numpy())
            finally:
                release()
        # One physical dispatch: the global count and the bucket fill
        # record it once; each member's counters record its share.
        with self._lock:
            self.packed_dispatches += 1
            self.dispatches += 1
            fill = self._fill.setdefault(B, [0, 0])
            fill[0] += 1
            fill[1] += m
            for mid in ids:
                rms[mid].dispatches += 1
            for mid, block in items:
                rms[mid].requests += 1
                rms[mid].rows += block.shape[0]
        dt = time.perf_counter() - t0
        results = []
        off = 0
        for mid, block in items:
            mb = block.shape[0]
            results.append(labels_all[slot[mid], off: off + mb].copy())
            off += mb
        for (mid, block), lab in zip(items, results):
            self._observe_quality(rms[mid], B, dt, rows=block.shape[0],
                                  labels=lab)
            self._feed_learner(rms[mid], block)
        return results

    # ----------------------------------------------- bf16 verification

    def verify_quantized(self, model_id, rows) -> dict:
        """Hold the quantized path against the float32 path on a probe
        batch: ``{"labels_equal", "label_mismatches", "corrected_rows",
        "dist_max_rel"}`` (bf16: labels equal by construction, distances
        by their row-scale relative error; PQ: the mismatches MEASURE the
        quantization error)."""
        rm = self._rm(model_id)
        if rm.spec["family"] == "gmm":
            raise ValueError("verify_quantized applies to the K-Means "
                             "family bf16 assignment fast path")
        if mesh_shape(self.mesh)[1] != 1:
            raise ValueError(
                "verify_quantized requires a data-parallel mesh — the "
                "guarded bf16 assignment has no TP form (quantization "
                "is rejected under TP sharding)")
        block = self._validate(model_id, "predict", rows)
        buf, m, B = self._stage(rm, block)
        chunk = self._serve_chunk(rm, B)
        cents = rm.table_dev()
        f32_mode = rm.model._mode()

        def f32_labels():
            note_dispatch("verify-quantized/f32-oracle")
            with obs_trace.span("dispatch",
                                tag="verify-quantized/f32-oracle", rows=m):
                ds, release = self._place(buf, chunk)
                try:
                    return self._host(ds, self._predict_fn(
                        chunk, f32_mode)(ds.points, cents))[:m]
                finally:
                    release()

        if rm.quantize == "pq":
            return self._verify_pq(rm, buf, m, f32_labels())
        ds, release = self._place(buf, chunk)
        try:
            lab_q, corrected = self._assign_bf16_guarded(
                rm, buf, ds, cents, chunk, m)
        finally:
            release()
        lab_f = f32_labels()

        def _distances(tmode):
            tfn = self._fn(("transform", chunk, tmode),
                           lambda: _cached(
                               dist.make_transform_fn, self.mesh,
                               chunk_size=chunk, mode=tmode))
            note_dispatch("verify-quantized/transform")
            return tfn(torch.from_numpy(buf).to(self.device),
                       cents).cpu().numpy()[:m, :rm.spec["k"]]

        f64q = _distances("matmul_bf16").astype(np.float64)
        f64f = _distances("matmul").astype(np.float64)
        mism = int(np.sum(lab_q != lab_f))
        # bf16's error is relative to the |x||c| magnitude, so each row's
        # distances are compared at that row's scale (its largest).
        scale = np.maximum(np.max(np.abs(f64f), axis=1, keepdims=True),
                           np.finfo(np.float64).tiny)
        rel = np.abs(f64q - f64f) / scale
        return {"labels_equal": mism == 0,
                "label_mismatches": mism,
                "corrected_rows": corrected,
                "dist_max_rel": float(np.max(rel))}

    def _verify_pq(self, rm: ResidentModel, buf: np.ndarray, m: int,
                   lab_f: np.ndarray) -> dict:
        """``verify_quantized`` of a ``quantize='pq'`` resident: the ADC
        route against the float32 true-table labels, and the decoded-vs-
        true distance residual at the row scale."""
        lab_q, corrected = self._assign_pq(rm, buf, m)
        Q = np.asarray(buf[:m], np.float64)
        table = np.asarray(rm.model.centroids, np.float64)
        decoded = rm.pq.decode(rm.pq_codes)

        def _d2(tab):
            return (np.sum(Q ** 2, axis=1)[:, None] - 2.0 * Q @ tab.T
                    + np.sum(tab ** 2, axis=1)[None, :])

        df, dq = _d2(table), _d2(decoded)
        scale = np.maximum(np.max(np.abs(df), axis=1, keepdims=True),
                           np.finfo(np.float64).tiny)
        mism = int(np.sum(lab_q != lab_f))
        return {"labels_equal": mism == 0,
                "label_mismatches": mism,
                "corrected_rows": int(corrected),
                "dist_max_rel": float(np.max(np.abs(dq - df) / scale))}

    # ------------------------------------------------------------ stats

    def warmup(self, model_id=None, *, buckets=None) -> int:
        """Run the predict path once per bucket shape (the first dispatch
        builds the step functions, loads the kernel library and fills the
        staging buffers).  Returns the number of warm dispatches, which
        the stats leave out."""
        ids = [model_id] if model_id is not None else self.models()
        buckets = self.buckets if buckets is None else \
            check_buckets(buckets)
        n = 0
        self._tls.warming = True
        try:
            for mid in ids:
                rm = self._rm(mid)
                for B in buckets:
                    probe = np.zeros((B, rm.spec["d"]),
                                     np.dtype(rm.spec["dtype"]))
                    probe[:, 0] = 1.0       # finite, unit rows
                    self._dispatch(mid, "predict",
                                   self._validate(mid, "predict", probe))
                    n += 1
        finally:
            self._tls.warming = False
        return n

    def stats(self) -> dict:
        """Operator-facing snapshot: models resident, dispatch counts,
        batch-fill histogram, the queue's counters and the quality
        block."""
        with self._lock:
            fill = {
                int(b): {"dispatches": v[0], "rows": v[1],
                         "fill": round(v[1] / (v[0] * b), 4)
                         if v[0] else 0.0}
                for b, v in sorted(self._fill.items())}
            models = {
                mid: {"family": rm.spec["family"],
                      "model_class": rm.spec["model_class"],
                      "k": rm.spec["k"], "d": rm.spec["d"],
                      "dtype": rm.spec["dtype"],
                      "quantize": rm.quantize,
                      "requests": rm.requests, "rows": rm.rows,
                      "dispatches": rm.dispatches,
                      "table_bytes": rm.table_bytes,
                      "bf16_corrected_rows": rm.bf16_corrected_rows,
                      "pq_corrected_rows": rm.pq_corrected_rows}
                for mid, rm in sorted(self._residents.items())}
            stats = {
                "models_resident": len(models),
                "models": models,
                "resident_table_bytes": sum(
                    m["table_bytes"] for m in models.values()),
                "program_memory": self._program_memory(),
                "dispatches": self.dispatches,
                "packed_dispatches": self.packed_dispatches,
                "queue": self.queue.stats(),
                "batch_fill": fill,
                "buckets": list(self.buckets),
            }
        stats["quality"] = self.quality_status()
        if self._learn_cfg is not None:
            stats["learn"] = self.update_status()
        return stats

    def update_status(self) -> dict:
        """Per-model serve-and-learn snapshot (``ModelLearner.status``):
        armed state, budgets left, reservoir fill, the pending evaluation
        and the recent decisions; ``None`` for a model without a learner.
        Assembled outside the engine lock (each learner takes its own)."""
        return {mid: (rm.learner.status() if rm.learner is not None
                      else None)
                for mid, rm in sorted(self._residents.items())}

    def quality_status(self) -> dict:
        """Per-model drift-monitor snapshot; ``None`` entries mean
        monitoring is off."""
        return {mid: (rm.monitor.status() if rm.monitor is not None
                      else None)
                for mid, rm in sorted(self._residents.items())}

    #: The builders of the programs a dispatch runs: K-Means' assignment,
    #: margin, score and transform passes, and the mixture's posterior;
    #: and the step caches that keep them (a cost record is named by its
    #: cache, its key starts with the builder's name).
    _SERVING_BUILDERS = ("make_predict_fn", "make_assign_margin_fn",
                         "make_score_rows_fn", "make_multi_predict_fn",
                         "make_transform_fn", "make_two_level_predict_fn",
                         "make_gmm_predict_fn")
    _SERVING_CACHES = ("kmeans._STEP_CACHE", "gmm._STEP_CACHE")

    @classmethod
    def _serving_record(cls, rec) -> bool:
        """Whether a cost record is of a serving program."""
        return rec.cache in cls._SERVING_CACHES and any(
            rec.key.startswith(f"('{b}',") for b in cls._SERVING_BUILDERS)

    def _program_memory(self) -> List[dict]:
        """What the engine holds per bucket shape, under the JAX package's
        keys: one row per staging buffer set (``cache='serving.staging'``,
        ``key`` (rows, D, dtype), its pinned host, device and weight bytes
        in ``peak_bytes``, the device bytes in ``arg_bytes``).  Under a
        cost collector (``obs.cost.collecting``), one row per record of a
        serving program (:meth:`_serving_record`): run ``warmup()``
        inside the scope so that the bucket programs are built and
        measured there, as in the reference.  Without one, one row per
        built step function (``cache='serving.step_fns'``, its key, the
        byte fields None and ``available`` False: nothing measured
        it)."""
        from kmeans_tpu_torch.obs import cost as obs_cost
        rows = [{"cache": "serving.staging", "key": key, "role": "staging",
                 "peak_bytes": st.nbytes,
                 "arg_bytes": int(st.dev.nbytes + st.weights.nbytes),
                 "temp_bytes": None, "code_bytes": None, "available": True}
                for key, st in sorted(self._staging.items())]
        col = obs_cost.get_collector()
        if col is not None:
            return rows + [
                {"cache": r.cache, "key": r.key, "role": r.role,
                 "peak_bytes": r.peak_bytes, "arg_bytes": r.arg_bytes,
                 "temp_bytes": r.temp_bytes, "code_bytes": r.code_bytes,
                 "available": r.available}
                for r in col.records() if self._serving_record(r)]
        rows += [{"cache": "serving.step_fns", "key": key,
                  "role": key[0], "peak_bytes": None, "arg_bytes": None,
                  "temp_bytes": None, "code_bytes": None,
                  "available": False}
                 for key in sorted(self._fns, key=repr)]
        return rows

    # -------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Join the learners (an update in flight finishes first), drain
        the queue, join its worker, close the drift-monitor sinks
        (idempotent)."""
        for rm in list(self._residents.values()):
            if rm.learner is not None:
                rm.learner.close(join=True)
        self.queue.close()
        for rm in self._residents.values():
            if rm.monitor is not None:
                rm.monitor.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
