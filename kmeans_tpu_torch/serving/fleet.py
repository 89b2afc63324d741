"""A serving fleet: replicated engines behind an SLO-aware router.

Counterpart of the JAX package's ``serving/fleet.py``.  One
:class:`~kmeans_tpu_torch.serving.engine.ServingEngine` is one replica;
:class:`ServingFleet` puts N of them behind a router:

* **Replicated engines.**  N engines in one process on one device (the
  card unless the caller asks for the CPU).  Replicas share the fitted
  model OBJECTS, so the device table cache (``KMeans._cents_dev``) is
  shared: replication costs bookkeeping, not placements, and fleet labels
  are bit-equal to a single engine's by construction.
* **SLO-aware routing.**  Per-(replica, model, bucket) latency histograms
  in the metrics registry (``fleet.latency_ms.<replica>.<model>.b<bucket>``)
  take every routed request's latency on the fleet's clock; once every
  candidate has :data:`MIN_ROUTE_SAMPLES` of them a request goes to the
  LEAST EXPECTED LATENCY, ``(inflight + 1) * p50``.  While any candidate
  is cold, a deterministic power-of-two-choices rule: two candidates off a
  rotating counter, fewer in flight wins, ties to the lower index.
* **Admission control.**  With ``slo_p99_ms`` a request sheds when every
  candidate's expected completion ``(inflight + 1) * p99`` breaches the
  bound (cold candidates admit: no shed without evidence), and with
  ``max_inflight`` when every candidate is at the limit.  A shed is
  explicit: :class:`FleetOverloadError`, and the ``fleet.shed`` /
  ``fleet.shed.<model>`` counters.
* **Pack-group placement.**  Under ``replication < n_replicas`` a model
  lands on the least-loaded replicas, except that a member of a pack group
  (same (k, D, dtype)) joins its group's replicas, so ``predict_multi``
  stays one packed dispatch.
* **Replica lifecycle.**  A replica takes traffic only in state
  ``'serving'``, reached through ``warmup()`` (its bucket shapes run once
  first).  Each replica appends heartbeats (``hb.<replica>.jsonl``) to the
  fleet directory, which ``obs.fleet.straggler_report`` reads;
  :meth:`ServingFleet.reap` declares dead a replica that holds work in
  flight and has completed no dispatch within the stall window.  A dead
  replica's queued requests fail through its engine's ``dispatch_guard``
  and the queue's per-request isolation, and the router re-dispatches
  each on a surviving replica (``fleet.redispatch``).

Every replica dispatches on the fleet's device through the engine's own
paths: kernel 2 (2b under ``quantize='bf16'``'s float32 fix-ups and a
'kernel_bf16' model) once per dispatch on the card.

Multi-rank meshes: a mesh of the port is one process per rank, every rank
running the same collectives; a router choosing by latencies measured in
its own process would send the ranks' requests to different replicas, so
``ServingFleet`` on a mesh of more than one rank raises
``NotImplementedError`` (ROADMAP.md, A.21) before any collective runs.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kmeans_tpu_torch.models.kmeans import resolve_device
from kmeans_tpu_torch.obs import metrics_registry as obs_metrics
from kmeans_tpu_torch.parallel.mesh import check_mesh
from kmeans_tpu_torch.serving.batching import (DEFAULT_BUCKETS, ServingFuture,
                                               bucket_for, check_buckets)
from kmeans_tpu_torch.serving.engine import ServingEngine, refuse_multi_rank
from kmeans_tpu_torch.serving.registry import ModelRegistry, load_fitted

__all__ = ["ServingFleet", "FleetFuture", "FleetOverloadError",
           "ReplicaDeadError", "MIN_ROUTE_SAMPLES", "DEAD_AFTER_FACTOR",
           "DEAD_MIN_S"]

#: Histogram observations before a (replica, model, bucket) latency
#: estimate is trusted for least-expected-latency routing; below it the
#: router takes the power-of-two-choices rule.
MIN_ROUTE_SAMPLES = 8

#: Routed requests between percentile refreshes per (replica, model,
#: bucket): ``Histogram.percentile`` sorts its reservoir, and the queue
#: term ``(inflight + 1)`` carries the fast signal anyway.
ROUTE_REFRESH = 32

#: A replica holding work in flight with no completed dispatch for
#: ``DEAD_AFTER_FACTOR`` heartbeat intervals (at least ``DEAD_MIN_S``
#: seconds) is dead for :meth:`ServingFleet.reap`.
DEAD_AFTER_FACTOR = 3.0
DEAD_MIN_S = 1.0


class FleetOverloadError(RuntimeError):
    """The explicit shed: the committed p99 bound (or the in-flight
    limit) would be breached on every candidate replica, so the request is
    refused up front.  Counted (``fleet.shed``, ``fleet.shed.<model>``)."""


class ReplicaDeadError(RuntimeError):
    """A dispatch refused because its replica is dead (killed, or reaped
    on a heartbeat stall).  Raised by the engine's ``dispatch_guard``; the
    router catches it and re-dispatches on a surviving replica."""


class _Replica:
    """One replica: the engine and the router's state of it (liveness,
    requests in flight, heartbeat sink)."""

    def __init__(self, name: str, index: int, engine: ServingEngine,
                 hb_path: Optional[str], hb_interval_s: float):
        self.name = name
        self.index = index
        self.engine = engine
        self.state = "warming"            # 'warming' | 'serving' | 'dead'
        self.killed = False
        self.inflight = 0
        self.models: set = set()
        self.prewarm_s: Optional[float] = None
        # utils.faults.inject_replica_kill's hook: called with (replica,
        # model_id, op) before the killed check.
        self.fault_hook = None
        # Fleet-clock time of the last COMPLETED dispatch (reap's signal).
        self.last_beat: Optional[float] = None
        self._hb_path = hb_path
        self._hb_interval = float(hb_interval_s)
        self._hb_wall_last: Optional[float] = None
        self._hb_rows = 0
        engine.dispatch_guard = self._guard

    def _guard(self, model_id, op: str) -> None:
        """The engine's pre-dispatch hook: the fault hook, then liveness.
        A killed replica refuses every dispatch (direct, queued, packed),
        so its queued requests fail through the queue's per-request
        isolation and the router re-dispatches them."""
        hook = self.fault_hook
        if hook is not None:
            hook(self, model_id, op)
        if self.killed:
            raise ReplicaDeadError(
                f"replica {self.name!r} is dead (dispatch refused)")

    def beat(self, *, rows: int = 0, force: bool = False) -> None:
        """Append one heartbeat (``ts``, identity and progress) to this
        replica's sink, at most one per heartbeat interval.  ``iteration``
        carries the engine's dispatch count and ``rows_per_sec`` the recent
        serving rate."""
        self._hb_rows += rows
        if self._hb_path is None:
            return
        now = time.time()
        if not force and self._hb_wall_last is not None \
                and now - self._hb_wall_last < self._hb_interval:
            return
        rate = None
        if self._hb_wall_last is not None and now > self._hb_wall_last:
            rate = self._hb_rows / (now - self._hb_wall_last)
        rec = {"ts": now, "phase": "serving",
               "iteration": int(self.engine.dispatches),
               "rows_per_sec": rate, "process_index": self.index,
               "host": self.name, "replica": self.name,
               "state": self.state, "inflight": int(self.inflight)}
        try:
            with open(self._hb_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            # Telemetry never fails serving; the sink goes stale and the
            # straggler report shows its age.
            pass
        self._hb_wall_last = now
        self._hb_rows = 0


class FleetFuture:
    """Completion handle of one routed queued request.  ``result()`` is
    the request's own rows' slice; when its replica died with it in
    flight, the request is re-dispatched on a surviving replica, so the
    caller sees a result, never the dead replica."""

    def __init__(self, fleet: "ServingFleet", rep: _Replica,
                 inner: ServingFuture, model_id, rows, op: str,
                 t0: float):
        self._fleet = fleet
        self._rep = rep
        self._inner = inner
        self._model_id = model_id
        self._rows = rows
        self._op = op
        self._t0 = t0
        self._settled = False

    def done(self) -> bool:
        return self._inner.done()

    def result(self, timeout: Optional[float] = None):
        while True:
            try:
                out = self._inner.result(timeout)
            except ReplicaDeadError:
                self._fleet._fail_over(self._rep)
                rep, inner = self._fleet._resubmit(
                    self._model_id, self._rows, self._op)
                self._rep, self._inner = rep, inner
                continue
            except Exception:
                self._settle(error=True)
                raise
            self._settle()
            return out

    def exception(self, timeout: Optional[float] = None):
        try:
            self.result(timeout)
            return None
        except TimeoutError:
            raise
        except Exception as e:              # noqa: BLE001 — as
            return e                        # ServingFuture.exception

    def _settle(self, error: bool = False) -> None:
        """Release the in-flight slot and, on success, feed the routing
        histogram, once however often ``result()`` is called."""
        if self._settled:
            return
        self._settled = True
        self._fleet._complete(self._rep, self._model_id,
                              self._rows, self._t0, error=error)


class ServingFleet:
    """N :class:`ServingEngine` replicas behind an SLO-aware router.

    Parameters
    ----------
    n_replicas : the first replica count (``add_replica``,
        ``kill_replica``, ``remove_replica`` change it later).
    device : as in the engine: ``None`` is the card (and raises where
        there is none); ``device='cpu'`` runs the kernels' plain versions.
    mesh : None, or a mesh of one rank (more raise, ROADMAP.md, A.21).
    buckets, max_wait_ms, clock, start, quality, quality_window :
        forwarded to every replica engine.  ``clock`` also times the
        router's latency observations and drives :meth:`reap`.
    fleet_dir : directory of the replicas' sinks: quality JSONL
        (``quality.<model>.<replica>.jsonl``) and heartbeats
        (``hb.<replica>.jsonl``).  None keeps them in memory.
    slo_p99_ms : committed p99 bound (ms); None turns admission by
        latency off.
    max_inflight : per-replica limit of requests in flight; a request
        sheds when every candidate is at it.  None is unbounded.
    replication : copies of each model (least-loaded placement, pack
        groups co-resident).  None places every model on every replica.
    heartbeat_interval_s : least seconds between heartbeats, and the base
        of :meth:`reap`'s stall window.
    learn : False | True | dict, forwarded to every replica engine.
        Replicas share the model objects, so their learners serialize
        updates on the model's lock (``serving.learn._model_update_lock``)
        and every replica serves a published table at once; snapshots are
        per replica (``learn.<model>.<replica>.npz``).
    """

    def __init__(self, n_replicas: int = 2, *, device=None, mesh=None,
                 buckets=DEFAULT_BUCKETS, max_wait_ms: float = 2.0,
                 clock=None, start: bool = True, quality="auto",
                 quality_window: Optional[int] = None,
                 fleet_dir=None, slo_p99_ms: Optional[float] = None,
                 max_inflight: Optional[int] = None,
                 replication: Optional[int] = None,
                 heartbeat_interval_s: float = 0.5,
                 learn=False):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if replication is not None and replication < 1:
            raise ValueError(f"replication must be >= 1, "
                             f"got {replication}")
        self.device = resolve_device(device)
        self.mesh = check_mesh(mesh)
        refuse_multi_rank(self.mesh, "ServingFleet")
        self.buckets = check_buckets(buckets)
        self._max_wait_ms = float(max_wait_ms)
        self._clock = clock if clock is not None else time.monotonic
        self._user_clock = clock
        self._start = bool(start)
        self._quality = quality
        self._quality_window = quality_window
        self._fleet_dir = str(fleet_dir) if fleet_dir is not None else None
        if self._fleet_dir is not None:
            os.makedirs(self._fleet_dir, exist_ok=True)
        self.slo_p99_ms = float(slo_p99_ms) if slo_p99_ms is not None \
            else None
        self.max_inflight = int(max_inflight) if max_inflight is not None \
            else None
        self._replication = int(replication) if replication is not None \
            else None
        self._hb_interval = float(heartbeat_interval_s)
        self._learn = learn
        self.registry = ModelRegistry()     # the fleet's placement view
        self._quantize: Dict[str, Optional[str]] = {}
        self._profiles: Dict[str, Optional[dict]] = {}
        self._placement: Dict[str, List[int]] = {}
        self._group_homes: Dict[tuple, List[int]] = {}
        self._replicas: List[_Replica] = []
        self._hists: Dict[tuple, object] = {}
        self._est: Dict[tuple, tuple] = {}
        self._lock = threading.Lock()
        self._rr = 0                        # power-of-two rotation
        self._next_index = 0
        self.routes = 0
        self.sheds = 0
        self.redispatches = 0
        self._closed = False
        for _ in range(int(n_replicas)):
            self._spawn()

    # -------------------------------------------------------- replicas

    def _spawn(self) -> _Replica:
        i = self._next_index
        self._next_index += 1
        name = f"r{i}"
        eng = ServingEngine(
            device=self.device, mesh=self.mesh, buckets=self.buckets,
            max_wait_ms=self._max_wait_ms, clock=self._user_clock,
            start=self._start, quality=self._quality,
            quality_dir=self._fleet_dir,
            quality_window=self._quality_window, quality_tag=name,
            learn=self._learn)
        hb = os.path.join(self._fleet_dir, f"hb.{name}.jsonl") \
            if self._fleet_dir is not None else None
        rep = _Replica(name, i, eng, hb, self._hb_interval)
        self._replicas.append(rep)
        return rep

    def _replica(self, name) -> _Replica:
        for rep in self._replicas:
            if rep.name == name:
                return rep
        raise KeyError(f"no replica {name!r}; fleet: "
                       f"{[r.name for r in self._replicas]}")

    def replicas(self) -> List[str]:
        return [r.name for r in self._replicas]

    def add_replica(self, *, prewarm: bool = True) -> str:
        """Grow the fleet by one replica.  Models placed everywhere land on
        it at once; under ``replication`` it joins the pool for later
        models.  With ``prewarm`` it runs every bucket shape BEFORE it
        enters ``'serving'``; ``prewarm_s`` (stats) is the cost."""
        rep = self._spawn()
        if self._replication is None:
            for mid in self.registry.ids():
                rep.engine.add_model(mid, self.registry.get(mid),
                                     quantize=self._quantize[mid],
                                     profile=self._profiles[mid])
                rep.models.add(mid)
                self._placement[mid].append(rep.index)
        t0 = time.perf_counter()
        self._warm_replica(rep, prewarm=prewarm)
        rep.prewarm_s = time.perf_counter() - t0
        return rep.name

    def kill_replica(self, name) -> None:
        """Kill a replica: it refuses every further dispatch through its
        engine's guard, so its queued requests fail over to survivors;
        routing skips it at once."""
        rep = self._replica(name)
        rep.killed = True
        rep.state = "dead"

    def remove_replica(self, name) -> None:
        """Shrink gracefully: stop routing to the replica, drain its queue
        (pending requests complete) and drop it from the placement."""
        rep = self._replica(name)
        rep.state = "dead"
        rep.engine.close()
        for mid in list(rep.models):
            idxs = self._placement.get(mid, [])
            if rep.index in idxs:
                idxs.remove(rep.index)
        for key, homes in list(self._group_homes.items()):
            if rep.index in homes:
                homes.remove(rep.index)

    def _fail_over(self, rep: _Replica) -> None:
        """Mark a replica dead after a ReplicaDeadError came from it, and
        count the re-dispatch that follows."""
        rep.killed = True
        rep.state = "dead"
        with self._lock:
            self.redispatches += 1
        obs_metrics.REGISTRY.counter("fleet.redispatch").inc()

    def reap(self, now: Optional[float] = None) -> List[str]:
        """Declare dead every serving replica that HOLDS work in flight
        and has completed no dispatch within the stall window
        (``DEAD_AFTER_FACTOR`` heartbeat intervals, at least
        ``DEAD_MIN_S``).  An idle replica never reaps.  Returns the names
        newly dead; their queued requests fail over when collected."""
        now = self._clock() if now is None else now
        window = max(DEAD_AFTER_FACTOR * self._hb_interval, DEAD_MIN_S)
        newly: List[str] = []
        for rep in self._replicas:
            if rep.state != "serving" or rep.inflight <= 0:
                continue
            if rep.last_beat is not None \
                    and now - rep.last_beat > window:
                rep.killed = True
                rep.state = "dead"
                newly.append(rep.name)
        return newly

    # ------------------------------------------------------- residency

    def add_model(self, model_id: str, model, *,
                  quantize: Optional[str] = None,
                  profile: Optional[dict] = None) -> List[str]:
        """Make a fitted model resident across the fleet; returns the
        replicas it was placed on."""
        spec = self.registry.register(model_id, model)
        idxs = self._place(spec)
        placed: List[int] = []
        try:
            for i in idxs:
                rep = self._replicas[i]
                rep.engine.add_model(model_id, model, quantize=quantize,
                                     profile=profile)
                rep.models.add(model_id)
                placed.append(i)
        except Exception:
            for i in placed:
                self._replicas[i].engine.remove(model_id)
                self._replicas[i].models.discard(model_id)
            self.registry.remove(model_id)
            raise
        self._placement[model_id] = list(idxs)
        self._quantize[model_id] = quantize
        self._profiles[model_id] = profile
        key = ModelRegistry.group_key(spec)
        if key is not None and key not in self._group_homes:
            self._group_homes[key] = list(idxs)
        return [self._replicas[i].name for i in idxs]

    def load(self, path, model_id: Optional[str] = None, *,
             quantize: Optional[str] = None) -> str:
        """Load a checkpoint once onto the fleet's device and place it
        (every replica shares the one model object)."""
        model = load_fitted(path, device=self.device, mesh=self.mesh)
        if model_id is None:
            from pathlib import Path
            stem = Path(str(path)).stem
            model_id, i = stem, 1
            while model_id in self.registry:
                i += 1
                model_id = f"{stem}-{i}"
        self.add_model(model_id, model, quantize=quantize)
        return model_id

    def models(self) -> List[str]:
        return self.registry.ids()

    def _place(self, spec: dict) -> List[int]:
        """Home replicas of a new model: its pack group's when it has one,
        else the ``replication`` least-loaded live replicas (ties to the
        lower index)."""
        live = [r for r in self._replicas if r.state != "dead"]
        if not live:
            raise RuntimeError("fleet has no live replicas")
        key = ModelRegistry.group_key(spec)
        if key is not None:
            homes = [i for i in self._group_homes.get(key, [])
                     if self._replicas[i].state != "dead"]
            if homes:
                return sorted(homes)
        r = len(live) if self._replication is None \
            else min(self._replication, len(live))
        order = sorted(live, key=lambda rep: (len(rep.models), rep.index))
        return sorted(rep.index for rep in order[:r])

    # ---------------------------------------------------------- warmup

    def warmup(self, *, prewarm: bool = True) -> int:
        """Run every replica's bucket shapes once and open the fleet
        (replicas move from ``'warming'`` to ``'serving'``; routing only
        considers serving replicas).  ``prewarm=False`` opens without the
        probes.  Returns the warm dispatches run."""
        n = 0
        for rep in self._replicas:
            if rep.state == "warming":
                n += self._warm_replica(rep, prewarm=prewarm)
        return n

    def _warm_replica(self, rep: _Replica, *, prewarm: bool = True) -> int:
        n = rep.engine.warmup() if prewarm and rep.models else 0
        rep.state = "serving"
        rep.last_beat = self._clock()
        rep.beat(force=True)                # its sink shows it live
        return n

    # ---------------------------------------------------------- routing

    def _hist(self, rep: _Replica, model_id, bucket: int):
        key = (rep.name, model_id, bucket)
        h = self._hists.get(key)
        if h is None:
            h = obs_metrics.REGISTRY.histogram(
                f"fleet.latency_ms.{rep.name}.{model_id}.b{bucket}")
            self._hists[key] = h
        return h

    def _estimates(self, rep: _Replica, model_id, bucket: int
                   ) -> Tuple[Optional[float], Optional[float]]:
        """(p50, p99) for routing, ``(None, None)`` while the histogram is
        cold; refreshed every ``ROUTE_REFRESH`` observations."""
        h = self._hist(rep, model_id, bucket)
        n = h.count
        if n < MIN_ROUTE_SAMPLES:
            return None, None
        key = (rep.name, model_id, bucket)
        cached = self._est.get(key)
        if cached is not None and n - cached[0] < ROUTE_REFRESH:
            return cached[1], cached[2]
        p50, p99 = h.percentile(0.50), h.percentile(0.99)
        self._est[key] = (n, p50, p99)
        return p50, p99

    def _candidates(self, model_id) -> List[_Replica]:
        idxs = self._placement.get(model_id)
        if idxs is None:
            raise KeyError(
                f"no resident model {model_id!r}; resident: "
                f"{self.models()}")
        cands = [self._replicas[i] for i in idxs
                 if self._replicas[i].state == "serving"]
        if not cands:
            states = {self._replicas[i].name: self._replicas[i].state
                      for i in idxs}
            raise ReplicaDeadError(
                f"no serving replica hosts model {model_id!r} "
                f"(placement: {states}; did you call warmup()?)")
        return cands

    def _route(self, model_id, m: int) -> _Replica:
        """The replica for an m-row request, after admission control:
        least expected latency on warm histograms, power-of-two choices
        while any is cold.  A shed raises :class:`FleetOverloadError`."""
        bucket = bucket_for(m, self.buckets)
        cands = self._candidates(model_id)
        ests = [(rep,) + self._estimates(rep, model_id, bucket)
                for rep in cands]
        if self.max_inflight is not None and all(
                rep.inflight >= self.max_inflight for rep in cands):
            self._record_shed(model_id)
            raise FleetOverloadError(
                f"all {len(cands)} replicas at max_inflight="
                f"{self.max_inflight} for model {model_id!r} — request "
                f"shed (explicit, counted in fleet.shed)")
        if self.slo_p99_ms is not None:
            known = [(rep, p99) for rep, _, p99 in ests
                     if p99 is not None]
            if known and len(known) == len(ests) and all(
                    (rep.inflight + 1) * p99 > self.slo_p99_ms
                    for rep, p99 in known):
                self._record_shed(model_id)
                raise FleetOverloadError(
                    f"expected completion exceeds the committed p99 "
                    f"bound {self.slo_p99_ms} ms on every replica for "
                    f"model {model_id!r} — request shed (explicit, "
                    f"counted in fleet.shed)")
        if all(p99 is not None for _, _, p99 in ests):
            best, best_exp = None, None
            for rep, p50, _ in ests:
                exp = (rep.inflight + 1) * (p50 or 0.0)
                if best_exp is None or exp < best_exp:
                    best, best_exp = rep, exp
            return best
        return self._two_choices(cands)

    def _two_choices(self, cands: List[_Replica]) -> _Replica:
        """Deterministic power-of-two choices: two candidates off the
        rotating counter, fewer in flight wins (ties to the first)."""
        with self._lock:
            c = self._rr
            self._rr += 1
        a = cands[c % len(cands)]
        b = cands[(c + 1) % len(cands)]
        return b if b.inflight < a.inflight else a

    def _record_route(self, replica_name: str, model_id,
                      n: int = 1) -> None:
        """The registry's record of forwarded traffic (every forward
        site calls it)."""
        with self._lock:
            self.routes += n
        reg = obs_metrics.REGISTRY
        reg.counter("fleet.route").inc(n)
        reg.counter(f"fleet.route.{replica_name}").inc(n)

    def _record_shed(self, model_id) -> None:
        """The registry's record of a shed (explicit, counted)."""
        with self._lock:
            self.sheds += 1
        reg = obs_metrics.REGISTRY
        reg.counter("fleet.shed").inc()
        reg.counter(f"fleet.shed.{model_id}").inc()

    def _complete(self, rep: _Replica, model_id, rows, t0: float,
                  error: bool = False) -> None:
        """Release one in-flight slot; on success feed the routing
        histogram and the replica's heartbeat."""
        dt_ms = (self._clock() - t0) * 1e3
        with self._lock:
            rep.inflight = max(0, rep.inflight - 1)
        if error:
            return
        m = _rows_of(rows)
        self._hist(rep, model_id, bucket_for(m, self.buckets)) \
            .observe(dt_ms)
        rep.last_beat = self._clock()
        rep.beat(rows=m)

    # ----------------------------------------------------- public calls

    def call(self, model_id, rows, *, op: str = "predict") -> np.ndarray:
        """Routed immediate dispatch; fails over to a surviving replica
        when the target dies during the request."""
        rows = np.asarray(rows)
        m = _rows_of(rows)
        while True:
            rep = self._route(model_id, m)
            try:
                return self._forward(rep, model_id, rows, op)
            except ReplicaDeadError:
                self._fail_over(rep)

    def predict(self, model_id, rows) -> np.ndarray:
        return self.call(model_id, rows)

    def score(self, model_id, rows) -> float:
        rows = np.asarray(rows)
        m = _rows_of(rows)
        while True:
            rep = self._route(model_id, m)
            self._record_route(rep.name, model_id)
            t0 = self._clock()
            with self._lock:
                rep.inflight += 1
            try:
                out = rep.engine.score(model_id, rows)
            except ReplicaDeadError:
                self._complete(rep, model_id, rows, t0, error=True)
                self._fail_over(rep)
                continue
            except Exception:
                self._complete(rep, model_id, rows, t0, error=True)
                raise
            self._complete(rep, model_id, rows, t0)
            return out

    def _forward(self, rep: _Replica, model_id, rows,
                 op: str) -> np.ndarray:
        """Forward one request to a replica engine, keeping the in-flight
        count and the latency histogram."""
        self._record_route(rep.name, model_id)
        t0 = self._clock()
        with self._lock:
            rep.inflight += 1
        try:
            out = rep.engine.call(model_id, rows, op=op)
        except Exception:
            self._complete(rep, model_id, rows, t0, error=True)
            raise
        self._complete(rep, model_id, rows, t0)
        return out

    def submit(self, model_id, rows, *, op: str = "predict"
               ) -> FleetFuture:
        """Route one request into a replica's micro-batch queue; the
        :class:`FleetFuture` re-dispatches on replica death.  A shed
        raises here, at submit time."""
        rows = np.asarray(rows)
        rep = self._route(model_id, _rows_of(rows))
        inner = self._submit_once(rep, model_id, rows, op)
        return FleetFuture(self, rep, inner, model_id, rows, op,
                           self._clock())

    def _submit_once(self, rep: _Replica, model_id, rows,
                     op: str) -> ServingFuture:
        self._record_route(rep.name, model_id)
        with self._lock:
            rep.inflight += 1
        return rep.engine.submit(model_id, rows, op=op)

    def _resubmit(self, model_id, rows, op: str
                  ) -> Tuple[_Replica, ServingFuture]:
        """Re-dispatch a request whose replica died with it in flight."""
        rep = self._route(model_id, _rows_of(rows))
        return rep, self._submit_once(rep, model_id, rows, op)

    def predict_multi(self, requests: Sequence[Tuple[str, np.ndarray]]
                      ) -> List[np.ndarray]:
        """Routed mixed-model batch, forwarded WHOLE to one replica that
        hosts every model asked for (pack-group co-residency makes that
        the common case, so it stays one packed dispatch); requests whose
        models share no replica are routed one by one."""
        if not requests:
            return []
        mids = {mid for mid, _ in requests}
        for mid in mids:
            if mid not in self._placement:
                raise KeyError(
                    f"no resident model {mid!r}; resident: "
                    f"{self.models()}")
        cands = [rep for rep in self._replicas
                 if rep.state == "serving" and mids <= rep.models]
        m = sum(int(np.asarray(rows).shape[0]) for _, rows in requests)
        first = next(iter(mids))
        while cands:
            rep = self._two_choices(cands)
            self._record_route(rep.name, first, n=len(requests))
            t0 = self._clock()
            with self._lock:
                rep.inflight += 1
            try:
                out = rep.engine.predict_multi(requests)
            except ReplicaDeadError:
                self._complete(rep, first, m, t0, error=True)
                self._fail_over(rep)
                cands = [r for r in cands if r is not rep]
                continue
            except Exception:
                self._complete(rep, first, m, t0, error=True)
                raise
            self._complete(rep, first, m, t0)
            return out
        return [self.call(mid, rows) for mid, rows in requests]

    # ------------------------------------------------------------ stats

    def stats(self) -> dict:
        """Operator snapshot: router counters, each replica's liveness,
        load and engine counters, placement and pack groups.
        ``dispatches`` is the fleet's total."""
        with self._lock:
            routes, sheds, redispatches = \
                self.routes, self.sheds, self.redispatches
        replicas = {}
        models: Dict[str, dict] = {}
        for rep in self._replicas:
            st = rep.engine.stats()
            replicas[rep.name] = {
                "state": rep.state, "inflight": int(rep.inflight),
                "models": sorted(rep.models),
                "dispatches": st["dispatches"],
                "packed_dispatches": st["packed_dispatches"],
                "queue": st["queue"],
                "prewarm_s": rep.prewarm_s,
            }
            for mid, m in st["models"].items():
                agg = models.setdefault(mid, {
                    "requests": 0, "rows": 0, "dispatches": 0,
                    "replicas": []})
                agg["requests"] += m["requests"]
                agg["rows"] += m["rows"]
                agg["dispatches"] += m["dispatches"]
                agg["replicas"].append(rep.name)
        return {
            "replicas": replicas,
            "n_replicas": len(self._replicas),
            "n_serving": sum(1 for r in self._replicas
                             if r.state == "serving"),
            "models": models,
            "placement": {mid: [self._replicas[i].name for i in idxs]
                          for mid, idxs in sorted(self._placement.items())},
            "pack_groups": {
                "/".join(map(str, key)): ids
                for key, ids in self.registry.pack_groups().items()},
            "routes": routes, "sheds": sheds,
            "redispatches": redispatches,
            "slo_p99_ms": self.slo_p99_ms,
            "max_inflight": self.max_inflight,
            "dispatches": sum(r["dispatches"] for r in replicas.values()),
            "buckets": list(self.buckets),
        }

    def quality_status(self) -> dict:
        """``{model_id: {replica: drift status or None}}``."""
        out: Dict[str, dict] = {}
        for rep in self._replicas:
            for mid, st in rep.engine.quality_status().items():
                out.setdefault(mid, {})[rep.name] = st
        return out

    def update_status(self) -> dict:
        """``{model_id: {replica: learner status or None}}``."""
        out: Dict[str, dict] = {}
        for rep in self._replicas:
            for mid, st in rep.engine.update_status().items():
                out.setdefault(mid, {})[rep.name] = st
        return out

    # -------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Drain and close every replica engine (idempotent)."""
        if self._closed:
            return
        self._closed = True
        for rep in self._replicas:
            rep.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _rows_of(rows) -> int:
    """Rows of a request: its first axis, 1 for a single row."""
    return int(np.asarray(rows).shape[0]) if np.ndim(rows) > 1 else 1
