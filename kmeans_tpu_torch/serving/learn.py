"""Serve-and-learn: in-place online updates of a served ``MiniBatchKMeans``,
published by one atomic swap, snapshotted first and rolled back on
regression.

Counterpart of the JAX package's ``serving/learn.py``.  The model's drift
monitor (``obs.drift.QualityMonitor``) is the trigger; this module is the
actuator.  A resident mini-batch model updates in place from sampled live
traffic when its monitor fires (Sculley's updates, ``partial_fit``), under
three safety layers:

* **A reservoir fed by what a dispatch already has.**  A bounded FIFO of
  the rows that serving dispatches materialized anyway (warm-up probes are
  left out by the engine).  Draining it gives ``partial_fit`` batches of
  exactly :data:`UPDATE_BATCH_ROWS` rows, never padded: padding rows would
  enter the per-centre statistics as real mass.
* **Clone, update, swap.**  The update runs ``partial_fit`` on a detached
  clone (``MiniBatchKMeans._learn_clone``) on the learner's thread, off
  the dispatch path: a failed update dies with the clone, and the served
  model stays bit-identical on its last good table.  Publication is one
  atomic swap (:func:`publish_tables`): the new table is placed on the
  device and the model's ``_cents_cache`` seeded BEFORE ``centroids`` is
  rebound.  ``KMeans._cents_dev`` reads ``centroids`` once, so a
  concurrent reader serves the old table or the new one, never a mix.
* **Snapshot and rollback.**  Every update first writes the model's state
  through ``utils.checkpoint.save_state_rotating``; when the windows after
  the update regress past :data:`REGRESSION_RATIO`, the learner restores
  that state (``load_state_with_fallback``) through the same swap and
  records an :class:`UpdateRolledBack`.  Budgets and cooldown are the
  committed constants below.

Every decision is recorded three ways: a ``serve.learn`` tracer event, a
``serve.learn.*`` registry counter, and a ``kind: update | rollback`` line
through ``QualityMonitor.record`` (aggregated by
``obs.drift.quality_report``).

On the card the update's pass is kernel 1 (``partial_fit`` in the kernel
modes), launched from the learner's thread on the same (default) stream
as the serving dispatches; :func:`publish_tables` waits for the new
table's copy before the rebind.

The invariant the tests hold: a QUIESCED model equals, bit for bit, the
same ``partial_fit`` batches replayed offline from the pre-update
snapshot (the float64 Sculley carry makes the trajectory reproducible),
and an injected update failure or quality regression fails no serving
request.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from kmeans_tpu_torch.obs import metrics_registry as _metrics
from kmeans_tpu_torch.obs import trace as _trace
from kmeans_tpu_torch.utils import checkpoint as ckpt
from kmeans_tpu_torch.utils import faults as _faults

__all__ = [
    "UPDATE_BATCH_ROWS", "UPDATE_MAX_BATCHES", "RESERVOIR_ROWS",
    "UPDATE_MIN_ROWS", "UPDATE_BUDGET", "ROLLBACK_BUDGET",
    "UPDATE_COOLDOWN_WINDOWS", "REGRESSION_RATIO",
    "REGRESSION_EVAL_WINDOWS", "LEARN_P99_EXCURSION_BOUND",
    "COMMITTED_LEARN_RULES",
    "Decision", "UpdateRolledBack", "publish_tables", "ModelLearner",
]

# --------------------------------------------------------- committed rules

#: Rows per ``partial_fit`` update batch: the 512 rung of the serving
#: bucket ladder, which is also the drift window's rows
#: (``obs.drift.DRIFT_WINDOW_ROWS``), so one batch carries one window of
#: evidence.  Every batch has exactly this many rows (never padded).
UPDATE_BATCH_ROWS = 512

#: Update batches consumed per update: bounds the burst of one update (and
#: so the serving p99 excursion it can cause).
UPDATE_MAX_BATCHES = 4

#: Reservoir capacity in rows (trimmed oldest first, by whole blocks):
#: eight batches, enough to decouple traffic bursts from the update
#: cadence and small enough that the sample is recent.
RESERVOIR_ROWS = 8 * UPDATE_BATCH_ROWS

#: Reservoir fill before an update may start: one full batch.
UPDATE_MIN_ROWS = UPDATE_BATCH_ROWS

#: Updates a learner may apply over its life.  The learner bridges refits;
#: a model that needed this many online updates needs retraining.
UPDATE_BUDGET = 8

#: Rollbacks before the learner disarms itself: traffic that regresses
#: every time is not learnable by this loop.
ROLLBACK_BUDGET = 2

#: Monitor windows between updates: twice the drift debounce, so the
#: evaluation windows of one update close before the next starts.
UPDATE_COOLDOWN_WINDOWS = 4

#: Post/pre score-per-row ratio above which an applied update is judged a
#: regression and rolled back (far below the 2.0 drift alert).
REGRESSION_RATIO = 1.25

#: Monitor windows that must close after an update before it is judged.
REGRESSION_EVAL_WINDOWS = 2

#: The committed bound of the serving p99 during an update wave over the
#: p99 of a quiet wave: the update runs off the dispatch path, so the
#: serve-side costs are the reservoir copy and one swap.
LEARN_P99_EXCURSION_BOUND = 3.0

#: The committed decision table as one dict (tests, ``status()``).
COMMITTED_LEARN_RULES: Dict[str, float] = {
    "batch_rows": UPDATE_BATCH_ROWS,
    "max_batches": UPDATE_MAX_BATCHES,
    "reservoir_rows": RESERVOIR_ROWS,
    "min_rows": UPDATE_MIN_ROWS,
    "update_budget": UPDATE_BUDGET,
    "rollback_budget": ROLLBACK_BUDGET,
    "cooldown_windows": UPDATE_COOLDOWN_WINDOWS,
    "regression_ratio": REGRESSION_RATIO,
    "eval_windows": REGRESSION_EVAL_WINDOWS,
}

#: Decisions kept in each learner's in-memory log (the JSONL sink keeps
#: every one).
DECISION_HISTORY = 64

#: Registry counter per decision action (one fixed name per action).
_ACTION_COUNTERS = {
    "update": "serve.learn.updates",
    "update-failed": "serve.learn.update_failures",
    "update-skipped": "serve.learn.skips",
    "eval-ok": "serve.learn.eval_ok",
    "rollback": "serve.learn.rollbacks",
    "disabled": "serve.learn.disabled",
}

#: The ``action`` field of each decision's quality-sink line.
_SINK_ACTIONS = {"update": "applied", "update-failed": "failed",
                 "update-skipped": "skipped", "eval-ok": "eval-ok",
                 "rollback": "rollback", "disabled": "disabled"}


@dataclass
class Decision:
    """One serve-and-learn decision: what the learner did and why, in
    sequence order."""

    seq: int
    t_s: float
    model: str
    action: str          # a key of _ACTION_COUNTERS
    reason: str
    detail: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"seq": self.seq, "t_s": round(self.t_s, 3),
                "model": self.model, "action": self.action,
                "reason": self.reason, "detail": dict(self.detail)}


@dataclass
class UpdateRolledBack:
    """One rollback to the last good state: which applied update
    regressed, what the committed rule measured, and where the restored
    state came from (the ``primary`` snapshot or its ``.prev``)."""

    model: str
    update_seq: int
    reason: str
    pre_ratio: Optional[float]
    post_ratio: Optional[float]
    ratio: Optional[float]
    restored_from: str

    def as_dict(self) -> dict:
        return {"model": self.model, "update_seq": self.update_seq,
                "reason": self.reason, "pre_ratio": self.pre_ratio,
                "post_ratio": self.post_ratio, "ratio": self.ratio,
                "restored_from": self.restored_from}


# ------------------------------------------------------------ atomic swap

def publish_tables(model, *, centroids_f64, seen, iterations_run,
                   sse_history, cluster_sizes=None) -> float:
    """Publish a new (or restored) table to a served model by one atomic
    swap; the only code of ``serving`` that rebinds a resident model's
    table or touches its ``_cents_cache``.

    ``KMeans._cents_dev`` reads ``centroids`` once and keys its device
    copy on that object, so the rebind of ``centroids`` comes LAST: the
    float64 carry and counts first, then the new table placed on the
    model's device and seeded into ``_cents_cache`` under the new array,
    then the one reference assignment that makes it visible.  A reader
    that read ``centroids`` before the rebind serves the old table end to
    end; one that read it after finds the new table already placed.  On a
    CUDA device the placement's copy is waited for before the rebind, so
    the first reader never reads a table still being copied.  The worst
    interleaving (a reader placing the old table between the seed and the
    rebind) costs one placement more, never a torn table.

    Returns the swap's seconds (placement and rebinds)."""
    t0 = time.perf_counter()
    carry = np.asarray(centroids_f64, np.float64)
    new_cents = carry.astype(model.dtype)
    model._centroids_f64 = carry
    model._seen = np.array(seen, dtype=np.float64, copy=True)
    if cluster_sizes is not None:
        model.cluster_sizes_ = np.asarray(cluster_sizes, np.int64)
    model.iterations_run = int(iterations_run)
    model.sse_history = list(sse_history)
    dev = model._put_centroids(new_cents)
    if dev.is_cuda:
        torch.cuda.current_stream(dev.device).synchronize()
    model._cents_cache = (new_cents, model.device, dev)
    model.centroids = new_cents          # THE swap: old table -> new
    return time.perf_counter() - t0


# One update lock per MODEL OBJECT: fleet replicas share the model, so
# their learners serialize updates on it.  Weak-keyed: a dropped model's
# lock goes with it.
_MODEL_LOCKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_MODEL_LOCKS_GUARD = threading.Lock()


def _model_update_lock(model) -> threading.Lock:
    with _MODEL_LOCKS_GUARD:
        lock = _MODEL_LOCKS.get(model)
        if lock is None:
            lock = threading.Lock()
            _MODEL_LOCKS[model] = lock
        return lock


class ModelLearner:
    """The serve-and-learn loop of one (engine, resident model).

    The engine calls ``offer(rows)`` (the reservoir) and ``poke()`` (the
    trigger check) on its dispatch path, both cheap host calls; updates and
    evaluations run on a short-lived background thread, never on a
    dispatch thread.  ``update_now(force=True)`` is the synchronous path.
    ``close()`` joins an update in flight before the engine closes the
    model's monitor, so an update never writes after ``remove``."""

    def __init__(self, engine, rm, *, snapshot_path: str,
                 batch_rows: int = UPDATE_BATCH_ROWS,
                 max_batches: int = UPDATE_MAX_BATCHES,
                 reservoir_rows: int = RESERVOIR_ROWS,
                 min_rows: int = UPDATE_MIN_ROWS,
                 update_budget: int = UPDATE_BUDGET,
                 rollback_budget: int = ROLLBACK_BUDGET,
                 cooldown_windows: int = UPDATE_COOLDOWN_WINDOWS,
                 regression_ratio: float = REGRESSION_RATIO,
                 eval_windows: int = REGRESSION_EVAL_WINDOWS):
        self.engine = engine
        self.rm = rm
        self.model = rm.model
        self.model_id = rm.model_id
        self.monitor = rm.monitor
        if self.monitor is None:
            raise ValueError(
                f"model {rm.model_id!r} has no quality monitor; the "
                f"serve-and-learn trigger IS the drift monitor — serve "
                f"with quality monitoring on to learn")
        self.snapshot_path = str(snapshot_path)
        self.batch_rows = int(batch_rows)
        self.max_batches = int(max_batches)
        self.reservoir_rows = int(reservoir_rows)
        self.min_rows = max(int(min_rows), self.batch_rows)
        self.update_budget = int(update_budget)
        self.rollback_budget = int(rollback_budget)
        self.cooldown_windows = int(cooldown_windows)
        self.regression_ratio = float(regression_ratio)
        self.eval_windows = int(eval_windows)

        self._res: deque = deque()
        self._res_rows = 0
        self._res_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._busy = threading.Lock()        # one worker in flight
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._armed = True
        self._seq = 0
        self._t0 = time.monotonic()
        self._last_update_window = -self.cooldown_windows
        self._pending: Optional[dict] = None
        self.updates_applied = 0
        self.updates_failed = 0
        self.rollbacks: List[UpdateRolledBack] = []
        self.decisions: deque = deque(maxlen=DECISION_HISTORY)
        # The batches of each APPLIED update, newest last (what an offline
        # replay of the update takes; bounded like the decision log).
        self.applied_batches: deque = deque(maxlen=DECISION_HISTORY)

    # -------------------------------------------------------- reservoir

    def offer(self, rows: np.ndarray) -> None:
        """Keep a copy of one dispatch's rows; the oldest blocks fall off
        past the cap (by whole blocks: the cap bounds retention, not the
        batch shape)."""
        if self._closed or not self._armed:
            return
        block = np.array(rows, copy=True)
        if block.ndim != 2 or block.shape[0] == 0:
            return
        with self._res_lock:
            self._res.append(block)
            self._res_rows += block.shape[0]
            while self._res_rows - self._res[0].shape[0] \
                    >= self.reservoir_rows:
                self._res_rows -= self._res.popleft().shape[0]

    def _drain_batches(self) -> List[np.ndarray]:
        """Pop the oldest ``n * batch_rows`` rows as batches of exactly
        ``batch_rows`` (arrival order, so an offline replay of the same
        traffic builds the same batches)."""
        with self._res_lock:
            n_batches = min(self._res_rows // self.batch_rows,
                            self.max_batches)
            if n_batches == 0:
                return []
            need = n_batches * self.batch_rows
            taken, got = [], 0
            while got < need:
                block = self._res.popleft()
                take = min(block.shape[0], need - got)
                taken.append(block[:take])
                if take < block.shape[0]:
                    self._res.appendleft(block[take:])
                got += take
            self._res_rows -= need
        rows = np.concatenate(taken, axis=0)
        B = self.batch_rows
        return [np.ascontiguousarray(rows[i * B:(i + 1) * B])
                for i in range(n_batches)]

    # -------------------------------------------------------- recording

    def _decide(self, action: str, reason: str, **detail) -> Decision:
        """Record one decision three ways: a tracer event, a registry
        counter and a line in the model's quality sink."""
        with self._state_lock:
            self._seq += 1
            d = Decision(seq=self._seq,
                         t_s=time.monotonic() - self._t0,
                         model=self.model_id, action=action,
                         reason=reason, detail=detail)
            self.decisions.append(d)
        _metrics.REGISTRY.counter(_ACTION_COUNTERS[action]).inc()
        _trace.event("serve.learn", model=self.model_id, action=action,
                     reason=reason)
        if not self._closed:
            kind = "rollback" if action == "rollback" else "update"
            self.monitor.record(kind, action=_SINK_ACTIONS[action],
                                seq=d.seq, reason=reason, **detail)
        return d

    # ---------------------------------------------------------- trigger

    def _update_due(self) -> bool:
        if not self._armed or self._closed or self._pending is not None:
            return False
        if self.updates_applied >= self.update_budget:
            return False
        if self._res_rows < self.min_rows:
            return False
        if not self.monitor.drifting:
            return False
        return (self.monitor.windows - self._last_update_window
                >= self.cooldown_windows)

    def _eval_due(self) -> bool:
        p = self._pending
        return (p is not None
                and self.monitor.windows >= p["eval_after_window"])

    def poke(self) -> None:
        """The post-dispatch trigger check: starts the background worker
        when an update or a pending evaluation is due.  O(1) reads on the
        common path."""
        if self._closed or not self._armed or self._busy.locked():
            return
        if not (self._eval_due() or self._update_due()):
            return
        if not self._busy.acquire(blocking=False):
            return
        try:
            # Joined by close(), which the engine calls before it closes
            # the model's sinks.
            t = threading.Thread(target=self._worker,
                                 name=f"learn-{self.model_id}",
                                 daemon=True)
            self._thread = t
            t.start()
        except BaseException:
            self._busy.release()
            raise

    def _worker(self) -> None:
        try:
            if self._eval_due():
                self._evaluate()
            elif self._update_due():
                self._run_update(force=False, reason="drift")
        except Exception as e:  # noqa: BLE001 — a learner fault must
            # never take serving down; it is recorded.
            self._decide("update-failed", f"internal: {e}",
                         error=type(e).__name__, ok=False)
        finally:
            self._busy.release()

    # ----------------------------------------------------------- update

    def evaluate_now(self, *, force: bool = True) -> None:
        """Judge the pending update now; ``force=True`` judges on the
        windows there are instead of waiting for ``eval_windows``."""
        with self._busy:
            self._evaluate(force=force)

    def update_now(self, *, force: bool = True,
                   reason: str = "manual") -> Optional[dict]:
        """Synchronous update on the calling thread: a due evaluation
        first, then one update.  ``force=True`` bypasses the drift trigger
        and the cooldown, never the budgets or the fill rule.  Returns the
        decision's dict (None when nothing ran)."""
        with self._busy:
            if self._pending is not None:
                self._evaluate(force=force)
            d = self._run_update(force=force, reason=reason)
        return d.as_dict() if d is not None else None

    def _run_update(self, *, force: bool,
                    reason: str) -> Optional[Decision]:
        """One update.  The caller holds ``_busy``."""
        if self._closed or not self._armed:
            return None
        if self.updates_applied >= self.update_budget:
            return self._decide("update-skipped", "update-budget-exhausted",
                                budget=self.update_budget, ok=False)
        if not force and not self._update_due():
            return None
        mlock = _model_update_lock(self.model)
        if not mlock.acquire(blocking=False):
            # A fleet peer's learner is updating the shared model.
            return self._decide("update-skipped", "peer-updating",
                                ok=False)
        try:
            return self._run_update_locked(reason)
        finally:
            mlock.release()

    def _run_update_locked(self, reason: str) -> Optional[Decision]:
        batches = self._drain_batches()
        if not batches:
            return self._decide("update-skipped", "reservoir-underfilled",
                                rows=self._res_rows,
                                min_rows=self.min_rows, ok=False)
        # The regression rule's baseline, under the OLD table.
        pre_ratio = self._recent_score_ratio(after_window=None)
        pre_sizes = np.array(self.model.cluster_sizes_, copy=True) \
            if getattr(self.model, "cluster_sizes_", None) is not None \
            else None
        # 1. The snapshot before the update (rotating: the previous one
        #    stays at .prev).
        try:
            ckpt.save_state_rotating(self.snapshot_path,
                                     self.model._state_dict())
        except Exception as e:  # noqa: BLE001 — recorded, typed
            self.updates_failed += 1
            return self._decide("update-failed", f"snapshot: {e}",
                                error=type(e).__name__, ok=False)
        # 2. partial_fit on a detached clone: the served model is
        #    untouched until the swap.
        t_fit = time.perf_counter()
        try:
            clone = self.model._learn_clone()
            for i, batch in enumerate(batches):
                _faults.on_update_step(self.model_id, i)
                clone.partial_fit(batch)
        except Exception as e:  # noqa: BLE001 — the served model stays
            # bit-identical on its last good table.
            self.updates_failed += 1
            # Cooldown all the same: a deterministic failure must not
            # retry on every window close.
            self._last_update_window = self.monitor.windows
            return self._decide("update-failed", str(e),
                                error=type(e).__name__,
                                n_batches=len(batches), ok=False)
        fit_s = time.perf_counter() - t_fit
        if self._closed:
            # remove()/close() raced the update: never publish.
            return None
        # 3. One atomic swap publishes the clone's tables.
        swap_s = publish_tables(
            self.model, centroids_f64=clone._centroids_f64,
            seen=clone._seen, cluster_sizes=clone.cluster_sizes_,
            iterations_run=clone.iterations_run,
            sse_history=clone.sse_history)
        self.updates_applied += 1
        self._last_update_window = self.monitor.windows
        self.applied_batches.append(batches)
        self._pending = {
            "update_seq": self._seq + 1,
            "window": self.monitor.windows,
            "eval_after_window": self.monitor.windows + self.eval_windows,
            "pre_ratio": pre_ratio,
            "pre_cluster_sizes": pre_sizes,
        }
        return self._decide(
            "update", reason, ok=True, n_batches=len(batches),
            rows=len(batches) * self.batch_rows,
            fit_ms=round(fit_s * 1e3, 3),
            swap_ms=round(swap_s * 1e3, 3),
            budget_left=self.update_budget - self.updates_applied,
            snapshot=self.snapshot_path)

    # ------------------------------------------------------- evaluation

    def _recent_score_ratio(self, *, after_window: Optional[int]
                            ) -> Optional[float]:
        """Median ``score_ratio`` over the newest windows that carry one
        (at most ``eval_windows``), only windows closed after
        ``after_window`` when given; None when no window carried one."""
        vals = [w["detectors"].get("score_ratio")
                for w in self.monitor.history()
                if (after_window is None or w["window"] > after_window)]
        vals = [v for v in vals if v is not None]
        if not vals:
            return None
        return float(np.median(vals[-self.eval_windows:]))

    def _evaluate(self, *, force: bool = False) -> None:
        """Judge the pending update by the committed regression rule and
        roll back on a breach.  The caller holds ``_busy``."""
        p = self._pending
        if p is None or self._closed:
            return
        if not force and not self._eval_due():
            return
        post = self._recent_score_ratio(after_window=p["window"])
        pre = p["pre_ratio"]
        ratio = (post / pre) if (post is not None and pre) else None
        # An armed utils.faults.inject_quality_regression overrides the
        # measured ratio, driving the real restore and swap.
        ratio = _faults.on_update_eval(self.model_id, ratio)
        self._pending = None
        if ratio is None or ratio <= self.regression_ratio:
            self._decide("eval-ok",
                         "no-score-signal" if ratio is None
                         else "within-threshold",
                         update_seq=p["update_seq"],
                         pre_ratio=pre, post_ratio=post, ratio=ratio,
                         ok=True)
            return
        self._rollback(p, pre=pre, post=post, ratio=ratio)

    def _rollback(self, pending: dict, *, pre, post, ratio) -> None:
        """Restore the pre-update snapshot and publish it by the same
        atomic swap as the update."""
        try:
            state, used_fallback = ckpt.load_state_with_fallback(
                self.snapshot_path)
        except Exception as e:  # noqa: BLE001 — both files torn: record
            # it and disarm; the model keeps serving the updated table.
            self._armed = False
            self._decide("disabled", f"rollback-restore-failed: {e}",
                         error=type(e).__name__, ok=False)
            return
        carry = state.get("centroids_f64")
        if carry is None:
            carry = np.asarray(state["centroids"], np.float64)
        if self._closed:
            return
        swap_s = publish_tables(
            self.model, centroids_f64=carry, seen=state["seen_counts"],
            cluster_sizes=pending.get("pre_cluster_sizes"),
            iterations_run=int(state["iterations_run"]),
            sse_history=list(state["sse_history"]))
        restored_from = "prev" if used_fallback else "primary"
        rec = UpdateRolledBack(
            model=self.model_id, update_seq=pending["update_seq"],
            reason=f"score regression {ratio:.3f} > "
                   f"{self.regression_ratio} over {self.eval_windows} "
                   f"windows",
            pre_ratio=pre, post_ratio=post, ratio=float(ratio),
            restored_from=restored_from)
        self.rollbacks.append(rec)
        self._last_update_window = self.monitor.windows
        self._decide("rollback", rec.reason, ok=True,
                     update_seq=pending["update_seq"],
                     pre_ratio=pre, post_ratio=post, ratio=float(ratio),
                     restored_from=restored_from,
                     swap_ms=round(swap_s * 1e3, 3))
        if len(self.rollbacks) >= self.rollback_budget:
            self._armed = False
            self._decide("disabled", "rollback-budget-exhausted",
                         rollbacks=len(self.rollbacks),
                         budget=self.rollback_budget, ok=False)

    # ------------------------------------------------------------ status

    def status(self) -> dict:
        """The ``update_status()`` entry of this model: armed state,
        budgets, reservoir fill, the pending evaluation and the recent
        decisions."""
        with self._state_lock:
            p = self._pending
            return {
                "model": self.model_id,
                "armed": self._armed and not self._closed,
                "closed": self._closed,
                "updates_applied": self.updates_applied,
                "updates_failed": self.updates_failed,
                "rollbacks": [r.as_dict() for r in self.rollbacks],
                "update_budget_left":
                    max(self.update_budget - self.updates_applied, 0),
                "rollback_budget_left":
                    max(self.rollback_budget - len(self.rollbacks), 0),
                "reservoir_rows": self._res_rows,
                "pending_eval": ({
                    "update_seq": p["update_seq"],
                    "eval_after_window": p["eval_after_window"],
                    "pre_ratio": p["pre_ratio"],
                } if p is not None else None),
                "snapshot": self.snapshot_path,
                "rules": {
                    "batch_rows": self.batch_rows,
                    "max_batches": self.max_batches,
                    "reservoir_rows": self.reservoir_rows,
                    "min_rows": self.min_rows,
                    "update_budget": self.update_budget,
                    "rollback_budget": self.rollback_budget,
                    "cooldown_windows": self.cooldown_windows,
                    "regression_ratio": self.regression_ratio,
                    "eval_windows": self.eval_windows,
                },
                "decisions": [d.as_dict() for d in self.decisions],
            }

    # --------------------------------------------------------- lifecycle

    def close(self, *, join: bool = True) -> None:
        """Stop learning and JOIN an update in flight, before the caller
        closes the model's sinks: an update never publishes to a removed
        model or writes to a closed sink.  Idempotent."""
        with self._state_lock:
            if self._closed:
                return
            self._closed = True
        t = self._thread
        if join and t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=60.0)
        with self._res_lock:
            self._res.clear()
            self._res_rows = 0


def snapshot_path_for(learn_dir: str, model_id: str,
                      tag: Optional[str] = None) -> str:
    """The rotating pre-update snapshot of one (model, replica):
    ``learn.<model_id>[.<tag>].npz`` beside the quality sinks."""
    name = f"learn.{model_id}.npz" if tag is None \
        else f"learn.{model_id}.{tag}.npz"
    return os.path.join(learn_dir, name)
