"""The elastic autopilot: a supervising loop over per-host fit workers.

Counterpart of ``kmeans_tpu/orchestrator/autopilot.py``.  It composes
rotating checkpoints that any world size resumes, fleet heartbeats with
``obs.fleet.straggler_report``, and the store of built kernel libraries
shipped with a checkpoint, into the controller: launch the fleet, watch
its heartbeats, and act on the committed, typed rules of
``orchestrator.policy``:

* a worker that dies is classified by its typed exit code and relaunched
  from the newest resumable rotating checkpoint (``policy.select_resume``,
  aware of ``.prev``), up to ``policy.RELAUNCH_BUDGET`` deaths per index;
* a host flagged ``stalled`` on ``policy.STALL_CONSECUTIVE_POLLS``
  consecutive polls is evicted, the fleet relaunches on the smaller world
  from the last rotating checkpoint, and after ``policy.GROW_HOLDOFF_POLLS``
  healthy polls grows back toward the target world when capacity returns;
* a launch failure retries under the bounded deterministic exponential
  backoff (``policy.backoff_delay_s``), and any exhausted budget refuses
  with :class:`policy.AutopilotGaveUpError`, which carries the whole
  decision log, rather than looping forever.

Every decision is a JSONL record (``<out>/autopilot.decisions.jsonl``,
appended and flushed as it happens, so a crashed supervisor still leaves
its log), an ``autopilot.decision`` event through the tracer, and an
``autopilot.<action>`` counter in the metrics registry; the evict, shrink,
grow and relaunch operations run inside ``autopilot.<action>`` spans.

Stall flags count per worker incarnation: a flag counts only when the host
has beaten since its current launch (``ts >= launched_wall``), so a freshly
(re)launched worker still importing torch does not read as stalled because
its previous incarnation's beats are old.  A worker that hangs before its
first beat is bounded by ``policy.MAX_RUN_S``.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from kmeans_tpu_torch.obs import REGISTRY, fleet as obs_fleet
from kmeans_tpu_torch.obs import trace as obs_trace
from kmeans_tpu_torch.obs.trace import TraceReadError
from kmeans_tpu_torch.orchestrator import launcher, policy
from kmeans_tpu_torch.orchestrator.policy import AutopilotGaveUpError, Decision

__all__ = ["Autopilot", "AutopilotResult", "run_autopilot"]


@dataclass
class AutopilotResult:
    """What a completed (non-gave-up) supervised run looked like."""

    outcome: str                    # "converged" | "degraded"
    world_start: int
    target_world: int
    final_world: int
    decisions: List[Dict[str, Any]]
    results: Dict[int, Dict[str, Any]]   # per-index result.p<i>.json
    centroids_agree: bool
    out_dir: str

    @property
    def exit_code(self) -> int:
        """The CLI contract: 0 converged, 1 degraded-but-done (the
        gave-up path raises and maps to 2)."""
        return 0 if self.outcome == "converged" else 1

    def as_dict(self) -> Dict[str, Any]:
        return {"outcome": self.outcome, "exit_code": self.exit_code,
                "world_start": self.world_start,
                "target_world": self.target_world,
                "final_world": self.final_world,
                "centroids_agree": self.centroids_agree,
                "decisions": self.decisions,
                "results": {str(i): r for i, r in self.results.items()},
                "out_dir": self.out_dir}


class Autopilot:
    """Supervise ``world`` fit workers to completion under the
    committed policy.  ``capacity_fn`` answers "can the fleet grow back
    one host right now?" (default: always, the single-machine simulated
    fleet); ``grow=False`` pins a shrunk fleet shrunk (useful when the
    straggler cause is known to persist)."""

    def __init__(self, spec_path, out_dir, world: int, *,
                 target_world: Optional[int] = None,
                 poll_period_s: float = policy.POLL_PERIOD_S,
                 grow: bool = True,
                 max_run_s: float = policy.MAX_RUN_S,
                 capacity_fn: Optional[Callable[[], bool]] = None,
                 coordinator_address: Optional[str] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.spec_path = Path(spec_path)
        if not self.spec_path.is_file():
            raise FileNotFoundError(
                f"worker spec not found: {self.spec_path}")
        from kmeans_tpu_torch.orchestrator.worker import check_spec
        check_spec(json.loads(self.spec_path.read_text()))
        self.out_dir = Path(out_dir)
        self.world = world
        self.world_start = world
        self.target_world = target_world if target_world is not None \
            else world
        self.poll_period_s = poll_period_s
        self.grow = grow
        self.max_run_s = max_run_s
        self.capacity_fn = capacity_fn or (lambda: True)
        self.coordinator_address = coordinator_address
        self.sleep = sleep
        self.decisions: List[Decision] = []
        self._active: Dict[int, launcher.WorkerHandle] = {}
        self._launched_wall: Dict[int, float] = {}
        self._stall_streak: Dict[int, int] = {}
        self._relaunches: Dict[int, int] = {}
        self._healthy_streak = 0
        self._t0 = 0.0
        self._log_file = None

    # ------------------------------------------------------- decisions

    def _record(self, action: str, reason: str, *, world_after=None,
                **detail) -> Decision:
        d = Decision(seq=len(self.decisions),
                     t_s=time.monotonic() - self._t0,
                     action=action, reason=reason,
                     world_before=self.world,
                     world_after=(self.world if world_after is None
                                  else world_after),
                     detail=detail)
        self.decisions.append(d)
        payload = d.as_dict()
        if self._log_file is not None:
            self._log_file.write(json.dumps(payload) + "\n")
            self._log_file.flush()
        obs_trace.event("autopilot.decision", **payload)
        REGISTRY.counter(f"autopilot.{action}").inc()
        return d

    def _record_unreadable(self, error: str) -> None:
        """Account an unreadable heartbeat scan (a worker mid-append);
        the poll simply carries no signal — counted, never silent."""
        REGISTRY.counter("autopilot.poll_unreadable").inc()

    def _give_up(self, reason: str, **detail):
        self._record("give-up", reason, **detail)
        raise AutopilotGaveUpError(reason, self.decisions)

    # --------------------------------------------------------- workers

    def _launch(self, index: int, *, resume=None, action="launch",
                reason="fleet bring-up", **detail) -> None:
        def on_backoff(attempt, delay, err):
            self._record("launch-backoff",
                         f"worker {index} attempt {attempt} failed",
                         attempt=attempt, delay_s=delay, error=err)

        try:
            with obs_trace.span(f"autopilot.{action}", index=index,
                                world=self.world):
                h = launcher.launch_with_backoff(
                    self.spec_path, index, self.world, self.out_dir,
                    resume=resume,
                    coordinator_address=self.coordinator_address,
                    on_backoff=on_backoff, sleep=self.sleep)
        except launcher.LaunchError as e:
            # The committed backoff budget is spent: the typed give-up
            # with the whole decision log.
            self._give_up(
                f"worker {index} failed to launch after "
                f"{policy.LAUNCH_RETRY_BUDGET} attempts: {e}")
        h.relaunches = self._relaunches.get(index, 0)
        self._active[index] = h
        self._launched_wall[index] = time.time()
        self._stall_streak[index] = 0
        self._record(action, reason, index=index,
                     resume=str(resume) if resume else None, **detail)

    def _select_resume(self, indexes) -> Optional[object]:
        """The committed resume rule + its decision records."""
        path, info = policy.select_resume(self.out_dir, indexes)
        if path is None:
            if info["torn"]:
                self._record("resume-torn",
                             "no rotation classifies resumable; "
                             "handing torn state to the typed worker "
                             "failure path", torn=info["torn"])
                return Path(info["torn"][0])
            return None
        if info["source"] == "prev":
            self._record("resume-fallback-prev",
                         f"primary torn; resuming from the .prev "
                         f"last-good rotation at iteration "
                         f"{info['iteration']}", path=str(path),
                         iteration=info["iteration"])
        return path

    def _relaunch_fleet(self, new_world: int, *, action: str,
                        reason: str) -> None:
        """Kill every active worker and relaunch the fleet at
        ``new_world`` from the newest resumable checkpoint — the shrink
        / grow primitive (a ``torch.distributed`` world cannot
        change size in place)."""
        old_indexes = set(range(max(self.world, new_world))) \
            | set(self._active)
        with obs_trace.span(f"autopilot.{action}",
                            world_before=self.world,
                            world_after=new_world):
            for h in self._active.values():
                h.terminate()
            self._active.clear()
            self._record(action, reason, world_after=new_world)
            self.world = new_world
            resume = self._select_resume(old_indexes)
            for i in range(new_world):
                self._launch(i, resume=resume, action="relaunch",
                             reason=f"{action} to world {new_world}")

    # ------------------------------------------------------------ poll

    def _reap(self) -> bool:
        """Collect exited workers; relaunch the dead under the
        committed budgets.  Returns True if any worker exited."""
        reaped = False
        for index, h in list(self._active.items()):
            rc = h.poll()
            if rc is None:
                continue
            reaped = True
            del self._active[index]
            kind = policy.classify_exit(rc)
            if kind == "done":
                self._record("finish", f"worker {index} exit 0",
                             index=index)
                continue
            self._relaunches[index] = self._relaunches.get(index, 0) + 1
            if self._relaunches[index] > policy.RELAUNCH_BUDGET:
                self._give_up(
                    f"worker {index} died {self._relaunches[index]} "
                    f"times (last: {kind}, exit {rc}) — relaunch "
                    f"budget {policy.RELAUNCH_BUDGET} exhausted",
                    index=index, exit_code=rc, kind=kind)
            resume = self._select_resume(
                set(range(self.world)) | {index})
            self._launch(index, resume=resume, action="relaunch",
                         reason=f"worker {index} {kind} (exit {rc}); "
                         f"resuming from last rotating checkpoint",
                         exit_code=rc, kind=kind,
                         death=self._relaunches[index])
        return reaped

    def _stalled_now(self) -> List[int]:
        """Active worker indexes currently flagged ``stalled`` by the
        merged-heartbeat straggler report, gated per incarnation."""
        paths = sorted(self.out_dir.glob("hb.p*.jsonl"))
        if not paths:
            return []
        try:
            records = obs_fleet.merge_heartbeats(paths)
        except TraceReadError as e:
            # A torn read of a file mid-append is an expected transient:
            # counted, read again at the next poll.
            self._record_unreadable(str(e))
            return []
        if not records:
            return []
        report = obs_fleet.straggler_report(records, now=time.time())
        out = []
        for row in report["hosts"]:
            idx = row.get("process_index")
            if idx not in self._active or "stalled" not in row["flags"]:
                continue
            if row.get("ts", 0.0) < self._launched_wall.get(idx, 0.0):
                continue    # no beat from THIS incarnation yet
            out.append(idx)
        return out

    # ------------------------------------------------------------- run

    def run(self) -> AutopilotResult:
        """Supervise the fleet to completion.  Returns the typed result
        (``converged`` / ``degraded``); raises
        :class:`AutopilotGaveUpError` when a committed budget is
        exhausted."""
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self._t0 = time.monotonic()
        own_tracer = obs_trace.get_tracer() is None
        ctx = obs_trace.tracing(self.out_dir / "autopilot.trace.jsonl") \
            if own_tracer else contextlib.nullcontext()
        with ctx, open(self.out_dir / "autopilot.decisions.jsonl",
                       "a") as self._log_file:
            try:
                return self._run()
            finally:
                for h in self._active.values():
                    h.terminate()
                self._active.clear()
                self._log_file = None

    def _run(self) -> AutopilotResult:
        for i in range(self.world):
            self._launch(i)
        while True:
            if time.monotonic() - self._t0 > self.max_run_s:
                self._give_up(
                    f"deadline exceeded ({self.max_run_s:g} s) with "
                    f"{len(self._active)} workers still running")
            self.sleep(self.poll_period_s)
            reaped = self._reap()
            if not self._active:
                break
            stalled = self._stalled_now()
            for idx in list(self._stall_streak):
                self._stall_streak[idx] = \
                    self._stall_streak.get(idx, 0) + 1 \
                    if idx in stalled else 0
            victims = [i for i in sorted(self._active)
                       if policy.should_evict(self._stall_streak.get(i, 0))]
            if victims:
                victim = victims[0]
                self._healthy_streak = 0
                self._record(
                    "evict",
                    f"worker {victim} stalled on "
                    f"{self._stall_streak[victim]} consecutive polls",
                    index=victim,
                    streak=self._stall_streak[victim])
                if self.world - 1 < 1:
                    self._give_up("no healthy hosts left after "
                                  "evicting the last worker")
                self._active.pop(victim).terminate()
                self._relaunch_fleet(
                    self.world - 1, action="shrink",
                    reason=f"evicted stalled worker {victim}")
                continue
            if reaped or stalled:
                self._healthy_streak = 0
            else:
                self._healthy_streak += 1
            if self.grow and policy.should_grow(
                    self.world, self.target_world,
                    self._healthy_streak) and self.capacity_fn():
                self._healthy_streak = 0
                self._relaunch_fleet(
                    self.world + 1, action="grow",
                    reason=f"capacity returned after "
                    f"{policy.GROW_HOLDOFF_POLLS} healthy polls")
        return self._finish()

    def _finish(self) -> AutopilotResult:
        import numpy as np

        results: Dict[int, Dict[str, Any]] = {}
        cents = {}
        for i in range(self.world):
            rp = self.out_dir / f"result.p{i}.json"
            if rp.exists():
                results[i] = json.loads(rp.read_text())
            cp = self.out_dir / f"centroids.p{i}.npy"
            if cp.exists():
                cents[i] = np.load(cp)
        agree = len(cents) == self.world and self.world > 0 and all(
            np.array_equal(cents[i], cents[0]) for i in cents)
        outcome = "converged" if self.world == self.target_world \
            else "degraded"
        self._record("done", f"fleet of {self.world} finished "
                     f"({outcome})", centroids_agree=agree)
        return AutopilotResult(
            outcome=outcome, world_start=self.world_start,
            target_world=self.target_world, final_world=self.world,
            decisions=[d.as_dict() for d in self.decisions],
            results=results, centroids_agree=agree,
            out_dir=str(self.out_dir))


def run_autopilot(spec_path, out_dir, world: int,
                  **kwargs) -> AutopilotResult:
    """One-call convenience wrapper around :class:`Autopilot`."""
    return Autopilot(spec_path, out_dir, world, **kwargs).run()
