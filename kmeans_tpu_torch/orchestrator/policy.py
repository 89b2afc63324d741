"""The autopilot's decision rules, committed and typed.

Counterpart of ``kmeans_tpu/orchestrator/policy.py``, with its constants,
functions and messages unchanged.  Every threshold the supervising loop
acts on lives here as a module constant, fixed before any chaos run: a
rule the autopilot applies is a rule a reader can find, and a chaos test
pins the behaviour at the committed value.

The decision vocabulary (``Decision.action``):

=====================  ==================================================
``launch``             a worker process spawned (initial fleet bring-up)
``launch-backoff``     a launch attempt failed; deterministic exponential
                       delay before the retry (:func:`backoff_delay_s`)
``finish``             a worker exited 0 (its shard of the fit is done)
``relaunch``           a dead worker restarted from the selected resume
                       source (same world)
``resume-fallback-prev`` the selected resume source is the ``.prev``
                       last-good rotation: the primary is torn or corrupt
``resume-torn``        nothing classifies resumable but torn checkpoint
                       state exists on disk: the relaunch hands the torn
                       path to ``fit(resume=)`` anyway, so the failure is
                       the worker's typed one, counted against the
                       relaunch budget (never a silent fresh restart that
                       would discard committed progress)
``evict``              a host flagged ``stalled`` for
                       :data:`STALL_CONSECUTIVE_POLLS` consecutive polls
                       is killed
``shrink``             the fleet relaunches on the smaller world from the
                       last rotating checkpoint
``grow``               capacity returned: the fleet relaunches on the
                       larger world (bounded by the target world)
``give-up``            a committed budget is exhausted:
                       :class:`AutopilotGaveUpError` carries the whole
                       decision log
``done``               the run completed (``converged`` or ``degraded``)
=====================  ==================================================

Every function here is pure (no IO, no clock): the loop in
``autopilot.py`` feeds them observations and acts on their verdicts, so
every rule is testable without a fleet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "POLL_PERIOD_S", "STALL_CONSECUTIVE_POLLS",
    "LAUNCH_RETRY_BUDGET", "LAUNCH_BACKOFF_BASE_S",
    "LAUNCH_BACKOFF_FACTOR", "LAUNCH_BACKOFF_MAX_S",
    "RELAUNCH_BUDGET", "GROW_HOLDOFF_POLLS", "MAX_RUN_S",
    "EXIT_DONE", "EXIT_PREEMPTED", "EXIT_CKPT_CORRUPT",
    "Decision", "AutopilotGaveUpError",
    "backoff_delay_s", "classify_exit", "should_evict", "should_grow",
    "checkpoint_path", "select_resume",
]

# ------------------------------------------------- committed thresholds

#: Supervising-loop poll period (heartbeat scan + reap), seconds.
POLL_PERIOD_S = 0.25

#: A host must be flagged ``stalled`` by ``obs.fleet.straggler_report``
#: on this many CONSECUTIVE polls before it is evicted — one flag can be
#: a paused disk flush; a run of them is a dead host.
STALL_CONSECUTIVE_POLLS = 2

#: Launch attempts per worker (initial spawn or relaunch) before the
#: autopilot gives up.  4 attempts = 3 backoffs.
LAUNCH_RETRY_BUDGET = 4

#: Deterministic exponential launch backoff: attempt ``i`` (0-based)
#: sleeps ``min(BASE * FACTOR**i, MAX)`` seconds.  No jitter — chaos
#: runs must replay bit-identically.
LAUNCH_BACKOFF_BASE_S = 0.05
LAUNCH_BACKOFF_FACTOR = 2.0
LAUNCH_BACKOFF_MAX_S = 2.0

#: Times ONE worker index may die (preemption, corrupt resume, crash)
#: and be relaunched before the autopilot refuses with
#: :class:`AutopilotGaveUpError` rather than looping forever.
RELAUNCH_BUDGET = 3

#: Consecutive healthy polls (no stall flags, no deaths) required
#: before a shrunk fleet grows back toward the target world.
GROW_HOLDOFF_POLLS = 8

#: Wall-clock deadline for one supervised run, seconds.
MAX_RUN_S = 600.0

# ------------------------------------------------- worker exit contract

#: Worker exit codes (``orchestrator.worker``): the ONLY channel a dead
#: process has.  75 is sysexits' EX_TEMPFAIL (transient, retry), 77 is
#: EX_NOPERM repurposed as "resume state unusable" — distinct so the
#: supervisor can tell a preemption (checkpoint valid, relaunch) from a
#: torn resume source (counted toward give-up).
EXIT_DONE = 0
EXIT_PREEMPTED = 75
EXIT_CKPT_CORRUPT = 77


def classify_exit(returncode: int) -> str:
    """Typed classification of a worker exit: ``done`` / ``preempted``
    / ``checkpoint-corrupt`` / ``crashed``."""
    if returncode == EXIT_DONE:
        return "done"
    if returncode == EXIT_PREEMPTED:
        return "preempted"
    if returncode == EXIT_CKPT_CORRUPT:
        return "checkpoint-corrupt"
    return "crashed"


def backoff_delay_s(attempt: int) -> float:
    """Delay before retrying a failed launch ``attempt`` (0-based):
    bounded deterministic exponential —
    ``min(BASE * FACTOR**attempt, MAX)``."""
    if attempt < 0:
        raise ValueError(f"attempt must be >= 0, got {attempt}")
    return min(LAUNCH_BACKOFF_BASE_S * LAUNCH_BACKOFF_FACTOR ** attempt,
               LAUNCH_BACKOFF_MAX_S)


def should_evict(consecutive_stalled_polls: int) -> bool:
    """Evict once a host has been flagged ``stalled`` on
    :data:`STALL_CONSECUTIVE_POLLS` consecutive polls."""
    return consecutive_stalled_polls >= STALL_CONSECUTIVE_POLLS


def should_grow(world: int, target_world: int,
                healthy_streak: int) -> bool:
    """Grow back toward the target once the shrunk fleet has been
    healthy for :data:`GROW_HOLDOFF_POLLS` consecutive polls."""
    return world < target_world and healthy_streak >= GROW_HOLDOFF_POLLS


# ------------------------------------------------------------ decisions

@dataclass
class Decision:
    """One autopilot decision — the JSONL record, the tracer event
    payload, and the give-up report line are all this dict."""

    seq: int
    t_s: float                  # seconds since the run started
    action: str                 # vocabulary in the module docstring
    reason: str
    world_before: int
    world_after: int
    detail: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        d = {"seq": self.seq, "t_s": round(self.t_s, 3),
             "action": self.action, "reason": self.reason,
             "world_before": self.world_before,
             "world_after": self.world_after}
        d.update(self.detail)
        return d


class AutopilotGaveUpError(RuntimeError):
    """A committed retry budget is exhausted: the autopilot REFUSES to
    keep looping.  Carries the complete typed decision log — the
    post-mortem is in the exception, not scattered across worker
    logs."""

    def __init__(self, reason: str, decisions: Sequence[Decision]):
        self.reason = reason
        self.decisions = list(decisions)
        super().__init__(
            f"autopilot gave up: {reason} "
            f"({len(self.decisions)} decisions logged)")

    def report(self) -> str:
        """The decision log, one line per decision, newest last."""
        lines = [f"autopilot gave up: {self.reason}"]
        for d in self.decisions:
            lines.append(
                f"  [{d.seq:3d}] t={d.t_s:8.3f}s {d.action:<22s} "
                f"world {d.world_before}->{d.world_after}  {d.reason}")
        return "\n".join(lines)


# ------------------------------------------------------- resume sources

def checkpoint_path(out_dir, index: int):
    """The per-worker rotating checkpoint path convention
    (``<out>/ckpt.p<i>.npz``) shared by the worker (writes) and the
    resume selection below (reads)."""
    from pathlib import Path
    return Path(out_dir) / f"ckpt.p{index}.npz"


def select_resume(out_dir, indexes: Sequence[int]) -> Tuple[
        Optional[object], Dict[str, Any]]:
    """Pick the resume source for a relaunch: among the fleet's rotating
    checkpoints (``ckpt.p<i>.npz`` for ``i`` in ``indexes``), the
    RESUMABLE one with the highest completed iteration — ties broken by
    lowest index, so the choice is deterministic.  Classification goes
    through ``utils.checkpoint.classify_resume`` (the ``.prev``-aware
    metadata read; no array materialization).

    Returns ``(path_or_None, info)`` where ``info`` carries ``source``
    (``primary``/``prev``/``None``), ``iteration``, and ``torn`` — the
    paths that exist on disk but classify unresumable.  ``path`` is
    None only when NO checkpoint classifies resumable; if ``torn`` is
    non-empty the caller must treat that as torn state (relaunch
    against it, bounded by the relaunch budget), never as
    start-from-scratch."""
    from kmeans_tpu_torch.utils.checkpoint import classify_resume, prev_path

    best = None     # (iteration, index, path, cls)
    torn: List[str] = []
    for i in sorted(indexes):
        p = checkpoint_path(out_dir, i)
        if not p.exists() and not prev_path(p).exists():
            continue
        cls = classify_resume(p)
        if not cls["resumable"]:
            torn.append(str(p))
            continue
        key = (cls["iteration"] or 0, -i)
        if best is None or key > (best[0], -best[1]):
            best = (cls["iteration"] or 0, i, p, cls)
    if best is None:
        return None, {"source": None, "iteration": None, "torn": torn}
    _, i, p, cls = best
    return p, {"source": cls["source"], "iteration": cls["iteration"],
               "index": i, "torn": torn}
