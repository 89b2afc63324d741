"""Worker process launch for the autopilot.

Counterpart of ``kmeans_tpu/orchestrator/launcher.py``.  One worker is one
host of the fleet: one OS process running
``python -m kmeans_tpu_torch.orchestrator.worker`` against a shared JSON
spec.  Two fleet modes share this launcher:

* **Simulated fleet** (the default, and what one machine runs): each worker
  gets the ``KMEANS_TPU_PROCESS_INDEX`` / ``_COUNT`` / ``_HOST`` identity
  environment (``parallel.multihost.simulated_world_env``) and runs an
  independent replica of the fit, with no process group.  Per-process
  heartbeat and trace sinks, host-targeted fault injection, checkpoints and
  resume all run through the fit's own code paths.
* **A ``torch.distributed`` world**: pass ``coordinator_address`` (an
  ``init_method`` such as ``tcp://host:port``) and each worker joins one
  world through ``parallel.multihost.initialize`` with its index as rank.

Launch failures are typed: every spawn attempt first fires
``utils.faults.on_launch`` (the ``inject_launch_failures`` registry, so a
chaos run flakes the real spawn path), and any failure surfaces as
:class:`LaunchError` for the autopilot's committed exponential backoff
(``policy.backoff_delay_s``).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from kmeans_tpu_torch.orchestrator import policy
from kmeans_tpu_torch.parallel.multihost import simulated_world_env
from kmeans_tpu_torch.utils import faults

__all__ = ["LaunchError", "WorkerHandle", "launch_worker",
           "launch_with_backoff"]


class LaunchError(RuntimeError):
    """A worker spawn attempt failed (an injected flake or a real
    ``OSError``).  The typed boundary between "could not start a process"
    (retry with backoff, bounded by ``policy.LAUNCH_RETRY_BUDGET``) and "a
    started process died" (``policy.classify_exit``, bounded by
    ``policy.RELAUNCH_BUDGET``)."""


@dataclass
class WorkerHandle:
    """One live (or reaped) worker process."""

    index: int                   # fleet process_index
    world: int                   # process_count it was launched into
    proc: subprocess.Popen
    log_path: Path
    resume: Optional[str] = None  # resume source it was handed
    launch_attempts: int = 1     # spawn attempts this launch consumed
    relaunches: int = 0          # deaths this index has accumulated
    detail: dict = field(default_factory=dict)

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def terminate(self, grace_s: float = 5.0) -> int:
        """SIGTERM, a bounded wait, then SIGKILL; returns the exit code."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                # A stuck worker must never wedge the supervisor.
                self.proc.kill()
                self.proc.wait()
        return self.proc.returncode


def launch_worker(spec_path, index: int, world: int, out_dir, *,
                  resume: Optional[object] = None,
                  attempt: int = 0,
                  coordinator_address: Optional[str] = None,
                  python: Optional[str] = None,
                  extra_env: Optional[dict] = None) -> WorkerHandle:
    """Spawn one worker.  Fires the launch-attempt fault hook first
    (``faults.on_launch``), then starts
    ``python -m kmeans_tpu_torch.orchestrator.worker``.  Any failure raises
    :class:`LaunchError`; the caller owns retry and backoff
    (:func:`launch_with_backoff`)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    log_path = out_dir / f"worker.p{index}.log"
    cmd = [python or sys.executable, "-m",
           "kmeans_tpu_torch.orchestrator.worker",
           "--spec", str(spec_path), "--index", str(index),
           "--world", str(world), "--out", str(out_dir)]
    if resume is not None:
        cmd += ["--resume", str(resume)]

    env = os.environ.copy()
    if coordinator_address is not None:
        cmd += ["--coordinator-address", coordinator_address]
    else:
        env.update(simulated_world_env(index, world))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parents[2])]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    if extra_env:
        env.update(extra_env)

    try:
        faults.on_launch(index, attempt)
        log = open(log_path, "a")
        try:
            proc = subprocess.Popen(cmd, env=env, stdout=log,
                                    stderr=subprocess.STDOUT)
        finally:
            log.close()     # Popen holds its own copy of the descriptor
    except (faults.SimulatedLaunchFailure, OSError) as e:
        # A typed re-raise for the committed backoff and retry policy.
        raise LaunchError(
            f"launch of worker {index}/{world} failed on attempt "
            f"{attempt}: {e}") from e
    return WorkerHandle(index=index, world=world, proc=proc,
                        log_path=log_path,
                        resume=str(resume) if resume is not None else None,
                        launch_attempts=attempt + 1)


def launch_with_backoff(spec_path, index: int, world: int, out_dir, *,
                        resume: Optional[object] = None,
                        coordinator_address: Optional[str] = None,
                        extra_env: Optional[dict] = None,
                        on_backoff: Optional[Callable[[int, float, str],
                                                      None]] = None,
                        sleep: Callable[[float], None] = time.sleep
                        ) -> WorkerHandle:
    """Spawn a worker under the committed retry rule: up to
    ``policy.LAUNCH_RETRY_BUDGET`` attempts, sleeping the deterministic
    ``policy.backoff_delay_s(attempt)`` between failures.  Each failure is
    reported through ``on_backoff(attempt, delay_s, error)`` (the
    autopilot's ``launch-backoff`` decision); when the budget is spent the
    last :class:`LaunchError` is raised again."""
    last: Optional[LaunchError] = None
    for attempt in range(policy.LAUNCH_RETRY_BUDGET):
        try:
            return launch_worker(
                spec_path, index, world, out_dir, resume=resume,
                attempt=attempt, coordinator_address=coordinator_address,
                extra_env=extra_env)
        except LaunchError as e:
            last = e
            if attempt == policy.LAUNCH_RETRY_BUDGET - 1:
                raise
            delay = policy.backoff_delay_s(attempt)
            if on_backoff is not None:
                on_backoff(attempt, delay, str(e))
            sleep(delay)
    raise last  # pragma: no cover -- the loop raises above
