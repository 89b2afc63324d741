"""The elastic autopilot: the supervising loop that keeps a distributed fit
running through preemption, stragglers, torn checkpoints and launch flakes.

Counterpart of ``kmeans_tpu/orchestrator/``.  Its layers, each importable
alone:

* :mod:`~kmeans_tpu_torch.orchestrator.policy`: the committed, typed
  decision rules (every threshold, budget and backoff step a module
  constant; pure functions; :class:`AutopilotGaveUpError`);
* :mod:`~kmeans_tpu_torch.orchestrator.launcher`: typed worker spawning (a
  simulated fleet's identity environment, or a ``torch.distributed``
  ``init_method``) with the bounded deterministic exponential retry;
* :mod:`~kmeans_tpu_torch.orchestrator.worker`: one host's entry point,
  ``fit(resume=)`` under per-process sinks and the typed exit codes;
* :mod:`~kmeans_tpu_torch.orchestrator.autopilot`: the loop itself.

Exit codes of ``python -m kmeans_tpu_torch autopilot``: 0 converged, 1
degraded but done, 2 gave up.
"""

from kmeans_tpu_torch.orchestrator.autopilot import (Autopilot,
                                                     AutopilotResult,
                                                     run_autopilot)
from kmeans_tpu_torch.orchestrator.launcher import (LaunchError,
                                                    WorkerHandle,
                                                    launch_with_backoff,
                                                    launch_worker)
from kmeans_tpu_torch.orchestrator.policy import (AutopilotGaveUpError,
                                                  Decision, backoff_delay_s,
                                                  classify_exit,
                                                  select_resume)

__all__ = [
    "Autopilot", "AutopilotResult", "run_autopilot",
    "LaunchError", "WorkerHandle", "launch_worker",
    "launch_with_backoff",
    "AutopilotGaveUpError", "Decision", "backoff_delay_s",
    "classify_exit", "select_resume",
]
