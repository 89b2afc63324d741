"""One host of an autopilot-supervised fleet.

Counterpart of ``kmeans_tpu/orchestrator/worker.py``.  Spawned by
``orchestrator.launcher`` as ``python -m
kmeans_tpu_torch.orchestrator.worker --spec ... --index i --world n --out
dir [--resume ckpt] [--coordinator-address tcp://host:port]``.  The
worker:

1. takes its fleet identity from the environment the launcher set (the
   simulated ``KMEANS_TPU_*`` overrides), or joins a ``torch.distributed``
   world through ``parallel.multihost.initialize`` (rank ``i`` of ``n``)
   when it is given a coordinator;
2. arms the deterministic fault injections the shared spec asks for
   (``utils.faults``: the fit's own code paths, never mocks);
3. runs ``KMeans(...).fit(X, resume=..., checkpoint_every=...,
   checkpoint_path=<out>/ckpt.p<i>.npz)`` on the spec's ``device`` under
   per-process heartbeat and trace sinks; and
4. reports through the typed exit codes
   (``policy.EXIT_DONE`` / ``EXIT_PREEMPTED`` / ``EXIT_CKPT_CORRUPT``)
   and the files ``centroids.p<i>.npy`` / ``result.p<i>.json``.

Spec schema (JSON), the reference's with ``device``::

    {"k": 4, "max_iter": 8, "tolerance": 1e-30, "seed": 0,
     "dtype": "float64",            # float64: bit-exact resume parity
     "device": "cpu",               # default: the card
     "checkpoint_every": 1,
     "data_npy": "X.npy",           # or "synthetic": {n, d, kind, seed}
     "devices_per_host": 1,         # only 1: one process per rank
     "mesh": false,                 # a data mesh over the world's ranks
     "compute_sse": true,
     "faults": {                    # all optional, all deterministic
       "kill": {"process_index": 1, "after_iteration": 2,
                "tear": "none"|"primary"|"both"},
       "slow": {"process_index": 1, "after_iteration": 2,
                "seconds": 600.0}}}

``devices_per_host`` other than 1 is refused: the reference gives a host
process several XLA devices, the port runs one process per rank (one
card each).  Kill faults fire once per index across relaunches: firing
drops a latch file (``fault.kill.p<i>.latch``) in the out dir, and a
relaunched worker at the same index sees the latch and does not arm again.
``tear`` models a preemption that also tore the checkpoint mid-copy: after
the kill, the primary file (with ``"both"`` the ``.prev`` rotation too) is
overwritten with garbage, so the relaunch runs the real
``load_state_with_fallback`` classification.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from pathlib import Path


def check_spec(spec: dict) -> None:
    """Refuse what the port's worker does not run: ``devices_per_host``
    other than 1 (one process per rank, one card each)."""
    per_host = int(spec.get("devices_per_host", 1))
    if per_host != 1:
        raise ValueError(
            f"devices_per_host={per_host}: the port runs one process per "
            f"rank, one card each; launch a world of that many workers "
            f"instead")


def _load_data(spec, np):
    if spec.get("data_npy"):
        return np.load(spec["data_npy"])
    syn = spec["synthetic"]
    from kmeans_tpu_torch.data.synthetic import host_equivalent
    kind = syn.get("kind", "uniform")
    centers = None
    if kind == "blobs":
        # Well-separated centres from the spec alone, so every incarnation
        # of every worker makes the same data.
        k = int(syn.get("centers_k", spec.get("k", 3)))
        centers = np.asarray(
            np.random.default_rng(int(syn.get("seed", 0)))
            .uniform(-6.0, 6.0, size=(k, int(syn["d"]))))
    return host_equivalent(int(syn["n"]), int(syn["d"]),
                           kind=kind, seed=int(syn.get("seed", 0)),
                           centers=centers)


def _tear(path, mode: str) -> None:
    """Overwrite checkpoint file(s) with garbage: the deterministic stand-in
    for a write torn by the preemption."""
    from kmeans_tpu_torch.utils.checkpoint import prev_path
    targets = [Path(path)]
    if mode == "both":
        targets.append(prev_path(path))
    for t in targets:
        if t.exists():
            t.write_bytes(b"torn checkpoint (injected)")


def build_model(spec: dict, mesh=None):
    """The spec's ``KMeans``: host loop, no labels, the spec's dtype and
    device (the card by default)."""
    import numpy as np

    from kmeans_tpu_torch import KMeans
    dtype = np.float64 if spec.get("dtype") == "float64" else None
    return KMeans(k=int(spec["k"]), max_iter=int(spec.get("max_iter", 100)),
                  tolerance=float(spec.get("tolerance", 1e-4)),
                  seed=int(spec.get("seed", 0)),
                  compute_sse=bool(spec.get("compute_sse", True)),
                  empty_cluster=spec.get("empty_cluster", "keep"),
                  dtype=dtype, mesh=mesh, host_loop=True,
                  compute_labels=False, verbose=False,
                  device=spec.get("device"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kmeans_tpu_torch.orchestrator.worker")
    ap.add_argument("--spec", required=True)
    ap.add_argument("--index", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--coordinator-address", default=None)
    args = ap.parse_args(argv)

    spec = json.loads(Path(args.spec).read_text())
    check_spec(spec)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    import numpy as np

    from kmeans_tpu_torch import obs
    from kmeans_tpu_torch.orchestrator import policy
    from kmeans_tpu_torch.utils import faults
    from kmeans_tpu_torch.utils.checkpoint import CheckpointCorruptError

    if args.coordinator_address:
        from kmeans_tpu_torch.parallel.multihost import initialize
        initialize(args.coordinator_address, world_size=args.world,
                   rank=args.index)

    X = _load_data(spec, np)
    mesh = None
    if spec.get("mesh"):
        from kmeans_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh()
    km = build_model(spec, mesh)

    ckpt = policy.checkpoint_path(out, args.index)
    fspec = spec.get("faults") or {}
    kill = fspec.get("kill")
    slow = fspec.get("slow")
    latch = out / f"fault.kill.p{args.index}.latch"

    stack = contextlib.ExitStack()
    with stack:
        if kill and int(kill["process_index"]) == args.index \
                and not latch.exists():
            stack.enter_context(faults.inject_host_kill(
                args.index,
                after_iteration=int(kill.get("after_iteration", 0))))
        if slow and int(slow["process_index"]) == args.index:
            stack.enter_context(faults.inject_checkpoint_delay(
                float(slow.get("seconds", 600.0)),
                after_iteration=int(slow.get("after_iteration", 0))))
        stack.enter_context(obs.tracing(out / "trace.jsonl",
                                        per_process=True))
        stack.enter_context(obs.heartbeat(out / "hb.jsonl",
                                          per_process=True))
        try:
            km.fit(X, resume=args.resume or False,
                   checkpoint_every=int(spec.get("checkpoint_every", 1)),
                   checkpoint_path=ckpt)
        except faults.SimulatedPreemption:
            # The typed exit code is the route: the supervisor classifies
            # it against the committed relaunch budget.  The latch first,
            # so a resumed worker at this index is not preempted again.
            latch.touch()
            if kill and kill.get("tear", "none") != "none":
                _tear(ckpt, kill["tear"])
            return policy.EXIT_PREEMPTED
        except CheckpointCorruptError:
            # Both rotations of the resume source are torn: the typed exit
            # of the supervisor's give-up rule.
            return policy.EXIT_CKPT_CORRUPT

    np.save(out / f"centroids.p{args.index}.npy",
            np.asarray(km.centroids))
    result = {"index": args.index, "world": args.world,
              "iterations_run": int(km.iterations_run),
              "sse": (float(km.sse_history[-1])
                      if km.sse_history else None),
              "resumed_from": args.resume}
    (out / f"result.p{args.index}.json").write_text(json.dumps(result))
    print(f"worker {args.index}/{args.world} done "
          f"({km.iterations_run} iterations)", flush=True)
    return policy.EXIT_DONE


def _exit(code: int) -> None:
    """Leave the process with ``code``.  A worker that did not finish
    (preempted, or its resume state torn) ends at once, without the
    interpreter's teardown, as the preemption it stands for would end it:
    on the card the CUDA context's teardown takes a second or more, and a
    process still alive past its last mid-fit beat for that long reads as
    a stall (``obs.fleet``'s committed 1 s floor) before the supervisor
    reaps its exit.  Its trace and heartbeat sinks are closed already."""
    if code != 0:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    sys.exit(code)


if __name__ == "__main__":
    _exit(main())
