"""Setting up the ranks: one process per GPU, over ``torch.distributed``.

Counterpart of ``kmeans_tpu/parallel/multihost.py``.  Every rank runs the
same program over the global mesh; every statistic the loops read (sums,
counts, SSE) comes back replicated by the mesh's ``all_reduce``, so each
rank computes the same centroid update and the same convergence decision
and no other coordination is needed.

Typical entry, one process per GPU::

    from kmeans_tpu_torch.parallel import multihost
    from kmeans_tpu_torch.parallel.mesh import make_mesh
    multihost.initialize("tcp://10.0.0.1:29500", world_size=8, rank=r)
    km = KMeans(k=1024, mesh=make_mesh())   # or mesh=None: the same mesh
    km.fit(X)                               # every rank passes the same X

or ``sharding.from_process_local(X_local, mesh)`` where each rank loads only
its own rows.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as tdist

from kmeans_tpu_torch.obs import trace as _obs_trace
from kmeans_tpu_torch.parallel import mesh as _mesh

#: Variables that say this process is one rank of a job launched by a
#: cluster tool (torchrun, Slurm, MPI).
_CLUSTER_ENV_VARS = ("MASTER_ADDR", "TORCHELASTIC_RUN_ID", "SLURM_JOB_ID",
                     "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")


def _cluster_env_present() -> bool:
    return any(os.environ.get(v) for v in _CLUSTER_ENV_VARS)


def _local_rank(rank: int) -> int:
    """The rank's card on its host: ``LOCAL_RANK`` where a launcher set
    it, else the rank modulo the host's card count."""
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group``, and each rank bound to its
    card (``torch.cuda.set_device``) before any kernel is built or launched.

    Does nothing when the group is already up, or when the program runs as
    one process: no coordinates passed and no cluster environment.  Where
    coordinates were passed, or the environment names a cluster job, a
    failed set-up raises: every rank silently fitting alone would be a
    wrong result, not a slower one.  ``backend`` defaults to NCCL where
    CUDA is available and gloo on the CPU; a world of NCCL ranks may
    capture its collectives in CUDA graphs (the device loop), for which
    NCCL's asynchronous error handling is turned off unless the caller set
    it."""
    if tdist.is_initialized():
        return
    explicit = any(a is not None for a in (init_method, world_size, rank))
    if not explicit and not _cluster_env_present():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if torch.cuda.is_available() and rank is not None:
        torch.cuda.set_device(_local_rank(rank))
    kwargs = {"backend": backend}
    if init_method is not None:
        kwargs["init_method"] = init_method
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    tdist.init_process_group(**kwargs)


def is_primary() -> bool:
    """True on the process that owns logging and file writes (rank 0 of
    the world; the only process without a group)."""
    return _mesh.is_primary(None)


def fleet_barrier(tag: str = "fit-start", mesh=None) -> None:
    """The clock anchor of merged timelines (the reference's): a barrier
    over the ranks of ``mesh`` (of the world without one) inside a
    ``collective`` span, then a ``fleet.barrier`` event, which
    ``obs.fleet.merge_traces`` aligns the ranks' clocks on.  The fits call
    it where the reference's do, at a fit's or a stream's start.

    With no tracer installed it returns after one ``None`` check: no
    barrier, no record.  So a trace is installed on every rank or on none,
    as in the reference: a rank that traced alone would wait here.  A
    world of one rank waits for nobody; its event says ``synced=False``
    (a sequence marker, which the merge does not align on)."""
    if _obs_trace.get_tracer() is None:
        return
    synced = False
    if _mesh.world_size() > 1 and _mesh.in_mesh(mesh):
        with _obs_trace.span("collective", op="barrier",
                             site=f"fleet_barrier:{tag}"):
            _mesh.barrier(mesh)
        synced = True
    _obs_trace.event("fleet.barrier", tag=tag, synced=synced)
