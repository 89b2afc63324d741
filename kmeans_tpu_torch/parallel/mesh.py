"""The (data, model) mesh over the ranks of a ``torch.distributed`` world.

Counterpart of ``kmeans_tpu/parallel/mesh.py``.  There the cluster is a
``jax.sharding.Mesh`` of devices driven by one program; here it is a
``torch.distributed.device_mesh.DeviceMesh`` of ranks, one process per GPU
(``parallel.multihost.initialize``), every rank running the same program.
Ranks are laid out row-major, rank = data index * model + model index, the
reference's ``reshape(data, model)``.

Every collective of the package is an ``all_reduce`` over one axis group of
the mesh (:func:`all_reduce`): NCCL takes it on CUDA tensors, and so does gloo
(which has no ``all_gather`` for CUDA tensors), and gloo on CPU tensors; no
path depends on the backend.  The one exception is the serving path's
decisions on a mesh of more than one rank (:func:`share`): a SUM
``all_reduce`` of a small int64 vector on a gloo group of every rank of the
mesh (:func:`decision_group`), kept apart from the axis groups so that a
rank waiting for the next decision holds none of them.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

DATA_AXIS = "data"    # shards the N points (the reference's partitions)
MODEL_AXIS = "model"  # shards the k centroids (optional)
AXES = (DATA_AXIS, MODEL_AXIS)


def group_up() -> bool:
    """Whether a ``torch.distributed`` process group is initialized."""
    return tdist.is_available() and tdist.is_initialized()


def world_size() -> int:
    """Ranks of the initialized world; 1 when no process group is up."""
    return tdist.get_world_size() if group_up() else 1


def make_mesh(data: Optional[int] = None, model: int = 1,
              ranks: Optional[Sequence[int]] = None):
    """A (data, model) ``DeviceMesh`` over the ranks of the world.

    ``data=None`` takes every rank not consumed by ``model``.  ``ranks``
    (the JAX package's ``devices``) picks the ranks the mesh may use, the
    first ``data * model`` of them; the default is the whole world.  Every
    rank of the world must call this (it creates the axis groups), also
    ranks that the mesh leaves out: for them the mesh has no coordinate
    and they wait.  Needs an initialized process group
    (``multihost.initialize``), also for a world of one rank."""
    pool = list(ranks) if ranks is not None else list(range(world_size()))
    n = len(pool)
    if model <= 0:
        raise ValueError(f"model axis size must be positive, got {model}")
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model={model}")
    if data is None:
        data = n // model
    if data <= 0:
        raise ValueError(f"data axis size must be positive, got {data}")
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data*model} devices, "
                         f"have {n}")
    if not group_up():
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed process "
            "group: call kmeans_tpu_torch.parallel.multihost.initialize() "
            "first (one process per GPU), or use mesh=None on one device")
    grid = torch.tensor(pool[: data * model], dtype=torch.int64).reshape(
        data, model)
    device_type = "cuda" if tdist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, grid, mesh_dim_names=AXES)


def check_mesh(mesh):
    """``mesh`` as a model's argument: None, or a ``DeviceMesh`` with the
    axes ("data", "model")."""
    if mesh is None:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh) or \
            tuple(mesh.mesh_dim_names or ()) != AXES:
        raise TypeError(f"mesh must be a DeviceMesh with the axes {AXES} "
                        f"(parallel.mesh.make_mesh), got {mesh!r}")
    return mesh


def mesh_shape(mesh) -> Tuple[int, int]:
    """(data, model) axis sizes; (1, 1) for the un-meshed single device."""
    if mesh is None:
        return (1, 1)
    return (mesh.size(0), mesh.size(1))


def coords(mesh) -> Tuple[int, int]:
    """This rank's (data index, model index); (0, 0) without a mesh.
    Raises on a rank that the mesh leaves out."""
    if mesh is None:
        return (0, 0)
    c = mesh.get_coordinate()
    if c is None:
        raise ValueError(f"rank {tdist.get_rank()} is not in this mesh")
    return (int(c[0]), int(c[1]))


def in_mesh(mesh) -> bool:
    """Whether this rank holds a coordinate of ``mesh`` (always without)."""
    return mesh is None or mesh.get_coordinate() is not None


_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}

#: Payload bytes and calls of every ``all_reduce`` on an axis group so far
#: (the bill ``obs.cost`` records and ``obs.fleet.comm_crosscheck`` reads).
#: A captured device loop takes the capture's share back and adds it at
#: each replay, as it does for the kernels' launch counts.
COLLECTIVES = {"bytes": 0, "count": 0}


def count_collectives(nbytes: int, count: int = 1) -> None:
    COLLECTIVES["bytes"] += int(nbytes)
    COLLECTIVES["count"] += int(count)


def all_reduce(t: torch.Tensor, mesh, axes: Sequence[str] = AXES,
               op: str = "sum") -> torch.Tensor:
    """``t`` reduced in place over the named axes of ``mesh`` (each axis one
    ``all_reduce`` on its group, the model axis first), and returned.  The
    data axis always reduces, also at size 1, so a world of one rank runs
    the same collectives as a larger one; the model axis only where it has
    more than one rank.  Without a mesh ``t`` is returned as it is.  Each
    call on a group adds its payload to :data:`COLLECTIVES`."""
    if mesh is None:
        return t
    red = getattr(tdist.ReduceOp, _OPS[op])
    for axis in (MODEL_AXIS, DATA_AXIS):
        if axis not in axes:
            continue
        if axis == MODEL_AXIS and mesh.size(1) == 1:
            continue
        tdist.all_reduce(t, op=red, group=mesh.get_group(axis))
        count_collectives(t.numel() * t.element_size())
    return t


#: Calls and payload bytes of the serving path's decision exchanges
#: (:func:`share`), kept apart from :data:`COLLECTIVES`, the fits' bill.
DECISIONS = {"bytes": 0, "count": 0}

#: Values that travel in the first exchange of :func:`share` (more take a
#: second one).
SHARE_WIDTH = 7


#: Released decision groups by their ranks, with the world they belong to:
#: :func:`decision_group` takes one back before it makes another.
_IDLE_GROUPS: dict = {}
_IDLE_LOCK = threading.Lock()


def decision_group(mesh):
    """A gloo group of every rank of ``mesh``, for :func:`share`: the
    decisions travel in host memory, and a rank waiting for the next one
    holds none of the mesh's own groups (another thread of the rank may use
    them meanwhile, for a fit on the same world).  Made by the mesh's ranks
    only, in the same order on each.  A group given back by
    :func:`release_group` is taken again before a new one is made: every
    rank holds the same idle groups in the same order, since each made and
    released its groups in the same order (the serving path's SPMD
    contract).  A group is never destroyed: torch names a group made by
    some of the ranks after the groups alive, so a new group after a
    destroyed one would meet the destroyed one's addresses in the store."""
    ranks = tuple(sorted(int(r) for r in mesh.mesh.flatten().tolist()))
    with _IDLE_LOCK:
        world, idle = _IDLE_GROUPS.get(ranks, (None, []))
        if world is tdist.group.WORLD and idle:
            return idle.pop()
    return tdist.new_group(ranks=list(ranks), backend="gloo",
                           use_local_synchronization=True)


def release_group(mesh, group) -> None:
    """Give back a group of :func:`decision_group` whose exchanges all
    ended on every rank (its sequencer stopped cleanly)."""
    ranks = tuple(sorted(int(r) for r in mesh.mesh.flatten().tolist()))
    with _IDLE_LOCK:
        world, idle = _IDLE_GROUPS.get(ranks, (None, []))
        if world is not tdist.group.WORLD:
            idle = []
        idle.append(group)
        _IDLE_GROUPS[ranks] = (tdist.group.WORLD, idle)


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    """A SUM ``all_reduce`` of ``t`` over ``group``, counted in
    :data:`DECISIONS`."""
    tdist.all_reduce(t, op=tdist.ReduceOp.SUM, group=group)
    DECISIONS["bytes"] += t.numel() * t.element_size()
    DECISIONS["count"] += 1
    return t


def share(values, mesh, group) -> list:
    """Rank (0, 0)'s list of ints on every rank of ``mesh``: ``values`` is
    read on the primary rank only (elsewhere pass None, or anything).  The
    decision travels as a SUM ``all_reduce`` over ``group``
    (:func:`decision_group`: every rank of the mesh, on the host) of an
    int64 vector that is zero on every other rank: its length and its first
    :data:`SHARE_WIDTH` values in one exchange, the rest in a second.  Every
    rank must call it at the same point of its sequence of collectives."""
    head = torch.zeros(SHARE_WIDTH + 1, dtype=torch.int64)
    vals = [int(v) for v in values] if is_primary(mesh) else []
    if vals:
        head[0] = len(vals)
        first = vals[:SHARE_WIDTH]
        head[1:1 + len(first)] = torch.tensor(first, dtype=torch.int64)
    head = _exchange(head, group).tolist()
    n = head[0]
    out = head[1:1 + min(n, SHARE_WIDTH)]
    if n > SHARE_WIDTH:
        rest = torch.zeros(n - SHARE_WIDTH, dtype=torch.int64)
        if vals:
            rest[:] = torch.tensor(vals[SHARE_WIDTH:], dtype=torch.int64)
        out += _exchange(rest, group).tolist()
    return out


def is_primary(mesh) -> bool:
    """True on the rank at (0, 0) of ``mesh`` (on rank 0 without one): the
    rank that writes a model's files."""
    if mesh is None:
        return not group_up() or tdist.get_rank() == 0
    return coords(mesh) == (0, 0)


def barrier(mesh) -> None:
    """Wait for every rank of ``mesh`` (of the world without one; nothing
    without a process group): an ``all_reduce`` of one zero over both
    axes."""
    if mesh is None:
        if group_up():
            tdist.barrier()
        return
    device = (torch.device("cuda", torch.cuda.current_device())
              if tdist.get_backend() == "nccl" else torch.device("cpu"))
    all_reduce(torch.zeros(1, device=device), mesh)
