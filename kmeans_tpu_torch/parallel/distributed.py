"""The training, predict and transform passes, on one device or a mesh.

Counterpart of ``kmeans_tpu/parallel/distributed.py``
(``_weighted_sqnorm_total``, ``_sse_from_stats``, ``pad_centroids``,
``_pallas_local_stats``, the chunk scan of ``_local_stats``,
``make_step_fn``, ``make_predict_fn``, ``make_fit_fn``,
``_empty_seed_array`` and ``_refill_empty_slots``, ``make_transform_fn``,
``_check_guarded``, ``make_multi_fit_fn`` (its
``_refill_empty_slots_batched`` is ``_MultiLoop._refill``),
``make_multi_predict_fn``, ``_project_centroids``, and the mini-batch
engines ``_check_minibatch_mode``, ``make_minibatch_step_fn``,
``_sample_batch``, ``_batch_candidates``, ``apply_reassignment`` and
``make_minibatch_fit_fn``).

``mode='kernel'`` runs the fused CUDA kernel of ``ops.hopper_kernels`` (its
plain version when the tensors lie on the CPU) and ``'kernel_bf16'`` its bf16
tensor-core kernel; ``'matmul'``, ``'matmul_bf16'`` and ``'direct'`` run the
chunked torch pass of ``ops.assign``.  The kernels are a float32 engine:
float64 points and centroids reach them as float32 casts, as in the JAX
package (``pallas_kernels._pad_inputs``), and their sums and counts come back
in the points' type.

Under a (data, model) mesh (``parallel.mesh``) every builder takes the mesh
first and each rank works on its block of a ``sharding.ShardedDataset``:

* ``model == 1``: the rank's step is the one-device step on its block
  (kernel 1 or 1b in the kernel modes);
* ``model > 1``: the centroid table is padded with sentinel rows
  (:func:`pad_centroids`) and each rank scores its block of the rows
  against its block of the table with the assignment kernel (kernel 2 or
  2b, or the torch pass); the global winner is the smallest distance over
  the model axis, the lowest block among equal ones (:func:`_owner`); then
  an ownership-masked one-hot scatter in torch ops sums the rows a block
  owns (the fused kernel cannot: it would add rows whose winner lies in
  another block).

The statistics are then reduced over both axes, all of them with
``all_reduce`` (``mesh.all_reduce``): sums, counts and SSE by SUM in one
packed buffer, the SSE divided by ``model``; the farthest point by MAX, the
lowest rank among equal maxima by MIN, its row by SUM.  Every rank gets the
same statistics, as the reference's replicated ``out_specs`` say.

:func:`make_fit_fn` is the device loop (``KMeans(host_loop=False)``): every
iteration's step, mean division, empty-cluster refill and convergence test
run on the device, with no value read to the host inside an iteration.  On a
CUDA device one iteration is captured once as a ``torch.cuda.CUDAGraph`` and
replayed, the NCCL collectives of a mesh inside it; on the CPU the same
iteration runs eagerly (over gloo).  :func:`make_multi_fit_fn` runs R fits
(restarts, or the members of a sweep over k) in one such loop: one graph per
iteration holds every member.

The guarded bf16 rung (``'matmul_bf16_guarded'``, ``ops.assign``) is a
torch mode: its step, predict and device loop run the chunked pass with the
guard; it refuses a model axis and 'farthest' (:func:`_check_guarded`).

Both device loops take ``project='sphere'`` (``SphericalKMeans``): every
real centroid row is put back on the unit sphere after the mean update and
the refill (:func:`project_centroids`).  :func:`make_minibatch_fit_fn` is
the mini-batch (Sculley) loop: each iteration draws its batch on the device
from ``(seed, iteration)`` by integer hashing (:func:`minibatch_rows`), so
the draws need no generator and no read to the host, and a captured
iteration replays them; under a mesh each rank draws its share of the
batch from its own block, as in the JAX package, and the statistics and the
reassignment candidates are reduced over the data axis.

A loop kept in a dataset's memo holds no reference to the dataset (its row
gather is a weak method), so a dataset that is dropped frees its loops and
their captured graphs at once.  Every loop counts its iterations from any
start to any stop, so a segment of a checkpointed fit, or a resumed fit,
replays the graph captured for the dataset; a loop whose first run fails
before its capture leaves the memo (the out-of-memory backoff's replay
then builds its own).
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from kmeans_tpu_torch.obs import cost as _cost
from kmeans_tpu_torch.obs import trace as _obs_trace
from kmeans_tpu_torch.ops import _build
from kmeans_tpu_torch.ops.assign import (GUARDED_MODE, StepStats,
                                         _accum_dtype, assign_chunk,
                                         assign_labels, init_stats,
                                         margin_chunk, pairwise_sq_dists,
                                         reduce_chunks, round_bf16,
                                         value_mode)
from kmeans_tpu_torch.ops.hopper_kernels import (fused_assign_reduce,
                                                 hopper_assign)
from kmeans_tpu_torch.parallel.mesh import (AXES, COLLECTIVES, DATA_AXIS,
                                            MODEL_AXIS, all_reduce, coords,
                                            count_collectives, mesh_shape)
from kmeans_tpu_torch.parallel.sharding import (Dataset, draw_keys,
                                                permuted_draws)

KERNEL_MODES = ("kernel", "kernel_bf16")
TORCH_MODES = ("matmul", "matmul_bf16", "direct", GUARDED_MODE)


#: Iterations the device loop keeps in flight on the card: the host reads
#: the done flag of iteration i - IN_FLIGHT while iteration i is queued.
#: The iterations queued past convergence change nothing (they are masked)
#: but take their time on the card.  0 by measurement on an H100: at the
#: GloVe-like shape (7.4 ms iterations) each masked iteration cost more
#: than the host's wait for each flag (PERF.md, PR 11).
IN_FLIGHT = 0

#: Iterations captured as CUDA graphs, by loop class: a later fit on the
#: same dataset, a segment of a checkpointed fit and a resumed fit replay
#: the graph already captured and add nothing here.
CAPTURES: Dict[str, int] = {}


def _weighted_sqnorm_total(points: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """The first term of :func:`_sse_from_stats`: ``sum_i w_i ||x_i||^2``."""
    x = points.to(torch.float32)
    return (weights.to(torch.float32) * (x * x).sum(dim=1)).sum()


def dataset_sqnorm(ds: Dataset) -> torch.Tensor:
    """``sum w ||x||^2`` of a dataset, computed at its first use and kept
    beside it: it does not change while the points and weights do not."""
    return ds.memo("weighted_sqnorm_total",
                   lambda: _weighted_sqnorm_total(ds.points, ds.weights))


def _sse_from_stats(x2w, centroids, sums, counts, acc) -> torch.Tensor:
    """SSE derived algebraically from the pass statistics:

        SSE = sum_i w_i ||x_i||^2  -  2 sum_k <c_k, S_k>  +  sum_k n_k ||c_k||^2

    (expand ||x - c_{b(i)}||^2 and group by cluster; S_k / n_k are the
    weighted per-cluster sums and counts).  Costs O(k*D) instead of a reduce
    over the kernel's per-point ``mind2``.  Clamped at 0: the difference of
    large terms can go tiny-negative near a perfect fit."""
    c = centroids.to(torch.float32)
    cross = (c * sums.to(torch.float32)).sum()
    cnorm = (counts.to(torch.float32) * (c * c).sum(dim=1)).sum()
    return torch.clamp_min(x2w - 2.0 * cross + cnorm, 0.0).to(acc)


#: Elements of the (rows, k) one-hot tile of :func:`cluster_sums`.
CLUSTER_SUM_ELEMS = 1 << 24


def cluster_sums(labels: torch.Tensor, values: torch.Tensor,
                 k: int) -> torch.Tensor:
    """``values`` summed per label 0..k-1, in an order that does not depend
    on the device's scheduling: a one-hot product per block of rows (the
    rule of ``ops.assign.consume_chunk``), the blocks in row order.  An
    ``index_add_`` on the card adds in the order its atomics land, so two
    runs could differ in the last bits, and the bisecting tree compares
    these sums to pick its next split."""
    n = labels.shape[0]
    out = torch.zeros((k,), dtype=values.dtype, device=values.device)
    ids = torch.arange(k, device=labels.device)
    rows = max(1, CLUSTER_SUM_ELEMS // max(k, 1))
    for lo in range(0, n, rows):
        onehot = (labels[lo:lo + rows].to(torch.int64)[:, None]
                  == ids[None, :]).to(values.dtype)
        out += onehot.T @ values[lo:lo + rows]
    return out


def _kernel_local_stats(points, weights, centroids, *, bf16: bool = False,
                        need_sse: bool = True, need_farthest: bool = True,
                        need_sse_pc: bool = True, x2w=None) -> StepStats:
    """One pass through the fused kernel (its bf16 form with ``bf16``), then
    the statistics it does not produce itself, in torch ops on (n,) and
    (k, D) tensors.  The per-point ``mind2`` is only asked of the kernel
    when something reads it."""
    acc = _accum_dtype(points.dtype)
    k, d = centroids.shape
    w = weights.to(torch.float32)
    need_point = need_farthest or need_sse_pc or (need_sse and x2w is None)
    labels, mind2, sums, counts = fused_assign_reduce(
        points.to(torch.float32), w, centroids.to(torch.float32), bf16=bf16,
        with_mind2=need_point)
    zero = init_stats(k, d, acc, points.device)
    if not need_sse:
        sse = zero.sse
    elif x2w is not None:
        sse = _sse_from_stats(x2w, centroids, sums, counts, acc)
    else:
        sse = (mind2 * w).sum().to(acc)
    if need_sse_pc:
        sse_pc = cluster_sums(labels, (mind2 * w).to(acc), k)
    else:
        sse_pc = zero.sse_per_cluster
    if need_farthest:
        live = w > 0
        masked = torch.where(live, mind2, torch.full_like(mind2,
                                                          float("-inf")))
        # index_select, not [i]: a tensor index would read it to the host,
        # which a captured graph cannot do.
        i = torch.argmax(masked).reshape(1)
        far = masked.index_select(0, i)[0]
        far_d = torch.where(live.any(), far,
                            torch.full_like(far, -1.0)).to(acc)
        far_p = points.index_select(0, i)[0].to(acc)
    else:
        far_d, far_p = zero.farthest_dist, zero.farthest_point
    return StepStats(sums.to(acc), counts.to(acc), sse, far_d, far_p, sse_pc)


def local_stats(points, weights, centroids, *, chunk_size: int, mode: str,
                need_sse: bool = True, need_farthest: bool = True,
                need_sse_pc: bool = True, x2w=None, pipeline: int = 0):
    """The statistics of one pass over the device's points, and the
    guarded rung's flagged rows (int32 0 in every other mode):
    ``(StepStats, flagged)``.  ``pipeline`` picks the chunk schedule of the
    torch modes (``ops.assign.assign_reduce``); the kernel modes ignore
    it."""
    if mode in KERNEL_MODES:
        return _kernel_local_stats(
            points, weights, centroids, bf16=mode == "kernel_bf16",
            need_sse=need_sse,
            need_farthest=need_farthest, need_sse_pc=need_sse_pc,
            x2w=x2w), torch.zeros((), dtype=torch.int32,
                                  device=points.device)
    if mode not in TORCH_MODES:
        raise ValueError(f"unknown distance mode: {mode!r}")
    return reduce_chunks(points, weights, centroids, chunk_size=chunk_size,
                         mode=mode, need_sse=need_sse,
                         need_farthest=need_farthest,
                         need_sse_pc=need_sse_pc, pipeline=pipeline)


# ------------------------------------------------------------- model axis

#: Coordinate of the sentinel rows that pad the centroid table to a multiple
#: of the model axis: no real point ever picks one, and its squared norm
#: stays finite in float32.
PAD_CENTROID_VALUE = 1e12


def pad_centroids(centroids, model_shards: int):
    """The (k, D) table (array or tensor) padded with sentinel rows to a
    multiple of the model axis."""
    k, d = centroids.shape
    pad = (-k) % model_shards
    if pad == 0:
        return centroids
    if isinstance(centroids, torch.Tensor):
        return torch.cat([centroids, torch.full(
            (pad, d), PAD_CENTROID_VALUE, dtype=centroids.dtype,
            device=centroids.device)])
    filler = np.full((pad, d), PAD_CENTROID_VALUE, dtype=centroids.dtype)
    return np.concatenate([centroids, filler], axis=0)


def _model_block(centroids: torch.Tensor, mesh):
    """This rank's block of the padded table: ``(block, first row,
    padded k)``."""
    model_shards = mesh_shape(mesh)[1]
    padded = pad_centroids(centroids, model_shards)
    k_local = padded.shape[0] // model_shards
    first = coords(mesh)[1] * k_local
    return padded[first:first + k_local], first, padded.shape[0]


def _assign_block(points, block, *, mode: str, chunk_size: int):
    """Labels (int32, local to ``block``) and minimum squared distances of
    the rows against one block of the table: the assignment kernel (kernel
    2 or 2b) in the kernel modes, the chunked torch pass otherwise."""
    if mode in KERNEL_MODES:
        return hopper_assign(points.to(torch.float32),
                             block.to(torch.float32),
                             bf16=mode == "kernel_bf16")
    if mode not in TORCH_MODES:
        raise ValueError(f"unknown distance mode: {mode!r}")
    parts = [assign_chunk(points[lo:lo + chunk_size], block, mode=mode)
             for lo in range(0, points.shape[0], chunk_size)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _owner(mind2: torch.Tensor, mesh):
    """The global winner of each row over the model axis: ``(mine, gmin)``,
    ``mine`` true where this rank's block holds it.  The smallest distance
    by a MIN ``all_reduce``, then the lowest block index among the blocks
    that reach it by a second one: ``argmin``'s lowest-index rule, since the
    blocks are in table order."""
    m_idx, model_shards = coords(mesh)[1], mesh_shape(mesh)[1]
    gmin = all_reduce(mind2.clone(), mesh, (MODEL_AXIS,), "min")
    cand = torch.where(mind2 == gmin,
                       torch.full_like(mind2, m_idx, dtype=torch.int32),
                       torch.full_like(mind2, model_shards,
                                       dtype=torch.int32))
    owner = all_reduce(cand, mesh, (MODEL_AXIS,), "min")
    return owner == m_idx, gmin


def _model_axis_stats(points, weights, centroids, mesh, *, mode: str,
                      chunk_size: int, need_sse: bool, need_farthest: bool,
                      need_sse_pc: bool, embed: bool = True) -> StepStats:
    """The rank's statistics under centroid sharding, its block's sums,
    counts and per-cluster SSE embedded in the padded table (zeros
    elsewhere), or with ``embed=False`` the block's alone (the k-sharded
    step); the SSE is of the global minima (every block of a row counts
    it, the caller divides by the model axis)."""
    acc = _accum_dtype(points.dtype)
    block, first, k_pad = _model_block(centroids, mesh)
    k_local, d = block.shape
    labels, mind2 = _assign_block(points, block, mode=mode,
                                  chunk_size=chunk_size)
    mine, gmind2 = _owner(mind2, mesh)
    gmind2 = gmind2.to(acc)
    w = weights.to(acc)
    w_eff = w * mine.to(acc)
    bf16 = mode in ("kernel_bf16", "matmul_bf16")
    ids = torch.arange(k_local, device=points.device)
    k_table = k_pad if embed else k_local
    sums = torch.zeros((k_table, d), dtype=acc, device=points.device)
    counts = torch.zeros((k_table,), dtype=acc, device=points.device)
    sse_pc = torch.zeros((k_table,), dtype=acc, device=points.device)
    rows = slice(first, first + k_local) if embed else slice(0, k_local)
    # The one-hot rule of ops.assign.consume_chunk, chunk by chunk.
    for lo in range(0, points.shape[0], chunk_size):
        hi = lo + chunk_size
        onehot = (labels[lo:hi].to(torch.int64)[:, None] == ids[None, :]
                  ).to(acc) * w_eff[lo:hi, None]
        xc = points[lo:hi].to(acc)
        if bf16:
            sums[rows] += round_bf16(onehot, acc).T @ round_bf16(xc, acc)
        else:
            sums[rows] += onehot.T @ xc
        counts[rows] += onehot.sum(dim=0)
        if need_sse_pc:
            sse_pc[rows] += onehot.T @ gmind2[lo:hi]
    zero = init_stats(k_table, d, acc, points.device)
    sse = (gmind2 * w).sum() if need_sse else zero.sse
    if need_farthest:
        live = w > 0
        masked = torch.where(live, gmind2,
                             torch.full_like(gmind2, float("-inf")))
        i = torch.argmax(masked).reshape(1)
        far = masked.index_select(0, i)[0]
        far_d = torch.where(live.any(), far, torch.full_like(far, -1.0))
        far_p = points.index_select(0, i)[0].to(acc)
    else:
        far_d, far_p = zero.farthest_dist, zero.farthest_point
    return StepStats(sums, counts, sse, far_d, far_p, sse_pc)


def _reduce_stats(st: StepStats, mesh, k: int, *, need_sse_pc: bool,
                  need_farthest: bool) -> StepStats:
    """The statistics of every rank, replicated: sums, counts, SSE (and the
    per-cluster SSE) by one packed SUM ``all_reduce`` over both axes, the
    SSE divided by the model axis (each block of a row counted it); the
    farthest point by MAX, then the lowest rank among equal maxima (the
    reference's first maximum over its gather) by MIN, its row by SUM.
    The table is cut to its ``k`` real rows."""
    data_shards, model_shards = mesh_shape(mesh)
    k_pad, d = st.sums.shape
    parts = [st.sums.reshape(-1), st.counts, st.sse.reshape(1)]
    if need_sse_pc:
        parts.append(st.sse_per_cluster)
    flat = all_reduce(torch.cat(parts), mesh, AXES)
    sums = flat[: k_pad * d].reshape(k_pad, d)[:k]
    counts = flat[k_pad * d: k_pad * d + k_pad][:k]
    sse = flat[k_pad * d + k_pad]
    if model_shards > 1:
        sse = sse / model_shards
    sse_pc = (flat[k_pad * d + k_pad + 1:][:k] if need_sse_pc
              else st.sse_per_cluster[:k])
    far_d, far_p = st.farthest_dist, st.farthest_point
    if need_farthest:
        far_d, far_p = _reduce_farthest(far_d, far_p, mesh)
    return StepStats(sums, counts, sse, far_d, far_p, sse_pc)


def _reduce_farthest(far_d, far_p, mesh):
    """The farthest point over every rank: MAX of the distance, the lowest
    rank among equal maxima (the reference's first maximum over its
    gather) by MIN, its row by SUM."""
    data_shards, model_shards = mesh_shape(mesh)
    d_idx, m_idx = coords(mesh)
    rank = d_idx * model_shards + m_idx
    top = all_reduce(far_d.clone().reshape(1), mesh, AXES, "max")
    cand = torch.where(far_d.reshape(1) == top,
                       torch.full((1,), rank, dtype=torch.int64,
                                  device=far_d.device),
                       torch.full((1,), data_shards * model_shards,
                                  dtype=torch.int64, device=far_d.device))
    win = all_reduce(cand, mesh, AXES, "min")
    far_p = all_reduce(torch.where(win == rank, far_p,
                                   torch.zeros_like(far_p)), mesh, AXES)
    return top[0], far_p


def _check_guarded(mode: str, model_shards: int,
                   empty_policy: Optional[str] = None) -> None:
    """Where the guarded bf16 rung runs: not under a model axis, and not
    with the 'farthest' policy (the JAX package's rules and messages)."""
    if mode != GUARDED_MODE:
        return
    if model_shards > 1:
        raise ValueError(
            "distance_mode='matmul_bf16_guarded' requires a data-parallel "
            "mesh (model_shards == 1): the guard re-resolves near-tie "
            "rows against a full-precision distance pass, which has no "
            "TP (centroid-sharded) form — the same rejection the serving "
            "engine applies to quantize='bf16' under TP sharding")
    if empty_policy == "farthest":
        raise ValueError(
            "distance_mode='matmul_bf16_guarded' does not support "
            "empty_cluster='farthest': the farthest-point policy is an "
            "argmax over min-distance VALUES, which the guarded rung "
            "reproduces only to ~1 ulp (the rtol class), not bitwise; "
            "use 'keep' or 'resample' (label-exact by construction)")


@_cost.program()
def make_step_fn(mesh=None, *, chunk_size: int, mode: str = "matmul",
                 need_sse: bool = True, need_farthest: bool = True,
                 need_sse_pc: bool = True, pipeline: int = 0,
                 audit: bool = False) -> Callable:
    """The step: ``(points, weights, centroids, x2w=None) -> StepStats``,
    ``centroids`` the whole (k, D) table, the statistics those of every
    rank of ``mesh`` (of the one device without one).

    The ``need_*`` flags elide the statistics that the caller does not read
    (their fields keep their initial values); the kernel then writes no
    per-point distance unless the farthest point or the per-cluster SSE
    needs it.  In the kernel modes the SSE comes from the algebraic form
    (:func:`_sse_from_stats`), as in the JAX package's per-dispatch path: it
    does not inherit the low bias of a minimum over rounded distances; pass
    ``x2w``, the block's ``sum w ||x||^2`` (:func:`dataset_sqnorm`), or
    the step computes it.  In ``'kernel_bf16'`` the sums carry bf16-rounded
    products, so the SSE is of that class too (the JAX package's
    ``_sse_from_stats`` says the same).  Under centroid sharding the SSE is
    that of the global minima, as in the JAX package.

    ``audit=True`` makes the step return ``(StepStats, flagged)``, the
    guarded rung's flagged rows of the pass over every rank (int32, 0 in
    the other modes): the device loop's audit."""
    model_shards = mesh_shape(mesh)[1]
    _check_guarded(mode, model_shards)

    def step(points, weights, centroids, x2w=None):
        flagged = None
        if model_shards > 1:
            st = _model_axis_stats(
                points, weights, centroids, mesh, mode=mode,
                chunk_size=chunk_size, need_sse=need_sse,
                need_farthest=need_farthest, need_sse_pc=need_sse_pc)
        else:
            if mode in KERNEL_MODES and need_sse and x2w is None:
                x2w = _weighted_sqnorm_total(points, weights)
            st, flagged = local_stats(
                points, weights, centroids, chunk_size=chunk_size,
                mode=mode, need_sse=need_sse, need_farthest=need_farthest,
                need_sse_pc=need_sse_pc, x2w=x2w, pipeline=pipeline)
        if mesh is not None:
            st = _reduce_stats(st, mesh, centroids.shape[0],
                               need_sse_pc=need_sse_pc,
                               need_farthest=need_farthest)
        if not audit:
            return st
        if flagged is None:
            flagged = torch.zeros((), dtype=torch.int32,
                                  device=points.device)
        elif mesh is not None:
            flagged = all_reduce(flagged.clone(), mesh, AXES)
        return st, flagged

    return step


@_cost.program()
def make_predict_fn(mesh=None, *, chunk_size: int,
                    mode: str = "matmul") -> Callable:
    """The label assignment: ``(points, centroids) -> labels`` int32, one
    per row of ``points`` (the rank's block under a mesh), global indices
    into the table.  The kernel modes run the assignment-only kernel: the
    fused one would also scatter sums that nobody reads.  Under centroid
    sharding each block's winner is kept where it wins over the model axis
    (:func:`_owner`) and a SUM ``all_reduce`` of the labels, zero where a
    block lost, gives every rank of the axis the global label.  The guarded
    rung runs its guard here too (``ops.assign.assign_labels``)."""
    model_shards = mesh_shape(mesh)[1]
    _check_guarded(mode, model_shards)

    def predict(points, centroids) -> torch.Tensor:
        if model_shards > 1:
            block, first, _ = _model_block(centroids, mesh)
            labels, mind2 = _assign_block(points, block, mode=mode,
                                          chunk_size=chunk_size)
            mine, _ = _owner(mind2, mesh)
            contrib = torch.where(mine, labels + first,
                                  torch.zeros_like(labels))
            return all_reduce(contrib, mesh, (MODEL_AXIS,))
        if mode in KERNEL_MODES:
            return hopper_assign(points.to(torch.float32),
                                 centroids.to(torch.float32),
                                 bf16=mode == "kernel_bf16")[0]
        if mode not in TORCH_MODES:
            raise ValueError(f"unknown distance mode: {mode!r}")
        return assign_labels(points, centroids, chunk_size=chunk_size,
                             mode=mode)

    return predict


# ---------------------------------------------------------------- massive k


#: The phases of the statistics pass, in order, for the phase ladder
#: (``utils.profiling.measure_phase_ladder``): 'distance' is the (chunk, k)
#: distance product (and one sum over its tile, so that it is not
#: elided), 'assign' adds the minimum and argmin over the tile, 'reduce'
#: adds the one-hot scatter, the counts and the (k, D) ``all_reduce``: the
#: whole pass.
ESTEP_PHASES = ("distance", "assign", "reduce")


@_cost.program()
def make_estep_phase_fn(mesh=None, *, chunk_size: int, n_iters: int,
                        phase: str, mode: str = "matmul") -> Callable:
    """The prefix chain of the phase ladder (the reference's
    ``make_estep_phase_fn``): ``(points, weights, centroids) -> scalar``
    runs ``n_iters`` repetitions of the statistics pass up to ``phase``,
    each threading the table through a zero-weighted dependency on the
    last, so no repetition can be skipped.  The value is the reference's:
    the sum over every rank of the rank's table block, divided by the
    ranks.  A harness times two chain lengths and takes the difference
    per repetition, then gives each phase its rung's difference to the one
    before.  Only 'reduce' pays the collective.

    The kernel modes fuse every phase in one kernel and have no prefixes:
    they raise, with the reference's message, and the ladder puts kernel
    1's whole step beside the 'matmul' rungs."""
    if phase not in ESTEP_PHASES:
        raise ValueError(f"phase must be one of {ESTEP_PHASES}, got "
                         f"{phase!r}")
    if mode in KERNEL_MODES:
        raise ValueError("the fused Pallas kernel has no phase prefixes; "
                         "ladder mode='matmul' and compare the fused "
                         "kernel's full step alongside")
    if mode not in ("matmul", "matmul_bf16", "direct"):
        raise ValueError(f"unknown distance mode: {mode!r}")
    data_shards, model_shards = mesh_shape(mesh)

    def run(points, weights, centroids):
        block = (_model_block(centroids, mesh)[0] if model_shards > 1
                 else centroids)
        acc = _accum_dtype(points.dtype)
        n = points.shape[0]
        w = weights.to(acc)

        def iter_dep(cents):
            if phase == "reduce":
                st, _ = reduce_chunks(points, weights, cents,
                                      chunk_size=chunk_size, mode=mode,
                                      need_sse=False, need_farthest=False,
                                      need_sse_pc=False)
                sums = all_reduce(st.sums.clone(), mesh, AXES)
                counts = all_reduce(st.counts.clone(), mesh, AXES)
                return sums.sum() + counts.sum()
            dep = torch.zeros((), dtype=acc, device=points.device)
            for lo in range(0, n, chunk_size):
                d2 = pairwise_sq_dists(points[lo:lo + chunk_size], cents,
                                       mode=mode)
                if phase == "distance":
                    dep = dep + d2.sum()
                    continue
                mind2, best = torch.min(d2, dim=1)
                dep = dep + (mind2 * w[lo:lo + chunk_size]).sum() \
                    + best.to(acc).sum()
            return all_reduce(dep, mesh, AXES)

        cents = block.to(acc)
        for _ in range(n_iters):
            cents = cents + 0.0 * iter_dep(cents)
        return all_reduce(cents.sum(), mesh, AXES) / (data_shards
                                                      * model_shards)

    return run


def _check_large_k_mode(mode: str, what: str, why: str) -> None:
    """The large-k steps run the matmul-class torch modes only: the fused
    kernels are dense-tile passes over the whole table (the JAX package's
    rule for its Pallas modes), and the guarded rung has no model-axis or
    candidate-set form."""
    if mode in KERNEL_MODES or mode == GUARDED_MODE:
        raise ValueError(f"{what} supports the matmul-class modes only, "
                         f"got {mode!r}: {why}")
    if mode not in TORCH_MODES:
        raise ValueError(f"unknown distance mode: {mode!r}")


@_cost.program()
def make_kshard_step_fn(mesh, *, chunk_size: int, mode: str = "matmul",
                        need_farthest: bool = True,
                        need_sse_pc: bool = True) -> Callable:
    """The k-sharded step of the massive-k tier: ``(points, weights,
    centroids, x2w=None) -> StepStats`` whose ``sums``, ``counts`` and
    ``sse_per_cluster`` are this rank's (k/M, D) block of the statistics
    (rows ``[m * k/M, (m + 1) * k/M)`` of the padded table, m the rank's
    model index), reduced over the data axis only.  The dense model-axis
    step embeds the block in a (k_pad, D) table reduced over both axes;
    here no rank's device holds more than its block.  The winner of a row
    is :func:`_owner`'s pair select (MIN of the distance, then MIN of the
    block index), the SSE and the farthest point the dense step's
    expressions, so the step is the bit-exact partner of the dense step on
    the same mesh.  :func:`gather_kshard_stats` assembles the blocks in
    host memory for the host loop's M-step.  Matmul-class modes only."""
    model_shards = mesh_shape(mesh)[1]
    if model_shards <= 1:
        raise ValueError(
            "make_kshard_step_fn requires a TP (centroid-sharded) mesh "
            f"(model_shards > 1, got {model_shards}); on a data-parallel "
            "mesh the dense step already holds only one centroid block — "
            "use make_step_fn (k_shard=0)")
    _check_large_k_mode(
        mode, "make_kshard_step_fn",
        "the fused kernels carry their own TP assignment form, and the "
        "guarded bf16 rung has no TP form (_check_guarded)")

    def step(points, weights, centroids, x2w=None):
        st = _model_axis_stats(
            points, weights, centroids, mesh, mode=mode,
            chunk_size=chunk_size, need_sse=True,
            need_farthest=need_farthest, need_sse_pc=need_sse_pc,
            embed=False)
        k_local, d = st.sums.shape
        parts = [st.sums.reshape(-1), st.counts]
        if need_sse_pc:
            parts.append(st.sse_per_cluster)
        flat = all_reduce(torch.cat(parts), mesh, (DATA_AXIS,))
        sums = flat[: k_local * d].reshape(k_local, d)
        counts = flat[k_local * d: k_local * d + k_local]
        sse_pc = (flat[k_local * d + k_local:] if need_sse_pc
                  else st.sse_per_cluster)
        sse = all_reduce(st.sse.clone().reshape(1), mesh, AXES)[0] \
            / model_shards
        far_d, far_p = st.farthest_dist, st.farthest_point
        if need_farthest:
            far_d, far_p = _reduce_farthest(far_d, far_p, mesh)
        return StepStats(sums, counts, sse, far_d, far_p, sse_pc)

    return step


#: Gloo groups of each mesh's model axis, made at the first host gather
#: (every rank of the world makes every group, in one order).
_HOST_GROUPS: Dict[int, tuple] = {}


def _host_model_group(mesh):
    """A gloo group over this rank's row of the model axis: the host-memory
    collective of :func:`gather_kshard_stats` (NCCL takes no CPU tensors)."""
    import torch.distributed as tdist
    entry = _HOST_GROUPS.get(id(mesh))
    if entry is None or entry[0] is not mesh:
        mine = None
        for row in mesh.mesh.reshape(mesh.size(0), mesh.size(1)).tolist():
            group = tdist.new_group(row, backend="gloo")
            if tdist.get_rank() in row:
                mine = group
        entry = _HOST_GROUPS[id(mesh)] = (mesh, mine)
    return entry[1]


def gather_kshard_stats(st: StepStats, mesh, k: int) -> StepStats:
    """The whole (k, D) statistics of a k-sharded step, on the host: each
    rank copies its block to host memory, embeds it in a zero (k_pad,
    D + 2) host buffer, and a SUM ``all_reduce`` over a gloo group of the
    model axis (:func:`_host_model_group`) adds the blocks (each row is
    one block's; the others add zeros, exactly).  No (k, D) buffer is
    allocated on a device.  Every field of the result is a CPU tensor."""
    k_local, d = st.sums.shape
    model_shards = mesh_shape(mesh)[1]
    first = coords(mesh)[1] * k_local
    host = torch.zeros((k_local * model_shards, d + 2),
                       dtype=st.sums.dtype)
    host[first: first + k_local, :d] = st.sums.cpu()
    host[first: first + k_local, d] = st.counts.cpu()
    host[first: first + k_local, d + 1] = st.sse_per_cluster.cpu()
    import torch.distributed as tdist
    tdist.all_reduce(host, group=_host_model_group(mesh))
    return StepStats(host[:k, :d], host[:k, d], st.sse.cpu(),
                     st.farthest_dist.cpu(), st.farthest_point.cpu(),
                     host[:k, d + 1])


def _check_two_level(mode: str, model_shards: int) -> None:
    """Where the two-level step runs: a data-parallel mesh and a
    matmul-class mode (the JAX package's rules and messages)."""
    if model_shards != 1:
        raise ValueError(
            "two-level assignment requires a data-parallel mesh "
            f"(model_shards == 1, got {model_shards}): the candidate "
            "gather indexes the FULL centroid table; at table sizes "
            "that need TP sharding, use k_shard instead (the two tiers "
            "compose with the planner, not with each other)")
    _check_large_k_mode(
        mode, "two-level assignment",
        "the fused kernels and the guarded bf16 rung are dense-tile "
        "passes — the candidate-set gather has no fused form")


#: Elements of one (rows, L) candidate tile of the two-level search: a cell
#: that more rows of a chunk activate is visited in slices of rows.
TWO_LEVEL_TILE_ELEMS = 1 << 25


def _two_level_best(xc, coarse, cents_ext, members, *, nprobe: int,
                    mode: str, k: int, tables=None):
    """The two-level candidate search of one chunk: ``(best_d, best_i)``,
    each row's exact squared distance to, and global index of, its nearest
    candidate centroid.

    Each row activates its ``nprobe`` nearest coarse cells (every cell at
    or below its ``nprobe``-th smallest coarse distance, so ties activate a
    superset).  The loop visits only the cells that some row of the chunk
    activated, each with the rows that activated it: their distances to
    the cell's member list (``members[c]``, sorted ascending, ``k`` in the
    empty slots, which gather the sentinel row of ``cents_ext`` and are
    masked to +inf) come from the same ``pairwise_sq_dists`` ladder as the
    dense pass.  The merge across cells is lexicographic on (distance,
    global index), and within a cell ``argmin`` takes the first, lowest,
    index: the dense argmin's rule.  ``tables`` (C, L, D) are the member
    lists' rows when the caller gathered them once.  A cell's rows are
    taken in slices of at most ``TWO_LEVEL_TILE_ELEMS // L``, so that a
    cell that most rows activate (a hub) keeps its tile to that budget."""
    m = xc.shape[0]
    C, L = members.shape
    if not 1 <= nprobe <= C:
        raise ValueError(f"nprobe must be in [1, {C}], got {nprobe}")
    acc = _accum_dtype(xc.dtype)
    dc = pairwise_sq_dists(xc, coarse, mode=mode)            # (m, C)
    thresh = torch.topk(dc, nprobe, dim=1, largest=False).values[:, -1]
    cells, rows = torch.nonzero((dc <= thresh[:, None]).T, as_tuple=True)
    del dc
    per_cell = torch.bincount(cells, minlength=C).cpu().tolist()
    best_d = torch.full((m,), float("inf"), dtype=acc, device=xc.device)
    best_i = torch.full((m,), k, dtype=torch.int64, device=xc.device)
    inf = torch.full((), float("inf"), dtype=acc, device=xc.device)
    valid = members < k
    step = max(1, TWO_LEVEL_TILE_ELEMS // L)
    start = 0
    for c, count in enumerate(per_cell):
        if not count:
            continue
        tab = tables[c] if tables is not None else \
            cents_ext.index_select(0, members[c])
        for lo in range(start, start + count, step):
            r = rows[lo: min(lo + step, start + count)]
            d2 = pairwise_sq_dists(xc.index_select(0, r), tab, mode=mode)
            d2 = torch.where(valid[c][None, :], d2, inf)
            j = torch.argmin(d2, dim=1)
            dm = d2.gather(1, j[:, None])[:, 0]
            gi = members[c].index_select(0, j)
            cur_d = best_d.index_select(0, r)
            cur_i = best_i.index_select(0, r)
            better = (dm < cur_d) | ((dm == cur_d) & (gi < cur_i))
            best_d.index_copy_(0, r, torch.where(better, dm, cur_d))
            best_i.index_copy_(0, r, torch.where(better, gi, cur_i))
        start += count
    return best_d, best_i


def _two_level_inputs(centroids, coarse, members):
    """The step's device inputs: the table with its sentinel row, the
    coarse table in the table's dtype, the member lists (int64) and their
    (C, L, D) rows, gathered once per step."""
    k, d = centroids.shape
    cents_ext = torch.cat([centroids, torch.full(
        (1, d), PAD_CENTROID_VALUE, dtype=centroids.dtype,
        device=centroids.device)])
    coarse = torch.as_tensor(np.asarray(coarse), device=centroids.device
                             ).to(centroids.dtype)
    members = torch.as_tensor(np.asarray(members),
                              device=centroids.device).to(torch.int64)
    return cents_ext, coarse, members, cents_ext[members]


@_cost.program()
def make_two_level_step_fn(mesh=None, *, chunk_size: int, nprobe: int,
                           mode: str = "matmul",
                           need_farthest: bool = True,
                           need_sse_pc: bool = True) -> Callable:
    """The two-level step of the massive-k tier: ``(points, weights,
    centroids (k, D), coarse (C, D), members (C, L)) -> StepStats``.  Each
    chunk's rows go through :func:`_two_level_best`, and the statistics
    accumulate by a scatter-add (``index_add_``) over the winning labels:
    no (chunk, k) tile is formed.  A row whose candidates are all +inf (a
    NaN row) adds nothing to the sums and counts.  The SSE is exact for
    the labels it produces.  With ``nprobe == C`` every centroid is a
    candidate and the step is the parity partner of the dense step; the
    sums' order differs (on the card ``index_add_`` adds in the order its
    atomics land, so they are of the rtol class).  Under a data-parallel
    mesh the statistics reduce over the data axis as the dense step's do.
    Matmul-class modes, no model axis (:func:`_check_two_level`)."""
    _check_two_level(mode, mesh_shape(mesh)[1])

    def step(points, weights, centroids, coarse, members):
        k, d = centroids.shape
        acc = _accum_dtype(points.dtype)
        cents_ext, coarse, members, tables = _two_level_inputs(
            centroids, coarse, members)
        st = init_stats(k, d, acc, points.device)
        sums, counts, sse_pc = st.sums, st.counts, st.sse_per_cluster
        sse = st.sse
        best = torch.empty((points.shape[0],), dtype=acc,
                           device=points.device)
        for lo in range(0, points.shape[0], chunk_size):
            xc = points[lo:lo + chunk_size]
            wc = weights[lo:lo + chunk_size].to(acc)
            bd, bi = _two_level_best(xc, coarse, cents_ext, members,
                                     nprobe=nprobe, mode=mode, k=k,
                                     tables=tables)
            ok = bi < k
            idx = torch.where(ok, bi, torch.zeros_like(bi))
            wx = torch.where(ok[:, None], xc.to(acc) * wc[:, None],
                             torch.zeros((), dtype=acc, device=xc.device))
            sums.index_add_(0, idx, wx)
            counts.index_add_(0, idx, torch.where(ok, wc,
                                                  torch.zeros_like(wc)))
            sse = sse + (bd * wc).sum()
            if need_sse_pc:
                sse_pc.index_add_(0, idx, torch.where(
                    ok, bd * wc, torch.zeros_like(bd)))
            best[lo:lo + chunk_size] = bd
        far_d, far_p = st.farthest_dist, st.farthest_point
        if need_farthest and points.shape[0]:
            live = weights > 0
            masked = torch.where(live, best,
                                 torch.full_like(best, float("-inf")))
            i = torch.argmax(masked).reshape(1)
            far = masked.index_select(0, i)[0]
            far_d = torch.where(live.any(), far, torch.full_like(far, -1.0))
            far_p = points.index_select(0, i)[0].to(acc)
        st = StepStats(sums, counts, sse, far_d, far_p, sse_pc)
        if mesh is not None:
            st = _reduce_stats(st, mesh, k, need_sse_pc=need_sse_pc,
                               need_farthest=need_farthest)
        return st

    return step


@_cost.program()
def make_two_level_predict_fn(mesh=None, *, chunk_size: int, nprobe: int,
                              mode: str = "matmul") -> Callable:
    """Two-level labels: ``(points, centroids, coarse, members) ->
    labels`` int32 (the rank's block under a mesh), the candidate search
    and tie rule of :func:`make_two_level_step_fn`, no (chunk, k) tile."""
    mode = value_mode(mode)
    _check_two_level(mode, mesh_shape(mesh)[1])

    def predict(points, centroids, coarse, members):
        cents_ext, coarse, members, tables = _two_level_inputs(
            centroids, coarse, members)
        labels = torch.empty((points.shape[0],), dtype=torch.int32,
                             device=points.device)
        for lo in range(0, points.shape[0], chunk_size):
            labels[lo:lo + chunk_size] = _two_level_best(
                points[lo:lo + chunk_size], coarse, cents_ext, members,
                nprobe=nprobe, mode=mode, k=centroids.shape[0],
                tables=tables)[1]
        return labels

    return predict


# ------------------------------------------------------------ device loop


class FitResult(NamedTuple):
    """What the device loop hands back to the host, once per fit."""

    centroids: torch.Tensor      # (k, D), accumulation dtype, on the device
    n_iters: int                 # iterations that ran (not masked)
    sse_history: np.ndarray      # (n_iters,) float64; zeros unless asked
    shift_history: np.ndarray    # (n_iters,) float64, largest shifts
    counts: np.ndarray           # (k,) float64, of the last iteration
    finite: bool                 # False: iteration n_iters went non-finite
    launched: int                # iterations launched, masked ones too
    flagged: Optional[int] = None  # guarded rung: rows flagged, all iterations


def empty_draw_keys(seed: int, stop: int, start: int = 0) -> np.ndarray:
    """(stop - start, PERMUTE_STEPS) keys of the refill draws of iterations
    ``start .. stop - 1``: iteration ``it`` draws under ``draw_keys([seed,
    it + 1])`` for the absolute ``it``, the seed the host loop gives
    ``Dataset.sample_positive_rows`` (the JAX package's
    ``_empty_seed_array(seed, it0, seg)`` schedule), so a segment or a
    resumed fit draws what the uninterrupted fit draws.  SeedSequence is
    host-only, so the schedule is made here, once per fit or segment."""
    return np.stack([draw_keys([seed, it + 1])
                     for it in range(start, stop)])


def refill_table(ds: Dataset, keys: np.ndarray, k: int) -> torch.Tensor:
    """(len(keys), k) int64 on the device: the positive-weight row (its
    ordinal, ``Dataset.gather_positive``) that draw j of the iteration of
    each row of ``keys`` (:func:`empty_draw_keys`) refills (``-1`` where
    the positive-weight rows are used up).  Draw j is the same row
    ``ds.sample_positive_rows`` returns j-th for the same seed, so the host
    loop and the device loop refill alike on a dataset without a host
    copy, and a mesh draws the rows one device would.  Made before
    the loop: inside it an iteration reads its row of the table, O(k)."""
    n_pos = ds.positive_count()
    j = torch.arange(k, device=ds.device).expand(keys.shape[0], k)
    if n_pos == 0:
        return torch.full_like(j, -1)
    return permuted_draws(n_pos, j, torch.from_numpy(keys))


def project_centroids(new: torch.Tensor, prev: torch.Tensor,
                      real: Optional[torch.Tensor] = None,
                      project: Optional[str] = None) -> torch.Tensor:
    """The device form of a family's centroid hook, applied after the mean
    update and the refill and before the shift test (the JAX package's
    ``_project_centroids``).  ``'sphere'`` (``SphericalKMeans``): each real
    row divided by its norm (the mean direction); a row of norm 0 (members
    that cancel exactly) keeps its previous value ``prev``.  Rows outside
    ``real`` (sentinel rows, (..., k) bool; None: every row is real) stay
    as they are: a sentinel put on the sphere would win rows.  Plain tensor
    ops, so a captured iteration holds it."""
    if project is None:
        return new
    if project != "sphere":
        raise ValueError(f"unknown device projection {project!r}")
    norm = torch.sqrt((new * new).sum(dim=-1, keepdim=True))
    unit = new / torch.clamp_min(norm, torch.finfo(new.dtype).tiny)
    if real is None:
        return torch.where(norm > 0, unit, prev)
    real_c = real[..., None]
    return torch.where(real_c & (norm > 0), unit,
                       torch.where(real_c, prev, new))


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A float64 host array of the loop's state ``t`` that owns its memory:
    on the CPU, ``.to(float64).cpu().numpy()`` of a float64 tensor is a
    view of the state, which the next fit on the dataset overwrites."""
    return np.array(t.detach().to(torch.float64).cpu().numpy())


class _Replay:
    """How a device loop's iteration is launched: on the card it runs once
    eagerly, then is captured as a CUDA graph and replayed; on the CPU it
    runs eagerly.  The host reads the loop's done flag ``running`` (a bool
    tensor) once per iteration.  A subclass sets ``points`` (a tensor on the
    loop's device), ``max_iter``, ``running``, ``graph = None`` and
    ``graph_launches = {}``, and defines ``iterate()``, which reads nothing
    to the host."""

    def _capture(self, measure: Optional[dict] = None) -> None:
        """The first iteration on the card: it runs eagerly on a side stream
        (a real iteration, which also does the kernels' one-time host work:
        library load, function attributes, occupancy query), then one
        iteration is captured, which runs nothing.  The kernel launches,
        their declared operations and the collectives' bytes that the
        capture recorded are taken back off ``LAUNCHES``, ``OPS`` and
        ``mesh.COLLECTIVES`` and added at each replay instead, so the counts
        are of work that reached the card.  ``measure``: a cost capture's
        request (``obs.cost.take_request``), taken on the eager iteration,
        never across the capture.  Under a tracer the capture is a
        ``compile`` span (``via='graph-capture'``)."""
        current = torch.cuda.current_stream(self.points.device)
        side = torch.cuda.Stream(device=self.points.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            if measure is None:
                self.iterate()
            else:
                _cost.measure_launch(measure, self.iterate,
                                     args=self._measured_args(),
                                     outputs=self._measured_outputs(),
                                     region="warm-up")
        current.wait_stream(side)
        before = dict(_build.LAUNCHES)
        ops_before = dict(_build.OPS)
        comm_before = dict(COLLECTIVES)
        graph = torch.cuda.CUDAGraph()
        try:
            with _obs_trace.span("compile", via="graph-capture",
                                 loop=type(self).__name__), \
                    torch.cuda.graph(graph):
                self.iterate()
        except RuntimeError as e:
            oom = _oom_in_chain(e)
            if oom is not None:
                raise oom
            raise RuntimeError(
                f"the device loop's iteration could not be captured as a "
                f"CUDA graph: {e}") from e
        finally:
            recorded = {name: (count - before.get(name, 0),
                               _build.OPS.get(name, 0.0)
                               - ops_before.get(name, 0.0))
                        for name, count in _build.LAUNCHES.items()}
            _build.LAUNCHES.update(before)
            _build.OPS.update(ops_before)
            comm = {key: COLLECTIVES[key] - comm_before[key]
                    for key in COLLECTIVES}
            COLLECTIVES.update(comm_before)
        self.graph_launches = {n: c for n, (c, _) in recorded.items() if c}
        self.graph_ops = {n: ops for n, (c, ops) in recorded.items() if c}
        self.graph_comm = comm
        self.graph = graph
        name = type(self).__name__
        CAPTURES[name] = CAPTURES.get(name, 0) + 1

    def _measured_args(self):
        """The tensors an iteration reads, for a cost record."""
        return (self.points, getattr(self, "weights", None))

    def _measured_outputs(self):
        """The state an iteration writes, for a cost record."""
        return tuple(v for v in vars(self).values()
                     if isinstance(v, torch.Tensor)
                     and v is not self.points
                     and v is not getattr(self, "weights", None))

    def _replay(self) -> None:
        self.graph.replay()
        ops = getattr(self, "graph_ops", {})
        for name, count in self.graph_launches.items():
            _build.count_launch(name, count, ops.get(name, 0.0))
        comm = getattr(self, "graph_comm", None)
        if comm and comm["count"]:
            count_collectives(comm["bytes"], comm["count"])

    def _eager(self, req: Optional[dict]) -> None:
        """One eager iteration, measured for a cost capture's request
        ``req`` (None: not measured)."""
        if req is None:
            self.iterate()
        else:
            _cost.measure_launch(req, self.iterate,
                                 args=self._measured_args(),
                                 outputs=self._measured_outputs(),
                                 region="eager")

    def _launch(self) -> None:
        req = _cost.take_request()
        if not self.points.is_cuda:
            self._eager(req)
        elif self.graph is None:
            self._capture(req)
        elif req is None:
            self._replay()
        else:
            _cost.measure_launch(req, self._replay,
                                 args=self._measured_args(),
                                 outputs=self._measured_outputs(),
                                 region="replay")

    def _drive(self, in_flight: int, limit: Optional[int] = None) -> int:
        """Launch iterations until the host reads a done flag: that of
        iteration i - ``in_flight`` while iteration i is queued; at most
        ``limit`` (None: ``max_iter``).  On a CUDA device the flags come
        back through a pinned ring, each behind an event; on the CPU each
        is read as it is set.  Returns the iterations launched."""
        limit = self.max_iter if limit is None else limit
        cuda = self.points.is_cuda
        slots = in_flight + 1
        if cuda:
            ring = torch.empty(slots, dtype=torch.bool, pin_memory=True)
            events = [torch.cuda.Event() for _ in range(slots)]
        flags = []
        launched = 0
        while launched < limit:
            self._launch()
            if cuda:
                ring[launched % slots].copy_(self.running, non_blocking=True)
                events[launched % slots].record()
            else:
                flags.append(bool(self.running))
            launched += 1
            back = launched - 1 - in_flight
            if back < 0:
                continue
            if cuda:
                events[back % slots].synchronize()
                go = bool(ring[back % slots])
            else:
                go = flags[back]
            if not go:
                break
        if cuda:
            torch.cuda.current_stream(self.points.device).synchronize()
        return launched


class _DeviceLoop(_Replay):
    """The device loop's state on one dataset, and one iteration over it.

    Every tensor the iteration reads or writes across iterations is made
    here, once, so that a captured iteration finds it at the same address
    on every replay.  An iteration that runs after convergence or
    divergence (``running`` false) leaves every one of them as it was.
    The iteration counter ``it`` is absolute: a run starts at any ``start``
    and stops at ``stop`` (both written before the first launch), so a
    segment of a checkpointed fit, or a resumed fit, replays the graph
    captured for the whole fit and indexes its draws and histories by the
    uninterrupted fit's iteration."""

    def __init__(self, points, weights, step, gather, *, k: int,
                 max_iter: int, tolerance: float, empty_policy: str,
                 need_sse: bool, x2w: Optional[torch.Tensor],
                 x2w_finite: Optional[torch.Tensor], audit: bool = False,
                 project: Optional[str] = None):
        dev, d = points.device, points.shape[-1]
        acc = _accum_dtype(points.dtype)
        self.points, self.weights, self.step = points, weights, step
        # Weak: the loop lives in its dataset's memo, and a strong bound
        # method would tie the two in a cycle that only the collector frees.
        self._gather = None if gather is None else weakref.WeakMethod(gather)
        self.audit, self.project = audit, project
        self.flagged = torch.zeros((), dtype=torch.int64, device=dev)
        self.max_iter, self.tolerance = max_iter, float(tolerance)
        self.policy, self.need_sse, self.x2w = empty_policy, need_sse, x2w
        self.x2w_finite = x2w_finite
        self.cents = torch.zeros((k, d), dtype=acc, device=dev)
        self.counts = torch.zeros((k,), dtype=acc, device=dev)
        self.sse_hist = torch.zeros((max_iter,), dtype=acc, device=dev)
        self.shift_hist = torch.zeros((max_iter,), dtype=acc, device=dev)
        self.shift = torch.zeros((), dtype=acc, device=dev)
        self.it = torch.zeros((), dtype=torch.int64, device=dev)
        self.stop = torch.full((), max_iter, dtype=torch.int64, device=dev)
        self.ok = torch.ones((), dtype=torch.bool, device=dev)
        self.running = torch.ones((), dtype=torch.bool, device=dev)
        self.table = (None if empty_policy == "keep" else torch.full(
            (max_iter, k), -1, dtype=torch.int64, device=dev))
        self.slots = torch.arange(k, device=dev)
        self.iters = torch.arange(max_iter, device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.graph_launches: Dict[str, int] = {}

    # ------------------------------------------------------------ iteration

    def gather(self, ordinals: torch.Tensor) -> torch.Tensor:
        """The dataset's ``gather_positive`` (the dataset is alive while a
        fit on it runs)."""
        return self._gather()(ordinals)

    def _refill(self, new, empty, st: StepStats):
        """The empty slots of ``new``, all in this iteration: 'farthest'
        puts the farthest point in the first (when its distance is valid);
        every other empty slot takes its draw from this iteration's row of
        the table, in slot order.  A slot without a draw keeps its value."""
        k = empty.shape[0]
        skip = torch.zeros((), dtype=torch.int64, device=new.device)
        if self.policy == "farthest":
            first = torch.argmax(empty.to(torch.int32))
            use_far = empty.any() & (st.farthest_dist >= 0)
            at_first = (self.slots == first) & use_far
            new = torch.where(at_first[:, None],
                              st.farthest_point.to(new.dtype)[None, :], new)
            skip = use_far.to(torch.int64)
        draw = torch.cumsum(empty.to(torch.int64), 0) - 1 - skip
        row = torch.clamp(self.it, max=self.max_iter - 1).reshape(1)
        pick = self.table.index_select(0, row)[0].gather(
            0, draw.clamp(0, k - 1))
        take = empty & (draw >= 0) & (pick >= 0)
        rows = self.gather(pick).to(new.dtype)
        return torch.where(take[:, None], rows, new)

    def iterate(self) -> None:
        """One Lloyd iteration, masked by ``running``: the step, the mean
        division in the accumulation dtype, the empty-cluster policy, the
        projection, the all-finite flag, the largest shift and the
        converged flag.  Nothing is read to the host."""
        active = self.running.clone()
        st = self.step(self.points, self.weights, self.cents, self.x2w)
        if self.audit:
            st, flagged = st
            self.flagged.add_(torch.where(active, flagged.to(torch.int64),
                                          torch.zeros_like(self.flagged)))
        counts = st.counts
        nonempty = counts > 0
        new = torch.where(nonempty[:, None],
                          st.sums / torch.clamp_min(counts, 1.0)[:, None],
                          self.cents)
        if self.policy != "keep":
            new = self._refill(new, ~nonempty, st)
        new = project_centroids(new, self.cents, None, self.project)
        diff = new - self.cents
        shift = torch.sqrt((diff * diff).sum(dim=1)).max()
        # The host loop's guard: non-finite centroids, or a non-finite SSE
        # (in the kernel modes sum w ||x||^2 carries a zero-weight NaN row).
        ok = torch.isfinite(new).all()
        if self.need_sse:
            ok = ok & torch.isfinite(st.sse)
        if self.x2w_finite is not None:
            ok = ok & self.x2w_finite
        at = (self.iters == self.it) & active
        self.sse_hist.copy_(torch.where(at, st.sse, self.sse_hist))
        self.shift_hist.copy_(torch.where(at, shift, self.shift_hist))
        self.cents.copy_(torch.where(active, new, self.cents))
        self.counts.copy_(torch.where(active, counts, self.counts))
        self.shift.copy_(torch.where(active, shift, self.shift))
        self.ok.copy_(self.ok & (ok | ~active))
        self.it.add_(active.to(torch.int64))
        self.running.copy_((self.it < self.stop)
                           & (self.shift >= self.tolerance) & self.ok)

    def _reset(self, centroids0: torch.Tensor,
               table: Optional[torch.Tensor], start: int = 0,
               stop: Optional[int] = None) -> None:
        """The state of a run of iterations ``start .. stop - 1``:
        ``centroids0``, and ``table``, the refill rows of those iterations
        (:func:`refill_table`), at their absolute rows."""
        stop = self.max_iter if stop is None else stop
        if not 0 <= start < stop <= self.max_iter:
            raise ValueError(f"need 0 <= start < stop <= {self.max_iter}, "
                             f"got start={start}, stop={stop}")
        self.cents.copy_(centroids0)
        for t in (self.counts, self.sse_hist, self.shift_hist, self.shift,
                  self.flagged):
            t.zero_()
        self.it.fill_(start)
        self.stop.fill_(stop)
        self.ok.fill_(True)
        self.running.fill_(True)
        if table is not None:
            self.table[..., start:stop, :].copy_(table)

    def run(self, centroids0: torch.Tensor, table: Optional[torch.Tensor],
            in_flight: int, start: int = 0,
            stop: Optional[int] = None) -> FitResult:
        """Reset the state to ``centroids0`` at iteration ``start`` (and the
        refill ``table`` of iterations ``start .. stop - 1``), then launch
        iterations until done or at ``stop`` (:meth:`_drive`)."""
        stop = self.max_iter if stop is None else stop
        self._reset(centroids0, table, start, stop)
        launched = self._drive(in_flight, stop - start)
        end = int(self.it)
        return FitResult(
            self.cents.clone(), end - start,
            _host_copy(self.sse_hist[start:end]),
            _host_copy(self.shift_hist[start:end]), _host_copy(self.counts),
            bool(self.ok), launched,
            int(self.flagged) if self.audit else None)


def _oom_in_chain(e: BaseException):
    """The ``torch.cuda.OutOfMemoryError`` that ``e`` is or was raised
    while handling (a capture that fails may raise again as it ends), or
    None."""
    seen = set()
    while e is not None and id(e) not in seen:
        if isinstance(e, torch.cuda.OutOfMemoryError):
            return e
        seen.add(id(e))
        e = e.__cause__ or e.__context__
    return None


def _run_evicting(ds: Dataset, key, loop: "_Replay", run: Callable):
    """``run()`` on a loop kept in ``ds.memo`` under ``key``; when it raises
    before the loop's iteration was captured (an out-of-memory error in
    the first, eager iteration or in the capture), the loop leaves the
    memo, so that its state and graph pool are freed and a retry (the
    out-of-memory backoff's, at a smaller chunk) builds its own."""
    try:
        return run()
    except BaseException:
        if loop.graph is None:
            ds.forget(key)
        raise


def _check_backend(mesh, ds: Dataset) -> None:
    if mesh is not None and ds.points.is_cuda and \
            torch.distributed.get_backend() != "nccl":
        raise ValueError(
            "the device loop (host_loop=False) needs NCCL for CUDA "
            "tensors: its captured CUDA graph holds the mesh's "
            "collectives, and gloo collectives cannot be captured; use "
            "host_loop=True on this process group")


def _x2w_of(ds: Dataset, mode: str, mesh):
    """``(x2w, x2w_finite)`` of a device loop: the dataset's ``sum w
    ||x||^2`` and its finiteness over the data axis where the kernel modes'
    SSE reads it, else ``(None, None)``."""
    if mode not in KERNEL_MODES or mesh_shape(mesh)[1] != 1:
        return None, None
    x2w = dataset_sqnorm(ds)
    return x2w, torch.isfinite(all_reduce(x2w.clone(), mesh, (DATA_AXIS,)))


@_cost.program(loop=True)
def make_fit_fn(mesh=None, *, chunk_size: int, mode: str = "matmul",
                max_iter: int,
                tolerance: float, empty_policy: str = "keep",
                history_sse: bool = True, pipeline: int = 0,
                in_flight: Optional[int] = None,
                project: Optional[str] = None) -> Callable:
    """The device loop: ``fit(ds, centroids0, seed) -> FitResult``.

    Counterpart of the JAX package's ``make_fit_fn`` (its ``lax.while_loop``
    becomes a replayed CUDA graph of one iteration).  Semantics, as there:

    * the mean division in the accumulation dtype, on the device (the host
      loop divides in float64 on the host; for float32 and float64 data
      the quotient rounds to the same value);
    * empty clusters: 'keep' keeps the old centroid; 'farthest' puts the
      farthest point in the first empty slot and draws the rest; 'resample'
      draws every one; all in the same iteration, with the draws of
      :func:`refill_table`, so a dataset without a host copy refills as in
      the host loop;
    * the loop stops at ``max_iter``, when the largest shift falls below
      ``tolerance``, or at the iteration whose centroids (or, as in the host
      loop, the SSE or ``sum w ||x||^2``) go non-finite;
    * only the statistics that are read are computed: the SSE with
      ``history_sse``, the farthest point with 'farthest', no per-cluster
      SSE (the JAX package's ``need_*`` rule);
    * the guarded bf16 rung (refused under a model axis and with
      'farthest', :func:`_check_guarded`) counts the rows its guard flags
      over the fit's iterations: ``FitResult.flagged``, the JAX package's
      trailing audit count;
    * ``project`` (None | 'sphere') is the family's centroid hook on the
      device (:func:`project_centroids`), after the refill and before the
      shift test, where the host loop calls ``_postprocess_centroids``.

    ``seed`` is the restart's seed; the refill of iteration ``it`` draws
    under ``[seed, it + 1]``.  The loop's state and its captured graph are
    kept with the dataset (``Dataset.memo``), once per shape, mode, policy
    and ``history_sse``, so restarts and later fits on it replay them.
    ``fit(..., start=, stop=)`` runs iterations ``start .. stop - 1`` only
    (default: all of them): a segment of a checkpointed fit, or a resumed
    fit, replays the same graph, its counter and its draws those of the
    uninterrupted fit.  A run that fails before its iteration was captured
    leaves no loop in the memo (:func:`_run_evicting`).
    ``in_flight``: see :data:`IN_FLIGHT` (None: that value).

    Under a ``mesh`` the step and the refill's row gather reduce over the
    mesh inside the iteration, so every rank runs the same iterations and
    stops at the same one.  On CUDA tensors the captured graph holds these
    collectives, which needs NCCL: a mesh over gloo with CUDA tensors
    raises ``ValueError`` (the host loop runs there).  On CPU tensors the
    iteration runs eagerly with its gloo collectives."""
    if empty_policy not in ("keep", "farthest", "resample"):
        raise ValueError(
            f"on-device loop supports empty_cluster 'keep', 'farthest' or "
            f"'resample', got {empty_policy!r}")
    _check_guarded(mode, mesh_shape(mesh)[1], empty_policy)
    guarded = mode == GUARDED_MODE
    need_sse = bool(history_sse)
    step = make_step_fn(mesh, chunk_size=chunk_size, mode=mode,
                        need_sse=need_sse,
                        need_farthest=empty_policy == "farthest",
                        need_sse_pc=False, pipeline=pipeline, audit=guarded)

    def _make_loop(ds: Dataset, step, k: int) -> _DeviceLoop:
        x2w, x2w_finite = _x2w_of(ds, mode, mesh)
        return _DeviceLoop(ds.points, ds.weights, step, ds.gather_positive,
                           k=k, max_iter=max_iter, tolerance=tolerance,
                           empty_policy=empty_policy, need_sse=need_sse,
                           x2w=x2w, x2w_finite=x2w_finite, audit=guarded,
                           project=project)

    # The kernel modes take every row of the block in one launch: without a
    # model axis no chunk reaches the step, so the loop is one for every
    # chunk (an out-of-memory backoff replays its graph).
    loop_chunk = (None if mode in KERNEL_MODES and mesh_shape(mesh)[1] == 1
                  else chunk_size)

    def fit(ds: Dataset, centroids0: torch.Tensor, seed: int,
            start: int = 0, stop: Optional[int] = None) -> FitResult:
        _check_backend(mesh, ds)
        k = centroids0.shape[0]
        stop = max_iter if stop is None else stop
        key = ("device_loop", mode, loop_chunk, k, max_iter,
               float(tolerance), empty_policy, need_sse, pipeline, project)
        loop = ds.memo(key, lambda: _make_loop(ds, step, k))
        table = (None if empty_policy == "keep" else
                 refill_table(ds, empty_draw_keys(seed, stop, start), k))
        return _run_evicting(ds, key, loop, lambda: loop.run(
            centroids0, table, IN_FLIGHT if in_flight is None else in_flight,
            start, stop))

    return fit


# ------------------------------------------------------- batched restarts


class MultiFitResult(NamedTuple):
    """What :func:`make_multi_fit_fn` hands back to the host: every
    member's state with ``return_all``, else the winner's (the member of
    the lowest true final inertia, the first of equal ones)."""

    centroids: torch.Tensor      # (R, k, D), or the winner's (k, D)
    n_iters: np.ndarray          # (R,), or the winner's as an int
    sse_history: np.ndarray      # (R, max_iter), or the winner's (n,)
    shift_history: np.ndarray    # (R, max_iter), or the winner's (n,)
    counts: np.ndarray           # (R, k), or the winner's (k,)
    inertias: np.ndarray         # (R,) true final inertia of every member
    best: int                    # the winner
    finite: np.ndarray           # (R,) bool: False where a member diverged
    launched: int                # iterations launched, masked ones too
    flagged: Optional[int] = None  # guarded rung: rows flagged, all members


class _MultiLoop(_DeviceLoop):
    """The device loop of R members over one dataset: the state of
    :class:`_DeviceLoop` with a leading member axis, one iteration of every
    member per launch (one captured graph).  A member that has converged
    or diverged is frozen: its centroids, counts and histories stop
    changing.  The loop runs until every member is frozen or ``max_iter``.

    ``stats(points, weights, cents, x2w)`` gives the members' statistics
    (a :class:`StepStats` with the member axis) and their flagged rows
    (R,).  ``real`` (R, k) marks each member's real centroid rows: the
    rows past a member's own k hold sentinels, which take no refill.
    ``points`` is (n, D), or (R, n, D) with each member's own rows
    (``member_points``)."""

    def __init__(self, points, weights, stats, gather, *, real, max_iter,
                 tolerance, empty_policy, need_sse, x2w, x2w_finite,
                 audit, project=None):
        members, k = real.shape
        super().__init__(points, weights, stats, gather, k=k,
                         max_iter=max_iter, tolerance=tolerance,
                         empty_policy=empty_policy, need_sse=need_sse,
                         x2w=x2w, x2w_finite=x2w_finite, audit=audit,
                         project=project)
        dev, d = points.device, points.shape[-1]
        acc = _accum_dtype(points.dtype)
        self.real = real
        self.cents = torch.zeros((members, k, d), dtype=acc, device=dev)
        self.counts = torch.zeros((members, k), dtype=acc, device=dev)
        self.sse_hist = torch.zeros((members, max_iter), dtype=acc,
                                    device=dev)
        self.shift_hist = torch.zeros_like(self.sse_hist)
        self.n_iters = torch.zeros((members,), dtype=torch.int64, device=dev)
        self.ok = torch.ones((members,), dtype=torch.bool, device=dev)
        self.done = torch.zeros((members,), dtype=torch.bool, device=dev)
        self.table = (None if empty_policy == "keep" else torch.full(
            (members, max_iter, k), -1, dtype=torch.int64, device=dev))

    def _refill(self, new, empty, st: StepStats):
        """:meth:`_DeviceLoop._refill` for every member at once (the JAX
        package's ``_refill_empty_slots_batched``): each member draws from
        its own table, made from its own seed, so the members refill as R
        single fits with those seeds would."""
        members, k = empty.shape
        skip = torch.zeros((members,), dtype=torch.int64, device=new.device)
        if self.policy == "farthest":
            first = torch.argmax(empty.to(torch.int32), dim=1)
            use_far = empty.any(dim=1) & (st.farthest_dist >= 0)
            at_first = (self.slots[None, :] == first[:, None]) \
                & use_far[:, None]
            new = torch.where(at_first[..., None],
                              st.farthest_point.to(new.dtype)[:, None, :],
                              new)
            skip = use_far.to(torch.int64)
        draw = torch.cumsum(empty.to(torch.int64), 1) - 1 - skip[:, None]
        row = torch.clamp(self.it, max=self.max_iter - 1).reshape(1)
        pick = self.table.index_select(1, row)[:, 0].gather(
            1, draw.clamp(0, k - 1))
        take = empty & (draw >= 0) & (pick >= 0)
        rows = self.gather(pick.reshape(-1)).to(new.dtype).reshape(new.shape)
        return torch.where(take[..., None], rows, new)

    def iterate(self) -> None:
        """One Lloyd iteration of every member that is still moving; the
        frozen ones are computed and left as they were."""
        active = ~self.done & self.running
        st, flagged = self.step(self.points, self.weights, self.cents,
                                self.x2w)
        if self.audit:
            self.flagged.add_(torch.where(active, flagged.to(torch.int64),
                                          torch.zeros_like(
                                              flagged, dtype=torch.int64)
                                          ).sum())
        counts = st.counts
        nonempty = counts > 0
        new = torch.where(nonempty[..., None],
                          st.sums / torch.clamp_min(counts, 1.0)[..., None],
                          self.cents)
        if self.policy != "keep":
            new = self._refill(new, ~nonempty & self.real, st)
        new = project_centroids(new, self.cents, self.real, self.project)
        diff = new - self.cents
        shifts = torch.sqrt((diff * diff).sum(dim=2))
        shift = torch.where(self.real, shifts,
                            torch.zeros_like(shifts)).max(dim=1).values
        ok = torch.isfinite(new).reshape(new.shape[0], -1).all(dim=1)
        if self.need_sse:
            ok = ok & torch.isfinite(st.sse)
        if self.x2w_finite is not None:
            ok = ok & self.x2w_finite
        at = (self.iters[None, :] == self.it) & active[:, None]
        self.sse_hist.copy_(torch.where(at, st.sse[:, None], self.sse_hist))
        self.shift_hist.copy_(torch.where(at, shift[:, None],
                                          self.shift_hist))
        self.cents.copy_(torch.where(active[:, None, None], new, self.cents))
        self.counts.copy_(torch.where(active[:, None], counts, self.counts))
        self.n_iters.add_(active.to(torch.int64))
        self.ok.copy_(self.ok & (ok | ~active))
        self.done.copy_(self.done | (active & ((shift < self.tolerance)
                                               | ~ok)))
        self.it.add_(self.running.to(torch.int64))
        self.running.copy_((self.it < self.max_iter) & ~self.done.all())

    def _reset(self, centroids0, table) -> None:
        super()._reset(centroids0, table)
        self.n_iters.zero_()
        self.done.zero_()


@_cost.program(loop=True)
def make_multi_fit_fn(mesh=None, *, chunk_size: int, mode: str = "matmul",
                      k_real: int, max_iter: int, tolerance: float,
                      empty_policy: str = "keep", n_init: int,
                      history_sse: bool = True, k_reals=None,
                      return_all: bool = False,
                      pipeline: int = 0,
                      project: Optional[str] = None,
                      member_points: bool = False) -> Callable:
    """R = ``n_init`` fits in one device loop: ``fit(ds, centroids0 (R,
    k_real, D), seeds) -> MultiFitResult``.

    Counterpart of the JAX package's ``make_multi_fit_fn``.  The members
    are restarts, or with ``k_reals`` (R ints, each at most ``k_real``) the
    members of a sweep over k: member r's rows from ``k_reals[r]`` on must
    be sentinel rows (:data:`PAD_CENTROID_VALUE`), which never win a row,
    keep their value, and take no refill.  Each iteration is one launch of
    every member (one captured CUDA graph on the card); a member that has
    converged stops moving and stops recording (frozen), and the loop ends
    when every member is frozen or at ``max_iter``.  Member r refills its
    empty slots with the draws of ``seeds[r]`` (:func:`refill_table`), as
    a single fit with that seed does.  After the loop one pass per member
    scores its final centroids (the true final inertia, the selection rule
    of ``n_init``); the winner is the lowest, the first of equal ones.

    In every mode the members' passes run one after another inside the
    iteration, each the step of a single fit at the member's own k (its
    sentinel rows cut off) over the shared points: kernel 1 (1b) in the
    kernel modes, the JAX package's ``lax.map`` route, and the chunked
    torch pass in the others.  The points are never copied per member, a
    member's tiles are a single fit's, and its arithmetic is that of a
    single fit at its own k.  (A batch of the torch modes' products,
    (R, chunk, k) through ``torch.bmm``, was measured no faster on the
    card: PERF.md.)  ``return_all`` returns every member's state;
    ``flagged`` counts the guarded rung's flagged rows of every member
    while it moves.  ``project`` is the family's centroid hook, on each
    member's real rows (:func:`project_centroids`).

    ``member_points=True`` gives each member rows of its own (the product
    quantizer's subspaces): ``fit(ds, centroids0, seeds, points)`` takes
    them as a separate (R, n, D) tensor, and member r trains against
    ``points[r]`` with ``ds``'s weights (``ds`` is a dataset of one member,
    the rank's block under a mesh), its pass the single fit's step over
    those rows.  As in the JAX package it takes the matmul-class modes and
    ``empty_policy='keep'`` only."""
    if empty_policy not in ("keep", "farthest", "resample"):
        raise ValueError(
            f"on-device loop supports empty_cluster 'keep', 'farthest' or "
            f"'resample', got {empty_policy!r}")
    _check_guarded(mode, mesh_shape(mesh)[1], empty_policy)
    if member_points:
        if mode in KERNEL_MODES or mode == GUARDED_MODE:
            raise ValueError(
                f"member_points supports the matmul-class modes only, "
                f"got {mode!r} (the Pallas prep hoists and the guarded "
                "rung are shared-points programs)")
        if empty_policy != "keep":
            raise ValueError(
                f"member_points requires empty_cluster='keep', got "
                f"{empty_policy!r}: the Gumbel refill engine draws rows "
                "from the shared dataset by global index, which has no "
                "per-member-rows form")
    ks = (np.full((n_init,), k_real, np.int64) if k_reals is None
          else np.asarray(k_reals, np.int64))
    if ks.shape != (n_init,):
        raise ValueError(f"k_reals must have shape ({n_init},), got "
                         f"{ks.shape}")
    if np.any(ks < 1) or np.any(ks > k_real):
        raise ValueError(f"k_reals entries must be in [1, {k_real}], got "
                         f"{ks.tolist()}")
    guarded = mode == GUARDED_MODE
    need_farthest = empty_policy == "farthest"

    def stats_fn(need_sse: bool):
        step = make_step_fn(mesh, chunk_size=chunk_size, mode=mode,
                            need_sse=need_sse, need_farthest=need_farthest,
                            need_sse_pc=False, pipeline=pipeline,
                            audit=True)

        def member_stats(points, weights, cents, x2w=None):
            parts, flags = [], []
            for r, k_m in enumerate(ks.tolist()):
                st, flagged = step(points[r] if member_points else points,
                                   weights, cents[r, :k_m], x2w)
                if k_m < k_real:
                    pad = k_real - k_m
                    st = st._replace(
                        sums=torch.cat([st.sums, st.sums.new_zeros(
                            (pad, st.sums.shape[1]))]),
                        counts=torch.cat([st.counts,
                                          st.counts.new_zeros(pad)]),
                        sse_per_cluster=torch.cat([
                            st.sse_per_cluster,
                            st.sse_per_cluster.new_zeros(pad)]))
                parts.append(st)
                flags.append(flagged)
            return (StepStats(*(torch.stack(f) for f in zip(*parts))),
                    torch.stack(flags))

        return member_stats

    loop_stats, final_stats = stats_fn(bool(history_sse)), stats_fn(True)

    def _make_loop(ds: Dataset, points: torch.Tensor) -> _MultiLoop:
        x2w, x2w_finite = _x2w_of(ds, mode, mesh)
        real = torch.arange(k_real, device=ds.device)[None, :] < \
            torch.from_numpy(ks).to(ds.device)[:, None]
        return _MultiLoop(points, ds.weights, loop_stats,
                          ds.gather_positive, real=real, max_iter=max_iter,
                          tolerance=tolerance, empty_policy=empty_policy,
                          need_sse=bool(history_sse), x2w=x2w,
                          x2w_finite=x2w_finite, audit=guarded,
                          project=project)

    def fit(ds: Dataset, centroids0: torch.Tensor, seeds,
            points: Optional[torch.Tensor] = None) -> MultiFitResult:
        _check_backend(mesh, ds)
        if member_points != (points is not None):
            raise ValueError("points (the members' own rows) go with "
                             "member_points=True, and only with it")
        if member_points and (
                points.dim() != 3 or points.shape[0] != n_init
                or points.shape[1] != ds.points.shape[0]):
            raise ValueError(
                f"member_points needs ({n_init}, {ds.points.shape[0]}, D) "
                f"points, got {tuple(points.shape)}")
        if tuple(centroids0.shape[:2]) != (n_init, k_real) or \
                len(seeds) != n_init:
            raise ValueError(f"centroids0 must be ({n_init}, {k_real}, D) "
                             f"with one seed per member, got "
                             f"{tuple(centroids0.shape)} and "
                             f"{len(seeds)} seeds")
        key = ("multi_loop", mode, chunk_size, k_real, tuple(ks.tolist()),
               max_iter, float(tolerance), empty_policy, bool(history_sse),
               pipeline, project)
        # The members' rows are the caller's, not the dataset's: their
        # loop is built for this call, not kept in the dataset's memo.
        loop = (_make_loop(ds, points) if member_points
                else ds.memo(key, lambda: _make_loop(ds, ds.points)))
        table = None
        if empty_policy != "keep":
            table = torch.stack([
                refill_table(ds, empty_draw_keys(int(s), max_iter), k_real)
                for s in seeds])
        loop._reset(centroids0, table)
        launched = loop._drive(IN_FLIGHT)
        cents = loop.cents.clone()
        final, _ = final_stats(loop.points, ds.weights, cents, loop.x2w)
        inertias = _host_copy(final.sse)
        finite = np.array(loop.ok.cpu().numpy())
        best = int(np.argmin(np.where(np.isfinite(inertias) & finite,
                                      inertias, np.inf)))
        n_iters = np.array(loop.n_iters.cpu().numpy())
        sse_hist = _host_copy(loop.sse_hist)
        shift_hist = _host_copy(loop.shift_hist)
        counts = _host_copy(loop.counts)
        flagged = int(loop.flagged) if guarded else None
        if return_all:
            return MultiFitResult(cents, n_iters, sse_hist, shift_hist,
                                  counts, inertias, best, finite, launched,
                                  flagged)
        n = int(n_iters[best])
        return MultiFitResult(cents[best], n, sse_hist[best, :n],
                              shift_hist[best, :n], counts[best], inertias,
                              best, finite, launched, flagged)

    return fit


@_cost.program()
def make_multi_predict_fn(mesh=None, *, chunk_size: int,
                          mode: str = "matmul",
                          n_models: int) -> Callable:
    """Labels of the rows under each of M models of one shape in one pass:
    ``(points (n, D), stack (M, k, D)) -> labels (M, n)`` int32, the rank's
    rows under a mesh.  Counterpart of the JAX package's
    ``make_multi_predict_fn``: each chunk's (M, chunk, k) tile is one
    batched product.  A data axis only (the stack is whole on every rank).
    The kernel modes have no batched-model kernel and take their matmul
    forms ('kernel' -> 'matmul', 'kernel_bf16' -> 'matmul_bf16'), and the
    guarded rung its float32 class, as in the JAX package."""
    if mesh_shape(mesh)[1] != 1:
        raise ValueError(
            "make_multi_predict_fn requires a data-parallel mesh "
            f"(model_shards == 1, got {mesh_shape(mesh)[1]}); packed "
            "serving falls back to per-model dispatches under TP sharding")
    mode = value_mode({"kernel": "matmul",
                       "kernel_bf16": "matmul_bf16"}.get(mode, mode))
    if mode not in TORCH_MODES:
        raise ValueError(f"unknown distance mode: {mode!r}")

    def predict(points, stack) -> torch.Tensor:
        if stack.shape[0] != n_models:
            raise ValueError(f"expected {n_models} models, got "
                             f"{stack.shape[0]}")
        labels = torch.empty((n_models, points.shape[0]), dtype=torch.int32,
                             device=points.device)
        for lo in range(0, points.shape[0], chunk_size):
            d2 = pairwise_sq_dists(points[lo:lo + chunk_size], stack,
                                   mode=mode)
            labels[:, lo:lo + chunk_size] = torch.argmin(d2, dim=-1).to(
                torch.int32)
        return labels

    return predict


@_cost.program()
def make_assign_margin_fn(mesh=None, *, chunk_size: int,
                          mode: str = "matmul_bf16") -> Callable:
    """The serving bf16 fast path's guarded assignment: ``(points,
    centroids) -> (labels int32, margin, scale)``, one of each per row,
    chunk by chunk (counterpart of the JAX package's
    ``make_assign_margin_fn``):

    * ``labels``: argmin of the ``mode`` distances (bf16 cross term);
    * ``margin``: second-best minus best distance;
    * ``scale``: ``||x||^2 + max_k ||c_k||^2``, what the bf16 error is
      relative to.

    The engine keeps a label only where ``margin > BF16_GUARD_RTOL *
    scale`` and relabels the other rows by the float32 predict, which
    makes the served labels those of the float32 path by construction.
    The per-chunk triple is ``ops.assign.margin_chunk``, the guarded
    training rung's.  One device or a data-parallel mesh (each rank its
    rows)."""
    model_shards = mesh_shape(mesh)[1]
    if model_shards != 1:
        raise ValueError(
            "make_assign_margin_fn requires a data-parallel mesh "
            f"(model_shards == 1, got {model_shards})")
    if mode not in TORCH_MODES or mode == GUARDED_MODE:
        raise ValueError(f"unknown distance mode: {mode!r}")

    def assign(points, centroids):
        acc = _accum_dtype(points.dtype)
        ca = centroids.to(acc)
        c2max = (ca * ca).sum(dim=1).max()
        parts = [margin_chunk(points[lo:lo + chunk_size], pairwise_sq_dists(
            points[lo:lo + chunk_size], centroids, mode=mode), c2max)
            for lo in range(0, points.shape[0], chunk_size)]
        return tuple(torch.cat(col) for col in zip(*parts))

    return assign


@_cost.program()
def make_score_rows_fn(mesh=None, *, chunk_size: int,
                       mode: str = "matmul") -> Callable:
    """Per-row squared distance to the nearest centroid: ``(points,
    centroids) -> mind2`` (n,), the rank's rows under a mesh (counterpart
    of the JAX package's ``make_score_rows_fn``, the serving engine's
    scoring primitive: a request's K-Means score is minus the sum of its
    rows' slice).  The kernel modes return the assignment kernel's
    ``mind2`` (kernel 2, or 2b for 'kernel_bf16', float32); the torch
    modes the minimum of :func:`ops.assign.pairwise_sq_dists` per chunk.
    The guarded rung reports its float32 class ('matmul',
    ``ops.assign.value_mode``).  Under centroid sharding each rank scores
    its block and a MIN ``all_reduce`` over the model axis gives the
    nearest."""
    mode = value_mode(mode)
    if mode not in KERNEL_MODES and mode not in TORCH_MODES:
        raise ValueError(f"unknown distance mode: {mode!r}")
    model_shards = mesh_shape(mesh)[1]

    def score_rows(points, centroids) -> torch.Tensor:
        if model_shards > 1:
            block, _, _ = _model_block(centroids, mesh)
            _, mind2 = _assign_block(points, block, mode=mode,
                                     chunk_size=chunk_size)
            return all_reduce(mind2.clone(), mesh, (MODEL_AXIS,), "min")
        if mode in KERNEL_MODES:
            return hopper_assign(points.to(torch.float32),
                                 centroids.to(torch.float32),
                                 bf16=mode == "kernel_bf16")[1]
        return torch.cat([
            pairwise_sq_dists(points[lo:lo + chunk_size], centroids,
                              mode=mode).min(dim=1).values
            for lo in range(0, points.shape[0], chunk_size)])

    return score_rows


# ------------------------------------------------------------- mini-batch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit
    constant, in 16-bit halves so that no int64 product overflows."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser on int64 tensors holding 32-bit
    values: a bijection of [0, 2^32) that mixes every input bit into every
    output bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def minibatch_keys(seed: int) -> np.ndarray:
    """The three 32-bit keys (int64) of a mini-batch fit's draws: the
    rotation, the row within each stratum, and the reassignment
    candidates, from ``np.random.SeedSequence([seed, 0x4D42])``."""
    return np.random.SeedSequence([int(seed), 0x4D42]).generate_state(
        3).astype(np.int64)


def minibatch_streams(keys: torch.Tensor, iterations) -> torch.Tensor:
    """The hash words (int64 (..., 3)) of ``iterations`` (an int or an
    int64 tensor of any shape) under a fit's ``keys``: one word for each
    draw of an iteration, the rotation, the rows and the candidates.  A
    loop makes the words of all its iterations at once, before its first:
    an iteration then reads its row, and does not hash a scalar on the
    device."""
    it = torch.as_tensor(iterations, dtype=torch.int64, device=keys.device)
    return _fmix32(keys ^ _fmix32(it & _M32)[..., None])


def minibatch_rows(n: int, batch: int, stream: torch.Tensor,
                   shard: int = 0) -> torch.Tensor:
    """Rows (int64 (batch,)) of the batch of the iteration whose hash words
    are ``stream`` (:func:`minibatch_streams`): the JAX package's
    ``_sample_batch`` rule.  The n rows are cut into ``batch`` strata of
    ``n // batch`` rows, one row is drawn in each, and the whole is
    rotated by a draw in [0, n), so the rows are distinct and every row can
    be drawn.  The draws are hashes of ``(seed, iteration, stratum)``
    (:func:`_fmix32`), a pure function of the seed and the absolute
    iteration: integer tensor ops, no generator and no read to the host,
    the same rows on the CPU and the card, and capturable in a CUDA graph.
    (The JAX package draws with ``jax.random``, threefry, so its rows are
    other rows.)

    Under a mesh ``n`` is the rows of a block and ``shard`` its index on
    the data axis: the strata are hashed at their position in the whole
    batch, ``shard * batch + j``, and the rotation under a word of the
    shard's own, so the blocks draw independently; shard 0 draws what one
    device draws."""
    if not 1 <= batch <= n < 2 ** 31:
        raise ValueError(f"need 1 <= batch <= n < 2^31, got batch={batch},"
                         f" n={n}")
    stratum = n // batch
    rot = stream[0] if shard == 0 else _fmix32(stream[0] ^ shard)
    rho = (rot * n) >> 32
    j = torch.arange(batch, dtype=torch.int64, device=stream.device)
    r = (_fmix32(stream[1] ^ (j + shard * batch)) * stratum) >> 32
    return (j * stratum + r + rho) % n


def _top_candidates(bw: torch.Tensor, stream: torch.Tensor, kc: int,
                    first: int = 0):
    """The ``kc`` highest candidate scores of the batch's rows and their
    positions: each row's score is a hash of ``(seed, iteration, first +
    position)``, distinct for distinct positions (a bijection), -1 for a
    row of weight 0."""
    j = torch.arange(bw.shape[0], dtype=torch.int64, device=bw.device)
    score = _fmix32(stream[2] ^ (j + first))
    score = torch.where(bw > 0, score, torch.full_like(score, -1))
    return torch.topk(score, kc)


def _batch_candidates(bw: torch.Tensor, stream: torch.Tensor, n_cand: int):
    """Up to ``n_cand`` distinct positive-weight rows of the batch,
    uniformly (the JAX package's ``_batch_candidates``): positions in the
    batch (int64 (n_cand,)) and their validity (False on tail slots when
    the batch has fewer positive rows).  The candidates are the top scores
    (:func:`_top_candidates`) in order.  No ties, so ``torch.topk`` picks
    the same rows on every device."""
    kc = min(n_cand, bw.shape[0])
    top, idx = _top_candidates(bw, stream, kc)
    valid = top >= 0
    if kc < n_cand:
        pad = n_cand - kc
        idx = torch.cat([idx, idx.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return idx, valid


def _mesh_candidates(bx: torch.Tensor, bw: torch.Tensor,
                     stream: torch.Tensor, n_cand: int, mesh, shard: int):
    """:func:`_batch_candidates` of the whole batch of a mesh, from each
    block's share ``(bx, bw)``, as rows (n_cand, D) and validity on every
    rank: each block's top scores at their positions in the whole batch,
    embedded with their rows in a zero table of every block's slots, one
    SUM ``all_reduce`` over the data axis (each slot is written by one
    block, and adding zeros is exact; the float64 table holds the 32-bit
    scores exactly), then the top scores of the table.  Any top candidate
    of the whole batch is among its block's top ``n_cand``, so these are
    the rows that :func:`_batch_candidates` picks on the whole batch."""
    data = mesh_shape(mesh)[0]
    b, d = bx.shape
    kc = min(n_cand, b)
    top, idx = _top_candidates(bw, stream, kc, shard * b)
    table = torch.zeros((data, kc, d + 1), dtype=torch.float64,
                        device=bx.device)
    table[shard, :, :d] = bx.index_select(0, idx).to(torch.float64)
    table[shard, :, d] = top.to(torch.float64)
    table = all_reduce(table, mesh, (DATA_AXIS,)).reshape(data * kc, d + 1)
    m = min(n_cand, data * kc)
    top, j = torch.topk(table[:, d], m)
    rows = table.index_select(0, j)[:, :d].to(bx.dtype)
    valid = top >= 0
    if m < n_cand:
        pad = n_cand - m
        rows = torch.cat([rows, rows.new_zeros((pad, d))])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return rows, valid


def apply_reassignment(new, seen, cand_rows, cand_valid, do_re,
                       ratio: float):
    """Low-count reassignment (the JAX package's ``apply_reassignment``):
    with ``do_re``, the centres whose lifetime count ``seen`` is below
    ``ratio * max(seen)`` take the candidate rows in slot order, and their
    counts become the least count of the kept centres.  Returns ``(new,
    seen)``."""
    n_cand = cand_rows.shape[0]
    flagged = (seen < ratio * seen.max()) & do_re
    rank = torch.cumsum(flagged.to(torch.int64), 0) - 1
    take = rank.clamp(0, n_cand - 1)
    ok = flagged & (rank < n_cand) & cand_valid.index_select(0, take)
    new = torch.where(ok[:, None],
                      cand_rows.to(new.dtype).index_select(0, take), new)
    keep_min = torch.where(~flagged, seen,
                           torch.full_like(seen, float("inf"))).min()
    keep_min = torch.where(torch.isfinite(keep_min), keep_min,
                           torch.zeros_like(keep_min))
    return new, torch.where(ok, keep_min, seen)


def _check_minibatch_mode(mode: str) -> None:
    """The mini-batch engines take every mode but the guarded rung (the
    JAX package's rule and message)."""
    if mode == GUARDED_MODE:
        raise ValueError(
            "distance_mode='matmul_bf16_guarded' applies to the "
            "full-batch Lloyd engines (KMeans/SphericalKMeans fit "
            "paths); the mini-batch Sculley engines run the f32-class "
            "modes — use 'matmul' (exact) or 'matmul_bf16' (unguarded)")


@_cost.program()
def make_minibatch_step_fn(mesh=None, *, batch: int, mode: str = "matmul",
                           chunk_size: Optional[int] = None,
                           n_candidates: int = 0,
                           need_sse: bool = True) -> Callable:
    """One mini-batch pass: ``(points, weights, centroids, stream) ->
    (StepStats, cand_rows, cand_valid)`` of the batch that the iteration's
    hash words ``stream`` draw (:func:`minibatch_rows`), passed through
    :func:`make_step_fn` at the batch's size: kernel 1 (1b) on the gathered
    batch in the kernel modes.  Its SSE is of the batch (the kernel modes'
    algebraic SSE takes the batch's own ``sum w ||x||^2``, never the
    dataset's).  With ``n_candidates`` it also returns that many
    reassignment candidates (:func:`_batch_candidates`), else None twice.

    Under a ``mesh`` (the JAX package's rule) ``points`` and ``weights``
    are the rank's block and ``batch`` the rows each block draws: every
    rank of the data axis draws its own share from its own block, the
    step's statistics are those of the whole batch (reduced over the mesh
    as :func:`make_step_fn` reduces them), and the candidates are drawn
    from the whole batch (:func:`_mesh_candidates`).  The ranks of a model
    axis draw the same rows."""
    _check_minibatch_mode(mode)
    shard = coords(mesh)[0] if mesh is not None else 0
    base = make_step_fn(mesh, chunk_size=chunk_size or batch, mode=mode,
                        need_sse=need_sse, need_farthest=False,
                        need_sse_pc=False)

    def step(points, weights, centroids, stream):
        rows = minibatch_rows(points.shape[0], batch, stream, shard)
        bx, bw = points.index_select(0, rows), weights.index_select(0, rows)
        st = base(bx, bw, centroids, None)
        if n_candidates <= 0:
            return st, None, None
        if mesh is not None:
            return (st,) + _mesh_candidates(bx, bw, stream, n_candidates,
                                            mesh, shard)
        cidx, valid = _batch_candidates(bw, stream, n_candidates)
        return st, bx.index_select(0, cidx), valid

    return step


class MiniBatchFitResult(NamedTuple):
    """What the mini-batch loop hands back to the host, once per fit."""

    centroids: torch.Tensor      # (k, D), accumulation dtype, on the device
    seen: np.ndarray             # (k,) float64 lifetime counts
    n_iters: int                 # iterations that ran (not masked)
    sse_history: np.ndarray      # (n_iters,) scaled batch SSE estimates
    shift_history: np.ndarray    # (n_iters,) largest shifts
    counts: np.ndarray           # (k,) the last batch's counts
    finite: bool                 # False: iteration n_iters went non-finite
    launched: int                # iterations launched, masked ones too


class _MiniBatchLoop(_DeviceLoop):
    """The mini-batch loop's state on one dataset and one iteration over
    it: the batch pass, the Sculley update in the accumulation dtype, the
    reassignment every ``every`` iterations, the shift test.  Every tensor
    an iteration reads across iterations (the hash words of every
    iteration and the iteration counter too) lives here, so one captured
    iteration replays them."""

    def __init__(self, ds: Dataset, step, *, k, max_iter, tolerance,
                 need_sse, ratio, every):
        # A bucket's padding rows (weight 0, after the real ones on one
        # device) are left out of the draws, so a bucketed fit draws the
        # rows of the exact-shape one; a mesh's blocks keep theirs.
        points, weights = ds.points, ds.weights
        if ds.mesh is None and points.shape[0] != ds.n:
            points, weights = points[: ds.n], weights[: ds.n]
        super().__init__(points, weights, step, None, k=k,
                         max_iter=max_iter, tolerance=tolerance,
                         empty_policy="keep", need_sse=need_sse, x2w=None,
                         x2w_finite=None)
        acc = _accum_dtype(ds.points.dtype)
        self.seen = torch.zeros((k,), dtype=acc, device=ds.device)
        self.streams = torch.zeros((max_iter, 3), dtype=torch.int64,
                                   device=ds.device)
        self.w_total = all_reduce(weights.to(acc).sum().reshape(1),
                                  ds.mesh, (DATA_AXIS,))[0]
        self.ratio, self.every = float(ratio), int(every)

    def iterate(self) -> None:
        """One mini-batch iteration, masked by ``running``; nothing is read
        to the host."""
        active = self.running.clone()
        row = torch.clamp(self.it, max=self.max_iter - 1).reshape(1)
        st, cand_rows, cand_valid = self.step(
            self.points, self.weights, self.cents.to(self.points.dtype),
            self.streams.index_select(0, row)[0])
        counts = st.counts
        seen = self.seen + counts
        eta = (counts / torch.clamp_min(seen, 1.0))[:, None]
        bmean = st.sums / torch.clamp_min(counts, 1.0)[:, None]
        new = torch.where((counts > 0)[:, None],
                          (1.0 - eta) * self.cents + eta * bmean, self.cents)
        if self.ratio > 0:
            do_re = ((self.it + 1) % self.every) == 0
            new, seen = apply_reassignment(new, seen, cand_rows, cand_valid,
                                           do_re, self.ratio)
        diff = new - self.cents
        shift = torch.sqrt((diff * diff).sum(dim=1)).max()
        ok = torch.isfinite(new).all()
        sse = (st.sse * self.w_total / torch.clamp_min(counts.sum(), 1.0)
               if self.need_sse else st.sse)
        at = (self.iters == self.it) & active
        self.sse_hist.copy_(torch.where(at, sse, self.sse_hist))
        self.shift_hist.copy_(torch.where(at, shift, self.shift_hist))
        self.cents.copy_(torch.where(active, new, self.cents))
        self.seen.copy_(torch.where(active, seen, self.seen))
        self.counts.copy_(torch.where(active, counts, self.counts))
        self.shift.copy_(torch.where(active, shift, self.shift))
        self.ok.copy_(self.ok & (ok | ~active))
        self.it.add_(active.to(torch.int64))
        self.running.copy_((self.it < self.stop)
                           & (self.shift >= self.tolerance) & self.ok)

    def _reset(self, centroids0: torch.Tensor, keys: np.ndarray,
               start: int = 0, stop: Optional[int] = None,
               seen0: Optional[torch.Tensor] = None) -> None:
        """The state of a run of iterations ``start .. stop - 1`` from
        ``centroids0`` and the lifetime counts ``seen0`` (zeros: a fresh
        fit); the hash words of every iteration, absolute."""
        super()._reset(centroids0, None, start, stop)
        if seen0 is None:
            self.seen.zero_()
        else:
            self.seen.copy_(seen0)
        self.streams.copy_(minibatch_streams(
            torch.from_numpy(keys).to(self.streams.device), self.iters))

    def result(self, launched: int, start: int = 0) -> MiniBatchFitResult:
        end = int(self.it)
        return MiniBatchFitResult(
            self.cents.clone(), _host_copy(self.seen), end - start,
            _host_copy(self.sse_hist[start:end]),
            _host_copy(self.shift_hist[start:end]),
            _host_copy(self.counts), bool(self.ok), launched)


@_cost.program(loop=True)
def make_minibatch_fit_fn(mesh=None, *, batch: int, mode: str = "matmul",
                          k: int, max_iter: int, tolerance: float,
                          history_sse: bool = True,
                          reassignment_ratio: float = 0.0,
                          reassign_every: int = 1,
                          chunk_size: Optional[int] = None,
                          host_loop: bool = False) -> Callable:
    """The mini-batch loop: ``fit(ds, centroids0, seed, on_iteration=None)
    -> MiniBatchFitResult``.  Counterpart of the JAX package's
    ``make_minibatch_fit_fn`` and, with ``host_loop``, of its
    per-iteration engine.  ``batch`` is the rows each block of the data
    axis draws (:func:`make_minibatch_step_fn`; the whole batch without a
    mesh).

    Each iteration: the batch of :func:`make_minibatch_step_fn` (kernel 1
    (1b) on the gathered batch in the kernel modes), ``seen += counts``,
    the Sculley update ``c <- (1 - eta) c + eta * mean`` with ``eta =
    counts / seen`` where the batch reached the centre, the reassignment
    every ``reassign_every`` iterations when ``reassignment_ratio > 0``
    (:func:`apply_reassignment`), the largest shift, the SSE estimate
    scaled by the total weight over the batch's, the all-finite flag.  It
    stops at ``max_iter``, at a shift below ``tolerance`` or at a
    non-finite update.

    ``host_loop=False`` launches iterations until the host reads a done
    flag, one captured CUDA graph per iteration on the card (the loop
    state is kept with the dataset, ``Dataset.memo``).  ``fit(...,
    start=, stop=, seen0=)`` runs iterations ``start .. stop - 1`` from
    the lifetime counts ``seen0``: the draws and the reassignment cadence
    are keyed by the absolute iteration, so a segment of a checkpointed
    fit, or a resumed one, gives the uninterrupted fit's bits and replays
    its graph.  ``on_iteration`` gets the absolute iteration.
    ``host_loop=True`` launches the same iteration eagerly, one at a time,
    calls
    ``on_iteration(loop, i)`` after each and reads its flag: the same
    operations on the same state, so both engines give the same bits in
    every dtype.  (The JAX package's per-iteration engine interpolates in
    float64 on the host and meets its loop in float64 only.)  Under a
    ``mesh`` the statistics and the candidates reduce over the mesh inside
    the iteration; the captured loop on CUDA tensors then needs NCCL, as
    :func:`make_fit_fn`'s does."""
    _check_minibatch_mode(mode)
    step = make_minibatch_step_fn(
        mesh, batch=batch, mode=mode, chunk_size=chunk_size,
        n_candidates=k if reassignment_ratio > 0 else 0,
        need_sse=bool(history_sse))

    def fit(ds: Dataset, centroids0: torch.Tensor, seed: int,
            on_iteration=None, start: int = 0, stop: Optional[int] = None,
            seen0: Optional[torch.Tensor] = None) -> MiniBatchFitResult:
        if ds.mesh is not mesh:
            raise ValueError(f"the dataset was placed with mesh="
                             f"{ds.mesh!r}, the loop built for {mesh!r}")
        key = ("minibatch_loop", mode, batch, chunk_size, k, max_iter,
               float(tolerance), bool(history_sse),
               float(reassignment_ratio), int(reassign_every))
        if not host_loop:
            _check_backend(mesh, ds)
        loop = ds.memo(key, lambda: _MiniBatchLoop(
            ds, step, k=k, max_iter=max_iter,
            tolerance=tolerance, need_sse=bool(history_sse),
            ratio=reassignment_ratio, every=reassign_every))
        stop = max_iter if stop is None else stop

        def run():
            loop._reset(centroids0, minibatch_keys(seed), start, stop, seen0)
            if not host_loop:
                return loop.result(loop._drive(IN_FLIGHT, stop - start),
                                   start)
            launched = 0
            while launched < stop - start:
                # The span holds the iteration and the reads of its state
                # (the per-iteration engine's sync points).
                with _obs_trace.span("dispatch", tag="minibatch/step",
                                     iteration=start + launched):
                    loop._eager(_cost.take_request())
                    launched += 1
                    if on_iteration is not None:
                        on_iteration(loop, start + launched - 1)
                    go = bool(loop.running)
                if not go:
                    break
            return loop.result(launched, start)

        return _run_evicting(ds, key, loop, run)

    return fit


# --------------------------------------------------------------- transform


@_cost.program()
def make_transform_fn(mesh=None, *, chunk_size: int,
                      mode: str = "matmul") -> Callable:
    """``(points, centroids) -> (n, k)`` Euclidean distances in the points'
    dtype, chunk by chunk: :func:`ops.assign.pairwise_sq_dists` (the
    expanded form through ``torch.matmul``, clamped at 0), then ``sqrt``.
    Counterpart of the JAX package's ``make_transform_fn``; like it, the
    pass is plain torch (no kernel computes distances as an output), so
    ``mode`` is a torch mode: ``'matmul'``, ``'matmul_bf16'`` or
    ``'direct'``.

    The guarded rung reports the 'matmul' distances
    (``ops.assign.value_mode``).

    Under a ``mesh`` every rank passes the same rows: each computes the
    tile of its data block of the rows and its block of the table, and a
    SUM ``all_reduce`` of the tiles, zeros elsewhere, gives every rank the
    whole (n, k)."""
    mode = value_mode(mode)
    if mode not in TORCH_MODES:
        raise ValueError(f"unknown distance mode: {mode!r}")

    def dists(points, centroids, out, lo, hi, col):
        for start in range(lo, hi, chunk_size):
            stop = min(start + chunk_size, hi)
            d2 = pairwise_sq_dists(points[start:stop], centroids, mode=mode)
            out[start:stop, col:col + centroids.shape[0]] = torch.sqrt(
                d2).to(points.dtype)
        return out

    def transform(points, centroids) -> torch.Tensor:
        n, k = points.shape[0], centroids.shape[0]
        if mesh is None:
            out = torch.empty((n, k), dtype=points.dtype,
                              device=points.device)
            return dists(points, centroids, out, 0, n, 0)
        block, first, k_pad = _model_block(centroids, mesh)
        rows = -(-n // mesh_shape(mesh)[0])
        lo = min(coords(mesh)[0] * rows, n)
        out = torch.zeros((n, k_pad), dtype=points.dtype,
                          device=points.device)
        dists(points, block, out, lo, min(lo + rows, n), first)
        return all_reduce(out, mesh, AXES)[:, :k]

    return transform
