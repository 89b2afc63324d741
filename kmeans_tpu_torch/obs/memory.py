"""Device-memory planner: a fit's peak bytes on one rank, predicted from
the shapes, and the slab geometry of the staged ingest.

Counterpart of ``kmeans_tpu/obs/memory.py``: :func:`plan_fit` for the five
families, :func:`plan_ingest`, :data:`INGEST_SLAB_TARGET_BYTES`,
:func:`device_memory_info`, the advisory pre-dispatch check
:func:`advise_dispatch` and :func:`format_plan_table`.  ``records``
(``obs.cost.CostRecord`` objects) join a plan as the measured
``observed_peak_bytes`` of the family's programs.

:func:`plan_ingest` is the reference's arithmetic, unchanged.
:func:`plan_fit` keeps the reference's keys and its split into a resident
part (the dataset and the table, alive for the whole fit) and a temporary
part (what one step allocates), but its byte terms are those of this port's
allocations, which differ from the XLA buffers the reference models:

* rows are not padded to a multiple of the chunk (the torch passes take a
  short last chunk, the kernels mask their own edge): a rank holds
  ``ceil(n / data)`` rows;
* every rank holds the whole (k, D) table (the host loop puts it on each
  device; a model-axis step takes its block of it), where the reference
  holds one block;
* the torch modes ('matmul', 'matmul_bf16', 'direct', the guarded rung)
  keep four (chunk, k) tiles in the accumulation type alive at a chunk's
  peak (the expanded distance form's product, its two partial sums and the
  weighted one-hot of the scatter), where the reference counts two float32
  tiles;
* the kernel modes form no tile: the fused kernel (kernel 1) writes
  per-block tables of ``k (D + 1)`` floats, one per persistent block (two
  per SM, at most one per 128 rows, within a 2 GiB budget), plus labels and
  minimum distances per row; under a model axis the assignment kernel
  (kernel 2) writes labels and distances only;
* the k-sharded step (``k_shard``) keeps the (k/M, D) block of the
  statistics, as the reference's does, and scores a (chunk, k/M) tile;
* ``"spherical"`` and ``"bisecting"`` run K-Means' step, so they plan as
  ``"kmeans"``; ``"minibatch"`` scores its batch (the tile's rows are the
  batch's) and holds the batch's rows, the reference's ``batch_bytes``;
* ``"gmm"`` keeps the reference's terms in the torch E pass (the (chunk,
  k) log-density and responsibility tiles, two (chunk, D) moment
  buffers); in the kernel mode (``diag_estep``, float32 'diag' and
  'spherical' on a card) it forms no tile: its persistent blocks write
  tables of ``k (2 ceil8(D) + 2)`` floats and one double each, beside the
  split coefficients (``4 k ceil8(D)`` floats);
* the two-level step (``assign='two_level'``) forms no (chunk, k) tile:
  its terms are the (chunk, C) coarse tile, the (C, L, D) member table,
  the (row, cell) pairs of a chunk, a cell's (rows, L) tile (up to every
  row of the chunk, in slices of ``TWO_LEVEL_TILE_ELEMS // L`` rows) and
  the gathered rows, and each row's best distance and index
  (``parallel.distributed.make_two_level_step_fn``).

``chip_smoke.py`` (phase ``large_k``) holds ``predicted_peak_bytes``
against ``torch.cuda.max_memory_allocated`` on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from kmeans_tpu_torch.obs import trace as _trace
from kmeans_tpu_torch.obs.metrics_registry import REGISTRY

__all__ = ["plan_fit", "plan_ingest", "device_memory_info",
           "advise_dispatch", "format_plan_table", "FAMILIES",
           "INGEST_SLAB_TARGET_BYTES"]

#: The families the planner models (the reference's five).
FAMILIES = ("kmeans", "spherical", "bisecting", "minibatch", "gmm")

_DTYPE_BYTES = {"float32": 4, "float64": 8, "bfloat16": 2, "float16": 2}

#: The fused kernel's launch geometry (``ops.hopper_kernels``): rows of a
#: block's tile, persistent blocks per SM, the per-block tables' budget.
_TILE_ROWS = 128
_BLOCKS_PER_SM = 2
_PARTIAL_BUDGET_BYTES = 2 << 30
#: SMs of an H100 SXM, where the caller names no device.
_DEFAULT_SMS = 132
_KERNEL_MODES = ("kernel", "kernel_bf16")


def _itemsize(dtype) -> int:
    name = getattr(dtype, "name", None) or str(dtype)
    return _DTYPE_BYTES.get(name.replace("np.", "").replace("torch.", ""), 4)


def _sms(device) -> int:
    if device is None or torch.device(device).type != "cuda":
        return _DEFAULT_SMS
    return torch.cuda.get_device_properties(
        torch.device(device)).multi_processor_count


def plan_fit(family: str, n: int, d: int, k: int, *,
             data_shards: int = 1, model_shards: int = 1,
             dtype="float32", chunk: Optional[int] = None,
             cov_type: str = "diag", batch: Optional[int] = None,
             pipeline: int = 0, k_shard: int = 0, mode: str = "matmul",
             assign: str = "dense", coarse_cells: Optional[int] = None,
             nprobe: Optional[int] = None,
             member_width: Optional[int] = None, device=None,
             records=None) -> dict:
    """Predict one rank's peak device bytes for a family's fit at a shape.

    The reference's keys (``components``, ``predicted_resident_bytes``,
    ``predicted_temp_bytes``, ``predicted_peak_bytes``,
    ``observed_peak_bytes``, ...), with the port's byte terms (see the
    module's docstring).  ``chunk`` is the torch passes' chunk (None: all
    the rank's rows); ``pipeline`` doubles the tile (two chunks in
    flight).  ``mode`` is the resolved distance mode (the mixture's:
    'torch' or 'kernel'), ``k_shard`` the resolved knob, ``assign``
    'dense' or 'two_level' with its ``coarse_cells`` C, ``nprobe`` and
    member-list width ``member_width`` L (None: the width of balanced
    cells, ``sharding.bucket_candidates(ceil(k / C))``).  ``cov_type`` is
    the mixture's, ``batch`` the mini-batch's rows.  ``device`` gives the
    SM count of the kernel's launch (None: an H100's 132).  ``records``
    (cost records) give ``observed_peak_bytes``, the largest measured peak
    of the family's programs."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; families: "
                         f"{FAMILIES}")
    if family == "gmm":
        plan = _plan_gmm(n, d, k, data_shards=data_shards,
                         model_shards=model_shards, dtype=dtype,
                         chunk=chunk, cov_type=cov_type, pipeline=pipeline,
                         mode=mode, device=device)
    else:
        plan = _plan_kmeans(family, n, d, k, data_shards=data_shards,
                            model_shards=model_shards, dtype=dtype,
                            chunk=chunk, batch=batch, pipeline=pipeline,
                            k_shard=k_shard, mode=mode, assign=assign,
                            coarse_cells=coarse_cells, nprobe=nprobe,
                            member_width=member_width, device=device)
    observed = _observed_peak(family, records)
    if observed is not None:
        plan["observed_peak_bytes"] = observed
    return plan


def _kernel_blocks(rows: int, table_floats: int, device) -> int:
    """Persistent blocks of a kernel launch over ``rows`` rows, each
    writing a table of ``table_floats`` floats (``hopper_kernels._blocks``
    at two blocks per SM)."""
    return max(1, min(_BLOCKS_PER_SM * _sms(device), -(-rows // _TILE_ROWS),
                      _PARTIAL_BUDGET_BYTES // (4 * table_floats)))


def _finish(comp: Dict[str, int], **fields) -> dict:
    resident = sum(comp[key] for key in ("points_bytes", "weights_bytes",
                                         "table_bytes"))
    temp = sum(v for key, v in comp.items()
               if key not in ("points_bytes", "weights_bytes",
                              "table_bytes"))
    return dict(fields, components=comp,
                predicted_resident_bytes=resident,
                predicted_temp_bytes=temp,
                predicted_peak_bytes=resident + temp,
                observed_peak_bytes=None)


def _plan_gmm(n, d, k, *, data_shards, model_shards, dtype, chunk,
              cov_type, pipeline, mode, device) -> dict:
    item = _itemsize(dtype)
    data_shards = max(1, int(data_shards))
    model_shards = max(1, int(model_shards))
    rows_local = -(-int(n) // data_shards)
    tile_rows = min(int(chunk), rows_local) if chunk else rows_local
    k_pad = -(-int(k) // model_shards) * model_shards
    k_local = k_pad // model_shards
    cov_elems = {"diag": k_local * d, "spherical": k_local,
                 "tied": d * d, "full": k_local * d * d}
    if cov_type not in cov_elems:
        raise ValueError(f"unknown covariance type {cov_type!r}")
    comp: Dict[str, int] = {
        "points_bytes": rows_local * d * item,
        "weights_bytes": rows_local * item,
        "table_bytes": (2 * k_local * d + k_local
                        + cov_elems[cov_type]) * item,
    }
    if mode == "kernel":
        d8 = -(-int(d) // 8) * 8
        table = k_local * (2 * d8 + 2)
        blocks = _kernel_blocks(rows_local, table, device)
        comp["tile_bytes"] = blocks * (table * 4 + 8) + 4 * k_local * d8 * 4
    else:
        comp["tile_bytes"] = (2 * tile_rows * k_local
                              + 2 * tile_rows * d) * 4
    comp["stats_bytes"] = (2 * k_local * d + k_local
                           + cov_elems[cov_type]) * 4
    if pipeline:
        comp["tile_bytes"] *= 2
    return _finish(comp, family="gmm", n=int(n), d=int(d), k=int(k),
                   cov_type=cov_type, data_shards=data_shards,
                   model_shards=model_shards,
                   dtype=str(getattr(dtype, "name", dtype)),
                   chunk=tile_rows, pipeline=int(bool(pipeline)),
                   k_shard=0, mode="kernel" if mode == "kernel" else "torch",
                   assign="dense")


def _plan_kmeans(family, n, d, k, *, data_shards, model_shards, dtype,
                 chunk, batch, pipeline, k_shard, mode, assign,
                 coarse_cells, nprobe, member_width, device) -> dict:
    from kmeans_tpu_torch.parallel.sharding import bucket_candidates
    item = _itemsize(dtype)
    acc = 8 if item == 8 else 4
    data_shards = max(1, int(data_shards))
    model_shards = max(1, int(model_shards))
    rows_local = -(-int(n) // data_shards)
    scored = int(batch) if (family == "minibatch" and batch) \
        else rows_local
    tile_rows = min(int(chunk), scored) if chunk else scored
    k_pad = -(-int(k) // model_shards) * model_shards
    k_local = k_pad // model_shards
    comp: Dict[str, int] = {
        "points_bytes": rows_local * d * item,
        "weights_bytes": rows_local * item,
        "table_bytes": k_pad * d * item,
    }
    if assign == "two_level":
        C = min(int(coarse_cells or max(2, round(k ** 0.5))), int(k))
        npb = min(int(nprobe or max(1, -(-C // 8))), C)
        L = int(member_width or bucket_candidates(-(-int(k) // C)))
        comp["coarse_bytes"] = C * d * item
        comp["member_bytes"] = C * L * (d * item + 8)
        # The (chunk, C) coarse tile, or a cell's (rows, L) tile, rows up
        # to the whole chunk (a hub cell) in slices of TWO_LEVEL_TILE_ELEMS
        # // L; the gathered rows and the (row, cell) pairs.
        from kmeans_tpu_torch.parallel.distributed import \
            TWO_LEVEL_TILE_ELEMS
        cell_rows = min(tile_rows, max(1, TWO_LEVEL_TILE_ELEMS // L))
        comp["tile_bytes"] = (4 * max(tile_rows * C, cell_rows * L) * acc
                              + tile_rows * (d * acc + npb * 16))
        comp["row_best_bytes"] = rows_local * (acc + 8)
        comp["stats_bytes"] = (k_pad * d + 2 * k_pad) * acc
    else:
        kernel = mode in _KERNEL_MODES
        if kernel and model_shards == 1:
            table = int(k) * (d + 1)
            blocks = _kernel_blocks(scored, table, device)
            comp["tile_bytes"] = (blocks * table * 4
                                  + scored * 8 + int(k) * 4)
        elif kernel:
            comp["tile_bytes"] = scored * 8 + k_local * 4 + \
                tile_rows * k_local * acc
        else:
            comp["tile_bytes"] = 4 * tile_rows * k_local * acc
        # The dense model-axis step embeds its block in the whole padded
        # table; the k-sharded step keeps its block only.
        k_stats = k_local if (k_shard and model_shards > 1) else k_pad
        comp["stats_bytes"] = (k_stats * d + 2 * k_stats) * acc
    if pipeline:
        comp["tile_bytes"] *= 2            # two chunk tiles in flight
    if family == "minibatch" and batch:
        comp["batch_bytes"] = int(batch) * d * item
    return _finish(comp, family=family, n=int(n), d=int(d), k=int(k),
                   cov_type=None, data_shards=data_shards,
                   model_shards=model_shards,
                   dtype=str(getattr(dtype, "name", dtype)),
                   chunk=min(int(chunk), rows_local) if chunk
                   else rows_local, pipeline=int(bool(pipeline)),
                   k_shard=int(k_shard), mode=mode, assign=assign)


#: Bytes of host-to-device copy the staged ingest keeps in one slab (the
#: reference's 64 MiB), capped at 1/8 of the device's free bytes where the
#: device reports them.
INGEST_SLAB_TARGET_BYTES = 64 << 20


def plan_ingest(n: int, d: int, *, data_shards: int = 1,
                chunk: int = 1, dtype="float32", device=None) -> dict:
    """Slab geometry of the staged ingest, the reference's arithmetic: rows
    pad to ``data_shards * chunk`` multiples, a shard holds ``n_pad /
    data_shards`` rows, a slab groups whole shards up to ``target_bytes``
    (:data:`INGEST_SLAB_TARGET_BYTES`, capped at 1/8 of the free bytes
    :func:`device_memory_info` reports for ``device``).

    In the port one rank holds one shard, so the reference's grouping gives
    one slab per rank: ``parallel.sharding`` cuts the rank's own rows into
    slabs of ``target_bytes`` instead (ROADMAP.md, "Differences by
    design")."""
    item = _itemsize(dtype)
    data_shards = max(1, int(data_shards))
    chunk = max(1, int(chunk))
    mult = data_shards * chunk
    n_pad = -(-int(n) // mult) * mult
    shard_rows = n_pad // data_shards
    shard_bytes = shard_rows * int(d) * item
    target = INGEST_SLAB_TARGET_BYTES
    free = device_memory_info(device)
    if free.get("available") and free.get("bytes_free"):
        target = min(target, max(free["bytes_free"] // 8, 1))
    slab_shards = max(1, min(data_shards,
                             target // max(shard_bytes, 1)))
    slabs = -(-data_shards // slab_shards)
    return {
        "n": int(n), "d": int(d), "n_pad": n_pad,
        "data_shards": data_shards, "chunk": chunk,
        "dtype": str(getattr(dtype, "name", dtype)),
        "shard_rows": shard_rows, "shard_bytes": shard_bytes,
        "slab_shards": slab_shards, "slabs": slabs,
        "slab_rows": slab_shards * shard_rows,
        "slab_bytes": slab_shards * shard_bytes,
        "target_bytes": target,
        "total_bytes": n_pad * int(d) * item,
    }


def device_memory_info(device=None) -> dict:
    """``{"available", "bytes_limit", "bytes_in_use", "bytes_free"}`` of a
    CUDA device (None: the current one): the card's total bytes
    (``torch.cuda.mem_get_info``), the bytes of live buffers, and the
    rest.  ``bytes_free`` is the card's free bytes plus what this
    process's caching allocator has reserved but holds no tensor in
    (``memory_reserved - memory_allocated``), which a new allocation
    reuses; the reference's ``bytes_in_use`` likewise counts live buffers
    only.  Other processes' bytes count as in use.  A CPU device, or a
    machine without CUDA, reports ``available: False``, as the
    reference's CPU backend does."""
    none = {"available": False, "bytes_limit": None, "bytes_in_use": None,
            "bytes_free": None}
    if device is not None and torch.device(device).type != "cuda":
        return none
    if not torch.cuda.is_available():
        return none
    try:
        free, total = torch.cuda.mem_get_info(device)
        idle = (torch.cuda.memory_reserved(device)
                - torch.cuda.memory_allocated(device))
    except RuntimeError as e:
        return dict(none, error=f"{type(e).__name__}: {e}")
    free = int(free + max(idle, 0))
    return {"available": True, "bytes_limit": int(total),
            "bytes_in_use": int(total - free), "bytes_free": free}


#: family -> the builders whose programs carry that family's footprint
#: (the join between a plan and the cost records).
_FAMILY_CACHES = {
    "kmeans": ("make_step_fn", "make_fit_fn", "make_multi_fit_fn",
               "make_kshard_step_fn", "make_two_level_step_fn"),
    "spherical": ("make_step_fn", "make_fit_fn", "make_multi_fit_fn"),
    "bisecting": ("make_step_fn", "make_fit_fn"),
    "minibatch": ("make_minibatch_step_fn", "make_minibatch_fit_fn"),
    "gmm": ("make_gmm_step_fn", "make_gmm_step_full_fn",
            "make_gmm_step_tied_fn", "make_gmm_fit_fn",
            "make_gmm_multi_fit_fn"),
}


def _observed_peak(family: str, records) -> Optional[int]:
    """The largest available peak among the records of the family's
    programs (the step or the loop dominates)."""
    if not records:
        return None
    caches = _FAMILY_CACHES.get(family)
    peaks = [r.peak_bytes for r in records
             if r.available and r.peak_bytes is not None
             and (caches is None or r.cache in caches)]
    return max(peaks) if peaks else None


def advise_dispatch(model, chunk: int, segment: int = 0) -> Optional[dict]:
    """The reference's advisory pre-dispatch check for
    ``_dispatch_oom_safe``: with a tracer active, the (chunk, k) tile's
    bytes and the table's from the model's host attributes, against the
    free bytes of the model's device, as a ``mem.plan`` event and the
    ``fit.mem_planned_chunk`` gauge.  None without a tracer (one check).
    Advisory only: never raises and never changes the chunk."""
    if not _trace.active():
        return None
    try:
        k = getattr(model, "k", None) or getattr(model, "n_components",
                                                 None)
        cents = getattr(model, "centroids", None)
        if cents is None:
            cents = getattr(model, "means_", None)
        d = int(cents.shape[1]) if cents is not None \
            and getattr(cents, "ndim", 0) == 2 else None
        tile = int(chunk) * int(k) * 4 if k else None
        table = int(k) * d * 4 if (k and d) else None
        free = device_memory_info(getattr(model, "device", None))
        advisory = {
            "segment": int(segment), "chunk": int(chunk),
            "k": int(k) if k else None, "d": d,
            "predicted_tile_bytes": tile,
            "predicted_table_bytes": table,
            "device_bytes_free": free.get("bytes_free"),
            "fits": (bool(tile <= free["bytes_free"])
                     if tile is not None and free.get("bytes_free")
                     is not None else None),
        }
        REGISTRY.gauge("fit.mem_planned_chunk").set(int(chunk))
        _trace.event("mem.plan", **{k_: v for k_, v in advisory.items()
                                    if v is not None})
        return advisory
    except Exception:  # noqa: BLE001 -- advisory never fails a fit
        return None


def _fmt_bytes(b: Optional[float]) -> str:
    if b is None:
        return "-"
    b = float(b)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024.0 or unit == "TB":
            return f"{b:.0f}{unit}" if unit == "B" else f"{b:.2f}{unit}"
        b /= 1024.0
    return f"{b:.2f}TB"


def format_plan_table(plans: List[dict], title: str = "hbm footprint plan",
                      device=None) -> str:
    """Fixed-width rendering of :func:`plan_fit` rows (the reference's
    text), with the free bytes of ``device`` (None: the current CUDA
    device)."""
    lines = [f"{title} (per device):",
             f"  {'family':<10} {'shape':<22} {'chunk':>8} "
             f"{'resident':>10} {'temp':>10} {'predicted':>10} "
             f"{'observed':>10}"]
    for p in plans:
        shape = f"{p['n']}x{p['d']} k={p['k']}"
        if p.get("cov_type"):
            shape += f" {p['cov_type']}"
        lines.append(
            f"  {p['family']:<10} {shape:<22} {p['chunk']:>8} "
            f"{_fmt_bytes(p['predicted_resident_bytes']):>10} "
            f"{_fmt_bytes(p['predicted_temp_bytes']):>10} "
            f"{_fmt_bytes(p['predicted_peak_bytes']):>10} "
            f"{_fmt_bytes(p.get('observed_peak_bytes')):>10}")
    free = device_memory_info(device)
    if free.get("available"):
        lines.append(f"  device free: {_fmt_bytes(free['bytes_free'])} "
                     f"of {_fmt_bytes(free['bytes_limit'])}")
    else:
        lines.append("  device free: unreported on this backend")
    return "\n".join(lines)
