"""Device-memory planner: a fit's peak bytes on one rank, predicted from
the shapes, and the slab geometry of the staged ingest.

Counterpart of ``kmeans_tpu/obs/memory.py`` (``plan_fit`` for the
``"kmeans"`` family, ``plan_ingest``, ``INGEST_SLAB_TARGET_BYTES``,
``device_memory_info``).  The other families of the reference's planner,
``advise_dispatch`` and ``format_plan_table`` come with the rest of
``obs/`` (ROADMAP.md, A.13).

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

from typing import Dict, Optional

import torch

__all__ = ["plan_fit", "plan_ingest", "device_memory_info", "FAMILIES",
           "INGEST_SLAB_TARGET_BYTES"]

#: The families the reference's planner models.  The port plans the
#: ``"kmeans"`` family; the others raise naming ROADMAP.md, A.13.
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
             pipeline: int = 0, k_shard: int = 0, mode: str = "matmul",
             assign: str = "dense", coarse_cells: Optional[int] = None,
             nprobe: Optional[int] = None,
             member_width: Optional[int] = None, device=None) -> dict:
    """Predict one rank's peak device bytes for a K-Means fit at a shape.

    The reference's keys (``components``, ``predicted_resident_bytes``,
    ``predicted_temp_bytes``, ``predicted_peak_bytes``, ...), with the
    port's byte terms (see the module's docstring).  ``chunk`` is the torch
    passes' chunk (None: all the rank's rows); ``pipeline`` doubles the
    tile (two chunks in flight).  ``mode`` is the resolved distance mode,
    ``k_shard`` the resolved knob, ``assign`` 'dense' or 'two_level' with
    its ``coarse_cells`` C, ``nprobe`` and member-list width
    ``member_width`` L (None: the width of balanced cells,
    ``sharding.bucket_candidates(ceil(k / C))``).  ``device`` gives the
    SM count of the kernel's launch (None: an H100's 132)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; families: "
                         f"{FAMILIES}")
    if family != "kmeans":
        raise NotImplementedError(
            f"plan_fit({family!r}) is not ported to kmeans_tpu_torch yet: "
            "ROADMAP.md, A.13 'Observability'")
    from kmeans_tpu_torch.parallel.sharding import bucket_candidates
    item = _itemsize(dtype)
    acc = 8 if item == 8 else 4
    data_shards = max(1, int(data_shards))
    model_shards = max(1, int(model_shards))
    rows_local = -(-int(n) // data_shards)
    tile_rows = min(int(chunk), rows_local) if chunk else rows_local
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
            blocks = min(_BLOCKS_PER_SM * _sms(device),
                         -(-rows_local // _TILE_ROWS),
                         _PARTIAL_BUDGET_BYTES // (4 * table))
            comp["tile_bytes"] = (max(1, blocks) * table * 4
                                  + rows_local * 8 + int(k) * 4)
        elif kernel:
            comp["tile_bytes"] = rows_local * 8 + k_local * 4 + \
                tile_rows * k_local * acc
        else:
            comp["tile_bytes"] = 4 * tile_rows * k_local * acc
        # The dense model-axis step embeds its block in the whole padded
        # table; the k-sharded step keeps its block only.
        k_stats = k_local if (k_shard and model_shards > 1) else k_pad
        comp["stats_bytes"] = (k_stats * d + 2 * k_stats) * acc
    if pipeline:
        comp["tile_bytes"] *= 2            # two chunk tiles in flight
    resident = sum(comp[key] for key in ("points_bytes", "weights_bytes",
                                         "table_bytes"))
    temp = sum(v for key, v in comp.items()
               if key not in ("points_bytes", "weights_bytes",
                              "table_bytes"))
    return {
        "family": family, "n": int(n), "d": int(d), "k": int(k),
        "cov_type": None,
        "data_shards": data_shards, "model_shards": model_shards,
        "dtype": str(getattr(dtype, "name", dtype)),
        "chunk": tile_rows, "pipeline": int(bool(pipeline)),
        "k_shard": int(k_shard), "mode": mode, "assign": assign,
        "components": comp,
        "predicted_resident_bytes": resident,
        "predicted_temp_bytes": temp,
        "predicted_peak_bytes": resident + temp,
        "observed_peak_bytes": None,
    }


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
