"""Telemetry identity: which process of which fleet produced a record.

Counterpart of the JAX package's ``obs/identity.py``.  Every telemetry
record (trace spans, metrics exports) carries the producing process's
coordinates, so the streams of several processes merge into one
timeline:

* ``process_index`` / ``process_count`` — the process's rank and the
  world size of an initialized ``torch.distributed`` process group;
  ``0`` / ``1`` otherwise (a single-process run IS a one-host fleet).
  The reference reads JAX's process index here.
* ``host`` — the machine name (``socket.gethostname()``).

Resolution order (first hit wins), as in the reference:

1. ``KMEANS_TPU_PROCESS_INDEX`` / ``KMEANS_TPU_PROCESS_COUNT`` /
   ``KMEANS_TPU_HOST`` environment overrides (the reference's names, so
   one harness drives both packages);
2. the ``torch.distributed`` rank and world size, read only when a
   process group is already initialized (a telemetry call never starts
   one);
3. ``{process_index: 0, process_count: 1}``.

Pure stdlib at import: ``torch.distributed`` is looked up in
``sys.modules`` and never imported from here.
"""

from __future__ import annotations

import os
import socket
import sys
from typing import Optional

__all__ = ["identity", "per_process_path"]


def _group_coords() -> Optional[tuple]:
    """(rank, world size) of an ALREADY-initialized ``torch.distributed``
    process group, else None."""
    tdist = sys.modules.get("torch.distributed")
    if tdist is None:
        return None
    try:
        if not (tdist.is_available() and tdist.is_initialized()):
            return None
        return int(tdist.get_rank()), int(tdist.get_world_size())
    except Exception:  # noqa: BLE001 — telemetry must never raise here
        return None


def identity() -> dict:
    """``{"process_index", "process_count", "host"}`` for this process
    (see the module docstring for the resolution order)."""
    host = os.environ.get("KMEANS_TPU_HOST")
    if host is None:
        try:
            host = socket.gethostname()
        except Exception:  # noqa: BLE001 — containers without a hostname
            host = "?"
    env_idx = os.environ.get("KMEANS_TPU_PROCESS_INDEX")
    env_cnt = os.environ.get("KMEANS_TPU_PROCESS_COUNT")
    if env_idx is not None or env_cnt is not None:
        try:
            return {"process_index": int(env_idx or 0),
                    "process_count": int(env_cnt or 1), "host": host}
        except ValueError:
            pass                        # malformed override: fall through
    coords = _group_coords()
    if coords is not None:
        return {"process_index": coords[0], "process_count": coords[1],
                "host": host}
    return {"process_index": 0, "process_count": 1, "host": host}


def per_process_path(path, process_index: int) -> str:
    """The per-process sink path: ``trace.jsonl`` -> ``trace.p3.jsonl``
    (suffix inserted before the final extension; appended when the path
    has none)."""
    s = str(path)
    base, dot, ext = s.rpartition(".")
    if not dot or os.sep in ext or (os.altsep and os.altsep in ext):
        return f"{s}.p{process_index}"
    return f"{base}.p{process_index}.{ext}"
