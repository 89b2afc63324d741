"""Model checkpoints: one ``.npz`` with a JSON ``__meta__`` record.

Same file layout and ``FORMAT_VERSION`` as the JAX package's
``utils/checkpoint.py``, so a model saved by either package loads in the
other: arrays are npz members, every other value goes into the JSON record,
and the record carries ``__format_version__``.  Writes are atomic (temp file
in the same directory, then ``os.replace``).
"""

from __future__ import annotations

import json
import os
import zipfile
from pathlib import Path
from typing import Any, Dict

import numpy as np

FORMAT_VERSION = 1


class CheckpointCorruptError(ValueError):
    """A checkpoint file exists but cannot be parsed (truncated write, torn
    copy, or not a checkpoint of this format).  Carries ``.path``."""

    def __init__(self, path, cause: str):
        self.path = Path(path)
        super().__init__(
            f"checkpoint {self.path} is truncated or corrupt ({cause})")


def _normalize(path) -> Path:
    """np.savez appends '.npz' to suffix-less paths; make load agree."""
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_name(path.name
                                                             + ".npz")


def save_state(path, state: Dict[str, Any]) -> None:
    """Write a checkpoint dict; arrays as npz payloads, rest as JSON."""
    path = _normalize(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in state.items()
              if isinstance(v, np.ndarray)}
    meta = {k: v for k, v in state.items() if k not in arrays}
    meta["__format_version__"] = FORMAT_VERSION
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def save_state_primary(path, state: Dict[str, Any], mesh=None) -> None:
    """:func:`save_state` on one rank of ``mesh`` only (one writer to a
    shared path: the rank at (0, 0), rank 0 without a mesh), then a barrier
    over the mesh, so that a ``load`` on any of its ranks after it returns
    reads the whole file.  Without a process group it is ``save_state``."""
    from kmeans_tpu_torch.parallel import mesh as _mesh
    if _mesh.is_primary(mesh):
        save_state(path, state)
    _mesh.barrier(mesh)


def topology_meta(mesh, dtype) -> Dict[str, Any]:
    """The JAX package's topology block (``meta_*``): the format version,
    the mesh's (data, model) shape (None for one device) and the dtype;
    information only, no load reads it."""
    from kmeans_tpu_torch.parallel.mesh import mesh_shape
    data_shards, model_shards = (mesh_shape(mesh) if mesh is not None
                                 else (None, None))
    return {"meta_format_version": FORMAT_VERSION,
            "meta_mesh_data_shards": data_shards,
            "meta_mesh_model_shards": model_shards,
            "meta_dtype": str(dtype)}


def load_state(path) -> Dict[str, Any]:
    """Read a checkpoint back into one dict (JSON values and arrays)."""
    path = _normalize(path)
    try:
        with np.load(path, allow_pickle=False) as z:
            if "__meta__" not in z.files:
                raise CheckpointCorruptError(
                    path, "missing __meta__ record — not a kmeans "
                          "checkpoint")
            raw_meta = str(z["__meta__"])
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
    except (zipfile.BadZipFile, EOFError, OSError, KeyError,
            ValueError) as e:
        # A missing file is not a corrupt one, and our own classification
        # passes through.
        if isinstance(e, (FileNotFoundError, CheckpointCorruptError)):
            raise
        raise CheckpointCorruptError(path, f"{type(e).__name__}: {e}") \
            from e
    try:
        state: Dict[str, Any] = json.loads(raw_meta)
    except json.JSONDecodeError as e:
        raise CheckpointCorruptError(path, f"unparseable __meta__: {e}") \
            from e
    _check_version(path, state.pop("__format_version__", None))
    state.update(arrays)
    return state


def _check_version(path, ver) -> None:
    if not isinstance(ver, int):
        raise CheckpointCorruptError(
            path, f"missing or malformed __format_version__ ({ver!r})")
    if ver > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {Path(path)} uses format version {ver}, but this "
            f"build supports up to {FORMAT_VERSION}: it was written by a "
            f"newer build — upgrade this installation")
    if ver < FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {Path(path)} uses obsolete format version {ver} "
            f"(< supported minimum {FORMAT_VERSION}); re-save it with the "
            f"build that wrote it, then load here")
