"""Model checkpoints: one ``.npz`` with a JSON ``__meta__`` record.

Same file layout and ``FORMAT_VERSION`` as the JAX package's
``utils/checkpoint.py``, so a model saved by either package loads in the
other: arrays are npz members, every other value goes into the JSON record,
and the record carries ``__format_version__``.  Writes are atomic (temp file
in the same directory, then ``os.replace``).

The segmented fits (``checkpoint_every=N``) write with last-good rotation
(:func:`save_state_rotating`: the previous file moves to ``<path>.prev``
first), and ``fit(resume=<path>)`` reads with
:func:`load_state_with_fallback`, which falls back to ``.prev`` when the
file is torn.  :func:`describe_checkpoint` and :func:`classify_resume` read
the JSON record alone.  The checkpoints of both packages rotate alike, so
either package resumes from the other's files.  Under a tracer a write is a
``checkpoint.save`` span and a read of a whole file a
``checkpoint.restore`` span.
"""

from __future__ import annotations

import json
import os
import zipfile
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

from kmeans_tpu_torch.obs import trace as _obs_trace

FORMAT_VERSION = 1


class CheckpointCorruptError(ValueError):
    """A checkpoint file exists but cannot be parsed (truncated write, torn
    copy, or not a checkpoint of this format).  Carries ``.path``."""

    def __init__(self, path, cause: str):
        self.path = Path(path)
        super().__init__(
            f"checkpoint {self.path} is truncated or corrupt ({cause}); "
            f"if a last-good rotation exists, resume from "
            f"{self.path.name}.prev (fit(resume=<path>) does this "
            f"automatically)")


def _normalize(path) -> Path:
    """np.savez appends '.npz' to suffix-less paths; make load agree."""
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_name(path.name
                                                             + ".npz")


def prev_path(path) -> Path:
    """The last-good rotation slot of ``path`` (``<name>.npz.prev``)."""
    p = _normalize(path)
    return p.with_name(p.name + ".prev")


def save_state(path, state: Dict[str, Any]) -> None:
    """Write a checkpoint dict; arrays as npz payloads, rest as JSON."""
    path = _normalize(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in state.items()
              if isinstance(v, np.ndarray)}
    meta = {k: v for k, v in state.items() if k not in arrays}
    meta["__format_version__"] = FORMAT_VERSION
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    with _obs_trace.span("checkpoint.save", path=str(path)):
        try:
            with open(tmp, "wb") as f:
                np.savez(f, __meta__=json.dumps(meta), **arrays)
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)


def save_state_rotating(path, state: Dict[str, Any]) -> None:
    """:func:`save_state` with last-good rotation: the file at ``path`` (if
    any) moves to :func:`prev_path` first.  Both renames are atomic; the
    worst a crash between them leaves is a missing ``path`` beside a valid
    ``.prev``, which :func:`load_state_with_fallback` reads."""
    path = _normalize(path)
    if path.exists():
        os.replace(path, prev_path(path))
    save_state(path, state)


def save_state_primary(path, state: Dict[str, Any], mesh=None,
                       rotate: bool = False) -> None:
    """:func:`save_state` on one rank of ``mesh`` only (one writer to a
    shared path: the rank at (0, 0), rank 0 without a mesh), then a barrier
    over the mesh, so that a ``load`` on any of its ranks after it returns
    reads the whole file.  Without a process group it is ``save_state``.
    ``rotate=True`` writes with :func:`save_state_rotating` (the segmented
    fits' writer)."""
    from kmeans_tpu_torch.parallel import mesh as _mesh
    if _mesh.is_primary(mesh):
        (save_state_rotating if rotate else save_state)(path, state)
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
    return _load_state_at(_normalize(path))


def _parse_npz(path: Path, materialize: bool):
    """``(meta, arrays)`` of the file at ``path`` (no ``.npz``
    normalisation: it also reads the ``.prev`` slot); ``materialize=False``
    reads the JSON record alone (``arrays`` None).  A file that does not
    parse raises :class:`CheckpointCorruptError`; a missing one
    ``FileNotFoundError``; a version mismatch ``ValueError``."""
    try:
        with np.load(path, allow_pickle=False) as z:
            if "__meta__" not in z.files:
                raise CheckpointCorruptError(
                    path, "missing __meta__ record — not a kmeans "
                          "checkpoint")
            raw_meta = str(z["__meta__"])
            arrays = ({k: z[k] for k in z.files if k != "__meta__"}
                      if materialize else None)
    except (zipfile.BadZipFile, EOFError, OSError, KeyError,
            ValueError) as e:
        # A missing file is not a corrupt one, and our own classification
        # passes through.
        if isinstance(e, (FileNotFoundError, CheckpointCorruptError)):
            raise
        raise CheckpointCorruptError(path, f"{type(e).__name__}: {e}") \
            from e
    try:
        meta: Dict[str, Any] = json.loads(raw_meta)
    except json.JSONDecodeError as e:
        raise CheckpointCorruptError(path, f"unparseable __meta__: {e}") \
            from e
    _check_version(path, meta.pop("__format_version__", None))
    return meta, arrays


def _load_state_at(path: Path) -> Dict[str, Any]:
    with _obs_trace.span("checkpoint.restore", path=str(path)):
        state, arrays = _parse_npz(path, materialize=True)
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


def load_state_with_fallback(path) -> Tuple[Dict[str, Any], bool]:
    """Load ``path``; when it is torn (or missing beside a rotation), load
    the last-good ``.prev`` instead.  Returns ``(state, used_fallback)``.
    A version error never falls back; when both files are unreadable the
    error names both."""
    try:
        return load_state(path), False
    except (CheckpointCorruptError, FileNotFoundError) as primary_err:
        prev = prev_path(path)
        if not prev.exists():
            raise
        try:
            return _load_state_at(prev), True
        except (CheckpointCorruptError, FileNotFoundError) as e:
            raise CheckpointCorruptError(
                path, f"{primary_err}; last-good fallback {prev} also "
                      f"unreadable ({e})") from e


def describe_checkpoint(path) -> Dict[str, Any]:
    """A summary of a checkpoint from its JSON record alone (no array is
    read): model class, cluster count, completed iteration, the topology
    block, and whether the ``.prev`` rotation exists and reads.  A torn
    primary file is reported (``primary_error``) and the summary is taken
    from ``.prev`` when that reads.  Works on the checkpoints of every
    family and of both packages (the JAX package's record names its jax
    version, this package's does not: ``jax_version`` None)."""
    path = _normalize(path)
    prev = prev_path(path)
    out: Dict[str, Any] = {"path": str(path), "primary_error": None,
                           "prev_exists": prev.exists(),
                           "prev_loads": None, "source": None}
    state = None
    try:
        state, _ = _parse_npz(path, materialize=False)
        out["source"] = "primary"
    except (CheckpointCorruptError, FileNotFoundError, ValueError) as e:
        out["primary_error"] = str(e)
    if out["prev_exists"]:
        try:
            prev_state, _ = _parse_npz(prev, materialize=False)
            out["prev_loads"] = True
            if state is None:
                state = prev_state
                out["source"] = "prev"
        except (CheckpointCorruptError, ValueError) as e:
            out["prev_loads"] = False
            out["prev_error"] = str(e)
    if state is None:
        return out
    k = state.get("k", state.get("n_components"))
    out.update({
        "model_class": state.get("model_class"),
        "k": int(k) if k is not None else None,
        "iteration": int(state.get("iterations_run",
                                   state.get("n_iter_", 0))),
        "format_version": int(state.get("meta_format_version",
                                        FORMAT_VERSION)),
        "jax_version": state.get("meta_jax_version"),
        "dtype": state.get("meta_dtype", state.get("dtype")),
        "written_on_mesh": {
            "data_shards": state.get("meta_mesh_data_shards"),
            "model_shards": state.get("meta_mesh_model_shards"),
        },
    })
    return out


def classify_resume(path) -> Dict[str, Any]:
    """Whether ``path`` is worth handing to ``fit(resume=...)``, and from
    which file: ``{"resumable", "source", "iteration", "detail"}``,
    ``source`` 'primary', 'prev' (the fallback
    :func:`load_state_with_fallback` takes) or None (nothing reads)."""
    desc = describe_checkpoint(path)
    source = desc.get("source")
    if source == "prev" and desc.get("prev_loads") is False:
        source = None
    return {
        "resumable": source is not None,
        "source": source,
        "iteration": desc.get("iteration"),
        "detail": desc,
    }
