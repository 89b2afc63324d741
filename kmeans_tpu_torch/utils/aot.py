"""Warm start: a store of built kernel libraries, shipped with checkpoints.

Counterpart of ``kmeans_tpu/utils/aot.py``.  There the artefact of a compile
is a serialized XLA executable; in the port it is a kernel library that
``ops._build`` built with ``nvcc`` from ``csrc/`` (a ``.so`` loaded with
``ctypes``).  A cold build of the sources takes seconds on every fresh
host, an elastic restart or a serving replica on a new machine included,
while a built library loads in milliseconds.  This module keeps the
libraries where another process finds them:

* :func:`enable_compilation_cache` -- the first rung: the build directory
  in use (``ops._build.BUILD_DIR``), moved by the environment knob
  ``KMEANS_TPU_TORCH_BUILD_DIR``; a library built there is reused by every
  later process on the machine.
* :class:`AOTStore` -- the second rung: a directory of verified artefacts,
  one zip (``.klib``) per library holding ``meta.json`` (the key fields of
  :func:`artifact_key` and the sha256 of the library's bytes) and
  ``lib.so``.  ``ops._build.load_variant`` asks the active store before it
  starts ``nvcc`` and puts what ``nvcc`` built into it; with a mirror set
  (:func:`on_checkpoint_path`) every library the fit uses is copied into
  the checkpoint's sibling ``<ckpt>.aot`` directory, and a resume
  (:func:`on_resume_path`) adds that directory to the read path.  A host
  with an empty build directory and no ``nvcc`` then resumes a shipped
  checkpoint without building anything.

Under a tracer every library load is a ``compile`` span whose ``via`` says
where it came from: ``'load'`` (build directory), ``'aot-load'`` (the
store), ``'nvcc'`` (built).

Degrade contract: on the CPU no library is ever loaded, so
:func:`aot_supported` is False there with its reason and :func:`wrap` does
nothing.  A corrupted or version-skewed artefact is a counted fallback
(``aot.fallback`` in the metrics registry, one warning) and the same
kernel is rebuilt by ``nvcc``: its bytes are never loaded, and nothing
falls back to the plain torch version.  The stored key fields are checked
against the expected ones, and the sha256 against the bytes, before the
library is written where ``dlopen`` reads it.

Key discipline: every artefact is written and read under
:func:`artifact_key`, which holds the library's name and ``-D`` defines,
the hash of the sources and flags, the ``nvcc`` flags, the card's compute
capability, ``torch.version.cuda`` and the torch version.

Trust note: an artefact is machine code that this process runs.  A store
directory, and a checkpoint's ``.aot`` directory, are therefore in the
trust domain of checkpoints: read them only from where you would load a
checkpoint from.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import warnings
import zipfile
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

from kmeans_tpu_torch.obs import metrics_registry as _metrics
from kmeans_tpu_torch.ops import _build
from kmeans_tpu_torch.utils.cache import AOT_ENV

__all__ = ["enable_compilation_cache", "aot_supported", "AOTStore",
           "artifact_key", "configure", "deactivate", "active_store",
           "wrap", "aot_dir_for", "on_checkpoint_path", "on_resume_path",
           "describe_dir", "libraries_for", "FORMAT"]

FORMAT = "kmeans_tpu_torch.aot.v1"

#: Artefact file extension (one kernel library per file).
_EXT = ".klib"


# ------------------------------------------------------ build directory

def enable_compilation_cache() -> str:
    """The build directory in use, after reading its environment knob
    ``KMEANS_TPU_TORCH_BUILD_DIR`` again: where it is set (not empty) it
    becomes ``ops._build.BUILD_DIR``; unset, the directory stays as it
    is.  Libraries loaded already stay loaded."""
    env = os.environ.get(_build.BUILD_DIR_ENV)
    if env:
        _build.BUILD_DIR = Path(env)
    return str(_build.BUILD_DIR)


# ------------------------------------------------------ card capability

_SUPPORTED: Optional[Tuple[bool, str]] = None
_SUPPORT_LOCK = threading.Lock()


def _capability() -> Optional[str]:
    """The compute capability of the current CUDA card (``'9.0'``), or
    None where there is none."""
    import torch
    if not torch.cuda.is_available():
        return None
    major, minor = torch.cuda.get_device_capability()
    return f"{major}.{minor}"


def aot_supported() -> Tuple[bool, str]:
    """(supported, reason): can this process load a kernel library, a CUDA
    card with a readable compute capability?  Probed once per process."""
    global _SUPPORTED
    with _SUPPORT_LOCK:
        if _SUPPORTED is None:
            try:
                cap = _capability()
                _SUPPORTED = ((True, "ok") if cap else
                              (False, "no CUDA device: the kernel libraries "
                                      "are never loaded on the CPU"))
            except Exception as e:  # noqa: BLE001 -- capability probe
                _SUPPORTED = (False, f"{type(e).__name__}: {e}")
        return _SUPPORTED


# ------------------------------------------------------------ key fields

def artifact_key(name: str, defines: Optional[Mapping[str, int]] = None,
                 *, capability: Optional[str] = "auto"
                 ) -> Dict[str, object]:
    """The key of the library of ``csrc/<name>.cu`` under ``defines``: the
    one constructor of every artefact's key.  ``capability`` 'auto' reads
    the current card's (None without one)."""
    import torch
    defines = dict(defines or {})
    return {
        "format": FORMAT,
        "library": str(name),
        "defines": [[k, int(v)] for k, v in sorted(defines.items())],
        "sources": _build._sources_hash(defines),
        "nvcc_flags": list(_build.NVCC_FLAGS),
        "capability": _capability() if capability == "auto"
        else capability,
        "torch_cuda": torch.version.cuda,
        "torch": torch.__version__,
    }


def _digest(fields: Dict[str, object]) -> str:
    return hashlib.sha256(
        json.dumps(fields, sort_keys=True).encode()).hexdigest()[:40]


def _write_atomic(path: Path, write) -> None:
    """``write(tmp)``, then the temporary file renamed to ``path``: no
    reader ever sees a torn file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}."
                         f"{threading.get_ident()}.tmp")
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


# ---------------------------------------------------------------- store

#: The registry counter of each of the store's counts.
_METRICS = {"loaded": "aot.loaded", "built": "aot.built",
            "saved": "aot.saved", "fallbacks": "aot.fallback"}


class AOTStore:
    """A directory of verified kernel-library artefacts.

    ``root`` is the write (and first read) directory; ``read_dirs`` are
    more directories to read (a shipped checkpoint's ``<ckpt>.aot``);
    ``mirror``, where set, receives a copy of every library the process
    uses (the checkpoint's ``.aot`` directory)."""

    def __init__(self, root, read_dirs=(), mirror=None):
        self.root = Path(root)
        self.read_dirs: List[Path] = [Path(d) for d in read_dirs]
        self.mirror: Optional[Path] = Path(mirror) if mirror else None
        self._lock = threading.Lock()
        self.counts = {"loaded": 0, "built": 0, "saved": 0, "fallbacks": 0}

    # ---------------------------------------------------- bookkeeping
    def _count(self, what: str) -> None:
        with self._lock:
            self.counts[what] += 1
        _metrics.REGISTRY.counter(_METRICS[what]).inc()

    def stats(self) -> dict:
        ok, reason = aot_supported()
        with self._lock:
            counts = dict(self.counts)
        return {"root": str(self.root),
                "read_dirs": [str(d) for d in self.read_dirs],
                "mirror": str(self.mirror) if self.mirror else None,
                "available": ok, "reason": reason, **counts}

    def add_read_dir(self, path) -> None:
        p = Path(path)
        if p not in self.read_dirs:
            self.read_dirs.append(p)

    def set_mirror(self, path) -> None:
        self.mirror = Path(path) if path else None

    def _targets(self) -> List[Path]:
        return [self.root] + ([self.mirror] if self.mirror else [])

    def _candidates(self, digest: str) -> List[Path]:
        dirs = [self.root] + self.read_dirs
        if self.mirror is not None:
            dirs.append(self.mirror)
        return [d / (digest + _EXT) for d in dirs]

    # ------------------------------------------------------------ put
    def put(self, fields: Dict[str, object], library, *,
            missing_only: bool = False) -> bool:
        """Write the library file ``library`` under ``fields``
        (:func:`artifact_key`) into the root and the mirror
        (``missing_only``: only where it is not there yet).  Returns False,
        counted and warned, where a write failed; raises nothing into a
        fit."""
        digest = _digest(fields)
        wrote = False
        try:
            data = Path(library).read_bytes()
        except OSError as e:
            self._count("fallbacks")
            _warn_once(f"kernel library {library} unreadable ({e}); "
                       f"nothing stored")
            return False
        meta = json.dumps({**fields,
                           "sha256": hashlib.sha256(data).hexdigest()},
                          sort_keys=True)
        for target in self._targets():
            path = target / (digest + _EXT)
            if missing_only and path.is_file():
                continue

            def write(tmp, meta=meta):
                with zipfile.ZipFile(tmp, "w") as z:
                    z.writestr("meta.json", meta)
                    z.writestr("lib.so", data)
            try:
                _write_atomic(path, write)
                wrote = True
            except OSError as e:
                self._count("fallbacks")
                warnings.warn(f"kernel library artefact write to {target} "
                              f"failed ({e})", UserWarning, stacklevel=2)
                return False
        if wrote:
            self._count("saved")
        return True

    # ------------------------------------------------------------ get
    def get(self, fields: Dict[str, object], dest) -> bool:
        """Place the library stored under ``fields`` at ``dest``, after
        checking its stored key fields against ``fields`` and its sha256
        against its bytes.  False for a miss, and for a counted fallback
        (a corrupted or version-skewed artefact, whose bytes are never
        written): the caller then builds the same kernel."""
        digest = _digest(fields)
        expect = json.loads(json.dumps(fields, sort_keys=True))
        for path in self._candidates(digest):
            if not path.is_file():
                continue
            try:
                with zipfile.ZipFile(path) as z:
                    meta = json.loads(z.read("meta.json"))
                    data = z.read("lib.so")
                sha = meta.pop("sha256", None)
                if meta != expect:
                    skew = sorted(k for k in set(meta) | set(expect)
                                  if meta.get(k) != expect.get(k))
                    raise ValueError(
                        f"key fields mismatch in {skew} (stored "
                        f"{[meta.get(k) for k in skew]}, expected "
                        f"{[expect.get(k) for k in skew]})")
                if sha != hashlib.sha256(data).hexdigest():
                    raise ValueError("sha256 of the library bytes does not "
                                     "match its meta.json")
            except Exception as e:  # noqa: BLE001 -- rebuild, never load it
                self._count("fallbacks")
                _warn_once(f"kernel library artefact {path} unusable "
                           f"({type(e).__name__}: {e}); rebuilding the "
                           f"same kernel with nvcc")
                return False
            _write_atomic(Path(dest), lambda tmp: Path(tmp).write_bytes(data))
            self._count("loaded")
            return True
        return False

    # ------------------------------------------- what ops._build calls
    def fetch(self, name: str, defines: Mapping[str, int], dest) -> bool:
        """:meth:`get` of the library of (``name``, ``defines``) for this
        card, placed at ``dest``; the same artefact then goes to the
        mirror if it lacks it."""
        fields = artifact_key(name, defines)
        if not self.get(fields, dest):
            return False
        if self.mirror is not None:
            self.put(fields, dest, missing_only=True)
        return True

    def store(self, name: str, defines: Mapping[str, int], library, *,
              built: bool = False) -> bool:
        """:meth:`put` of the library file ``library`` of (``name``,
        ``defines``) where the root or the mirror lacks it; ``built``
        counts a build by ``nvcc``."""
        if built:
            self._count("built")
        return self.put(artifact_key(name, defines), library,
                        missing_only=True)


def _warn_once(msg: str, _seen: set = set()) -> None:  # noqa: B006
    """One warning per distinct message and process."""
    if msg not in _seen:
        _seen.add(msg)
        warnings.warn(msg, UserWarning, stacklevel=3)


# -------------------------------------------------------- active store

_STORE: Optional[AOTStore] = None
_ENV_CHECKED = False


def configure(root, read_dirs=(), mirror=None) -> Optional[AOTStore]:
    """Install the process's store (``root=None`` removes it).  Its
    environment twin is ``KMEANS_TPU_TORCH_AOT_CACHE=<dir>``, read at the
    first use when nothing was configured."""
    global _STORE, _ENV_CHECKED
    _ENV_CHECKED = True
    _STORE = AOTStore(root, read_dirs=read_dirs, mirror=mirror) \
        if root else None
    return _STORE


def deactivate() -> None:
    configure(None)


def active_store() -> Optional[AOTStore]:
    """The installed store; made from ``KMEANS_TPU_TORCH_AOT_CACHE`` once
    where nothing was configured."""
    global _ENV_CHECKED
    if _STORE is None and not _ENV_CHECKED:
        env = os.environ.get(AOT_ENV)
        if env:
            return configure(env)
        _ENV_CHECKED = True
    return _STORE


def aot_dir_for(ckpt_path) -> Path:
    """The artefact directory shipped beside a checkpoint
    (``model.npz`` -> ``model.npz.aot/``)."""
    from kmeans_tpu_torch.utils.checkpoint import _normalize
    p = _normalize(ckpt_path)
    return p.with_name(p.name + ".aot")


def on_checkpoint_path(ckpt_path) -> None:
    """The checkpointed fit's hook (``AutoCheckpointMixin._check_ckpt``):
    with a store active, the checkpoint's ``.aot`` directory becomes the
    mirror, and the libraries this process has loaded already go there;
    the ones it loads later follow at their load."""
    store = active_store()
    if store is None or ckpt_path is None:
        return
    store.set_mirror(aot_dir_for(ckpt_path))
    for name, defines in list(_build._LIBS):
        path = _build.library_path(name, dict(defines))
        if path.is_file():
            store.store(name, dict(defines), path)


def on_resume_path(ckpt_path) -> None:
    """The resume hook (``AutoCheckpointMixin._resolve_resume``): with a
    store active, the checkpoint's ``.aot`` directory joins its read
    path."""
    store = active_store()
    if store is not None and ckpt_path is not None:
        store.add_read_dir(aot_dir_for(ckpt_path))


def describe_dir(path) -> dict:
    """A summary of an artefact directory: artefacts, bytes, unreadable
    files and the distinct (library, defines, capability, torch) present.
    Reads zip and json only; never initializes CUDA."""
    p = Path(path)
    out = {"path": str(p), "exists": p.is_dir(), "artifacts": 0,
           "bytes": 0, "libraries": [], "unreadable": 0}
    if not out["exists"]:
        return out
    seen = set()
    for f in sorted(p.glob(f"*{_EXT}")):
        out["artifacts"] += 1
        out["bytes"] += f.stat().st_size
        try:
            with zipfile.ZipFile(f) as z:
                meta = json.loads(z.read("meta.json"))
            seen.add((meta.get("library", "?"),
                      json.dumps(meta.get("defines", [])),
                      str(meta.get("capability")), meta.get("torch", "?")))
        except Exception:  # noqa: BLE001 -- a torn artefact still counts
            out["unreadable"] += 1
    out["libraries"] = [{"library": lib, "defines": json.loads(dfn),
                         "capability": cap, "torch": tv}
                        for lib, dfn, cap, tv in sorted(seen)]
    return out


# ------------------------------------------------------------ miss hook

def libraries_for(key) -> List[str]:
    """The kernel libraries that the step cache's entry under ``key``
    (``utils.cache.builder_key``: builder name, args, sorted kwargs)
    launches: by its ``mode``, the mixture's builders ``gmm_estep`` in
    mode 'kernel'."""
    if not (isinstance(key, tuple) and len(key) == 3
            and isinstance(key[0], str)):
        return []
    from kmeans_tpu_torch.ops import estep_kernels, hopper_kernels
    kwargs = dict(key[2]) if isinstance(key[2], tuple) else {}
    mode = kwargs.get("mode")
    if key[0].startswith("make_gmm"):
        return [estep_kernels.LIB_NAME] if mode == "kernel" else []
    lib = hopper_kernels.mode_library(mode)
    return [lib] if lib else []


def wrap(cache_name: str, key, value):
    """The step cache's miss hook: with a store active on a CUDA card, the
    libraries of the entry's mode (:func:`libraries_for`) are loaded now
    (build directory, then the store, then ``nvcc``, whose build goes into
    the store and its mirror).  ``value`` comes back as it is; with no
    store the hook is one ``None`` check."""
    store = active_store()
    if store is None:
        return value
    names = libraries_for(key)
    if names and aot_supported()[0]:
        for name in names:
            _build.load(name)
    return value
