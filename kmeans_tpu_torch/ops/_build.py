"""Builds the CUDA sources of ``kmeans_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>_<hash>.so``: ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``.  No PyTorch header is included, so a source builds in seconds.
The hash covers every file under ``csrc`` and the compiler flags, so a library
left from other sources is never loaded.  A build that fails raises with the
compiler's output; nothing here falls back to another implementation.

:func:`build_variants` and :func:`load_variant` build a source under ``-D``
defines (the tile sizes that the variant lab sweeps) into a library of its
own, whose hash also covers the defines; the main path's builds pass none.

The build directory is ``kmeans_tpu_torch/build`` unless the environment
knob ``KMEANS_TPU_TORCH_BUILD_DIR`` names another (read at import, and again
by ``utils.aot.enable_compilation_cache``).  Where a library is not in it,
:func:`load_variant` asks the active store of built libraries
(``utils.aot``) before it starts ``nvcc``, and a library that ``nvcc``
built goes into that store: a host with an empty build directory and no
``nvcc`` then loads the libraries a checkpoint shipped.

Under a tracer each ``nvcc`` run is a ``compile`` span (``via='nvcc'``) and
each library load one more, whose ``via`` says where the library came from:
``'load'`` (the build directory), ``'aot-load'`` (the store) or ``'nvcc'``
(built for this load).  The first dispatch of a fit that loads a kernel
holds them, and the time-to-first-iteration report (``obs.report``) counts
them in its ``compile`` row.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from kmeans_tpu_torch.obs import trace as _obs_trace

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
#: The environment knob that moves the build directory.
BUILD_DIR_ENV = "KMEANS_TPU_TORCH_BUILD_DIR"


def default_build_dir() -> Path:
    """``KMEANS_TPU_TORCH_BUILD_DIR`` where it is set and not empty, else
    ``kmeans_tpu_torch/build``."""
    env = os.environ.get(BUILD_DIR_ENV)
    return Path(env) if env else _PKG / "build"


BUILD_DIR = default_build_dir()

#: ``nvcc`` processes this process started (every build, the lab's too).
NVCC_RUNS = 0

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

#: Loaded libraries by (source, defines).  Looked up before anything is
#: hashed: a wrapper asks for its library on every call.
_LIBS: Dict[Tuple[str, Tuple[Tuple[str, int], ...]], ctypes.CDLL] = {}

#: Kernel launches so far, by kernel name, for every kernel module of the
#: package (each adds its names at import).  A wrapper adds one where it
#: launches its kernel and nowhere else.
LAUNCHES: Dict[str, int] = {}

#: The operations the launches so far declared, by kernel name
#: (``hopper_kernels.declared_operations`` of each launch's shape): what a
#: cost record adds to the aten count, which cannot see a ``ctypes``
#: launch (``obs.cost``).
OPS: Dict[str, float] = {}

#: Guards every change of ``LAUNCHES``: a serving thread and a learner's
#: update thread launch kernels at the same time, and ``+=`` on a dict
#: entry is a read, an add and a write.
_LAUNCH_LOCK = threading.Lock()


def count_launch(name: str, n: int = 1, ops: float = 0.0) -> None:
    """Add ``n`` to the count of kernel ``name`` (0 where it has none), and
    ``ops`` to its declared operations."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] = LAUNCHES.get(name, 0) + n
        OPS[name] = OPS.get(name, 0.0) + ops


def reset_launch_counts() -> None:
    """Set the count of every kernel of the package to 0."""
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


class KernelCompileError(RuntimeError):
    """``nvcc`` is missing or refused a source; carries its output."""


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, or under ``CUDA_HOME`` / ``CUDA_PATH``
    / ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelCompileError(
        "nvcc not found (looked on PATH and under CUDA_HOME, CUDA_PATH and "
        "/usr/local/cuda); the kernels of kmeans_tpu_torch are built from "
        "source and need the CUDA toolkit")


def source_names() -> List[str]:
    """Names (without suffix) of the ``.cu`` sources in the package."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _define_flags(defines: Mapping[str, int]) -> List[str]:
    return [f"-D{key}={int(value)}" for key, value in sorted(defines.items())]


def _sources_hash(defines: Optional[Mapping[str, int]] = None) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    if defines:
        h.update(" ".join(_define_flags(defines)).encode())
    for p in sorted(list(CSRC_DIR.glob("*.cu")) + list(CSRC_DIR.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str,
                 defines: Optional[Mapping[str, int]] = None) -> Path:
    """Where the build of ``csrc/<name>.cu`` under ``defines`` lives."""
    return BUILD_DIR / f"lib{name}_{_sources_hash(defines)}.so"


def _start(name: str, defines: Mapping[str, int]):
    """Start ``nvcc`` on one source; returns (process, tmp path, final path,
    command) or None when the library is already there."""
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise KernelCompileError(f"no such kernel source: {src}")
    out = library_path(name, defines)
    if out.is_file():
        return None
    global NVCC_RUNS
    cmd = [find_nvcc(), *NVCC_FLAGS, *_define_flags(defines)]
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd += ["-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    NVCC_RUNS += 1
    return proc, tmp, out, cmd


def build_variants(variants: Iterable[Tuple[str, Mapping[str, int]]]
                   ) -> List[str]:
    """Build each (source, defines), one ``nvcc`` for each, all started
    together; no defines is the main path's build.  Returns the compiler's
    outputs in order (empty for a library that was already built); raises
    if any build failed."""
    started = [_start(name, defines) for name, defines in variants]
    logs: List[str] = []
    failed = []
    for job in started:
        if job is None:
            logs.append("")
            continue
        proc, tmp, out, cmd = job
        with _obs_trace.span("compile", via="nvcc", library=out.name):
            log, _ = proc.communicate()
        logs.append(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{' '.join(cmd)}\nexit code {proc.returncode}\n"
                          f"{log}")
        else:
            os.replace(tmp, out)       # atomic: no reader sees a torn file
    if failed:
        raise KernelCompileError("nvcc failed:\n" + "\n".join(failed))
    return logs


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build the named sources (all of them by default) as the main path
    uses them, one ``nvcc`` for each, all started together.  Returns the
    compiler's output by name (empty for a library that was already
    built)."""
    names = list(names) if names is not None else source_names()
    return dict(zip(names, build_variants((name, {}) for name in names)))


#: Guards the first load of each library: a serving thread and a fit may
#: ask for the same one at once.
_LOAD_LOCK = threading.RLock()


def _active_store():
    """The store of built libraries where ``utils.aot`` is in use (imported,
    or its environment knob set), else None."""
    import sys
    mod = sys.modules.get("kmeans_tpu_torch.utils.aot")
    if mod is None:
        from kmeans_tpu_torch.utils.cache import AOT_ENV
        if not os.environ.get(AOT_ENV):
            return None
        from kmeans_tpu_torch.utils import aot as mod
    return mod.active_store()


def _ensure_built(name: str, defines: Mapping[str, int]) -> str:
    """Make the library of (``name``, ``defines``) present at
    :func:`library_path`: already there (``'load'``), placed from the
    active store (``'aot-load'``), or built by ``nvcc`` (``'nvcc'``); with
    a store active the library then goes into it.  Returns which."""
    path = library_path(name, defines)
    store = _active_store()
    if path.is_file():
        via = "load"
    elif store is not None and store.fetch(name, defines, path):
        via = "aot-load"
    else:
        build_variants([(name, defines)])
        via = "nvcc"
    if store is not None:
        # Where the store's root or its mirror (a checkpoint's .aot
        # directory) lacks this library, it goes there.
        store.store(name, defines, path, built=via == "nvcc")
    return via


def load_variant(name: str, defines: Mapping[str, int]) -> ctypes.CDLL:
    """The build of ``csrc/<name>.cu`` under ``defines``: from the build
    directory, else from the active store of built libraries, else built
    by ``nvcc``."""
    key = (name, tuple(sorted(defines.items())))
    lib = _LIBS.get(key)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(key)
            if lib is None:
                with _obs_trace.span("compile", via="load",
                                     source=name) as sp:
                    via = _ensure_built(name, defines)
                    if sp is not None:
                        sp["attrs"]["via"] = via
                    lib = ctypes.CDLL(str(library_path(name, defines)))
                _LIBS[key] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if need be."""
    return load_variant(name, {})
