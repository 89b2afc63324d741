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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

#: Loaded libraries by (source, defines).  Looked up before anything is
#: hashed: a wrapper asks for its library on every call.
_LIBS: Dict[Tuple[str, Tuple[Tuple[str, int], ...]], ctypes.CDLL] = {}

#: Kernel launches so far, by kernel name, for every kernel module of the
#: package (each adds its names at import).  A wrapper adds one where it
#: launches its kernel and nowhere else.
LAUNCHES: Dict[str, int] = {}


def reset_launch_counts() -> None:
    """Set the count of every kernel of the package to 0."""
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
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *_define_flags(defines), "-o", str(tmp),
           str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
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


def load_variant(name: str, defines: Mapping[str, int]) -> ctypes.CDLL:
    """The build of ``csrc/<name>.cu`` under ``defines``, building it if
    need be."""
    key = (name, tuple(sorted(defines.items())))
    lib = _LIBS.get(key)
    if lib is None:
        build_variants([(name, defines)])
        lib = ctypes.CDLL(str(library_path(name, defines)))
        _LIBS[key] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if need be."""
    return load_variant(name, {})
