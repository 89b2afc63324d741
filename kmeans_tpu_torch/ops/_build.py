"""Builds the CUDA sources of ``kmeans_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>_<hash>.so``: ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``.  No PyTorch header is included, so a source builds in seconds.
The hash covers every file under ``csrc`` and the compiler flags, so a library
left from other sources is never loaded.  A build that fails raises with the
compiler's output; nothing here falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}

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


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(list(CSRC_DIR.glob("*.cu")) + list(CSRC_DIR.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_sources_hash()}.so"


def _start(name: str):
    """Start ``nvcc`` on one source; returns (process, tmp path, final path)
    or None when the library is already there."""
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise KernelCompileError(f"no such kernel source: {src}")
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build the named sources (all of them by default), one ``nvcc`` for
    each, all started together.  Returns the compiler's output by name
    (empty for a library that was already built)."""
    names = list(names) if names is not None else source_names()
    started = {name: _start(name) for name in names}
    logs: Dict[str, str] = {}
    failed = []
    for name, job in started.items():
        if job is None:
            logs[name] = ""
            continue
        proc, tmp, out, cmd = job
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{' '.join(cmd)}\nexit code {proc.returncode}\n"
                          f"{log}")
        else:
            os.replace(tmp, out)       # atomic: no reader sees a torn file
    if failed:
        raise KernelCompileError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
