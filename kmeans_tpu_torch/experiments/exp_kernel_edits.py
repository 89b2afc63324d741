"""Ablations of the float32 kernels, on one NVIDIA GPU.

The card's machine runs no ``ncu``, so where a kernel spends its time is
found by taking parts away: each variant is a copy of a source under
``csrc/`` with some text replaced (a JSON file of named lists of
``{"old": ..., "new": ...}`` edits; each ``old`` must occur exactly once;
an optional top-level ``"source"`` names the source, ``assign_kernels``
where it is absent), built into ``build/edits/`` with the main path's
``nvcc`` flags, all builds started together.  Each variant is then checked
against the plain version, with weights that hold zeros and the tolerances
of ``ops/compare.py``, and timed at the given shape: CUDA events around one
call, the median of 10 after 2 warm-ups.

* ``assign_kernels`` (the float32 K-Means kernels): checked on a 4096-row
  slice; both kernels, assignment only and the fused pass, timed on blobs
  with centroids at random rows.
* ``gmm_estep`` (``diag_estep``): checked and timed on all rows of
  ``chip_smoke.py``'s mixture inputs, blobs about 1e3 from the origin with
  means at random rows.

An edit that removes work (the products, the epilogue) breaks the result:
its check says so, and only its time means something.

Usage::

    python -m kmeans_tpu_torch.experiments.exp_kernel_edits N D K EDITS.json

``kmeans_tpu_torch/experiments/edits_assign_f32.json`` and
``edits_gmm_estep.json`` hold the ablations that ``PERF.md`` reports.  It
prints one line per variant and then one JSON object per variant.  It needs
a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Sequence

import torch

from kmeans_tpu_torch.data.synthetic import make_blobs_device
from kmeans_tpu_torch.experiments.exp_pallas_kernel import check_inputs
from kmeans_tpu_torch.ops import _build
from kmeans_tpu_torch.ops import compare as cmp
from kmeans_tpu_torch.ops import estep_kernels as ek
from kmeans_tpu_torch.ops import hopper_kernels as hk
from kmeans_tpu_torch.parallel.sharding import weighted_mean

SOURCE = "assign_kernels"
EDITS_DIR = _build.BUILD_DIR / "edits"
DEFAULT_EDITS = Path(__file__).with_name("edits_assign_f32.json")
ESTEP_EDITS = Path(__file__).with_name("edits_gmm_estep.json")
#: How a built library of each source is bound.
_BIND = {"assign_kernels": lambda lib: hk.bind(lib, False),
         ek.LIB_NAME: ek.bind}


def apply_edits(text: str, edits: Sequence[dict]) -> str:
    """``text`` with each edit's ``old`` (which must occur exactly once)
    replaced by its ``new``; raises ValueError otherwise."""
    for edit in edits:
        count = text.count(edit["old"])
        if count != 1:
            raise ValueError(f"edit {edit['old'][:60]!r}... occurs {count} "
                             f"times in the source, not once")
        text = text.replace(edit["old"], edit["new"])
    return text


def edits_source(path) -> str:
    """The source an edits file applies to (its ``"source"``)."""
    source = json.loads(Path(path).read_text()).get("source", SOURCE)
    if source not in _BIND:
        raise ValueError(f"edits of an unknown source: {source!r}")
    return source


def load_edits(path) -> Dict[str, List[dict]]:
    """The named variants of an edits file, each checked to apply to the
    current source."""
    variants = json.loads(Path(path).read_text())
    source = edits_source(path)
    variants.pop("source", None)
    src = (_build.CSRC_DIR / f"{source}.cu").read_text()
    for edits in variants.values():
        apply_edits(src, edits)
    return variants


def build(variants: Dict[str, List[dict]],
          source: str = SOURCE) -> Dict[str, ctypes.CDLL]:
    """Every variant's library, one ``nvcc`` for each, all started together;
    raises with the compilers' output if one fails."""
    src = (_build.CSRC_DIR / f"{source}.cu").read_text()
    EDITS_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, edits in variants.items():
        cu = EDITS_DIR / f"{source}-{name}.cu"
        cu.write_text(apply_edits(src, edits))
        lib = EDITS_DIR / f"lib{source}-{name}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
               str(_build.CSRC_DIR), "-o", str(lib), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    failed, libs = [], {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            libs[name] = _BIND[source](ctypes.CDLL(str(lib)))
    if failed:
        raise _build.KernelCompileError("nvcc failed:\n" + "\n".join(failed))
    return libs


def median_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def measure(name: str, lib: ctypes.CDLL, x, c) -> dict:
    """One variant checked on a slice and timed on all of ``x``."""
    counter = f"kernel_edit:{name}"
    hk.LAUNCHES.setdefault(counter, 0)
    xs, ws, _ = check_inputs(x, c)
    labels, mind2, sums, counts = hk.launch_fused(lib, False, xs, ws, c,
                                                  counter)
    ref = hk.fused_assign_reduce_reference(xs, ws, c)
    torch.cuda.synchronize()
    n_diff, n_outside = cmp.label_band(xs, c, labels, ref[0])
    same = labels == ref[0]
    ok = (n_outside == 0
          and cmp.close(mind2[same], ref[1][same], cmp.MIND2_RTOL,
                        cmp.mind2_atol(xs, c))
          and (n_diff > 0 or cmp.sums_close(sums, ref[2])))
    w = torch.ones(x.shape[0], device=x.device)
    return {"name": name, "ok": bool(ok), "label_diff": n_diff,
            "mind2_err": cmp.max_err(mind2[same], ref[1][same]),
            "assign_ms": median_ms(
                lambda: hk.launch_assign(lib, False, x, c, counter)),
            "fused_ms": median_ms(
                lambda: hk.launch_fused(lib, False, x, w, c, counter))}


def estep_inputs(n: int, d: int, k: int, dev):
    """``chip_smoke.py``'s mixture inputs: blobs about 1e3 from the origin,
    and the tables of a mixture with means at random rows:
    ``(x, (shift, means_c, inv_var, log_det, log_weights))``."""
    x, _ = make_blobs_device(n, k, d, device=dev, seed=21,
                             center_box=(990.0, 1010.0))
    gen = torch.Generator(device=dev).manual_seed(22)
    pick = torch.randperm(n, generator=gen, device=dev)[:k]
    shift = weighted_mean(x, torch.ones(n, device=dev)).contiguous()
    means_c = (x[pick] - shift).contiguous()
    var = torch.rand((k, d), generator=gen, device=dev) + 0.5
    return x, (shift, means_c, (1.0 / var).contiguous(),
               torch.log(var).sum(1).contiguous(),
               torch.full((k,), -math.log(k), device=dev))


def measure_estep(name: str, lib: ctypes.CDLL, x, tables) -> dict:
    """One variant of ``diag_estep`` checked and timed on all of ``x`` (the
    check with the weights of :func:`check_inputs`, zeros among them: on a
    slice of a few thousand rows, k = 256 leaves each component too few
    rows for the tolerances, which the float32 plain version's own error
    would break)."""
    counter = f"kernel_edit:{name}"
    hk.LAUNCHES.setdefault(counter, 0)
    _, ws, _ = check_inputs(x, tables[1], rows=x.shape[0])
    out = ek.launch_estep(lib, x, ws, *tables, counter)
    ref = ek.diag_estep_reference(x, ws, *tables)
    torch.cuda.synchronize()
    w = torch.ones(x.shape[0], device=x.device)
    return {"name": name, **cmp.estep_errors(out, ref),
            "estep_ms": median_ms(
                lambda: ek.launch_estep(lib, x, w, *tables, counter))}


def main(argv: Sequence[str]) -> int:
    if len(argv) != 4:
        print(__doc__, file=sys.stderr)
        return 2
    n, d, k = (int(a) for a in argv[:3])
    source = edits_source(argv[3])
    variants = load_edits(argv[3])
    if not torch.cuda.is_available():
        print("exp_kernel_edits: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    libs = build(variants, source)
    if source == ek.LIB_NAME:
        x, tables = estep_inputs(n, d, k, dev)
        records = [measure_estep(name, lib, x, tables)
                   for name, lib in libs.items()]
    else:
        x, _ = make_blobs_device(n, k, d, device=dev, seed=1)
        gen = torch.Generator(device=dev).manual_seed(2)
        c = x[torch.randperm(n, generator=gen, device=dev)[:k]].contiguous()
        records = [measure(name, lib, x, c) for name, lib in libs.items()]
    for rec in records:
        verdict = "" if rec["ok"] else "  (result differs: timing only)"
        times = (f"estep {rec['estep_ms']:8.3f} ms" if "estep_ms" in rec
                 else f"assign {rec['assign_ms']:8.3f} ms  fused "
                      f"{rec['fused_ms']:8.3f} ms")
        print(f"{rec['name']:22s} {times}{verdict}", flush=True)
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
