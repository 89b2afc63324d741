"""Variant lab of the fused K-Means kernel, on one NVIDIA GPU.

Counterpart of ``experiments/exp_pallas_kernel.py`` (``build_kernel`` and the
harness around it); the name is kept so that a reader finds it, but nothing
here is Pallas.  A variant is a compile-time build of one of the port's CUDA
sources under ``-D`` defines: ``csrc/assign_kernels.cu`` (float32 products)
or, with flag ``b``, ``csrc/assign_bf16.cu`` (bf16 products on the tensor
cores).  Each variant is first checked against the port's plain version
(``hopper_kernels.fused_assign_reduce_reference``), with the tolerances of
``ops/compare.py`` that ``chip_smoke.py`` also holds the kernels to: on a
4096-row slice whose weights hold zeros, and on the whole of the inputs it
is timed on.  Then it is timed per Lloyd iteration by the marginal method:
a chain of 2 passes and a chain of
2 + T passes, with the centroid update ``sums / max(counts, 1)`` on the
device between passes, CUDA events, the median of 3 repeats.  A variant
that fails its check prints ``WRONG RESULT`` and is not timed.

Usage::

    python -m kmeans_tpu_torch.experiments.exp_pallas_kernel N D K T spec...

    spec    name=tile_n,tile_k,flags       e.g.  f32=128,128,p  bf=64,128,pb
    tile_n  rows of a block's tile: 128 (float32); 128 or 64 (bf16)
    tile_k  centroids of a tile: 128 or 64
    flags   p  fetch the next 16-feature slice into registers while the
               current one is multiplied (KM_PIPE=1); without it: load,
               barrier, multiply
            b  the bf16 tensor-core kernel instead of the float32 one
    The TPU-only flags of the JAX lab, m (manual argmin), o (counts through
    a ones column) and f (h folded into the product), have no counterpart
    and raise ValueError.

It prints one line per variant and then one JSON object per variant.  The
lab changes no tile of the main path.  It needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import json
import statistics
import sys
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

from kmeans_tpu_torch.data.synthetic import make_blobs_device
from kmeans_tpu_torch.ops import _build
from kmeans_tpu_torch.ops import hopper_kernels as hk
from kmeans_tpu_torch.ops import compare as cmp

CHECK_ROWS = 4096

#: Why each TPU-only flag of the JAX lab has no counterpart here.
TPU_ONLY_FLAGS = {
    "m": "the manual argmin is a Mosaic lowering choice; the CUDA kernels' "
         "argmin is always explicit (lowest index among equal minima)",
    "o": "counts through a ones column of the scatter product is a TPU lane "
         "trick; the CUDA scatter always adds the counts as column D of its "
         "per-block table",
    "f": "folding h into the product through a ones column is a TPU lane "
         "trick; the CUDA kernels never fold h: they subtract it in float32 "
         "in the epilogue",
}
#: Supported (tile_n, tile_k) values by kernel class (bf16 or not); the
#: sources' static_asserts say the same.
TILES = {False: ((128,), (128, 64)), True: ((128, 64), (128, 64))}


@dataclass(frozen=True)
class Variant:
    """One compile-time variant of the fused kernel."""

    name: str
    tile_n: int
    tile_k: int
    pipe: bool
    bf16: bool

    @property
    def source(self) -> str:
        return hk.LIB_NAMES[self.bf16]

    @property
    def defines(self) -> Dict[str, int]:
        return {"KM_TILE_N": self.tile_n, "KM_TILE_K": self.tile_k,
                "KM_PIPE": int(self.pipe)}

    @property
    def counter(self) -> str:
        """Its launch counter, ``kernel_variant:<name>``."""
        return f"kernel_variant:{self.name}"

    def library_path(self):
        return _build.library_path(self.source, self.defines)


def parse_spec(text: str) -> Variant:
    """``name=tile_n,tile_k[,flags]`` as a :class:`Variant`; raises
    ValueError on anything it cannot build."""
    name, sep, rest = text.partition("=")
    parts = rest.split(",")
    if not sep or not name or len(parts) not in (2, 3):
        raise ValueError(f"spec {text!r} is not name=tile_n,tile_k[,flags]")
    try:
        tile_n, tile_k = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"spec {text!r}: tile_n and tile_k must be "
                         f"integers") from None
    flags = parts[2] if len(parts) == 3 else ""
    for flag in flags:
        if flag in TPU_ONLY_FLAGS:
            raise ValueError(f"spec {text!r}: flag {flag!r} has no CUDA "
                             f"counterpart: {TPU_ONLY_FLAGS[flag]}")
        if flag not in "pb":
            raise ValueError(f"spec {text!r}: unknown flag {flag!r} "
                             f"(flags: p, b)")
    bf16 = "b" in flags
    rows, cols = TILES[bf16]
    kind = "bf16" if bf16 else "float32"
    if tile_n not in rows or tile_k not in cols:
        raise ValueError(f"spec {text!r}: the {kind} kernel takes tile_n in "
                         f"{rows} and tile_k in {cols}")
    return Variant(name, tile_n, tile_k, "p" in flags, bf16)


def build(variants: Iterable[Variant]) -> List[str]:
    """Build every variant, one ``nvcc`` for each, all started together;
    raises if one fails.  Returns the compilers' outputs."""
    return _build.build_variants((v.source, v.defines) for v in variants)


def run(variant: Variant, points: torch.Tensor, weights: torch.Tensor,
        centroids: torch.Tensor):
    """One fused pass of ``variant``: ``(labels, mind2, sums, counts)``.
    A CUDA tensor launches the variant's build, counted under
    ``LAUNCHES[variant.counter]``; a CPU tensor takes the plain version."""
    hk._check(points, centroids, weights)
    if not points.is_cuda:
        return hk.fused_assign_reduce_reference(points, weights, centroids,
                                                bf16=variant.bf16)
    lib = hk.bind(_build.load_variant(variant.source, variant.defines),
                  variant.bf16)
    hk.LAUNCHES.setdefault(variant.counter, 0)
    return hk.launch_fused(lib, variant.bf16, points, weights, centroids,
                           variant.counter)


# ----------------------------------------------------------------- checking


def check(variant: Variant, points, weights, centroids) -> dict:
    """One pass of ``variant`` against the plain version on the same inputs,
    with the tolerances of :mod:`kmeans_tpu_torch.ops.compare`.  Returns a
    record whose ``ok`` says whether every comparison held."""
    labels, mind2, sums, counts = run(variant, points, weights, centroids)
    ref = hk.fused_assign_reduce_reference(points, weights, centroids,
                                           bf16=variant.bf16)
    if points.is_cuda:
        torch.cuda.synchronize()
    n_diff, n_outside = cmp.label_band(points, centroids, labels, ref[0],
                                       variant.bf16)
    same = labels == ref[0]
    m_ok = cmp.close(mind2[same], ref[1][same], cmp.MIND2_RTOL,
                     cmp.mind2_atol(points, centroids))
    if n_diff:
        ref_sums, ref_counts = cmp.scatter_reference(
            points, weights, labels, centroids.shape[0], variant.bf16)
    else:
        ref_sums, ref_counts = ref[2], ref[3]
    s_ok = cmp.sums_close(sums, ref_sums)
    c_ok = cmp.close(counts, ref_counts, cmp.COUNTS_RTOL, 0.0)
    return {"n": points.shape[0], "ok": n_outside == 0 and m_ok and s_ok
            and c_ok, "label_diff": n_diff, "label_diff_outside_band":
            n_outside, "mind2_err": cmp.max_err(mind2[same], ref[1][same]),
            "sums_err": cmp.max_err(sums, ref_sums),
            "counts_err": cmp.max_err(counts, ref_counts)}


def check_inputs(points, centroids, rows: int = CHECK_ROWS):
    """The check's slice: the first ``rows`` rows, weights in [0.5, 1.5)
    with every tenth row at 0, and the given centroids."""
    x = points[:rows].contiguous()
    gen = torch.Generator(device=x.device).manual_seed(3)
    w = torch.rand((x.shape[0],), generator=gen, device=x.device) + 0.5
    w[::10] = 0.0
    return x, w, centroids


def unit_weights(points) -> torch.Tensor:
    """The timed inputs' weights."""
    return torch.ones(points.shape[0], dtype=torch.float32,
                      device=points.device)


def check_variant(variant: Variant, points, centroids) -> dict:
    """Both checks of ``variant``: on the slice of :func:`check_inputs`
    (weights with zeros), and on the inputs it is timed on (all of
    ``points``, unit weights), where each persistent block walks many row
    tiles."""
    on_slice = check(variant, *check_inputs(points, centroids))
    timed = check(variant, points, unit_weights(points), centroids)
    return {"variant": variant.name, "ok": on_slice["ok"] and timed["ok"],
            "slice": on_slice, "timed_inputs": timed}


# ------------------------------------------------------------------ timing


def _event_ms(fn: Callable[[], object]) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def marginal_ms(variant: Variant, points, weights, centroids, iters: int,
                repeats: int = 3):
    """Milliseconds per Lloyd iteration of ``variant`` by the marginal
    method: (time of 2 + iters passes - time of 2 passes) / iters, each
    pass followed by the centroid update on the device; the median over
    ``repeats`` and the repeats themselves."""

    def chain(count: int):
        c = centroids
        for _ in range(count):
            _, _, sums, counts = run(variant, points, weights, c)
            c = (sums / counts.clamp_min(1.0)[:, None]).contiguous()
        return c

    chain(2)
    chain(2 + iters)
    margins = []
    for _ in range(repeats):
        short = _event_ms(lambda: chain(2))
        long_ = _event_ms(lambda: chain(2 + iters))
        margins.append((long_ - short) / iters)
    return statistics.median(margins), margins


def measure(variant: Variant, points, centroids, iters: int,
            checked: Optional[dict] = None) -> dict:
    """Check ``variant`` (:func:`check_variant`), then, if it held, time it
    on all of ``points`` with unit weights, starting from ``centroids``.
    ``checked`` is that check's record where the caller already made it."""
    if checked is None:
        checked = check_variant(variant, points, centroids)
    rec = {"name": variant.name, "tile_n": variant.tile_n,
           "tile_k": variant.tile_k, "pipe": variant.pipe,
           "bf16": variant.bf16, "check": checked,
           "ms_per_iter": None, "reps": None}
    if checked["ok"]:
        rec["ms_per_iter"], rec["reps"] = marginal_ms(
            variant, points, unit_weights(points), centroids, iters)
    return rec


def line(rec: dict) -> str:
    """The human line of one variant, as the JAX lab prints it."""
    if rec["ms_per_iter"] is None:
        return f"{rec['name']:16s} WRONG RESULT - skipping timing"
    reps = [f"{m:.2f}" for m in rec["reps"]]
    return f"{rec['name']:16s} {rec['ms_per_iter']:8.3f} ms/iter  (reps {reps})"


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) < 5:
        print(__doc__, file=sys.stderr)
        return 2
    n, d, k, iters = (int(a) for a in args[:4])
    variants = [parse_spec(s) for s in args[4:]]
    if not torch.cuda.is_available():
        print("exp_pallas_kernel: torch.cuda.is_available() is False; the "
              "lab builds and times CUDA kernels on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    build(variants)
    x, _ = make_blobs_device(n, min(k, 1024), d, device=dev, seed=1)
    gen = torch.Generator(device=dev).manual_seed(2)
    c0 = x[torch.randperm(n, generator=gen, device=dev)[:k]].contiguous()
    print(f"N={n} D={d} K={k} T={iters} "
          f"device={torch.cuda.get_device_name(0)}", flush=True)
    records = []
    for variant in variants:
        records.append(measure(variant, x, c0, iters))
        print(line(records[-1]), flush=True)
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0 if all(r["check"]["ok"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
