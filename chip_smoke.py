#!/usr/bin/env python3
"""Smoke run of kmeans_tpu_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card, drives the port's main path
(``KMeans.fit`` then ``predict``, ``save`` and ``load``) at n = 2,097,152,
D = 128, k = 1024 in float32 and at a ragged GloVe-like shape, shows by the
launch counters that the path went through the kernels, and times each kernel
beside its plain version, a library yardstick and its roofline bound.

Every phase prints one JSON line as it ends.  A phase that fails raises, so
the run ends with a non-zero code and without the result line.  The last line
is ``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit; the line before that is the table of kernels.

Needs one CUDA device and ``nvcc``; there is no CPU mode.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this run needs "
          "an NVIDIA GPU", file=sys.stderr)
    sys.exit(1)

sys.path.insert(0, str(Path(__file__).resolve().parent))

from kmeans_tpu_torch import KMeans  # noqa: E402
from kmeans_tpu_torch.data.synthetic import make_blobs_device  # noqa: E402
from kmeans_tpu_torch.ops import _build  # noqa: E402
from kmeans_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402

DEV = torch.device("cuda", 0)

# The main shape, and a ragged second one (GloVe-like).
MAIN = dict(n=2_097_152, d=128, k=1024, iters=5)
SECOND = dict(n=400_000, d=100, k=3000, iters=3)
PREDICT_ROWS = 262_144

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates).
PEAK_FP32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12         # bf16 tensor cores (for the later variant)
PEAK_BYTES_PER_S = 3.35e12       # HBM3

# Tolerances, kernel against plain version (both float32 on the card, sums
# taken in another order):
#   labels  equal, or the two centroids' float64 distances to the row differ
#           by at most MARGIN_RTOL * (||x||^2 + max ||c||^2)
#   mind2   |a - b| <= max(1e-4, 1e-6 S) + 1e-4 |b|, S = max ||x||^2 +
#           max ||c||^2: the expanded form cancels, so its absolute error
#           grows with the norms
#   sums    |a - b| <= 1e-5 max|b| + 1e-4 |b|
#   counts  |a - b| <= 1e-5 |b|, and equal where all weights are 0 or 1
MARGIN_RTOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


CARD = ""          # name and power limit, set by main(): beside every time


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


# ----------------------------------------------------------------- comparing


def label_band(x, c, la, lb):
    """(rows whose labels differ, those of them outside the margin band)."""
    diff = (la != lb).nonzero().flatten()
    if diff.numel() == 0:
        return 0, 0
    xd = x[diff].double()
    cd = c.double()
    da = ((xd - cd[la[diff].long()]) ** 2).sum(1)
    db = ((xd - cd[lb[diff].long()]) ** 2).sum(1)
    scale = (xd * xd).sum(1) + (cd * cd).sum(1).max()
    outside = ((da - db).abs() > MARGIN_RTOL * scale) | torch.isnan(da - db)
    return int(diff.numel()), int(outside.sum())


def close(a, b, rtol, atol) -> bool:
    return bool(torch.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True))


def max_err(a, b) -> float:
    d = torch.nan_to_num(a - b, nan=0.0, posinf=0.0, neginf=0.0)
    return float(d.abs().max()) if d.numel() else 0.0


def compare_case(name, x, w, c, *, with_mind2=True, unit_weights=False,
                 expect_label=None):
    """Both kernels on one set of inputs against their plain versions.
    Returns the case's record; raises on any disagreement."""
    out = hk.fused_assign_reduce(x, w, c, with_mind2=with_mind2)
    again = hk.fused_assign_reduce(x, w, c, with_mind2=with_mind2)
    la, ma = hk.hopper_assign(x, c)
    torch.cuda.synchronize()
    ref = hk.fused_assign_reduce_reference(x, w, c, with_mind2=with_mind2)
    lr, mr = hk.assign_reference(x, c)
    torch.cuda.synchronize()
    labels, mind2, sums, counts = out
    finite_x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    scale = float((finite_x * finite_x).sum(1).max() + (c * c).sum(1).max())
    m_atol = max(1e-4, 1e-6 * scale)
    n_diff, n_outside = label_band(x, c, labels, ref[0])
    check(n_outside == 0, f"{name}: {n_outside} labels of kernel 1 differ "
                          f"from the plain version outside the margin band")
    n_diff2, n_outside2 = label_band(x, c, la, lr)
    check(n_outside2 == 0, f"{name}: {n_outside2} labels of kernel 2 differ "
                           f"from the plain version outside the margin band")
    check(torch.equal(la, labels), f"{name}: labels of the two kernels differ")
    same = labels == ref[0]
    rec = {"case": name, "n": x.shape[0], "d": x.shape[1], "k": c.shape[0],
           "with_mind2": with_mind2, "label_diff": n_diff,
           "label_diff_in_band": n_diff - n_outside}
    if with_mind2:
        check(close(mind2[same], ref[1][same], 1e-4, m_atol),
              f"{name}: mind2 of kernel 1 disagrees")
        rec["mind2_err"] = max_err(mind2[same], ref[1][same])
    else:
        check(mind2 is None, f"{name}: with_mind2=False returned a mind2")
    same2 = la == lr
    check(close(ma[same2], mr[same2], 1e-4, m_atol),
          f"{name}: mind2 of kernel 2 disagrees")
    rec["assign_mind2_err"] = max_err(ma[same2], mr[same2])
    if n_diff == 0:
        ref_sums, ref_counts = ref[2], ref[3]
    else:
        # A row on a near-tie sits in another cluster: hold the scatter
        # against index_add_ over the kernel's own labels.
        idx = labels.long()
        live = (w != 0)[:, None]
        ref_sums = torch.zeros_like(sums).index_add_(
            0, idx, torch.where(live, w[:, None] * x, torch.zeros_like(x)))
        ref_counts = torch.zeros_like(counts).index_add_(0, idx, w)
    finite = torch.nan_to_num(ref_sums, nan=0.0, posinf=0.0, neginf=0.0)
    check(close(sums, ref_sums, 1e-4, 1e-5 * float(finite.abs().max())),
          f"{name}: sums disagree")
    rec["sums_err"] = max_err(sums, ref_sums)
    if unit_weights:
        check(torch.equal(counts, ref_counts), f"{name}: counts differ")
    else:
        check(close(counts, ref_counts, 1e-5, 0.0),
              f"{name}: counts disagree")
    rec["counts_err"] = max_err(counts, ref_counts)
    bitwise = (torch.equal(labels, again[0])
               and sums.view(torch.int32).equal(again[2].view(torch.int32))
               and counts.view(torch.int32).equal(
                   again[3].view(torch.int32)))
    check(bitwise, f"{name}: two runs of kernel 1 are not bit-identical")
    rec["bitwise_repeat"] = True
    if expect_label is not None:
        row, want = expect_label
        check(int(labels[row]) == want and int(la[row]) == want,
              f"{name}: row {row} got label {int(labels[row])}, not {want}")
    return rec


def random_case(n, d, k, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device=DEV)
    c = torch.randn((k, d), generator=gen, device=DEV)
    w = torch.rand((n,), generator=gen, device=DEV) + 0.5
    w[::10] = 0.0                      # a tenth of the rows at weight 0
    return x, w, c


def phase_kernels(x_main, c_main, x_second):
    records = []
    shapes = [(4099, 100, 3000), (8192, 128, 1024), (1000, 7, 5),
              (257, 784, 10)]
    for i, (n, d, k) in enumerate(shapes):
        x, w, c = random_case(n, d, k, seed=100 + i)
        records.append(compare_case(f"random_{n}x{d}_k{k}", x, w, c))
    x, w, c = random_case(4099, 100, 3000, seed=7)
    records.append(compare_case("no_mind2", x, w, c, with_mind2=False))
    x, w, c = random_case(2000, 40, 300, seed=8)
    c[200] = c[17]                     # duplicate centroids, one of them far
    c[3] = c[17]                       # down the table: lowest index wins
    x[5] = c[17]
    w[5] = 1.0
    records.append(compare_case("duplicate_centroids", x, w, c,
                                expect_label=(5, 3)))
    x, w, c = random_case(2000, 40, 300, seed=9)
    x[7, 20] = float("nan")            # a NaN row gets label 0
    w[7] = 0.0
    records.append(compare_case("nan_row", x, w, c, expect_label=(7, 0)))
    w_main = torch.ones(x_main.shape[0], device=DEV)
    records.append(compare_case("main_shape", x_main, w_main, c_main,
                                unit_weights=True))
    # The second path's own shape: 3125 row tiles over the persistent
    # blocks, so each block walks many tiles with a ragged last centroid
    # tile and a ragged feature slice.
    x2, w2, c2 = x_second
    records.append(compare_case("glove_shape", x2, w2, c2))
    emit("kernels", cases=records,
         kernels=[{"name": "fused_assign_reduce", "ok": True},
                  {"name": "hopper_assign", "ok": True}])
    return records


# ------------------------------------------------------------------ the path


def sse_non_increasing(history) -> bool:
    return all(b <= a * (1.0 + 1e-6) for a, b in zip(history, history[1:]))


def fit_shape(x, shape, label):
    km = KMeans(k=shape["k"], max_iter=shape["iters"], seed=42,
                compute_sse=True, init="forgy", verbose=False)
    hk.reset_launch_counts()           # this path's own counts
    t0 = time.perf_counter()
    km.fit(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = hk.LAUNCHES["fused_assign_reduce"]
    check(x.is_cuda and km.device.type == "cuda",
          f"{label}: the fit did not run on cuda")
    check(km._mode() == "kernel", f"{label}: default mode is not the kernel")
    check(launched >= km.iterations_run >= 1,
          f"{label}: {launched} launches of kernel 1 for "
          f"{km.iterations_run} iterations")
    check(km.centroids.shape == (shape["k"], shape["d"])
          and bool(torch.isfinite(torch.from_numpy(km.centroids)).all()),
          f"{label}: centroids are not finite (k, D)")
    check(len(km.sse_history) == km.iterations_run
          and sse_non_increasing(km.sse_history),
          f"{label}: SSE history rises: {km.sse_history}")
    check(km.labels_.shape == (shape["n"],)
          and 0 <= int(km.labels_.min())
          and int(km.labels_.max()) < shape["k"],
          f"{label}: labels_ out of range")
    emit("fit", shape=label, n=shape["n"], d=shape["d"], k=shape["k"],
         iterations=km.iterations_run, sse_history=km.sse_history,
         seconds_per_iteration=statistics.median(km.iter_times_),
         fit_seconds=wall, kernel1_launches=launched,
         kernel2_launches=hk.LAUNCHES["hopper_assign"])
    return km


def phase_predict(km, x):
    rows = x[:PREDICT_ROWS]
    before = hk.LAUNCHES["hopper_assign"]
    labels = km.predict(rows)
    launched = hk.LAUNCHES["hopper_assign"] - before
    check(launched == 1, f"predict launched kernel 2 {launched} times")
    cents = torch.from_numpy(km.centroids).to(DEV)
    ref, _ = hk.assign_reference(rows, cents)
    got = torch.from_numpy(labels).to(DEV)
    n_diff, n_outside = label_band(rows, cents, got, ref)
    check(n_outside == 0, f"predict: {n_outside} labels outside the band")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "model.npz"
        km.save(path)
        loaded = KMeans.load(path)
        again = loaded.predict(rows)
    check(loaded.device.type == "cuda", "the loaded model is not on cuda")
    check(bool((again == labels).all()), "labels differ after save and load")
    emit("predict", rows=PREDICT_ROWS, label_diff=n_diff,
         label_diff_in_band=n_diff - n_outside, kernel2_launches=launched,
         save_load_same_labels=True)


# -------------------------------------------------------------------- timing


def median_ms(fn, runs=10, warmup=2) -> float:
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


def bounds(n, d, k, fused: bool):
    """(bound ms, what bounds it, bytes, operations, bf16 bound ms): each
    input read once, each output written once; float32 operations at the
    non-tensor rate."""
    byt = 4 * (n * d + k * d + 2 * n)              # x, c, labels, mind2
    # products, h - x.c, ||x||^2, h
    ops = 2 * n * k * d + n * k + 2 * n * d + 2 * k * d
    if fused:
        byt += 4 * (n + k * d + k)                 # w, sums, counts
        ops += 2 * n * d + n                       # the scatter
    t_bytes = byt / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    bf16 = max(t_bytes, ops / PEAK_BF16_FLOPS * 1e3)
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, byt, ops, bf16


def library_assign(x, c, block=65536):
    """The yardstick: torch.cdist + argmin over blocks of rows."""
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for lo in range(0, x.shape[0], block):
        out[lo:lo + block] = torch.cdist(x[lo:lo + block], c).argmin(dim=1)
    return out


def library_fused(x, w, c):
    labels = library_assign(x, c)
    sums = torch.zeros_like(c).index_add_(0, labels, w[:, None] * x)
    counts = torch.zeros(c.shape[0], device=x.device).index_add_(0, labels, w)
    return labels, sums, counts


def phase_timing(x, c, errs, launches, iter_seconds):
    n, d = x.shape
    k = c.shape[0]
    w = torch.ones(n, device=DEV)
    rows = []
    specs = [
        ("fused_assign_reduce", True,
         "kmeans_tpu/ops/pallas_kernels.py:558",
         lambda: hk.fused_assign_reduce(x, w, c),
         lambda: hk.fused_assign_reduce_reference(x, w, c),
         lambda: library_fused(x, w, c)),
        ("hopper_assign", False,
         "kmeans_tpu/ops/pallas_kernels.py:542",
         lambda: hk.hopper_assign(x, c),
         lambda: hk.assign_reference(x, c),
         lambda: library_assign(x, c)),
    ]
    for name, fused, replaces, kernel, plain, library in specs:
        bound_ms, by, byt, ops, bf16_ms = bounds(n, d, k, fused)
        ms = median_ms(kernel)
        rows.append({
            "name": name, "route": "cuda",
            "source": "kmeans_tpu_torch/csrc/assign_kernels.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms,
            "plain_ms": median_ms(plain), "bound_ms": bound_ms,
            "bound_by": by, "library_ms": median_ms(library)})
        emit("timing", kernel=name, n=n, d=d, k=k, kernel_ms=ms,
             plain_ms=rows[-1]["plain_ms"],
             library_ms=rows[-1]["library_ms"], bound_ms=bound_ms,
             bound_by=by, bytes=byt, operations=ops,
             bf16_tensor_core_bound_ms=bf16_ms,
             roofline_share=bound_ms / ms)
    # The whole step on the device (the fused kernel, the algebraic SSE's
    # sum of w ||x||^2, per-cluster SSE and farthest point), beside the
    # host's wall time for one iteration of the fit.
    step = dist.make_step_fn(chunk_size=n, mode="kernel")
    emit("timing", what="one Lloyd iteration of the main fit",
         step_ms=median_ms(lambda: step(x, w, c)),
         weighted_sqnorm_ms=median_ms(
             lambda: dist._weighted_sqnorm_total(x, w)),
         seconds_per_iteration=iter_seconds, n=n, d=d, k=k)
    return rows


def main() -> None:
    global CARD
    CARD = card_line()
    emit("env", device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    _build.build()
    emit("build", sources=_build.source_names(),
         seconds=time.perf_counter() - t0)

    x_main, _ = make_blobs_device(MAIN["n"], MAIN["k"], MAIN["d"],
                                  device=DEV, seed=1)
    gen = torch.Generator(device=DEV).manual_seed(2)
    pick = torch.randperm(MAIN["n"], generator=gen, device=DEV)[:MAIN["k"]]
    c_main = x_main[pick].contiguous()
    x2, _ = make_blobs_device(SECOND["n"], 1000, SECOND["d"], device=DEV,
                              seed=5)
    pick2 = torch.randperm(SECOND["n"], generator=gen,
                           device=DEV)[:SECOND["k"]]
    w2 = torch.rand((SECOND["n"],), generator=gen, device=DEV) + 0.5
    w2[::10] = 0.0                     # a tenth of the rows at weight 0
    records = phase_kernels(x_main, c_main,
                            (x2, w2, x2[pick2].contiguous()))
    del w2
    main_rec = next(r for r in records if r["case"] == "main_shape")
    errs = {"fused_assign_reduce": max(main_rec["sums_err"],
                                       main_rec["mind2_err"],
                                       main_rec["counts_err"]),
            "hopper_assign": main_rec["assign_mind2_err"]}

    # Each path: counters to 0 just before (in fit_shape), read just after.
    # The main path is fit, predict, save, load and predict again.
    km = fit_shape(x_main, MAIN, "main")
    phase_predict(km, x_main)
    launches = dict(hk.LAUNCHES)
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path was never launched: {launches}")
    emit("launches", path="main", **launches)

    fit_shape(x2, SECOND, "glove_like")
    second = dict(hk.LAUNCHES)
    del x2
    check(all(v > 0 for v in second.values()),
          f"a kernel of the second path was never launched: {second}")
    emit("launches", path="glove_like", **second)

    rows = phase_timing(x_main, c_main, errs, launches,
                        statistics.median(km.iter_times_))

    print(json.dumps({"kernels": rows}), flush=True)
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
