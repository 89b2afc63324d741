#!/usr/bin/env python3
"""Smoke run of kmeans_tpu_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds the CUDA kernels from the sources in this checkout (and four
compile-time variants of the K-Means kernel for the variant lab, all with
one ``nvcc`` each, started together), holds each kernel against its plain
PyTorch version on the card, and drives five paths: ``KMeans.fit`` then
``predict``, ``save`` and ``load`` at n = 2,097,152, D = 128, k = 1024 in
float32; the same with ``distance_mode='pallas_bf16'`` (the bf16
tensor-core kernels) plus ``score``; ``KMeans.fit`` at a ragged GloVe-like
shape; ``GaussianMixture.fit`` (k = 256, 'diag', internal KMeans init) then
``predict``, ``predict_proba``, ``score_samples``, ``save`` and ``load`` at
n = 2,097,152, D = 128, on blobs about 1e3 from the origin; and the variant
lab (``kmeans_tpu_torch.experiments.exp_pallas_kernel``) at the main shape.
The launch counters show that each path went through its own kernels.  Each
kernel is timed beside its plain version, a library yardstick and its
roofline bound.

Every phase prints one JSON line as it ends.  A phase that fails raises, so
the run ends with a non-zero code and without the result line.  The last line
is ``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit; the line before that is the table of kernels.

Needs one CUDA device and ``nvcc``; there is no CPU mode.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this run needs "
          "an NVIDIA GPU", file=sys.stderr)
    sys.exit(1)

sys.path.insert(0, str(Path(__file__).resolve().parent))

from kmeans_tpu_torch import GaussianMixture, KMeans  # noqa: E402
from kmeans_tpu_torch.data.synthetic import make_blobs_device  # noqa: E402
from kmeans_tpu_torch.experiments import exp_kernel_edits as kernel_edits  # noqa: E402,E501
from kmeans_tpu_torch.experiments import exp_pallas_kernel as lab  # noqa: E402
from kmeans_tpu_torch.models.kmeans import _FORMAT_MODES  # noqa: E402
from kmeans_tpu_torch.ops import _build  # noqa: E402
from kmeans_tpu_torch.ops import compare as cmp  # noqa: E402
from kmeans_tpu_torch.ops import estep_kernels as ek  # noqa: E402
from kmeans_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402
from kmeans_tpu_torch.parallel.sharding import (EM_MAX_CHUNK,  # noqa: E402
                                                weighted_mean)

DEV = torch.device("cuda", 0)

# The main shape, and a ragged second one (GloVe-like).
MAIN = dict(n=2_097_152, d=128, k=1024, iters=5)
SECOND = dict(n=400_000, d=100, k=3000, iters=3)
PREDICT_ROWS = 262_144
# The mixture path: the shape of the JAX package's own mixture record
# (docs/PERFORMANCE.md, "The mixture family"), blobs about 1e3 from the
# origin so that centering and moment precision are exercised (made by
# exp_kernel_edits.estep_inputs, which the E-step ablations time too).
GMM = dict(n=2_097_152, d=128, k=256, iters=5)

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates).
PEAK_FP32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12         # TF32 tensor cores
PEAK_BF16_FLOPS = 989e12         # bf16 tensor cores
PEAK_BYTES_PER_S = 3.35e12       # HBM3

# The variant lab's phase: four variants at the main shape, T iterations.
LAB_ITERS = 5
LAB_SPECS = ("f32_default=128,128,p", "f32_k64=128,64,p",
             "bf16_default=128,128,pb", "bf16_n64=64,128,pb")

# Tolerances, kernel against plain version: those of
# kmeans_tpu_torch/ops/compare.py, which says why (the variant lab checks its
# builds with the same module):
#   labels  equal outside MARGIN_RTOL * (||x||^2 + max ||c||^2) on the
#           float64 difference of the two centroids' distances (bf16: of the
#           scores from the bf16-rounded inputs)
#   mind2   |a - b| <= max(1e-4, 1e-6 S) + 1e-4 |b|, S = max ||x||^2 +
#           max ||c||^2
#   sums    |a - b| <= 1e-5 max|b| + 1e-4 |b|
#   counts  |a - b| <= 1e-5 |b|, and equal where all weights are 0 or 1
# The bf16 kernels are held to their bf16 plain versions with the same
# tolerances.
MARGIN_RTOL = cmp.MARGIN_RTOL
# The SSE history of a bf16 fit may rise by this share between iterations:
# its SSE is derived from sums of bf16-rounded products (2^-9 relative per
# coordinate), and its assignments are approximate.
BF16_SSE_SLACK = 1e-3
# A bf16 fit's final SSE lies within this share of the float32 fit's.
BF16_SSE_RATIO = 0.01
# diag_estep against diag_estep_reference (both float32 on the card), with
# the tolerances of ops/compare.py (ESTEP_RTOL, ESTEP_ATOL_SHARE, LL_RTOL):
#   rsum, s1, s2  |a - b| <= 1e-5 max|b| + 1e-4 |b|  (centered sums cancel
#                 to near zero, hence the share of the largest entry)
#   ll            |a - b| <= 1e-5 |b|
#   and two runs of the kernel give the same bits.
# The hard-init tables (inv_var = 1e6) are held on the rows outside the tie
# band: x_c^2 a and 2 x_c b are of order 1e8 and cancel, so a row whose two
# nearest means' float64 squared distances differ by less than
# MARGIN_RTOL * (||x_c||^2 + max ||mu_c||^2) may go to either mean.
# far_clusters (clusters 100 apart, unit noise) is held by its variances
# S2/R - (S1/R)^2 against the float64 plain version: within this factor of
# the float32 plain version's own error there (measured in the same run).
FAR_VAR_FACTOR = 4.0


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


def clocks() -> str:
    """The card's SM clock, power draw and temperature now (beside a
    timing: a card below its power limit runs slower under load)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """The last name of a mangled kernel (``_Z<len><name>`` or, inside a
    namespace, ``_ZN<len><ns><len><name>``), with ``<0>`` / ``<1>`` for its
    bool template argument (``ILb0E`` / ``ILb1E``)."""
    nested = mangled.startswith("_ZN")
    if not mangled.startswith("_Z"):
        return mangled
    pos, name = (3 if nested else 2), mangled
    while m := re.compile(r"\d+").match(mangled, pos):
        name = mangled[m.end():m.end() + int(m.group())]
        pos = m.end() + int(m.group())
        if not nested:
            break
    if mangled.startswith("ILb", pos):
        name += f"<{mangled[pos + 3]}>"
    return name


def resource_usage(library: Path) -> list:
    """Registers, stack frame (where spills go), local memory and shared
    memory (with the 1 KiB the system reserves) of each kernel in a built
    library, from ``cuobjdump --dump-resource-usage``.  A kernel templated
    on its vector loads appears once for each."""
    text = subprocess.run(
        [str(Path(_build.find_nvcc()).parent / "cuobjdump"),
         "--dump-resource-usage", str(library)], capture_output=True,
        text=True, check=True).stdout
    out = []
    for mangled, fields in re.findall(r"Function (\S+):\s*\n\s*(.*)", text):
        usage = re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", fields)
        out.append({"kernel": kernel_name(mangled),
                    **{key.lower(): int(value) for key, value in usage}})
    check(bool(out), f"cuobjdump found no kernel in {library.name}")
    return out


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


# ----------------------------------------------------------------- comparing


label_band, close, max_err = cmp.label_band, cmp.close, cmp.max_err


def compare_case(name, x, w, c, *, with_mind2=True, unit_weights=False,
                 expect_label=None, bf16=False):
    """Both kernels (the bf16 ones with ``bf16``) on one set of inputs
    against their plain versions.  ``expect_label`` is (row, label) that
    both kernels must give.  Returns the case's record; raises on any
    disagreement."""
    out = hk.fused_assign_reduce(x, w, c, with_mind2=with_mind2, bf16=bf16)
    again = hk.fused_assign_reduce(x, w, c, with_mind2=with_mind2,
                                   bf16=bf16)
    la, ma = hk.hopper_assign(x, c, bf16=bf16)
    la2, ma2 = hk.hopper_assign(x, c, bf16=bf16)
    torch.cuda.synchronize()
    ref = hk.fused_assign_reduce_reference(x, w, c, with_mind2=with_mind2,
                                           bf16=bf16)
    lr, mr = hk.assign_reference(x, c, bf16=bf16)
    torch.cuda.synchronize()
    labels, mind2, sums, counts = out
    m_atol = cmp.mind2_atol(x, c)
    n_diff, n_outside = label_band(x, c, labels, ref[0], bf16)
    check(n_outside == 0, f"{name}: {n_outside} labels of kernel 1 differ "
                          f"from the plain version outside the margin band")
    n_diff2, n_outside2 = label_band(x, c, la, lr, bf16)
    check(n_outside2 == 0, f"{name}: {n_outside2} labels of kernel 2 differ "
                           f"from the plain version outside the margin band")
    check(torch.equal(la, labels), f"{name}: labels of the two kernels differ")
    same = labels == ref[0]
    rec = {"case": name, "n": x.shape[0], "d": x.shape[1], "k": c.shape[0],
           "bf16": bf16, "with_mind2": with_mind2, "label_diff": n_diff,
           "label_diff_in_band": n_diff - n_outside}
    if with_mind2:
        check(close(mind2[same], ref[1][same], cmp.MIND2_RTOL, m_atol),
              f"{name}: mind2 of kernel 1 disagrees")
        rec["mind2_err"] = max_err(mind2[same], ref[1][same])
    else:
        check(mind2 is None, f"{name}: with_mind2=False returned a mind2")
    same2 = la == lr
    check(close(ma[same2], mr[same2], cmp.MIND2_RTOL, m_atol),
          f"{name}: mind2 of kernel 2 disagrees")
    rec["assign_mind2_err"] = max_err(ma[same2], mr[same2])
    if n_diff == 0:
        ref_sums, ref_counts = ref[2], ref[3]
    else:
        # A row on a near-tie sits in another cluster: hold the scatter
        # against index_add_ over the kernel's own labels.
        ref_sums, ref_counts = cmp.scatter_reference(x, w, labels, c.shape[0],
                                                     bf16)
    check(cmp.sums_close(sums, ref_sums), f"{name}: sums disagree")
    rec["sums_err"] = max_err(sums, ref_sums)
    if unit_weights:
        check(torch.equal(counts, ref_counts), f"{name}: counts differ")
    else:
        check(close(counts, ref_counts, cmp.COUNTS_RTOL, 0.0),
              f"{name}: counts disagree")
    rec["counts_err"] = max_err(counts, ref_counts)
    bitwise = (torch.equal(labels, again[0])
               and sums.view(torch.int32).equal(again[2].view(torch.int32))
               and counts.view(torch.int32).equal(
                   again[3].view(torch.int32)))
    check(bitwise, f"{name}: two runs of kernel 1 are not bit-identical")
    check(torch.equal(la, la2) and ma.view(torch.int32).equal(
        ma2.view(torch.int32)), f"{name}: two runs of kernel 2 are not "
                                f"bit-identical")
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


def phase_kernels(x_main, c_main, x_second, bf16=False):
    """The ten cases, for the float32 kernels or (``bf16``) the bf16
    ones."""
    records = []
    shapes = [(4099, 100, 3000), (8192, 128, 1024), (1000, 7, 5),
              (257, 784, 10)]
    for i, (n, d, k) in enumerate(shapes):
        x, w, c = random_case(n, d, k, seed=100 + i)
        records.append(compare_case(f"random_{n}x{d}_k{k}", x, w, c,
                                    bf16=bf16))
    x, w, c = random_case(4099, 100, 3000, seed=7)
    records.append(compare_case("no_mind2", x, w, c, with_mind2=False,
                                bf16=bf16))
    x, w, c = random_case(2000, 40, 300, seed=8)
    c[200] = c[17]                     # duplicate centroids, one of them far
    c[3] = c[17]                       # down the table: lowest index wins
    x[5] = c[17]
    w[5] = 1.0
    records.append(compare_case("duplicate_centroids", x, w, c,
                                expect_label=(5, 3), bf16=bf16))
    x, w, c = random_case(2000, 40, 300, seed=9)
    x[7, 20] = float("nan")            # a NaN row gets label 0
    w[7] = 0.0
    records.append(compare_case("nan_row", x, w, c, expect_label=(7, 0),
                                bf16=bf16))
    # One +Inf coordinate: every score is +-inf, none NaN, so the row gets a
    # real label, the plain version's: the lowest centroid whose coordinate
    # is positive (a split that made Inf - Inf = NaN would give label 0; a
    # label other than the plain version's has a NaN margin, which
    # label_band counts as outside the band).  The other features sit near
    # 1e3, where the float32 kernels shift their frame: the shift must keep
    # those signs.
    x, w, c = random_case(2000, 40, 300, seed=10)
    x += 1e3
    c += 1e3
    c[:, 5] -= 1e3                     # a column of both signs, ...
    c[:3, 5] = -c[:3, 5].abs()         # ... negative for the first three
    x[11, 5] = float("inf")
    w[11] = 1.0
    want = int((c[:, 5] > 0).nonzero()[0])
    records.append(compare_case("inf_coordinate", x, w, c,
                                expect_label=(11, want), bf16=bf16))
    w_main = torch.ones(x_main.shape[0], device=DEV)
    records.append(compare_case("main_shape", x_main, w_main, c_main,
                                unit_weights=True, bf16=bf16))
    # The second path's own shape: 3125 row tiles over the persistent
    # blocks, so each block walks many tiles with a ragged last centroid
    # tile and a ragged feature slice.
    x2, w2, c2 = x_second
    records.append(compare_case("glove_shape", x2, w2, c2, bf16=bf16))
    suffix = "_bf16" if bf16 else ""
    emit("kernels" + suffix, cases=records,
         kernels=[{"name": "fused_assign_reduce" + suffix, "ok": True},
                  {"name": "hopper_assign" + suffix, "ok": True}])
    return records


# ------------------------------------------------------- the mixture's kernel


def estep_tables(means_c, var, log_w):
    """E-step tables (inv_var, log_det, log_weights) of a diagonal mixture."""
    var = var.contiguous()
    return (1.0 / var).contiguous(), torch.log(var).sum(1).contiguous(), \
        log_w.contiguous()


def clear_of_ties(x, shift, means_c, block=65536):
    """Rows whose two nearest means are farther apart (float64) than the
    tie band of the hard-init tables."""
    mc = means_c.double()
    out = torch.empty(x.shape[0], dtype=torch.bool, device=x.device)
    for lo in range(0, x.shape[0], block):
        xc = x[lo:lo + block].double() - shift.double()
        d2 = torch.cdist(xc, mc) ** 2
        two = d2.topk(2, dim=1, largest=False).values
        scale = (xc * xc).sum(1) + (mc * mc).sum(1).max()
        out[lo:lo + block] = (two[:, 1] - two[:, 0]) > MARGIN_RTOL * scale
    return out


def estep_case(name, x, w, shift, means_c, inv_var, log_det, log_w):
    """diag_estep against its plain version on one set of inputs; raises on
    any disagreement.  Returns the case's record."""
    args = (x, w, shift, means_c, inv_var, log_det, log_w)
    out = ek.diag_estep(*args)
    again = ek.diag_estep(*args)
    torch.cuda.synchronize()
    ref = ek.diag_estep_reference(*args)
    torch.cuda.synchronize()
    errs = cmp.estep_errors(out, ref)
    check(errs.pop("ok"), f"{name}: an output is not finite or disagrees "
                          f"(ll {float(out[3])} against {float(ref[3])}; "
                          f"largest errors {errs})")
    rec = {"case": name, "n": x.shape[0], "d": x.shape[1],
           "k": means_c.shape[0], **errs, "ll": float(out[3])}
    check(abs(float(out[0].sum()) - float(w.sum()))
          <= 1e-4 * float(w.sum()), f"{name}: rsum does not add up to sum w")
    bitwise = all(a.view(torch.int32).equal(b.view(torch.int32))
                  for a, b in zip(out, again))
    check(bitwise, f"{name}: two runs of diag_estep are not bit-identical")
    rec["bitwise_repeat"] = True
    return rec


def gmm_case(n, d, k, seed, *, spread=3.0, offset=0.0, hard=False,
             spherical=False):
    """Blobs, weights (a tenth 0), their weighted mean and the tables of a
    mixture near them (or the hard-init tables)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    centers = torch.randn((k, d), generator=gen, device=DEV) * spread + offset
    y = torch.randint(0, k, (n,), generator=gen, device=DEV)
    x = (centers[y] + torch.randn((n, d), generator=gen, device=DEV)
         ).contiguous()
    w = torch.rand((n,), generator=gen, device=DEV) + 0.5
    w[::10] = 0.0                      # a tenth of the rows at weight 0
    shift = weighted_mean(x, w).contiguous()
    if hard:
        means_c = (centers - shift).contiguous()
        tables = (torch.full((k, d), 1e6, device=DEV),
                  torch.zeros(k, device=DEV), torch.zeros(k, device=DEV))
        w = torch.where(clear_of_ties(x, shift, means_c), w,
                        torch.zeros_like(w))
        return x, w, shift, means_c, *tables
    means_c = (centers - shift + 0.3 * torch.randn(
        (k, d), generator=gen, device=DEV)).contiguous()
    var = torch.rand((k, 1 if spherical else d), generator=gen,
                     device=DEV) + 0.5
    log_w = torch.log_softmax(torch.randn(k, generator=gen, device=DEV), 0)
    return (x, w, shift, means_c,
            *estep_tables(means_c, var.expand(k, d), log_w))


def with_bad_rows(x, w, *tables):
    """Rows holding NaN, +Inf or -Inf, all at weight 0 (the shift and
    tables come from the clean data)."""
    bad = torch.arange(7, x.shape[0], 997, device=DEV)
    x[bad[0::3], 3] = float("nan")
    x[bad[1::3]] = float("inf")
    x[bad[2::3], 10] = -float("inf")
    w[bad] = 0.0
    return (x, w, *tables)


def variances(rsum, s1, s2):
    """The M-step's diagonal variances S2/R - (S1/R)^2, in float64."""
    r = rsum.double()[:, None]
    return s2.double() / r - (s1.double() / r) ** 2


def far_case(name, x, w, shift, means_c, inv_var, log_det, log_w):
    """Clusters 100 apart with unit noise, where S2/R - (S1/R)^2 cancels:
    the variances from the kernel's moments against those of the float64
    plain version, within 4 times the error that the float32 plain version
    shows against the same float64 one."""
    args = (x, w, shift, means_c, inv_var, log_det, log_w)
    out = ek.diag_estep(*args)
    again = ek.diag_estep(*args)
    plain = ek.diag_estep_reference(*args)
    exact = ek.diag_estep_reference(*(a.double() for a in args))
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(a).all()) for a in out),
          f"{name}: an output is not finite")
    want = variances(*exact[:3])
    kernel_err = float((variances(*out[:3]) - want).abs().max())
    plain_err = float((variances(*plain[:3]) - want).abs().max())
    check(kernel_err <= FAR_VAR_FACTOR * plain_err,
          f"{name}: variance error {kernel_err}, more than "
          f"{FAR_VAR_FACTOR} x the float32 plain version's {plain_err}")
    check(all(a.view(torch.int32).equal(b.view(torch.int32))
              for a, b in zip(out, again)),
          f"{name}: two runs of diag_estep are not bit-identical")
    return {"case": name, "n": x.shape[0], "d": x.shape[1],
            "k": means_c.shape[0], "variance_err": kernel_err,
            "plain_float32_variance_err": plain_err,
            "variance_factor": FAR_VAR_FACTOR,
            "ll_err_float64": max_err(out[3], exact[3].float()),
            "bitwise_repeat": True}


def phase_estep_kernel(x_gmm, gmm_tables):
    records = [estep_case("gmm_main_shape", x_gmm,
                          torch.ones(x_gmm.shape[0], device=DEV),
                          *gmm_tables)]
    cases = [
        ("ragged_400000x100_k3000", dict(n=400_000, d=100, k=3000)),
        ("tiny_d7_k5", dict(n=1000, d=7, k=5)),
        ("tiny_many_tiles", dict(n=20_011, d=7, k=5)),
        ("hard_init_tables", dict(n=50_000, d=64, k=32, hard=True)),
        ("spherical", dict(n=30_000, d=40, k=70, spherical=True)),
        # test_gmm_tpu.py's offset clusters: N(0, 25) + 1e3
        ("offset_clusters", dict(n=50_000, d=64, k=32, spread=5.0,
                                 offset=1e3)),
        ("nan_rows_at_weight_0", dict(n=20_000, d=64, k=32)),
        # the last component tile of 128 full, and one past it; then the
        # kernel's own tile of 256 and one past it (one component
        # recomputed, the rest kept)
        ("k_128", dict(n=30_000, d=64, k=128)),
        ("k_129", dict(n=30_000, d=64, k=129)),
        ("k_257", dict(n=30_000, d=48, k=257)),
        # rows too wide to stay in shared memory: read where needed
        ("wide_d200", dict(n=20_000, d=200, k=40)),
    ]
    for i, (name, kw) in enumerate(cases):
        case = gmm_case(seed=300 + i, **kw)
        if name == "nan_rows_at_weight_0":
            case = with_bad_rows(*case)
        records.append(estep_case(name, *case))
    records.append(far_case("far_clusters", *gmm_case(
        n=50_000, d=64, k=32, seed=300 + len(cases), spread=100.0)))
    emit("estep_kernel", cases=records,
         kernels=[{"name": "diag_estep", "ok": True}])
    return records


# ------------------------------------------------------------ the mixture path


def phase_gmm(x_gmm):
    """GaussianMixture fit, predict, predict_proba, score_samples, save,
    load and predict again on the card, at full width."""
    gm = GaussianMixture(n_components=GMM["k"], init_params="kmeans",
                         max_iter=GMM["iters"], tol=0.0, seed=7)
    bounds_seen = []
    m_step = gm._m_step

    def record(st):                    # the lower bound of every E-step
        out = m_step(st)
        bounds_seen.append(float(st.loglik) / out[0])
        return out

    gm._m_step = record
    hk.reset_launch_counts()           # this path's own counts
    t0 = time.perf_counter()
    gm.fit(x_gmm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(gm.estep_path_ == "kernel", f"E-step path {gm.estep_path_}")
    check(gm.n_iter_ == GMM["iters"], f"{gm.n_iter_} EM iterations")
    em = bounds_seen[1:]               # the hard-init pass first
    check(len(em) == GMM["iters"] and all(np.isfinite(em)),
          f"lower bounds {bounds_seen}")
    check(all(b >= a - 1e-5 * abs(a) for a, b in zip(em, em[1:])),
          f"the lower bound decreases: {em}")
    cov = gm.covariances_
    check(cov.shape == (GMM["k"], GMM["d"]) and bool(np.isfinite(cov).all()),
          "covariances_ are not finite (k, D)")
    median = float(np.median(cov))
    check(0.5 < median < 2.0, f"median covariance {median}, blobs have 1")
    check(float(cov.min()) > 0.1, f"a covariance collapsed: {cov.min()}")
    check(abs(float(gm.weights_.sum()) - 1.0) < 1e-9, "weights_ sum")

    rows = x_gmm[:PREDICT_ROWS]
    labels = gm.predict(rows)
    proba = gm.predict_proba(rows)
    scores = gm.score_samples(rows)
    check(labels.shape == (PREDICT_ROWS,) and labels.dtype == np.int32
          and 0 <= labels.min() and labels.max() < GMM["k"],
          "predict: labels out of range")
    check(proba.shape == (PREDICT_ROWS, GMM["k"])
          and np.allclose(proba.sum(1), 1.0, atol=1e-4),
          "predict_proba: rows do not sum to 1")
    check(bool((proba.argmax(1) == labels).all()),
          "predict is not the argmax of predict_proba")
    check(scores.shape == (PREDICT_ROWS,) and bool(np.isfinite(scores).all()),
          "score_samples is not finite")
    # Labels against a float64 posterior on a slice, outside the band where
    # the two best log-densities are closer than float32 can tell.
    sub = rows[:4096].double()
    shift = torch.from_numpy(gm.shift_).to(DEV)
    mc = torch.from_numpy(gm.means_).to(DEV) - shift
    var = torch.from_numpy(np.maximum(cov, gm.reg_covar)).to(DEV)
    logp = (torch.log(torch.from_numpy(gm.weights_).to(DEV))
            - 0.5 * ((((sub - shift)[:, None, :] - mc[None]) ** 2
                      / var[None]).sum(-1) + torch.log(var).sum(1)
                     + GMM["d"] * math.log(2 * math.pi)))
    top = logp.topk(2, dim=1).values
    clear = ((top[:, 0] - top[:, 1]) > 1e-2).cpu().numpy()
    want = logp.argmax(1).cpu().numpy()
    check(bool((labels[:4096][clear] == want[clear]).all()),
          "predict disagrees with a float64 posterior")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "gmm.npz"
        gm.save(path)
        loaded = GaussianMixture.load(path)
        again = loaded.predict(rows)
    check(loaded.device.type == "cuda", "the loaded mixture is not on cuda")
    check(bool((again == labels).all()), "labels differ after save and load")
    launches = check_path_launches("gmm")
    check(launches["diag_estep"] == 1 + GMM["iters"],
          f"diag_estep launched {launches['diag_estep']} times, not 1 hard "
          f"init + {GMM['iters']} EM iterations")
    emit("gmm", n=GMM["n"], d=GMM["d"], k=GMM["k"], iterations=gm.n_iter_,
         lower_bounds=em, covariance_median=median,
         covariance_min=float(cov.min()), covariance_max=float(cov.max()),
         fit_seconds=fit_s,
         seconds_per_iteration=statistics.median(gm.iter_times_),
         predict_rows=PREDICT_ROWS, float64_label_rows=int(clear.sum()),
         save_load_same_labels=True)
    return gm, launches


def phase_gmm_offset():
    """The check the JAX package pins on its own hardware
    (tests/test_gmm_tpu.py): clusters N(0, 25) + 1e3, means_init at the
    true centers; every covariance near the true 1, lower bound < 0."""
    rng = np.random.default_rng(0)
    k, d, n = 32, 64, 50_000
    centers = rng.normal(size=(k, d)) * 5 + 1e3
    y = rng.integers(0, k, size=n)
    X = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    gm = GaussianMixture(n_components=k, means_init=centers, max_iter=3,
                         tol=0.0, seed=1).fit(X)
    cov = gm.covariances_
    check(float(cov.min()) > 0.5 and float(cov.max()) < 2.0,
          f"offset clusters: covariances in [{cov.min()}, {cov.max()}]")
    check(gm.lower_bound_ < 0, f"offset clusters: lower bound "
                               f"{gm.lower_bound_} >= 0")
    emit("gmm_offset", k=k, d=d, n=n, covariance_min=float(cov.min()),
         covariance_max=float(cov.max()), lower_bound=gm.lower_bound_)


# ------------------------------------------------------------------ the path


#: The kernels that each path must launch at least once.
PATH_KERNELS = {
    "main": ("fused_assign_reduce", "hopper_assign"),
    "main_bf16": ("fused_assign_reduce_bf16", "hopper_assign_bf16"),
    "glove_like": ("fused_assign_reduce", "hopper_assign"),
    "gmm": ("diag_estep", "fused_assign_reduce"),
    "lab": tuple(lab.parse_spec(spec).counter for spec in LAB_SPECS),
}


def check_path_launches(path: str) -> dict:
    """Reads the counters just after a path: every kernel the path names
    must have launched; kernels of other paths are not its business."""
    launches = dict(hk.LAUNCHES)
    missing = [name for name in PATH_KERNELS[path]
               if launches.get(name, 0) <= 0]
    check(not missing, f"kernels of the {path} path never launched: "
                       f"{missing} (counts {launches})")
    emit("launches", path=path, **launches)
    return launches


def largest_rise(history) -> float:
    """The largest rise of the SSE history between iterations, as a share
    of the earlier value (0 where it never rises)."""
    return max([(b - a) / a for a, b in zip(history, history[1:])] + [0.0])


def fit_shape(x, shape, label, distance_mode="auto"):
    """One fit on the card.  'auto' must resolve to the float32 kernel;
    'pallas_bf16' runs the bf16 one and may let the SSE rise by
    BF16_SSE_SLACK."""
    bf16 = distance_mode == "pallas_bf16"
    suffix = "_bf16" if bf16 else ""
    km = KMeans(k=shape["k"], max_iter=shape["iters"], seed=42,
                compute_sse=True, init="forgy", verbose=False,
                distance_mode=distance_mode)
    hk.reset_launch_counts()           # this path's own counts
    t0 = time.perf_counter()
    km.fit(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = hk.LAUNCHES["fused_assign_reduce" + suffix]
    check(x.is_cuda and km.device.type == "cuda",
          f"{label}: the fit did not run on cuda")
    want = "kernel" + suffix
    check(km._mode() == want, f"{label}: mode {km._mode()}, not {want}")
    check(launched >= km.iterations_run >= 1,
          f"{label}: {launched} launches of kernel 1 for "
          f"{km.iterations_run} iterations")
    check(km.centroids.shape == (shape["k"], shape["d"])
          and bool(torch.isfinite(torch.from_numpy(km.centroids)).all()),
          f"{label}: centroids are not finite (k, D)")
    rise = largest_rise(km.sse_history)
    check(len(km.sse_history) == km.iterations_run
          and rise <= (BF16_SSE_SLACK if bf16 else 1e-6),
          f"{label}: SSE history rises: {km.sse_history}")
    check(km.labels_.shape == (shape["n"],)
          and 0 <= int(km.labels_.min())
          and int(km.labels_.max()) < shape["k"],
          f"{label}: labels_ out of range")
    emit("fit", shape=label, n=shape["n"], d=shape["d"], k=shape["k"],
         distance_mode=distance_mode, iterations=km.iterations_run,
         sse_history=km.sse_history, largest_sse_rise=rise,
         seconds_per_iteration=statistics.median(km.iter_times_),
         fit_seconds=wall, kernel1_launches=launched,
         kernel2_launches=hk.LAUNCHES["hopper_assign" + suffix])
    return km


def phase_predict(km, x):
    """predict on the card against the plain version, then save, load and
    predict again; for a bf16 model also ``score``."""
    bf16 = km._mode() == "kernel_bf16"
    name = "hopper_assign_bf16" if bf16 else "hopper_assign"
    rows = x[:PREDICT_ROWS]
    before = hk.LAUNCHES[name]
    labels = km.predict(rows)
    launched = hk.LAUNCHES[name] - before
    check(launched == 1, f"predict launched kernel 2 {launched} times")
    cents = torch.from_numpy(km.centroids).to(DEV)
    ref, _ = hk.assign_reference(rows, cents, bf16=bf16)
    got = torch.from_numpy(labels).to(DEV)
    n_diff, n_outside = label_band(rows, cents, got, ref, bf16)
    check(n_outside == 0, f"predict: {n_outside} labels outside the band")
    fields = {}
    if bf16:
        before = hk.LAUNCHES["fused_assign_reduce_bf16"]
        fields["score"] = km.score(rows)
        check(hk.LAUNCHES["fused_assign_reduce_bf16"] == before + 1
              and math.isfinite(fields["score"]) and fields["score"] <= 0,
              f"score: {fields['score']}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "model.npz"
        km.save(path)
        with np.load(path) as z:
            saved_mode = json.loads(str(z["__meta__"]))["distance_mode"]
        loaded = KMeans.load(path)
        again = loaded.predict(rows)
    want = _FORMAT_MODES.get(km.distance_mode, km.distance_mode)
    check(saved_mode == want, f"the file names distance_mode={saved_mode!r}")
    check(loaded.distance_mode == km.distance_mode,
          f"loaded back as {loaded.distance_mode!r}")
    check(loaded.device.type == "cuda", "the loaded model is not on cuda")
    check(bool((again == labels).all()), "labels differ after save and load")
    emit("predict", mode=km._mode(), rows=PREDICT_ROWS, label_diff=n_diff,
         label_diff_in_band=n_diff - n_outside, kernel2_launches=launched,
         saved_distance_mode=saved_mode, save_load_same_labels=True,
         **fields)


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


def bounds(n, d, k, fused: bool, bf16: bool = False):
    """(bound ms, what bounds it, bytes, operations, scalar float32 bound
    ms): each input read once, each output written once.  The product's
    2nkD operations run on the tensor cores: with ``bf16`` at the bf16 rate,
    else as three TF32 products each (3xTF32, which keeps float32's
    accuracy) at the TF32 rate; the rest (h - x.c, the norms, the scatter)
    at the float32 rate outside them.  The two kinds issue side by side, so
    the operations take the longer of the two times.  The fifth field is
    the bound of a kernel that does every operation at the float32
    non-tensor rate."""
    byt = 4 * (n * d + k * d + 2 * n)              # x, c, labels, mind2
    # products, h - x.c, ||x||^2, h
    product = 2 * n * k * d
    ops = product + n * k + 2 * n * d + 2 * k * d
    if fused:
        byt += 4 * (n + k * d + k)                 # w, sums, counts
        ops += 2 * n * d + n                       # the scatter
    t_bytes = byt / PEAK_BYTES_PER_S * 1e3
    rest_ms = (ops - product) / PEAK_FP32_FLOPS * 1e3
    tensor_ms = (product / PEAK_BF16_FLOPS if bf16
                 else 3 * product / PEAK_TF32_FLOPS) * 1e3
    t_ops = max(tensor_ms, rest_ms)
    by = "operations" if t_ops >= t_bytes else "bytes"
    scalar_ms = max(t_bytes, ops / PEAK_FP32_FLOPS * 1e3)
    return max(t_bytes, t_ops), by, byt, ops, scalar_ms


def library_assign(x, c, block=65536):
    """The yardstick: torch.cdist + argmin over blocks of rows."""
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for lo in range(0, x.shape[0], block):
        out[lo:lo + block] = torch.cdist(x[lo:lo + block], c).argmin(dim=1)
    return out


def library_fused(x, w, c, assign=library_assign):
    labels = assign(x, c)
    sums = torch.zeros_like(c).index_add_(0, labels, w[:, None] * x)
    counts = torch.zeros(c.shape[0], device=x.device).index_add_(0, labels, w)
    return labels, sums, counts


def library_assign_bf16(x, c, block=65536):
    """The bf16 yardstick: a bf16 torch.matmul (cuBLAS, tensor cores) over
    blocks of rows, then h - score and argmin."""
    cb = c.to(torch.bfloat16).T
    h = 0.5 * (c * c).sum(1)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for lo in range(0, x.shape[0], block):
        score = (x[lo:lo + block].to(torch.bfloat16) @ cb).float()
        out[lo:lo + block] = (h - score).argmin(dim=1)
    return out


def phase_timing(x, c, errs, launches, iter_seconds):
    n, d = x.shape
    k = c.shape[0]
    w = torch.ones(n, device=DEV)
    rows = []
    f32_src = "kmeans_tpu_torch/csrc/assign_kernels.cu"
    bf16_src = "kmeans_tpu_torch/csrc/assign_bf16.cu"
    specs = [
        ("fused_assign_reduce", True, False, f32_src,
         "kmeans_tpu/ops/pallas_kernels.py:558",
         lambda: hk.fused_assign_reduce(x, w, c),
         lambda: hk.fused_assign_reduce_reference(x, w, c),
         lambda: library_fused(x, w, c)),
        ("hopper_assign", False, False, f32_src,
         "kmeans_tpu/ops/pallas_kernels.py:542",
         lambda: hk.hopper_assign(x, c),
         lambda: hk.assign_reference(x, c),
         lambda: library_assign(x, c)),
        ("fused_assign_reduce_bf16", True, True, bf16_src,
         "kmeans_tpu/ops/pallas_kernels.py:558 (bf16=True, :494)",
         lambda: hk.fused_assign_reduce(x, w, c, bf16=True),
         lambda: hk.fused_assign_reduce_reference(x, w, c, bf16=True),
         lambda: library_fused(x, w, c, library_assign_bf16)),
        ("hopper_assign_bf16", False, True, bf16_src,
         "kmeans_tpu/ops/pallas_kernels.py:542 (bf16=True, :494)",
         lambda: hk.hopper_assign(x, c, bf16=True),
         lambda: hk.assign_reference(x, c, bf16=True),
         lambda: library_assign_bf16(x, c)),
    ]
    for name, fused, bf16, source, replaces, kernel, plain, library in specs:
        bound_ms, by, byt, ops, scalar_ms = bounds(n, d, k, fused, bf16)
        before = clocks()
        ms = median_ms(kernel)
        after = clocks()
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms,
            "plain_ms": median_ms(plain), "bound_ms": bound_ms,
            "bound_by": by, "library_ms": median_ms(library)})
        emit("timing", kernel=name, n=n, d=d, k=k, kernel_ms=ms,
             plain_ms=rows[-1]["plain_ms"],
             library_ms=rows[-1]["library_ms"], bound_ms=bound_ms,
             bound_by=by, bytes=byt, operations=ops,
             tensor_core_rate="bf16" if bf16 else "3xTF32",
             scalar_float32_bound_ms=scalar_ms,
             roofline_share=bound_ms / ms,
             clocks_power_temperature=[before, after])
    # The scatter's share of the fused kernel: the fused pass less the
    # assignment-only pass on the same inputs.
    by_name = {row["name"]: row["ms"] for row in rows}
    for suffix in ("", "_bf16"):
        fused_ms = by_name["fused_assign_reduce" + suffix]
        scatter_ms = fused_ms - by_name["hopper_assign" + suffix]
        emit("scatter_share", kernel="fused_assign_reduce" + suffix,
             fused_ms=fused_ms, scatter_ms=scatter_ms,
             share=scatter_ms / fused_ms)
    # The whole step on the device (the fused kernel, the algebraic SSE's
    # sum of w ||x||^2, per-cluster SSE and farthest point), beside the
    # host's wall time for one iteration of the fit.
    for mode, label in (("kernel", "main"), ("kernel_bf16", "main_bf16")):
        step = dist.make_step_fn(chunk_size=n, mode=mode)
        emit("timing", what=f"one Lloyd iteration of the {label} fit",
             step_ms=median_ms(lambda: step(x, w, c)),
             weighted_sqnorm_ms=median_ms(
                 lambda: dist._weighted_sqnorm_total(x, w)),
             seconds_per_iteration=iter_seconds[label], n=n, d=d, k=k)
    return rows


def phase_lab(x, c, kernel_rows):
    """The variant lab at the main shape: each variant held against the
    plain version on a weighted slice and on the whole of the inputs it is
    timed on, then timed per Lloyd iteration (marginal method) with each
    variant's own launch count.  Returns the kernel table's rows of the two
    default variants (plain, bound and library times are those of the
    kernel rows of this run: the same function on the same inputs)."""
    variants = [lab.parse_spec(spec) for spec in LAB_SPECS]
    checks = {v.name: lab.check_variant(v, x, c) for v in variants}
    for v in variants:
        check(checks[v.name]["ok"], f"lab: variant {v.name} failed its "
                                    f"check: {checks[v.name]}")
    hk.reset_launch_counts()           # this path's own counts
    records = [lab.measure(v, x, c, LAB_ITERS, checked=checks[v.name])
               for v in variants]
    launches = check_path_launches("lab")
    for v, rec in zip(variants, records):
        rec["launches"] = launches[v.counter]
        print(lab.line(rec), flush=True)
    by_name = {row["name"]: row for row in kernel_rows}
    compare = {}
    rows = []
    for rec in records:
        if rec["name"] not in ("f32_default", "bf16_default"):
            continue
        kernel = by_name["fused_assign_reduce_bf16" if rec["bf16"]
                         else "fused_assign_reduce"]
        compare[rec["name"]] = {"lab_ms_per_iter": rec["ms_per_iter"],
                                "kernel_row_ms": kernel["ms"],
                                "ratio": rec["ms_per_iter"] / kernel["ms"]}
        errs = [part[key] for part in (rec["check"]["slice"],
                                       rec["check"]["timed_inputs"])
                for key in ("mind2_err", "sums_err", "counts_err")]
        rows.append({
            "name": f"exp_pallas_kernel:{rec['name']}", "route": "cuda",
            "source": "kmeans_tpu_torch/experiments/exp_pallas_kernel.py",
            "replaces": "experiments/exp_pallas_kernel.py:44",
            "launches": rec["launches"], "max_abs_err": max(errs),
            "ms": rec["ms_per_iter"], "plain_ms": kernel["plain_ms"],
            "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
            "library_ms": kernel["library_ms"]})
    emit("lab", iters=LAB_ITERS, variants=records,
         defaults_against_kernel_rows=compare)
    return rows


def library_estep(x, w, shift, means_c, inv_var, log_det, log_w,
                  chunk=EM_MAX_CHUNK):
    """The yardstick: the E-step as cuBLAS and torch calls over chunks of
    EM_MAX_CHUNK rows (TF32 off): addmm for logp, logsumexp and softmax,
    one product r^T [x_c, x_c^2]."""
    coef, c1 = ek.estep_coefficients(means_c, inv_var, log_det, log_w)
    k, d = means_c.shape
    rsum = torch.zeros(k, device=DEV)
    mom = torch.zeros((k, 2 * d), device=DEV)
    ll = torch.zeros((), device=DEV)
    for lo in range(0, x.shape[0], chunk):
        xc = x[lo:lo + chunk] - shift
        f = torch.cat([xc, xc * xc], dim=1)
        logp = torch.addmm(c1, f, coef.T)
        wc = w[lo:lo + chunk]
        r = torch.softmax(logp, dim=1) * wc[:, None]
        rsum += r.sum(0)
        mom += r.T @ f
        ll += (wc * torch.logsumexp(logp, dim=1)).sum()
    return rsum, mom[:, :d], mom[:, d:], ll


def estep_bounds(n, d, k):
    """(bound ms, what bounds it, bytes, operations, scalar float32 bound
    ms) of diag_estep: each input read once, each output written once; the
    operations are the two depth-2D products (8 n k D) on the tensor cores,
    as three TF32 products each (3xTF32, which keeps float32's accuracy) at
    the TF32 rate, and the softmax (max, subtract, exp, scale, sum: 5 n k)
    and the centering and squares (2 n D) at the float32 rate outside them;
    the two kinds issue side by side, so the longer counts.  The fifth
    field puts every operation at the float32 non-tensor rate."""
    byt = 4 * (n * d + n + d + 2 * k * d + 2 * k) + 4 * (k * (2 * d + 1) + 1)
    product = 8 * n * k * d
    ops = product + 5 * n * k + 2 * n * d
    t_bytes = byt / PEAK_BYTES_PER_S * 1e3
    tensor_ms = 3 * product / PEAK_TF32_FLOPS * 1e3
    rest_ms = (ops - product) / PEAK_FP32_FLOPS * 1e3
    t_ops = max(tensor_ms, rest_ms)
    scalar_ms = max(t_bytes, ops / PEAK_FP32_FLOPS * 1e3)
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                 else "bytes"), byt, ops, scalar_ms


def host_ms(fn, runs=5) -> float:
    """Median host wall time of a call that ends on the host."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_gmm_timing(x, tables, gm, err, launches):
    n, d = x.shape
    k = tables[1].shape[0]
    w = torch.ones(n, device=DEV)
    args = (x, w, *tables)
    bound_ms, by, byt, ops, scalar_ms = estep_bounds(n, d, k)
    ms = median_ms(lambda: ek.diag_estep(*args))
    plain = median_ms(lambda: ek.diag_estep_reference(*args))
    library = median_ms(lambda: library_estep(*args))
    row = {"name": "diag_estep", "route": "cuda",
           "source": "kmeans_tpu_torch/csrc/gmm_estep.cu",
           "replaces": "experiments/exp_gmm_estep_pallas.py:139",
           "launches": launches["diag_estep"], "max_abs_err": err,
           "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
           "bound_by": by, "library_ms": library}
    emit("timing", kernel="diag_estep", n=n, d=d, k=k, kernel_ms=ms,
         plain_ms=plain, library_ms=library, bound_ms=bound_ms, bound_by=by,
         bytes=byt, operations=ops, tensor_core_rate="3xTF32",
         scalar_float32_bound_ms=scalar_ms, roofline_share=bound_ms / ms)
    # One EM iteration of the fit, in its parts: the tables' upload, the
    # E-step on the device, the statistics' download and the float64
    # M-step on the host.
    ds = gm._dataset(x)
    step = lambda: ek.diag_estep(ds.points, ds.weights,  # noqa: E731
                                 *gm._params_dev())
    st = step()
    on_host = gm._host(st)
    emit("timing", what="one EM iteration of the mixture fit",
         seconds_per_iteration=statistics.median(gm.iter_times_),
         estep_ms=median_ms(step),
         tables_upload_ms=host_ms(lambda: gm._params_dev()),
         stats_download_ms=host_ms(lambda: gm._host(st)),
         m_step_ms=host_ms(lambda: gm._m_step(on_host)),
         n=n, d=d, k=k)
    return row


def main() -> None:
    global CARD
    started = time.perf_counter()
    CARD = card_line()
    # Full float32 products in every torch matmul of the run (the default,
    # stated): the plain versions and yardsticks must not use TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("env", device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    # Every source of the main path and the lab's variants: one nvcc each,
    # all started together.
    t0 = time.perf_counter()
    lab_variants = [lab.parse_spec(spec) for spec in LAB_SPECS]
    _build.build_variants(
        [(name, {}) for name in _build.source_names()]
        + [(v.source, v.defines) for v in lab_variants])
    emit("build", sources=_build.source_names(),
         variants=[v.library_path().name for v in lab_variants],
         seconds=time.perf_counter() - t0)
    libraries = {name: _build.library_path(name)
                 for name in _build.source_names()}
    libraries.update({f"lab:{v.name}": v.library_path()
                      for v in lab_variants})
    emit("registers", **{name: resource_usage(path)
                         for name, path in libraries.items()})
    # Every kernel class runs its products on the tensor cores (K-Means in
    # bf16, K-Means float32 and the mixture's E-step in 3xTF32): their
    # machine code holds HMMA instructions.
    hmma = {}
    for lib_name in (*hk.LIB_NAMES.values(), ek.LIB_NAME):
        sass = subprocess.run(
            [str(Path(_build.find_nvcc()).parent / "cuobjdump"), "-sass",
             str(_build.library_path(lib_name))], capture_output=True,
            text=True, check=True).stdout
        hmma[lib_name] = sum("HMMA" in line for line in sass.splitlines())
        check(hmma[lib_name] > 0,
              f"the {lib_name} library holds no HMMA instruction")
    emit("sass", hmma_instructions=hmma)

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
    second = (x2, w2, x2[pick2].contiguous())
    errs = {}
    for bf16 in (False, True):
        records = phase_kernels(x_main, c_main, second, bf16)
        main_rec = next(r for r in records if r["case"] == "main_shape")
        suffix = "_bf16" if bf16 else ""
        errs["fused_assign_reduce" + suffix] = max(
            main_rec["sums_err"], main_rec["mind2_err"],
            main_rec["counts_err"])
        errs["hopper_assign" + suffix] = main_rec["assign_mind2_err"]
    del w2, second

    # Each path: counters to 0 just before it, read just after it, and only
    # the kernels that this path must launch are checked.
    km = fit_shape(x_main, MAIN, "main")
    phase_predict(km, x_main)
    launches = check_path_launches("main")

    km_bf16 = fit_shape(x_main, MAIN, "main_bf16", "pallas_bf16")
    phase_predict(km_bf16, x_main)
    launches.update({name: count for name, count in
                     check_path_launches("main_bf16").items()
                     if name.endswith("_bf16")})
    ratio = km_bf16.sse_history[-1] / km.sse_history[-1]
    emit("sse_bf16_against_f32", main_bf16=km_bf16.sse_history[-1],
         main=km.sse_history[-1], ratio=ratio)
    check(abs(ratio - 1.0) <= BF16_SSE_RATIO,
          f"main_bf16: final SSE {ratio} times the float32 path's")

    fit_shape(x2, SECOND, "glove_like")
    check_path_launches("glove_like")
    del x2

    # The mixture: its kernel against the plain version, then its path.
    # The data (blobs about 1e3 from the origin) and the tables of a mixture
    # with means at random rows are those the E-step ablations time.
    x_gmm, gmm_tables = kernel_edits.estep_inputs(GMM["n"], GMM["d"],
                                                  GMM["k"], DEV)
    estep_records = phase_estep_kernel(x_gmm, gmm_tables)
    gmm_main = estep_records[0]
    gm, gmm_launches = phase_gmm(x_gmm)
    phase_gmm_offset()

    rows = phase_timing(x_main, c_main, errs, launches,
                        {"main": statistics.median(km.iter_times_),
                         "main_bf16": statistics.median(km_bf16.iter_times_)})
    rows.append(phase_gmm_timing(
        x_gmm, gmm_tables, gm,
        max(gmm_main[f"{s}_err"] for s in ("rsum", "s1", "s2", "ll")),
        gmm_launches))
    rows += phase_lab(x_main, c_main, rows)

    emit("total", seconds=time.perf_counter() - started)
    print(json.dumps({"kernels": rows}), flush=True)
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
