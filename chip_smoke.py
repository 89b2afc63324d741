#!/usr/bin/env python3
"""Smoke run of kmeans_tpu_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card, and drives three paths:
``KMeans.fit`` then ``predict``, ``save`` and ``load`` at n = 2,097,152,
D = 128, k = 1024 in float32; ``KMeans.fit`` at a ragged GloVe-like shape;
and ``GaussianMixture.fit`` (k = 256, 'diag', internal KMeans init) then
``predict``, ``predict_proba``, ``score_samples``, ``save`` and ``load`` at
n = 2,097,152, D = 128, on blobs about 1e3 from the origin.  The launch
counters show that each path went through its own kernels.  Each kernel is
timed beside its plain version, a library yardstick and its roofline
bound.

Every phase prints one JSON line as it ends.  A phase that fails raises, so
the run ends with a non-zero code and without the result line.  The last line
is ``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit; the line before that is the table of kernels.

Needs one CUDA device and ``nvcc``; there is no CPU mode.
"""

from __future__ import annotations

import json
import math
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
from kmeans_tpu_torch.ops import _build  # noqa: E402
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
# origin so that centering and moment precision are exercised.
GMM = dict(n=2_097_152, d=128, k=256, iters=5, center_box=(990.0, 1010.0))

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
# diag_estep against diag_estep_reference (both float32 on the card):
#   rsum, s1, s2  |a - b| <= 1e-5 max|b| + 1e-4 |b|  (centered sums cancel
#                 to near zero, hence the share of the largest entry)
#   ll            |a - b| <= 1e-5 |b|
#   and two runs of the kernel give the same bits.
# The hard-init tables (inv_var = 1e6) are held on the rows outside the tie
# band: x_c^2 a and 2 x_c b are of order 1e8 and cancel, so a row whose two
# nearest means' float64 squared distances differ by less than
# MARGIN_RTOL * (||x_c||^2 + max ||mu_c||^2) may go to either mean.
ESTEP_RTOL, ESTEP_ATOL_SHARE, LL_RTOL = 1e-4, 1e-5, 1e-5


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
    rec = {"case": name, "n": x.shape[0], "d": x.shape[1],
           "k": means_c.shape[0]}
    for label, a, b in zip(("rsum", "s1", "s2"), out[:3], ref[:3]):
        check(bool(torch.isfinite(a).all()), f"{name}: {label} not finite")
        atol = ESTEP_ATOL_SHARE * float(b.abs().max())
        check(close(a, b, ESTEP_RTOL, atol), f"{name}: {label} disagrees "
                                             f"(max error {max_err(a, b)})")
        rec[f"{label}_err"] = max_err(a, b)
    check(close(out[3], ref[3], LL_RTOL, 0.0),
          f"{name}: ll {float(out[3])} against {float(ref[3])}")
    rec["ll_err"] = max_err(out[3], ref[3])
    rec["ll"] = float(out[3])
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
    ]
    for i, (name, kw) in enumerate(cases):
        records.append(estep_case(name, *gmm_case(seed=300 + i, **kw)))
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
    "glove_like": ("fused_assign_reduce", "hopper_assign"),
    "gmm": ("diag_estep", "fused_assign_reduce"),
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
    """(bound ms, what bounds it, bytes, operations) of diag_estep: each
    input read once, each output written once; the operations are the two
    depth-2D products (8 n k D), the softmax (max, subtract, exp, scale,
    sum: 5 n k) and the centering and squares (2 n D)."""
    byt = 4 * (n * d + n + d + 2 * k * d + 2 * k) + 4 * (k * (2 * d + 1) + 1)
    ops = 8 * n * k * d + 5 * n * k + 2 * n * d
    t_bytes = byt / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                 else "bytes"), byt, ops


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
    bound_ms, by, byt, ops = estep_bounds(n, d, k)
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
         bytes=byt, operations=ops, roofline_share=bound_ms / ms)
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

    # Each path: counters to 0 just before it, read just after it, and only
    # the kernels that this path must launch are checked.
    km = fit_shape(x_main, MAIN, "main")
    phase_predict(km, x_main)
    launches = check_path_launches("main")

    fit_shape(x2, SECOND, "glove_like")
    check_path_launches("glove_like")
    del x2

    # The mixture: its kernel against the plain version, then its path.
    x_gmm, _ = make_blobs_device(GMM["n"], GMM["k"], GMM["d"], device=DEV,
                                 seed=21, center_box=GMM["center_box"])
    gen = torch.Generator(device=DEV).manual_seed(22)
    pick = torch.randperm(GMM["n"], generator=gen, device=DEV)[:GMM["k"]]
    shift = weighted_mean(x_gmm, torch.ones(GMM["n"], device=DEV))
    means_c = (x_gmm[pick] - shift).contiguous()
    var = torch.rand((GMM["k"], GMM["d"]), generator=gen, device=DEV) + 0.5
    log_w = torch.full((GMM["k"],), -math.log(GMM["k"]), device=DEV)
    gmm_tables = (shift.contiguous(), means_c,
                  *estep_tables(means_c, var, log_w))
    estep_records = phase_estep_kernel(x_gmm, gmm_tables)
    gmm_main = estep_records[0]
    gm, gmm_launches = phase_gmm(x_gmm)
    phase_gmm_offset()

    rows = phase_timing(x_main, c_main, errs, launches,
                        statistics.median(km.iter_times_))
    rows.append(phase_gmm_timing(
        x_gmm, gmm_tables, gm,
        max(gmm_main[f"{s}_err"] for s in ("rsum", "s1", "s2", "ll")),
        gmm_launches))

    emit("total", seconds=time.perf_counter() - started)
    print(json.dumps({"kernels": rows}), flush=True)
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
