"""Holding a kernel against its plain version: tolerances and helpers.

One place for the comparisons that ``chip_smoke.py``, the variant lab
(``experiments/exp_pallas_kernel.py``) and the ablations
(``experiments/exp_kernel_edits.py``) make, so that none can loosen
another's check.  Kernel and plain version compute the same function in
float32 and sum in another order (for bf16: the same rounded inputs, the
tensor cores against cuBLAS's float32 product), hence:

  labels  equal outside the band MARGIN_RTOL * (||x||^2 + max ||c||^2) on
          the float64 difference of the two centroids' squared distances
          (for bf16, of the scores from the bf16-rounded inputs)
  mind2   |a - b| <= max(1e-4, 1e-6 S) + MIND2_RTOL |b|, S = max ||x||^2 +
          max ||c||^2: the expanded form cancels, so its absolute error
          grows with the norms
  sums    |a - b| <= SUMS_ATOL_SHARE max|b| + SUMS_RTOL |b|
  counts  |a - b| <= COUNTS_RTOL |b|

The mixture's E-step (``diag_estep`` against ``diag_estep_reference``, both
float32):

  rsum, s1, s2  |a - b| <= ESTEP_ATOL_SHARE max|b| + ESTEP_RTOL |b|
                (centered sums cancel to near zero, hence the share of the
                largest entry)
  ll            |a - b| <= LL_RTOL |b|
"""

from __future__ import annotations

import torch

from kmeans_tpu_torch.ops.assign import round_bf16

MARGIN_RTOL = 1e-4
MIND2_RTOL = 1e-4
SUMS_RTOL, SUMS_ATOL_SHARE = 1e-4, 1e-5
COUNTS_RTOL = 1e-5
ESTEP_RTOL, ESTEP_ATOL_SHARE, LL_RTOL = 1e-4, 1e-5, 1e-5


def label_band(x, c, la, lb, bf16: bool = False):
    """(rows whose labels differ, those of them outside the margin band).
    The band is on the float64 difference of the two centroids' squared
    distances; with ``bf16`` on that of the scores the bf16 kernels compare,
    ``2 h - 2 bf16(x) . bf16(c)``, h from the unrounded centroids."""
    diff = (la != lb).nonzero().flatten()
    if diff.numel() == 0:
        return 0, 0
    xd = x[diff].double()
    cd = c.double()
    ia, ib = la[diff].long(), lb[diff].long()
    if bf16:
        xb = round_bf16(x[diff], torch.float64)
        cb = round_bf16(c, torch.float64)
        h2 = (cd * cd).sum(1)
        da = h2[ia] - 2.0 * (xb * cb[ia]).sum(1)
        db = h2[ib] - 2.0 * (xb * cb[ib]).sum(1)
    else:
        da = ((xd - cd[ia]) ** 2).sum(1)
        db = ((xd - cd[ib]) ** 2).sum(1)
    scale = (xd * xd).sum(1) + (cd * cd).sum(1).max()
    outside = ((da - db).abs() > MARGIN_RTOL * scale) | torch.isnan(da - db)
    return int(diff.numel()), int(outside.sum())


def close(a, b, rtol, atol) -> bool:
    return bool(torch.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True))


def max_err(a, b) -> float:
    d = torch.nan_to_num(a - b, nan=0.0, posinf=0.0, neginf=0.0)
    return float(d.abs().max()) if d.numel() else 0.0


def mind2_atol(x, c) -> float:
    """The absolute part of the mind2 tolerance."""
    finite_x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    scale = float((finite_x * finite_x).sum(1).max() + (c * c).sum(1).max())
    return max(1e-4, 1e-6 * scale)


def sums_close(sums, ref_sums) -> bool:
    finite = torch.nan_to_num(ref_sums, nan=0.0, posinf=0.0, neginf=0.0)
    return close(sums, ref_sums, SUMS_RTOL,
                 SUMS_ATOL_SHARE * float(finite.abs().max()))


def scatter_reference(points, weights, labels, k: int, bf16: bool = False):
    """Sums and counts over the given labels by ``index_add_``: the plain
    scatter, for a comparison where a near-tie put a row elsewhere."""
    live = (weights != 0)[:, None]
    if bf16:
        wx = round_bf16(weights, torch.float32)[:, None] \
            * round_bf16(points, torch.float32)
    else:
        wx = weights[:, None] * points
    idx = labels.long()
    sums = torch.zeros((k, points.shape[1]), dtype=torch.float32,
                       device=points.device).index_add_(
        0, idx, torch.where(live, wx, torch.zeros_like(points)))
    counts = torch.zeros(k, dtype=torch.float32,
                         device=points.device).index_add_(0, idx, weights)
    return sums, counts


def estep_errors(out, ref) -> dict:
    """Largest error of each E-step output ``(rsum, s1, s2, ll)`` against
    the plain version's, and ``ok``: all finite and within the
    tolerances."""
    ok = all(bool(torch.isfinite(a).all()) for a in out)
    errs = {}
    for label, a, b in zip(("rsum", "s1", "s2"), out[:3], ref[:3]):
        ok = ok and close(a, b, ESTEP_RTOL,
                          ESTEP_ATOL_SHARE * float(b.abs().max()))
        errs[f"{label}_err"] = max_err(a, b)
    ok = ok and close(out[3], ref[3], LL_RTOL, 0.0)
    errs["ll_err"] = max_err(out[3], ref[3])
    return {"ok": ok, **errs}
