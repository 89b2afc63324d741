"""The numerical design of the card's E-step kernel, emulated on the CPU.

``kmeans_tpu_torch/csrc/gmm_estep.cu`` (behind ``ops.estep_kernels.
diag_estep``) runs both of its products on the tensor cores as three TF32
products each (3xTF32).  A CUDA kernel cannot run here, so this file
emulates its arithmetic in torch, step by step, and holds the result to the
float64 plain version ``diag_estep_reference`` with the tolerances that
``chip_smoke.py`` holds the kernel to on the card (``ESTEP_RTOL = 1e-4``,
``ESTEP_ATOL_SHARE = 1e-5`` of the largest entry, ``LL_RTOL = 1e-5``):

* ``cvt.rna.tf32``: round to nearest, ties away from zero, keeping 10
  mantissa bits;
* ``F = [x_c, 0 ..., x_c^2, 0 ...]``, each half D rounded up to 8, and the
  coefficients alike;
* the split ``v = hi + lo``, ``hi = tf32(v)``, ``lo = tf32(v - hi)`` (no Inf
  guard: the kernel zeroes rows of weight 0 before it splits);
* per 8-deep group, three products (lo.hi, hi.lo, hi.hi), each ``mma``
  adding its 8 exact products into a float32 part that starts from zero,
  and the part joining the running float32 sum by a rounding add.  The
  tensor cores truncate inside an ``mma`` where this emulation rounds;
* logp over tiles of 256 components, an online max and sum per row, and
  ``r = exp(logp - m) * (w / s)``;
* the moments per tile of 128 rows (groups of 8 rows), each tile's sums
  added into the table of its block (tiles dealt to blocks in turn), the
  tables added in block order.

The inputs are ``chip_smoke.py``'s cases ``hard_init_tables``,
``offset_clusters`` and ``far_clusters`` at small n, made with
``np.random.default_rng``.  Nothing here is part of the package.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu_torch.ops import estep_kernels as ek  # noqa: E402

ESTEP_RTOL, ESTEP_ATOL_SHARE, LL_RTOL = 1e-4, 1e-5, 1e-5
MARGIN_RTOL = 1e-4               # the tie band of the hard-init tables
TC, BM, BLOCKS = 256, 128, 3     # component tile, row tile, blocks


def tf32(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of finite float32 values."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign = bits & 0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0xFFFFE000
    out = sign | mag
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32(v)
    return hi, tf32(v - hi)


def group_products(a, b, one_product=False):
    """float32 part of each 8-deep group: a (..., G, 8, M) and
    b (..., G, 8, N) -> (..., G, M, N), three mma from zero (small terms
    first), or one TF32 product (hi.hi) where ``one_product``."""
    (ah, al), (bh, bl) = split(a), split(b)

    def mma(x, y):                 # 8 exact products, summed in float64
        return torch.einsum("...gkm,...gkn->...gmn", x.double(), y.double())

    if one_product:
        return mma(ah, bh).float()
    part = mma(al, bh).float()
    part = (part.double() + mma(ah, bl)).float()
    return (part.double() + mma(ah, bh)).float()


def running_sum(parts, dim):
    """The parts along ``dim`` added one after another in float32."""
    acc = torch.zeros_like(parts.select(dim, 0))
    for i in range(parts.shape[dim]):
        acc = acc + parts.select(dim, i)
    return acc


def emulate_estep(x, w, shift, means_c, inv_var, log_det, log_w,
                  one_product=False):
    """The kernel's arithmetic on float32 tensors: (rsum, s1, s2, ll)."""
    n, d = x.shape
    k = means_c.shape[0]
    dx = -(-d // 8) * 8            # F = [x_c, 0 ..., x_c^2, 0 ...]
    live = w > 0
    xc = torch.where(live[:, None], x - shift, torch.zeros(()))
    f = torch.zeros((n, 2 * dx))
    f[:, :d], f[:, dx:dx + d] = xc, xc * xc
    coef, c1 = ek.estep_coefficients(means_c, inv_var, log_det, log_w)
    cf = torch.zeros((k, 2 * dx))
    cf[:, :d], cf[:, dx:dx + d] = coef[:, :d], coef[:, d:]
    fp = 2 * dx
    # logp: rows x components, depth fp in groups of 8.
    parts = group_products(f.T.reshape(fp // 8, 8, n),
                           cf.T.reshape(fp // 8, 8, k), one_product)
    logp = running_sum(parts, 0) + c1
    # Online max and sum over tiles of TC components.
    m = torch.full((n,), -float("inf"))
    s = torch.zeros(n)
    for c0 in range(0, k, TC):
        tile = logp[:, c0:c0 + TC]
        mn = torch.maximum(m, tile.max(1).values)
        s = s * torch.exp(m - mn) + torch.exp(tile - mn[:, None]).sum(1)
        m = mn
    scale = torch.where(live, w / s, torch.zeros(()))
    r = torch.exp(logp - m[:, None]) * scale[:, None]
    ll = torch.where(live, w.double() * (m + torch.log(s)).double(),
                     torch.zeros((), dtype=torch.float64)).sum()
    # Moments: tiles of BM rows, groups of 8 rows, then blocks.
    tiles = -(-n // BM)
    rp = torch.zeros((tiles * BM, k))
    fpd = torch.zeros((tiles * BM, fp))
    rp[:n], fpd[:n] = r, f
    parts = group_products(rp.reshape(tiles, BM // 8, 8, k),
                           fpd.reshape(tiles, BM // 8, 8, fp), one_product)
    per_tile = running_sum(parts, 1)                     # (tiles, k, fp)
    rs_tile = running_sum(rp.reshape(tiles, BM, k), 1)   # (tiles, k)
    tables = [running_sum(per_tile[b::BLOCKS], 0) for b in range(BLOCKS)]
    rsums = [running_sum(rs_tile[b::BLOCKS], 0) for b in range(BLOCKS)]
    mom = running_sum(torch.stack(tables), 0)
    rsum = running_sum(torch.stack(rsums), 0)
    return rsum, mom[:, :d], mom[:, dx:dx + d], ll.float()


def clear_of_ties(x, shift, means_c):
    xc = x.astype(np.float64) - shift
    mc = means_c.astype(np.float64)
    d2 = ((xc[:, None, :] - mc[None, :, :]) ** 2).sum(-1)
    two = np.partition(d2, 1, axis=1)
    scale = (xc * xc).sum(1) + (mc * mc).sum(1).max()
    return (two[:, 1] - two[:, 0]) > MARGIN_RTOL * scale


def gmm_case(n, d, k, seed, spread=3.0, offset=0.0, hard=False):
    """chip_smoke.py's gmm_case with numpy: blobs, weights (a tenth 0), their
    weighted mean, and the tables of a mixture near them (or the hard-init
    tables, with the rows in the tie band at weight 0)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * spread + offset
    x = centers[rng.integers(0, k, size=n)] + rng.normal(size=(n, d))
    x = x.astype(np.float32)
    w = (rng.uniform(size=n) + 0.5).astype(np.float32)
    w[::10] = 0.0
    shift = ((w.astype(np.float64) @ x) / w.sum()).astype(np.float32)
    if hard:
        means_c = (centers - shift).astype(np.float32)
        tables = (np.full((k, d), 1e6), np.zeros(k), np.zeros(k))
        w = np.where(clear_of_ties(x, shift, means_c), w, 0)
    else:
        means_c = (centers - shift
                   + 0.3 * rng.normal(size=(k, d))).astype(np.float32)
        var = rng.uniform(size=(k, d)) + 0.5
        logit = rng.normal(size=k)
        log_w = logit - np.log(np.exp(logit).sum())
        tables = (1.0 / var, np.log(var).sum(1), log_w)
    arrays = (x, w, shift, means_c, *tables)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 for a in arrays)


CASES = {
    "hard_init_tables": dict(n=2048, d=64, k=32, hard=True),
    "offset_clusters": dict(n=2048, d=64, k=32, spread=5.0, offset=1e3),
    "far_clusters": dict(n=2048, d=64, k=32, spread=100.0),
}


def _within(got, ref):
    """chip_smoke.py's E-step tolerances; returns the worst share of the
    allowed error over the four outputs."""
    worst = 0.0
    for a, b in zip(got[:3], ref[:3]):
        a, b = a.double(), b.double()
        allowed = ESTEP_ATOL_SHARE * float(b.abs().max()) \
            + ESTEP_RTOL * b.abs()
        worst = max(worst, float(((a - b).abs() / allowed).max()))
    return max(worst, abs(float(got[3]) - float(ref[3]))
               / (LL_RTOL * abs(float(ref[3]))))


@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_design_within_the_card_tolerances(name):
    args = gmm_case(seed=300 + sorted(CASES).index(name), **CASES[name])
    ref = ek.diag_estep_reference(*(a.double() for a in args))
    got = emulate_estep(*args)
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert _within(got, ref) <= 1.0


def test_one_tf32_product_is_not_enough_for_the_hard_init_tables():
    args = gmm_case(seed=300, **CASES["hard_init_tables"])
    ref = ek.diag_estep_reference(*(a.double() for a in args))
    assert _within(emulate_estep(*args), ref) <= 1.0
    assert _within(emulate_estep(*args, one_product=True), ref) > 1.0


def _variances(rsum, s1, s2):
    r = rsum.double()[:, None]
    return s2.double() / r - (s1.double() / r) ** 2


def test_far_clusters_variances_within_four_times_float32():
    """Where S2/R - (S1/R)^2 cancels: the emulated kernel's variances stay
    within 4 times the error of the float32 plain version itself, both
    against the float64 plain version (chip_smoke.py's rule)."""
    args = gmm_case(seed=302, **CASES["far_clusters"])
    want = _variances(*ek.diag_estep_reference(*(a.double()
                                                  for a in args))[:3])
    plain = _variances(*ek.diag_estep_reference(*args)[:3])
    got = _variances(*emulate_estep(*args)[:3])
    plain_err = float((plain - want).abs().max())
    assert plain_err > 0
    assert float((got - want).abs().max()) <= 4 * plain_err


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    one = 1.0 + 2.0 ** -10                      # a TF32 value
    half = 2.0 ** -11                           # half its last place
    v = torch.tensor([1.0 + half, -(1.0 + half), one + half,
                      1.0 + half / 2, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one, -one, one + 2 * half, 1.0, 3.0, -0.0])
    assert torch.equal(tf32(v), want)
    hi, lo = split(torch.tensor([1.0 / 3.0]))
    assert float(hi) != 1.0 / 3.0 and abs(float(hi + lo) - 1.0 / 3.0) < 1e-7
