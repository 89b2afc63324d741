"""The E-step split over the blocks of a model axis, against the E-step of
the whole table.

``diag_estep_rows_reference`` (launch (a): each row's max and sum over a
block of components) and ``diag_estep_moments_reference`` (launch (b): the
block's moments from the rows' global max and sum) are the plain versions
that the kernel's ``ROWS`` and ``MOMENTS`` instances are held to on the
card.  Here the table is padded to a multiple of the blocks with the
reference's inert components (zero mean, unit variance, log-weight -inf),
cut into blocks, each block's pair combined as the model axis combines it
(the MAX, then the SUM of ``combine_terms``), and the blocks' moments
concatenated: the result is ``diag_estep_reference`` of the whole table.

Cases: random tables, the hard-init tables (``inv_var = 1e6``: logp terms
of order 1e8 that cancel), rows of weight 0 (a tenth of every case), and a
block of only pads (k = 3 in four blocks: its max is -inf, its sum 0, and
nothing it adds is a NaN).  Tolerances: float64 to ``rtol=1e-12`` (the
split sums the same terms in another order); float32 the E-step class of
``ops.compare``; the hard tables on the rows outside the float32 tie band
(``test_torch_gmm_step.clear_of_ties``).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu_torch.ops import compare as cmp  # noqa: E402
from kmeans_tpu_torch.ops import estep_kernels as ek  # noqa: E402
from kmeans_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from test_torch_gmm_step import clear_of_ties, make_case  # noqa: E402

#: (k, blocks): two even blocks, an odd k on two blocks (one pad), and
#: k = 3 on four blocks (the last block holds only a pad).
SPLITS = [(6, 2), (5, 2), (3, 2), (3, 4)]


def _pad(table, k_pad, fill):
    out = np.full((k_pad,) + table.shape[1:], fill, table.dtype)
    out[:table.shape[0]] = table
    return out


def _split(args, blocks, plain=True):
    """The whole table's E-step by the two launches over ``blocks`` blocks
    of the padded table: ``(rsum, s1, s2, ll)`` of the real components,
    every block's ``ll`` (all the same), and the blocks' row pairs."""
    X, w, shift, mc, iv, ld, lw = (torch.from_numpy(a) for a in args)
    k = mc.shape[0]
    k_pad = -(-k // blocks) * blocks
    kl = k_pad // blocks
    tables = [torch.from_numpy(_pad(t.numpy(), k_pad, f))
              for t, f in ((mc, 0.0), (iv, 1.0), (ld, 0.0),
                           (lw, -np.inf))]
    rows = ek.diag_estep_rows_reference if plain else ek.diag_estep_rows
    moments = ek.diag_estep_moments_reference if plain \
        else ek.diag_estep_moments

    def block(i):
        return [t[i * kl:(i + 1) * kl].contiguous() for t in tables]

    pairs = [rows(X, w, shift, *block(i)) for i in range(blocks)]
    big_m = torch.stack([m for m, _ in pairs]).max(dim=0).values
    big_s = sum(ek.combine_terms(m, s, big_m) for m, s in pairs)
    outs = [moments(X, w, shift, *block(i), big_m, big_s)
            for i in range(blocks)]
    joined = [torch.cat([o[f] for o in outs])[:k] for f in range(3)]
    return joined + [outs[0][3]], [o[3] for o in outs], pairs


@pytest.mark.parametrize("hard", [False, True], ids=["random", "hard"])
@pytest.mark.parametrize("k,blocks", SPLITS)
def test_split_equals_the_whole_table_float64(k, blocks, hard):
    args = make_case(403, 7, k, seed=11 * k + blocks, hard=hard)
    want = ek.diag_estep_reference(*(torch.from_numpy(a) for a in args))
    got, lls, pairs = _split(args, blocks)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()))
    for ll in lls:
        np.testing.assert_allclose(float(ll), float(want[3]), rtol=1e-12)
    for m, s in pairs:
        assert not torch.isnan(m).any() and not torch.isnan(s).any()
        # A block without a finite logp reports m = -inf and s = 0.
        assert torch.equal(torch.isinf(m), s == 0)
    if (k, blocks) == (3, 4):
        m, s = pairs[3]
        assert bool(torch.isneginf(m).all()) and bool((s == 0).all())


@pytest.mark.parametrize("hard", [False, True], ids=["random", "hard"])
@pytest.mark.parametrize("k,blocks", SPLITS)
def test_split_equals_the_whole_table_float32(k, blocks, hard):
    args = make_case(1037, 33, k, seed=7 * k + blocks, hard=hard,
                     dtype=np.float32)
    if hard:
        X, w, shift, mc = args[:4]
        w = np.where(clear_of_ties(X, shift, mc), w, 0).astype(np.float32)
        args = (X, w) + args[2:]
    want = ek.diag_estep_reference(*(torch.from_numpy(a) for a in args))
    got, lls, _ = _split(args, blocks)
    errs = cmp.estep_errors(got, want)
    assert errs["ok"], errs
    assert len({float(ll) for ll in lls}) == 1


def test_rows_of_weight_zero_add_nothing():
    """A row of weight 0 adds nothing to the block's moments or ll, not
    even a NaN: its coordinates are Inf here."""
    X, w, shift, mc, iv, ld, lw = make_case(200, 5, 4, seed=3)
    X = X.copy()
    X[w == 0] = np.inf
    args = (X, w, shift, mc, iv, ld, lw)
    got, _, _ = _split(args, 2)
    live = w > 0
    want = ek.diag_estep_reference(*(torch.from_numpy(a) for a in (
        X[live], w[live], shift, mc, iv, ld, lw)))
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()))


def test_the_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers are their plain versions (float32 only,
    as the kernel), launch nothing, and refuse what the kernel does not
    take."""
    args = make_case(300, 9, 5, seed=5, dtype=np.float32)
    hk.reset_launch_counts()
    got, _, pairs = _split(args, 2, plain=False)
    want, _, pairs_ref = _split(args, 2, plain=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for (m, s), (mr, sr) in zip(pairs, pairs_ref):
        assert torch.equal(m, mr) and torch.equal(s, sr)
    assert hk.LAUNCHES.get("diag_estep_rows", 0) == 0
    assert hk.LAUNCHES.get("diag_estep_moments", 0) == 0
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(TypeError):
        ek.diag_estep_rows(t[0].double(), *t[1:])
    m, s = ek.diag_estep_rows(*t)
    with pytest.raises(ValueError, match="row_max"):
        ek.diag_estep_moments(*t, m[:10], s)
    with pytest.raises(ValueError, match="row_sum"):
        ek.diag_estep_moments(*t, m, s.double())


def test_declared_operations_of_the_two_launches():
    """Launch (a) does the logp product once (4 n k D), launch (b) the logp
    product again and the moment product (8 n k D): the split does 12 n k D
    against the whole E-step's 8 n k D."""
    n, d, k = 1000, 128, 128
    rows = hk.declared_operations("estep_rows", n, d, k)
    moments = hk.declared_operations("estep_moments", n, d, k)
    assert rows[0] == 4 * n * k * d and moments[0] == 8 * n * k * d
    assert rows[1] == rows[0] + 4 * n * k + 2 * n * d
    assert moments[1] == moments[0] + 4 * n * k + 2 * n * d
    assert hk.declared_operations("estep", n, d, k)[0] == 8 * n * k * d
