"""The plain versions of the Hopper kernels against the Pallas kernels.

``fused_assign_reduce_reference`` and ``assign_reference``
(kmeans_tpu_torch.ops.hopper_kernels) are the arithmetic the CUDA kernels are
held to on the card.  Here they are held to the TPU kernels they stand for,
``kmeans_tpu.ops.pallas_kernels.fused_assign_reduce`` and ``pallas_assign``,
run in interpret mode exactly as ``tests/test_pallas.py`` runs them, on the
same inputs made with ``np.random.default_rng(seed)``.

Tolerances (both sides float32, summed in another order): labels equal
wherever the float64 margin between best and second best exceeds
``1e-4 * (||x||^2 + ||c||^2)``; ``mind2`` ``rtol=1e-4, atol=1e-4``; sums
``rtol=1e-5`` (plus the same fraction of the largest sum, for entries that
cancel to near zero); counts equal for unit weights, ``rtol=1e-6`` for
fractional ones.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from conftest import pallas_x64_skip  # noqa: E402

from kmeans_tpu.ops.pallas_kernels import (  # noqa: E402
    fused_assign_reduce as pallas_fused, pallas_assign)
from kmeans_tpu_torch.ops import hopper_kernels as hk  # noqa: E402

pytestmark = pallas_x64_skip

# D below, at and above 128 (fold and no-fold on the TPU side); k = 5 and
# k = 300 (one and three 128-wide TPU k-tiles, the last one ragged).
SHAPES = [(257, 5, 5), (512, 128, 96), (1000, 17, 300), (300, 128, 7),
          (257, 130, 5), (2000, 40, 300)]


def _case(n, d, k, seed=0, weighted=False):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    C = (rng.normal(size=(k, d)) * 3).astype(np.float32)
    if weighted:
        w = rng.uniform(0.0, 2.0, size=n).astype(np.float32)
        w[rng.choice(n, n // 5, replace=False)] = 0.0
    else:
        w = np.ones(n, np.float32)
    return X, w, C


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _clear_rows(X, C):
    x = X.astype(np.float64)
    c = C.astype(np.float64)
    d2 = ((x * x).sum(1)[:, None] + (c * c).sum(1)[None, :] - 2 * x @ c.T)
    part = np.partition(d2, 1, axis=1)
    scale = (x * x).sum(1) + (c * c).sum(1).max()
    return (part[:, 1] - part[:, 0]) > 1e-4 * scale


def _pallas(X, w, C, **kw):
    return pallas_fused(X, w, C, tile_n=128, tile_k=128, interpret=True, **kw)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,d,k", SHAPES)
def test_fused_reference_matches_pallas(n, d, k, weighted):
    X, w, C = _case(n, d, k, seed=n + d + k, weighted=weighted)
    ref_l, ref_m, ref_s, ref_c = (np.asarray(a) for a in _pallas(X, w, C))
    labels, mind2, sums, counts = hk.fused_assign_reduce_reference(
        _t(X), _t(w), _t(C))
    assert labels.dtype == torch.int32 and labels.shape == (n,)
    assert sums.shape == (k, d) and counts.shape == (k,)
    clear = _clear_rows(X, C)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(labels.numpy()[clear], ref_l[clear])
    same = labels.numpy() == ref_l
    np.testing.assert_allclose(mind2.numpy()[same], ref_m[same], rtol=1e-4,
                               atol=1e-4)
    if same.all():
        np.testing.assert_allclose(
            sums.numpy(), ref_s, rtol=1e-5,
            atol=1e-5 * float(np.abs(ref_s).max()))
        if weighted:
            np.testing.assert_allclose(counts.numpy(), ref_c, rtol=1e-6)
        else:
            np.testing.assert_array_equal(counts.numpy(), ref_c)


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_assign_reference_matches_pallas_assign(n, d, k):
    X, _, C = _case(n, d, k, seed=7 + n)
    ref_l, ref_m = (np.asarray(a) for a in pallas_assign(
        X, C, tile_n=128, tile_k=128, interpret=True))
    labels, mind2 = hk.assign_reference(_t(X), _t(C))
    clear = _clear_rows(X, C)
    np.testing.assert_array_equal(labels.numpy()[clear], ref_l[clear])
    same = labels.numpy() == ref_l
    np.testing.assert_allclose(mind2.numpy()[same], ref_m[same], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_labels_of_the_two_plain_versions_are_equal(n, d, k):
    X, w, C = _case(n, d, k, seed=11)
    fused = hk.fused_assign_reduce_reference(_t(X), _t(w), _t(C))
    labels, mind2 = hk.assign_reference(_t(X), _t(C))
    assert torch.equal(fused[0], labels)
    assert torch.equal(fused[1], mind2)


def test_zero_weight_rows_are_inert():
    X, w, C = _case(300, 9, 11)
    w[250:] = 0.0
    _, _, ref_s, ref_c = (np.asarray(a) for a in _pallas(X, w, C))
    _, _, sums, counts = hk.fused_assign_reduce_reference(_t(X), _t(w), _t(C))
    assert float(counts.sum()) == 250 == float(ref_c.sum())
    np.testing.assert_allclose(sums.numpy(), ref_s, rtol=1e-5, atol=1e-4)
    # A zero-weight row adds nothing even where its coordinates are NaN.
    X[299, 3] = np.nan
    _, _, sums2, counts2 = hk.fused_assign_reduce_reference(
        _t(X), _t(w), _t(C))
    assert torch.equal(sums2, sums) and torch.equal(counts2, counts)


def test_exact_ties_go_to_the_lowest_index():
    X = np.array([[1.0, 1.0], [2.0, 0.0]], np.float32)
    C = np.array([[1.0, 1.0], [1.0, 1.0], [5.0, 5.0]], np.float32)
    w = np.ones(2, np.float32)
    ref_l = np.asarray(pallas_fused(X, w, C, tile_n=8, tile_k=128,
                                    interpret=True)[0])
    np.testing.assert_array_equal(ref_l, [0, 0])
    labels = hk.fused_assign_reduce_reference(_t(X), _t(w), _t(C))[0]
    np.testing.assert_array_equal(labels.numpy(), [0, 0])
    np.testing.assert_array_equal(
        hk.assign_reference(_t(X), _t(C))[0].numpy(), [0, 0])
    # Duplicates far apart in a wide table: still the lowest index.
    Xw, ww, Cw = _case(64, 8, 300, seed=5)
    Cw[250] = Cw[17]
    Cw[3] = Cw[17]
    Xw[9] = Cw[17]
    ref = np.asarray(_pallas(Xw, ww, Cw)[0])
    got = hk.fused_assign_reduce_reference(_t(Xw), _t(ww), _t(Cw))[0].numpy()
    assert ref[9] == 3 and got[9] == 3


def test_nonfinite_rows_get_label_zero():
    X = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    X[3, 2] = np.nan
    X[17, :] = np.inf
    C = np.random.default_rng(1).normal(size=(300, 8)).astype(np.float32)
    w = np.ones((64,), np.float32)
    ref_l = np.asarray(pallas_fused(X, w, C, tile_n=32, tile_k=128,
                                    interpret=True)[0])
    assert int(ref_l[3]) == 0 and int(ref_l[17]) == 0
    labels, mind2, _, _ = hk.fused_assign_reduce_reference(
        _t(X), _t(w), _t(C))
    got = labels.numpy()
    assert 0 <= got.min() and got.max() < 300
    assert int(got[3]) == 0 and int(got[17]) == 0
    ok = np.ones(64, bool)
    ok[[3, 17]] = False
    np.testing.assert_array_equal(got[ok], ref_l[ok])
    assert int(hk.assign_reference(_t(X), _t(C))[0][3]) == 0


def test_with_mind2_false_returns_none():
    X, w, C = _case(257, 5, 7)
    ref = _pallas(X, w, C, with_mind2=False)
    assert ref[1] is None
    full = hk.fused_assign_reduce_reference(_t(X), _t(w), _t(C))
    labels, mind2, sums, counts = hk.fused_assign_reduce_reference(
        _t(X), _t(w), _t(C), with_mind2=False)
    assert mind2 is None
    assert torch.equal(labels, full[0]) and torch.equal(sums, full[2])
    assert torch.equal(counts, full[3])
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref[0]))


def test_weight_column_layout_is_taken():
    """(n, 1) weights, the layout the JAX package's prep_points hands to its
    kernel, give the same result as (n,) weights."""
    X, w, C = _case(300, 9, 11, weighted=True)
    flat = hk.fused_assign_reduce_reference(_t(X), _t(w), _t(C))
    col = hk.fused_assign_reduce_reference(_t(X), _t(w[:, None]), _t(C))
    assert all(torch.equal(a, b) for a, b in zip(flat, col))


def test_rows_are_walked_in_blocks(monkeypatch):
    """No (n, k) matrix is held whole: more than one block of rows gives the
    same labels as one block."""
    X, w, C = _case(1000, 17, 300)
    whole = hk.fused_assign_reduce_reference(_t(X), _t(w), _t(C))
    monkeypatch.setattr(hk, "_REF_TILE_ELEMS", 128 * 300)
    assert hk._row_block(300) == 128
    blocked = hk.fused_assign_reduce_reference(_t(X), _t(w), _t(C))
    assert torch.equal(whole[0], blocked[0])
    np.testing.assert_allclose(blocked[2].numpy(), whole[2].numpy(),
                               rtol=1e-5, atol=1e-4)
    assert torch.equal(hk.assign_reference(_t(X), _t(C))[0], whole[0])


@pytest.mark.parametrize("fn", ["fused", "assign"])
def test_wrappers_refuse_what_the_kernels_do_not_take(fn):
    X, w, C = _case(64, 8, 5)

    def call(x, ww, c, **kw):
        if fn == "fused":
            return hk.fused_assign_reduce(x, ww, c, **kw)
        return hk.hopper_assign(x, c, **kw)

    # The bf16 kernels take float32 points too and round them themselves.
    with pytest.raises(TypeError):
        call(_t(X).double(), _t(w), _t(C), bf16=True)
    with pytest.raises(TypeError):
        call(_t(X).double(), _t(w), _t(C))
    with pytest.raises(ValueError):
        call(_t(X)[:, :4], _t(w), _t(C))
    with pytest.raises(ValueError):
        call(_t(X).T.contiguous().T, _t(w), _t(C))     # not contiguous
    with pytest.raises(ValueError):
        call(_t(X)[0], _t(w), _t(C))                   # 1-D points


# ------------------------------------------------- the fused GMM E-step kernel
#
# ``diag_estep_reference`` (kmeans_tpu_torch.ops.estep_kernels), the plain
# version that the CUDA kernel ``diag_estep`` is held to on the card, against
# the TPU kernel it stands for, ``pallas_estep`` of
# experiments/exp_gmm_estep_pallas.py, run in interpret mode.  Both sides
# float32, summed in another order.  Tolerances: rsum, s1 and s2
# ``rtol=1e-4`` plus 1e-5 of the largest entry (centered sums cancel to near
# zero); ll ``rtol=1e-5``.  The hard tables are held on the rows outside the
# tie band (tests/test_torch_gmm_step.py says why).

import importlib.util  # noqa: E402
from pathlib import Path  # noqa: E402

from kmeans_tpu_torch.ops import estep_kernels as ek  # noqa: E402
from test_torch_gmm_step import clear_of_ties, make_case  # noqa: E402


def _load_pallas_estep():
    path = (Path(__file__).resolve().parent.parent / "experiments"
            / "exp_gmm_estep_pallas.py")
    spec = importlib.util.spec_from_file_location("exp_gmm_estep_pallas",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.pallas_estep


_PALLAS_ESTEP = []


def _pallas_estep(*args):
    """The TPU kernel with 64-bit types off inside the call, as the JAX
    package's own hardware tests run its float32 kernels
    (tests/test_pallas_tpu.py): under x64 its ``D log 2pi`` constant would
    promote ``c1`` to float64 and the float32 output block refuses it."""
    import jax
    if not _PALLAS_ESTEP:
        _PALLAS_ESTEP.append(_load_pallas_estep())
    with jax.enable_x64(False):
        return [np.asarray(a)
                for a in _PALLAS_ESTEP[0](*args, interpret=True)]


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("n,d,k", [(1037, 7, 5), (1037, 100, 64),
                                   (777, 7, 64), (777, 100, 5)])
def test_estep_reference_matches_pallas_estep(n, d, k, hard):
    X, w, shift, mc, iv, ld, lw = make_case(n, d, k, seed=n * k + d,
                                            hard=hard, dtype=np.float32)
    if hard:
        w = np.where(clear_of_ties(X, shift, mc), w, 0).astype(np.float32)
        assert (w > 0).mean() > 0.8
    args = (X, w, shift, mc, iv, ld, lw)
    ref = _pallas_estep(*args)
    got = [a.numpy() for a in ek.diag_estep_reference(*(_t(a)
                                                         for a in args))]
    assert got[1].dtype == np.float32 and got[1].shape == (k, d)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()))
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-5)


def test_estep_wrapper_refuses_what_the_kernel_does_not_take():
    args = [_t(a) for a in make_case(64, 8, 5, seed=1, dtype=np.float32)]
    with pytest.raises(TypeError):
        ek.diag_estep(args[0].double(), *args[1:])
    with pytest.raises(TypeError):                     # float64 elsewhere
        ek.diag_estep(*args[:4], args[4].double(), *args[5:])
    with pytest.raises(ValueError):
        ek.diag_estep(args[0], args[1], args[2][:4], *args[3:])
    with pytest.raises(ValueError):
        ek.diag_estep(*args[:4], args[4].T.contiguous().T, *args[5:])
    with pytest.raises(ValueError):
        ek.diag_estep(args[0], args[1][:10], *args[2:])
    with pytest.raises(ValueError):
        ek.diag_estep(args[0][:, :4], *args[1:])
    # The plain version also takes float64, all inputs alike.
    ek.diag_estep_reference(*(a.double() for a in args))


# ------------------------------------------ ablations of the E-step kernel
#
# ``experiments/edits_gmm_estep.json`` holds the edited builds of
# ``csrc/gmm_estep.cu`` that PERF.md reports (its top-level ``"source"``
# names the file).  Every ``old`` text must occur exactly once in the
# current source, and the builds need ``nvcc``: without it they raise.

from kmeans_tpu_torch.experiments import \
    exp_kernel_edits as kernel_edits  # noqa: E402
from kmeans_tpu_torch.ops import _build  # noqa: E402


def test_estep_edits_apply_to_the_source_and_build_only_with_nvcc(
        monkeypatch, tmp_path):
    path = kernel_edits.ESTEP_EDITS
    assert kernel_edits.edits_source(path) == ek.LIB_NAME
    assert kernel_edits.edits_source(kernel_edits.DEFAULT_EDITS) \
        == "assign_kernels"
    variants = kernel_edits.load_edits(path)
    src = (_build.CSRC_DIR / "gmm_estep.cu").read_text()
    texts = {name: kernel_edits.apply_edits(src, edits)
             for name, edits in variants.items()}
    assert texts["as_is"] == src
    assert {"one_product", "no_products", "no_group_rounding",
            "always_recompute"} <= set(texts)
    assert len(set(texts.values())) == len(texts)
    bad = tmp_path / "bad.json"
    bad.write_text('{"source": "no_such_source", "as_is": []}')
    with pytest.raises(ValueError, match="unknown source"):
        kernel_edits.load_edits(bad)

    def no_nvcc():
        raise _build.KernelCompileError("nvcc not found (test)")

    monkeypatch.setattr(kernel_edits, "EDITS_DIR", tmp_path / "edits")
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        kernel_edits.build({"as_is": []}, ek.LIB_NAME)
