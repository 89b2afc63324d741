"""The bf16 distance class of the port against the JAX package's, on the CPU.

* ``ops.assign`` in ``mode='matmul_bf16'`` against ``kmeans_tpu.ops.assign``
  in the same mode (XLA on the CPU).
* The plain versions of the bf16 kernels,
  ``hopper_kernels.fused_assign_reduce(..., bf16=True)`` and
  ``hopper_assign(..., bf16=True)`` on CPU tensors, against the Pallas
  kernels with ``bf16=True`` in interpret mode, as
  ``tests/test_torch_kernels_plain.py`` runs the float32 ones.
* ``KMeans(distance_mode='pallas_bf16')`` and ``'matmul_bf16'`` as a whole.
* The CPU parts of the variant lab, ``experiments/exp_pallas_kernel.py``.

Both sides compute "bf16 products, float32 sums": the same rounded inputs,
summed in another order.  Tolerances: labels equal outside the band
``1e-4 (||x||^2 + max ||c||^2)`` on the float64 difference of the two
centroids' scores from the bf16-rounded inputs; distances ``rtol=1e-5``
(plus ``1e-6`` of the norms: the expanded form cancels); ``mind2``
``rtol=1e-4, atol=1e-4``; sums ``rtol=1e-5`` plus ``1e-5`` of the largest
entry; counts ``rtol=1e-6``, equal for unit weights.

The one rule of the port at every D: ``h`` and the counts are float32 from
the unrounded inputs, the sums ``sum bf16(w) bf16(x)``.  The Pallas kernel
follows it where D is a multiple of 128; at a ragged D it folds ``-h`` and a
ones column through its bf16 product, so its ``h`` is rounded to bf16 and
its counts are ``sum bf16(w)`` (ROADMAP.md, C).  The tests at D = 100 pin
that difference.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from conftest import pallas_x64_skip  # noqa: E402

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu.ops import assign as jx  # noqa: E402
from kmeans_tpu.ops.pallas_kernels import (  # noqa: E402
    fused_assign_reduce as pallas_fused, pallas_assign)
from kmeans_tpu_torch.data.synthetic import make_blobs  # noqa: E402
from kmeans_tpu_torch.experiments import exp_pallas_kernel as lab  # noqa: E402
from kmeans_tpu_torch.experiments import \
    exp_kernel_edits as kernel_edits  # noqa: E402
from kmeans_tpu_torch.ops import _build  # noqa: E402
from kmeans_tpu_torch.ops import assign as pt  # noqa: E402
from kmeans_tpu_torch.ops import hopper_kernels as hk  # noqa: E402

SHAPES = [(257, 5, 7), (512, 40, 96), (1000, 17, 300)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf(a):
    """bf16-rounded, as float64 (NumPy has no bf16)."""
    return _t(a).to(torch.bfloat16).double().numpy()


def _case(n, d, k, seed=0, weighted=True):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    C = (rng.normal(size=(k, d)) * 3).astype(np.float32)
    if weighted:
        # Uniform in [0.5, 2): almost none of them is a bf16 value.
        w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
        w[rng.choice(n, n // 10, replace=False)] = 0.0
    else:
        w = np.ones(n, np.float32)
    return X, w, C


def _clear_rows(X, C):
    """Rows whose two best bf16 scores (float64, from the rounded inputs)
    are farther apart than the band."""
    c = C.astype(np.float64)
    score = (c * c).sum(1)[None, :] - 2.0 * _bf(X) @ _bf(C).T
    part = np.partition(score, 1, axis=1)
    scale = (X.astype(np.float64) ** 2).sum(1) + (c * c).sum(1).max()
    return (part[:, 1] - part[:, 0]) > 1e-4 * scale


# ------------------------------------------------- ops.assign, matmul_bf16


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_pairwise_sq_dists_bf16_matches_jax(n, d, k):
    X, _, C = _case(n, d, k)
    ref = np.asarray(jx.pairwise_sq_dists(X, C, mode="matmul_bf16"))
    got = pt.pairwise_sq_dists(_t(X), _t(C), mode="matmul_bf16").numpy()
    assert got.dtype == np.float32
    norms = (X.astype(np.float64) ** 2).sum(1)[:, None] \
        + (C.astype(np.float64) ** 2).sum(1)[None, :]
    np.testing.assert_array_less(np.abs(got - ref), 1e-5 * np.abs(ref)
                                 + 1e-6 * norms)
    # Not the float32 distances: the cross term is the rounded one.
    exact = pt.pairwise_sq_dists(_t(X), _t(C), mode="matmul").numpy()
    assert np.abs(exact - got).max() > 1e-3


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_assign_chunk_bf16_matches_jax(n, d, k):
    X, _, C = _case(n, d, k, seed=3)
    ref_l, ref_m = (np.asarray(a) for a in jx.assign_chunk(
        X, C, mode="matmul_bf16"))
    got_l, got_m = pt.assign_chunk(_t(X), _t(C), mode="matmul_bf16")
    clear = _clear_rows(X, C)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got_l.numpy()[clear], ref_l[clear])
    np.testing.assert_allclose(got_m.numpy(), ref_m, rtol=1e-4, atol=1e-3)
    labels = pt.assign_labels(_t(X), _t(C), chunk_size=128,
                              mode="matmul_bf16").numpy()
    np.testing.assert_array_equal(labels, got_l.numpy())


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_assign_reduce_bf16_matches_jax(n, d, k):
    X, w, C = _case(n, d, k, seed=n + k)
    chunk = 128
    pad = (-n) % chunk
    Xp = np.concatenate([X, np.zeros((pad, d), X.dtype)])
    wp = np.concatenate([w, np.zeros(pad, w.dtype)])
    ref = jx.assign_reduce(Xp, wp, C, chunk_size=chunk, mode="matmul_bf16")
    got = pt.assign_reduce(_t(X), _t(w), _t(C), chunk_size=chunk,
                           mode="matmul_bf16")
    # Both sides give every row the same label here, the rows inside the
    # band included, so the sums are held entry by entry.
    jl = np.asarray(jx.assign_chunk(X, C, mode="matmul_bf16")[0])
    labels = pt.assign_chunk(_t(X), _t(C), mode="matmul_bf16")[0].numpy()
    np.testing.assert_array_equal(labels, jl)
    ref_s = np.asarray(ref.sums)
    tol = dict(rtol=1e-5, atol=1e-5 * float(np.abs(ref_s).max()))
    np.testing.assert_allclose(got.sums.numpy(), ref_s, **tol)
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(ref.counts),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got.sse), float(ref.sse), rtol=1e-5)
    # The sums round the weights too (bf16(onehot * w)); without that
    # rounding they are farther from the reference than the tolerance.
    unrounded = np.zeros((k, d))
    np.add.at(unrounded, labels, w[:, None].astype(np.float64) * _bf(X))
    assert not np.allclose(unrounded, ref_s, **tol)


def test_guarded_mode_still_raises():
    """The guarded rung is ported (tests/test_torch_guarded.py); what
    still raises: its name is no tile mode, so ``pairwise_sq_dists`` raises
    the JAX package's ValueError, and ``KMeans`` refuses it under a model
    axis and with 'farthest', with the JAX package's messages."""
    X, _, C = _case(16, 4, 3)
    for fn, args in ((pt.pairwise_sq_dists, (_t(X), _t(C))),
                     (jx.pairwise_sq_dists, (X, C))):
        with pytest.raises(ValueError, match="unknown distance mode"):
            fn(*args, mode="matmul_bf16_guarded")
    with pytest.raises(ValueError, match="data-parallel mesh"):
        kmeans_tpu_torch.KMeans(k=3, device="cpu", model_shards=2,
                                distance_mode="matmul_bf16_guarded")
    with pytest.raises(ValueError, match="empty_cluster='farthest'"):
        kmeans_tpu_torch.KMeans(k=3, device="cpu", empty_cluster="farthest",
                                distance_mode="matmul_bf16_guarded")


# ------------------------------------- plain versions of the bf16 kernels


def _pallas(X, w, C, **kw):
    return [None if a is None else np.asarray(a) for a in pallas_fused(
        X, w, C, tile_n=128, tile_k=128, bf16=True, interpret=True, **kw)]


@pallas_x64_skip
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,d,k", [(512, 128, 96), (300, 256, 200),
                                   (257, 128, 300)])
def test_bf16_fused_reference_matches_pallas(n, d, k, weighted):
    X, w, C = _case(n, d, k, seed=n + d + k, weighted=weighted)
    ref_l, ref_m, ref_s, ref_c = _pallas(X, w, C)
    labels, mind2, sums, counts = hk.fused_assign_reduce(
        _t(X), _t(w), _t(C), bf16=True)
    clear = _clear_rows(X, C)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(labels.numpy()[clear], ref_l[clear])
    same = labels.numpy() == ref_l
    np.testing.assert_allclose(mind2.numpy()[same], ref_m[same], rtol=1e-4,
                               atol=1e-4)
    if not same.all():
        return
    np.testing.assert_allclose(sums.numpy(), ref_s, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref_s).max()))
    if weighted:
        np.testing.assert_allclose(counts.numpy(), ref_c, rtol=1e-6)
    else:
        np.testing.assert_array_equal(counts.numpy(), ref_c)


@pallas_x64_skip
@pytest.mark.parametrize("n,d,k", [(512, 128, 96), (300, 256, 200)])
def test_bf16_assign_reference_matches_pallas_assign(n, d, k):
    X, _, C = _case(n, d, k, seed=7 + n)
    ref_l, ref_m = (np.asarray(a) for a in pallas_assign(
        X, C, tile_n=128, tile_k=128, bf16=True, interpret=True))
    labels, mind2 = hk.hopper_assign(_t(X), _t(C), bf16=True)
    clear = _clear_rows(X, C)
    np.testing.assert_array_equal(labels.numpy()[clear], ref_l[clear])
    same = labels.numpy() == ref_l
    np.testing.assert_allclose(mind2.numpy()[same], ref_m[same], rtol=1e-4,
                               atol=1e-4)
    fused = hk.fused_assign_reduce(_t(X), torch.ones(n), _t(C), bf16=True)
    assert torch.equal(fused[0], labels) and torch.equal(fused[1], mind2)


@pallas_x64_skip
def test_ragged_width_differs_from_pallas_as_documented():
    """D = 100: the Pallas kernel folds -h and a ones column through its
    bf16 product, the port keeps one rule at every D."""
    n, d, k = 512, 100, 96
    X, w, C = _case(n, d, k, seed=5)
    ref_l, ref_m, ref_s, ref_c = _pallas(X, w, C)
    labels, mind2, sums, counts = hk.fused_assign_reduce(
        _t(X), _t(w), _t(C), bf16=True)
    lab = labels.numpy()
    # Counts: the port's are sum w, the kernel's sum bf16(w).
    want = np.zeros(k)
    np.add.at(want, lab, w.astype(np.float64))
    np.testing.assert_allclose(counts.numpy(), want, rtol=1e-6)
    same = lab == ref_l
    rounded = np.zeros(k)
    np.add.at(rounded, ref_l, _bf(w))
    np.testing.assert_allclose(ref_c, rounded, rtol=1e-6)
    assert np.abs(counts.numpy() - ref_c).max() > 1e-3
    # mind2: apart only by the bf16 rounding of h (2 ulp of the largest h)
    # and the band.
    h = 0.5 * (C.astype(np.float64) ** 2).sum(1)
    ulp = 2.0 ** (np.floor(np.log2(h.max())) - 7)
    scale = (X.astype(np.float64) ** 2).sum(1) + 2 * h.max()
    bound = 2 * (2 * ulp) + 1e-4 * scale
    assert (np.abs(mind2.numpy() - ref_m)[same] <= bound[same]).all()
    assert same.mean() > 0.9
    # ... and the port equals matmul_bf16 at every D.
    jl, jm = (np.asarray(a) for a in jx.assign_chunk(X, C,
                                                     mode="matmul_bf16"))
    clear = _clear_rows(X, C)
    np.testing.assert_array_equal(lab[clear], jl[clear])
    np.testing.assert_allclose(mind2.numpy(), jm, rtol=1e-4, atol=1e-3)


def test_bf16_plain_versions_round_what_the_kernels_round():
    X, w, C = _case(300, 24, 11, seed=2)
    x, c, ww = _t(X), _t(C), _t(w)
    labels, mind2, sums, counts = hk.fused_assign_reduce_reference(
        x, ww, c, bf16=True)
    xb, cb = _bf(X), _bf(C)
    h = 0.5 * (C.astype(np.float64) ** 2).sum(1)
    score = h[None, :] - xb @ cb.T
    np.testing.assert_array_equal(labels.numpy(), score.argmin(1))
    x2 = (X.astype(np.float64) ** 2).sum(1)
    np.testing.assert_allclose(mind2.numpy(),
                               np.maximum(2 * score.min(1) + x2, 0),
                               rtol=1e-5, atol=1e-4)
    want = np.zeros((11, 24))
    np.add.at(want, score.argmin(1), _bf(w)[:, None] * xb)
    np.testing.assert_allclose(sums.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        counts.numpy(), np.bincount(score.argmin(1), weights=w,
                                    minlength=11), rtol=1e-6)
    # Rows of weight 0 add nothing, not even a NaN.
    X[5, 3] = np.nan
    w[5] = 0.0
    again = hk.fused_assign_reduce(_t(X), _t(w), c, bf16=True)
    assert int(again[0][5]) == 0 and bool(torch.isfinite(again[2]).all())
    with pytest.raises(TypeError):
        hk.hopper_assign(x.double(), c.double(), bf16=True)


# --------------------------------------------------------- the slice


# (port mode, D, the JAX package's mode, rtol of sse_history): at D = 128
# the Pallas bf16 kernel and the port agree by construction; at D = 100 the
# port is held to matmul_bf16 (the fold of the Pallas kernel rounds h,
# ROADMAP.md C).  There the two SSEs are different estimators: the kernel
# modes derive the SSE algebraically from the bf16-rounded sums (as the JAX
# package's pallas modes do), matmul_bf16 sums the minimum distances; the
# bf16 rounding of the cross term 2 sum <c_k, S_k> (about 2^-9 of each
# coordinate) parts them by up to 8.6e-4 of the SSE on this data.
SLICE = [("pallas_bf16", 128, "pallas_bf16", 1e-4),
         ("pallas_bf16", 100, "matmul_bf16", 2e-3),
         ("matmul_bf16", 128, "matmul_bf16", 1e-4)]


@pallas_x64_skip
@pytest.mark.parametrize("mode,d,jax_mode,sse_rtol", SLICE)
def test_bf16_fit_and_predict_match_jax(mesh1, mode, d, jax_mode, sse_rtol):
    X, _ = make_blobs(2048, 16, d, random_state=7)
    common = dict(k=16, max_iter=20, seed=3, init="forgy", compute_sse=True,
                  verbose=False)
    jm = kmeans_tpu.KMeans(mesh=mesh1, host_loop=True, distance_mode=jax_mode,
                           **common).fit(X)
    pm = kmeans_tpu_torch.KMeans(device="cpu", distance_mode=mode,
                                 **common).fit(X)
    assert pm.n_iter_ == jm.n_iter_ < 20
    np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(pm.sse_history, jm.sse_history, rtol=sse_rtol)
    Q, _ = make_blobs(700, 16, d, random_state=9)
    got = pm.predict(Q)
    clear = _clear_rows(Q, pm.centroids)
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear],
                                  np.asarray(jm.predict(Q))[clear])
    np.testing.assert_array_equal(pm.labels_, np.asarray(jm.labels_))
    np.testing.assert_allclose(pm.score(Q), jm.score(Q), rtol=sse_rtol)


def test_bf16_mode_names_and_dtype():
    km = kmeans_tpu_torch.KMeans(k=3, device="cpu",
                                 distance_mode="pallas_bf16")
    assert km.distance_mode == km._mode() == "kernel_bf16"
    assert km._state_dict()["distance_mode"] == "pallas_bf16"
    assert kmeans_tpu_torch.KMeans(
        k=3, device="cpu", distance_mode="matmul_bf16")._mode() == \
        "matmul_bf16"
    # float64 is taken as the JAX package takes it: the kernel runs on
    # float32 casts, the centroids stay float64.
    X, _ = make_blobs(300, 3, 5, random_state=1, dtype=np.float64)
    km64 = kmeans_tpu_torch.KMeans(k=3, device="cpu", dtype=np.float64,
                                   distance_mode="pallas_bf16", verbose=False,
                                   max_iter=5).fit(X)
    assert km64._mode() == "kernel_bf16"
    assert km64.centroids.dtype == np.float64
    ref = hk.assign_reference(_t(X.astype(np.float32)),
                              _t(km64.centroids.astype(np.float32)),
                              bf16=True)[0]
    np.testing.assert_array_equal(km64.predict(X), ref.numpy())
    # matmul_bf16 is a torch pass: float64 is taken, and only the product's
    # inputs are rounded.
    pm = kmeans_tpu_torch.KMeans(k=3, device="cpu", dtype=np.float64,
                                 distance_mode="matmul_bf16", verbose=False,
                                 max_iter=5).fit(X)
    assert pm.centroids.dtype == np.float64


def test_bf16_kernel_mode_runs_the_plain_versions_on_the_cpu():
    X, _ = make_blobs(600, 4, 8, random_state=2)
    hk.reset_launch_counts()
    km = kmeans_tpu_torch.KMeans(k=4, device="cpu", verbose=False,
                                 distance_mode="pallas_bf16",
                                 compute_sse=True).fit(X)
    x = _t(X)
    c = _t(km.centroids)
    ref = hk.assign_reference(x, c, bf16=True)[0].numpy()
    np.testing.assert_array_equal(km.predict(X), ref)
    np.testing.assert_array_equal(km.fit_predict(X), km.labels_)
    assert set(hk.LAUNCHES.values()) == {0}


# ------------------------------------------------------- the variant lab


def test_lab_spec_grammar():
    v = lab.parse_spec("pipe1=128,64,p")
    assert (v.name, v.tile_n, v.tile_k, v.pipe, v.bf16) == \
        ("pipe1", 128, 64, True, False)
    assert v.source == "assign_kernels"
    b = lab.parse_spec("b=64,128,bp")
    assert (b.tile_n, b.tile_k, b.pipe, b.bf16) == (64, 128, True, True)
    assert b.source == "assign_bf16"
    assert b.defines == {"KM_TILE_N": 64, "KM_TILE_K": 128, "KM_PIPE": 1}
    plain = lab.parse_spec("plain=128,128")
    assert not plain.pipe and not plain.bf16
    for bad in ("x", "x=128", "x=a,128", "x=128,128,z", "x=64,128,p",
                "x=128,256,b", "=128,128"):
        with pytest.raises(ValueError):
            lab.parse_spec(bad)


@pytest.mark.parametrize("flag", ["m", "o", "f"])
def test_lab_refuses_the_tpu_only_flags(flag):
    with pytest.raises(ValueError, match="no CUDA counterpart"):
        lab.parse_spec(f"v=128,128,p{flag}")


def test_lab_variant_library_names_follow_the_defines():
    a = lab.parse_spec("a=128,128,p").library_path()
    b = lab.parse_spec("b=128,64,p").library_path()
    c = lab.parse_spec("c=128,128").library_path()
    d = lab.parse_spec("d=128,128,pb").library_path()
    assert len({a, b, c, d}) == 4
    assert a.parent == _build.BUILD_DIR
    assert a.name.startswith("libassign_kernels_")
    assert d.name.startswith("libassign_bf16_")
    assert _build.library_path("assign_kernels") not in {a, b, c}
    assert lab.parse_spec("e=128,128,p").library_path() == a


@pytest.mark.parametrize("spec", ["f=128,128,p", "b=64,128,pb"])
def test_lab_check_on_cpu_tensors_is_the_plain_version(spec):
    X, _, C = _case(5000, 20, 40, seed=4)
    variant = lab.parse_spec(spec)
    x, w, c = lab.check_inputs(_t(X), _t(C))
    assert x.shape == (lab.CHECK_ROWS, 20) and float(w[0]) == 0.0
    hk.reset_launch_counts()
    rec = lab.check(variant, x, w, c)
    assert rec["ok"] and rec["label_diff"] == 0 and rec["sums_err"] == 0.0
    both = lab.check_variant(variant, _t(X), _t(C))
    assert both["ok"] and both["slice"] == rec
    assert both["timed_inputs"]["n"] == 5000
    got = lab.run(variant, x, w, c)
    ref = hk.fused_assign_reduce_reference(x, w, c, bf16=variant.bf16)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert variant.counter == f"kernel_variant:{variant.name}"
    assert variant.counter not in hk.LAUNCHES
    assert "WRONG RESULT" in lab.line({"name": "v", "ms_per_iter": None})


def test_lab_build_without_nvcc_raises_and_does_not_fall_back(monkeypatch,
                                                             tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", _no_nvcc)
    variant = lab.parse_spec("v=128,64,p")
    assert not variant.library_path().exists()
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        lab.build([variant])
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        _build.load_variant(variant.source, variant.defines)
    assert lab.main(["10", "4", "3", "1"]) == 2          # no spec: usage


def _no_nvcc():
    raise _build.KernelCompileError("nvcc not found (test)")


def test_kernel_edits_apply_to_the_source_and_build_only_with_nvcc(
        monkeypatch, tmp_path):
    variants = kernel_edits.load_edits(kernel_edits.DEFAULT_EDITS)
    src = (_build.CSRC_DIR / "assign_kernels.cu").read_text()
    texts = {name: kernel_edits.apply_edits(src, edits)
             for name, edits in variants.items()}
    assert texts["as_is"] == src and len(texts) > 1
    assert len(set(texts.values())) == len(texts)
    with pytest.raises(ValueError, match="not once"):
        kernel_edits.apply_edits(src, [{"old": "no such text", "new": ""}])
    monkeypatch.setattr(kernel_edits, "EDITS_DIR", tmp_path / "edits")
    monkeypatch.setattr(_build, "find_nvcc", _no_nvcc)
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        kernel_edits.build({"as_is": []})
    assert kernel_edits.main([]) == 2


# ----------------------------------- the layout of bf16(c) in the scratch
#
# prep_centroids_kernel writes bf16(c) as tile images that one bulk copy
# moves into shared memory, already in the layout that the wgmma
# descriptors read; hopper_kernels.tile_image_index mirrors its index
# arithmetic (chip_smoke.py holds the kernel's scratch to it on the card).


@pytest.mark.parametrize("tile_k", [128, 64])
@pytest.mark.parametrize("k,d", [(3000, 100), (1024, 128), (5, 7),
                                 (10, 784)])
def test_tile_images_round_trip(k, d, tile_k):
    rng = np.random.default_rng(k + d)
    c = _t(rng.normal(size=(k, d)).astype(np.float32))
    images = hk.tile_images(c, tile_k)
    tiles, chunks = -(-k // tile_k), -(-d // 64)
    assert images.dtype == torch.bfloat16
    assert images.numel() == tiles * tile_k * chunks * 64
    back = hk.read_tile_images(images, k, d, tile_k)
    want = torch.zeros((tiles * tile_k, chunks * 64), dtype=torch.bfloat16)
    want[:k, :d] = c.to(torch.bfloat16)
    assert torch.equal(back.view(torch.int16), want.view(torch.int16))
    index = hk.tile_image_index(k, d, tile_k)
    assert torch.equal(index.reshape(-1).sort().values,
                       torch.arange(index.numel()))
    # Tile j is one block of tile_k * chunks * 64 elements; in it chunk q
    # holds tile_k rows of 64, and unit u (8 features) of row r sits at unit
    # u ^ (r % 8) of its row.
    image = tile_k * chunks * 64
    for tile in range(tiles):
        rows = index[tile * tile_k:(tile + 1) * tile_k]
        assert int(rows.min()) == tile * image
        assert int(rows.max()) == (tile + 1) * image - 1
    r, q, u, e = 9, chunks - 1, 3, 2
    assert int(index[r, q * 64 + u * 8 + e]) == (
        q * tile_k * 64 + r * 64 + (u ^ (r % 8)) * 8 + e)


def test_bf16_grid_follows_what_the_library_reports():
    class Lib:
        _per_sm = {}

        @staticmethod
        def kmeans_blocks_per_sm(d):
            return 0 if d > 1000 else 1

    lib = Lib()
    assert hk._per_sm(lib, True, 128) == 1 and lib._per_sm == {128: 1}
    assert hk._per_sm(lib, False, 128) == hk._BLOCKS_PER_SM
    with pytest.raises(RuntimeError, match="no block"):
        hk._per_sm(lib, True, 2000)
