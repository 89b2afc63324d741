"""The guarded bf16 rung of the port (``distance_mode='matmul_bf16_guarded'``,
``ops.assign.guarded_assign_chunk``) on the CPU.

The reference's own guarded tests fail (ROADMAP C.3: its float32 labels
are not the float32 argmin everywhere), so the oracles are:

* a float64 argmin: the rung's labels equal it wherever the float64 margin
  clears ``1e-4 * (||x||^2 + max ||c||^2)`` (the float32 band);
* the rung's own margin rule: the flagged rows are exactly those whose
  margin on the bf16 tile lies within ``BF16_GUARD_RTOL`` of their scale;
* the JAX package's functions in float64, on data built so that every
  margin lies far from the flag threshold (rows between twin centroids,
  far below it, or clear rows): equal flags and labels, margins and winner
  distances to ``rtol=1e-12``, and the bf16 tiles to ``rtol=1e-7`` (XLA
  sums the bf16 products in float32 there, the port in float64);
* the port's own 'matmul' fit: the rung's labels, sums and counts are those
  of 'matmul', so its centroids are bit-equal in float64.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu.ops import assign as jx  # noqa: E402
from kmeans_tpu.parallel import distributed as jdist  # noqa: E402
from kmeans_tpu_torch.ops import assign as pt  # noqa: E402
from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402

GUARDED = "matmul_bf16_guarded"
RTOL, ATOL = 1e-12, 1e-10


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _blobs(n=1500, d=8, centers=6, seed=0, dtype=np.float64, std=0.6):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-4.0, 4.0, size=(centers, d))
    y = rng.integers(0, centers, size=n)
    return (means[y] + std * rng.standard_normal((n, d))).astype(dtype)


def _near_ties(n=600, d=12, k=24, seed=0, dtype=np.float64):
    """Rows and centroids whose margins lie far from the flag threshold
    (about 0.03 of a scale near 3e3): a third of the centroids are twins,
    3 from one of the others, and half of the rows lie between a centroid
    and its twin, nearer the centroid by 0.9 to 3.6 in squared distance
    (flagged: within the bf16 error, outside the float32 band); the other
    rows lie near a centroid without a twin, every other centroid farther
    by hundreds (clear)."""
    rng = np.random.default_rng(seed)
    n_base = k - k // 3
    base = rng.uniform(-20.0, 20.0, size=(n_base, d))
    step = rng.standard_normal((k // 3, d))
    step *= 3.0 / np.linalg.norm(step, axis=1, keepdims=True)
    C = np.concatenate([base, base[: k // 3] + step])
    half = n // 2
    pair = rng.integers(0, k // 3, half)
    t = rng.uniform(0.3, 0.45, half)[:, None]
    between = base[pair] + t * step[pair]
    alone = base[rng.integers(k // 3, n_base, n - half)] + \
        0.05 * rng.standard_normal((n - half, d))
    return (np.concatenate([between, alone]).astype(dtype),
            C.astype(dtype))


def _float64_outside(X, C, labels):
    """Rows whose label differs from the float64 argmin outside the band."""
    x, c = X.astype(np.float64), C.astype(np.float64)
    d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    ref = d2.argmin(1)
    rows = np.flatnonzero(labels != ref)
    gap = np.abs(d2[rows, labels[rows]] - d2[rows, ref[rows]])
    scale = (x[rows] ** 2).sum(1) + (c ** 2).sum(1).max()
    return int((gap > 1e-4 * scale).sum()), rows.size


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_guarded_labels_are_the_float64_argmin_outside_the_band(dtype,
                                                                seed):
    X, C = _near_ties(seed=seed, dtype=dtype)
    d2 = pt.distance_stage(_t(X), _t(C), mode=GUARDED)
    labels, flagged = pt.guarded_assign_chunk(_t(X), d2, _t(C))
    outside, differ = _float64_outside(X, C, labels.numpy())
    assert outside == 0
    assert int(flagged) > 0
    # The bf16 argmin alone is wrong outside the band on this data.
    bf16 = torch.argmin(d2, dim=1).numpy()
    assert _float64_outside(X, C, bf16)[0] > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_flags_follow_the_margin_rule(dtype):
    X, C = _near_ties(seed=4, dtype=dtype)
    x, c = _t(X), _t(C)
    d2 = pt.distance_stage(x, c, mode=GUARDED).double().numpy()
    part = np.sort(d2, axis=1)
    scale = (X.astype(np.float64) ** 2).sum(1) + \
        (C.astype(np.float64) ** 2).sum(1).max()
    near = (part[:, 1] - part[:, 0]) <= pt.BF16_GUARD_RTOL * scale
    w = np.ones(X.shape[0])
    w[::5] = 0.0
    _, flagged = pt.guarded_assign_chunk(x, _t(d2.astype(dtype)), c,
                                         valid=_t(w > 0))
    assert int(flagged) == int((near & (w > 0)).sum())
    _, every = pt.guarded_assign_chunk(x, _t(d2.astype(dtype)), c)
    assert int(every) == int(near.sum()) > int(flagged)


def test_sentinel_rows_stay_out_of_the_scale():
    """A 1e12 sentinel row in the scale would flag every row; masked by
    ``real_mask`` it changes nothing (the sweep's padding)."""
    X, C = _near_ties(seed=5)
    pad = np.full((3, C.shape[1]), dist.PAD_CENTROID_VALUE)
    Cp = np.concatenate([C, pad])
    real = _t(np.arange(Cp.shape[0]) < C.shape[0])
    d2 = pt.distance_stage(_t(X), _t(Cp), mode=GUARDED)
    masked, n_masked = pt.guarded_assign_chunk(_t(X), d2, _t(Cp),
                                               real_mask=real)
    plain, n_plain = pt.guarded_assign_chunk(
        _t(X), pt.distance_stage(_t(X), _t(C), mode=GUARDED), _t(C))
    np.testing.assert_array_equal(masked.numpy(), plain.numpy())
    assert int(n_masked) == int(n_plain) < X.shape[0]
    _, n_all = pt.guarded_assign_chunk(_t(X), d2, _t(Cp))
    assert int(n_all) == X.shape[0]


@pytest.mark.parametrize("seed", [0, 3])
def test_chunk_functions_match_jax_away_from_the_threshold(seed):
    X, C = _near_ties(seed=seed)
    w = np.ones(X.shape[0])
    w[::7] = 0.0
    d2_j = jx.distance_stage(X, C, mode=GUARDED)
    d2_p = pt.distance_stage(_t(X), _t(C), mode=GUARDED)
    # XLA sums the bf16 products in float32 here, the port in float64.
    np.testing.assert_allclose(d2_p.numpy(), np.asarray(d2_j), rtol=1e-7,
                               atol=1e-3)
    lj, nj = jx.guarded_assign_chunk(X, d2_j, C, valid=w > 0)
    lp, n_p = pt.guarded_assign_chunk(_t(X), d2_p, _t(C), valid=_t(w > 0))
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
    assert int(n_p) == int(nj) > 0
    c2max = float((C ** 2).sum(1).max())
    bj, mj, sj = jx.margin_chunk(X, d2_j, c2max)
    bp, mp, sp = pt.margin_chunk(_t(X), _t(np.array(d2_j)),
                                 torch.tensor(c2max, dtype=torch.float64))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    np.testing.assert_allclose(mp.numpy(), np.asarray(mj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), rtol=RTOL)
    win_j = jx._winner_sq_dists(X, C, lj, np.float64)
    win_p = pt._winner_sq_dists(_t(X), _t(C), lp, torch.float64)
    np.testing.assert_allclose(win_p.numpy(), np.asarray(win_j), rtol=RTOL,
                               atol=ATOL)
    for mode in (GUARDED, "matmul", "kernel"):
        assert pt.value_mode(mode) == jx.value_mode(mode)
    assert pt.BF16_GUARD_RTOL == jx.BF16_GUARD_RTOL
    assert pt.GUARDED_MODE == jx.GUARDED_MODE


@pytest.mark.parametrize("weighted", [False, True])
def test_the_pass_is_the_matmul_pass_with_winner_distances(weighted):
    X = _blobs(n=900, seed=2)
    rng = np.random.default_rng(1)
    w = rng.uniform(0.5, 2.0, X.shape[0]) if weighted else np.ones(900)
    C = X[rng.choice(900, 7, replace=False)]
    g, flagged = pt.reduce_chunks(_t(X), _t(w), _t(C), chunk_size=128,
                                  mode=GUARDED)
    m = pt.assign_reduce(_t(X), _t(w), _t(C), chunk_size=128,
                         mode="matmul")
    np.testing.assert_array_equal(g.sums.numpy(), m.sums.numpy())
    np.testing.assert_array_equal(g.counts.numpy(), m.counts.numpy())
    np.testing.assert_allclose(float(g.sse), float(m.sse), rtol=RTOL)
    np.testing.assert_allclose(g.sse_per_cluster.numpy(),
                               m.sse_per_cluster.numpy(), rtol=RTOL,
                               atol=ATOL)
    piped, flagged2 = pt.reduce_chunks(_t(X), _t(w), _t(C), chunk_size=128,
                                       mode=GUARDED, pipeline=1)
    for f in g._fields:
        np.testing.assert_array_equal(getattr(piped, f).numpy(),
                                      getattr(g, f).numpy())
    assert int(flagged2) == int(flagged)
    labels = pt.assign_labels(_t(X), _t(C), chunk_size=128, mode=GUARDED)
    np.testing.assert_array_equal(
        labels.numpy(), pt.assign_labels(_t(X), _t(C), chunk_size=128,
                                         mode="matmul").numpy())


@pytest.mark.parametrize("host_loop", [True, False])
@pytest.mark.parametrize("policy", ["keep", "resample"])
def test_fit_matches_jax_and_the_matmul_fit(mesh1, host_loop, policy):
    X = _blobs(seed=3)
    kw = dict(k=6, max_iter=20, seed=3, compute_sse=True, verbose=False,
              dtype=np.float64, host_loop=host_loop, empty_cluster=policy)
    jm = kmeans_tpu.KMeans(distance_mode=GUARDED, mesh=mesh1, **kw).fit(X)
    pm = kmeans_tpu_torch.KMeans(distance_mode=GUARDED, device="cpu",
                                 **kw).fit(X)
    mm = kmeans_tpu_torch.KMeans(distance_mode="matmul", device="cpu",
                                 **kw).fit(X)
    assert pm.iterations_run == jm.iterations_run == mm.iterations_run
    np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pm.centroids, mm.centroids)
    np.testing.assert_allclose(pm.sse_history, jm.sse_history, rtol=RTOL)
    np.testing.assert_array_equal(pm.labels_, np.asarray(jm.labels_))
    np.testing.assert_array_equal(pm.cluster_sizes_, jm.cluster_sizes_)
    assert pm.bf16_guard_corrected_rows_ == jm.bf16_guard_corrected_rows_
    assert (pm.bf16_guard_corrected_rows_ is None) == host_loop
    assert pm.loop_path_ == ("host" if host_loop else "device")


def test_device_loop_audit_counts_the_flags_of_its_iterations():
    """One iteration: the audit is the flag count of the init's tile."""
    X, C = _near_ties(n=800, seed=6)
    pm = kmeans_tpu_torch.KMeans(k=C.shape[0], max_iter=1, init=C,
                                 distance_mode=GUARDED, host_loop=False,
                                 device="cpu", verbose=False,
                                 dtype=np.float64, empty_cluster="keep")
    pm.fit(X)
    _, flagged = pt.guarded_assign_chunk(
        _t(X), pt.distance_stage(_t(X), _t(C), mode=GUARDED), _t(C))
    assert pm.bf16_guard_corrected_rows_ == int(flagged) > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_both_loops_give_the_same_bits(dtype):
    X = torch.from_numpy(_blobs(seed=8, dtype=dtype))
    kw = dict(k=6, max_iter=15, seed=1, compute_sse=True, verbose=False,
              dtype=dtype, distance_mode=GUARDED, device="cpu",
              empty_cluster="resample")
    a = kmeans_tpu_torch.KMeans(host_loop=True, **kw).fit(X)
    b = kmeans_tpu_torch.KMeans(host_loop=False, **kw).fit(X)
    assert a.iterations_run == b.iterations_run
    np.testing.assert_array_equal(a.centroids, b.centroids)
    assert a.sse_history == b.sse_history
    outside, _ = _float64_outside(X.numpy(), b.centroids, b.labels_)
    assert outside == 0


def test_predict_transform_score_and_checkpoint(mesh1, tmp_path):
    X = _blobs(seed=9)
    kw = dict(k=6, max_iter=10, seed=2, verbose=False, dtype=np.float64)
    pm = kmeans_tpu_torch.KMeans(distance_mode=GUARDED, device="cpu",
                                 **kw).fit(X)
    ref = kmeans_tpu_torch.KMeans(distance_mode="matmul", device="cpu",
                                  **kw)
    ref.centroids = pm.centroids
    np.testing.assert_array_equal(pm.predict(X), ref.predict(X))
    np.testing.assert_array_equal(pm.transform(X), ref.transform(X))
    np.testing.assert_allclose(pm.score(X), ref.score(X), rtol=RTOL)
    pm.save(tmp_path / "g.npz")
    jm = kmeans_tpu.KMeans.load(tmp_path / "g.npz")
    assert jm.distance_mode == GUARDED
    np.testing.assert_array_equal(np.asarray(jm.predict(X)), pm.predict(X))
    jm.save(tmp_path / "j.npz")
    back = kmeans_tpu_torch.KMeans.load(tmp_path / "j.npz", device="cpu")
    assert back.distance_mode == GUARDED
    np.testing.assert_array_equal(back.predict(X), pm.predict(X))


def test_refusals_match_jax():
    for args in ((GUARDED, 2), (GUARDED, 1, "farthest")):
        with pytest.raises(ValueError) as want:
            jdist._check_guarded(*args)
        with pytest.raises(ValueError) as got:
            dist._check_guarded(*args)
        assert str(got.value) == str(want.value)
    dist._check_guarded("matmul", 2, "farthest")
    with pytest.raises(ValueError, match="data-parallel"):
        kmeans_tpu_torch.KMeans(k=3, device="cpu", distance_mode=GUARDED,
                                model_shards=2)
    for build in (dist.make_step_fn, dist.make_predict_fn):
        build(None, chunk_size=64, mode=GUARDED)
    with pytest.raises(ValueError, match="farthest"):
        dist.make_fit_fn(chunk_size=64, mode=GUARDED, max_iter=3,
                         tolerance=1e-4, empty_policy="farthest")
    with pytest.raises(ValueError, match="farthest"):
        dist.make_multi_fit_fn(chunk_size=64, mode=GUARDED, k_real=3,
                               max_iter=3, tolerance=1e-4, n_init=2,
                               empty_policy="farthest")
