"""kmeans_tpu_torch.ops.assign against kmeans_tpu.ops.assign on the CPU.

The same inputs, made with ``np.random.default_rng(seed)``, go through the
JAX functions and their torch counterparts.

Tolerances:

* float64: labels and counts equal; distances, sums, SSE ``rtol=1e-12``
  (the two frameworks sum in another order, a few ulp apart).
* float32: labels equal wherever the float64 margin between the best and
  the second best centroid exceeds ``1e-4 * (||x||^2 + ||c||^2)`` (inside
  that band a float32 rounding may pick either); sums and SSE ``rtol=1e-5``
  (summation order differs between XLA and torch).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu.ops import assign as jx  # noqa: E402
from kmeans_tpu_torch.ops import assign as pt  # noqa: E402

SHAPES = [(257, 5, 7), (512, 40, 96), (1000, 17, 300), (2000, 40, 300)]
DTYPES = [np.float64, np.float32]


def _case(n, d, k, dtype, seed=0, weighted=True):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * 3).astype(dtype)
    C = (rng.normal(size=(k, d)) * 3).astype(dtype)
    if weighted:
        w = rng.uniform(0.5, 2.0, size=n).astype(dtype)
        w[rng.choice(n, n // 10, replace=False)] = 0.0
    else:
        w = np.ones(n, dtype)
    return X, w, C


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _clear_rows(X, C):
    """Rows whose float64 margin between best and second best clears the
    float32 band."""
    x = X.astype(np.float64)
    c = C.astype(np.float64)
    d2 = ((x * x).sum(1)[:, None] + (c * c).sum(1)[None, :] - 2 * x @ c.T)
    part = np.partition(d2, 1, axis=1)
    margin = part[:, 1] - part[:, 0]
    scale = (x * x).sum(1) + (c * c).sum(1).max()
    return margin > 1e-4 * scale


def _pad(X, w, chunk):
    pad = (-X.shape[0]) % chunk
    Xp = np.concatenate([X, np.zeros((pad, X.shape[1]), X.dtype)])
    wp = np.concatenate([w, np.zeros(pad, w.dtype)])
    return Xp, wp


@pytest.mark.parametrize("mode", ["matmul", "direct"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d,k", SHAPES[:3])
def test_pairwise_sq_dists_matches_jax(n, d, k, dtype, mode):
    X, _, C = _case(n, d, k, dtype)
    ref = np.asarray(jx.pairwise_sq_dists(X, C, mode=mode))
    got = pt.pairwise_sq_dists(_t(X), _t(C), mode=mode).numpy()
    assert got.dtype == ref.dtype == dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    else:
        # The expanded form cancels: absolute error scales with the norms.
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d,k", SHAPES)
def test_assign_reduce_matches_jax(n, d, k, dtype, weighted):
    X, w, C = _case(n, d, k, dtype, seed=n + k, weighted=weighted)
    chunk = 128
    Xp, wp = _pad(X, w, chunk)
    ref = jx.assign_reduce(Xp, wp, C, chunk_size=chunk, mode="matmul")
    got = pt.assign_reduce(_t(X), _t(w), _t(C), chunk_size=chunk,
                           mode="matmul")
    clear = _clear_rows(X, C)
    if dtype == np.float64 or clear.all():
        if weighted:
            np.testing.assert_allclose(got.counts.numpy(),
                                       np.asarray(ref.counts),
                                       rtol=1e-12 if dtype == np.float64
                                       else 1e-5)
        else:
            np.testing.assert_array_equal(got.counts.numpy(),
                                          np.asarray(ref.counts))
        rtol = 1e-12 if dtype == np.float64 else 1e-5
        scale = float(np.abs(np.asarray(ref.sums)).max())
        np.testing.assert_allclose(got.sums.numpy(), np.asarray(ref.sums),
                                   rtol=rtol, atol=rtol * scale)
        np.testing.assert_allclose(got.sse_per_cluster.numpy(),
                                   np.asarray(ref.sse_per_cluster),
                                   rtol=max(rtol, 1e-10) * 10,
                                   atol=rtol * float(ref.sse))
    rtol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(float(got.sse), float(ref.sse), rtol=rtol)
    np.testing.assert_allclose(float(got.farthest_dist),
                               float(ref.farthest_dist),
                               rtol=1e-10 if dtype == np.float64 else 1e-4)
    if dtype == np.float64:
        np.testing.assert_array_equal(got.farthest_point.numpy(),
                                      np.asarray(ref.farthest_point))


@pytest.mark.parametrize("mode", ["matmul", "direct"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d,k", SHAPES[:3])
def test_assign_labels_matches_jax(n, d, k, dtype, mode):
    X, _, C = _case(n, d, k, dtype, seed=3)
    ref = np.asarray(jx.assign_labels(X, C, chunk_size=128, mode=mode))
    got = pt.assign_labels(_t(X), _t(C), chunk_size=128, mode=mode).numpy()
    assert got.dtype == np.int32 and got.shape == (n,)
    if dtype == np.float64:
        np.testing.assert_array_equal(got, ref)
    else:
        clear = _clear_rows(X, C)
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(got[clear], ref[clear])


@pytest.mark.parametrize("dtype", DTYPES)
def test_assign_chunk_need_min_and_ties(dtype):
    X = np.array([[1.0, 1.0], [2.0, 0.0]], dtype)
    C = np.array([[1.0, 1.0], [1.0, 1.0], [5.0, 5.0]], dtype)
    ref_l, ref_m = jx.assign_chunk(X, C)
    got_l, got_m = pt.assign_chunk(_t(X), _t(C))
    np.testing.assert_array_equal(got_l.numpy(), [0, 0])   # lowest index
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), rtol=1e-6)
    assert pt.assign_chunk(_t(X), _t(C), need_min=False)[1] is None


def test_zero_weight_rows_are_inert():
    X, w, C = _case(300, 9, 11, np.float64)
    w[:] = 1.0
    w[250:] = 0.0
    got = pt.assign_reduce(_t(X), _t(w), _t(C), chunk_size=64)
    head = pt.assign_reduce(_t(X[:250]), _t(w[:250]), _t(C), chunk_size=64)
    assert float(got.counts.sum()) == 250
    np.testing.assert_allclose(got.sums.numpy(), head.sums.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(float(got.sse), float(head.sse), rtol=1e-12)


def test_need_flags_keep_initial_values():
    X, w, C = _case(200, 6, 9, np.float64)
    got = pt.assign_reduce(_t(X), _t(w), _t(C), chunk_size=64,
                           need_sse=False, need_farthest=False,
                           need_sse_pc=False)
    assert float(got.sse) == 0.0 and float(got.farthest_dist) == -1.0
    assert float(got.sse_per_cluster.abs().sum()) == 0.0
    full = pt.assign_reduce(_t(X), _t(w), _t(C), chunk_size=64)
    np.testing.assert_array_equal(got.sums.numpy(), full.sums.numpy())


@pytest.mark.parametrize("mode", ["matmul_bf16_guarded"])
def test_later_modes_raise(mode):
    """The guarded rung is ported, but not as a tile mode: its name raises
    the JAX package's ValueError in ``pairwise_sq_dists`` (the rung's tile
    is ``distance_stage``'s)."""
    X, _, C = _case(16, 4, 3, np.float32)
    with pytest.raises(ValueError, match="unknown distance mode"):
        pt.pairwise_sq_dists(_t(X), _t(C), mode=mode)
    with pytest.raises(ValueError, match="unknown distance mode"):
        jx.pairwise_sq_dists(X, C, mode=mode)
    np.testing.assert_array_equal(
        pt.distance_stage(_t(X), _t(C), mode=mode).numpy(),
        pt.pairwise_sq_dists(_t(X), _t(C), mode="matmul_bf16").numpy())


def test_unknown_mode_raises():
    X, _, C = _case(16, 4, 3, np.float32)
    with pytest.raises(ValueError):
        pt.pairwise_sq_dists(_t(X), _t(C), mode="nope")
