"""Batched restarts of the port (``parallel.distributed.make_multi_fit_fn``,
``KMeans(n_init > 1, host_loop=False)``) on the CPU.

Oracles:

* the port's own single fits (``make_fit_fn``), one per member with the
  member's seed, on the same dataset: every member bit-equal (centroids,
  iterations, SSE and shift histories, counts) in every mode, float32 and
  float64; a sweep member padded to k_max with sentinel rows bit-equal to
  its single fit at its own k;
* the JAX package's ``n_init`` device loop in float64: labels, counts,
  iterations and ``best_restart_`` equal, centroids and restart inertias to
  ``rtol=1e-12``, ``atol=1e-10`` (its 'resample' draws come from its own
  PRNG, so the policies compared there draw nothing).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu_torch.models.kmeans import \
    NumericalDivergenceError  # noqa: E402
from kmeans_tpu_torch.ops import assign as pt  # noqa: E402
from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402
from kmeans_tpu_torch.parallel.sharding import Dataset  # noqa: E402

RTOL, ATOL = 1e-12, 1e-10
#: (distance mode, dtype) of the bit-equality tests: every torch mode, both
#: kernel modes (their plain versions here) and the guarded rung.
MODES = [("matmul", np.float64), ("matmul", np.float32),
         ("matmul_bf16", np.float32), ("direct", np.float64),
         ("kernel", np.float32), ("kernel", np.float64),
         ("kernel_bf16", np.float32),
         ("matmul_bf16_guarded", np.float64)]


def _blobs(n=900, d=6, centers=5, seed=0, dtype=np.float64, std=0.7):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-4.0, 4.0, size=(centers, d))
    y = rng.integers(0, centers, size=n)
    return (means[y] + std * rng.standard_normal((n, d))).astype(dtype)


def _dataset(X, w=None):
    """A dataset without a host copy: both loops draw with the device
    engine."""
    x = torch.from_numpy(X)
    w = torch.ones(X.shape[0], dtype=x.dtype) if w is None else \
        torch.from_numpy(w.astype(X.dtype))
    return Dataset(x, w)


def _inits(X, k, members, dups=3, seed=0):
    """One init per member, each with ``dups`` copies of one row at its
    head (forced empties) and other rows after it."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(members):
        rows = rng.choice(X.shape[0], k - dups + 1, replace=False)
        out.append(X[[rows[0]] * dups + list(rows[1:])])
    return np.stack(out)


def _single(ds, c0, seed, *, mode, policy, max_iter=12, tol=1e-4,
            chunk=128):
    fit = dist.make_fit_fn(chunk_size=chunk, mode=mode, max_iter=max_iter,
                           tolerance=tol, empty_policy=policy)
    return fit(ds, torch.from_numpy(c0), seed)


def _multi(ds, c0, seeds, *, mode, policy, max_iter=12, tol=1e-4,
           chunk=128, k_reals=None):
    fit = dist.make_multi_fit_fn(chunk_size=chunk, mode=mode,
                                 k_real=c0.shape[1], max_iter=max_iter,
                                 tolerance=tol, empty_policy=policy,
                                 n_init=c0.shape[0], k_reals=k_reals,
                                 return_all=True)
    return fit(ds, torch.from_numpy(c0), seeds)


def _assert_member(res, r, one, k=None):
    k = res.centroids.shape[1] if k is None else k
    n = one.n_iters
    assert int(res.n_iters[r]) == n
    assert bool(res.finite[r]) == one.finite
    np.testing.assert_array_equal(res.centroids[r, :k].numpy(),
                                  one.centroids.numpy())
    np.testing.assert_array_equal(res.sse_history[r, :n], one.sse_history)
    np.testing.assert_array_equal(res.shift_history[r, :n],
                                  one.shift_history)
    np.testing.assert_array_equal(res.counts[r, :k], one.counts)


@pytest.mark.parametrize("mode,dtype,policy", [
    (mode, dtype, policy) for mode, dtype in MODES
    for policy in ("keep", "farthest", "resample")
    # The guarded rung refuses 'farthest' (test_torch_guarded.py).
    if not (mode == "matmul_bf16_guarded" and policy == "farthest")])
def test_members_are_bit_equal_to_single_fits(mode, dtype, policy):
    X = _blobs(seed=1, dtype=dtype)
    ds = _dataset(X)
    c0 = _inits(X, 7, 3)
    seeds = [5, 17, 2024]
    res = _multi(ds, c0, seeds, mode=mode, policy=policy)
    assert res.launched == int(res.n_iters.max())
    for r, seed in enumerate(seeds):
        _assert_member(res, r, _single(ds, c0[r], seed, mode=mode,
                                       policy=policy))
    if mode == "matmul_bf16_guarded":
        assert res.flagged == sum(
            _single(ds, c0[r], s, mode=mode, policy=policy).flagged
            for r, s in enumerate(seeds))
    else:
        assert res.flagged is None


@pytest.mark.parametrize("mode,dtype", MODES)
def test_sweep_members_at_their_own_k(mode, dtype):
    """Members padded to k_max with sentinel rows, each bit-equal to a
    single fit at its own k; the sentinel rows stay as they were."""
    X = _blobs(seed=2, dtype=dtype)
    ds = _dataset(X)
    rng = np.random.default_rng(3)
    ks = [2, 4, 7, 7]
    k_max = max(ks)
    c0 = np.full((len(ks), k_max, X.shape[1]), dist.PAD_CENTROID_VALUE,
                 dtype)
    singles = []
    for r, k in enumerate(ks):
        c0[r, :k] = X[rng.choice(X.shape[0], k, replace=False)]
        singles.append(_single(ds, c0[r, :k].copy(), r, mode=mode,
                               policy="resample"))
    res = _multi(ds, c0, list(range(len(ks))), mode=mode, policy="resample",
                 k_reals=ks)
    for r, k in enumerate(ks):
        _assert_member(res, r, singles[r], k)
        assert (res.centroids[r, k:] == dist.PAD_CENTROID_VALUE).all()
        assert (res.counts[r, k:] == 0).all()


def test_converged_members_are_frozen():
    X = _blobs(seed=4)
    ds = _dataset(X)
    c0 = _inits(X, 5, 4, dups=1, seed=2)
    res = _multi(ds, c0, [0, 1, 2, 3], mode="matmul", policy="keep",
                 max_iter=60, tol=1e-6)
    assert len(set(res.n_iters.tolist())) > 1
    assert res.launched == int(res.n_iters.max()) < 60
    for r in range(4):
        n = int(res.n_iters[r])
        assert res.shift_history[r, n - 1] < 1e-6
        assert (res.sse_history[r, n:] == 0).all()
        assert (res.shift_history[r, n:] == 0).all()


@pytest.mark.parametrize("policy,dups", [("keep", 1), ("keep", 3),
                                         ("farthest", 2)])
@pytest.mark.parametrize("init", ["forgy", "kmeans++"])
def test_n_init_matches_the_jax_device_loop(mesh1, policy, dups, init):
    X = _blobs(seed=5)
    kw = dict(k=6, max_iter=20, seed=11, n_init=3, compute_sse=True,
              dtype=np.float64, distance_mode="matmul", verbose=False,
              empty_cluster=policy, host_loop=False)
    if dups > 1:
        kw.update(init=lambda X_, k, s: np.asarray(X_)[
            [s % 50] * dups + list(range(100, 100 + k - dups))], n_init=3)
    else:
        kw["init"] = init
    jm = kmeans_tpu.KMeans(mesh=mesh1, **kw).fit(X)
    pm = kmeans_tpu_torch.KMeans(device="cpu", **kw).fit(X)
    assert pm.loop_path_ == "device" and jm.loop_path_ == "device-multi"
    assert pm.best_restart_ == jm.best_restart_
    assert pm.iterations_run == jm.iterations_run
    np.testing.assert_allclose(pm.restart_inertias_, jm.restart_inertias_,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pm.sse_history, jm.sse_history, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(pm.cluster_sizes_, jm.cluster_sizes_)
    np.testing.assert_array_equal(pm.labels_, np.asarray(jm.labels_))


@pytest.mark.parametrize("mode,dtype", [("kernel", np.float32),
                                        ("kernel_bf16", np.float32),
                                        ("matmul", np.float64)])
def test_n_init_device_loop_equals_the_host_loop(mode, dtype):
    X = torch.from_numpy(_blobs(seed=6, dtype=dtype))
    kw = dict(k=6, max_iter=15, seed=3, n_init=4, compute_sse=True,
              dtype=dtype, distance_mode=mode, verbose=False, device="cpu",
              empty_cluster="resample")
    host = kmeans_tpu_torch.KMeans(host_loop=True, **kw).fit(X)
    dev = kmeans_tpu_torch.KMeans(host_loop=False, **kw).fit(X)
    assert dev.best_restart_ == host.best_restart_
    np.testing.assert_array_equal(dev.restart_inertias_,
                                  host.restart_inertias_)
    np.testing.assert_array_equal(dev.centroids, host.centroids)
    assert dev.sse_history == host.sse_history
    np.testing.assert_array_equal(dev.labels_, host.labels_)
    assert len(dev.iter_times_) == dev.iterations_run


def test_kernel_members_share_the_points(monkeypatch):
    """The kernel modes launch kernel 1 per member on the dataset's own
    points: no (R, n, D) copy (the JAX package's ``lax.map`` route)."""
    X = _blobs(seed=7, dtype=np.float32)
    ds = _dataset(X)
    seen = []
    real = dist.fused_assign_reduce

    def spy(points, weights, centroids, **kw):
        seen.append((points.data_ptr(), tuple(points.shape),
                     tuple(centroids.shape)))
        return real(points, weights, centroids, **kw)

    monkeypatch.setattr(dist, "fused_assign_reduce", spy)
    c0 = _inits(X, 5, 3, dups=1)
    res = _multi(ds, c0, [1, 2, 3], mode="kernel", policy="keep",
                 max_iter=4)
    assert len(seen) == 3 * res.launched + 3      # loop, then final pass
    assert {s[0] for s in seen} == {ds.points.data_ptr()}
    assert {s[1] for s in seen} == {tuple(ds.points.shape)}
    assert {s[2] for s in seen} == {(5, X.shape[1])}


def test_a_diverging_member_raises_like_the_host_loop():
    X = _blobs(seed=8)
    X[10, 0] = np.nan
    w = np.ones(X.shape[0])
    w[10] = 0.0
    kw = dict(k=4, max_iter=5, n_init=3, verbose=False, device="cpu",
              distance_mode="kernel", compute_sse=True)
    errors = []
    for host_loop in (True, False):
        with pytest.raises(NumericalDivergenceError) as err:
            kmeans_tpu_torch.KMeans(host_loop=host_loop, **kw).fit(
                X, sample_weight=w)
        errors.append(err.value)
    assert errors[0].iteration == errors[1].iteration == 1


def test_arguments_are_checked_as_in_jax():
    base = dict(chunk_size=64, mode="matmul", k_real=4, max_iter=3,
                tolerance=1e-4, n_init=2)
    with pytest.raises(ValueError, match="k_reals must have shape"):
        dist.make_multi_fit_fn(k_reals=[1, 2, 3], **base)
    with pytest.raises(ValueError, match=r"k_reals entries must be in"):
        dist.make_multi_fit_fn(k_reals=[0, 4], **base)
    with pytest.raises(ValueError, match="on-device loop supports"):
        dist.make_multi_fit_fn(empty_policy="drop", **base)
    fit = dist.make_multi_fit_fn(**base)
    X = _blobs(n=50, seed=9)
    with pytest.raises(ValueError, match="centroids0 must be"):
        fit(_dataset(X), torch.from_numpy(X[:4]), [1, 2])


@pytest.mark.parametrize("mode,tile", [("matmul", "matmul"),
                                       ("kernel", "matmul"),
                                       ("kernel_bf16", "matmul_bf16"),
                                       ("matmul_bf16_guarded", "matmul")])
def test_multi_predict_labels_each_model(mode, tile):
    X = _blobs(n=700, seed=10, dtype=np.float32)
    rng = np.random.default_rng(0)
    stack = np.full((3, 6, X.shape[1]), dist.PAD_CENTROID_VALUE,
                    np.float32)
    for m, k in enumerate((3, 6, 4)):
        stack[m, :k] = X[rng.choice(700, k, replace=False)]
    labels = dist.make_multi_predict_fn(chunk_size=128, mode=mode,
                                        n_models=3)(
        torch.from_numpy(X), torch.from_numpy(stack))
    assert labels.shape == (3, 700) and labels.dtype == torch.int32
    for m in range(3):
        want = pt.assign_labels(torch.from_numpy(X),
                                torch.from_numpy(stack[m]), chunk_size=128,
                                mode=tile)
        np.testing.assert_array_equal(labels[m].numpy(), want.numpy())
