"""kmeans_tpu_torch.BisectingKMeans against kmeans_tpu.BisectingKMeans on the
CPU, and the family's own invariants.

The same rows and weights (made with ``np.random.default_rng``), seed and
arguments go through ``kmeans_tpu.BisectingKMeans(mesh=mesh1,
host_loop=True)`` and ``kmeans_tpu_torch.BisectingKMeans(device='cpu')``.
Every split's 2-means draws its init and its refills from the same host
generators in both packages, so in float64 'matmul' the trees are the same:
``labels_``, ``cluster_sizes_`` and ``iterations_run`` equal, centroids,
``cluster_sse_`` and ``sse_history`` to ``rtol=1e-12`` / ``atol=1e-10``
(the float64 parity class).  In the kernel modes (float32 sums) the same
tree, centroids to ``atol=1e-4`` and the SSE to ``rtol=1e-4``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu_torch import BisectingKMeans, KMeans, convert  # noqa: E402
from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402
from kmeans_tpu_torch.utils import faults  # noqa: E402

# (JAX arguments, port arguments, centroid atol, SSE and centroid rtol).
PATHS = {
    "matmul_f64": (dict(distance_mode="matmul", dtype=np.float64),
                   dict(distance_mode="matmul", dtype=np.float64), 1e-10,
                   1e-12),
    "kernel_f32": (dict(distance_mode="pallas"),
                   dict(distance_mode="kernel"), 1e-4, 1e-4),
}


def _blobs(n=1200, d=4, centers=6, seed=7, std=0.7, dtype=np.float64):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-8.0, 8.0, size=(centers, d))
    y = rng.integers(0, centers, size=n)
    return (means[y] + std * rng.standard_normal((n, d))).astype(dtype), y


def _port(**kw):
    return BisectingKMeans(device="cpu", verbose=False, **kw)


def _sse(X, centroids, labels, w=None):
    r = ((X.astype(np.float64) - centroids.astype(np.float64)[labels]) ** 2
         ).sum(1)
    return float(np.sum(r if w is None else w * r))


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("strategy", ["biggest_sse", "largest_cluster"])
@pytest.mark.parametrize("weighted", [False, True])
def test_tree_matches_the_jax_package(mesh1, path, strategy, weighted):
    jx_kw, pt_kw, atol, rtol = PATHS[path]
    X, _ = _blobs(dtype=pt_kw.get("dtype", np.float32))
    w = None
    if weighted:
        w = np.random.default_rng(3).uniform(0.5, 2.0, size=X.shape[0])
        w[::7] = 0.0
    common = dict(k=6, max_iter=40, seed=3, compute_sse=True,
                  bisecting_strategy=strategy, verbose=False)
    jm = kmeans_tpu.BisectingKMeans(mesh=mesh1, host_loop=True, **jx_kw,
                                    **common).fit(X, sample_weight=w)
    pm = BisectingKMeans(device="cpu", **pt_kw, **common).fit(
        X, sample_weight=w)
    assert pm.iterations_run == jm.iterations_run == 5
    np.testing.assert_array_equal(pm.labels_, np.asarray(jm.labels_))
    np.testing.assert_allclose(pm.cluster_sizes_, jm.cluster_sizes_,
                               rtol=rtol)
    np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(pm.cluster_sse_, jm.cluster_sse_, rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(pm.sse_history, jm.sse_history, rtol=rtol)
    np.testing.assert_array_equal(pm.predict(X), np.asarray(jm.predict(X)))


def test_invariants_of_the_tree():
    X, _ = _blobs()
    model = _port(k=6, max_iter=50, compute_sse=True, seed=3,
                  dtype=np.float64).fit(X)
    assert model.centroids.shape == (6, 4)
    assert set(np.unique(model.labels_)) == set(range(6))
    np.testing.assert_allclose(model.cluster_sizes_,
                               np.bincount(model.labels_, minlength=6))
    total = _sse(X, model.centroids, model.labels_)
    assert np.isclose(model.cluster_sse_.sum(), total, rtol=1e-10)
    assert np.all(np.diff(model.sse_history) <= 1e-6)
    assert np.isclose(model.sse_history[-1], total, rtol=1e-10)


def test_weights_mask_points():
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(0, 0.1, (100, 2)),
                        rng.normal(5, 0.1, (100, 2)),
                        rng.normal((0, 9), 0.1, (50, 2))])
    w = np.ones(250)
    w[200:] = 0.0
    model = _port(k=2, seed=0, dtype=np.float64).fit(X, sample_weight=w)
    cents = model.centroids[np.argsort(model.centroids[:, 0])]
    np.testing.assert_allclose(cents[0], [0, 0], atol=0.1)
    np.testing.assert_allclose(cents[1], [5, 5], atol=0.1)


@pytest.mark.parametrize("mode", ["kernel", "matmul"])
def test_k1_is_the_weighted_mean_far_from_the_origin(mesh1, mode):
    """k = 1: the weighted mean from one pass at a zero centroid, its SSE
    from one 'direct' pass (the variance identity would cancel in float32
    this far from the origin)."""
    rng = np.random.default_rng(4)
    X = rng.normal(loc=5000.0, size=(2048, 8)).astype(np.float32)
    model = _port(k=1, compute_sse=True, distance_mode=mode).fit(X)
    mu = X.astype(np.float64).mean(axis=0)
    expect = float(np.sum((X.astype(np.float64) - mu) ** 2))
    assert model.iterations_run == 0 and model.cluster_sse_[0] >= 0
    assert np.isclose(model.sse_history[-1], expect, rtol=1e-3)
    np.testing.assert_allclose(model.centroids[0], mu, rtol=1e-5)
    jm = kmeans_tpu.BisectingKMeans(k=1, compute_sse=True, mesh=mesh1,
                                    verbose=False).fit(X)
    np.testing.assert_allclose(model.centroids, np.asarray(jm.centroids),
                               rtol=1e-5)
    assert np.isclose(model.cluster_sse_[0], jm.cluster_sse_[0], rtol=1e-4)


@pytest.mark.parametrize("mode", ["kernel", "matmul"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_loop_inner_fits_equal_the_host_loop(mode, dtype):
    X, _ = _blobs(dtype=dtype)
    kw = dict(k=6, seed=3, dtype=dtype, distance_mode=mode, compute_sse=True)
    host = _port(host_loop=True, **kw).fit(X)
    dev = _port(host_loop=False, **kw).fit(X)
    assert host.loop_path_ == "host" and dev.loop_path_ == "device"
    np.testing.assert_array_equal(dev.labels_, host.labels_)
    np.testing.assert_array_equal(dev.centroids, host.centroids)
    np.testing.assert_array_equal(dev.cluster_sse_, host.cluster_sse_)
    np.testing.assert_array_equal(dev.sse_history, host.sse_history)


def test_two_runs_give_the_same_tree():
    X, _ = _blobs(seed=9, n=2000, centers=8)
    a = _port(k=8, seed=1, distance_mode="kernel").fit(X)
    b = _port(k=8, seed=1, distance_mode="kernel").fit(X)
    np.testing.assert_array_equal(a.labels_, b.labels_)
    np.testing.assert_array_equal(a.cluster_sse_, b.cluster_sse_)
    np.testing.assert_array_equal(a.centroids, b.centroids)


def test_per_cluster_sse_is_summed_in_a_fixed_order():
    """``cluster_sums`` against a float64 sum per label, at k = 2 (the
    split's pass) and at a k whose one-hot tile is cut into blocks."""
    rng = np.random.default_rng(5)
    labels = torch.from_numpy(rng.integers(0, 2, size=5000).astype(np.int32))
    values = torch.from_numpy(rng.uniform(0, 10, size=5000))
    got = dist.cluster_sums(labels, values, 2)
    want = np.bincount(labels.numpy(), weights=values.numpy(), minlength=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    k = dist.CLUSTER_SUM_ELEMS // 1000 + 3       # blocks of 999 rows
    labels = torch.from_numpy(rng.integers(0, k, size=4000).astype(np.int32))
    got = dist.cluster_sums(labels, values[:4000], k)
    want = np.bincount(labels.numpy(), weights=values[:4000].numpy(),
                       minlength=k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    x = torch.from_numpy(rng.normal(size=(300, 5)))
    w = torch.from_numpy(rng.uniform(0.5, 2.0, size=300))
    c = torch.from_numpy(rng.normal(size=(2, 5)))
    st = dist.local_stats(x, w, c, chunk_size=300, mode="kernel")[0]
    lab = np.argmin(((x.numpy()[:, None] - c.numpy()[None]) ** 2).sum(-1), 1)
    d2 = ((x.numpy() - c.numpy()[lab]) ** 2).sum(1)
    np.testing.assert_allclose(
        st.sse_per_cluster.numpy(),
        np.bincount(lab, weights=w.numpy() * d2, minlength=2), rtol=1e-5)


def test_with_weights_keeps_no_memo_of_its_parent():
    X, _ = _blobs(n=400)
    km = KMeans(k=3, device="cpu", dtype=np.float64, distance_mode="kernel")
    ds = km.cache(X)
    full = float(dist.dataset_sqnorm(ds))
    assert ds.positive_count() == 400
    w = np.zeros(400)
    w[:100] = 2.0
    sub = ds.with_weights(w)
    assert sub.points is ds.points                    # the points are shared
    assert float(dist.dataset_sqnorm(sub)) == pytest.approx(
        float(2.0 * (X[:100].astype(np.float32) ** 2).sum()), rel=1e-6)
    assert float(dist.dataset_sqnorm(ds)) == full      # the parent's memo
    assert sub.positive_count() == 100
    np.testing.assert_array_equal(sub.host_weights, w)
    np.testing.assert_array_equal(sub.weights.numpy(), w)
    # The SSE of a fit on the masked rows is of those rows only.
    fit = KMeans(k=2, device="cpu", dtype=np.float64, compute_sse=True,
                 distance_mode="kernel", verbose=False, seed=0).fit(sub)
    st = fit._sse(sub)
    lab = fit.predict(X[:100])
    assert st == pytest.approx(_sse(X[:100], fit.centroids, lab,
                                    np.full(100, 2.0)), rel=1e-5)
    with pytest.raises(ValueError, match="shape"):
        ds.with_weights(np.ones(3))


def test_a_dropped_dataset_frees_its_loops():
    """A device loop kept in a dataset's memo holds no reference back to the
    dataset, so the loop (on the card, its captured graph) is freed with
    the dataset by reference counting, the cyclic collector off: the Lloyd
    loop, the restarts' loop and the mini-batch loop, and the loop of every
    split of a bisecting fit, whose masked datasets live for one split."""
    import gc
    import weakref

    from kmeans_tpu_torch import MiniBatchKMeans
    X, _ = _blobs(n=600)
    kw = dict(k=3, max_iter=5, seed=0, device="cpu", verbose=False,
              host_loop=False)

    def live():
        return sum(issubclass(type(o), dist._DeviceLoop)
                   for o in gc.get_objects())

    gc.collect()
    gc.disable()
    try:
        before = live()
        for make in (lambda: KMeans(empty_cluster="resample", **kw),
                     lambda: KMeans(n_init=3, init="forgy", **kw),
                     lambda: MiniBatchKMeans(batch_size=64, **kw)):
            model = make()
            ds = model.cache(X)
            model.fit(ds)
            assert live() == before + 1
            gone = weakref.ref(ds)
            del ds, model
            assert gone() is None and live() == before
        bk = _port(k=4, seed=1, host_loop=False).fit(X)
        assert len(bk.split_iterations_) == 3 and live() == before
    finally:
        gc.enable()


def test_unsplittable_raises():
    X = np.ones((20, 3))
    with pytest.raises(RuntimeError, match="Cannot bisect"):
        _port(k=3, dtype=np.float64).fit(X)


def test_unported_arguments_name_their_items(tmp_path):
    """Checkpoints are ported (ROADMAP A.9): ``resume=True`` without a
    split tree raises the JAX package's error, and a fit checkpointed at
    every split, killed after split 1 and resumed from its file, builds the
    uninterrupted tree; ``fit_stream`` and ``sweep`` still raise."""
    X, _ = _blobs(n=100)
    with pytest.raises(ValueError, match="split-boundary checkpoint"):
        _port(k=2).fit(X, resume=True)
    full = _port(k=3).fit(X)
    path = tmp_path / "c"
    with faults.inject_kill_after_iteration(1):
        with pytest.raises(faults.SimulatedPreemption):
            _port(k=3).fit(X, checkpoint_every=1, checkpoint_path=path)
    resumed = _port(k=3).fit(X, resume=path)
    assert resumed.iterations_run == full.iterations_run == 2
    np.testing.assert_array_equal(resumed.centroids, full.centroids)
    np.testing.assert_array_equal(resumed.labels_, full.labels_)
    np.testing.assert_array_equal(resumed.cluster_sse_, full.cluster_sse_)
    # A refusal by design, with the JAX package's message.
    with pytest.raises(NotImplementedError) as want:
        kmeans_tpu.BisectingKMeans(k=3, verbose=False).fit_stream(lambda: iter([]))
    with pytest.raises(NotImplementedError) as got:
        _port(k=3).fit_stream(lambda: iter([]))
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="sweep"):
        _port(k=2).sweep(X, k_range=[2, 3])
    with pytest.raises(ValueError, match="bisecting_strategy"):
        _port(k=2, bisecting_strategy="smallest")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross(tmp_path, mesh1, direction):
    X, _ = _blobs()
    path = tmp_path / "bis.npz"
    kw = dict(k=4, seed=2, dtype=np.float64, compute_sse=True, verbose=False,
              bisecting_strategy="largest_cluster", distance_mode="matmul")
    if direction == "jax_to_port":
        src = kmeans_tpu.BisectingKMeans(mesh=mesh1, **kw).fit(X)
        src.save(path)
        other = BisectingKMeans.load(path, device="cpu")
        assert isinstance(other, BisectingKMeans)
        again = convert.from_jax_state(src._state_dict(), device="cpu")
        assert isinstance(again, BisectingKMeans)
        assert again.bisecting_strategy == "largest_cluster"
    else:
        src = BisectingKMeans(device="cpu", **kw).fit(X)
        src.save(path)
        other = kmeans_tpu.BisectingKMeans.load(path)
    assert other.bisecting_strategy == "largest_cluster"
    np.testing.assert_array_equal(np.asarray(other.centroids),
                                  np.asarray(src.centroids))
    np.testing.assert_array_equal(np.asarray(other.predict(X)),
                                  np.asarray(src.predict(X)))


def test_the_default_device_is_the_card():
    """Without ``device`` the model runs on the card, or raises where
    there is none: it never runs on the CPU unasked."""
    if torch.cuda.is_available():
        assert BisectingKMeans(k=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BisectingKMeans(k=2)
