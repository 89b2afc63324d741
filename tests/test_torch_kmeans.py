"""The first slice of the port as a whole: kmeans_tpu_torch.KMeans against
kmeans_tpu.KMeans on the CPU.

The same ``X`` (made with ``np.random.default_rng(seed)``), seed and
arguments go through ``kmeans_tpu.KMeans(mesh=mesh1, host_loop=True,
distance_mode='pallas')`` (the Pallas kernels in interpret mode) and
``kmeans_tpu_torch.KMeans(device='cpu', distance_mode='kernel')`` (the plain
versions of the CUDA kernels), and again through ``'matmul'`` at float64.

Tolerances: the initial centroids are the same rows, so they are equal;
``iterations_run`` equal; centroids ``atol=1e-4`` (float32: sums taken in
another order) / ``1e-10`` (float64); ``sse_history`` ``rtol=1e-5``;
``predict`` labels equal (the fixtures are blobs, whose rows sit clear of
every boundary).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu.models import init as jx_init  # noqa: E402
from kmeans_tpu_torch.models import init as pt_init  # noqa: E402
from kmeans_tpu_torch.models.kmeans import _LATER_ARGS  # noqa: E402
from kmeans_tpu_torch.parallel.sharding import Dataset  # noqa: E402

# (JAX arguments, port arguments, centroid atol) of the two compared paths.
PATHS = {
    "kernel_f32": (dict(distance_mode="pallas"),
                   dict(distance_mode="kernel"), 1e-4),
    "matmul_f64": (dict(distance_mode="matmul", dtype=np.float64),
                   dict(distance_mode="matmul", dtype=np.float64), 1e-10),
}


def _blobs(n=1500, d=8, centers=6, seed=0, dtype=np.float32, std=0.6):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-4.0, 4.0, size=(centers, d))
    y = rng.integers(0, centers, size=n)
    X = means[y] + std * rng.standard_normal((n, d))
    return X.astype(dtype)


def _pair(mesh1, path, **kw):
    jx_kw, pt_kw, atol = PATHS[path]
    common = dict(verbose=False, **kw)
    jm = kmeans_tpu.KMeans(mesh=mesh1, host_loop=True, **jx_kw, **common)
    pm = kmeans_tpu_torch.KMeans(device="cpu", **pt_kw, **common)
    return jm, pm, atol


def _data(path, **kw):
    dtype = np.float64 if path == "matmul_f64" else np.float32
    return _blobs(dtype=dtype, **kw)


def _assert_same_fit(jm, pm, atol):
    assert pm.iterations_run == jm.iterations_run
    np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids),
                               atol=atol, rtol=0)
    assert pm.centroids.dtype == np.asarray(jm.centroids).dtype
    np.testing.assert_allclose(pm.sse_history, jm.sse_history, rtol=1e-5)
    np.testing.assert_array_equal(pm.cluster_sizes_, jm.cluster_sizes_)


@pytest.mark.parametrize("k", [3, 40])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("strategy", ["forgy", "kmeans++"])
def test_initial_centroids_are_the_same_rows(strategy, weighted, k):
    X = _blobs(n=600, seed=5)
    w = None
    if weighted:
        w = np.random.default_rng(1).uniform(0.0, 2.0, 600)
        w[::7] = 0.0
    fn = {"forgy": "forgy_init", "kmeans++": "kmeanspp_init"}[strategy]
    ref = getattr(jx_init, fn)(jx_init.as_source(X, w), k, 42)
    got = getattr(pt_init, fn)(pt_init.as_source(X, w), k, 42)
    np.testing.assert_array_equal(got, np.asarray(ref))
    ds = kmeans_tpu_torch.KMeans(k=k, device="cpu").cache(X, sample_weight=w)
    np.testing.assert_array_equal(pt_init.resolve_init(strategy, ds, k, 42),
                                  np.asarray(ref))


@pytest.mark.parametrize("init", ["forgy", "k-means++"])
@pytest.mark.parametrize("path", list(PATHS))
def test_fit_and_predict_match_jax(mesh1, path, init):
    X = _data(path, seed=3)
    jm, pm, atol = _pair(mesh1, path, k=6, max_iter=25, seed=42,
                         compute_sse=True, init=init)
    jm.fit(X)
    pm.fit(X)
    _assert_same_fit(jm, pm, atol)
    assert pm.iterations_run < 25          # converged, not cut
    Q = _data(path, n=700, seed=9)
    np.testing.assert_array_equal(pm.predict(Q), np.asarray(jm.predict(Q)))
    np.testing.assert_array_equal(pm.labels_, np.asarray(jm.labels_))
    assert pm.predict(Q).dtype == np.int32
    np.testing.assert_allclose(pm.score(Q), jm.score(Q), rtol=1e-5)
    assert pm.n_iter_ == jm.n_iter_
    np.testing.assert_allclose(pm.inertia_, jm.inertia_, rtol=1e-5)
    assert pm.cluster_centers_ is pm.centroids


@pytest.mark.parametrize("policy", ["keep", "farthest", "resample"])
@pytest.mark.parametrize("path", list(PATHS))
def test_empty_cluster_policies_match_jax(mesh1, path, policy):
    X = _data(path, seed=11)
    init = X[[10, 10, 10, 200, 300]].copy()   # duplicates: two start empty
    jm, pm, atol = _pair(mesh1, path, k=5, max_iter=8, seed=7,
                         compute_sse=True, init=init, empty_cluster=policy)
    jm.fit(X)
    pm.fit(X)
    _assert_same_fit(jm, pm, atol)
    # The first iteration meets the two empty duplicates (ties go to the
    # lowest index) and applies the policy.
    _, first, _ = _pair(mesh1, path, k=5, max_iter=1, seed=7, init=init,
                        empty_cluster=policy)
    first.fit(X)
    assert (first.cluster_sizes_ == 0).sum() == 2
    kept = (first.centroids[1:3] == init[1:3]).all(axis=1)
    assert kept.all() if policy == "keep" else not kept.any()


@pytest.mark.parametrize("path", list(PATHS))
def test_n_init_picks_the_same_restart(mesh1, path):
    X = _data(path, centers=8, seed=21)
    jm, pm, atol = _pair(mesh1, path, k=8, max_iter=6, seed=5, n_init=3,
                         compute_sse=True)
    jm.fit(X)
    pm.fit(X)
    assert pm.best_restart_ == jm.best_restart_
    np.testing.assert_allclose(pm.restart_inertias_, jm.restart_inertias_,
                               rtol=1e-5)
    assert len(set(np.round(pm.restart_inertias_, 3))) > 1
    _assert_same_fit(jm, pm, atol)


@pytest.mark.parametrize("path", list(PATHS))
def test_sample_weight_matches_jax(mesh1, path):
    X = _data(path, seed=13)
    w = np.random.default_rng(2).uniform(0.0, 3.0, X.shape[0])
    w[::9] = 0.0
    jm, pm, atol = _pair(mesh1, path, k=6, max_iter=10, seed=42,
                         compute_sse=True)
    jm.fit(X, sample_weight=w)
    pm.fit(X, sample_weight=w)
    assert pm.iterations_run == jm.iterations_run
    np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(pm.sse_history, jm.sse_history, rtol=1e-5)
    np.testing.assert_array_equal(pm.labels_, np.asarray(jm.labels_))


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("case", ["k=0", "predict_before_fit", "nan_data",
                                  "n<k", "1-D", "bad_weights"])
def test_error_paths_raise_the_same_types(mesh1, package, case):
    def make(**kw):
        if package == "jax":
            return kmeans_tpu.KMeans(mesh=mesh1, host_loop=True,
                                     distance_mode="matmul", verbose=False,
                                     **kw)
        return kmeans_tpu_torch.KMeans(device="cpu", verbose=False, **kw)

    X = _blobs(n=100, d=3, centers=3)
    with pytest.raises(ValueError):
        if case == "k=0":
            make(k=0)
        elif case == "predict_before_fit":
            make(k=3).predict(X)
        elif case == "nan_data":
            bad = X.copy()
            bad[:, 1] = np.nan
            make(k=3).fit(bad)
        elif case == "n<k":
            make(k=101).fit(X)
        elif case == "1-D":
            make(k=3).fit(X[:, 0])
        else:
            make(k=3).fit(X, sample_weight=-np.ones(100))


def test_nan_row_among_the_data_is_a_divergence_error():
    X = _blobs(n=200, d=3, centers=3)
    X[150, 0] = np.nan          # not drawn by Forgy with seed 42
    km = kmeans_tpu_torch.KMeans(k=3, device="cpu", verbose=False)
    with pytest.raises(ValueError, match="NaN or Inf detected in centroids"):
        km.fit(X)


@pytest.mark.parametrize("arg,value", [
    ("mesh", object()), ("model_shards", 2), ("host_loop", False),
    ("pipeline", 1), ("bucket", "auto"), ("overlap", 1), ("ingest", "slab"),
    ("k_shard", 2), ("assign", "two_level"), ("coarse_cells", 8),
    ("nprobe", 2), ("init_cap", 512), ("init", "k-means||"),
    ("distance_mode", "matmul_bf16_guarded")])
def test_unported_arguments_raise(arg, value):
    X = _blobs(n=100, d=3, centers=3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kmeans_tpu_torch.KMeans(k=3, device="cpu", verbose=False,
                                **{arg: value}).fit(X)


@pytest.mark.parametrize("kw", [dict(resume=True),
                                dict(checkpoint_every=2,
                                     checkpoint_path="x.npz")])
def test_unported_fit_arguments_raise(kw):
    X = _blobs(n=100, d=3, centers=3)
    km = kmeans_tpu_torch.KMeans(k=3, device="cpu", verbose=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        km.fit(X, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        km.fit_stream(lambda: iter([X]))


def test_arguments_that_name_what_the_port_does_are_taken():
    taken = {name: allowed[0] for name, (allowed, _) in _LATER_ARGS.items()}
    km = kmeans_tpu_torch.KMeans(k=3, device="cpu", **taken)
    assert not any(hasattr(km, name) for name in taken)
    with pytest.raises(TypeError):
        kmeans_tpu_torch.KMeans(k=3, device="cpu", no_such_argument=1)


def test_distance_mode_resolution():
    km = kmeans_tpu_torch.KMeans(k=3, device="cpu")
    assert km.distance_mode == "auto" and km._mode() == "matmul"
    assert kmeans_tpu_torch.KMeans(
        k=3, device="cpu", distance_mode="pallas").distance_mode == "kernel"
    with pytest.raises(ValueError, match="float32"):
        kmeans_tpu_torch.KMeans(k=3, device="cpu", distance_mode="kernel",
                                dtype=np.float64)
    with pytest.raises(ValueError):
        kmeans_tpu_torch.KMeans(k=3, device="cpu", distance_mode="nope")
    with pytest.raises(ValueError):
        kmeans_tpu_torch.KMeans(k=3, device="cpu", dtype=np.float16)


def test_n_init_auto_and_validation():
    assert kmeans_tpu_torch.KMeans(k=3, device="cpu",
                                   n_init="auto").n_init == 10
    assert kmeans_tpu_torch.KMeans(k=3, device="cpu", n_init="auto",
                                   init="k-means++").n_init == 1
    for bad in (0, "many"):
        with pytest.raises(ValueError):
            kmeans_tpu_torch.KMeans(k=3, device="cpu", n_init=bad)
    with pytest.raises(ValueError):
        kmeans_tpu_torch.KMeans(k=3, device="cpu", empty_cluster="drop")


def test_compute_labels_false_and_fit_predict():
    X = _blobs(n=400, d=4, centers=4)
    km = kmeans_tpu_torch.KMeans(k=4, device="cpu", verbose=False,
                                 compute_labels=False).fit(X)
    with pytest.raises(AttributeError, match="compute_labels=False"):
        km.labels_
    with pytest.raises(AttributeError):
        kmeans_tpu_torch.KMeans(k=4, device="cpu").labels_
    km2 = kmeans_tpu_torch.KMeans(k=4, device="cpu", verbose=False)
    labels = km2.fit_predict(X)
    np.testing.assert_array_equal(labels, km2.predict(X))
    assert km2._fit_ds is None              # fit lets go of its dataset


@pytest.mark.parametrize("mode", ["kernel", "matmul", "direct"])
def test_inputs_tensor_dataset_and_callable_init(mode):
    X = _blobs(n=500, d=5, centers=4, seed=2)
    kw = dict(k=4, seed=1, device="cpu", verbose=False, distance_mode=mode,
              compute_sse=True)
    base = kmeans_tpu_torch.KMeans(**kw).fit(X)
    from_tensor = kmeans_tpu_torch.KMeans(**kw).fit(torch.from_numpy(X))
    np.testing.assert_array_equal(from_tensor.centroids, base.centroids)
    km = kmeans_tpu_torch.KMeans(**kw)
    ds = km.cache(X)
    assert isinstance(ds, Dataset) and ds.n == 500 and ds.d == 5
    np.testing.assert_array_equal(km.fit(ds).centroids, base.centroids)
    np.testing.assert_array_equal(km.predict(ds), base.predict(X))
    picked = kmeans_tpu_torch.KMeans(
        **{**kw, "init": lambda data, k, seed: data[:k]}).fit(X)
    explicit = kmeans_tpu_torch.KMeans(**{**kw, "init": X[:4]}).fit(X)
    np.testing.assert_array_equal(picked.centroids, explicit.centroids)
    with pytest.raises(ValueError, match="explicit init must have shape"):
        kmeans_tpu_torch.KMeans(**{**kw, "init": X[:3]}).fit(X)


def test_dataset_without_host_copy_samples_on_the_device():
    """A tensor that already lies on the model's device is used as it is
    (no host copy); seeding and resampling then read the device."""
    X = torch.from_numpy(_blobs(n=300, d=4, centers=3, seed=4))
    w = np.ones(300)
    w[:50] = 0.0
    km = kmeans_tpu_torch.KMeans(k=3, device="cpu", verbose=False)
    ds = km.cache(X, sample_weight=w)
    assert ds.host is None and ds.points.data_ptr() == X.data_ptr()
    np.testing.assert_array_equal(ds.positive_rows(), np.arange(50, 300))
    rows = ds.sample_positive_rows(5, [42, 1])
    again = ds.sample_positive_rows(5, [42, 1])
    np.testing.assert_array_equal(rows, again)       # seeded
    assert rows.shape == (5, 4)
    assert all((X[50:].numpy() == r.astype(np.float32)).all(1).any()
               for r in rows)
    assert ds.sample_positive_rows(500, [1]).shape == (250, 4)
    for init in ("forgy", "k-means++"):
        fit = kmeans_tpu_torch.KMeans(k=3, device="cpu", verbose=False,
                                      init=init).fit(ds)
        assert np.isfinite(fit.centroids).all()


def test_verbose_log_lines_match_jax(mesh1, capsys):
    X = _blobs(n=300, d=3, centers=3, dtype=np.float64)
    kw = dict(k=3, max_iter=4, seed=42, compute_sse=True, verbose=True,
              distance_mode="matmul", dtype=np.float64)
    kmeans_tpu.KMeans(mesh=mesh1, host_loop=True, **kw).fit(X)
    ref = capsys.readouterr().out
    kmeans_tpu_torch.KMeans(device="cpu", **kw).fit(X)
    got = capsys.readouterr().out
    assert got == ref and "Starting K-Means with k=3" in got
