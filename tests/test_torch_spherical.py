"""kmeans_tpu_torch.SphericalKMeans against kmeans_tpu.SphericalKMeans on the
CPU, and the family's own invariants.

The same rows (made with ``np.random.default_rng``), seed and arguments go
through ``kmeans_tpu.SphericalKMeans(mesh=mesh1, host_loop=True)`` and
``kmeans_tpu_torch.SphericalKMeans(device='cpu')``, in 'pallas' / 'kernel'
(the Pallas kernels in interpret mode against the plain versions of the
CUDA kernels) and in 'matmul'.

Tolerances: float64 'matmul' is the float64 parity class (labels, counts
and iterations equal; centroids and ``sse_history`` to ``rtol=1e-12``,
``atol=1e-10``).  The kernel modes compute their sums in float32 even for
float64 rows (the kernels are a float32 engine in both packages), so
float64 'kernel' holds labels, counts and iterations equal, centroids to
``atol=1e-6`` and the SSE (the algebraic form over float32 sums) to
``rtol=1e-5``; float32 'kernel' is the float32 class (labels equal on these
well separated directions, centroids ``atol=1e-5``, SSE ``rtol=1e-5``).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu_torch import convert  # noqa: E402
from kmeans_tpu_torch import SphericalKMeans  # noqa: E402
from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402

# (JAX arguments, port arguments, centroid atol and rtol, SSE rtol).
PATHS = {
    "kernel_f32": (dict(distance_mode="pallas"),
                   dict(distance_mode="kernel"), 1e-5, 1e-5, 1e-5),
    "kernel_f64": (dict(distance_mode="pallas", dtype=np.float64),
                   dict(distance_mode="kernel", dtype=np.float64), 1e-6,
                   1e-6, 1e-5),
    "matmul_f64": (dict(distance_mode="matmul", dtype=np.float64),
                   dict(distance_mode="matmul", dtype=np.float64), 1e-10,
                   1e-12, 1e-12),
}


def _cones(seed=0, n_per=150, d=3, dtype=np.float64):
    """Tight cones around the axes with random lengths (the length is
    noise to a spherical model)."""
    rng = np.random.default_rng(seed)
    X, y = [], []
    for j in range(d):
        v = np.eye(d)[j][None, :] + rng.normal(scale=0.05, size=(n_per, d))
        X.append(v * rng.uniform(0.1, 100.0, size=(n_per, 1)))
        y.append(np.full(n_per, j))
    return np.concatenate(X).astype(dtype), np.concatenate(y)


def _embeddings(seed=1, n=1200, d=16, centers=6, dtype=np.float64):
    """Directions around random centres, lengths spread over 3 decades."""
    rng = np.random.default_rng(seed)
    dirs = rng.standard_normal((centers, d))
    y = rng.integers(0, centers, size=n)
    X = dirs[y] + 0.3 * rng.standard_normal((n, d))
    X *= rng.uniform(0.1, 100.0, size=(n, 1))
    return X.astype(dtype), y


def _normalize(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _port(**kw):
    return SphericalKMeans(device="cpu", verbose=False, **kw)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("init", ["forgy", "k-means++"])
def test_fit_matches_the_jax_package(mesh1, path, init):
    jx_kw, pt_kw, atol, rtol, sse_rtol = PATHS[path]
    dtype = pt_kw.get("dtype", np.float32)
    X, _ = _embeddings(dtype=dtype)
    common = dict(k=6, max_iter=30, seed=3, compute_sse=True, init=init,
                  empty_cluster="keep", verbose=False)
    jm = kmeans_tpu.SphericalKMeans(mesh=mesh1, host_loop=True, **jx_kw,
                                    **common).fit(X)
    pm = kmeans_tpu_torch.SphericalKMeans(device="cpu", **pt_kw,
                                          **common).fit(X)
    assert pm.iterations_run == jm.iterations_run
    np.testing.assert_array_equal(pm.cluster_sizes_, jm.cluster_sizes_)
    np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(pm.sse_history, jm.sse_history,
                               rtol=sse_rtol)
    np.testing.assert_array_equal(pm.predict(X), np.asarray(jm.predict(X)))
    np.testing.assert_array_equal(pm.labels_, np.asarray(jm.labels_))
    assert pm.centroids.dtype == np.asarray(jm.centroids).dtype


@pytest.mark.parametrize("mode", ["kernel", "matmul"])
@pytest.mark.parametrize("n_init", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_loop_equals_the_host_loop(mode, n_init, dtype):
    """The projection's device form (``project='sphere'``) and the host
    hook run the same arithmetic: both loops give the same bits."""
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(3000, 8))
         + 2.0 * rng.integers(0, 5, size=(3000, 1))).astype(dtype)
    kw = dict(k=5, max_iter=25, seed=42, compute_sse=True, dtype=dtype,
              n_init=n_init, init="forgy", distance_mode=mode)
    host = _port(host_loop=True, **kw).fit(X)
    dev = _port(host_loop=False, **kw).fit(X)
    assert dev.loop_path_ == "device" and host.loop_path_ == "host"
    assert dev.iterations_run == host.iterations_run
    np.testing.assert_array_equal(dev.centroids, host.centroids)
    np.testing.assert_array_equal(dev.sse_history, host.sse_history)
    np.testing.assert_array_equal(dev.labels_, host.labels_)
    if n_init > 1:
        assert dev.best_restart_ == host.best_restart_
        np.testing.assert_array_equal(dev.restart_inertias_,
                                      host.restart_inertias_)
    np.testing.assert_allclose(np.linalg.norm(dev.centroids, axis=1), 1.0,
                               atol=10 * np.finfo(dtype).eps)


def test_device_loop_resample_on_a_dataset_without_a_host_copy():
    """'resample' refills inside the spherical device loop: the refilled
    rows are normalised data rows, projected again; the host loop on a
    dataset without a host copy draws the same rows."""
    X, _ = _cones(seed=13)
    init = np.concatenate([_normalize(X[:2]), [[0.0, 0.0, -1.0]]])

    def run(host_loop):
        km = _port(k=3, max_iter=10, seed=3, init=init,
                   empty_cluster="resample", dtype=np.float64,
                   host_loop=host_loop, compute_sse=True)
        ds = km.cache(X)
        ds._host, ds._host_weights = None, None
        return km.fit(ds)

    host, dev = run(True), run(False)
    assert dev.iterations_run == host.iterations_run
    np.testing.assert_array_equal(dev.centroids, host.centroids)


def test_recovers_directional_clusters():
    X, y = _cones()
    km = _port(k=3, seed=1, compute_sse=True, dtype=np.float64).fit(X)
    np.testing.assert_allclose(np.linalg.norm(km.centroids, axis=1), 1.0,
                               atol=1e-12)
    assert set(np.argmax(km.centroids, axis=1)) == {0, 1, 2}
    labels = km.predict(X)
    for j in range(3):
        assert len(np.unique(labels[y == j])) == 1


def test_scale_invariance():
    X, _ = _cones(seed=3)
    scales = np.random.default_rng(4).uniform(0.01, 1000.0,
                                              size=(X.shape[0], 1))
    km = _port(k=3, seed=2, dtype=np.float64).fit(X)
    np.testing.assert_array_equal(km.predict(X), km.predict(X * scales))


def test_sse_is_chordal():
    X, _ = _cones(seed=5)
    km = _port(k=3, seed=0, compute_sse=True, dtype=np.float64).fit(X)
    hist = np.asarray(km.sse_history)
    assert np.all(np.diff(hist) <= 1e-6)
    cos = _normalize(X) @ km.centroids.T
    assert np.isclose(-km.score(X), float(np.sum(2.0 - 2.0 * cos.max(1))),
                      rtol=1e-10)


def test_transform_is_chordal_against_cosine():
    X, _ = _cones(seed=6)
    km = _port(k=3, seed=0, dtype=np.float64).fit(X)
    D = km.transform(X[:20])
    cos = _normalize(X[:20]) @ km.centroids.T
    np.testing.assert_allclose(1.0 - D ** 2 / 2.0, cos, atol=1e-10)
    blocks = np.concatenate(list(km.transform_stream(
        lambda: iter([X[:7], X[7:20]]))))
    np.testing.assert_allclose(blocks, D, atol=1e-12)


def test_zero_rows_tolerated():
    X, _ = _cones(seed=7)
    X[10] = 0.0
    km = _port(k=3, seed=0, dtype=np.float64).fit(X)
    assert np.all(np.isfinite(km.centroids))
    ds = km.cache(X)
    assert float(ds.points[10].abs().sum()) == 0.0
    assert km.predict(X).shape == (X.shape[0],)


def test_zero_mean_keeps_previous_direction():
    km = _port(k=2, dtype=np.float64)
    new = np.array([[0.0, 0.0], [3.0, 4.0]])
    prev = np.array([[0.0, 1.0], [1.0, 0.0]])
    out = km._postprocess_centroids(new, prev=prev)
    np.testing.assert_allclose(out[0], [0.0, 1.0])
    np.testing.assert_allclose(out[1], [0.6, 0.8])
    # The device form: the same rule, and sentinel rows stay as they are.
    real = torch.tensor([True, True, False])
    t_new = torch.tensor([[0.0, 0.0], [3.0, 4.0], [1e12, 1e12]],
                         dtype=torch.float64)
    t_prev = torch.tensor([[0.0, 1.0], [1.0, 0.0], [1e12, 1e12]],
                          dtype=torch.float64)
    got = dist.project_centroids(t_new, t_prev, real, "sphere").numpy()
    np.testing.assert_allclose(got, [[0.0, 1.0], [0.6, 0.8], [1e12, 1e12]])
    with pytest.raises(ValueError, match="projection"):
        dist.project_centroids(t_new, t_prev, real, "cube")


def test_foreign_dataset_rejected():
    X, _ = _cones(seed=10)
    foreign = kmeans_tpu_torch.KMeans(k=3, dtype=np.float64,
                                      device="cpu").cache(X)
    km = _port(k=3, dtype=np.float64)
    with pytest.raises(ValueError, match="row-normalized"):
        km.fit(foreign)
    own = km.cache(X)
    km.fit(own)
    assert np.all(np.isfinite(km.centroids))
    # A tensor on the model's device is normalised there.
    t = km.cache(torch.from_numpy(X))
    np.testing.assert_allclose(t.points.numpy(), _normalize(X), atol=1e-15)


def test_host_hook_without_its_tag_stays_on_the_host_loop():
    class Custom(SphericalKMeans):
        def _postprocess_centroids(self, centroids, prev=None):
            return super()._postprocess_centroids(centroids, prev)

    X, _ = _cones(seed=11)
    assert SphericalKMeans(k=3, device="cpu")._device_hooks()
    custom = Custom(k=3, device="cpu", verbose=False, host_loop=False)
    assert not custom._device_hooks()
    with pytest.raises(ValueError, match="host_loop=True"):
        custom.fit(X)


def test_sweep(mesh1):
    X, _ = _embeddings(seed=2, n=600, centers=4, dtype=np.float64)
    km = _port(k=3, seed=0, dtype=np.float64, max_iter=20, n_init=2,
               init="forgy")
    res = km.sweep(X, k_range=[2, 3, 4, 5], criterion="silhouette")
    seq = km.sweep(X, k_range=[2, 3, 4, 5], criterion="silhouette",
                   batched=0)
    assert res.selected_k == seq.selected_k
    np.testing.assert_allclose(res.member_scores, seq.member_scores,
                               rtol=1e-12)
    np.testing.assert_allclose(res.scores, seq.scores, rtol=1e-12)
    best = res.best_model
    assert isinstance(best, SphericalKMeans)
    np.testing.assert_allclose(np.linalg.norm(best.centroids, axis=1), 1.0,
                               atol=1e-12)
    jx = kmeans_tpu.SphericalKMeans(k=3, seed=0, dtype=np.float64,
                                    max_iter=20, n_init=2, init="forgy",
                                    mesh=mesh1, verbose=False,
                                    distance_mode="matmul")
    jres = jx.sweep(X, k_range=[2, 3, 4, 5], criterion="silhouette")
    assert jres.selected_k == res.selected_k
    np.testing.assert_allclose(res.member_scores, jres.member_scores,
                               rtol=1e-9)


def test_unported_surfaces_name_their_items():
    km = _port(k=2)
    # fit_stream is ported (ROADMAP A.10): an empty stream is refused.
    with pytest.raises(ValueError, match="FRESH iterable"):
        km.fit_stream(lambda: iter([]))
    with pytest.raises(NotImplementedError, match="A.12"):
        km.fitted_state()
    with pytest.raises(NotImplementedError, match="A.13"):
        km._quality_rows(np.zeros((2, 2)))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_round_trip(tmp_path, mesh1, direction):
    X, _ = _cones(seed=8)
    path = tmp_path / "sph.npz"
    if direction == "port_to_jax":
        src = _port(k=3, seed=9, dtype=np.float64, compute_sse=True).fit(X)
        src.save(path)
        other = kmeans_tpu.SphericalKMeans.load(path)
        assert isinstance(other, kmeans_tpu.SphericalKMeans)
    else:
        src = kmeans_tpu.SphericalKMeans(k=3, seed=9, dtype=np.float64,
                                         mesh=mesh1, verbose=False,
                                         compute_sse=True).fit(X)
        src.save(path)
        other = SphericalKMeans.load(path, device="cpu")
        assert isinstance(other, SphericalKMeans)
    np.testing.assert_array_equal(np.asarray(other.centroids),
                                  np.asarray(src.centroids))
    np.testing.assert_array_equal(np.asarray(other.predict(X[:50])),
                                  np.asarray(src.predict(X[:50])))
    back = convert.from_jax_state(src._state_dict(),
                                  device="cpu")
    assert isinstance(back, SphericalKMeans)


def test_the_default_device_is_the_card():
    """Without ``device`` the model runs on the card, or raises where
    there is none: it never runs on the CPU unasked."""
    if torch.cuda.is_available():
        assert SphericalKMeans(k=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SphericalKMeans(k=2)
