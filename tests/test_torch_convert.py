"""State carried between kmeans_tpu and kmeans_tpu_torch: the state
dictionary (``convert.from_jax_state`` / ``to_jax_state``) and the ``.npz``
checkpoint, in both directions.  A model that crossed over predicts the same
labels as the one that was fitted."""

import json
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu.utils import checkpoint as jx_ckpt  # noqa: E402
from kmeans_tpu_torch import convert  # noqa: E402
from kmeans_tpu_torch.utils import checkpoint as pt_ckpt  # noqa: E402

MODES = [("pallas", "kernel", np.float32), ("matmul", "matmul", np.float64),
         ("auto", "auto", np.float32),
         ("pallas_bf16", "kernel_bf16", np.float32),
         ("matmul_bf16", "matmul_bf16", np.float32)]


def _blobs(n=800, d=6, centers=5, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-4.0, 4.0, size=(centers, d))
    y = rng.integers(0, centers, size=n)
    return (means[y] + 0.5 * rng.standard_normal((n, d))).astype(dtype)


def _fit_jax(mesh1, mode, dtype, **kw):
    X = _blobs(dtype=dtype)
    km = kmeans_tpu.KMeans(k=5, max_iter=6, seed=3, compute_sse=True,
                           mesh=mesh1, host_loop=True, distance_mode=mode,
                           dtype=dtype, verbose=False, **kw).fit(X)
    return km, X, _blobs(n=300, seed=8, dtype=dtype)


@pytest.mark.parametrize("jx_mode,pt_mode,dtype", MODES)
def test_from_jax_state_predicts_the_same(mesh1, jx_mode, pt_mode, dtype):
    jm, X, Q = _fit_jax(mesh1, jx_mode, dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # nothing to drop: no warning
        pm = convert.from_jax_state(jm._state_dict(), device="cpu")
    assert isinstance(pm, kmeans_tpu_torch.KMeans)
    assert pm.distance_mode == pt_mode and pm.dtype == np.dtype(dtype)
    assert (pm.k, pm.max_iter, pm.seed, pm.tolerance) == \
        (jm.k, jm.max_iter, jm.seed, jm.tolerance)
    assert pm.iterations_run == jm.iterations_run
    np.testing.assert_array_equal(pm.centroids, np.asarray(jm.centroids))
    np.testing.assert_allclose(pm.sse_history, jm.sse_history)
    for data in (X, Q):
        np.testing.assert_array_equal(pm.predict(data),
                                      np.asarray(jm.predict(data)))


def test_from_jax_state_warns_once_about_dropped_arguments(mesh1):
    jm, X, _ = _fit_jax(mesh1, "matmul", np.float64)
    state = jm._state_dict()
    state.update(pipeline=1, bucket="auto", host_loop=False)
    with pytest.warns(UserWarning) as caught:
        pm = convert.from_jax_state(state, device="cpu")
    assert len(caught) == 1
    text = str(caught[0].message)
    assert all(name in text for name in ("pipeline", "bucket", "host_loop"))
    np.testing.assert_array_equal(pm.predict(X), np.asarray(jm.predict(X)))


def test_from_jax_state_needs_a_device_here(mesh1):
    jm, _, _ = _fit_jax(mesh1, "matmul", np.float64)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.from_jax_state(jm._state_dict())


@pytest.mark.parametrize("jx_mode,pt_mode,dtype", MODES)
def test_npz_saved_by_jax_loads_in_the_port(mesh1, tmp_path, jx_mode,
                                            pt_mode, dtype):
    jm, X, Q = _fit_jax(mesh1, jx_mode, dtype)
    path = tmp_path / "from_jax.npz"
    jm.save(path)
    pm = kmeans_tpu_torch.KMeans.load(path, device="cpu")
    assert pm.distance_mode == pt_mode
    np.testing.assert_array_equal(pm.centroids, np.asarray(jm.centroids))
    np.testing.assert_array_equal(pm.predict(Q), np.asarray(jm.predict(Q)))


@pytest.mark.parametrize("jx_mode,pt_mode,dtype", MODES)
def test_npz_saved_by_the_port_loads_in_jax(tmp_path, jx_mode, pt_mode,
                                            dtype):
    X = _blobs(dtype=dtype)
    Q = _blobs(n=300, seed=8, dtype=dtype)
    pm = kmeans_tpu_torch.KMeans(k=5, max_iter=6, seed=3, compute_sse=True,
                                 distance_mode=pt_mode, dtype=dtype,
                                 verbose=False, device="cpu").fit(X)
    path = tmp_path / "from_port"            # '.npz' is appended
    pm.save(path)
    jm = kmeans_tpu.KMeans.load(path)
    assert jm.distance_mode == jx_mode and jm.k == 5
    assert jm.iterations_run == pm.iterations_run
    np.testing.assert_array_equal(np.asarray(jm.centroids), pm.centroids)
    np.testing.assert_array_equal(np.asarray(jm.predict(Q)), pm.predict(Q))
    back = kmeans_tpu_torch.KMeans.load(path, device="cpu")
    np.testing.assert_array_equal(back.predict(Q), pm.predict(Q))
    np.testing.assert_allclose(back.sse_history, pm.sse_history)


def test_to_jax_state_round_trip(mesh1, tmp_path):
    X = _blobs()
    pm = kmeans_tpu_torch.KMeans(k=5, max_iter=6, seed=3, verbose=False,
                                 distance_mode="kernel", init=X[:5],
                                 device="cpu").fit(X)
    state = convert.to_jax_state(pm)
    assert state["distance_mode"] == "pallas"
    assert state["model_shards"] == 1 and state["host_loop"] is True
    np.testing.assert_array_equal(state["init_array"], X[:5])
    jx_ckpt.save_state(tmp_path / "via_jax_writer.npz", state)
    jm = kmeans_tpu.KMeans.load(tmp_path / "via_jax_writer.npz")
    np.testing.assert_array_equal(np.asarray(jm.predict(X)), pm.predict(X))
    again = convert.from_jax_state(jm._state_dict(), device="cpu")
    np.testing.assert_array_equal(again.centroids, pm.centroids)
    np.testing.assert_array_equal(again.init, X[:5])


def test_unfitted_model_round_trips(tmp_path):
    pm = kmeans_tpu_torch.KMeans(k=4, device="cpu", init="k-means++")
    pm.save(tmp_path / "empty.npz")
    back = kmeans_tpu_torch.KMeans.load(tmp_path / "empty.npz", device="cpu")
    assert back.centroids is None and back.init == "k-means++"
    with pytest.raises(ValueError):
        back.predict(np.zeros((3, 2), np.float32))


def test_checkpoint_files_have_the_same_layout(tmp_path):
    state = {"centroids": np.arange(6.0).reshape(3, 2), "k": 3,
             "sse_history": [1.0, 0.5], "init": "forgy", "chunk_size": None}
    jx_ckpt.save_state(tmp_path / "a.npz", dict(state))
    pt_ckpt.save_state(tmp_path / "b.npz", dict(state))
    assert pt_ckpt.FORMAT_VERSION == jx_ckpt.FORMAT_VERSION
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(str(a["__meta__"])) == json.loads(str(b["__meta__"]))
    for loader in (jx_ckpt.load_state, pt_ckpt.load_state):
        for name in ("a.npz", "b.npz"):
            got = loader(tmp_path / name)
            assert got["k"] == 3 and got["sse_history"] == [1.0, 0.5]
            np.testing.assert_array_equal(got["centroids"],
                                          state["centroids"])


@pytest.mark.parametrize("version,exc", [(2, ValueError), (0, ValueError),
                                         (None, pt_ckpt.CheckpointCorruptError)])
def test_version_gate(tmp_path, version, exc):
    meta = {"k": 3}
    if version is not None:
        meta["__format_version__"] = version
    path = tmp_path / "v.npz"
    np.savez(path, __meta__=json.dumps(meta), centroids=np.zeros((3, 2)))
    with pytest.raises(exc):
        pt_ckpt.load_state(path)
    with pytest.raises(exc):
        kmeans_tpu_torch.KMeans.load(path, device="cpu")


def test_corrupt_and_missing_files(tmp_path):
    torn = tmp_path / "torn.npz"
    torn.write_bytes(b"PK\x03\x04 not a zip")
    with pytest.raises(pt_ckpt.CheckpointCorruptError) as err:
        pt_ckpt.load_state(torn)
    assert err.value.path == torn
    np.savez(tmp_path / "plain.npz", a=np.zeros(3))
    with pytest.raises(pt_ckpt.CheckpointCorruptError, match="__meta__"):
        pt_ckpt.load_state(tmp_path / "plain.npz")
    with pytest.raises(FileNotFoundError):
        pt_ckpt.load_state(tmp_path / "absent.npz")


# ------------------------------------------------------------ GaussianMixture


def _gmm_data(dtype=np.float64):
    X = _blobs(n=900, d=4, centers=3, seed=4, dtype=dtype)
    rng = np.random.default_rng(2)
    means = X[rng.choice(len(X), 3, replace=False)].astype(np.float64)
    return X, dict(n_components=3, max_iter=6, tol=0.0, means_init=means,
                   weights_init=np.full(3, 1 / 3))


def _fit_jax_gmm(cov_type, dtype):
    X, kw = _gmm_data(dtype)
    prec = np.ones((3, 4)) if cov_type == "diag" else np.ones(3)
    return kmeans_tpu.GaussianMixture(covariance_type=cov_type, dtype=dtype,
                                      precisions_init=prec, **kw).fit(X), X


def _same_gmm(a, b, X):
    for name in ("weights_", "means_", "covariances_", "shift_"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)))
    assert (a.n_iter_, a.converged_, a.lower_bound_) == \
        (b.n_iter_, b.converged_, b.lower_bound_)
    np.testing.assert_array_equal(np.asarray(a.predict(X)),
                                  np.asarray(b.predict(X)))
    np.testing.assert_allclose(np.asarray(a.score_samples(X)),
                               np.asarray(b.score_samples(X)), rtol=1e-5)


@pytest.mark.parametrize("cov_type", ["diag", "spherical"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gmm_npz_saved_by_jax_loads_in_the_port(tmp_path, cov_type, dtype):
    jm, X = _fit_jax_gmm(cov_type, dtype)
    jm.save(tmp_path / "gmm_jax.npz")
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # nothing to drop: no warning
        pm = kmeans_tpu_torch.GaussianMixture.load(tmp_path / "gmm_jax.npz",
                                                   device="cpu")
    assert pm.covariance_type == cov_type and pm.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(pm.means_init, jm.means_init)
    _same_gmm(pm, jm, X)


@pytest.mark.parametrize("cov_type", ["diag", "spherical"])
def test_gmm_npz_saved_by_the_port_loads_in_jax(tmp_path, cov_type):
    X, kw = _gmm_data()
    pm = kmeans_tpu_torch.GaussianMixture(
        covariance_type=cov_type, dtype=np.float64, device="cpu",
        n_init=1, **kw).fit(X)
    path = tmp_path / "gmm_port"             # '.npz' is appended
    pm.save(path)
    jm = kmeans_tpu.GaussianMixture.load(path)
    assert jm.host_loop is True and jm.model_shards == 1
    _same_gmm(jm, pm, X)
    back = kmeans_tpu_torch.GaussianMixture.load(path, device="cpu")
    _same_gmm(back, pm, X)
    np.testing.assert_array_equal(back.weights_init, kw["weights_init"])


def test_gmm_state_dispatch_and_dropped_arguments():
    jm, X = _fit_jax_gmm("diag", np.float64)
    state = jm._state_dict()
    pm = convert.from_jax_state(state, device="cpu")
    assert isinstance(pm, kmeans_tpu_torch.GaussianMixture)
    _same_gmm(pm, jm, X)
    back = convert.to_jax_state(pm)
    assert back["model_class"] == "GaussianMixture"
    assert back["host_loop"] is True and back["model_shards"] == 1
    # The JAX package's device-loop tables and loop options: the tables are
    # read as absent, the options dropped with one warning.
    state.update(host_loop=False, pipeline=1,
                 dev_means_c=np.zeros((3, 4)), dev_cov=np.ones((3, 4)),
                 dev_log_w=np.zeros(3), dev_prev_ll=0.0,
                 dev_cov_type="diag")
    with pytest.warns(UserWarning) as caught:
        again = convert.from_jax_state(state, device="cpu")
    assert len(caught) == 1
    assert "host_loop" in str(caught[0].message)
    assert not any(name.startswith("dev_") for name in vars(again))
    _same_gmm(again, jm, X)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        convert.from_jax_state({"model_class": "BisectingKMeans"},
                               device="cpu")


def test_unfitted_gmm_round_trips(tmp_path):
    pm = kmeans_tpu_torch.GaussianMixture(n_components=2, device="cpu",
                                          covariance_type="spherical")
    pm.save(tmp_path / "empty.npz")
    back = kmeans_tpu_torch.GaussianMixture.load(tmp_path / "empty.npz",
                                                 device="cpu")
    assert back.means_ is None and back.covariance_type == "spherical"
    jm = kmeans_tpu.GaussianMixture.load(tmp_path / "empty.npz")
    assert jm.means_ is None and jm.n_components == 2
    with pytest.raises(ValueError, match="fitted"):
        back.predict(np.zeros((3, 2), np.float32))
