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
         ("matmul_bf16", "matmul_bf16", np.float32),
         ("pallas", "kernel", np.float64),
         ("pallas_bf16", "kernel_bf16", np.float64)]


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
    """The loop options are the port's own since the device loop came, and
    ``bucket`` and ``overlap`` since the warm start: kept, not dropped.
    The port's KMeans now has every argument of the JAX package's, so
    nothing is dropped and nothing warns."""
    import warnings
    jm, X, _ = _fit_jax(mesh1, "matmul", np.float64)
    state = jm._state_dict()
    state.update(pipeline=1, bucket="auto", overlap=0, host_loop=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pm = convert.from_jax_state(state, device="cpu")
    assert pm.host_loop is False and pm.pipeline == 1
    assert pm.bucket == "auto" and pm.overlap == 0
    back = convert.to_jax_state(pm)
    assert back["host_loop"] is False and back["pipeline"] == 1
    assert back["bucket"] == "auto" and back["overlap"] == 0
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


def _clear_of_ties(Q, C, bf16):
    """Rows whose two best scores differ, in float64, by more than
    ``1e-4 (||x||^2 + max ||c||^2)``: with ``bf16`` the scores of the
    bf16-rounded inputs, which both packages' bf16 kernels compare."""
    x, c = Q.astype(np.float64), C.astype(np.float64)
    h2 = (c * c).sum(1)
    if bf16:
        x, c = (torch.from_numpy(a).to(torch.bfloat16).double().numpy()
                for a in (x, c))
    scores = h2[None, :] - 2.0 * x @ c.T
    part = np.partition(scores, 1, axis=1)
    scale = (Q.astype(np.float64) ** 2).sum(1) + h2.max()
    return (part[:, 1] - part[:, 0]) > 1e-4 * scale


@pytest.mark.parametrize("jx_mode,pt_mode,d", [("pallas", "kernel", 6),
                                               ("pallas_bf16", "kernel_bf16",
                                                128)])
def test_float64_npz_of_a_kernel_mode_loads_and_predicts(mesh1, tmp_path,
                                                         jx_mode, pt_mode, d):
    """The JAX package fits float64 in its kernel modes on float32 casts;
    the port loads such a file as it is (float64 centroids, the kernel
    mode) and predicts the JAX model's labels on every row clear of a tie.
    Unclustered normal rows, so that many rows lie near a boundary."""
    rng = np.random.default_rng(4)
    X = rng.standard_normal((600, d))
    Q = rng.standard_normal((400, d))
    jm = kmeans_tpu.KMeans(k=7, max_iter=4, seed=3, compute_sse=True,
                           mesh=mesh1, host_loop=True, distance_mode=jx_mode,
                           dtype=np.float64, verbose=False).fit(X)
    path = tmp_path / "float64.npz"
    jm.save(path)
    pm = kmeans_tpu_torch.KMeans.load(path, device="cpu")
    assert pm._mode() == pt_mode and pm.dtype == np.float64
    assert pm.centroids.dtype == np.float64
    np.testing.assert_array_equal(pm.centroids, np.asarray(jm.centroids))
    clear = _clear_of_ties(Q, pm.centroids, bf16=pt_mode == "kernel_bf16")
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(pm.predict(Q)[clear],
                                  np.asarray(jm.predict(Q))[clear])


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
    # The model's own loop options, the JAX package's defaults here.
    assert state["model_shards"] == 1 and state["host_loop"] == "auto"
    assert state["pipeline"] == "auto"
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
    # The JAX package's device-loop tables and loop options: the tables
    # (``dev_*``) are the port's own since its device EM loop checkpoints
    # its carry, read and written back as they came; the loop options and
    # ``bucket`` / ``overlap`` are kept and not dropped; the model axis it
    # was written on (``model_shards``, ROADMAP A.18 is ported) is read
    # without a warning, the topology being information only as for
    # ``KMeans``: the model loads on the mesh it is given, here none.
    state.update(host_loop=False, pipeline=1, bucket="auto", overlap=0,
                 model_shards=2,
                 dev_means_c=np.zeros((3, 4)), dev_cov=np.ones((3, 4)),
                 dev_log_w=np.zeros(3), dev_prev_ll=0.0,
                 dev_cov_type="diag")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = convert.from_jax_state(state, device="cpu")
    assert again.model_shards == 1 and again.mesh is None
    assert again.host_loop is False and again.pipeline == 1
    assert again.bucket == "auto" and again.overlap == 0
    back = convert.to_jax_state(again)
    assert back["host_loop"] is False and back["pipeline"] == 1
    assert back["bucket"] == "auto" and back["overlap"] == 0
    assert not any(name.startswith("dev_") for name in vars(again))
    for name in ("dev_means_c", "dev_cov", "dev_log_w"):
        np.testing.assert_array_equal(back[name], state[name])
    assert back["dev_prev_ll"] == 0.0 and back["dev_cov_type"] == "diag"
    _same_gmm(again, jm, X)
    # ProductQuantizer is ported (ROADMAP A.11): a fitted JAX quantizer's
    # attributes carry into the port's class, which encodes as it does.
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(256, 8))
    jpq = kmeans_tpu.ProductQuantizer(m=4, k=8, seed=3, max_iter=5,
                                      dtype=np.float64).fit(rows)
    ppq = convert.from_jax_state(convert.pq_state(jpq), device="cpu")
    assert isinstance(ppq, kmeans_tpu_torch.ProductQuantizer)
    np.testing.assert_array_equal(ppq.codebooks_, jpq.codebooks_)
    np.testing.assert_array_equal(ppq.encode(rows), jpq.encode(rows))
    assert convert.to_jax_state(ppq)["model_class"] == "ProductQuantizer"
    with pytest.raises(ValueError, match="unknown model_class"):
        convert.from_jax_state({"model_class": "NoSuchModel"},
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


@pytest.mark.parametrize("jx_mode,dtype", [("matmul", np.float64),
                                           ("pallas", np.float32)])
def test_npz_saved_by_jax_on_a_2x2_mesh_loads_without_a_mesh(
        tmp_path, jx_mode, dtype):
    """A checkpoint written under a (data 2, model 2) mesh carries its
    topology block; the port loads it on one device and predicts the same
    labels (the state is the whole table, whatever mesh wrote it)."""
    import jax
    from kmeans_tpu.parallel.mesh import make_mesh
    X = _blobs(dtype=dtype)
    jm = kmeans_tpu.KMeans(k=5, max_iter=8, seed=3, verbose=False,
                           distance_mode=jx_mode, dtype=dtype,
                           mesh=make_mesh(data=2, model=2,
                                          devices=jax.devices()[:4])).fit(X)
    path = tmp_path / "mesh2x2.npz"
    jm.save(path)
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
    assert (meta["meta_mesh_data_shards"], meta["meta_mesh_model_shards"],
            meta["model_shards"]) == (2, 2, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pm = kmeans_tpu_torch.KMeans.load(path, device="cpu")
    assert pm.mesh is None and pm.model_shards == 1
    np.testing.assert_array_equal(pm.centroids, np.asarray(jm.centroids))
    np.testing.assert_array_equal(pm.predict(X), np.asarray(jm.predict(X)))


def test_a_port_checkpoint_carries_the_topology_block(tmp_path):
    pm = kmeans_tpu_torch.KMeans(k=3, device="cpu", verbose=False,
                                 dtype=np.float64).fit(_blobs(centers=3))
    pm.save(tmp_path / "m.npz")
    state = pt_ckpt.load_state(tmp_path / "m.npz")
    assert {key: state[key] for key in state if key.startswith("meta_")} == {
        "meta_format_version": 1, "meta_mesh_data_shards": None,
        "meta_mesh_model_shards": None, "meta_dtype": "float64"}
    jm = kmeans_tpu.KMeans.load(tmp_path / "m.npz")
    np.testing.assert_array_equal(np.asarray(jm.centroids), pm.centroids)
