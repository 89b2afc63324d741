"""The rest of ``KMeans``'s surface on the CPU against the JAX package:
``transform``, ``transform_stream`` and ``fit_transform``; ``get_params``,
``set_params`` and ``get_feature_names_out``; pickling, ``deepcopy`` and the
``labels_`` setter.

Both models hold the same centroids (the JAX model is loaded from the port
model's checkpoint), so ``transform`` compares one distance pass with the
other: float64 to ``rtol=1e-9``, float32 and bf16 on the squared distances
to ``rtol=1e-4`` plus ``1e-5`` of ``||x||^2 + ||c||^2`` (the expanded form
cancels, and the two sum in another order).
"""

import copy
import pickle

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402


def _blobs(n=900, d=7, centers=5, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-4.0, 4.0, size=(centers, d))
    y = rng.integers(0, centers, size=n)
    return (means[y] + 0.7 * rng.standard_normal((n, d))).astype(dtype)


def _models(tmp_path, mode="matmul", dtype=np.float64, k=6):
    X = _blobs(dtype=dtype)
    pm = kmeans_tpu_torch.KMeans(k=k, max_iter=8, verbose=False,
                                 distance_mode=mode, dtype=dtype,
                                 device="cpu").fit(X)
    pm.save(tmp_path / "m.npz")
    jm = kmeans_tpu.KMeans.load(tmp_path / "m.npz")
    np.testing.assert_array_equal(np.asarray(jm.centroids), pm.centroids)
    return pm, jm, X


def _assert_distances(got, want, X, C, dtype):
    assert got.shape == want.shape and got.dtype == np.dtype(dtype)
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
        return
    scale = (X.astype(np.float64) ** 2).sum(1)[:, None] + \
        (C.astype(np.float64) ** 2).sum(1)[None, :]
    g2, w2 = got.astype(np.float64) ** 2, want.astype(np.float64) ** 2
    assert np.all(np.abs(g2 - w2) <= 1e-4 * w2 + 1e-5 * scale)


@pytest.mark.parametrize("mode,dtype", [("matmul", np.float64),
                                        ("kernel", np.float32),
                                        ("kernel_bf16", np.float32),
                                        ("direct", np.float64)])
def test_transform_matches_jax(tmp_path, mode, dtype):
    pm, jm, X = _models(tmp_path, mode, dtype)
    got = pm.transform(X)
    _assert_distances(got, np.asarray(jm.transform(X)), X, pm.centroids,
                      dtype)
    assert (got >= 0).all()
    blocks = pm.transform(X, block_rows=128)
    _assert_distances(blocks, got, X, pm.centroids, dtype)
    _assert_distances(blocks, np.asarray(jm.transform(X, block_rows=128)),
                      X, pm.centroids, dtype)
    tiles = list(pm.transform_stream(lambda: iter([X[:500], X[500:]]),
                                     block_rows=300))
    assert [t.shape[0] for t in tiles] == [300, 200, 300, 100]
    _assert_distances(np.concatenate(tiles), got, X, pm.centroids, dtype)


def test_fit_transform_and_inputs(tmp_path):
    X = _blobs(dtype=np.float64)
    kw = dict(k=5, max_iter=6, verbose=False, dtype=np.float64,
              device="cpu")
    pm = kmeans_tpu_torch.KMeans(**kw)
    out = pm.fit_transform(X)
    np.testing.assert_array_equal(out, pm.transform(X))
    np.testing.assert_array_equal(pm.transform(torch.from_numpy(X)), out)
    np.testing.assert_array_equal(np.argmin(out, axis=1), pm.predict(X))
    jm = kmeans_tpu.KMeans(**{k: v for k, v in kw.items()
                              if k != "device"})
    np.testing.assert_allclose(out, np.asarray(jm.fit_transform(X)),
                               rtol=1e-9, atol=1e-9)
    with pytest.raises(ValueError, match="2-D"):
        pm.transform(X[0])
    with pytest.raises(ValueError, match="fitted"):
        kmeans_tpu_torch.KMeans(k=3, device="cpu").transform(X)


@pytest.mark.parametrize("call", ["prefetch", "predict_stream",
                                  "score_stream"])
def test_streaming_entry_points_not_ported_raise(tmp_path, call):
    """Ported since (ROADMAP A.10): each stream runs and equals the JAX
    package's and the in-memory call."""
    pm, jm, X = _models(tmp_path)

    def blocks():
        return iter([X[:500], X[500:]])

    if call == "prefetch":
        got = np.concatenate(list(pm.transform_stream(blocks, prefetch=2)))
        np.testing.assert_array_equal(got, np.concatenate(list(
            pm.transform_stream(blocks, prefetch=0))))
        np.testing.assert_allclose(got, np.concatenate(list(
            jm.transform_stream(blocks, prefetch=2))), rtol=1e-9, atol=1e-9)
    elif call == "predict_stream":
        got = np.concatenate(list(pm.predict_stream(blocks)))
        np.testing.assert_array_equal(got, pm.predict(X))
        np.testing.assert_array_equal(got, np.concatenate(list(
            jm.predict_stream(blocks))))
    else:
        np.testing.assert_allclose(pm.score_stream(blocks), pm.score(X),
                                   rtol=1e-12)
        np.testing.assert_allclose(pm.score_stream(blocks),
                                   jm.score_stream(blocks), rtol=1e-12)


def test_get_params_names_the_jax_parameters():
    kw = dict(k=4, max_iter=7, tolerance=1e-3, seed=3, compute_sse=True,
              init="k-means++", n_init=2, compute_labels=False,
              empty_cluster="keep", dtype=np.float64, chunk_size=256,
              distance_mode="matmul", host_loop=False, pipeline=1,
              verbose=False)
    pm = kmeans_tpu_torch.KMeans(device="cpu", **kw)
    jm = kmeans_tpu.KMeans(**kw)
    got, want = pm.get_params(), jm.get_params()
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    assert {name: got[name] for name in want} == want
    again = kmeans_tpu_torch.KMeans(**got)
    assert again.get_params() == got


def test_set_params_validates_and_rolls_back(tmp_path):
    pm, jm, X = _models(tmp_path)
    labels = pm.predict(X)
    for model in (pm, jm):
        assert model.set_params(tolerance=1e-6, max_iter=3) is model
        assert (model.tolerance, model.max_iter) == (1e-6, 3)
        with pytest.raises(ValueError):
            model.set_params(empty_cluster="drop")
        assert model.empty_cluster == "resample" and model.max_iter == 3
        with pytest.raises(ValueError, match="unknown parameter"):
            model.set_params(no_such=1)
    np.testing.assert_array_equal(pm.predict(X), labels)   # fitted state
    # bucket is ported (the warm start): a value outside its grammar is
    # refused with the JAX package's message, and the model rolls back.
    with pytest.raises(ValueError, match="bucket"):
        pm.set_params(bucket="sometimes")
    with pytest.raises(ValueError, match="model_shards"):
        pm.set_params(model_shards=0)
    assert pm.get_params()["model_shards"] == 1 and pm.tolerance == 1e-6
    assert pm.get_params()["bucket"] == 0


def test_get_feature_names_out_matches_jax():
    pm = kmeans_tpu_torch.KMeans(k=3, device="cpu")
    want = kmeans_tpu.KMeans(k=3).get_feature_names_out()
    got = pm.get_feature_names_out()
    assert got.dtype == object and list(got) == list(want)
    assert list(got) == ["kmeans0", "kmeans1", "kmeans2"]


def test_pickle_round_trip_predicts_the_same_labels(tmp_path):
    pm, _, X = _models(tmp_path)
    assert pm.labels_ is not None and pm._fit_ds is None
    back = pickle.loads(pickle.dumps(pm))
    assert back.device == torch.device("cpu") and back._fit_ds is None
    np.testing.assert_array_equal(back.predict(X), pm.predict(X))
    np.testing.assert_array_equal(back.labels_, pm.labels_)
    np.testing.assert_array_equal(back.transform(X), pm.transform(X))


def test_pickling_materialises_labels_before_dropping_the_dataset():
    X = _blobs(dtype=np.float64)
    pm = kmeans_tpu_torch.KMeans(k=4, max_iter=5, verbose=False,
                                 dtype=np.float64, device="cpu")
    ds = pm.cache(X)
    pm.compute_labels = False
    pm.fit(ds)
    pm._fit_ds, pm._labels_cache, pm._labels_error = ds, None, None
    back = pickle.loads(pickle.dumps(pm))
    assert back._fit_ds is None
    np.testing.assert_array_equal(back.labels_, pm.predict(X))


def test_deepcopy_shares_the_dataset_and_copies_the_rest(tmp_path):
    pm, _, X = _models(tmp_path)
    pm._fit_ds = pm.cache(X)
    twin = copy.deepcopy(pm)
    assert twin._fit_ds is pm._fit_ds
    assert twin.centroids is not pm.centroids
    np.testing.assert_array_equal(twin.centroids, pm.centroids)
    twin.centroids[0] += 1.0
    assert not np.array_equal(twin.centroids, pm.centroids)


def test_labels_setter():
    pm = kmeans_tpu_torch.KMeans(k=3, device="cpu")
    labels = np.array([0, 2, 1], np.int32)
    pm.labels_ = labels
    assert pm.labels_ is labels
    jm = kmeans_tpu.KMeans(k=3)
    jm.labels_ = labels
    assert jm.labels_ is labels
