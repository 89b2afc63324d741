"""The streams on a ``torch.distributed`` mesh: two gloo ranks spawned for
the module (the harness of ``test_torch_distributed.py``: a FileStore under
``tmp_path``, a child's traceback fails the test, a child past its time is
killed).  Every rank runs ``make_blocks()`` and keeps its contiguous share
of each block; the statistics reduce over the mesh.  On the meshes
``data2`` (2 x 1) and ``model2`` (1 x 2), float64 'matmul', against one
device in the test process, in the float64 parity class (equal iterations
and counts, centroids, SSE and lower bounds to ``rtol=1e-12``):
``KMeans.fit_stream`` (every empty-cluster policy, weighted blocks),
``score_stream``, ``predict_stream``, ``GaussianMixture.fit_stream`` on
both axes ('diag' and 'full', its posterior stream too), and ``data.io.from_npy`` read rank by rank
(each rank its own rows, the padding at weight 0, the fit equal to one
device's)."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from test_torch_distributed import _spawn  # noqa: E402

RTOL, ATOL = 1e-12, 1e-10
WORLD = 2
MESHES = {"data2": (2, 1), "model2": (1, 2)}
N, D = 1003, 5
POLICIES = ("keep", "farthest", "resample")


def _inputs():
    rng = np.random.default_rng(31)
    means = rng.uniform(-6, 6, size=(4, D))
    X = means[rng.integers(0, 4, N)] + rng.standard_normal((N, D))
    W = rng.uniform(0.0, 2.0, size=N)
    W[::9] = 0.0
    return X, W


def _blocks(X, W=None, size=300):
    def make_blocks():
        for i in range(0, len(X), size):
            yield X[i: i + size] if W is None else \
                (X[i: i + size], W[i: i + size])
    return make_blocks


def _km_kw(policy):
    # Far-away starting centres force empties under every policy.
    X, _ = _inputs()
    init = np.concatenate([X[:3], np.full((2, D), 50.0)])
    return dict(k=5, init=init, max_iter=12, seed=3, compute_sse=True,
                empty_cluster=policy, tolerance=1e-12, dtype=np.float64,
                distance_mode="matmul", verbose=False)


GMM_KW = dict(n_components=3, max_iter=8, tol=0.0, init_params="random",
              seed=2, dtype=np.float64)


def _record(km):
    return dict(centroids=km.centroids, iterations=km.iterations_run,
                sse=np.asarray(km.sse_history),
                sizes=np.asarray(km.cluster_sizes_))


def _runs(mesh=None):
    """Every stream case on ``mesh`` (None: one device)."""
    from kmeans_tpu_torch import GaussianMixture, KMeans
    X, W = _inputs()
    out = {}
    for policy in POLICIES:
        km = KMeans(mesh=mesh, device="cpu", **_km_kw(policy))
        km.fit_stream(_blocks(X), prefetch=2)
        out["fit", policy] = _record(km)
    km = KMeans(mesh=mesh, device="cpu", **_km_kw("keep"))
    km.fit_stream(_blocks(X, W), prefetch=0)
    out["fit", "weighted"] = _record(km)
    out["score"] = km.score_stream(_blocks(X, W))
    out["predict"] = np.concatenate(list(km.predict_stream(_blocks(X))))
    for ct in ("diag", "full"):
        g = GaussianMixture(mesh=mesh, device="cpu", covariance_type=ct,
                            **GMM_KW).fit_stream(_blocks(X, W))
        out["gmm", ct] = dict(
            ll=g.lower_bound_, means=g.means_, cov=g.covariances_,
            n_iter=g.n_iter_,
            labels=np.concatenate(list(g.predict_stream(_blocks(X)))),
            scores=np.concatenate(list(g.score_samples_stream(
                _blocks(X)))))
    return out


def _scenario(rank, out_dir):
    from kmeans_tpu_torch import KMeans
    from kmeans_tpu_torch.data.io import from_npy
    from kmeans_tpu_torch.parallel.mesh import make_mesh
    res = {}
    for name, shape in MESHES.items():
        res[name] = _runs(make_mesh(*shape))
    mesh = make_mesh(2, 1)
    X, W = _inputs()
    path = os.path.join(out_dir, "pts.npy")
    for prefetch in (0, 2):
        ds = from_npy(path, mesh, device="cpu", dtype=np.float64,
                      sample_weight=W, prefetch=prefetch, chunk_size=64)
        res["npy", prefetch] = dict(
            points=ds.points.numpy(), weights=ds.weights.numpy(),
            offset=ds.offset, local_rows=ds.local_rows, n=ds.n,
            take=ds.take(np.array([0, 600, 1002])))
    km = KMeans(mesh=mesh, device="cpu", **_km_kw("resample"))
    km.init = "forgy"
    res["npy_fit"] = _record(km.fit(ds))
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream_mesh")
    np.save(tmp / "pts.npy", _inputs()[0])
    return _spawn(_scenario, WORLD, tmp)


@pytest.fixture(scope="module")
def one_device():
    return _runs()


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", list(POLICIES) + ["weighted"])
@pytest.mark.parametrize("name", list(MESHES))
def test_fit_stream_on_the_mesh_matches_one_device(world, one_device, name,
                                                   case):
    want = one_device["fit", case]
    for rank in world:
        got = rank[name]["fit", case]
        assert got["iterations"] == want["iterations"]
        np.testing.assert_array_equal(got["sizes"], want["sizes"])
        _close(got["centroids"], want["centroids"])
        _close(got["sse"], want["sse"])


@pytest.mark.parametrize("name", list(MESHES))
def test_score_and_predict_streams_on_the_mesh(world, one_device, name):
    for rank in world:
        _close(rank[name]["score"], one_device["score"])
        np.testing.assert_array_equal(rank[name]["predict"],
                                      one_device["predict"])


@pytest.mark.parametrize("ct", ["diag", "full"])
def test_gmm_fit_stream_on_the_data_axis(world, one_device, ct):
    want = one_device["gmm", ct]
    for rank in world:
        got = rank["data2"]["gmm", ct]
        assert got["n_iter"] == want["n_iter"]
        _close(got["ll"], want["ll"])
        _close(got["means"], want["means"])
        _close(got["cov"], want["cov"])


def test_gmm_stream_refuses_a_model_axis(world, one_device):
    """The mixture's stream on the model axis (its components in two
    blocks, k = 3 padded to 4): the one-device fit, labels and scores, in
    the float64 parity class, on both ranks."""
    for ct in ("diag", "full"):
        want = one_device["gmm", ct]
        for rank in world:
            got = rank["model2"]["gmm", ct]
            assert got["n_iter"] == want["n_iter"]
            for key in ("ll", "means", "cov", "scores"):
                _close(got[key], want[key])
            np.testing.assert_array_equal(got["labels"], want["labels"])


def test_from_npy_reads_each_ranks_rows(world):
    X, W = _inputs()
    block = -(-N // 2)
    for r, rank in enumerate(world):
        for prefetch in (0, 2):
            got = rank["npy", prefetch]
            lo, hi = r * block, min((r + 1) * block, N)
            assert (got["offset"], got["local_rows"], got["n"]) == \
                (lo, hi - lo, N)
            assert got["points"].shape == (block, D)
            np.testing.assert_array_equal(got["points"][: hi - lo],
                                          X[lo:hi])
            assert np.all(got["points"][hi - lo:] == 0)
            np.testing.assert_array_equal(got["weights"][: hi - lo],
                                          W[lo:hi])
            assert np.all(got["weights"][hi - lo:] == 0)
            np.testing.assert_array_equal(got["take"], X[[0, 600, 1002]])


def test_from_npy_fit_matches_one_device(world):
    from kmeans_tpu_torch import KMeans
    X, W = _inputs()
    kw = dict(_km_kw("resample"), init="forgy")
    want = KMeans(device="cpu", **kw).fit(X, sample_weight=W)
    for rank in world:
        got = rank["npy_fit"]
        assert got["iterations"] == want.iterations_run
        _close(got["centroids"], want.centroids)
        _close(got["sse"], want.sse_history)
