"""SphericalKMeans, BisectingKMeans and MiniBatchKMeans on a
``torch.distributed`` mesh.

One world of four gloo ranks is spawned for the module (the helpers of
``test_torch_distributed.py``); each case runs on the sub-meshes ``data2``
(2 x 1), ``model2`` (1 x 2) and ``dm22`` (2 x 2).  Against the JAX
package on a mesh of the same shape, float64 ``'matmul'``, the float64
parity class (labels, iterations and counts equal, centroids, SSE and the
per-leaf SSE to ``rtol=1e-12`` / ``atol=1e-10``): spherical, bisecting
and mini-batch host sampling.  The spherical device loop is held to its
host loop on every mesh.  Mini-batch device sampling draws other rows than
the JAX package's: each block of the data axis draws its own share of the
batch, so it is held, in the same parity class, to the float64 NumPy
Sculley update fed the rows and candidates that the blocks draw
(``test_torch_minibatch.sculley_oracle``).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from test_torch_distributed import MESHES, _spawn  # noqa: E402

RTOL, ATOL = 1e-12, 1e-10
N, D = 301, 5


def _inputs():
    rng = np.random.default_rng(21)
    dirs = rng.standard_normal((4, D))
    y = rng.integers(0, 4, size=N)
    X = (dirs[y] + 0.3 * rng.standard_normal((N, D))) \
        * rng.uniform(0.5, 20.0, size=(N, 1))
    W = rng.uniform(0.0, 2.0, size=N)
    W[::7] = 0.0
    return X, W


def _spherical_kw(loop):
    return dict(k=4, max_iter=15, seed=5, compute_sse=True, init="forgy",
                empty_cluster="keep", host_loop=loop == "host",
                distance_mode="matmul", dtype=np.float64, verbose=False)


def _bisecting_kw():
    return dict(k=4, max_iter=15, seed=2, compute_sse=True,
                distance_mode="matmul", dtype=np.float64, verbose=False)


def _minibatch_kw(loop, sampling):
    return dict(k=4, max_iter=12, seed=4, batch_size=64, compute_sse=True,
                sampling=sampling, host_loop=loop == "host",
                reassignment_ratio=0.3, tolerance=1e-12, n_init=2,
                init="forgy", distance_mode="matmul", dtype=np.float64,
                verbose=False)


MINIBATCH_FITS = [("host", "device"), ("device", "device"),
                  ("host", "host")]


def _record(km):
    return dict(centroids=km.centroids, labels=km.labels_,
                iterations=km.iterations_run,
                sse=np.asarray(km.sse_history),
                sizes=np.asarray(km.cluster_sizes_))


def _families(rank, out_dir):
    """Every case of the world on each sub-mesh the rank belongs to."""
    from kmeans_tpu_torch import (BisectingKMeans, MiniBatchKMeans,
                                  SphericalKMeans)
    from kmeans_tpu_torch.parallel.mesh import in_mesh, make_mesh
    X, W = _inputs()
    res = {}
    for name, (shape, ranks) in MESHES.items():
        mesh = make_mesh(*shape, ranks=ranks)
        if not in_mesh(mesh):
            continue
        out = res[name] = {}
        for loop in ("host", "device"):
            km = SphericalKMeans(mesh=mesh, device="cpu",
                                 **_spherical_kw(loop)).fit(X)
            out["spherical", loop] = _record(km)
        bk = BisectingKMeans(mesh=mesh, device="cpu",
                             **_bisecting_kw()).fit(X, sample_weight=W)
        out["bisecting"] = dict(_record(bk), cluster_sse=bk.cluster_sse_,
                                predict=bk.predict(X))
        for case in MINIBATCH_FITS:
            mb = MiniBatchKMeans(mesh=mesh, device="cpu",
                                 **_minibatch_kw(*case)).fit(
                X, sample_weight=W)
            out["minibatch", case] = dict(
                _record(mb), seen=mb._seen, inits=mb.init_inertias_,
                loop_path=mb.loop_path_)
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _spawn(_families, 4, tmp_path_factory.mktemp("families"))


@pytest.fixture(scope="module")
def jx():
    import jax
    from kmeans_tpu.parallel.mesh import make_mesh
    return {name: make_mesh(data=shape[0], model=shape[1],
                            devices=jax.devices()[:shape[0] * shape[1]])
            for name, (shape, _) in MESHES.items()}


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=ATOL)


def _same(got, jm):
    assert got["iterations"] == jm.iterations_run
    np.testing.assert_array_equal(got["labels"], np.asarray(jm.labels_))
    _close(got["centroids"], jm.centroids)
    _close(got["sse"], jm.sse_history)


@pytest.mark.parametrize("name", list(MESHES))
def test_spherical_matches_jax_on_the_mesh(world, jx, name):
    import kmeans_tpu
    X, _ = _inputs()
    jm = kmeans_tpu.SphericalKMeans(mesh=jx[name],
                                    **_spherical_kw("host")).fit(X)
    for rank in (r for r in world if name in r):
        host, dev = rank[name]["spherical", "host"], \
            rank[name]["spherical", "device"]
        _same(host, jm)
        np.testing.assert_array_equal(host["sizes"], jm.cluster_sizes_)
        assert dev["iterations"] == host["iterations"]
        np.testing.assert_array_equal(dev["centroids"], host["centroids"])
        np.testing.assert_array_equal(dev["labels"], host["labels"])


@pytest.mark.parametrize("name", list(MESHES))
def test_bisecting_matches_jax_on_the_mesh(world, jx, name):
    import kmeans_tpu
    X, W = _inputs()
    jm = kmeans_tpu.BisectingKMeans(mesh=jx[name], host_loop=True,
                                    **_bisecting_kw()).fit(
        X, sample_weight=W)
    for rank in (r for r in world if name in r):
        got = rank[name]["bisecting"]
        _same(got, jm)
        _close(got["sizes"], jm.cluster_sizes_)
        _close(got["cluster_sse"], jm.cluster_sse_)
        np.testing.assert_array_equal(got["predict"],
                                      np.asarray(jm.predict(X)))


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("case", MINIBATCH_FITS,
                         ids=["-".join(c) for c in MINIBATCH_FITS])
def test_minibatch_on_the_mesh(world, jx, name, case):
    import kmeans_tpu
    from kmeans_tpu_torch import MiniBatchKMeans
    from test_torch_minibatch import sculley_oracle
    X, W = _inputs()
    loop, sampling = case
    kw = _minibatch_kw(*case)
    if sampling == "host":
        ref = kmeans_tpu.MiniBatchKMeans(mesh=jx[name], **kw).fit(
            X, sample_weight=W)
        want = dict(centroids=ref.centroids, seen=ref._seen,
                    sizes=ref.cluster_sizes_, sse=ref.sse_history,
                    labels=np.asarray(ref.labels_),
                    iterations=ref.iterations_run)
    else:
        # The init the port picks (its candidates are scored on the whole
        # data, the same on every mesh), then the blocks' draws.
        ref = MiniBatchKMeans(device="cpu", **kw)
        c0 = ref._select_init(ref.cache(X, W))
        data = MESHES[name][0][0]
        bs_local = -(-kw["batch_size"] // data)
        c, seen, counts, sse, _ = sculley_oracle(
            X, W, c0, seed=kw["seed"], batch=bs_local,
            max_iter=kw["max_iter"], tolerance=kw["tolerance"],
            ratio=kw["reassignment_ratio"],
            every=ref._reassign_every(bs_local * data), data=data)
        d2 = ((X[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        want = dict(centroids=c, seen=seen, sizes=counts.astype(np.int64),
                    sse=sse, labels=d2.argmin(1), iterations=len(sse))
    for rank in (r for r in world if name in r):
        got = rank[name]["minibatch", case]
        assert got["loop_path"] == loop
        assert got["iterations"] == want["iterations"] == 12
        np.testing.assert_array_equal(got["sizes"], want["sizes"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        _close(got["sse"], want["sse"])
        _close(got["inits"], ref.init_inertias_)
        _close(got["centroids"], want["centroids"])
        _close(got["seen"], want["seen"])
        if case == ("device", "device"):      # the same bits as per iteration
            per = rank[name]["minibatch", ("host", "device")]
            np.testing.assert_array_equal(got["centroids"], per["centroids"])
            np.testing.assert_array_equal(got["seen"], per["seen"])
