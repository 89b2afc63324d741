"""The ingest and the massive-k tier on a ``torch.distributed`` mesh.

One world of two gloo ranks is spawned for the module (the helpers of
``test_torch_distributed.py``: a FileStore under ``tmp_path``, the spawn
start method, a join with a timeout); each case runs on the meshes
``data2`` (2 x 1) and ``model2`` (1 x 2) of the two ranks.

* Slab placement: ``to_device`` and ``data.io.from_npy`` under
  ``ingest='slab'`` (100-row slabs, so each rank's block takes two, the
  last ragged) place the bytes of ``'mono'``, weights and padding rows
  included; a ``GaussianMixture(ingest='slab')`` fit gives the bits of
  the mono fit.
* ``data.synthetic.device_shards`` on ``data2``: each rank's block is
  ``host_equivalent``'s rows bit for bit, its padding zero rows of weight 0.
* ``k_shard=2`` on ``model2`` is bit-exact against the dense model-axis fit
  on the same mesh (centroids, iteration counts, SSE history), float64 and
  float32; each rank's k-sharded step returns (k/2, D) blocks; the JAX
  package's errors for a mesh without a model axis, a k_shard that is not
  the model axis, ``host_loop=False`` and a two-level model on a model
  axis.
* ``assign='two_level'`` on ``data2`` against the JAX package fed the same
  coarse table, float64: labels, iterations and SSE history.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from test_torch_distributed import MESHES, _spawn  # noqa: E402

RTOL, ATOL = 1e-12, 1e-10
N, D = 301, 5
K = 8
SLAB_ROWS = 100


def _inputs():
    rng = np.random.default_rng(31)
    means = rng.uniform(-8.0, 8.0, size=(K, D))
    X = means[rng.integers(0, K, size=N)] + rng.standard_normal((N, D))
    W = rng.uniform(0.0, 2.0, size=N)
    W[::9] = 0.0
    return X, W


def _kmeans_kw(dtype, k=K, **kw):
    X, _ = _inputs()
    return dict(k=k, max_iter=12, tolerance=1e-9, compute_sse=True,
                init=X[:k].copy(), distance_mode="matmul", dtype=dtype,
                verbose=False, **kw)


def _two_level_coarse():
    """A coarse table of the fine table's first rows: the same for the
    port's ranks and the JAX package's fit."""
    X, _ = _inputs()
    return X[[0, 3, 5]].astype(np.float64)


def _blocks(ds):
    return (ds.points.cpu().numpy().copy(), ds.weights.cpu().numpy().copy(),
            ds.offset, ds.local_rows)


def _world(rank, out_dir):
    import os
    from kmeans_tpu_torch import GaussianMixture, KMeans
    from kmeans_tpu_torch.data import io as pio
    from kmeans_tpu_torch.data import synthetic
    from kmeans_tpu_torch.obs import memory
    from kmeans_tpu_torch.parallel import distributed as dist
    from kmeans_tpu_torch.parallel.mesh import make_mesh
    from kmeans_tpu_torch.parallel.sharding import to_device
    X, W = _inputs()
    meshes = {name: make_mesh(*shape, ranks=ranks)
              for name, (shape, ranks) in MESHES.items() if name != "dm22"}
    res = {}
    data2, model2 = meshes["data2"], meshes["model2"]

    # Slab against mono, host arrays and a .npy file, 100-row slabs.
    memory.INGEST_SLAB_TARGET_BYTES = SLAB_ROWS * D * 4
    path = os.path.join(out_dir, "x.npy")
    if rank == 0:
        np.save(path, X.astype(np.float32))
    torch.distributed.barrier()
    for sw in (None, W):
        for mode in ("mono", "slab"):
            ds = to_device(X.astype(np.float32), torch.device("cpu"),
                           np.float32, sample_weight=sw, mesh=data2,
                           ingest=mode)
            res["to_device", sw is None, mode] = _blocks(ds)
            ds = pio.from_npy(path, data2, device="cpu", ingest=mode,
                              sample_weight=sw, prefetch=1)
            res["from_npy", sw is None, mode] = _blocks(ds) + (ds.slabs,)
    gkw = dict(n_components=3, covariance_type="diag", max_iter=5,
               init_params="random", seed=2, dtype=np.float64,
               device="cpu", mesh=data2)
    for mode in ("mono", "slab"):
        gm = GaussianMixture(ingest=mode, **gkw).fit(X, sample_weight=W)
        res["gmm", mode] = (gm.means_, gm.covariances_, gm.lower_bound_,
                            gm.n_iter_)

    # Generated blocks against the host oracle.
    for kind in ("normal", "uniform", "blobs"):
        centers = X[:4] if kind == "blobs" else None
        ds = synthetic.device_shards(N, D, mesh=data2, kind=kind, seed=7,
                                     centers=centers, device="cpu")
        res["synthetic", kind] = _blocks(ds)

    # k_shard against the dense model-axis fit on the same mesh.
    for dtype in (np.float64, np.float32):
        for k in (K, 5):
            fits = {}
            for ks in (0, 2):
                km = KMeans(mesh=model2, device="cpu", k_shard=ks,
                            **_kmeans_kw(dtype, k=k)).fit(X)
                fits[ks] = (km.centroids, km.iterations_run,
                            list(km.sse_history), km.labels_,
                            km.k_shard_resolved_, km.cluster_sizes_)
            res["kshard", np.dtype(dtype).name, k] = fits
    step = dist.make_kshard_step_fn(model2, chunk_size=64)
    st = step(torch.from_numpy(X), torch.from_numpy(W),
              torch.from_numpy(X[:K].copy()))
    res["kshard_block"] = (tuple(st.sums.shape), tuple(st.counts.shape))
    errors = {}
    cases = {"no_model_axis": (data2, dict(k_shard=2)),
             "not_the_axis": (model2, dict(k_shard=3)),
             "host_loop": (model2, dict(k_shard=2, host_loop=False)),
             "two_level_tp": (model2, dict(assign="two_level"))}
    for name, (mesh, kw) in cases.items():
        try:
            KMeans(mesh=mesh, device="cpu",
                   **_kmeans_kw(np.float64, **kw)).fit(X)
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    for mode in ("kernel", "kernel_bf16"):
        try:
            dist.make_kshard_step_fn(model2, chunk_size=64, mode=mode)
            errors[mode] = None
        except ValueError as e:
            errors[mode] = str(e)
    res["errors"] = errors

    # Two-level on the data axis, from a given coarse table.
    km = KMeans(mesh=data2, device="cpu", assign="two_level",
                coarse_cells=3, nprobe=1, **_kmeans_kw(np.float64))
    km._train_coarse = lambda cents, C: _two_level_coarse()
    km.fit(X, sample_weight=W)
    res["two_level"] = (km.centroids, km.iterations_run,
                        list(km.sse_history), km.predict(X))
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _spawn(_world, 2, tmp_path_factory.mktemp("large_k"))


@pytest.mark.parametrize("source", ["to_device", "from_npy"])
@pytest.mark.parametrize("weighted", [False, True])
def test_slab_places_the_bytes_of_mono(world, source, weighted):
    X, W = _inputs()
    for rank, res in enumerate(world):
        mono = res[source, not weighted, "mono"]
        slab = res[source, not weighted, "slab"]
        assert slab[2:4] == mono[2:4] == (151 * rank, 151 - rank)
        for a, b in zip(mono[:2], slab[:2]):
            assert a.tobytes() == b.tobytes()
        pts, w = slab[0], slab[1]
        lo, rows = slab[2], slab[3]
        np.testing.assert_array_equal(pts[:rows],
                                      X[lo:lo + rows].astype(np.float32))
        np.testing.assert_array_equal(pts[rows:], 0.0)
        np.testing.assert_array_equal(w[rows:], 0.0)
        want = W[lo:lo + rows] if weighted else np.ones(rows)
        np.testing.assert_array_equal(w[:rows], want.astype(np.float32))
        if source == "from_npy":
            assert (mono[4], slab[4]) == (1, 2)


def test_gaussian_mixture_with_slab_ingest(world):
    for res in world:
        mono, slab = res["gmm", "mono"], res["gmm", "slab"]
        for a, b in zip(mono, slab):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(world[0]["gmm", "slab"][0],
                                  world[1]["gmm", "slab"][0])


@pytest.mark.parametrize("kind", ["normal", "uniform", "blobs"])
def test_device_shards_on_a_mesh_equal_the_host_oracle(world, kind):
    from kmeans_tpu_torch.data import synthetic
    X, _ = _inputs()
    host = synthetic.host_equivalent(
        N, D, kind=kind, seed=7, centers=X[:4] if kind == "blobs" else None)
    for rank, res in enumerate(world):
        pts, w, lo, rows = res["synthetic", kind]
        assert (lo, rows, pts.shape[0]) == (151 * rank, 151 - rank, 151)
        assert pts[:rows].tobytes() == host[lo:lo + rows].tobytes()
        assert pts[rows:].tobytes() == np.zeros_like(pts[rows:]).tobytes()
        np.testing.assert_array_equal(w, np.arange(151) < rows)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("k", [K, 5])
def test_kshard_is_bit_exact_against_the_dense_model_axis_fit(world, dtype,
                                                              k):
    for res in world:
        dense, sharded = res["kshard", dtype, k][0], res["kshard", dtype, k][2]
        assert (dense[4], sharded[4]) == (0, 2)
        np.testing.assert_array_equal(sharded[0], dense[0])
        assert sharded[1] == dense[1]
        assert sharded[2] == dense[2]
        np.testing.assert_array_equal(sharded[3], dense[3])
        np.testing.assert_array_equal(sharded[5], dense[5])
    np.testing.assert_array_equal(world[0]["kshard", dtype, k][2][0],
                                  world[1]["kshard", dtype, k][2][0])


def test_kshard_step_returns_blocks(world):
    for res in world:
        assert res["kshard_block"] == ((K // 2, D), (K // 2,))


def test_kshard_and_two_level_errors_are_the_references(world):
    for res in world:
        err = res["errors"]
        assert "requires a model-sharded mesh" in err["no_model_axis"]
        assert "does not match the mesh's model_shards=2" in \
            err["not_the_axis"]
        assert "host_loop=False cannot run the large-k paths" in \
            err["host_loop"]
        assert "composes with data parallelism only" in err["two_level_tp"]
        for mode in ("kernel", "kernel_bf16"):
            assert "make_kshard_step_fn supports the matmul-class modes " \
                "only" in err[mode]


def test_two_level_on_a_data_axis_matches_jax(world):
    import jax
    import kmeans_tpu
    from kmeans_tpu.parallel.mesh import make_mesh
    X, W = _inputs()
    jm = kmeans_tpu.KMeans(
        mesh=make_mesh(data=2, model=1, devices=jax.devices()[:2]),
        assign="two_level", coarse_cells=3, nprobe=1,
        **_kmeans_kw(np.float64))
    jm._train_coarse = lambda cents, C: _two_level_coarse()
    jm.fit(X, sample_weight=W)
    for res in world:
        cents, iters, sse, labels = res["two_level"]
        assert iters == jm.iterations_run
        np.testing.assert_allclose(cents, jm.centroids, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(sse, jm.sse_history, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(labels, jm.predict(X))
