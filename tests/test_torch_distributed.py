"""The port on a ``torch.distributed`` mesh against the JAX package's mesh.

One world of four gloo ranks is spawned once for the module (a FileStore
under ``tmp_path``, the spawn start method, one thread per rank); every
case runs in it, on sub-meshes of the world where a case needs fewer ranks:
``data2`` (2 x 1 on ranks 0 and 1), ``model2`` (1 x 2 on ranks 0 and 1) and
``dm22`` (2 x 2 on all four).  A second world of one rank checks that a mesh
of one rank gives the bits of ``mesh=None``.  The JAX package runs in this
process on the conftest's virtual CPU devices, on meshes of the same
shapes; the port's ranks run the plain versions of the kernels.

Parity classes: float64 ``'matmul'``: labels, counts and iteration counts
equal, sums, SSE, centroids and histories to ``rtol=1e-12`` /
``atol=1e-10``; float32 ``'kernel'`` against ``'pallas'``: the tolerances of
``kmeans_tpu_torch/ops/compare.py``.  The JAX device loop refills empty
clusters with its own Gumbel draws, so the port's device-loop refills are
held to the port's one-device device loop (the same draws) instead.

Model selection on each mesh (``_model_selection``): ``n_init`` by the
device loop and a ``KMeans.sweep`` against the JAX package's, the guarded
rung against the JAX package's on a data axis and refused on a model axis,
k-means|| and the metrics against the port on one device (float64 parity
class; the sweep's Calinski-Harabasz scores ``rtol=1e-4``, the JAX package
scoring in float32).
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

WORLD = 4
TIMEOUT = 300                  # seconds the spawned ranks may take
K, D, N = 5, 5, 301            # k = 5: model = 2 pads the table
CHUNK = 64
RTOL, ATOL = 1e-12, 1e-10
MESHES = {"data2": ((2, 1), (0, 1)), "model2": ((1, 2), (0, 1)),
          "dm22": ((2, 2), (0, 1, 2, 3))}
#: (loop, policy, init) of the fits held to the JAX package; 'far1' starts
#: one cluster empty (its centre lies far from every row), 'far3' three.
#: Not duplicated centres: under a model axis the JAX package's block
#: products break the exact tie between copies by rounding (ROADMAP C.8).
JAX_FITS = [("host", "keep", "far1"), ("host", "farthest", "far3"),
            ("host", "resample", "far3"), ("device", "keep", "far1"),
            ("device", "farthest", "far1")]
#: Device-loop fits whose refills draw rows: held to the port's one-device
#: device loop.
DRAW_FITS = [("device", "resample", "far3"), ("device", "farthest", "far3")]
LOCAL_ROWS = 120               # rank 0's rows of the process-local dataset
GMM_ITERS = 8
#: (covariance type, loop) of the mixture fits on the data axis, and on
#: the model axis (``model2``: k = 3 in two blocks of two, one of them
#: holding an inert pad).
GMM_FITS = [("diag", "host"), ("spherical", "host"), ("tied", "host"),
            ("full", "host"), ("diag", "device"), ("full", "device")]
GMM_MODEL_FITS = [(cov, loop) for cov in ("diag", "spherical", "tied",
                                         "full")
                  for loop in ("host", "device")]


def _inputs():
    """The data of every case, the same in every process."""
    rng = np.random.default_rng(12)
    means = rng.uniform(-6.0, 6.0, size=(4, D))
    X = means[rng.integers(0, 4, size=N)] + rng.standard_normal((N, D))
    C = X[rng.choice(N, K, replace=False)] + 0.1 * rng.standard_normal(
        (K, D))
    W = rng.uniform(0.0, 2.0, size=N)
    W[::9] = 0.0
    far = 100.0 + 10.0 * np.arange(3)[:, None] + np.zeros((3, D))
    inits = {"far1": np.concatenate([X[[0]], far[:1], X[[1, 2, 3]]]),
             "far3": np.concatenate([X[[0]], far, X[[3]]]),
             "rows": X[[5, 50, 100, 150, 200]]}
    gmm_means = X[rng.choice(N, 3, replace=False)]
    return X, C, W, inits, gmm_means


def _fit_kw(loop, policy, init, inits):
    return dict(k=K, max_iter=20, tolerance=1e-9, compute_sse=True,
                init=inits[init], empty_cluster=policy,
                host_loop=loop == "host", distance_mode="matmul",
                dtype=np.float64, verbose=False)


def _fit_record(km):
    return dict(centroids=km.centroids, labels=km.labels_,
                counts=km.cluster_sizes_, iterations=km.iterations_run,
                sse=np.asarray(km.sse_history))


# ------------------------------------------------------------ the ranks


def _world4(rank, out_dir):
    """Every case of the four-rank world; returns this rank's results.
    ``out_dir``: where the checkpoint case writes."""
    from kmeans_tpu_torch import GaussianMixture, KMeans
    from kmeans_tpu_torch.models import init as pt_init
    from kmeans_tpu_torch.parallel import distributed as dist
    from kmeans_tpu_torch.parallel.mesh import coords, in_mesh, make_mesh
    from kmeans_tpu_torch.parallel.sharding import (from_process_local,
                                                    to_device)
    X, C, W, inits, gmm_means = _inputs()
    cpu = torch.device("cpu")
    meshes = {name: make_mesh(*shape, ranks=ranks)
              for name, (shape, ranks) in MESHES.items()}
    res = {"coords": {name: coords(m) if in_mesh(m) else None
                      for name, m in meshes.items()}}
    for name, mesh in meshes.items():
        if not in_mesh(mesh):
            continue
        out = res[name] = {}
        for mode, dtype in (("matmul", np.float64), ("kernel", np.float32)):
            ds = to_device(X, cpu, dtype, mesh=mesh, sample_weight=W)
            c = torch.from_numpy(C.astype(dtype))
            st = dist.make_step_fn(mesh, chunk_size=CHUNK, mode=mode)(
                ds.points, ds.weights, c)
            out["step", mode] = {f: getattr(st, f).numpy()
                                 for f in st._fields}
            out["predict", mode] = ds.gather_rows(dist.make_predict_fn(
                mesh, chunk_size=CHUNK, mode=mode)(ds.points, c))
        for case in JAX_FITS + DRAW_FITS:
            km = KMeans(mesh=mesh, device="cpu", **_fit_kw(*case, inits))
            out["fit", case] = _fit_record(km.fit(X))
        km = KMeans(k=K, max_iter=10, n_init=2, init="forgy", seed=3,
                    compute_sse=True, distance_mode="matmul",
                    dtype=np.float64, verbose=False, mesh=mesh,
                    device="cpu").fit(X, sample_weight=W)
        out["n_init_weighted"] = dict(_fit_record(km),
                                      best=km.best_restart_,
                                      inertias=km.restart_inertias_)
        out["transform"] = km.transform(X)
        out["score"] = km.score(X)
        _model_selection(out, mesh, X, W, inits)
        out["gmm_model_axis"] = _gmm_record(GaussianMixture(
            3, **_gmm_kw("diag", "host", gmm_means), mesh=mesh,
            device="cpu").fit(X, sample_weight=W), X)
    _gmm_model_axis(res, rank, out_dir, X, W, gmm_means)
    mesh = meshes["data2"]
    if in_mesh(mesh):
        out = res["data2"]
        for cov, loop in GMM_FITS:
            gm = GaussianMixture(
                3, covariance_type=cov, max_iter=GMM_ITERS, tol=0.0,
                dtype=np.float64, means_init=gmm_means, mesh=mesh,
                host_loop=loop == "host", device="cpu").fit(
                X, sample_weight=W)
            key = ("gmm", cov) if loop == "host" else ("gmm", cov, loop)
            out[key] = dict(
                means=gm.means_, covariances=gm.covariances_,
                weights=gm.weights_, lower_bound=gm.lower_bound_,
                n_iter=gm.n_iter_, labels=gm.predict(X),
                proba=gm.predict_proba(X), scores=gm.score_samples(X))
        gm = GaussianMixture(3, max_iter=GMM_ITERS, tol=0.0,
                             dtype=np.float64, init_params="kmeans",
                             mesh=mesh, device="cpu").fit(X)
        out["gmm_kmeans_init"] = dict(means=gm.means_,
                                      covariances=gm.covariances_,
                                      lower_bound=gm.lower_bound_)
        km = KMeans(mesh=mesh, device="cpu",
                    **_fit_kw("host", "resample", "far3", inits)).fit(X)
        km.save(os.path.join(out_dir, "mesh.npz"))
        out["saved_labels"] = km.labels_
        # A checkpointed fit on the data axis, killed on every rank at
        # boundary 4 (after the one writer's rotating write).
        from kmeans_tpu_torch.utils import faults
        for loop in ("host", "device"):
            path = os.path.join(out_dir, f"seg_{loop}.npz")
            with faults.inject_kill_after_iteration(4) as rec:
                try:
                    KMeans(mesh=mesh, device="cpu",
                           **_fit_kw(loop, "keep", "rows", inits)).fit(
                        X, checkpoint_every=2, checkpoint_path=path)
                except faults.SimulatedPreemption:
                    pass
            out["killed", loop] = rec["fired_at"]
        # Process-local rows: rank 0 the first LOCAL_ROWS, rank 1 the rest.
        mine = slice(0, LOCAL_ROWS) if rank == 0 else slice(LOCAL_ROWS, N)
        ds = from_process_local(X[mine], mesh, device="cpu",
                                dtype=np.float64)
        for loop in ("host", "device"):
            km = KMeans(mesh=mesh, device="cpu",
                        **_fit_kw(loop, "keep", "rows", inits))
            out["local", loop] = dict(_fit_record(km.fit(ds)),
                                      predict=km.predict(ds))
        try:
            KMeans(k=K, init="forgy", mesh=mesh, device="cpu",
                   dtype=np.float64, verbose=False).fit(ds)
            out["local_forgy"] = None
        except ValueError as e:
            out["local_forgy"] = str(e)
        for weighted in (False, True):
            dsw = from_process_local(
                X[mine], mesh, device="cpu", dtype=np.float64,
                sample_weight=W[mine] if weighted else None)
            out["kmeanspp", weighted] = pt_init._kmeanspp_sharded_draws(
                dsw, 40, np.random.default_rng(9)).numpy()
    return res


def _gmm_kw(cov, loop, gmm_means):
    return dict(covariance_type=cov, max_iter=GMM_ITERS, tol=0.0,
                dtype=np.float64, means_init=gmm_means,
                host_loop=loop == "host")


def _gmm_record(gm, X):
    return dict(means=gm.means_, covariances=gm.covariances_,
                weights=gm.weights_, lower_bound=gm.lower_bound_,
                n_iter=gm.n_iter_, labels=gm.predict(X),
                proba=gm.predict_proba(X), scores=gm.score_samples(X),
                score=gm.score(X))


#: The mixture's restarts and sweep on the model axis.
GMM_N_INIT_KW = dict(n_components=3, max_iter=GMM_ITERS, tol=0.0, n_init=2,
                     init_params="random", seed=4, dtype=np.float64)
GMM_SWEEP_KS = (2, 3, 5)


def _gmm_model_axis(res, rank, out_dir, X, W, gmm_means):
    """The mixture on the model axis (ROADMAP A.18): every covariance type
    by both loops, restarts and a sweep on ``model2``, the E-step of the
    kernel mode (its plain versions here) against one device, a checkpoint,
    a block of only inert components (k = 3 on ``model4``), and
    ``model_shards=2`` without a mesh (the world's 2 x 2 mesh)."""
    from kmeans_tpu_torch import GaussianMixture
    from kmeans_tpu_torch.parallel.gmm_step import make_gmm_step_fn
    from kmeans_tpu_torch.parallel.mesh import in_mesh, make_mesh
    from kmeans_tpu_torch.parallel.sharding import to_device
    model2 = make_mesh(1, 2, ranks=(0, 1))
    model4 = make_mesh(1, 4)
    if in_mesh(model2):
        out = res["gmm_model2"] = {}
        for cov, loop in GMM_MODEL_FITS:
            gm = GaussianMixture(3, **_gmm_kw(cov, loop, gmm_means),
                                 mesh=model2, device="cpu").fit(
                X, sample_weight=W)
            out[cov, loop] = _gmm_record(gm, X)
        gm.save(os.path.join(out_dir, "gmm_model2.npz"))
        # A checkpointed device-loop fit killed at boundary 4 on every
        # rank, then resumed on the same mesh for the iterations left.
        from kmeans_tpu_torch.utils import faults
        path = os.path.join(out_dir, "gmm_seg.npz")
        with faults.inject_kill_after_iteration(4) as rec:
            try:
                GaussianMixture(3, **_gmm_kw("diag", "device", gmm_means),
                                mesh=model2, device="cpu").fit(
                    X, sample_weight=W, checkpoint_every=2,
                    checkpoint_path=path)
            except faults.SimulatedPreemption:
                pass
        kw = dict(_gmm_kw("diag", "device", gmm_means),
                  max_iter=GMM_ITERS - 4)
        out["resumed"] = dict(_gmm_record(GaussianMixture(
            3, **kw, mesh=model2, device="cpu").fit(
            X, sample_weight=W, resume=path), X), killed=rec["fired_at"])
        for loop in ("host", "device"):
            gm = GaussianMixture(host_loop=loop == "host", mesh=model2,
                                 device="cpu", **GMM_N_INIT_KW).fit(X)
            out["n_init", loop] = dict(_gmm_record(gm, X),
                                       best=gm.best_restart_)
        sw = GaussianMixture(mesh=model2, device="cpu",
                             **GMM_N_INIT_KW).sweep(X, k_range=GMM_SWEEP_KS)
        out["sweep"] = dict(selected=sw.selected_k, scores=sw.scores,
                            member_scores=sw.member_scores)
        x32 = X.astype(np.float32)
        ds = to_device(x32, torch.device("cpu"), np.float32, mesh=model2,
                       sample_weight=W.astype(np.float32))
        gm = GaussianMixture(5, **_gmm_kw("diag", "host", X[:5]),
                             mesh=model2, device="cpu").fit(X)
        tables = [t.to(torch.float32) for t in gm._params_dev()]
        out["kernel_tables"] = [t.numpy() for t in tables]
        out["kernel_step"] = [t.numpy() for t in make_gmm_step_fn(
            model2, chunk_size=CHUNK, mode="kernel")(
            ds.points, ds.weights, *tables)]
    res["gmm_model4"] = _gmm_record(GaussianMixture(
        3, **_gmm_kw("diag", "host", gmm_means), mesh=model4,
        device="cpu").fit(X, sample_weight=W), X)
    res["gmm_model_shards"] = _gmm_record(GaussianMixture(
        3, **_gmm_kw("full", "host", gmm_means), model_shards=2,
        device="cpu").fit(X, sample_weight=W), X)


def _model_selection(out, mesh, X, W, inits):
    """The model-selection cases of one mesh: ``n_init`` by the device
    loop, the guarded rung (refused under a model axis), k-means||, the
    metrics and a sweep."""
    from kmeans_tpu_torch import KMeans, metrics
    from kmeans_tpu_torch.models import init as pt_init
    from kmeans_tpu_torch.parallel.sharding import to_device
    km = KMeans(mesh=mesh, device="cpu", **_n_init_kw()).fit(
        X, sample_weight=W)
    out["n_init_device"] = dict(_fit_record(km), best=km.best_restart_,
                                inertias=km.restart_inertias_,
                                loop=km.loop_path_)
    try:
        gk = KMeans(mesh=mesh, device="cpu", **_guarded_kw(inits)).fit(X)
        out["guarded"] = dict(_fit_record(gk),
                              flagged=gk.bf16_guard_corrected_rows_)
    except ValueError as e:
        out["guarded"] = str(e)
    ds = to_device(X, torch.device("cpu"), np.float64, mesh=mesh,
                   sample_weight=W)
    out["kmeans||"] = pt_init.kmeans_parallel_init(ds, K, 5, cap=PAR_CAP)
    out["kmeans||_host"] = pt_init.kmeans_parallel_init(ds, K, 5,
                                                        device=False)
    y = km.labels_
    out["metrics"] = {name: getattr(metrics, name)(X, y, mesh=mesh,
                                                   device="cpu")
                      for name in METRICS}
    out["metrics_batched"] = {
        c: metrics.batched_criterion_scores(X, np.stack([y, (y + 1) % K]),
                                            c, mesh=mesh, device="cpu")
        for c in ("silhouette", "davies_bouldin")}
    res = KMeans(mesh=mesh, device="cpu", **_sweep_kw()).sweep(
        X, k_range=SWEEP_KS, criterion="calinski_harabasz")
    out["sweep"] = dict(selected=res.selected_k, scores=res.scores,
                        member_scores=res.member_scores,
                        centroids=res.best_model.centroids)


#: Model selection on the meshes: the candidates k-means|| keeps per round
#: (below every block's rows, so that a mesh seeds as one device does), the
#: metrics held to one device, and the sweep's k.
PAR_CAP = 64
METRICS = ("silhouette_score", "calinski_harabasz_score",
           "davies_bouldin_score")
SWEEP_KS = (2, 3, 5)


def _n_init_kw():
    return dict(k=K, max_iter=10, n_init=2, init="forgy", seed=3,
                compute_sse=True, distance_mode="matmul", dtype=np.float64,
                verbose=False, host_loop=False, empty_cluster="keep")


def _guarded_kw(inits):
    return dict(k=K, max_iter=10, init=inits["rows"], compute_sse=True,
                distance_mode="matmul_bf16_guarded", dtype=np.float64,
                verbose=False, host_loop=False)


def _sweep_kw():
    return dict(k=3, max_iter=10, n_init=2, seed=3, dtype=np.float64,
                distance_mode="matmul", verbose=False, empty_cluster="keep")


def _world1(rank, out_dir):
    """A world of one rank: the fits of ``_world1_cases`` on its mesh."""
    from kmeans_tpu_torch import KMeans
    from kmeans_tpu_torch.parallel.mesh import make_mesh
    X, _, W, inits, _ = _inputs()
    mesh = make_mesh()
    return {case: _fit_record(KMeans(mesh=mesh, device="cpu",
                                     **_world1_kw(case, inits)).fit(
        X, sample_weight=W)) for case in WORLD1_CASES}


WORLD1_CASES = [(mode, loop, policy)
                for mode in ("matmul", "kernel")
                for loop in ("host", "device")
                for policy in ("farthest", "resample")]


def _world1_kw(case, inits):
    mode, loop, policy = case
    return dict(k=K, max_iter=15, tolerance=1e-9, compute_sse=True,
                init=inits["far3"], empty_cluster=policy,
                host_loop=loop == "host", distance_mode=mode,
                dtype=np.float64 if mode == "matmul" else np.float32,
                verbose=False)


def _rank_main(rank, world, store, out, scenario):
    from kmeans_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world_size=world, rank=rank,
                         backend="gloo")
    try:
        res = scenario(rank, os.path.dirname(out))
    finally:
        torch.distributed.destroy_process_group()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)


def _spawn(scenario, world, tmp):
    """``scenario(rank)`` in ``world`` spawned gloo ranks; their results by
    rank.  A rank that raises fails the test with its traceback; ranks that
    outlive TIMEOUT are killed and fail it."""
    import torch.multiprocessing as mp
    out = str(tmp / "out")
    ctx = mp.start_processes(_rank_main, args=(
        world, str(tmp / "store"), out, scenario), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the {world} ranks did not end within "
                            f"{TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    results = []
    for rank in range(world):
        with open(f"{out}.{rank}", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world4")
    return _spawn(_world4, WORLD, tmp), tmp


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _spawn(_world1, 1, tmp_path_factory.mktemp("world1"))[0]


# ------------------------------------------------------------ the reference


@pytest.fixture(scope="module")
def jx():
    """The JAX package's meshes of the three shapes, and helpers."""
    import jax
    from kmeans_tpu.parallel.mesh import make_mesh
    return {name: make_mesh(data=shape[0], model=shape[1],
                            devices=jax.devices()[:shape[0] * shape[1]])
            for name, (shape, _) in MESHES.items()}


def _jax_step(jmesh, mode, dtype, X, C, W):
    from kmeans_tpu.parallel import distributed as jdist
    from kmeans_tpu.parallel.mesh import mesh_shape
    from kmeans_tpu.parallel.sharding import shard_points
    points, weights = shard_points(X.astype(dtype), jmesh, CHUNK,
                                   sample_weight=W.astype(dtype))
    cents = jdist.pad_centroids(C.astype(dtype), mesh_shape(jmesh)[1])
    st = jdist.make_step_fn(jmesh, chunk_size=CHUNK, mode=mode)(
        points, weights, cents)
    labels = jdist.make_predict_fn(jmesh, chunk_size=CHUNK, mode=mode)(
        points, cents, np.int32(len(X)))
    return {f: np.array(getattr(st, f)) for f in st._fields}, \
        np.array(labels)[: len(X)]


def _ranks_of(results, name):
    return [r[name] for r in results if name in r]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------ the tests


def test_rank_layout_is_row_major(world4, jx):
    results, _ = world4
    for name, (shape, ranks) in MESHES.items():
        ids = np.array([d.id for d in jx[name].devices.flat]).reshape(shape)
        for rank, res in enumerate(results):
            if rank in ranks:
                d_idx, m_idx = res["coords"][name]
                assert ranks.index(rank) == d_idx * shape[1] + m_idx
                assert ids[d_idx, m_idx] == ids.flat[ranks.index(rank)]
            else:
                assert res["coords"][name] is None


@pytest.mark.parametrize("name", list(MESHES))
def test_step_matches_jax_float64(world4, jx, name):
    X, C, W, _, _ = _inputs()
    want, _ = _jax_step(jx[name], "matmul", np.float64, X, C, W)
    for out in _ranks_of(world4[0], name):
        got = out["step", "matmul"]
        for field in ("sums", "counts", "sse", "sse_per_cluster",
                      "farthest_dist", "farthest_point"):
            _close(got[field], want[field][:K] if want[field].ndim
                   and field != "farthest_point" else want[field])


@pytest.mark.parametrize("name", list(MESHES))
def test_predict_matches_jax_float64(world4, jx, name):
    X, C, W, _, _ = _inputs()
    _, want = _jax_step(jx[name], "matmul", np.float64, X, C, W)
    for out in _ranks_of(world4[0], name):
        np.testing.assert_array_equal(out["predict", "matmul"], want)


@pytest.mark.parametrize("name", list(MESHES))
def test_kernel_step_matches_pallas_float32(world4, jx, name):
    from kmeans_tpu_torch.ops import compare as cmp
    X, C, W, _, _ = _inputs()
    want, want_labels = _jax_step(jx[name], "pallas", np.float32, X, C, W)
    x, c = torch.from_numpy(X.astype(np.float32)), torch.from_numpy(
        C.astype(np.float32))
    for out in _ranks_of(world4[0], name):
        got = out["step", "kernel"]
        labels = out["predict", "kernel"]
        assert cmp.label_band(x, c, torch.from_numpy(labels),
                              torch.from_numpy(want_labels))[1] == 0
        assert cmp.sums_close(torch.from_numpy(got["sums"]),
                              torch.from_numpy(want["sums"][:K]))
        assert cmp.close(torch.from_numpy(got["counts"]),
                         torch.from_numpy(want["counts"][:K]),
                         cmp.COUNTS_RTOL, 0.0)


def _jax_fit(jmesh, case, inits, X):
    import kmeans_tpu
    return kmeans_tpu.KMeans(mesh=jmesh, **_fit_kw(*case, inits)).fit(X)


def _assert_fit(got, jm):
    assert got["iterations"] == jm.iterations_run
    np.testing.assert_array_equal(got["labels"], np.asarray(jm.labels_))
    np.testing.assert_array_equal(got["counts"],
                                  np.asarray(jm.cluster_sizes_))
    _close(got["centroids"], np.asarray(jm.centroids))
    _close(got["sse"], np.asarray(jm.sse_history))


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("case", JAX_FITS, ids=["-".join(c) for c in
                                                JAX_FITS])
def test_fit_matches_jax_float64(world4, jx, name, case):
    X, _, _, inits, _ = _inputs()
    jm = _jax_fit(jx[name], case, inits, X)
    for out in _ranks_of(world4[0], name):
        _assert_fit(out["fit", case], jm)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("case", DRAW_FITS, ids=["-".join(c) for c in
                                                 DRAW_FITS])
def test_device_loop_refills_as_one_device(world4, name, case):
    import kmeans_tpu_torch
    X, _, _, inits, _ = _inputs()
    pm = kmeans_tpu_torch.KMeans(device="cpu", **_fit_kw(*case, inits))
    want = _fit_record(pm.fit(X))
    for out in _ranks_of(world4[0], name):
        got = out["fit", case]
        assert got["iterations"] == want["iterations"]
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_array_equal(got["counts"], want["counts"])
        _close(got["centroids"], want["centroids"])
        _close(got["sse"], want["sse"])


@pytest.mark.parametrize("name", list(MESHES))
def test_n_init_and_sample_weight_match_jax(world4, jx, name):
    import kmeans_tpu
    X, _, W, _, _ = _inputs()
    jm = kmeans_tpu.KMeans(k=K, max_iter=10, n_init=2, init="forgy", seed=3,
                           compute_sse=True, distance_mode="matmul",
                           dtype=np.float64, verbose=False, mesh=jx[name],
                           host_loop=True).fit(X, sample_weight=W)
    for out in _ranks_of(world4[0], name):
        got = out["n_init_weighted"]
        _assert_fit(got, jm)
        assert got["best"] == jm.best_restart_
        _close(got["inertias"], np.asarray(jm.restart_inertias_))
        _close(out["score"], jm.score(X))


@pytest.mark.parametrize("name", list(MESHES))
def test_transform_matches_one_device(world4, name):
    import kmeans_tpu_torch
    X, _, _, _, _ = _inputs()
    for out in _ranks_of(world4[0], name):
        pm = kmeans_tpu_torch.KMeans(k=K, device="cpu", dtype=np.float64)
        pm.centroids = out["n_init_weighted"]["centroids"]
        _close(out["transform"], pm.transform(X))


@pytest.mark.parametrize("name", list(MESHES))
def test_every_rank_gets_the_same_result(world4, name):
    outs = _ranks_of(world4[0], name)
    assert len(outs) == int(np.prod(MESHES[name][0]))
    for out in outs[1:]:
        for case in JAX_FITS + DRAW_FITS:
            for key, value in out["fit", case].items():
                np.testing.assert_array_equal(value,
                                              outs[0]["fit", case][key])
        np.testing.assert_array_equal(out["transform"], outs[0]["transform"])


def _jax_gmm(jmesh, X, W, **kw):
    import kmeans_tpu
    return kmeans_tpu.GaussianMixture(mesh=jmesh, **kw).fit(
        X, sample_weight=W)


def _assert_gmm(got, jm, X, n_iter=GMM_ITERS):
    """A mixture fit of the port against the JAX package's, float64 class:
    iterations and labels equal, the tables, bound and posteriors to
    ``RTOL`` / ``ATOL``."""
    assert got["n_iter"] == jm.n_iter_ == n_iter
    for name in ("means", "covariances", "weights"):
        _close(got[name], np.asarray(getattr(jm, name + "_")))
    _close(got["lower_bound"], jm.lower_bound_)
    np.testing.assert_array_equal(got["labels"], np.asarray(jm.predict(X)))
    _close(got["proba"], np.asarray(jm.predict_proba(X)))
    _close(got["scores"], np.asarray(jm.score_samples(X)))
    _close(got["score"], jm.score(X))


@pytest.mark.parametrize("name", list(MESHES))
def test_gmm_on_a_model_axis_raises_naming_A18(world4, jx, name):
    """The mixture runs on every mesh (ROADMAP A.18 is done): 'diag' with
    k = 3 on ``data2``, ``model2`` and ``dm22`` (the model axis pads the
    table to 4) against the JAX package's fit on the mesh of the same
    shape, in the float64 class, on every rank."""
    X, _, W, _, gmm_means = _inputs()
    jm = _jax_gmm(jx[name], X, W, n_components=3,
                  **_gmm_kw("diag", "host", gmm_means))
    outs = _ranks_of(world4[0], name)
    assert len(outs) == int(np.prod(MESHES[name][0]))
    for out in outs:
        _assert_gmm(out["gmm_model_axis"], jm, X)


@pytest.mark.parametrize("case", GMM_MODEL_FITS,
                         ids=["-".join(c) for c in GMM_MODEL_FITS])
def test_gmm_model_axis_matches_jax_float64(world4, jx, case):
    """Every covariance type by both loops on ``model2`` against the JAX
    package's model-axis fit, on both ranks, bit-equal between them."""
    X, _, W, _, gmm_means = _inputs()
    jm = _jax_gmm(jx["model2"], X, W, n_components=3,
                  **_gmm_kw(*case, gmm_means))
    outs = [r["gmm_model2"] for r in world4[0] if "gmm_model2" in r]
    assert len(outs) == 2
    for out in outs:
        _assert_gmm(out[case], jm, X)
    for key, value in outs[0][case].items():
        np.testing.assert_array_equal(outs[1][case][key], value)


@pytest.mark.parametrize("loop", ["host", "device"])
def test_gmm_model_axis_restarts_match_jax(world4, jx, loop):
    """``n_init=2`` from random starts on ``model2``: the JAX package's
    winner and fit."""
    X, _, _, _, _ = _inputs()
    import kmeans_tpu
    jm = kmeans_tpu.GaussianMixture(mesh=jx["model2"],
                                    host_loop=loop == "host",
                                    **GMM_N_INIT_KW).fit(X)
    for r in world4[0]:
        if "gmm_model2" in r:
            got = r["gmm_model2"]["n_init", loop]
            assert got["best"] == jm.best_restart_
            _assert_gmm(got, jm, X)


def test_gmm_model_axis_sweep_matches_jax(world4, jx):
    import kmeans_tpu
    X, _, _, _, _ = _inputs()
    jr = kmeans_tpu.GaussianMixture(mesh=jx["model2"],
                                    **GMM_N_INIT_KW).sweep(
        X, k_range=GMM_SWEEP_KS)
    for r in world4[0]:
        if "gmm_model2" in r:
            got = r["gmm_model2"]["sweep"]
            assert got["selected"] == jr.selected_k
            _close(got["member_scores"], jr.member_scores)
            _close(got["scores"], jr.scores)


def test_gmm_model_axis_checkpoint_resumes(world4):
    """A checkpointed device-loop fit on ``model2`` killed at boundary 4
    (one writer) and resumed on the same mesh: the uninterrupted fit's
    tables and bound, in the float64 class, on both ranks."""
    X, _, _, _, _ = _inputs()
    for r in world4[0]:
        if "gmm_model2" in r:
            got = r["gmm_model2"]["resumed"]
            want = r["gmm_model2"]["diag", "device"]
            assert got["killed"] == 4
            for name in ("means", "covariances", "weights", "lower_bound",
                         "scores"):
                _close(got[name], want[name])
            np.testing.assert_array_equal(got["labels"], want["labels"])


def test_gmm_block_of_only_pads_matches_jax(world4):
    """k = 3 on a model axis of four: the last rank's block holds only an
    inert component (every logp -inf, its softmax terms 0, no NaN); the
    JAX package's fit on a 1 x 4 mesh."""
    import jax
    from kmeans_tpu.parallel.mesh import make_mesh
    X, _, W, _, gmm_means = _inputs()
    jm = _jax_gmm(make_mesh(data=1, model=4, devices=jax.devices()[:4]),
                  X, W, n_components=3,
                  **_gmm_kw("diag", "host", gmm_means))
    for r in world4[0]:
        _assert_gmm(r["gmm_model4"], jm, X)


def test_gmm_kernel_mode_step_on_the_model_axis(world4):
    """The kernel mode's E-step on ``model2`` (k = 5 in blocks of three:
    launch (a), the MAX and SUM over the axis, launch (b); their plain
    versions on the CPU) against the one-device kernel-mode step, within
    the E-step tolerances of ``ops.compare``."""
    from kmeans_tpu_torch.ops import compare as cmp
    from kmeans_tpu_torch.parallel.gmm_step import make_gmm_step_fn
    X, _, W, _, _ = _inputs()
    outs = [r["gmm_model2"] for r in world4[0] if "gmm_model2" in r]
    assert len(outs) == 2
    tables = [torch.from_numpy(t) for t in outs[0]["kernel_tables"]]
    want = make_gmm_step_fn(chunk_size=CHUNK, mode="kernel")(
        torch.from_numpy(X.astype(np.float32)),
        torch.from_numpy(W.astype(np.float32)), *tables)
    for got in (o["kernel_step"] for o in outs):
        errs = cmp.estep_errors([torch.from_numpy(g) for g in got], want)
        assert errs["ok"], errs


@pytest.mark.parametrize("cov", ["diag", "spherical", "tied", "full"])
def test_gmm_on_a_data_axis_matches_jax_float64(world4, jx, cov):
    _gmm_on_data_axis(world4, jx, cov, "host")


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_gmm_device_loop_on_a_data_axis_matches_jax_float64(world4, jx, cov):
    """The device EM loop on the data axis (its statistics reduced inside
    the iteration) against the JAX package's device loop on the same
    mesh."""
    _gmm_on_data_axis(world4, jx, cov, "device")


def _gmm_on_data_axis(world4, jx, cov, loop):
    import kmeans_tpu
    X, _, W, _, gmm_means = _inputs()
    jm = kmeans_tpu.GaussianMixture(
        3, covariance_type=cov, max_iter=GMM_ITERS, tol=0.0,
        dtype=np.float64, means_init=gmm_means, host_loop=loop == "host",
        mesh=jx["data2"]).fit(X, sample_weight=W)
    key = ("gmm", cov) if loop == "host" else ("gmm", cov, loop)
    for out in _ranks_of(world4[0], "data2"):
        got = out[key]
        assert got["n_iter"] == jm.n_iter_ == GMM_ITERS
        for name in ("means", "covariances", "weights"):
            _close(got[name], np.asarray(getattr(jm, name + "_")))
        _close(got["lower_bound"], jm.lower_bound_)
        np.testing.assert_array_equal(got["labels"], np.asarray(
            jm.predict(X)))
        _close(got["proba"], np.asarray(jm.predict_proba(X)))
        _close(got["scores"], np.asarray(jm.score_samples(X)))


def test_gmm_kmeans_seeding_runs_its_kmeans_on_the_mesh(world4):
    """'kmeans' init fits the internal KMeans on the mixture's mesh: the
    same fit as on one device (the JAX package's mixture builds its
    internal KMeans without the dtype, so it is no float64 oracle here)."""
    import kmeans_tpu_torch
    X, _, _, _, _ = _inputs()
    want = kmeans_tpu_torch.GaussianMixture(
        3, max_iter=GMM_ITERS, tol=0.0, dtype=np.float64,
        init_params="kmeans", device="cpu").fit(X)
    for out in _ranks_of(world4[0], "data2"):
        got = out["gmm_kmeans_init"]
        _close(got["means"], want.means_)
        _close(got["covariances"], want.covariances_)
        _close(got["lower_bound"], want.lower_bound_)


def test_gmm_model_shards_raises_naming_A18(world4, jx):
    """``GaussianMixture(model_shards=2)`` without a mesh fits on the
    world's mesh ``make_mesh(model=2)``, 2 x 2 here ('full', k = 3 padded
    to 4): the JAX package's fit on the 2 x 2 mesh, on all four ranks; and
    a checkpoint written on ``model2`` loads on one device and in the JAX
    package with the same posteriors."""
    import kmeans_tpu
    import kmeans_tpu_torch
    results, tmp = world4
    X, _, W, _, gmm_means = _inputs()
    jm = _jax_gmm(jx["dm22"], X, W, n_components=3,
                  **_gmm_kw("full", "host", gmm_means))
    for r in results:
        _assert_gmm(r["gmm_model_shards"], jm, X)
    path = tmp / "gmm_model2.npz"
    saved = results[0]["gmm_model2"]["full", "device"]
    one = kmeans_tpu_torch.GaussianMixture.load(path, device="cpu")
    assert one.model_shards == 1 and one.mesh is None
    np.testing.assert_array_equal(one.predict(X), saved["labels"])
    _close(one.score_samples(X), saved["scores"])
    jl = kmeans_tpu.GaussianMixture.load(path)
    np.testing.assert_array_equal(np.asarray(jl.predict(X)),
                                  saved["labels"])
    _close(np.asarray(jl.score_samples(X)), saved["scores"])


def test_save_on_a_mesh_loads_on_one_device_and_in_jax(world4):
    import kmeans_tpu
    import kmeans_tpu_torch
    results, tmp = world4
    X, _, _, _, _ = _inputs()
    path = tmp / "mesh.npz"
    want = results[0]["data2"]["saved_labels"]
    pm = kmeans_tpu_torch.KMeans.load(path, device="cpu")
    np.testing.assert_array_equal(pm.predict(X), want)
    with np.load(path) as z:
        import json
        meta = json.loads(str(z["__meta__"]))
    assert (meta["meta_mesh_data_shards"],
            meta["meta_mesh_model_shards"]) == (2, 1)
    jm = kmeans_tpu.KMeans.load(path)
    np.testing.assert_array_equal(np.asarray(jm.predict(X)), want)


@pytest.mark.parametrize("loop", ["host", "device"])
def test_checkpoint_on_a_data_axis_resumes_on_one_device(world4, loop):
    """Two gloo ranks write one rotating checkpoint (the file and its
    ``.prev``, no temporary left behind), both are killed at boundary 4,
    and one device resumes from the file: the fit of one device, within
    the float64 class."""
    import kmeans_tpu_torch
    from kmeans_tpu_torch.utils import checkpoint as pt_ckpt
    results, tmp = world4
    X, _, _, inits, _ = _inputs()
    assert [out["killed", loop] for out in _ranks_of(results, "data2")] \
        == [4, 4]
    path = tmp / f"seg_{loop}.npz"
    assert pt_ckpt.load_state(path)["iterations_run"] == 4
    prev = pt_ckpt._load_state_at(pt_ckpt.prev_path(path))
    assert prev["iterations_run"] == 2
    assert (prev["meta_mesh_data_shards"], prev["meta_mesh_model_shards"]) \
        == (2, 1)
    assert not list(tmp.glob(f".seg_{loop}.npz.*.tmp"))
    kw = _fit_kw(loop, "keep", "rows", inits)
    full = kmeans_tpu_torch.KMeans(device="cpu", **kw).fit(X)
    resumed = kmeans_tpu_torch.KMeans(device="cpu", **kw).fit(
        X, resume=path)
    assert resumed.iterations_run == full.iterations_run == 7
    _close(resumed.centroids, full.centroids)
    _close(np.asarray(resumed.sse_history), np.asarray(full.sse_history))
    np.testing.assert_array_equal(resumed.labels_, full.labels_)


@pytest.mark.parametrize("loop", ["host", "device"])
def test_process_local_fit_equals_the_concatenated_fit(world4, loop):
    import kmeans_tpu_torch
    X, _, _, inits, _ = _inputs()
    want = _fit_record(kmeans_tpu_torch.KMeans(
        device="cpu", **_fit_kw(loop, "keep", "rows", inits)).fit(X))
    outs = _ranks_of(world4[0], "data2")
    for rank, out in enumerate(outs):
        got = out["local", loop]
        assert got["iterations"] == want["iterations"]
        _close(got["centroids"], want["centroids"])
        _close(got["sse"], want["sse"])
        mine = slice(0, LOCAL_ROWS) if rank == 0 else slice(LOCAL_ROWS, N)
        np.testing.assert_array_equal(got["predict"], want["labels"][mine])
        np.testing.assert_array_equal(got["labels"], want["labels"][mine])


def test_process_local_forgy_raises_as_jax(world4):
    from types import SimpleNamespace
    from kmeans_tpu.parallel.sharding import ShardedDataset
    not_addressable = SimpleNamespace(
        points=SimpleNamespace(is_fully_addressable=False))
    with pytest.raises(ValueError) as e:
        ShardedDataset._require_addressable(not_addressable, "positive_rows")
    for out in _ranks_of(world4[0], "data2"):
        assert out["local_forgy"] == str(e.value)


@pytest.mark.parametrize("weighted", [False, True])
def test_sharded_kmeanspp_draws_equal_one_device_draws(world4, weighted):
    from kmeans_tpu_torch.models import init as pt_init
    X, _, W, _, _ = _inputs()
    w = torch.from_numpy(W if weighted else np.ones(N))
    x = torch.from_numpy(X)
    idx = pt_init._kmeanspp_device_draws(x, w, 40, np.random.default_rng(9))
    for out in _ranks_of(world4[0], "data2"):
        np.testing.assert_array_equal(out["kmeanspp", weighted],
                                      X[idx.numpy()])


@pytest.mark.parametrize("case", WORLD1_CASES,
                         ids=["-".join(c) for c in WORLD1_CASES])
def test_a_world_of_one_rank_is_bit_identical_to_no_mesh(world1, case):
    import kmeans_tpu_torch
    X, _, W, inits, _ = _inputs()
    want = _fit_record(kmeans_tpu_torch.KMeans(
        device="cpu", **_world1_kw(case, inits)).fit(X, sample_weight=W))
    got = world1[case]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------- model selection


@pytest.mark.parametrize("name", list(MESHES))
def test_n_init_device_loop_matches_jax(world4, jx, name):
    import kmeans_tpu
    X, _, W, _, _ = _inputs()
    jm = kmeans_tpu.KMeans(mesh=jx[name], **_n_init_kw()).fit(
        X, sample_weight=W)
    for out in _ranks_of(world4[0], name):
        got = out["n_init_device"]
        assert got["loop"] == "device"
        _assert_fit(got, jm)
        assert got["best"] == jm.best_restart_
        _close(got["inertias"], np.asarray(jm.restart_inertias_))


@pytest.mark.parametrize("name", list(MESHES))
def test_guarded_rung_on_a_data_axis_and_refused_on_a_model_axis(
        world4, jx, name):
    import kmeans_tpu
    X, _, _, inits, _ = _inputs()
    outs = _ranks_of(world4[0], name)
    if MESHES[name][0][1] > 1:
        for out in outs:
            assert "requires a data-parallel mesh" in out["guarded"]
        with pytest.raises(ValueError, match="data-parallel mesh"):
            kmeans_tpu.KMeans(mesh=jx[name], **_guarded_kw(inits)).fit(X)
        return
    jm = kmeans_tpu.KMeans(mesh=jx[name], **_guarded_kw(inits)).fit(X)
    for out in outs:
        _assert_fit(out["guarded"], jm)
        assert out["guarded"]["flagged"] == jm.bf16_guard_corrected_rows_


@pytest.mark.parametrize("name", list(MESHES))
def test_kmeans_parallel_on_a_mesh_seeds_as_one_device(world4, name):
    """Every draw of the mesh's seeding is made per global row, so a mesh
    keeps the candidates one device keeps (``cap`` below every block's
    rows: the cap is bounded by a block's rows, as in the JAX package).
    The host engine runs over the host copy on every rank."""
    from kmeans_tpu_torch.models import init as pt_init
    from kmeans_tpu_torch.parallel.sharding import Dataset
    X, _, W, _, _ = _inputs()
    one = pt_init.kmeans_parallel_init(
        Dataset(torch.from_numpy(X), torch.from_numpy(W)), K, 5,
        cap=PAR_CAP)
    host = pt_init.kmeans_parallel_init(pt_init.as_source(X, W), K, 5,
                                        device=False)
    for out in _ranks_of(world4[0], name):
        _close(out["kmeans||"], one)
        np.testing.assert_array_equal(out["kmeans||_host"], host)


@pytest.mark.parametrize("name", list(MESHES))
def test_metrics_on_a_mesh_match_one_device(world4, name):
    from kmeans_tpu_torch import metrics
    X, _, _, _, _ = _inputs()
    for out in _ranks_of(world4[0], name):
        y = out["n_init_device"]["labels"]
        for metric in METRICS:
            _close(out["metrics"][metric],
                   getattr(metrics, metric)(X, y, device="cpu"))
        for c, got in out["metrics_batched"].items():
            _close(got, metrics.batched_criterion_scores(
                X, np.stack([y, (y + 1) % K]), c, device="cpu"))


@pytest.mark.parametrize("name", list(MESHES))
def test_sweep_on_a_mesh_matches_jax(world4, jx, name):
    import kmeans_tpu
    X, _, _, _, _ = _inputs()
    jr = kmeans_tpu.KMeans(mesh=jx[name], **_sweep_kw()).sweep(
        X, k_range=SWEEP_KS, criterion="calinski_harabasz")
    for out in _ranks_of(world4[0], name):
        got = out["sweep"]
        assert got["selected"] == jr.selected_k
        _close(got["member_scores"], jr.member_scores)
        np.testing.assert_allclose(got["scores"], jr.scores, rtol=1e-4)
        _close(got["centroids"], np.asarray(jr.best_model.centroids))
