"""The port's collective-bytes bill (``obs.fleet.comm_bytes_model``)
against the bytes the port sends, counted at ``parallel.mesh.all_reduce``
and recorded by the cost capture (``obs.cost``), on a world of two gloo
ranks spawned for the module (the helpers of ``test_torch_distributed.py``).

Each rank captures one K-Means step on the data axis (``data2``) and on
the model axis (``model2``), plain, with the farthest point and with the
per-cluster SSE (the bisecting step's), one 'diag' mixture
E-step on the data axis, one mixture E-step of every covariance type on the
model axis (k = 5 in blocks of three, its chunks' row statistics over the
axis), one device-loop iteration on the data axis, and
a traced fit whose fleet barrier is synced.  The bill agrees with every
measured record (``comm_crosscheck``); the sites the port shares with the
JAX package's model (the statistics' psums) carry its bytes;
``format_comm_table`` renders the bill with its measured line.
"""

import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from test_torch_distributed import _spawn  # noqa: E402

N, D, K = 301, 6, 5
GMM_CHUNK = 64          # 301 rows: four whole chunks and a short one


def _data():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((N, D)) + rng.integers(0, 3, size=(N, 1))
    return X, X[:K].copy()


def _bytes(rec):
    return {"collective_bytes": rec.collective_bytes,
            "collectives": rec.collectives, "available": rec.available}


def _world(rank, out_dir):
    from kmeans_tpu_torch import GaussianMixture, KMeans, obs
    from kmeans_tpu_torch.obs import cost
    from kmeans_tpu_torch.parallel import distributed as dist
    from kmeans_tpu_torch.models import kmeans as km_mod
    from kmeans_tpu_torch.parallel.mesh import make_mesh
    from kmeans_tpu_torch.utils.cache import cached_build
    from kmeans_tpu_torch.utils.profiling import compile_caches

    def cold():
        # A cost record is taken at a step cache's miss.
        for cache in compile_caches().values():
            cache.clear()
    X, C = _data()
    meshes = {"data2": make_mesh(2, 1), "model2": make_mesh(1, 2)}
    res = {}
    for name, mesh in meshes.items():
        km = KMeans(k=K, device="cpu", dtype=np.float64, mesh=mesh,
                    distance_mode="matmul", verbose=False)
        ds = km.cache(X)
        cents = torch.from_numpy(C)
        for far, pc in ((False, False), (True, False), (False, True)):
            cold()
            with cost.collecting() as col:
                cached_build(km_mod._STEP_CACHE, dist.make_step_fn, mesh,
                             chunk_size=64, mode="matmul",
                             need_farthest=far, need_sse_pc=pc)(
                    ds.points, ds.weights, cents)
            res[name, far, pc] = dict(_bytes(col.records()[0]),
                                      rows=int(ds.points.shape[0]))
    mesh = meshes["data2"]
    gm = GaussianMixture(n_components=K, covariance_type="diag",
                         max_iter=2, tol=0.0, seed=0, init_params="random",
                         device="cpu", dtype=np.float64, mesh=mesh,
                         verbose=False).fit(X)
    ds = gm._dataset(X)
    cold()
    with cost.collecting() as col:
        gm._make_step(mesh, gm._chunk(ds), "torch", 0)(
            ds.points, ds.weights, *gm._params_dev())
    res["gmm"] = _bytes(col.records()[0])
    model2 = meshes["model2"]
    for cov in ("diag", "spherical", "tied", "full"):
        gm = GaussianMixture(n_components=K, covariance_type=cov,
                             max_iter=2, tol=0.0, seed=0,
                             init_params="random", device="cpu",
                             dtype=np.float64, mesh=model2,
                             chunk_size=GMM_CHUNK, verbose=False).fit(X)
        ds = gm._dataset(X)
        cold()
        with cost.collecting() as col:
            gm._make_step(model2, gm._chunk(ds), "torch", 0)(
                ds.points, ds.weights, *gm._params_dev())
        res["gmm_model2", cov] = dict(_bytes(col.records()[0]),
                                      rows=int(ds.points.shape[0]))
        if cov == "diag":
            # The kernel mode (its plain versions here), float32.
            cold()
            with cost.collecting() as col:
                gm._make_step(model2, gm._chunk(ds), "kernel", 0)(
                    ds.points.float(), ds.weights.float(),
                    *[t.float() for t in gm._params_dev()])
            res["gmm_model2_kernel"] = dict(_bytes(col.records()[0]),
                                            rows=int(ds.points.shape[0]))
    cold()
    with cost.collecting() as col:
        KMeans(k=K, max_iter=2, tolerance=1e-30, init=C, device="cpu",
               dtype=np.float64, mesh=mesh, host_loop=False,
               empty_cluster="keep", compute_sse=True,
               compute_labels=False, distance_mode="matmul",
               verbose=False).fit(X)
    loop = next(r for r in col.records()
                if r.key.startswith("('make_fit_fn',"))
    res["loop"] = dict(_bytes(loop), region=loop.region)
    with obs.tracing() as tr:
        KMeans(k=K, max_iter=2, init=C, device="cpu", dtype=np.float64,
               mesh=mesh, verbose=False).fit(X)
    res["barrier"] = [(r["attrs"], r["parent"] is not None)
                      for r in tr.records()
                      if r.get("name") == "fleet.barrier"]
    res["collective_spans"] = [r["attrs"] for r in tr.records()
                               if r.get("kind") == "span"
                               and r["name"] == "collective"]
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _spawn(_world, 2, tmp_path_factory.mktemp("comm_mesh"))


def _check(measured, model):
    from kmeans_tpu_torch.obs import fleet
    chk = fleet.comm_crosscheck(model, types.SimpleNamespace(**measured))
    assert chk["agree"] is True, chk
    assert chk["measured_bytes"] == model["hlo_program_bytes"]
    return chk


@pytest.mark.parametrize("far,pc", [(False, False), (True, False),
                                   (False, True)],
                         ids=["stats", "farthest", "sse_per_cluster"])
@pytest.mark.parametrize("mesh", ["data2", "model2"])
def test_step_bytes_agree_with_the_bill(world, mesh, far, pc):
    from kmeans_tpu_torch.obs import fleet
    shape = {"data2": (2, 1), "model2": (1, 2)}[mesh]
    for res in world:
        measured = res[mesh, far, pc]
        model = fleet.comm_bytes_model(
            "kmeans", k=K, d=D, data_shards=shape[0], model_shards=shape[1],
            acc_bytes=8, empty_cluster="farthest" if far else "keep",
            rows=measured["rows"], need_sse_pc=pc)
        chk = _check(measured, model)
        assert chk["collectives"] == sum(s["count"] for s in model["sites"])
        assert measured["available"] is False       # the CPU's form
        text = fleet.format_comm_table(model, chk)
        assert "measured (mesh.all_reduce)" in text and "agree=True" in text


def test_mixture_and_loop_bytes_agree_with_the_bill(world):
    from kmeans_tpu_torch.obs import fleet
    for res in world:
        _check(res["gmm"], fleet.comm_bytes_model(
            "gmm", k=K, d=D, data_shards=2, acc_bytes=8))
        # One device-loop iteration sends the step's statistics.
        assert res["loop"]["region"] == "eager"
        _check(res["loop"], fleet.comm_bytes_model(
            "kmeans", k=K, d=D, data_shards=2, acc_bytes=8))


@pytest.mark.parametrize("cov", ["diag", "spherical", "tied", "full"])
def test_mixture_model_axis_bytes_agree_with_the_bill(world, cov):
    """The mixture's E-step on ``model2``: the statistics embedded over
    both axes and, per chunk, the MAX and SUM of the row statistics over
    the model axis, every call counted."""
    from kmeans_tpu_torch.obs import fleet
    for res in world:
        measured = res["gmm_model2", cov]
        model = fleet.comm_bytes_model(
            "gmm", k=K, d=D, model_shards=2, acc_bytes=8, cov_type=cov,
            rows=measured["rows"], chunk_rows=GMM_CHUNK)
        chk = _check(measured, model)
        assert chk["collectives"] == sum(s["count"] for s in model["sites"]
                                         if s["in_program"])
        names = {s["site"] for s in model["sites"]}
        assert {"estep.pmax_row_max", "estep.pmax_row_max_tail",
                "estep.psum_row_sum", "estep.psum_row_sum_tail"} <= names


def test_mixture_kernel_mode_model_axis_bytes_agree_with_the_bill(world):
    """The kernel mode's E-step on ``model2``: launch (a) over all the
    rank's rows, so one MAX and one SUM of every row's statistics over the
    axis (``chunk_rows=0``), whatever the chunk of the torch pass."""
    from kmeans_tpu_torch.obs import fleet
    for res in world:
        measured = res["gmm_model2_kernel"]
        model = fleet.comm_bytes_model(
            "gmm", k=K, d=D, model_shards=2, acc_bytes=4,
            rows=measured["rows"], chunk_rows=0)
        chk = _check(measured, model)
        rows = {s["site"]: s for s in model["sites"]
                if s["site"].startswith("estep.p") and "row" in s["site"]}
        assert set(rows) == {"estep.pmax_row_max", "estep.psum_row_sum"}
        assert all(s["count"] == 1 and s["result_bytes"] == 4 * N
                   for s in rows.values())
        assert chk["collectives"] == sum(s["count"] for s in model["sites"]
                                         if s["in_program"])


def test_shared_sites_carry_the_references_bytes():
    """Where a site is the same collective in both packages (the
    statistics' psums), the port's one packed buffer carries the bytes of
    the reference's sites together."""
    from kmeans_tpu.obs import fleet as jfleet

    from kmeans_tpu_torch.obs import fleet
    for fam, kw in (("kmeans", {}), ("gmm", {"cov_type": "diag"}),
                    ("gmm", {"cov_type": "spherical"}),
                    ("gmm", {"cov_type": "full"})):
        ours = fleet.comm_bytes_model(fam, k=7, d=4, data_shards=4, **kw)
        theirs = jfleet.comm_bytes_model(fam, k=7, d=4, data_shards=4,
                                         **kw)
        packed = next(s for s in ours["sites"]
                      if s["site"] == "estep.psum_stats")
        shared = [s for s in theirs["sites"] if s["scope"] == "iteration"
                  and s["site"].startswith("estep.psum_")]
        assert packed["result_bytes"] == sum(s["result_bytes"]
                                             for s in shared), (fam, kw)
        assert packed["collective"] == "all-reduce"
        assert ours["per_iteration_bytes"] == theirs["per_iteration_bytes"]
    assert fleet.COMM_AGREEMENT_RTOL == jfleet.COMM_AGREEMENT_RTOL
    for args in ((1000.0, 1, "all-reduce"), (1000.0, 4, "all-reduce"),
                 (1000.0, 4, "all-gather")):
        assert fleet._ring_wire(*args) == jfleet._ring_wire(*args)
    model = fleet.comm_bytes_model("kmeans", k=7, d=4)
    none = fleet.comm_crosscheck(model, types.SimpleNamespace(
        collective_bytes=None, collectives=None))
    jnone = jfleet.comm_crosscheck(model, types.SimpleNamespace(
        collective_bytes=None, collectives=None))
    assert none == jnone and none["agree"] is None
    with pytest.raises(ValueError, match="unknown family"):
        fleet.comm_bytes_model("nope", k=2, d=2)


def test_fleet_barrier_is_synced_on_two_ranks(world):
    for res in world:
        assert res["barrier"] == [({"tag": "fit-start", "synced": True},
                                   False)]
        assert res["collective_spans"] == [
            {"op": "barrier", "site": "fleet_barrier:fit-start"}]
