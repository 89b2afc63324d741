"""The serving engine and the product quantizer on a ``torch.distributed``
mesh.

One world of two gloo ranks is spawned for the module (the helpers of
``test_torch_distributed.py``); each rank holds the same models and serves
the same requests on one device and on the meshes ``data2`` (2 x 1) and
``model2`` (1 x 2):

* ``ServingEngine``: ``predict`` (1 row and ragged requests, an oversize
  one among them), ``score_rows``, ``score``, ``transform``, a float64
  model and a mixture's ``predict`` / ``predict_proba`` /
  ``score_samples`` give the one-device engine's results on every rank:
  labels equal, values to the float64 parity class (the MIN all_reduce of
  ``make_score_rows_fn`` over the model axis included).  On ``data2`` the
  guarded bf16 route (``quantize='bf16'``), the PQ route and packed
  ``predict_multi`` give the one-device labels too.  On ``model2`` the
  quantized and two-level refusals are the JAX package's messages.
* ``ProductQuantizer(mesh=data2)``: with the same initial codebooks, the
  one-device quantizer's codebooks (to the float64 class), iteration
  counts, counts and codes, on both ranks; the JAX package's fit from the
  same codebooks too.
* ``ServingFleet`` on either two-rank mesh (ROADMAP A.21): direct calls,
  a score, queued requests from two threads with one replica killed, a
  reap, and a fleet that sheds by its p99 bound.  Every rank gets the
  one-device fleet's labels (and, for the float64 model, the JAX package's
  fleet's), and both ranks followed rank (0, 0)'s sequence: equal route
  and sequence digests, the same sheds.
* ``ServingEngine(learn=...)`` on either mesh: a forced update and an
  injected regression's rollback give both ranks the same tables, within
  the float64 class of a one-device learner fed the same batches.
* A follower whose own queue timing differs (``max_wait_ms`` apart per
  rank) runs the primary's batches: the same coalescing and digest.
* Engines built and closed one after another on ``data2`` leave no
  process group and no sequencer thread behind.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu_torch.ops import compare as cmp  # noqa: E402
from test_torch_distributed import MESHES, _spawn  # noqa: E402

F64 = dict(rtol=1e-12, atol=1e-10)
N, D, K = 301, 6, 5
#: Request sizes: one row, ragged, a full bucket, and past the top bucket.
SIZES = (1, 7, 64, 150)
BUCKETS = (8, 64, 128)
OPS = ("predict", "score_rows", "transform")
PQ_KW = dict(m=2, k=4, max_iter=15, tolerance=1e-9, seed=3,
             dtype=np.float64)


def _inputs():
    rng = np.random.default_rng(41)
    means = rng.uniform(-6.0, 6.0, size=(K, D))
    X = means[rng.integers(0, K, size=N)] + rng.standard_normal((N, D))
    Q = X[rng.permutation(N)[:SIZES[-1]]] + 0.3 * rng.standard_normal(
        (SIZES[-1], D))
    return X, Q


def _pq_init(X, k, seed):
    """The same initial codebook on every rank and in both packages: the
    subspace's rows 0, 10, 20, ... of the host data (a quantizer on a
    mesh hands its callable init the whole subspace)."""
    return np.asarray(X)[:10 * k:10]


def _models(X):
    """Fitted models on the CPU, each call a fresh copy (``add_model``
    re-points a model to its engine's mesh)."""
    from kmeans_tpu_torch import GaussianMixture, KMeans
    km32 = KMeans(k=K, seed=0, max_iter=10, dtype=np.float32,
                  device="cpu", verbose=False).fit(X)
    km64 = KMeans(k=K, seed=0, max_iter=10, dtype=np.float64,
                  distance_mode="matmul", device="cpu",
                  verbose=False).fit(X)
    gm = GaussianMixture(n_components=3, covariance_type="diag",
                         max_iter=5, seed=0, dtype=np.float64,
                         device="cpu").fit(X)
    return km32, km64, gm


def _serve(eng, models, Q, quantized: bool):
    """Every op of every resident model on every request size."""
    import copy
    km32, km64, gm = models
    eng.add_model("km32", copy.deepcopy(km32))
    eng.add_model("km64", copy.deepcopy(km64))
    eng.add_model("gm", copy.deepcopy(gm))
    out = {}
    for m in SIZES:
        rows = Q[:m]
        for mid in ("km32", "km64"):
            for op in OPS:
                out[mid, op, m] = eng.call(mid, rows, op=op)
            out[mid, "score", m] = eng.score(mid, rows)
        for op in ("predict", "predict_proba", "score_samples"):
            out["gm", op, m] = eng.call("gm", rows, op=op)
    if quantized:
        eng.add_model("bf16", copy.deepcopy(km32), quantize="bf16")
        eng.add_model("pq", copy.deepcopy(km64), quantize="pq")
        for m in SIZES:
            out["bf16", "predict", m] = eng.call("bf16", Q[:m])
            out["pq", "predict", m] = eng.call("pq", Q[:m])
        out["bf16_corrected"] = eng._rm("bf16").bf16_corrected_rows
        before = eng.packed_dispatches
        out["packed"] = eng.predict_multi(
            [("km32", Q[:40]), ("bf16", Q[40:100]), ("km32", Q[100:])])
        out["packed_dispatches"] = eng.packed_dispatches - before
    return out


def _refusals(eng, models):
    import copy
    from kmeans_tpu_torch import KMeans
    X, _ = _inputs()
    km32 = models[0]
    errors = {}
    for q in ("bf16", "pq"):
        try:
            eng.add_model(f"q_{q}", copy.deepcopy(km32), quantize=q)
            errors[q] = None
        except ValueError as e:
            errors[q] = str(e)
    tl = KMeans(k=K, seed=0, max_iter=5, assign="two_level",
                coarse_cells=2, nprobe=1, dtype=np.float64,
                distance_mode="matmul", device="cpu", verbose=False).fit(X)
    try:
        eng.add_model("two_level", tl)
        errors["two_level"] = None
    except ValueError as e:
        errors["two_level"] = str(e)
    errors["resident"] = eng.models()
    return errors


#: The fleet's traffic: direct calls cycling through the sizes and both
#: models, then queued requests from two threads.
FLEET_CALLS = 20
FLEET_QUEUED = 24


def _fleet_run(mesh, models, Q):
    """The fleet's scenario on ``mesh`` (None: one device)."""
    import copy
    import threading
    from kmeans_tpu_torch.serving import FleetOverloadError, ServingFleet
    km32, km64, _ = models
    out = {}
    with ServingFleet(2, device="cpu", mesh=mesh, buckets=BUCKETS,
                      quality=False, max_wait_ms=2.0) as fleet:
        fleet.add_model("km32", copy.deepcopy(km32))
        fleet.add_model("km64", copy.deepcopy(km64))
        fleet.warmup()
        for i in range(FLEET_CALLS):
            mid = ("km32", "km64")[i % 2]
            out["call", i] = fleet.call(mid, _fleet_rows(Q, i))
        out["score"] = fleet.score("km64", Q[:64])
        got = {}

        def submitter(t):
            futs = [(i, fleet.submit("km64", _fleet_rows(Q, i)))
                    for i in range(t, FLEET_QUEUED, 2)]
            for i, fut in futs:
                got[i] = fut.result(timeout=60)

        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(2)]
        for t in threads:
            t.start()
        fleet.kill_replica("r1")
        for t in threads:
            t.join()
        out["queued"] = got
        out["reaped"] = fleet.reap()
        st = fleet.stats()
        out["served"] = st["routes"] - st["sheds"] - st["redispatches"]
        out["route_digest"] = fleet.route_digest
        out["seq_digest"] = fleet._seq.digest
    # Latency histograms are process-wide by replica name: a cold start.
    from kmeans_tpu_torch.obs import metrics_registry
    metrics_registry.REGISTRY.reset()
    with ServingFleet(2, device="cpu", mesh=mesh, buckets=BUCKETS,
                      quality=False, start=False,
                      slo_p99_ms=1e-9) as fleet:
        fleet.add_model("km64", copy.deepcopy(km64))
        fleet.warmup()
        shed = []
        for i in range(FLEET_CALLS):
            try:
                fleet.call("km64", Q[:1])
                shed.append(False)
            except FleetOverloadError:
                shed.append(True)
        out["shed"] = shed
        out["shed_digest"] = fleet.route_digest
    return out


def _fleet_rows(Q, i):
    lo = (7 * i) % 100
    return Q[lo:lo + SIZES[i % len(SIZES)]]


def _learn_model(X):
    from kmeans_tpu_torch import MiniBatchKMeans
    return MiniBatchKMeans(k=K, seed=0, batch_size=128, max_iter=5,
                           dtype=np.float64, distance_mode="matmul",
                           device="cpu", verbose=False).fit(X)


def _learn_run(model, rows, mesh, learn_dir):
    """Serve-and-learn on ``mesh`` (None: one device): three 512-row
    requests, a forced update, one more request, then an injected
    regression judged now: the rollback.  ``min_rows`` holds the drift
    monitor's own updates off: on one device they run on a thread, at a
    time the reference could not repeat."""
    from kmeans_tpu_torch.serving import ServingEngine
    from kmeans_tpu_torch.utils import faults
    out = {}
    with ServingEngine(device="cpu", mesh=mesh, start=False, quality=True,
                       buckets=(8, 64, 512),
                       learn={"dir": learn_dir, "min_rows": 1 << 30}) as eng:
        eng.add_model("mb", model)
        ln = eng._rm("mb").learner
        for i in range(3):
            out["labels", i] = eng.call("mb", rows[512 * i:512 * (i + 1)])
        out["update"] = ln.update_now(force=True)["action"]
        out["updated"] = (model.centroids.copy(),
                          model._centroids_f64.copy(), model._seen.copy())
        out["labels", 3] = eng.call("mb", rows[1536:2048])
        with faults.inject_quality_regression("mb"):
            ln.evaluate_now(force=True)
        out["rolled_back"] = (model.centroids.copy(),
                              model._centroids_f64.copy(),
                              model._seen.copy())
        out["actions"] = [d["action"] for d in ln.status()["decisions"]]
        out["restored_from"] = [r.restored_from for r in ln.rollbacks]
        out["applied"] = [np.stack(b) for b in ln.applied_batches]
    return out


def _learn_rows(X):
    rng = np.random.default_rng(8)
    return X[rng.integers(0, N, 2048)] + 0.5 * rng.standard_normal(
        (2048, D))


def _timing_run(mesh, models, Q, max_wait_ms):
    """Queued requests from one thread on an engine whose timer differs per
    rank: the batches are the primary's."""
    import copy
    from kmeans_tpu_torch.serving import ServingEngine
    with ServingEngine(device="cpu", mesh=mesh, buckets=BUCKETS,
                       quality=False, max_wait_ms=max_wait_ms) as eng:
        eng.add_model("km64", copy.deepcopy(models[1]))
        futs = [eng.submit("km64", _fleet_rows(Q, i)) for i in range(16)]
        labels = [f.result(timeout=60) for f in futs]
        eng.queue.close()
        return dict(labels=labels, hist=eng.queue.stats()["coalesce_hist"],
                    seq_digest=eng._seq.digest)


def _lifecycle_run(mesh, models, Q, engines=4):
    """Engines built and closed one after another on ``mesh``, each serving
    the same request three times in one queued batch: the labels, and the
    process groups and sequencer threads left once every engine closed."""
    import copy
    import threading

    import torch.distributed.distributed_c10d as c10d

    from kmeans_tpu_torch.serving import ServingEngine
    from kmeans_tpu_torch.serving.batching import SEQUENCER_THREAD

    def sequencers():
        return sum(t.name == SEQUENCER_THREAD and t.is_alive()
                   for t in threading.enumerate())
    before = (len(c10d._world.pg_map), sequencers())
    labels = []
    for _ in range(engines):
        with ServingEngine(device="cpu", mesh=mesh, buckets=BUCKETS,
                           quality=False, max_wait_ms=50.0) as eng:
            eng.add_model("km64", copy.deepcopy(models[1]))
            futs = [eng.submit("km64", _fleet_rows(Q, 1)) for _ in range(3)]
            labels.append([f.result(timeout=60) for f in futs])
            hist = eng.queue.stats()["coalesce_hist"]
    return dict(labels=labels, hist=hist, before=before,
                after=(len(c10d._world.pg_map), sequencers()))


def _multi_rank(meshes, models, X, Q, rank, out_dir):
    """The fleet and serve-and-learn on each two-rank mesh (A.21), and the
    follower with its own queue timing."""
    import os
    out = {}
    learn_model = _learn_model(X)
    out["learn_state"] = learn_model._state_dict()
    for name in ("data2", "model2"):
        out["fleet", name] = _fleet_run(meshes[name], models, Q)
        out["learn", name] = _learn_run(
            _learn_model_copy(learn_model), _learn_rows(X), meshes[name],
            os.path.join(out_dir, f"learn_{name}"))
    out["timing"] = _timing_run(meshes["data2"], models, Q,
                                1.0 if rank == 0 else 500.0)
    out["lifecycle"] = _lifecycle_run(meshes["data2"], models, Q)
    return out


def _learn_model_copy(model):
    import copy
    return copy.deepcopy(model)


def _world(rank, out_dir):
    from kmeans_tpu_torch import KMeans, ProductQuantizer
    from kmeans_tpu_torch.parallel.mesh import make_mesh
    from kmeans_tpu_torch.serving import ServingEngine
    X, Q = _inputs()
    meshes = {name: make_mesh(*shape, ranks=ranks)
              for name, (shape, ranks) in MESHES.items() if name != "dm22"}
    models = _models(X)
    res = {"km32_centroids": models[0].centroids}
    for name in (None, "data2", "model2"):
        with ServingEngine(device="cpu", buckets=BUCKETS, start=False,
                           quality=False,
                           mesh=meshes.get(name)) as eng:
            res["serve", name] = _serve(eng, models, Q, name != "model2")
            if name == "model2":
                res["refusals"] = _refusals(eng, models)
    res["multi_rank"] = _multi_rank(meshes, models, X, Q, rank, out_dir)

    # The quantizer on the data axis against one device, and each member
    # against a standalone KMeans on the same mesh.
    for name in (None, "data2"):
        pq = ProductQuantizer(init=_pq_init, device="cpu",
                              mesh=meshes.get(name), **PQ_KW).fit(X)
        res["pq", name] = (pq.codebooks_, pq.n_iters_, pq.counts_,
                           pq.subspace_inertias_, pq.encode(X))
    seeds = pq._member_seeds(PQ_KW["m"])
    d_sub = D // PQ_KW["m"]
    res["pq_standalone"] = [
        KMeans(k=PQ_KW["k"], max_iter=PQ_KW["max_iter"],
               tolerance=PQ_KW["tolerance"], seed=seeds[j], init=_pq_init,
               empty_cluster="keep", dtype=np.float64, host_loop=False,
               distance_mode="matmul", device="cpu", verbose=False,
               mesh=meshes["data2"]).fit(
                   X[:, j * d_sub:(j + 1) * d_sub]).centroids
        for j in range(PQ_KW["m"])]
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _spawn(_world, 2, tmp_path_factory.mktemp("serving_mesh"))


def _same(got, want, key, atol32):
    """Labels equal; float64 values to the float64 parity class; float32
    values (the float32 model's ``score_rows``, squared ``transform`` and
    ``score``) to ``ops.compare``'s mind2 class, whose absolute part
    ``atol32`` scales with ``|x|^2 + |c|^2``: the model axis takes each
    block's distances in another association than one device does."""
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=str(key))
    elif key[-3] == "km32":
        op, m = key[-2], key[-1]
        if op == "transform":
            got, want = got.astype(np.float64) ** 2, \
                want.astype(np.float64) ** 2
        np.testing.assert_allclose(
            got, want, rtol=cmp.MIND2_RTOL,
            atol=atol32 * (m if op == "score" else 1), err_msg=str(key))
    else:
        np.testing.assert_allclose(got, want, err_msg=str(key), **F64)


@pytest.mark.parametrize("mesh", ["data2", "model2"])
def test_engine_on_a_mesh_serves_the_one_device_results(world, mesh):
    """Every rank's results equal the one-device engine's: labels equal,
    float64 values to the parity class, float32 values to the mind2 class
    (the rank's rows go through the same passes; the model axis adds a
    MIN all_reduce of the blocks' nearest distances)."""
    _, Q = _inputs()
    for res in world:
        one, got = res["serve", None], res["serve", mesh]
        atol32 = cmp.mind2_atol(torch.from_numpy(Q),
                                torch.from_numpy(res["km32_centroids"]))
        assert set(got) <= set(one)
        keys = [k for k in one if k in got and len(k) == 3]
        assert len(keys) == len(SIZES) * (2 * (len(OPS) + 1) + 3) + (
            0 if mesh == "model2" else 2 * len(SIZES))
        for key in keys:
            _same(got[key], one[key], (mesh,) + key, atol32)
        for m in SIZES:
            assert got["km64", "predict", m].dtype == np.int32
            assert got["km64", "score_rows", m].shape == (m,)
            assert got["km64", "transform", m].shape == (m, K)
    for key, value in world[0]["serve", mesh].items():
        if len(key) == 3:
            _same(world[1]["serve", mesh][key], value,
                  ("rank 1", mesh) + key, 0.0)


def test_packed_and_quantized_routes_on_the_data_axis(world):
    """On the data axis the guarded bf16 route serves the float32 labels,
    the PQ route the one-device ADC labels, and a routed batch of a dense
    and a quantized model is one packed dispatch with the one-device
    results."""
    for res in world:
        one, got = res["serve", None], res["serve", "data2"]
        assert got["packed_dispatches"] == one["packed_dispatches"] == 1
        for m in SIZES:
            np.testing.assert_array_equal(got["bf16", "predict", m],
                                          one["km32", "predict", m])
            np.testing.assert_array_equal(got["pq", "predict", m],
                                          one["pq", "predict", m])
        assert got["bf16_corrected"] == one["bf16_corrected"]
        for a, b in zip(got["packed"], one["packed"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            np.concatenate([got["packed"][0], got["packed"][2]]),
            np.concatenate([one["km32", "predict", 64][:40],
                            got["km32", "predict", 150][100:]]))


def test_model_axis_refusals_are_the_jax_packages(world):
    """On a model axis ``quantize`` and a two-level model are refused with
    the JAX package's messages, and nothing refused stays resident."""
    import jax
    import kmeans_tpu
    from kmeans_tpu.serving import ServingEngine as JaxEngine
    X, _ = _inputs()
    jmesh = kmeans_tpu.make_mesh(data=1, model=2,
                                 devices=jax.devices()[:2])
    jkm = kmeans_tpu.KMeans(k=K, seed=0, max_iter=5, mesh=jmesh,
                            verbose=False).fit(X.astype(np.float32))
    want = {}
    with JaxEngine(mesh=jmesh, start=False, quality=False) as jeng:
        for q in ("bf16", "pq"):
            with pytest.raises(ValueError) as e:
                jeng.add_model(f"q_{q}", jkm, quantize=q)
            want[q] = str(e.value)
        tl = kmeans_tpu.KMeans(k=K, seed=0, max_iter=5, assign="two_level",
                               coarse_cells=2, nprobe=1, verbose=False,
                               mesh=kmeans_tpu.make_mesh(
                                   data=1, model=1,
                                   devices=jax.devices()[:1])).fit(X)
        with pytest.raises(ValueError) as e:
            jeng.add_model("two_level", tl)
        want["two_level"] = str(e.value)
        want["resident"] = jeng.models()
    assert want.pop("resident") == []
    for res in world:
        got = dict(res["refusals"])
        assert sorted(got.pop("resident")) == ["gm", "km32", "km64"]
        assert got == want


def test_product_quantizer_on_the_data_axis(world):
    """``ProductQuantizer(mesh=data2)`` from the same initial codebooks:
    the one-device quantizer's codebooks, iteration counts, counts,
    inertias and codes on both ranks, each member the centroids of a
    standalone ``KMeans`` on the same mesh, and the JAX package's fit."""
    import kmeans_tpu
    X, _ = _inputs()
    ref = kmeans_tpu.ProductQuantizer(
        init=_pq_init, mesh=kmeans_tpu.make_mesh(data=1, model=1),
        **PQ_KW).fit(X)
    for res in world:
        one, got = res["pq", None], res["pq", "data2"]
        np.testing.assert_allclose(got[0], one[0], **F64)
        np.testing.assert_array_equal(got[1], one[1])
        np.testing.assert_array_equal(got[2], one[2])
        np.testing.assert_allclose(got[3], one[3], **F64)
        np.testing.assert_array_equal(got[4], one[4])
        for j, cents in enumerate(res["pq_standalone"]):
            np.testing.assert_array_equal(got[0][j], cents)
        np.testing.assert_allclose(got[0], ref.codebooks_, **F64)
        np.testing.assert_array_equal(got[1], ref.n_iters_)
        np.testing.assert_array_equal(got[2], ref.counts_)
        np.testing.assert_array_equal(got[4], ref.encode(X))


@pytest.fixture(scope="module")
def one_device_fleet():
    X, Q = _inputs()
    return _fleet_run(None, _models(X), Q)


def _jax_fleet_labels(Q, km64, tmp_path):
    """The JAX package's fleet on the float64 model (saved by the port,
    loaded by the JAX package), over the fleet's direct and queued
    requests."""
    import jax
    import kmeans_tpu
    from kmeans_tpu.serving import ServingFleet as JaxFleet
    path = tmp_path / "km64.npz"
    km64.save(path)
    mesh1 = kmeans_tpu.make_mesh(data=1, model=1, devices=jax.devices()[:1])
    with JaxFleet(2, mesh=mesh1, quality=False, start=False,
                  buckets=BUCKETS) as jfleet:
        jfleet.load(path, "km64")
        jfleet.warmup()
        calls = {i: np.asarray(jfleet.call("km64", _fleet_rows(Q, i)))
                 for i in range(1, FLEET_CALLS, 2)}
        queued = {i: np.asarray(jfleet.call("km64", _fleet_rows(Q, i)))
                  for i in range(FLEET_QUEUED)}
    return calls, queued


def test_fleet_and_learn_refuse_a_multi_rank_mesh(world, one_device_fleet,
                                                  tmp_path):
    """``ServingFleet`` on each two-rank mesh (``data2``, ``model2``):
    every rank's direct, queued (two threads, one replica killed) and
    scored results are the one-device fleet's (labels equal, the float64
    score to the parity class) and, for the float64 model, the JAX
    package's fleet's labels; both ranks routed, shed and ran the same
    sequence (equal digests, the same sheds).  Serve-and-learn on both
    meshes: ``test_serve_and_learn_on_a_multi_rank_mesh``."""
    import kmeans_tpu_torch
    X, Q = _inputs()
    jcalls, jqueued = _jax_fleet_labels(
        Q, kmeans_tpu_torch.KMeans(k=K, seed=0, max_iter=10,
                                   dtype=np.float64, distance_mode="matmul",
                                   device="cpu", verbose=False).fit(X),
        tmp_path)
    for mesh in ("data2", "model2"):
        _check_fleet(world, one_device_fleet, mesh, jcalls, jqueued)


def _check_fleet(world, one, mesh, jcalls, jqueued):
    got = [res["multi_rank"]["fleet", mesh] for res in world]
    for g in got:
        for i in range(FLEET_CALLS):
            np.testing.assert_array_equal(g["call", i], one["call", i])
            if i in jcalls:
                np.testing.assert_array_equal(g["call", i], jcalls[i])
        np.testing.assert_allclose(g["score"], one["score"], **F64)
        assert sorted(g["queued"]) == list(range(FLEET_QUEUED))
        for i, labels in g["queued"].items():
            np.testing.assert_array_equal(labels, one["queued"][i])
            np.testing.assert_array_equal(labels, jqueued[i])
        assert g["served"] == FLEET_CALLS + 1 + FLEET_QUEUED
        assert g["reaped"] == []
        assert any(g["shed"]) and not all(g["shed"])
        assert g["seq_digest"]
    for key in ("route_digest", "seq_digest", "shed", "shed_digest",
                "served"):
        assert got[0][key] == got[1][key], key


@pytest.mark.parametrize("mesh", ["data2", "model2"])
def test_serve_and_learn_on_a_multi_rank_mesh(world, mesh, tmp_path):
    """A forced update and an injected regression's rollback on a two-rank
    mesh: both ranks publish the same tables (bit-equal), record the same
    decisions, restore what the primary restored from its snapshot file
    (only the primary wrote one), and match a one-device learner fed the
    same batches (float64 class)."""
    from kmeans_tpu_torch import MiniBatchKMeans
    X, _ = _inputs()
    got = [res["multi_rank"]["learn", mesh] for res in world]
    for key in ("updated", "rolled_back"):
        for a, b in zip(got[0][key], got[1][key]):
            np.testing.assert_array_equal(a, b)
    for key in ("actions", "restored_from", "update"):
        assert got[0][key] == got[1][key], key
    assert got[0]["update"] == "update"
    assert got[0]["actions"] == ["update", "rollback"]
    assert got[0]["restored_from"] == ["primary"]
    model = MiniBatchKMeans._from_state(world[0]["multi_rank"]["learn_state"],
                                        device="cpu")
    want = _learn_run(model, _learn_rows(X), None, str(tmp_path))
    for g in got:
        for a, b in zip(g["applied"], want["applied"]):
            np.testing.assert_array_equal(a, b)
        for key in ("updated", "rolled_back"):
            for a, b in zip(g[key], want[key]):
                np.testing.assert_allclose(a, b, **F64)
        for i in range(4):
            np.testing.assert_array_equal(g["labels", i],
                                          want["labels", i])
    # The rollback restored the pre-update table.
    np.testing.assert_array_equal(got[0]["rolled_back"][1],
                                  want["rolled_back"][1])


def test_a_follower_runs_the_primary_batches(world):
    """Rank 1's queue waits 500 ms, rank 0's 1 ms: the follower forms no
    batch of its own and runs rank 0's, so both ranks coalesce alike,
    follow the same sequence and serve the one-device labels."""
    import kmeans_tpu_torch
    X, Q = _inputs()
    km64 = kmeans_tpu_torch.KMeans(k=K, seed=0, max_iter=10,
                                   dtype=np.float64, distance_mode="matmul",
                                   device="cpu", verbose=False).fit(X)
    got = [res["multi_rank"]["timing"] for res in world]
    assert got[0]["hist"] == got[1]["hist"]
    assert got[0]["seq_digest"] == got[1]["seq_digest"]
    for g in got:
        for i, labels in enumerate(g["labels"]):
            np.testing.assert_array_equal(labels,
                                          km64.predict(_fleet_rows(Q, i)))


def test_engines_built_and_closed_on_a_mesh_leave_nothing(world):
    """Four engines built and closed one after another on ``data2``: each
    closed engine releases its sequencer's process group and thread, and
    the same request queued three times forms one batch on both ranks (a
    follower waits for all three of its equal requests)."""
    import kmeans_tpu_torch
    X, Q = _inputs()
    km64 = kmeans_tpu_torch.KMeans(k=K, seed=0, max_iter=10,
                                   dtype=np.float64, distance_mode="matmul",
                                   device="cpu", verbose=False).fit(X)
    want = km64.predict(_fleet_rows(Q, 1))
    for g in (res["multi_rank"]["lifecycle"] for res in world):
        assert g["after"] == g["before"]
        assert g["hist"] == {3: 1}
        assert len(g["labels"]) == 4
        for labels in g["labels"]:
            for got in labels:
                np.testing.assert_array_equal(got, want)
