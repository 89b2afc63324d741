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
* ``ServingFleet`` and ``ServingEngine(learn=...)`` on either two-rank
  mesh raise ``NotImplementedError`` naming ROADMAP A.21 on both ranks,
  before any collective: the world's later collectives still pair up.
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


def _multi_rank_refusals(meshes):
    """The A.21 refusals of the fleet and of serve-and-learn on each
    two-rank mesh: the message, or None where nothing was raised."""
    from kmeans_tpu_torch.serving import ServingEngine, ServingFleet
    makers = {
        "fleet": lambda mesh: ServingFleet(2, device="cpu", mesh=mesh,
                                           start=False),
        "learn": lambda mesh: ServingEngine(device="cpu", mesh=mesh,
                                            start=False, quality=True,
                                            learn=True)}
    out = {}
    for name in ("data2", "model2"):
        for what, make in makers.items():
            try:
                make(meshes[name]).close()
                out[what, name] = None
            except NotImplementedError as e:
                out[what, name] = str(e)
    return out


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
    res["multi_rank"] = _multi_rank_refusals(meshes)

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


def test_fleet_and_learn_refuse_a_multi_rank_mesh(world):
    """On a two-rank mesh (data or model axis) the fleet and
    serve-and-learn raise naming ROADMAP A.21, the same on both ranks,
    before any collective: the quantizer fits that the world runs next
    still pair their collectives (the other tests of this module)."""
    for res in world:
        got = res["multi_rank"]
        assert set(got) == {(w, m) for w in ("fleet", "learn")
                            for m in ("data2", "model2")}
        for (what, mesh), msg in got.items():
            assert msg is not None, (what, mesh)
            assert "A.21 'Serving fleet and serve-and-learn on a " \
                "multi-rank mesh'" in msg
            assert "on a mesh of 2 ranks" in msg
            assert msg.startswith("ServingFleet" if what == "fleet"
                                  else "ServingEngine(learn=...)")
    assert world[0]["multi_rank"] == world[1]["multi_rank"]
