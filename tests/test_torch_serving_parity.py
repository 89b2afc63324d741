"""The port's serving engine (``kmeans_tpu_torch.serving``) on the CPU,
case by case the JAX package's tests/test_serving_parity.py (without the
``serve`` CLI, ROADMAP A.14, and without the model-axis mesh cases): for
every family the engine's labels are bit-equal to the port model's own
``predict`` and equal to the JAX engine's labels for the same tables (the
JAX model converted with ``convert.from_jax_state``); the bf16 guard
corrects near-ties exactly; packed routing equals sequential routing; the
mixture's ``predict_proba`` and ``score_samples`` agree with the JAX
engine's to the float64 parity class; registry round trips, specs and
messages equal the JAX package's; warm-up stays out of the stats.  JAX
engines run with ``start=False`` (no worker thread)."""

import json

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu.serving import ServingEngine as JaxEngine  # noqa: E402
import kmeans_tpu_torch as kt  # noqa: E402
from kmeans_tpu_torch import convert  # noqa: E402
from kmeans_tpu_torch.serving import (ModelRegistry,  # noqa: E402
                                      ServingEngine, load_fitted)
from kmeans_tpu_torch.serving import engine as engine_mod  # noqa: E402
from kmeans_tpu_torch.utils import checkpoint as pt_ckpt  # noqa: E402

F64 = dict(rtol=1e-12, atol=1e-10)


@pytest.fixture(scope="module")
def data():
    X, _ = make_blobs(n_samples=3000, centers=6, n_features=8,
                      random_state=3)
    return X.astype(np.float32)


def _engine(**kw):
    kw.setdefault("start", False)
    kw.setdefault("quality", False)
    return ServingEngine(device="cpu", **kw)


def _jax_engine(mesh1):
    return JaxEngine(mesh=mesh1, start=False, quality=False)


#: (JAX class, port class, constructor arguments) of each family.
FAMILIES = {
    "kmeans": ("KMeans", dict(k=5, seed=0, max_iter=25)),
    "minibatch": ("MiniBatchKMeans", dict(k=5, seed=0, batch_size=256,
                                          max_iter=30)),
    "bisecting": ("BisectingKMeans", dict(k=5, seed=0)),
    "spherical": ("SphericalKMeans", dict(k=5, seed=0, max_iter=25)),
    "gmm": ("GaussianMixture", dict(n_components=4, seed=0, max_iter=30)),
}


def _port(name, **kw):
    cls, base = FAMILIES[name]
    extra = {} if name == "gmm" else {"verbose": False}
    return getattr(kt, cls)(device="cpu", **{**base, **extra, **kw})


def _jax_and_port(name, X, mesh1, **kw):
    """A JAX model fitted on X, and its conversion into the port."""
    cls, base = FAMILIES[name]
    extra = {} if name == "gmm" else {"verbose": False}
    jm = getattr(kmeans_tpu, cls)(mesh=mesh1, **{**base, **extra,
                                                 **kw}).fit(X)
    return jm, convert.from_jax_state(jm._state_dict(), device="cpu")


@pytest.fixture(scope="module")
def converted(data, mesh1):
    return {name: _jax_and_port(name, data, mesh1) for name in FAMILIES}


@pytest.mark.parametrize("rows", ["1", "ragged"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_serving_labels_bitequal_to_predict(family, rows, data, converted,
                                            mesh1):
    jm, pm = converted[family]
    sizes = (1,) if rows == "1" else (7, 64, 300, 4097)
    with _engine() as eng, _jax_engine(mesh1) as jeng:
        eng.add_model("m", pm)
        jeng.add_model("m", jm)
        for m_rows in sizes:
            probe = data[:m_rows]
            want = pm.predict(probe)
            got = eng.predict("m", probe)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, jeng.predict("m", probe))
            fut = eng.submit("m", probe)     # queued path, same contract
            eng.queue.service(now=float("inf"))
            np.testing.assert_array_equal(fut.result(0), want)


def test_gmm_proba_and_score_samples_parity(data, mesh1):
    X = data.astype(np.float64)
    jm, pm = _jax_and_port("gmm", X, mesh1, dtype=np.float64,
                           covariance_type="diag", init_params="random")
    with _engine() as eng, _jax_engine(mesh1) as jeng:
        eng.add_model("gm", pm)
        jeng.add_model("gm", jm)
        probe = X[:123]
        for op, own in (("predict", pm.predict),
                        ("predict_proba", pm.predict_proba),
                        ("score_samples", pm.score_samples)):
            fut = eng.submit("gm", probe, op=op)
            eng.queue.service(now=float("inf"))
            got = fut.result(0)
            np.testing.assert_array_equal(got, own(probe))
            want = jeng.call("gm", probe, op=op)
            if op == "predict":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, **F64)
        assert eng.score("gm", probe) == pm.score(probe)
        np.testing.assert_allclose(eng.score("gm", probe),
                                   jeng.score("gm", probe), **F64)


@pytest.mark.parametrize("cov", ["full", "tied", "spherical"])
def test_gmm_covariance_types_serve(cov, data, mesh1):
    jm, pm = _jax_and_port("gmm", data, mesh1, n_components=3,
                           covariance_type=cov)
    with _engine() as eng, _jax_engine(mesh1) as jeng:
        eng.add_model("gm", pm)
        jeng.add_model("gm", jm)
        probe = data[:57]
        np.testing.assert_array_equal(eng.predict("gm", probe),
                                      pm.predict(probe))
        np.testing.assert_array_equal(eng.predict("gm", probe),
                                      jeng.predict("gm", probe))


def test_bf16_fast_path_labels_exact_distances_rtol(data):
    km = _port("kmeans").fit(data)
    with _engine() as eng:
        rm = eng.add_model("q", km, quantize="bf16")
        assert rm.quantize == "bf16"
        probe = data[:400]
        np.testing.assert_array_equal(eng.predict("q", probe),
                                      km.predict(probe))
        report = eng.verify_quantized("q", probe)
        assert report["labels_equal"] and report["label_mismatches"] == 0
        assert 0.0 < report["dist_max_rel"] < 0.05
        with pytest.raises(ValueError, match="quantize"):
            eng.add_model("bad", km, quantize="int4")


def _midpoints(C, rng=None, nudge=1e-4):
    C = np.asarray(C, np.float64)
    mids = []
    for i in range(len(C)):
        for j in range(i + 1, len(C)):
            mid = (C[i] + C[j]) / 2.0
            if rng is not None:
                mid = mid * (1.0 + nudge * rng.standard_normal())
            mids.append(mid)
    return np.asarray(mids, np.float32)


def test_bf16_near_tie_rows_corrected_exactly(data, converted, mesh1):
    """Rows on Voronoi boundaries (centroid-pair midpoints, nudged): the
    guard flags them, relabels them at float32, and the labels equal the
    float32 predict and the JAX engine's guarded labels."""
    jm, km = converted["kmeans"]
    probe = _midpoints(km.centroids, np.random.default_rng(0))
    with _engine() as eng, _jax_engine(mesh1) as jeng:
        rm = eng.add_model("q", km, quantize="bf16")
        jeng.add_model("q", jm, quantize="bf16")
        got = eng.predict("q", probe)
        np.testing.assert_array_equal(got, km.predict(probe))
        np.testing.assert_array_equal(got, jeng.predict("q", probe))
        assert rm.bf16_corrected_rows > 0
        report = eng.verify_quantized("q", probe)
        assert report["labels_equal"] and report["corrected_rows"] > 0
        assert eng.stats()["models"]["q"]["bf16_corrected_rows"] > 0


def test_packed_routing_of_quantized_models_stays_exact(data):
    a = _port("kmeans").fit(data)
    b = _port("kmeans", seed=9).fit(data)
    mids = _midpoints(a.centroids)
    with _engine() as eng:
        eng.add_model("a", a, quantize="bf16")
        eng.add_model("b", b, quantize="bf16")
        outs = eng.predict_multi([("a", mids), ("b", mids)])
        np.testing.assert_array_equal(outs[0], a.predict(mids))
        np.testing.assert_array_equal(outs[1], b.predict(mids))
        assert eng.packed_dispatches == 1
        st = eng.stats()
        assert st["dispatches"] == 1
        assert sum(v["dispatches"]
                   for v in st["batch_fill"].values()) == 1


def test_bf16_differs_from_f32_distances(data):
    km = _port("kmeans").fit(data)
    with _engine() as eng:
        eng.add_model("q", km, quantize="bf16")
        assert eng.verify_quantized("q", data[:200])["dist_max_rel"] > 1e-5


def test_multi_model_routed_batch_matches_sequential(data):
    a = _port("kmeans").fit(data)
    b = _port("kmeans", seed=9).fit(data)
    s = _port("spherical", seed=3).fit(data)
    with _engine() as eng:
        eng.add_model("a", a)
        eng.add_model("b", b)
        eng.add_model("s", s)
        reqs = [("a", data[:40]), ("s", data[40:100]),
                ("b", data[100:110]), ("a", data[110:150])]
        outs = eng.predict_multi(reqs)
        np.testing.assert_array_equal(outs[0], a.predict(data[:40]))
        np.testing.assert_array_equal(outs[1], s.predict(data[40:100]))
        np.testing.assert_array_equal(outs[2], b.predict(data[100:110]))
        np.testing.assert_array_equal(outs[3], a.predict(data[110:150]))
        assert eng.packed_dispatches == 1
        gm = _port("gmm", n_components=3).fit(data)
        eng.add_model("gm", gm)
        outs = eng.predict_multi([("a", data[:20]), ("gm", data[:20])])
        np.testing.assert_array_equal(outs[0], a.predict(data[:20]))
        np.testing.assert_array_equal(outs[1], gm.predict(data[:20]))


def test_kmeans_score_rtol_and_transform_parity(data):
    km = _port("kmeans").fit(data)
    with _engine() as eng:
        eng.add_model("m", km)
        probe = data[:97]
        assert np.isclose(eng.score("m", probe), km.score(probe),
                          rtol=1e-5)
        fut = eng.submit("m", probe, op="transform")
        eng.queue.service(now=float("inf"))
        tile = fut.result(0)
        c = np.asarray(km.centroids, np.float64)
        exact = np.sqrt(((probe.astype(np.float64)[:, None, :]
                          - c[None]) ** 2).sum(-1))
        np.testing.assert_allclose(tile, exact, rtol=1e-4, atol=1e-4)
        mind2 = eng.call("m", probe, op="score_rows")
        np.testing.assert_allclose(mind2, (exact ** 2).min(axis=1),
                                   rtol=1e-4, atol=1e-3)


def test_table_placed_once_and_refit_invalidates(data, monkeypatch):
    """The resident table is uploaded once per ``centroids`` object: a
    refit (a new array) is picked up."""
    km = _port("kmeans", max_iter=10).fit(data)
    calls = []
    orig = kt.KMeans._put_centroids

    def counting(self, cents):
        calls.append(1)
        return orig(self, cents)

    monkeypatch.setattr(kt.KMeans, "_put_centroids", counting)
    with _engine() as eng:
        eng.add_model("m", km)
        eng.predict("m", data[:64])
        eng.predict("m", data[:32])
        eng.call("m", data[:8], op="score_rows")
        assert len(calls) == 1
        km.fit(data)
        calls.clear()
        got = eng.predict("m", data[:64])
        assert len(calls) == 1           # the refit's table, once
        eng.predict("m", data[:8])
        assert len(calls) == 1
        np.testing.assert_array_equal(got, km.predict(data[:64]))


def test_explicit_chunk_size_model_serves_at_bucket_chunk(data):
    big = 65536
    km = _port("kmeans", max_iter=10, chunk_size=big).fit(data)
    ref = _port("kmeans", max_iter=10).fit(data)
    with _engine() as eng:
        rm = eng.add_model("m", km)
        assert eng._serve_chunk(rm, 8) < big
        got = eng.predict("m", data[:3])
        fut = eng.submit("m", data[:3])
        eng.queue.service(now=float("inf"))
        np.testing.assert_array_equal(fut.result(0), got)
        assert all(key[1] < big for key in eng._fns)
    np.testing.assert_array_equal(got, ref.predict(data[:3]))


def test_warmup_excluded_from_stats_bf16_audit(data):
    km = _port("kmeans", k=2, max_iter=5).fit(data)
    cents = np.zeros((2, data.shape[1]), np.float32)
    cents[0, 1], cents[1, 1] = 1.0, -1.0     # equidistant from e1 probes
    km.centroids = cents
    with _engine() as eng:
        eng.add_model("m", km, quantize="bf16")
        assert eng.warmup() == len(eng.buckets)
        st = eng.stats()
        assert st["dispatches"] == 0 and st["batch_fill"] == {}
        assert st["models"]["m"]["bf16_corrected_rows"] == 0
        probe = np.zeros((4, data.shape[1]), np.float32)
        probe[:, 0] = 1.0
        eng.predict("m", probe)
        assert eng.stats()["models"]["m"]["bf16_corrected_rows"] > 0


# ----------------------------------------------------- registry + ckpts


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_registry_load_all_families_roundtrip(tmp_path, data, converted,
                                              writer):
    """Checkpoints of every family, written by either package, load into
    the engine by ``load_fitted`` and serve the writer's labels."""
    with _engine() as eng:
        for name, (jm, pm) in converted.items():
            path = tmp_path / f"{name}.npz"
            (pm if writer == "port" else jm).save(path)
            mid = eng.load(path)
            assert mid == name
            assert type(eng._rm(mid).model).__name__ == FAMILIES[name][0]
            np.testing.assert_array_equal(eng.predict(mid, data[:80]),
                                          pm.predict(data[:80]))
        stats = eng.stats()
        assert stats["models_resident"] == 5
        assert stats["models"]["gmm"]["family"] == "gmm"
        json.dumps(stats)


def test_registry_semantics(tmp_path, data):
    km = _port("kmeans", k=3, max_iter=5).fit(data)
    reg = ModelRegistry()
    reg.register("a", km)
    with pytest.raises(ValueError, match="already resident"):
        reg.register("a", km)
    with pytest.raises(KeyError, match="no resident model"):
        reg.get("zzz")
    with pytest.raises(ValueError, match="fitted"):
        reg.register("b", _port("kmeans", k=3))
    km.save(tmp_path / "a.npz")
    mid, loaded = reg.load(tmp_path / "a.npz", device="cpu")
    assert mid == "a-2" and loaded.device.type == "cpu"
    assert reg.ids() == ["a", "a-2"]
    assert list(reg.pack_groups().values()) == [["a", "a-2"]]
    assert reg.group_ids(reg.group_key(reg.spec("a"))) == ["a", "a-2"]
    reg.remove("a-2")
    assert reg.pack_groups() == {} and len(reg) == 1 and "a" in reg


def test_load_fitted_rejects_unknown_class(tmp_path, data):
    from kmeans_tpu.serving import load_fitted as jax_load_fitted
    km = _port("kmeans", k=3, max_iter=5).fit(data)
    state = km._state_dict()
    state["model_class"] = "FancyModel"
    path = tmp_path / "weird.npz"
    pt_ckpt.save_state(path, state)
    with pytest.raises(ValueError, match="FancyModel") as got:
        load_fitted(path, device="cpu")
    with pytest.raises(ValueError) as want:
        jax_load_fitted(path)
    assert str(got.value) == str(want.value)


def test_fitted_state_specs(data, converted):
    for name, (jm, pm) in converted.items():
        assert pm.fitted_state() == jm.fitted_state(), name
    assert converted["spherical"][1].fitted_state()["normalize_inputs"]
    gspec = converted["gmm"][1].fitted_state()
    assert gspec["family"] == "gmm" and not gspec["stackable"]
    with pytest.raises(ValueError, match="fitted") as got:
        _port("kmeans", k=3).fitted_state()
    with pytest.raises(ValueError) as want:
        kmeans_tpu.KMeans(k=3, verbose=False).fitted_state()
    assert str(got.value) == str(want.value)


# ------------------------------------------------- engine-level behavior


def _failures(eng, data):
    futs = [eng.submit("m", np.zeros((2, 3), np.float32)),
            eng.submit("m", np.full((1, data.shape[1]), np.nan,
                                    np.float32)),
            eng.submit("zzz", data[:1]),
            eng.submit("m", data[:1], op="predict_proba"),
            eng.submit("m", np.zeros((0, data.shape[1]), np.float32))]
    return [str(f.exception(0)) for f in futs]


def test_engine_validation_and_stats(data, converted, mesh1):
    jm, km = converted["kmeans"]
    with _engine() as eng, _jax_engine(mesh1) as jeng:
        eng.add_model("m", km)
        jeng.add_model("m", jm)
        got, want = _failures(eng, data), _failures(jeng, data)
        assert got == want
        for text, match in zip(got, ("rows must be", "non-finite",
                                     "no resident model", "not served",
                                     "at least one row")):
            assert match in text
        good = eng.submit("m", data[:2])
        eng.queue.service(now=float("inf"))
        np.testing.assert_array_equal(good.result(0), km.predict(data[:2]))
        assert eng.predict("m", data[0]).shape == (1,)
        with pytest.raises(ValueError) as e1:
            eng.add_model("m", km)
        with pytest.raises(ValueError) as e2:
            jeng.add_model("m", jm)
        assert str(e1.value) == str(e2.value)
        stats = eng.stats()
        assert stats["models_resident"] == 1
        assert stats["dispatches"] >= 2
        fills = stats["batch_fill"]
        assert fills and all(0 < v["fill"] <= 1 for v in fills.values())
        assert stats["program_memory"] and all(
            r["cache"] == "serving.step_fns" for r in
            stats["program_memory"])
        json.dumps(stats)


def test_engine_warmup_excluded_from_stats(data):
    km = _port("kmeans", k=4, max_iter=10).fit(data)
    with _engine() as eng:
        eng.add_model("m", km)
        assert eng.warmup() == len(eng.buckets)
        st = eng.stats()
        assert st["dispatches"] == 0 and st["batch_fill"] == {}
        assert st["queue"]["dispatches"] == 0


def test_engine_device_staging_and_refusals(data):
    """``device`` as in the estimators, ``add_model`` re-points the
    model, ``donate`` reuses one staging set per bucket shape with the
    same labels, quality 'auto' is off on the CPU, and serve-and-learn
    (ported) needs quality monitoring and takes a dict of overrides."""
    km = _port("kmeans").fit(data)
    with pytest.raises(ValueError, match="drift monitor"):
        ServingEngine(device="cpu", start=False, learn=True)
    with ServingEngine(device="cpu", start=False, quality=True,
                       learn={"dir": "x"}) as learning:
        assert learning._learn_cfg == {"dir": "x"}
        learning.add_model("m", _port("kmeans", k=4, max_iter=10).fit(data))
        assert learning.update_status() == {"m": None}
    with pytest.raises(ValueError, match="quality"):
        ServingEngine(device="cpu", start=False, quality="yes")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingEngine(start=False)
    eng = ServingEngine(device="cpu", start=False)
    assert eng._quality is False and eng._donate is False
    eng.close()
    km.mesh = "stale"
    with _engine(donate=True) as eng, _engine(donate=False) as plain:
        eng.add_model("m", km)
        assert km.device == torch.device("cpu") and km.mesh is None
        plain.add_model("m", km)
        for m_rows in (3, 5, 70, 700):
            np.testing.assert_array_equal(eng.predict("m", data[:m_rows]),
                                          plain.predict("m", data[:m_rows]))
        staged = [r for r in eng.stats()["program_memory"]
                  if r["cache"] == "serving.staging"]
        assert [r["key"][0] for r in staged] == [8, 512, 4096]
        assert all(r["peak_bytes"] > 0 for r in staged)
        assert not any(r["cache"] == "serving.staging"
                       for r in plain.stats()["program_memory"])
        assert eng.update_status() == {"m": None}


def test_quality_on_is_label_exact_and_sinks(tmp_path, data):
    km = _port("kmeans").fit(data)
    probe = data[:700]
    with _engine(quality=True, quality_dir=tmp_path,
                 quality_tag="r0") as on, _engine() as off:
        on.add_model("m", km)
        off.add_model("m", km)
        for lo in range(0, 700, 70):
            np.testing.assert_array_equal(on.predict("m", probe[lo:lo + 70]),
                                          off.predict("m",
                                                      probe[lo:lo + 70]))
        status = on.quality_status()["m"]
        assert status["reference"] and status["windows"] >= 1
        assert off.quality_status() == {"m": None}
    assert (tmp_path / "quality.m.r0.jsonl").is_file()


def test_pq_and_two_level_routes(data):
    km = _port("kmeans", k=12).fit(data)
    tl = _port("kmeans", k=12, assign="two_level", coarse_cells=4,
               nprobe=2).fit(data)
    rows = data[:50]
    with _engine() as eng:
        rm = eng.add_model("pq", km, quantize="pq")
        labels = eng.call("pq", rows)
        decoded = rm.pq.decode(rm.pq_codes)
        oracle = np.argmin(((rows.astype(np.float64)[:, None, :]
                             - decoded[None]) ** 2).sum(-1), axis=1)
        np.testing.assert_array_equal(labels, oracle)
        v = eng.verify_quantized("pq", rows)
        assert "dist_max_rel" in v and v["label_mismatches"] >= 0
        st = eng.stats()["models"]["pq"]
        assert st["quantize"] == "pq" and "pq_corrected_rows" in st
        eng.add_model("tl", tl)
        np.testing.assert_array_equal(eng.call("tl", rows), tl.predict(rows))
        with pytest.raises(ValueError, match="two_level"):
            eng.add_model("tlq", tl, quantize="bf16")
        assert "tlq" not in eng.models()
        assert eng._rm("tl").spec["stackable"] is False
    assert engine_mod.BF16_TIE_RTOL == 2.0 ** -5
