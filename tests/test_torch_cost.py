"""Device-cost records of the port (``kmeans_tpu_torch/obs/cost.py``)
against the JAX package's ``obs/cost.py`` and ``tests/test_cost.py``.

On the CPU a record is the degraded form the reference's backends that
cannot report give: the flops are counted (``FlopCounterMode``, the aten
products), the allocator keeps no statistics, so ``peak_bytes`` is None,
``error`` says why and ``available`` is False.  The capture contract is
the reference's: off by default, one record per (cache, key, role), the
fit bit-equal with capture on and off, a measurement that fails never
fails the fit.  The card's records (kernels, device ms, peak bytes) are
held by ``chip_smoke.py``'s phase ``cost``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu_torch import (BisectingKMeans, GaussianMixture,  # noqa: E402
                              KMeans, MiniBatchKMeans, SphericalKMeans, obs)
from kmeans_tpu_torch.obs import cost  # noqa: E402
from kmeans_tpu_torch.obs import trace as trace_mod  # noqa: E402
from kmeans_tpu_torch.models import kmeans as km_mod  # noqa: E402
from kmeans_tpu_torch.ops import _build  # noqa: E402
from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402
from kmeans_tpu_torch.utils.cache import cached_build  # noqa: E402
from kmeans_tpu_torch.utils.profiling import compile_caches  # noqa: E402


def _clear_caches():
    """Empty the step caches: a record is taken at a cache's miss (the
    reference's rule), so a scope that must see a program built starts
    from empty caches (an earlier test may have built the same key)."""
    for cache in compile_caches().values():
        cache.clear()


@pytest.fixture(autouse=True)
def _cold_caches():
    _clear_caches()
    yield


def _X(n=512, d=8, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d))
            + 3.0 * rng.integers(0, 3, size=(n, 1))).astype(dtype)


def _kmeans(**kw):
    base = dict(k=4, max_iter=3, tolerance=1e-30, seed=0, device="cpu",
                empty_cluster="keep", compute_labels=False, verbose=False,
                dtype=np.float64, distance_mode="matmul")
    base.update(kw)
    return KMeans(**base)


FAMILIES = {
    "kmeans": lambda: _kmeans(host_loop=False),
    "spherical": lambda: SphericalKMeans(
        k=4, max_iter=3, tolerance=1e-30, seed=0, device="cpu",
        host_loop=False, empty_cluster="keep", compute_labels=False,
        verbose=False, dtype=np.float64, distance_mode="matmul"),
    "bisecting": lambda: BisectingKMeans(
        k=3, max_iter=3, tolerance=1e-30, seed=0, device="cpu",
        host_loop=False, compute_labels=False, verbose=False,
        dtype=np.float64, distance_mode="matmul"),
    "minibatch": lambda: MiniBatchKMeans(
        k=4, batch_size=128, max_iter=3, tolerance=1e-30, seed=0,
        device="cpu", host_loop=False, compute_labels=False, verbose=False,
        dtype=np.float64, distance_mode="matmul"),
    "gmm": lambda: GaussianMixture(
        n_components=3, covariance_type="diag", max_iter=3, tol=0.0,
        seed=0, init_params="random", host_loop=False, device="cpu",
        verbose=False, dtype=np.float64),
}


def _same(a, b) -> bool:
    if hasattr(a, "means_"):
        return (a.n_iter_ == b.n_iter_
                and np.array_equal(a.means_, b.means_)
                and np.array_equal(a.covariances_, b.covariances_))
    return (a.iterations_run == b.iterations_run
            and np.array_equal(a.centroids, b.centroids))


# ------------------------------------------------------------ capture units


def test_no_collector_is_noop_and_identity():
    assert cost.get_collector() is None
    fn = lambda x: x  # noqa: E731
    assert cost.instrument("c", ("k",), fn) is fn
    tup = (fn, 3)
    assert cost.instrument("c", ("k",), tup) is tup
    # A builder's product without a collector is its plain function.
    step = dist.make_step_fn(chunk_size=8, mode="matmul")
    assert step.__name__ == "step" and not isinstance(
        step, cost._CapturedProgram)


def test_collecting_scope_installs_restores_and_closes(tmp_path):
    with cost.collecting(tmp_path / "c.jsonl") as col:
        assert cost.get_collector() is col
        with cost.collecting() as inner:
            assert cost.get_collector() is inner
        assert cost.get_collector() is col
        col.add(cost.CostRecord(cache="c", key="k", flops=1.0))
    assert cost.get_collector() is None
    assert col.closed and inner.closed
    assert not col.add(cost.CostRecord(cache="c", key="other"))
    lines = (tmp_path / "c.jsonl").read_text().splitlines()
    assert len(lines) == 1 and '"cache": "c"' in lines[0]


def test_collector_dedupes_by_cache_key_role():
    col = cost.CostCollector()
    rec = cost.CostRecord(cache="c", key="k", role=0, available=True,
                          flops=1.0, peak_bytes=10)
    assert col.add(rec)
    assert not col.add(cost.CostRecord(cache="c", key="k", role=0))
    assert col.add(cost.CostRecord(cache="c", key="k", role=1))
    assert len(col.records()) == 2
    assert col.seen(("c", "k", 0)) and not col.seen(("c", "k", 2))
    assert col.by_cache() == {"c": col.records()}
    assert col.max_metrics() == {"mem_peak_bytes": 10, "program_flops": 1.0}


def test_record_fields_are_the_references():
    from kmeans_tpu.obs.cost import CostRecord as JRecord
    ref = JRecord(cache="c", key="k").to_dict()
    got = cost.CostRecord(cache="c", key="k").to_dict()
    assert set(ref) <= set(got)
    assert {k: got[k] for k in ref} == ref
    rec = cost.CostRecord(cache="c", key="k", flops=8.0, bytes_accessed=2.0)
    assert rec.arithmetic_intensity() == 4.0 == rec.to_dict()["ai"]


def test_proxy_captures_once_and_delegates():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 5)))
    w = torch.ones(64, dtype=torch.float64)
    c = x[:3].clone()
    plain = dist.make_step_fn(chunk_size=16, mode="matmul")(x, w, c)
    with cost.collecting() as col:
        # The record is taken at the step cache's miss, named by the cache.
        step = cached_build(km_mod._STEP_CACHE, dist.make_step_fn,
                            chunk_size=16, mode="matmul")
        assert isinstance(step, cost._CapturedProgram)
        assert step.__name__ == "step"          # attributes fall through
        first = step(x, w, c)
        second = step(x, w, c)
    assert torch.equal(first.sums, plain.sums)
    assert torch.equal(second.counts, plain.counts)
    recs = col.records()
    assert len(recs) == 1
    rec = recs[0]
    assert rec.cache == "kmeans._STEP_CACHE" and rec.role is None
    assert rec.key.startswith("('make_step_fn',")
    assert "('chunk_size', 16)" in rec.key and "'matmul'" in rec.key
    assert rec.region == "call" and rec.backend == "cpu"
    assert rec.flops == 4.0 * 64 * 5 * 3 and rec.flops_source == "aten"
    assert rec.arg_bytes == x.nbytes + w.nbytes + c.nbytes
    assert rec.out_bytes > 0 and rec.peak_bytes is None
    assert rec.collective_bytes == 0.0 and rec.collectives == 0
    # A later call (collector closed) still works and adds nothing.
    step(x, w, c)
    assert len(col.records()) == 1


def test_tuple_entries_keep_structure():
    def f(v):
        return v + 1

    def g(v):
        return v * 2
    with cost.collecting() as col:
        a, b, three = cost.instrument("unit", ("t",), (f, g, 3))
        a(torch.ones(4)), b(torch.ones(4))
    assert three == 3
    assert sorted(r.role for r in col.records()) == [0, 1]


def test_registry_write_through_and_trace_event():
    obs.registry().reset()
    x = torch.from_numpy(_X(64, 4))
    w = torch.ones(64, dtype=torch.float64)
    with trace_mod.tracing() as tr, cost.collecting():
        step = cached_build(km_mod._STEP_CACHE, dist.make_step_fn,
                            chunk_size=32, mode="matmul")
        with trace_mod.span("dispatch", tag="unit"):
            step(x, w, x[:3].clone())
    snap = obs.registry().snapshot()
    # The CPU record is the degraded form: counted as unavailable.
    assert snap["cost.unavailable"]["value"] == 1
    assert "cost.captured" not in snap
    events = [r for r in tr.records() if r.get("kind") == "event"
              and r["name"] == "cost.record"]
    assert len(events) == 1
    assert events[0]["attrs"]["available"] is False
    assert events[0]["attrs"]["cache"] == "kmeans._STEP_CACHE"
    spans = {r["id"]: r for r in tr.records() if r.get("kind") == "span"}
    assert spans[events[0]["parent"]]["name"] == "dispatch"
    # The builder ran under a 'trace' span naming it.
    assert [s["attrs"]["builder"] for s in spans.values()
            if s["name"] == "trace"] == ["make_step_fn"]


# ------------------------------------------------------ the five families


@pytest.mark.parametrize("family", list(FAMILIES))
def test_families_capture_the_degraded_cpu_form(family):
    X = _X(768, 8)
    with cost.collecting() as col:
        FAMILIES[family]().fit(X)
    recs = col.records()
    assert recs, family
    for rec in recs:
        assert rec.backend == "cpu" and rec.available is False
        assert rec.peak_bytes is None and rec.temp_bytes is None
        assert "allocator statistics" in rec.error
        assert rec.kernels is None and rec.device_ms is None
        assert rec.launches == {}
    step = max(recs, key=lambda r: r.flops)
    assert step.flops > 0 and step.flops_source == "aten"
    assert step.flops_declared == 0.0 and step.arg_bytes > 0


@pytest.mark.parametrize("family", ["kmeans", "gmm"])
def test_matmul_flops_within_the_band(family):
    """The acceptance pin of the reference: the measured flops of the step
    program within ``FLOPS_AGREEMENT_RTOL`` of the hand formula, on the
    kmeans and gmm 'diag' programs at a single-chunk shape.  In the port
    the 'matmul' pass's aten count is the independent measure."""
    rng = np.random.default_rng(1)
    if family == "kmeans":
        n, d, k = 8192, 128, 64
        X = rng.standard_normal((n, d)).astype(np.float32)
        model = _kmeans(k=k, host_loop=True, chunk_size=n,
                        dtype=np.float32, max_iter=2)
    else:
        n, d, k = 8192, 64, 32
        X = rng.standard_normal((n, d)).astype(np.float32)
        model = GaussianMixture(n_components=k, covariance_type="diag",
                                max_iter=2, tol=0.0, seed=0,
                                init_params="random", host_loop=True,
                                chunk_size=n, device="cpu", verbose=False)
    with cost.collecting() as col:
        model.fit(X)
    step = max(col.records(), key=lambda r: r.flops)
    chk = cost.crosscheck(cost.analytic_step_flops(family, n, d, k,
                                                   chunk=n), step)
    assert chk["agree"], chk
    assert chk["ratio"] == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_capture_parity_fit_unchanged(family):
    """Capture changes no value and launches nothing: the fit under
    ``collecting()`` equals the plain fit bit for bit, with equal launch
    counts (zero on the CPU, where the wrappers take the plain
    versions)."""
    X = _X(600, 6, seed=3)
    _build.reset_launch_counts()
    plain = FAMILIES[family]().fit(X)
    before = dict(_build.LAUNCHES)
    _clear_caches()
    with cost.collecting():
        captured = FAMILIES[family]().fit(X)
    assert _same(plain, captured)
    assert dict(_build.LAUNCHES) == before


def test_device_loop_record_is_one_iteration():
    """A device loop is measured at its first launch, never across a
    graph capture: on the CPU its first eager iteration, one step's
    flops (the reference counts a loop body once)."""
    n, d, k = 640, 8, 4
    with cost.collecting() as col:
        _kmeans(k=k, host_loop=False, max_iter=4, chunk_size=n).fit(
            _X(n, d))
    loop = next(r for r in col.records()
                if r.cache == "kmeans._STEP_CACHE"
                and r.key.startswith("('make_fit_fn',"))
    assert loop.region == "eager"
    assert loop.flops == 4.0 * n * d * k
    assert cost.take_request() is None      # nothing left pending


def test_a_failing_measurement_never_fails_the_fit(monkeypatch):
    def boom():
        raise RuntimeError("counter unavailable")
    monkeypatch.setattr(cost, "_flop_counter", boom)
    X = _X(640, 6, seed=5)
    plain = _kmeans(host_loop=True).fit(X)
    _clear_caches()
    with cost.collecting() as col:
        m = _kmeans(host_loop=True).fit(X)
    assert _same(plain, m)
    recs = col.records()
    assert recs and all(not r.available for r in recs)
    assert all("counter unavailable" in r.error for r in recs)


# ------------------------------------------------------ roofline functions


def test_analytic_crosscheck_roofline_equal_the_references():
    from kmeans_tpu.obs import cost as jcost
    for family in ("kmeans", "spherical", "bisecting", "minibatch", "gmm"):
        for kw in ({}, {"chunk": 100}, {"n_devices": 4}):
            assert cost.analytic_step_flops(family, 1000, 8, 4, **kw) \
                == jcost.analytic_step_flops(family, 1000, 8, 4, **kw)
    for ct in ("diag", "spherical", "full", "tied"):
        assert cost.analytic_step_flops("gmm", 100, 8, 4, cov_type=ct) \
            == jcost.analytic_step_flops("gmm", 100, 8, 4, cov_type=ct)
    for bad in (cost, jcost):
        with pytest.raises(ValueError, match="unknown family"):
            bad.analytic_step_flops("nope", 1, 1, 1)
    for flops in (105.0, 130.0, None):
        got = cost.crosscheck(100.0, cost.CostRecord(
            cache="c", key="k", flops=flops))
        want = jcost.crosscheck(100.0, jcost.CostRecord(
            cache="c", key="k", flops=flops))
        assert got == want
    assert cost.FLOPS_AGREEMENT_RTOL == jcost.FLOPS_AGREEMENT_RTOL
    rec = cost.CostRecord(cache="c", key="k", flops=200.0,
                          bytes_accessed=50.0)
    jrec = jcost.CostRecord(cache="c", key="k", flops=200.0,
                            bytes_accessed=50.0)
    for args in ((100.0, 2.0), (100.0, None), (100.0, 0.0)):
        for peak in (None, 1e-12, 67.0):
            assert cost.roofline_fields(*args, rec, peak) == \
                jcost.roofline_fields(*args, jrec, peak)
            assert cost.roofline_fields(*args, None, peak) == \
                jcost.roofline_fields(*args, None, peak)


# ------------------------------------------------------------ surfaces


def test_heartbeat_cost_fields_with_a_collector_only():
    X = _X(512, 6, seed=11)
    beats = []
    with obs.heartbeat(callback=beats.append):
        _kmeans(host_loop=True).fit(X)
    assert beats and all("mem_peak_bytes" not in b
                         and "program_flops" not in b for b in beats)
    beats.clear()
    with cost.collecting() as col, obs.heartbeat(callback=beats.append):
        # The CPU's records carry no peak: an available record stands in
        # for the card's.
        col.add(cost.CostRecord(cache="make_step_fn", key="card",
                                available=True, flops=2.5e9,
                                peak_bytes=12345))
        _kmeans(host_loop=True).fit(X)
    assert beats
    assert all(b["mem_peak_bytes"] == 12345 for b in beats)
    assert all(b["program_flops"] == 2.5e9 for b in beats)


def test_program_memory_rows_from_the_records():
    from kmeans_tpu_torch.serving import ServingEngine
    X = _X(512, 8, seed=15)
    km = _kmeans(host_loop=True).fit(X)
    gm = FAMILIES["gmm"]().fit(X)
    with cost.collecting():
        with ServingEngine(device="cpu", buckets=(8, 64), start=False,
                           quality=False) as eng:
            eng.add_model("m", km)
            eng.add_model("g", gm)
            eng.warmup()
            rows = eng.stats()["program_memory"]
        serving = [r for r in rows if r["cache"] != "serving.staging"]
        # Records are named by the step cache that kept the program, their
        # keys by its builder.
        assert {r["cache"] for r in serving} == set(
            ServingEngine._SERVING_CACHES)
        builders = {r["key"].split("'")[1] for r in serving}
        assert builders <= set(ServingEngine._SERVING_BUILDERS)
        assert {"make_predict_fn", "make_gmm_predict_fn"} <= builders
        assert all(r["available"] is False and r["peak_bytes"] is None
                   for r in serving)
        assert all(set(r) == {"cache", "key", "role", "peak_bytes",
                              "arg_bytes", "temp_bytes", "code_bytes",
                              "available"} for r in rows)
    # Capture off: the built step functions, nothing measured.
    assert all(r["cache"] == "serving.step_fns"
               for r in eng._program_memory())
