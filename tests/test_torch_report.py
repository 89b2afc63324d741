"""The time-to-first-iteration and cost reports
(``kmeans_tpu_torch/obs/report.py``), the phase ladder and its tables
(``utils/profiling.py``) and ``parallel.distributed.make_estep_phase_fn``,
against the JAX package's ``obs/report.py``, ``utils/profiling.py`` and
``make_estep_phase_fn``.

The pure functions are fed the same span records and the same measure
callables in both packages and must give the same outputs.  A traced fit
of the port yields a ladder; ``device_cost_report(device='cpu')`` runs the
five families.  The card's tables (the fresh-interpreter time to first
iteration, the ladder timed by CUDA events) are ``chip_smoke.py``'s phases
``ttfi`` and ``phase_ladder``.
"""

import itertools
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu_torch import KMeans, obs  # noqa: E402
from kmeans_tpu_torch.obs import report  # noqa: E402
from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402
from kmeans_tpu_torch.utils import profiling  # noqa: E402


def _span(sid, name, t0, t1, parent=None, **attrs):
    rec = {"kind": "span", "name": name, "id": sid, "parent": parent,
           "t0": t0, "t1": t1, "dur": t1 - t0, "tid": 1,
           "process_index": 0, "process_count": 1, "host": "h"}
    if attrs:
        rec["attrs"] = attrs
    return rec


def _event(sid, name, t0, parent=None, **attrs):
    return {"kind": "event", "name": name, "id": sid, "parent": parent,
            "t0": t0, "t1": None, "dur": 0.0, "attrs": attrs}


def _records():
    """A fit's records: placement with two slab stages, a builder, a seed
    with a nested library load, the first dispatch with a graph capture
    and a cost record nested, a segment around a replayed dispatch, spans
    after the first iteration, and a stage that starts after it."""
    return [
        _span(0, "place", 0.0, 0.50, rows=1000, bytes=8000),
        _span(1, "stage", 0.05, 0.20, parent=0, slab=0, slabs=2,
              rows=600, bytes=4800),
        _span(2, "stage", 0.20, 0.45, parent=0, slab=1, slabs=2,
              rows=400, bytes=3200),
        _span(3, "trace", 0.50, 0.51, builder="make_step_fn"),
        _span(4, "seed", 0.51, 0.90, strategy="k-means++", k=4),
        _span(5, "compile", 0.60, 0.70, parent=4, via="load"),
        _span(6, "segment", 0.90, 2.00, index=0),
        _span(7, "dispatch", 0.91, 1.50, parent=6, tag="fit/segment",
              attempt=0),
        _span(8, "compile", 0.95, 1.10, parent=7, via="graph-capture"),
        _event(9, "cost.record", 0.96, parent=7, cache="make_fit_fn",
               available=True, flops=4.0e6, bytes_accessed=2.0e6,
               peak_bytes=1234),
        _event(10, "cost.record", 0.97, parent=7, cache="make_step_fn",
               available=False),
        _span(11, "dispatch", 1.50, 1.90, parent=6, tag="fit/segment",
              attempt=1),
        _span(12, "stage", 1.95, 1.99, parent=6, rows=10, bytes=80),
        _event(13, "cost.record", 0.52, parent=4, cache="make_predict_fn",
               available=True, flops=1.0e3, peak_bytes=99),
    ]


# ------------------------------------------------------- pure functions


def test_report_functions_equal_the_references():
    from kmeans_tpu.obs import report as jreport
    recs = _records()
    assert report.TTFI_PHASES == jreport.TTFI_PHASES
    assert report.ttfi_ladder(recs) == jreport.ttfi_ladder(recs)
    for share in (None, 0.3):
        assert report.time_to_first_iteration(recs, share) == \
            jreport.time_to_first_iteration(recs, share)
    comm = {"per_iteration_bytes": 528388.0,
            "wire_bytes_per_device_per_iteration": 528388.0}
    got = report.time_to_first_iteration(recs, comm_model=comm)
    assert got == jreport.time_to_first_iteration(recs, comm_model=comm)
    assert report.format_phase_table(got) == jreport.format_phase_table(got)
    assert report.merge_cost(recs) == jreport.merge_cost(recs)
    assert report.ingest_breakdown(recs) == jreport.ingest_breakdown(recs)
    rows = report.ingest_breakdown(recs)
    assert [r["slab"] for r in rows] == [0, 1]
    assert report.format_ingest_table(rows) == \
        jreport.format_ingest_table(rows)
    assert report.format_ingest_table([]) == jreport.format_ingest_table([])
    cost_rows = [
        {"family": "kmeans", "program": "make_fit_fn", "flops": 5.5e11,
         "analytic_flops": 1.1e12, "ratio": 0.5, "agree": False,
         "ai": None, "peak_bytes": 1.2e9, "planned_peak_bytes": 1.24e9},
        {"family": "gmm", "program": "make_gmm_step_fn", "flops": None,
         "analytic_flops": 1.3e8, "ratio": None, "ai": 3.5,
         "peak_bytes": None, "planned_peak_bytes": 3.1e6}]
    assert report.format_cost_table(cost_rows) == \
        jreport.format_cost_table(cost_rows)
    assert report.REPORT_SPECS == jreport.REPORT_SPECS


def test_attribution_rules():
    """Self time up to the end of the first dispatch: the nested library
    load and graph capture go to 'compile', not to 'seed' or to the first
    dispatch; the replayed attempt and the late stage count nowhere."""
    ladder = {r["phase"]: r["seconds"]
              for r in report.ttfi_ladder(_records())}
    assert ladder["compile"] == pytest.approx(0.10 + 0.15)
    assert ladder["seed"] == pytest.approx(0.39 - 0.10)
    assert ladder["first_dispatch"] == pytest.approx(0.59 - 0.15)
    assert ladder["stage"] == pytest.approx(0.15 + 0.25)
    assert ladder["place"] == pytest.approx(0.50 - 0.40)
    assert "segment" not in ladder


def test_no_dispatch_raises_as_the_reference():
    from kmeans_tpu.obs import report as jreport
    recs = [r for r in _records() if r.get("name") != "dispatch"]
    with pytest.raises(ValueError) as got:
        report.ttfi_ladder(recs)
    with pytest.raises(ValueError) as want:
        jreport.ttfi_ladder(recs)
    assert str(got.value) == str(want.value)


def test_a_traced_fit_yields_a_ladder(tmp_path):
    from kmeans_tpu_torch.utils.profiling import compile_caches
    for cache in compile_caches().values():
        cache.clear()               # the fit's step functions are built here
    rng = np.random.default_rng(0)
    X = rng.standard_normal((600, 5))
    with obs.tracing(tmp_path / "fit.jsonl") as tr:
        KMeans(k=4, max_iter=3, seed=0, device="cpu", verbose=False,
               dtype=np.float64, distance_mode="matmul",
               init="forgy").fit(X)
    recs = tr.records()
    rows = obs.time_to_first_iteration(recs)
    assert [r["phase"] for r in rows] == list(report.TTFI_PHASES) + [
        "first_dispatch"]
    assert all(r["ms"] >= 0 for r in rows)
    by = {r["phase"]: r["ms"] for r in rows}
    assert by["place"] > 0 and by["stage"] > 0 and by["seed"] > 0
    assert by["trace"] > 0 and by["first_dispatch"] > 0
    # The compile row holds the step cache's misses (their builders' trace
    # spans nested in them); the CPU loads no kernel library.
    compiles = [r for r in recs if r.get("kind") == "span"
                and r["name"] == "compile"]
    assert compiles and by["compile"] > 0
    assert all(r["attrs"]["cache"] == "kmeans._STEP_CACHE"
               and "via" not in r["attrs"] for r in compiles)
    text = obs.format_phase_table(rows)
    assert text.splitlines()[0] == "time-to-first-iteration:"
    # The file written by the tracer reads back to the same table.
    again = obs.time_to_first_iteration(obs.read_jsonl(tmp_path
                                                       / "fit.jsonl"))
    assert [r["ms"] for r in again] == [r["ms"] for r in rows]


# --------------------------------------------------------- the ladder


def _measures(seed):
    """Deterministic measure callables: each rung returns its next
    value of a fixed sequence, cumulative across rungs."""
    rng = np.random.default_rng(seed)
    vals = np.cumsum(rng.uniform(0.001, 0.01, size=(3, 5)), axis=0)
    # The 'assign' rung is noise: its differences mostly negative.
    vals[1] = vals[0] + np.array([-1e-4, -2e-4, -1e-4, 5e-5, -3e-4])
    its = [iter(vals[i]) for i in range(3)]
    return [(label, (lambda it=it: float(next(it))))
            for label, it in zip(("distance", "assign", "reduce"), its)]


def test_ladder_and_tables_equal_the_references():
    from kmeans_tpu.obs.cost import CostRecord as JRecord
    from kmeans_tpu.utils import profiling as jprof

    from kmeans_tpu_torch.obs.cost import CostRecord
    for seed in (0, 1):
        got = profiling.measure_phase_ladder(_measures(seed), reps=5)
        want = jprof.measure_phase_ladder(_measures(seed), reps=5)
        assert got == want
        assert any(r["seconds"] == 0.0 for r in got)    # clamped noise
        for kw in ({}, {"flops_per_iter": 4e9, "peak_tflops": 67.0},
                   {"decision_share": 0.5},
                   {"comm_model": {
                       "per_iteration_bytes": 10.0,
                       "wire_bytes_per_device_per_iteration": 20.0}}):
            assert profiling.phase_ceiling_table(got, **kw) == \
                jprof.phase_ceiling_table(want, **kw)
        rec = CostRecord(cache="c", key="k", flops=8e9, bytes_accessed=2e9)
        jrec = JRecord(cache="c", key="k", flops=8e9, bytes_accessed=2e9)
        assert profiling.phase_ceiling_table(
            got, flops_per_iter=4e9, peak_tflops=67.0, cost_record=rec) == \
            jprof.phase_ceiling_table(want, flops_per_iter=4e9,
                                      peak_tflops=67.0, cost_record=jrec)
    assert profiling.PHASE_DECISION_SHARE == jprof.PHASE_DECISION_SHARE
    flat = [1.0, float("inf"), (float("nan"), {"a": -float("inf")}),
            {"b": [2, "x", None]}]
    assert profiling.sanitize_json(flat) == jprof.sanitize_json(flat)
    json.dumps(profiling.sanitize_json(flat), allow_nan=False)


def test_estep_phase_chain_equals_the_reference():
    import jax
    from kmeans_tpu.parallel import distributed as jdist
    from kmeans_tpu.parallel.mesh import make_mesh
    rng = np.random.default_rng(3)
    X = rng.standard_normal((512, 8)) + 5.0
    W = rng.uniform(0.5, 2.0, size=512)
    C = rng.standard_normal((6, 8)) + 5.0
    assert dist.ESTEP_PHASES == jdist.ESTEP_PHASES
    # (the suite's conftest runs the JAX package with x64 on)
    jmesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    for phase, n_iters in itertools.product(dist.ESTEP_PHASES, (1, 3)):
        want = float(jdist.make_estep_phase_fn(
            jmesh, chunk_size=128, n_iters=n_iters, phase=phase)(X, W, C))
        got = float(dist.make_estep_phase_fn(
            None, chunk_size=128, n_iters=n_iters, phase=phase)(
            torch.from_numpy(X), torch.from_numpy(W), torch.from_numpy(C)))
        np.testing.assert_allclose(got, want, rtol=1e-12)
    with pytest.raises(ValueError) as want:
        jdist.make_estep_phase_fn(jmesh, chunk_size=128, n_iters=1,
                                  phase="reduce", mode="pallas")
    for mode in dist.KERNEL_MODES:
        with pytest.raises(ValueError) as got:
            dist.make_estep_phase_fn(None, chunk_size=128, n_iters=1,
                                     phase="reduce", mode=mode)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="phase must be one of"):
        dist.make_estep_phase_fn(None, chunk_size=128, n_iters=1,
                                 phase="scatter")


def test_estep_phase_rungs_time_on_the_cpu():
    """The ladder over the three rungs runs with the CPU timer (the card
    times the same callables with CUDA events)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((256, 4)))
    w = torch.ones(256, dtype=torch.float64)
    c = x[:5].clone()

    def rung(phase):
        fns = {n: dist.make_estep_phase_fn(None, chunk_size=64, n_iters=n,
                                           phase=phase) for n in (1, 3)}

        def measure():
            t = {}
            for n, fn in fns.items():
                timer = profiling.Timer()
                with timer.measure(sync_on=x):
                    fn(x, w, c)
                t[n] = timer.total
            return (t[3] - t[1]) / 2
        return phase, measure
    ladder = profiling.measure_phase_ladder(
        [rung(p) for p in dist.ESTEP_PHASES], reps=2)
    assert [r["phase"] for r in ladder] == list(dist.ESTEP_PHASES)
    assert all(r["seconds"] >= 0 for r in ladder)


def test_timer_trace_and_timed_call(tmp_path):
    timer = profiling.Timer()
    assert timer.mean == 0.0
    for _ in range(2):
        with timer.measure(sync_on=torch.zeros(1)):
            torch.ones(8).sum()
    assert timer.count == 2 and timer.total > 0 and timer.mean > 0
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(16) @ torch.ones(16)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert "traceEvents" in events
    seconds, out = profiling.timed_call(lambda a: a * 2, torch.ones(3),
                                        warmup=1, iters=2)
    assert seconds >= 0 and torch.equal(out, torch.full((3,), 2.0))


# --------------------------------------------------- device cost report


def test_device_cost_report_runs_the_five_families_on_the_cpu():
    small = {"kmeans": dict(n=1024, d=16, k=8),
             "spherical": dict(n=1024, d=16, k=8),
             "bisecting": dict(n=512, d=16, k=4),
             "minibatch": dict(n=1024, d=16, k=8, batch=256),
             "gmm": dict(n=1024, d=16, k=8)}
    rep = obs.device_cost_report(specs=small, device="cpu")
    assert rep["backend"] == "cpu"
    assert rep["device_memory"]["available"] is False
    rows = {r["family"]: r for r in rep["rows"]}
    assert list(rows) == list(report.REPORT_SPECS)
    for fam, row in rows.items():
        assert row["captured"] >= 1 and row["flops"] > 0, fam
        assert row["available"] is False and row["peak_bytes"] is None
        assert row["planned_peak_bytes"] > 0 and row["ratio"] > 0
    # The 'matmul' passes of kmeans and the mixture count 4 n D k and
    # 8 n D k exactly (the device loop's record is one iteration).
    assert rows["kmeans"]["agree"] and rows["gmm"]["agree"]
    table = obs.format_cost_table(rep["rows"])
    assert table.splitlines()[0] == "device cost:"
    assert len(table.splitlines()) == 2 + 5
    assert [p["family"] for p in rep["plans"]] == list(report.REPORT_SPECS)
