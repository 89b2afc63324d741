"""The port's observability modules against the JAX package's on the CPU:
``obs.trace`` (span and event records, the JSONL and Chrome exports),
``obs.metrics_registry`` (the snapshot JSON), ``obs.identity``,
``obs.drift`` (``QualityMonitor`` windows, PSI, JS, events, the sinks and
the serve-status report), ``utils.profiling.note_dispatch``, and the
serving engine's span and counter names.  The same calls go through both
packages; records are compared after dropping what differs by nature
(timestamps, thread ids)."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu.obs import drift as jax_drift  # noqa: E402
from kmeans_tpu.obs import identity as jax_identity  # noqa: E402
from kmeans_tpu.obs import metrics_registry as jax_metrics  # noqa: E402
from kmeans_tpu.obs import trace as jax_trace  # noqa: E402
from kmeans_tpu.utils import profiling as jax_profiling  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu_torch.obs import drift  # noqa: E402
from kmeans_tpu_torch.obs import identity  # noqa: E402
from kmeans_tpu_torch.obs import metrics_registry  # noqa: E402
from kmeans_tpu_torch.obs import trace  # noqa: E402
from kmeans_tpu_torch.serving import ServingEngine  # noqa: E402
from kmeans_tpu_torch.utils import faults, profiling  # noqa: E402

#: Record fields that differ between two runs by nature.
_VOLATILE = ("t0", "t1", "dur", "tid", "wall0", "pid", "ts")


def _stable(records):
    return [{k: v for k, v in r.items() if k not in _VOLATILE}
            for r in records]


def _script(mod):
    """The same span/event calls against a trace module."""
    with mod.span("serve.flush", model="m", coalesced=2, rows=9):
        with mod.span("serve.request", model="m", op="predict", rows=9,
                      bucket=64):
            mod.event("dispatch.note", label="x")
        with mod.span("dispatch", tag="serve/bf16-margin", rows=9,
                      weird=(1, 2)):
            pass
    with pytest.raises(KeyError):
        with mod.span("dispatch", tag="boom"):
            raise KeyError("k")


def test_trace_records_and_exports_match_the_jax_tracer(tmp_path):
    got_path, want_path = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    with trace.tracing(got_path) as got:
        _script(trace)
    with jax_trace.tracing(want_path) as want:
        _script(jax_trace)
    assert trace.get_tracer() is None and not trace.active()
    assert _stable(got.records()) == _stable(want.records())
    assert trace.SPAN_NAMES == jax_trace.SPAN_NAMES
    got_lines = got_path.read_text().splitlines()
    want_lines = want_path.read_text().splitlines()
    assert len(got_lines) == len(want_lines) == 6
    assert _stable([json.loads(x) for x in got_lines]) == \
        _stable([json.loads(x) for x in want_lines])
    assert _stable(trace.read_jsonl(got_path)) == \
        _stable(jax_trace.read_jsonl(got_path))
    sg = trace.summarize(got.records())
    sw = jax_trace.summarize(want.records())
    assert {k: v["count"] for k, v in sg.items()} == \
        {k: v["count"] for k, v in sw.items()}
    eg = trace.chrome_events(got.records())
    ew = jax_trace.chrome_events(want.records())
    assert [(e["name"], e["ph"]) for e in eg] == \
        [(e["name"], e["ph"]) for e in ew]
    # Disabled: a shared null span, no record, no error.
    with trace.span("dispatch", tag="off") as rec:
        assert rec is None
    trace.event("dispatch.note")


def _metric_calls(reg):
    reg.counter("serve.dispatches").inc()
    reg.counter("serve.rows").inc(37)
    reg.gauge("serve.queue_depth").set(4)
    reg.gauge("serve.queue_depth").add(-1.5)
    h = reg.histogram("serve.latency_ms.m.b64", reservoir=8)
    for v in (3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0, 5.0, 3.0, 5.0):
        h.observe(v)
    return reg


def test_metrics_registry_json_matches_the_jax_registry():
    got = _metric_calls(metrics_registry.MetricsRegistry())
    want = _metric_calls(jax_metrics.MetricsRegistry())
    assert got.names() == want.names()
    assert got.to_json(indent=1) == want.to_json(indent=1)
    assert json.loads(got.to_json())["__identity__"] == identity.identity()
    h = got.histogram("serve.latency_ms.m.b64")
    assert h.percentile(50) == want.histogram(
        "serve.latency_ms.m.b64").percentile(50)
    with pytest.raises(TypeError):
        got.gauge("serve.rows")
    got.reset()
    assert got.snapshot() == {}


def test_identity_and_sink_paths(monkeypatch):
    assert identity.identity() == jax_identity.identity()
    for path in ("trace.jsonl", "a/b.c/trace", "x.tar.gz", "q"):
        assert identity.per_process_path(path, 3) == \
            jax_identity.per_process_path(path, 3)
    # A process group's rank and world size (stubbed: no group here).
    monkeypatch.setattr(identity, "_group_coords", lambda: (2, 4))
    assert identity.identity()["process_index"] == 2
    assert identity.identity()["process_count"] == 4


@pytest.mark.parametrize("index", [0, 1])
def test_host_kill_reads_the_identity(monkeypatch, index):
    """``inject_host_kill`` fires on the process whose identity index it
    names, and on no other."""
    monkeypatch.setattr(faults, "identity",
                        lambda: {"process_index": index,
                                 "process_count": 2, "host": "h"})
    with faults.inject_host_kill(1, after_iteration=2) as rec:
        faults.on_checkpoint(1, "p")
        if index == 1:
            with pytest.raises(faults.SimulatedPreemption,
                               match="process 1 after iteration 2"):
                faults.on_checkpoint(2, "p")
            assert rec["fired_at"] == 2
        else:
            faults.on_checkpoint(2, "p")
            assert rec["fired_at"] is None


def test_note_dispatch_matches_the_jax_package(tmp_path):
    before = profiling.dispatch_counts().get("bf16-guard-fix", 0)
    with trace.tracing() as tr, profiling.log_dispatches() as log:
        profiling.note_dispatch("bf16-guard-fix")
        with profiling.log_dispatches() as inner:
            profiling.note_dispatch("serve/two-level")
        profiling.note_dispatch("bf16-guard-fix")
    with jax_trace.tracing() as jtr, \
            jax_profiling.log_dispatches() as jlog:
        jax_profiling.note_dispatch("bf16-guard-fix")
        with jax_profiling.log_dispatches() as jinner:
            jax_profiling.note_dispatch("serve/two-level")
        jax_profiling.note_dispatch("bf16-guard-fix")
    assert (log, inner) == (jlog, jinner) == \
        (["bf16-guard-fix"] * 2, ["serve/two-level"])
    assert _stable(tr.records()) == _stable(jtr.records())
    assert profiling.dispatch_counts()["bf16-guard-fix"] == before + 2


def _profile(mod):
    return mod.build_profile(family="kmeans", model_class="KMeans", k=4,
                             counts=np.array([40.0, 30.0, 20.0, 10.0]),
                             score_kind="sse", score_per_row=1.5,
                             per_cluster_sse=np.arange(4.0), n_rows=100.0)


def _feed(mod, sink, profile):
    """Windows of drifting traffic through a monitor of ``mod``."""
    rng = np.random.default_rng(7)
    mon = mod.QualityMonitor("m", 4, profile=profile, window_rows=64,
                             sink_path=sink)
    for step in range(12):
        p = [0.4, 0.3, 0.2, 0.1] if step < 4 else [0.05, 0.05, 0.1, 0.8]
        labels = rng.choice(4, size=40, p=p)
        labels[:2] = [7, -1]                 # sentinels: masked
        score = rng.gamma(2.0, 1.0 if step < 6 else 3.0, size=40)
        mon.observe(40, labels=labels, score=score,
                    near_ties=int(step >= 8) * 5, guarded_rows=40)
    mon.close()
    return mon


def test_quality_monitor_windows_match_the_jax_monitor(tmp_path):
    assert _profile(drift) == _profile(jax_drift)
    a, b = np.array([0.5, 0.5, 0.0]), np.array([0.2, 0.3, 0.5])
    assert drift.psi(a, b) == jax_drift.psi(a, b)
    assert drift.js_divergence(a, b) == jax_drift.js_divergence(a, b)
    labels = np.array([0, 3, 3, -1, 9, 2])
    np.testing.assert_array_equal(drift.assignment_counts(labels, 4),
                                  jax_drift.assignment_counts(labels, 4))
    got = _feed(drift, tmp_path / "quality.m.p.jsonl", _profile(drift))
    want = _feed(jax_drift, tmp_path / "quality.m.j.jsonl",
                 _profile(jax_drift))
    assert _stable(got.history()) == _stable(want.history())
    assert len(got.history()) == 6 and got.events >= 1
    sg, sw = got.status(), want.status()
    sg.pop("sink_path"), sw.pop("sink_path")
    assert sg == sw and sg["drifting"]
    rg = drift.read_quality_log(tmp_path / "quality.m.p.jsonl")
    rw = jax_drift.read_quality_log(tmp_path / "quality.m.j.jsonl")
    assert _stable(rg) == _stable(rw)
    # No reference: the reference-free subset, the same in both.
    assert _stable(_feed(drift, None, None).history()) == \
        _stable(_feed(jax_drift, None, None).history())


def test_quality_report_matches_the_jax_report(tmp_path):
    _feed(drift, tmp_path / "quality.m.jsonl", _profile(drift))
    (tmp_path / "trace.jsonl").write_text('{"kind": "header"}\n')
    got = drift.quality_report(tmp_path)
    want = jax_drift.quality_report(tmp_path)
    got["models"]["m"].pop("last_ts"), want["models"]["m"].pop("last_ts")
    assert got == want and got["drifting"] == ["m"]
    assert drift.format_quality_status(got) == \
        jax_drift.format_quality_status(want)
    with pytest.raises(trace.TraceReadError) as e1:
        drift.quality_report(tmp_path / "missing")
    with pytest.raises(jax_trace.TraceReadError) as e2:
        jax_drift.quality_report(tmp_path / "missing")
    assert str(e1.value) == str(e2.value)


def test_serving_spans_and_counters_match_the_jax_engine(mesh1):
    """The engine's ``serve.request`` spans and ``serve.*`` counters for
    the same calls: equal names and attributes in both packages."""
    rng = np.random.default_rng(3)
    X = (rng.normal(size=(400, 4))
         + 6.0 * rng.integers(0, 3, size=(400, 1))).astype(np.float32)
    kw = dict(k=3, seed=1, max_iter=10, init="forgy", verbose=False)
    pm = kmeans_tpu_torch.KMeans(device="cpu", **kw).fit(X)
    jm = kmeans_tpu.KMeans(mesh=mesh1, **kw).fit(X)
    calls = [(X[:5], "predict"), (X[:70], "predict"),
             (X[:3], "score_rows"), (X[:9], "transform")]

    def run(engine, tracing, registry):
        engine.add_model("m", pm if engine.__module__.startswith(
            "kmeans_tpu_torch") else jm)
        before = {n: registry.counter(n).snapshot()
                  for n in ("serve.dispatches", "serve.requests",
                            "serve.rows")}
        with tracing() as tr:
            for rows, op in calls:
                engine.call("m", rows, op=op)
        engine.close()
        spans = [(r["name"], r.get("attrs")) for r in tr.records()
                 if r["name"].startswith("serve.")]
        return spans, {n: registry.counter(n).snapshot() - v
                       for n, v in before.items()}

    got = run(ServingEngine(device="cpu", start=False, quality=False),
              trace.tracing, metrics_registry.REGISTRY)
    from kmeans_tpu.serving import ServingEngine as JaxEngine
    want = run(JaxEngine(mesh=mesh1, start=False, quality=False),
               jax_trace.tracing, jax_metrics.REGISTRY)
    assert got == want
    assert got[1] == {"serve.dispatches": 4, "serve.requests": 4,
                      "serve.rows": 87}
