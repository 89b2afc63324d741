"""Fit heartbeats and the fleet readers of the port (``obs.heartbeat``,
``obs.fleet``) against the JAX package's ``obs/heartbeat.py`` and
``obs/fleet.py`` on the CPU.

* The JAX package's heartbeat cases: file and callback sinks, the timer
  thread's ticks and its join, the throttle's flush at close, isolated
  callback and file failures, a re-entrant callback, unserializable
  fields, the scope's validation; each scripted sequence gives the JAX
  heartbeat's records (time stamps aside).
* Real fits of every family (``KMeans`` by the host loop and the device
  loop, segmented by checkpoints, ``SphericalKMeans``, ``BisectingKMeans``,
  ``MiniBatchKMeans`` by host sampling and ``partial_fit``, and
  ``GaussianMixture``) beat at the JAX package's boundaries, with the
  same phases and iterations, and their results are bit-equal with and
  without a heartbeat.
* ``merge_traces``, ``merge_heartbeats``, ``straggler_report`` and both
  formatters give the JAX functions' outputs on the same files, their
  errors too; ``quality_report`` reads a serving fleet's directory (its
  heartbeat sinks beside the quality sinks) as the JAX package's does,
  and the straggler report over that directory flags a killed replica.

Timer ticks are awaited on an event with a timeout; nothing sleeps.
"""

import json
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu import obs as jobs  # noqa: E402
from kmeans_tpu.obs import drift as jax_drift  # noqa: E402
from kmeans_tpu.obs import fleet as jax_fleet  # noqa: E402
import kmeans_tpu_torch as kt  # noqa: E402
from kmeans_tpu_torch import obs  # noqa: E402
from kmeans_tpu_torch.obs import drift as pt_drift  # noqa: E402
from kmeans_tpu_torch.obs import fleet as pt_fleet  # noqa: E402
from kmeans_tpu_torch.obs import metrics_registry as pt_metrics  # noqa: E402
from kmeans_tpu_torch.obs.heartbeat import (Heartbeat,  # noqa: E402
                                            get_heartbeat)
from kmeans_tpu_torch.obs.trace import TraceReadError  # noqa: E402
from kmeans_tpu_torch.serving import ServingFleet  # noqa: E402
from kmeans_tpu_torch.utils.faults import inject_replica_kill  # noqa: E402

TIMEOUT = 60.0
#: Fields that differ between two runs of the same sequence.
CLOCK_FIELDS = ("ts", "mono", "rows_per_sec")


@pytest.fixture(autouse=True)
def _fresh_metrics():
    pt_metrics.REGISTRY.reset()
    jobs.REGISTRY.reset()
    yield
    pt_metrics.REGISTRY.reset()
    jobs.REGISTRY.reset()


def _strip(records, extra=()):
    drop = CLOCK_FIELDS + tuple(extra)
    return [{k: v for k, v in r.items() if k not in drop} for r in records]


def _both(script):
    """``script(obs_module)`` under the port and under the JAX package."""
    return script(obs), script(jobs)


# --------------------------------------------------- the heartbeat itself


def test_callback_and_file_match_the_jax_heartbeat(tmp_path):
    def script(mod):
        p = tmp_path / f"hb.{mod.__name__}.jsonl"
        got = []
        with mod.heartbeat(str(p), callback=got.append) as hb:
            mod.note_progress(None, phase="iteration", iteration=3)
            mod.note_progress(None, phase="checkpoint", iteration=6)
        lines = [json.loads(ln) for ln in p.read_text().splitlines()]
        return hb.emitted, _strip(got), _strip(lines)

    got, want = _both(script)
    assert got == want
    assert got[0] == 2
    assert [r["phase"] for r in got[2]] == ["iteration", "checkpoint"]


def test_thread_joins_on_close_no_leak():
    before = set(threading.enumerate())
    hb = Heartbeat(callback=lambda r: None, interval_s=0.02)
    assert hb._thread is not None and hb._thread.is_alive()
    hb.beat({"phase": "iteration"})
    hb.close()
    assert hb._thread is None
    assert not [t for t in set(threading.enumerate()) - before
                if t.name == "kmeans_tpu_torch-heartbeat"]
    hb.close()                         # idempotent


def test_timer_reemits_latest_with_tick():
    got = []
    ticked = threading.Event()

    def record(rec):
        got.append(rec)
        if rec.get("tick"):
            ticked.set()

    with obs.heartbeat(callback=record, interval_s=0.01):
        obs.note_progress(None, phase="iteration", iteration=1)
        assert ticked.wait(TIMEOUT), "the timer thread emitted no tick"
    ticks = [r for r in got if r.get("tick")]
    assert ticks and all(r["iteration"] == 1 for r in ticks)
    assert not got[0].get("tick")


def test_throttle_flushes_latest_on_close():
    def script(mod):
        got = []
        with mod.heartbeat(callback=got.append, min_period_s=60.0):
            for i in range(5):
                mod.note_progress(None, phase="iteration", iteration=i)
        return _strip(got)

    got, want = _both(script)
    assert got == want
    assert [r["iteration"] for r in got] == [0, 4]


def test_callback_errors_isolated():
    def bad(rec):
        raise RuntimeError("observer broke")

    def script(mod):
        with mod.heartbeat(callback=bad) as hb:
            mod.note_progress(None, phase="iteration")
        return hb.callback_errors, hb.emitted

    got, want = _both(script)
    assert got == want == (1, 1)


def test_reentrant_callback_does_not_deadlock():
    def script(mod):
        got = []

        def reentrant(rec):
            got.append(rec)
            if not rec.get("nested"):
                mod.note_progress(None, phase="iteration", nested=True)

        with mod.heartbeat(callback=reentrant):
            mod.note_progress(None, phase="iteration")
        return _strip(got)

    got, want = _both(script)
    assert got == want
    assert len(got) == 2 and got[1]["nested"] is True


def test_file_sink_failure_isolated(tmp_path):
    def script(mod):
        got = []
        bad = tmp_path / "no_such_dir" / "hb.jsonl"
        with mod.heartbeat(str(bad), callback=got.append) as hb:
            mod.note_progress(None, phase="iteration", iteration=1)
            mod.note_progress(None, phase="iteration", iteration=2)
        return hb.sink_errors, len(got)

    got, want = _both(script)
    assert got == want == (1, 2)


def test_unserializable_field_does_not_raise(tmp_path):
    def script(mod):
        p = tmp_path / f"u.{mod.__name__}.jsonl"
        with mod.heartbeat(str(p)):
            mod.note_progress(None, phase="iteration",
                              weird=np.float32(1.5), path=tmp_path)
        return _strip([json.loads(p.read_text().splitlines()[0])])

    got, want = _both(script)
    assert got == want
    assert got[0]["phase"] == "iteration"


def test_note_progress_is_noop_without_heartbeat():
    assert get_heartbeat() is None
    obs.note_progress(None, phase="iteration")


@pytest.mark.parametrize("kw", [dict(interval_s=0), dict(per_process="x")],
                         ids=["interval", "per_process"])
def test_validation_messages(kw):
    with pytest.raises(ValueError) as want:
        jobs.Heartbeat(**kw)
    with pytest.raises(ValueError) as got:
        Heartbeat(**kw)
    assert str(got.value) == str(want.value)


def test_scope_rejects_kwargs_with_instance():
    msgs = []
    for mod, cls in ((obs, Heartbeat), (jobs, jobs.Heartbeat)):
        hb = cls(callback=lambda r: None)
        with pytest.raises(ValueError, match="keyword arguments") as e:
            with mod.heartbeat(hb, interval_s=1.0):
                pass
        msgs.append(str(e.value))
        hb.close()
    assert msgs[0] == msgs[1]


def test_nested_scopes_shadow_and_restore():
    outer, inner = [], []
    with obs.heartbeat(callback=outer.append):
        with obs.heartbeat(callback=inner.append):
            obs.note_progress(None, phase="iteration", iteration=1)
        obs.note_progress(None, phase="iteration", iteration=2)
    assert [r["iteration"] for r in inner] == [1]
    assert [r["iteration"] for r in outer] == [2]
    assert get_heartbeat() is None


def test_per_process_suffix(tmp_path):
    p = tmp_path / "hb.jsonl"
    with obs.heartbeat(str(p), per_process=True) as hb:
        obs.note_progress(None, phase="iteration")
    assert hb.resolved_path == str(tmp_path / "hb.p0.jsonl")
    assert (tmp_path / "hb.p0.jsonl").exists() and not p.exists()


# --------------------------------------------------- fits of every family


def _X(n=600, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 5)) + 4.0 * rng.integers(0, 4, n)[:, None]


KM64 = dict(k=4, max_iter=6, tolerance=1e-12, dtype=np.float64,
            distance_mode="matmul", seed=0, verbose=False)
#: name -> (class, constructor arguments, fit call, checkpointed).
FITS = {
    "kmeans_host": ("KMeans", KM64, "fit", True),
    "kmeans_device": ("KMeans", dict(KM64, host_loop=False), "fit", True),
    "kmeans_device_plain": ("KMeans", dict(KM64, host_loop=False), "fit",
                            False),
    "spherical": ("SphericalKMeans", dict(KM64, max_iter=4), "fit", False),
    "bisecting": ("BisectingKMeans", dict(KM64, max_iter=10), "fit", True),
    "minibatch_host": ("MiniBatchKMeans",
                       dict(KM64, max_iter=4, batch_size=100,
                            sampling="host"), "fit", True),
    "minibatch_partial": ("MiniBatchKMeans",
                          dict(KM64, batch_size=100), "partial_fit",
                          False),
    "gmm": ("GaussianMixture",
            dict(n_components=3, max_iter=4, tol=0.0, dtype=np.float64,
                 means_init=_X()[[0, 200, 400]], seed=0), "fit", True),
}


def _run(mod, name, tmp_path, hb=True):
    cls, kw, call, ckpt = FITS[name]
    extra = {"mesh": kmeans_tpu.make_mesh(data=1, model=1)} \
        if mod is kmeans_tpu and cls != "GaussianMixture" else {}
    if mod is kt:
        extra = {"device": "cpu"}
    model = getattr(mod, cls)(**kw, **extra)
    X = _X()
    tag = f"{name}.{mod.__name__}.{hb}"

    def fit():
        if call == "partial_fit":
            for lo in (0, 200, 400):
                model.partial_fit(X[lo:lo + 200])
        elif ckpt:
            model.fit(X, checkpoint_every=2,
                      checkpoint_path=tmp_path / f"{tag}.npz")
        else:
            model.fit(X)

    got = []
    if hb:
        obs_mod = obs if mod is kt else jobs
        with obs_mod.heartbeat(callback=got.append):
            fit()
    else:
        fit()
    return model, got


def _phases(records):
    return [(r.get("phase"), r.get("iteration"), r.get("segment"),
             r.get("model_class"), r.get("family"), r.get("k"))
            for r in records]


def _results(model):
    names = ("centroids", "sse_history", "iterations_run", "means_",
             "covariances_", "weights_", "n_iter_", "lower_bound_",
             "_seen")
    return {n: getattr(model, n) for n in names
            if getattr(model, n, None) is not None}


@pytest.mark.parametrize("name", list(FITS))
def test_fits_beat_at_the_jax_boundaries_and_stay_bit_equal(name,
                                                            tmp_path):
    """Every family beats where the JAX package's does (the same phases,
    iterations, segments and identity fields); the fit is bit-equal with
    and without a heartbeat, and the records hold host values only."""
    model, records = _run(kt, name, tmp_path)
    plain, _ = _run(kt, name, tmp_path, hb=False)
    _, want = _run(kmeans_tpu, name, tmp_path)
    assert records and _phases(records) == _phases(want)
    got, ref = _results(model), _results(plain)
    assert set(got) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(value), err_msg=key)
    last = records[-1]
    assert last["process_index"] == 0 and last["process_count"] == 1
    json.dumps(records)


def test_kill_and_resume_beats_checkpoints(tmp_path):
    """A checkpointed fit killed at a boundary beats up to the kill; the
    resumed fit beats from the boundary on, as the JAX package's does."""
    from kmeans_tpu.utils import faults as jax_faults
    from kmeans_tpu_torch.utils import faults

    def script(mod, fx, obs_mod, extra):
        got = []
        path = tmp_path / f"k.{mod.__name__}.npz"
        with obs_mod.heartbeat(callback=got.append):
            with fx.inject_kill_after_iteration(4):
                with pytest.raises(fx.SimulatedPreemption):
                    mod.KMeans(**KM64, **extra).fit(
                        _X(), checkpoint_every=2, checkpoint_path=path)
            mod.KMeans(**KM64, **extra).fit(_X(), resume=path,
                                           checkpoint_every=2,
                                           checkpoint_path=path)
        return _phases(got)

    got = script(kt, faults, obs, {"device": "cpu"})
    want = script(kmeans_tpu, jax_faults, jobs,
                  {"mesh": kmeans_tpu.make_mesh(data=1, model=1)})
    assert got == want
    assert ("checkpoint", 4, None, "KMeans", "kmeans", 4) in got


# ------------------------------------------------------- fleet readers


def _trace_file(path, idx, *, wall0=None, barriers=(), offset=0.0,
                tags=None, count=2):
    """A trace stream of one process: an optional header, two spans and
    synced ``fleet.barrier`` events at the given times (on this process's
    monotonic clock, ``offset`` from the first process's)."""
    recs = []
    if wall0 is not None:
        recs.append({"kind": "header", "wall0": wall0, "process_index": idx,
                     "process_count": count, "host": f"h{idx}"})
    sid = 0
    for j, t in enumerate(barriers):
        sid += 1
        recs.append({"kind": "event", "name": "fleet.barrier", "id": sid,
                     "t0": t - offset, "attrs": {
                         "synced": True,
                         "tag": (tags or ["fit-start"] * 9)[j]}})
    for j in range(2):
        sid += 1
        recs.append({"kind": "span", "name": "dispatch", "id": sid,
                     "parent": None, "t0": 1.0 + j - offset,
                     "t1": 1.5 + j - offset, "attrs": {"rows": 8}})
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return path


def _agree(fn_pt, fn_jax, *args, **kw):
    """The port's function and the JAX package's on the same inputs: the
    same result, or the same error message."""
    try:
        got = fn_pt(*args, **kw)
    except TraceReadError as e:
        with pytest.raises(jax_fleet.TraceReadError) as want:
            fn_jax(*args, **kw)
        assert str(e) == str(want.value)
        return None
    assert fn_jax(*args, **kw) == got
    return got


def test_merge_traces_and_summary_match_the_jax_reader(tmp_path):
    """Barrier alignment (offsets and the skew bound from two barriers),
    wall alignment from the headers, a single stream, and the errors:
    duplicate process indices, disagreeing barrier tags, unalignable
    streams, a missing file, an empty directory."""
    d = tmp_path / "barrier"
    d.mkdir()
    _trace_file(d / "trace.p0.jsonl", 0, wall0=100.0, barriers=(0.5, 3.0))
    _trace_file(d / "trace.p1.jsonl", 1, wall0=100.2, barriers=(0.5, 3.0),
                offset=0.25)
    merged = _agree(pt_fleet.merge_traces, jax_fleet.merge_traces, str(d))
    assert merged["align"] == "barrier" and merged["barriers"] == 2
    assert merged["hosts"][1]["offset_s"] == pytest.approx(0.25)
    assert pt_fleet.format_fleet_summary(merged) == \
        jax_fleet.format_fleet_summary(merged)
    w = tmp_path / "wall"
    w.mkdir()
    _trace_file(w / "a.jsonl", 0, wall0=10.0)
    _trace_file(w / "b.jsonl", 1, wall0=10.5)
    merged = _agree(pt_fleet.merge_traces, jax_fleet.merge_traces,
                    [str(w / "a.jsonl"), str(w / "b.jsonl")])
    assert merged["align"] == "wall" and merged["skew_bound_s"] is None
    assert pt_fleet.format_fleet_summary(merged) == \
        jax_fleet.format_fleet_summary(merged)
    single = _agree(pt_fleet.merge_traces, jax_fleet.merge_traces,
                    str(w / "a.jsonl"))
    assert single["align"] == "single"
    bad = tmp_path / "bad"
    bad.mkdir()
    _trace_file(bad / "x.jsonl", 0, wall0=1.0)
    _trace_file(bad / "y.jsonl", 0, wall0=2.0)
    assert _agree(pt_fleet.merge_traces, jax_fleet.merge_traces,
                  str(bad)) is None
    tags = tmp_path / "tags"
    tags.mkdir()
    _trace_file(tags / "p0.jsonl", 0, barriers=(1.0,), tags=["a"])
    _trace_file(tags / "p1.jsonl", 1, barriers=(1.0,), tags=["b"])
    assert _agree(pt_fleet.merge_traces, jax_fleet.merge_traces,
                  str(tags)) is None
    nowall = tmp_path / "nowall"
    nowall.mkdir()
    _trace_file(nowall / "p0.jsonl", 0)
    _trace_file(nowall / "p1.jsonl", 1)
    assert _agree(pt_fleet.merge_traces, jax_fleet.merge_traces,
                  str(nowall)) is None
    empty = tmp_path / "empty"
    empty.mkdir()
    for arg in (str(empty), str(tmp_path / "missing.jsonl"),
                str(tmp_path / "none*.jsonl")):
        assert _agree(pt_fleet.expand_fleet_paths,
                      jax_fleet.expand_fleet_paths, arg) is None
    assert pt_fleet.sniff_stream(d / "trace.p0.jsonl") == \
        jax_fleet.sniff_stream(d / "trace.p0.jsonl") == "trace"


def _hb_file(path, host, idx, beats, *, phase="iteration", t0=1000.0,
             dt=1.0, rate=100.0, torn=False):
    recs = [{"ts": t0 + i * dt, "phase": phase, "iteration": i + 1,
             "rows_per_sec": rate, "process_index": idx, "host": host,
             "inertia": 10.0 / (i + 1)} for i in range(beats)]
    text = "".join(json.dumps(r) + "\n" for r in recs)
    path.write_text(text + ('{"ts": 12' if torn else ""))
    return path


def test_heartbeat_readers_and_straggler_report_match(tmp_path):
    """Merged heartbeats, the straggler report (post-hoc and live) and its
    table: a slow host, a host behind, a torn last line, a finished host,
    and the malformed cases."""
    d = tmp_path / "hb"
    d.mkdir()
    _hb_file(d / "hb.p0.jsonl", "a", 0, 8)
    _hb_file(d / "hb.p1.jsonl", "b", 1, 8, rate=20.0, torn=True)
    _hb_file(d / "hb.p2.jsonl", "c", 2, 4)
    _hb_file(d / "hb.p3.jsonl", "d", 3, 8, phase="finished")
    recs = _agree(pt_fleet.merge_heartbeats, jax_fleet.merge_heartbeats,
                  str(d))
    assert len(recs) == 28
    for kw in ({}, {"now": 1020.0}, {"now": 1007.5}):
        rep = _agree(pt_fleet.straggler_report, jax_fleet.straggler_report,
                     recs, **kw)
        assert pt_fleet.format_fleet_status(rep) == \
            jax_fleet.format_fleet_status(rep)
    rep = pt_fleet.straggler_report(recs)
    flags = {h["host"]: h["flags"] for h in rep["hosts"]}
    assert "slow" in flags["b"] and "behind" in flags["c"]
    assert flags["d"] == [] and not rep["healthy"]
    live = pt_fleet.straggler_report(recs, now=1020.0)
    assert "stalled" in {h["host"]: h["flags"] for h in
                         live["hosts"]}["a"]
    assert {h["host"]: h["flags"] for h in live["hosts"]}["d"] == []
    for name, text in (("garbage.jsonl", "not json\n{}\n"),
                       ("nots.jsonl", '{"phase": "x"}\n'),
                       ("empty.jsonl", "")):
        (tmp_path / name).write_text(text)
        assert _agree(pt_fleet.read_heartbeats, jax_fleet.read_heartbeats,
                      str(tmp_path / name)) is None
    assert _agree(pt_fleet.straggler_report, jax_fleet.straggler_report,
                  []) is None
    for key in ("FLEET_SKEW_BOUND_S", "STRAGGLER_RATE_FACTOR",
                "STRAGGLER_BEHIND_ITERS", "STRAGGLER_STALL_FACTOR",
                "STRAGGLER_STALL_MIN_S", "TERMINAL_PHASES"):
        assert getattr(pt_fleet, key) == getattr(jax_fleet, key), key


def test_fit_heartbeat_files_read_as_the_jax_readers_do(tmp_path):
    """Heartbeat sinks written by two port fits merge and report as the
    JAX readers merge and report them.  The second file's records are
    stamped as a second process would stamp them (index 1)."""
    paths = []
    for idx in (0, 1):
        p = tmp_path / f"fit.p{idx}.jsonl"
        with obs.heartbeat(str(p)):
            kt.KMeans(**dict(KM64, max_iter=3 + idx),
                      device="cpu").fit(_X())
        recs = [dict(json.loads(ln), process_index=idx, host=f"h{idx}")
                for ln in p.read_text().splitlines()]
        p.write_text("".join(json.dumps(r) + "\n" for r in recs))
        paths.append(str(p))
    recs = _agree(pt_fleet.merge_heartbeats, jax_fleet.merge_heartbeats,
                  paths)
    rep = _agree(pt_fleet.straggler_report, jax_fleet.straggler_report,
                 recs)
    assert [h["iteration"] for h in rep["hosts"]] == [3, 4]
    assert [h["phase"] for h in rep["hosts"]] == ["finished"] * 2
    assert pt_fleet.format_fleet_status(rep) == \
        jax_fleet.format_fleet_status(rep)


def _served_fleet_dir(tmp_path, *, kill: bool):
    X = _X(2000, seed=3).astype(np.float32)
    km = kt.KMeans(k=4, seed=0, max_iter=10, device="cpu",
                   verbose=False).fit(X)
    fdir = tmp_path / "fleet"
    with ServingFleet(2, device="cpu", quality=True, fleet_dir=str(fdir),
                      quality_window=128, start=False,
                      heartbeat_interval_s=0.0) as fleet:
        fleet.add_model("m", km)
        fleet.warmup()
        if kill:
            # The cold rotation sends the second call to r1, which dies
            # on it; the call fails over to r0.
            with inject_replica_kill(fleet, "r1") as rec:
                fleet.call("m", X[:64])
                fleet.call("m", X[64:128])
            assert rec["killed"]
        for i in range(8):
            fleet.call("m", X[i * 128:(i + 1) * 128])
    return fdir


def test_quality_report_reads_a_fleet_directory(tmp_path):
    """A serving fleet's directory (quality sinks beside heartbeat sinks):
    ``quality_report`` keeps the quality streams and aggregates them as
    the JAX package's does; a heartbeat file named explicitly stays
    strict, and a path that names nothing raises the same error."""
    fdir = _served_fleet_dir(tmp_path, kill=False)
    rep = pt_drift.quality_report(str(fdir))
    jrep = jax_drift.quality_report(str(fdir))
    assert rep == jrep
    assert sorted(rep["files"]) == sorted(
        str(p) for p in fdir.glob("quality.m.*.jsonl"))
    assert rep["models"]["m"]["windows"] == 8
    assert pt_drift.format_quality_status(rep) == \
        jax_drift.format_quality_status(jrep)
    glob_rep = pt_drift.quality_report(str(fdir / "quality.*.jsonl"))
    assert glob_rep == jax_drift.quality_report(
        str(fdir / "quality.*.jsonl"))
    for arg in (str(fdir / "hb.r0.jsonl"), str(tmp_path / "nothing.jsonl")):
        with pytest.raises(TraceReadError) as got:
            pt_drift.quality_report(arg)
        with pytest.raises(jax_fleet.TraceReadError) as want:
            jax_drift.quality_report(arg)
        assert str(got.value) == str(want.value)


def test_straggler_report_flags_a_killed_replica(tmp_path):
    """Over a serving fleet's heartbeats: every replica shows, the killed
    one is behind (it stopped counting dispatches), as the JAX reader
    reports the same files."""
    fdir = _served_fleet_dir(tmp_path, kill=True)
    recs = pt_fleet.merge_heartbeats(str(fdir / "hb.*.jsonl"))
    assert recs == jax_fleet.merge_heartbeats(str(fdir / "hb.*.jsonl"))
    rep = pt_fleet.straggler_report(recs)
    assert rep == jax_fleet.straggler_report(recs)
    hosts = {h["host"]: h for h in rep["hosts"]}
    assert set(hosts) == {"r0", "r1"}
    assert "behind" in hosts["r1"]["flags"] and hosts["r0"]["flags"] == []
    assert rep["flagged"] == [1]
