"""The port's readers on the command line (``trace summarize``,
``fleet-status``, ``serve-status``: ``kmeans_tpu_torch/cli.py``) against the
JAX package's, on the CPU.

Both packages' commands read the same files, written by the JAX package's
own writers (its tracer, heartbeat and serving engine: an oracle that owes
nothing to the port): a single trace, a directory of two processes' traces
beside a heartbeat file, two processes' heartbeats (post hoc and with
``--now``), and a monitored engine's quality sinks.  Their ``--json``
outputs are equal (both name the same paths), and so are their exit codes
and error messages.  Then the port's commands read the files the port's
own writers produce.  A second process's records come from the same
writers with the identity function returning index 1 (no environment
variable changes).
"""

import contextlib
import io
import json
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu import cli as jax_cli  # noqa: E402
from kmeans_tpu import obs as jobs  # noqa: E402
from kmeans_tpu.obs import identity as jax_identity  # noqa: E402
from kmeans_tpu.serving import ServingEngine as JaxEngine  # noqa: E402
import kmeans_tpu_torch as kt  # noqa: E402
from kmeans_tpu_torch import cli, obs  # noqa: E402
from kmeans_tpu_torch.obs import metrics_registry as pt_metrics  # noqa: E402
from kmeans_tpu_torch.serving import ServingEngine  # noqa: E402

KM = dict(k=4, seed=0, tolerance=1e-30, verbose=False)


@pytest.fixture(autouse=True)
def _fresh_metrics():
    pt_metrics.REGISTRY.reset()
    jobs.REGISTRY.reset()
    yield
    pt_metrics.REGISTRY.reset()
    jobs.REGISTRY.reset()


def _X(n=1200, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6, size=(4, 5))
    return (centers[rng.integers(0, 4, n)]
            + rng.normal(size=(n, 5))).astype(np.float32)


def _run(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = fn(argv)
    return code, out.getvalue(), err.getvalue()


def _both(name, argv):
    """The port's command and the JAX package's on the same arguments:
    equal exit codes and equal output (``--json`` parsed)."""
    port = _run(getattr(cli, name), argv)
    jax_r = _run(getattr(jax_cli, name), argv)
    assert port[0] == jax_r[0]
    if "--json" in argv and port[0] != 2:
        assert json.loads(port[1]) == json.loads(jax_r[1])
    else:
        assert port[1] == jax_r[1]
        assert port[2] == jax_r[2]
    return port


@contextlib.contextmanager
def _as_process(monkeypatch, idx, count=2):
    """The JAX writers' identity for this scope: process ``idx`` of
    ``count`` on host ``h<idx>``."""
    with monkeypatch.context() as m:
        m.setattr(jax_identity, "identity",
                  lambda: {"process_index": idx, "process_count": count,
                           "host": f"h{idx}"})
        yield


def _jax_fit(max_iter=4, **kw):
    return kmeans_tpu.KMeans(**dict(KM, max_iter=max_iter, **kw)).fit(_X())


# --------------------------------------------------------------------- trace


@pytest.fixture()
def jax_trace(tmp_path):
    path = tmp_path / "one.jsonl"
    with jobs.tracing(str(path), per_process=False):
        _jax_fit()
    return path


def test_trace_summarize_one_jax_file(jax_trace, tmp_path):
    port = _both("trace_main", ["summarize", str(jax_trace), "--json"])
    got = json.loads(port[1])
    assert got["time_to_first_iteration"] and got["phases"]
    assert got["files"] == [str(jax_trace)]
    # Text, cost columns and the Chrome export.
    _both("trace_main", ["summarize", str(jax_trace), "--cost"])
    cp, cj = tmp_path / "p.json", tmp_path / "j.json"
    assert _run(cli.trace_main, ["summarize", str(jax_trace),
                                 "--chrome", str(cp)])[0] == 0
    assert _run(jax_cli.trace_main, ["summarize", str(jax_trace),
                                     "--chrome", str(cj)])[0] == 0
    assert json.loads(cp.read_text()) == json.loads(cj.read_text())


def test_trace_summarize_merges_a_jax_fleet_directory(tmp_path,
                                                      monkeypatch):
    """Two processes' traces and one heartbeat file in a directory: the
    heartbeat stream is skipped, the traces merge, and the fleet block is
    the JAX reader's."""
    fleet = tmp_path / "fleet"
    fleet.mkdir()
    for idx in (0, 1):
        with _as_process(monkeypatch, idx):
            with jobs.tracing(str(fleet / "trace.jsonl"),
                              per_process=True), \
                    jobs.heartbeat(str(fleet / "hb.jsonl"),
                                   per_process=True):
                _jax_fit(max_iter=3 + idx)
    assert sorted(p.name for p in fleet.iterdir()) == [
        "hb.p0.jsonl", "hb.p1.jsonl", "trace.p0.jsonl", "trace.p1.jsonl"]
    port = _both("trace_main", ["summarize", str(fleet), "--json"])
    got = json.loads(port[1])
    assert len(got["files"]) == 2 and got["fleet"]["hosts"]
    assert got["time_to_first_iteration"] is None
    _both("trace_main", ["summarize", str(fleet / "trace.p*.jsonl")])


@pytest.mark.parametrize("case", ["missing", "malformed", "only_heartbeat"])
def test_trace_errors_are_the_jax_commands(tmp_path, case):
    if case == "missing":
        arg = tmp_path / "nope.jsonl"
    elif case == "malformed":
        arg = tmp_path / "bad.jsonl"
        arg.write_text("{not json\n")
    else:
        arg = tmp_path / "d"
        arg.mkdir()
        for idx in (0, 1):
            (arg / f"hb.p{idx}.jsonl").write_text(json.dumps(
                {"ts": 1.0, "process_index": idx, "iteration": 1}) + "\n")
    port = _both("trace_main", ["summarize", str(arg)])
    assert port[0] == 2 and port[2].startswith("error:")


# -------------------------------------------------------------- fleet-status


@pytest.fixture()
def jax_heartbeats(tmp_path, monkeypatch):
    """Two processes' heartbeats from JAX fits; process 1 stops 3
    iterations early (behind the leader)."""
    d = tmp_path / "hb"
    d.mkdir()
    for idx, iters in ((0, 6), (1, 3)):
        with _as_process(monkeypatch, idx):
            with jobs.heartbeat(str(d / "hb.jsonl"), per_process=True):
                _jax_fit(max_iter=iters)
    return d


def test_fleet_status_reads_jax_heartbeats(jax_heartbeats):
    port = _both("fleet_status_main", [str(jax_heartbeats), "--json"])
    rep = json.loads(port[1])
    assert port[0] == 1 and rep["flagged"] == [1]
    assert [h["iteration"] for h in rep["hosts"]] == [6, 3]
    _both("fleet_status_main", [str(jax_heartbeats)])
    # The committed thresholds overridden: nobody is behind by 4.
    port = _both("fleet_status_main", [str(jax_heartbeats), "--json",
                                       "--behind-iters", "4",
                                       "--rate-factor", "0.0"])
    assert port[0] == 0


def test_fleet_status_now_reads_as_the_jax_command(jax_heartbeats,
                                                   monkeypatch):
    """``--now`` anchors liveness at the wall clock (frozen here for both
    commands): every host is long silent and process 1 is behind."""
    frozen = time.time() + 3600.0
    monkeypatch.setattr(time, "time", lambda: frozen)
    port = _both("fleet_status_main", [str(jax_heartbeats), "--json",
                                       "--now"])
    rep = json.loads(port[1])
    assert port[0] == 1 and rep["now"] == frozen
    assert "stalled" in rep["hosts"][1]["flags"]


def test_fleet_status_errors_are_the_jax_commands(tmp_path, jax_trace):
    port = _both("fleet_status_main", [str(jax_trace)])
    assert port[0] == 2 and "no heartbeat files" in port[2]
    port = _both("fleet_status_main", [str(tmp_path / "nothing")])
    assert port[0] == 2 and port[2].startswith("error:")


# -------------------------------------------------------------- serve-status


def _jax_quality_dir(tmp_path, rows=128, drift=0.0):
    qdir = tmp_path / "quality"
    km = _jax_fit(max_iter=10)
    X = _X(2000, seed=3) + np.float32(drift)
    eng = JaxEngine(start=False, quality=True, quality_dir=str(qdir),
                    quality_window=rows)
    try:
        eng.add_model("m", km)
        for i in range(8):
            eng.call("m", X[i * rows:(i + 1) * rows])
    finally:
        eng.close()
    return qdir


@pytest.mark.parametrize("drift", [0.0, 25.0], ids=["steady", "shifted"])
def test_serve_status_reads_jax_quality_sinks(tmp_path, drift):
    qdir = _jax_quality_dir(tmp_path, drift=drift)
    port = _both("serve_status_main", [str(qdir), "--json"])
    rep = json.loads(port[1])
    assert rep["models"]["m"]["windows"] == 8
    assert port[0] == (0 if rep["healthy"] else 1)
    _both("serve_status_main", [str(qdir)])


def test_serve_status_errors_are_the_jax_commands(tmp_path, jax_trace):
    for arg in (tmp_path / "nothing.jsonl", jax_trace):
        port = _both("serve_status_main", [str(arg)])
        assert port[0] == 2 and port[2].startswith("error:")


# ------------------------------------------------- files the port writes


def test_the_ports_commands_read_the_ports_files(tmp_path):
    """The port's tracer, heartbeat and serving engine write; the port's
    commands read (and the JAX package's read them alike)."""
    X = _X()
    trace = tmp_path / "trace.jsonl"
    (tmp_path / "hb").mkdir()
    with obs.tracing(str(trace), per_process=False), \
            obs.heartbeat(str(tmp_path / "hb" / "hb.jsonl"),
                          per_process=True):
        km = kt.KMeans(**dict(KM, max_iter=5), device="cpu").fit(X)
    code, out, _ = _run(cli.trace_main, ["summarize", str(trace), "--json"])
    got = json.loads(out)
    assert code == 0
    assert got["time_to_first_iteration"] == obs.report.\
        time_to_first_iteration(obs.read_jsonl(str(trace)))
    assert {"dispatch", "place"} <= set(got["phases"])
    _both("trace_main", ["summarize", str(trace), "--json"])

    code, out, _ = _run(cli.fleet_status_main,
                        [str(tmp_path / "hb"), "--json"])
    rep = json.loads(out)
    assert code == 0 and rep["healthy"]
    assert [h["phase"] for h in rep["hosts"]] == ["finished"]
    _both("fleet_status_main", [str(tmp_path / "hb"), "--json"])

    qdir = tmp_path / "quality"
    with ServingEngine(device="cpu", start=False, quality=True,
                       quality_dir=str(qdir), quality_window=128) as eng:
        eng.add_model("m", km)
        for i in range(6):
            eng.call("m", X[i * 128:(i + 1) * 128])
    code, out, _ = _run(cli.serve_status_main, [str(qdir), "--json"])
    rep = json.loads(out)
    assert code == (0 if rep["healthy"] else 1)
    assert rep["models"]["m"]["windows"] == 6
    _both("serve_status_main", [str(qdir), "--json"])
