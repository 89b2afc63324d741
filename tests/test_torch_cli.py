"""The port's command line (``python -m kmeans_tpu_torch``, ``kmeans_tpu_torch
/cli.py``) on the CPU, command by command against the JAX package's
``kmeans_tpu/cli.py`` on the same ``.npy`` made from a seed with NumPy:

* ``fit`` of every family with ``--device cpu``: the same summary keys and
  iterations; labels equal where the float64 margin clears the band;
  inertia and centroids to the float32 rtol (``minibatch`` by quality: its
  draws differ by design); the artefacts bit-equal to the port's own
  estimator with the same parameters;
* ``sweep`` kmeans and gmm: the same selected k;
* ``ckpt-info`` of one checkpoint file that both packages load, and of a
  torn one: the same keys and exit codes (``jax_version`` None: the port
  writes none; the ``aot`` block lists kernel libraries where the
  reference lists XLA executables, by design);
* ``plan --json``: the same resolution and ``auto_rule`` text;
* ``serve`` of one checkpoint over a piped JSONL: the replies of the JAX
  ``serve``, error lines included;
* ``report``: two SVG files;
* ``python -m kmeans_tpu_torch`` routes every command (one subprocess), and
  ``bench``, ``bench-diff`` and ``lint`` exit 2 naming their ROADMAP item;
* every error path of the reference's ``tests/test_cli.py``: the same exit
  code and message, the program name changed; every command that places
  data refuses to run without a card unless ``--device cpu`` is given;
  ``warm`` exits 2 on the CPU with the reference's message.

The JAX package's commands turn on its persistent compilation cache, a
process-wide setting in a fixed directory; the tests replace that call by
a no-op so nothing is written outside ``tmp_path``.
"""

import contextlib
import io
import json
import subprocess
import sys
import xml.dom.minidom
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu.__main__ as jax_main_mod  # noqa: E402
from kmeans_tpu import cli as jax_cli  # noqa: E402
from kmeans_tpu.utils import aot as jax_aot  # noqa: E402
import kmeans_tpu_torch as kt  # noqa: E402
import kmeans_tpu_torch.__main__ as main_mod  # noqa: E402
from kmeans_tpu_torch import cli  # noqa: E402
from kmeans_tpu_torch.ops import compare as cmp  # noqa: E402
from kmeans_tpu_torch.utils import aot  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
F32_RTOL = 1e-4

#: fit's families: the port class and the JAX class.
FIT_FAMILIES = {"kmeans": "KMeans", "bisecting": "BisectingKMeans",
                "spherical": "SphericalKMeans",
                "minibatch": "MiniBatchKMeans"}


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    monkeypatch.setattr(jax_aot, "enable_compilation_cache", lambda: None)


@pytest.fixture()
def data_file(tmp_path):
    """The reference's data: four blobs in 6-D, 2000 rows, float32."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=8, size=(4, 6)).astype(np.float32)
    X = (centers[rng.integers(0, 4, 2000)]
         + rng.normal(size=(2000, 6)).astype(np.float32))
    path = tmp_path / "points.npy"
    np.save(path, X)
    return path


def _run(fn, argv, stdin=None):
    """``fn(argv)`` with its standard streams captured: ``(exit code,
    stdout, stderr)``."""
    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            code = fn(argv)
    finally:
        sys.stdin = saved
    return code, out.getvalue(), err.getvalue()


def _same_error(port, jax_res):
    """Both exit 2 with the same message, the program name aside."""
    assert port[0] == jax_res[0] == 2
    assert port[2].replace("kmeans_tpu_torch", "kmeans_tpu") == jax_res[2]
    assert port[2].startswith("error:")


def _labels_outside_band(X, cents, la, lb) -> int:
    _, outside = cmp.label_band(torch.from_numpy(X),
                                torch.from_numpy(cents.astype(np.float32)),
                                torch.from_numpy(la.astype(np.int64)),
                                torch.from_numpy(lb.astype(np.int64)))
    return outside


# ----------------------------------------------------------------------- fit


def _fit_both(data_file, tmp_path, model, extra=()):
    argv = [str(data_file), "--k", "4", "--model", model, "--sse",
            "--quiet", "--max-iter", "20", "--seed", "3", *extra]
    rp = cli.main(argv + ["--out-dir", str(tmp_path / "port")] + CPU)
    rj = jax_cli.main(argv + ["--out-dir", str(tmp_path / "jax")])
    assert rp == rj == 0
    load = {side: {name: np.load(tmp_path / side / f"{name}.npy")
                   for name in ("centroids", "labels")}
            for side in ("port", "jax")}
    summ = {side: json.loads((tmp_path / side / "summary.json").read_text())
            for side in ("port", "jax")}
    return load, summ


def _own_estimator(model, X, **kw):
    """The port's estimator that ``fit --model`` builds, fitted on X."""
    cls = getattr(kt, FIT_FAMILIES[model])
    extra = {"batch_size": 4096} if model == "minibatch" else {}
    return cls(k=4, max_iter=20, tolerance=1e-4, seed=3, compute_sse=True,
               init="forgy", n_init=1, verbose=False, bucket=0,
               device="cpu", **extra, **kw).fit(X)


@pytest.mark.parametrize("model", ["kmeans", "bisecting", "spherical"])
def test_fit_matches_the_jax_command(data_file, tmp_path, model):
    load, summ = _fit_both(data_file, tmp_path, model)
    X = np.load(data_file)
    assert set(summ["port"]) == set(summ["jax"])
    assert summ["port"]["iterations"] == summ["jax"]["iterations"]
    assert summ["port"]["k"] == 4 and summ["port"]["model"] == model
    np.testing.assert_allclose(summ["port"]["inertia"],
                               summ["jax"]["inertia"], rtol=F32_RTOL)
    np.testing.assert_allclose(load["port"]["centroids"],
                               load["jax"]["centroids"], rtol=F32_RTOL,
                               atol=1e-4)
    assert _labels_outside_band(X, load["port"]["centroids"],
                                load["port"]["labels"],
                                load["jax"]["labels"]) == 0
    assert summ["port"]["cluster_sizes"] is not None
    assert sum(summ["port"]["cluster_sizes"]) == X.shape[0]
    # The artefacts are the port's own estimator's, bit for bit.
    own = _own_estimator(model, X)
    np.testing.assert_array_equal(load["port"]["centroids"], own.centroids)
    np.testing.assert_array_equal(load["port"]["labels"], own.labels_)
    assert summ["port"]["sse_history"] == [float(s)
                                           for s in own.sse_history]


def test_fit_minibatch_by_quality(data_file, tmp_path):
    """The mini-batch draws are the port's own (hashed), so its fit is held
    by quality against the JAX command's, and bit for bit against its own
    estimator."""
    load, summ = _fit_both(data_file, tmp_path, "minibatch")
    X = np.load(data_file)
    assert set(summ["port"]) == set(summ["jax"])
    assert summ["port"]["inertia"] <= 1.05 * summ["jax"]["inertia"]
    own = _own_estimator("minibatch", X)
    np.testing.assert_array_equal(load["port"]["centroids"], own.centroids)
    np.testing.assert_array_equal(load["port"]["labels"], own.labels_)


def test_fit_inertia_without_sse(data_file, tmp_path):
    out = tmp_path / "nosse"
    assert cli.main([str(data_file), "--k", "4", "--quiet",
                     "--out-dir", str(out)] + CPU) == 0
    summary = json.loads((out / "summary.json").read_text())
    assert summary["inertia"] is not None and summary["inertia"] > 0
    assert summary["sse_history"] == []


def test_fit_npz_no_labels_and_bucket(data_file, tmp_path):
    X = np.load(data_file)
    npz = tmp_path / "data.npz"
    np.savez(npz, features=X)
    out = tmp_path / "npz_out"
    assert cli.main([str(npz), "--npz-key", "features", "--k", "2",
                     "--quiet", "--out-dir", str(out), "--max-iter", "5",
                     "--no-labels", "--bucket", "auto"] + CPU) == 0
    assert np.load(out / "centroids.npy").shape == (2, 6)
    assert not (out / "labels.npy").exists()


# --------------------------------------------------------------------- sweep


@pytest.mark.parametrize("argv", [
    ["--k-range", "2:7", "--n-init", "2", "--max-iter", "20"],
    ["--model", "gmm", "--k-range", "2,4", "--criterion", "bic",
     "--max-iter", "15"]], ids=["kmeans", "gmm"])
def test_sweep_selects_the_jax_commands_k(data_file, tmp_path, argv):
    rp, outp, _ = _run(cli.sweep_main, [str(data_file), *argv, "--json",
                                        "--out-dir", str(tmp_path / "p")]
                       + CPU)
    rj, outj, _ = _run(jax_cli.sweep_main,
                       [str(data_file), *argv, "--json",
                        "--out-dir", str(tmp_path / "j")])
    assert rp == rj == 0
    port, jax_s = json.loads(outp), json.loads(outj)
    assert set(port) == set(jax_s)
    assert port["selected_k"] == jax_s["selected_k"]
    assert port["k_range"] == jax_s["k_range"]
    assert port["dispatches"] == 1 and port["batched"] is True
    assert np.load(tmp_path / "p" / "centroids.npy").shape[0] == \
        port["selected_k"]
    disk = json.loads((tmp_path / "p" / "sweep.json").read_text())
    assert disk["selected_k"] == port["selected_k"]


def test_sweep_sequential_oracle(data_file, tmp_path):
    runs = {}
    for tag, extra in (("b", []), ("s", ["--sequential"])):
        rc, out, _ = _run(cli.sweep_main,
                          [str(data_file), "--k-range", "3:6", "--max-iter",
                           "15", "--out-dir", str(tmp_path / tag), "--json",
                           *extra] + CPU)
        assert rc == 0
        runs[tag] = json.loads(out)
    assert runs["s"]["batched"] is False
    assert runs["s"]["selected_k"] == runs["b"]["selected_k"]
    assert runs["s"]["scores"] == runs["b"]["scores"]


# ---------------------------------------------------------------- ckpt-info


@pytest.fixture()
def ckpt_file(data_file, tmp_path):
    X = np.load(data_file)
    path = tmp_path / "m.npz"
    kt.KMeans(k=3, max_iter=4, seed=0, verbose=False,
              device="cpu").fit(X).save(path)
    return path


def test_ckpt_info_matches_the_jax_command(ckpt_file):
    rp, outp, _ = _run(cli.ckpt_info_main, [str(ckpt_file), "--json"])
    rj, outj, _ = _run(jax_cli.ckpt_info_main, [str(ckpt_file), "--json"])
    assert rp == rj == 0
    port, jax_i = json.loads(outp), json.loads(outj)
    assert set(port) == set(jax_i)
    for key in ("path", "source", "model_class", "k", "iteration",
                "format_version", "dtype", "written_on_mesh",
                "prev_exists", "prev_loads", "primary_error",
                "jax_version"):
        assert port[key] == jax_i[key], key
    assert port["jax_version"] is None
    assert set(port["plan"]) == set(jax_i["plan"])
    for key in ("n_assumed", "d", "k", "data_shards", "model_shards",
                "chunk", "k_shard", "assign", "resolved_by"):
        assert port["plan"][key] == jax_i["plan"][key], key
    # The port's plan rows carry the reference's keys and two of their
    # own ('mode', 'assign').
    assert set(jax_i["plan"]["plans"][0]) <= set(port["plan"]["plans"][0])
    assert port["aot"]["exists"] is False and port["aot"]["artifacts"] == 0
    # Text form: both name no shipped artefacts, both exit 0.
    rp, outp, _ = _run(cli.ckpt_info_main, [str(ckpt_file)])
    rj, outj, _ = _run(jax_cli.ckpt_info_main, [str(ckpt_file)])
    assert rp == rj == 0
    assert "none shipped" in outp and "none shipped" in outj
    assert "python -m kmeans_tpu_torch warm" in outp


def test_ckpt_info_of_a_torn_checkpoint(ckpt_file):
    ckpt_file.write_bytes(b"torn checkpoint")
    rp, outp, _ = _run(cli.ckpt_info_main, [str(ckpt_file), "--json"])
    rj, outj, _ = _run(jax_cli.ckpt_info_main, [str(ckpt_file), "--json"])
    assert rp == rj == 2
    port, jax_i = json.loads(outp), json.loads(outj)
    assert set(port) == set(jax_i)
    assert port["source"] is None and port["plan"] is None
    rp, _, errp = _run(cli.ckpt_info_main, [str(ckpt_file)])
    rj, _, errj = _run(jax_cli.ckpt_info_main, [str(ckpt_file)])
    assert rp == rj == 2
    assert errp.startswith("error:") and "no loadable state" in errp
    assert "no loadable state" in errj


def test_ckpt_info_reports_shipped_libraries(ckpt_file):
    """A ``<ckpt>.aot`` directory with one artefact (a stand-in library:
    no library is built on the CPU) is described from its records."""
    store = aot.AOTStore(ckpt_file.parent / "store",
                         mirror=aot.aot_dir_for(ckpt_file))
    lib = ckpt_file.parent / "libstand_in.so"
    lib.write_bytes(b"\0" * 64)
    assert store.put(aot.artifact_key("assign_kernels", capability="9.0"),
                     lib)
    rc, out, _ = _run(cli.ckpt_info_main, [str(ckpt_file), "--json"])
    info = json.loads(out)
    assert rc == 0 and info["aot"]["exists"] and \
        info["aot"]["artifacts"] == 1
    assert info["aot"]["libraries"][0]["library"] == "assign_kernels"
    rc, out, _ = _run(cli.ckpt_info_main, [str(ckpt_file)])
    assert rc == 0 and "assign_kernels@sm9.0" in out


# ---------------------------------------------------------------------- plan


@pytest.mark.parametrize("argv", [
    ["--n", "2097152", "--d", "128", "--k", "1024"],
    ["--n", "1000000", "--d", "64", "--k", "65536", "--model-shards", "2"],
    ["--n", "100000", "--d", "32", "--k", "4096", "--assign", "two_level"],
    ["--n", "100000", "--d", "32", "--k", "4096", "--model-shards", "2",
     "--k-shard", "2", "--dtype", "float64"]],
    ids=["main", "model2", "two_level", "kshard"])
def test_plan_resolves_as_the_jax_command(argv):
    argv = argv + ["--data-shards", "1", "--json"]
    rp, outp, _ = _run(cli.plan_main, argv + CPU)
    rj, outj, _ = _run(jax_cli.plan_main, argv)
    assert rp == rj == 0
    port, jax_p = json.loads(outp), json.loads(outj)
    assert set(port["resolution"]) == set(jax_p["resolution"])
    for key in ("k_shard", "assign", "auto_rule"):
        assert port["resolution"][key] == jax_p["resolution"][key], key
    assert len(port["plans"]) == len(jax_p["plans"])
    assert all(set(j) <= set(p)
               for p, j in zip(port["plans"], jax_p["plans"]))
    assert port["resolution"]["dense_predicted_peak_bytes"] == \
        port["plans"][0]["predicted_peak_bytes"]


def test_plan_text_and_the_ports_data_shards():
    """Without ``--data-shards`` the port plans the world size of an
    initialized process group: 1 here."""
    rc, out, _ = _run(cli.plan_main, ["--n", "4096", "--d", "8", "--k",
                                      "64", "--model-shards", "2"] + CPU)
    assert rc == 0
    assert "(1x2 mesh)" in out and "k-shard saves" in out
    assert "resolution     : k_shard=0, assign='dense'" in out


def test_plan_on_the_fit_rule(monkeypatch):
    """``plan`` asks the fit's own rule (``obs.memory.dense_room``): on a
    stubbed card too small for the dense table it resolves 'two_level'
    without a model axis, like ``KMeans._resolve_large_k``."""
    from kmeans_tpu_torch.obs import memory as pmem
    monkeypatch.setattr(pmem, "device_memory_info", lambda device=None: {
        "available": True, "bytes_limit": 1 << 30, "bytes_in_use": 0,
        "bytes_free": 1 << 20})
    rc, out, _ = _run(cli.plan_main, ["--n", "4096", "--d", "8", "--k",
                                      "4096", "--json"] + CPU)
    res = json.loads(out)["resolution"]
    assert rc == 0 and (res["k_shard"], res["assign"]) == (0, "two_level")
    assert res["auto_rule"] == "dense plan exceeds 80% of free HBM"


@pytest.mark.parametrize("argv", [
    ["--k-shard", "x"], ["--k-shard", "3", "--model-shards", "2"],
    ["--k-shard", "2"], ["--assign", "two_level", "--model-shards", "2"]],
    ids=["not_int", "mismatch", "no_axis", "two_level_tp"])
def test_plan_errors_are_the_jax_commands(argv):
    argv = ["--n", "1000", "--d", "8", "--k", "16", "--data-shards", "1",
            *argv]
    _same_error(_run(cli.plan_main, argv + CPU), _run(jax_cli.plan_main,
                                                      argv))


# --------------------------------------------------------------------- serve


def _serve_lines(X):
    return "\n".join(json.dumps(r) for r in [
        {"x": X[:5].tolist(), "id": "a"},
        {"model": "m", "x": X[5:7].tolist(), "op": "transform"},
        {"x": X[:3].tolist(), "op": "score_rows", "id": 7},
        {"model": "nope", "x": X[:2].tolist()},
        {"x": X[:2, :4].tolist()},
        {"op": "predict"},
        {"x": X[:2].tolist(), "op": "explode"},
        {"learn": True},
        {"fleet_stats": True}, "a string"]) + "\nnot json\n\n"


def test_serve_replies_as_the_jax_command(ckpt_file, data_file):
    X = np.load(data_file)
    argv = ["--model", str(ckpt_file), "--buckets", "8,64"]
    rp, outp, errp = _run(cli.serve_main, argv + CPU,
                          stdin=_serve_lines(X))
    rj, outj, errj = _run(jax_cli.serve_main, argv, stdin=_serve_lines(X))
    assert rp == rj == 0
    port = [json.loads(line) for line in outp.strip().splitlines()]
    jax_r = [json.loads(line) for line in outj.strip().splitlines()]
    assert len(port) == len(jax_r) == 11
    for a, b in zip(port, jax_r):
        assert set(a) == set(b)
        if "error" in a:
            assert a["error"] == b["error"]
        elif a["op"] == "predict":
            assert a == b
        else:
            assert (a["model"], a["op"], a.get("id")) == \
                (b["model"], b["op"], b.get("id"))
            np.testing.assert_allclose(a["result"], b["result"],
                                       rtol=F32_RTOL, atol=1e-3)
    model = kt.KMeans.load(ckpt_file, device="cpu")
    assert port[0]["result"] == model.predict(X[:5]).tolist()
    assert "serve: resident 'm': KMeans k=3 d=6" in errp
    assert "serve: done" in errp and "serve: done" in errj


def test_serve_fleet_quality_and_json(ckpt_file, data_file, tmp_path):
    """``--replicas 2 --quality-dir``: fleet stats answer, the replies are
    the single engine's, the quality sinks are written, ``--json`` ends
    with the stats line."""
    X = np.load(data_file)
    lines = "\n".join(json.dumps(r) for r in [
        {"x": X[:64].tolist()}, {"fleet_stats": True},
        {"quality": True}]) + "\n"
    qdir = tmp_path / "q"
    rc, out, err = _run(cli.serve_main,
                        ["--model", str(ckpt_file), "--buckets", "8,64",
                         "--replicas", "2", "--quality-dir", str(qdir),
                         "--quality", "--json"] + CPU, stdin=lines)
    assert rc == 0
    replies = [json.loads(line) for line in out.strip().splitlines()]
    model = kt.KMeans.load(ckpt_file, device="cpu")
    assert replies[0]["result"] == model.predict(X[:64]).tolist()
    assert replies[1]["n_replicas"] == 2
    assert "m" in replies[2]
    assert replies[-1]["n_replicas"] == 2
    assert "fleet of 2 replicas" in err
    assert list(qdir.glob("quality.*.jsonl"))


@pytest.mark.parametrize("argv,needle", [
    (["--id", "a", "--id", "b"], "more --id flags"),
    (["--replicas", "0"], "--replicas must be >= 1"),
    (["--quality", "--no-quality"], "mutually exclusive"),
    (["--learn", "--no-quality"], "--learn requires quality")],
    ids=["ids", "replicas", "quality", "learn"])
def test_serve_argument_errors_are_the_jax_commands(ckpt_file, argv,
                                                    needle):
    argv = ["--model", str(ckpt_file), *argv]
    port = _run(cli.serve_main, argv + CPU, stdin="")
    _same_error(port, _run(jax_cli.serve_main, argv, stdin=""))
    assert needle in port[2]


def test_serve_unloadable_checkpoint_exits_2(tmp_path):
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"nope")
    rc, _, err = _run(cli.serve_main, ["--model", str(bad)] + CPU,
                      stdin="")
    assert rc == 2 and err.startswith(f"error: cannot load {bad}")


# -------------------------------------------------------------------- report


def test_report_writes_two_svgs(tmp_path):
    from kmeans_tpu_torch.utils.diagram import main as report_main
    rc, out, _ = _run(report_main, ["--out-dir", str(tmp_path)])
    assert rc == 0
    for name in ("architecture_diagram.svg", "kmeans_tpu_report.svg"):
        path = tmp_path / name
        assert path.stat().st_size > 5_000
        xml.dom.minidom.parse(str(path))
        assert f"wrote {path}" in out
        text = path.read_text()
        assert "TPU" not in text and "ms" not in text.split()


def test_report_draws_in_the_suites_speedup_graph(tmp_path):
    from kmeans_tpu_torch.utils.diagram import render_report
    from kmeans_tpu_torch.utils.plotting import save_speedup_graph
    graph = save_speedup_graph([1, 2, 4], {1: 1.0, 2: 1.9, 4: 3.5},
                               tmp_path / "speedup_graph.svg")
    with_graph = render_report(tmp_path / "a.svg", speedup=graph)
    without = render_report(tmp_path / "b.svg")
    xml.dom.minidom.parse(str(with_graph))
    assert "Speedup vs Number of Shards" in with_graph.read_text()
    assert "Speedup vs Number of Shards" not in without.read_text()


# -------------------------------------------------------- the module router


def test_every_command_is_routed():
    """One subprocess runs ``python -m kmeans_tpu_torch <command> --help``
    for every command, as ``-m`` does (``runpy``), and the three commands
    not ported yet.  Each argparse command prints its own usage line."""
    script = r"""
import contextlib, io, json, runpy, sys
from kmeans_tpu_torch.__main__ import COMMANDS
out = {}
for cmd in list(COMMANDS) + ["nope"]:
    sys.argv = ["kmeans_tpu_torch", cmd, "--help"]
    so, se = io.StringIO(), io.StringIO()
    code = None
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        try:
            runpy.run_module("kmeans_tpu_torch", run_name="__main__")
        except SystemExit as e:
            code = e.code
    out[cmd] = [code, so.getvalue(), se.getvalue()]
print(json.dumps(out))
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for cmd in main_mod.COMMANDS:
        code, out, err = got[cmd]
        if cmd in main_mod.NOT_PORTED:
            assert code == 2
            assert f"ROADMAP {main_mod.NOT_PORTED[cmd]}" in err
        elif cmd == "suite":
            assert code == 0 and "tests A-E" in out
        else:
            assert code == 0, (cmd, err)
            assert f"usage: python -m kmeans_tpu_torch {cmd}" in \
                " ".join(out.split()), cmd
    assert got["nope"][0] == 2 and "unknown command 'nope'" in \
        got["nope"][2]
    assert {"jax", "kmeans_tpu"}.isdisjoint(proc.stdout.split())


def test_the_command_list_is_the_jax_packages(monkeypatch):
    err = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["kmeans_tpu", "nope"])
    with contextlib.redirect_stderr(err):
        assert jax_main_mod.main() == 2
    listed = err.getvalue().split("available:")[1].replace(",", " ").split()
    assert sorted(listed) == sorted(main_mod.COMMANDS)


@pytest.mark.parametrize("cmd", ("bench", "bench-diff", "lint"))
def test_unported_commands_exit_2_naming_their_item(monkeypatch, cmd):
    """The commands that were not ported: ``bench`` and ``bench-diff`` still
    exit 2 naming their ROADMAP item; ``lint`` is ported and exits 0 over
    the port (the package lints clean)."""
    monkeypatch.setattr(sys, "argv", ["kmeans_tpu_torch", cmd])
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main_mod.main()
    if cmd == "lint":
        assert "lint" not in main_mod.NOT_PORTED
        assert code == 0, out.getvalue()[-3000:]
        assert "lint: 0 findings over" in out.getvalue()
    else:
        assert code == 2
        assert f"ROADMAP {main_mod.NOT_PORTED[cmd]}" in err.getvalue()
    assert "kmeans_tpu_torch.benchmarks" not in sys.modules


# --------------------------------------------------------------- error paths


def test_fit_bad_shape(tmp_path):
    path = tmp_path / "bad.npy"
    np.save(path, np.zeros(7, np.float32))
    argv = [str(path), "--k", "2", "--quiet"]
    _same_error(_run(cli.main, argv + CPU), _run(jax_cli.main, argv))


def test_fit_missing_file(tmp_path):
    argv = [str(tmp_path / "nope.npy"), "--k", "2", "--quiet"]
    _same_error(_run(cli.main, argv + CPU), _run(jax_cli.main, argv))


def test_fit_bad_npz_key(data_file, tmp_path):
    npz = tmp_path / "d.npz"
    np.savez(npz, a=np.load(data_file))
    argv = [str(npz), "--npz-key", "missing", "--k", "2", "--quiet"]
    port = _run(cli.main, argv + CPU)
    _same_error(port, _run(jax_cli.main, argv))
    assert "available" in port[2]


def test_fit_bad_bucket(data_file, tmp_path):
    argv = [str(data_file), "--k", "2", "--quiet", "--bucket", "soon",
            "--out-dir", str(tmp_path)]
    _same_error(_run(cli.main, argv + CPU), _run(jax_cli.main, argv))


@pytest.mark.parametrize("bad", ["9:2", "abc", "0:4", "2:5000"])
def test_sweep_invalid_range(data_file, bad):
    argv = [str(data_file), "--k-range", bad]
    _same_error(_run(cli.sweep_main, argv + CPU),
                _run(jax_cli.sweep_main, argv))


@pytest.mark.parametrize("argv", [
    ["--k-range", "2:5", "--criterion", "bic"],
    ["--model", "gmm", "--k-range", "2:5", "--criterion", "silhouette"]],
    ids=["kmeans_bic", "gmm_silhouette"])
def test_sweep_criterion_family_mismatch(data_file, argv):
    argv = [str(data_file), *argv]
    _same_error(_run(cli.sweep_main, argv + CPU),
                _run(jax_cli.sweep_main, argv))


def test_cost_report_unknown_family():
    argv = ["--families", "kmeans,nope"]
    _same_error(_run(cli.cost_report_main, argv + CPU),
                _run(jax_cli.cost_report_main, argv))


def test_cost_report_on_the_cpu():
    """On the CPU the report runs and its rows say ``available: False``
    (no allocator peak), exit 0."""
    rc, out, _ = _run(cli.cost_report_main,
                      ["--families", "kmeans", "--n", "512", "--d", "8",
                       "--k", "4", "--json"] + CPU)
    rep = json.loads(out)
    assert rc == 0 and rep["backend"] == "cpu"
    assert [r["family"] for r in rep["rows"]] == ["kmeans"]
    assert rep["rows"][0]["available"] is False


def test_warm_exits_2_on_the_cpu():
    """No library loads on the CPU: ``warm`` refuses with the reference's
    message and ``available=False``."""
    rc, _, err = _run(cli.warm_main, ["--family", "kmeans", "--shape",
                                      "1024x8", "--k", "4"] + CPU)
    ok, reason = aot.aot_supported()
    assert rc == 2 and not ok
    assert err == (f"error: this backend cannot serialize compiled "
                   f"executables ({reason}); the AOT cache is unavailable "
                   f"(available=False)\n")


def test_warm_requires_shape_without_ckpt(monkeypatch, tmp_path):
    """The reference's argument error, past the capability check (stubbed:
    no card here)."""
    monkeypatch.setattr(aot, "aot_supported", lambda: (True, "ok"))
    argv = ["--family", "kmeans", "--k", "4", "--aot-dir",
            str(tmp_path / "store")]
    try:
        port = _run(cli.warm_main, argv + CPU)
        _same_error(port, _run(jax_cli.warm_main, argv))
    finally:
        aot.deactivate()
        jax_aot.deactivate()
    assert "--shape" in port[2]


def test_warm_on_a_model_axis_raises_the_ports_error(monkeypatch, tmp_path):
    """``--model-shards 2`` needs a world of two ranks in the port: the
    warm fit raises the mesh's error (the reference set ``mesh=None``)."""
    monkeypatch.setattr(aot, "aot_supported", lambda: (True, "ok"))
    try:
        with pytest.raises(ValueError, match="model=2"):
            _run(cli.warm_main, ["--family", "kmeans", "--shape", "256x4",
                                 "--k", "4", "--model-shards", "2",
                                 "--aot-dir", str(tmp_path / "s")] + CPU)
    finally:
        aot.deactivate()


def test_warm_puts_the_models_libraries_into_the_store(monkeypatch,
                                                       tmp_path,
                                                       ckpt_file):
    """With a checkpoint the store's mirror is ``<ckpt>.aot``, and the
    libraries of the model's mode go into it even where the process had
    them loaded already (the warm fit then loads nothing).  The CPU has
    no library: the kernel mode's library is a stand-in file, and
    ``_build.load`` returns it as loaded."""
    from kmeans_tpu_torch.ops import _build
    monkeypatch.setattr(aot, "aot_supported", lambda: (True, "ok"))
    monkeypatch.setattr(aot, "artifact_key",
                        lambda name, defines=None, capability="auto": {
                            "library": name, "defines": []})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build.library_path("assign_kernels")
    lib.parent.mkdir()
    lib.write_bytes(b"\0" * 32)
    monkeypatch.setattr(_build, "load", lambda name: None)
    monkeypatch.setattr(cli, "_model_libraries",
                        lambda model: ["assign_kernels"])
    try:
        rc, out, _ = _run(cli.warm_main,
                          [str(ckpt_file), "--shape", "512x6", "--json",
                           "--aot-dir", str(tmp_path / "store")] + CPU)
    finally:
        aot.deactivate()
    stats = json.loads(out)
    assert rc == 0 and stats["k"] == 3 and stats["saved"] == 1
    assert stats["mirror"] == str(aot.aot_dir_for(ckpt_file))
    shipped = aot.describe_dir(aot.aot_dir_for(ckpt_file))
    assert shipped["artifacts"] == 1
    assert [lib["library"] for lib in shipped["libraries"]] == \
        ["assign_kernels"]
    assert len(list((tmp_path / "store").glob("*.klib"))) == 1


def test_model_libraries_follow_the_distance_mode():
    assert cli._model_libraries(kt.KMeans(
        k=2, device="cpu", distance_mode="pallas")) == ["assign_kernels"]
    assert cli._model_libraries(kt.KMeans(
        k=2, device="cpu", distance_mode="pallas_bf16")) == ["assign_bf16"]
    assert cli._model_libraries(kt.KMeans(k=2, device="cpu")) == []
    assert cli._model_libraries(kt.GaussianMixture(
        n_components=2, device="cpu")) == []


@pytest.mark.parametrize("cmd,argv", [
    ("main", ["{data}", "--k", "2", "--quiet"]),
    ("sweep_main", ["{data}", "--k-range", "2:4"]),
    ("serve_main", ["--model", "{ckpt}"]),
    ("cost_report_main", ["--families", "kmeans"]),
    ("plan_main", ["--n", "100", "--d", "4", "--k", "2"])],
    ids=["fit", "sweep", "serve", "cost-report", "plan"])
def test_the_card_is_the_default_device(data_file, ckpt_file, cmd, argv):
    """Without ``--device`` a command runs on the card: here, with none,
    it exits 2 with the estimators' error."""
    argv = [a.format(data=data_file, ckpt=ckpt_file) for a in argv]
    rc, _, err = _run(getattr(cli, cmd), argv, stdin="")
    assert rc == 2
    assert "runs on an NVIDIA GPU by default" in err
    assert "pass device='cpu'" in err
