"""The port's invariant linter (``kmeans_tpu_torch.analysis``) against the
JAX package's (``kmeans_tpu.analysis``), on the same sources.

* The rules that carry over as they are (``thread``, ``counter-reset``,
  ``dead-private``, ``cache-name``, ``quality-counter``, ``fleet-record``,
  ``atomic-swap``, ``suppression``) give the reference's findings (rule,
  line, message, incident) on every fixture of ``tests/test_lint.py``,
  read from that file, under every path scope; so do the suppression
  grammar and ``Report.to_json()``.
* Both CLIs give the same exit codes and output, up to the program name.
* Each rewritten rule finds on a torch translation of the reference's
  firing fixture what the reference finds on the fixture itself: the same
  number of findings, on the same lines (the translations keep the
  layout).
* The package self-test: the port lints clean, with at most three
  suppressions, each with a reason and each used, and ``analysis`` imports
  only the standard library.
"""

import ast
import contextlib
import io
import json
import sys
from pathlib import Path

import pytest
import torch

import kmeans_tpu_torch
from kmeans_tpu_torch.analysis import RULES, lint_paths
from kmeans_tpu_torch.analysis.cli import main as lint_main
from kmeans_tpu.analysis import RULES as JRULES
from kmeans_tpu.analysis import lint_paths as jlint_paths
from kmeans_tpu.analysis.cli import main as jlint_main

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG_DIR = Path(kmeans_tpu_torch.__file__).parent
REF_TESTS = ROOT / "tests" / "test_lint.py"

#: The rules whose code is the reference's, with the port's names.
CARRIED = ("thread", "counter-reset", "dead-private", "cache-name",
           "quality-counter", "fleet-record", "atomic-swap", "suppression")
REWRITTEN = ("trace-hazard", "cache-key", "dispatch", "obs-span",
             "collective-span", "ingest-span", "aot-key", "large-k",
             "fault-path")
SCOPES = ("parallel", "ops", "serving", "models", "data", "orchestrator",
          "utils")


def _key(f):
    return (f.rule, f.path, f.line, f.message, f.incident)


def _reference_fixtures():
    """Every multi-line Python source among the string constants of the
    reference's tests (the ``_*_BAD`` / ``_*_OK`` fixtures and the inline
    ``src`` snippets), by a name that locates it."""
    tree = ast.parse(REF_TESTS.read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "\n" in node.value.strip("\n") \
                and "def " in node.value + "class " and "=" in node.value:
            try:
                ast.parse(node.value)
            except SyntaxError:
                continue
            out.setdefault(f"test_lint.py:{node.lineno}", node.value)
    return out


REF_FIXTURES = _reference_fixtures()


def _write(tmp_path, subdir, source, name="mod.py"):
    d = tmp_path / subdir
    d.mkdir(parents=True, exist_ok=True)
    f = d / name
    f.write_text(source)
    return f


# ---------------------------------------------------------------- registry

def test_rule_ids_are_the_references():
    assert set(RULES) == set(JRULES)
    assert set(RULES) == set(CARRIED) | set(REWRITTEN)
    assert len(RULES) == 17
    for rule in RULES.values():
        assert rule.id and rule.incident, rule
        assert rule.incident == JRULES[rule.id].incident


def test_reference_fixtures_were_found():
    assert len(REF_FIXTURES) >= 40


# ------------------------------------------- carried-over rules: parity

@pytest.mark.parametrize("scope", SCOPES)
def test_carried_rules_match_the_reference_on_its_fixtures(tmp_path, scope):
    """Every reference fixture, under every path scope: the carried-over
    rules find what the reference's find.  The one difference is a name
    the port does not have: its mixture keeps no ``_params_cache`` device
    cache, so ``atomic-swap`` does not list it."""
    for i, (where, src) in enumerate(sorted(REF_FIXTURES.items())):
        f = _write(tmp_path, scope, src, name=f"fx{i}.py")
        got = {_key(x) for x in lint_paths([f], rules=list(CARRIED))
               .findings}
        want = {_key(x) for x in jlint_paths([f], rules=list(CARRIED))
                .findings}
        assert got <= want, (where, got - want)
        assert {w for w in want - got
                if "._params_cache" not in w[3]} == set(), where


def test_the_params_cache_difference_is_the_only_one(tmp_path):
    src = "class U:\n    def drop(self, m):\n        del m._params_cache\n"
    f = _write(tmp_path, "serving", src)
    assert [x.rule for x in jlint_paths([f]).findings] == ["atomic-swap"]
    assert lint_paths([f]).findings == []


@pytest.mark.parametrize("src", [
    "def _orphan(x):  # lint: ok(dead-private) — kept as a fixture\n"
    "    return x + 1\n",
    "# lint: ok(dead-private) — fixture helper\n"
    "def _orphan(x):\n    return x + 1\n",
    "X = 1  # lint: ok(dead-private)\nY = 2  # lint: ok() — why\n",
    "X = 1  # lint: ok(no-such-rule) — because\n",
    "X = 1  # lint: ok(thread, dead-private) – two rules, en-dash\n",
    "def _orphan(x):\n    return x\n\n\n"
    "def used(x):\n    \"\"\"Mentions _orphan in prose.\"\"\"\n    return x\n",
], ids=["same-line", "preceding-line", "malformed", "unknown-rule",
        "two-rules", "docstring-mention"])
def test_suppression_grammar_matches_the_reference(tmp_path, src):
    f = _write(tmp_path, "models", src, name="m.py")
    got, want = lint_paths([f]), jlint_paths([f])
    assert [_key(x) for x in got.findings] == \
        [_key(x) for x in want.findings]
    assert got.suppressed == want.suppressed
    assert [s.to_json() for s in got.suppressions] == \
        [s.to_json() for s in want.suppressions]


def test_report_json_matches_the_reference_on_a_mixed_tree(tmp_path,
                                                           monkeypatch):
    srcs = [s for s in REF_FIXTURES.values()
            if ("_orphan" in s or "threading" in s or "segments_" in s
                or "LRUCache(64" in s or "_record(" in s)
            and "jax" not in s]
    assert len(srcs) >= 6
    for i, src in enumerate(srcs):
        _write(tmp_path, ("models", "serving", "data")[i % 3], src,
               name=f"f{i}.py")
    _write(tmp_path, "models", "Z = 1  # lint: ok(thread) — inert example\n",
           name="z.py")
    monkeypatch.chdir(tmp_path)
    got = lint_paths([Path(".")], rules=list(CARRIED)).to_json()
    want = jlint_paths([Path(".")], rules=list(CARRIED)).to_json()
    assert got == want
    assert got["findings"] and got["suppressions"]
    assert set(got) == {"files", "findings", "counts", "suppressed",
                        "suppressions"}


# ------------------------------------------------------------------- CLI

_JPROG, _PROG = "python -m kmeans_tpu lint", "python -m kmeans_tpu_torch lint"


def _run_cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = main(argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue()


def _cli_case(tmp_path, case):
    models = tmp_path / "models"
    models.mkdir(exist_ok=True)
    dead = "\ndef _orphan(x):\n    return x + 1\n\n\ndef used(x):\n" \
        "    return x\n"
    if case == "clean":
        (models / "m.py").write_text("def used(x):\n    return x\n")
        return [str(models)]
    if case in ("violation", "json", "rule-thread", "rule-dead"):
        (models / "m.py").write_text(
            dead + "\nZ = 1  # lint: ok(thread) — inert example\n")
        return {"violation": [str(models)],
                "json": ["--json", str(models)],
                "rule-thread": ["--rule", "thread", str(models)],
                "rule-dead": ["--rule", "dead-private", "--rule",
                              "thread", str(models)]}[case]
    if case == "bad-path":
        return [str(tmp_path / "no" / "such" / "target")]
    if case == "not-python":
        (tmp_path / "notes.txt").write_text("hi")
        return [str(tmp_path / "notes.txt")]
    if case == "unknown-rule":
        (models / "m.py").write_text("def used(x):\n    return x\n")
        return ["--rule", "no-such-rule", str(models)]
    if case == "syntax":
        (models / "m.py").write_text("def broken(:\n")
        return [str(models)]
    if case == "help":
        return ["--help"]
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["clean", "violation", "json",
                                  "rule-thread", "rule-dead", "bad-path",
                                  "not-python", "unknown-rule", "syntax",
                                  "help"])
def test_cli_matches_the_reference(tmp_path, case):
    argv = _cli_case(tmp_path, case)
    got = _run_cli(lint_main, argv)
    want = _run_cli(jlint_main, argv)
    assert got[0] == want[0], (got, want)
    if case == "help":
        # argparse wraps the usage line by the program name's length, and
        # the default target is named by the package.
        got = tuple(" ".join(x.replace(_PROG, _JPROG).replace(
            "kmeans_tpu_torch", "kmeans_tpu").split())
            if isinstance(x, str) else x for x in got)
        want = tuple(" ".join(x.split()) if isinstance(x, str) else x
                     for x in want)
    assert got[1].replace(_PROG, _JPROG) == want[1]
    assert got[2].replace(_PROG, _JPROG) == want[2]
    expect = {"clean": 0, "rule-thread": 0, "help": 0}.get(case, 2)
    assert got[0] == expect
    if case == "json":
        payload = json.loads(got[1])
        assert payload["counts"] == {"dead-private": 1}
        assert payload["suppressions"][0]["reason"] == "inert example"


def test_main_module_routes_lint(monkeypatch, tmp_path):
    import kmeans_tpu_torch.__main__ as entry
    d = _write(tmp_path, "models", "def used(x):\n    return x\n").parent
    monkeypatch.setattr(sys, "argv", ["kmeans_tpu_torch", "lint", str(d)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert entry.main() == 0
    assert "lint: 0 findings over 1 files" in out.getvalue()
    assert "lint" not in entry.NOT_PORTED
    assert sorted(entry.NOT_PORTED) == ["bench", "bench-diff"]


def test_cli_lint_main_delegates(tmp_path):
    from kmeans_tpu_torch import cli
    d = _write(tmp_path, "models", "def _orphan():\n    pass\n").parent
    code, out, _ = _run_cli(cli.lint_main, [str(d)])
    assert code == 2 and "[dead-private]" in out


# ------------------------- rewritten rules: JAX fixture vs its translation

#: rule -> (scope, the reference's firing fixture's name in test_lint.py,
#: its torch translation, which keeps the layout).
_TRANSLATIONS = {
    "trace-hazard": ("parallel", "_TRACE_BAD", '''
import torch
from kmeans_tpu_torch.parallel.distributed import _Replay

class Loop(_Replay):
    def iterate(self):
        v = float(self.carry)         # host cast of a device tensor
        if self.chunk.sum() > 0:      # Python branch on a tensor
            v = v + 1
        import numpy as np
        a = np.asarray(self.carry)    # host materialization
        b = self.carry.item()         # host sync
        while v > 0:                  # Python loop in a captured body
            v -= 1
        self.carry.add_(v)

    def __init__(self):
        self.carry = torch.zeros(())
        self.chunk = torch.ones(4)
'''),
    "cache-key": ("models", "_CACHEKEY_BAD", '''
from kmeans_tpu_torch.parallel.sharding import Dataset

_unused = None


def get_loop(ds, chunk, mode, build):
    return ds.memo(
        ("loop", chunk),
        lambda: build(ds, chunk_size=chunk, mode=mode))
'''),
    "dispatch": ("serving", "_DISPATCH_BAD", '''
from kmeans_tpu_torch.models.kmeans import _cached

_unused = None


def serve(pts, mesh, chunk, build):
    fn = _cached(build, mesh, chunk_size=chunk)
    return fn(pts)
'''),
    "obs-span": ("serving", "_OBS_SPAN_BAD", '''
from kmeans_tpu_torch.models.kmeans import _cached
from kmeans_tpu_torch.utils.profiling import note_dispatch

_unused = None


def serve(pts, mesh, chunk, build):
    fn = _cached(build, mesh, chunk_size=chunk)
    note_dispatch("serve/predict")
    return fn(pts)
'''),
    "collective-span": ("parallel", "_COLLECTIVE_BAD", '''
import torch
import torch.distributed as tdist


def gather_counts(n_local):
    return tdist.all_gather_object(
        [None] * tdist.get_world_size(), n_local)
'''),
    "ingest-span": ("data", "_INGEST_BAD", '''
import torch
import numpy as np


def place_shards(x, spans, n_pad, device):
    parts = [torch.from_numpy(x[lo:hi]).to(dev)
             for lo, hi, dev in spans]
    return torch.cat(parts).to(
        device)
'''),
    "aot-key": ("utils", "_AOT_KEY_BAD", '''
def persist(store, library, name, defines):
    fields = {"library": name, "defines": defines}  # hand-rolled key
    store.put(fields, library)
'''),
    "large-k": ("models", "_LARGE_K_BAD", '''
from kmeans_tpu_torch.parallel import distributed as dist
from kmeans_tpu_torch.models.kmeans import _cached

class Estimator:
    def fit(self, pts, mesh, chunk):
        step = _cached(dist.make_step_fn, mesh, chunk_size=chunk)
        return step(pts)
'''),
    "fault-path": ("orchestrator", "_FAULT_BAD", '''
import torch


def supervise(worker):
    try:
        worker.step()
    except torch.cuda.OutOfMemoryError:
        pass                       # swallowed fault: never routed
'''),
}


def _reference_constant(name):
    tree = ast.parse(REF_TESTS.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return node.value.value
    raise KeyError(name)


@pytest.mark.parametrize("rule", REWRITTEN)
def test_rewritten_rule_finds_on_the_translation_what_the_reference_finds(
        tmp_path, rule):
    scope, name, torch_src = _TRANSLATIONS[rule]
    jax_src = _reference_constant(name)
    jf = _write(tmp_path / "jax", scope, jax_src)
    tf = _write(tmp_path / "torch", scope, torch_src)
    want = [f.line for f in jlint_paths([jf], rules=[rule]).findings]
    got = [f.line for f in lint_paths([tf], rules=[rule]).findings]
    assert want, rule
    assert got == want
    # The JAX idioms themselves mean nothing to the port's rule where
    # the port has no such idiom.
    if rule in ("trace-hazard", "collective-span", "ingest-span"):
        assert lint_paths([jf], rules=[rule]).findings == []


# ------------------------------------------------------ package self-test

@pytest.fixture(scope="module")
def package_report():
    return lint_paths([PKG_DIR])


def test_package_lints_clean(package_report):
    """``python -m kmeans_tpu_torch lint`` exits 0 on the shipped port."""
    report = package_report
    assert report.files > 60
    assert report.findings == [], "\n".join(
        f.format() for f in report.findings)


def test_package_suppression_inventory_is_small_and_used(package_report):
    sups = package_report.suppressions
    assert len(sups) <= 3
    for sup in sups:
        assert sup.reason, f"reason-less suppression at {sup.path}:" \
                           f"{sup.line}"
        assert sup.used > 0, f"stale suppression at {sup.path}:{sup.line}"


def test_analysis_imports_only_the_standard_library():
    stdlib = set(sys.stdlib_module_names)
    for path in sorted((PKG_DIR / "analysis").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top in stdlib or name.startswith(
                    "kmeans_tpu_torch.analysis"), (path.name, name)
