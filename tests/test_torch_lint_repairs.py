"""The repairs the port's linter prompted, each pinned by a test that
fails on the tree before it:

* the learner thread's counted suppression, the reference's
  (``serving/learn.py``);
* ``ingest-span``: the one-copy ('mono') placement of ``data.io``'s
  process-local loader, the key upload of ``permuted_draws``, the index
  upload of ``Dataset.take`` and the centres of ``generate_rows`` each
  under a ``stage`` span; the copies of ``BlockStager`` and the weights of
  ``with_weights`` placed inside their spans;
* ``collective-span``: ``gather_kshard_stats``'s gloo gather under a
  ``collective`` span;
* ``cache-key``: the loops of ``make_multi_fit_fn`` and
  ``make_minibatch_fit_fn`` kept per builder product; the GMM loop built
  from its key's arguments, on the dataset's own mesh (a loop built for
  one mesh refuses a dataset of another); the measurement cache and the
  device loop's one-for-every-chunk memo suppressed with their reasons;
* ``large-k``: ``BisectingKMeans`` and ``MiniBatchKMeans`` build their
  steps through ``KMeans._step_fn``, beside the planner checks.

No repair changes a result: the parity tests of these modules hold them
to the JAX package, unchanged.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import kmeans_tpu_torch
from kmeans_tpu_torch import obs
from kmeans_tpu_torch.analysis import lint_paths
from kmeans_tpu_torch.data import synthetic
from kmeans_tpu_torch.parallel import distributed as dist
from kmeans_tpu_torch.parallel.sharding import to_device

from test_torch_distributed import _spawn

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG_DIR = Path(kmeans_tpu_torch.__file__).parent


def _spans(records, name):
    return [r for r in records if r.get("kind") == "span"
            and r.get("name") == name]


# --------------------------------------------------- the repaired files


@pytest.mark.parametrize("rule,rel", [
    ("thread", "serving/learn.py"),
    ("ingest-span", "data/io.py"),
    ("ingest-span", "data/synthetic.py"),
    ("ingest-span", "parallel/sharding.py"),
    ("collective-span", "parallel/distributed.py"),
    ("cache-key", "parallel/distributed.py"),
    ("cache-key", "parallel/gmm_step.py"),
    ("cache-key", "models/kmeans.py"),
    ("large-k", "models/bisecting.py"),
    ("large-k", "models/minibatch.py"),
])
def test_repaired_file_lints_clean(rule, rel):
    findings = lint_paths([PKG_DIR / rel], rules=[rule]).findings
    assert findings == [], [f.format() for f in findings]


def _suppressions(rel):
    return {s.line: s for s in lint_paths([PKG_DIR / rel]).suppressions}


def test_learner_thread_suppression_is_the_references():
    ref = _suppressions_of(ROOT / "kmeans_tpu" / "serving" / "learn.py")
    port = _suppressions(Path("serving") / "learn.py")
    assert [s.rules for s in port.values()] == [("thread",)]
    assert [s.reason for s in port.values()] == \
        [s.reason for s in ref.values()]


def _suppressions_of(path):
    from kmeans_tpu_torch.analysis.core import Module
    mod = Module(path, str(path), path.read_text())
    return mod.suppressions


def test_measurement_cache_suppression_is_the_references():
    ref = _suppressions_of(ROOT / "kmeans_tpu" / "models" / "kmeans.py")
    port = _suppressions("models/kmeans.py")
    assert [s.reason for s in port.values()] == \
        [s.reason for s in ref.values()]
    assert [s.rules for s in port.values()] == [("cache-key",)]


def test_device_loop_memo_suppression_names_its_reason():
    sups = list(_suppressions("parallel/distributed.py").values())
    assert [s.rules for s in sups] == [("cache-key",)]
    assert "chunk" in sups[0].reason and sups[0].used == 1


# ------------------------------------------------------ ingest-span


def test_take_without_a_host_copy_stages_its_index():
    ds = synthetic.device_shards(50, 3, seed=1, device="cpu")
    assert ds.host is None
    with obs.tracing() as tr:
        rows = ds.take(np.array([3, 7, 11]))
    stage = _spans(tr.records(), "stage")
    assert len(stage) == 1
    assert stage[0]["attrs"] == {"rows": 3, "bytes": 24}
    np.testing.assert_array_equal(
        rows, ds.points[[3, 7, 11]].numpy())


def test_device_draws_stage_their_keys():
    ds = synthetic.device_shards(60, 3, seed=2, device="cpu")
    with obs.tracing() as tr:
        rows = ds.sample_positive_rows(5, [4, 5])
    stage = _spans(tr.records(), "stage")
    assert len(stage) == 1 and stage[0]["attrs"]["rows"] >= 1
    assert rows.shape == (5, 3)


def test_generate_rows_stages_host_centres():
    centers = np.arange(12, dtype=np.float32).reshape(4, 3)
    with obs.tracing() as tr:
        synthetic.generate_rows(0, 10, 10, 3, kind="blobs", seed=1,
                                dtype=np.float32, centers=centers)
    stage = _spans(tr.records(), "stage")
    assert len(stage) == 1
    assert stage[0]["attrs"] == {"rows": 4, "bytes": centers.nbytes}


def test_device_shards_places_the_centres_under_its_own_span():
    """The generator's one ``stage`` span covers the centres of 'blobs'
    too, and the rows are those of the host oracle."""
    centers = np.arange(12, dtype=np.float32).reshape(4, 3)
    with obs.tracing() as tr:
        ds = synthetic.device_shards(40, 3, kind="blobs", seed=5,
                                     centers=centers, device="cpu")
    stage = _spans(tr.records(), "stage")
    assert [s["attrs"]["ingest"] for s in stage] == ["synthetic"]
    host = synthetic.host_equivalent(40, 3, kind="blobs", seed=5,
                                     centers=centers)
    assert ds.points.numpy().tobytes() == host.tobytes()


def test_with_weights_places_inside_its_span():
    """The weights' copy is now lexically inside ``with_weights``' stage
    span (the helper returns the host block)."""
    X = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    ds = to_device(X, torch.device("cpu"), np.float32)
    w = np.linspace(0.5, 2.0, 20)
    with obs.tracing() as tr:
        new = ds.with_weights(w)
    assert len(_spans(tr.records(), "stage")) == 1
    np.testing.assert_array_equal(new.weights.numpy(),
                                  w.astype(np.float32))
    src = (PKG_DIR / "parallel" / "sharding.py").read_text()
    assert "_weights_like" not in src


# ------------------------------------------------------------ cache-key


def _ds(n=64, d=3, seed=0):
    X = np.random.default_rng(seed).normal(size=(n, d))
    return to_device(X.astype(np.float64), torch.device("cpu"), np.float64)


def _memo_keys(ds, head):
    return [k for k in ds._memo if isinstance(k, tuple) and k[0] == head]


def test_minibatch_loops_are_kept_per_builder_product():
    ds = _ds()
    kw = dict(batch=16, mode="matmul", k=3, max_iter=2, tolerance=0.0,
              history_sse=True, reassignment_ratio=0.0, reassign_every=1,
              chunk_size=64, host_loop=False)
    c0 = ds.points[:3].clone()
    a = dist.make_minibatch_fit_fn(None, **kw)(ds, c0, 0)
    b = dist.make_minibatch_fit_fn(None, **kw)(ds, c0, 0)
    assert len(_memo_keys(ds, "minibatch_loop")) == 2
    np.testing.assert_array_equal(a.centroids.numpy(), b.centroids.numpy())


def test_multi_fit_loops_are_kept_per_builder_product():
    ds = _ds()
    kw = dict(chunk_size=64, mode="matmul", k_real=3, max_iter=3,
              tolerance=0.0, n_init=2)
    c0 = torch.stack([ds.points[:3], ds.points[3:6]]).clone()
    a = dist.make_multi_fit_fn(None, **kw)(ds, c0, [0, 1])
    b = dist.make_multi_fit_fn(None, **kw)(ds, c0, [0, 1])
    assert len(_memo_keys(ds, "multi_loop")) == 2
    np.testing.assert_array_equal(a.centroids.numpy(), b.centroids.numpy())


def test_gmm_loop_is_built_from_its_key():
    """The memo factory names nothing outside its key: the loop's tables
    are made by ``_em_loop`` from the key's arguments and the dataset."""
    src = (PKG_DIR / "parallel" / "gmm_step.py").read_text()
    tree = ast.parse(src)
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "make_gmm_multi_fit_fn")
    memo = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute) and n.func.attr == "memo"]
    assert len(memo) == 1
    body = memo[0].args[1].body
    assert isinstance(body, ast.Call) and body.func.id == "_em_loop"


# -------------------------------------------------------------- large-k


@pytest.mark.parametrize("family", ["bisecting", "minibatch"])
def test_subclasses_build_their_steps_through_kmeans(monkeypatch, family):
    from kmeans_tpu_torch import BisectingKMeans, MiniBatchKMeans
    from kmeans_tpu_torch.models.kmeans import KMeans
    calls = []
    real = KMeans._step_fn

    def spy(self, mesh, chunk, mode=None, **flags):
        calls.append((type(self).__name__, mode, tuple(sorted(flags))))
        return real(self, mesh, chunk, mode=mode, **flags)

    monkeypatch.setattr(KMeans, "_step_fn", spy)
    X = np.random.default_rng(3).normal(size=(120, 4)).astype(np.float32)
    if family == "bisecting":
        BisectingKMeans(k=3, max_iter=3, seed=0, device="cpu",
                        verbose=False).fit(X)
        assert ("BisectingKMeans", None,
                ("need_farthest", "need_sse", "need_sse_pc")) in calls
    else:
        MiniBatchKMeans(k=3, max_iter=3, batch_size=32, n_init=2, seed=0,
                        device="cpu", verbose=False).fit(X)
        assert ("MiniBatchKMeans", None,
                ("need_farthest", "need_sse_pc")) in calls


# ------------------------------------- the mesh repairs, one gloo rank


def _world1(rank, out_dir):
    import os
    from kmeans_tpu_torch import obs as pobs
    from kmeans_tpu_torch.data import io as pio
    from kmeans_tpu_torch.parallel import gmm_step
    from kmeans_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(1, 1)
    X = np.random.default_rng(4).normal(size=(40, 3)).astype(np.float32)
    path = os.path.join(out_dir, "x.npy")
    np.save(path, X)
    res = {}
    with pobs.tracing() as tr:
        ds = pio.from_npy(path, mesh, device="cpu", ingest="mono")
    res["mono"] = [s["attrs"] for s in tr.records()
                   if s.get("kind") == "span" and s["name"] == "stage"]
    res["mono_rows"] = ds.points.numpy().copy()
    st = dist.StepStats(torch.ones(2, 3), torch.ones(2), torch.zeros(()),
                        torch.zeros(()), torch.zeros(3), torch.ones(2))
    with pobs.tracing() as tr:
        out = dist.gather_kshard_stats(st, mesh, 2)
    res["gather"] = [s["attrs"] for s in tr.records()
                     if s.get("kind") == "span"
                     and s["name"] == "collective"]
    res["gather_sums"] = out.sums.numpy().copy()
    fit = gmm_step.make_gmm_multi_fit_fn(
        None, chunk_sizes=[64], max_iter=2, tol=0.0, reg_covar=1e-6,
        cov_type="diag", mode="torch")
    try:
        fit(ds, None, None, None, None, ks=[2])
        res["gmm"] = "ran"
    except Exception as e:                  # noqa: BLE001 - reported
        res["gmm"] = f"{type(e).__name__}: {e}"
    return res


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _spawn(_world1, 1, tmp_path_factory.mktemp("lint_world1"))[0]


def test_process_local_mono_placement_is_staged(world1):
    assert world1["mono"] == [{"rows": 40, "bytes": 40 * 3 * 4,
                               "ingest": "mono"}]
    assert world1["mono_rows"].shape == (40, 3)


def test_kshard_host_gather_is_a_collective_span(world1):
    assert len(world1["gather"]) == 1
    attrs = world1["gather"][0]
    assert attrs["site"] == "gather_kshard_stats"
    assert attrs["op"] == "all_reduce"
    np.testing.assert_array_equal(world1["gather_sums"], np.ones((2, 3)))


def test_gmm_loop_refuses_a_dataset_of_another_mesh(world1):
    assert "the dataset was placed with mesh=" in world1["gmm"]
