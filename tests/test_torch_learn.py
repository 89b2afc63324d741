"""Serve-and-learn in the port (``kmeans_tpu_torch.serving.learn``, the
``learn=`` argument of ``ServingEngine``, ``MiniBatchKMeans._learn_clone``)
against the JAX package's ``serving/learn.py`` on the CPU.

* The committed rules, the decision table and the ``learn`` config
  messages are the JAX package's.
* An update from the same reservoir batches gives the JAX learner's
  float64 Sculley carry, lifetime counts and iteration count
  (``rtol=1e-12``); a scripted sequence of updates, an injected failure,
  an underfilled reservoir and an injected regression gives the same
  decisions, counters and ``quality_report`` rows in both packages; the
  drift trigger and the cooldown fire at the same windows.
* A quiesced model equals the offline replay of its applied batches from
  the pre-update snapshot, bit for bit.
* A served table is read once: a publication landing between a reader's
  reads of ``centroids`` never hands the reader a table under another
  version's key, and readers hammering two fleet replicas during
  publications only ever see published tables, every replica the last one
  at the end.
* Budgets, the rollback to the snapshot, ``remove`` and ``close`` joining
  an update in flight, and the fleet's shared model.

Engines run with ``start=False``; the one background update (the drift
trigger) is joined with a timeout.  Nothing waits on the wall clock.
"""

import json
import threading

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu.obs import drift as jax_drift  # noqa: E402
from kmeans_tpu.obs import metrics_registry as jax_metrics  # noqa: E402
from kmeans_tpu.serving import ServingEngine as JaxEngine  # noqa: E402
from kmeans_tpu.serving import learn as jax_learn  # noqa: E402
from kmeans_tpu.utils import faults as jax_faults  # noqa: E402
import kmeans_tpu_torch as kt  # noqa: E402
from kmeans_tpu_torch import convert  # noqa: E402
from kmeans_tpu_torch.obs import drift as pt_drift  # noqa: E402
from kmeans_tpu_torch.obs import metrics_registry as pt_metrics  # noqa: E402
from kmeans_tpu_torch.serving import (ServingEngine, ServingFleet,  # noqa: E402
                                      UpdateRolledBack, publish_tables)
from kmeans_tpu_torch.serving import learn as pt_learn  # noqa: E402
from kmeans_tpu_torch.utils import faults  # noqa: E402

F64 = dict(rtol=1e-12, atol=1e-10)
#: Small exact batches and no cooldown, as the JAX package's tests run.
LEARN = {"batch_rows": 128, "min_rows": 128, "max_batches": 2,
         "cooldown_windows": 0}
TIMEOUT = 60.0


@pytest.fixture(autouse=True)
def _fresh_metrics():
    pt_metrics.REGISTRY.reset()
    jax_metrics.REGISTRY.reset()
    yield
    pt_metrics.REGISTRY.reset()
    jax_metrics.REGISTRY.reset()


@pytest.fixture(scope="module")
def data():
    X, _ = make_blobs(n_samples=6000, centers=4, n_features=8,
                      cluster_std=0.5, center_box=(-40, 40),
                      random_state=7)
    return X


def _fitted(data, seed=0, dtype=np.float32):
    return kt.MiniBatchKMeans(k=4, seed=seed, batch_size=256, max_iter=8,
                              dtype=dtype, device="cpu",
                              verbose=False).fit(data[:3000].astype(dtype))


def _pair(data, mesh1):
    """A float64 'matmul' MiniBatchKMeans of the JAX package and its
    conversion into the port: the same fitted state in both."""
    jm = kmeans_tpu.MiniBatchKMeans(k=4, seed=0, batch_size=256, max_iter=8,
                                    dtype=np.float64, distance_mode="matmul",
                                    verbose=False, mesh=mesh1).fit(
                                        data[:3000])
    pm = convert.from_jax_state(jm._state_dict(), device="cpu")
    jm.mesh = None
    return jm, pm


def _engine(model, tmp_path, learn=None, **kw):
    eng = ServingEngine(device="cpu", quality=True,
                        quality_dir=str(tmp_path), start=False,
                        learn=dict(LEARN, **(learn or {})), **kw)
    eng.add_model("m", model)
    return eng


def _jax_engine(model, tmp_path, mesh1, learn=None, **kw):
    eng = JaxEngine(mesh=mesh1, quality=True, quality_dir=str(tmp_path),
                    start=False, learn=dict(LEARN, **(learn or {})), **kw)
    eng.add_model("m", model)
    return eng


def _blocks(data, n_blocks=4, rows=128, start=3000, dtype=np.float32):
    return [data[start + i * rows: start + (i + 1) * rows].astype(dtype)
            for i in range(n_blocks)]


def _feed(eng, blocks):
    for b in blocks:
        eng.call("m", b, op="predict")


def _learner(eng):
    return eng._residents["m"].learner


# ------------------------------------------------------------- surface


def test_committed_rules_are_the_jax_packages():
    assert pt_learn.COMMITTED_LEARN_RULES == \
        jax_learn.COMMITTED_LEARN_RULES
    for name in ("UPDATE_BATCH_ROWS", "UPDATE_MAX_BATCHES",
                 "RESERVOIR_ROWS", "UPDATE_MIN_ROWS", "UPDATE_BUDGET",
                 "ROLLBACK_BUDGET", "UPDATE_COOLDOWN_WINDOWS",
                 "REGRESSION_RATIO", "REGRESSION_EVAL_WINDOWS",
                 "LEARN_P99_EXCURSION_BOUND", "DECISION_HISTORY",
                 "_ACTION_COUNTERS"):
        assert getattr(pt_learn, name) == getattr(jax_learn, name), name
    assert pt_learn.snapshot_path_for("d", "m", "r1") == \
        jax_learn.snapshot_path_for("d", "m", "r1")
    assert pt_learn.snapshot_path_for("d", "m") == \
        jax_learn.snapshot_path_for("d", "m")


@pytest.mark.parametrize("kw", [dict(quality=False, learn=True),
                                dict(quality=True, learn={"batch_size": 9}),
                                dict(quality=False, learn={"dir": "x"})],
                         ids=["needs_quality", "unknown_key",
                              "dict_needs_quality"])
def test_learn_config_validation_messages(mesh1, kw):
    with pytest.raises(ValueError) as want:
        JaxEngine(mesh=mesh1, start=False, **kw)
    with pytest.raises(ValueError) as got:
        ServingEngine(device="cpu", start=False, **kw)
    assert str(got.value) == str(want.value)


def test_learner_attach_and_update_status(data, mesh1, tmp_path):
    """A monitored mini-batch resident gets a learner whose status has the
    JAX learner's keys and rules; a ``KMeans`` resident (no
    ``partial_fit``) and a ``quantize='pq'`` one get none."""
    jm, pm = _pair(data, mesh1)
    km = kt.KMeans(k=4, seed=0, max_iter=5, device="cpu",
                   verbose=False).fit(data[:2000])
    eng = _engine(pm, tmp_path / "p")
    jeng = _jax_engine(jm, tmp_path / "j", mesh1)
    try:
        eng.add_model("plain", km)
        eng.add_model("pq", _fitted(data, seed=1), quantize="pq")
        st, jst = eng.update_status(), jeng.update_status()
        assert st["plain"] is None and st["pq"] is None
        assert set(st["m"]) == set(jst["m"])
        for key in ("armed", "closed", "updates_applied", "updates_failed",
                    "rollbacks", "update_budget_left",
                    "rollback_budget_left", "reservoir_rows",
                    "pending_eval", "rules", "decisions"):
            assert st["m"][key] == jst["m"][key], key
        assert st["m"]["rules"]["batch_rows"] == 128
        assert st["m"]["rules"]["regression_ratio"] == \
            pt_learn.COMMITTED_LEARN_RULES["regression_ratio"]
        assert st["m"]["snapshot"] == str(tmp_path / "p" / "learn.m.npz")
        assert eng.registry.spec("m")["updatable"] is True
        assert eng.registry.spec("plain")["updatable"] is False
        assert eng.stats()["learn"] == eng.update_status()
        json.dumps(eng.stats())
    finally:
        eng.close()
        jeng.close()
    with ServingEngine(device="cpu", start=False, quality=True) as off:
        off.add_model("m", _fitted(data))
        assert "learn" not in off.stats()
        assert off.update_status() == {"m": None}


def test_update_skipped_on_empty_reservoir(data, mesh1, tmp_path):
    jm, pm = _pair(data, mesh1)
    eng = _engine(pm, tmp_path / "p")
    jeng = _jax_engine(jm, tmp_path / "j", mesh1)
    try:
        got = _learner(eng).update_now(force=True)
        want = _learner(jeng).update_now(force=True)
        assert got["action"] == "update-skipped"
        assert got["reason"] == "reservoir-underfilled"
        for key in ("seq", "model", "action", "reason", "detail"):
            assert got[key] == want[key], key
    finally:
        eng.close()
        jeng.close()


# --------------------------------------------- the update, against JAX


def test_update_matches_the_jax_learner(data, mesh1, tmp_path):
    """The same traffic through both engines: the same reservoir batches,
    and after the update the JAX learner's float64 carry, lifetime counts
    and iteration count (float64 parity class), the same served labels."""
    jm, pm = _pair(data, mesh1)
    eng = _engine(pm, tmp_path / "p")
    jeng = _jax_engine(jm, tmp_path / "j", mesh1)
    try:
        blocks = _blocks(data, dtype=np.float64)
        _feed(eng, blocks)
        _feed(jeng, blocks)
        ln, jln = _learner(eng), _learner(jeng)
        assert ln.status()["reservoir_rows"] == \
            jln.status()["reservoir_rows"] == 512
        got = ln.update_now(force=True)
        want = jln.update_now(force=True)
        assert got["action"] == want["action"] == "update"
        for key in ("n_batches", "rows", "budget_left", "ok"):
            assert got["detail"][key] == want["detail"][key], key
        for a, b in zip(ln.applied_batches[-1], jln.applied_batches[-1]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(pm._centroids_f64, jm._centroids_f64,
                                   **F64)
        np.testing.assert_allclose(pm.centroids, jm.centroids, **F64)
        np.testing.assert_array_equal(pm._seen, jm._seen)
        np.testing.assert_array_equal(pm.cluster_sizes_, jm.cluster_sizes_)
        assert pm.iterations_run == jm.iterations_run
        q = data[4000:4100]
        np.testing.assert_array_equal(eng.call("m", q), jeng.call("m", q))
    finally:
        eng.close()
        jeng.close()


def _script(eng, data, fx, blocks_at):
    """The scripted sequence: update, injected failure, underfilled
    reservoir, update, injected regression.  Returns the decisions."""
    ln = _learner(eng)
    _feed(eng, blocks_at(0))
    ln.update_now(force=True)
    _feed(eng, blocks_at(1))
    with fx.inject_update_failure("m") as rec:
        ln.update_now(force=True)
    assert rec["fired"] == 1
    ln.update_now(force=True)
    _feed(eng, blocks_at(2))
    ln.update_now(force=True)
    with fx.inject_quality_regression("m", ratio=10.0) as rec:
        ln.evaluate_now(force=True)
    assert rec["fired"] == 1
    return [(d["action"], d["reason"]) for d in ln.status()["decisions"]]


def test_decisions_counters_and_report_match_the_jax_learner(
        data, mesh1, tmp_path):
    """The scripted sequence in both packages: the same decisions, the
    same ``serve.learn.*`` counters, the same ``quality_report`` rows, and
    the rollback restores the same state."""
    jm, pm = _pair(data, mesh1)
    eng = _engine(pm, tmp_path / "p")
    jeng = _jax_engine(jm, tmp_path / "j", mesh1)

    def blocks_at(i):
        # Two 128-row blocks: one update's two batches empty the reservoir.
        return _blocks(data, n_blocks=2, start=3000 + 256 * i,
                       dtype=np.float64)

    try:
        got = _script(eng, data, faults, blocks_at)
        want = _script(jeng, data, jax_faults, blocks_at)
        assert got == want
        assert [a for a, _ in got] == [
            "update", "eval-ok", "update-failed", "update-skipped",
            "update", "rollback"]
        for action, name in pt_learn._ACTION_COUNTERS.items():
            assert pt_metrics.REGISTRY.counter(name).value == \
                jax_metrics.REGISTRY.counter(name).value, name
        np.testing.assert_allclose(pm._centroids_f64, jm._centroids_f64,
                                   **F64)
        np.testing.assert_array_equal(pm._seen, jm._seen)
        assert pm.iterations_run == jm.iterations_run
        [rb], [jrb] = _learner(eng).rollbacks, _learner(jeng).rollbacks
        assert isinstance(rb, UpdateRolledBack)
        assert {k: v for k, v in rb.as_dict().items()} == jrb.as_dict()
    finally:
        eng.close()
        jeng.close()
    rep = pt_drift.quality_report([tmp_path / "p" / "quality.m.jsonl"])
    jrep = jax_drift.quality_report([tmp_path / "j" / "quality.m.jsonl"])
    row, jrow = rep["models"]["m"], jrep["models"]["m"]
    for key in ("windows", "rows", "events", "reference", "drifting",
                "updates", "update_failures", "rollbacks"):
        assert row[key] == jrow[key], key
    assert (row["updates"], row["update_failures"], row["rollbacks"]) == \
        (2, 1, 1)
    assert "2upd,1rb" in pt_drift.format_quality_status(rep)


def test_drift_trigger_and_cooldown_match_the_jax_learner(data, mesh1,
                                                          tmp_path):
    """Single-cluster traffic, one 128-row window per call: in both
    packages the monitor drifts and ``_update_due`` opens at the same
    calls, the drift update lands, and after it the cooldown of two
    windows holds the trigger shut for the same calls.  The learners'
    busy locks are held while tracing, so no background update starts."""
    jm, pm = _pair(data, mesh1)
    one = data[np.argsort(pm.predict(data[:3000]))[:1500]]
    cfg = {"cooldown_windows": 2}
    eng = _engine(pm, tmp_path / "p", learn=cfg, quality_window=128)
    jeng = _jax_engine(jm, tmp_path / "j", mesh1, learn=cfg,
                       quality_window=128)

    def trace(engine, lo, hi):
        ln = _learner(engine)
        out = []
        with ln._busy:
            for i in range(lo, hi):
                engine.call("m", one[i * 128:(i + 1) * 128])
                out.append((ln.monitor.windows, ln.monitor.drifting,
                            ln._update_due()))
        return out

    try:
        before = trace(eng, 0, 4)
        assert before == trace(jeng, 0, 4)
        assert [t[1] for t in before] == [False, True, True, True]
        assert before[-1][2] is True
        got = _learner(eng).update_now(force=False, reason="drift")
        want = _learner(jeng).update_now(force=False, reason="drift")
        assert got["action"] == want["action"] == "update"
        assert got["reason"] == "drift"
        for ln in (_learner(eng), _learner(jeng)):
            ln.evaluate_now(force=True)
        after = trace(eng, 4, 8)
        assert after == trace(jeng, 4, 8)
        assert [t[2] for t in after] == [False, True, True, True]
        np.testing.assert_allclose(pm._centroids_f64, jm._centroids_f64,
                                   **F64)
    finally:
        eng.close()
        jeng.close()


def test_drift_fires_the_update_on_its_own(data, tmp_path):
    """The closed loop on the real trigger: single-cluster traffic drifts
    the monitor, the post-dispatch poke starts the background update
    (joined here with a timeout), and the decision says 'drift'."""
    model = _fitted(data)
    eng = _engine(model, tmp_path, quality_window=128)
    try:
        ln = _learner(eng)
        one = data[np.argsort(model.predict(data[:3000]))[:1500]].astype(
            np.float32)
        calls = 0
        while ln._thread is None and calls < 11:
            eng.call("m", one[calls * 128:(calls + 1) * 128])
            calls += 1
        assert ln._thread is not None, "the drift trigger never fired"
        ln._thread.join(timeout=TIMEOUT)
        assert not ln._thread.is_alive()
        st = ln.status()
        assert st["updates_applied"] == 1
        [up] = [d for d in st["decisions"] if d["action"] == "update"]
        assert up["reason"] == "drift"
    finally:
        eng.close()


# ------------------------------------------------ quiesced equivalence


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quiesced_update_equals_offline_replay(data, tmp_path, dtype):
    """A quiesced model equals, bit for bit, the same ``partial_fit``
    batches replayed offline from the pre-update snapshot: table, float64
    carry, lifetime counts, iteration count and served labels."""
    model = _fitted(data, dtype=dtype)
    eng = _engine(model, tmp_path)
    try:
        blocks = _blocks(data, dtype=dtype)
        _feed(eng, blocks)
        ln = _learner(eng)
        assert ln.update_now(force=True)["action"] == "update"
        batches = ln.applied_batches[-1]
        np.testing.assert_array_equal(np.concatenate(batches),
                                      np.concatenate(blocks)[:256])
        off = kt.MiniBatchKMeans.load(ln.snapshot_path, device="cpu")
        for b in batches:
            off.partial_fit(b)
        assert model.centroids.dtype == off.centroids.dtype
        np.testing.assert_array_equal(model.centroids, off.centroids)
        np.testing.assert_array_equal(model._centroids_f64,
                                      off._centroids_f64)
        np.testing.assert_array_equal(model._seen, off._seen)
        assert model.iterations_run == off.iterations_run
        q = data[4000:4100].astype(dtype)
        np.testing.assert_array_equal(eng.call("m", q), off.predict(q))
    finally:
        eng.close()


def test_learn_clone_is_detached(data):
    """``_learn_clone`` copies the training state: ``partial_fit`` on the
    clone leaves the model's table, carry, lifetime counts (the in-place
    ``seen += counts`` hazard) and history untouched; no device table
    cache and no verbosity ride along; an unfitted model refuses."""
    model = _fitted(data)
    model.verbose = True
    model._cents_dev()
    before = {name: np.array(getattr(model, name), copy=True) for name in
              ("centroids", "_centroids_f64", "_seen", "cluster_sizes_")}
    hist = list(model.sse_history)
    clone = model._learn_clone()
    assert clone._cents_cache is None and not clone.verbose
    assert clone.mesh is model.mesh and clone.device == model.device
    clone.partial_fit(data[3000:3128].astype(np.float32))
    for name, value in before.items():
        np.testing.assert_array_equal(getattr(model, name), value)
    assert model.sse_history == hist and model.verbose
    assert not np.array_equal(clone._seen, model._seen)
    with pytest.raises(ValueError, match="fitted"):
        kt.MiniBatchKMeans(k=3, device="cpu")._learn_clone()


# ------------------------------------------------ one read of the table


class RacingModel(kt.MiniBatchKMeans):
    """A model whose ``centroids`` can publish the next table right after
    a reader has read it: ``race`` is called after each read."""

    race = None

    @property
    def centroids(self):
        value = self.__dict__["centroids"]
        race = self.race
        if race is not None:
            race(value)
        return value

    @centroids.setter
    def centroids(self, value):
        self.__dict__["centroids"] = value


def _versions(model, n, seed=0):
    rng = np.random.default_rng(seed)
    base = np.asarray(model._centroids_f64, np.float64)
    return [base + rng.normal(scale=0.1, size=base.shape)
            for _ in range(n)]


def _publish(model, carry, i):
    return publish_tables(model, centroids_f64=carry,
                          seen=np.asarray(model._seen, np.float64),
                          iterations_run=i, sse_history=[])


def test_a_publication_between_reads_never_tears_the_served_table(data):
    """The repair of the served table: a publication lands right after a
    reader's first read of ``centroids`` (the read its cache is keyed
    on).  The table the reader gets is the version of that read, on the
    first dispatch and on every later one; the next reader gets the new
    version.  A reader that reads ``centroids`` twice (once for the key,
    once for the upload) gets the new table under the old key and fails
    here."""
    model = RacingModel(k=4, seed=0, batch_size=256, max_iter=8,
                        device="cpu", verbose=False).fit(
                            data[:3000].astype(np.float32))
    eng = ServingEngine(device="cpu", start=False, quality=False)
    eng.add_model("m", model)
    rm = eng._residents["m"]
    versions = _versions(model, 3)
    try:
        for i, carry in enumerate(versions):
            reads = []

            def race(value, carry=carry, i=i):
                reads.append(value)
                if len(reads) == 1:
                    model.race = None
                    _publish(model, carry, i)
                    model.race = race

            model.race = race
            dev = rm.table_dev()
            model.race = None
            np.testing.assert_array_equal(dev.numpy(), reads[0])
            np.testing.assert_array_equal(
                eng.call("m", data[4000:4200].astype(np.float32)),
                _argmin(data[4000:4200], carry.astype(np.float32)))
            np.testing.assert_array_equal(rm.table_dev().numpy(),
                                          carry.astype(np.float32))
    finally:
        eng.close()


def _argmin(q, table):
    q = np.asarray(q, np.float64)
    t = np.asarray(table, np.float64)
    return np.argmin((q * q).sum(1)[:, None] - 2.0 * q @ t.T
                     + (t * t).sum(1)[None, :], axis=1)


def test_readers_on_every_replica_see_only_published_tables(data):
    """Reader threads hammer the served table of both replicas of a fleet
    (one shared model) while the main thread publishes twelve known
    tables: every table a reader gets is bit-equal to one published
    version, and after the last publication every replica serves it (no
    replica keeps a stale table)."""
    model = _fitted(data)
    k = model.k
    versions = [np.asarray(model._centroids_f64, np.float64)] + \
        _versions(model, 12)
    expected = [v.astype(model.dtype) for v in versions]
    fleet = ServingFleet(2, device="cpu", start=False, quality=False)
    fleet.add_model("m", model)
    fleet.warmup(prewarm=False)
    residents = [rep.engine._residents["m"] for rep in fleet._replicas]
    stop = threading.Event()
    started = threading.Barrier(len(residents) * 2 + 1)
    errors: list = []

    def reader(rm):
        try:
            started.wait(TIMEOUT)
            while not stop.is_set():
                host = rm.table_dev().numpy()[:k]
                if not any(np.array_equal(host, v) for v in expected):
                    errors.append("torn table observed")
                    return
        except Exception as e:  # noqa: BLE001 — no reader may fail
            errors.append(repr(e))

    threads = [threading.Thread(target=reader, args=(rm,))
               for rm in residents for _ in range(2)]
    for t in threads:
        t.start()
    try:
        started.wait(TIMEOUT)
        for i, v in enumerate(versions[1:], start=1):
            _publish(model, v, i)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=TIMEOUT)
        fleet.close()
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    for rm in residents:
        np.testing.assert_array_equal(rm.table_dev().numpy(), expected[-1])


# ------------------------------------------------------ chaos injection


def test_injected_update_failure_never_fails_serving(data, tmp_path):
    """A failed update dies with the clone: the served table is the same
    object, the failure is recorded three ways, requests keep their
    answers."""
    model = _fitted(data)
    eng = _engine(model, tmp_path)
    try:
        ln = _learner(eng)
        _feed(eng, _blocks(data))
        before = model.centroids
        want = model.predict(data[4000:4032].astype(np.float32))
        with faults.inject_update_failure("m") as rec:
            dec = ln.update_now(force=True)
        assert rec["fired"] == 1
        assert dec["action"] == "update-failed"
        assert "SimulatedUpdateFailure" in dec["detail"]["error"]
        assert model.centroids is before
        assert ln.status()["updates_applied"] == 0
        assert ln.status()["updates_failed"] == 1
        np.testing.assert_array_equal(
            eng.call("m", data[4000:4032].astype(np.float32)), want)
        assert pt_metrics.REGISTRY.counter(
            "serve.learn.update_failures").value == 1
    finally:
        eng.close()
    rep = pt_drift.quality_report([tmp_path / "quality.m.jsonl"])
    assert rep["models"]["m"]["update_failures"] == 1
    assert rep["models"]["m"]["updates"] == 0


def test_injected_regression_rolls_back_to_last_good(data, tmp_path):
    """The update moves the table; the injected regression rolls it back
    to the snapshot bit for bit (table, carry, counts, sizes) through the
    same swap; requests answer throughout."""
    model = _fitted(data)
    eng = _engine(model, tmp_path)
    try:
        ln = _learner(eng)
        _feed(eng, _blocks(data))
        pre = {name: np.array(getattr(model, name), copy=True) for name in
               ("centroids", "_centroids_f64", "_seen", "cluster_sizes_")}
        assert ln.update_now(force=True)["action"] == "update"
        assert not np.array_equal(model.centroids, pre["centroids"])
        with faults.inject_quality_regression("m", ratio=10.0) as rec:
            ln.evaluate_now(force=True)
        assert rec["fired"] == 1
        for name, value in pre.items():
            np.testing.assert_array_equal(getattr(model, name), value)
        [rb] = ln.rollbacks
        assert rb.ratio == 10.0 and rb.restored_from == "primary"
        assert [d["action"] for d in ln.status()["decisions"]] == \
            ["update", "rollback"]
        q = data[4000:4032].astype(np.float32)
        np.testing.assert_array_equal(eng.call("m", q), model.predict(q))
    finally:
        eng.close()


def test_rollback_budget_disarms_the_learner(data, tmp_path):
    model = _fitted(data)
    eng = _engine(model, tmp_path, learn={"rollback_budget": 2})
    try:
        ln = _learner(eng)
        for i in range(2):
            _feed(eng, _blocks(data, start=3000 + 512 * i))
            assert ln.update_now(force=True)["action"] == "update"
            with faults.inject_quality_regression("m", ratio=10.0):
                ln.evaluate_now(force=True)
        st = ln.status()
        assert st["armed"] is False and st["rollback_budget_left"] == 0
        assert st["decisions"][-1]["action"] == "disabled"
        assert ln.update_now(force=True) is None
        assert eng.call("m", data[4000:4016].astype(np.float32)).shape \
            == (16,)
    finally:
        eng.close()


def test_update_budget_exhaustion_is_an_explicit_skip(data, tmp_path):
    model = _fitted(data)
    eng = _engine(model, tmp_path, learn={"update_budget": 1})
    try:
        ln = _learner(eng)
        _feed(eng, _blocks(data))
        assert ln.update_now(force=True)["action"] == "update"
        ln._pending = None
        _feed(eng, _blocks(data))
        dec = ln.update_now(force=True)
        assert dec["action"] == "update-skipped"
        assert dec["reason"] == "update-budget-exhausted"
    finally:
        eng.close()


# --------------------------------------------------- remove and close


@pytest.mark.parametrize("how", ["remove", "close"])
def test_remove_and_close_join_an_update_in_flight(data, tmp_path, how):
    """An update running on another thread when the model is removed (or
    the engine closed) is joined or gives up unpublished before the sinks
    close: no crash, the learner closed, every sink line whole."""
    for rep in range(3):
        model = _fitted(data, seed=rep)
        eng = _engine(model, tmp_path / f"r{rep}")
        ln = _learner(eng)
        _feed(eng, _blocks(data))
        t = threading.Thread(
            target=lambda: ln.update_now(force=True, reason=how))
        t.start()
        if how == "remove":
            eng.remove("m")
        eng.close()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive() and ln._closed
        assert ln._thread is None or not ln._thread.is_alive()
        sink = tmp_path / f"r{rep}" / "quality.m.jsonl"
        if sink.exists():
            for line in sink.read_text().splitlines():
                json.loads(line)


# ---------------------------------------------------------------- fleet


def test_fleet_learners_share_the_model_and_serialize(data, tmp_path):
    """Two replicas with ``learn=`` share one model: a replica's update is
    served by both at once, a peer's update while the model's lock is
    held is an explicit skip, and ``update_status`` / the quality report
    aggregate the replicas."""
    model = _fitted(data)
    fdir = tmp_path / "fleet"
    fleet = ServingFleet(2, device="cpu", quality=True, fleet_dir=str(fdir),
                         start=False, learn=LEARN, max_wait_ms=1.0)
    try:
        fleet.add_model("m", model)
        fleet.warmup(prewarm=False)
        for b in _blocks(data, n_blocks=8):
            fleet.call("m", b)
        st = fleet.update_status()
        assert set(st["m"]) == {"r0", "r1"}
        assert all(s["reservoir_rows"] == 512 for s in st["m"].values())
        learners = [rep.engine._residents["m"].learner
                    for rep in fleet._replicas]
        with pt_learn._model_update_lock(model):
            dec = learners[1].update_now(force=True)
        assert dec["action"] == "update-skipped"
        assert dec["reason"] == "peer-updating"
        pre = np.array(model.centroids, copy=True)
        assert learners[0].update_now(force=True)["action"] == "update"
        assert not np.array_equal(model.centroids, pre)
        q = data[4000:4064].astype(np.float32)
        want = model.predict(q)
        for rep in fleet._replicas:
            np.testing.assert_array_equal(rep.engine.call("m", q), want)
        agg = fleet.update_status()["m"]
        assert sum(s["updates_applied"] for s in agg.values()) == 1
    finally:
        fleet.close()
    rep = pt_drift.quality_report(sorted(fdir.glob("quality.m.*.jsonl")))
    assert rep["models"]["m"]["updates"] == 1
    assert sorted(p.name for p in fdir.glob("learn.m.*.npz")) == \
        ["learn.m.r0.npz"]
