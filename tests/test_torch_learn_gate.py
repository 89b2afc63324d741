"""Serve-and-learn's update gate (``serving.learn.UpdateGate``): a
learner's update, or rollback, runs as one exclusive slice between the
dispatches of every engine of the process, so the GIL's hand-offs
between the learner's thread and a dispatch thread never reach a request.

The gate alone (its ordering, re-entry), then the real update path on
the CPU: a dispatch issued while an update runs returns only after the
update's slice has ended, on the learner's engine and on another
engine, and serves the published table."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

torch.set_num_threads(1)

import kmeans_tpu_torch as kt  # noqa: E402
from kmeans_tpu_torch.serving import ServingEngine  # noqa: E402
from kmeans_tpu_torch.serving import learn as pt_learn  # noqa: E402
from kmeans_tpu_torch.utils import faults  # noqa: E402

TIMEOUT = 60.0
HOLD_S = 0.3
# The drift trigger held off (``min_rows``): only the forced update runs.
LEARN = {"batch_rows": 128, "min_rows": 1 << 40, "max_batches": 2,
         "cooldown_windows": 0}


@pytest.fixture(scope="module")
def data():
    X, _ = make_blobs(n_samples=4000, centers=4, n_features=8,
                      random_state=3)
    return X.astype(np.float32)


def _fitted(data):
    return kt.MiniBatchKMeans(k=4, seed=0, batch_size=256, max_iter=8,
                              device="cpu", verbose=False).fit(data[:3000])


def _engine(model, tmp_path, learn=True):
    eng = ServingEngine(device="cpu", quality=True,
                        quality_dir=str(tmp_path), start=False,
                        learn=dict(LEARN) if learn else False)
    eng.add_model("m", model)
    return eng


class _Hold:
    """An update-step hook that holds the update at its first batch for
    ``HOLD_S`` and records when it let go."""

    def __init__(self):
        self.started = threading.Event()
        self.released_at = None

    def __call__(self, model_id, batch_index):
        if batch_index == 0 and not self.started.is_set():
            self.started.set()
            time.sleep(HOLD_S)
            self.released_at = time.perf_counter()

    def __enter__(self):
        with faults._HOOK_LOCK:
            faults._UPDATE_HOOKS.append(self)
        return self

    def __exit__(self, *exc):
        with faults._HOOK_LOCK:
            faults._UPDATE_HOOKS.remove(self)


# ------------------------------------------------------------ the gate


def test_a_slice_waits_for_dispatches_and_holds_new_ones():
    gate = pt_learn.UpdateGate()
    log, lock = [], threading.Lock()
    in_dispatch, let_go = threading.Event(), threading.Event()

    def note(what):
        with lock:
            log.append(what)

    def first():
        with gate.dispatch():
            note("d1 in")
            in_dispatch.set()
            let_go.wait(TIMEOUT)
            note("d1 out")

    def updater():
        with gate.update_slice():
            note("slice in")
            time.sleep(0.1)
            note("slice out")

    def second():
        with gate.dispatch():
            note("d2 in")

    t1 = threading.Thread(target=first)
    t1.start()
    assert in_dispatch.wait(TIMEOUT)
    tu = threading.Thread(target=updater)
    tu.start()
    while not gate._slices_waiting:         # the slice is queued
        time.sleep(0.001)
    t2 = threading.Thread(target=second)
    t2.start()
    time.sleep(0.05)
    assert log == ["d1 in"]                 # both wait behind d1
    let_go.set()
    for t in (t1, tu, t2):
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert log == ["d1 in", "d1 out", "slice in", "slice out", "d2 in"]


def test_a_dispatch_or_a_slice_inside_a_dispatch_passes():
    gate = pt_learn.UpdateGate()
    done = []

    def nested():
        with gate.dispatch():
            with gate.dispatch():
                with gate.update_slice():
                    done.append(True)
        with gate.update_slice():
            done.append(True)

    t = threading.Thread(target=nested)
    t.start()
    t.join(TIMEOUT)
    assert not t.is_alive() and done == [True, True]
    assert gate._dispatching == 0 and not gate._slicing


# ---------------------------------------------------- the update path


@pytest.mark.parametrize("where", ["same_engine", "other_engine"])
def test_a_dispatch_waits_for_the_update_slice(data, tmp_path, where):
    """A request issued while an update runs returns after the update has
    ended, and is served by the published table; without the gate it
    returned during the update."""
    model = _fitted(data)
    eng = _engine(model, tmp_path / "a")
    other = _engine(_fitted(data), tmp_path / "b", learn=False) \
        if where == "other_engine" else eng
    try:
        ln = eng._residents["m"].learner
        for i in range(4):
            eng.call("m", data[3000 + 128 * i: 3128 + 128 * i])
        probe = data[3500:3628]
        dec = [None]

        def update():
            dec[0] = ln.update_now(force=True, reason="gate-test")

        with _Hold() as hold:
            tu = threading.Thread(target=update)
            tu.start()
            assert hold.started.wait(TIMEOUT)
            labels = other.call("m", probe)
            returned = time.perf_counter()
            tu.join(TIMEOUT)
        assert not tu.is_alive()
        assert dec[0]["action"] == "update"
        assert hold.released_at is not None
        assert returned >= hold.released_at
        served = other._residents["m"].model
        np.testing.assert_array_equal(labels, served.predict(probe))
    finally:
        eng.close()
        if other is not eng:
            other.close()
