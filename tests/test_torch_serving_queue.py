"""The port's micro-batching queue (``kmeans_tpu_torch.serving.batching``),
case by case the JAX package's tests/test_serving_queue.py: the injected
clock, flush on timer and on full, per-request order, error isolation,
clean shutdown.  Every case runs with ``start=False`` and the fake clock,
no sleep and no wall-clock deadline, except the one worker-thread case,
which joins its thread with a timeout.  A scripted scenario drives the
port's queue and the JAX package's side by side: the same dispatches, the
same slices, the same counters."""

import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu.serving import batching as jax_batching  # noqa: E402
from kmeans_tpu_torch.serving.batching import (  # noqa: E402
    DEFAULT_BUCKETS, THREAD_NAME, MicroBatchQueue, ServingClosedError,
    bucket_for, check_buckets)
from kmeans_tpu_torch.utils import faults  # noqa: E402


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


class DispatchSpy:
    """Records every dispatched batch; result = rows' first column + a
    per-model offset (so slices are checkable per request and per
    model)."""

    def __init__(self, fail_on=None):
        self.calls = []
        self.fail_on = fail_on or (lambda model_id, op, rows: False)

    def __call__(self, model_id, op, rows):
        self.calls.append((model_id, op, np.array(rows)))
        if self.fail_on(model_id, op, rows):
            raise RuntimeError(f"poisoned batch for {model_id}")
        base = {"a": 0, "b": 1000}.get(model_id, 0)
        return rows[:, 0] + base


def _rows(*vals):
    return np.asarray([[float(v), 0.0] for v in vals], np.float32)


def test_bucket_ladder():
    assert DEFAULT_BUCKETS == jax_batching.DEFAULT_BUCKETS == \
        (8, 64, 512, 4096)
    assert check_buckets((64, 8, 512, 8)) == (8, 64, 512)
    with pytest.raises(ValueError, match="buckets"):
        check_buckets(())
    with pytest.raises(ValueError, match="buckets"):
        check_buckets((0, 8))
    bs = (8, 64, 512, 4096)
    for m in (1, 8, 9, 64, 65, 4096, 4097, 5000, 12_289):
        assert bucket_for(m, bs) == jax_batching.bucket_for(m, bs)
    assert bucket_for(5000, bs) == 8192      # oversize: top multiple


def test_flush_on_timer_injectable_clock():
    clock = FakeClock()
    spy = DispatchSpy()
    q = MicroBatchQueue(spy, buckets=(8,), max_wait_ms=5.0, clock=clock,
                        start=False)
    f1 = q.submit("a", _rows(1, 2))
    clock.advance(0.002)
    f2 = q.submit("a", _rows(3))
    # Not due yet: the OLDEST request has waited < 5 ms.
    assert q.service(now=clock.t) == 0
    assert not f1.done() and q.pending() == 2
    assert q.service(now=clock.advance(0.0031)) == 1
    assert len(spy.calls) == 1
    model_id, op, rows = spy.calls[0]
    assert (model_id, op) == ("a", "predict")
    np.testing.assert_array_equal(rows[:, 0], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(f1.result(0), [1.0, 2.0])
    np.testing.assert_array_equal(f2.result(0), [3.0])
    q.close()


def test_flush_on_full_runs_inline_without_worker():
    spy = DispatchSpy()
    q = MicroBatchQueue(spy, buckets=(4,), max_wait_ms=1e9,
                        clock=FakeClock(), start=False)
    futs = [q.submit("a", _rows(i)) for i in range(4)]
    assert len(spy.calls) == 1
    assert all(f.done() for f in futs)
    assert [f.result(0)[0] for f in futs] == [0.0, 1.0, 2.0, 3.0]
    q.close()


def test_requests_never_mix_models_and_keep_order():
    clock = FakeClock()
    spy = DispatchSpy()
    q = MicroBatchQueue(spy, buckets=(8,), max_wait_ms=1.0, clock=clock,
                        start=False)
    fa1 = q.submit("a", _rows(1))
    fb1 = q.submit("b", _rows(10, 11))
    fa2 = q.submit("a", _rows(2))
    fb2 = q.submit("b", _rows(12))
    q.service(now=clock.advance(0.01))
    assert len(spy.calls) == 2
    by_model = {c[0]: c[2] for c in spy.calls}
    np.testing.assert_array_equal(by_model["a"][:, 0], [1.0, 2.0])
    np.testing.assert_array_equal(by_model["b"][:, 0],
                                  [10.0, 11.0, 12.0])
    assert fa1.result(0)[0] == 1.0 and fa2.result(0)[0] == 2.0
    assert fb1.result(0).tolist() == [1010.0, 1011.0]
    assert fb2.result(0)[0] == 1012.0
    q.close()


def test_oversize_request_rides_alone():
    spy = DispatchSpy()
    q = MicroBatchQueue(spy, buckets=(4,), max_wait_ms=1e9,
                        clock=FakeClock(), start=False)
    small = q.submit("a", _rows(1))
    big = q.submit("a", _rows(*range(10, 16)))   # 6 rows > bucket cap 4
    q.service(now=1.0)
    assert [c[2].shape[0] for c in spy.calls] == [1, 6]
    assert small.result(0)[0] == 1.0
    assert big.result(0).shape == (6,)
    q.close()


def test_submit_time_validation_fails_alone():
    def validate(model_id, op, rows):
        rows = np.asarray(rows, np.float32)
        if not np.all(np.isfinite(rows)):
            raise ValueError("non-finite request")
        return rows

    spy = DispatchSpy()
    q = MicroBatchQueue(spy, buckets=(8,), max_wait_ms=1.0,
                        clock=FakeClock(), start=False,
                        validate=validate)
    good = q.submit("a", _rows(1))
    bad = q.submit("a", np.asarray([[np.nan, 0.0]], np.float32))
    assert bad.done()
    with pytest.raises(ValueError, match="non-finite"):
        bad.result(0)
    q.service(now=1.0)
    np.testing.assert_array_equal(good.result(0), [1.0])
    assert len(spy.calls) == 1 and spy.calls[0][2].shape[0] == 1
    q.close()


def test_dispatch_error_isolation_poisoned_fails_alone():
    spy = DispatchSpy(
        fail_on=lambda m, o, rows: bool(np.any(rows[:, 0] == -1.0)))
    q = MicroBatchQueue(spy, buckets=(8,), max_wait_ms=1.0,
                        clock=FakeClock(), start=False)
    f1 = q.submit("a", _rows(1, 2))
    poisoned = q.submit("a", _rows(-1))
    f2 = q.submit("a", _rows(3))
    q.service(now=1.0)
    np.testing.assert_array_equal(f1.result(0), [1.0, 2.0])
    np.testing.assert_array_equal(f2.result(0), [3.0])
    with pytest.raises(RuntimeError, match="poisoned"):
        poisoned.result(0)
    # 1 failed batch dispatch + 3 isolation re-dispatches.
    assert len(spy.calls) == 4
    assert q.dispatches == 4
    q.close()


def test_transient_fault_costs_one_isolation_round():
    spy = DispatchSpy()
    flaky = faults.fail_first_attempts(spy, 1)
    q = MicroBatchQueue(flaky, buckets=(8,), max_wait_ms=1.0,
                        clock=FakeClock(), start=False)
    futs = [q.submit("a", _rows(i)) for i in range(3)]
    q.service(now=1.0)
    assert [f.result(0)[0] for f in futs] == [0.0, 1.0, 2.0]
    assert len(spy.calls) == 3
    q.close()


def test_worker_thread_timer_flush_and_clean_shutdown():
    """The one case with the worker thread: requests below the full
    threshold flush by timer without a ``service`` call; ``close`` joins
    the thread (bounded here by a join timeout)."""
    spy = DispatchSpy()
    q = MicroBatchQueue(spy, buckets=(64,), max_wait_ms=5.0, start=True)
    worker = q._thread
    assert worker is not None and worker.name == THREAD_NAME
    futs = [q.submit("a", _rows(i)) for i in range(3)]
    got = [f.result(timeout=60.0) for f in futs]
    assert [g[0] for g in got] == [0.0, 1.0, 2.0]
    assert 1 <= len(spy.calls) <= 3
    assert sum(c[2].shape[0] for c in spy.calls) == 3
    closer = threading.Thread(target=q.close)
    closer.start()
    closer.join(timeout=60.0)
    worker.join(timeout=60.0)
    assert not closer.is_alive() and not worker.is_alive()
    q.close()                                # idempotent
    assert THREAD_NAME not in {t.name for t in threading.enumerate()}


def test_close_drains_pending_and_rejects_new():
    spy = DispatchSpy()
    q = MicroBatchQueue(spy, buckets=(64,), max_wait_ms=1e9,
                        clock=FakeClock(), start=False)
    f1 = q.submit("a", _rows(7))
    q.close()
    np.testing.assert_array_equal(f1.result(0), [7.0])
    late = q.submit("a", _rows(8))
    assert isinstance(late.exception(0), ServingClosedError)
    assert q.pending() == 0


def test_future_timeout_and_exception_accessor():
    q = MicroBatchQueue(DispatchSpy(), buckets=(8,), max_wait_ms=1e9,
                        clock=FakeClock(), start=False)
    f = q.submit("a", _rows(1))
    with pytest.raises(TimeoutError):
        f.result(timeout=0)
    with pytest.raises(TimeoutError):
        f.exception(timeout=0)
    q.close()
    assert f.exception(0) is None
    np.testing.assert_array_equal(f.result(0), [1.0])


def test_knob_validation():
    with pytest.raises(ValueError, match="max_wait_ms"):
        MicroBatchQueue(DispatchSpy(), max_wait_ms=-1.0, start=False)
    with pytest.raises(ValueError) as got:
        MicroBatchQueue(DispatchSpy(), max_wait_ms=-1.0, start=False)
    with pytest.raises(ValueError) as want:
        jax_batching.MicroBatchQueue(DispatchSpy(), max_wait_ms=-1.0,
                                     start=False)
    assert str(got.value) == str(want.value)


def test_concurrent_submitters_all_resolve():
    """Four threads submit without a worker (flush on full runs in the
    submitting thread); one ``service`` drains the rest: every future
    resolves with its own slice, nothing is lost."""
    spy = DispatchSpy()
    q = MicroBatchQueue(spy, buckets=(8, 64), max_wait_ms=1.0,
                        clock=FakeClock(), start=False)
    futs = {}
    errs = []

    def client(tid):
        try:
            futs[tid] = [(v, q.submit("a", _rows(v)))
                         for v in range(tid * 100, tid * 100 + 20)]
        except Exception as e:           # noqa: BLE001 — surfaced below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads) and not errs
    q.service(now=1.0)
    q.close()
    for pairs in futs.values():
        assert all(v == f.result(0)[0] for v, f in pairs)
    assert q.requests == 80 and q.rows == 80
    assert sum(c[2].shape[0] for c in spy.calls) == 80


def _scenario(queue_cls, error_cls):
    """One scripted run: timers, full flushes, two models, a poisoned
    request and a late submit; returns what an observer can see."""
    clock = FakeClock()
    spy = DispatchSpy(
        fail_on=lambda m, o, rows: bool(np.any(rows[:, 0] == -1.0)))
    q = queue_cls(spy, buckets=(4, 8), max_wait_ms=2.0, clock=clock,
                  start=False)
    futs = [q.submit("a", _rows(1, 2)), q.submit("b", _rows(5))]
    clock.advance(0.001)
    futs += [q.submit("a", _rows(-1)), q.submit("a", _rows(3, 4, 6, 7))]
    futs.append(q.submit("b", _rows(*range(20, 29))))
    served = [q.service(now=clock.t), q.service(now=clock.advance(0.0015))]
    futs.append(q.submit("a", _rows(9)))
    q.close()
    late = q.submit("a", _rows(10))
    out = []
    for f in futs:
        err = f.exception(0)
        out.append(type(err).__name__ if err is not None
                   else f.result(0).tolist())
    return {"served": served,
            "calls": [(m, o, r.tolist()) for m, o, r in spy.calls],
            "results": out, "stats": q.stats(),
            "late": isinstance(late.exception(0), error_cls)}


def test_scripted_scenario_matches_the_jax_queue():
    port = _scenario(MicroBatchQueue, ServingClosedError)
    ref = _scenario(jax_batching.MicroBatchQueue,
                    jax_batching.ServingClosedError)
    assert port == ref
    assert port["late"] and "RuntimeError" in port["results"]
