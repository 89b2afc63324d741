"""The port's streaming pipeline (``kmeans_tpu_torch.data.prefetch`` and the
``prefetch`` knob of every stream): prefetch moves where the per-block work
happens, a bounded background producer, and never what is computed (the
``prefetch=0`` and ``prefetch=2`` results are bit-identical), raises reader
errors at the consumer, and leaves no thread behind.  Mirrors the JAX
package's ``tests/test_prefetch.py``; the streamed fits are also held to the
JAX package's in float64 'matmul'.  On the CPU the block stager is
``torch.from_numpy``; its CUDA ring is exercised by ``chip_smoke.py``."""

import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu_torch import GaussianMixture, KMeans  # noqa: E402
from kmeans_tpu_torch.data.prefetch import (THREAD_NAME,  # noqa: E402
                                            check_prefetch, prefetch_iter)

RTOL = 1e-12


@pytest.fixture()
def data():
    rng = np.random.default_rng(11)
    centers = rng.uniform(-10, 10, size=(5, 8))
    return (centers[rng.integers(0, 5, 6000)]
            + rng.standard_normal((6000, 8))).astype(np.float32)


def _blocks_of(X, size, weights=None):
    def make_blocks():
        for i in range(0, len(X), size):
            if weights is None:
                yield X[i: i + size]
            else:
                yield X[i: i + size], weights[i: i + size]
    return make_blocks


def _no_leaked_threads(baseline=0):
    """Every producer thread is named; poll briefly for its teardown."""
    for _ in range(50):
        alive = [t for t in threading.enumerate()
                 if t.name.startswith(THREAD_NAME)]
        if len(alive) <= baseline:
            return True
        time.sleep(0.02)
    return False


# ------------------------------------------------------------ primitive


def test_prefetch_iter_order_and_stage():
    for prefetch in (0, 1, 2, 5):
        got = list(prefetch_iter(iter(range(20)), prefetch,
                                 stage=lambda x: x * x))
        assert got == [i * i for i in range(20)]
    assert list(prefetch_iter(iter([]), 2)) == []
    assert _no_leaked_threads()


def test_prefetch_validation():
    from kmeans_tpu.data.prefetch import check_prefetch as jax_check
    for bad in (-1, 1.5):
        with pytest.raises(ValueError) as want:
            jax_check(bad)
        with pytest.raises(ValueError) as got:
            check_prefetch(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="prefetch"):
        list(prefetch_iter([1], -2))


def test_prefetch_iter_source_error_propagates_in_order():
    def source():
        yield 1
        yield 2
        raise RuntimeError("disk died")

    it = prefetch_iter(source(), 2)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(RuntimeError, match="disk died"):
        next(it)
    assert _no_leaked_threads()


def test_prefetch_iter_stage_error_propagates():
    def stage(x):
        if x == 3:
            raise ValueError("bad block")
        return x

    got = []
    with pytest.raises(ValueError, match="bad block"):
        for v in prefetch_iter(iter(range(10)), 2, stage):
            got.append(v)
    assert got == [0, 1, 2]
    assert _no_leaked_threads()


def test_prefetch_iter_early_close_joins_thread():
    it = prefetch_iter(iter(range(1000)), 3)
    assert next(it) == 0
    it.close()
    assert _no_leaked_threads()
    it.close()                       # idempotent, and stays exhausted
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_iter_blocked_producer_unblocks_on_close():
    """A producer stuck on a full queue still joins promptly on close."""
    it = prefetch_iter(iter(range(10_000)), 1)
    next(it)
    time.sleep(0.1)
    it.close()
    assert _no_leaked_threads()


def test_prefetch_iter_runs_stage_in_background_thread():
    seen = []

    def stage(x):
        seen.append(threading.current_thread().name)
        return x

    list(prefetch_iter(iter(range(3)), 2, stage))
    assert all(n == THREAD_NAME for n in seen)
    list(prefetch_iter(iter(range(3)), 0, stage))
    assert seen[-1] == threading.main_thread().name


# ----------------------------------------------- streamed-fit parity


def _fit_pair(data, **kw):
    base = dict(k=5, seed=0, compute_sse=True, verbose=False,
                chunk_size=128, dtype=np.float64, distance_mode="matmul")
    base.update(kw)
    rng = np.random.RandomState(0)
    base.setdefault("init", data[rng.choice(len(data), base["k"],
                                            replace=False)].copy())
    fits = []
    for prefetch in (0, 2):
        km = KMeans(device="cpu", **base)
        km.fit_stream(_blocks_of(data, 1000), prefetch=prefetch)
        fits.append(km)
    jm = kmeans_tpu.KMeans(**base)
    jm.fit_stream(_blocks_of(data, 1000))
    return fits[0], fits[1], jm


def _held_to_jax(km, jm):
    assert km.iterations_run == jm.iterations_run
    np.testing.assert_allclose(km.centroids, jm.centroids, rtol=RTOL,
                               atol=1e-10)
    np.testing.assert_allclose(km.sse_history, jm.sse_history, rtol=RTOL)


def test_kmeans_stream_prefetch_trajectory_bit_identical(data):
    km0, km2, jm = _fit_pair(data, empty_cluster="keep")
    assert km0.iterations_run == km2.iterations_run
    np.testing.assert_array_equal(km0.centroids, km2.centroids)
    assert km0.sse_history == km2.sse_history
    np.testing.assert_array_equal(km0.cluster_sizes_, km2.cluster_sizes_)
    _held_to_jax(km2, jm)
    assert _no_leaked_threads()


def test_kmeans_stream_prefetch_identical_under_resample(data):
    """The 'resample' reservoir takes the blocks on the consumer's side, in
    block order: prefetch does not move its draws, which are the JAX
    package's."""
    km0, km2, jm = _fit_pair(data[:40], k=8, empty_cluster="resample",
                             max_iter=12)
    assert km0.iterations_run == km2.iterations_run
    np.testing.assert_array_equal(km0.centroids, km2.centroids)
    _held_to_jax(km2, jm)


def test_kmeans_stream_prefetch_identical_weighted_multi_restart(data):
    w = np.random.RandomState(3).uniform(0.1, 2.0, len(data))
    kw = dict(k=4, n_init=3, seed=7, init="forgy", compute_sse=True,
              empty_cluster="keep", verbose=False, chunk_size=128,
              dtype=np.float64, distance_mode="matmul")
    fits = []
    for prefetch in (0, 2):
        km = KMeans(device="cpu", **kw)
        km.fit_stream(_blocks_of(data, 900, w), prefetch=prefetch)
        fits.append(km)
    assert fits[0].best_restart_ == fits[1].best_restart_
    np.testing.assert_array_equal(fits[0].centroids, fits[1].centroids)
    np.testing.assert_array_equal(fits[0].restart_inertias_,
                                  fits[1].restart_inertias_)
    jm = kmeans_tpu.KMeans(**kw)
    jm.fit_stream(_blocks_of(data, 900, w))
    assert fits[1].best_restart_ == jm.best_restart_
    np.testing.assert_allclose(fits[1].restart_inertias_,
                               jm.restart_inertias_, rtol=RTOL)
    _held_to_jax(fits[1], jm)


def _gmm_pair(data, **kw):
    base = dict(n_components=3, init_params="random", seed=0,
                chunk_size=128, dtype=np.float64)
    base.update(kw)
    fits = [GaussianMixture(device="cpu", **base).fit_stream(
        _blocks_of(data, 1000), prefetch=p) for p in (0, 2)]
    jg = kmeans_tpu.GaussianMixture(**base).fit_stream(
        _blocks_of(data, 1000))
    return fits[0], fits[1], jg


def _same_mixture(g0, g2):
    assert g0.n_iter_ == g2.n_iter_
    np.testing.assert_array_equal(g0.means_, g2.means_)
    np.testing.assert_array_equal(g0.weights_, g2.weights_)
    np.testing.assert_array_equal(g0.covariances_, g2.covariances_)
    assert g0.lower_bound_ == g2.lower_bound_


def test_gmm_stream_prefetch_trajectory_bit_identical(data):
    g0, g2, jg = _gmm_pair(data, max_iter=6)
    _same_mixture(g0, g2)
    assert g2.n_iter_ == jg.n_iter_
    np.testing.assert_allclose(g2.lower_bound_, jg.lower_bound_, rtol=RTOL)
    np.testing.assert_allclose(g2.means_, jg.means_, rtol=RTOL)
    assert _no_leaked_threads()


def test_gmm_tied_stream_prefetch_identical(data):
    """'tied' adds the prefetched total-scatter pass."""
    g0, g2, jg = _gmm_pair(data, covariance_type="tied", max_iter=4)
    _same_mixture(g0, g2)
    np.testing.assert_allclose(g2.covariances_, jg.covariances_,
                               rtol=RTOL, atol=1e-12)


# ------------------------------------------- inference-stream parity


def test_inference_streams_prefetch_identical(data):
    km = KMeans(k=5, seed=0, verbose=False, chunk_size=128,
                device="cpu").fit(data)
    mk = _blocks_of(data, 700)
    l0 = np.concatenate(list(km.predict_stream(mk, prefetch=0)))
    l2 = np.concatenate(list(km.predict_stream(mk, prefetch=2)))
    np.testing.assert_array_equal(l0, l2)
    np.testing.assert_array_equal(l2, km.predict(data))
    assert km.score_stream(mk, prefetch=0) == km.score_stream(mk,
                                                              prefetch=2)
    t0 = np.concatenate(list(km.transform_stream(mk, prefetch=0)))
    t2 = np.concatenate(list(km.transform_stream(mk, prefetch=2)))
    np.testing.assert_array_equal(t0, t2)
    gm = GaussianMixture(n_components=3, seed=0, chunk_size=128,
                         device="cpu").fit(data)
    p0 = np.concatenate(list(gm.predict_stream(mk, prefetch=0)))
    p2 = np.concatenate(list(gm.predict_stream(mk, prefetch=2)))
    np.testing.assert_array_equal(p0, p2)
    s0 = np.concatenate(list(gm.score_samples_stream(mk, prefetch=0)))
    s2 = np.concatenate(list(gm.score_samples_stream(mk, prefetch=2)))
    np.testing.assert_array_equal(s0, s2)
    assert _no_leaked_threads()


# --------------------------------------- failure and shut-down


def test_stream_reader_exception_mid_epoch_propagates_no_threads(data):
    def bad_blocks():
        yield data[:1000]
        yield data[1000:2000]
        raise OSError("stream source failed")

    km = KMeans(k=5, seed=0, init=data[:5].copy(), verbose=False,
                chunk_size=128, device="cpu")
    with pytest.raises(OSError, match="stream source failed"):
        km.fit_stream(lambda: bad_blocks(), prefetch=2)
    assert _no_leaked_threads()
    gm = GaussianMixture(n_components=3, init_params="random", seed=0,
                         chunk_size=128, device="cpu")
    with pytest.raises(OSError, match="stream source failed"):
        gm.fit_stream(lambda: bad_blocks(), prefetch=2)
    assert _no_leaked_threads()


def test_stream_shape_error_still_points_at_block(data):
    def mixed():
        yield data[:1000]
        yield np.zeros((10, 3), np.float32)        # wrong width

    km = KMeans(k=5, seed=0, init=data[:5].copy(), verbose=False,
                chunk_size=128, device="cpu")
    with pytest.raises(ValueError, match="block shape"):
        km.fit_stream(lambda: mixed(), prefetch=2)
    assert _no_leaked_threads()


def test_abandoned_predict_stream_generator_joins_thread(data):
    km = KMeans(k=5, seed=0, verbose=False, chunk_size=128,
                device="cpu").fit(data)
    gen = km.predict_stream(_blocks_of(data, 500), prefetch=2)
    next(gen)
    gen.close()
    assert _no_leaked_threads()
    gen = km.transform_stream(_blocks_of(data, 500), prefetch=2)
    next(gen)
    del gen                                        # the collection path
    assert _no_leaked_threads()


def test_fit_stream_d_peek_closes_prefetching_source(tmp_path, data):
    """The ``d`` peek takes one item and abandons the iterator: a
    prefetching source's thread is reaped at once."""
    from kmeans_tpu_torch.data.io import iter_npy_blocks
    path = tmp_path / "pts.npy"
    np.save(path, data)
    km = KMeans(k=5, seed=0, init=data[:5].copy(), max_iter=2,
                empty_cluster="keep", verbose=False, chunk_size=128,
                device="cpu")
    km.fit_stream(iter_npy_blocks(path, 1000, prefetch=2))
    assert _no_leaked_threads()
    gm = GaussianMixture(n_components=3, init_params="random", max_iter=2,
                         seed=0, chunk_size=128, device="cpu")
    gm.fit_stream(iter_npy_blocks(path, 1000, prefetch=2))
    assert _no_leaked_threads()


def test_nested_prefetch_early_close_reaps_inner_thread(tmp_path, data):
    from kmeans_tpu_torch.data.io import iter_npy_blocks
    path = tmp_path / "pts.npy"
    np.save(path, data)
    km = KMeans(k=5, seed=0, verbose=False, chunk_size=128,
                device="cpu").fit(data)
    for prefetch in (2, 0):
        gen = km.predict_stream(iter_npy_blocks(path, 500, prefetch=2),
                                prefetch=prefetch)
        next(gen)
        gen.close()
        assert _no_leaked_threads()


def test_iter_npy_blocks_prefetch_knob(tmp_path, data):
    from kmeans_tpu.data.io import iter_npy_blocks as jax_blocks
    from kmeans_tpu_torch.data.io import iter_npy_blocks
    path = tmp_path / "pts.npy"
    np.save(path, data)
    want = [np.array(b) for b in jax_blocks(path, 1700)()]
    sync = [b.copy() for b in iter_npy_blocks(path, 1700)()]
    pre = [b.copy() for b in iter_npy_blocks(path, 1700, prefetch=2)()]
    assert len(sync) == len(pre) == len(want) == 4
    for a, b, c in zip(sync, pre, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert _no_leaked_threads()
    with pytest.raises(ValueError, match="prefetch"):
        iter_npy_blocks(path, 1700, prefetch=-1)


def test_from_npy_readahead_matches_sync(tmp_path, data):
    """Read-ahead moves the reads to a thread and never past its end; the
    rows are the same (a mesh's per-rank reads: test_torch_stream_mesh)."""
    from kmeans_tpu_torch.data.io import _ReadaheadReader, from_npy
    path = tmp_path / "pts.npy"
    np.save(path, data.astype(np.float64))
    for prefetch in (0, 2):
        ds = from_npy(path, device="cpu", dtype=np.float64,
                      prefetch=prefetch)
        np.testing.assert_array_equal(ds.points.numpy(),
                                      data.astype(np.float64))
        np.testing.assert_array_equal(ds.weights.numpy(), 1.0)
    reads = []

    def read_rows(lo, hi):
        reads.append((lo, hi))
        return data[lo:hi]

    reader = _ReadaheadReader(read_rows, 4000, depth=2)
    got = [reader(lo, min(lo + 700, 4000)) for lo in range(0, 4000, 700)]
    got.append(reader(0, 10))                       # out of order: a miss
    reader.close()
    np.testing.assert_array_equal(np.concatenate(got[:-1]), data[:4000])
    np.testing.assert_array_equal(got[-1], data[:10])
    assert max(hi for _, hi in reads) <= 4000


def test_consumer_abandons_mid_retry_no_leaked_threads(data):
    """The consumer closes the iterator while the producer sleeps in a
    retry backoff: the close aborts the sleep and joins at once."""
    from kmeans_tpu_torch.data.io import resilient_blocks
    from kmeans_tpu_torch.utils import faults
    flaky = faults.flaky_blocks(_blocks_of(data, 1500), fail_block=1,
                                fail_times=10 ** 6)
    source = resilient_blocks(flaky, io_retries=5, io_backoff=60.0)
    it = prefetch_iter(source(), prefetch=2)
    np.testing.assert_array_equal(next(it), data[:1500])
    for _ in range(100):
        if flaky.state["failures"]:
            break
        time.sleep(0.02)
    assert flaky.state["failures"] >= 1
    t0 = time.perf_counter()
    it.close()
    elapsed = time.perf_counter() - t0
    assert elapsed < 10.0, f"close() waited out the backoff ({elapsed:.1f}s)"
    assert _no_leaked_threads()
