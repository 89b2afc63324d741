"""The port's out-of-core input (``kmeans_tpu_torch.data.io``) against the
JAX package's ``data.io``: datasets from ``.npy`` and raw files equal the
in-memory ones, block streams are the same blocks, retries are counted and
leave the results bit-identical, the non-finite policy names or drops a
block, and ``ingest='slab'`` places the bytes of ``'mono'``.  A mesh's
per-rank reads are in ``test_torch_stream_mesh.py`` and
``test_torch_large_k_mesh.py``."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu.data import io as jio  # noqa: E402
from kmeans_tpu_torch import KMeans  # noqa: E402
from kmeans_tpu_torch.data import io as pio  # noqa: E402
from kmeans_tpu_torch.utils import faults  # noqa: E402

RTOL = 1e-12


@pytest.fixture()
def npy_file(tmp_path):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(1003, 7)).astype(np.float32)
    path = tmp_path / "points.npy"
    np.save(path, X)
    return path, X


def _blocks_of(X, size, weights=None):
    def make_blocks():
        for i in range(0, len(X), size):
            yield X[i: i + size] if weights is None else \
                (X[i: i + size], weights[i: i + size])
    return make_blocks


def test_from_npy_matches_in_memory(npy_file):
    path, X = npy_file
    kw = dict(k=5, seed=42, compute_sse=True, verbose=False,
              dtype=np.float64, distance_mode="matmul")
    ds = pio.from_npy(path, device="cpu", dtype=np.float64)
    assert ds.host is not None and ds.io_stats.retries_used == 0
    km_file = KMeans(device="cpu", **kw)
    assert (km_file.io_retries_used_, km_file.blocks_skipped_) == (0, 0)
    km_file.fit(ds)
    assert km_file.io_retries_used_ == 0
    km_mem = KMeans(device="cpu", **kw).fit(X)
    np.testing.assert_array_equal(km_file.centroids, km_mem.centroids)
    assert km_file.sse_history == km_mem.sse_history
    jm = kmeans_tpu.KMeans(**kw).fit(X.astype(np.float64))
    assert km_file.iterations_run == jm.iterations_run
    np.testing.assert_allclose(km_file.centroids, jm.centroids, rtol=RTOL)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_from_npy_rows_and_weights(npy_file, prefetch):
    path, X = npy_file
    sw = np.linspace(0.1, 2.0, 1003)
    ds = pio.from_npy(path, device="cpu", sample_weight=sw,
                      prefetch=prefetch)
    np.testing.assert_array_equal(ds.points.numpy(), X)
    np.testing.assert_allclose(ds.weights.numpy(), sw.astype(np.float32),
                               rtol=0)
    np.testing.assert_array_equal(ds.take(np.array([0, 500, 1002])),
                                  X[[0, 500, 1002]])


def test_from_npy_rejects_bad_shapes(tmp_path):
    path = tmp_path / "bad.npy"
    np.save(path, np.zeros((4, 3, 2)))
    for load in (jio.from_npy, pio.from_npy):
        with pytest.raises(ValueError, match="2-D"):
            load(path, None)
    ok = tmp_path / "ok.npy"
    np.save(ok, np.zeros((10, 2)))
    with pytest.raises(ValueError, match="sample_weight"):
        pio.from_npy(ok, device="cpu", sample_weight=np.ones(7))


def test_from_npy_runs_on_the_card_unless_asked(npy_file, monkeypatch):
    """``device=None`` is the card, as at every entry point: without one
    it raises instead of falling back to the CPU."""
    path, _ = npy_file
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pio.from_npy(path)


def test_from_raw_matches_npy(tmp_path):
    rng = np.random.default_rng(12)
    X = rng.normal(size=(257, 4)).astype(np.float64)
    raw = tmp_path / "points.bin"
    X.tofile(raw)
    ds = pio.from_raw(raw, (257, 4), device="cpu", file_dtype=np.float64,
                      dtype=np.float32)
    np.testing.assert_array_equal(ds.points.numpy(), X.astype(np.float32))
    jds = jio.from_raw(raw, (257, 4), None, file_dtype=np.float64,
                       dtype=np.float32)
    np.testing.assert_array_equal(ds.points.numpy(),
                                  np.asarray(jds.points)[:257])
    header = tmp_path / "header.bin"
    with open(header, "wb") as f:
        f.write(b"\0" * 16)
        f.write(X.tobytes())
    ds = pio.from_raw(header, (257, 4), device="cpu", offset=16,
                      file_dtype=np.float64, dtype=np.float64)
    np.testing.assert_array_equal(ds.points.numpy(), X)
    km = KMeans(k=4, seed=0, verbose=False, device="cpu",
                dtype=np.float64).fit(ds)
    assert km.centroids.shape == (4, 4)
    assert np.all(np.isfinite(km.centroids))


def test_budget_elems_requests_em_sized_chunks():
    """The loaders' ``budget_elems`` is the JAX package's rule: an explicit
    budget replaces 2^25 and leaves the one-chunk shortcut."""
    from kmeans_tpu.parallel.sharding import choose_chunk_size as jchoose
    from kmeans_tpu_torch.parallel.sharding import (EM_CHUNK_BUDGET,
                                                    choose_chunk_size)
    for n, k, d in ((40_000, 256, 4), (1003, 5, 7), (1 << 22, 1024, 128),
                    (100, 3, 2)):
        for budget in (None, EM_CHUNK_BUDGET, 1 << 20):
            assert choose_chunk_size(n, k, d, budget_elems=budget) == \
                jchoose(n, k, d, budget_elems=budget), (n, k, budget)
    assert choose_chunk_size(40_000, 256, 4, EM_CHUNK_BUDGET) < \
        choose_chunk_size(40_000, 256, 4)


def test_iter_npy_blocks_matches_jax(tmp_path, npy_file):
    path, X = npy_file
    for rows in (100, 1003, 5000):
        got = list(pio.iter_npy_blocks(path, rows)())
        want = list(jio.iter_npy_blocks(path, rows)())
        assert len(got) == len(want) == -(-1003 // rows)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    got = next(iter(pio.iter_npy_blocks(path, 100, dtype=np.float64)()))
    assert got.dtype == np.float64
    with pytest.raises(ValueError, match="block_rows"):
        pio.iter_npy_blocks(path, 0)
    bad = tmp_path / "bad.npy"
    np.save(bad, np.zeros((3, 2, 2)))
    with pytest.raises(ValueError, match="2-D"):
        list(pio.iter_npy_blocks(bad, 2)())


def test_io_knobs_and_policy_messages():
    for args in ((-1, 0.0), (1.5, 0.0), (0, -1.0)):
        with pytest.raises(ValueError) as want:
            jio.check_io_knobs(*args)
        with pytest.raises(ValueError) as got:
            pio.check_io_knobs(*args)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="on_nonfinite"):
        pio.resilient_blocks(lambda: iter([]), on_nonfinite="drop")
    with pytest.raises(ValueError) as want:
        jio.resilient_blocks(lambda: iter([]), on_nonfinite="drop")
    with pytest.raises(ValueError) as got:
        pio.resilient_blocks(lambda: iter([]), on_nonfinite="drop")
    assert str(got.value) == str(want.value)


def test_retry_call_counts_and_gives_up():
    stats = pio.IOStats()
    fn = faults.fail_first_attempts(lambda: 7, 2)
    assert pio.retry_call(fn, retries=2, backoff=0.0, stats=stats) == 7
    assert stats.retries_used == 2
    fn = faults.fail_first_attempts(lambda: 7, 3)
    with pytest.raises(faults.TransientIOError):
        pio.retry_call(fn, retries=2, backoff=0.0, stats=stats)
    assert stats.retries_used == 4
    calls = []

    def not_io():
        calls.append(1)
        raise KeyError("not transient")

    with pytest.raises(KeyError):
        pio.retry_call(not_io, retries=5, backoff=0.0)
    assert len(calls) == 1


@pytest.mark.parametrize("fail_block", [0, 2])
def test_resilient_blocks_retry_is_bit_identical(fail_block):
    X = np.random.default_rng(3).normal(size=(500, 3))
    stats = pio.IOStats()
    flaky = faults.flaky_blocks(_blocks_of(X, 100), fail_block=fail_block,
                                fail_times=2)
    got = list(pio.resilient_blocks(flaky, io_retries=2, io_backoff=0.0,
                                    stats=stats)())
    assert stats.retries_used == 2
    np.testing.assert_array_equal(np.concatenate(got), X)
    flaky = faults.flaky_blocks(_blocks_of(X, 100), fail_block=fail_block,
                                fail_times=3)
    with pytest.raises(faults.TransientIOError):
        list(pio.resilient_blocks(flaky, io_retries=2, io_backoff=0.0)())


def test_fit_stream_io_retries_bit_identical_to_jax():
    X = np.random.default_rng(4).normal(size=(900, 3))
    init = X[:4].copy()
    kw = dict(k=4, init=init, max_iter=5, tolerance=1e-12, verbose=False,
              dtype=np.float64, distance_mode="matmul", compute_sse=True)
    clean = KMeans(device="cpu", **kw).fit_stream(_blocks_of(X, 200))
    for prefetch in (0, 2):
        flaky = faults.flaky_blocks(_blocks_of(X, 200), fail_block=3,
                                    fail_times=1)
        km = KMeans(device="cpu", **kw).fit_stream(
            flaky, io_retries=2, io_backoff=0.0, prefetch=prefetch)
        assert km.io_retries_used_ == 1 and km.blocks_skipped_ == 0
        np.testing.assert_array_equal(km.centroids, clean.centroids)
        assert km.sse_history == clean.sse_history
    flaky = faults.flaky_blocks(_blocks_of(X, 200), fail_block=3,
                                fail_times=1)
    jm = kmeans_tpu.KMeans(**kw)
    jm.fit_stream(flaky, io_retries=2, io_backoff=0.0)
    assert jm.io_retries_used_ == 1
    np.testing.assert_allclose(clean.centroids, jm.centroids, rtol=RTOL)


def test_on_nonfinite_error_names_block_and_skip_counts():
    X = np.random.default_rng(5).normal(size=(1000, 3))
    init = X[:3].copy()
    kw = dict(k=3, init=init, max_iter=4, verbose=False, dtype=np.float64,
              distance_mode="matmul", empty_cluster="keep")
    poisoned = faults.poison_blocks(_blocks_of(X, 250), block=2)
    with pytest.raises(ValueError, match="non-finite values in streamed "
                                         "block 2"):
        KMeans(device="cpu", **kw).fit_stream(poisoned)
    km = KMeans(device="cpu", **kw).fit_stream(poisoned,
                                               on_nonfinite="skip")
    assert km.blocks_skipped_ == 1
    clean = KMeans(device="cpu", **kw).fit_stream(
        _blocks_of(np.concatenate([X[:500], X[750:]]), 250))
    np.testing.assert_array_equal(km.centroids, clean.centroids)
    jm = kmeans_tpu.KMeans(**kw)
    jm.fit_stream(poisoned, on_nonfinite="skip")
    assert jm.blocks_skipped_ == 1
    np.testing.assert_allclose(km.centroids, jm.centroids, rtol=RTOL)
    w = np.ones(1000)
    w[600] = np.inf
    with pytest.raises(ValueError, match="streamed block 2"):
        list(pio.resilient_blocks(_blocks_of(X, 250, w))())


def test_ingest_slab_raises_naming_a10(npy_file):
    """The name is kept for the test's ID: ``ingest='slab'`` (ROADMAP A.10,
    ported) now loads the bytes of ``'mono'``, from ``.npy`` and raw
    files, with and without weights.  Without a mesh there is one copy, as
    in the JAX package; the slab path itself is held in
    ``test_torch_ingest.py`` and ``test_torch_large_k_mesh.py``."""
    path, X = npy_file
    sw = np.linspace(0.1, 2.0, 1003)
    for kw in (dict(), dict(sample_weight=sw)):
        mono = pio.from_npy(path, device="cpu", ingest="mono", **kw)
        assert mono.points.numpy().tobytes() == X.tobytes()
        for load in (lambda: pio.from_npy(path, device="cpu", ingest="slab",
                                          **kw),
                     lambda: pio.from_raw(path, (1003, 7), device="cpu",
                                          offset=128, ingest="slab", **kw)):
            ds = load()
            assert ds.points.numpy().tobytes() == \
                mono.points.numpy().tobytes()
            assert ds.weights.numpy().tobytes() == \
                mono.weights.numpy().tobytes()
    with pytest.raises(ValueError, match="ingest"):
        pio.from_npy(path, device="cpu", ingest="fast")
    for ingest in ("auto", "mono"):
        assert pio.from_npy(path, device="cpu", ingest=ingest).n == 1003
