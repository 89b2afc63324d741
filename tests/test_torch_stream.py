"""Streamed K-Means of the port (``KMeans.fit_stream``, the streamed inits,
``predict_stream``, ``score_stream``, ``transform_stream``,
``SphericalKMeans``' streams) held against the JAX package's, mirroring its
``tests/test_stream.py``.

The parity class is float64 ``distance_mode='matmul'``: equal iterations,
centroids and ``sse_history`` to ``rtol=1e-12``.  The reservoir draws
(streamed Forgy and 'random', the callable init's sample, the 'resample'
refill) use NumPy generators seeded as in the JAX package, so they give its
rows exactly.  The streamed k-means|| draws from a ``torch.Generator``, so
it is held by quality (the in-memory k-means|| class of
``test_torch_kmeans_parallel.py``) and its deterministic parts exactly.
Each streamed fit runs with ``prefetch`` 0 and 2, bit-identical."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu.models import init as ji  # noqa: E402
from kmeans_tpu_torch import (BisectingKMeans, KMeans,  # noqa: E402
                              MiniBatchKMeans, SphericalKMeans)
from kmeans_tpu_torch.data.io import iter_npy_blocks  # noqa: E402
from kmeans_tpu_torch.models import init as pi  # noqa: E402
from kmeans_tpu_torch.utils import faults  # noqa: E402

RTOL, ATOL = 1e-12, 1e-10
QUALITY_FACTOR = 1.25
F64 = dict(dtype=np.float64, distance_mode="matmul", verbose=False)


@pytest.fixture()
def data():
    rng = np.random.default_rng(11)
    centers = rng.uniform(-10, 10, size=(5, 8))
    return centers[rng.integers(0, 5, 6000)] + rng.standard_normal((6000, 8))


def _blocks_of(X, size, weights=None):
    def make_blocks():
        for i in range(0, len(X), size):
            yield X[i: i + size] if weights is None else \
                (X[i: i + size], weights[i: i + size])
    return make_blocks


def _pair(cls_name, make_blocks, fit_kw=None, **kw):
    """The port's fit_stream with prefetch 0 and 2 (bit-identical) and the
    JAX package's."""
    import kmeans_tpu_torch
    fit_kw = fit_kw or {}
    fits = []
    for prefetch in (0, 2):
        m = getattr(kmeans_tpu_torch, cls_name)(device="cpu", **kw)
        m.fit_stream(make_blocks, prefetch=prefetch, **fit_kw)
        fits.append(m)
    assert fits[0].iterations_run == fits[1].iterations_run
    np.testing.assert_array_equal(fits[0].centroids, fits[1].centroids)
    assert fits[0].sse_history == fits[1].sse_history
    jm = getattr(kmeans_tpu, cls_name)(**kw)
    jm.fit_stream(make_blocks, **fit_kw)
    return fits[1], jm


def _same(km, jm):
    assert km.iterations_run == jm.iterations_run
    np.testing.assert_allclose(km.centroids, jm.centroids, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(km.sse_history, jm.sse_history, rtol=RTOL)
    np.testing.assert_array_equal(km.cluster_sizes_, jm.cluster_sizes_)


@pytest.mark.parametrize("policy", ["keep", "farthest", "resample"])
@pytest.mark.parametrize("init", ["array", "forgy", "random"])
def test_stream_matches_jax_fit_stream(data, policy, init):
    init = data[np.random.RandomState(0).choice(6000, 5, replace=False)] \
        if init == "array" else init
    km, jm = _pair("KMeans", _blocks_of(data, 1000), k=5, seed=0,
                   init=init, compute_sse=True, empty_cluster=policy,
                   max_iter=25, **F64)
    _same(km, jm)


def test_stream_matches_in_memory_fit(data):
    init = data[np.random.RandomState(0).choice(6000, 5, replace=False)]
    kw = dict(k=5, seed=0, init=init, compute_sse=True,
              empty_cluster="keep", device="cpu", **F64)
    mem = KMeans(**kw).fit(data)
    st = KMeans(**kw).fit_stream(_blocks_of(data, 1000))
    assert st.iterations_run == mem.iterations_run
    np.testing.assert_allclose(st.centroids, mem.centroids, rtol=RTOL)
    np.testing.assert_allclose(st.sse_history, mem.sse_history, rtol=RTOL)
    assert st.loop_path_ == "host"


def test_stream_uneven_blocks_and_npy(tmp_path, data):
    path = tmp_path / "pts.npy"
    np.save(path, data)
    init = data[np.random.RandomState(1).choice(6000, 4, replace=False)]
    km, jm = _pair("KMeans", iter_npy_blocks(path, 1700), k=4, seed=0,
                   init=init, empty_cluster="farthest", compute_sse=True,
                   **F64)                            # 1700 * 3 + 900
    _same(km, jm)


def test_stream_guards(data):
    km_r = KMeans(k=3, n_init=2, empty_cluster="keep", max_iter=1,
                  device="cpu", **F64)
    km_r.fit_stream(_blocks_of(data, 1000))
    with pytest.raises(ValueError, match="resume requires n_init"):
        km_r.fit_stream(_blocks_of(data, 1000), resume=True)
    km = KMeans(k=3, empty_cluster="keep", max_iter=2, device="cpu", **F64)
    km.fit_stream(_blocks_of(data, 1000))
    jm = kmeans_tpu.KMeans(k=3, empty_cluster="keep", max_iter=2, **F64)
    jm.fit_stream(_blocks_of(data, 1000))
    with pytest.raises(AttributeError) as want:
        jm.labels_
    with pytest.raises(AttributeError) as got:
        km.labels_
    assert str(got.value) == str(want.value)
    assert km.predict(data[:100]).shape == (100,)
    with pytest.raises(ValueError, match="prefetch"):
        km.fit_stream(_blocks_of(data, 1000), prefetch=-1)
    with pytest.raises(ValueError, match="2-D"):
        km.fit_stream(lambda: iter([np.zeros(4)]))


def test_stream_too_few_points():
    X = np.zeros((3, 2))
    for cls, kw in ((kmeans_tpu.KMeans, {}), (KMeans, {"device": "cpu"})):
        km = cls(k=5, empty_cluster="keep", init=np.zeros((5, 2)), **F64,
                 **kw)
        with pytest.raises(ValueError, match="Not enough data points"):
            km.fit_stream(_blocks_of(X, 2))


def test_stream_farthest_multiple_empties_keeps_old():
    X = np.concatenate([np.zeros((50, 2)), np.ones((50, 2)) * 100.0])
    far_init = np.array([[0, 0], [100, 100], [500, 500], [600, 600],
                         [700, 700]], np.float64)
    km, jm = _pair("KMeans", _blocks_of(X, 40), k=5, init=far_init,
                   empty_cluster="farthest", max_iter=3, chunk_size=8,
                   compute_sse=True, **F64)
    _same(km, jm)
    assert np.all(np.isfinite(km.centroids))


def test_stream_one_shot_iterable_raises(data):
    blocks = iter([data[:2000], data[2000:]])       # not a fresh iterable
    km = KMeans(k=3, empty_cluster="keep", max_iter=5, init=data[:3].copy(),
                device="cpu", **F64)
    with pytest.raises(ValueError, match="FRESH iterable"):
        km.fit_stream(lambda: blocks)


def test_fit_after_fit_stream_clears_stale_labels_error(data):
    km = KMeans(k=5, seed=0, empty_cluster="keep", device="cpu", **F64)
    km.fit_stream(_blocks_of(data, 2000))
    with pytest.raises(AttributeError, match="fit_stream"):
        _ = km.labels_
    km.fit(data)
    assert km.labels_.shape == (len(data),)


def test_minibatch_and_bisecting_fit_stream_blocked():
    """Refusals by design, with the JAX package's messages."""
    from kmeans_tpu.models import BisectingKMeans as JB
    from kmeans_tpu.models import MiniBatchKMeans as JM
    for port, jax_cls in ((MiniBatchKMeans, JM), (BisectingKMeans, JB)):
        with pytest.raises(NotImplementedError) as want:
            jax_cls(k=3, verbose=False).fit_stream(lambda: [])
        with pytest.raises(NotImplementedError) as got:
            port(k=3, verbose=False, device="cpu").fit_stream(lambda: [])
        assert str(got.value) == str(want.value)


def test_stream_resample_policy_from_reservoir():
    """'resample' draws from the epoch's seeded reservoir: the JAX
    package's rows, a real streamed row in the refilled slot."""
    X = np.random.RandomState(7).normal(size=(400, 2))
    far_init = np.array([[0, 0], [0.3, 0.3], [1e3, 1e3]], np.float64)
    for max_iter in (1, 8):
        km, jm = _pair("KMeans", _blocks_of(X, 64), k=3, init=far_init,
                       empty_cluster="resample", max_iter=max_iter,
                       chunk_size=8, compute_sse=True, **F64)
        _same(km, jm)
        if max_iter == 1:
            assert np.any(np.all(np.isclose(X, km.centroids[2][None]),
                                 axis=1))


def test_reservoir_draw_is_uniform_chi2():
    stats = pytest.importorskip("scipy.stats")
    n, cap, m, trials = 120, 12, 4, 3000
    rows = np.arange(n, dtype=np.float64)[:, None]
    counts = np.zeros(n)
    for t in range(trials):
        res = pi._EpochReservoir(cap, 1, np.random.default_rng([t, 1]))
        for blk in (rows[:7], rows[7:60], rows[60:101], rows[101:]):
            res.offer(blk)
        drawn = res.sample(m, np.random.default_rng([t, 2]))
        counts[drawn[:, 0].astype(int)] += 1
    expected = trials * m / n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert float(stats.chi2.sf(chi2, df=n - 1)) > 1e-4


def test_reservoir_matches_jax_and_sequential_algorithm_r():
    n, cap = 257, 16
    rows = np.arange(n, dtype=np.float32)[:, None]
    res = pi._EpochReservoir(cap, 1, np.random.default_rng(99))
    jres = ji._EpochReservoir(cap, 1, np.random.default_rng(99))
    for blk in np.array_split(rows, 7):
        res.offer(blk)
        jres.offer(blk)
    np.testing.assert_array_equal(res.rows, jres.rows)
    assert res.rows.dtype == np.float64
    rng = np.random.default_rng(99)
    ref = np.zeros((cap, 1))
    for t in range(n):
        if t < cap:
            ref[t] = rows[t]
        else:
            j = rng.integers(0, t + 1)
            if j < cap:
                ref[j] = rows[t]
    np.testing.assert_array_equal(res.rows, ref)
    np.testing.assert_array_equal(
        res.sample(5, np.random.default_rng(3)),
        jres.sample(5, np.random.default_rng(3)))


def test_stream_resample_single_block_matches_jax():
    """One block holding the whole data, 'resample' empties forced: the
    JAX package's streamed trajectory, refills included."""
    rng = np.random.RandomState(11)
    X = np.concatenate([rng.normal(size=(150, 2)),
                        rng.normal(size=(150, 2)) + 8.0])
    far_init = np.array([[0, 0], [8, 8], [1e3, 1e3]], np.float64)
    km, jm = _pair("KMeans", lambda: [X], k=3, init=far_init,
                   empty_cluster="resample", seed=5, compute_sse=True,
                   tolerance=1e-7, max_iter=40, **F64)
    _same(km, jm)
    mem = KMeans(k=3, init=far_init, empty_cluster="resample", seed=5,
                 compute_sse=True, tolerance=1e-7, max_iter=40,
                 device="cpu", **F64).fit(X)
    assert km.sse_history[0] == mem.sse_history[0]


def test_predict_stream_matches_predict(data):
    km = KMeans(k=4, seed=2, device="cpu", **F64).fit(data)
    jm = kmeans_tpu.KMeans(k=4, seed=2, **F64).fit(data)
    np.testing.assert_allclose(km.centroids, jm.centroids, rtol=RTOL)

    def blocks():
        yield data[:2000]
        yield data[2000:4100]
        yield data[4100:]

    streamed = np.concatenate(list(km.predict_stream(blocks)))
    np.testing.assert_array_equal(streamed, km.predict(data))
    np.testing.assert_array_equal(
        streamed, np.concatenate(list(jm.predict_stream(blocks))))


def test_predict_stream_guards():
    km = KMeans(k=3, device="cpu", **F64)
    with pytest.raises(ValueError, match="fitted before prediction"):
        km.predict_stream(lambda: iter([np.zeros((4, 2))]))
    X = np.random.default_rng(0).normal(size=(200, 6))
    km.fit(X)
    bad = lambda: iter([np.zeros((8, 5))])          # noqa: E731
    with pytest.raises(ValueError, match=r"block shape .* != \(\*, 6\)"):
        list(km.predict_stream(bad))
    for call in (lambda: list(km.predict_stream(lambda: iter([]))),
                 lambda: km.score_stream(lambda: iter([])),
                 lambda: list(km.transform_stream(lambda: iter([])))):
        with pytest.raises(ValueError, match="FRESH iterable"):
            call()
    with pytest.raises(ValueError, match="3-tuple"):
        list(km.predict_stream(lambda: iter([(X, X, X)])))


def _sorted_blob_blocks(n_per=800, k=4, d=4, std=0.6, seed=0):
    """A cluster-sorted stream: block i holds only blob i."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-20, 20, size=(k, d))
    blocks = [centers[i] + std * rng.normal(size=(n_per, d))
              for i in range(k)]
    return (lambda: iter([b.copy() for b in blocks])), np.concatenate(blocks)


def test_stream_forgy_init_rows_match_jax():
    """Streamed Forgy draws over the whole stream: the JAX package's rows,
    seeds from more than the first block."""
    make_blocks, X = _sorted_blob_blocks()
    outs, n = pi.streamed_forgy_init(make_blocks, 4, [0, 5], 4, np.float64)
    jouts, jn = ji.streamed_forgy_init(make_blocks, 4, [0, 5], 4,
                                       np.float64)
    assert n == jn == 3200
    for a, b in zip(outs, jouts):
        np.testing.assert_array_equal(a, b)
    blob_of = np.repeat(np.arange(4), 800)
    seeded = {int(blob_of[np.argmin(np.linalg.norm(X - c, axis=1))])
              for c in outs[0]}
    assert len(seeded) > 1


def test_stream_callable_init_sees_full_stream():
    """A callable init gets the JAX package's seeded sample of the whole
    stream (positive-weight rows, permuted)."""
    make_blocks, X = _sorted_blob_blocks()
    seen = []

    def grab_init(sample, k, seed):
        seen.append((np.array(sample), seed))
        return sample[:k]

    km, jm = _pair("KMeans", make_blocks, k=4, init=grab_init, n_init=2,
                   seed=7, max_iter=2, compute_sse=True, **F64)
    assert len(seen) == 6                  # two restarts, three fits
    for (a, s), (b, t) in zip(seen[:2], seen[4:]):
        assert s == t
        np.testing.assert_array_equal(a, b)
        assert a.shape == (2048, 4)
    _same(km, jm)

    def weighted_blocks():
        for i, b in enumerate(np.split(X, 4)):
            yield b, np.full(len(b), 0.0 if i == 3 else 1.0)

    samples, _ = pi.streamed_init_sample(weighted_blocks, 4, [7], 4,
                                         np.float64)
    jsamples, _ = ji.streamed_init_sample(weighted_blocks, 4, [7], 4,
                                          np.float64)
    np.testing.assert_array_equal(samples[0], jsamples[0])
    blob_of = np.repeat(np.arange(4), 800)
    assert {int(blob_of[np.argmin(np.linalg.norm(X - r, axis=1))])
            for r in samples[0]} == {0, 1, 2}


def test_stream_init_deterministic():
    make_blocks, _ = _sorted_blob_blocks()
    for init in ("forgy", "k-means++"):
        a, b = (KMeans(k=4, seed=3, init=init, max_iter=3, device="cpu",
                       **F64).fit_stream(make_blocks) for _ in range(2))
        np.testing.assert_array_equal(a.centroids, b.centroids)


def test_stream_forgy_is_uniform_over_stream():
    lo, hi = np.zeros((500, 2)), np.ones((500, 2))
    frac = []
    for s in range(200):
        outs, n = pi.streamed_forgy_init(
            lambda: iter([lo.copy(), hi.copy()]), 4, [s], 2, np.float32)
        frac.append(float(np.mean(outs[0][:, 0] > 0.5)))
    assert abs(np.mean(frac) - 0.5) < 0.06 and n == 1000


def _seed_only_init(pool):
    def init(X_ignored, k, seed):
        rng = np.random.default_rng(seed)
        return pool[rng.choice(len(pool), size=k, replace=False)]
    return init


def test_stream_n_init_picks_same_winner_as_jax():
    make_blocks, X = _sorted_blob_blocks()
    pool = X[np.random.default_rng(7).choice(len(X), 64, replace=False)]
    km, jm = _pair("KMeans", make_blocks, k=4, seed=0, n_init=3,
                   init=_seed_only_init(pool), max_iter=40,
                   compute_sse=True, **F64)
    assert km.best_restart_ == jm.best_restart_
    np.testing.assert_allclose(km.restart_inertias_, jm.restart_inertias_,
                               rtol=RTOL)
    _same(km, jm)
    mem = KMeans(k=4, seed=0, n_init=3, init=_seed_only_init(pool),
                 max_iter=40, device="cpu", **F64).fit(X)
    assert km.best_restart_ == mem.best_restart_


def test_stream_resume_continues(tmp_path):
    make_blocks, X = _sorted_blob_blocks(std=6.0)
    init = X[np.random.default_rng(1).choice(len(X), 4, replace=False)]
    kw = dict(k=4, seed=0, init=init, empty_cluster="resample",
              tolerance=1e-12, compute_sse=True, device="cpu", **F64)
    full = KMeans(max_iter=12, **kw).fit_stream(make_blocks)
    part = KMeans(max_iter=5, **kw).fit_stream(make_blocks)
    part.max_iter = 12
    part.fit_stream(make_blocks, resume=True)
    np.testing.assert_array_equal(part.centroids, full.centroids)
    assert part.iterations_run == full.iterations_run > 5
    assert part.sse_history == full.sse_history
    path = tmp_path / "ck"
    with faults.inject_kill_after_iteration(4):
        with pytest.raises(faults.SimulatedPreemption):
            KMeans(max_iter=12, **kw).fit_stream(
                make_blocks, checkpoint_every=2, checkpoint_path=path)
    resumed = KMeans(max_iter=12, **kw).fit_stream(
        make_blocks, resume=path, checkpoint_every=2, checkpoint_path=path)
    np.testing.assert_array_equal(resumed.centroids, full.centroids)
    assert resumed.sse_history == full.sse_history
    assert resumed.iterations_run == full.iterations_run
    assert resumed.checkpoint_segments_ == (full.iterations_run - 4 + 1) // 2


def test_stream_resume_exhausted_budget_is_noop():
    make_blocks, X = _sorted_blob_blocks(std=6.0)
    init = X[np.random.default_rng(1).choice(len(X), 4, replace=False)]
    km = KMeans(k=4, seed=0, init=init, empty_cluster="keep", max_iter=4,
                tolerance=1e-12, device="cpu", **F64)
    km.fit_stream(make_blocks)
    assert km.iterations_run == 4
    cents, sizes = km.centroids.copy(), km.cluster_sizes_.copy()
    km.fit_stream(make_blocks, resume=True)
    np.testing.assert_array_equal(km.centroids, cents)
    assert km.iterations_run == 4
    np.testing.assert_array_equal(km.cluster_sizes_, sizes)


def _directions(seed=0):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(4, 6))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return np.concatenate([
        dd * rng.uniform(0.1, 100.0, size=(300, 1))
        + 0.05 * rng.normal(size=(300, 6)) for dd in dirs]), rng


def test_spherical_fit_stream_normalizes_blocks():
    X, rng = _directions()
    init = X[rng.choice(len(X), 4, replace=False)]
    kw = dict(k=4, seed=0, init=init, empty_cluster="keep",
              compute_sse=True, **F64)
    st, jst = _pair("SphericalKMeans", _blocks_of(X, 400), **kw)
    _same(st, jst)
    np.testing.assert_allclose(np.linalg.norm(st.centroids, axis=1), 1.0,
                               rtol=1e-12)
    mem = SphericalKMeans(device="cpu", **kw).fit(X)
    np.testing.assert_allclose(st.centroids, mem.centroids, rtol=RTOL,
                               atol=ATOL)
    lab = np.concatenate(list(st.predict_stream(_blocks_of(X, 400))))
    np.testing.assert_array_equal(lab, mem.predict(X))
    tiles = np.concatenate(list(st.transform_stream(_blocks_of(X, 400))))
    np.testing.assert_allclose(tiles, st.transform(X), rtol=1e-9,
                               atol=1e-12)


def test_spherical_score_stream_normalizes_blocks():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(600, 5)) * rng.uniform(0.1, 50.0, size=(600, 1))
    km = SphericalKMeans(k=4, seed=0, empty_cluster="keep", device="cpu",
                         **F64).fit(X)
    jm = kmeans_tpu.SphericalKMeans(k=4, seed=0, empty_cluster="keep",
                                    **F64).fit(X)
    got = km.score_stream(_blocks_of(X, 200))
    np.testing.assert_allclose(got, km.score(X), rtol=RTOL)
    np.testing.assert_allclose(got, jm.score_stream(_blocks_of(X, 200)),
                               rtol=RTOL)


def test_weighted_stream_matches_jax(data):
    rng = np.random.RandomState(3)
    w = rng.randint(1, 4, size=len(data)).astype(np.float64)
    w[::13] = 0.0
    init = data[rng.choice(len(data), 5, replace=False)].copy()
    km, jm = _pair("KMeans", _blocks_of(data, 1000, w), k=5, seed=0,
                   init=init, empty_cluster="keep", compute_sse=True,
                   chunk_size=128, **F64)
    _same(km, jm)
    mem = KMeans(k=5, seed=0, init=init, empty_cluster="keep",
                 compute_sse=True, device="cpu", **F64).fit(
        data, sample_weight=w)
    np.testing.assert_allclose(km.centroids, mem.centroids, rtol=RTOL)


def test_weighted_stream_init_skips_zero_weight_rows():
    rng = np.random.RandomState(5)
    good = rng.normal(size=(500, 2))
    X = np.concatenate([good, rng.normal(size=(500, 2)) + 1e3])
    w = np.concatenate([np.ones(500), np.zeros(500)])

    def make_blocks():
        yield X[:600], w[:600]
        yield X[600:], w[600:]

    for init in ("forgy", "k-means++"):
        km = KMeans(k=3, seed=0, init=init, empty_cluster="keep",
                    max_iter=5, device="cpu", **F64)
        km.fit_stream(make_blocks)
        assert np.all(np.abs(km.centroids) < 100), init


def test_weighted_stream_guards(data):
    for model in (KMeans(k=3, max_iter=1, empty_cluster="keep",
                         device="cpu", **F64),
                  kmeans_tpu.KMeans(k=3, max_iter=1, empty_cluster="keep",
                                    **F64)):
        with pytest.raises(ValueError, match="must have shape"):
            model.fit_stream(lambda: iter([(data[:100], np.ones(5))]))
        with pytest.raises(ValueError, match="finite and >= 0"):
            model.fit_stream(lambda: iter([(data[:100], -np.ones(100))]))
        with pytest.raises(ValueError, match="Not enough data points"):
            model.fit_stream(lambda: iter([(data[:100], np.zeros(100))]))


def test_weighted_stream_reusable_for_predict_and_transform(data):
    w = np.random.RandomState(3).randint(1, 4, size=len(data)) * 1.0
    make_blocks = _blocks_of(data, 2000, w)
    km = KMeans(k=4, seed=0, max_iter=5, empty_cluster="keep",
                device="cpu", **F64).fit_stream(make_blocks)
    lab = np.concatenate(list(km.predict_stream(make_blocks)))
    np.testing.assert_array_equal(lab, km.predict(data))
    tiles = np.concatenate(list(km.transform_stream(make_blocks)))
    np.testing.assert_array_equal(tiles, km.transform(data))


def test_score_stream_matches_score_and_jax(data):
    km = KMeans(k=4, seed=0, max_iter=5, empty_cluster="keep",
                device="cpu", **F64).fit(data)
    jm = kmeans_tpu.KMeans(k=4, seed=0, max_iter=5, empty_cluster="keep",
                           **F64).fit(data)
    got = km.score_stream(_blocks_of(data, 1700))
    np.testing.assert_allclose(got, km.score(data), rtol=RTOL)
    np.testing.assert_allclose(got, jm.score_stream(_blocks_of(data, 1700)),
                               rtol=RTOL)
    w = np.full(len(data), 2.0)
    got_w = km.score_stream(_blocks_of(data, 1700, w))
    np.testing.assert_allclose(got_w, 2.0 * got, rtol=RTOL)


def test_transform_stream_matches_jax(data):
    km = KMeans(k=4, seed=0, max_iter=5, device="cpu", **F64).fit(data)
    jm = kmeans_tpu.KMeans(k=4, seed=0, max_iter=5, **F64).fit(data)
    for rows in (None, 1000):
        got = np.concatenate(list(km.transform_stream(
            _blocks_of(data, 2500), block_rows=rows)))
        want = np.concatenate(list(jm.transform_stream(
            _blocks_of(data, 2500), block_rows=rows)))
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def _blobs(n=4000, d=8, centers=20, seed=0, std=1.0, box=10.0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-box, box, size=(centers, d))
    y = rng.integers(0, centers, size=n)
    return means[y] + std * rng.standard_normal((n, d))


def _sse(X, C):
    d2 = ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1)
    return float(d2.min(1).sum())


def test_streamed_kmeans_parallel_quality():
    """The streamed k-means|| by quality: its seeding SSE, the mean over
    six seeds pooled over three datasets, within ``QUALITY_FACTOR`` of the
    JAX package's streamed k-means|| (either way); after five Lloyd
    iterations, the streamed fit's SSE within ``QUALITY_FACTOR`` of the
    in-memory k-means|| fit's (whose seeding also polishes its reduce); a
    fit from it within 1 % of the JAX package's on separated blobs."""
    ours, theirs, fit_stream, fit_mem = [], [], [], []
    kw = dict(k=20, init="k-means||", max_iter=5, device="cpu", **F64)
    for ds in range(3):
        X = _blobs(seed=ds)
        mk = _blocks_of(X, 1100)
        for s in range(6):
            c, n = pi.streamed_kmeans_parallel_init(mk, 20, [s], 8,
                                                    np.float64,
                                                    device="cpu")
            jc, jn = ji.streamed_kmeans_parallel_init(mk, 20, [s], 8,
                                                      np.float64)
            assert n == jn == 4000 and c[0].shape == (20, 8)
            assert len(np.unique(c[0], axis=0)) == 20
            ours.append(_sse(X, c[0]))
            theirs.append(_sse(X, jc[0]))
            fit_stream.append(-KMeans(seed=s, **kw).fit_stream(mk).score(X))
            fit_mem.append(-KMeans(seed=s, **kw).fit(X).score(X))
    for a, b in ((ours, theirs), (fit_stream, fit_mem)):
        ratio = np.mean(a) / np.mean(b)
        assert 1 / QUALITY_FACTOR <= ratio <= QUALITY_FACTOR, ratio
    make_blocks, X = _sorted_blob_blocks()
    km = KMeans(k=4, seed=0, init="k-means++", compute_sse=True,
                max_iter=50, device="cpu", **F64).fit_stream(make_blocks)
    jm = kmeans_tpu.KMeans(k=4, seed=0, init="k-means++", compute_sse=True,
                           max_iter=50, **F64)
    jm.fit_stream(make_blocks)
    assert -km.score(X) <= -jm.score(X) * 1.01


def test_streamed_kmeans_parallel_deterministic_parts():
    """What does not draw from the generator is the JAX package's: the
    first candidate (a cap-1 reservoir), the row count, the n < k error,
    and, where the rounds find fewer than k distinct rows, the backfill
    (a cap-k reservoir).  Weighted streams skip zero-weight rows."""
    X = np.repeat(np.arange(6, dtype=np.float64)[:, None], 50, axis=0) \
        * np.ones((1, 3))                      # 6 distinct rows
    mk = _blocks_of(X, 70)
    c, n = pi.streamed_kmeans_parallel_init(mk, 8, [4], 3, np.float64,
                                            device="cpu")
    jc, jn = ji.streamed_kmeans_parallel_init(mk, 8, [4], 3, np.float64)
    assert n == jn == 300
    assert {tuple(r) for r in c[0]} == {tuple(r) for r in jc[0]}
    for fn in (pi.streamed_kmeans_parallel_init,
               ji.streamed_kmeans_parallel_init):
        kw = {"device": "cpu"} if fn is pi.streamed_kmeans_parallel_init \
            else {}
        with pytest.raises(ValueError, match="Not enough data points"):
            fn(_blocks_of(X[:5], 2), 8, [0], 3, np.float64, **kw)
    res = pi._EpochReservoir(1, 3, np.random.default_rng([9, 0xF1257]))
    jres = ji._EpochReservoir(1, 3, np.random.default_rng([9, 0xF1257]))
    for b in np.array_split(_blobs(n=500, d=3), 4):
        res.offer(b)
        jres.offer(b)
    np.testing.assert_array_equal(res.rows, jres.rows)
