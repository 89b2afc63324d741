"""``GaussianMixture.fit_stream`` and its inference streams against the JAX
package's, in float64: the lower bound and the parameters to
``rtol=1e-12``, equal iterations, for every covariance type from
``means_init`` and from ``init_params='random'`` (the streamed Forgy rows
are the JAX package's); 'kmeans' (a streamed k-means|| then each restart's
own ``KMeans.fit_stream``) by quality; weighted streams; the restarts;
``predict_stream`` and ``score_samples_stream`` against in-memory
``predict`` and ``score_samples``; checkpoint and resume of a stream, bit
for bit.  Every fit runs with ``prefetch`` 0 and 2, bit-identical."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu_torch import GaussianMixture  # noqa: E402
from kmeans_tpu_torch.utils import faults  # noqa: E402

RTOL = 1e-12
COV_TYPES = ("diag", "spherical", "tied", "full")


def _data(n=2400, d=4, centers=3, seed=5):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-8, 8, size=(centers, d))
    y = rng.integers(0, centers, size=n)
    return means[y] + rng.standard_normal((n, d)) * rng.uniform(
        0.5, 1.5, size=(centers, 1))[y]


def _blocks_of(X, size, weights=None):
    def make_blocks():
        for i in range(0, len(X), size):
            yield X[i: i + size] if weights is None else \
                (X[i: i + size], weights[i: i + size])
    return make_blocks


def _fit_pair(make_blocks, **kw):
    kw = dict(dict(dtype=np.float64, seed=1), **kw)
    fits = [GaussianMixture(device="cpu", **kw).fit_stream(
        make_blocks, prefetch=p) for p in (0, 2)]
    a, b = fits
    assert a.n_iter_ == b.n_iter_ and a.lower_bound_ == b.lower_bound_
    for name in ("weights_", "means_", "covariances_"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    jg = kmeans_tpu.GaussianMixture(**kw).fit_stream(make_blocks)
    return b, jg


def _same(g, jg):
    assert g.n_iter_ == jg.n_iter_ and g.converged_ == jg.converged_
    np.testing.assert_allclose(g.lower_bound_, jg.lower_bound_, rtol=RTOL)
    for name in ("weights_", "means_", "covariances_"):
        np.testing.assert_allclose(getattr(g, name),
                                   np.asarray(getattr(jg, name)),
                                   rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("init", ["means_init", "random"])
@pytest.mark.parametrize("ct", COV_TYPES)
def test_fit_stream_matches_jax(ct, init):
    X = _data()
    kw = dict(n_components=3, covariance_type=ct, max_iter=12, tol=1e-9)
    if init == "means_init":
        kw["means_init"] = X[:3].copy()
    else:
        kw["init_params"] = "random"
    g, jg = _fit_pair(_blocks_of(X, 700), **kw)
    _same(g, jg)
    assert g.loop_path_ == "host" and g.estep_path_ == "serial"


@pytest.mark.parametrize("ct", ["diag", "full"])
def test_fit_stream_matches_in_memory(ct):
    X = _data()
    kw = dict(n_components=3, covariance_type=ct, max_iter=12, tol=1e-9,
              means_init=X[:3].copy(), dtype=np.float64, device="cpu")
    mem = GaussianMixture(**kw).fit(X)
    st = GaussianMixture(**kw).fit_stream(_blocks_of(X, 500))
    assert st.n_iter_ == mem.n_iter_
    np.testing.assert_allclose(st.lower_bound_, mem.lower_bound_, rtol=RTOL)
    np.testing.assert_allclose(st.means_, mem.means_, rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(st.covariances_, mem.covariances_,
                               rtol=RTOL, atol=1e-12)
    # The frame only: the in-memory shift is the mean of the rows rounded
    # to float32 (the JAX package's ``_mean_jit``), the stream's the
    # float64 mean (its ``fit_stream``).
    np.testing.assert_allclose(st.shift_, mem.shift_, rtol=1e-7)


def test_fit_stream_restarts_match_jax():
    X = _data(seed=7)
    g, jg = _fit_pair(_blocks_of(X, 800), n_components=4, n_init=3,
                      init_params="random", max_iter=10, tol=1e-9)
    _same(g, jg)
    assert g.best_restart_ == jg.best_restart_
    np.testing.assert_allclose(g.restart_lower_bounds_,
                               jg.restart_lower_bounds_, rtol=RTOL)


@pytest.mark.parametrize("ct", ["diag", "tied"])
def test_fit_stream_kmeans_init_by_quality(ct):
    """'kmeans': a streamed k-means|| (the port's generator) refined by
    each restart's own ``KMeans.fit_stream``; on separated blobs it reaches
    the JAX package's optimum."""
    X = _data(centers=3, seed=9)
    kw = dict(n_components=3, covariance_type=ct, max_iter=30, tol=1e-10)
    g, jg = _fit_pair(_blocks_of(X, 600), init_params="kmeans", **kw)
    np.testing.assert_allclose(g.lower_bound_, jg.lower_bound_, rtol=1e-6)
    order = np.argsort(g.means_[:, 0])
    jorder = np.argsort(np.asarray(jg.means_)[:, 0])
    np.testing.assert_allclose(g.means_[order],
                               np.asarray(jg.means_)[jorder], rtol=1e-5,
                               atol=1e-5)
    again = GaussianMixture(device="cpu", dtype=np.float64, seed=1,
                            init_params="kmeans", **kw).fit_stream(
        _blocks_of(X, 600))
    assert again.lower_bound_ == g.lower_bound_


def test_weighted_stream_matches_jax_and_memory():
    X = _data()
    w = np.random.RandomState(4).randint(0, 4, size=len(X)).astype(float)
    kw = dict(n_components=3, means_init=X[:3].copy(), max_iter=15,
              tol=1e-9)
    g, jg = _fit_pair(_blocks_of(X, 700, w), **kw)
    _same(g, jg)
    mem = GaussianMixture(device="cpu", dtype=np.float64, seed=1,
                          **kw).fit(X, sample_weight=w)
    np.testing.assert_allclose(g.lower_bound_, mem.lower_bound_, rtol=RTOL)
    np.testing.assert_allclose(g.means_, mem.means_, rtol=RTOL)


def test_stream_guards_match_jax():
    X = _data(n=100)
    cases = [lambda: iter([(X, np.zeros(100))]),
             lambda: iter([(X, np.ones(5))]),
             lambda: iter([]),
             lambda: iter([X[:2]])]
    for make_blocks in cases:
        with pytest.raises(ValueError) as want:
            kmeans_tpu.GaussianMixture(n_components=3).fit_stream(
                make_blocks)
        with pytest.raises(ValueError) as got:
            GaussianMixture(n_components=3, device="cpu").fit_stream(
                make_blocks)
        assert str(got.value) == str(want.value)
    g = GaussianMixture(n_components=2, n_init=2, init_params="random",
                        max_iter=2, device="cpu", dtype=np.float64)
    g.fit_stream(_blocks_of(X, 50))
    with pytest.raises(ValueError, match="resume requires n_init"):
        g.fit_stream(_blocks_of(X, 50), resume=True)
    with pytest.raises(ValueError, match="non-finite values in streamed"):
        GaussianMixture(n_components=2, device="cpu").fit_stream(
            faults.poison_blocks(_blocks_of(X, 50), block=1))


@pytest.mark.parametrize("ct", COV_TYPES)
def test_inference_streams_match_in_memory(ct):
    X = _data()
    g = GaussianMixture(n_components=3, covariance_type=ct, max_iter=10,
                        means_init=X[:3].copy(), dtype=np.float64,
                        device="cpu").fit(X)
    jg = kmeans_tpu.GaussianMixture(n_components=3, covariance_type=ct,
                                    max_iter=10, means_init=X[:3].copy(),
                                    dtype=np.float64).fit(X)
    mk = _blocks_of(X, 900, np.ones(len(X)))       # weights are ignored
    labels = np.concatenate(list(g.predict_stream(mk)))
    np.testing.assert_array_equal(labels, g.predict(X))
    np.testing.assert_array_equal(
        labels, np.concatenate(list(jg.predict_stream(mk))))
    lse = np.concatenate(list(g.score_samples_stream(mk)))
    np.testing.assert_allclose(lse, g.score_samples(X), rtol=RTOL)
    np.testing.assert_allclose(
        lse, np.concatenate(list(jg.score_samples_stream(mk))), rtol=1e-10)
    with pytest.raises(ValueError, match="fitted"):
        GaussianMixture(device="cpu").predict_stream(mk)
    with pytest.raises(ValueError, match="block shape"):
        list(g.predict_stream(lambda: iter([X[:, :2]])))


@pytest.mark.parametrize("ct", ["diag", "full"])
def test_checkpoint_and_resume_bit_exact(tmp_path, ct):
    X = _data(seed=3)
    kw = dict(n_components=3, covariance_type=ct, tol=0.0,
              init_params="random", seed=2, dtype=np.float64, device="cpu")
    mk = _blocks_of(X, 600)
    full = GaussianMixture(max_iter=6, **kw).fit_stream(mk)
    path = tmp_path / "g"
    ck = GaussianMixture(max_iter=6, **kw).fit_stream(
        mk, checkpoint_every=2, checkpoint_path=path)
    assert ck.checkpoint_segments_ == 3 and ck.lower_bound_ == \
        full.lower_bound_
    with faults.inject_kill_after_iteration(4):
        with pytest.raises(faults.SimulatedPreemption):
            GaussianMixture(max_iter=6, **kw).fit_stream(
                mk, checkpoint_every=2, checkpoint_path=path)
    # resume grants max_iter more epochs: 2 to reach 6.
    resumed = GaussianMixture(max_iter=2, **kw).fit_stream(mk, resume=path)
    assert resumed.n_iter_ == full.n_iter_ == 6
    assert resumed.lower_bound_ == full.lower_bound_
    for name in ("weights_", "means_", "covariances_"):
        np.testing.assert_array_equal(getattr(resumed, name),
                                      getattr(full, name))
