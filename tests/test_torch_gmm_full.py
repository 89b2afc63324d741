"""kmeans_tpu_torch.GaussianMixture with 'tied' and 'full' covariances
against kmeans_tpu.GaussianMixture on the CPU, by the host loop.

Parity classes: both float64 and the same initial parameters, the same
``n_iter_`` and labels, and ``means_``, ``covariances_``, ``weights_``,
``lower_bound_``, ``precisions_cholesky_``, ``predict_proba``,
``score_samples`` and ``sample`` to ``rtol=1e-12`` / ``atol=1e-10``; the
jitter ladder rescues the same components with the same count and fails
with the same text.  Float32: the E-step's statistics against the float64
E-step at the same parameters within the bands of ``ops/compare.py``
(``ESTEP_RTOL``, ``ESTEP_ATOL_SHARE``, ``LL_RTOL``), and the fit against the
JAX package's float32 fit at the tolerances of ``test_torch_gmm.py``.  The
JAX package's fits compile, so the fitted pairs are shared through
module-scoped fixtures.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu_torch import convert  # noqa: E402
from kmeans_tpu_torch.ops import compare as cmp  # noqa: E402
from kmeans_tpu_torch.parallel import gmm_step  # noqa: E402

RTOL, ATOL = 1e-12, 1e-10
K, D, N = 3, 4, 400
COV_TYPES = ["tied", "full"]


def _data(dtype=np.float64, n=N, seed=0):
    """Overlapping correlated clusters: soft responsibilities on many
    rows, and off-diagonal covariance for 'full' and 'tied' to find."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(K, D)) * 2.0
    mix = rng.normal(size=(K, D, D)) * 0.5 + np.eye(D)
    y = rng.integers(0, K, size=n)
    X = centers[y] + np.einsum("nd,nde->ne", rng.normal(size=(n, D)),
                               mix[y])
    return X.astype(dtype)


def _init(X, cov_type, seed=1):
    rng = np.random.default_rng(seed)
    means = X[rng.choice(len(X), K, replace=False)].astype(np.float64)
    prec = np.eye(D) if cov_type == "tied" else np.broadcast_to(
        np.eye(D), (K, D, D)).copy()
    return dict(means_init=means, weights_init=np.full(K, 1.0 / K),
                precisions_init=prec)


def _kw(cov_type, dtype, X, **extra):
    kw = dict(n_components=K, covariance_type=cov_type, max_iter=12,
              tol=0.0, reg_covar=1e-6, dtype=dtype, **_init(X, cov_type))
    kw.update(extra)
    return kw


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module", params=COV_TYPES)
def pair64(request):
    X = _data()
    kw = _kw(request.param, np.float64, X)
    jm = kmeans_tpu.GaussianMixture(**kw).fit(X)
    pm = kmeans_tpu_torch.GaussianMixture(device="cpu", **kw).fit(X)
    return jm, pm, X


def test_float64_fit_matches_jax(pair64):
    jm, pm, X = pair64
    assert pm.estep_path_ == "serial" and pm.loop_path_ == "host"
    assert pm.n_iter_ == jm.n_iter_ == 12
    for name in ("means_", "covariances_", "weights_", "shift_"):
        _close(getattr(pm, name), getattr(jm, name))
    _close(pm.lower_bound_, jm.lower_bound_)
    assert pm.covariances_.shape == np.asarray(jm.covariances_).shape
    assert pm.cov_jitter_retries_ == jm.cov_jitter_retries_ == 0


def test_float64_posterior_matches_jax(pair64):
    jm, pm, X = pair64
    np.testing.assert_array_equal(pm.predict(X), np.asarray(jm.predict(X)))
    _close(pm.predict_proba(X), jm.predict_proba(X))
    _close(pm.score_samples(X), jm.score_samples(X))
    _close(pm.score(X), jm.score(X))
    _close(pm.bic(X), jm.bic(X))
    _close(pm.aic(X), jm.aic(X))
    _close(pm.precisions_cholesky_, jm.precisions_cholesky_)
    _close(pm.precisions_, jm.precisions_)


def test_sample_draws_what_jax_draws(pair64):
    jm, pm, _ = pair64
    Xj, yj = jm.sample(300)
    Xp, yp = pm.sample(300)
    np.testing.assert_array_equal(yp, np.asarray(yj))
    _close(Xp, Xj)
    assert Xp.dtype == np.float64 and yp.dtype == np.int32


def test_checkpoints_cross_both_ways(pair64, tmp_path):
    jm, pm, X = pair64
    pm.save(tmp_path / "port")
    back = kmeans_tpu.GaussianMixture.load(tmp_path / "port")
    assert back.covariance_type == pm.covariance_type
    np.testing.assert_array_equal(np.asarray(back.covariances_),
                                  pm.covariances_)
    np.testing.assert_array_equal(np.asarray(back.predict(X)),
                                  pm.predict(X))
    again = kmeans_tpu_torch.GaussianMixture.load(tmp_path / "port",
                                                  device="cpu")
    np.testing.assert_array_equal(again.precisions_cholesky_,
                                  pm.precisions_cholesky_)
    conv = convert.from_jax_state(jm._state_dict(), device="cpu")
    assert conv.covariance_type == jm.covariance_type
    for name in ("means_", "covariances_", "weights_", "shift_"):
        np.testing.assert_array_equal(getattr(conv, name),
                                      np.asarray(getattr(jm, name)))
    np.testing.assert_array_equal(conv.precisions_cholesky_,
                                  np.asarray(jm.precisions_cholesky_))
    np.testing.assert_array_equal(conv.predict(X), np.asarray(jm.predict(X)))


@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_jitter_ladder_rescues_as_jax_does(cov_type):
    """A starting covariance just past positive definite (one eigenvalue
    at -reg_covar / 2): the first E-step's factorisation retries with
    ``reg_covar * 10`` on the diagonal, once per offending component, and
    warns; the fits then agree in the float64 class."""
    X = _data()
    kw = _kw(cov_type, np.float64, X)
    bad = np.eye(D)
    bad[0, 0] = -2.0 / kw["reg_covar"]          # covariance -reg / 2
    prec = kw["precisions_init"]
    if cov_type == "tied":
        prec = bad
    else:
        prec[1] = bad
    kw["precisions_init"] = prec
    with pytest.warns(UserWarning, match="jitter ladder"):
        pm = kmeans_tpu_torch.GaussianMixture(device="cpu", **kw).fit(X)
    with pytest.warns(UserWarning, match="jitter ladder"):
        jm = kmeans_tpu.GaussianMixture(**kw).fit(X)
    assert pm.cov_jitter_retries_ == jm.cov_jitter_retries_ == 1
    for name in ("means_", "covariances_", "weights_"):
        _close(getattr(pm, name), getattr(jm, name))
    _close(pm.lower_bound_, jm.lower_bound_)
    again = convert.from_jax_state(convert.to_jax_state(pm), device="cpu")
    assert again.cov_jitter_retries_ == 1


@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_jitter_ladder_exhausted_raises_the_same_text(cov_type):
    X = _data()
    kw = _kw(cov_type, np.float64, X)
    bad = np.eye(D)
    bad[2, 2] = -1.0                            # covariance -1: hopeless
    if cov_type == "tied":
        kw["precisions_init"] = bad
    else:
        kw["precisions_init"][0] = bad
    with pytest.raises(ValueError, match="jitter ladder") as got:
        kmeans_tpu_torch.GaussianMixture(device="cpu", **kw).fit(X)
    with pytest.raises(ValueError, match="jitter ladder") as want:
        kmeans_tpu.GaussianMixture(**kw).fit(X)
    assert str(got.value) == str(want.value)
    assert ("the shared tied covariance" if cov_type == "tied"
            else "component(s) [0]") in str(got.value)


@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_predict_raises_on_a_covariance_that_does_not_factor(cov_type):
    """Inference keeps the strict factorisation (no ladder)."""
    X = _data()
    pm = kmeans_tpu_torch.GaussianMixture(
        device="cpu", **_kw(cov_type, np.float64, X, max_iter=2)).fit(X)
    cov = np.array(pm.covariances_)
    if cov_type == "tied":
        cov[0, 0] = -1.0
    else:
        cov[0, 0, 0] = -1.0
    pm.covariances_ = cov
    with pytest.raises(ValueError, match="ill-defined empirical"):
        pm.predict(X)


@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_float32_estep_within_the_bands(cov_type):
    """One float32 E-step at fitted parameters against the same step in
    float64: the bands of ``ops/compare.py``."""
    X = _data()
    pm = kmeans_tpu_torch.GaussianMixture(
        device="cpu", **_kw(cov_type, np.float64, X, max_iter=4)).fit(X)
    outs = []
    for dtype in (np.float32, np.float64):
        pm.dtype = np.dtype(dtype)
        ds = pm._dataset(X.astype(dtype))
        step = pm._step_fn(ds, "torch", 0)
        outs.append([t.to(torch.float64) for t in step(
            ds.points, ds.weights, *pm._params_dev())])
    got, want = outs
    for a, b in zip(got[:3], want[:3]):
        assert cmp.close(a, b, cmp.ESTEP_RTOL,
                         cmp.ESTEP_ATOL_SHARE * float(b.abs().max()))
    assert cmp.close(got[3], want[3], cmp.LL_RTOL, 0.0)


@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_float32_fit_matches_jax(cov_type):
    X = _data(np.float32)
    kw = _kw(cov_type, np.float32, X)
    jm = kmeans_tpu.GaussianMixture(**kw).fit(X)
    pm = kmeans_tpu_torch.GaussianMixture(device="cpu", **kw).fit(X)
    np.testing.assert_allclose(pm.means_, np.asarray(jm.means_), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(pm.weights_, np.asarray(jm.weights_),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(pm.covariances_, np.asarray(jm.covariances_),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(pm.lower_bound_, jm.lower_bound_, rtol=1e-4)
    assert (pm.predict(X) == np.asarray(jm.predict(X))).mean() > 0.99


@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_kmeans_init_and_restarts_run(cov_type):
    """init_params='kmeans' (the internal KMeans) and n_init=2 by the host
    loop: the restarts' bounds recorded, the best one kept."""
    X = _data(np.float32)
    pm = kmeans_tpu_torch.GaussianMixture(
        n_components=K, covariance_type=cov_type, max_iter=8, n_init=2,
        seed=4, device="cpu").fit(X)
    assert pm.restart_lower_bounds_.shape == (2,)
    assert pm.lower_bound_ == pm.restart_lower_bounds_.max()
    assert pm.best_restart_ == int(np.argmax(pm.restart_lower_bounds_))
    assert np.all(np.isfinite(pm.covariances_))


@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_pipelined_schedule_gives_the_same_bits(cov_type):
    X = _data()
    runs = [kmeans_tpu_torch.GaussianMixture(
        device="cpu", chunk_size=64,
        **_kw(cov_type, np.float64, X, max_iter=5, pipeline=p)).fit(X)
        for p in (0, 1)]
    assert [m.estep_path_ for m in runs] == ["serial", "pipelined"]
    for name in ("means_", "covariances_", "weights_"):
        np.testing.assert_array_equal(getattr(runs[0], name),
                                      getattr(runs[1], name))
    assert runs[0].lower_bound_ == runs[1].lower_bound_


def test_the_tied_total_scatter_is_one_product():
    X = _data()
    w = np.linspace(0.0, 2.0, len(X))
    shift = (w @ X) / w.sum()
    got = gmm_step.total_scatter(
        torch.from_numpy(X), torch.from_numpy(w), torch.from_numpy(shift))
    xc = X - shift
    _close(got.numpy(), (xc * w[:, None]).T @ xc)


@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_n_parameters_as_sklearn_counts(cov_type):
    pm = kmeans_tpu_torch.GaussianMixture(n_components=3, device="cpu",
                                          covariance_type=cov_type)
    jm = kmeans_tpu.GaussianMixture(n_components=3,
                                    covariance_type=cov_type)
    assert pm._n_parameters_for(3, 5, cov_type) == \
        jm._n_parameters_for(3, 5, cov_type)


def test_host_statistics_keep_their_kind():
    """``_host`` takes the statistics to float64 host arrays: 'full''s
    stay ``EStatsFull``, and the diagonal kernel's plain four
    (``diag_estep``'s tuple) become ``EStats``."""
    t = [torch.ones(2), torch.ones((2, 3)), torch.ones((2, 3, 3)),
         torch.ones(())]
    full = kmeans_tpu_torch.GaussianMixture._host(gmm_step.EStatsFull(*t))
    assert isinstance(full, gmm_step.EStatsFull)
    diag = kmeans_tpu_torch.GaussianMixture._host(
        (t[0], t[1], t[1], t[3]))
    assert isinstance(diag, gmm_step.EStats)
    assert diag.x2sum.dtype == np.float64 and diag.x2sum.shape == (2, 3)
