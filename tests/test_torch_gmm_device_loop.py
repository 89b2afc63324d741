"""The mixture's device EM loop (``GaussianMixture(host_loop=False)``,
``parallel.gmm_step.make_gmm_fit_fn``) and its batched restarts
(``make_gmm_multi_fit_fn``) against the JAX package's device loop on the
CPU.

The port's loop runs the same iteration as the reference's
``lax.while_loop``: the E-step, the M-step in the model's dtype, the lower
bound and ``|ll - prev| < tol``.  Parity class, float64 and the same
initial parameters: the same ``n_iter_`` and ``converged_``, and
``means_``, ``covariances_``, ``weights_`` and ``lower_bound_`` to
``rtol=1e-12`` / ``atol=1e-10``, for all four covariance types.  The
device loop and the host loop (float64 M-step on the host) agree by
tolerance only: in float64 to ``rtol=1e-10``.  The kernel's module is run
through ``diag_estep``'s plain version (tensors on the CPU).  Restarts in
one loop: the same winner and ``restart_lower_bounds_`` as the JAX
package's batched restarts, and each member bit-equal to the port's own
single device-loop fit with its seed.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu_torch.models.kmeans import NumericalDivergenceError  # noqa
from kmeans_tpu_torch.parallel import gmm_step  # noqa: E402

RTOL, ATOL = 1e-12, 1e-10
K, D, N = 3, 4, 360
COV_TYPES = ["diag", "spherical", "tied", "full"]


def _data(dtype=np.float64, n=N, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(K, D)) * 2.2
    scale = rng.uniform(0.6, 1.4, size=(K, D))
    y = rng.integers(0, K, size=n)
    return (centers[y] + scale[y] * rng.normal(size=(n, D))).astype(dtype)


def _init(X, cov_type, seed=2):
    rng = np.random.default_rng(seed)
    means = X[rng.choice(len(X), K, replace=False)].astype(np.float64)
    prec = {"diag": np.ones((K, D)), "spherical": np.ones(K),
            "tied": np.eye(D),
            "full": np.broadcast_to(np.eye(D), (K, D, D)).copy()}[cov_type]
    return dict(means_init=means, weights_init=np.full(K, 1.0 / K),
                precisions_init=prec)


def _kw(cov_type, X, **extra):
    kw = dict(n_components=K, covariance_type=cov_type, max_iter=10,
              tol=0.0, dtype=np.float64, host_loop=False,
              **_init(X, cov_type))
    kw.update(extra)
    return kw


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


def _same_fit(pm, jm, rtol=RTOL, atol=ATOL):
    assert pm.n_iter_ == jm.n_iter_ and pm.converged_ == jm.converged_
    for name in ("means_", "covariances_", "weights_"):
        _close(getattr(pm, name), getattr(jm, name), rtol, atol)
    _close(pm.lower_bound_, jm.lower_bound_, rtol, atol)


@pytest.fixture(scope="module", params=COV_TYPES)
def pair(request):
    X = _data()
    kw = _kw(request.param, X)
    jm = kmeans_tpu.GaussianMixture(**kw).fit(X)
    pm = kmeans_tpu_torch.GaussianMixture(device="cpu", **kw).fit(X)
    return jm, pm, X, kw


def test_device_loop_matches_jax_float64(pair):
    jm, pm, X, _ = pair
    assert pm.loop_path_ == "device" and pm.estep_path_ == "serial"
    assert pm.n_iter_ == 10
    _same_fit(pm, jm)
    assert len(pm.iter_times_) == pm.n_iter_


def test_device_loop_posterior_matches_jax(pair):
    jm, pm, X, _ = pair
    np.testing.assert_array_equal(pm.predict(X), np.asarray(jm.predict(X)))
    _close(pm.score_samples(X), jm.score_samples(X))
    _close(pm.precisions_cholesky_, jm.precisions_cholesky_)


def test_device_loop_agrees_with_the_host_loop(pair):
    """The two loops run the same E-step; the M-step's dtype is the
    model's on the device and float64 on the host: in float64 they agree
    to ``rtol=1e-10``."""
    _, pm, X, kw = pair
    host = kmeans_tpu_torch.GaussianMixture(
        device="cpu", **{**kw, "host_loop": True}).fit(X)
    assert host.loop_path_ == "host"
    _same_fit(pm, host, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_convergence_stops_where_jax_stops(cov_type):
    X = _data()
    kw = _kw(cov_type, X, tol=1e-4, max_iter=60)
    jm = kmeans_tpu.GaussianMixture(**kw).fit(X)
    pm = kmeans_tpu_torch.GaussianMixture(device="cpu", **kw).fit(X)
    assert pm.converged_ and pm.n_iter_ < 60
    _same_fit(pm, jm)


@pytest.mark.parametrize("cov_type", ["diag", "full"])
def test_resume_carries_the_iteration_count_and_baseline(cov_type):
    """``fit(resume=True)`` by the device loop: the iteration counter goes
    on from ``n_iter_`` and ``lower_bound_`` is the convergence baseline
    (``prev0``); the parameters round-trip through the float64 fitted
    attributes, so the fit agrees with the uninterrupted one by
    tolerance."""
    X = _data()
    whole = kmeans_tpu_torch.GaussianMixture(
        device="cpu", **_kw(cov_type, X, max_iter=9)).fit(X)
    part = kmeans_tpu_torch.GaussianMixture(
        device="cpu", **_kw(cov_type, X, max_iter=5)).fit(X)
    part.set_params(max_iter=4)
    part.fit(X, resume=True)
    assert part.n_iter_ == whole.n_iter_ == 9
    _same_fit(part, whole, rtol=1e-10, atol=1e-10)
    # A baseline equal to the first resumed bound converges at once.
    part.set_params(max_iter=3, tol=1e30)
    part.fit(X, resume=True)
    assert part.converged_ and part.n_iter_ == 10


@pytest.mark.parametrize("cov_type", COV_TYPES)
@pytest.mark.parametrize("host_loop", [True, False])
def test_a_collapsed_component_fails_as_jax_fails(cov_type, host_loop):
    """The JAX package's test_reg_covar_zero_full_collapse_fails_loudly,
    every covariance type and both loops: a component of identical rows
    with ``reg_covar=0``.  'diag' cannot represent it and both loops raise
    naming the log-likelihood; 'full' raises the ill-defined-covariance
    error on the host loop and the non-finite log-likelihood on the device
    loop (its factorisation gives NaN); 'spherical' and 'tied' average the
    collapse away and fit.  The port raises where the JAX package raises,
    with the same message, and never returns NaNs."""
    rng = np.random.default_rng(2)
    X = np.concatenate([np.full((400, 4), 5.0),
                        rng.normal(size=(400, 4))]).astype(np.float32)
    kw = dict(n_components=2, covariance_type=cov_type, reg_covar=0.0,
              max_iter=15, seed=0, host_loop=host_loop)
    try:
        kmeans_tpu.GaussianMixture(**kw).fit(X)
        want = None
    except ValueError as e:
        want = str(e)
    gm = kmeans_tpu_torch.GaussianMixture(device="cpu", **kw)
    if want is None:
        gm.fit(X)
        assert np.isfinite(gm.lower_bound_)
        assert np.all(np.isfinite(gm.precisions_))
        return
    with pytest.raises(ValueError) as got:
        gm.fit(X)
    assert str(got.value) == want
    if not host_loop:
        assert isinstance(got.value, NumericalDivergenceError)


def test_pipelined_schedule_gives_the_same_bits():
    X = _data()
    runs = [kmeans_tpu_torch.GaussianMixture(
        device="cpu", chunk_size=50, **_kw("diag", X, pipeline=p)).fit(X)
        for p in (0, 1)]
    assert [m.estep_path_ for m in runs] == ["serial", "pipelined"]
    np.testing.assert_array_equal(runs[0].means_, runs[1].means_)
    np.testing.assert_array_equal(runs[0].covariances_, runs[1].covariances_)
    assert runs[0].lower_bound_ == runs[1].lower_bound_


def test_the_loop_lives_in_the_dataset_and_replays():
    """The loop's state is kept with the dataset: a second fit on it reuses
    the loop (the captured graph on the card) and gives the same bits; the
    loop holds the dataset's tensors, not the dataset (dropping it frees
    the loop, ROADMAP C.11)."""
    import gc
    import weakref
    X = _data(np.float32)
    gm = kmeans_tpu_torch.GaussianMixture(
        n_components=K, max_iter=6, tol=0.0, seed=1, host_loop=False,
        device="cpu")
    ds = gm._dataset(X)
    first = gm.fit(ds).means_.copy()
    loops = [v for v in ds._memo.values()
             if isinstance(v, gmm_step._EmLoop)]
    assert len(loops) == 1
    np.testing.assert_array_equal(gm.fit(ds).means_, first)
    assert [v for v in ds._memo.values()
            if isinstance(v, gmm_step._EmLoop)] == loops
    assert not any(isinstance(v, type(ds)) for v in vars(loops[0]).values())
    ref = weakref.ref(ds)
    del ds, loops
    gc.collect()
    assert ref() is None


# -------------------------------------------------------- batched restarts


@pytest.fixture(scope="module", params=["diag", "spherical"])
def multi(request):
    X = _data(np.float64, n=500, seed=9)
    kw = dict(n_components=K, covariance_type=request.param, max_iter=8,
              tol=0.0, seed=4, n_init=3, init_params="random",
              dtype=np.float64, host_loop=False)
    jm = kmeans_tpu.GaussianMixture(**kw).fit(X)
    pm = kmeans_tpu_torch.GaussianMixture(device="cpu", **kw).fit(X)
    return jm, pm, X, kw


def test_restarts_in_one_loop_match_jax(multi):
    jm, pm, X, _ = multi
    assert pm.loop_path_ == "device-multi"
    assert pm.best_restart_ == jm.best_restart_
    _close(pm.restart_lower_bounds_, jm.restart_lower_bounds_)
    _same_fit(pm, jm)


def test_each_restart_is_bit_equal_to_its_single_fit(multi):
    _, pm, X, kw = multi
    singles = []
    for seed in pm._restart_seeds():
        one = kmeans_tpu_torch.GaussianMixture(
            device="cpu", **{**kw, "n_init": 1, "seed": seed}).fit(X)
        singles.append(one)
    np.testing.assert_array_equal(pm.restart_lower_bounds_,
                                  [m.lower_bound_ for m in singles])
    win = singles[pm.best_restart_]
    for name in ("means_", "covariances_", "weights_"):
        np.testing.assert_array_equal(getattr(pm, name), getattr(win, name))


def test_a_diverged_restart_never_wins():
    """A member whose log-likelihood goes non-finite freezes at -inf and
    the survivors are kept (warning); the multi-fit builder's own
    contract."""
    X = _data()
    fit = gmm_step.make_gmm_multi_fit_fn(
        chunk_sizes=[64], max_iter=5, tol=0.0, reg_covar=1e-6)
    from kmeans_tpu_torch.parallel.sharding import to_device
    ds = to_device(X, torch.device("cpu"), np.float64)
    shift = torch.from_numpy(X.mean(0))
    means = torch.from_numpy(np.stack([X[:K], X[K:2 * K]]) - X.mean(0))
    var = torch.ones((2, K, D), dtype=torch.float64)
    log_w = torch.full((2, K), float(np.log(1.0 / K)), dtype=torch.float64)
    log_w[1, 0] = float("nan")
    res = fit(ds, shift, means, var, log_w, ks=[K, K])
    assert np.isfinite(res.final_lls[0]) and res.final_lls[1] == -np.inf
    assert res.best == 0 and res.n_iters[1] == 1 and res.n_iters[0] == 5
