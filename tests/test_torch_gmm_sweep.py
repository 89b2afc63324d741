"""``kmeans_tpu_torch.GaussianMixture.sweep`` against the JAX package's
mixture sweep on the CPU.

Float64, ``init_params='random'`` (the same host draws in both packages):
the same selected k and winning restarts, the criterion values and the
member lower bounds to ``rtol=1e-12`` / ``atol=1e-10``.  Within the port,
the batched sweep (every member in one device loop, padded to k_max with
inert components) and the sequential oracle (``batched=0``, one device
loop fit per member) give bit-equal member lower bounds and pick the same
k: each batched member runs its single fit's iteration at its own k.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402

RTOL, ATOL = 1e-12, 1e-10
KS = [2, 3, 4]


def _data(n=300, d=3, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, d)) * 3.0
    return centers[rng.integers(0, 4, n)] + rng.normal(size=(n, d))


def _kw(cov_type, **extra):
    kw = dict(covariance_type=cov_type, max_iter=6, tol=0.0, seed=3,
              n_init=2, init_params="random", dtype=np.float64)
    kw.update(extra)
    return kw


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("criterion", ["bic", "aic"])
@pytest.mark.parametrize("cov_type", ["diag", "spherical"])
def test_sweep_matches_jax(cov_type, criterion, batched):
    X = _data()
    kw = _kw(cov_type)
    want = kmeans_tpu.GaussianMixture(**kw).sweep(
        X, k_range=KS, criterion=criterion, batched=batched)
    got = kmeans_tpu_torch.GaussianMixture(device="cpu", **kw).sweep(
        X, k_range=KS, criterion=criterion, batched=batched)
    assert got.family == "gmm" and got.batched == bool(batched)
    assert got.selected_k == want.selected_k
    assert got.selected_restart == want.selected_restart
    _close(got.scores, want.scores)
    _close(got.member_scores, want.member_scores)
    np.testing.assert_array_equal(got.n_iters, want.n_iters)
    best = got.best_model
    assert best.n_components == got.selected_k
    _close(best.means_, want.best_model.means_)
    _close(best.covariances_, want.best_model.covariances_)
    np.testing.assert_array_equal(best.predict(X),
                                  np.asarray(want.best_model.predict(X)))


@pytest.mark.parametrize("cov_type", ["diag", "spherical"])
def test_batched_members_are_bit_equal_to_the_sequential_oracle(cov_type):
    X = _data(seed=8)
    kw = _kw(cov_type, n_init=1, seed=11)
    batched = kmeans_tpu_torch.GaussianMixture(device="cpu", **kw).sweep(
        X, k_range=KS, batched=True)
    oracle = kmeans_tpu_torch.GaussianMixture(device="cpu", **kw).sweep(
        X, k_range=KS, batched=False)
    np.testing.assert_array_equal(batched.member_scores,
                                  oracle.member_scores)
    np.testing.assert_array_equal(batched.n_iters, oracle.n_iters)
    assert batched.selected_k == oracle.selected_k
    assert batched.n_dispatches == 1 and oracle.n_dispatches == 2 * len(KS)
    assert batched.best_model.loop_path_ == "device-sweep"
    for name in ("means_", "covariances_", "weights_"):
        np.testing.assert_array_equal(
            getattr(batched.best_model, name),
            getattr(oracle.best_model, name))


def test_full_and_tied_sweep_sequentially_with_a_warning():
    X = _data()
    for cov_type in ("full", "tied"):
        kw = _kw(cov_type, n_init=1)
        with pytest.warns(UserWarning, match="sequential path"):
            got = kmeans_tpu_torch.GaussianMixture(device="cpu", **kw).sweep(
                X, k_range=KS)
        with pytest.warns(UserWarning, match="sequential path"):
            want = kmeans_tpu.GaussianMixture(**kw).sweep(X, k_range=KS)
        assert not got.batched and got.selected_k == want.selected_k
        _close(got.scores, want.scores)


def test_sweep_refusals():
    X = _data()
    gm = kmeans_tpu_torch.GaussianMixture(device="cpu", **_kw("diag"))
    with pytest.raises(ValueError, match="criterion"):
        gm.sweep(X, k_range=KS, criterion="inertia")
    with pytest.raises(ValueError, match="k_max"):
        gm.sweep(X[:4], k_range=[2, 4])
    with pytest.raises(ValueError, match="data-driven"):
        kmeans_tpu_torch.GaussianMixture(
            n_components=2, device="cpu",
            means_init=X[:2]).sweep(X, k_range=KS)
