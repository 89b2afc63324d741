"""``GaussianMixture`` with the fit-shape bucket and the overlapped set-up,
against the JAX package's ``GaussianMixture(bucket=, overlap=)`` on the CPU.

The float64 parity class of ``tests/test_torch_gmm.py``: the same data and
the same initial parameters, the same ``n_iter_`` and labels, ``means_``,
``covariances_``, ``weights_`` and ``lower_bound_`` to ``rtol=1e-9``.  The
bucket's rows are inert (weight 0), so ``bucket='auto'`` is held to the
JAX package's bucketed fit and to the port's exact-shape one; ``overlap=1``
to ``overlap=0`` bit for bit.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu.data.synthetic import make_blobs  # noqa: E402
from kmeans_tpu_torch.parallel.sharding import bucket_rows  # noqa: E402
from kmeans_tpu_torch.utils.profiling import \
    recompilation_sentinel  # noqa: E402

K, D = 3, 5


def _data(n, seed=0):
    X, _ = make_blobs(n, K, D, random_state=seed, dtype=np.float64)
    return X


def _init(X, cov_type, seed=0):
    rng = np.random.default_rng(seed)
    means = X[rng.choice(len(X), K, replace=False)].astype(np.float64)
    prec = {"diag": np.ones((K, D)), "spherical": np.ones(K),
            "full": np.stack([np.eye(D)] * K), "tied": np.eye(D)}[cov_type]
    return dict(means_init=means, weights_init=np.full(K, 1.0 / K),
                precisions_init=prec)


def _args(X, cov_type, **kw):
    return dict(n_components=K, covariance_type=cov_type, max_iter=10,
                tol=0.0, reg_covar=1e-6, dtype=np.float64,
                **_init(X, cov_type), **kw)


def _same(a, b):
    return (a.n_iter_ == b.n_iter_
            and all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in ("means_", "covariances_", "weights_"))
            and a.lower_bound_ == b.lower_bound_)


@pytest.mark.parametrize("cov_type,host_loop", [
    ("diag", True), ("diag", False), ("spherical", False), ("full", True)])
def test_bucket_auto_matches_the_jax_package(cov_type, host_loop):
    X = _data(1100, seed=4)
    assert bucket_rows(1100) == 1280
    args = _args(X, cov_type, bucket="auto")
    jm = kmeans_tpu.GaussianMixture(**args).fit(X)
    pm = kmeans_tpu_torch.GaussianMixture(device="cpu", host_loop=host_loop,
                                          **args).fit(X)
    assert pm.n_iter_ == jm.n_iter_ == 10
    for name in ("means_", "covariances_", "weights_"):
        np.testing.assert_allclose(getattr(pm, name),
                                   np.asarray(getattr(jm, name)),
                                   rtol=1e-9, err_msg=name)
    np.testing.assert_allclose(pm.lower_bound_, jm.lower_bound_, rtol=1e-9)
    np.testing.assert_array_equal(pm.predict(X), np.asarray(jm.predict(X)))
    assert pm.score_samples(X).shape == (1100,)
    # The padding is inert: the exact-shape fit, to the same class.
    exact = kmeans_tpu_torch.GaussianMixture(
        device="cpu", host_loop=host_loop, **_args(X, cov_type)).fit(X)
    np.testing.assert_allclose(pm.means_, exact.means_, rtol=1e-9)
    np.testing.assert_allclose(pm.lower_bound_, exact.lower_bound_,
                               rtol=1e-9)


@pytest.mark.parametrize("host_loop", [True, False])
def test_overlap_and_bucket0_are_bit_exact(host_loop):
    X = _data(900, seed=6)
    base = kmeans_tpu_torch.GaussianMixture(
        device="cpu", host_loop=host_loop, **_args(X, "diag")).fit(X)
    for kw in (dict(overlap=1), dict(overlap=0), dict(bucket=0),
               dict(overlap=1, bucket=0)):
        got = kmeans_tpu_torch.GaussianMixture(
            device="cpu", host_loop=host_loop, **_args(X, "diag", **kw)
        ).fit(X)
        assert _same(got, base), kw
    lapped = kmeans_tpu_torch.GaussianMixture(
        device="cpu", host_loop=host_loop,
        **_args(X, "diag", overlap=1, bucket="auto")).fit(X)
    serial = kmeans_tpu_torch.GaussianMixture(
        device="cpu", host_loop=host_loop,
        **_args(X, "diag", overlap=0, bucket="auto")).fit(X)
    assert _same(lapped, serial)


def test_same_bucket_repeat_fit_builds_nothing():
    def fit(n, seed):
        X = _data(n, seed)
        return kmeans_tpu_torch.GaussianMixture(
            device="cpu", host_loop=False, bucket="auto",
            **_args(X, "diag")).fit(X)
    assert bucket_rows(1030) == bucket_rows(1100)
    fit(1030, 1)
    with recompilation_sentinel() as rec:
        fit(1100, 2)
    assert rec["new"] == {}


def test_mixture_dataset_is_padded_inert():
    X = _data(700)
    gm = kmeans_tpu_torch.GaussianMixture(n_components=K, device="cpu",
                                          bucket="auto")
    ds = gm._dataset(X)
    assert ds.n == 700 and ds.points.shape[0] == bucket_rows(700) == 768
    assert float(ds.weights[700:].sum()) == 0.0
    assert gm._chunk(ds) == gm._em_chunk(700, D)
