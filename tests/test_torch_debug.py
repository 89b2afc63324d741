"""The port's determinism checker (``kmeans_tpu_torch/utils/debug.py``)
against the cases of the JAX package's ``tests/test_debug.py``, on the
port's models on the CPU (the kernel wrappers' plain versions): K-Means by
both loops and in every kernel mode, the empty-cluster resample, the
mini-batch with and without weights, the mixture; the checker detects a
nondeterministic factory, refuses bad arguments and an unsupported
``sample_weight``; and one configuration given to both packages' checkers
is deterministic in each, the two fits in the float64 parity class.  The
card's verdicts for kernels 1, 1b, 2, 2b and ``diag_estep`` come from
``chip_smoke.py``'s phase ``determinism``."""

import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu.data.synthetic import make_blobs  # noqa: E402
from kmeans_tpu.utils.debug import \
    check_determinism as jax_check  # noqa: E402
from kmeans_tpu_torch import (GaussianMixture, KMeans,  # noqa: E402
                              MiniBatchKMeans)
from kmeans_tpu_torch.utils.debug import (DeterminismReport,  # noqa: E402
                                          check_determinism)


@pytest.fixture()
def X():
    return make_blobs(3000, centers=5, n_features=6, random_state=3,
                      dtype=np.float32)[0]


@pytest.mark.parametrize("mode,host_loop", [
    ("kernel", True), ("kernel", False), ("kernel_bf16", True),
    ("matmul", True), ("matmul", False)])
def test_kmeans_deterministic(X, mode, host_loop):
    report = check_determinism(
        lambda: KMeans(k=5, seed=7, compute_sse=True, verbose=False,
                       device="cpu", distance_mode=mode,
                       host_loop=host_loop), X)
    assert isinstance(report, DeterminismReport)
    assert report["deterministic"], report
    assert report["runs"] == 2


def test_empty_cluster_resample_deterministic():
    # Forced empties (3 tight blobs, k=6) with the 'resample' policy: the
    # draws are seeded by (seed, iteration), so the runs agree.
    X = make_blobs(800, centers=3, n_features=2, cluster_std=0.5,
                   random_state=42, dtype=np.float32)[0]
    report = check_determinism(
        lambda: KMeans(k=6, seed=42, empty_cluster="resample",
                       verbose=False, device="cpu"), X, runs=3)
    assert report["deterministic"], report


@pytest.mark.parametrize("host_loop", [True, False])
def test_minibatch_deterministic(X, host_loop):
    report = check_determinism(
        lambda: MiniBatchKMeans(k=5, seed=3, batch_size=256, max_iter=8,
                                verbose=False, device="cpu",
                                host_loop=host_loop), X)
    assert report["deterministic"], report


def test_detects_nondeterminism(X):
    counter = itertools.count()

    def factory():
        # Another seed each run: the checker must see the divergence.
        return KMeans(k=5, seed=next(counter), verbose=False, device="cpu")

    report = check_determinism(factory, X)
    assert not report["deterministic"]
    assert "diverged" in report["details"] and report["runs"] == 2


def test_rejects_bad_args(X):
    with pytest.raises(ValueError, match="runs"):
        check_determinism(lambda: KMeans(k=2, verbose=False, device="cpu"),
                          X, runs=1)
    with pytest.raises(ValueError, match="verbose"):
        check_determinism(lambda: KMeans(k=2, device="cpu"), X)


def test_sample_weight_unsupported_model_clear_error(X):
    class NoWeights:
        verbose = False

        def fit(self, X):
            return self

    with pytest.raises(ValueError, match="sample_weight"):
        check_determinism(lambda: NoWeights(), X,
                          sample_weight=np.ones(X.shape[0], np.float32))


def test_minibatch_sample_weight_deterministic(X):
    w = np.ones(X.shape[0], np.float32)
    w[:100] = 3.0
    report = check_determinism(
        lambda: MiniBatchKMeans(k=3, seed=0, batch_size=128, max_iter=6,
                                verbose=False, device="cpu"), X,
        sample_weight=w)
    assert report["deterministic"], report


def test_sample_weight_supported(X):
    w = np.ones(X.shape[0], np.float32)
    w[:100] = 2.0
    report = check_determinism(
        lambda: KMeans(k=5, seed=2, verbose=False, device="cpu",
                       bucket="auto"), X, sample_weight=w)
    assert report["deterministic"], report


@pytest.mark.parametrize("cov_type,host_loop", [("full", True),
                                                ("diag", False)])
def test_determinism_checker_covers_gmm(cov_type, host_loop):
    X, _ = make_blobs(600, centers=3, n_features=4, random_state=0,
                      dtype=np.float32)
    rep = check_determinism(
        lambda: GaussianMixture(n_components=3, seed=0, max_iter=10,
                                covariance_type=cov_type,
                                host_loop=host_loop, device="cpu"), X)
    assert rep["deterministic"], rep


def test_one_configuration_in_both_packages(mesh1):
    """The same factory configuration through both packages' checkers:
    deterministic in each, and the two fits in the float64 parity class
    (labels and iterations equal, centroids to 1e-10)."""
    X = make_blobs(1500, centers=5, n_features=6, random_state=8,
                   dtype=np.float64)[0]
    kw = dict(k=5, seed=11, compute_sse=True, verbose=False,
              dtype=np.float64, distance_mode="matmul", max_iter=20,
              empty_cluster="resample")
    fits = {}

    def port():
        fits["port"] = KMeans(device="cpu", **kw)
        return fits["port"]

    def jax():
        fits["jax"] = kmeans_tpu.KMeans(mesh=mesh1, host_loop=True, **kw)
        return fits["jax"]

    assert check_determinism(port, X, runs=2)["deterministic"]
    assert jax_check(jax, X, runs=2)["deterministic"]
    pm, jm = fits["port"], fits["jax"]
    assert pm.iterations_run == jm.iterations_run
    np.testing.assert_array_equal(pm.predict(X), np.asarray(jm.predict(X)))
    np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids),
                               rtol=0, atol=1e-10)
