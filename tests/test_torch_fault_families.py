"""Kill and resume in every family of kmeans_tpu_torch, and across packages.

Inside the port, on the CPU: a fit killed at a checkpoint boundary
(``utils.faults.inject_kill_after_iteration``) and resumed from its file by
a fresh model gives the bits of the uninterrupted fit, and so does a
segmented fit, in ``KMeans`` (both loops, the kernel modes through their
plain versions and 'matmul'), ``SphericalKMeans``, ``BisectingKMeans``
(split-boundary checkpoints with the split tree), ``MiniBatchKMeans`` (the
three engines) and ``GaussianMixture`` (all four covariance types, both
loops; the device loop through its ``dev_*`` tables).

Across packages: the JAX package is killed by its own
``inject_kill_after_iteration`` and the port resumes from that file, and
the reverse; each is held to the uninterrupted JAX fit in float64
(``rtol=1e-12``, ``atol=1e-10``, equal iteration counts).  Every file is
written under ``tmp_path``.
"""

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch as kt  # noqa: E402
from kmeans_tpu.models import (BisectingKMeans as JxBisecting,  # noqa: E402
                               GaussianMixture as JxGmm)
from kmeans_tpu.utils import checkpoint as jx_ckpt  # noqa: E402
from kmeans_tpu.utils import faults as jx_faults  # noqa: E402
from kmeans_tpu_torch import convert  # noqa: E402
from kmeans_tpu_torch.models import fault_tolerance as pt_ft  # noqa: E402
from kmeans_tpu_torch.parallel.sharding import to_device  # noqa: E402
from kmeans_tpu_torch.utils import checkpoint as pt_ckpt  # noqa: E402
from kmeans_tpu_torch.utils import faults as pt_faults  # noqa: E402

RTOL, ATOL = 1e-12, 1e-10


def _blobs(n=2000, d=3, centers=4, rs=9, dtype=np.float32):
    X, _ = make_blobs(n_samples=n, centers=centers, n_features=d,
                      random_state=rs)
    return X.astype(dtype)


def _killed(make, j, fit, faults=pt_faults):
    """``fit(make())`` with a kill armed at boundary ``j``; it must fire."""
    with faults.inject_kill_after_iteration(j) as rec:
        with pytest.raises(faults.SimulatedPreemption):
            fit(make())
    assert rec["fired_at"] == j


def _same_kmeans(a, b):
    assert a.iterations_run == b.iterations_run
    np.testing.assert_array_equal(a.centroids, b.centroids)
    assert list(a.sse_history) == list(b.sse_history)


def _same_gmm(a, b):
    assert a.n_iter_ == b.n_iter_ and a.converged_ == b.converged_
    assert a.lower_bound_ == b.lower_bound_
    for name in ("weights_", "means_", "covariances_"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def _close_gmm(a, b):
    assert a.n_iter_ == b.n_iter_
    np.testing.assert_allclose(a.lower_bound_, b.lower_bound_, rtol=RTOL)
    for name in ("weights_", "means_", "covariances_"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                   rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- KMeans


@pytest.mark.parametrize("mode", ["kernel", "kernel_bf16", "matmul"])
@pytest.mark.parametrize("host_loop", [True, False])
def test_kmeans_kill_and_resume_is_bit_exact(mode, host_loop, tmp_path):
    X = _blobs()
    kw = dict(k=4, max_iter=25, tolerance=1e-12, seed=1, compute_sse=True,
              verbose=False, device="cpu", distance_mode=mode,
              host_loop=host_loop, empty_cluster="resample")
    full = kt.KMeans(**kw).fit(X)
    path = tmp_path / "c.npz"
    _killed(lambda: kt.KMeans(**kw), 4,
            lambda m: m.fit(X, checkpoint_every=2, checkpoint_path=path))
    state = pt_ckpt.load_state(path)
    assert state["iterations_run"] == 4
    assert pt_ckpt._load_state_at(pt_ckpt.prev_path(path))[
        "iterations_run"] == 2
    resumed = kt.KMeans(**kw).fit(X, resume=path)
    _same_kmeans(resumed, full)
    np.testing.assert_array_equal(resumed.labels_, full.labels_)


@pytest.mark.parametrize("host_loop", [True, False])
def test_spherical_kill_and_resume_projects_as_the_uninterrupted_fit(
        host_loop, tmp_path):
    X = _blobs(n=2000, d=8, centers=12, rs=4)
    kw = dict(k=10, max_iter=20, tolerance=1e-12, seed=3, compute_sse=True,
              verbose=False, device="cpu", host_loop=host_loop)
    full = kt.SphericalKMeans(**kw).fit(X)
    assert full.iterations_run > 4
    path = tmp_path / "s.npz"
    _killed(lambda: kt.SphericalKMeans(**kw), 4,
            lambda m: m.fit(X, checkpoint_every=2, checkpoint_path=path))
    resumed = kt.SphericalKMeans(**kw).fit(X, resume=path)
    _same_kmeans(resumed, full)
    np.testing.assert_allclose(np.linalg.norm(resumed.centroids, axis=1),
                               1.0, rtol=1e-6)


@pytest.mark.parametrize("host_loop", [True, False])
def test_bisecting_resumes_the_split_tree(host_loop, tmp_path):
    X = _blobs()
    kw = dict(k=6, max_iter=20, tolerance=1e-10, seed=7, compute_sse=True,
              verbose=False, device="cpu", host_loop=host_loop)
    full = kt.BisectingKMeans(**kw).fit(X)
    path = tmp_path / "b.npz"
    _killed(lambda: kt.BisectingKMeans(**kw), 2,
            lambda m: m.fit(X, checkpoint_every=2, checkpoint_path=path))
    state = pt_ckpt.load_state(path)
    assert state["tree_labels"].shape == (X.shape[0],)
    assert state["tree_splits_done"] == 2 and state["tree_cents"].shape \
        == (3, 3)
    resumed = kt.BisectingKMeans(**kw).fit(X, resume=path)
    assert resumed.iterations_run == full.iterations_run == 5
    assert len(resumed.split_iterations_) == 3
    np.testing.assert_array_equal(resumed.centroids, full.centroids)
    np.testing.assert_array_equal(resumed.labels_, full.labels_)
    np.testing.assert_array_equal(resumed.cluster_sse_, full.cluster_sse_)
    assert resumed.sse_history == full.sse_history
    seg = kt.BisectingKMeans(**kw).fit(X, checkpoint_every=2,
                                      checkpoint_path=tmp_path / "t")
    assert seg.checkpoint_segments_ == 3          # splits 2, 4 and 5
    np.testing.assert_array_equal(seg.labels_, full.labels_)
    with pytest.raises(ValueError, match="built on 2000 rows"):
        kt.BisectingKMeans(**kw).fit(X[:1000], resume=path)


@pytest.mark.parametrize("engine", [("device", True), ("device", False),
                                    ("host", True)])
def test_minibatch_kill_and_resume_in_every_engine(engine, tmp_path):
    sampling, host_loop = engine
    X = _blobs()
    kw = dict(k=4, max_iter=24, tolerance=1e-12, seed=3, batch_size=256,
              compute_sse=True, verbose=False, device="cpu",
              sampling=sampling, host_loop=host_loop)
    full = kt.MiniBatchKMeans(**kw).fit(X)
    seg = kt.MiniBatchKMeans(**kw).fit(X, checkpoint_every=5,
                                       checkpoint_path=tmp_path / "s")
    _same_kmeans(seg, full)
    assert seg.checkpoint_segments_ == 5
    path = tmp_path / "m.npz"
    _killed(lambda: kt.MiniBatchKMeans(**kw), 10,
            lambda m: m.fit(X, checkpoint_every=5, checkpoint_path=path))
    resumed = kt.MiniBatchKMeans(**kw).fit(X, resume=path)
    _same_kmeans(resumed, full)
    np.testing.assert_array_equal(resumed._seen, full._seen)


def test_partial_fit_divergence_keeps_the_incremental_progress(tmp_path):
    """``partial_fit`` is no checkpointed fit: a diverging batch raises
    in place and never restores the file an earlier ``fit`` left."""
    X = _blobs()
    m = kt.MiniBatchKMeans(k=4, max_iter=4, batch_size=256, verbose=False,
                           device="cpu", sampling="host")
    m.fit(X, checkpoint_every=2, checkpoint_path=tmp_path / "p")
    m.partial_fit(X[:300])
    progress = m.centroids.copy()
    bad = X[:300].copy()
    bad[:] = np.nan
    with pytest.raises(pt_ft.NumericalDivergenceError) as err:
        m.partial_fit(bad)
    assert err.value.rolled_back_to is None
    np.testing.assert_array_equal(m.centroids, progress)


# -------------------------------------------------------------- mixture


@pytest.mark.parametrize("cov_type", ["diag", "spherical", "full", "tied"])
@pytest.mark.parametrize("host_loop", [True, False])
def test_gmm_segmented_and_resumed_are_bit_exact(cov_type, host_loop,
                                                 tmp_path):
    """EM killed at iteration 3 and resumed for the 5 iterations left
    (``resume`` runs up to ``max_iter`` more); the device loop resumes from
    its raw tables (``dev_*``)."""
    X = _blobs(dtype=np.float64)
    kw = dict(n_components=4, covariance_type=cov_type, tol=0.0,
              max_iter=8, init_params="random", seed=0, device="cpu",
              host_loop=host_loop, dtype=np.float64)
    full = kt.GaussianMixture(**kw).fit(X)
    seg = kt.GaussianMixture(**kw).fit(X, checkpoint_every=3,
                                       checkpoint_path=tmp_path / "s")
    _same_gmm(seg, full)
    assert seg.checkpoint_segments_ == 3
    path = tmp_path / "g.npz"
    _killed(lambda: kt.GaussianMixture(**kw), 3,
            lambda m: m.fit(X, checkpoint_every=3, checkpoint_path=path))
    state = pt_ckpt.load_state(path)
    assert state["n_iter_"] == 3
    assert ("dev_means_c" in state) == (not host_loop)
    resumed = kt.GaussianMixture(**dict(kw, max_iter=5)).fit(X,
                                                            resume=path)
    _same_gmm(resumed, full)


def test_gmm_divergence_rolls_back_to_the_last_checkpoint(tmp_path):
    X = _blobs(dtype=np.float64)
    kw = dict(n_components=4, tol=0.0, max_iter=4, init_params="random",
              seed=0, device="cpu", host_loop=False, dtype=np.float64)
    path = tmp_path / "g.npz"
    kt.GaussianMixture(**kw).fit(X, checkpoint_every=2, checkpoint_path=path)
    good = pt_ckpt.load_state(path)
    bad = X.copy()
    bad[7] = np.inf
    # A cached dataset: the fit scans only array inputs for non-finite rows.
    bad = to_device(bad, torch.device("cpu"), np.float64)
    m = kt.GaussianMixture(**kw)
    with pytest.raises(pt_ft.NumericalDivergenceError) as err:
        m.fit(bad, resume=path, checkpoint_every=2, checkpoint_path=path)
    assert err.value.quantity == "log-likelihood"
    assert err.value.iteration == 5 and err.value.rolled_back_to == 4
    np.testing.assert_array_equal(m.means_, good["means_"])


# -------------------------------------------------------- across packages


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("host_loop", [True, False])
def test_kmeans_resumes_across_packages(direction, host_loop, mesh1,
                                        tmp_path):
    X = _blobs(dtype=np.float64)
    kw = dict(k=4, max_iter=25, tolerance=1e-12, seed=1, compute_sse=True,
              verbose=False, dtype=np.float64, distance_mode="matmul",
              host_loop=host_loop)
    full = kmeans_tpu.KMeans(mesh=mesh1, **kw).fit(X)
    path = tmp_path / "x.npz"
    jax = lambda: kmeans_tpu.KMeans(mesh=mesh1, **kw)     # noqa: E731
    port = lambda: kt.KMeans(device="cpu", **kw)          # noqa: E731
    writer, reader, faults = ((jax, port, jx_faults)
                              if direction == "jax_to_port"
                              else (port, jax, pt_faults))
    _killed(writer, 6, lambda m: m.fit(X, checkpoint_every=3,
                                       checkpoint_path=path), faults)
    resumed = reader().fit(X, resume=path)
    assert resumed.iterations_run == full.iterations_run
    np.testing.assert_allclose(resumed.centroids, full.centroids,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(resumed.sse_history, full.sse_history,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("host_loop", [True, False])
def test_gmm_resumes_across_packages(direction, host_loop, mesh1, tmp_path):
    """The device loop's checkpoint carries the raw tables in the shared
    ``dev_*`` layout, which either package resumes from."""
    X = _blobs(dtype=np.float64)
    kw = dict(n_components=4, tol=0.0, max_iter=8, init_params="random",
              seed=0, host_loop=host_loop, dtype=np.float64)
    full = JxGmm(mesh=mesh1, **kw).fit(X)
    path = tmp_path / "g.npz"
    jax = lambda **o: JxGmm(mesh=mesh1, **dict(kw, **o))  # noqa: E731
    port = lambda **o: kt.GaussianMixture(          # noqa: E731
        device="cpu", **dict(kw, **o))
    writer, reader, faults = ((jax, port, jx_faults)
                              if direction == "jax_to_port"
                              else (port, jax, pt_faults))
    _killed(writer, 4, lambda m: m.fit(X, checkpoint_every=2,
                                       checkpoint_path=path), faults)
    assert ("dev_means_c" in jx_ckpt.load_state(path)) == (not host_loop)
    resumed = reader(max_iter=4).fit(X, resume=path)
    _close_gmm(resumed, full)


def test_bisecting_resumes_a_jax_split_tree(mesh1, tmp_path):
    X = _blobs(dtype=np.float64)
    kw = dict(k=6, max_iter=20, tolerance=1e-10, seed=7, compute_sse=True,
              verbose=False, dtype=np.float64, distance_mode="matmul",
              host_loop=True)
    full = JxBisecting(mesh=mesh1, **kw).fit(X)
    path = tmp_path / "b.npz"
    _killed(lambda: JxBisecting(mesh=mesh1, **kw), 2,
            lambda m: m.fit(X, checkpoint_every=2, checkpoint_path=path),
            jx_faults)
    resumed = kt.BisectingKMeans(device="cpu", **kw).fit(X, resume=path)
    assert resumed.iterations_run == full.iterations_run
    np.testing.assert_allclose(resumed.centroids, full.centroids,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(resumed.labels_, full.labels_)


def test_from_jax_state_reads_the_rotating_checkpoints(mesh1, tmp_path):
    """A JAX package checkpoint of a segmented fit, through
    ``convert.from_jax_state``: the mixture's ``dev_*`` tables, the split
    tree and the mini-batch counts come with it."""
    X = _blobs(dtype=np.float64)
    JxGmm(n_components=3, max_iter=4, tol=0.0, init_params="random",
          seed=0, host_loop=False, dtype=np.float64, mesh=mesh1).fit(
        X, checkpoint_every=2, checkpoint_path=tmp_path / "g")
    gm = convert.from_jax_state(
        pt_ckpt.load_state_with_fallback(tmp_path / "g")[0], device="cpu")
    assert gm._dev_tables["means_c"].shape == (3, 3)
    assert gm._dev_tables["cov_type"] == "diag" and gm.n_iter_ == 4
    JxBisecting(k=4, seed=7, dtype=np.float64, mesh=mesh1,
                verbose=False).fit(X, checkpoint_every=1,
                                   checkpoint_path=tmp_path / "b")
    bm = convert.from_jax_state(pt_ckpt.load_state(tmp_path / "b"),
                                device="cpu")
    assert bm._tree_state["splits_done"] == 3
    assert bm._tree_state["labels"].shape == (X.shape[0],)
    kmeans_tpu.MiniBatchKMeans(k=4, max_iter=6, batch_size=256, seed=3,
                               dtype=np.float64, mesh=mesh1,
                               verbose=False).fit(
        X, checkpoint_every=3, checkpoint_path=tmp_path / "m")
    mm = convert.from_jax_state(pt_ckpt.load_state(tmp_path / "m"),
                                device="cpu")
    assert mm.iterations_run == 6 and mm._seen.sum() > 0
