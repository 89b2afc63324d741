"""The port's on-device generators (``data.synthetic.device_shards``,
``host_equivalent``, ``make_uniform``) against the JAX package's.

The port draws each value from an integer hash of ``(seed, row, column,
draw)``, where the JAX package draws with threefry, so the values differ by
design (ROADMAP.md, "Differences by design").  Held here:

* ``device_shards`` equals ``host_equivalent`` bit for bit (one device; the
  mesh case is in ``test_torch_large_k_mesh.py``), for every kind and both
  dtypes, and a row does not depend on how many rows are made;
* the distributions against the JAX package's generators at the same
  shape: per-column mean and variance for 'normal' and 'uniform' (within
  six standard errors of each other), blob membership ``row % k`` and the
  distance to the centre for 'blobs';
* ``make_uniform`` equals the JAX package's (the same NumPy draws), and the
  errors are the JAX package's.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu.data import synthetic as jsyn  # noqa: E402
from kmeans_tpu_torch import KMeans  # noqa: E402
from kmeans_tpu_torch.data import synthetic as psyn  # noqa: E402

N, D = 20_000, 8


def _centers(k=5, d=D):
    return (np.arange(k * d, dtype=np.float64).reshape(k, d) % 7) * 10.0


@pytest.mark.parametrize("kind", psyn.SYNTH_KINDS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_shards_equal_the_host_oracle(kind, dtype):
    centers = _centers() if kind == "blobs" else None
    host = psyn.host_equivalent(N, D, kind=kind, seed=9, dtype=dtype,
                                centers=centers, low=-2.0, high=3.0)
    ds = psyn.device_shards(N, D, kind=kind, seed=9, dtype=dtype,
                            centers=centers, low=-2.0, high=3.0,
                            device="cpu")
    assert host.dtype == np.dtype(dtype) and host.shape == (N, D)
    assert ds.points.numpy().tobytes() == host.tobytes()
    assert ds.host is None and ds.n == N and ds.mesh is None
    np.testing.assert_array_equal(ds.weights.numpy(), 1.0)
    # A prefix is the same rows: each row depends on (seed, row) only.
    assert psyn.host_equivalent(1000, D, kind=kind, seed=9, dtype=dtype,
                                centers=centers, low=-2.0,
                                high=3.0).tobytes() == host[:1000].tobytes()
    assert not np.array_equal(
        psyn.host_equivalent(1000, D, kind=kind, seed=10, dtype=dtype,
                             centers=centers, low=-2.0, high=3.0),
        host[:1000])


def test_generate_rows_pads_with_zero_rows_of_weight_zero():
    x, w = psyn.generate_rows(N - 3, 10, N, D, kind="blobs", seed=9,
                              dtype=np.float32, centers=_centers())
    host = psyn.host_equivalent(N, D, kind="blobs", seed=9,
                                centers=_centers())
    assert x[:3].numpy().tobytes() == host[-3:].tobytes()
    assert x[3:].numpy().tobytes() == np.zeros((7, D), np.float32).tobytes()
    np.testing.assert_array_equal(w.numpy(), [1, 1, 1] + [0] * 7)


def _jax_rows(kind, **kw):
    ds = jsyn.device_shards(N, D, kind=kind, seed=4, **kw)
    return np.asarray(ds.points)[:N]


@pytest.mark.parametrize("kind,low,high", [("normal", -1.0, 1.0),
                                           ("uniform", -1.0, 1.0),
                                           ("uniform", 2.0, 5.0)])
def test_moments_match_the_references(kind, low, high):
    ours = psyn.host_equivalent(N, D, kind=kind, seed=4, low=low, high=high)
    theirs = _jax_rows(kind, low=low, high=high)
    var = 1.0 if kind == "normal" else (high - low) ** 2 / 12.0
    se_mean = np.sqrt(2 * var / N)
    np.testing.assert_array_less(np.abs(ours.mean(0) - theirs.mean(0)),
                                 6 * se_mean)
    # Variance of a sample variance: (mu4 - var^2) / N per sample.
    mu4 = 3 * var ** 2 if kind == "normal" else (high - low) ** 4 / 80.0
    se_var = np.sqrt(2 * (mu4 - var ** 2) / N)
    np.testing.assert_array_less(np.abs(ours.var(0) - theirs.var(0)),
                                 6 * se_var)
    if kind == "uniform":
        assert ours.min() >= low and ours.max() < high
        assert theirs.min() >= low and theirs.max() < high


def test_blobs_match_the_references():
    centers = _centers()
    ours = psyn.host_equivalent(N, D, kind="blobs", seed=4, centers=centers)
    theirs = _jax_rows("blobs", centers=centers)
    idx = np.arange(N)
    for rows in (ours, theirs):
        d2 = ((rows[:, None, :] - centers[None]) ** 2).sum(-1)
        np.testing.assert_array_equal(np.argmin(d2, 1), idx % 5)
    dist_ours = np.linalg.norm(ours - centers[idx % 5], axis=1)
    dist_theirs = np.linalg.norm(theirs - centers[idx % 5], axis=1)
    assert abs(dist_ours.mean() - dist_theirs.mean()) < \
        6 * dist_theirs.std() / np.sqrt(N / 2)
    assert abs(dist_ours.var() - dist_theirs.var()) < 0.05 * \
        dist_theirs.var()


def test_make_uniform_is_the_references():
    np.testing.assert_array_equal(
        psyn.make_uniform(300, 7, low=-3.0, high=4.0, random_state=5),
        jsyn.make_uniform(300, 7, low=-3.0, high=4.0, random_state=5))
    assert psyn.make_uniform(10, 2, dtype=np.float64).dtype == np.float64


@pytest.mark.parametrize("kw", [dict(kind="gauss"), dict(kind="blobs"),
                                dict(kind="blobs",
                                     centers=np.zeros((3, D + 1)))])
def test_errors_are_the_references(kw):
    with pytest.raises(ValueError) as ours:
        psyn.host_equivalent(10, D, **kw)
    with pytest.raises(ValueError) as theirs:
        jsyn.host_equivalent(10, D, **kw)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError):
        psyn.device_shards(10, D, device="cpu", **kw)


def test_device_shards_records_its_chunk_and_refuses_min_rows():
    """The chunk it records; ``min_rows`` (ported since, the bucket's
    padding) adds zero rows of weight 0 after the real ones, inert: a fit
    on the padded rows is the fit on the real ones."""
    ds = psyn.device_shards(5000, D, device="cpu")
    assert (ds.chunk, ds.explicit_chunk) == (5000, False)
    ds = psyn.device_shards(5000, D, device="cpu", chunk_size=512)
    assert (ds.chunk, ds.explicit_chunk) == (512, True)
    pad = psyn.device_shards(5000, D, device="cpu", min_rows=8192)
    assert pad.n == 5000 and pad.points.shape == (8192, D)
    assert pad.chunk == 8192
    torch.testing.assert_close(pad.points[:5000], ds.points, rtol=0, atol=0)
    assert torch.all(pad.points[5000:] == 0)
    assert pad.weights[:5000].sum() == 5000 and pad.weights[5000:].sum() == 0
    init = ds.points[:6].numpy().copy()
    kw = dict(k=6, init=init, max_iter=4, verbose=False, device="cpu",
              compute_sse=True)
    a = KMeans(**kw).fit(ds)
    b = KMeans(**kw).fit(pad)
    np.testing.assert_allclose(b.centroids, a.centroids, rtol=1e-5,
                               atol=1e-6)
    assert b.iterations_run == a.iterations_run
    assert b.labels_.shape == (5000,)
    np.testing.assert_array_equal(b.labels_, a.labels_)


def test_a_fit_on_generated_rows():
    """A dataset with no host copy: Forgy draws its rows on the device, and
    the fit is that of the same rows given as an array, seeded alike."""
    centers = _centers()
    ds = psyn.device_shards(N, D, kind="blobs", seed=1, centers=centers,
                            device="cpu")
    init = ds.points[:5].numpy().copy()
    kw = dict(k=5, init=init, max_iter=10, compute_sse=True, verbose=False,
              device="cpu")
    km = KMeans(**kw).fit(ds)
    ref = KMeans(**kw).fit(psyn.host_equivalent(N, D, kind="blobs", seed=1,
                                                centers=centers))
    np.testing.assert_array_equal(km.centroids, ref.centroids)
    forgy = KMeans(k=5, max_iter=10, verbose=False, device="cpu").fit(ds)
    assert forgy.centroids.shape == (5, D)
    assert np.all(np.isfinite(forgy.centroids))
