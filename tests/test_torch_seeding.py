"""k-means++ with its draws on the device (``models.init.
_kmeanspp_device_draws``) against the per-draw host version
(``_kmeanspp_host_draws``) and the JAX package's ``kmeanspp_init``.

``numpy.random.Generator.choice(n, p=p)`` takes one ``random()`` and
returns ``searchsorted(cdf, u, side='right')``; the device version inverts
the same float64 CDF with the same uniforms, so the chosen rows are equal
(they could differ only where a uniform falls within rounding of a CDF
step, which these seeds do not hit).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu.models import init as jx_init  # noqa: E402
from kmeans_tpu_torch.models import init as pt_init  # noqa: E402
from kmeans_tpu_torch.parallel.sharding import to_device  # noqa: E402


def _data(n, d, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-5, 5, size=(12, d))
    return (means[rng.integers(0, 12, n)]
            + rng.standard_normal((n, d))).astype(dtype)


def test_choice_is_a_cdf_inversion_with_one_uniform():
    """The property the device draws rest on, checked on the installed
    NumPy."""
    rng = np.random.default_rng(0)
    p = rng.random(500) ** 3
    p[::7] = 0.0
    p /= p.sum()
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(20):
        cdf = np.cumsum(p)
        cdf /= cdf[-1]
        assert a.choice(500, p=p) == np.searchsorted(cdf, b.random(),
                                                     side="right")
    assert a.random() == b.random()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("weighted", [False, True])
def test_device_draws_are_the_host_draws(weighted, dtype):
    X = _data(3000, 8, dtype=dtype)
    w = np.ones(3000)
    if weighted:
        w = np.random.default_rng(1).random(3000)
        w[::5] = 0.0
    pts = torch.from_numpy(X)
    wt = torch.from_numpy(w.astype(dtype))
    got = pt_init._kmeanspp_device_draws(pts, wt, 25,
                                         np.random.default_rng(3))
    want = pt_init._kmeanspp_host_draws(None, w, 25,
                                        np.random.default_rng(3), points=pts)
    np.testing.assert_array_equal(got.numpy(), want)
    assert all(w[i] > 0 for i in want)
    np.testing.assert_array_equal(
        pt_init._weighted_kmeanspp_device(pts, wt, 25,
                                          np.random.default_rng(3)),
        X[want])


def test_degenerate_branch_draws_by_the_weights():
    """Coincident points: every D^2 mass is 0, so each draw after the
    first falls back to the weights, one uniform each, on both sides."""
    X = np.tile(_data(1, 4), (400, 1))
    w = np.random.default_rng(2).random(400)
    pts = torch.from_numpy(X)
    got = pt_init._kmeanspp_device_draws(pts, torch.from_numpy(w), 6,
                                         np.random.default_rng(8))
    want = pt_init._kmeanspp_host_draws(None, w, 6, np.random.default_rng(8),
                                        points=pts)
    np.testing.assert_array_equal(got.numpy(), want)


def test_large_data_seeds_on_the_device_with_the_jax_rows():
    """Above ``_HOST_KMEANSPP_ELEMS`` a dataset with a host copy seeds on
    the device; its rows are the JAX package's, which draws on the host."""
    X = _data(66_000, 64)
    assert X.size > pt_init._HOST_KMEANSPP_ELEMS
    ds = to_device(X, torch.device("cpu"), np.float32)
    got = pt_init.kmeanspp_init(ds, 6, 11)
    want = jx_init.kmeanspp_init(X, 6, 11)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_no_value_reaches_the_host_inside_the_draw_loop(monkeypatch):
    X = torch.from_numpy(_data(2000, 5))
    w = torch.ones(2000)
    reads = []
    for name in ("cpu", "numpy", "item", "tolist"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            reads.append(_name)
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, spy)
    idx = pt_init._kmeanspp_device_draws(X, w, 30, np.random.default_rng(4))
    monkeypatch.undo()
    assert reads == [] and idx.shape == (30,)


def test_not_enough_positive_rows_raises():
    X = torch.from_numpy(_data(10, 3))
    w = torch.zeros(10)
    w[:3] = 1.0
    with pytest.raises(ValueError, match="Not enough data points"):
        pt_init._kmeanspp_device_draws(X, w, 4, np.random.default_rng(0))


@pytest.mark.parametrize("n,block", [(1000, 64), (1000, 1000), (1000, 4096),
                                     (257, 256)])
def test_update_mind2_blocks_give_the_one_pass_distances(monkeypatch, n,
                                                         block):
    """The blocked update (ROADMAP C.7) against the (n, D) difference it
    replaced, in float64: every block, the last one overlapping its
    predecessor, lands on the same minimum; the update is in place."""
    monkeypatch.setattr(pt_init, "MIND2_BLOCK_ROWS", block)
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(n, 7)))
    mind2 = torch.from_numpy(rng.uniform(0.0, 20.0, size=n))
    want = torch.minimum(mind2, ((x - x[3]) ** 2).sum(1))
    got = pt_init.update_mind2(mind2, x, x[3])
    assert got is mind2 and float(got[3]) == 0.0
    torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-13)


def test_update_mind2_arithmetic_does_not_depend_on_n():
    """A row's update is the same at every n (the blocks have one shape):
    what lets a mesh's ranks draw the rows one device draws."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3000, 9)).astype(np.float32))
    c = x[17]
    whole = pt_init.update_mind2(torch.full((3000,), float("inf")), x, c)
    for lo, hi in ((0, 1000), (1000, 3000), (5, 6)):
        part = pt_init.update_mind2(torch.full((hi - lo,), float("inf")),
                                    x[lo:hi], c)
        assert torch.equal(part, whole[lo:hi])
