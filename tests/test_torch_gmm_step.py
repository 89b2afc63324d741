"""The E-step and the posterior pass of the port's Gaussian mixture against
the JAX package's, on the same inputs made with ``np.random.default_rng``.

``kmeans_tpu_torch.parallel.gmm_step`` (``estep_chunk``, the chunked pass of
``make_gmm_step_fn``, ``make_gmm_predict_fn``) and the plain version of the
E-step kernel, ``ops.estep_kernels.diag_estep_reference``, are held against
``kmeans_tpu.parallel.gmm_step`` in float64: to ``rtol=1e-10`` (plus the same
fraction of the largest entry, for centered sums that cancel to near zero).
The two sides sum in another order, nothing else.

The hard-assignment tables (``inv_var = 1e6``) are compared on the rows
whose two nearest means are not near a tie: there ``x_c^2 a`` and
``2 x_c b`` are of order 1e8 and cancel, so a row whose two best squared
distances differ by less than ``1e-4 (||x_c||^2 + max ||mu_c||^2)`` may go
to either mean in float32 (float64 here, but the same rule as on the card).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from kmeans_tpu.parallel import gmm_step as jx  # noqa: E402
from kmeans_tpu_torch.ops import estep_kernels as ek  # noqa: E402
from kmeans_tpu_torch.parallel import gmm_step as pt  # noqa: E402

HARD_INV_VAR = 1e6
# D in {7, 100}, k in {5, 64}; n a multiple of no tile.
SHAPES = [(1037, 7, 5), (1037, 100, 64), (777, 7, 64), (777, 100, 5)]


def make_case(n, d, k, seed, hard=False, dtype=np.float64, offset=5.0):
    """Points about ``offset`` from the origin, a tenth of the weights 0,
    and the E-step tables ``(shift, means_c, inv_var, log_det,
    log_weights)`` of a mixture near the data (or the hard tables)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 3 + offset
    y = rng.integers(0, k, size=n)
    X = centers[y] + rng.normal(size=(n, d))
    w = rng.uniform(0.5, 1.5, size=n)
    w[rng.choice(n, n // 10, replace=False)] = 0.0
    shift = (w @ X) / w.sum()
    if hard:
        means_c = centers - shift
        inv_var = np.full((k, d), HARD_INV_VAR)
        log_det = np.zeros(k)
        log_w = np.zeros(k)
    else:
        means_c = centers - shift + 0.3 * rng.normal(size=(k, d))
        var = rng.uniform(0.5, 2.0, size=(k, d))
        inv_var = 1.0 / var
        log_det = np.log(var).sum(1)
        log_w = np.log(rng.dirichlet(np.ones(k)))
    arrays = (X, w, shift, means_c, inv_var, log_det, log_w)
    return tuple(np.ascontiguousarray(a, dtype=dtype) for a in arrays)


def clear_of_ties(X, shift, means_c):
    """Rows whose two nearest means are farther apart than the float32
    cancellation band of the hard tables."""
    xc = X.astype(np.float64) - shift
    mc = means_c.astype(np.float64)
    d2 = ((xc[:, None, :] - mc[None, :, :]) ** 2).sum(-1)
    part = np.partition(d2, 1, axis=1)
    scale = (xc * xc).sum(1) + (mc * mc).sum(1).max()
    return (part[:, 1] - part[:, 0]) > 1e-4 * scale


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _jax_estep(X, w, shift, means_c, inv_var, log_det, log_w):
    st = jx.estep_chunk(jnp.asarray(X - shift), jnp.asarray(w),
                        jnp.asarray(means_c), jnp.asarray(inv_var),
                        jnp.asarray(log_det), jnp.asarray(log_w))
    return [np.asarray(a) for a in st]


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("n,d,k", SHAPES)
def test_estep_chunk_matches_jax_float64(n, d, k, hard):
    X, w, shift, mc, iv, ld, lw = make_case(n, d, k, seed=n + d + k,
                                            hard=hard)
    if hard:
        w = np.where(clear_of_ties(X, shift, mc), w, 0.0)
    ref = _jax_estep(X, w, shift, mc, iv, ld, lw)
    got = pt.estep_chunk(_t(X - shift), _t(w), _t(mc), _t(iv), _t(ld),
                         _t(lw))
    assert got.xsum.dtype == torch.float64 and got.xsum.shape == (k, d)
    for a, b in zip(got, ref):
        _close(a.numpy(), b, 1e-10)


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("n,d,k", SHAPES)
def test_plain_kernel_version_matches_jax_float64(n, d, k, hard):
    """The kernel's arithmetic (expanded [x_c, x_c^2] . [b, -a/2] + c1,
    centering inside, zero-weight rows inert) in float64."""
    X, w, shift, mc, iv, ld, lw = make_case(n, d, k, seed=3 * n + k,
                                            hard=hard)
    if hard:
        w = np.where(clear_of_ties(X, shift, mc), w, 0.0)
    ref = _jax_estep(X, w, shift, mc, iv, ld, lw)
    got = ek.diag_estep_reference(*(_t(a) for a in (X, w, shift, mc, iv,
                                                    ld, lw)))
    for a, b in zip(got, ref):
        _close(a.numpy(), b, 1e-10)
    assert float(got[0].sum()) == pytest.approx(w.sum(), rel=1e-12)


@pytest.mark.parametrize("chunk", [128, 1000, 4096])
@pytest.mark.parametrize("cov_seed", [0, 1])
def test_chunked_pass_matches_jax_step(mesh1, chunk, cov_seed):
    """The port's chunked pass (short last chunk) against the JAX package's
    whole-shard step on a one-device mesh, serial schedule."""
    n, d, k = 1000, 7, 5
    X, w, shift, mc, iv, ld, lw = make_case(n, d, k, seed=40 + cov_seed)
    step = jx.make_gmm_step_fn(mesh1, chunk_size=n, pipeline=0)
    ref = [np.asarray(a) for a in step(
        jnp.asarray(X), jnp.asarray(w), jnp.asarray(shift), jnp.asarray(mc),
        jnp.asarray(iv), jnp.asarray(ld), jnp.asarray(lw))]
    got = pt.make_gmm_step_fn(chunk_size=chunk, mode="torch")(
        *(_t(a) for a in (X, w, shift, mc, iv, ld, lw)))
    for a, b in zip(got, ref):
        _close(a.numpy(), b, 1e-10)


def test_kernel_mode_on_the_cpu_is_the_plain_version():
    X, w, shift, mc, iv, ld, lw = make_case(700, 9, 6, seed=5,
                                            dtype=np.float32)
    args = [_t(a) for a in (X, w, shift, mc, iv, ld, lw)]
    before = dict(ek.LAUNCHES)
    got = pt.make_gmm_step_fn(chunk_size=128, mode="kernel")(*args)
    want = ek.diag_estep_reference(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ek.LAUNCHES == before               # nothing reached a card
    torch_pass = pt.make_gmm_step_fn(chunk_size=128, mode="torch")(*args)
    for a, b in zip(got, torch_pass):
        _close(a.numpy(), b.numpy(), 1e-4)
    with pytest.raises(ValueError, match="mode"):
        pt.make_gmm_step_fn(chunk_size=128, mode="pallas")


@pytest.mark.parametrize("chunk", [128, 1000])
@pytest.mark.parametrize("n,d,k", [(1000, 7, 5), (1000, 100, 64)])
def test_predict_pass_matches_jax(mesh1, n, d, k, chunk):
    X, _, shift, mc, iv, ld, lw = make_case(n, d, k, seed=n + k + 1)
    predict = jx.make_gmm_predict_fn(mesh1, chunk_size=n)
    ref_l, ref_r, ref_s = (np.asarray(a) for a in predict(
        jnp.asarray(X), jnp.asarray(shift), jnp.asarray(mc),
        jnp.asarray(iv), jnp.asarray(ld), jnp.asarray(lw)))
    labels, logr, lse = pt.make_gmm_predict_fn(chunk_size=chunk)(
        *(_t(a) for a in (X, shift, mc, iv, ld, lw)))
    assert labels.dtype == torch.int32 and logr.shape == (n, k)
    np.testing.assert_array_equal(labels.numpy(), ref_l)
    np.testing.assert_allclose(logr.numpy(), ref_r, rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(lse.numpy(), ref_s, rtol=1e-10)


def test_predict_pass_takes_no_rows():
    _, _, shift, mc, iv, ld, lw = make_case(50, 4, 3, seed=2)
    labels, logr, lse = pt.make_gmm_predict_fn(chunk_size=128)(
        torch.zeros((0, 4), dtype=torch.float64),
        *(_t(a) for a in (shift, mc, iv, ld, lw)))
    assert labels.shape == (0,) and logr.shape == (0, 3) and lse.shape == (0,)


def test_zero_weight_rows_add_nothing_even_with_nan():
    X, w, shift, mc, iv, ld, lw = make_case(300, 6, 4, seed=9,
                                            dtype=np.float32)
    args = [_t(a) for a in (X, w, shift, mc, iv, ld, lw)]
    base = ek.diag_estep_reference(*args)
    dead = int(np.flatnonzero(w == 0)[0])
    X2 = X.copy()
    X2[dead, 2] = np.nan
    got = ek.diag_estep_reference(_t(X2), *args[1:])
    assert all(torch.equal(a, b) for a, b in zip(got, base))
    assert float(base[0].sum()) == pytest.approx(float(w.sum()), rel=1e-5)
