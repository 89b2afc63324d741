"""The port's ``ProductQuantizer`` (``kmeans_tpu_torch.models.pq``) against
the JAX package's on the CPU.  With the same initial codebooks (a callable
``init``, since the packages' k-means++ draws differ) a float64 fit gives
the JAX package's codebooks, iteration counts, counts and subspace
inertias to the float64 parity class, and the same codes; k-means++ fits
are held by quality.  Each member is bit-equal to a standalone ``KMeans``
of its subspace seeded with ``_member_seeds(m)[j]`` (the JAX package's
tests/test_large_k.py property).  ADC labels equal the exact argmin over
the decoded table, and the JAX package's labels and corrected count for
the same codebooks and codes."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu.models.pq import default_subspaces as jax_subspaces  # noqa
from kmeans_tpu_torch import KMeans, ProductQuantizer, convert  # noqa: E402
from kmeans_tpu_torch.models.pq import default_subspaces, pq_state  # noqa: E402,E501
from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402

F64 = dict(rtol=1e-12, atol=1e-10)


def _rows(n=1024, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)) + 3.0 * rng.integers(0, 3, size=(n, 1))


def _draw(X, k, seed):
    """A callable init: k distinct rows of the subspace by a NumPy draw."""
    X = np.asarray(X)
    return X[np.random.default_rng(seed).choice(len(X), k, replace=False)]


def _pair(X, dtype=np.float64, **kw):
    kw = dict(dict(m=4, k=8, max_iter=20, tolerance=1e-6, seed=7,
                   init=_draw, dtype=dtype), **kw)
    port = ProductQuantizer(device="cpu", **kw).fit(X)
    ref = kmeans_tpu.ProductQuantizer(
        mesh=kmeans_tpu.make_mesh(data=1, model=1), **kw).fit(X)
    return port, ref


@pytest.fixture(scope="module")
def fitted():
    X = _rows()
    return X, _pair(X)


def test_fit_matches_the_jax_quantizer(fitted):
    X, (port, ref) = fitted
    assert (port.m_, port.d_, port.d_sub_) == (ref.m_, ref.d_, ref.d_sub_)
    np.testing.assert_allclose(port.codebooks_, ref.codebooks_, **F64)
    np.testing.assert_array_equal(port.n_iters_, ref.n_iters_)
    np.testing.assert_array_equal(port.counts_, ref.counts_)
    np.testing.assert_allclose(port.subspace_inertias_,
                               ref.subspace_inertias_, **F64)
    assert port.codebooks_.dtype == np.float64
    assert port._member_seeds(4) == ref._member_seeds(4)


def test_encode_decode_and_ratio_match(fitted):
    X, (port, ref) = fitted
    codes = port.encode(X)
    assert codes.shape == (1024, 4) and codes.dtype == np.uint8
    np.testing.assert_array_equal(codes, ref.encode(X))
    np.testing.assert_allclose(port.decode(codes), ref.decode(codes), **F64)
    assert port.compression_ratio() == ref.compression_ratio() == 32.0
    for j in (0, 3):
        sub = X[:, j * 4:(j + 1) * 4]
        d2 = ((sub[:, None, :] - port.codebooks_[j][None]) ** 2).sum(-1)
        np.testing.assert_array_equal(codes[:, j], np.argmin(d2, axis=1))


def test_member_equals_standalone_fit(fitted):
    """Every member is bit-equal to a standalone device-loop ``KMeans`` of
    its subspace with the member's seed; its inertia is its true final
    SSE."""
    X, (port, _) = fitted
    seeds = port._member_seeds(4)
    for j in range(4):
        sub = X[:, j * 4:(j + 1) * 4]
        km = KMeans(k=8, max_iter=20, tolerance=1e-6, seed=seeds[j],
                    init=_draw, empty_cluster="keep", dtype=np.float64,
                    host_loop=False, distance_mode="matmul", device="cpu",
                    verbose=False).fit(sub)
        assert np.max(np.abs(km.centroids - port.codebooks_[j])) == 0.0
        assert km.iterations_run == port.n_iters_[j]
        d2 = ((sub[:, None, :] - port.codebooks_[j][None]) ** 2).sum(-1)
        assert port.subspace_inertias_[j] == pytest.approx(
            float(np.sum(np.min(d2, axis=1))), rel=1e-9)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kmeanspp_members_equal_standalone_and_quality(dtype):
    """The k-means++ draw path: members bit-equal to standalone fits in
    both dtypes, and the total inertia within 10 % of the JAX package's
    (the draws differ by design)."""
    X = _rows(n=600, d=8, seed=2)
    port, ref = _pair(X, dtype=dtype, m=2, k=6, init="k-means++", seed=5)
    seeds = port._member_seeds(2)
    for j in range(2):
        km = KMeans(k=6, max_iter=20, tolerance=1e-6, seed=seeds[j],
                    init="k-means++", empty_cluster="keep", dtype=dtype,
                    host_loop=False, distance_mode="matmul", device="cpu",
                    verbose=False).fit(X[:, j * 4:(j + 1) * 4])
        np.testing.assert_array_equal(km.centroids, port.codebooks_[j])
    assert port.codebooks_.dtype == dtype
    assert port.subspace_inertias_.sum() <= \
        1.1 * ref.subspace_inertias_.sum()


def test_adc_assign_matches_decoded_argmin_and_the_jax_labels():
    """The guarded ADC: labels equal the exact float64 argmin over the
    decoded table; for the same codebooks and codes the JAX package's
    labels and corrected count."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=(64, 16))
    port, codes = ProductQuantizer.for_table(table, m=4, k=16, seed=3,
                                             device="cpu")
    assert codes.shape == (64, 4)
    queries = rng.normal(size=(200, 16))
    labels, corrected = port.adc_assign(queries, codes)
    dec = port.decode(codes)
    oracle = np.argmin(((queries[:, None, :] - dec[None]) ** 2).sum(-1),
                       axis=1)
    np.testing.assert_array_equal(labels, oracle)
    assert labels.dtype == np.int32 and 0 < corrected <= 200
    jpq = kmeans_tpu.ProductQuantizer(
        m=4, k=16, seed=3, dtype=np.float64,
        mesh=kmeans_tpu.make_mesh(data=1, model=1))
    for name, value in pq_state(port).items():
        if name.endswith("_"):
            setattr(jpq, name, value)
    jl, jc = jpq.adc_assign(queries, codes)
    np.testing.assert_array_equal(labels, jl)
    assert corrected == jc
    # A one-row table flags every query: labels all 0.
    one, c1 = port.adc_assign(queries[:5], codes[:1])
    assert one.tolist() == [0] * 5 and c1 == 5


def test_plan_state_and_conversion(fitted):
    X, (port, ref) = fitted
    assert port.plan_ is not None
    assert port.plan_["predicted_peak_bytes"] > 0
    assert port.fitted_state() == ref.fitted_state()
    back = convert.from_jax_state(convert.pq_state(ref), device="cpu")
    np.testing.assert_array_equal(back.codebooks_, ref.codebooks_)
    np.testing.assert_array_equal(back.encode(X), ref.encode(X))
    again = convert.from_jax_state(convert.to_jax_state(port),
                                   device="cpu")
    np.testing.assert_array_equal(again.counts_, port.counts_)
    assert again.compression_ratio() == port.compression_ratio()


def test_subspaces_and_validation_messages():
    for d in (16, 7, 13, 128, 1, 30):
        assert default_subspaces(d) == jax_subspaces(d)
    X = _rows(n=64)
    mesh = kmeans_tpu.make_mesh(data=1, model=1)
    cases = [(dict(m=5), X), (dict(m=4, k=8), X[:4]),
             (dict(m=4, k=8), X[:, :1].reshape(-1)),
             (dict(m=4), np.where(X > 4, np.nan, X))]
    for kw, rows in cases:
        with pytest.raises(ValueError) as got:
            ProductQuantizer(device="cpu", **kw).fit(rows)
        with pytest.raises(ValueError) as want:
            kmeans_tpu.ProductQuantizer(mesh=mesh, **kw).fit(rows)
        assert str(got.value) == str(want.value)
    for kw in (dict(m=0), dict(k=0)):
        with pytest.raises(ValueError) as got:
            ProductQuantizer(device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            kmeans_tpu.ProductQuantizer(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="fitted first"):
        ProductQuantizer(device="cpu").encode(X)


@pytest.mark.parametrize("kw, match", [
    (dict(mode="kernel"), "matmul-class modes only"),
    (dict(mode="matmul_bf16_guarded"), "matmul-class modes only"),
    (dict(empty_policy="farthest"), "requires empty_cluster='keep'")])
def test_member_points_refusals(kw, match):
    kw = dict(dict(chunk_size=64, mode="matmul", k_real=4, max_iter=3,
                   tolerance=0.0, n_init=2, member_points=True), **kw)
    with pytest.raises(ValueError, match=match):
        dist.make_multi_fit_fn(**kw)


def test_member_points_ride_beside_a_two_d_dataset():
    """The members' rows are a separate (R, n, D) tensor beside a dataset
    of one member's (n, D) rows and the weights: each member then trains
    as a single fit of its own rows; rows without ``member_points``, or
    ``member_points`` without rows or with another n, are refused."""
    from kmeans_tpu_torch.parallel.sharding import Dataset
    rng = np.random.default_rng(4)
    pts = torch.from_numpy(rng.normal(size=(2, 90, 3)))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, size=90))
    c0 = pts[:, :4].clone()
    kw = dict(chunk_size=32, mode="matmul", k_real=4, max_iter=6,
              tolerance=0.0, return_all=True)
    fit = dist.make_multi_fit_fn(n_init=2, member_points=True, **kw)
    ds = Dataset(pts[0], w)
    got = fit(ds, c0, [1, 2], pts)
    single = dist.make_multi_fit_fn(n_init=1, **kw)
    for r in range(2):
        want = single(Dataset(pts[r], w), c0[r:r + 1], [1])
        assert torch.equal(got.centroids[r], want.centroids[0])
        np.testing.assert_array_equal(got.n_iters[r], want.n_iters[0])
        np.testing.assert_array_equal(got.counts[r], want.counts[0])
    with pytest.raises(ValueError, match="go with member_points=True"):
        fit(ds, c0, [1, 2])
    with pytest.raises(ValueError, match="go with member_points=True"):
        dist.make_multi_fit_fn(n_init=2, **kw)(ds, c0, [1, 2], pts)
    with pytest.raises(ValueError, match=r"needs \(2, 90, D\) points"):
        fit(ds, c0, [1, 2], pts[:, :60])
