"""k-means|| seeding of the port (``models.init.kmeans_parallel_init``,
``KMeans(init='k-means||', init_cap=...)``) on the CPU.

The JAX package draws from ``jax.random``, the port from a seeded
``torch.Generator``, so a seeded trajectory cannot match (ROADMAP's parity
class "paths that depend on the PRNG").  The parts that do not draw are held
against the JAX package's on the same inputs, in float64 to ``rtol=1e-12``
(integer results exactly):

* the fold of a candidate buffer into ``mind2`` (``_fold_candidates``), and
  in the kernel modes against the Pallas assignment kernel in interpret
  mode (the port's kernel-2 plain version; tolerances of ``ops/compare``);
* the cell mass of a buffer (the mass pass's counts);
* the weighted k-means++ reduce from given draws (``_kmeanspp_body`` with
  its Gumbel noise handed to the port) and the ``refine`` steps;
* ``_distinct_backfill``.

The whole seeding is held by quality: k distinct rows (data rows where no
``refine`` step moves them: the host engine, or ``refine=0``); its SSE, the
mean over six seeds, within a factor 1.25 of the JAX package's (either
way), pooled over three datasets so that one merged cluster of one draw
does not decide it; the SSE of a fit from it within 1 % of the JAX
package's on separated blobs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu.models import init as ji  # noqa: E402
from kmeans_tpu.ops import assign as jx_assign  # noqa: E402
from kmeans_tpu.ops.pallas_kernels import pallas_assign  # noqa: E402
from kmeans_tpu_torch.models import init as pi  # noqa: E402
from kmeans_tpu_torch.ops import compare as cmp  # noqa: E402
from kmeans_tpu_torch.parallel.sharding import Dataset  # noqa: E402

RTOL, ATOL = 1e-12, 1e-10
QUALITY_FACTOR = 1.25


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _blobs(n=4000, d=8, centers=20, seed=0, dtype=np.float64, std=1.0,
           box=10.0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-box, box, size=(centers, d))
    y = rng.integers(0, centers, size=n)
    return (means[y] + std * rng.standard_normal((n, d))).astype(dtype)


def _buffer(X, m, seed=0, sentinels=5):
    """A candidate buffer: ``m`` data rows, then sentinel rows."""
    rng = np.random.default_rng(seed)
    rows = X[rng.choice(X.shape[0], m, replace=False)]
    pad = np.full((sentinels, X.shape[1]), pi._CAND_SENTINEL, X.dtype)
    return np.concatenate([rows, pad]), np.arange(m + sentinels) < m


def _sse(X, C):
    d2 = ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1)
    return float(d2.min(1).sum())


@pytest.mark.parametrize("m", [1, 37, 300])
def test_fold_matches_jax(m):
    X = _blobs(n=1500, seed=1)
    cands, valid = _buffer(X, m)
    start = np.random.default_rng(2).uniform(0, 50, X.shape[0])
    want = np.asarray(ji._fold_candidates(jnp.asarray(X),
                                          jnp.asarray(start),
                                          jnp.asarray(cands),
                                          jnp.asarray(valid)))
    got = pi.fold_candidates(_t(X), _t(start.copy()), _t(cands))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-9)


@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_fold_is_the_assignment_kernel(bf16):
    """In the kernel modes the fold is kernel 2's (2b's) ``mind2``: its
    plain version here, held to the Pallas kernel in interpret mode (at D a
    multiple of 128, where the Pallas bf16 kernel keeps the port's rule)."""
    X = _blobs(n=1024, d=128, seed=3, dtype=np.float32)
    cands, _ = _buffer(X, 200)
    start = np.full(X.shape[0], np.inf, np.float32)
    got = pi.fold_candidates(_t(X), _t(start),
                             _t(cands), mode="kernel_bf16" if bf16
                             else "kernel").numpy()
    ref = np.asarray(pallas_assign(X, cands, tile_n=128, tile_k=128,
                                   bf16=bf16, interpret=True)[1])
    atol = cmp.mind2_atol(_t(X), _t(cands[:200]))
    np.testing.assert_allclose(got, ref, rtol=cmp.MIND2_RTOL, atol=atol)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["matmul", "kernel"])
def test_cell_mass_matches_jax(weighted, mode):
    X = _blobs(n=1200, seed=4)
    rng = np.random.default_rng(5)
    # Dyadic weights: every sum is exact, in any order.
    w = (rng.integers(1, 8, X.shape[0]) / 4.0 if weighted
         else np.ones(X.shape[0]))
    cands, _ = _buffer(X, 60, seed=6)
    want = np.asarray(jx_assign.assign_reduce(
        jnp.asarray(X), jnp.asarray(w), jnp.asarray(cands),
        chunk_size=X.shape[0]).counts)
    got = pi.cell_mass(_t(X), _t(w), _t(cands), mode=mode).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[60:] == 0).all()


def test_segment_sum_is_the_per_label_sum():
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 9, 500)
    w = rng.uniform(0, 2, 500)
    got = pi.segment_sum(_t(labels), _t(w), 11).numpy()
    np.testing.assert_allclose(got, np.bincount(labels, w, minlength=11),
                               rtol=RTOL)
    assert got[9] == got[10] == 0.0


@pytest.mark.parametrize("k", [1, 5, 24])
def test_weighted_kmeanspp_from_given_draws_matches_jax(k):
    X = _blobs(n=400, seed=8)
    mass = np.random.default_rng(9).uniform(0.0, 3.0, X.shape[0])
    mass[::13] = 0.0
    key = jax.random.PRNGKey(11)
    want = np.asarray(ji._kmeanspp_body(jnp.asarray(X), jnp.asarray(mass),
                                        k, key))
    noise = np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(key, i), (X.shape[0],), jnp.float64))
        for i in range(k)])
    got = pi.kmeanspp_gumbel(_t(X), _t(mass), k, _t(noise)).numpy()
    np.testing.assert_array_equal(got, want)


def test_weighted_kmeanspp_falls_back_to_the_weights():
    X = np.repeat(_blobs(n=3, seed=10), 4, axis=0)     # coincident rows
    mass = np.ones(X.shape[0])
    key = jax.random.PRNGKey(3)
    want = np.asarray(ji._kmeanspp_body(jnp.asarray(X), jnp.asarray(mass),
                                        6, key))
    noise = np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(key, i), (X.shape[0],), jnp.float64))
        for i in range(6)])
    got = pi.kmeanspp_gumbel(_t(X), _t(mass), 6, _t(noise)).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_refine(cands, mass, centers, steps):
    """The refine steps of the JAX package's pipeline
    (``_build_parallel_pipeline``'s ``refine_body``), step for step."""
    c = jnp.asarray(centers)
    buf = jnp.asarray(cands)
    m = jnp.asarray(mass)
    ids = jnp.arange(centers.shape[0])
    for _ in range(steps):
        best = jnp.argmin(jx_assign.pairwise_sq_dists(buf, c), axis=1)
        oh = (best[:, None] == ids[None, :]).astype(buf.dtype) * m[:, None]
        sums = oh.T @ buf
        counts = jnp.sum(oh, axis=0)
        c = jnp.where((counts > 0)[:, None],
                      sums / jnp.maximum(counts, 1.0)[:, None], c)
    return np.asarray(c)


@pytest.mark.parametrize("steps", [0, 1, 4])
def test_refine_matches_jax(steps):
    X = _blobs(n=600, seed=12)
    cands, valid = _buffer(X, 500, seed=13)
    mass = np.where(valid, np.random.default_rng(14).uniform(
        0.5, 4.0, cands.shape[0]), 0.0)
    centers = cands[:12].copy()
    want = _jax_refine(cands, mass, centers, steps)
    got = pi.refine_centers(_t(cands), _t(mass), _t(centers), steps)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_distinct_backfill_matches_jax(weighted):
    X = _blobs(n=200, seed=15)
    w = None
    if weighted:
        w = np.ones(X.shape[0])
        w[::3] = 0.0
    table = X[[4, 4, 9, 17, 9, 4, 30, 31]].copy()
    want = ji._distinct_backfill(table.copy(), ji.as_source(X, w), 8, 21)
    got = pi._distinct_backfill(table.copy(), pi.as_source(X, w), 8, 21)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got, axis=0)) == 8
    same = X[:8].copy()
    np.testing.assert_array_equal(
        pi._distinct_backfill(same.copy(), pi.as_source(X), 8, 1), same)


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("k", [20, 32])
def test_seeding_quality_is_that_of_jax(engine, k):
    """k = 20 is the blobs' own count (a seeding that merges two blobs
    costs much), k = 32 more than it."""
    device = engine == "device"
    ours, theirs = [], []
    for X, seed in [(_blobs(seed=data), seed) for data in (0, 1, 16)
                    for seed in range(6)]:
        got = pi.kmeans_parallel_init(X, k, seed,
                                      device="cpu" if device else False)
        assert got.shape == (k, X.shape[1]) and np.isfinite(got).all()
        assert len(np.unique(got, axis=0)) == k
        rows = got if not device else pi.kmeans_parallel_init(
            X, k, seed, refine=0, device="cpu")
        assert len(np.unique(rows, axis=0)) == k
        assert (rows[:, None, :] == X[None, :, :]).all(-1).any(1).all()
        ours.append(_sse(X, got))
        theirs.append(_sse(X, np.asarray(ji.kmeans_parallel_init(
            X, k, seed, device=device))))
    ratio = np.mean(ours) / np.mean(theirs)
    assert 1 / QUALITY_FACTOR <= ratio <= QUALITY_FACTOR, ratio


@pytest.mark.parametrize("mode,dtype", [("matmul", np.float64),
                                        ("kernel", np.float32),
                                        ("kernel_bf16", np.float32)])
def test_fit_from_kmeans_parallel_is_within_a_percent_of_jax(mesh1, mode,
                                                             dtype):
    X = _blobs(n=3000, centers=12, seed=17, std=0.3, box=20.0, dtype=dtype)
    kw = dict(k=12, max_iter=50, seed=4, init="k-means||", verbose=False,
              compute_sse=True, dtype=dtype)
    jm = kmeans_tpu.KMeans(mesh=mesh1, distance_mode="matmul", **kw).fit(X)
    pm = kmeans_tpu_torch.KMeans(device="cpu", distance_mode=mode,
                                 **kw).fit(X)
    # The float64 SSE of each fit's centroids (a bf16 model scores in its
    # own class).
    x = X.astype(np.float64)
    assert abs(_sse(x, pm.centroids.astype(np.float64))
               / _sse(x, np.asarray(jm.centroids, np.float64)) - 1) <= 0.01


def test_seeding_is_deterministic_and_follows_the_seed():
    X = _blobs(seed=18)
    ds = Dataset(_t(X), torch.ones(X.shape[0], dtype=torch.float64))
    a = pi.kmeans_parallel_init(ds, 16, 3)
    np.testing.assert_array_equal(a, pi.kmeans_parallel_init(ds, 16, 3))
    np.testing.assert_array_equal(a, pi.kmeans_parallel_init(
        X, 16, 3, device="cpu"))
    assert not np.array_equal(a, pi.kmeans_parallel_init(ds, 16, 4))


def test_zero_weight_rows_are_never_candidates():
    X = _blobs(n=800, seed=19)
    w = np.ones(X.shape[0])
    w[::2] = 0.0
    X[::2] += 1e3                       # far away: D^2 would pick them
    ds = Dataset(_t(X), _t(w))
    got = pi.kmeans_parallel_init(ds, 10, 2, refine=0)
    rows = (got[:, None, :] == X[None, :, :]).all(-1)
    assert rows.any(1).all() and not rows[:, ::2].any()


@pytest.mark.parametrize("cap", [1, 7, 64])
def test_init_cap_sizes_the_buffer(cap):
    X = _blobs(n=500, seed=20)
    k = 8
    rounds = max(5, -(-int(1.5 * k) // cap))
    _, cands, mass = pi.kmeans_parallel_init(X, k, 0, cap=cap,
                                             return_candidates=True,
                                             device="cpu")
    assert 1 <= cands.shape[0] <= 1 + rounds * cap
    assert mass.shape == (cands.shape[0],) and mass.sum() == X.shape[0]
    km = kmeans_tpu_torch.KMeans(k=k, init="k-means||", init_cap=cap,
                                 device="cpu", verbose=False).fit(X)
    assert km.init_cap == cap and km.get_params()["init_cap"] == cap


def test_tiny_data_gets_k_distinct_rows():
    X = _blobs(n=12, seed=21)
    for device in ("cpu", False):
        got = pi.kmeans_parallel_init(X, 12, 5, device=device)
        assert len(np.unique(got, axis=0)) == 12


def test_refusals_match_jax():
    X = _blobs(n=50, seed=22)
    with pytest.raises(ValueError) as want:
        ji.resolve_init("forgy", X, 3, 0, cap=8)
    with pytest.raises(ValueError) as got:
        pi.resolve_init("forgy", X, 3, 0, cap=8)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="init_cap"):
        kmeans_tpu_torch.KMeans(k=3, init_cap=8, device="cpu",
                                verbose=False).fit(X)
    with pytest.raises(ValueError, match="init_cap must be >= 1"):
        kmeans_tpu_torch.KMeans(k=3, init_cap=0, device="cpu")
    with pytest.raises(ValueError, match="Not enough data points"):
        pi.kmeans_parallel_init(X, 51, 0, device="cpu")
    bad = X.copy()
    bad[3, 1] = np.nan
    with pytest.raises(ValueError, match="NaN or Inf"):
        pi.kmeans_parallel_init(bad, 3, 0, device="cpu")
    # The streamed k-means|| (ported since, ROADMAP A.10) refuses as the
    # JAX package's does.
    with pytest.raises(ValueError) as want:
        ji.streamed_kmeans_parallel_init(lambda: iter([X]), 51, [0],
                                         X.shape[1], np.float64)
    with pytest.raises(ValueError) as got:
        pi.streamed_kmeans_parallel_init(lambda: iter([X]), 51, [0],
                                         X.shape[1], np.float64,
                                         device="cpu")
    assert str(got.value) == str(want.value)


def test_a_host_array_goes_to_the_card_unless_asked(monkeypatch):
    """The device engine places a host array on ``resolve_device(None)``,
    the card, as every entry point of the port does: without one it raises
    rather than running on the CPU.  ``device='cpu'`` and the host engine
    (``device=False``) stay on the CPU."""
    from kmeans_tpu_torch.models import kmeans as pk
    X = _blobs(n=300, seed=23)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pi.kmeans_parallel_init(X, 4, 0)
    asked, seen = [], []
    real_pipeline = pi._parallel_pipeline

    def fake_resolve(device):
        asked.append(device)
        return torch.device("cpu")

    def spy(src, points, *args, **kwargs):
        seen.append(points.device)
        return real_pipeline(src, points, *args, **kwargs)

    monkeypatch.setattr(pk, "resolve_device", fake_resolve)
    monkeypatch.setattr(pi, "_parallel_pipeline", spy)
    pi.kmeans_parallel_init(X, 4, 0)
    pi.kmeans_parallel_init(X, 4, 0, device="cuda:1")
    assert asked == [None, "cuda:1"] and len(seen) == 2
    pi.kmeans_parallel_init(X, 4, 0, device=False)
    assert asked == [None, "cuda:1"]        # the host engine asks for none
