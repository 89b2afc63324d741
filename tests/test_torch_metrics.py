"""``kmeans_tpu_torch.metrics`` against ``kmeans_tpu.metrics`` on the CPU.

* The label scores (adjusted Rand, mutual information, NMI, homogeneity,
  completeness, V-measure) are the JAX package's NumPy arithmetic: equal.
* The geometric scores (silhouette, Calinski-Harabasz, Davies-Bouldin, and
  the member-batched ``batched_criterion_scores``): in float32 against the
  JAX package's (which scores in float32) to ``rtol=1e-4`` (silhouettes,
  which lie in [-1, 1], also ``atol=1e-6``: a random labeling scores near
  0; per-row silhouettes ``atol=1e-4``: the JAX package keeps a row's
  distance to itself, the square root of the expanded form's rounding,
  where the port puts 0); in float64, which the JAX package does not
  score, against scikit-learn's float64 scores to ``rtol=1e-10``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from sklearn import metrics as sk  # noqa: E402

from kmeans_tpu import metrics as jm  # noqa: E402
from kmeans_tpu_torch import metrics as pm  # noqa: E402

F32_RTOL, F64_RTOL = 1e-4, 1e-10
SILHOUETTE_ATOL = 1e-6
GEOMETRIC = {"silhouette": ("silhouette_score", "silhouette_score"),
             "calinski_harabasz": ("calinski_harabasz_score",
                                   "calinski_harabasz_score"),
             "davies_bouldin": ("davies_bouldin_score",
                                "davies_bouldin_score")}


def _blobs(n=700, d=5, centers=4, seed=0, dtype=np.float64, std=0.8):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-5.0, 5.0, size=(centers, d))
    y = rng.integers(0, centers, size=n)
    X = means[y] + std * rng.standard_normal((n, d))
    return X.astype(dtype), y


def _labels(n, k, seed):
    return np.random.default_rng(seed).integers(0, k, n)


LABEL_CASES = [(0, 1, 5, 5), (1, 2, 3, 7), (2, 3, 1, 4), (3, 4, 6, 1),
               (4, 4, 12, 12)]


@pytest.mark.parametrize("seed,s2,ka,kb", LABEL_CASES)
def test_label_scores_equal_jax(seed, s2, ka, kb):
    a = _labels(300, ka, seed)
    b = _labels(300, kb, s2)
    b[:100] = a[:100]                  # some agreement
    for name in ("adjusted_rand_score", "mutual_info_score",
                 "normalized_mutual_info_score",
                 "homogeneity_completeness_v_measure"):
        assert getattr(pm, name)(a, b) == getattr(jm, name)(a, b)


def test_label_scores_on_identical_and_float_labels():
    a = _labels(200, 5, 9)
    assert pm.adjusted_rand_score(a, a) == 1.0
    assert pm.normalized_mutual_info_score(a, a) == \
        jm.normalized_mutual_info_score(a, a)
    f = a.astype(np.float64) * 0.5
    assert pm.mutual_info_score(f, a) == jm.mutual_info_score(f, a)
    f[3] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        pm.adjusted_rand_score(f, a)
    with pytest.raises(ValueError, match="differ in length"):
        pm.mutual_info_score(a, a[:-1])
    with pytest.raises(ValueError, match="non-empty"):
        pm.mutual_info_score([], [])


@pytest.mark.parametrize("criterion", list(GEOMETRIC))
@pytest.mark.parametrize("seed", [0, 1])
def test_geometric_scores_float32_match_jax(criterion, seed):
    X, y = _blobs(seed=seed, dtype=np.float32)
    y[::50] = 7                        # a gap in the ids: compacted
    name = GEOMETRIC[criterion][0]
    got = getattr(pm, name)(X, y, device="cpu")
    want = getattr(jm, name)(X, y)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL,
                               atol=SILHOUETTE_ATOL if
                               criterion == "silhouette" else 0.0)


@pytest.mark.parametrize("criterion", list(GEOMETRIC))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_geometric_scores_float64_match_sklearn(criterion, seed):
    X, y = _blobs(seed=seed)
    ours, theirs = GEOMETRIC[criterion]
    np.testing.assert_allclose(getattr(pm, ours)(X, y, device="cpu"),
                               getattr(sk, theirs)(X, y), rtol=F64_RTOL)


def test_silhouette_samples_and_subsample_match():
    X, y = _blobs(n=500, seed=3)
    y[7] = 9                           # a singleton cluster scores 0
    got = pm.silhouette_samples(X, y, device="cpu")
    np.testing.assert_allclose(got, sk.silhouette_samples(X, y),
                               rtol=F64_RTOL, atol=1e-12)
    assert got[7] == 0.0
    np.testing.assert_allclose(
        pm.silhouette_samples(X.astype(np.float32), y, device="cpu"),
        jm.silhouette_samples(X.astype(np.float32), y), rtol=F32_RTOL,
        atol=1e-4)
    sub = pm.silhouette_score(X, y, sample_size=120, seed=4, device="cpu")
    idx = np.random.default_rng(4).choice(500, size=120, replace=False)
    np.testing.assert_allclose(sub, sk.silhouette_score(X[idx], y[idx]),
                               rtol=F64_RTOL)
    np.testing.assert_allclose(
        pm.silhouette_score(X.astype(np.float32), y, sample_size=120,
                            seed=4, device="cpu"),
        jm.silhouette_score(X.astype(np.float32), y, sample_size=120,
                            seed=4), rtol=F32_RTOL, atol=SILHOUETTE_ATOL)


def test_column_blocks_and_row_chunks_cover_every_row():
    """More rows than a column block (4096) and than a row chunk (1024)."""
    X, y = _blobs(n=4500, d=3, centers=3, seed=5)
    np.testing.assert_allclose(pm.silhouette_score(X, y, device="cpu"),
                               sk.silhouette_score(X, y), rtol=F64_RTOL)


@pytest.mark.parametrize("criterion", list(GEOMETRIC))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batched_scores_match_the_single_scores_and_jax(criterion, dtype):
    X, y = _blobs(n=600, seed=6, dtype=dtype)
    stack = np.stack([y, _labels(600, 3, 1), _labels(600, 6, 2),
                      np.where(np.arange(600) % 2, 1, 0)])
    got = pm.batched_criterion_scores(X, stack, criterion, device="cpu")
    single = getattr(pm, GEOMETRIC[criterion][0])
    rtol = F64_RTOL if dtype == np.float64 else F32_RTOL
    atol = SILHOUETTE_ATOL if criterion == "silhouette" else 0.0
    np.testing.assert_allclose(
        got, [single(X, lab, device="cpu") for lab in stack], rtol=rtol,
        atol=atol if dtype == np.float32 else 0.0)
    np.testing.assert_allclose(
        got, jm.batched_criterion_scores(X.astype(np.float32), stack,
                                         criterion),
        rtol=F32_RTOL if dtype == np.float32 else 1e-3, atol=atol)


def test_batched_scores_of_a_collapsed_member_are_nan():
    X, y = _blobs(n=300, seed=7)
    stack = np.stack([y, np.zeros(300, np.int64)])
    for criterion in GEOMETRIC:
        got = pm.batched_criterion_scores(X, stack, criterion, device="cpu")
        want = jm.batched_criterion_scores(X.astype(np.float32), stack,
                                           criterion)
        assert np.isfinite(got[0]) and np.isnan(got[1]) and \
            np.isnan(want[1])


def test_batched_silhouette_subsample_is_shared():
    X, y = _blobs(n=800, seed=8)
    stack = np.stack([y, _labels(800, 5, 3)])
    got = pm.batched_criterion_scores(X, stack, "silhouette",
                                      sample_size=200, seed=2,
                                      device="cpu")
    idx = np.random.default_rng(2).choice(800, size=200, replace=False)
    np.testing.assert_allclose(
        got, [sk.silhouette_score(X[idx], lab[idx]) for lab in stack],
        rtol=F64_RTOL)


def test_errors_match_jax():
    X, y = _blobs(n=50, seed=9)
    for fn in ("silhouette_score", "calinski_harabasz_score",
               "davies_bouldin_score"):
        for bad in (np.zeros(50, int), y[:-1]):
            with pytest.raises(ValueError):
                getattr(jm, fn)(X, bad)
            with pytest.raises(ValueError):
                getattr(pm, fn)(X, bad, device="cpu")
    with pytest.raises(ValueError, match="unknown batched criterion"):
        pm.batched_criterion_scores(X, y[None], "inertia", device="cpu")
    with pytest.raises(ValueError, match="non-negative"):
        pm.batched_criterion_scores(X, -np.ones((1, 50), int),
                                    "silhouette", device="cpu")
    bad = X.copy()
    bad[2, 2] = np.inf
    with pytest.raises(ValueError, match="NaN or Inf"):
        pm.davies_bouldin_score(bad, y, device="cpu")
    assert pm.SWEEP_SCORE_DISPATCHES == jm.SWEEP_SCORE_DISPATCHES
