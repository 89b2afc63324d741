"""Model selection of the port (``kmeans_tpu_torch.sweep``,
``KMeans.sweep``) against the JAX package's on the CPU.

* The selection rules (``parse_k_range``, ``elbow_index``, ``select_k``,
  ``within_k_winners``, ``selected_member``, ``SweepResult.summary``) are
  the JAX package's NumPy arithmetic: equal.
* ``KMeans.sweep`` in float64 on separated blobs, for each criterion: the
  same selected k, the same winning restart of every k, member inertias
  (the true final inertia of each (k, restart) fit) to ``rtol=1e-12``, and
  each k's score to ``rtol=1e-12`` for inertia and ``1e-4`` for the metric
  criteria (the JAX package scores them in float32).
* The batched sweep against the sequential oracle (``batched=0``): the same
  selected k and member inertias, bit for bit in the kernel modes (each
  member's kernel runs at its own k) and to ``rtol=1e-12`` in the torch
  modes (a batched member's pass walks the rows in the chunks of a k_max
  fit, the oracle's in those of its own k).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu import sweep as js  # noqa: E402
from kmeans_tpu_torch import sweep as ps  # noqa: E402
from kmeans_tpu_torch.parallel.sharding import Dataset  # noqa: E402

RTOL = 1e-12
CRITERIA = ("inertia", "silhouette", "calinski_harabasz", "davies_bouldin")


def _blobs(n=800, d=4, centers=5, seed=0, dtype=np.float64, std=0.4):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-8.0, 8.0, size=(centers, d))
    y = rng.integers(0, centers, size=n)
    return (means[y] + std * rng.standard_normal((n, d))).astype(dtype)


@pytest.mark.parametrize("spec", ["2:9", "2:33:3", "2,4,8", "8,4,4,2",
                                  range(3, 7), [5, 1, 3]])
def test_parse_k_range_matches_jax(spec):
    assert ps.parse_k_range(spec) == js.parse_k_range(spec)


@pytest.mark.parametrize("spec", ["", "2:", "a:b", "1:2:3:4", 7, [], [0, 2]])
def test_parse_k_range_refusals_match_jax(spec):
    with pytest.raises(ValueError) as want:
        js.parse_k_range(spec)
    with pytest.raises(ValueError) as got:
        ps.parse_k_range(spec)
    assert str(got.value) == str(want.value)


CURVES = [([2, 3, 4, 5, 6], [100.0, 40.0, 20.0, 18.0, 17.0]),
          ([2, 3], [10.0, 5.0]),
          ([2, 4, 8, 16], [1.0, 2.0, 3.0, 4.0]),
          ([1, 2, 3, 4], [50.0, np.nan, 10.0, 9.0]),
          ([2, 3, 4, 5], [9.0, 8.0, 7.0, 6.0])]


@pytest.mark.parametrize("ks,curve", CURVES)
@pytest.mark.parametrize("criterion", CRITERIA + ("bic",))
def test_selection_rules_match_jax(ks, curve, criterion):
    assert ps.elbow_index(ks, curve) == js.elbow_index(ks, curve)
    assert ps.select_k(ks, curve, criterion) == \
        js.select_k(ks, curve, criterion)
    win = np.arange(len(ks)) * 2
    assert ps.selected_member(ks, curve, criterion, win) == \
        js.selected_member(ks, curve, criterion, win)


@pytest.mark.parametrize("maximize", [False, True])
def test_within_k_winners_match_jax(maximize):
    vals = np.array([3.0, 1.0, np.nan, 2.0, 5.0, np.inf, 0.5, 0.5, 7.0])
    got = ps.within_k_winners(vals, 3, 3, maximize)
    want = js.within_k_winners(vals, 3, 3, maximize)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no finite"):
        ps.select_k([2, 3], [np.nan, np.nan], "inertia")
    with pytest.raises(ValueError, match="unknown criterion"):
        ps.check_criterion("bic", ps.KMEANS_CRITERIA)
    assert ps.KMEANS_CRITERIA == js.KMEANS_CRITERIA
    assert ps.GMM_CRITERIA == js.GMM_CRITERIA


@pytest.mark.parametrize("criterion", CRITERIA)
def test_sweep_matches_jax(mesh1, criterion):
    X = _blobs(seed=1)
    kw = dict(k=3, max_iter=30, seed=7, n_init=2, verbose=False,
              compute_sse=True, dtype=np.float64, distance_mode="matmul",
              empty_cluster="keep")
    jr = kmeans_tpu.KMeans(mesh=mesh1, **kw).sweep(
        X, k_range="2:9", criterion=criterion)
    pr = kmeans_tpu_torch.KMeans(device="cpu", **kw).sweep(
        X, k_range="2:9", criterion=criterion)
    assert pr.selected_k == jr.selected_k
    assert pr.selected_restart == jr.selected_restart
    assert pr.k_range == jr.k_range and pr.criterion == jr.criterion
    np.testing.assert_array_equal(np.argmin(pr.member_scores, axis=1),
                                  np.argmin(jr.member_scores, axis=1))
    np.testing.assert_allclose(pr.member_scores, jr.member_scores,
                               rtol=RTOL)
    np.testing.assert_array_equal(pr.n_iters, jr.n_iters)
    if criterion == "inertia":
        np.testing.assert_allclose(pr.scores, jr.scores, rtol=RTOL)
    else:
        np.testing.assert_allclose(pr.scores, jr.scores, rtol=1e-4,
                                   atol=1e-6)
    assert pr.n_dispatches == jr.n_dispatches
    best, jbest = pr.best_model, jr.best_model
    assert best.k == pr.selected_k and best.loop_path_ == "device-sweep"
    np.testing.assert_allclose(best.centroids, np.asarray(jbest.centroids),
                               rtol=RTOL, atol=1e-10)
    np.testing.assert_array_equal(best.predict(X),
                                  np.asarray(jbest.predict(X)))
    np.testing.assert_allclose(best.sse_history, jbest.sse_history,
                               rtol=RTOL)
    assert best.best_restart_ == jbest.best_restart_
    with pytest.raises(AttributeError, match="sweep"):
        _ = best.labels_
    summary = pr.summary()
    assert set(summary) == set(jr.summary())
    assert summary["selected_k"] == pr.selected_k
    assert [c.shape[0] for c in pr.winner_centroids] == list(pr.k_range)


@pytest.mark.parametrize("mode,dtype", [("kernel", np.float32),
                                        ("kernel_bf16", np.float32),
                                        ("matmul", np.float64),
                                        ("matmul_bf16_guarded", np.float64)])
@pytest.mark.parametrize("criterion", ["inertia", "davies_bouldin"])
def test_batched_sweep_equals_the_sequential_oracle(mode, dtype, criterion):
    X = torch.from_numpy(_blobs(seed=2, dtype=dtype))
    km = kmeans_tpu_torch.KMeans(k=3, max_iter=25, seed=3, n_init=2,
                                 verbose=False, compute_sse=True,
                                 dtype=dtype, distance_mode=mode,
                                 device="cpu", empty_cluster="resample")
    ds = km.cache(X)
    batched = km.sweep(ds, k_range=[2, 5, 7], criterion="inertia")
    sequential = km.sweep(ds, k_range=[2, 5, 7], criterion="inertia",
                          batched=0)
    assert batched.selected_k == sequential.selected_k
    np.testing.assert_array_equal(batched.n_iters, sequential.n_iters)
    if mode.startswith("kernel"):
        np.testing.assert_array_equal(batched.member_scores,
                                      sequential.member_scores)
    else:
        np.testing.assert_allclose(batched.member_scores,
                                   sequential.member_scores, rtol=RTOL)
    assert sequential.best_model.loop_path_ == "sequential-sweep"
    if criterion != "inertia":
        host = kmeans_tpu_torch.KMeans(
            k=3, max_iter=25, seed=3, n_init=2, verbose=False, dtype=dtype,
            distance_mode=mode, device="cpu")
        a = host.sweep(X.numpy(), k_range=[2, 5, 7], criterion=criterion)
        b = host.sweep(X.numpy(), k_range=[2, 5, 7], criterion=criterion,
                       batched=0)
        assert a.selected_k == b.selected_k
        if mode != "kernel_bf16":
            # In 'kernel_bf16' the batched labels come from the bf16 torch
            # product, the sequential ones from kernel 2b: near-ties differ.
            np.testing.assert_allclose(a.scores, b.scores, rtol=1e-6)
    if mode == "matmul_bf16_guarded":
        assert batched.best_model.bf16_guard_corrected_rows_ == \
            km.bf16_guard_corrected_rows_ is not None


def test_sweep_refusals_match_jax():
    X = _blobs(n=60, seed=4)
    pm = kmeans_tpu_torch.KMeans(k=3, device="cpu", verbose=False)
    with pytest.raises(ValueError, match="criterion"):
        pm.sweep(X, k_range="2:5", criterion="bic")
    with pytest.raises(ValueError, match="needs k >= 2"):
        pm.sweep(X, k_range="1:5", criterion="silhouette")
    with pytest.raises(ValueError, match="must be < n"):
        pm.sweep(X, k_range=[2, 60])
    with pytest.raises(ValueError, match="explicit"):
        kmeans_tpu_torch.KMeans(k=3, init=X[:3], device="cpu").sweep(
            X, k_range="2:4")
    x = torch.from_numpy(X)
    hostless = Dataset(x, torch.ones(60, dtype=x.dtype))
    with pytest.raises(ValueError, match="scores host rows"):
        kmeans_tpu_torch.KMeans(k=3, device="cpu", dtype=np.float64,
                                verbose=False).sweep(
            hostless, k_range="2:4", criterion="silhouette")


def _collapsing_init(X, k, seed):
    """k = 3: one row and two centroids far from every row (they stay
    empty under 'keep'); k = 2: one row of each group."""
    if k == 3:
        return np.concatenate([X[:1], np.full((2, X.shape[1]), 1e6)])
    return X[[0, -1]]


def test_a_collapsed_winner_scores_nan_and_is_never_selected():
    """Under 'keep', a winner whose labels occupy one cluster only scores
    NaN, and the other k is selected."""
    X = np.concatenate([np.zeros((30, 2)), np.ones((30, 2)) * 50.0])
    X += np.random.default_rng(0).normal(scale=1e-3, size=X.shape)
    km = kmeans_tpu_torch.KMeans(k=2, max_iter=10, device="cpu",
                                 verbose=False, dtype=np.float64,
                                 empty_cluster="keep", init=_collapsing_init)
    res = km.sweep(X, k_range=[2, 3], criterion="silhouette")
    assert np.isnan(res.scores[1]) and res.selected_k == 2
