"""kmeans_tpu_torch.MiniBatchKMeans against kmeans_tpu.MiniBatchKMeans on the
CPU, and the device engine's invariants.

``sampling='host'`` draws its batches, its candidate inits' scoring subset
and its reassignment candidates with the same NumPy generators in both
packages, so in float64 'matmul' the two fits take the same steps: the
float64 parity class (iterations and batch counts equal, centroids and
``sse_history`` to ``rtol=1e-12`` / ``atol=1e-10``).

``sampling='device'`` draws on the device by integer hashing
(``parallel.distributed.minibatch_rows``), other rows than the JAX
package's ``jax.random`` draws.  Its arithmetic is held, in float64 to
``rtol=1e-12``, against independent updates fed the same batches: the JAX
package's ``partial_fit`` sequence without reassignment, and
:func:`sculley_oracle` (NumPy, the host reassignment rule) with it.  Its
draws are held by their invariants and by quality: the same seed gives the
same fit, the per-iteration engine and the loop give the same bits, a
batch is distinct rows (one per rotated stratum), every row is reachable,
candidates are rows of positive weight, and the final SSE is within 1.25
times a full-batch fit's (the bound of the JAX package's
``test_minibatch_device.py``).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu_torch import KMeans, MiniBatchKMeans, convert  # noqa: E402
from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402
from kmeans_tpu_torch.utils import faults  # noqa: E402


def _blobs(n=4000, d=8, centers=5, seed=2, dtype=np.float32, std=0.8):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-6.0, 6.0, size=(centers, d))
    y = rng.integers(0, centers, size=n)
    return (means[y] + std * rng.standard_normal((n, d))).astype(dtype)


def _port(**kw):
    kw.setdefault("verbose", False)
    return MiniBatchKMeans(device="cpu", **kw)


def batch_rows(n, batch, stream, data=1):
    """Global rows of one iteration's batch under ``data`` blocks of the
    data axis (blocks of ``ceil(n / data)`` rows, the last padded), in the
    order of the blocks: the draws of ``minibatch_rows``."""
    block = -(-n // data)
    return np.concatenate([
        s * block + dist.minibatch_rows(block, batch, stream, s).numpy()
        for s in range(data)])


def sculley_oracle(X, W, C0, *, seed, batch, max_iter, tolerance, ratio,
                   every, data=1):
    """The device engine's fit recomputed in float64 NumPy on the batches
    that its draws pick (:func:`batch_rows`; the candidates are the
    positions that ``_batch_candidates`` picks on the whole batch): the
    direct nearest centre, the Sculley update ``c <- (1 - eta) c + eta *
    mean`` with ``eta = counts / seen``, every ``every`` iterations the
    host rule of reassignment (the flagged centres below ``ratio *
    max(seen)`` take the candidates in slot order and the least count of
    the kept ones), the SSE scaled by the total weight over the batch's.
    Returns ``(centroids, seen, counts, sse_history, reassigned)``."""
    n, d = X.shape
    k = C0.shape[0]
    block = -(-n // data)
    Xp = np.zeros((block * data, d))
    Wp = np.zeros(block * data)
    Xp[:n], Wp[:n] = X, W
    keys = torch.from_numpy(dist.minibatch_keys(seed))
    c, seen = np.array(C0, np.float64), np.zeros(k)
    sse_history, reassigned = [], 0
    for i in range(max_iter):
        stream = dist.minibatch_streams(keys, i)
        rows = batch_rows(n, batch, stream, data)
        bx, bw = Xp[rows], Wp[rows]
        d2 = ((bx[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        lab = d2.argmin(1)
        counts = np.bincount(lab, weights=bw, minlength=k)
        sums = np.zeros((k, d))
        np.add.at(sums, lab, bw[:, None] * bx)
        sse = float((bw * d2[np.arange(len(rows)), lab]).sum())
        seen = seen + counts
        eta = (counts / np.maximum(seen, 1.0))[:, None]
        mean = sums / np.maximum(counts, 1.0)[:, None]
        new = np.where(counts[:, None] > 0, (1.0 - eta) * c + eta * mean,
                       c)
        if ratio > 0 and (i + 1) % every == 0:
            idx, valid = dist._batch_candidates(torch.from_numpy(bw),
                                                stream, k)
            cand = bx[idx.numpy()[valid.numpy()]]
            flagged = seen < ratio * seen.max()
            slots = np.flatnonzero(flagged)[:len(cand)]
            new[slots] = cand[:len(slots)]
            kept = seen[~flagged]
            seen[slots] = kept.min() if kept.size else 0.0
            reassigned += len(slots)
        shift = float(np.sqrt(((new - c) ** 2).sum(1)).max())
        sse_history.append(sse * W.sum() / max(counts.sum(), 1.0))
        c = new
        if shift < tolerance:
            break
    return c, seen, counts, np.asarray(sse_history), reassigned


# ------------------------------------------------------------ host sampling


@pytest.mark.parametrize("init", ["forgy", "k-means++"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reassign", [0.0, 0.3])
def test_host_sampling_matches_the_jax_package(mesh1, init, weighted,
                                               reassign):
    X = _blobs(dtype=np.float64)
    w = None
    if weighted:
        w = np.random.default_rng(5).uniform(0.5, 2.0, size=X.shape[0])
        w[::9] = 0.0
    common = dict(k=6, max_iter=25, seed=11, batch_size=300, init=init,
                  sampling="host", compute_sse=True, dtype=np.float64,
                  distance_mode="matmul", tolerance=1e-12,
                  reassignment_ratio=reassign, verbose=False)
    jm = kmeans_tpu.MiniBatchKMeans(mesh=mesh1, **common).fit(
        X, sample_weight=w)
    pm = _port(**common).fit(X, sample_weight=w)
    assert pm.iterations_run == jm.iterations_run == 25
    np.testing.assert_array_equal(pm.cluster_sizes_, jm.cluster_sizes_)
    np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids),
                               rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(pm._seen, jm._seen, rtol=1e-12)
    np.testing.assert_allclose(pm.sse_history, jm.sse_history, rtol=1e-12)
    np.testing.assert_array_equal(pm.labels_, np.asarray(jm.labels_))


def test_reassignment_reseeds_dead_centres(mesh1, capsys):
    """A centre far from every row never takes a batch row; every
    ``10 k / batch + 1`` iterations the reassignment moves it onto a batch
    row, as in the JAX package."""
    X = _blobs(dtype=np.float64)
    init = np.concatenate([X[:4], np.full((1, X.shape[1]), 1e3)])
    common = dict(k=5, max_iter=12, seed=4, batch_size=200, init=init,
                  sampling="host", dtype=np.float64, distance_mode="matmul",
                  tolerance=1e-12, reassignment_ratio=0.01)
    pm = MiniBatchKMeans(device="cpu", verbose=True, **common).fit(X)
    assert "reassigned" in capsys.readouterr().out
    assert np.abs(pm.centroids).max() < 100
    jm = kmeans_tpu.MiniBatchKMeans(mesh=mesh1, verbose=False,
                                    **common).fit(X)
    np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids),
                               rtol=1e-12, atol=1e-10)
    assert pm._reassign_every(200) == 1


@pytest.mark.parametrize("sampling", ["host", "device"])
def test_candidate_inits_are_scored(mesh1, sampling):
    X = _blobs(dtype=np.float64)
    common = dict(k=5, max_iter=5, seed=21, batch_size=256, n_init=3,
                  sampling=sampling, dtype=np.float64,
                  distance_mode="matmul", verbose=False)
    pm = _port(**common).fit(X)
    assert pm.init_inertias_.shape == (3,)
    assert pm.best_init_ == int(np.argmin(pm.init_inertias_))
    jm = kmeans_tpu.MiniBatchKMeans(mesh=mesh1, **common).fit(X)
    np.testing.assert_allclose(pm.init_inertias_, jm.init_inertias_,
                               rtol=1e-12)
    assert pm.best_init_ == jm.best_init_
    assert _port(k=5, n_init="auto").n_init == 3


def test_partial_fit_sequence_matches_the_jax_package(mesh1):
    X = _blobs(dtype=np.float64)
    common = dict(k=4, seed=8, dtype=np.float64, distance_mode="matmul",
                  compute_sse=True, verbose=False)
    pm = _port(**common)
    jm = kmeans_tpu.MiniBatchKMeans(mesh=mesh1, **common)
    for lo in range(0, 2000, 250):
        pm.partial_fit(X[lo:lo + 250])
        jm.partial_fit(X[lo:lo + 250])
    assert pm.iterations_run == jm.iterations_run == 8
    np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids),
                               rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(pm.sse_history, jm.sse_history, rtol=1e-12)
    assert pm.labels_.shape == (250,)
    np.testing.assert_array_equal(pm.labels_, np.asarray(jm.labels_))
    with pytest.raises(ValueError, match="sample_weight"):
        pm.partial_fit(X[:10], sample_weight=np.ones(10))
    with pytest.raises(ValueError, match="features"):
        pm.partial_fit(X[:10, :3])


@pytest.mark.parametrize("family", ["KMeans", "MiniBatchKMeans",
                                    "BisectingKMeans", "SphericalKMeans"])
@pytest.mark.parametrize("init", ["forgy", "k-means++", "k-means||",
                                  "kmeans||"])
def test_n_init_auto_resolves_as_in_the_jax_package(family, init):
    """``n_init='auto'``: 1 for the D^2-seeded inits, k-means|| among
    them (ROADMAP C.10: the port gave it 10), else 10, or 3 for the
    mini-batch family."""
    import kmeans_tpu_torch
    pt = getattr(kmeans_tpu_torch, family)(k=3, device="cpu",
                                           n_init="auto", init=init)
    jx = getattr(kmeans_tpu, family)(k=3, n_init="auto", init=init)
    assert pt.n_init == jx.n_init


# ---------------------------------------------------------- device sampling


def test_batch_rows_are_distinct_and_every_row_is_reachable():
    n, batch = 1003, 64
    keys = torch.from_numpy(dist.minibatch_keys(7))
    streams = dist.minibatch_streams(keys, torch.arange(400))
    seen = np.zeros(n, bool)
    for it in range(400):
        rows = dist.minibatch_rows(n, batch, streams[it]).numpy()
        assert len(np.unique(rows)) == batch
        assert rows.min() >= 0 and rows.max() < n
        seen[rows] = True
        again = dist.minibatch_rows(
            n, batch, dist.minibatch_streams(keys, it)).numpy()
        np.testing.assert_array_equal(rows, again)
    assert seen.all()                     # every row is reachable
    other = dist.minibatch_rows(n, batch, dist.minibatch_streams(
        torch.from_numpy(dist.minibatch_keys(8)), 0))
    first = dist.minibatch_rows(n, batch, streams[0]).numpy()
    assert not np.array_equal(other.numpy(), first)
    with pytest.raises(ValueError, match="batch"):
        dist.minibatch_rows(10, 11, streams[0])


def test_strata_hold_one_row_each():
    n, batch = 1000, 100
    keys = torch.from_numpy(dist.minibatch_keys(3))
    for it in range(50):
        rows = dist.minibatch_rows(
            n, batch, dist.minibatch_streams(keys, it)).numpy()
        # One rotation, the same for every row, puts one row in each
        # stratum of 10.
        for rho in range(n):
            strata = ((rows - rho) % n) // 10
            if len(np.unique(strata)) == batch:
                break
        else:
            pytest.fail(f"iteration {it}: no rotation leaves one row per "
                        f"stratum")


def test_candidates_are_positive_weight_batch_rows():
    keys = torch.from_numpy(dist.minibatch_keys(1))
    bw = torch.ones(50, dtype=torch.float64)
    bw[::3] = 0.0
    for it in range(20):
        idx, valid = dist._batch_candidates(
            bw, dist.minibatch_streams(keys, it), 40)
        got = idx[valid].numpy()
        assert valid.sum() == int((bw > 0).sum())    # 33 of 40 slots
        assert len(np.unique(got)) == len(got)
        assert np.all(bw.numpy()[got] > 0)
        assert not valid[33:].any()
    idx, valid = dist._batch_candidates(
        bw, dist.minibatch_streams(keys, 0), 80)          # k > batch
    assert idx.shape == (80,) and int(valid.sum()) == 33


def test_reassignment_on_the_device_is_the_host_rule():
    seen = torch.tensor([50.0, 0.1, 30.0, 0.2, 40.0], dtype=torch.float64)
    new = torch.zeros((5, 2), dtype=torch.float64)
    cands = torch.tensor([[1.0, 1.0], [2.0, 2.0]], dtype=torch.float64)
    out, s = dist.apply_reassignment(new, seen, cands,
                                     torch.tensor([True, True]),
                                     torch.tensor(True), 0.01)
    np.testing.assert_array_equal(out.numpy()[[1, 3]], cands.numpy())
    np.testing.assert_array_equal(s.numpy(), [50.0, 30.0, 30.0, 30.0, 40.0])
    out, s = dist.apply_reassignment(new, seen, cands,
                                     torch.tensor([True, True]),
                                     torch.tensor(False), 0.01)
    assert not out.any() and torch.equal(s, seen)


@pytest.mark.parametrize("loop", ["host", "device"])
def test_device_sampling_is_the_jax_partial_fit_sequence(mesh1, loop):
    """Without reassignment the device engine's iterations are the JAX
    package's ``partial_fit`` on the same batches (its SSE is of the batch,
    the engine's is scaled by n over the batch's rows).  Float64 'matmul':
    the kernel modes compute their statistics in float32."""
    X = _blobs(n=3000, dtype=np.float64)
    C0 = X[[0, 500, 1000, 1500, 2000, 2500]]
    n, bs, iters = X.shape[0], 128, 15
    pm = _port(k=6, seed=9, batch_size=bs, max_iter=iters, init=C0,
               n_init=1, tolerance=1e-12, reassignment_ratio=0.0,
               compute_sse=True, dtype=np.float64, distance_mode="matmul",
               host_loop=loop == "host").fit(X)
    jm = kmeans_tpu.MiniBatchKMeans(k=6, seed=9, init=C0, mesh=mesh1,
                                    reassignment_ratio=0.0,
                                    compute_sse=True, dtype=np.float64,
                                    distance_mode="matmul", verbose=False)
    keys = torch.from_numpy(dist.minibatch_keys(9))
    for i in range(iters):
        jm.partial_fit(X[batch_rows(n, bs, dist.minibatch_streams(keys, i))])
    assert pm.iterations_run == jm.iterations_run == iters
    np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids),
                               rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(pm._seen, jm._seen, rtol=1e-12)
    np.testing.assert_array_equal(pm.cluster_sizes_, jm.cluster_sizes_)
    np.testing.assert_allclose(pm.sse_history,
                               np.asarray(jm.sse_history) * n / bs,
                               rtol=1e-12)


@pytest.mark.parametrize("loop", ["host", "device"])
def test_device_sampling_is_the_numpy_sculley_update(loop):
    """With weights (some 0) and a reassignment every iteration, the device
    engine is :func:`sculley_oracle` on the same batches and candidates."""
    X = _blobs(n=3000, dtype=np.float64)
    w = np.random.default_rng(3).uniform(0.2, 2.0, size=X.shape[0])
    w[::5] = 0.0
    C0 = np.concatenate([X[[1, 700, 1400, 2100]],
                         np.full((2, X.shape[1]), 40.0)])
    kw = dict(seed=13, batch_size=96, max_iter=20, tolerance=1e-12)
    pm = _port(k=6, init=C0, n_init=1, reassignment_ratio=0.3,
               compute_sse=True, dtype=np.float64, distance_mode="matmul",
               host_loop=loop == "host", **kw).fit(X, sample_weight=w)
    every = pm._reassign_every(96)
    c, seen, counts, sse, reassigned = sculley_oracle(
        X, w, C0, seed=13, batch=96, max_iter=20, tolerance=1e-12,
        ratio=0.3, every=every)
    assert every == 1 and reassigned >= 2     # the far centres moved
    assert pm.iterations_run == len(sse) == 20
    np.testing.assert_allclose(pm.centroids, c, rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(pm._seen, seen, rtol=1e-12)
    np.testing.assert_array_equal(pm.cluster_sizes_,
                                  counts.astype(np.int64))
    np.testing.assert_allclose(pm.sse_history, sse, rtol=1e-12)


def test_blocks_draw_their_own_rows():
    """Under a mesh each block of the data axis draws its own strata:
    block 0 draws what one device draws, the others other offsets."""
    keys = torch.from_numpy(dist.minibatch_keys(5))
    stream = dist.minibatch_streams(keys, 3)
    one = dist.minibatch_rows(500, 50, stream).numpy()
    np.testing.assert_array_equal(
        dist.minibatch_rows(500, 50, stream, 0).numpy(), one)
    others = [dist.minibatch_rows(500, 50, stream, s).numpy()
              for s in (1, 2)]
    for rows in others:
        assert len(np.unique(rows)) == 50 and rows.max() < 500
        assert not np.array_equal(rows % 10, one % 10)
    assert not np.array_equal(others[0], others[1])


def test_same_seed_same_fit_and_the_loop_equals_per_iteration():
    X = _blobs()
    kw = dict(k=5, seed=3, batch_size=256, max_iter=12, compute_sse=True,
              distance_mode="kernel", reassignment_ratio=0.3,
              tolerance=1e-12)
    a = _port(host_loop=True, **kw).fit(X)
    b = _port(host_loop=True, **kw).fit(X)
    c = _port(host_loop=False, **kw).fit(X)
    assert a.loop_path_ == "host" and c.loop_path_ == "device"
    assert a.iterations_run == c.iterations_run == 12
    for m in (b, c):
        np.testing.assert_array_equal(m.centroids, a.centroids)
        np.testing.assert_array_equal(m.sse_history, a.sse_history)
        np.testing.assert_array_equal(m._seen, a._seen)
        np.testing.assert_array_equal(m.cluster_sizes_, a.cluster_sizes_)
    d = _port(host_loop=True, **{**kw, "seed": 4}).fit(X)
    assert not np.array_equal(d.centroids, a.centroids)


@pytest.mark.parametrize("mode", ["kernel", "matmul"])
def test_device_sampling_converges_near_the_full_batch_fit(mode):
    X = _blobs()
    mb = _port(k=5, seed=0, batch_size=512, max_iter=60,
               distance_mode=mode).fit(X)
    full = KMeans(k=5, seed=0, verbose=False, device="cpu",
                  distance_mode=mode).fit(X)
    assert -mb.score(X) < -full.score(X) * 1.25
    assert mb.labels_.shape == (X.shape[0],)


def test_weighted_device_sampling_scales_the_statistics():
    X = _blobs(dtype=np.float64)
    w = np.ones(X.shape[0])
    w[X[:, 0] > 0] = 0.0
    mb = _port(k=3, seed=1, batch_size=400, max_iter=30, dtype=np.float64,
               compute_sse=True).fit(X, sample_weight=w)
    assert mb._total_w == float(w.sum())
    # Centres only ever move towards rows of positive weight.
    assert np.all(mb.centroids[:, 0] <= 0.5)


def test_dataset_without_a_host_copy(tmp_path):
    X = _blobs()
    km = _port(k=5, seed=1, batch_size=256, max_iter=10, init="k-means++")
    ds = km.cache(X)
    ds._host, ds._host_weights = None, None
    km.fit(ds)
    assert np.all(np.isfinite(km.centroids))
    assert km.labels_.shape == (len(X),)
    host = _port(k=5, sampling="host")
    ds2 = host.cache(X)
    ds2._host, ds2._host_weights = None, None
    with pytest.raises(ValueError, match="sampling='device'"):
        host.fit(ds2)


def test_refusals_name_their_reasons(tmp_path, mesh1):
    X = _blobs(n=300)
    with pytest.raises(ValueError, match="matmul_bf16_guarded"):
        _port(k=3, distance_mode="matmul_bf16_guarded",
              sampling="device").fit(X)
    with pytest.raises(ValueError, match="sampling"):
        _port(sampling="banana")
    with pytest.raises(ValueError, match="batch_size"):
        _port(batch_size=0)
    with pytest.raises(ValueError, match="reassignment_ratio"):
        _port(reassignment_ratio=-1)
    # Checkpoints are ported (ROADMAP A.9): a fit checkpointed every 2
    # iterations, killed after 2 and resumed from its file, gives the bits
    # of the uninterrupted fit; the other items still raise.
    kw = dict(k=3, max_iter=5, tolerance=1e-12, batch_size=64)
    full = _port(**kw).fit(X)
    with faults.inject_kill_after_iteration(2):
        with pytest.raises(faults.SimulatedPreemption):
            _port(**kw).fit(X, checkpoint_every=2,
                            checkpoint_path=tmp_path / "c")
    resumed = _port(**kw).fit(X, resume=tmp_path / "c")
    assert resumed.iterations_run == full.iterations_run == 5
    np.testing.assert_array_equal(resumed.centroids, full.centroids)
    np.testing.assert_array_equal(resumed._seen, full._seen)
    # A refusal by design, with the JAX package's message.
    with pytest.raises(NotImplementedError) as want:
        kmeans_tpu.MiniBatchKMeans(k=3, verbose=False).fit_stream(lambda: iter([]))
    with pytest.raises(NotImplementedError) as got:
        _port(k=3).fit_stream(lambda: iter([]))
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="A.12"):
        _port(k=3)._learn_clone()
    # The profile hooks are ported (ROADMAP A.13): the JAX package's values
    # before a fit and after one (lifetime counts, the fit's total weight).
    jx = kmeans_tpu.MiniBatchKMeans(k=3, verbose=False)
    assert _port(k=3)._profile_counts() is jx._profile_counts() is None
    assert _port(k=3)._profile_rows() is jx._profile_rows() is None
    hkw = dict(k=3, seed=4, max_iter=5, batch_size=64, init="forgy",
               sampling="host", dtype=np.float64, distance_mode="matmul",
               verbose=False)
    Xd = X.astype(np.float64)
    pm = _port(**hkw).fit(Xd)
    jm = kmeans_tpu.MiniBatchKMeans(mesh=mesh1, **hkw).fit(Xd)
    np.testing.assert_array_equal(pm._profile_counts(), jm._profile_counts())
    assert pm._profile_rows() == jm._profile_rows() == 300.0
    with pytest.raises(NotImplementedError, match="sweep"):
        _port(k=3).sweep(X, k_range=[2, 3])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("sampling", ["host", "device"])
def test_checkpoints_cross(tmp_path, mesh1, direction, sampling):
    X = _blobs(dtype=np.float64)
    path = tmp_path / "mb.npz"
    kw = dict(k=4, seed=2, dtype=np.float64, max_iter=6, batch_size=300,
              sampling=sampling, reassignment_ratio=0.05, verbose=False,
              compute_sse=True, distance_mode="matmul")
    if direction == "jax_to_port":
        src = kmeans_tpu.MiniBatchKMeans(mesh=mesh1, **kw).fit(X)
        src.save(path)
        other = MiniBatchKMeans.load(path, device="cpu")
        assert isinstance(convert.from_jax_state(src._state_dict(),
                                                 device="cpu"),
                          MiniBatchKMeans)
    else:
        src = _port(**kw).fit(X)
        src.save(path)
        other = kmeans_tpu.MiniBatchKMeans.load(path)
    assert other.sampling == sampling and other.batch_size == 300
    assert other.reassignment_ratio == 0.05
    np.testing.assert_array_equal(np.asarray(other.centroids),
                                  np.asarray(src.centroids))
    np.testing.assert_allclose(np.asarray(other._seen),
                               np.asarray(src._seen))
    np.testing.assert_array_equal(np.asarray(other.predict(X)),
                                  np.asarray(src.predict(X)))


def test_the_default_device_is_the_card():
    """Without ``device`` the model runs on the card, or raises where
    there is none: it never runs on the CPU unasked."""
    if torch.cuda.is_available():
        assert MiniBatchKMeans(k=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MiniBatchKMeans(k=2)


def _sse64(X, C):
    d2 = ((X.astype(np.float64)[:, None, :]
           - np.asarray(C, np.float64)[None, :, :]) ** 2).sum(-1)
    return float(d2.min(1).sum())


@pytest.mark.parametrize("call", ["fit", "partial_fit"])
def test_kmeans_parallel_seeds_on_the_models_device(call):
    """ROADMAP C.12: k-means|| seeds host rows on the model's device, so
    ``device='cpu'`` fits with host sampling and ``partial_fit`` draw
    their init on the CPU (they raised asking for a card).  k-means||
    draws other rows than the JAX package, so the fit is held by quality:
    its SSE within 1.2 times the JAX package's fit of the same data."""
    X = _blobs(n=3000, centers=3)
    kw = dict(k=3, seed=5, init="k-means||", sampling="host",
              batch_size=512, max_iter=10)
    pm = _port(**kw)
    jm = kmeans_tpu.MiniBatchKMeans(verbose=False, **kw)
    getattr(pm, call)(X)
    getattr(jm, call)(X)
    assert pm.device == torch.device("cpu")
    assert np.all(np.isfinite(pm.centroids))
    assert _sse64(X, pm.centroids) <= 1.2 * _sse64(X, jm.centroids)


GUARDED = "matmul_bf16_guarded"


def _labels_outside_band(X, C, labels):
    """Labels that differ from the float64 argmin where its margin clears
    the float32 band ``1e-4 (||x||^2 + max ||c||^2)``."""
    x, c = X.astype(np.float64), np.asarray(C, np.float64)
    d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    ref = d2.argmin(1)
    rows = np.flatnonzero(labels != ref)
    gap = np.abs(d2[rows, labels[rows]] - d2[rows, ref[rows]])
    scale = (x[rows] ** 2).sum(1) + (c ** 2).sum(1).max()
    return int((gap > 1e-4 * scale).sum())


@pytest.mark.parametrize("case", ["fit_host", "partial_fit_host",
                                  "partial_fit_device"])
def test_guarded_rung_runs_where_jax_runs_it(case):
    """ROADMAP C.13: the guarded bf16 rung is refused by the device
    sampling engine only, as in the JAX package: the host-sampling fit and
    ``partial_fit`` (either sampling) run the guarded full-batch step.
    Each is held to the JAX package's same call in float64: the same
    centroids to ``rtol=1e-12`` and, for both, labels equal to a float64
    argmin outside the band; and to the port's own 'matmul' run, bit for
    bit (the rung's labels, sums and counts are those of 'matmul')."""
    X = _blobs(n=1500, dtype=np.float64)
    sampling = "device" if case.endswith("device") else "host"
    kw = dict(k=4, seed=3, batch_size=256, max_iter=8, dtype=np.float64,
              init="forgy", sampling=sampling, distance_mode=GUARDED)
    pm, ref = _port(**kw), _port(**{**kw, "distance_mode": "matmul"})
    jm = kmeans_tpu.MiniBatchKMeans(verbose=False, **kw)
    for m in (pm, ref, jm):
        if case == "fit_host":
            m.fit(X)
        else:
            for i in range(3):
                m.partial_fit(X[i * 256:(i + 1) * 256])
    np.testing.assert_array_equal(pm.centroids, ref.centroids)
    np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids),
                               rtol=1e-12, atol=1e-10)
    for m in (pm, jm):
        labels = np.asarray(m.predict(X))
        assert _labels_outside_band(X, m.centroids, labels) == 0


def test_guarded_rung_device_fit_raises_as_jax_does():
    X = _blobs(n=600)
    kw = dict(k=3, seed=1, batch_size=128, max_iter=3, sampling="device",
              distance_mode=GUARDED)
    with pytest.raises(ValueError, match=GUARDED) as got:
        _port(**kw).fit(X)
    with pytest.raises(ValueError, match=GUARDED) as want:
        kmeans_tpu.MiniBatchKMeans(verbose=False, **kw).fit(X)
    assert str(got.value) == str(want.value)
