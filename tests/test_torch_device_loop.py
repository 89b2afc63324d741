"""The device loop of kmeans_tpu_torch (``KMeans(host_loop=False)``,
``parallel.distributed.make_fit_fn``) on the CPU, where it runs eagerly.

It is held against the port's own host loop (the same step, the same
draws on a dataset without a host copy), and against the JAX package's
device loop (``kmeans_tpu.KMeans(host_loop=False)``) in float64.
Tolerances: float64, the parity class of ROADMAP's standing constraints:
``n_iter_`` equal, centroids and SSE history to ``rtol=1e-12``,
``atol=1e-10``.  Against the port's host loop the kernel modes are exact in
float32 too: both divide float32 sums, and the quotient rounds to the same
float32 whether it is taken in float32 or in float64.  The JAX package
draws its 'resample' rows with its own PRNG, so 'resample' is held by
quality there: distinct positive-weight rows, the same for the same seed.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu_torch.models import kmeans as km_mod  # noqa: E402
from kmeans_tpu_torch.ops import assign as pt_assign  # noqa: E402
from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402

RTOL, ATOL = 1e-12, 1e-10
POLICIES = ("keep", "farthest", "resample")


def _blobs(n=1200, d=6, centers=5, seed=0, dtype=np.float64, std=0.7):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-4.0, 4.0, size=(centers, d))
    y = rng.integers(0, centers, size=n)
    return (means[y] + std * rng.standard_normal((n, d))).astype(dtype)


def _forced_empty_init(X, k=8, dups=3):
    """k initial centroids whose first ``dups`` are one row: all but the
    first of them start empty (ties go to the lowest index)."""
    return X[[0] * dups + list(range(1, k - dups + 1))].copy()


def _fit(X, host_loop, **kw):
    args = dict(k=8, max_iter=25, compute_sse=True, verbose=False,
                device="cpu")
    args.update(kw)
    return kmeans_tpu_torch.KMeans(host_loop=host_loop, **args).fit(X)


def _same(a, b, rtol=RTOL, atol=ATOL):
    assert a.iterations_run == b.iterations_run
    np.testing.assert_allclose(a.centroids, b.centroids, rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(a.sse_history, b.sse_history, rtol=rtol,
                               atol=atol)
    np.testing.assert_array_equal(a.cluster_sizes_, b.cluster_sizes_)


@pytest.mark.parametrize("mode", ["matmul", "kernel", "direct"])
@pytest.mark.parametrize("policy", POLICIES)
def test_device_loop_matches_the_host_loop_in_float64(policy, mode):
    """A tensor input has no host copy, so 'resample' draws with the one
    engine both loops share."""
    X = torch.from_numpy(_blobs())
    init = _forced_empty_init(X.numpy())
    kw = dict(init=init, empty_cluster=policy, distance_mode=mode,
              dtype=np.float64)
    host, dev = _fit(X, True, **kw), _fit(X, False, **kw)
    assert (host.loop_path_, dev.loop_path_) == ("host", "device")
    assert len(dev.iter_times_) == dev.iterations_run
    _same(dev, host)


@pytest.mark.parametrize("mode", ["kernel", "kernel_bf16"])
@pytest.mark.parametrize("policy", POLICIES)
def test_device_loop_is_bit_equal_to_the_host_loop_in_float32(policy, mode):
    X = torch.from_numpy(_blobs(dtype=np.float32))
    kw = dict(init=_forced_empty_init(X.numpy()), empty_cluster=policy,
              distance_mode=mode)
    host, dev = _fit(X, True, **kw), _fit(X, False, **kw)
    assert dev.iterations_run == host.iterations_run
    np.testing.assert_array_equal(dev.centroids, host.centroids)
    assert dev.sse_history == host.sse_history


@pytest.mark.parametrize("policy", ["keep", "farthest"])
def test_device_loop_matches_the_jax_device_loop(mesh1, policy):
    """One forced empty slot: 'farthest' fills it with the farthest point
    and draws nothing (the JAX package would draw any further ones with its
    own PRNG)."""
    X = _blobs(seed=3)
    init = _forced_empty_init(X, dups=2)
    kw = dict(k=8, max_iter=25, compute_sse=True, verbose=False,
              init=init, empty_cluster=policy, distance_mode="matmul",
              dtype=np.float64, host_loop=False)
    jm = kmeans_tpu.KMeans(mesh=mesh1, **kw).fit(X)
    pm = kmeans_tpu_torch.KMeans(device="cpu", **kw).fit(X)
    assert jm.loop_path_ == pm.loop_path_ == "device"
    assert pm.iterations_run == jm.iterations_run
    np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pm.sse_history, jm.sse_history, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(pm.predict(X), np.asarray(jm.predict(X)))


def test_resample_draws_distinct_positive_rows_and_repeats_per_seed(mesh1):
    """One iteration with forced empties: each emptied slot holds a row of
    positive weight, no two the same; the same seed draws the same rows,
    another seed others.  The JAX package's device loop, drawing with its
    own PRNG, reaches the same final SSE within 5 %."""
    X = _blobs(n=800, seed=4)
    w = np.ones(len(X))
    w[::3] = 0.0
    init = _forced_empty_init(X, k=10, dups=5)
    kw = dict(k=10, init=init, empty_cluster="resample", dtype=np.float64,
              verbose=False, device="cpu", host_loop=False)
    one = kmeans_tpu_torch.KMeans(max_iter=1, **kw)
    ds = one.cache(torch.from_numpy(X), sample_weight=w)
    drawn = one.fit(ds).centroids[1:5]
    rows = [np.flatnonzero((X == r).all(1)) for r in drawn]
    assert all(len(r) == 1 and w[r[0]] > 0 for r in rows)
    assert len({int(r[0]) for r in rows}) == 4
    again = kmeans_tpu_torch.KMeans(max_iter=1, **kw).fit(ds).centroids
    np.testing.assert_array_equal(again[1:5], drawn)
    other = kmeans_tpu_torch.KMeans(max_iter=1, seed=7, **kw).fit(ds)
    assert not np.array_equal(other.centroids[1:5], drawn)
    full = dict(kw, max_iter=30, compute_sse=True)
    pm = kmeans_tpu_torch.KMeans(**full).fit(ds)
    full.pop("device")
    jm = kmeans_tpu.KMeans(mesh=mesh1, **full).fit(X, sample_weight=w)
    assert abs(pm.sse_history[-1] / jm.sse_history[-1] - 1.0) < 0.05


def test_converging_inside_the_in_flight_window_changes_nothing():
    """Iterations queued after convergence are masked: the state, the
    histories and the count are those of a loop that reads every flag."""
    X = torch.from_numpy(_blobs(seed=5))
    km = kmeans_tpu_torch.KMeans(k=6, device="cpu", dtype=np.float64,
                                 verbose=False)
    ds = km.cache(X)
    c0 = torch.from_numpy(km._init_centroids(ds, 42))
    out = {}
    for depth in (0, 3):
        fit = dist.make_fit_fn(chunk_size=512, mode="matmul", max_iter=60,
                               tolerance=1e-3, empty_policy="resample",
                               in_flight=depth)
        out[depth] = fit(ds, c0, 42)
    a, b = out[0], out[3]
    assert a.n_iters < 50 and a.finite
    assert (a.launched, b.launched) == (a.n_iters, a.n_iters + 3)
    assert b.n_iters == a.n_iters
    assert torch.equal(a.centroids, b.centroids)
    np.testing.assert_array_equal(a.sse_history, b.sse_history)
    np.testing.assert_array_equal(a.shift_history, b.shift_history)
    np.testing.assert_array_equal(a.counts, b.counts)
    assert a.shift_history[-1] < 1e-3 <= a.shift_history[-2]


@pytest.mark.parametrize("compute_sse", [True, False])
@pytest.mark.parametrize("mode", ["kernel", "kernel_bf16", "matmul"])
def test_divergence_is_named_at_the_host_loops_iteration(mode, compute_sse):
    """A zero-weight NaN row: the kernels keep it out of the sums, and
    ``sum w ||x||^2`` (0 * NaN) carries it; the torch pass carries it into
    every centroid.  Either way both loops name iteration 1."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((64, 8)).astype(np.float32)
    X[3, 2] = np.nan
    w = np.ones(64, np.float32)
    w[3] = 0.0
    kw = dict(k=5, init=X[[0, 10, 20, 30, 40]].copy(), max_iter=5,
              compute_sse=compute_sse, distance_mode=mode, verbose=False,
              device="cpu")
    errors = []
    for host_loop in (True, False):
        with pytest.raises(km_mod.NumericalDivergenceError) as err:
            kmeans_tpu_torch.KMeans(host_loop=host_loop, **kw).fit(
                X, sample_weight=w)
        errors.append(err.value)
    assert errors[0].iteration == errors[1].iteration == 1
    assert str(errors[0]) == str(errors[1])


def test_n_init_runs_the_restarts_through_the_device_loop():
    X = torch.from_numpy(_blobs(seed=6))
    kw = dict(n_init=3, dtype=np.float64, distance_mode="matmul",
              empty_cluster="resample")
    host, dev = _fit(X, True, **kw), _fit(X, False, **kw)
    assert dev.loop_path_ == "device"
    assert dev.best_restart_ == host.best_restart_
    np.testing.assert_allclose(dev.restart_inertias_, host.restart_inertias_,
                               rtol=RTOL, atol=ATOL)
    _same(dev, host)


def test_host_loop_auto_is_the_host_loop_at_a_small_round_trip():
    km = _fit(_blobs(), "auto", dtype=np.float64)
    assert km.host_loop == "auto" and km.loop_path_ == "host"
    assert km.auto_rtt_ is not None and km.auto_rtt_ < 5e-3


@pytest.mark.parametrize("verbose,policy,path", [
    (False, "keep", "device"), (True, "keep", "host"),
    (False, "resample", "host")])
def test_host_loop_auto_switches_only_where_the_loops_agree(
        monkeypatch, verbose, policy, path):
    """A round trip of one second: 'auto' takes the device loop, unless the
    fit logs each iteration or draws its 'resample' rows on the host (a
    NumPy input has a host copy); each outcome says so once."""
    monkeypatch.setattr(km_mod, "_RTT_CACHE", {"cpu": 1.0})
    monkeypatch.setattr(km_mod, "_HINTS_EMITTED", set())
    X = _blobs(dtype=np.float32)
    with pytest.warns(km_mod.DispatchLatencyHint):
        km = _fit(X, "auto", verbose=verbose, empty_cluster=policy,
                  max_iter=3)
    assert km.loop_path_ == path and km.auto_rtt_ == 1.0


@pytest.mark.parametrize("mode", ["matmul", "matmul_bf16", "direct"])
def test_pipeline_is_bit_equal_to_the_serial_schedule(mode):
    X = _blobs(n=1000, dtype=np.float32)
    kw = dict(distance_mode=mode, chunk_size=96, max_iter=8)
    serial, piped = _fit(X, True, pipeline=0, **kw), \
        _fit(X, True, pipeline=1, **kw)
    assert (serial.estep_path_, piped.estep_path_) == ("serial", "pipelined")
    np.testing.assert_array_equal(piped.centroids, serial.centroids)
    assert piped.sse_history == serial.sse_history
    on_device = _fit(X, False, pipeline=1, **kw)
    np.testing.assert_array_equal(on_device.centroids, serial.centroids)
    pts, c = torch.from_numpy(X), torch.from_numpy(X[:7])
    w = torch.ones(len(X))
    a = pt_assign.assign_reduce(pts, w, c, chunk_size=96, mode=mode)
    b = pt_assign.assign_reduce(pts, w, c, chunk_size=96, mode=mode,
                                pipeline=1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_kernel_modes_ignore_the_pipeline_knob():
    km = _fit(_blobs(dtype=np.float32), True, distance_mode="kernel",
              pipeline=1)
    assert km.pipeline == 1 and km.estep_path_ == "fused-pallas"
    assert km._resolve_pipeline("kernel") == 0
    with pytest.raises(ValueError, match="pipeline"):
        kmeans_tpu_torch.KMeans(k=3, device="cpu", pipeline=2)
    with pytest.raises(ValueError, match="host_loop"):
        kmeans_tpu_torch.KMeans(k=3, device="cpu", host_loop="sometimes")


@pytest.mark.parametrize("host_loop", [True, False])
def test_weighted_sqnorm_is_computed_once_per_fit(monkeypatch, host_loop):
    """The kernel modes' SSE reads ``sum w ||x||^2``: once per dataset, the
    same bits as a step that computes it again each time."""
    calls = []
    real = dist._weighted_sqnorm_total

    def counting(points, weights):
        calls.append(1)
        return real(points, weights)

    X = _blobs(dtype=np.float32)
    every_step = _fit(X, True, distance_mode="kernel", tolerance=1e-9)
    monkeypatch.setattr(dist, "_weighted_sqnorm_total", counting)
    km = _fit(X, host_loop, distance_mode="kernel", tolerance=1e-9)
    assert km.iterations_run > 3 and len(calls) == 1
    assert km.sse_history == every_step.sse_history


def test_step_elides_what_nobody_reads():
    X = torch.from_numpy(_blobs(n=500, dtype=np.float32))
    w, c = torch.ones(500), X[:6].clone()
    for mode in ("kernel", "matmul"):
        full = dist.make_step_fn(chunk_size=128, mode=mode)(X, w, c)
        lean = dist.make_step_fn(chunk_size=128, mode=mode,
                                 need_farthest=False,
                                 need_sse_pc=False)(X, w, c)
        for name in ("sums", "counts", "sse"):
            assert torch.equal(getattr(full, name), getattr(lean, name))
        assert float(lean.farthest_dist) == -1.0
        assert float(lean.sse_per_cluster.abs().sum()) == 0.0
        assert float(full.farthest_dist) > 0


def test_checkpoints_carry_the_loop_options(tmp_path):
    X = _blobs(dtype=np.float32)
    km = _fit(X, False, pipeline=1, max_iter=4)
    km.save(tmp_path / "m.npz")
    back = kmeans_tpu_torch.KMeans.load(tmp_path / "m.npz", device="cpu")
    assert back.host_loop is False and back.pipeline == 1
    jm = kmeans_tpu.KMeans.load(tmp_path / "m.npz")
    assert jm.host_loop is False and jm.pipeline == 1
    np.testing.assert_array_equal(back.predict(X), np.asarray(jm.predict(X)))
