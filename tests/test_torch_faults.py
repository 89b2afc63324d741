"""Fault tolerance of kmeans_tpu_torch against the JAX package, on the CPU.

The registries (``utils.faults``), the chunk backoff, the OOM
classification, the checkpoint helpers and ``NumericalDivergenceError`` are
held to the JAX package's own by identical inputs.  Segmented and
killed-and-resumed ``KMeans`` fits are held bit for bit to the plain fit in
the port, and to the JAX package's segmented fit in float64 (``rtol=1e-12``,
``atol=1e-10``, equal iteration counts and ``checkpoint_segments_``).  The
recovery paths (the torn-file fallback, the model and ``k`` checks, the
rollback and the stale-checkpoint rule, the out-of-memory replay) run
through the real fit code, the kernel modes through their plain versions.
Every file is written under ``tmp_path``.
"""

import warnings

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu.models import fault_tolerance as jx_ft  # noqa: E402
from kmeans_tpu.parallel import sharding as jx_sharding  # noqa: E402
from kmeans_tpu.utils import checkpoint as jx_ckpt  # noqa: E402
from kmeans_tpu.utils import faults as jx_faults  # noqa: E402
from kmeans_tpu_torch.models import fault_tolerance as pt_ft  # noqa: E402
from kmeans_tpu_torch.models import kmeans as pt_kmeans  # noqa: E402
from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402
from kmeans_tpu_torch.parallel import sharding as pt_sharding  # noqa: E402
from kmeans_tpu_torch.utils import checkpoint as pt_ckpt  # noqa: E402
from kmeans_tpu_torch.utils import faults as pt_faults  # noqa: E402

RTOL, ATOL = 1e-12, 1e-10


def _blobs(n=2000, d=3, centers=4, rs=9, dtype=np.float32):
    # About 17 Lloyd iterations at tolerance=1e-12: every boundary below
    # lands mid-fit.
    X, _ = make_blobs(n_samples=n, centers=centers, n_features=d,
                      random_state=rs)
    return X.astype(dtype)


def _kw(**over):
    kw = dict(k=4, max_iter=30, tolerance=1e-12, seed=1, compute_sse=True,
              verbose=False)
    kw.update(over)
    return kw


def _port(**over):
    return kmeans_tpu_torch.KMeans(device="cpu", **_kw(**over))


def _same(a, b):
    assert a.iterations_run == b.iterations_run
    np.testing.assert_array_equal(a.centroids, b.centroids)
    assert list(a.sse_history) == list(b.sse_history)


def _killed(make, j, fit, faults=pt_faults):
    """Run ``fit(make())`` with a kill armed at boundary ``j``."""
    with faults.inject_kill_after_iteration(j) as rec:
        with pytest.raises(faults.SimulatedPreemption):
            fit(make())
    assert rec["fired_at"] == j
    return rec


# --------------------------------------------------------- the error


@pytest.mark.parametrize("quantity", ["centroids", "log-likelihood",
                                      "covariance", "batch SSE"])
@pytest.mark.parametrize("extra", [
    {}, {"detail": "at k=3"},
    {"rolled_back_to": 4, "checkpoint_path": "/x/c.npz"},
    {"checkpoint_path": "/x/c.npz"}])
def test_divergence_error_is_the_references(quantity, extra):
    """The reference's signature ``(quantity, iteration, *,
    rolled_back_to, checkpoint_path, detail)``, its fields and its
    phrases (a quantity it has no phrase for takes the generic one), and
    one class under three import paths."""
    jx = jx_ft.NumericalDivergenceError(quantity, 7, **extra)
    pt = pt_ft.NumericalDivergenceError(quantity, 7, **extra)
    assert str(pt) == str(jx)
    for name in ("quantity", "iteration", "rolled_back_to",
                 "checkpoint_path"):
        assert getattr(pt, name) == getattr(jx, name)
    assert isinstance(pt, ValueError)
    assert kmeans_tpu_torch.NumericalDivergenceError \
        is pt_kmeans.NumericalDivergenceError \
        is pt_ft.NumericalDivergenceError


# ------------------------------------------------------------ registries


def _run_sequence(faults):
    """An armed sequence of every checkpoint and segment hook, and the
    callable and block wrappers: what raised where, and the records."""
    seen = []

    def call(fn, *args):
        try:
            fn(*args)
            seen.append(None)
        except Exception as e:                  # noqa: BLE001
            seen.append((type(e).__name__, str(e)))

    with faults.inject_kill_after_iteration(3) as kill, \
            faults.inject_oom_on_segment(1, times=2) as oom, \
            faults.inject_checkpoint_delay(0.0, after_iteration=2) as delay, \
            faults.inject_host_kill(0, after_iteration=5) as host:
        for it in range(1, 8):
            call(faults.on_checkpoint, it, "p")
        for seg in (0, 1, 1, 1, 2):
            call(faults.on_segment_dispatch, seg, 256)
    with faults.inject_launch_failures(2) as launch:
        for attempt in range(4):
            call(faults.on_launch, 0, attempt)
    with faults.inject_update_failure("m", on_batch=1, times=1) as upd:
        for b in range(3):
            call(faults.on_update_step, "m", b)
    with faults.inject_quality_regression("m", ratio=5.0) as qual:
        ratios = [faults.on_update_eval("m", 1.0) for _ in range(2)]
    flaky = faults.fail_first_attempts(lambda x: x + 1, 2)
    for x in range(4):
        call(flaky, x)
    blocks = [np.arange(6.0).reshape(3, 2) + i for i in range(3)]
    make = faults.flaky_blocks(lambda: iter(blocks), fail_block=1,
                               fail_times=1)
    for _ in range(2):
        call(lambda: list(make()))
    poisoned = faults.poison_blocks(lambda: iter(blocks), block=2,
                                    from_epoch=1)
    epochs = [np.concatenate(list(poisoned())) for _ in range(2)]
    return (seen, kill, oom, delay, host, launch, upd, qual, ratios,
            flaky.state, make.state, poisoned.state, epochs)


def test_fault_registries_raise_at_the_references_calls():
    jx, pt = _run_sequence(jx_faults), _run_sequence(pt_faults)
    for a, b in zip(jx[:-1], pt[:-1]):
        assert a == b
    for a, b in zip(jx[-1], pt[-1]):
        np.testing.assert_array_equal(a, b)
    assert sorted(pt_faults.__all__) == sorted(jx_faults.__all__)
    assert str(pt_faults.SimulatedOOM(2, 512)) == \
        str(jx_faults.SimulatedOOM(2, 512))


def test_backoff_chunk_is_the_references():
    for chunk in list(range(1, 3000)) + [131072, 262144, 2 ** 21,
                                         2 ** 21 + 8, 999_999]:
        assert pt_sharding.backoff_chunk(chunk) == \
            jx_sharding.backoff_chunk(chunk), chunk
    # The reference's own cases (tests/test_elastic.py).
    assert pt_sharding.backoff_chunk(256) == 128
    assert pt_sharding.backoff_chunk(384) == 192
    assert pt_sharding.backoff_chunk(128) is None
    assert pt_sharding.backoff_chunk(250) is None
    assert pt_sharding.backoff_chunk(300) == 150
    assert pt_sharding.MIN_CHUNK == jx_sharding.MIN_CHUNK


def test_is_oom_error_is_the_references_plus_torchs():
    cases = [pt_faults.SimulatedOOM(0, 256),
             RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating"),
             RuntimeError("CUDA out of memory. Tried to allocate 2 GiB"),
             MemoryError("out of memory"),
             pt_faults.SimulatedPreemption("RESOURCE_EXHAUSTED kill"),
             ValueError("RESOURCE_EXHAUSTED"), RuntimeError("OOM"),
             RuntimeError("something else"), KeyError("out of memory")]
    for e in cases:
        jx_e = (jx_faults.SimulatedPreemption(str(e))
                if isinstance(e, pt_faults.SimulatedPreemption) else e)
        assert pt_ft.is_oom_error(e) == jx_ft.is_oom_error(jx_e), e
    assert pt_ft.is_oom_error(torch.OutOfMemoryError("no tag here"))
    assert torch.cuda.OutOfMemoryError is torch.OutOfMemoryError
    assert pt_ft.MAX_OOM_BACKOFFS == jx_ft.MAX_OOM_BACKOFFS
    assert pt_ft._OOM_TAGS == jx_ft._OOM_TAGS


@pytest.mark.parametrize("bad", [
    dict(checkpoint_every=-1, checkpoint_path="p"),
    dict(checkpoint_every=1.5, checkpoint_path="p"),
    dict(checkpoint_every=2),
    dict(checkpoint_every=0, checkpoint_path="p"),
    dict(checkpoint_every=2, checkpoint_path="p", n_init=3)])
def test_knob_validation_gives_the_references_messages(bad, mesh1, tmp_path):
    bad = dict(bad)
    n_init = bad.pop("n_init", 1)
    if "checkpoint_path" in bad:
        bad["checkpoint_path"] = tmp_path / bad["checkpoint_path"]
    X = _blobs(n=200)
    with pytest.raises(ValueError) as jx:
        kmeans_tpu.KMeans(k=3, n_init=n_init, mesh=mesh1,
                          verbose=False).fit(X, **bad)
    with pytest.raises(ValueError) as pt:
        _port(k=3, n_init=n_init).fit(X, **bad)
    assert str(pt.value) == str(jx.value)
    assert not (tmp_path / "p.npz").exists()


# ------------------------------------------------------ checkpoint files


def test_rotation_describe_and_classify_across_packages(tmp_path):
    """Either package's rotating writer leaves the file and its ``.prev``;
    both packages describe and classify both packages' files alike, a
    torn primary included."""
    state = {"model_class": "KMeans", "k": 3, "iterations_run": 2,
             "centroids": np.ones((3, 2)), "dtype": "float32"}
    for writer, name in ((jx_ckpt, "j"), (pt_ckpt, "p")):
        path = tmp_path / name
        writer.save_state_rotating(path, dict(state, iterations_run=2))
        writer.save_state_rotating(path, dict(state, iterations_run=4))
        assert pt_ckpt.prev_path(path) == jx_ckpt.prev_path(path)
        for reader in (jx_ckpt, pt_ckpt):
            got, used_prev = reader.load_state_with_fallback(path)
            assert got["iterations_run"] == 4 and not used_prev
        keys = ("source", "iteration", "k", "model_class", "prev_exists",
                "prev_loads", "primary_error")
        want = jx_ckpt.describe_checkpoint(path)
        got = pt_ckpt.describe_checkpoint(path)
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
        primary = pt_ckpt._normalize(path)
        primary.write_bytes(primary.read_bytes()[:40])     # torn
        for reader in (jx_ckpt, pt_ckpt):
            got, used_prev = reader.load_state_with_fallback(path)
            assert got["iterations_run"] == 2 and used_prev
            c = reader.classify_resume(path)
            assert (c["resumable"], c["source"], c["iteration"]) == \
                (True, "prev", 2)
        assert "truncated or corrupt" in \
            pt_ckpt.describe_checkpoint(path)["primary_error"]


def test_save_state_primary_rotates_without_a_group(tmp_path):
    path = tmp_path / "c"
    for it in (1, 2, 3):
        pt_ckpt.save_state_primary(path, {"iterations_run": it}, None,
                                   rotate=True)
    assert pt_ckpt.load_state(path)["iterations_run"] == 3
    assert pt_ckpt._load_state_at(pt_ckpt.prev_path(path))[
        "iterations_run"] == 2


# ----------------------------------------------- segmented == unsegmented


@pytest.mark.parametrize("every", [1, 3, 30])
@pytest.mark.parametrize("host_loop", [True, False])
def test_segmented_fit_is_bit_equal_in_the_port(every, host_loop, tmp_path):
    X = _blobs()
    full = _port(host_loop=host_loop).fit(X)
    seg = _port(host_loop=host_loop).fit(X, checkpoint_every=every,
                                         checkpoint_path=tmp_path / "c")
    _same(seg, full)
    assert full.checkpoint_segments_ is None
    assert seg.checkpoint_segments_ == -(-full.iterations_run // every)
    assert pt_ckpt.load_state(tmp_path / "c")["iterations_run"] == \
        full.iterations_run


@pytest.mark.parametrize("every", [1, 3, 30])
@pytest.mark.parametrize("host_loop", [True, False])
def test_segmented_fit_matches_the_references_in_float64(every, host_loop,
                                                         mesh1, tmp_path):
    X = _blobs(dtype=np.float64)
    kw = _kw(dtype=np.float64, distance_mode="matmul", host_loop=host_loop)
    jm = kmeans_tpu.KMeans(mesh=mesh1, **kw).fit(
        X, checkpoint_every=every, checkpoint_path=tmp_path / "j")
    pm = kmeans_tpu_torch.KMeans(device="cpu", **kw).fit(
        X, checkpoint_every=every, checkpoint_path=tmp_path / "p")
    assert pm.iterations_run == jm.iterations_run
    assert pm.checkpoint_segments_ == jm.checkpoint_segments_
    np.testing.assert_allclose(pm.centroids, jm.centroids, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pm.sse_history, jm.sse_history, rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------- recovery


@pytest.mark.parametrize("host_loop", [True, False])
def test_torn_checkpoint_resumes_from_prev_with_a_warning(host_loop,
                                                          tmp_path):
    X = _blobs()
    full = _port(host_loop=host_loop).fit(X)
    path = tmp_path / "c.npz"
    _killed(lambda: _port(host_loop=host_loop), 6,
            lambda m: m.fit(X, checkpoint_every=3, checkpoint_path=path))
    path.write_bytes(path.read_bytes()[:100])
    resumed = _port(host_loop=host_loop)
    with pytest.warns(UserWarning, match="last-good rotation"):
        resumed.fit(X, resume=path)
    _same(resumed, full)


def test_resume_refuses_another_model_or_k(tmp_path):
    X = _blobs(n=300)
    path = tmp_path / "c.npz"
    _port(k=4, max_iter=3).fit(X, checkpoint_every=1, checkpoint_path=path)
    with pytest.raises(ValueError, match="k=4 model"):
        _port(k=5).fit(X, resume=path)
    with pytest.raises(ValueError, match="written by KMeans"):
        kmeans_tpu_torch.MiniBatchKMeans(k=4, device="cpu",
                                         verbose=False).fit(X, resume=path)
    with pytest.raises(FileNotFoundError):
        _port().fit(X, resume=tmp_path / "missing.npz")


@pytest.mark.parametrize("host_loop", [True, False])
def test_divergence_rolls_back_to_the_fits_own_checkpoint(host_loop,
                                                          tmp_path):
    """The reference's trigger (``tests/test_elastic.py``): a fit writes
    its checkpoints, then a resume on poisoned data goes non-finite at its
    first iteration; the model is restored to the checkpoint it resumed
    from and the error names it."""
    X = _blobs()
    path = tmp_path / "g.npz"
    kw = dict(max_iter=6, host_loop=host_loop)
    _port(**kw).fit(X, checkpoint_every=2, checkpoint_path=path)
    good = pt_ckpt.load_state(path)
    bad = X.copy()
    bad[100] = np.nan
    m = _port(**dict(kw, max_iter=40))
    with pytest.raises(pt_ft.NumericalDivergenceError) as err:
        m.fit(bad, resume=path, checkpoint_every=2, checkpoint_path=path)
    assert err.value.quantity == "centroids"
    assert err.value.iteration == 7
    assert err.value.rolled_back_to == 6 == good["iterations_run"]
    assert "rolled back" in str(err.value)
    np.testing.assert_array_equal(m.centroids, good["centroids"])
    assert m.iterations_run == 6


@pytest.mark.parametrize("host_loop", [True, False])
def test_a_stale_checkpoint_of_another_fit_is_never_restored(host_loop,
                                                             tmp_path):
    X = _blobs()
    path = tmp_path / "stale.npz"
    kw = dict(max_iter=6, host_loop=host_loop)
    _port(**kw).fit(X, checkpoint_every=2, checkpoint_path=path)
    stale = pt_ckpt.load_state(path)
    other = _blobs(rs=3)
    other[5] = np.nan
    b = _port(**kw)
    with pytest.raises(pt_ft.NumericalDivergenceError) as err:
        b.fit(other, checkpoint_every=2, checkpoint_path=path)
    assert err.value.rolled_back_to is None
    assert err.value.checkpoint_path is None
    assert b.centroids is None or not np.array_equal(b.centroids,
                                                     stale["centroids"])
    np.testing.assert_array_equal(pt_ckpt.load_state(path)["centroids"],
                                  stale["centroids"])


@pytest.mark.parametrize("mode", ["matmul", "kernel"])
@pytest.mark.parametrize("every", [0, 3])
def test_oom_replays_the_segment_at_a_smaller_chunk(mode, every, tmp_path):
    """An injected device OOM on segment 1 (segment 0, the whole fit,
    without checkpoints) halves the chunk and replays the segment from its
    boundary, in the same mode on the same device.  The kernel modes take
    no chunk: the bits of the plain fit.  In 'matmul' the chunk groups the
    sums: the bits of a clean fit at the final chunk when the whole fit
    replayed, else the plain fit's class."""
    X = _blobs()
    kw = dict(host_loop=False, distance_mode=mode, chunk_size=512)
    full = _port(**kw).fit(X)
    at_final = _port(**dict(kw, chunk_size=256)).fit(X)
    m = _port(**kw)
    ds = m.cache(X)
    ckpt_kw = (dict(checkpoint_every=every, checkpoint_path=tmp_path / "c")
               if every else {})
    segment = 1 if every else 0
    with pytest.warns(UserWarning, match="retrying at chunk 256"):
        with pt_faults.inject_oom_on_segment(segment) as rec:
            m.fit(ds, **ckpt_kw)
    assert rec["fired"] == 1 and rec["chunks"] == [512]
    assert m.oom_backoffs_ == 1 and m.effective_chunk_ == 256
    assert m._mode() == mode and m.device.type == "cpu"
    if mode == "kernel":
        _same(m, full)
    elif not every:
        _same(m, at_final)
    else:
        assert m.iterations_run == full.iterations_run
        np.testing.assert_allclose(m.centroids, full.centroids, rtol=1e-5)
    # The kernel modes keep one loop for every chunk (no chunk reaches the
    # kernel); 'matmul' one per chunk, the failed first run's evicted.
    chunks = {key[2] for key in ds._memo if key[0] == "device_loop"}
    assert chunks == ({None} if mode == "kernel" else
                      {256} if not every else {512, 256})


def test_oom_backoff_gives_up_at_the_floor_and_never_absorbs_a_kill():
    X = _blobs(n=400)
    m = _port(host_loop=False, chunk_size=256, distance_mode="matmul")
    with pytest.warns(UserWarning):
        with pt_faults.inject_oom_on_segment(0, times=5):
            with pytest.raises(RuntimeError, match="backoff exhausted at "
                                                   "128 rows after 1"):
                m.fit(X)
    with pytest.raises(pt_faults.SimulatedPreemption):
        m._dispatch_oom_safe(lambda c: (_ for _ in ()).throw(
            pt_faults.SimulatedPreemption("out of memory")), 512, 0)


def test_a_run_that_fails_before_its_capture_leaves_no_loop(monkeypatch):
    """A loop whose first run raises (a real out-of-memory error in its
    eager iteration) leaves the dataset's memo; the backoff's replay at
    the smaller chunk builds, and keeps, its own."""
    X = _blobs()
    m = _port(host_loop=False, distance_mode="matmul", chunk_size=512)
    ds = m.cache(X)
    real = dist._DeviceLoop.iterate
    calls = {"n": 0}

    def failing(self):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 64.00 GiB")
        return real(self)

    monkeypatch.setattr(dist._DeviceLoop, "iterate", failing)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        m.fit(ds)
    assert m.oom_backoffs_ == 1 and m.effective_chunk_ == 256
    assert [key[2] for key in ds._memo if key[0] == "device_loop"] == [256]
    monkeypatch.undo()
    _same(m, _port(host_loop=False, distance_mode="matmul",
                   chunk_size=256).fit(X))
