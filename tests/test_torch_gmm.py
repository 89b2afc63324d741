"""kmeans_tpu_torch.GaussianMixture against kmeans_tpu.GaussianMixture on
the CPU, with the same data and the same initial parameters.

Parity classes: both float64, the same ``n_iter_`` and ``means_``,
``covariances_``, ``weights_``, ``lower_bound_`` to ``rtol=1e-9`` (the two
sides sum in another order: XLA over eight shards, torch in chunks); both
float32, the tolerances of the JAX package's own sklearn parity test
(tests/test_gmm.py::test_em_matches_sklearn_with_shared_init) and ``predict``
equal on more than 99.9 % of the rows.  Every JAX fit compiles, so the
fitted pairs are shared through module-scoped fixtures.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu.data.synthetic import make_blobs  # noqa: E402
from kmeans_tpu_torch import convert  # noqa: E402
from kmeans_tpu_torch.models import gmm as gmm_mod  # noqa: E402
from kmeans_tpu_torch.utils import checkpoint as pt_ckpt  # noqa: E402
from kmeans_tpu_torch.utils import faults  # noqa: E402

K, D = 3, 5


def _data(n=2_000, centers=K, d=D, seed=0, dtype=np.float64):
    X, y = make_blobs(n, centers, d, random_state=seed, dtype=dtype)
    return X, y


def _shared_init(X, k, cov_type, seed=0):
    rng = np.random.default_rng(seed)
    means = X[rng.choice(len(X), k, replace=False)].astype(np.float64)
    prec = np.ones((k, X.shape[1])) if cov_type == "diag" else np.ones(k)
    return dict(means_init=means, weights_init=np.full(k, 1.0 / k),
                precisions_init=prec)


def _pair(cov_type, dtype, max_iter=15, **kw):
    X, _ = _data(dtype=dtype)
    init = _shared_init(X, K, cov_type)
    args = dict(n_components=K, covariance_type=cov_type,
                max_iter=max_iter, tol=0.0, reg_covar=1e-6, dtype=dtype,
                **init, **kw)
    jm = kmeans_tpu.GaussianMixture(**args).fit(X)
    pm = kmeans_tpu_torch.GaussianMixture(device="cpu", **args).fit(X)
    return jm, pm, X


@pytest.fixture(scope="module", params=["diag", "spherical"])
def pair64(request):
    return _pair(request.param, np.float64)


@pytest.fixture(scope="module", params=["diag", "spherical"])
def pair32(request):
    return _pair(request.param, np.float32)


def test_float64_fit_matches_jax(pair64):
    jm, pm, X = pair64
    assert pm.estep_path_ == "serial" and pm.n_iter_ == jm.n_iter_ == 15
    for name in ("means_", "covariances_", "weights_", "shift_"):
        np.testing.assert_allclose(getattr(pm, name),
                                   np.asarray(getattr(jm, name)),
                                   rtol=1e-9, err_msg=name)
    np.testing.assert_allclose(pm.lower_bound_, jm.lower_bound_, rtol=1e-9)
    assert pm.covariances_.shape == np.asarray(jm.covariances_).shape


def test_float64_posterior_matches_jax(pair64):
    jm, pm, X = pair64
    np.testing.assert_array_equal(pm.predict(X), np.asarray(jm.predict(X)))
    np.testing.assert_allclose(pm.predict_proba(X),
                               np.asarray(jm.predict_proba(X)),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(pm.score_samples(X),
                               np.asarray(jm.score_samples(X)), rtol=1e-9)
    np.testing.assert_allclose(pm.score(X), jm.score(X), rtol=1e-9)
    np.testing.assert_allclose(pm.bic(X), jm.bic(X), rtol=1e-9)
    np.testing.assert_allclose(pm.aic(X), jm.aic(X), rtol=1e-9)
    np.testing.assert_allclose(pm.precisions_, jm.precisions_, rtol=1e-9)
    np.testing.assert_allclose(pm.precisions_cholesky_,
                               jm.precisions_cholesky_, rtol=1e-9)


def test_float32_fit_matches_jax(pair32):
    jm, pm, X = pair32
    np.testing.assert_allclose(pm.means_, np.asarray(jm.means_), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(pm.weights_, np.asarray(jm.weights_),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(pm.covariances_, np.asarray(jm.covariances_),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(pm.lower_bound_, jm.lower_bound_, rtol=1e-4)
    np.testing.assert_allclose(pm.predict_proba(X),
                               np.asarray(jm.predict_proba(X)), atol=2e-3)
    assert (pm.predict(X) == np.asarray(jm.predict(X))).mean() > 0.999


def test_sample_draws_what_jax_draws(pair64):
    jm, pm, _ = pair64
    Xj, yj = jm.sample(500)
    Xp, yp = pm.sample(500)
    np.testing.assert_array_equal(yp, np.asarray(yj))
    np.testing.assert_allclose(Xp, np.asarray(Xj), rtol=1e-9)
    assert Xp.dtype == np.float64 and yp.dtype == np.int32


def test_sample_from_a_converted_jax_state(pair32):
    jm, _, _ = pair32
    pm = convert.from_jax_state(jm._state_dict(), device="cpu")
    assert isinstance(pm, kmeans_tpu_torch.GaussianMixture)
    Xj, yj = jm.sample(300)
    Xp, yp = pm.sample(300)
    np.testing.assert_array_equal(yp, np.asarray(yj))
    np.testing.assert_array_equal(Xp, np.asarray(Xj))


@pytest.fixture(scope="module")
def kmeans_init_pair():
    """init_params='kmeans' on well-separated blobs: the internal KMeans
    makes the same host draws (k-means++ with default_rng(seed)) on both
    sides.  float32: the JAX package's internal KMeans is float32."""
    X, _ = make_blobs(3_000, 4, 6, random_state=11, dtype=np.float32)
    kw = dict(n_components=4, max_iter=10, seed=5)
    return (kmeans_tpu.GaussianMixture(**kw).fit(X),
            kmeans_tpu_torch.GaussianMixture(device="cpu", **kw).fit(X), X)


def test_kmeans_init_matches_jax(kmeans_init_pair):
    jm, pm, X = kmeans_init_pair
    assert pm.n_iter_ == jm.n_iter_ and pm.converged_ == jm.converged_
    np.testing.assert_allclose(pm.means_, np.asarray(jm.means_), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pm.covariances_, np.asarray(jm.covariances_),
                               rtol=1e-3)
    np.testing.assert_array_equal(pm.predict(X), np.asarray(jm.predict(X)))


@pytest.mark.parametrize("init_params", ["k-means++", "random"])
def test_other_inits_run_and_agree_on_the_blobs(kmeans_init_pair,
                                                init_params):
    _, ref, X = kmeans_init_pair
    pm = kmeans_tpu_torch.GaussianMixture(
        n_components=4, max_iter=30, seed=5, init_params=init_params,
        device="cpu").fit(X)
    assert np.isfinite(pm.lower_bound_)
    assert pm.lower_bound_ == pytest.approx(ref.lower_bound_, rel=1e-3)


def test_n_init_picks_the_best_restart_as_jax_does():
    X, _ = _data(n=1_500, centers=4, seed=3, dtype=np.float32)
    kw = dict(n_components=4, max_iter=8, tol=0.0, seed=4, n_init=3,
              init_params="random")
    jm = kmeans_tpu.GaussianMixture(**kw).fit(X)
    pm = kmeans_tpu_torch.GaussianMixture(device="cpu", **kw).fit(X)
    assert pm.restart_lower_bounds_.shape == (3,)
    np.testing.assert_allclose(pm.restart_lower_bounds_,
                               jm.restart_lower_bounds_, rtol=1e-4)
    assert pm.best_restart_ == int(np.argmax(pm.restart_lower_bounds_)) \
        == jm.best_restart_
    assert pm.lower_bound_ == pm.restart_lower_bounds_.max()
    np.testing.assert_allclose(pm.means_, np.asarray(jm.means_), rtol=2e-3,
                               atol=2e-3)


def test_lower_bound_does_not_decrease(monkeypatch):
    X, _ = _data(n=1_500, centers=4, seed=3, dtype=np.float32)
    history = []
    orig = kmeans_tpu_torch.GaussianMixture._m_step

    def spy(self, st):
        history.append(float(st.loglik))
        return orig(self, st)

    monkeypatch.setattr(kmeans_tpu_torch.GaussianMixture, "_m_step", spy)
    kmeans_tpu_torch.GaussianMixture(n_components=4, max_iter=20, tol=0.0,
                                     seed=1, device="cpu").fit(X)
    ll = np.array(history[1:])       # the hard-assignment init pass first
    assert len(ll) == 20
    assert np.all(np.diff(ll) >= -1e-3 * np.abs(ll[:-1])), ll


def test_offset_data_covariances_not_collapsed():
    """|mean| / std ~ 1e4 (tests/test_gmm.py): the centered E pass keeps
    the covariances near their true 1, not at reg_covar; both packages and
    sklearn's float64 fit agree."""
    sklearn_gmm = pytest.importorskip("sklearn.mixture").GaussianMixture
    rng = np.random.default_rng(0)
    k, d = 3, 4
    centers = rng.normal(size=(k, d)) * 3 + 1e4
    y = rng.integers(0, k, size=4_000)
    X = (centers[y] + rng.normal(size=(4_000, d))).astype(np.float32)
    kw = dict(n_components=k, max_iter=10, tol=0.0, reg_covar=1e-6,
              means_init=centers, weights_init=np.full(k, 1.0 / k),
              precisions_init=np.ones((k, d)))
    pm = kmeans_tpu_torch.GaussianMixture(device="cpu", **kw).fit(X)
    jm = kmeans_tpu.GaussianMixture(**kw).fit(X)
    ref = sklearn_gmm(covariance_type="diag", n_init=1,
                      **kw).fit(X.astype(np.float64))
    assert pm.covariances_.min() > 0.5
    np.testing.assert_allclose(pm.covariances_, ref.covariances_, rtol=0.05)
    np.testing.assert_allclose(pm.covariances_, np.asarray(jm.covariances_),
                               rtol=1e-3)
    np.testing.assert_allclose(pm.means_, ref.means_, rtol=1e-6)


def test_resume_continues_from_the_current_parameters():
    X, _ = _data(n=1_000, seed=7)
    init = _shared_init(X, K, "diag")
    kw = dict(n_components=K, tol=0.0, dtype=np.float64, device="cpu",
              **init)
    whole = kmeans_tpu_torch.GaussianMixture(max_iter=8, **kw).fit(X)
    part = kmeans_tpu_torch.GaussianMixture(max_iter=5, **kw).fit(X)
    part.set_params(max_iter=3)
    part.fit(X, resume=True)
    assert part.n_iter_ == whole.n_iter_ == 8
    np.testing.assert_allclose(part.means_, whole.means_, rtol=1e-12)
    np.testing.assert_allclose(part.lower_bound_, whole.lower_bound_,
                               rtol=1e-12)


def test_fit_predict_and_sample_weight():
    X, _ = _data(n=900, seed=19, dtype=np.float32)
    kw = dict(n_components=K, max_iter=6, seed=2, device="cpu")
    labels = kmeans_tpu_torch.GaussianMixture(**kw).fit_predict(X)
    ref = kmeans_tpu_torch.GaussianMixture(**kw).fit(X).predict(X)
    np.testing.assert_array_equal(labels, ref)
    # Weight 2 on a row is the row twice.
    init = _shared_init(X, K, "diag", seed=1)
    kw = dict(n_components=K, max_iter=6, tol=0.0, dtype=np.float64,
              device="cpu", **init)
    w = np.ones(len(X))
    w[:200] = 2.0
    a = kmeans_tpu_torch.GaussianMixture(**kw).fit(
        X.astype(np.float64), sample_weight=w)
    b = kmeans_tpu_torch.GaussianMixture(**kw).fit(
        np.concatenate([X, X[:200]]).astype(np.float64))
    np.testing.assert_allclose(a.means_, b.means_, rtol=1e-9)
    np.testing.assert_allclose(a.covariances_, b.covariances_, rtol=1e-9)


def test_tensor_and_dataset_inputs():
    X, _ = _data(n=800, seed=2, dtype=np.float32)
    kw = dict(n_components=K, max_iter=5, seed=3, device="cpu")
    ref = kmeans_tpu_torch.GaussianMixture(**kw).fit(X)
    gm = kmeans_tpu_torch.GaussianMixture(**kw)
    np.testing.assert_array_equal(gm.fit(torch.from_numpy(X)).means_,
                                  ref.means_)
    with pytest.raises(ValueError, match="NaN"):
        bad = X.copy()
        bad[3, 1] = np.inf
        kmeans_tpu_torch.GaussianMixture(**kw).fit(bad)
    with pytest.raises(ValueError, match="fitted"):
        kmeans_tpu_torch.GaussianMixture(**kw).predict(X)


def test_get_and_set_params():
    gm = kmeans_tpu_torch.GaussianMixture(n_components=2, device="cpu")
    params = gm.get_params()
    assert params["n_components"] == 2 and params["device"] == "cpu"
    gm.set_params(tol=1e-5, covariance_type="spherical")
    assert gm.tol == 1e-5 and gm.covariance_type == "spherical"
    with pytest.raises(ValueError):
        gm.set_params(n_components=0)
    assert gm.n_components == 2
    with pytest.raises(ValueError, match="invalid parameter"):
        gm.set_params(k=3)


LATER = {"tied": dict(covariance_type="tied"),
         "full": dict(covariance_type="full"),
         "host_loop": dict(host_loop=False), "pipeline": dict(pipeline=1),
         "model_shards": dict(model_shards=2), "mesh": dict(mesh="a mesh"),
         "bucket": dict(bucket="auto"), "overlap": dict(overlap=1),
         "ingest": dict(ingest="slab")}
#: The arguments of LATER ported since: each now fits, and the model
#: reports what ran (``ingest='slab'`` places the same bytes; one copy
#: without a mesh; ``bucket`` pads with inert rows, ``overlap`` stages the
#: upload on a producer thread).
PORTED = {"tied": ("tied", True, "serial"), "full": ("full", True, "serial"),
          "host_loop": ("diag", False, "serial"),
          "pipeline": ("diag", True, "pipelined"),
          "ingest": ("diag", True, "serial"),
          "bucket": ("diag", True, "serial"),
          "overlap": ("diag", True, "serial")}


@pytest.mark.parametrize("kw", list(LATER.values()), ids=list(LATER))
def test_arguments_not_ported_yet_raise(kw):
    """Each raises naming its ROADMAP item; ``mesh``, ported since, refuses
    what is not a DeviceMesh instead; 'tied', 'full', ``host_loop=False``,
    ``pipeline=1``, ``ingest='slab'``, ``bucket='auto'`` and ``overlap=1``,
    ported since, fit a few rows and report what ran."""
    if "mesh" in kw:
        with pytest.raises(TypeError, match="DeviceMesh"):
            kmeans_tpu_torch.GaussianMixture(n_components=2, device="cpu",
                                             **kw)
        return
    name = next(n for n, v in LATER.items() if v == kw)
    if name in PORTED:
        X, _ = _data(n=120, centers=2, d=3, seed=5)
        gm = kmeans_tpu_torch.GaussianMixture(n_components=2, device="cpu",
                                              max_iter=4, **kw).fit(X)
        assert (gm.covariance_type, gm.host_loop, gm.estep_path_) == \
            PORTED[name]
        assert gm.loop_path_ == ("host" if gm.host_loop else "device")
        assert gm.n_iter_ >= 1 and np.isfinite(gm.lower_bound_)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kmeans_tpu_torch.GaussianMixture(n_components=2, device="cpu", **kw)


@pytest.mark.parametrize("call", ["fit_stream", "predict_stream",
                                  "score_samples_stream", "sweep",
                                  "fitted_state", "quality_profile",
                                  "checkpoint", "resume_path"])
def test_entry_points_not_ported_yet_raise(call, tmp_path):
    """Each raises naming its ROADMAP item; ``sweep``, ported since, runs
    a two-value sweep and returns its ``SweepResult``; ``fitted_state``
    and ``quality_profile`` (ROADMAP A.12, A.13), ported since, refuse or
    return None before a fit and after one equal the JAX package's spec
    and profile (float64, the same start); ``checkpoint`` and
    ``resume_path`` (ROADMAP A.9) write a rotating checkpoint every EM
    iteration, and resume from a path to the bits of the uninterrupted
    fit."""
    gm = kmeans_tpu_torch.GaussianMixture(n_components=2, device="cpu")
    X = np.zeros((10, 2), np.float32)
    if call in ("checkpoint", "resume_path"):
        X, _ = _data(n=200, centers=3, d=3, seed=6, dtype=np.float64)
        kw = dict(n_components=3, device="cpu", max_iter=4, tol=0.0,
                  init_params="random", seed=1, dtype=np.float64)
        path = tmp_path / "c"
        full = kmeans_tpu_torch.GaussianMixture(**kw).fit(X)
        if call == "checkpoint":
            gm = kmeans_tpu_torch.GaussianMixture(**kw).fit(
                X, checkpoint_every=1, checkpoint_path=path)
            assert gm.checkpoint_segments_ == 4
            assert pt_ckpt.load_state(path)["n_iter_"] == 4
            assert pt_ckpt._load_state_at(pt_ckpt.prev_path(path))[
                "n_iter_"] == 3
        else:
            with faults.inject_kill_after_iteration(2):
                with pytest.raises(faults.SimulatedPreemption):
                    kmeans_tpu_torch.GaussianMixture(**kw).fit(
                        X, checkpoint_every=2, checkpoint_path=path)
            # ``max_iter`` more iterations on resume: 2 to reach 4.
            gm = kmeans_tpu_torch.GaussianMixture(
                **dict(kw, max_iter=2)).fit(X, resume=str(path) + ".npz")
        assert gm.n_iter_ == full.n_iter_ == 4
        assert gm.lower_bound_ == full.lower_bound_
        np.testing.assert_array_equal(gm.means_, full.means_)
        np.testing.assert_array_equal(gm.covariances_, full.covariances_)
        return
    if call in ("fit_stream", "predict_stream", "score_samples_stream"):
        # Ported since (ROADMAP A.10): the stream of two blocks gives the
        # in-memory fit's bits where the fit's arithmetic is the same.
        X, _ = _data(n=200, centers=3, d=3, seed=6, dtype=np.float64)
        kw = dict(n_components=3, device="cpu", max_iter=4, tol=0.0,
                  means_init=X[:3].copy(), dtype=np.float64)

        def blocks():
            return iter([X[:120], X[120:]])

        mem = kmeans_tpu_torch.GaussianMixture(**kw).fit(X)
        if call == "fit_stream":
            st = kmeans_tpu_torch.GaussianMixture(**kw).fit_stream(blocks)
            assert st.n_iter_ == mem.n_iter_ == 4
            np.testing.assert_allclose(st.lower_bound_, mem.lower_bound_,
                                       rtol=1e-12)
            np.testing.assert_allclose(st.means_, mem.means_, rtol=1e-12,
                                       atol=1e-12)
        elif call == "predict_stream":
            np.testing.assert_array_equal(
                np.concatenate(list(mem.predict_stream(blocks))),
                mem.predict(X))
        else:
            np.testing.assert_allclose(
                np.concatenate(list(mem.score_samples_stream(blocks))),
                mem.score_samples(X), rtol=1e-12)
        return
    if call == "sweep":
        X, _ = _data(n=200, centers=3, d=3, seed=6, dtype=np.float32)
        res = kmeans_tpu_torch.GaussianMixture(
            device="cpu", max_iter=5, seed=1).sweep(X, k_range=[2, 3])
        assert isinstance(res, kmeans_tpu_torch.SweepResult)
        assert res.family == "gmm" and res.criterion == "bic"
        assert res.k_range == (2, 3) and res.selected_k in (2, 3)
        assert res.scores.shape == (2,) and np.all(np.isfinite(res.scores))
        assert res.best_model.n_components == res.selected_k
        return
    if call in ("fitted_state", "quality_profile"):
        X, _ = _data(n=200, centers=3, d=3, seed=6, dtype=np.float64)
        kw = dict(n_components=3, max_iter=4, tol=0.0, seed=1,
                  means_init=X[:3].copy(), dtype=np.float64)
        jm = kmeans_tpu.GaussianMixture(**kw).fit(X)
        if call == "fitted_state":
            with pytest.raises(ValueError, match="fitted"):
                gm.fitted_state()
            pm = kmeans_tpu_torch.GaussianMixture(device="cpu",
                                                  **kw).fit(X)
            assert pm.fitted_state() == jm.fitted_state()
            return
        assert gm.quality_profile() is None
        pm = kmeans_tpu_torch.GaussianMixture(device="cpu", **kw).fit(X)
        for got, want in ((pm.quality_profile(), jm.quality_profile()),
                          (pm.quality_profile(X), jm.quality_profile(X))):
            assert got.keys() == want.keys()
            for key, value in want.items():
                if isinstance(value, (float, list)):
                    np.testing.assert_allclose(got[key], value,
                                               rtol=1e-12, atol=1e-10)
                else:
                    assert got[key] == value, key
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if call == "checkpoint":
            gm.fit(X, checkpoint_every=1, checkpoint_path=tmp_path / "c")
        elif call == "resume_path":
            gm.fit(X, resume=str(tmp_path / "c.npz"))
        elif call == "fitted_state":
            gm.fitted_state()
        else:
            getattr(gm, call)(X)


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kmeans_tpu_torch.GaussianMixture(n_components=2)
    with pytest.raises(RuntimeError, match="is_available"):
        kmeans_tpu_torch.GaussianMixture(n_components=2, device="cuda")
    gm = kmeans_tpu_torch.GaussianMixture(n_components=2, device="cpu")
    assert gm.device == torch.device("cpu")


@pytest.mark.parametrize("device,dtype,cov,want", [
    ("cuda", np.float32, "diag", "kernel"),
    ("cuda", np.float32, "spherical", "kernel"),
    ("cuda", np.float64, "diag", "torch"),
    ("cuda", np.float64, "spherical", "torch"),
    ("cpu", np.float32, "diag", "torch"),
    ("cpu", np.float64, "diag", "torch"),
    ("cuda", np.float32, "tied", "torch"),
    ("cuda", np.float32, "full", "torch"),
    ("cpu", np.float32, "tied", "torch"),
    ("cpu", np.float32, "full", "torch")])
def test_the_dtype_picks_the_estep(device, dtype, cov, want):
    """The E-step kernel is a float32 engine: a float64 mixture on the card
    runs the chunked torch E-step in float64 (and records 'serial'), as the
    JAX package's XLA E-step computes in the model's dtype.  The kernel has
    a diagonal form only: 'tied' and 'full' run the torch pass on every
    device, a rule of the covariance type."""
    assert gmm_mod.estep_mode(device, dtype, cov) == want
    gm = kmeans_tpu_torch.GaussianMixture(n_components=2, device="cpu",
                                          dtype=dtype, covariance_type=cov)
    gm.device = torch.device(device, 0) if device == "cuda" \
        else torch.device(device)          # the rule only, no launch
    assert gm._mode() == want


@pytest.mark.parametrize("init_params", ["kmeans", "k-means++"])
def test_float64_kmeans_seeding_matches_the_float32_fit(init_params):
    """The float64 'kmeans' and 'k-means++' inits against the port's own
    float32 fit of the same data and seed: the internal KMeans makes the
    same host draws, so the means agree to float32 tolerances.  The JAX
    package cannot be the oracle here: its internal KMeans is built without
    ``dtype`` (kmeans_tpu/models/gmm.py), so a float64 mixture with x64 on
    raises there instead of seeding."""
    X, _ = make_blobs(3_000, 4, 6, random_state=11, dtype=np.float64)
    kw = dict(n_components=4, max_iter=10, seed=5, init_params=init_params,
              device="cpu")
    f64 = kmeans_tpu_torch.GaussianMixture(dtype=np.float64, **kw).fit(X)
    f32 = kmeans_tpu_torch.GaussianMixture(dtype=np.float32, **kw).fit(
        X.astype(np.float32))
    assert f64.estep_path_ == f32.estep_path_ == "serial"
    assert f64.n_iter_ == f32.n_iter_
    np.testing.assert_allclose(f64.means_, f32.means_, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f64.weights_, f32.weights_, atol=1e-5)
    np.testing.assert_allclose(f64.covariances_, f32.covariances_,
                               rtol=1e-3)
    np.testing.assert_array_equal(f64.predict(X), f32.predict(X))
