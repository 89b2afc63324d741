"""The massive-k tier on one device (``assign='two_level'``, the knobs,
``bucket_candidates``, the member lists, the mode rule, checkpoints)
against the JAX package's.

* ``nprobe == coarse_cells`` (the collapse case) probes every centroid:
  labels, counts and iterations equal to the dense fit's in float64, and
  the SSE ratio 1.000000 in float32.
* ``nprobe < coarse_cells`` against the JAX package fed the same coarse
  table (the two packages' k-means++ draw from other generators, so each
  model's ``_train_coarse`` returns the JAX model's trained table), and
  ``_two_level_best`` on the same inputs: equal labels and SSE, float64.
* ``_build_members`` and ``bucket_candidates`` equal the JAX package's.
* The knobs take the JAX package's grammar and messages; 'auto' resolves
  to the dense step on the CPU; ``host_loop=False`` on a large-k path
  raises; the mode rule: under a large-k step 'auto' is 'matmul' and the
  kernel modes raise the JAX package's ``ValueError``.
* Checkpoints carry the knobs and the coarse table (``two_level_coarse``):
  a loaded model predicts as the saved one with ``nprobe < coarse_cells``,
  across packages both ways.
The mesh cases (``k_shard``, two-level on a data axis) are in
``test_torch_large_k_mesh.py``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu.parallel import distributed as jdist  # noqa: E402
from kmeans_tpu.parallel import sharding as jsh  # noqa: E402
from kmeans_tpu_torch import KMeans  # noqa: E402
from kmeans_tpu_torch.parallel import distributed as pdist  # noqa: E402
from kmeans_tpu_torch.parallel import sharding as psh  # noqa: E402
from kmeans_tpu_torch.utils import checkpoint as pt_ckpt  # noqa: E402

RTOL, ATOL = 1e-12, 1e-10
N, D, K = 3000, 8, 64


def _data(dtype=np.float64, n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D)) + rng.integers(0, 40, size=(n, 1)) \
        + 0.5 * rng.integers(0, 3, size=(n, D))
    return X.astype(dtype)


def _kw(X, dtype=np.float64, **kw):
    init = X[np.random.default_rng(1).choice(len(X), K, replace=False)]
    base = dict(k=K, init=init.copy(), max_iter=8, tolerance=1e-12,
                compute_sse=True, verbose=False, dtype=dtype,
                distance_mode="matmul")
    base.update(kw)
    return base


def test_collapse_equals_the_dense_fit_float64():
    X = _data()
    dense = KMeans(device="cpu", **_kw(X)).fit(X)
    col = KMeans(device="cpu", assign="two_level", coarse_cells=8,
                 nprobe=8, **_kw(X)).fit(X)
    assert (col.k_shard_resolved_, col.assign_resolved_) == (0, "two_level")
    assert col.iterations_run == dense.iterations_run
    np.testing.assert_array_equal(col.cluster_sizes_, dense.cluster_sizes_)
    np.testing.assert_array_equal(col.labels_, dense.labels_)
    np.testing.assert_allclose(col.centroids, dense.centroids, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(col.sse_history, dense.sse_history,
                               rtol=RTOL)


def test_collapse_sse_ratio_float32():
    """Float32 on separated blobs (the JAX package's own large-k fixture
    is of that kind): the scatter-add sums in another order than the
    dense one-hot product, so the centroids differ in their last bits and
    the class is the SSE ratio, 1.000000, not the bytes.  (On overlapping
    data the two trajectories part at near-ties over the iterations.)"""
    rng = np.random.default_rng(8)
    centres = rng.uniform(-30.0, 30.0, size=(K, 16))
    X = (centres[rng.integers(0, K, size=20_000)]
         + rng.normal(size=(20_000, 16))).astype(np.float32)
    kw = dict(k=K, init=X[:K].copy(), max_iter=8, tolerance=1e-12,
              compute_sse=True, verbose=False, dtype=np.float32,
              distance_mode="matmul", device="cpu")
    dense = KMeans(**kw).fit(X)
    col = KMeans(assign="two_level", coarse_cells=8, nprobe=8, **kw).fit(X)
    assert col.iterations_run == dense.iterations_run
    ratio = np.asarray(col.sse_history) / np.asarray(dense.sse_history)
    np.testing.assert_allclose(ratio, 1.0, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_two_level():
    X = _data()
    jm = kmeans_tpu.KMeans(assign="two_level", coarse_cells=8, nprobe=2,
                           **_kw(X)).fit(X)
    return X, jm


def _port_with_coarse(X, coarse, **kw):
    pm = KMeans(device="cpu", assign="two_level", coarse_cells=8, nprobe=2,
                **_kw(X, **kw))
    pm._train_coarse = lambda cents, C: coarse
    return pm.fit(X)


def test_two_level_matches_jax_fed_the_same_coarse_table(jax_two_level):
    X, jm = jax_two_level
    coarse = jm._two_level_route_[0]
    pm = _port_with_coarse(X, coarse)
    assert pm.iterations_run == jm.iterations_run
    np.testing.assert_allclose(pm.centroids, jm.centroids, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pm.sse_history, jm.sse_history, rtol=RTOL)
    np.testing.assert_array_equal(pm.labels_, np.asarray(jm.labels_))
    np.testing.assert_array_equal(pm.predict(X), jm.predict(X))
    np.testing.assert_array_equal(pm._two_level_route_[1],
                                  jm._two_level_route_[1])
    # nprobe < C routes some rows away from their dense nearest centroid.
    dense = KMeans(device="cpu", **_kw(X, init=pm.centroids, max_iter=1))
    dense.centroids = pm.centroids
    assert (dense.predict(X) != pm.predict(X)).any()


@pytest.mark.parametrize("nprobe", [1, 3, 8])
def test_two_level_best_is_the_references(nprobe):
    X = _data()
    cents = X[::47][:K].astype(np.float64)
    rng = np.random.default_rng(7)
    coarse = cents[rng.choice(K, 8, replace=False)] + 0.1
    km = KMeans(k=K, device="cpu")
    members = km._build_members(cents, coarse)
    ext = np.concatenate([cents, np.full((1, D), pdist.PAD_CENTROID_VALUE)])
    bd, bi = pdist._two_level_best(
        torch.from_numpy(X), torch.from_numpy(coarse), torch.from_numpy(ext),
        torch.from_numpy(members).long(), nprobe=nprobe, mode="matmul", k=K)
    import jax.numpy as jnp
    jd, ji = jdist._two_level_best(jnp.asarray(X), jnp.asarray(coarse),
                                   jnp.asarray(ext), jnp.asarray(members),
                                   nprobe=nprobe, mode="matmul", k=K)
    np.testing.assert_array_equal(bi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(bd.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=1e-9)
    with pytest.raises(ValueError, match="nprobe must be in"):
        pdist._two_level_best(torch.from_numpy(X), torch.from_numpy(coarse),
                              torch.from_numpy(ext),
                              torch.from_numpy(members).long(), nprobe=9,
                              mode="matmul", k=K)


def test_two_level_step_sse_is_exact_for_its_labels():
    """The step's SSE is the SSE of the labels it produces, its sums and
    counts those labels' (the scatter-add over the winners)."""
    X = _data()
    w = np.random.default_rng(3).uniform(0.0, 2.0, size=N)
    cents = X[::47][:K]
    km = KMeans(k=K, device="cpu")
    coarse = km._train_coarse(cents, 8)
    members = km._build_members(cents, coarse)
    step = pdist.make_two_level_step_fn(chunk_size=500, nprobe=3)
    st = step(torch.from_numpy(X), torch.from_numpy(w),
              torch.from_numpy(cents), coarse, members)
    labels = pdist.make_two_level_predict_fn(chunk_size=700, nprobe=3)(
        torch.from_numpy(X), torch.from_numpy(cents), coarse,
        members).numpy()
    d2 = ((X - cents[labels]) ** 2).sum(1)
    np.testing.assert_allclose(float(st.sse), (w * d2).sum(), rtol=1e-12)
    np.testing.assert_allclose(st.counts.numpy(),
                               np.bincount(labels, w, minlength=K),
                               rtol=1e-12)
    sums = np.zeros((K, D))
    np.add.at(sums, labels, w[:, None] * X)
    np.testing.assert_allclose(st.sums.numpy(), sums, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(float(st.farthest_dist), (d2 * (w > 0)).max(),
                               rtol=1e-12)


@pytest.mark.parametrize("k,C", [(64, 8), (300, 17), (1000, 32), (5, 2),
                                 (50, 50)])
def test_build_members_is_the_references(k, C):
    rng = np.random.default_rng(k)
    cents = rng.normal(size=(k, 6)) * 5
    coarse = cents[rng.choice(k, C, replace=False)] + rng.normal(size=(C, 6))
    coarse[0] = 1e3                       # an empty cell
    ours = KMeans(k=k, device="cpu")._build_members(cents, coarse)
    theirs = kmeans_tpu.KMeans(k=k)._build_members(cents, coarse)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == np.int32


def test_bucket_candidates_is_the_references():
    for n in list(range(0, 3000)) + [10**4, 12_345, 10**5, 2**20 + 1,
                                     10**7]:
        assert psh.bucket_candidates(n) == jsh.bucket_candidates(n), n
    assert psh.CANDIDATE_FLOOR == jsh.CANDIDATE_FLOOR
    assert psh.BUCKET_RUNGS == jsh.BUCKET_RUNGS


@pytest.mark.parametrize("kw", [dict(k_shard="bogus"), dict(k_shard=-1),
                                dict(assign="ivf"), dict(coarse_cells=0),
                                dict(nprobe=0)])
def test_knob_errors_are_the_references(kw):
    with pytest.raises(ValueError) as ours:
        KMeans(k=3, device="cpu", **kw)
    with pytest.raises(ValueError) as theirs:
        kmeans_tpu.KMeans(k=3, **kw)
    assert str(ours.value) == str(theirs.value)


def test_knobs_are_kept_and_reported():
    km = KMeans(k=3, device="cpu", k_shard=0, assign="two_level",
                coarse_cells=8, nprobe=2, ingest="slab")
    params = km.get_params()
    assert (params["k_shard"], params["assign"], params["coarse_cells"],
            params["nprobe"], params["ingest"]) == (0, "two_level", 8, 2,
                                                    "slab")
    # coarse_cells is clipped to k, as in the JAX package.
    assert km._two_level_params() == \
        kmeans_tpu.KMeans(k=3, coarse_cells=8, nprobe=2)._two_level_params()
    assert km._two_level_params() == (3, 2)
    clone = KMeans(**{**params, "device": "cpu"})
    assert clone.get_params() == params


def test_auto_resolves_to_the_dense_step_on_the_cpu():
    X = _data(n=500)
    km = KMeans(device="cpu", **_kw(X, max_iter=2)).fit(X)
    jm = kmeans_tpu.KMeans(**_kw(X, max_iter=2)).fit(X)
    assert (km.k_shard_resolved_, km.assign_resolved_) == \
        (jm.k_shard_resolved_, jm.assign_resolved_) == (0, "dense")
    assert km._two_level_route_ is None and km.loop_path_ == "host"


def _stub_card(monkeypatch, free):
    from kmeans_tpu_torch.obs import memory as pmem
    monkeypatch.setattr(pmem, "device_memory_info", lambda device=None: {
        "available": True, "bytes_limit": None, "bytes_in_use": None,
        "bytes_free": int(free)})


@pytest.mark.parametrize("room", ["fits", "short"])
def test_auto_counts_what_the_fit_has_still_to_allocate(monkeypatch, room):
    """'auto' on a card whose rows (45 % of it) are placed already: the
    free bytes leave those rows out, so the dense fit needs its table and
    its temporary bytes only, and stays dense although the whole plan's
    peak is over 80 % of the free bytes.  Without room for the table and
    the tiles it takes 'two_level'."""
    from kmeans_tpu_torch.obs import memory as pmem
    rng = np.random.default_rng(3)
    X = rng.normal(size=(2000, 256)).astype(np.float32)
    km = KMeans(k=4, max_iter=1, seed=0, verbose=False, dtype=np.float32,
                distance_mode="matmul", device="cpu")
    ds = km.cache(X)
    plan = pmem.plan_fit("kmeans", ds.n, ds.d, 4, dtype="float32",
                         chunk=km._chunk_for(ds), mode="matmul")
    rows = plan["components"]["points_bytes"] + \
        plan["components"]["weights_bytes"]
    need = plan["predicted_temp_bytes"] + plan["components"]["table_bytes"]
    free = rows / 0.45 - rows if room == "fits" else need
    assert plan["predicted_peak_bytes"] > 0.8 * free
    _stub_card(monkeypatch, free)
    km.fit(ds)
    assert (km.k_shard_resolved_, km.assign_resolved_) == \
        (0, "dense" if room == "fits" else "two_level")
    if room == "fits":
        # The device loop, which a large-k route refuses, runs.
        KMeans(k=4, max_iter=1, seed=0, dtype=np.float32, host_loop=False,
               distance_mode="matmul", device="cpu").fit(ds)


def _large_k_refusal(pkg, family, call, kw):
    X = _data(np.float32, n=300)
    model = getattr(pkg, family)(k=3, dtype=np.float32, **kw,
                                 **({"device": "cpu"}
                                    if pkg is not kmeans_tpu else {}))
    with pytest.raises(ValueError) as err:
        if call == "fit_stream":
            model.fit_stream(lambda: iter([X]), d=D)
        else:
            model.sweep(X, k_range="2:4")
    return str(err.value)


@pytest.mark.parametrize("kw", [dict(assign="two_level"), dict(k_shard=2)])
@pytest.mark.parametrize("family,call", [("KMeans", "fit_stream"),
                                         ("SphericalKMeans", "fit_stream"),
                                         ("KMeans", "sweep"),
                                         ("SphericalKMeans", "sweep")])
def test_stream_and_sweep_refuse_the_large_k_knobs(family, call, kw):
    """``fit_stream`` and ``sweep`` run the dense step only: an explicit
    large-k knob raises the JAX package's ValueError, word for word."""
    import kmeans_tpu_torch
    ours = _large_k_refusal(kmeans_tpu_torch, family, call, kw)
    assert ours == _large_k_refusal(kmeans_tpu, family, call, kw)
    assert ("fit_stream runs the dense" if call == "fit_stream"
            else "sweep() runs its members") in ours


def test_host_loop_false_on_a_large_k_path_raises():
    X = _data(n=500)
    with pytest.raises(ValueError, match="host_loop=False cannot run the "
                                         "large-k paths"):
        KMeans(device="cpu", assign="two_level", host_loop=False,
               **_kw(X)).fit(X)
    km = KMeans(device="cpu", assign="two_level", coarse_cells=4,
                **_kw(X, max_iter=2)).fit(X)
    assert km.loop_path_ == "host" and km.estep_path_ == "serial"


@pytest.mark.parametrize("mode", ["kernel", "kernel_bf16", "pallas",
                                  "matmul_bf16_guarded"])
def test_mode_rule_refuses_the_kernel_modes(mode):
    """Under a large-k step 'auto' reads 'matmul' (on a CUDA device too,
    where 'auto' is the kernel for the dense fit), and an explicit kernel
    mode raises the JAX package's ValueError; the dense fit keeps the
    kernel modes."""
    X = _data(np.float32, n=500)
    kw = _kw(X, np.float32, max_iter=2)
    kw.pop("distance_mode")
    km = KMeans(device="cpu", assign="two_level", distance_mode=mode, **kw)
    with pytest.raises(ValueError, match="two-level assignment supports "
                                         "the matmul-class modes only"):
        km.fit(X)
    if mode != "matmul_bf16_guarded":     # predict reads its value mode
        with pytest.raises(ValueError, match="matmul-class modes only"):
            pdist.make_two_level_predict_fn(chunk_size=64, nprobe=1,
                                            mode=km._mode())
    KMeans(device="cpu", distance_mode=mode, **kw).fit(X)


def test_mode_rule_auto_is_matmul():
    km = KMeans(k=3, device="cpu", assign="two_level")
    assert km.distance_mode == "auto" and km._large_k_mode() == "matmul"
    km = KMeans(k=3, device="cpu", distance_mode="matmul_bf16")
    assert km._large_k_mode() == "matmul_bf16"
    X = _data(np.float32, n=500)
    kw = _kw(X, np.float32, max_iter=2)
    kw.pop("distance_mode")
    fit = KMeans(device="cpu", assign="two_level", coarse_cells=8,
                 nprobe=8, distance_mode="matmul_bf16", **kw).fit(X)
    assert fit.estep_path_ == "serial" and fit.iterations_run == 2


def test_no_model_axis_for_k_shard():
    with pytest.raises(ValueError, match="requires a TP"):
        pdist.make_kshard_step_fn(None, chunk_size=64)
    with pytest.raises(ValueError, match="requires a model-sharded mesh"):
        KMeans(device="cpu", k_shard=2, **_kw(_data(n=300))).fit(
            _data(n=300))


@pytest.fixture(scope="module")
def saved_pair(tmp_path_factory, jax_two_level):
    X, jm = jax_two_level
    tmp = tmp_path_factory.mktemp("two_level_ckpt")
    pm = _port_with_coarse(X, jm._two_level_route_[0])
    pm.save(tmp / "port.npz")
    jm.save(str(tmp / "jax.npz"))
    return X, pm, jm, tmp


def test_checkpoint_carries_the_route(saved_pair):
    X, pm, _, tmp = saved_pair
    state = pt_ckpt.load_state(tmp / "port.npz")
    np.testing.assert_array_equal(state["two_level_coarse"],
                                  pm._two_level_route_[0])
    assert (state["k_shard"], state["assign"], state["coarse_cells"],
            state["nprobe"], state["ingest"]) == ("auto", "two_level", 8, 2,
                                                  "auto")
    loaded = KMeans.load(tmp / "port.npz", device="cpu")
    assert (loaded.assign, loaded.coarse_cells, loaded.nprobe) == \
        ("two_level", 8, 2)
    np.testing.assert_array_equal(loaded._two_level_route_[0],
                                  pm._two_level_route_[0])
    np.testing.assert_array_equal(loaded.predict(X), pm.predict(X))
    # A model that never ran a two-level fit writes no coarse table.
    dense = KMeans(device="cpu", **_kw(X, max_iter=1)).fit(X)
    dense.save(tmp / "dense.npz")
    assert "two_level_coarse" not in pt_ckpt.load_state(tmp / "dense.npz")


def test_checkpoints_load_across_packages(saved_pair):
    X, pm, jm, tmp = saved_pair
    from_jax = KMeans.load(tmp / "jax.npz", device="cpu")
    np.testing.assert_array_equal(from_jax._two_level_route_[0],
                                  jm._two_level_route_[0])
    np.testing.assert_array_equal(from_jax.predict(X), jm.predict(X))
    from_port = kmeans_tpu.KMeans.load(str(tmp / "port.npz"))
    assert (from_port.assign, from_port.nprobe) == ("two_level", 2)
    np.testing.assert_array_equal(from_port._two_level_route_[0],
                                  pm._two_level_route_[0])
    np.testing.assert_array_equal(np.asarray(from_port.predict(X)),
                                  pm.predict(X))


def test_a_hub_cell_is_visited_in_slices(monkeypatch):
    """A cell that many rows activate is visited in slices of
    ``TWO_LEVEL_TILE_ELEMS // L`` rows: the same labels, the distances to
    the float64 class (a product's summation order follows its shape)."""
    X = _data()
    cents = X[::47][:K]
    km = KMeans(k=K, device="cpu")
    coarse = km._train_coarse(cents, 8)
    members = km._build_members(cents, coarse)
    args = (torch.from_numpy(X), torch.from_numpy(coarse),
            torch.from_numpy(np.concatenate(
                [cents, np.full((1, D), pdist.PAD_CENTROID_VALUE)])),
            torch.from_numpy(members).long())
    whole = pdist._two_level_best(*args, nprobe=3, mode="matmul", k=K)
    monkeypatch.setattr(pdist, "TWO_LEVEL_TILE_ELEMS", 7 * members.shape[1])
    sliced = pdist._two_level_best(*args, nprobe=3, mode="matmul", k=K)
    np.testing.assert_array_equal(sliced[1].numpy(), whole[1].numpy())
    np.testing.assert_allclose(sliced[0].numpy(), whole[0].numpy(),
                               rtol=RTOL, atol=1e-10)
