"""The port's ingest (``parallel.sharding``'s ingest knobs and slab
placement, ``data.io``'s loaders) against the JAX package's.

* C.16: a dataset that ``from_npy`` or ``from_raw`` places on one device
  carries the chunk its loader chose (``chunk_size or choose_chunk_size(n,
  k_hint, D)``, explicit when given), and a fit takes it, as the JAX
  package's does: ``ds.chunk``, the explicit flag and the fit's chunk equal
  the JAX package's for a loader ``chunk_size`` of None, 256 and 8192, the
  fit gives the bits of a model whose own ``chunk_size`` is that chunk, and
  its float32 SSE agrees with the JAX package's fit from the same file
  (rtol 1e-4, the float32 class).
* The ingest knob: the JAX package's grammar and message; 'auto' resolves
  to 'mono' in the port (until the card measures slab's win); without a
  mesh 'slab' is taken and places the one-copy bytes, as the JAX package
  ignores the mode there; the slab placement itself (``place_slabs``) at
  several slab sizes, ragged tails and weights, with and without its
  producer thread, byte for byte against 'mono'; ``KMeans`` and
  ``GaussianMixture`` with ``ingest='slab'`` fit to the mono bits.
  The mesh cases are in ``test_torch_large_k_mesh.py``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu.data import io as jio  # noqa: E402
from kmeans_tpu.parallel import sharding as jsh  # noqa: E402
from kmeans_tpu_torch import GaussianMixture, KMeans  # noqa: E402
from kmeans_tpu_torch.data import io as pio  # noqa: E402
from kmeans_tpu_torch.obs import memory  # noqa: E402
from kmeans_tpu_torch.parallel import sharding as psh  # noqa: E402

F32_RTOL = 1e-4


@pytest.fixture(scope="module")
def probe_file(tmp_path_factory):
    """ROADMAP C.16's probe data: 20,000 x 16 float32, 64 clusters' worth."""
    rng = np.random.default_rng(3)
    X = (3.0 * rng.normal(size=(20_000, 16))
         + 5.0 * rng.integers(0, 8, size=(20_000, 1))).astype(np.float32)
    path = tmp_path_factory.mktemp("c16") / "x.npy"
    np.save(path, X)
    return path, X


def _jax_one_device():
    """The JAX package's mesh of one device, where its one-device dataset
    lives (the tests' virtual CPU devices would give it eight)."""
    import jax
    from kmeans_tpu.parallel.mesh import make_mesh
    return make_mesh(data=1, model=1, devices=jax.devices()[:1])


def _c16_kw(X):
    return dict(k=64, init=X[:64].copy(), max_iter=5, tolerance=1e-12,
                compute_sse=True, verbose=False, distance_mode="matmul")


@pytest.mark.parametrize("chunk_size", [None, 256, 8192])
@pytest.mark.parametrize("raw", [False, True])
def test_one_device_loader_chunk_is_the_references(probe_file, chunk_size,
                                                   raw):
    path, X = probe_file
    if raw:
        ds = pio.from_raw(path, X.shape, device="cpu", offset=128,
                          chunk_size=chunk_size)
        jds = jio.from_raw(path, X.shape, None, offset=128,
                           chunk_size=chunk_size)
    else:
        ds = pio.from_npy(path, device="cpu", chunk_size=chunk_size)
        jds = jio.from_npy(path, None, chunk_size=chunk_size)
    assert ds.mesh is None and ds.points.numpy().tobytes() == X.tobytes()
    assert ds.chunk == jds.chunk
    assert ds.explicit_chunk == jds.explicit_chunk == (chunk_size
                                                       is not None)
    km = KMeans(device="cpu", **_c16_kw(X))
    jm = kmeans_tpu.KMeans(mesh=_jax_one_device(), **_c16_kw(X))
    assert km._chunk_for(ds) == jm._eff_chunk(jds)
    km.fit(ds)
    jm.fit(jds)
    # The fit honours the loader's chunk: the bits of a model whose own
    # chunk_size is that chunk.
    own = KMeans(device="cpu", chunk_size=jds.effective_chunk(64),
                 **_c16_kw(X)).fit(X)
    np.testing.assert_array_equal(km.centroids, own.centroids)
    assert km.sse_history == own.sse_history
    assert km.iterations_run == jm.iterations_run
    np.testing.assert_allclose(km.sse_history, jm.sse_history,
                               rtol=F32_RTOL)


def test_a_loader_chunk_is_clamped_for_the_real_k(probe_file):
    """A chunk chosen for a small ``k_hint`` is bounded for the model's
    real k, as the JAX package's ``effective_chunk`` bounds it."""
    path, _ = probe_file
    ds = pio.from_npy(path, device="cpu", k_hint=2)
    jds = jio.from_npy(path, None, k_hint=2)
    for k in (64, 5000, 40_000):
        assert ds.effective_chunk(k) == jds.effective_chunk(k)
    assert KMeans(k=5000, device="cpu")._chunk_for(ds) == \
        jds.effective_chunk(5000)


def test_a_dataset_without_a_chunk_takes_the_automatic_one():
    X = np.zeros((5000, 8), np.float32)
    ds = psh.to_device(X, torch.device("cpu"), np.float32)
    assert ds.chunk is None and not ds.explicit_chunk
    assert ds.effective_chunk(300) == psh.choose_chunk_size(5000, 300, 8)


@pytest.mark.parametrize("value", ["auto", "mono", "slab", "fast", None])
def test_ingest_grammar_is_the_references(value):
    if value in psh.INGEST_MODES:
        assert psh.check_ingest(value) == jsh.check_ingest(value) == value
        assert psh.resolve_ingest(value) == ("mono" if value == "auto"
                                             else value)
        return
    with pytest.raises(ValueError) as ours:
        psh.check_ingest(value)
    with pytest.raises(ValueError) as theirs:
        jsh.check_ingest(value)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="ingest"):
        KMeans(k=2, device="cpu", ingest=value)
    with pytest.raises(ValueError, match="ingest"):
        GaussianMixture(n_components=2, device="cpu", ingest=value)


def test_auto_stays_mono():
    """'auto' is 'mono' on every device until the card measures slab's
    1.2x win (ROADMAP A.10); the JAX package's CPU backend says 'mono'
    too."""
    assert psh.resolve_ingest("auto") == "mono" == jsh.resolve_ingest("auto")


@pytest.mark.parametrize("weighted", [False, True])
def test_slab_is_taken_without_a_mesh(weighted):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(257, 6)).astype(np.float32)
    sw = rng.uniform(0.0, 3.0, size=257) if weighted else None
    cpu = torch.device("cpu")
    mono = psh.to_device(X, cpu, np.float32, sample_weight=sw,
                         ingest="mono")
    slab = psh.to_device(X, cpu, np.float32, sample_weight=sw,
                         ingest="slab")
    assert slab.points.numpy().tobytes() == mono.points.numpy().tobytes()
    assert slab.weights.numpy().tobytes() == mono.weights.numpy().tobytes()
    jp, jw = jsh.shard_points(X, None, 257, sample_weight=sw,
                              ingest="slab")
    np.testing.assert_array_equal(np.asarray(jp), X)
    np.testing.assert_array_equal(slab.weights.numpy(), np.asarray(jw))


@pytest.mark.parametrize("slab_rows", [1, 7, 64, 300])
@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_place_slabs_is_byte_identical_to_mono(monkeypatch, slab_rows,
                                               prefetch, dtype):
    rng = np.random.default_rng(slab_rows)
    X = rng.normal(size=(203, 5)).astype(dtype)
    sw = rng.uniform(0.0, 2.0, size=203).astype(dtype)
    monkeypatch.setattr(memory, "INGEST_SLAB_TARGET_BYTES",
                        slab_rows * 5 * np.dtype(dtype).itemsize)
    for lo, hi, block in ((0, 102, 102), (102, 203, 102), (0, 203, 203)):
        for w in (None, sw):
            points, weights, slabs = psh.place_slabs(
                lambda a, b: X[a:b], lo, hi, block, 5, "cpu", dtype, w,
                prefetch=prefetch)
            rows, mask = psh.pad_points(X[lo:hi], block, min_rows=block)
            if w is not None:
                mask[: hi - lo] = w[lo:hi]
            assert slabs == -(-block // slab_rows)
            assert points.numpy().tobytes() == rows.tobytes()
            assert weights.numpy().tobytes() == mask.tobytes()


def test_plan_ingest_gives_the_slab_size(monkeypatch):
    """The slab holds ``plan_ingest``'s ``target_bytes`` of rows."""
    X = np.zeros((1000, 4), np.float32)
    monkeypatch.setattr(memory, "INGEST_SLAB_TARGET_BYTES", 160)
    _, _, slabs = psh.place_slabs(lambda a, b: X[a:b], 0, 1000, 1000, 4,
                                  "cpu", np.float32)
    assert slabs == 100
    assert memory.plan_ingest(1000, 4)["target_bytes"] == 160


def test_kmeans_and_the_mixture_fit_the_same_with_slab():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(400, 4)) + rng.integers(0, 4, size=(400, 1)) * 4
    kw = dict(k=4, max_iter=6, compute_sse=True, verbose=False,
              dtype=np.float64, device="cpu")
    fits = [KMeans(ingest=m, **kw).fit(X) for m in ("mono", "slab")]
    np.testing.assert_array_equal(fits[0].centroids, fits[1].centroids)
    assert fits[1].ingest == "slab" and \
        fits[1].get_params()["ingest"] == "slab"
    gkw = dict(n_components=3, max_iter=5, init_params="random", seed=1,
               dtype=np.float64, device="cpu")
    gms = [GaussianMixture(ingest=m, **gkw).fit(X) for m in ("mono", "slab")]
    np.testing.assert_array_equal(gms[0].means_, gms[1].means_)
    assert gms[1].get_params()["ingest"] == "slab"


def test_loader_docstring_says_the_whole_file_is_read_without_a_mesh():
    doc = pio.from_npy.__doc__
    assert "never loaded whole" not in doc.split("Under a mesh")[0]
    assert "reads the whole file" in doc
