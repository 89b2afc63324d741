"""Warm start in the port against the JAX package's ``tests/test_aot.py``:
the fit-shape bucket, the overlapped set-up, and the store of built kernel
libraries (``kmeans_tpu_torch/utils/aot.py``) shipped with checkpoints.

Pinned contracts:

* the bucket ladder, ``check_bucket`` and ``bucket_target`` are the JAX
  package's, errors included; ``bucket`` pads with inert rows of weight 0;
  ``bucket=0`` is the bit-exact oracle; ``bucket='auto'`` matches the JAX
  package's ``bucket='auto'`` fit in the float64 class (labels, counts and
  iterations equal, centroids and SSE to ``rtol=1e-12``); a second fit in
  the same bucket builds nothing (``recompilation_sentinel``);
* ``overlap=1`` gives the bits of ``overlap=0`` by both loops and stages
  the upload on the producer thread;
* the store checks the key fields and the sha256 before a library is
  placed where ``dlopen`` reads it; a corrupted or version-skewed artefact
  is a counted fallback to a build of the same kernel, never its bytes.

No ``nvcc`` here: the library bytes of the store's cases are a stand-in
file, and ``ops._build``'s build is replaced by one that counts and
refuses.  The cross-process load of real libraries, with ``nvcc`` hidden,
is ``chip_smoke.py``'s phase ``warm_start`` on the card.  (The JAX
package's own cross-process round trip fails here, ROADMAP C.4; it is not
copied.)
"""

import json
import os
import subprocess
import sys
import threading
import warnings
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu.parallel import sharding as jsh  # noqa: E402
from kmeans_tpu_torch import (BisectingKMeans, GaussianMixture,  # noqa: E402
                              KMeans, MiniBatchKMeans, SphericalKMeans)
from kmeans_tpu_torch import convert  # noqa: E402
from kmeans_tpu_torch.models import kmeans as km_mod  # noqa: E402
from kmeans_tpu_torch.obs import metrics_registry  # noqa: E402
from kmeans_tpu_torch.obs import trace as obs_trace  # noqa: E402
from kmeans_tpu_torch.ops import _build  # noqa: E402
from kmeans_tpu_torch.parallel import sharding as psh  # noqa: E402
from kmeans_tpu_torch.utils import aot  # noqa: E402
from kmeans_tpu_torch.utils.profiling import \
    recompilation_sentinel  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _aot_isolation():
    """Every test starts and ends with no store active."""
    aot.deactivate()
    yield
    aot.deactivate()


def _blobs(n=600, d=6, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(4, d)) * 6
    return (cents[rng.integers(0, 4, n)]
            + rng.normal(size=(n, d))).astype(dtype)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 -- compared with the reference's
        return (type(e).__name__, str(e))


# ------------------------------------------------------------ the ladder

def test_bucket_ladder_and_grammar_are_the_references():
    ns = list(range(1, 3000)) + [4095, 4096, 4097, 123457, 10 ** 6,
                                 1_900_000, 2_000_000, 2_097_152,
                                 2_097_153]
    for n in ns:
        assert psh.bucket_rows(n) == jsh.bucket_rows(n), n
    assert (psh.BUCKET_RUNGS, psh.BUCKET_FLOOR) == (jsh.BUCKET_RUNGS,
                                                    jsh.BUCKET_FLOOR)
    # Several rungs are crossed, each a fixed point, at most 25 % padding.
    rungs = sorted({psh.bucket_rows(n) for n in ns})
    assert len(rungs) > 20
    assert all(psh.bucket_rows(b) == b for b in rungs)
    assert all(psh.bucket_rows(n) / n <= 1.25 + 1e-9 for n in ns if n > 256)
    for value in ("auto", 0, 3, 7.0, True, -1, "sometimes", 2.5, "0"):
        assert _outcome(psh.check_bucket, value) == \
            _outcome(jsh.check_bucket, value), value
    for bucket in ("auto", 0, 500, 7):
        for n in (1, 255, 256, 601, 1000, 1900000):
            assert psh.bucket_target(bucket, n) == \
                jsh.bucket_target(bucket, n)


def test_bucket_param_validation():
    with pytest.raises(ValueError, match="bucket"):
        KMeans(k=2, bucket="sometimes", device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        KMeans(k=2, bucket=-1, device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        GaussianMixture(n_components=2, bucket="sometimes", device="cpu")
    with pytest.raises(ValueError, match="overlap"):
        KMeans(k=2, overlap=2, device="cpu")
    with pytest.raises(ValueError, match="overlap"):
        GaussianMixture(n_components=2, overlap=2, device="cpu")


@pytest.mark.parametrize("weighted", [False, True])
def test_bucket_pads_with_inert_rows(weighted):
    X = _blobs(n=600)
    w = np.linspace(0.5, 2.0, 600).astype(np.float32) if weighted else None
    ds = KMeans(k=4, bucket="auto", verbose=False, device="cpu").cache(
        X, sample_weight=w)
    assert ds.n == 600 and ds.host.shape == (600, 6)      # real rows
    assert ds.points.shape[0] == psh.bucket_rows(600) == 640
    wt = ds.weights.numpy()
    np.testing.assert_array_equal(wt[:600], w if weighted else 1.0)
    assert wt[600:].sum() == 0.0 and not ds.points[600:].any()
    assert ds.positive_count() == 600
    assert ds.gather_rows(torch.arange(640)).shape == (600,)


# ------------------------------------------------- the bit-exact oracle

FAMILIES = [
    ("kmeans", lambda **kw: KMeans(k=4, max_iter=8, seed=5, verbose=False,
                                   device="cpu", **kw)),
    ("kmeans_device", lambda **kw: KMeans(k=4, max_iter=8, seed=5,
                                          verbose=False, device="cpu",
                                          host_loop=False, **kw)),
    ("minibatch", lambda **kw: MiniBatchKMeans(k=4, max_iter=6, seed=5,
                                               batch_size=128, device="cpu",
                                               verbose=False, **kw)),
    ("bisecting", lambda **kw: BisectingKMeans(k=4, max_iter=6, seed=5,
                                               device="cpu", verbose=False,
                                               **kw)),
    ("spherical", lambda **kw: SphericalKMeans(k=4, max_iter=8, seed=5,
                                               device="cpu", verbose=False,
                                               **kw)),
    ("gmm", lambda **kw: GaussianMixture(n_components=3, max_iter=6,
                                         seed=5, device="cpu", **kw)),
]


def _table(model):
    return np.asarray(model.centroids if hasattr(model, "centroids")
                      and model.centroids is not None else model.means_)


@pytest.mark.parametrize("name,build", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_bucket0_is_bit_exact_oracle(name, build):
    X = _blobs(n=700, d=5)
    base = build().fit(X)
    oracle = build(bucket=0).fit(X)
    assert np.array_equal(_table(base), _table(oracle))


@pytest.mark.parametrize("name,build", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_bucket_auto_same_semantics(name, build):
    """'auto' adds inert rows only: the same trajectory to the float32
    tolerance, the attributes at the real shapes."""
    X = _blobs(n=700, d=5)
    base = build().fit(X)
    auto = build(bucket="auto").fit(X)
    assert _table(auto).shape == _table(base).shape
    np.testing.assert_allclose(_table(auto), _table(base), atol=1e-4)
    if hasattr(auto, "labels_"):
        np.testing.assert_array_equal(auto.labels_, base.labels_)
    assert np.asarray(auto.predict(X)).shape == (700,)


@pytest.mark.parametrize("host_loop", [True, False])
@pytest.mark.parametrize("n", [700, 1900])
def test_bucket_auto_matches_the_jax_package(mesh1, host_loop, n):
    """The float64 parity class: labels, counts and iterations equal,
    centroids and SSE history to ``rtol=1e-12``."""
    X = _blobs(n=n, d=5, seed=2, dtype=np.float64)
    kw = dict(k=5, max_iter=12, seed=3, compute_sse=True, verbose=False,
              dtype=np.float64, distance_mode="matmul", bucket="auto",
              host_loop=host_loop, empty_cluster="keep")
    jm = kmeans_tpu.KMeans(mesh=mesh1, **kw).fit(X)
    pm = KMeans(device="cpu", **kw).fit(X)
    assert pm.iterations_run == jm.iterations_run
    np.testing.assert_array_equal(pm.labels_, np.asarray(jm.labels_))
    np.testing.assert_array_equal(pm.cluster_sizes_, jm.cluster_sizes_)
    np.testing.assert_allclose(pm.centroids, np.asarray(jm.centroids),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(pm.sse_history, jm.sse_history, rtol=1e-12)


@pytest.mark.parametrize("host_loop", [True, False])
def test_same_bucket_repeat_fit_zero_new_entries(host_loop):
    """Two row counts in one bucket run the same step functions: nothing
    is built in the second fit (no cache entry, no library, no compile
    span of a miss).  On the card a device loop still captures its graph
    once for the new dataset (``chip_smoke.py``'s phase ``bucket``); on
    the CPU nothing is captured."""
    def build():
        return KMeans(k=4, max_iter=5, seed=5, verbose=False, device="cpu",
                      bucket="auto", host_loop=host_loop,
                      empty_cluster="keep")
    assert psh.bucket_rows(900) == psh.bucket_rows(1000)
    build().fit(_blobs(n=900))
    with obs_trace.tracing() as tr, recompilation_sentinel() as rec:
        build().fit(_blobs(n=1000, seed=9))
    assert rec["new"] == {}
    assert [r for r in tr.records() if r.get("kind") == "span"
            and r["name"] == "compile"] == []


def test_explicit_int_bucket_rounds_up():
    km = KMeans(k=4, bucket=500, verbose=False, device="cpu")
    assert km._bucket_target(601) == 1000
    assert km._bucket_target(1000) == 1000
    assert km.cache(_blobs(n=601)).points.shape[0] == 1000


def test_bucket_roundtrips_through_params_checkpoint_and_convert(tmp_path):
    km = KMeans(k=4, max_iter=4, seed=0, bucket="auto", overlap=0,
                verbose=False, device="cpu").fit(_blobs())
    assert km.get_params()["bucket"] == "auto"
    assert km.get_params()["overlap"] == 0
    km.save(tmp_path / "m.npz")
    loaded = KMeans.load(tmp_path / "m.npz", device="cpu")
    assert loaded.bucket == "auto" and loaded.overlap == 0
    jx = kmeans_tpu.KMeans.load(tmp_path / "m.npz")
    assert jx.bucket == "auto" and jx.overlap == 0
    back = convert.from_jax_state(jx._state_dict(), device="cpu")
    assert back.bucket == "auto" and back.overlap == 0
    assert convert.to_jax_state(back)["bucket"] == "auto"
    km.set_params(bucket=512)
    assert km.bucket == 512
    g = GaussianMixture(n_components=2, max_iter=3, seed=0, bucket=512,
                        overlap=1, device="cpu").fit(_blobs())
    g.save(tmp_path / "g.npz")
    gl = GaussianMixture.load(tmp_path / "g.npz", device="cpu")
    assert gl.bucket == 512 and gl.overlap == 1
    assert kmeans_tpu.GaussianMixture.load(tmp_path / "g.npz").bucket == 512


# ------------------------------------------------------------ overlap

@pytest.mark.parametrize("host_loop", [True, False])
def test_overlap_bit_exact_parity(host_loop):
    X = _blobs(n=800, d=6)
    kw = dict(k=4, max_iter=8, seed=2, verbose=False, device="cpu",
              host_loop=host_loop, empty_cluster="keep", bucket="auto")
    serial = KMeans(overlap=0, **kw).fit(X)
    lapped = KMeans(overlap=1, **kw).fit(X)
    assert np.array_equal(serial.centroids, lapped.centroids)
    assert np.array_equal(serial.labels_, lapped.labels_)
    assert serial.iterations_run == lapped.iterations_run
    assert KMeans(overlap="auto", **kw)._resolve_overlap() == 0   # the CPU


def test_overlap_stages_on_producer_thread():
    """The overlapped set-up's 'place' and 'stage' spans come from the
    producer thread, the step cache's misses from the fit's."""
    X = _blobs(n=800)
    km_mod._STEP_CACHE.clear()
    with obs_trace.tracing() as tr:
        KMeans(k=4, max_iter=3, seed=2, verbose=False, overlap=1,
               host_loop=False, empty_cluster="keep", device="cpu").fit(X)
    main_tid = threading.get_ident()
    spans = [r for r in tr.records() if r.get("kind") == "span"]
    stage = [s for s in spans if s["name"] in ("stage", "place")]
    assert stage and all(s["tid"] != main_tid for s in stage)
    compiles = [s for s in spans if s["name"] == "compile"]
    assert compiles and all(s["tid"] == main_tid for s in compiles)


def test_overlap_skips_dataset_input():
    km = KMeans(k=4, max_iter=4, seed=2, verbose=False, overlap=1,
                device="cpu")
    ds = km.cache(_blobs())
    assert not km._overlaps(ds) and km._overlaps(_blobs())
    assert not km._overlaps(torch.from_numpy(_blobs()))
    ref = KMeans(k=4, max_iter=4, seed=2, verbose=False, overlap=0,
                 device="cpu").fit(_blobs())
    assert np.array_equal(km.fit(ds).centroids, ref.centroids)


# --------------------------------------------------------- the store

def test_aot_supported_is_false_with_a_reason_on_the_cpu():
    ok, reason = aot.aot_supported()
    assert not ok and "CPU" in reason


def test_artifact_key_spans_versions_and_the_card():
    fields = aot.artifact_key("assign_kernels", {"TILE": 64},
                              capability="9.0")
    assert fields["format"] == aot.FORMAT
    assert fields["library"] == "assign_kernels"
    assert fields["defines"] == [["TILE", 64]]
    assert fields["sources"] == _build._sources_hash({"TILE": 64})
    assert fields["nvcc_flags"] == _build.NVCC_FLAGS
    assert fields["capability"] == "9.0"
    assert fields["torch"] == torch.__version__
    assert fields["torch_cuda"] == torch.version.cuda
    json.dumps(fields)                       # JSON-stable: the digest's input
    assert aot.artifact_key("assign_kernels")["capability"] is None  # CPU
    base = aot._digest(aot.artifact_key("assign_kernels", capability="9.0"))
    for other in (aot.artifact_key("assign_bf16", capability="9.0"),
                  aot.artifact_key("assign_kernels", {"TILE": 64},
                                   capability="9.0"),
                  aot.artifact_key("assign_kernels", capability="8.0")):
        assert aot._digest(other) != base


def _fake_library(path: Path, payload: bytes = b"\x7fELF stand-in") -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(payload)
    return path


def test_store_round_trip_in_process(tmp_path):
    store = aot.configure(tmp_path / "store", mirror=tmp_path / "mirror")
    assert aot.active_store() is store
    lib = _fake_library(tmp_path / "built" / "lib.so")
    fields = aot.artifact_key("assign_kernels", capability="9.0")
    assert store.put(fields, lib)
    arts = list((tmp_path / "store").glob("*.klib"))
    assert len(arts) == 1
    assert list((tmp_path / "mirror").glob("*.klib"))[0].name == arts[0].name
    dest = tmp_path / "fresh_build" / "libassign_kernels.so"
    assert store.get(fields, dest)
    assert dest.read_bytes() == lib.read_bytes()
    with zipfile.ZipFile(arts[0]) as z:
        meta = json.loads(z.read("meta.json"))
    assert meta.pop("sha256") and meta == json.loads(json.dumps(fields))
    # Another key misses; a read directory serves what it holds.
    assert not store.get(aot.artifact_key("assign_bf16", capability="9.0"),
                         tmp_path / "x.so")
    other = aot.AOTStore(tmp_path / "elsewhere",
                         read_dirs=[tmp_path / "store"])
    assert other.get(fields, tmp_path / "y.so")
    st = store.stats()
    assert (st["saved"], st["loaded"], st["fallbacks"]) == (1, 1, 0)
    assert st["available"] is False and st["mirror"] == str(
        tmp_path / "mirror")


@pytest.mark.parametrize("damage", ["not_a_zip", "flipped_byte"])
def test_corrupted_artifact_is_a_counted_fallback(tmp_path, damage):
    store = aot.configure(tmp_path / "store")
    fields = aot.artifact_key("assign_kernels", capability="9.0")
    store.put(fields, _fake_library(tmp_path / "lib.so"))
    art = next((tmp_path / "store").glob("*.klib"))
    if damage == "not_a_zip":
        art.write_bytes(b"not a zip")
    else:
        with zipfile.ZipFile(art) as z:
            meta, data = z.read("meta.json"), bytearray(z.read("lib.so"))
        data[3] ^= 0x01
        with zipfile.ZipFile(art, "w") as z:
            z.writestr("meta.json", meta)
            z.writestr("lib.so", bytes(data))
    before = metrics_registry.REGISTRY.counter("aot.fallback").value
    dest = tmp_path / "build" / "lib.so"
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert not store.get(fields, dest)
    assert not dest.exists()                       # never its bytes
    assert store.stats()["fallbacks"] == 1
    assert metrics_registry.REGISTRY.counter("aot.fallback").value \
        == before + 1
    assert any("unusable" in str(x.message) for x in w)


def test_version_skewed_artifact_is_a_counted_fallback(tmp_path):
    """An artefact whose meta names another torch build is a mismatch
    (counted), never this build's library, though its bytes are whole."""
    store = aot.configure(tmp_path / "store")
    fields = aot.artifact_key("assign_kernels", capability="9.0")
    store.put(fields, _fake_library(tmp_path / "lib.so"))
    art = next((tmp_path / "store").glob("*.klib"))
    with zipfile.ZipFile(art) as z:
        meta, data = json.loads(z.read("meta.json")), z.read("lib.so")
    meta["torch"] = "999.0.0"
    with zipfile.ZipFile(art, "w") as z:
        z.writestr("meta.json", json.dumps(meta, sort_keys=True))
        z.writestr("lib.so", data)
    dest = tmp_path / "build" / "lib.so"
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert not store.get(fields, dest)
    assert not dest.exists() and store.stats()["fallbacks"] == 1
    assert any("mismatch" in str(x.message) and "torch" in str(x.message)
               for x in w)


@pytest.fixture()
def fake_build(tmp_path, monkeypatch):
    """An empty build directory under ``tmp_path``, and an ``nvcc`` that
    counts and refuses (no toolkit here): what ``ops._build`` loads."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    calls = []

    def no_nvcc(variants):
        calls.append(list(variants))
        raise _build.KernelCompileError("nvcc hidden in this test")
    monkeypatch.setattr(_build, "build_variants", no_nvcc)
    return calls


def test_a_load_reads_the_store_before_nvcc(tmp_path, fake_build):
    store = aot.configure(tmp_path / "store")
    lib = _fake_library(tmp_path / "other" / "lib.so")
    store.put(aot.artifact_key("assign_kernels"), lib)
    assert _build._ensure_built("assign_kernels", {}) == "aot-load"
    assert fake_build == []
    assert _build.library_path("assign_kernels").read_bytes() == \
        lib.read_bytes()
    assert _build._ensure_built("assign_kernels", {}) == "load"
    # A damaged artefact: the same kernel goes to nvcc (refused here),
    # its bytes never to the build directory.
    _build.library_path("assign_kernels").unlink()
    art = next((tmp_path / "store").glob("*.klib"))
    art.write_bytes(b"torn")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(_build.KernelCompileError, match="hidden"):
            _build._ensure_built("assign_kernels", {})
    assert fake_build == [[("assign_kernels", {})]]
    assert not _build.library_path("assign_kernels").exists()
    assert store.stats()["fallbacks"] == 1


def test_store_off_costs_nothing():
    """Without a store the miss hook returns its entry unchanged and a load
    asks no store; with one on the CPU the entry is unchanged too and no
    library is loaded (none ever is on the CPU)."""
    assert aot.active_store() is None and _build._active_store() is None
    fn = object()
    key = ("make_step_fn", (None,), (("chunk_size", 8), ("mode", "kernel")))
    assert aot.wrap("kmeans._STEP_CACHE", key, fn) is fn
    km_mod._STEP_CACHE.clear()
    libs = dict(_build._LIBS)
    KMeans(k=3, max_iter=3, seed=0, verbose=False, device="cpu").fit(
        _blobs())
    assert dict(_build._LIBS) == libs
    aot.configure("unused-store-root")
    assert aot.wrap("kmeans._STEP_CACHE", key, fn) is fn
    assert aot.libraries_for(key) == ["assign_kernels"]
    assert aot.libraries_for(("make_gmm_step_fn", (None,),
                              (("mode", "kernel"),))) == ["gmm_estep"]
    assert aot.libraries_for(("make_step_fn", (), (("mode", "matmul"),))) \
        == []
    assert dict(_build._LIBS) == libs
    assert not Path("unused-store-root").exists()


def test_describe_dir_and_ship_with_checkpoint(tmp_path, fake_build,
                                               monkeypatch):
    """A checkpointed fit with a store active mirrors the libraries it
    loaded into ``<ckpt>.aot``; a resume from that checkpoint with another
    store adds the directory to its read path, and an empty build
    directory then gets the library from it, with no nvcc.  (The CPU
    loads no library: one stands in, loaded as the card would have.)"""
    lib = _fake_library(_build.library_path("assign_kernels"))
    monkeypatch.setattr(_build, "_LIBS",
                        {("assign_kernels", ()): object()})
    store = aot.configure(tmp_path / "store")
    X = _blobs(n=700, d=6)
    ckpt = tmp_path / "model.npz"
    kw = dict(k=4, seed=3, verbose=False, device="cpu",
              empty_cluster="keep")
    KMeans(max_iter=4, **kw).fit(X, checkpoint_every=2,
                                 checkpoint_path=ckpt)
    shipped = aot.aot_dir_for(ckpt)
    assert shipped == tmp_path / "model.npz.aot"
    assert store.mirror == shipped and list(shipped.glob("*.klib"))
    desc = aot.describe_dir(shipped)
    assert desc["exists"] and desc["artifacts"] == 1
    assert desc["bytes"] > 0 and desc["unreadable"] == 0
    assert [d["library"] for d in desc["libraries"]] == ["assign_kernels"]
    assert aot.describe_dir(tmp_path / "none")["exists"] is False
    # A fresh host: another store, an empty build directory, no nvcc.
    lib.unlink()
    store2 = aot.configure(tmp_path / "other")
    km2 = KMeans(max_iter=6, **kw)
    km2.fit(X, resume=ckpt)
    assert str(shipped) in [str(d) for d in store2.read_dirs]
    assert _build._ensure_built("assign_kernels", {}) == "aot-load"
    assert fake_build == [] and store2.stats()["loaded"] == 1
    assert km2.iterations_run == 6


_KNOB_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from kmeans_tpu_torch import KMeans
before = "kmeans_tpu_torch.utils.aot" in sys.modules
KMeans(k=3, max_iter=2, seed=0, verbose=False, device="cpu").fit(
    np.random.default_rng(0).normal(size=(200, 4)))
after = "kmeans_tpu_torch.utils.aot" in sys.modules
from kmeans_tpu_torch.ops import _build
from kmeans_tpu_torch.utils import aot
store = aot.active_store()
print(json.dumps({"before": before, "after": after,
                  "root": None if store is None else str(store.root),
                  "build_dir": str(_build.BUILD_DIR),
                  "library": str(_build.library_path("assign_kernels")),
                  "enabled": aot.enable_compilation_cache()}))
"""


def _knob_child(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("KMEANS_TPU_TORCH_AOT_CACHE",
                        "KMEANS_TPU_TORCH_BUILD_DIR")}
    env.update(env_extra)
    proc = subprocess.run([sys.executable, "-c", _KNOB_CHILD, str(ROOT)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_env_knob_activates_the_store(tmp_path):
    got = _knob_child({"KMEANS_TPU_TORCH_AOT_CACHE": str(tmp_path / "env")})
    assert got["root"] == str(tmp_path / "env")
    # The step cache's miss hook imported the store's module for the knob.
    assert not got["before"] and got["after"]
    off = _knob_child({})
    assert off["root"] is None and not off["after"]


def test_build_dir_env_knob(tmp_path):
    got = _knob_child({"KMEANS_TPU_TORCH_BUILD_DIR": str(tmp_path / "b")})
    assert got["build_dir"] == got["enabled"] == str(tmp_path / "b")
    assert Path(got["library"]).parent == tmp_path / "b"
    off = _knob_child({})
    assert off["build_dir"] == off["enabled"] == str(
        ROOT / "kmeans_tpu_torch" / "build")
