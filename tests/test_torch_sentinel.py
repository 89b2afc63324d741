"""The port's recompilation sentinel (``kmeans_tpu_torch/utils/profiling.py``)
against the sentinel cases of the JAX package's ``tests/test_lint.py``:
the step caches are discovered, growth raises naming the cache and the key,
the ``allowed_new`` budget holds, a clean scope records nothing, a repeated
``predict`` of every family and repeated serving calls build nothing.  The
port makes programs in two more places, watched beside the caches: a
kernel library loaded (``ops._build._LIBS``) and a CUDA graph captured by a
device loop (``parallel.distributed.CAPTURES``); each counts as growth."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu_torch import (BisectingKMeans, GaussianMixture,  # noqa: E402
                              KMeans, MiniBatchKMeans, SphericalKMeans)
from kmeans_tpu_torch.models import kmeans as km  # noqa: E402
from kmeans_tpu_torch.obs import trace as obs_trace  # noqa: E402
from kmeans_tpu_torch.ops import _build  # noqa: E402
from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402
from kmeans_tpu_torch.serving import ServingEngine  # noqa: E402
from kmeans_tpu_torch.utils.profiling import (  # noqa: E402
    CAPTURES, LIBRARIES, RecompilationError, compile_caches,
    recompilation_sentinel)

KM_CACHE = "kmeans_tpu_torch.models.kmeans._STEP_CACHE"


def test_compile_caches_discovers_package_caches():
    names = set(compile_caches())
    assert KM_CACHE in names
    assert "kmeans_tpu_torch.models.gmm._STEP_CACHE" in names
    assert "kmeans_tpu_torch.models.init._PIPE_CACHE" in names


def test_sentinel_raises_on_growth_naming_cache_and_key():
    probe = ("recompilation-sentinel-probe",)
    try:
        with pytest.raises(RecompilationError) as ei:
            with recompilation_sentinel():
                km._STEP_CACHE[probe] = object()
        msg = str(ei.value)
        assert KM_CACHE in msg and "recompilation-sentinel-probe" in msg
    finally:
        km._STEP_CACHE._d.pop(probe, None)


def test_sentinel_allowed_new_budget():
    probe = ("recompilation-sentinel-probe-2",)
    try:
        with obs_trace.tracing() as tr:
            with recompilation_sentinel(allowed_new=1) as rec:
                km._STEP_CACHE[probe] = object()
        assert rec["new"] == {KM_CACHE: [probe]}
        spans = [r for r in tr.records() if r.get("kind") == "span"
                 and r["name"] == "compile"]
        assert [(s["attrs"]["cache"], s["attrs"]["via"]) for s in spans] \
            == [(KM_CACHE, "sentinel")]
    finally:
        km._STEP_CACHE._d.pop(probe, None)


def test_sentinel_clean_scope_records_empty():
    with recompilation_sentinel() as rec:
        pass
    assert rec["new"] == {}
    assert {KM_CACHE, LIBRARIES, CAPTURES} <= set(rec["caches"])


@pytest.mark.parametrize("place", ["library", "capture"])
def test_a_library_load_and_a_graph_capture_count_as_growth(place):
    """A kernel library loaded and a device loop's graph captured are
    programs made: outside the budget they raise, naming where and what;
    within it they are recorded."""
    keys = [("sentinel_probe_source", (("TILE", i),)) for i in range(2)]
    before = dict(dist.CAPTURES)

    def grow(i):
        if place == "library":
            _build._LIBS[keys[i]] = object()
        else:
            dist.CAPTURES["_DeviceLoop"] = \
                dist.CAPTURES.get("_DeviceLoop", 0) + 1
    where = LIBRARIES if place == "library" else CAPTURES
    try:
        with pytest.raises(RecompilationError) as ei:
            with recompilation_sentinel():
                grow(0)
        assert where in str(ei.value)
        assert ("sentinel_probe_source" if place == "library"
                else "_DeviceLoop") in str(ei.value)
        with recompilation_sentinel(allowed_new=1) as rec:
            grow(1)
        assert list(rec["new"]) == [where]
    finally:
        for key in keys:
            _build._LIBS.pop(key, None)
        dist.CAPTURES.clear()
        dist.CAPTURES.update(before)


@pytest.fixture(scope="module")
def blob_data():
    rng = np.random.RandomState(7)
    centers = rng.randn(4, 6) * 6.0
    X = np.concatenate([c + rng.randn(50, 6) for c in centers])
    return X.astype(np.float32)


def _families():
    common = dict(seed=0, verbose=False, device="cpu")
    return {
        "kmeans": KMeans(k=3, max_iter=5, **common),
        "minibatch": MiniBatchKMeans(k=3, max_iter=6, batch_size=64,
                                     **common),
        "bisecting": BisectingKMeans(k=3, max_iter=5, **common),
        "spherical": SphericalKMeans(k=3, max_iter=5, **common),
        "gmm": GaussianMixture(n_components=3, max_iter=5, seed=0,
                               device="cpu"),
    }


@pytest.mark.parametrize("family", sorted(_families().keys()))
def test_repeat_predict_adds_zero_cache_entries(family, blob_data):
    model = _families()[family]
    model.fit(blob_data)
    warm = model.predict(blob_data)
    with recompilation_sentinel() as rec:
        for _ in range(3):
            got = model.predict(blob_data)
    np.testing.assert_array_equal(got, warm)
    assert rec["new"] == {}


def test_repeat_serving_calls_add_zero_cache_entries(blob_data):
    model = KMeans(k=3, max_iter=5, seed=0, verbose=False,
                   device="cpu").fit(blob_data)
    gm = GaussianMixture(n_components=3, max_iter=5, seed=0,
                         device="cpu").fit(blob_data)
    with ServingEngine(device="cpu", max_wait_ms=1.0, quality=False) as eng:
        eng.add_model("m", model)
        eng.add_model("g", gm)
        probe = blob_data[:17]
        warm = eng.predict("m", probe)
        eng.call("m", probe, op="score_rows")
        gwarm = eng.predict("g", probe)
        with recompilation_sentinel() as rec:
            for _ in range(3):
                got = eng.predict("m", probe)
                eng.call("m", probe, op="score_rows")
                ggot = eng.predict("g", probe)
        np.testing.assert_array_equal(got, warm)
        np.testing.assert_array_equal(ggot, gwarm)
        assert rec["new"] == {}
