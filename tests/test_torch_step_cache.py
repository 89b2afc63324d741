"""The port's step caches (``kmeans_tpu_torch/utils/cache.py``) against the
cases of the JAX package's ``tests/test_step_cache.py``: the LRU semantics,
``get_or_create`` never raising on eviction, and a ``predict_stream`` of
many block shapes kept within the cache's bound.  Beside them: the caches
keep builders' products only, so a dataset dropped after a device-loop fit
still frees its loops (its captured graphs live in the dataset's memo)."""

import gc
import weakref

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu_torch import KMeans, MiniBatchKMeans  # noqa: E402
from kmeans_tpu_torch.models import kmeans as kmeans_mod  # noqa: E402
from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402
from kmeans_tpu_torch.utils.cache import (LRUCache,  # noqa: E402
                                          builder_key, cached_build)


def test_lru_semantics():
    c = LRUCache(2)
    c["a"] = 1
    c["b"] = 2
    _ = c["a"]          # refresh a
    c["c"] = 3          # evicts b (LRU)
    assert "a" in c and "c" in c and "b" not in c and len(c) == 2
    assert c.keys() == ["a", "c"]
    with pytest.raises(ValueError, match="maxsize"):
        LRUCache(0)


def test_get_or_create_never_raises_on_eviction():
    """The models go through get_or_create, so an eviction between a check
    and a read can never surface as KeyError: the factory's result is
    returned directly."""
    c = LRUCache(1)
    calls = []
    assert c.get_or_create("a", lambda: calls.append("a") or 1) == 1
    assert c.get_or_create("b", lambda: calls.append("b") or 2) == 2
    assert c.get_or_create("a", lambda: calls.append("a2") or 3) == 3
    assert calls == ["a", "b", "a2"] and len(c) == 1


def test_predict_stream_cache_bounded(monkeypatch):
    cap = 6
    monkeypatch.setattr(kmeans_mod, "_STEP_CACHE", LRUCache(cap))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(512, 4)).astype(np.float32)
    km = KMeans(k=3, seed=0, verbose=False, max_iter=5, device="cpu").fit(X)
    want = km.predict(X)
    # 20 distinct block sizes: 20 chunks, each its own predict pass; the
    # bound keeps at most ``cap`` of them.
    sizes = [17 + 13 * i for i in range(20)]
    got = np.concatenate(list(km.predict_stream(
        lambda: (X[: s] for s in sizes))))
    assert len(kmeans_mod._STEP_CACHE) <= cap
    np.testing.assert_array_equal(got, np.concatenate(
        [want[: s] for s in sizes]))


def test_builder_keys_span_every_argument():
    """The key of a builder's product names the builder and every
    argument, a mesh by identity; equal calls hit, others miss."""
    c = LRUCache(8, name="unit")
    a = cached_build(c, dist.make_step_fn, None, chunk_size=16,
                     mode="matmul")
    assert cached_build(c, dist.make_step_fn, None, mode="matmul",
                        chunk_size=16) is a
    b = cached_build(c, dist.make_step_fn, None, chunk_size=32,
                     mode="matmul")
    assert b is not a and len(c) == 2
    key = builder_key(dist.make_step_fn, None, chunk_size=16, mode="matmul")
    assert key == ("make_step_fn", (None,),
                   (("chunk_size", 16), ("mode", "matmul")))
    assert builder_key(dist.make_multi_fit_fn, k_reals=[3, 4]) == \
        ("make_multi_fit_fn", (), (("k_reals", (3, 4)),))


def test_a_dropped_dataset_still_frees_its_loops_with_the_caches():
    """The step caches keep the builders' products (the loop functions),
    never a loop: with the caches warm, a dataset dropped after a
    device-loop fit frees its loops by reference counting (the cyclic
    collector off), for the Lloyd loop and the mini-batch loop alike."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(600, 4)) + 4.0 * rng.integers(0, 3, size=(600, 1))
    kw = dict(k=3, max_iter=5, seed=0, device="cpu", verbose=False,
              host_loop=False)

    def live():
        return sum(issubclass(type(o), dist._DeviceLoop)
                   for o in gc.get_objects())

    for make in (lambda: KMeans(empty_cluster="resample", **kw),
                 lambda: MiniBatchKMeans(batch_size=64, **kw)):
        make().fit(X)                      # the caches hold its functions
        entries = len(kmeans_mod._STEP_CACHE)
        gc.collect()
        gc.disable()
        try:
            before = live()
            model = make()
            ds = model.cache(X)
            model.fit(ds)
            assert live() == before + 1
            assert len(kmeans_mod._STEP_CACHE) == entries   # all hits
            gone = weakref.ref(ds)
            del ds, model
            assert gone() is None and live() == before
        finally:
            gc.enable()
