"""The lifecycle spans, events and counters of the port's fit, stream,
checkpoint, ingest and fault paths, against the JAX package's
(``tests/test_obs.py:425-625``).

* Telemetry never changes a fit: every family, the device loop and the
  stream give the same bits with tracing, heartbeats and cost capture on
  as with them off.
* A traced fit emits the reference's span names (the port's ``compile``
  spans are the kernel libraries' loads and the graph captures of the
  card, which the CPU does not make); a segmented device fit one
  ``segment`` per segment with its dispatch attempts nested, an
  out-of-memory replay one more attempt inside the same segment; a resume
  a ``checkpoint.restore``; a stream one ``io.block`` per block read and
  one ``stage(via='prefetch')`` and one ``stream/block`` dispatch per
  block.
* The ``io.retries``, ``io.blocks_skipped``, ``ingest.bytes`` and
  ``ingest.slabs`` counters equal the JAX package's under the same
  injected faults and placements; ``advise_dispatch`` and the fleet
  barrier give the reference's records.
"""

import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu_torch import (BisectingKMeans, GaussianMixture,  # noqa: E402
                              KMeans, MiniBatchKMeans, SphericalKMeans, obs)
from kmeans_tpu_torch.data.io import iter_npy_blocks  # noqa: E402
from kmeans_tpu_torch.obs import cost  # noqa: E402
from kmeans_tpu_torch.obs import memory as obs_memory  # noqa: E402
from kmeans_tpu_torch.obs import metrics_registry as mr  # noqa: E402
from kmeans_tpu_torch.utils import faults  # noqa: E402

CPU = dict(device="cpu", verbose=False, dtype=np.float64)


def _blobs(n=600, d=5, k=4, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-5.0, 5.0, size=(k, d))
    return means[rng.integers(0, k, size=n)] + rng.standard_normal((n, d))


def spans_named(recs, name, **attrs):
    return [r for r in recs if r.get("kind") == "span" and r["name"] == name
            and all((r.get("attrs") or {}).get(a) == v
                    for a, v in attrs.items())]


FAMILIES = {
    "kmeans": lambda: KMeans(k=5, max_iter=8, tolerance=1e-12, seed=0,
                             compute_sse=True, **CPU),
    "minibatch": lambda: MiniBatchKMeans(k=5, max_iter=8, batch_size=128,
                                         seed=0, **CPU),
    "bisecting": lambda: BisectingKMeans(k=4, max_iter=6, seed=0,
                                         compute_sse=True, **CPU),
    "spherical": lambda: SphericalKMeans(k=4, max_iter=8, seed=0, **CPU),
    "gmm": lambda: GaussianMixture(n_components=4, max_iter=6,
                                   init_params="random", seed=0, **CPU),
}


def _same(a, b) -> bool:
    if hasattr(a, "means_"):
        return (a.n_iter_ == b.n_iter_ and a.lower_bound_ == b.lower_bound_
                and np.array_equal(a.means_, b.means_)
                and np.array_equal(a.covariances_, b.covariances_))
    return (a.iterations_run == b.iterations_run
            and np.array_equal(a.centroids, b.centroids)
            and list(a.sse_history) == list(b.sse_history))


def _telemetry(tmp_path, tag):
    """Every telemetry scope at once: a tracer and a heartbeat writing
    JSONL files, and a cost collector."""
    import contextlib
    stack = contextlib.ExitStack()
    stack.enter_context(obs.tracing(str(tmp_path / f"{tag}.jsonl")))
    stack.enter_context(obs.heartbeat(str(tmp_path / f"{tag}.hb.jsonl")))
    stack.enter_context(cost.collecting())
    return stack


# ------------------------------------------------------------ obs-off parity


@pytest.mark.parametrize("family", list(FAMILIES))
def test_obs_off_parity(family, tmp_path):
    X = _blobs()
    plain = FAMILIES[family]().fit(X)
    with _telemetry(tmp_path, family):
        traced = FAMILIES[family]().fit(X)
    assert _same(plain, traced)
    if hasattr(plain, "labels_") and family != "gmm":
        assert np.array_equal(plain.labels_, traced.labels_)
    assert (tmp_path / f"{family}.jsonl").stat().st_size > 0


def test_obs_off_parity_device_loop_and_stream(tmp_path):
    X = _blobs()

    def dev():
        return KMeans(k=5, max_iter=8, tolerance=1e-12, seed=0,
                      compute_sse=True, host_loop=False,
                      empty_cluster="keep", **CPU)
    plain = dev().fit(X)
    with _telemetry(tmp_path, "dev"):
        traced = dev().fit(X)
    assert _same(plain, traced)

    def blocks():
        for i in range(0, X.shape[0], 256):
            yield X[i: i + 256]

    def stream():
        return KMeans(k=5, max_iter=4, tolerance=1e-12, seed=0,
                      compute_sse=True, **CPU).fit_stream(
            lambda: blocks(), prefetch=2)
    plain = stream()
    with _telemetry(tmp_path, "stream"):
        traced = stream()
    assert _same(plain, traced)


# ------------------------------------------------------------ span structure


def test_traced_fit_span_names_are_the_references():
    from kmeans_tpu import KMeans as JKMeans
    from kmeans_tpu import obs as jobs
    X = _blobs().astype(np.float32)
    with obs.tracing() as tr:
        KMeans(k=5, max_iter=5, seed=0, chunk_size=117, device="cpu",
               verbose=False).fit(X)
    with jobs.tracing() as jtr:
        JKMeans(k=5, max_iter=5, seed=0, chunk_size=117,
                verbose=False).fit(X)
    names = {r["name"] for r in tr.records() if r.get("kind") == "span"}
    jnames = {r["name"] for r in jtr.records() if r.get("kind") == "span"}
    assert names - {"compile"} == jnames - {"compile"}
    for name in ("place", "stage", "seed", "dispatch", "trace"):
        assert spans_named(tr.records(), name), name
    traces = spans_named(tr.records(), "trace")
    assert all(t["attrs"]["builder"].startswith("make_") for t in traces)
    steps = spans_named(tr.records(), "dispatch", tag="lloyd/step")
    jsteps = spans_named(jtr.records(), "dispatch", tag="lloyd/step")
    assert len(steps) == len(jsteps) > 0
    assert [s["attrs"]["iteration"] for s in steps] == \
        [s["attrs"]["iteration"] for s in jsteps]


def _dev_kw(**extra):
    kw = dict(k=5, max_iter=6, tolerance=1e-12, seed=0, host_loop=False,
              empty_cluster="keep", **CPU)
    kw.update(extra)
    return kw


def test_segmented_fit_span_counts(tmp_path):
    from kmeans_tpu import KMeans as JKMeans
    from kmeans_tpu import obs as jobs
    X = _blobs()
    plain = KMeans(**_dev_kw()).fit(X)
    with obs.tracing() as tr:
        km = KMeans(**_dev_kw())
        km.fit(X, checkpoint_every=2, checkpoint_path=str(tmp_path / "s"))
    recs = tr.records()
    segs = spans_named(recs, "segment")
    assert _same(plain, km)
    assert len(segs) == km.checkpoint_segments_ == 3
    assert len(spans_named(recs, "checkpoint.save")) == len(segs)
    attempts = spans_named(recs, "dispatch", tag="fit/segment")
    assert len(attempts) == len(segs)
    assert {a["parent"] for a in attempts} == {s["id"] for s in segs}
    assert sum(r.get("name") == "mem.plan" for r in recs) == len(segs)
    # The JAX package's segmented fit of the same data: the same counts.
    jkw = {k: v for k, v in _dev_kw().items() if k != "device"}
    with jobs.tracing() as jtr:
        jkm = JKMeans(**jkw)
        jkm.fit(X, checkpoint_every=2, checkpoint_path=str(tmp_path / "j"))
    jrecs = jtr.records()
    assert len(spans_named(jrecs, "segment")) == len(segs)
    assert len(spans_named(jrecs, "checkpoint.save")) == len(segs)
    assert len(spans_named(jrecs, "dispatch", tag="fit/segment")) == \
        len(attempts)


def test_oom_replay_attempts_nest_in_one_segment(tmp_path):
    X = _blobs()
    # The kernel mode takes every row in one launch whatever the chunk, so
    # the replay at the halved chunk gives the clean fit's bits (ROADMAP,
    # "The chunk of an out-of-memory backoff").
    kw = _dev_kw(chunk_size=256, distance_mode="pallas", dtype=np.float32)
    clean = KMeans(**kw).fit(X)
    mr.REGISTRY.reset()
    with obs.tracing() as tr, faults.inject_oom_on_segment(1) as rec, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        km = KMeans(**kw)
        km.fit(X, checkpoint_every=2, checkpoint_path=str(tmp_path / "o"))
    assert rec["fired"] == 1 and km.oom_backoffs_ == 1
    assert _same(clean, km)
    recs = tr.records()
    segs = spans_named(recs, "segment")
    assert len(segs) == km.checkpoint_segments_
    attempts = spans_named(recs, "dispatch", tag="fit/segment")
    assert len(attempts) == len(segs) + 1
    replayed = [a for a in attempts if a["attrs"]["attempt"] == 1]
    assert len(replayed) == 1
    assert replayed[0]["parent"] in {s["id"] for s in segs}
    assert replayed[0]["attrs"]["chunk"] == 128
    assert replayed[0].get("error") is None
    failed = [a for a in attempts if a.get("error")]
    assert len(failed) == 1 and failed[0]["parent"] == replayed[0]["parent"]
    assert mr.REGISTRY.snapshot()["fit.oom_backoffs"]["value"] == 1


def test_resume_emits_restore_span(tmp_path):
    X = _blobs()
    p = str(tmp_path / "res.npz")
    plain = KMeans(**_dev_kw()).fit(X)
    with faults.inject_kill_after_iteration(2):
        try:
            KMeans(**_dev_kw()).fit(X, checkpoint_every=2,
                                    checkpoint_path=p)
        except faults.SimulatedPreemption:
            pass
    with obs.tracing() as tr:
        km = KMeans(**_dev_kw())
        km.fit(X, resume=p, checkpoint_every=2, checkpoint_path=p)
    recs = tr.records()
    restores = spans_named(recs, "checkpoint.restore")
    assert restores and restores[0]["attrs"]["path"].endswith("res.npz")
    assert len(spans_named(recs, "segment")) == km.checkpoint_segments_
    assert _same(plain, km)


def test_host_loop_checkpoints_and_seed_spans(tmp_path):
    X = _blobs()
    with obs.tracing() as tr:
        km = KMeans(k=5, max_iter=5, tolerance=1e-12, seed=0,
                    init="k-means++", **CPU)
        km.fit(X, checkpoint_every=2, checkpoint_path=str(tmp_path / "h"))
    recs = tr.records()
    assert len(spans_named(recs, "checkpoint.save")) == \
        km.checkpoint_segments_
    seeds = spans_named(recs, "seed")
    assert len(seeds) == 1 and seeds[0]["attrs"] == {"strategy":
                                                     "k-means++", "k": 5}
    with obs.tracing() as tr:
        gm = GaussianMixture(n_components=3, max_iter=3, seed=0,
                             **CPU).fit(X)
    seeds = spans_named(tr.records(), "seed")
    outer = [s for s in seeds if s["attrs"]["strategy"] == "kmeans"]
    assert len(outer) == 1 and outer[0]["attrs"]["k"] == 3
    # The inner KMeans' seed nests in the mixture's.
    assert any(s["parent"] == outer[0]["id"] for s in seeds)
    assert len(spans_named(tr.records(), "dispatch", tag="em/step")) == \
        gm.n_iter_


def test_stream_io_and_stage_spans(tmp_path):
    X = _blobs(n=400)
    path = tmp_path / "x.npy"
    np.save(path, X)
    blocks, epochs = 4, 2
    with obs.tracing() as tr:
        km = KMeans(k=4, max_iter=epochs, tolerance=1e-30, seed=0,
                    init=X[:4].copy(), **CPU).fit_stream(
            iter_npy_blocks(path, 100), d=5, prefetch=2)
    recs = tr.records()
    reads = [r for r in spans_named(recs, "io.block")
             if "offset" in r.get("attrs", {})]
    assert len(reads) == blocks * epochs
    assert sorted({r["attrs"]["offset"] for r in reads}) == [0, 100, 200,
                                                             300]
    assert len(spans_named(recs, "stage", via="prefetch")) == \
        blocks * epochs
    assert len(spans_named(recs, "dispatch", tag="stream/block")) == \
        blocks * epochs
    # The resilient pass: one span per read, the end of each pass too.
    assert len([r for r in spans_named(recs, "io.block")
                if "index" in r.get("attrs", {})]) == (blocks + 1) * epochs
    assert sum(r.get("name") == "fleet.barrier" for r in recs) == 1
    with obs.tracing() as tr:
        labels = np.concatenate(list(km.predict_stream(
            iter_npy_blocks(path, 100), prefetch=2)))
    assert np.array_equal(labels, km.predict(X))
    assert len([r for r in spans_named(tr.records(), "io.block")
                if "offset" in r.get("attrs", {})]) == blocks


# ----------------------------------------------------------------- counters


def _io_counters(registry):
    snap = registry.snapshot()
    return {name: snap.get(name, {}).get("value", 0)
            for name in ("io.retries", "io.blocks_skipped")}


def test_io_counters_equal_the_references():
    """The same stream, one flaky read and one NaN block, through both
    packages' ``fit_stream``: the same retries and skipped blocks in the
    registries."""
    from kmeans_tpu import KMeans as JKMeans
    from kmeans_tpu.obs import metrics_registry as jmr
    from kmeans_tpu.utils import faults as jfaults
    X = _blobs(n=400)

    def make(fmod):
        def blocks():
            for i in range(0, 400, 100):
                yield X[i: i + 100]
        return fmod.flaky_blocks(fmod.poison_blocks(blocks, block=1),
                                 fail_block=2, fail_times=2)
    kw = dict(k=4, max_iter=2, tolerance=1e-30, seed=0, init=X[:4].copy(),
              verbose=False)
    stream_kw = dict(io_retries=3, io_backoff=0.0, on_nonfinite="skip",
                     prefetch=0)
    mr.REGISTRY.reset()
    km = KMeans(device="cpu", dtype=np.float64, **kw).fit_stream(
        make(faults), **stream_kw)
    jmr.REGISTRY.reset()
    jkm = JKMeans(dtype=np.float64, **kw).fit_stream(make(jfaults),
                                                    **stream_kw)
    got, want = _io_counters(mr.REGISTRY), _io_counters(jmr.REGISTRY)
    assert got == want and got["io.retries"] == 2
    assert got["io.blocks_skipped"] > 0
    assert km.blocks_skipped_ == jkm.blocks_skipped_
    assert km.io_retries_used_ == jkm.io_retries_used_


def test_ingest_counters_equal_the_references():
    from kmeans_tpu import KMeans as JKMeans
    from kmeans_tpu.obs import metrics_registry as jmr
    X = _blobs(n=500).astype(np.float32)
    mr.REGISTRY.reset()
    with obs.tracing() as tr:
        KMeans(k=4, max_iter=2, seed=0, device="cpu",
               verbose=False).fit(X)
    jmr.REGISTRY.reset()
    JKMeans(k=4, max_iter=2, seed=0, verbose=False).fit(X)
    snap, jsnap = mr.REGISTRY.snapshot(), jmr.REGISTRY.snapshot()
    for name in ("ingest.bytes", "ingest.slabs"):
        assert snap[name]["value"] == jsnap[name]["value"], name
    assert snap["ingest.bytes"]["value"] == X.nbytes
    stage = spans_named(tr.records(), "stage")
    assert stage[0]["attrs"] == {"rows": 500, "bytes": X.nbytes,
                                 "ingest": "mono"}
    place = spans_named(tr.records(), "place")
    assert len(place) == 1 and stage[0]["parent"] == place[0]["id"]


def test_synthetic_and_weights_stage_spans():
    from kmeans_tpu_torch.data.synthetic import device_shards
    mr.REGISTRY.reset()
    with obs.tracing() as tr:
        ds = device_shards(300, 4, seed=1, device="cpu")
        ds.with_weights(np.ones(300))
    stages = spans_named(tr.records(), "stage")
    assert stages[0]["attrs"] == {"rows": 300, "bytes": 0,
                                  "ingest": "synthetic"}
    assert stages[1]["attrs"]["rows"] == 300
    snap = mr.REGISTRY.snapshot()
    assert snap["ingest.slabs"]["value"] == 1
    assert snap["ingest.bytes"]["value"] == 300 * 4


def test_advise_dispatch_is_the_references():
    from kmeans_tpu.obs import memory as jmem
    from kmeans_tpu.obs import trace as jtrace
    X = _blobs()
    km = KMeans(k=4, max_iter=2, seed=0, **CPU).fit(X)
    assert obs_memory.advise_dispatch(km, 192) is None     # tracing off
    mr.REGISTRY.reset()
    with obs.tracing() as tr:
        adv = obs_memory.advise_dispatch(km, 192, segment=3)
    with jtrace.tracing():
        jadv = jmem.advise_dispatch(km, 192, segment=3)
    assert adv == jadv
    assert adv["predicted_tile_bytes"] == 192 * 4 * 4
    assert mr.REGISTRY.snapshot()["fit.mem_planned_chunk"]["value"] == 192
    plans = [r for r in tr.records() if r.get("name") == "mem.plan"]
    assert len(plans) == 1 and plans[0]["attrs"]["segment"] == 3


def test_fleet_barrier_event_is_the_references():
    from kmeans_tpu import KMeans as JKMeans
    from kmeans_tpu import obs as jobs

    from kmeans_tpu_torch.parallel.multihost import fleet_barrier
    fleet_barrier("fit-start")                     # no tracer: nothing
    X = _blobs().astype(np.float32)
    with obs.tracing() as tr:
        KMeans(k=4, max_iter=2, seed=0, device="cpu", verbose=False).fit(X)
    with jobs.tracing() as jtr:
        JKMeans(k=4, max_iter=2, seed=0, verbose=False).fit(X)
    got = [r["attrs"] for r in tr.records()
           if r.get("name") == "fleet.barrier"]
    want = [r["attrs"] for r in jtr.records()
            if r.get("name") == "fleet.barrier"]
    assert got == want == [{"tag": "fit-start", "synced": False}]
