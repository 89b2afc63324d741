"""The port's memory planner (``kmeans_tpu_torch.obs.memory``).

``plan_ingest`` is the JAX package's arithmetic: equal to its
``obs.memory.plan_ingest``, key for key, on a grid of shapes (on the CPU
neither device reports free bytes).  ``plan_fit`` models the port's own
allocations (the module's docstring says which terms differ from the
reference's), so it is held term by term here, and against
``torch.cuda.max_memory_allocated`` by ``chip_smoke.py`` (phase
``large_k``).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu.obs import memory as jmem  # noqa: E402
from kmeans_tpu_torch.obs import memory  # noqa: E402
from kmeans_tpu_torch.parallel.sharding import bucket_candidates  # noqa


@pytest.mark.parametrize("n", [1, 7, 1000, 2_097_152, 10**9])
@pytest.mark.parametrize("d", [1, 16, 128])
@pytest.mark.parametrize("data_shards,chunk", [(1, 1), (2, 8), (4, 2048),
                                               (256, 65536)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plan_ingest_equals_the_references(n, d, data_shards, chunk, dtype):
    ours = memory.plan_ingest(n, d, data_shards=data_shards, chunk=chunk,
                              dtype=dtype)
    theirs = jmem.plan_ingest(n, d, data_shards=data_shards, chunk=chunk,
                              dtype=dtype)
    assert ours == theirs


def test_device_memory_info_counts_the_idle_cache_free(monkeypatch):
    """Bytes the caching allocator holds without a tensor in them are
    free: a new allocation reuses them (the reference counts live buffers
    only as in use)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (30 << 20, 100 << 20))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: 50 << 20)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 20 << 20)
    assert memory.device_memory_info() == {
        "available": True, "bytes_limit": 100 << 20,
        "bytes_in_use": 40 << 20, "bytes_free": 60 << 20}


def test_slab_target_is_the_references():
    assert memory.INGEST_SLAB_TARGET_BYTES == \
        jmem.INGEST_SLAB_TARGET_BYTES == 64 << 20


def test_device_memory_info_on_the_cpu():
    info = memory.device_memory_info("cpu")
    assert info == {"available": False, "bytes_limit": None,
                    "bytes_in_use": None, "bytes_free": None}
    assert jmem.device_memory_info()["available"] is False
    if not torch.cuda.is_available():
        assert memory.device_memory_info()["available"] is False


def _plan(**kw):
    base = dict(n=10_000, d=16, k=300)
    base.update(kw)
    n, d, k = base.pop("n"), base.pop("d"), base.pop("k")
    return memory.plan_fit("kmeans", n, d, k, **base)


def test_plan_fit_keeps_the_references_keys():
    ours = _plan(chunk=1024)
    theirs = jmem.plan_fit("kmeans", 10_000, 16, 300, chunk=1024)
    assert set(theirs) <= set(ours)
    assert ours["predicted_peak_bytes"] == \
        ours["predicted_resident_bytes"] + ours["predicted_temp_bytes"]


def test_plan_fit_torch_mode_terms():
    p = _plan(chunk=1024)
    c = p["components"]
    assert c == {"points_bytes": 10_000 * 16 * 4,
                 "weights_bytes": 10_000 * 4,
                 "table_bytes": 300 * 16 * 4,
                 "tile_bytes": 4 * 1024 * 300 * 4,
                 "stats_bytes": (300 * 16 + 2 * 300) * 4}
    assert p["predicted_resident_bytes"] == sum(
        c[key] for key in ("points_bytes", "weights_bytes", "table_bytes"))
    f64 = _plan(chunk=1024, dtype="float64")["components"]
    assert f64["points_bytes"] == 2 * c["points_bytes"]
    assert f64["tile_bytes"] == 2 * c["tile_bytes"]
    assert _plan(chunk=1024, pipeline=1)["components"]["tile_bytes"] == \
        2 * c["tile_bytes"]
    # No chunk: one tile of every row.
    assert _plan()["components"]["tile_bytes"] == 4 * 10_000 * 300 * 4


def test_plan_fit_kernel_terms():
    c = _plan(mode="kernel")["components"]
    blocks = min(2 * 132, -(-10_000 // 128))
    assert c["tile_bytes"] == blocks * 300 * 17 * 4 + 10_000 * 8 + 300 * 4
    # The per-block tables keep to their 2 GiB budget.
    big = memory.plan_fit("kmeans", 2_097_152, 128, 16_384, mode="kernel")
    tables = (2 << 30) // (4 * 16_384 * 129)
    assert big["components"]["tile_bytes"] == \
        tables * 16_384 * 129 * 4 + 2_097_152 * 8 + 16_384 * 4
    # Under a model axis the assignment kernel forms no table.
    tp = _plan(mode="kernel", model_shards=2, data_shards=1, chunk=1024)
    assert tp["components"]["tile_bytes"] == \
        10_000 * 8 + 150 * 4 + 1024 * 150 * 4


def test_plan_fit_k_shard_keeps_one_block_of_statistics():
    dense = _plan(model_shards=2, chunk=1024)["components"]
    sharded = _plan(model_shards=2, chunk=1024, k_shard=2)["components"]
    assert dense["stats_bytes"] == (300 * 16 + 2 * 300) * 4
    assert sharded["stats_bytes"] == (150 * 16 + 2 * 150) * 4
    assert sharded["tile_bytes"] == dense["tile_bytes"] == 4 * 1024 * 150 * 4
    assert sharded["table_bytes"] == 300 * 16 * 4
    # k_shard is a no-op without a model axis, as in the reference.
    assert _plan(k_shard=2, chunk=1024)["components"]["stats_bytes"] == \
        dense["stats_bytes"]


def test_plan_fit_two_level_terms():
    p = _plan(assign="two_level", coarse_cells=17, nprobe=3, chunk=512)
    c = p["components"]
    L = bucket_candidates(-(-300 // 17))
    assert c["coarse_bytes"] == 17 * 16 * 4
    assert c["member_bytes"] == 17 * L * (16 * 4 + 8)
    assert c["tile_bytes"] == 4 * 512 * max(17, L) * 4 \
        + 512 * (16 * 4 + 3 * 16)
    assert c["row_best_bytes"] == 10_000 * (4 + 8)
    # Defaults: about sqrt(k) cells, an eighth of them probed, and no
    # (chunk, k) tile at any k.
    d = _plan(assign="two_level", member_width=64, chunk=512)["components"]
    assert d["coarse_bytes"] == 17 * 16 * 4 and \
        d["member_bytes"] == 17 * 64 * 72
    assert d["tile_bytes"] == 4 * 512 * 64 * 4 + 512 * (64 + 3 * 16)
    # A hub cell's rows come in slices of TWO_LEVEL_TILE_ELEMS // L.
    hub = memory.plan_fit("kmeans", 2_097_152, 128, 16_384,
                          assign="two_level", coarse_cells=128, nprobe=16,
                          member_width=768, chunk=131_072)["components"]
    assert hub["tile_bytes"] == 4 * ((1 << 25) // 768) * 768 * 4 \
        + 131_072 * (128 * 4 + 16 * 16)
    big = memory.plan_fit("kmeans", 2_097_152, 128, 16_384,
                          assign="two_level", coarse_cells=128, nprobe=16,
                          chunk=65_536)
    dense = memory.plan_fit("kmeans", 2_097_152, 128, 16_384, chunk=2048)
    assert big["predicted_temp_bytes"] < dense["predicted_temp_bytes"]


@pytest.mark.parametrize("family", ["spherical", "bisecting", "minibatch",
                                    "gmm"])
def test_plan_fit_other_families_name_their_item(family):
    """Every family plans now: the JAX package's dict, but for the port's
    documented tile and statistics terms of the K-Means families (four
    (chunk, k) tiles in the accumulation type, ``2 k`` statistics beside
    the sums), and the port's ``mode`` and ``assign`` keys.  An unknown
    family still raises."""
    batch = 1024 if family == "minibatch" else None
    got = memory.plan_fit(family, 8192, 64, 32, chunk=2048, batch=batch)
    ref = jmem.plan_fit(family, 8192, 64, 32, chunk=2048, batch=batch)
    port_terms = set() if family == "gmm" else {"tile_bytes",
                                                "stats_bytes"}
    assert set(got["components"]) == set(ref["components"])
    for key, value in ref["components"].items():
        if key not in port_terms:
            assert got["components"][key] == value, key
    sums = {"predicted_temp_bytes", "predicted_peak_bytes"} \
        if port_terms else set()
    for key, value in ref.items():
        if key != "components" and key not in sums:
            assert got[key] == value, key
    if port_terms:
        rows = min(2048, batch or 8192)
        assert got["components"]["tile_bytes"] == 4 * rows * 32 * 4
        assert got["components"]["stats_bytes"] == (32 * 64 + 2 * 32) * 4
    assert got["mode"] == ("torch" if family == "gmm" else "matmul")
    with pytest.raises(ValueError, match="unknown family"):
        memory.plan_fit("nope", 100, 4, 3)
    assert family in memory.FAMILIES == jmem.FAMILIES


def test_plan_fit_dtype_names():
    assert _plan(dtype=np.dtype(np.float64))["components"][
        "points_bytes"] == 10_000 * 16 * 8
    assert _plan(dtype="float64")["dtype"] == "float64"


@pytest.mark.parametrize("cov_type", ["diag", "spherical", "tied", "full"])
def test_plan_fit_gmm_equals_the_reference(cov_type):
    """The mixture in the torch E pass plans exactly as the reference;
    the kernel mode (``diag_estep``) forms no (chunk, k) tile but its
    blocks' tables and the split coefficients."""
    got = memory.plan_fit("gmm", 10_000, 16, 8, chunk=2500,
                          cov_type=cov_type, data_shards=2)
    want = jmem.plan_fit("gmm", 10_000, 16, 8, chunk=2500,
                         cov_type=cov_type, data_shards=2)
    assert {k: v for k, v in got.items() if k not in ("mode", "assign")} \
        == want
    kern = memory.plan_fit("gmm", 1_000_000, 16, 8, cov_type=cov_type,
                           mode="kernel", device="cpu")
    table = 8 * (2 * 16 + 2)
    blocks = min(2 * 132, -(-1_000_000 // 128))
    assert kern["components"]["tile_bytes"] == \
        blocks * (table * 4 + 8) + 4 * 8 * 16 * 4
    with pytest.raises(ValueError, match="covariance"):
        memory.plan_fit("gmm", 10, 2, 2, cov_type="bogus")


def test_plan_observed_join_and_table_text():
    from kmeans_tpu_torch.obs.cost import CostRecord
    recs = [CostRecord(cache="make_step_fn", key="k", available=True,
                       flops=1.0, peak_bytes=12345),
            CostRecord(cache="make_gmm_step_fn", key="k", available=True,
                       flops=1.0, peak_bytes=99999),
            CostRecord(cache="make_fit_fn", key="k", available=False,
                       flops=1.0, peak_bytes=None)]
    for fam, want in (("kmeans", 12345), ("spherical", 12345),
                      ("bisecting", 12345), ("gmm", 99999),
                      ("minibatch", None)):
        plan = memory.plan_fit(fam, 100, 4, 2, batch=10, records=recs)
        assert plan["observed_peak_bytes"] == want, fam
    assert memory.plan_fit("kmeans", 100, 4, 2)["observed_peak_bytes"] \
        is None
    plans = [memory.plan_fit(f, 8192, 64, 32, chunk=2048, batch=1024)
             for f in ("gmm",)] + [
        memory.plan_fit("gmm", 5000, 8, 4, cov_type="full")]
    jplans = [jmem.plan_fit(f, 8192, 64, 32, chunk=2048, batch=1024)
              for f in ("gmm",)] + [
        jmem.plan_fit("gmm", 5000, 8, 4, cov_type="full")]
    assert memory.format_plan_table(plans, device="cpu") == \
        jmem.format_plan_table(jplans)
    plans[0]["observed_peak_bytes"] = 3 << 30
    jplans[0]["observed_peak_bytes"] = 3 << 30
    assert memory.format_plan_table(plans, title="t", device="cpu") == \
        jmem.format_plan_table(jplans, title="t")
    assert memory._fmt_bytes(None) == jmem._fmt_bytes(None) == "-"
    for b in (0, 1023, 1 << 20, 5 << 40, 7 << 50):
        assert memory._fmt_bytes(b) == jmem._fmt_bytes(b)
