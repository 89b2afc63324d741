"""The port stands alone: it imports neither jax nor kmeans_tpu, runs on the
card unless the CPU is asked for, and on the CPU its kernel wrappers take
the plain versions without counting a launch."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import kmeans_tpu_torch  # noqa: E402
from kmeans_tpu_torch.ops import _build  # noqa: E402
from kmeans_tpu_torch.ops import hopper_kernels as hk  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "kmeans_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]

MODULES = ["kmeans_tpu_torch", "kmeans_tpu_torch.convert",
           "kmeans_tpu_torch.data.io", "kmeans_tpu_torch.data.prefetch",
           "kmeans_tpu_torch.data.synthetic",
           "kmeans_tpu_torch.experiments",
           "kmeans_tpu_torch.experiments.exp_kernel_edits",
           "kmeans_tpu_torch.experiments.exp_pallas_kernel",
           "kmeans_tpu_torch.experiments.exp_profiler_loss",
           "kmeans_tpu_torch.experiments.exp_stream_host",
           "kmeans_tpu_torch.metrics",
           "kmeans_tpu_torch.models.bisecting",
           "kmeans_tpu_torch.models.fault_tolerance",
           "kmeans_tpu_torch.models.gmm",
           "kmeans_tpu_torch.models.init", "kmeans_tpu_torch.models.kmeans",
           "kmeans_tpu_torch.models.minibatch",
           "kmeans_tpu_torch.models.pq",
           "kmeans_tpu_torch.models.spherical",
           "kmeans_tpu_torch.obs", "kmeans_tpu_torch.obs.cost",
           "kmeans_tpu_torch.obs.drift",
           "kmeans_tpu_torch.obs.fleet", "kmeans_tpu_torch.obs.heartbeat",
           "kmeans_tpu_torch.obs.identity", "kmeans_tpu_torch.obs.memory",
           "kmeans_tpu_torch.obs.metrics_registry",
           "kmeans_tpu_torch.obs.report", "kmeans_tpu_torch.obs.trace",
           "kmeans_tpu_torch.ops._build", "kmeans_tpu_torch.ops.assign",
           "kmeans_tpu_torch.ops.compare",
           "kmeans_tpu_torch.ops.estep_kernels",
           "kmeans_tpu_torch.ops.hopper_kernels",
           "kmeans_tpu_torch.parallel.distributed",
           "kmeans_tpu_torch.parallel.gmm_step",
           "kmeans_tpu_torch.parallel.mesh",
           "kmeans_tpu_torch.parallel.multihost",
           "kmeans_tpu_torch.parallel.sharding",
           "kmeans_tpu_torch.serving", "kmeans_tpu_torch.serving.batching",
           "kmeans_tpu_torch.serving.engine",
           "kmeans_tpu_torch.serving.fleet",
           "kmeans_tpu_torch.serving.learn",
           "kmeans_tpu_torch.serving.registry",
           "kmeans_tpu_torch.suite", "kmeans_tpu_torch.sweep",
           "kmeans_tpu_torch.utils.aot", "kmeans_tpu_torch.utils.cache",
           "kmeans_tpu_torch.utils.checkpoint",
           "kmeans_tpu_torch.utils.debug",
           "kmeans_tpu_torch.utils.faults",
           "kmeans_tpu_torch.utils.logging",
           "kmeans_tpu_torch.utils.plotting",
           "kmeans_tpu_torch.utils.profiling",
           "kmeans_tpu_torch.utils.validation"]


def test_fresh_interpreter_loads_neither_jax_nor_kmeans_tpu():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = out.split()
    assert "kmeans_tpu_torch.models.kmeans" in loaded and "torch" in loaded
    assert "kmeans_tpu_torch.ops.estep_kernels" in loaded
    assert "kmeans_tpu_torch.parallel.mesh" in loaded
    assert "kmeans_tpu_torch.suite" in loaded
    assert not any(m == "matplotlib" or m.startswith("matplotlib.")
                   or m == "sklearn" or m.startswith("sklearn.")
                   for m in loaded)
    bad = [m for m in loaded
           if m == "jax" or m.startswith(("jax.", "jaxlib"))
           or m == "kmeans_tpu" or m.startswith("kmeans_tpu.")]
    assert bad == []


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_sources_name_no_jax_import(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert not re.search(r"^\s*(import|from)\s+kmeans_tpu(\s|\.|$)", text,
                         re.M)
    # 'kmeans_tpu.' in running text names the reference; in code it would be
    # an attribute of the JAX package.
    code = re.sub(r'""".*?"""', "", text, flags=re.S)
    code = re.sub(r"#.*", "", code)
    code = re.sub(r'"[^"\n]*"|\'[^\'\n]*\'', '""', code)
    assert "kmeans_tpu." not in code.replace("kmeans_tpu_torch", "")


def test_every_module_is_listed():
    found = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (ROOT / "kmeans_tpu_torch").rglob("*.py"))
    assert set(MODULES) <= set(found)
    extra = [m for m in found if m not in MODULES
             and not (ROOT / Path(*m.split(".")) / "__init__.py").is_file()]
    assert extra == []


def test_exports():
    assert kmeans_tpu_torch.__all__ == ["GaussianMixture", "KMeans",
                                        "MiniBatchKMeans", "BisectingKMeans",
                                        "SphericalKMeans", "ProductQuantizer",
                                        "DispatchLatencyHint",
                                        "NumericalDivergenceError",
                                        "ShardedDataset", "SweepResult",
                                        "make_mesh", "__version__"]
    for name in kmeans_tpu_torch.__all__:
        assert hasattr(kmeans_tpu_torch, name), name
    assert kmeans_tpu_torch.make_mesh.__module__ == \
        "kmeans_tpu_torch.parallel.mesh"
    assert kmeans_tpu_torch.ShardedDataset.__module__ == \
        "kmeans_tpu_torch.parallel.sharding"
    assert kmeans_tpu_torch.SweepResult.__module__ == "kmeans_tpu_torch.sweep"
    assert issubclass(kmeans_tpu_torch.NumericalDivergenceError, ValueError)
    assert issubclass(kmeans_tpu_torch.DispatchLatencyHint, UserWarning)
    assert "ProductQuantizer" in kmeans_tpu_torch.__all__
    assert kmeans_tpu_torch.ProductQuantizer.__module__ == \
        "kmeans_tpu_torch.models.pq"
    assert isinstance(kmeans_tpu_torch.__version__, str)
    assert kmeans_tpu_torch.KMeans.__module__ == \
        "kmeans_tpu_torch.models.kmeans"
    assert kmeans_tpu_torch.GaussianMixture.__module__ == \
        "kmeans_tpu_torch.models.gmm"
    for name in ("MiniBatchKMeans", "BisectingKMeans", "SphericalKMeans"):
        cls = getattr(kmeans_tpu_torch, name)
        assert cls.__module__ == ("kmeans_tpu_torch.models."
                                  + name.removesuffix("KMeans").lower())
        assert issubclass(cls, kmeans_tpu_torch.KMeans)


def test_serving_exports_what_is_ported():
    """``kmeans_tpu_torch.serving`` exports the JAX package's names: the
    engine, queue and registry, the fleet and serve-and-learn (ROADMAP
    A.12); ``obs`` has the heartbeat, the fleet module, and since the rest
    of A.13 the cost records and the reports, the port's own modules with
    the JAX package's names."""
    import kmeans_tpu.serving
    from kmeans_tpu_torch import obs, serving
    assert serving.__all__ == kmeans_tpu.serving.__all__ == [
        "ServingEngine", "ResidentModel", "MicroBatchQueue",
        "ServingFuture", "ServingClosedError", "ModelRegistry",
        "load_fitted", "ServingFleet", "FleetFuture", "FleetOverloadError",
        "ReplicaDeadError", "ModelLearner", "UpdateRolledBack",
        "publish_tables"]
    for name in serving.__all__:
        assert getattr(serving, name).__module__.startswith(
            "kmeans_tpu_torch.serving.")
    assert obs.drift.__name__ == "kmeans_tpu_torch.obs.drift"
    assert obs.fleet.__name__ == "kmeans_tpu_torch.obs.fleet"
    assert obs.heartbeat.__module__ == "kmeans_tpu_torch.obs.heartbeat"
    assert obs.note_progress.__module__ == "kmeans_tpu_torch.obs.heartbeat"
    import kmeans_tpu.obs
    assert obs.cost.__name__ == "kmeans_tpu_torch.obs.cost"
    assert obs.report.__name__ == "kmeans_tpu_torch.obs.report"
    for name in ("cost", "memory", "fleet", "identity", "drift",
                 "ttfi_ladder", "time_to_first_iteration",
                 "format_phase_table", "merge_cost", "format_cost_table"):
        assert name in obs.__all__ and name in kmeans_tpu.obs.__all__, name
    for name in kmeans_tpu.obs._LAZY_REPORT:
        assert getattr(obs, name) is getattr(obs.report, name), name
    for name in ("FLOPS_AGREEMENT_RTOL", "CostRecord", "collecting",
                 "instrument", "crosscheck", "roofline_fields"):
        assert getattr(obs.cost, name) is not None, name


def test_default_device_is_the_card_and_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kmeans_tpu_torch.KMeans(k=3)
    with pytest.raises(RuntimeError, match="is_available"):
        kmeans_tpu_torch.KMeans(k=3, device="cuda")
    kmeans_tpu_torch.KMeans(k=3, device="cpu").save(tmp_path / "m.npz")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kmeans_tpu_torch.KMeans.load(tmp_path / "m.npz")
    assert kmeans_tpu_torch.KMeans(k=3, device="cpu").device == \
        torch.device("cpu")


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(300, 9)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(11, 9)).astype(np.float32))
    w = torch.ones(300)
    hk.reset_launch_counts()
    got = hk.fused_assign_reduce(x, w, c)
    ref = hk.fused_assign_reduce_reference(x, w, c)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    got2 = hk.hopper_assign(x, c)
    ref2 = hk.assign_reference(x, c)
    assert all(torch.equal(a, b) for a, b in zip(got2, ref2))
    assert hk.fused_assign_reduce(x, w, c, with_mind2=False)[1] is None
    got3 = hk.fused_assign_reduce(x, w, c, bf16=True)
    ref3 = hk.fused_assign_reduce_reference(x, w, c, bf16=True)
    assert all(torch.equal(a, b) for a, b in zip(got3, ref3))
    assert all(torch.equal(a, b) for a, b in zip(
        hk.hopper_assign(x, c, bf16=True),
        hk.assign_reference(x, c, bf16=True)))
    for mode in ("kernel", "kernel_bf16"):
        km = kmeans_tpu_torch.KMeans(k=11, device="cpu", distance_mode=mode,
                                     verbose=False, max_iter=3).fit(x.numpy())
        km.predict(x.numpy())
    gm = kmeans_tpu_torch.GaussianMixture(n_components=4, device="cpu",
                                          max_iter=3).fit(x.numpy())
    gm.predict(x.numpy())
    assert gm.estep_path_ == "serial"
    # One table for every kernel of the package, and no launch on the CPU.
    assert hk.LAUNCHES is _build.LAUNCHES
    assert hk.LAUNCHES == {"fused_assign_reduce": 0, "hopper_assign": 0,
                           "fused_assign_reduce_bf16": 0,
                           "hopper_assign_bf16": 0, "diag_estep": 0}
    hk.LAUNCHES["diag_estep"] = 5
    hk.reset_launch_counts()
    assert set(hk.LAUNCHES.values()) == {0}


def test_kernel_sources_ship_with_the_package():
    assert _build.source_names() == ["assign_bf16", "assign_kernels",
                                     "gmm_estep"]
    src = (_build.CSRC_DIR / "assign_kernels.cu").read_text()
    for name in ("kmeans_assign_launch", "kmeans_fused_assign_reduce_launch",
                 "assign_kernel", "fused_assign_reduce_kernel",
                 "reduce_partials_kernel", "pallas_kernels.py",
                 "kmeans_tile_rows", "kmeans_scratch_bytes", "KM_TILE_K",
                 "KM_PIPE"):
        assert name in src
    bf16 = (_build.CSRC_DIR / "assign_bf16.cu").read_text()
    # The bf16 products are wgmma (both operands from shared memory) fed by
    # bulk-async copies; no mma.sync is left in that source.
    for name in ("kmeans_assign_bf16_launch",
                 "kmeans_fused_assign_reduce_bf16_launch",
                 "assign_bf16_kernel", "fused_assign_reduce_bf16_kernel",
                 "prep_centroids_kernel", "reduce_partials_kernel",
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                 "cp.async.bulk.shared::cluster.global.mbarrier",
                 "pallas_kernels.py:542", "kmeans_tile_rows",
                 "kmeans_scratch_bytes", "kmeans_blocks_per_sm",
                 "kmeans_tile_centroids", "kmeans_prep_centroids_bf16",
                 "KM_TILE_N", "KM_TILE_K", "KM_PIPE"):
        assert name in bf16
    assert "mma.sync" not in bf16
    common = (_build.CSRC_DIR / "assign_common.cuh").read_text()
    assert "reduce_partials_kernel" in common
    gmm = (_build.CSRC_DIR / "gmm_estep.cu").read_text()
    for name in ("gmm_diag_estep_launch", "estep_kernel",
                 "estep_tables_kernel", "estep_reduce_kernel",
                 "exp_gmm_estep_pallas.py"):
        assert name in gmm
    for banned in ("cublas", "cutlass", "torch/extension.h"):
        for text in (src, gmm, bf16, common):
            assert banned not in text.lower()
    lib = _build.library_path("assign_kernels")
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
    assert re.fullmatch(r"libassign_kernels_[0-9a-f]{16}\.so", lib.name)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_a_build_without_nvcc_raises_and_does_not_fall_back(monkeypatch):
    import os
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    roots = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             "/usr/local/cuda"]
    have = [r for r in roots if r and (Path(r) / "bin" / "nvcc").is_file()]
    if have:
        assert _build.find_nvcc() == str(Path(have[0]) / "bin" / "nvcc")
    else:
        with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
            _build.find_nvcc()
        with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
            _build.build()
    with pytest.raises(_build.KernelCompileError, match="no such kernel"):
        _build.load("no_such_source")


def test_a_loaded_library_is_found_without_hashing_the_sources(monkeypatch):
    """A wrapper asks for its library on every call: once loaded, the
    library is looked up without reading or hashing ``csrc`` again."""
    fake = object()
    monkeypatch.setitem(_build._LIBS, ("assign_kernels", ()), fake)
    monkeypatch.setitem(_build._LIBS, ("assign_bf16", (("KM_TILE_K", 64),)),
                        fake)

    def no_hash(*args):
        raise AssertionError("the sources were hashed again")

    monkeypatch.setattr(_build, "_sources_hash", no_hash)
    assert _build.load("assign_kernels") is fake
    assert _build.load_variant("assign_bf16", {"KM_TILE_K": 64}) is fake


#: Constructor arguments under which each family fits the same way in both
#: packages (float64 'matmul', host loops, host draws).
_SAME_FIT = {"KMeans": dict(init="forgy", host_loop=True),
             "MiniBatchKMeans": dict(init="forgy", sampling="host",
                                     batch_size=64),
             "BisectingKMeans": dict(host_loop=True),
             "SphericalKMeans": dict(init="forgy", host_loop=True)}


def _same_profile(got, want):
    """Two quality profiles: the same keys, the same strings and ints, the
    floats (and lists of them) to the float64 parity class."""
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, (float, list)):
            np.testing.assert_allclose(got[key], value, rtol=1e-12,
                                       atol=1e-10, err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("cls", ["KMeans", "MiniBatchKMeans",
                                 "BisectingKMeans", "SphericalKMeans"])
def test_fitted_state_and_quality_profile_name_their_items(cls, mesh1):
    """ROADMAP C.14, then A.12 and A.13: every K-Means family has the JAX
    package's ``fitted_state`` and ``quality_profile``.  Before a fit the
    spec refuses and the profile is None in both packages; fitted on the
    same rows from the same start, the spec equals the JAX package's dict
    for dict and the profiles (from the fit, and from explicit rows) agree
    to the float64 parity class."""
    import kmeans_tpu
    km = getattr(kmeans_tpu_torch, cls)(k=2, device="cpu")
    with pytest.raises(ValueError, match="fitted before serving"):
        km.fitted_state()
    assert km.quality_profile() is None
    rng = np.random.default_rng(4)
    X = rng.normal(size=(300, 3)) + 6.0 * rng.integers(0, 3, size=(300, 1))
    if cls == "SphericalKMeans":
        X += 1.0
    kw = dict(k=3, seed=2, max_iter=10, dtype=np.float64,
              distance_mode="matmul", compute_sse=True, verbose=False,
              **_SAME_FIT[cls])
    jm = getattr(kmeans_tpu, cls)(mesh=mesh1, **kw).fit(X)
    pm = getattr(kmeans_tpu_torch, cls)(device="cpu", **kw).fit(X)
    assert pm.fitted_state() == jm.fitted_state()
    _same_profile(pm.quality_profile(), jm.quality_profile())
    _same_profile(pm.quality_profile(X), jm.quality_profile(X))
