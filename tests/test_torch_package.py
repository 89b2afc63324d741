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
           "kmeans_tpu_torch.data.synthetic",
           "kmeans_tpu_torch.experiments",
           "kmeans_tpu_torch.experiments.exp_pallas_kernel",
           "kmeans_tpu_torch.models.gmm",
           "kmeans_tpu_torch.models.init", "kmeans_tpu_torch.models.kmeans",
           "kmeans_tpu_torch.ops._build", "kmeans_tpu_torch.ops.assign",
           "kmeans_tpu_torch.ops.compare",
           "kmeans_tpu_torch.ops.estep_kernels",
           "kmeans_tpu_torch.ops.hopper_kernels",
           "kmeans_tpu_torch.parallel.distributed",
           "kmeans_tpu_torch.parallel.gmm_step",
           "kmeans_tpu_torch.parallel.sharding",
           "kmeans_tpu_torch.utils.checkpoint",
           "kmeans_tpu_torch.utils.logging",
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
                                        "__version__"]
    assert isinstance(kmeans_tpu_torch.__version__, str)
    assert kmeans_tpu_torch.KMeans.__module__ == \
        "kmeans_tpu_torch.models.kmeans"
    assert kmeans_tpu_torch.GaussianMixture.__module__ == \
        "kmeans_tpu_torch.models.gmm"


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
    for name in ("kmeans_assign_bf16_launch",
                 "kmeans_fused_assign_reduce_bf16_launch",
                 "assign_bf16_kernel", "fused_assign_reduce_bf16_kernel",
                 "prep_centroids_kernel", "reduce_partials_kernel",
                 "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                 "pallas_kernels.py:542", "kmeans_tile_rows",
                 "kmeans_scratch_bytes", "KM_TILE_N", "KM_TILE_K",
                 "KM_PIPE"):
        assert name in bf16
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
