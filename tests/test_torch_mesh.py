"""The mesh of the port (``kmeans_tpu_torch.parallel.mesh``) and the pad and
chunk rules of ``parallel.sharding`` against the JAX package's.

``make_mesh`` raises where ``kmeans_tpu.parallel.mesh.make_mesh`` raises,
with its messages; without a process group the world is one rank.
``clamp_chunk_for_k`` and ``pad_points`` are NumPy-only in both packages,
so they are held to the reference functions over a grid of inputs, bit for
bit.  The rank layout of a real mesh is checked by the spawned worlds of
``test_torch_distributed.py``.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu.parallel import mesh as jx_mesh  # noqa: E402
from kmeans_tpu.parallel import sharding as jx_sharding  # noqa: E402
from kmeans_tpu_torch.parallel import mesh as pt_mesh  # noqa: E402
from kmeans_tpu_torch.parallel import sharding as pt_sharding  # noqa: E402


def _jax_error(**kw):
    with pytest.raises(ValueError) as e:
        jx_mesh.make_mesh(devices=jax.devices()[:kw.pop("n")], **kw)
    return str(e.value)


@pytest.mark.parametrize("n,data,model", [
    (1, None, 0), (1, None, -2), (1, None, 2), (1, 2, 1), (4, 3, 2),
    (4, None, 3), (4, 5, 1), (2, 2, 2)])
def test_make_mesh_raises_as_the_reference(n, data, model):
    want = _jax_error(n=n, data=data, model=model)
    with pytest.raises(ValueError) as got:
        pt_mesh.make_mesh(data=data, model=model, ranks=range(n))
    assert str(got.value) == want


def test_a_valid_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        pt_mesh.make_mesh()
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        pt_mesh.make_mesh(data=2, model=2, ranks=range(4))


def test_non_positive_data_axis_raises():
    with pytest.raises(ValueError, match="data axis size must be positive"):
        pt_mesh.make_mesh(data=0, ranks=range(2))


def test_mesh_shape_and_coordinates_without_a_mesh():
    assert pt_mesh.mesh_shape(None) == jx_mesh.mesh_shape(None) == (1, 1)
    assert pt_mesh.coords(None) == (0, 0)
    assert pt_mesh.in_mesh(None)
    assert pt_mesh.world_size() == 1
    t = torch.arange(3.0)
    assert pt_mesh.all_reduce(t, None) is t
    assert pt_mesh.check_mesh(None) is None
    assert (pt_mesh.DATA_AXIS, pt_mesh.MODEL_AXIS) == (jx_mesh.DATA_AXIS,
                                                       jx_mesh.MODEL_AXIS)


@pytest.mark.parametrize("value", [object(), "a mesh", (2, 1)])
def test_a_model_refuses_what_is_not_a_device_mesh(value):
    with pytest.raises(TypeError, match="DeviceMesh"):
        pt_mesh.check_mesh(value)


CLAMP_GRID = [(chunk, k, budget, cap)
              for chunk in (8, 120, 128, 129, 1000, 4096, 65536, 131072,
                            1 << 20, 3 * (1 << 18), 4_000_008, 2_097_152)
              for k in (1, 16, 64, 1000, 1024, 4096)
              for budget in (pt_sharding.SINGLE_CHUNK_ELEMS, 1 << 23)
              for cap in (None, 32768)]


@pytest.mark.parametrize("chunk,k,budget,cap", CLAMP_GRID[::7]
                         + [(4_000_008, 1024,
                             pt_sharding.SINGLE_CHUNK_ELEMS, None)])
def test_clamp_chunk_for_k_matches_the_reference(chunk, k, budget, cap):
    with warnings.catch_warnings(record=True) as w_ref:
        warnings.simplefilter("always")
        want = jx_sharding.clamp_chunk_for_k(chunk, k, budget, max_chunk=cap)
    with warnings.catch_warnings(record=True) as w_got:
        warnings.simplefilter("always")
        got = pt_sharding.clamp_chunk_for_k(chunk, k, budget, max_chunk=cap)
    assert got == want
    assert [str(x.message) for x in w_got] == [str(x.message)
                                               for x in w_ref]


def test_clamp_chunk_for_k_over_the_whole_grid():
    for chunk, k, budget, cap in CLAMP_GRID:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert pt_sharding.clamp_chunk_for_k(
                chunk, k, budget, max_chunk=cap) == \
                jx_sharding.clamp_chunk_for_k(chunk, k, budget,
                                              max_chunk=cap)


def test_the_advice_case_returns_1333336_and_warns():
    with pytest.warns(UserWarning, match="budget overshoot"):
        assert pt_sharding.clamp_chunk_for_k(4_000_008, 1024) == 1333336


@pytest.mark.parametrize("n,multiple,min_rows", [
    (0, 4, 0), (0, 4, 1), (1, 1, 1), (7, 4, 0), (8, 4, 0), (8, 4, 13),
    (301, 2, 0), (301, 3, 302), (5, 8, 0)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pad_points_matches_the_reference(n, multiple, min_rows, dtype):
    x = np.random.default_rng(n).normal(size=(n, 3)).astype(dtype)
    want = jx_sharding.pad_points(x, multiple, min_rows=min_rows)
    got = pt_sharding.pad_points(x, multiple, min_rows=min_rows)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
