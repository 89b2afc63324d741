"""The fused diagonal-GMM E-step kernel for Hopper, and its plain version.

Counterpart of ``experiments/exp_gmm_estep_pallas.py::pallas_estep``.
:func:`diag_estep` launches the CUDA C++ kernels of ``csrc/gmm_estep.cu``:
the whole E-step of the points in one pass, with the (n, k) log-densities
and responsibilities kept out of device memory.

Arithmetic, shared with :func:`diag_estep_reference`, for x_c = x - shift:

* ``logp = c1 + [x_c, x_c^2] . [b, -a/2]^T`` with ``a = inv_var``,
  ``b = means_c * a`` and ``c1 = log_weights - 0.5 (D log 2pi + log_det +
  sum_d means_c b)``: the algebra of ``parallel.gmm_step._log_prob_chunk``;
* a max-subtracted softmax over all k components; ``r = p w / sum p``;
* ``rsum = sum r``, ``s1 = r^T x_c``, ``s2 = r^T x_c^2`` and
  ``ll = sum over rows with w > 0 of w (max + log sum p)``;
* a row of weight 0 adds nothing to any output, not even a NaN;
* float32-accurate products and float32 accumulation (ll in double on the
  card): on the card both products run on the tensor cores as three TF32
  products each (3xTF32), never as one TF32 or bf16 product, which neither
  the hard-init tables (terms of order 1e8 that cancel) nor the variance
  ``S2/R - mu^2`` would survive.

Two calls on the same inputs give the same bits: the kernel adds per-block
tables in a fixed order.  A tensor on the CPU goes to the plain version; a
CUDA tensor launches the kernel or raises.  ``LAUNCHES['diag_estep']``
counts the launches, one per call that reached the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from kmeans_tpu_torch.ops import _build
from kmeans_tpu_torch.ops.hopper_kernels import _PARTIAL_BUDGET_BYTES, \
    _check, _raise_on, _row_block, declared_operations

#: The package's table of kernel launches (``_build.LAUNCHES``).
LAUNCHES: Dict[str, int] = _build.LAUNCHES
LAUNCHES.update(diag_estep=0)

#: The source of the kernels (``csrc/gmm_estep.cu``).
LIB_NAME = "gmm_estep"
_LOG2PI = math.log(2.0 * math.pi)
#: Persistent blocks of ``estep_kernel`` on each SM: 256 threads at up to
#: 255 registers, and more than half of the SM's shared memory.
_BLOCKS_PER_SM = 1

EStepOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument types of a built library of ``csrc/gmm_estep.cu``."""
    if not getattr(lib, "_gmm_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gmm_diag_estep_launch.argtypes = [p] * 15 + [ll, i, i, i, p]
        lib.gmm_diag_estep_launch.restype = i
        lib.gmm_estep_tile_rows.argtypes = []
        lib.gmm_estep_tile_rows.restype = i
        for name in ("gmm_estep_coef_floats", "gmm_estep_table_floats"):
            getattr(lib, name).argtypes = [i, i]
            getattr(lib, name).restype = ll
        lib._gmm_bound = True
    return lib


def _lib() -> ctypes.CDLL:
    return bind(_build.load(LIB_NAME))


def _blocks(device: torch.device, n: int, table_floats: int,
            tile_rows: int) -> int:
    """Persistent blocks of a launch: one on each SM, no more than there are
    row tiles, and within the per-block tables' budget."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = min(_BLOCKS_PER_SM * sms, -(-n // tile_rows),
                 _PARTIAL_BUDGET_BYTES // (4 * table_floats))
    return max(1, blocks)


def _check_estep(points, weights, shift, means_c, inv_var, log_det,
                 log_weights, dtypes=(torch.float32,)) -> None:
    _check(points, means_c, weights, dtypes)
    k, d = means_c.shape
    for name, t, shape in (("shift", shift, (d,)),
                           ("inv_var", inv_var, (k, d)),
                           ("log_det", log_det, (k,)),
                           ("log_weights", log_weights, (k,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != points.dtype:
            raise TypeError(f"{name} must be {points.dtype} like points, "
                            f"got {t.dtype}")
        if t.device != points.device:
            raise ValueError(f"{name} is on {t.device}, points on "
                             f"{points.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def estep_coefficients(means_c: torch.Tensor, inv_var: torch.Tensor,
                       log_det: torch.Tensor, log_weights: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(coef (k, 2D) = [b, -a/2], c1 (k,))``: the per-component tables of
    the expanded log-density."""
    d = means_c.shape[1]
    b = means_c * inv_var
    c1 = log_weights - 0.5 * (d * _LOG2PI + log_det + (means_c * b).sum(1))
    return torch.cat([b, -0.5 * inv_var], dim=1), c1


def diag_estep_reference(points: torch.Tensor, weights: torch.Tensor,
                         shift: torch.Tensor, means_c: torch.Tensor,
                         inv_var: torch.Tensor, log_det: torch.Tensor,
                         log_weights: torch.Tensor) -> EStepOut:
    """Plain version of :func:`diag_estep`: ``(rsum (k,), s1 (k, D),
    s2 (k, D), ll ())`` by torch ops, in blocks of rows so that no (n, k)
    matrix is ever whole.  float32 or float64 (all inputs alike)."""
    _check_estep(points, weights, shift, means_c, inv_var, log_det,
                 log_weights, dtypes=(torch.float32, torch.float64))
    n, d = points.shape
    k = means_c.shape[0]
    coef, c1 = estep_coefficients(means_c, inv_var, log_det, log_weights)
    kw = dict(dtype=points.dtype, device=points.device)
    rsum = torch.zeros((k,), **kw)
    s1 = torch.zeros((k, d), **kw)
    s2 = torch.zeros((k, d), **kw)
    ll = torch.zeros((), **kw)
    step = _row_block(k)
    for lo in range(0, n, step):
        w = weights[lo:lo + step]
        live = w > 0
        xc = torch.where(live[:, None], points[lo:lo + step] - shift,
                         torch.zeros((), **kw))
        x2 = xc * xc
        logp = torch.addmm(c1, torch.cat([xc, x2], dim=1), coef.T)
        m = logp.max(dim=1, keepdim=True).values
        p = torch.exp(logp - m)
        s = p.sum(dim=1, keepdim=True)
        r = torch.where(live[:, None], p * (w[:, None] / s),
                        torch.zeros((), **kw))
        rsum += r.sum(dim=0)
        s1 += r.T @ xc
        s2 += r.T @ x2
        lse = m[:, 0] + torch.log(s[:, 0])
        ll += torch.where(live, w * lse, torch.zeros((), **kw)).sum()
    return rsum, s1, s2, ll


def diag_estep(points: torch.Tensor, weights: torch.Tensor,
               shift: torch.Tensor, means_c: torch.Tensor,
               inv_var: torch.Tensor, log_det: torch.Tensor,
               log_weights: torch.Tensor) -> EStepOut:
    """The E-step of the diagonal mixture over all points in one pass:
    ``(rsum (k,), s1 (k, D), s2 (k, D), ll ())``, float32, in the frame
    centered by ``shift``; ``means_c`` must already be centered.

    Launches ``estep_tables_kernel``, ``estep_kernel`` and
    ``estep_reduce_kernel`` on the current stream for CUDA tensors and does
    not synchronise; CPU tensors go to :func:`diag_estep_reference`."""
    _check_estep(points, weights, shift, means_c, inv_var, log_det,
                 log_weights)
    if not points.is_cuda:
        return diag_estep_reference(points, weights, shift, means_c,
                                    inv_var, log_det, log_weights)
    return launch_estep(_lib(), points, weights, shift, means_c, inv_var,
                        log_det, log_weights, "diag_estep")


def launch_estep(lib: ctypes.CDLL, points: torch.Tensor,
                 weights: torch.Tensor, shift: torch.Tensor,
                 means_c: torch.Tensor, inv_var: torch.Tensor,
                 log_det: torch.Tensor, log_weights: torch.Tensor,
                 counter: str) -> EStepOut:
    """One launch of a bound ``gmm_estep`` library (the package's, or an
    edited build) on checked CUDA tensors, counted under ``counter``."""
    n, d = points.shape
    k = means_c.shape[0]
    dev = points.device
    kw = dict(dtype=torch.float32, device=dev)
    if n == 0:
        return (torch.zeros((k,), **kw), torch.zeros((k, d), **kw),
                torch.zeros((k, d), **kw), torch.zeros((), **kw))
    table = lib.gmm_estep_table_floats(d, k)
    blocks = _blocks(dev, n, table, lib.gmm_estep_tile_rows())
    with torch.cuda.device(dev):
        coef = torch.empty(lib.gmm_estep_coef_floats(d, k), **kw)
        c1 = torch.empty(k, **kw)
        partial = torch.zeros(blocks * table, **kw)
        ll_partial = torch.empty(blocks, dtype=torch.float64, device=dev)
        rsum = torch.empty((k,), **kw)
        s1 = torch.empty((k, d), **kw)
        s2 = torch.empty((k, d), **kw)
        ll = torch.empty((), **kw)
        err = lib.gmm_diag_estep_launch(
            points.data_ptr(), weights.data_ptr(), shift.data_ptr(),
            means_c.data_ptr(), inv_var.data_ptr(), log_det.data_ptr(),
            log_weights.data_ptr(), coef.data_ptr(), c1.data_ptr(),
            partial.data_ptr(),
            ll_partial.data_ptr(), rsum.data_ptr(), s1.data_ptr(),
            s2.data_ptr(), ll.data_ptr(), n, d, k, blocks,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, counter)
    _build.count_launch(counter,
                        ops=declared_operations("estep", n, d, k)[1])
    return rsum, s1, s2, ll
