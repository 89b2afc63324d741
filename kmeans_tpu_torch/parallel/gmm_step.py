"""The E-step, the posterior pass and the device EM loop of the Gaussian
mixture, on one device or over the data axis of a mesh.

Counterpart of ``kmeans_tpu/parallel/gmm_step.py``: ``EStats``,
``EStatsFull``, ``_log_prob_chunk``, ``_log_prob_full_chunk``,
``_log_prob_tied_chunk``, ``_softmax_resp``, ``_diag_stage_fns``,
``estep_chunk``, ``_chunked_epass`` with its serial and pipelined
schedules, ``_scan_estats_full``, ``_scan_estats_tied``, ``_embed_psum``
and ``_embed_psum_full`` (here :func:`_reduce_estats`), ``_prec_chol_dev``,
the step builders of the four covariance types, ``make_total_scatter_fn``
(here :func:`total_scatter`), ``_predict_from_logp`` and the three predict
builders (here one, :func:`make_gmm_predict_fn`), and the device EM
loops ``make_gmm_fit_fn``, ``make_gmm_fit_full_fn``,
``make_gmm_fit_tied_fn`` (here one builder, :func:`make_gmm_fit_fn`) and
``make_gmm_multi_fit_fn`` with ``_diag_estats_block`` and
``_diag_m_step``.  Under a mesh each rank runs the pass on its block of
the rows and the statistics are summed over the data axis (one packed SUM
``all_reduce``), so every rank gets the global ones.

The model axis (``model_shards = M > 1``) shards the components: the
functions here take the whole (k, ...) tables, pad them to ``k_pad`` (k
rounded up to a multiple of M) with the reference's inert components (zero
mean, unit variance, identity precision factor, ``log_weight = -inf``) and
run each rank's block of ``k_local = k_pad / M`` of them
(:func:`_model_blocks`).  Per chunk the softmax takes its row maximum by a
MAX ``all_reduce`` and its denominator by a SUM ``all_reduce`` over the
model axis (:func:`_softmax_resp`; in the kernel mode launch (a),
``diag_estep_rows``, gives each block's pair and launch (b),
``diag_estep_moments``, the moments from the global pair).  The block's
statistics are embedded into the (k_pad, ...) table and summed over both
axes, the log-likelihood divided by M (every rank of the model axis holds
the same one), then cut back to k (:func:`_reduce_estats`).  The posterior
pass picks the global label as the lowest block among those that reach a
row's maximum (``distributed._owner``).  A block of only inert components
has every logp at -inf: its max is -inf, its sum 0, and its term vanishes
from the denominator without a NaN.

For diagonal Gaussians, with ``a = 1/sigma^2``,

    log N(x | mu_k, sigma_k^2)
      = -0.5 [ sum_d x_d^2 a_kd - 2 sum_d x_d mu_kd a_kd
               + sum_d mu_kd^2 a_kd + sum_d log sigma_kd^2 + D log 2pi ],

so a (chunk, k) log-density tile is two matrix products plus per-component
constants.  'full' transforms each chunk by every component's precision
Cholesky ``P_k`` (``Sigma_k^-1 = P_k P_k^T``; a batched product, k matrices
of D x D), 'tied' by the one shared ``P`` (one product, then the diagonal
form's two).  The statistics of a pass are

    R_k  = sum_i r_ik            S1_k = sum_i r_ik x_i
    S2_k = sum_i r_ik x_i^2      ll   = sum_i w_i logsumexp_k(...)

with ``r`` the weighted responsibilities; 'full' accumulates the scatter
``sum_i r_ik x_i x_i^T`` (k, D, D) in place of ``S2``, and 'tied' none (its
M-step takes the total scatter, computed once per fit,
:func:`total_scatter`).

Centering: every pass subtracts a (D,) ``shift`` (the data's weighted mean)
from each chunk and works against shifted means, so that the second moments
stay at the data's spread and ``S2/R - mu^2`` does not cancel for data far
from the origin.  No centered copy of the data is made.

``mode='kernel'`` runs the whole diagonal pass as one launch of the fused
CUDA kernel (``ops.estep_kernels.diag_estep``; its plain version for
tensors on the CPU); ``mode='torch'`` is the chunked plain pass, in float32
or float64, and the only pass of 'tied' and 'full'.  ``pipeline=1`` skews
the torch pass's chunk loop by one chunk (chunk i's log-density products,
then chunk i - 1's softmax and moments); the arithmetic of each chunk and
the fold order are those of the serial loop, so both give the same bits.
The posterior pass (``predict``) has no kernel in either package.

Precision of the products: every float32 product here is a full float32
product, with the default of PyTorch (``torch.backends.cuda.matmul
.allow_tf32`` is False), which the port never changes; ``chip_smoke.py``
sets it False at its start and holds 'tied' and 'full' to float64 fits on
the card.  The JAX package runs the tied moments and its total scatter at
HIGHEST and the full moments at HIGH (bf16 splits of float32 on its
hardware); full float32 is at least as accurate as both.  A caller who
turns TF32 on gets TF32 products here, which the tied M-step's cancellation
``(T - sum_k R_k mu_k mu_k^T) / W`` does not survive on data far from the
origin.

The device EM loop (:func:`make_gmm_fit_fn`, ``GaussianMixture(host_loop=
False)``): the whole EM iteration, E-step and M-step, on the device, in the
model's dtype; one captured CUDA graph per iteration, replayed, the host
reading one done flag per iteration (``parallel.distributed._Replay``); on
the CPU the same iteration runs eagerly.  'full' and 'tied' factor their
covariances inside the iteration with ``torch.linalg.cholesky_ex`` (no
synchronisation): a batch that is not positive definite gives NaN, and the
non-finite log-likelihood stops the loop, which the model turns into its
loud error.  :func:`make_gmm_multi_fit_fn` runs R fits (restarts, or the
members of a sweep over k) in one such loop, each member the single fit's
iteration at its own k, one after another.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from kmeans_tpu_torch.obs import cost as _cost
from kmeans_tpu_torch.ops.estep_kernels import (combine_terms, diag_estep,
                                                diag_estep_moments,
                                                diag_estep_rows)
from kmeans_tpu_torch.parallel.distributed import (IN_FLIGHT, _check_backend,
                                                   _host_copy, _owner,
                                                   _Replay, _run_evicting)
from kmeans_tpu_torch.parallel.mesh import (AXES, DATA_AXIS, MODEL_AXIS,
                                            all_reduce, coords, mesh_shape)

_LOG2PI = math.log(2.0 * math.pi)

GMM_MODES = ("kernel", "torch")
COV_TYPES = ("diag", "spherical", "tied", "full")


class EStats(NamedTuple):
    """E-step statistics of one pass (in the centered frame)."""

    resp_sum: torch.Tensor    # (k,)   sum of weighted responsibilities
    xsum: torch.Tensor        # (k, D) responsibility-weighted point sums
    x2sum: torch.Tensor       # (k, D) responsibility-weighted square sums
    loglik: torch.Tensor      # ()     weighted total log-likelihood


class EStatsFull(NamedTuple):
    """E-step statistics of a 'full' pass: the scatter moment
    ``sum_i r_ik x_i x_i^T`` in place of the squares."""

    resp_sum: torch.Tensor    # (k,)
    xsum: torch.Tensor        # (k, D)
    scatter: torch.Tensor     # (k, D, D)
    loglik: torch.Tensor      # ()


def _log_prob_chunk(x, means, inv_var, log_det, log_weights):
    """(chunk, k) weighted log joint: log pi_k + log N(x | mu_k, s2_k)."""
    a = inv_var
    b = means * inv_var
    x2a = (x * x) @ a.T
    xb = x @ b.T
    quad = x2a - 2.0 * xb + (means * b).sum(dim=1)[None, :]
    d = x.shape[1]
    return (log_weights[None, :]
            - 0.5 * (quad + log_det[None, :] + d * _LOG2PI))


def _log_prob_full_chunk(x, means, prec_chol, log_det_half, log_weights):
    """(chunk, k) weighted log joint for full covariances: with ``P_k`` the
    precision Cholesky (``Sigma_k^-1 = P_k P_k^T``) and ``log_det_half_k =
    sum_d log P_k[d, d]``, ``log N = log_det_half_k - 0.5 (||(x - mu_k)
    P_k||^2 + D log 2pi)``: one batched product (k matrices) minus a
    per-component row."""
    xt = torch.matmul(x, prec_chol)                       # (k, c, D)
    mt = torch.matmul(means[:, None, :], prec_chol)       # (k, 1, D)
    quad = ((xt - mt) ** 2).sum(dim=-1).T                 # (c, k)
    d = x.shape[1]
    return (log_weights[None, :] + log_det_half[None, :]
            - 0.5 * (quad + d * _LOG2PI))


def _log_prob_tied_chunk(x, means_t, prec_chol, log_det_half, log_weights):
    """(chunk, k) weighted log joint for a tied covariance: the chunk is
    transformed once by the shared ``P`` and the quadratic form is the
    diagonal form's ``||xt||^2 + ||mt||^2 - 2 xt mt^T``; ``means_t`` must
    already be transformed (``mu_c @ P``)."""
    xt = x @ prec_chol
    x2 = (xt * xt).sum(dim=1)[:, None]
    cross = xt @ means_t.T
    m2 = (means_t * means_t).sum(dim=1)[None, :]
    quad = x2 - 2.0 * cross + m2
    d = x.shape[1]
    return (log_weights[None, :] + log_det_half
            - 0.5 * (quad + d * _LOG2PI))


def _model_shards(mesh) -> int:
    return mesh_shape(mesh)[1]


class _Blocks(NamedTuple):
    """This rank's block of a k-component table on the model axis."""

    k: int          # the real components
    k_pad: int      # k rounded up to a multiple of the axis
    lo: int         # the block's first component
    k_local: int    # its components


def _model_blocks(mesh, k: int) -> _Blocks:
    """The block of k components that this rank of a model axis runs."""
    shards = _model_shards(mesh)
    k_pad = -(-k // shards) * shards
    k_local = k_pad // shards
    return _Blocks(k, k_pad, coords(mesh)[1] * k_local, k_local)


def _block_of(t: torch.Tensor, b: _Blocks, fill) -> torch.Tensor:
    """Rows ``b.lo .. b.lo + b.k_local`` of the table ``t`` (k, ...), the
    rows past k filled with ``fill`` (a number, or 'eye' for an identity
    matrix), contiguous."""
    out = torch.empty((b.k_local,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    real = max(0, min(b.k, b.lo + b.k_local) - b.lo)
    out[:real] = t[b.lo:b.lo + real]
    if real < b.k_local:
        out[real:] = torch.eye(t.shape[-1], dtype=t.dtype,
                               device=t.device) if fill == "eye" else fill
    return out


def _softmax_resp(logp, w, mesh=None):
    """Responsibility softmax of one chunk: ``(resp, lse)`` with
    ``resp = p / sum p * w``.  On a model axis ``logp`` holds the rank's
    block of components, the row maximum is a MAX and the denominator a SUM
    ``all_reduce`` over the axis, and ``resp`` is the block's."""
    m = logp.max(dim=1).values
    axis = mesh is not None and _model_shards(mesh) > 1
    if axis:
        m = all_reduce(m, mesh, (MODEL_AXIS,), "max")
    p = torch.exp(logp - m[:, None])
    denom = p.sum(dim=1)
    if axis:
        denom = all_reduce(denom, mesh, (MODEL_AXIS,))
    lse = m + torch.log(denom)
    return p / denom[:, None] * w[:, None], lse


def _loglik_part(lse, wc):
    return torch.where(wc > 0, lse * wc, torch.zeros_like(lse)).sum()


def _diag_stage_fns(means, inv_var, log_det, log_weights, mesh=None):
    """The E pass as two stages: ``logp_fn(xc)`` (the log-density
    products) and ``consume(stats, logp, xc, wc)`` (softmax and moment
    accumulation) — the one implementation of this arithmetic, shared by
    :func:`estep_chunk` and the chunked pass.  On a model axis the tables
    are the rank's block."""

    def logp_fn(xc):
        return _log_prob_chunk(xc, means, inv_var, log_det, log_weights)

    def consume(carry, logp, xc, wc):
        resp, lse = _softmax_resp(logp, wc, mesh)
        return EStats(
            carry.resp_sum + resp.sum(dim=0),
            carry.xsum + resp.T @ xc,
            carry.x2sum + resp.T @ (xc * xc),
            carry.loglik + _loglik_part(lse, wc))

    return logp_fn, consume


def _zero_estats(k: int, d: int, dtype, device, full: bool = False):
    kw = dict(dtype=dtype, device=device)
    if full:
        return EStatsFull(torch.zeros((k,), **kw), torch.zeros((k, d), **kw),
                          torch.zeros((k, d, d), **kw), torch.zeros((), **kw))
    return EStats(torch.zeros((k,), **kw), torch.zeros((k, d), **kw),
                  torch.zeros((k, d), **kw), torch.zeros((), **kw))


def estep_chunk(x, w, means, inv_var, log_det, log_weights) -> EStats:
    """E-statistics of one chunk of (already centered) points."""
    k, d = means.shape
    logp_fn, consume = _diag_stage_fns(means, inv_var, log_det,
                                       log_weights)
    return consume(_zero_estats(k, d, x.dtype, x.device), logp_fn(x), x, w)


def _chunked_epass(points, weights, shift, *, chunk_size: int, logp_fn,
                   consume_fn, init, pipeline: int = 0):
    """The chunk loop of every covariance type's E pass.  Each chunk is
    centered, then stage A (``logp_fn``, the log-density products) and
    stage B (``consume_fn``, softmax and moments) run on it; the last chunk
    may be short.  ``pipeline=0`` runs A and B back to back per chunk;
    ``pipeline=1`` runs stage A of chunk i before stage B of chunk i - 1
    (the reference's skewed schedule: a prologue, the skewed body, an
    epilogue).  Per chunk the arithmetic and the fold order are the same,
    so the two schedules give the same bits."""
    st = init
    w = weights.to(points.dtype)
    pending = None
    for lo in range(0, points.shape[0], chunk_size):
        xc = points[lo:lo + chunk_size] - shift[None, :]
        wc = w[lo:lo + chunk_size]
        if not pipeline:
            st = consume_fn(st, logp_fn(xc), xc, wc)
            continue
        logp = logp_fn(xc)                          # stage A, chunk i
        if pending is not None:
            st = consume_fn(st, *pending)           # stage B, chunk i - 1
        pending = (logp, xc, wc)
    if pending is not None:
        st = consume_fn(st, *pending)               # the epilogue
    return st


def _reduce_estats(st, mesh, blocks: Optional[_Blocks] = None):
    """The statistics of every block of the data axis, replicated: one SUM
    ``all_reduce`` of every field packed into one buffer (``EStats`` or
    ``EStatsFull``); ``mesh=None`` returns them as they are.  On a model
    axis the rank's (k_local, ...) block is embedded into the (k_pad, ...)
    table first, the buffer summed over both axes, the log-likelihood
    divided by the axis's size and the tables cut to the real k (the
    reference's ``_embed_psum`` and ``_embed_psum_full``); ``blocks`` is
    the block ``st`` holds (:func:`_model_blocks`), None without the
    axis."""
    if mesh is None:
        return st
    if blocks is not None and _model_shards(mesh) == 1:
        blocks = None
    fields = list(st[:3])
    if blocks is not None:
        emb = []
        for t in fields:
            full = torch.zeros((blocks.k_pad,) + tuple(t.shape[1:]),
                               dtype=t.dtype, device=t.device)
            full[blocks.lo:blocks.lo + blocks.k_local] = t
            emb.append(full)
        fields = emb
    fields.append(st[3])
    flat = all_reduce(torch.cat([t.reshape(-1) for t in fields]), mesh,
                      AXES if blocks is not None else (DATA_AXIS,))
    out, lo = [], 0
    for t in fields:
        out.append(flat[lo:lo + t.numel()].reshape(t.shape))
        lo += t.numel()
    if blocks is not None:
        out = [t[:blocks.k] for t in out[:3]] + \
            [out[3] / _model_shards(mesh)]
    return type(st)(*out)


#: The inert component's entry of each table a pass takes, in its order: a
#: mean row of zeros, unit variances and a zero log-determinant, an identity
#: precision factor, a log-weight of -inf; None for a table every component
#: shares ('tied''s factor and log-determinant).
_INF = float("-inf")
_FILLS = {"diag": (0.0, 1.0, 0.0, _INF), "full": (0.0, "eye", 0.0, _INF),
          "tied": (0.0, None, None, _INF)}


def _blocked(mesh, tables, form: str):
    """``(blocks, tables)``: this rank's block of each per-component table
    of a pass (``form`` 'diag', 'full' or 'tied'), and the block; ``(None,
    tables)`` without a model axis."""
    if mesh is None or _model_shards(mesh) == 1:
        return None, tuple(tables)
    b = _model_blocks(mesh, tables[0].shape[0])
    return b, tuple(t if f is None else _block_of(t, b, f)
                    for t, f in zip(tables, _FILLS[form]))


def _kernel_model_axis(points, weights, shift, means, inv_var, log_det,
                       log_weights, *, mesh) -> EStats:
    """The kernel mode's pass over the rank's rows on a model axis: launch
    (a) gives the block's row maxima and sums, a MAX then a SUM
    ``all_reduce`` of the rows over the axis the global ones, launch (b)
    the block's moments from them.  Neither launch materialises the (rows,
    k) log-densities, so the pass is not chunked: one exchange of 2 n
    floats per E-step."""
    m, s = diag_estep_rows(points, weights, shift, means, inv_var, log_det,
                           log_weights)
    big_m = all_reduce(m.clone(), mesh, (MODEL_AXIS,), "max")
    big_s = all_reduce(combine_terms(m, s, big_m), mesh, (MODEL_AXIS,))
    return EStats(*diag_estep_moments(points, weights, shift, means,
                                      inv_var, log_det, log_weights, big_m,
                                      big_s))


def _scan_estats(points, weights, shift, means, inv_var, log_det,
                 log_weights, *, chunk_size: int, mode: str,
                 pipeline: int = 0, mesh=None) -> EStats:
    """The diagonal E pass over the rank's rows: one launch of the fused
    kernel (``mode='kernel'``), or the chunked torch pass.  On a model axis
    (``mesh``) the tables are the rank's block and the softmax spans the
    axis: two launches per E-step in the kernel mode."""
    if mode == "kernel":
        if mesh is not None and _model_shards(mesh) > 1:
            return _kernel_model_axis(points, weights, shift, means,
                                      inv_var, log_det, log_weights,
                                      mesh=mesh)
        return EStats(*diag_estep(points, weights, shift, means, inv_var,
                                  log_det, log_weights))
    k, d = means.shape
    logp_fn, consume = _diag_stage_fns(means, inv_var, log_det, log_weights,
                                       mesh)
    return _chunked_epass(points, weights, shift, chunk_size=chunk_size,
                          logp_fn=logp_fn, consume_fn=consume,
                          init=_zero_estats(k, d, points.dtype,
                                            points.device),
                          pipeline=pipeline)


def _scan_estats_full(points, weights, shift, means, prec_chol,
                      log_det_half, log_weights, *, chunk_size: int,
                      pipeline: int = 0, mesh=None) -> EStatsFull:
    """The 'full' E pass over the rank's rows: responsibilities, sums and
    the scatter ``sum_i r_ik x_i x_i^T`` (a batched product, k matrices of
    D x chunk by chunk x D)."""
    k, d = means.shape

    def logp_fn(xc):
        return _log_prob_full_chunk(xc, means, prec_chol, log_det_half,
                                    log_weights)

    def consume(carry, logp, xc, wc):
        resp, lse = _softmax_resp(logp, wc, mesh)
        rx = resp.T[:, :, None] * xc[None, :, :]          # (k, c, D)
        return EStatsFull(
            carry.resp_sum + resp.sum(dim=0),
            carry.xsum + resp.T @ xc,
            carry.scatter + torch.matmul(rx.transpose(1, 2), xc),
            carry.loglik + _loglik_part(lse, wc))

    return _chunked_epass(points, weights, shift, chunk_size=chunk_size,
                          logp_fn=logp_fn, consume_fn=consume,
                          init=_zero_estats(k, d, points.dtype, points.device,
                                            full=True),
                          pipeline=pipeline)


def _scan_estats_tied(points, weights, shift, means_t, prec_chol,
                      log_det_half, log_weights, *, chunk_size: int,
                      pipeline: int = 0, mesh=None) -> EStats:
    """The 'tied' E pass over the rank's rows: ``EStats`` with ``x2sum``
    left at zero (the tied M-step takes the total scatter instead)."""
    k, d = means_t.shape

    def logp_fn(xc):
        return _log_prob_tied_chunk(xc, means_t, prec_chol, log_det_half,
                                    log_weights)

    def consume(carry, logp, xc, wc):
        resp, lse = _softmax_resp(logp, wc, mesh)
        return EStats(carry.resp_sum + resp.sum(dim=0),
                      carry.xsum + resp.T @ xc, carry.x2sum,
                      carry.loglik + _loglik_part(lse, wc))

    return _chunked_epass(points, weights, shift, chunk_size=chunk_size,
                          logp_fn=logp_fn, consume_fn=consume,
                          init=_zero_estats(k, d, points.dtype,
                                            points.device),
                          pipeline=pipeline)


@_cost.program()
def make_gmm_step_fn(mesh=None, *, chunk_size: int, mode: str = "torch",
                     pipeline: int = 0) -> Callable:
    """The diagonal E-step: ``(points, weights, shift, means_c, inv_var,
    log_det, log_weights) -> EStats`` over all points (every rank's block
    under a ``mesh``), in the frame centered by ``shift`` (``means_c`` must
    already be centered).

    ``mode='kernel'`` is one launch of the fused kernel over the block
    (float32); ``'torch'`` the chunked plain pass, in the chunk schedule
    ``pipeline``."""
    if mode not in GMM_MODES:
        raise ValueError(f"unknown E-step mode: {mode!r}")

    def step(points, weights, shift, means, inv_var, log_det, log_weights):
        blocks, tables = _blocked(
            mesh, (means, inv_var, log_det, log_weights), "diag")
        return _reduce_estats(_scan_estats(
            points, weights, shift, *tables, chunk_size=chunk_size,
            mode=mode, pipeline=pipeline, mesh=mesh), mesh, blocks)

    return step


@_cost.program()
def make_gmm_step_full_fn(mesh=None, *, chunk_size: int,
                          pipeline: int = 0) -> Callable:
    """The 'full' E-step: ``(points, weights, shift, means_c, prec_chol
    (k, D, D), log_det_half (k,), log_weights) -> EStatsFull``, over every
    rank's block under a ``mesh``."""

    def step(points, weights, shift, means, prec_chol, log_det_half,
             log_weights):
        blocks, tables = _blocked(
            mesh, (means, prec_chol, log_det_half, log_weights), "full")
        return _reduce_estats(_scan_estats_full(
            points, weights, shift, *tables, chunk_size=chunk_size,
            pipeline=pipeline, mesh=mesh), mesh, blocks)

    return step


@_cost.program()
def make_gmm_step_tied_fn(mesh=None, *, chunk_size: int,
                          pipeline: int = 0) -> Callable:
    """The 'tied' E-step: ``(points, weights, shift, means_t (mu_c @ P),
    prec_chol (D, D), log_det_half (), log_weights) -> EStats`` with
    ``x2sum`` zero, over every rank's block under a ``mesh``."""

    def step(points, weights, shift, means_t, prec_chol, log_det_half,
             log_weights):
        blocks, tables = _blocked(
            mesh, (means_t, prec_chol, log_det_half, log_weights), "tied")
        return _reduce_estats(_scan_estats_tied(
            points, weights, shift, *tables, chunk_size=chunk_size,
            pipeline=pipeline, mesh=mesh), mesh, blocks)

    return step


def total_scatter(points, weights, shift, mesh=None) -> torch.Tensor:
    """(D, D) total weighted scatter ``sum_i w_i (x_i - shift)(x_i -
    shift)^T`` over every rank's block, replicated (the reference's
    ``make_total_scatter_fn``): the loop-invariant term of the tied M-step,
    one product over the rows, computed once per fit."""
    xc = points - shift[None, :]
    w = weights.to(points.dtype)
    t = (xc * w[:, None]).T @ xc
    return t if mesh is None else all_reduce(t, mesh, (DATA_AXIS,))


def _prec_chol_dev(cov, tiny: float):
    """Precision Cholesky of a (..., D, D) covariance batch on the device:
    ``Sigma = L L^T -> P = L^-T``, ``log_det_half = -sum log diag L``.  A
    matrix that is not positive definite gives NaN (``cholesky_ex`` does not
    synchronise, so a captured iteration holds it), which the loop reads as
    a non-finite log-likelihood."""
    d = cov.shape[-1]
    L, info = torch.linalg.cholesky_ex(cov)
    L = torch.where((info == 0)[..., None, None], L,
                    torch.full_like(L, float("nan")))
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device).expand_as(cov)
    p_chol = torch.linalg.solve_triangular(L, eye, upper=False)
    ldh = -torch.log(torch.clamp_min(torch.diagonal(L, dim1=-2, dim2=-1),
                                     tiny)).sum(dim=-1)
    return p_chol.transpose(-1, -2), ldh


def _predict_from_logp(logp_fn, points, chunk_size: int, mesh=None,
                       blocks: Optional[_Blocks] = None):
    """Posterior pass: per chunk, logp by ``logp_fn``, then labels (the
    lowest index among equal maxima), log-responsibilities and the
    per-row log-likelihood ``lse``.  On a model axis (``blocks``, the
    rank's block of components) the label is the lowest block among those
    that reach the row's maximum (``distributed._owner``), the denominator
    a SUM over the axis, and the log-responsibilities of every block are
    embedded into the (n, k_pad) table and summed over the axis."""
    n = points.shape[0]
    labels = torch.empty(n, dtype=torch.int32, device=points.device)
    logr, lse = [], []
    for lo in range(0, max(n, 1), chunk_size):     # n = 0: one empty chunk
        logp = logp_fn(points[lo:lo + chunk_size])
        m = logp.max(dim=1).values
        best = torch.argmax(logp, dim=1).to(torch.int32)
        if blocks is None:
            labels[lo:lo + chunk_size] = best
            row_lse = m + torch.log(torch.exp(logp - m[:, None]).sum(dim=1))
            logr.append(logp - row_lse[:, None])
            lse.append(row_lse)
            continue
        mine, neg = _owner(-m, mesh)
        m = -neg
        labels[lo:lo + chunk_size] = all_reduce(
            torch.where(mine, best + blocks.lo, torch.zeros_like(best)),
            mesh, (MODEL_AXIS,))
        row_lse = m + torch.log(all_reduce(
            torch.exp(logp - m[:, None]).sum(dim=1), mesh, (MODEL_AXIS,)))
        full = torch.zeros((logp.shape[0], blocks.k_pad), dtype=logp.dtype,
                           device=logp.device)
        full[:, blocks.lo:blocks.lo + blocks.k_local] = \
            logp - row_lse[:, None]
        logr.append(all_reduce(full, mesh, (MODEL_AXIS,))[:, :blocks.k])
        lse.append(row_lse)
    return labels, torch.cat(logr), torch.cat(lse)


_LOG_PROB = {"diag": _log_prob_chunk, "spherical": _log_prob_chunk,
             "tied": _log_prob_tied_chunk, "full": _log_prob_full_chunk}
_FORM = {"diag": "diag", "spherical": "diag", "tied": "tied",
         "full": "full"}


@_cost.program()
def make_gmm_predict_fn(mesh=None, *, chunk_size: int,
                        cov_type: str = "diag") -> Callable:
    """The posterior pass: ``(points, shift, *tables) -> (labels (n,)
    int32, log_resp (n, k), lse (n,))``, one row per row of ``points`` (the
    rank's block under a mesh: without a model axis each row needs only the
    replicated tables, so the pass has no collective; on a model axis each
    rank scores its block of components and the rows meet over the axis,
    :func:`_predict_from_logp`).  The tables are the E-step's of
    ``cov_type``: ``(means_c, inv_var, log_det, log_weights)`` for 'diag'
    and 'spherical', ``(means_t, prec_chol, log_det_half, log_weights)`` for
    'tied', ``(means_c, prec_chol, log_det_half, log_weights)`` for
    'full' (the reference's three predict builders)."""
    log_prob = _LOG_PROB[cov_type]

    def predict(points, shift, *tables):
        blocks, tables = _blocked(mesh, tables, _FORM[cov_type])
        return _predict_from_logp(
            lambda x: log_prob(x - shift[None, :], *tables), points,
            chunk_size, mesh, blocks)

    return predict


# --------------------------------------------------------- device EM loop


def _floor_tiny(dtype: torch.dtype):
    """``(tiny, pi_floor)`` of the accumulation dtype: the floors of the
    device M-step (``pi_floor = max(1e-300, tiny)``: for float64 the host
    M-step's constants)."""
    tiny = float(torch.finfo(dtype).tiny)
    return tiny, (max(1e-300, tiny) if dtype == torch.float64 else tiny)


def _estats_fn(cov_type: str, mode: str, chunk_size: int, pipeline: int,
               mesh, reg_covar: float, tiny: float) -> Callable:
    """``(points, weights, shift, means_c, cov, log_w) -> statistics`` of
    one fit's carried tables, reduced over the data axis: the reference's
    ``_diag_estats_block`` (the variance floored at ``max(reg_covar,
    tiny)``, precision and log-determinant from the same floored value) and
    the per-iteration factorisation of 'full' and 'tied'."""
    if cov_type in ("diag", "spherical"):
        floor = max(reg_covar, tiny)

        def estats(points, weights, shift, means_c, var, log_w):
            cv = torch.clamp_min(var, floor)
            blocks, tables = _blocked(mesh, (
                means_c, 1.0 / cv, torch.log(cv).sum(dim=1), log_w), "diag")
            st = _scan_estats(points, weights, shift, *tables,
                              chunk_size=chunk_size, mode=mode,
                              pipeline=pipeline, mesh=mesh)
            return _reduce_estats(st, mesh, blocks)
    elif cov_type == "full":
        def estats(points, weights, shift, means_c, cov, log_w):
            p_chol, ldh = _prec_chol_dev(cov, tiny)
            blocks, tables = _blocked(mesh, (means_c, p_chol, ldh, log_w),
                                      "full")
            st = _scan_estats_full(points, weights, shift, *tables,
                                   chunk_size=chunk_size, pipeline=pipeline,
                                   mesh=mesh)
            return _reduce_estats(st, mesh, blocks)
    else:
        def estats(points, weights, shift, means_c, cov, log_w):
            p_chol, ldh = _prec_chol_dev(cov, tiny)
            blocks, tables = _blocked(
                mesh, (means_c @ p_chol, p_chol, ldh, log_w), "tied")
            st = _scan_estats_tied(points, weights, shift, *tables,
                                   chunk_size=chunk_size, pipeline=pipeline,
                                   mesh=mesh)
            return _reduce_estats(st, mesh, blocks)
    return estats


def _m_step_fn(cov_type: str, reg_covar: float, tiny: float,
               pi_floor: float) -> Callable:
    """``(stats, w_total, T) -> (mu, cov, log_w)``: the device M-step in the
    accumulation dtype (the reference's ``_diag_m_step`` and the M-step
    bodies of its 'full' and 'tied' loops).  ``R`` is floored at ``10
    tiny``, the variances and the covariance diagonals at ``max(reg_covar,
    tiny)`` after adding ``reg_covar``, the mixing weights at ``pi_floor``;
    'spherical' carries its variance broadcast over D."""
    floor = max(reg_covar, tiny)

    def weights_of(R, w_total):
        pi = torch.clamp_min(R / torch.clamp_min(w_total, pi_floor),
                             pi_floor)
        return torch.log(pi / pi.sum())

    def m_step(st, w_total, T):
        Rc = torch.clamp_min(st.resp_sum, 10 * tiny)
        mu = st.xsum / Rc[:, None]
        if cov_type in ("diag", "spherical"):
            cov = torch.clamp_min(st.x2sum / Rc[:, None] - mu ** 2
                                  + reg_covar, floor)
            if cov_type == "spherical":
                cov = cov.mean(dim=-1, keepdim=True).expand_as(cov)
        else:
            if cov_type == "full":
                cov = st.scatter / Rc[:, None, None] \
                    - mu[:, :, None] * mu[:, None, :]
            else:
                cov = (T - (st.resp_sum[:, None] * mu).T @ mu) \
                    / torch.clamp_min(w_total, pi_floor)
            diag = torch.diagonal(cov, dim1=-2, dim2=-1)
            eye = torch.eye(cov.shape[-1], dtype=torch.bool,
                            device=cov.device)
            cov = torch.where(eye, torch.diag_embed(
                torch.clamp_min(diag + reg_covar, floor)), cov)
        return mu, cov, weights_of(st.resp_sum, w_total)

    return m_step


class _EmMember:
    """One fit's state in a device EM loop: its carried tables (views of
    the loop's storage, at the fit's own k) and its iteration counter,
    convergence baseline, history and flags, each made once so that a
    captured iteration finds them at the same address on every replay.
    The counter runs from ``start`` to at most ``stop`` (both written
    before the first launch): a segment of a checkpointed fit replays the
    graph captured for the whole fit."""

    def __init__(self, estats, m_step, means_c, cov, log_w, *,
                 max_iter: int, tol: float):
        dev, acc = means_c.device, means_c.dtype
        self.estats, self.m_step = estats, m_step
        self.means_c, self.cov, self.log_w = means_c, cov, log_w
        self.max_iter, self.tol = max_iter, float(tol)
        self.prev = torch.zeros((), dtype=acc, device=dev)
        self.hist = torch.zeros((max_iter,), dtype=acc, device=dev)
        self.it = torch.zeros((), dtype=torch.int64, device=dev)
        self.stop = torch.full((), max_iter, dtype=torch.int64, device=dev)
        self.conv = torch.zeros((), dtype=torch.bool, device=dev)
        self.ok = torch.ones((), dtype=torch.bool, device=dev)
        self.running = torch.ones((), dtype=torch.bool, device=dev)
        self.iters = torch.arange(max_iter, device=dev)

    def reset(self, prev0: float, start: int = 0,
              stop: Optional[int] = None) -> None:
        self.prev.fill_(prev0)
        for t in (self.hist, self.conv):
            t.zero_()
        self.it.fill_(start)
        self.stop.fill_(self.max_iter if stop is None else stop)
        self.ok.fill_(True)
        self.running.fill_(True)

    def iterate(self, loop) -> None:
        """One EM iteration, masked by ``running``: the E-step, the M-step,
        the lower bound ``loglik / w_total`` into the history, the test
        ``|ll - prev| < tol`` and the all-finite flag.  Nothing is read to
        the host."""
        active = self.running.clone()
        st = self.estats(loop.points, loop.weights, loop.shift, self.means_c,
                         self.cov, self.log_w)
        mu, cov, log_w = self.m_step(st, loop.w_total, loop.T)
        ll = st.loglik / loop.w_total
        at = (self.iters == self.it) & active
        self.hist.copy_(torch.where(at, ll, self.hist))
        self.means_c.copy_(torch.where(active, mu, self.means_c))
        self.cov.copy_(torch.where(active, cov, self.cov))
        self.log_w.copy_(torch.where(active, log_w, self.log_w))
        self.conv.copy_(torch.where(active, (ll - self.prev).abs() < self.tol,
                                    self.conv))
        self.ok.copy_(torch.where(active, torch.isfinite(ll), self.ok))
        self.prev.copy_(torch.where(active, ll, self.prev))
        self.it.add_(active.to(torch.int64))
        self.running.copy_((self.it < self.stop) & ~self.conv & self.ok)


class _EmLoop(_Replay):
    """The device EM loop of R >= 1 fits over one dataset: every member's
    iteration in one launch (one captured CUDA graph on the card), the loop
    running while any member does.  ``means``, ``cov``, ``log_w`` are the
    stacked storage (R, k, ...), 'tied' (R, D, D); ``ks`` each member's k
    (its rows past k are never read).  ``T`` is the tied total scatter,
    set per fit.  The loop holds the dataset's tensors, not the dataset."""

    def __init__(self, points, weights, mesh, *, cov_type: str, ks,
                 estats_fns, m_step, max_iter: int, tol: float):
        dev, d = points.device, points.shape[1]
        acc = points.dtype
        k_pad, R = max(ks), len(ks)
        self.points, self.weights, self.mesh = points, weights, mesh
        self.max_iter = max_iter
        self.w_total = all_reduce(weights.to(acc).sum().reshape(1), mesh,
                                  (DATA_AXIS,))[0]
        self.shift = torch.zeros((d,), dtype=acc, device=dev)
        self.T = torch.zeros((d, d), dtype=acc, device=dev) \
            if cov_type == "tied" else None
        self.means = torch.zeros((R, k_pad, d), dtype=acc, device=dev)
        self.cov = torch.zeros(
            (R, d, d) if cov_type == "tied" else
            (R, k_pad, d, d) if cov_type == "full" else (R, k_pad, d),
            dtype=acc, device=dev)
        self.log_w = torch.zeros((R, k_pad), dtype=acc, device=dev)
        self.members = [
            _EmMember(estats_fns[r], m_step, self.means[r, :k],
                      self.cov[r] if cov_type == "tied" else self.cov[r, :k],
                      self.log_w[r, :k], max_iter=max_iter, tol=tol)
            for r, k in enumerate(ks)]
        self.running = torch.ones((), dtype=torch.bool, device=dev)
        self.graph = None
        self.graph_launches = {}

    def iterate(self) -> None:
        for m in self.members:
            m.iterate(self)
        self.running.copy_(torch.stack([m.running for m in self.members])
                           .any())

    def reset(self, shift, means0, cov0, log_w0, prev0, start: int = 0,
              stop: Optional[int] = None) -> None:
        """The fit's starting point: the stacked tables (their padding
        rows too), the shift, for 'tied' the total scatter, and the
        iterations ``start .. stop - 1`` to run."""
        self.shift.copy_(shift)
        self.means.copy_(means0)
        self.cov.copy_(cov0)
        self.log_w.copy_(log_w0)
        if self.T is not None:
            self.T.copy_(total_scatter(self.points, self.weights, self.shift,
                                       self.mesh))
        for m in self.members:
            m.reset(prev0, start, stop)
        self.running.fill_(True)


def _em_loop(ds, *, cov_type: str, mode: str, chunks, ks, max_iter: int,
             tol: float, reg_covar: float, pipeline: int) -> _EmLoop:
    """The device EM loop of the members at ``ks`` (chunks ``chunks``) on
    the dataset ``ds``, over its mesh: every table it is built from is
    named by its arguments, the memo key of ``make_gmm_multi_fit_fn``."""
    tiny, pi_floor = _floor_tiny(ds.points.dtype)
    estats = [_estats_fn(cov_type, mode, c, pipeline, ds.mesh, reg_covar,
                         tiny) for c in chunks]
    return _EmLoop(ds.points, ds.weights, ds.mesh, cov_type=cov_type,
                   ks=list(ks), estats_fns=estats,
                   m_step=_m_step_fn(cov_type, reg_covar, tiny, pi_floor),
                   max_iter=max_iter, tol=tol)


class GmmFitResult(NamedTuple):
    """What the device EM loop hands back to the host, once per fit."""

    means_c: torch.Tensor     # (k, D) centered, accumulation dtype
    cov: torch.Tensor         # (k, D), (k, D, D) 'full', (D, D) 'tied'
    log_w: torch.Tensor       # (k,)
    n_iter: int               # iterations that ran
    ll_hist: np.ndarray       # (n_iter,) float64 of the recorded bounds
    converged: bool
    prev: float               # the convergence baseline at the end


@_cost.program(loop=True)
def make_gmm_fit_fn(mesh=None, *, chunk_size: int, max_iter: int,
                    tol: float, reg_covar: float, cov_type: str = "diag",
                    mode: str = "torch", pipeline: int = 0) -> Callable:
    """The device EM loop: ``fit(ds, shift, means0_c, cov0, log_w0, prev0)
    -> GmmFitResult``.

    Counterpart of the JAX package's ``make_gmm_fit_fn``,
    ``make_gmm_fit_full_fn`` and ``make_gmm_fit_tied_fn`` (their
    ``lax.while_loop`` becomes a replayed CUDA graph of one iteration).
    Per iteration: the E-step (one launch of ``diag_estep`` for float32
    'diag' and 'spherical' in ``mode='kernel'``, else the torch pass;
    'full' and 'tied' factor their carried covariance first), the M-step
    in the accumulation dtype (the host loop's is float64 on the host: the
    two loops agree by tolerance), the lower bound ``loglik / w_total`` and
    ``|ll - prev| < tol``.  It stops at ``max_iter``, on convergence, or at
    the iteration whose log-likelihood is not finite (the caller raises).

    ``means0_c`` (k, D) centered, ``cov0`` (k, D) variances ('spherical'
    broadcast over D), (k, D, D) 'full' or (D, D) 'tied', ``log_w0`` (k,),
    all in the points' dtype; ``prev0`` seeds the convergence baseline
    (``-inf`` fresh, the last lower bound on resume).  ``start`` and
    ``stop`` (default 0 and ``max_iter``) run iterations ``start .. stop -
    1`` of the fit: a segment of a checkpointed fit hands the next one its
    carry tables as they are (tensors in the accumulation dtype, never a
    host cast) and its baseline ``prev``, so the segments give the bits of
    one run.  The loop's state
    and its captured graph are kept with the dataset (``Dataset.memo``),
    once per shape and setting, so later fits on it replay them; a run
    that fails before its iteration was captured leaves none.  Under a
    ``mesh`` the statistics reduce over the data axis inside the
    iteration; on CUDA tensors the captured graph holds that collective,
    which needs NCCL."""
    if cov_type not in COV_TYPES:
        raise ValueError(f"unknown covariance type {cov_type!r}")
    if mode == "kernel" and cov_type not in ("diag", "spherical"):
        raise ValueError(f"the E-step kernel has no {cov_type!r} form")
    multi = make_gmm_multi_fit_fn(
        mesh, chunk_sizes=[chunk_size], max_iter=max_iter, tol=tol,
        reg_covar=reg_covar, cov_type=cov_type, mode=mode, pipeline=pipeline)

    def fit(ds, shift, means0, cov0, log_w0, prev0, start: int = 0,
            stop: Optional[int] = None) -> GmmFitResult:
        res = multi(ds, shift, means0[None], cov0[None], log_w0[None],
                    prev0=prev0, ks=[means0.shape[0]], start=start,
                    stop=stop)
        n = int(res.n_iters[0])
        return GmmFitResult(res.means_c[0], res.cov[0], res.log_w[0], n,
                            res.ll_hist[0, :n], bool(res.converged[0]),
                            float(res.ll_hist[0, n - 1]) if n
                            else float(prev0))

    return fit


class GmmMultiFitResult(NamedTuple):
    """What :func:`make_gmm_multi_fit_fn` hands back: every member's state
    (their tables padded to k_max, the padding rows as they came in)."""

    means_c: torch.Tensor        # (R, k_max, D)
    cov: torch.Tensor            # (R, k_max, D[, D]) or (R, D, D) 'tied'
    log_w: torch.Tensor          # (R, k_max)
    n_iters: np.ndarray          # (R,)
    ll_hist: np.ndarray          # (R, max_iter), zeros past n_iters
    converged: np.ndarray        # (R,) bool
    final_lls: np.ndarray        # (R,) last recorded bound, -inf if not finite
    best: int                    # argmax of final_lls, the first of equal
    final_scores: Optional[np.ndarray]   # (R,) fresh bounds (``score``)


@_cost.program(loop=True)
def make_gmm_multi_fit_fn(mesh=None, *, chunk_sizes: Sequence[int],
                          max_iter: int, tol: float, reg_covar: float,
                          cov_type: str = "diag", mode: str = "torch",
                          pipeline: int = 0,
                          return_scores: bool = False) -> Callable:
    """R fits in one device EM loop: ``fit(ds, shift, means0 (R, k_max, D),
    cov0, log_w0 (R, k_max), *, ks, prev0=-inf) -> GmmMultiFitResult``.

    Counterpart of the JAX package's ``make_gmm_multi_fit_fn`` (``n_init``
    restarts, and with ``k_reals`` the members of a sweep over k).  Member
    r is the single fit's iteration at its own k = ``ks[r]``, over the
    shared points, with its own chunk ``chunk_sizes[r]`` (one chunk size
    for every member when one is given): it reads only its
    first ``ks[r]`` rows, so a member padded to k_max with the reference's
    inert components (zero mean, unit variance, ``-inf`` log-weight) gives
    the bits of its single fit, and the padding stays as it came in.  The
    members run one after another in each launch (one captured graph); a
    member that converges or goes non-finite stops moving, and the loop
    ends when every member has stopped or at ``max_iter``.  ``final_lls``
    is each member's last recorded lower bound (``-inf`` when not finite:
    such a member cannot win); ``best`` the highest.  With
    ``return_scores`` one more E pass per member scores its final
    parameters (``final_scores``, the quantity BIC and AIC are defined
    on)."""
    if cov_type not in COV_TYPES:
        raise ValueError(f"unknown covariance type {cov_type!r}")
    if mode not in GMM_MODES:
        raise ValueError(f"unknown E-step mode: {mode!r}")

    def fit(ds, shift, means0, cov0, log_w0, *, ks,
            prev0: float = -np.inf, start: int = 0,
            stop: Optional[int] = None) -> GmmMultiFitResult:
        _check_backend(mesh, ds)
        if ds.mesh is not mesh:
            raise ValueError(f"the dataset was placed with mesh="
                             f"{ds.mesh!r}, the loop built for {mesh!r}")
        R = len(ks)
        chunks = list(chunk_sizes) if len(chunk_sizes) == R \
            else [chunk_sizes[0]] * R
        key = ("gmm_loop", cov_type, mode, tuple(chunks), tuple(ks),
               max_iter, float(tol), float(reg_covar), pipeline)
        loop = ds.memo(key, lambda: _em_loop(
            ds, cov_type=cov_type, mode=mode, chunks=chunks, ks=ks,
            max_iter=max_iter, tol=tol, reg_covar=reg_covar,
            pipeline=pipeline))
        stop = max_iter if stop is None else stop

        def run():
            loop.reset(shift, means0, cov0, log_w0, prev0, start, stop)
            loop._drive(IN_FLIGHT, stop - start)

        _run_evicting(ds, key, loop, run)
        members = loop.members
        prev = np.array([float(m.prev) for m in members])
        final = np.where(np.isfinite(prev), prev, -np.inf)
        scores = None
        if return_scores:
            scores = []
            for m in members:
                st = m.estats(loop.points, loop.weights, loop.shift,
                              m.means_c, m.cov, m.log_w)
                s = float(st.loglik / loop.w_total)
                scores.append(s if np.isfinite(s) else -np.inf)
            scores = np.asarray(scores, np.float64)
        return GmmMultiFitResult(
            loop.means.clone(), loop.cov.clone(), loop.log_w.clone(),
            np.array([int(m.it) - start for m in members]),
            np.stack([_host_copy(m.hist[start:]) for m in members]),
            np.array([bool(m.conv) for m in members]), final,
            int(np.argmax(final)), scores)

    return fit
