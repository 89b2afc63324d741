"""The E-step and the posterior pass of the diagonal Gaussian mixture, on
one device or over the data axis of a mesh.

Counterpart of ``kmeans_tpu/parallel/gmm_step.py`` for the 'diag' and
'spherical' covariance types (``EStats``, ``_log_prob_chunk``,
``_softmax_resp``, ``_diag_stage_fns``, ``estep_chunk``, ``_chunked_epass``
with its serial schedule, ``make_gmm_step_fn``, ``_predict_from_logp``,
``make_gmm_predict_fn``).  Under a mesh each rank runs the pass on its block
of the rows and the statistics are summed over the data axis (one packed
SUM ``all_reduce``), so every rank gets the global ones; the model axis
does not shard a mixture (the fused E-step cannot take its softmax across
blocks of components).

For diagonal Gaussians, with ``a = 1/sigma^2``,

    log N(x | mu_k, sigma_k^2)
      = -0.5 [ sum_d x_d^2 a_kd - 2 sum_d x_d mu_kd a_kd
               + sum_d mu_kd^2 a_kd + sum_d log sigma_kd^2 + D log 2pi ],

so a (chunk, k) log-density tile is two matrix products plus per-component
constants.  The statistics of a pass are

    R_k  = sum_i r_ik            S1_k = sum_i r_ik x_i
    S2_k = sum_i r_ik x_i^2      ll   = sum_i w_i logsumexp_k(...)

with ``r`` the weighted responsibilities; the M-step on the host makes
weights, means and variances of them.

Centering: every pass subtracts a (D,) ``shift`` (the data's weighted mean)
from each chunk and works against shifted means, so that ``S2`` stays at
the data's spread and ``S2/R - mu^2`` does not cancel for data far from the
origin.  No centered copy of the data is made.

``mode='kernel'`` runs the whole pass as one launch of the fused CUDA
kernel (``ops.estep_kernels.diag_estep``; its plain version for tensors on
the CPU); ``mode='torch'`` is the chunked plain pass, in float32 or float64.
The posterior pass (``predict``) has no kernel in either package: its
products are ``torch.matmul`` (float32 products stay float32 unless the
caller turns TF32 on).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from kmeans_tpu_torch.ops.estep_kernels import diag_estep
from kmeans_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce

_LOG2PI = math.log(2.0 * math.pi)

GMM_MODES = ("kernel", "torch")


class EStats(NamedTuple):
    """E-step statistics of one pass (in the centered frame)."""

    resp_sum: torch.Tensor    # (k,)   sum of weighted responsibilities
    xsum: torch.Tensor        # (k, D) responsibility-weighted point sums
    x2sum: torch.Tensor       # (k, D) responsibility-weighted square sums
    loglik: torch.Tensor      # ()     weighted total log-likelihood


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


def _softmax_resp(logp, w):
    """Responsibility softmax of one chunk: ``(resp, lse)`` with
    ``resp = p / sum p * w``."""
    m = logp.max(dim=1).values
    p = torch.exp(logp - m[:, None])
    denom = p.sum(dim=1)
    lse = m + torch.log(denom)
    return p / denom[:, None] * w[:, None], lse


def _diag_stage_fns(means, inv_var, log_det, log_weights):
    """The E pass as two stages: ``logp_fn(xc)`` (the log-density
    products) and ``consume(stats, logp, xc, wc)`` (softmax and moment
    accumulation) — the one implementation of this arithmetic, shared by
    :func:`estep_chunk` and the chunked pass."""

    def logp_fn(xc):
        return _log_prob_chunk(xc, means, inv_var, log_det, log_weights)

    def consume(carry, logp, xc, wc):
        resp, lse = _softmax_resp(logp, wc)
        return EStats(
            carry.resp_sum + resp.sum(dim=0),
            carry.xsum + resp.T @ xc,
            carry.x2sum + resp.T @ (xc * xc),
            carry.loglik + torch.where(wc > 0, lse * wc,
                                       torch.zeros_like(lse)).sum())

    return logp_fn, consume


def _zero_estats(k: int, d: int, dtype, device) -> EStats:
    kw = dict(dtype=dtype, device=device)
    return EStats(torch.zeros((k,), **kw), torch.zeros((k, d), **kw),
                  torch.zeros((k, d), **kw), torch.zeros((), **kw))


def estep_chunk(x, w, means, inv_var, log_det, log_weights) -> EStats:
    """E-statistics of one chunk of (already centered) points."""
    k, d = means.shape
    logp_fn, consume = _diag_stage_fns(means, inv_var, log_det,
                                       log_weights)
    return consume(_zero_estats(k, d, x.dtype, x.device), logp_fn(x), x, w)


def _chunked_epass(points, weights, shift, *, chunk_size: int, logp_fn,
                   consume_fn, init) -> EStats:
    """The chunk loop of the E pass, serial schedule: for each chunk in row
    order, center it, run stage A, then stage B.  The last chunk may be
    short (no padding is needed here)."""
    st = init
    w = weights.to(points.dtype)
    for lo in range(0, points.shape[0], chunk_size):
        xc = points[lo:lo + chunk_size] - shift[None, :]
        st = consume_fn(st, logp_fn(xc), xc, w[lo:lo + chunk_size])
    return st


def _reduce_estats(st: EStats, mesh) -> EStats:
    """The statistics of every block of the data axis, replicated: one SUM
    ``all_reduce`` of the four packed into one buffer."""
    k, d = st.xsum.shape
    flat = all_reduce(torch.cat([st.resp_sum, st.xsum.reshape(-1),
                                 st.x2sum.reshape(-1), st.loglik.reshape(1)]),
                      mesh, (DATA_AXIS,))
    return EStats(flat[:k], flat[k:k + k * d].reshape(k, d),
                  flat[k + k * d:k + 2 * k * d].reshape(k, d),
                  flat[k + 2 * k * d])


def make_gmm_step_fn(mesh=None, *, chunk_size: int,
                     mode: str = "torch") -> Callable:
    """The E-step: ``(points, weights, shift, means_c, inv_var, log_det,
    log_weights) -> EStats`` over all points (every rank's block under a
    ``mesh``), in the frame centered by ``shift`` (``means_c`` must already
    be centered).

    ``mode='kernel'`` is one launch of the fused kernel over the block
    (float32); ``'torch'`` the chunked plain pass."""
    if mode not in GMM_MODES:
        raise ValueError(f"unknown E-step mode: {mode!r}")

    def local(points, weights, shift, means, inv_var, log_det, log_weights):
        if mode == "kernel":
            return EStats(*diag_estep(points, weights, shift, means,
                                      inv_var, log_det, log_weights))
        k, d = means.shape
        logp_fn, consume = _diag_stage_fns(means, inv_var, log_det,
                                           log_weights)
        return _chunked_epass(
            points, weights, shift, chunk_size=chunk_size, logp_fn=logp_fn,
            consume_fn=consume,
            init=_zero_estats(k, d, points.dtype, points.device))

    def step(*args) -> EStats:
        st = local(*args)
        return st if mesh is None else _reduce_estats(st, mesh)

    return step


def _predict_from_logp(logp_fn, points, chunk_size: int):
    """Posterior pass: per chunk, logp by ``logp_fn``, then labels (the
    lowest index among equal maxima), log-responsibilities and the
    per-row log-likelihood ``lse``."""
    n = points.shape[0]
    labels = torch.empty(n, dtype=torch.int32, device=points.device)
    logr, lse = [], []
    for lo in range(0, max(n, 1), chunk_size):     # n = 0: one empty chunk
        logp = logp_fn(points[lo:lo + chunk_size])
        m = logp.max(dim=1).values
        labels[lo:lo + chunk_size] = torch.argmax(logp, dim=1).to(
            torch.int32)
        row_lse = m + torch.log(torch.exp(logp - m[:, None]).sum(dim=1))
        logr.append(logp - row_lse[:, None])
        lse.append(row_lse)
    return labels, torch.cat(logr), torch.cat(lse)


def make_gmm_predict_fn(*, chunk_size: int) -> Callable:
    """The posterior pass: ``(points, shift, means_c, inv_var, log_det,
    log_weights) -> (labels (n,) int32, log_resp (n, k), lse (n,))``, one
    row per row of ``points`` (the rank's block under a mesh: each row
    needs only the replicated tables, so the pass has no collective)."""

    def predict(points, shift, means, inv_var, log_det, log_weights):
        return _predict_from_logp(
            lambda x: _log_prob_chunk(x - shift[None, :], means, inv_var,
                                      log_det, log_weights),
            points, chunk_size)

    return predict
