"""Device-resident dataset for one device.

One-device counterpart of ``kmeans_tpu/parallel/sharding.py``
(``ShardedDataset``, ``to_device``, ``choose_chunk_size``): the points and
their per-row weights are placed on the device once and stay there for the
whole fit.  When the data came from the host, the host copy is kept, which
makes row sampling (Forgy seeding, empty-cluster resampling) a host draw
with the same NumPy generators as the JAX package: the same seed picks the
same rows in both.  Without a host copy the rows are drawn on the device by
:func:`permuted_draws`, the one engine of the host loop and the device loop.
No padding is needed: the torch passes take a short last chunk and the
kernels mask their own ragged edge.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

#: Below this many (n * k) elements the whole dataset is one chunk.
SINGLE_CHUNK_ELEMS = 1 << 26


def choose_chunk_size(n: int, k: int, d: int) -> int:
    """Rows per chunk of the plain torch pass: the chunk exists only to bound
    the live (chunk, k) distance temporary.  One chunk when n * k is small,
    else about 2^25 tile elements, at most 2^17 rows, a multiple of 8."""
    if n * max(k, 1) <= SINGLE_CHUNK_ELEMS:
        return int(max(128, -(-n // 8) * 8))
    chunk = max(128, min(n, (1 << 25) // max(k, 1), 1 << 17))
    return int(max(8, (chunk // 8) * 8))


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a NumPy dtype (float32 or float64)."""
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def _validate_sample_weight(sample_weight, n: int, dtype) -> np.ndarray:
    """Shape (n,), finite, non-negative; cast to the dataset dtype."""
    sw = np.asarray(sample_weight, dtype=dtype)
    if sw.shape != (n,):
        raise ValueError(
            f"sample_weight must have shape ({n},), got {sw.shape}")
    if np.any(sw < 0) or not np.all(np.isfinite(sw)):
        raise ValueError("sample_weight must be finite and >= 0")
    return sw


#: Steps of the keyed bijection behind :func:`permuted_draws`; each step
#: XORs one half of the index with a hash of the other half and its key.
PERMUTE_STEPS = 6
#: Passes of cycle walking before a draw is given up.  The walk runs on a
#: domain less than twice the candidates, so a draw still outside after
#: this many passes has probability below 2^-64 (2^-64 for two candidates,
#: (3/4)^64 for one, which :func:`permuted_draws` does not walk).
WALK_LIMIT = 64
_M31 = 0x7FFFFFFF


def draw_keys(seed_seq) -> np.ndarray:
    """The keys of one permutation: ``PERMUTE_STEPS`` words of 31 bits from
    ``np.random.SeedSequence(seed_seq)``, int64."""
    words = np.random.SeedSequence(seed_seq).generate_state(PERMUTE_STEPS)
    return words.astype(np.int64) & _M31


def _hash31(v: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """A 31-bit mix of ``v`` (< 2^31) and ``key``.  Every product is of a
    31-bit value and a 30-bit constant, so int64 never overflows."""
    h = (v ^ key) & _M31
    h = (h * 0x2C1B3C6D) & _M31
    h = h ^ (h >> 15)
    h = (h * 0x297A2D39) & _M31
    return h ^ (h >> 13)


def _permute(x: torch.Tensor, keys: torch.Tensor, lo_bits: int,
             hi_bits: int) -> torch.Tensor:
    """A keyed bijection of ``[0, 2^(lo_bits + hi_bits))``: each step XORs
    one half with a hash of the other, so each step, and the whole, can be
    undone.  ``keys`` (..., PERMUTE_STEPS, 1) broadcasts against ``x``."""
    hi, lo = x >> lo_bits, x & ((1 << lo_bits) - 1)
    for step in range(PERMUTE_STEPS):
        key = keys[..., step, :]
        if step % 2 == 0:
            hi = hi ^ (_hash31(lo, key) & ((1 << hi_bits) - 1))
        else:
            lo = lo ^ (_hash31(hi, key) & ((1 << lo_bits) - 1))
    return (hi << lo_bits) | lo


def permuted_draws(n_pos: int, j: torch.Tensor,
                   keys: torch.Tensor) -> torch.Tensor:
    """Draw ``j`` (int64, any shape) of a keyed pseudo-random permutation of
    ``[0, n_pos)``: distinct values for distinct ``j`` under one key, and
    draw ``j`` does not depend on how many are drawn.  ``keys`` is
    (PERMUTE_STEPS,) for one permutation, or (T, PERMUTE_STEPS) for one
    per row of a (T, m) ``j``.  ``-1`` where ``j >= n_pos`` (the candidates
    are used up) or where the walk did not end (see ``WALK_LIMIT``).

    The bijection runs on ``[0, 2^b)``, ``2^b`` the least power of two not
    below ``n_pos`` (at least 4); a value at or above ``n_pos`` is mapped
    again (cycle walking) until it falls inside, which keeps the map a
    bijection of ``[0, n_pos)``.  Fixed shapes, int64 torch ops only, no
    generator: the same draws on every device.  The walk stops as soon as
    every value is inside, which reads one flag to the host per pass."""
    keys = keys.to(device=j.device, dtype=torch.int64)[..., None]
    live = j < n_pos
    if n_pos == 1:
        return torch.where(live, torch.zeros_like(j), torch.full_like(j, -1))
    bits = max(2, (n_pos - 1).bit_length())
    lo_bits = bits // 2
    hi_bits = bits - lo_bits
    x = _permute(torch.where(live, j, torch.zeros_like(j)), keys, lo_bits,
                 hi_bits)
    for _ in range(WALK_LIMIT - 1):
        outside = x >= n_pos
        if not bool(outside.any()):
            break
        x = torch.where(outside, _permute(x, keys, lo_bits, hi_bits), x)
    return torch.where(live & (x < n_pos), x, torch.full_like(x, -1))


class Dataset:
    """Points (n, D) and weights (n,) on one device, with an optional host
    copy of both (``host_weights`` None means all ones).

    :meth:`memo` keeps what is computed once per dataset and read by every
    fit on it (``sum w ||x||^2``, the positive-weight rows, the device
    loop's captured graphs); the points and weights must not change while
    it holds them."""

    def __init__(self, points: torch.Tensor, weights: torch.Tensor,
                 host: Optional[np.ndarray] = None,
                 host_weights: Optional[np.ndarray] = None):
        self.points = points
        self.weights = weights
        self.n, self.d = points.shape
        self._host = host
        self._host_weights = host_weights
        self._memo: dict = {}

    def memo(self, key, make: Callable):
        """``make()``, computed at the first call for ``key`` and kept."""
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    @property
    def device(self) -> torch.device:
        return self.points.device

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(str(self.points.dtype).replace("torch.", ""))

    @property
    def host(self) -> Optional[np.ndarray]:
        """Host copy of the data, when the dataset was built from one."""
        return self._host

    @property
    def host_weights(self) -> Optional[np.ndarray]:
        return self._host_weights

    def positive_index(self) -> torch.Tensor:
        """Indices (int64, on the device) of the rows with weight > 0: the
        candidates of the device draws.  Found once per dataset."""
        return self.memo("positive_index", lambda: torch.nonzero(
            self.weights > 0).flatten())

    def positive_rows(self) -> np.ndarray:
        """Indices of rows with weight > 0: the candidates for seeding and
        for empty-cluster resampling (a zero-weight row must never become a
        centroid)."""
        if self._host is not None:
            if self._host_weights is None:
                return np.arange(self.n)
            return np.flatnonzero(self._host_weights > 0)
        return self.positive_index().cpu().numpy()

    def take(self, idx) -> np.ndarray:
        """Rows by index, as a host array."""
        if self._host is not None:
            return np.asarray(self._host[idx])
        index = torch.as_tensor(np.asarray(idx), device=self.device)
        return self.points[index].cpu().numpy()

    def sample_positive_rows(self, m: int, seed_seq) -> np.ndarray:
        """Up to ``m`` distinct positive-weight rows, uniformly, seeded by
        ``seed_seq`` (entropy for ``np.random.SeedSequence``).

        With a host copy this is the JAX package's host draw, row for row.
        Without one the draws are :func:`permuted_draws` under
        ``draw_keys(seed_seq)``, the engine of the device loop's refill:
        deterministic for a seed, the same rows on both loops, but other
        rows than the JAX package's device-side draw would pick."""
        if self._host is not None:
            rng = np.random.default_rng(seed_seq)
            candidates = self.positive_rows()
            take = min(m, len(candidates))
            idx = candidates[rng.choice(len(candidates), size=take,
                                        replace=False)]
            return self.take(idx)
        pos = self.positive_index()
        take = min(m, pos.numel())
        if take == 0:
            return np.empty((0, self.d))
        draws = permuted_draws(
            pos.numel(), torch.arange(take, device=self.device),
            torch.from_numpy(draw_keys(seed_seq)))
        rows = pos[draws[draws >= 0]]
        return self.points[rows].cpu().numpy().astype(np.float64)


def to_device(X, device: torch.device, dtype, sample_weight=None) -> Dataset:
    """Place (n, D) data on ``device`` once; a :class:`Dataset` passes
    through.  Host data (NumPy, lists) keeps its host copy; a tensor that
    already lies on ``device`` is used as it is and no host copy is made.
    ``sample_weight`` (n,) makes every statistic weighted."""
    dtype = np.dtype(dtype)
    tdtype = torch_dtype(dtype)
    if isinstance(X, Dataset):
        if X.device != device:
            raise ValueError(f"Dataset is on {X.device}, model on {device}")
        if X.dtype != dtype:
            raise ValueError(f"Dataset dtype {X.dtype} != model dtype "
                             f"{dtype}")
        if sample_weight is not None:
            raise ValueError("pass sample_weight when caching the dataset, "
                             "not on a pre-built Dataset")
        return X
    if isinstance(X, torch.Tensor) and X.device == device:
        host, shape = None, tuple(X.shape)
    else:
        if isinstance(X, torch.Tensor):
            X = X.cpu().numpy()
        host = np.ascontiguousarray(np.asarray(X, dtype=dtype))
        shape = host.shape
    if len(shape) != 2:
        raise ValueError(f"X must be 2-D (n, D), got shape {shape}")
    points = (X.to(tdtype).contiguous() if host is None
              else torch.from_numpy(host).to(device))
    if sample_weight is None:
        sw = None
        weights = torch.ones(shape[0], dtype=tdtype, device=device)
    else:
        if isinstance(sample_weight, torch.Tensor):
            sample_weight = sample_weight.cpu().numpy()
        sw = _validate_sample_weight(sample_weight, shape[0], dtype)
        weights = torch.from_numpy(sw).to(device)
    # Without a host copy, seeding and resampling read the device's weights.
    return Dataset(points, weights, host=host,
                   host_weights=sw if host is not None else None)


# ------------------------------------------------------------ the EM pass

#: Element budget of the (chunk, k) log-density tile of the plain EM pass,
#: and its row cap: the JAX package's ``EM_CHUNK_BUDGET`` and
#: ``EM_MAX_CHUNK`` (``models/gmm.py``).
EM_CHUNK_BUDGET = 1 << 23
EM_MAX_CHUNK = 32768


def choose_em_chunk(n: int, k: int) -> int:
    """Rows per chunk of the plain torch E pass and of the predict pass:
    a (chunk, k) tile of at most ``EM_CHUNK_BUDGET`` elements, at most
    ``EM_MAX_CHUNK`` and at least 128 rows, a multiple of 8."""
    chunk = max(128, min(max(n, 1), EM_CHUNK_BUDGET // max(k, 1),
                         EM_MAX_CHUNK))
    return int(chunk // 8 * 8)


def weighted_mean(points: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """The mixture's centering shift, the JAX package's ``_mean_jit``:
    ``(w @ x) / max(sum w, tiny)`` over the points rounded to float32, in
    the weights' dtype, with the total weight summed in float32.  The guard
    is float32's ``tiny``, not 1.0: clamping at 1.0 would scale the shift
    down whenever the total weight is below 1."""
    x = points.to(torch.float32).to(weights.dtype)
    total = torch.clamp_min(weights.to(torch.float32).sum(),
                            torch.finfo(torch.float32).tiny)
    return (weights @ x) / total
