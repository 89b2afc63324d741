"""Product quantization: m subspace codebooks trained in one device loop.

Counterpart of the JAX package's ``models/pq.py``.  Product quantization
(Jégou et al., PAMI 2011) splits the feature space into ``m`` contiguous
subspaces and learns an independent k-means codebook per subspace; a row
is stored as its ``m`` codeword indices (``m`` bytes at k <= 256), and
distances to compressed rows are answered by per-subspace lookup-table
sums (ADC, asymmetric distance computation).

The trainer is one call of ``parallel.distributed.make_multi_fit_fn(
member_points=True, mode='matmul')``: the m subspace problems are the
members of one device loop, each training against its own (n, d_sub)
rows, one launch of every member per iteration (one captured CUDA graph
on the card).  Each member runs the single fit's step over its rows, so
member j is bit-equal to a standalone ``KMeans`` fit of subspace j seeded
with ``_member_seeds(m)[j]`` (held by tests/test_torch_pq.py and by
``chip_smoke.py``'s phase ``pq``).  The fit runs the chunked torch pass
('matmul'): no kernel is on its path, as in the JAX package.

``adc_assign`` answers nearest-row queries against a PQ-compressed table
with the bf16 guard's error model (``ops.assign.BF16_GUARD_RTOL``): the
float32 ADC sum decides every query whose argmin margin clears the rtol of
its distance scale, and the flagged near-ties re-resolve against the
decoded table in float64, so the labels are those of the exact
decoded-table argmin by construction.  Encoding and the ADC pass run in
torch on the quantizer's device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from kmeans_tpu_torch.models.init import resolve_init
from kmeans_tpu_torch.models.kmeans import resolve_device
from kmeans_tpu_torch.ops.assign import BF16_GUARD_RTOL
from kmeans_tpu_torch.parallel import distributed as dist
from kmeans_tpu_torch.parallel.mesh import check_mesh, mesh_shape
from kmeans_tpu_torch.parallel.sharding import Dataset, to_device
from kmeans_tpu_torch.utils.validation import check_finite_array

__all__ = ["ProductQuantizer", "default_subspaces", "pq_state"]

#: Query rows per chunk of ``encode`` and ``adc_assign``'s passes.
_QUERY_CHUNK = 1 << 14


def default_subspaces(d: int) -> int:
    """Largest m <= 8 dividing d (PQ needs equal contiguous slices);
    1 when d is prime to 2..8 — PQ degenerates to plain VQ there."""
    for m in range(min(8, d), 0, -1):
        if d % m == 0:
            return m
    return 1  # pragma: no cover — m=1 always divides


class ProductQuantizer:
    """m independent per-subspace k-means codebooks, trained in ONE device
    loop over the members' own rows.

    Parameters: ``m`` subspaces ('auto': largest divisor of d up to 8),
    ``k`` codewords per subspace (<= 256 keeps codes at one byte each),
    and the familiar fit knobs.  ``empty_cluster`` is pinned to 'keep' (a
    subspace codeword with no mass keeps its old value).  ``device`` and
    ``mesh`` as in ``KMeans``: ``None`` is the card.

    Fitted attributes: ``codebooks_`` (m, k, d_sub), ``n_iters_`` (m,),
    ``subspace_inertias_`` (m,) — each member's true final inertia on its
    own subspace — ``counts_`` (m, k) and ``plan_`` (``obs.memory
    .plan_fit`` of one subspace fit).
    """

    def __init__(self, m="auto", k: int = 256, max_iter: int = 25,
                 tolerance: float = 1e-4, seed: int = 42, *,
                 init="k-means++", dtype=None,
                 mesh=None, chunk_size: Optional[int] = None,
                 verbose: bool = False, device=None):
        if m != "auto" and int(m) < 1:
            raise ValueError(f"m must be 'auto' or an int >= 1, got {m}")
        self.m = m if m == "auto" else int(m)
        if int(k) < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = int(k)
        self.max_iter = int(max_iter)
        self.tolerance = float(tolerance)
        self.seed = int(seed)
        self.init = init
        self.dtype = np.dtype(dtype) if dtype is not None \
            else np.dtype(np.float32)
        if self.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
            raise ValueError(f"dtype must be float32 or float64, got "
                             f"{self.dtype}")
        self.mesh = check_mesh(mesh)
        self.chunk_size = chunk_size
        self.verbose = verbose
        self.device = resolve_device(device)
        self.codebooks_: Optional[np.ndarray] = None
        self.n_iters_: Optional[np.ndarray] = None
        self.subspace_inertias_: Optional[np.ndarray] = None
        self.counts_: Optional[np.ndarray] = None
        self.plan_: Optional[dict] = None
        self.m_: Optional[int] = None
        self.d_: Optional[int] = None
        self.d_sub_: Optional[int] = None

    # ------------------------------------------------------------- fit

    def _member_seeds(self, m: int) -> List[int]:
        """One derived init seed per subspace — the restart-seed
        discipline (distinct streams, deterministic in ``seed``)."""
        return [int(s) for s in
                np.random.SeedSequence(self.seed).generate_state(m)]

    def _member_datasets(self, sub: np.ndarray):
        """``(points (m, n, d_sub), datasets)``: each subspace's rows as
        the dataset a standalone ``KMeans`` of this device and mesh places
        (the rank's block under a mesh), and their points stacked.  On one
        device the datasets are views of the stacked tensor."""
        if self.mesh is None:
            pts = torch.from_numpy(sub).to(self.device)
            weights = torch.ones(sub.shape[1], dtype=pts.dtype,
                                 device=self.device)
            return pts, [Dataset(pts[j], weights, host=sub[j])
                         for j in range(sub.shape[0])]
        members = [to_device(sub[j], self.device, self.dtype,
                             mesh=self.mesh, chunk=self.chunk_size,
                             k_hint=self.k) for j in range(sub.shape[0])]
        return torch.stack([ds.points for ds in members]), members

    def fit(self, X) -> "ProductQuantizer":
        X = np.asarray(X.cpu().numpy() if isinstance(X, torch.Tensor)
                       else X, dtype=self.dtype)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D (n, D), got shape {X.shape}")
        check_finite_array(X, "Data contains NaN or Inf values")
        n, d = X.shape
        m = default_subspaces(d) if self.m == "auto" else self.m
        if d % m:
            raise ValueError(
                f"m={m} must divide d={d} into equal contiguous "
                f"subspaces (PQ's split; pad the features or pick a "
                f"divisor)")
        if n < self.k:
            raise ValueError(f"Not enough data points ({n}) to train "
                             f"{self.k} codewords per subspace")
        d_sub = d // m
        data_shards, model_shards = mesh_shape(self.mesh)
        sub = np.ascontiguousarray(
            X.reshape(n, m, d_sub).transpose(1, 0, 2))   # (m, n, d_sub)
        points, members = self._member_datasets(sub)
        chunk = self.chunk_size or members[0].effective_chunk(self.k)
        from kmeans_tpu_torch.obs.memory import plan_fit
        self.plan_ = plan_fit(
            "kmeans", n, d_sub, self.k, data_shards=data_shards,
            model_shards=model_shards, dtype=str(self.dtype),
            chunk=chunk, device=self.device)
        seeds = self._member_seeds(m)
        inits = np.stack([
            np.asarray(resolve_init(self.init, members[j], self.k,
                                    seeds[j], validate=False,
                                    mode="matmul"),
                       np.float64).astype(self.dtype)
            for j in range(m)])
        fit_fn = dist.make_multi_fit_fn(
            self.mesh, chunk_size=chunk, mode="matmul", k_real=self.k,
            max_iter=self.max_iter, tolerance=float(self.tolerance),
            empty_policy="keep", n_init=m, history_sse=True,
            return_all=True, member_points=True)
        res = fit_fn(members[0], torch.from_numpy(inits).to(self.device),
                     seeds, points)
        self.codebooks_ = np.asarray(
            res.centroids.to(torch.float64).cpu().numpy()).astype(
                self.dtype)
        self.n_iters_ = np.asarray(res.n_iters, np.int64)
        self.subspace_inertias_ = np.asarray(res.inertias, np.float64)
        self.counts_ = np.asarray(res.counts, np.float64)
        self.m_, self.d_, self.d_sub_ = m, d, d_sub
        return self

    # ---------------------------------------------------- encode/decode

    def _check_fitted(self):
        if self.codebooks_ is None:
            raise ValueError("ProductQuantizer must be fitted first")

    def _code_dtype(self):
        return np.uint8 if self.k <= 256 else (
            np.uint16 if self.k <= 65536 else np.uint32)

    def _rows(self, X, name: str) -> torch.Tensor:
        """(n, d) rows as a float64 tensor on the quantizer's device."""
        if isinstance(X, torch.Tensor):
            X = X.detach().cpu().numpy()
        X = np.asarray(X, np.float64)
        if X.ndim != 2 or X.shape[1] != self.d_:
            raise ValueError(f"{name} must be (n, {self.d_}), got "
                             f"{X.shape}")
        return torch.from_numpy(np.ascontiguousarray(X)).to(self.device)

    def _books(self, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            self.codebooks_)).to(self.device, dtype)

    def encode(self, X) -> np.ndarray:
        """(n, d) rows -> (n, m) per-subspace codeword indices (exact
        float64 per-subspace argmin; ties to the lowest index, the dense
        argmin rule)."""
        self._check_fitted()
        X = self._rows(X, "X")
        books = self._books(torch.float64)
        cb2 = (books * books).sum(dim=2)                      # (m, k)
        codes = torch.empty((X.shape[0], self.m_), dtype=torch.int64,
                            device=self.device)
        for lo in range(0, X.shape[0], _QUERY_CHUNK):
            for j in range(self.m_):
                xj = X[lo:lo + _QUERY_CHUNK,
                       j * self.d_sub_:(j + 1) * self.d_sub_]
                d2 = ((xj * xj).sum(dim=1)[:, None]
                      - 2.0 * xj @ books[j].T + cb2[j][None, :])
                codes[lo:lo + _QUERY_CHUNK, j] = torch.argmin(d2, dim=1)
        return codes.cpu().numpy().astype(self._code_dtype())

    def decode(self, codes) -> np.ndarray:
        """(n, m) codes -> (n, d) reconstruction (per-subspace codeword
        concatenation, float64)."""
        self._check_fitted()
        codes = np.asarray(codes)
        return np.concatenate(
            [np.asarray(self.codebooks_[j], np.float64)[codes[:, j]]
             for j in range(self.m_)], axis=1)

    def compression_ratio(self) -> float:
        """Stored bytes per row, original vs coded."""
        self._check_fitted()
        return (self.d_ * self.dtype.itemsize) \
            / (self.m_ * np.dtype(self._code_dtype()).itemsize)

    # ------------------------------------------------------ ADC serving

    def adc_assign(self, queries, codes, *,
                   tie_rtol: float = BF16_GUARD_RTOL):
        """Nearest compressed-table row per query: ``(labels int32,
        n_corrected)``.

        The float32 ADC pass (per-subspace lookup table, then the sum of
        the gathered entries) decides every query whose argmin margin
        clears ``tie_rtol`` of its distance scale ``|q|^2 + max_i
        |row_i|^2`` — the bf16 guard's error model.  Flagged near-ties
        re-resolve by one exact float64 pass against the DECODED table, so
        labels equal the exact decoded-table argmin by construction; the
        quantization residual (decoded vs original rows) is the one
        approximation, a property of the stored codes."""
        self._check_fitted()
        Q = self._rows(queries, "queries")
        codes = np.asarray(codes)
        t = codes.shape[0]
        decoded_np = self.decode(codes)
        decoded = torch.from_numpy(decoded_np).to(self.device)
        dec2 = (decoded * decoded).sum(dim=1)
        books = self._books(torch.float32)
        cb2 = (books * books).sum(dim=2)
        cols = torch.from_numpy(codes.astype(np.int64)).to(self.device)
        c2max = dec2.max().to(torch.float32)
        best = torch.empty(Q.shape[0], dtype=torch.int32,
                           device=self.device)
        near_parts = []
        for lo in range(0, Q.shape[0], _QUERY_CHUNK):
            q = Q[lo:lo + _QUERY_CHUNK]
            q32 = q.to(torch.float32)
            approx = torch.zeros((q.shape[0], t), dtype=torch.float32,
                                 device=self.device)
            for j in range(self.m_):
                qj = q32[:, j * self.d_sub_:(j + 1) * self.d_sub_]
                lut = ((qj * qj).sum(dim=1)[:, None]
                       - 2.0 * qj @ books[j].T + cb2[j][None, :])
                approx += lut[:, cols[:, j]]
            b = torch.argmin(approx, dim=1)
            d1 = approx.gather(1, b[:, None])[:, 0]
            masked = approx.scatter(1, b[:, None], float("inf"))
            margin = masked.min(dim=1).values - d1
            scale = (q32 * q32).sum(dim=1) + c2max
            flag = (margin <= tie_rtol * scale) | torch.tensor(
                t < 2, device=self.device)
            near = torch.nonzero(flag)[:, 0]
            if near.numel():
                sub = q[near]
                d2 = ((sub * sub).sum(dim=1)[:, None]
                      - 2.0 * sub @ decoded.T + dec2[None, :])
                b[near] = torch.argmin(d2, dim=1)
            best[lo:lo + q.shape[0]] = b.to(torch.int32)
            near_parts.append(near.numel())
        return best.cpu().numpy(), int(sum(near_parts))

    # ---------------------------------------------------------- serving

    def fitted_state(self) -> dict:
        """Serving handle (the registry contract)."""
        self._check_fitted()
        return {
            "family": "pq",
            "model_class": type(self).__name__,
            "k": int(self.k),
            "d": int(self.d_),
            "dtype": self.dtype.str,
            "stackable": False,
            "normalize_inputs": False,
            "m": int(self.m_),
            "ops": ("encode",),
        }

    @classmethod
    def for_table(cls, table, *, m="auto", k: Optional[int] = None,
                  seed: int = 0, mesh=None, max_iter: int = 25,
                  device=None):
        """Compress a fitted (k_table, d) centroid table: train the
        codebooks ON the table rows and encode them.  Returns
        ``(pq, codes)`` — the serving engine's ``quantize='pq'``
        ingredients."""
        table = np.asarray(table)
        kt, d = table.shape
        k_pq = int(k) if k is not None else min(256, max(2, kt // 4))
        pq = cls(m=m, k=min(k_pq, kt), seed=seed, mesh=mesh,
                 max_iter=max_iter, dtype=table.dtype,
                 device=device).fit(table)
        return pq, pq.encode(table)

    # ------------------------------------------------------- checkpoint

    def _state_dict(self) -> dict:
        return pq_state(self)

    @classmethod
    def _from_state(cls, state: dict, device=None,
                    mesh=None) -> "ProductQuantizer":
        pq = cls(m=state.get("m", "auto"), k=int(state["k"]),
                 max_iter=int(state.get("max_iter", 25)),
                 tolerance=float(state.get("tolerance", 1e-4)),
                 seed=int(state.get("seed", 42)),
                 init=state.get("init", "k-means++"),
                 dtype=np.dtype(str(state["dtype"])), device=device,
                 mesh=mesh)
        if state.get("codebooks_") is not None:
            pq.codebooks_ = np.asarray(state["codebooks_"]).astype(pq.dtype)
            pq.counts_ = np.asarray(state["counts_"], np.float64)
            pq.n_iters_ = np.asarray(state["n_iters_"], np.int64)
            pq.subspace_inertias_ = np.asarray(state["subspace_inertias_"],
                                               np.float64)
            pq.m_, pq.d_, pq.d_sub_ = (int(state["m_"]), int(state["d_"]),
                                       int(state["d_sub_"]))
        return pq


#: Fitted attributes carried across packages (``convert``).
_STATE_ATTRS = ("codebooks_", "counts_", "n_iters_", "subspace_inertias_",
                "m_", "d_", "d_sub_")


def pq_state(pq) -> dict:
    """The state dictionary of a product quantizer of either package, read
    from its attributes (the JAX package's ``ProductQuantizer`` has no
    checkpoint): the constructor's ``m``, ``k``, ``max_iter``,
    ``tolerance``, ``seed``, ``init`` (a callable as 'k-means++') and
    ``dtype``, and the fitted ``codebooks_``, ``counts_``, ``n_iters_``,
    ``subspace_inertias_``, ``m_``, ``d_``, ``d_sub_``."""
    state = {"model_class": "ProductQuantizer", "m": pq.m, "k": int(pq.k),
             "max_iter": int(pq.max_iter), "tolerance": float(pq.tolerance),
             "seed": int(pq.seed),
             "init": pq.init if isinstance(pq.init, str) else "k-means++",
             "dtype": str(pq.dtype)}
    for name in _STATE_ATTRS:
        value = getattr(pq, name)
        state[name] = (value if value is None or isinstance(value, int)
                       else np.asarray(value))
    return state
