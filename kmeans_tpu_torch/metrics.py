"""Clustering quality metrics: the geometric scores on the card, the label
scores on the host.

Counterpart of ``kmeans_tpu/metrics.py``.  The internal scores (silhouette,
Calinski-Harabasz, Davies-Bouldin) run in torch ops on a device, the rows in
chunks, distances in the expanded 'matmul' form (``ops.assign``), the
per-cluster reductions as one-hot products, and the silhouette's O(n^2 D)
pass in column blocks (``col_block``) so that nothing of size O(n k) or
O(n^2) is ever whole.  ``batched_criterion_scores`` scores M label sets of
the same rows in the same passes (the sweep's scoring).  Under a ``mesh``
(``parallel.mesh``) each rank takes its block of the rows along the data
axis and the sums meet in one SUM ``all_reduce``; every rank passes the
same arguments and gets the same scores.

Float64 rows are scored in float64, any other in float32 (the JAX package
scores in float32 always).  ``device=None`` is the card (the rank's own
under a mesh), as for the models; ``device='cpu'`` runs on the CPU.

The label scores (adjusted Rand, mutual information, NMI, homogeneity,
completeness and V-measure) are contingency-table reductions in NumPy, the
JAX package's own arithmetic.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kmeans_tpu_torch.models.kmeans import resolve_device
from kmeans_tpu_torch.ops.assign import pairwise_sq_dists
from kmeans_tpu_torch.parallel import mesh as _mesh
from kmeans_tpu_torch.utils.validation import check_finite_array

__all__ = ["silhouette_score", "silhouette_samples",
           "davies_bouldin_score", "calinski_harabasz_score",
           "adjusted_rand_score", "mutual_info_score",
           "normalized_mutual_info_score",
           "homogeneity_completeness_v_measure",
           "batched_criterion_scores"]

#: Passes over the rows that one ``batched_criterion_scores`` call makes,
#: whatever the number of members: silhouette one, Calinski-Harabasz and
#: Davies-Bouldin two (moments, then the scatter about the centroids).
SWEEP_SCORE_DISPATCHES = {"silhouette": 1, "calinski_harabasz": 2,
                          "davies_bouldin": 2}


def _dtype_of(X) -> np.dtype:
    return (np.dtype(np.float64) if np.asarray(X).dtype == np.float64
            else np.dtype(np.float32))


def _as_arrays(X, labels):
    X = np.ascontiguousarray(np.asarray(X, dtype=_dtype_of(X)))
    labels = np.asarray(labels)
    if X.ndim != 2:
        raise ValueError(f"X must be 2-D (n, D), got shape {X.shape}")
    if labels.shape != (X.shape[0],):
        raise ValueError(f"labels must have shape ({X.shape[0]},), got "
                         f"{labels.shape}")
    check_finite_array(X, "Input data contains NaN or Inf values")
    # Compact to 0..k-1 over the ids present (an emptied cluster, or -1
    # noise, must not become a phantom cluster at the origin).
    uniq, enc = np.unique(labels, return_inverse=True)
    k = int(uniq.size)
    if k < 2 or k >= X.shape[0]:
        raise ValueError("metrics need 2 <= n_labels <= n_samples - 1 "
                         f"(got {k} distinct labels, {X.shape[0]} samples)")
    return X, np.ascontiguousarray(enc.astype(np.int64)), k


def _as_arrays_batched(X, labels_stack):
    X = np.ascontiguousarray(np.asarray(X, dtype=_dtype_of(X)))
    L = np.asarray(labels_stack)
    if X.ndim != 2:
        raise ValueError(f"X must be 2-D (n, D), got shape {X.shape}")
    if L.ndim != 2 or L.shape[1] != X.shape[0]:
        raise ValueError(f"labels_stack must have shape (M, {X.shape[0]}),"
                         f" got {L.shape}")
    check_finite_array(X, "Input data contains NaN or Inf values")
    if np.any(L < 0):
        raise ValueError("batched labels must be non-negative ints "
                         "(one compact label set per member)")
    L = np.ascontiguousarray(L.astype(np.int64))
    k_max = int(L.max()) + 1
    # A member outside 2 <= n_labels <= n_samples - 1 scores NaN and the
    # other members' scores survive it.
    counts = np.stack([np.bincount(L[m], minlength=k_max)
                       for m in range(L.shape[0])])
    occupied = (counts > 0).sum(axis=1)
    valid = (occupied >= 2) & (occupied <= X.shape[0] - 1)
    return X, L, k_max, counts, valid


def _block(n: int, mesh):
    """This rank's rows ``[lo, hi)`` of n: contiguous blocks along the data
    axis (all of them without a mesh)."""
    if mesh is None:
        return 0, n
    rows = -(-n // _mesh.mesh_shape(mesh)[0])
    lo = min(_mesh.coords(mesh)[0] * rows, n)
    return lo, min(lo + rows, n)


def _summed(t: torch.Tensor, mesh) -> torch.Tensor:
    return t if mesh is None else _mesh.all_reduce(t, mesh,
                                                   (_mesh.DATA_AXIS,))


def _chunk(rows: int, lo: int = 256, hi: int = 2048) -> int:
    return min(hi, max(lo, rows))


def _onehot(lab: torch.Tensor, k: int, dtype) -> torch.Tensor:
    """(.., c, k) one-hot of labels (.., c)."""
    return (lab.unsqueeze(-1) == torch.arange(k, device=lab.device)).to(
        dtype)


def _moments(x, lab, k: int, mesh):
    """Per-cluster coordinate sums and counts, ((.., k, D), (.., k)), of
    labels ``lab`` ((n,) or (M, n)) over this rank's rows, summed over the
    data axis."""
    n, d = x.shape
    lo, hi = _block(n, mesh)
    lead = tuple(lab.shape[:-1])
    sums = x.new_zeros(lead + (k, d))
    counts = x.new_zeros(lead + (k,))
    step = _chunk(hi - lo)
    for a in range(lo, hi, step):
        oh = _onehot(lab[..., a:min(a + step, hi)], k, x.dtype)
        sums += oh.transpose(-1, -2) @ x[a:min(a + step, hi)]
        counts += oh.sum(dim=-2)
    return _summed(sums, mesh), _summed(counts, mesh)


def _scatter(x, lab, centroids, k: int, mesh):
    """Per-cluster sums of the Euclidean and of the squared distance of
    each member to its own centroid, ((.., k), (.., k)); ``centroids``
    (k, D) or (M, k, D) with ``lab`` (M, n)."""
    n = x.shape[0]
    lo, hi = _block(n, mesh)
    lead = tuple(lab.shape[:-1])
    s1 = x.new_zeros(lead + (k,))
    s2 = x.new_zeros(lead + (k,))
    step = _chunk(hi - lo)
    for a in range(lo, hi, step):
        b = min(a + step, hi)
        d2 = pairwise_sq_dists(x[a:b], centroids)           # (.., c, k)
        oh = _onehot(lab[..., a:b], k, x.dtype)
        own = (d2 * oh).sum(dim=-1)                          # (.., c)
        s1 += (oh * torch.sqrt(own).unsqueeze(-1)).sum(dim=-2)
        s2 += (oh * own.unsqueeze(-1)).sum(dim=-2)
    return _summed(s1, mesh), _summed(s2, mesh)


def _tensors(X, labels, device):
    return (torch.from_numpy(X).to(device),
            torch.from_numpy(labels).to(device))


def _centre_dists(cen: np.ndarray, dtype, device) -> np.ndarray:
    c = torch.from_numpy(np.ascontiguousarray(cen.astype(dtype))).to(device)
    d2 = pairwise_sq_dists(c, c, mode="direct")
    return np.sqrt(np.maximum(d2.cpu().numpy().astype(np.float64), 0.0))


def _db_from(counts, centroids, s1, cd) -> float:
    scatter = s1 / np.maximum(counts, 1.0)
    ratio = (scatter[:, None] + scatter[None, :]) / np.where(cd > 0, cd,
                                                             np.inf)
    np.fill_diagonal(ratio, 0.0)
    return float(np.mean(ratio.max(axis=1)))


def _ch_from(counts, sums, centroids, s2, n: int, k: int) -> float:
    wss = float(np.sum(s2))
    mean = sums.sum(axis=0) / n
    bss = float(np.sum(counts * np.sum((centroids - mean) ** 2, axis=1)))
    if wss == 0.0:
        return 1.0                                  # sklearn's degenerate case
    return float(bss * (n - k) / (wss * (k - 1)))


def _centroids_of(X, labels, k, mesh, device):
    x, lab = _tensors(X, labels, device)
    sums, counts = _moments(x, lab, k, mesh)
    counts = counts.cpu().numpy().astype(np.float64)
    sums = sums.cpu().numpy().astype(np.float64)
    return x, lab, sums, counts, sums / np.maximum(counts, 1.0)[..., None]


def davies_bouldin_score(X, labels, *, mesh=None, device=None) -> float:
    """Davies-Bouldin index (lower is better):
    ``mean_i max_{j != i} (s_i + s_j) / d(c_i, c_j)``, ``s_i`` the mean
    Euclidean distance of cluster i's members to its centroid."""
    X, labels, k = _as_arrays(X, labels)
    dev = resolve_device(device)
    x, lab, _, counts, centroids = _centroids_of(X, labels, k, mesh, dev)
    s1, _ = _scatter(x, lab, torch.from_numpy(centroids).to(dev, x.dtype),
                     k, mesh)
    return _db_from(counts, centroids, s1.cpu().numpy().astype(np.float64),
                    _centre_dists(centroids, X.dtype, dev))


def calinski_harabasz_score(X, labels, *, mesh=None, device=None) -> float:
    """Calinski-Harabasz index (higher is better): between-group over
    within-group dispersion, ``(BSS / (k - 1)) / (WSS / (n - k))``."""
    X, labels, k = _as_arrays(X, labels)
    dev = resolve_device(device)
    x, lab, sums, counts, centroids = _centroids_of(X, labels, k, mesh, dev)
    _, s2 = _scatter(x, lab, torch.from_numpy(centroids).to(dev, x.dtype),
                     k, mesh)
    return _ch_from(counts, sums, centroids,
                    s2.cpu().numpy().astype(np.float64), X.shape[0], k)


def _silhouette_rows(x, lab, counts, k: int, mesh) -> torch.Tensor:
    """Silhouette values of every row, (.., n), for labels (n,) or (M, n):
    this rank's rows in chunks, each against all rows in column blocks of
    ``col_block``: a (chunk, col_block) distance tile reduced to
    per-cluster sums by a one-hot product (one tile for every member), so
    nothing of size O(n k) or O(n^2) is whole.  A row's distance to itself
    is set to 0: the expanded form leaves the square root of its rounding
    there (the JAX package keeps it), about 1e-7 of the scale in float64,
    3e-4 in float32."""
    n = x.shape[0]
    lo, hi = _block(n, mesh)
    col_block = min(4096, max(256, n))
    step = _chunk(hi - lo, 128, 1024)
    lead = tuple(lab.shape[:-1])
    out = x.new_zeros(lead + (n,))
    ids = torch.arange(k, device=x.device)
    for a in range(lo, hi, step):
        b = min(a + step, hi)
        xc, lc = x[a:b], lab[..., a:b]
        csums = x.new_zeros(lead + (b - a, k))
        for c0 in range(0, n, col_block):
            c1 = min(c0 + col_block, n)
            dist = torch.sqrt(pairwise_sq_dists(xc, x[c0:c1]))  # (c, cb)
            if c0 < b and a < c1:              # the tile holds self pairs
                rows = torch.arange(a, b, device=x.device)[:, None]
                cols = torch.arange(c0, c1, device=x.device)[None, :]
                dist = torch.where(rows == cols, torch.zeros_like(dist),
                                   dist)
            csums += dist @ _onehot(lab[..., c0:c1], k, x.dtype)
        own = csums.gather(-1, lc.unsqueeze(-1)).squeeze(-1)
        own_count = counts.gather(-1, lc)
        a_ = own / torch.clamp_min(own_count - 1.0, 1.0)
        mean_other = csums / torch.clamp_min(counts, 1.0).unsqueeze(-2)
        mask = (lc.unsqueeze(-1) == ids) | (counts == 0).unsqueeze(-2)
        mean_other = torch.where(mask, torch.full_like(mean_other,
                                                       float("inf")),
                                 mean_other)
        b_ = mean_other.min(dim=-1).values
        s = (b_ - a_) / torch.clamp_min(torch.maximum(a_, b_), 1e-30)
        out[..., a:b] = torch.where(own_count <= 1.0, torch.zeros_like(s),
                                    s)
    return _summed(out, mesh)


def silhouette_samples(X, labels, *, mesh=None, device=None) -> np.ndarray:
    """Per-row silhouette ``(b - a) / max(a, b)``; rows of singleton
    clusters score 0 (scikit-learn's convention).  O(n^2 D): split over
    the data axis of ``mesh``."""
    X, labels, k = _as_arrays(X, labels)
    dev = resolve_device(device)
    x, lab = _tensors(X, labels, dev)
    counts = torch.from_numpy(np.bincount(labels, minlength=k).astype(
        X.dtype)).to(dev)
    return _silhouette_rows(x, lab, counts, k, mesh).cpu().numpy().astype(
        np.float64)


def silhouette_score(X, labels, *, sample_size: Optional[int] = None,
                     seed: int = 0, mesh=None, device=None) -> float:
    """Mean silhouette over all rows, or over a seeded subsample of
    ``sample_size`` rows (``np.random.default_rng(seed)``, the JAX
    package's draw): the full score is O(n^2 D)."""
    X = np.asarray(X)
    labels = np.asarray(labels)
    if sample_size is not None and sample_size < X.shape[0]:
        idx = np.random.default_rng(seed).choice(
            X.shape[0], size=sample_size, replace=False)
        X, labels = X[idx], labels[idx]
    return float(np.mean(silhouette_samples(X, labels, mesh=mesh,
                                            device=device)))


def batched_criterion_scores(X, labels_stack, criterion: str, *,
                             mesh=None, sample_size: Optional[int] = None,
                             seed: int = 0, device=None) -> np.ndarray:
    """Scores of M label sets of the same rows, (M,) float64, in the passes
    of one (:data:`SWEEP_SCORE_DISPATCHES`): the member axis rides every
    reduction.  ``criterion`` is 'silhouette' (one member-batched O(n^2 D)
    pass; ``sample_size`` scores the same seeded rows for every member),
    'calinski_harabasz' or 'davies_bouldin' (one batched moments pass and
    one batched scatter pass, then each member on the host).  Each score
    is the single-member function's on its row of the stack; a member
    with fewer than 2 occupied clusters scores NaN."""
    if criterion not in SWEEP_SCORE_DISPATCHES:
        raise ValueError(f"unknown batched criterion {criterion!r}; "
                         f"valid: {sorted(SWEEP_SCORE_DISPATCHES)}")
    dev = resolve_device(device)
    if criterion == "silhouette":
        X = np.asarray(X)
        L = np.asarray(labels_stack)
        if sample_size is not None and sample_size < X.shape[0]:
            idx = np.random.default_rng(seed).choice(
                X.shape[0], size=sample_size, replace=False)
            X, L = X[idx], L[:, idx]
        X, L, k, member_counts, valid = _as_arrays_batched(X, L)
        x, lab = _tensors(X, L, dev)
        counts = torch.from_numpy(member_counts.astype(X.dtype)).to(dev)
        s = _silhouette_rows(x, lab, counts, k, mesh).cpu().numpy()
        out = s.astype(np.float64).mean(axis=1)
        out[~valid] = np.nan
        return out
    X, L, k, _, valid = _as_arrays_batched(X, labels_stack)
    x, lab = _tensors(X, L, dev)
    sums, counts = _moments(x, lab, k, mesh)
    sums = sums.cpu().numpy().astype(np.float64)
    counts = counts.cpu().numpy().astype(np.float64)
    centroids = sums / np.maximum(counts, 1.0)[..., None]
    s1, s2 = _scatter(x, lab, torch.from_numpy(centroids).to(dev, x.dtype),
                      k, mesh)
    s1 = s1.cpu().numpy().astype(np.float64)
    s2 = s2.cpu().numpy().astype(np.float64)
    n = X.shape[0]
    out = np.empty((L.shape[0],), np.float64)
    for m in range(L.shape[0]):
        if not valid[m]:
            out[m] = np.nan
            continue
        present = counts[m] > 0
        km = int(present.sum())
        if criterion == "calinski_harabasz":
            out[m] = _ch_from(counts[m][present], sums[m][present],
                              centroids[m][present], s2[m][present], n, km)
        else:
            cen = centroids[m][present]
            out[m] = _db_from(counts[m][present], cen, s1[m][present],
                              _centre_dists(cen, X.dtype, dev))
    return out


# --------------------------------------------------------- label metrics
# Agreement of two labelings (scikit-learn's external validity scores):
# O(n) contingency tables on the host, the JAX package's arithmetic.


def _contingency(labels_true, labels_pred):
    lt = np.asarray(labels_true).ravel()
    lp = np.asarray(labels_pred).ravel()
    if lt.shape != lp.shape:
        raise ValueError(f"label arrays differ in length: {lt.shape} vs "
                         f"{lp.shape}")
    if lt.size == 0:
        raise ValueError("label arrays must be non-empty")
    for arr in (lt, lp):
        if np.issubdtype(arr.dtype, np.floating):
            check_finite_array(arr, "labels contain NaN or Inf values")
    _, ti = np.unique(lt, return_inverse=True)
    _, pi = np.unique(lp, return_inverse=True)
    rows, cols = int(ti.max()) + 1, int(pi.max()) + 1
    return np.bincount(ti * cols + pi,
                       minlength=rows * cols).reshape(rows, cols)


def adjusted_rand_score(labels_true, labels_pred) -> float:
    """Adjusted Rand index (Hubert and Arabie): pair agreement corrected
    for chance; 1.0 for identical partitions, about 0 for random ones."""
    c = _contingency(labels_true, labels_pred)
    n = c.sum()

    def comb2(x):
        return x * (x - 1) / 2.0

    sum_ij = comb2(c.astype(np.float64)).sum()
    a = comb2(c.sum(axis=1).astype(np.float64)).sum()
    b = comb2(c.sum(axis=0).astype(np.float64)).sum()
    expected = a * b / max(comb2(float(n)), 1.0)
    max_index = 0.5 * (a + b)
    if max_index == expected:          # degenerate: one cluster each
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))


def _entropy(counts) -> float:
    p = counts[counts > 0].astype(np.float64)
    p = p / p.sum()
    return float(-(p * np.log(p)).sum())


def _mi_from_contingency(c) -> float:
    c = c.astype(np.float64)
    n = c.sum()
    outer = np.outer(c.sum(axis=1), c.sum(axis=0))
    nz = c > 0
    return float((c[nz] / n * (np.log(c[nz] * n) -
                               np.log(outer[nz]))).sum())


def mutual_info_score(labels_true, labels_pred) -> float:
    """Mutual information of the two partitions (nats)."""
    return _mi_from_contingency(_contingency(labels_true, labels_pred))


def normalized_mutual_info_score(labels_true, labels_pred) -> float:
    """NMI with the arithmetic-mean normalisation (scikit-learn's
    default)."""
    c = _contingency(labels_true, labels_pred)
    mi = _mi_from_contingency(c)
    h1 = _entropy(c.sum(axis=1))
    h2 = _entropy(c.sum(axis=0))
    denom = 0.5 * (h1 + h2)
    if denom == 0.0:                   # both partitions trivial
        return 1.0
    return float(np.clip(mi / denom, 0.0, 1.0))


def homogeneity_completeness_v_measure(labels_true, labels_pred):
    """(homogeneity, completeness, V-measure), scikit-learn's
    definitions."""
    c = _contingency(labels_true, labels_pred)
    mi = _mi_from_contingency(c)
    h_true = _entropy(c.sum(axis=1))
    h_pred = _entropy(c.sum(axis=0))
    hom = 1.0 if h_true == 0.0 else mi / h_true
    com = 1.0 if h_pred == 0.0 else mi / h_pred
    v = (0.0 if hom + com == 0.0
         else 2.0 * hom * com / (hom + com))
    return float(hom), float(com), float(v)
