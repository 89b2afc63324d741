"""Per-iteration log lines (own copy of the JAX package's
``utils/logging.py``; same messages).

Startup echo, one line per iteration with SSE / max shift / cluster sizes
and an explicit flush, the convergence announcement, and the empty-cluster
and SSE-rise warnings.  For large k the cluster sizes are summarised rather
than listed.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np


class IterationLogger:
    def __init__(self, verbose: bool = True, max_sizes_listed: int = 32):
        self.verbose = verbose
        self.max_sizes_listed = max_sizes_listed

    def _emit(self, msg: str) -> None:
        if self.verbose:
            print(msg)
            sys.stdout.flush()

    def startup(self, k: int, max_iter: int, tolerance: float,
                compute_sse: bool) -> None:
        self._emit(f"Starting K-Means with k={k}, max_iter={max_iter}, "
                   f"tolerance={tolerance}")
        self._emit("SSE computation: "
                   + ("ENABLED" if compute_sse else
                      "DISABLED (for performance)"))

    def _sizes_repr(self, sizes: Sequence[int]) -> str:
        if len(sizes) <= self.max_sizes_listed:
            return str([int(s) for s in sizes])
        a = np.asarray(sizes)
        return (f"[k={len(sizes)}: min={a.min()}, median={int(np.median(a))}, "
                f"max={a.max()}, empty={int((a == 0).sum())}]")

    def iteration(self, iteration: int, max_shift: float,
                  sizes: Sequence[int], sse: Optional[float]) -> None:
        if sse is not None:
            self._emit(f"Iteration {iteration + 1}: SSE = {sse:.4f}, "
                       f"Max Shift = {max_shift:.6f}, "
                       f"Cluster Sizes = {self._sizes_repr(sizes)}")
        else:
            self._emit(f"Iteration {iteration + 1}: "
                       f"Max Shift = {max_shift:.6f}, "
                       f"Cluster Sizes = {self._sizes_repr(sizes)}")

    def converged(self, iterations: int) -> None:
        self._emit(f"Converged after {iterations} iterations")

    def restart(self, restart: int, total: int, inertia: float,
                winner: bool = False) -> None:
        tag = "best of" if winner else "of"
        self._emit(f"Restart {restart + 1} {tag} {total}: "
                   f"final inertia = {inertia:.4f}")

    def warn_empty(self, n_empty: int) -> None:
        self._emit(f"  WARNING: {n_empty} empty cluster(s) detected. "
                   "Reinitializing...")

    def warn_reassign(self, n: int) -> None:
        self._emit(f"  WARNING: {n} low-count center(s) reassigned from "
                   "the current batch")

    def warn_sse_increase(self, prev: float, cur: float) -> None:
        self._emit(f"  WARNING: SSE increased from {prev:.4f} to {cur:.4f}")
