"""Model selection over k: fit many, pick the best.

Counterpart of ``kmeans_tpu/sweep.py``, its family-agnostic half, in NumPy:

* ``parse_k_range``: one grammar for CLI strings ("2:33", "2:33:2",
  "2,4,8"), Python ranges and iterables;
* ``check_criterion``, ``elbow_index`` and ``select_k``: the selection
  rules, with the elbow rule for inertia (which falls with k, so its
  minimum would always be k_max);
* ``within_k_winners`` and ``selected_member``: the best restart of each k,
  then the member the sweep publishes;
* ``clone_for``: an estimator cloned through ``get_params``, so that the
  members inherit every setting of the model they sweep;
* ``SweepResult``: the per-k curve, the per-member fit scores, the
  selected k and the fitted winner.

The family half is ``KMeans.sweep`` (``models/kmeans.py``): every (k,
restart) member in one device loop
(``parallel.distributed.make_multi_fit_fn`` with a per-member k, members
padded to k_max with sentinel rows), or one fit per member with
``batched=0``, the oracle of the batched path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

#: criterion -> optimization direction, per family.  'inertia' is
#: special-cased in ``select_k`` (elbow rule — inertia is monotone
#: decreasing in k, so raw argmin would degenerate to k_max).
KMEANS_CRITERIA = {"inertia": "min", "silhouette": "max",
                   "calinski_harabasz": "max", "davies_bouldin": "min"}
GMM_CRITERIA = {"bic": "min", "aic": "min"}


def parse_k_range(spec) -> Tuple[int, ...]:
    """Normalize a k-range spec to a sorted tuple of distinct ints >= 1.

    Accepts the CLI grammar ``"lo:hi"`` / ``"lo:hi:step"`` (half-open,
    Python ``range`` semantics: ``"2:33"`` is k ∈ {2..32}) and
    ``"2,4,8"`` comma lists, plus any Python iterable of ints (``range``
    objects included).  Raises ``ValueError`` on anything malformed or
    empty — the CLI maps that to exit code 2."""
    if isinstance(spec, str):
        s = spec.strip()
        try:
            if ":" in s:
                parts = [int(p) for p in s.split(":")]
                if len(parts) == 2:
                    ks = list(range(parts[0], parts[1]))
                elif len(parts) == 3:
                    ks = list(range(parts[0], parts[1], parts[2]))
                else:
                    raise ValueError
            else:
                ks = [int(p) for p in s.split(",")]
        except ValueError:
            raise ValueError(
                f"invalid k range {spec!r}: expected 'lo:hi[:step]' "
                f"(half-open) or a comma list like '2,4,8'") from None
    elif isinstance(spec, (int, np.integer)):
        raise ValueError(
            f"k_range must span several k values (a range or list), got "
            f"the single int {spec!r}; for one k just call fit")
    else:
        ks = [int(k) for k in spec]
    ks = sorted(set(ks))
    if not ks:
        raise ValueError(f"k range {spec!r} is empty")
    if ks[0] < 1:
        raise ValueError(f"k range {spec!r} contains k < 1")
    return tuple(ks)


def check_criterion(criterion: str, table: dict) -> str:
    if criterion not in table:
        raise ValueError(f"unknown criterion {criterion!r}; valid: "
                         f"{sorted(table)}")
    return table[criterion]


def elbow_index(ks, inertias) -> int:
    """Elbow of a (k, inertia) curve: the point with the maximum
    normalized distance BELOW the chord joining the curve's endpoints
    (the kneedle rule).  Inertia decreases monotonically in k, so the
    raw minimum is always k_max — the elbow is where adding clusters
    stops paying.  Degenerate inputs (fewer than 3 points, or a curve
    never below its chord — no convex knee) fall back to the minimum-
    inertia index, documented in ``KMeans.sweep``."""
    y = np.asarray(inertias, np.float64)
    finite = np.isfinite(y)
    if len(ks) < 3 or not np.all(finite):
        masked = np.where(finite, y, np.inf)
        return int(np.argmin(masked))
    x = np.asarray(ks, np.float64)
    x = (x - x[0]) / max(x[-1] - x[0], 1e-300)
    span = max(float(y.max() - y.min()), 1e-300)
    yn = (y - y.min()) / span
    chord = yn[0] + (yn[-1] - yn[0]) * x
    below = chord - yn                       # >0 where the curve dips
    i = int(np.argmax(below))
    if below[i] <= 0:                        # concave/flat: no knee
        return int(np.argmin(y))
    return i


def select_k(ks, scores, criterion: str) -> int:
    """The selected k for a per-k criterion curve (see the criteria
    tables; 'inertia' routes through the elbow rule)."""
    scores = np.asarray(scores, np.float64)
    if not np.any(np.isfinite(scores)):
        raise ValueError(
            f"no finite {criterion} score in the sweep (every member "
            f"failed); inspect SweepResult.member_scores")
    if criterion == "inertia":
        return int(ks[elbow_index(ks, scores)])
    direction = {**KMEANS_CRITERIA, **GMM_CRITERIA}[criterion]
    masked = np.where(np.isfinite(scores), scores,
                      -np.inf if direction == "max" else np.inf)
    pick = np.argmax(masked) if direction == "max" else np.argmin(masked)
    return int(ks[int(pick)])


def within_k_winners(member_vals, n_k: int, n_init: int,
                     maximize: bool = False):
    """Within-k restart selection over per-member fit values (the
    n_init rule; K-Means: lowest true final inertia, GMM: highest final
    lower bound).  Non-finite members can never win.  Returns
    ``(vals, best_r, win_idx)`` — the values reshaped ``(n_k, n_init)``,
    each k's winning restart index, and the winners' flat member ids.
    ONE implementation for both families: the masking/tie rule must
    not silently diverge between them."""
    vals = np.asarray(member_vals, np.float64).reshape(n_k, n_init)
    masked = np.where(np.isfinite(vals),
                      vals, -np.inf if maximize else np.inf)
    best_r = (np.argmax if maximize else np.argmin)(masked, axis=1)
    win_idx = np.arange(n_k) * n_init + best_r
    return vals, best_r, win_idx


def selected_member(ks, scores, criterion: str, win_idx):
    """Resolve the criterion curve to ``(selected_k, sel, m_sel)``:
    the chosen k, its index in ``ks``, and its winning restart's flat
    member id (the model the sweep publishes)."""
    selected_k = select_k(ks, scores, criterion)
    sel = int(np.flatnonzero(np.asarray(ks) == selected_k)[0])
    return selected_k, sel, int(win_idx[sel])


def clone_for(model, **overrides):
    """A fresh estimator of ``model``'s class with its constructor
    params (sklearn ``get_params`` protocol) plus ``overrides`` — how
    sweep members inherit every config knob (dtype, mesh, distance
    mode, empty policy, ...) of the model they sweep."""
    params = model.get_params()
    params.update(overrides)
    return type(model)(**params)


@dataclasses.dataclass
class SweepResult:
    """Outcome of a ``.sweep(k_range=...)`` model-selection run.

    ``scores[i]`` is the criterion value of k_range[i]'s winning
    restart; ``member_scores[i, r]`` is the per-member FIT score
    (K-Means family: true final inertia; GMM: final lower bound) that
    selected the restart within each k.  ``n_dispatches`` counts the
    engine's fit and scoring passes (a device loop, a pass of the
    members' labels, a metric pass): O(1) in |k_range| on the batched
    path, which seeds every member first."""

    family: str
    criterion: str
    k_range: Tuple[int, ...]
    scores: np.ndarray                  # (n_k,)
    member_scores: np.ndarray           # (n_k, n_init)
    selected_k: int
    selected_restart: int
    best_model: object
    n_dispatches: int
    batched: bool
    n_iters: Optional[np.ndarray] = None      # (n_k, n_init)
    #: The per-k winners' centroids, (k_i, D) each (the port's addition:
    #: what scoring the winners on other rows needs).
    winner_centroids: Optional[list] = None

    def summary(self) -> dict:
        """JSON-able summary (the CLI's ``--json`` payload)."""
        return {
            "family": self.family,
            "criterion": self.criterion,
            "k_range": [int(k) for k in self.k_range],
            "selected_k": int(self.selected_k),
            "selected_restart": int(self.selected_restart),
            "scores": {str(k): (None if not np.isfinite(s) else float(s))
                       for k, s in zip(self.k_range, self.scores)},
            "member_scores": [[(None if not np.isfinite(s) else float(s))
                               for s in row]
                              for row in np.asarray(self.member_scores)],
            "dispatches": int(self.n_dispatches),
            "batched": bool(self.batched),
        }
