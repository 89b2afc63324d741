"""Serving-quality & drift observability.

The port's copy of the JAX package's ``obs/drift.py``: numpy detectors
over ring-buffered traffic windows, fed ONLY by the labels/distances the
serving dispatches already compute (no extra launch), compared against a
fit-time reference profile (``quality_profile()``) that the checkpoint
carries.

Three detector families, one committed decision table:

* **Assignment-distribution shift** — PSI and Jensen-Shannon divergence
  between the serving window's assignment histogram and the training
  histogram of the reference :func:`build_profile`, both with the same
  empty-bin smoothing (:data:`HIST_SMOOTHING`); labels outside
  ``[0, k)`` are masked (:func:`assignment_counts`).
* **Score shift** — rolling serving score-per-row over the reference's
  training score-per-row (``score_kind='sse'`` for the K-Means family,
  ``'neg_log_lik'`` for mixtures); a non-positive reference deactivates
  this detector (reported, never silently passed).
* **bf16-guard margin shift** — the fraction of guarded-path rows the
  near-tie guard re-labeled at float32.

Decision rules are the committed constants below, with a debounce: a
detector fires after :data:`DRIFT_DEBOUNCE_WINDOWS` consecutive breaching
windows.  Events go out three ways at once: a ``serve.drift`` tracer
event, the ``serve.drift.*`` registry counters, and a per-model JSONL
sink (read back by :func:`read_quality_log` / :func:`quality_report`).

This is the one ``obs`` module that imports numpy; the package
``__init__`` loads it lazily.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from kmeans_tpu_torch.obs import trace as _trace
from kmeans_tpu_torch.obs.metrics_registry import registry as _registry

__all__ = [
    "PSI_ALERT", "JS_ALERT", "SCORE_RATIO_ALERT",
    "NEAR_TIE_FRAC_ALERT", "HIST_SMOOTHING", "DRIFT_WINDOW_ROWS",
    "DRIFT_DEBOUNCE_WINDOWS", "DRIFT_HISTORY_WINDOWS",
    "COMMITTED_THRESHOLDS", "PROFILE_VERSION",
    "assignment_counts", "psi", "js_divergence", "build_profile",
    "QualityMonitor", "read_quality_log", "quality_report",
    "format_quality_status",
]

# --------------------------------------------------------- committed rules

#: PSI alert threshold.  The industry-standard PSI bands are < 0.1
#: stable, 0.1-0.25 moderate shift, > 0.25 major shift; the committed
#: rule fires at the major-shift boundary — serving traffic whose
#: assignment mix moved this far no longer matches the clusters.
PSI_ALERT = 0.25

#: Jensen-Shannon divergence alert (base-2 logs, so the value is in
#: bits and bounded by 1.0).  0.1 bit corresponds to a clearly visible
#: redistribution of assignment mass; JS is the bounded second opinion
#: next to PSI's unbounded tails (PSI explodes on near-empty reference
#: bins even smoothed; JS cannot).
JS_ALERT = 0.10

#: Serving score-per-row over training score-per-row.  2.0 = requests
#: land on average twice as far from their nearest centroid (or at
#: twice the negative log-likelihood) as the training data did — the
#: rolling-SSE rule.
SCORE_RATIO_ALERT = 2.0

#: Fraction of bf16-guarded rows the near-tie guard re-labeled at f32.
#: Separated traffic measures ~per-mille; uniform-random — the
#: adversarial no-structure case — measured 45% (the JAX package's
#: figures).  5% is an order of magnitude above the separated
#: baseline while far below the structureless ceiling: traffic
#: migrating to Voronoi boundaries.
NEAR_TIE_FRAC_ALERT = 0.05

#: Per-bin additive smoothing applied to BOTH histograms before
#: normalizing (empty serving bins and empty training bins alike), so
#: PSI/JS stay finite when a cluster receives zero traffic.
HIST_SMOOTHING = 1e-6

#: Rows per evaluation window.  Windows are row-counted, not
#: wall-clocked: detector variance is a function of sample size, and a
#: fixed row count makes the committed thresholds mean the same thing
#: at 10 QPS and 10k QPS.
DRIFT_WINDOW_ROWS = 512

#: Consecutive breaching windows before a drift event fires (and
#: consecutive clean windows before it clears).  One window of
#: boundary-heavy traffic is weather; two in a row is climate.
DRIFT_DEBOUNCE_WINDOWS = 2

#: Closed-window summaries retained in the ring buffer (the ``stats()``
#: / ``serve-status`` history depth; the JSONL sink keeps everything).
DRIFT_HISTORY_WINDOWS = 64

#: The committed decision table, detector name -> threshold — exported
#: as one dict so tests, ``serve-status``, and the docs pin the SAME
#: numbers (a drifted copy of a threshold is itself a drift bug).
COMMITTED_THRESHOLDS: Dict[str, float] = {
    "psi": PSI_ALERT,
    "js": JS_ALERT,
    "score_ratio": SCORE_RATIO_ALERT,
    "near_tie_frac": NEAR_TIE_FRAC_ALERT,
}

#: Reference-profile schema version (persisted in checkpoint metadata).
PROFILE_VERSION = 1

#: Record kinds a quality JSONL sink may contain (the ``serve-status``
#: classification rule; anything else in a stream is malformed).
#: ``update``/``rollback`` are the serve-and-learn actuator's decision
#: records: one line per in-place online update attempt and
#: one per rollback-to-last-good, written through the SAME per-model
#: sink the drift trigger writes — the multi-file reader aggregates
#: trigger and actuator into one per-model row.
QUALITY_KINDS = ("profile", "window", "drift", "recovered",
                 "update", "rollback")


# ------------------------------------------------------------- detectors

def assignment_counts(labels, k: int) -> np.ndarray:
    """(k,) float64 label counts with out-of-range labels MASKED.

    Sentinel/padded centroid rows (the k-sweep and TP padding
    discipline) can never legitimately win an assignment, but a
    histogram must be robust to one leaking through: labels outside
    ``[0, k)`` are dropped, not clipped — clipping would silently
    credit the first/last real cluster with phantom mass."""
    labels = np.asarray(labels).ravel()
    try:
        # Fast path (the per-dispatch serving feed): labels from an
        # argmin are non-negative, so bincount runs without the mask
        # allocations; sentinel labels >= k land in the tail and are
        # trimmed.
        counts = np.bincount(labels, minlength=int(k))
    except (ValueError, TypeError):
        # Negative or non-integer labels (hand-built test fixtures):
        # the masked slow path.
        valid = labels[(labels >= 0) & (labels < k)]
        counts = np.bincount(valid.astype(np.int64), minlength=int(k))
    return counts[: int(k)].astype(np.float64)


def _smoothed(hist, smoothing: float) -> np.ndarray:
    h = np.asarray(hist, np.float64) + float(smoothing)
    return h / h.sum()


def psi(ref: Sequence[float], cur: Sequence[float],
        smoothing: float = HIST_SMOOTHING) -> float:
    """Population stability index between two count/probability
    vectors: ``sum((c_i - r_i) * ln(c_i / r_i))`` over smoothed,
    normalized bins.  Symmetric in sign contributions, >= 0, unbounded
    above; the committed band is :data:`PSI_ALERT`."""
    r = _smoothed(ref, smoothing)
    c = _smoothed(cur, smoothing)
    if r.shape != c.shape:
        raise ValueError(f"histogram shapes differ: {r.shape} vs "
                         f"{c.shape}")
    return float(np.sum((c - r) * np.log(c / r)))


def js_divergence(ref: Sequence[float], cur: Sequence[float],
                  smoothing: float = HIST_SMOOTHING) -> float:
    """Jensen-Shannon divergence (base-2 logs -> bits, bounded [0, 1])
    between two count/probability vectors, smoothed like :func:`psi`."""
    r = _smoothed(ref, smoothing)
    c = _smoothed(cur, smoothing)
    if r.shape != c.shape:
        raise ValueError(f"histogram shapes differ: {r.shape} vs "
                         f"{c.shape}")
    m = 0.5 * (r + c)

    def _kl(a, b):
        return float(np.sum(a * np.log2(a / b)))

    return 0.5 * _kl(r, m) + 0.5 * _kl(c, m)


# ------------------------------------------------------- reference profile

def build_profile(*, family: str, model_class: str, k: int,
                  counts=None, score_kind: Optional[str] = None,
                  score_per_row: Optional[float] = None,
                  per_cluster_sse=None,
                  n_rows: Optional[float] = None) -> dict:
    """Assemble one JSON-ready reference profile (the checkpoint
    metadata block's ``quality_profile`` payload and the
    :class:`QualityMonitor` reference).

    ``counts`` is the raw training assignment mass per cluster
    (weighted sizes for the K-Means family, mixing weights for the
    mixture family); it is normalized here.  Every value is coerced to
    plain Python types — numpy scalars would break the checkpoint
    meta JSON."""
    if score_kind not in (None, "sse", "neg_log_lik"):
        raise ValueError(f"score_kind must be None, 'sse' or "
                         f"'neg_log_lik', got {score_kind!r}")
    hist = None
    if counts is not None:
        c = np.asarray(counts, np.float64).ravel()
        if c.shape[0] != int(k):
            raise ValueError(f"counts has {c.shape[0]} bins, model has "
                             f"k={k}")
        total = float(c.sum())
        if total > 0:
            hist = [float(v) for v in c / total]
    return {
        "profile_version": PROFILE_VERSION,
        "family": str(family),
        "model_class": str(model_class),
        "k": int(k),
        "n_rows": float(n_rows) if n_rows is not None else None,
        "assignment_hist": hist,
        "score_kind": score_kind,
        "score_per_row": (float(score_per_row)
                          if score_per_row is not None else None),
        "per_cluster_sse": ([float(v) for v in
                             np.asarray(per_cluster_sse,
                                        np.float64).ravel()]
                            if per_cluster_sse is not None else None),
    }


# ----------------------------------------------------------- the monitor

class QualityMonitor:
    """Per-resident-model drift monitor over ring-buffered traffic
    windows.

    Fed exclusively through :meth:`observe` with the host-side arrays
    serving dispatches already materialized — labels, per-row scores,
    bf16-guard correction counts.  Zero extra dispatches and zero
    writes into the dispatch outputs by construction (the monitor only
    READS); the obs=0 parity contract (monitoring on/off labels
    bit-equal) is therefore trivial and pinned by
    tests/test_quality.py.

    Thread-safe: serving dispatches arrive from the queue worker and
    from direct callers concurrently.  The JSONL sink follows the
    Heartbeat isolation discipline — a full disk or unserializable
    field is counted (``sink_errors``) and the sink disabled, never a
    serving failure.
    """

    def __init__(self, model_id: str, k: int, *,
                 profile: Optional[dict] = None,
                 window_rows: int = DRIFT_WINDOW_ROWS,
                 debounce: int = DRIFT_DEBOUNCE_WINDOWS,
                 thresholds: Optional[Dict[str, float]] = None,
                 sink_path=None,
                 history: int = DRIFT_HISTORY_WINDOWS):
        if window_rows <= 0:
            raise ValueError(f"window_rows must be positive, got "
                             f"{window_rows!r}")
        if debounce <= 0:
            raise ValueError(f"debounce must be positive, got "
                             f"{debounce!r}")
        if profile is not None and int(profile.get("k", k)) != int(k):
            raise ValueError(
                f"reference profile is for k={profile.get('k')}, "
                f"monitor serves k={k} — a mismatched reference would "
                f"compare histograms bin-by-bin across different "
                f"clusters")
        self.model_id = str(model_id)
        self.k = int(k)
        self.profile = profile
        self.window_rows = int(window_rows)
        self.debounce = int(debounce)
        self.thresholds = dict(COMMITTED_THRESHOLDS)
        if thresholds:
            unknown = sorted(set(thresholds) - set(self.thresholds))
            if unknown:
                raise ValueError(f"unknown detector thresholds "
                                 f"{unknown}; known: "
                                 f"{sorted(self.thresholds)}")
            self.thresholds.update(thresholds)
        self.sink_path = str(sink_path) if sink_path is not None else None
        self.sink_errors = 0
        self._file = None
        self._file_failed = False
        self._lock = threading.Lock()
        # Sink IO runs OUTSIDE _lock (emission must never serialize
        # dispatches) but still needs ITS OWN serialization: two
        # threads closing consecutive windows would otherwise
        # interleave JSON lines mid-write or double-open the lazy file
        # — the Heartbeat _emit_lock discipline.
        self._sink_lock = threading.Lock()
        self._ref_hist = (np.asarray(profile["assignment_hist"],
                                     np.float64)
                          if profile and profile.get("assignment_hist")
                          else None)
        # Smoothed reference + its logs, computed ONCE: the window
        # close is on the serving dispatch path (every ~window_rows
        # rows), and re-smoothing a constant there is pure overhead
        # against the <=1.01 bench rule.
        if self._ref_hist is not None:
            self._ref_sm = _smoothed(self._ref_hist, HIST_SMOOTHING)
            self._ref_log = np.log(self._ref_sm)
        else:
            self._ref_sm = self._ref_log = None
        ref_score = profile.get("score_per_row") if profile else None
        # The ratio rule needs a positive reference (docstring); a
        # non-positive one deactivates the detector, visibly.
        self._ref_score = (float(ref_score)
                           if ref_score is not None and ref_score > 0
                           else None)
        # Current (open) window accumulators.
        self._counts = np.zeros(self.k, np.float64)
        self._label_rows = 0
        self._score_sum = 0.0
        self._score_rows = 0
        self._near_ties = 0
        self._guarded_rows = 0
        self._rows_in_window = 0
        # Lifetime state.
        self.windows = 0
        self.rows = 0
        self.events = 0
        self.drifting = False
        self._consecutive = 0
        self._clean_streak = 0
        self._history = deque(maxlen=int(history))
        if profile is not None:
            self._sink({"kind": "profile", "model": self.model_id,
                        "ts": time.time(), "profile": profile,
                        "thresholds": self.thresholds,
                        "window_rows": self.window_rows,
                        "debounce": self.debounce})

    # ---------------------------------------------------------- feeding

    def observe(self, rows: int, *, labels=None, score=None,
                near_ties: int = 0, guarded_rows: int = 0) -> None:
        """Fold one dispatch's already-computed outputs into the open
        window.  ``labels``: int labels (sentinels masked); ``score``:
        per-row scores in the profile's ``score_kind`` convention
        (nearest squared distance / negative log-likelihood);
        ``near_ties``/``guarded_rows``: the bf16 guard's correction
        count and the rows that went through the guarded path."""
        closed = None
        with self._lock:
            self._rows_in_window += int(rows)
            self.rows += int(rows)
            if labels is not None:
                self._counts += assignment_counts(labels, self.k)
                self._label_rows += int(np.asarray(labels).size)
            if score is not None:
                s = np.asarray(score, np.float64).ravel()
                self._score_sum += float(s.sum())
                self._score_rows += int(s.size)
            if guarded_rows:
                self._near_ties += int(near_ties)
                self._guarded_rows += int(guarded_rows)
            if self._rows_in_window >= self.window_rows:
                closed = self._close_window_locked()
        if closed is not None:
            self._emit(closed)

    # ----------------------------------------------------- window close

    def _close_window_locked(self) -> dict:
        """Evaluate the committed detectors over the closed window and
        advance the debounce state.  Returns the window summary (the
        caller emits OUTSIDE the lock — sink IO and tracer events must
        never serialize dispatches)."""
        detectors: Dict[str, Optional[float]] = {
            "psi": None, "js": None, "score_ratio": None,
            "near_tie_frac": None}
        if self._ref_hist is not None and self._label_rows > 0:
            # One smoothing pass + the cached reference logs feed BOTH
            # histogram detectors (this runs on the serving dispatch
            # path — op/allocation count matters; identical arithmetic
            # to psi()/js_divergence(), pinned by the unit fixtures).
            r, logr = self._ref_sm, self._ref_log
            c = _smoothed(self._counts, HIST_SMOOTHING)
            logc = np.log(c)
            detectors["psi"] = float(np.sum((c - r) * (logc - logr)))
            m = 0.5 * (r + c)
            logm = np.log(m)
            detectors["js"] = float(
                (0.5 * np.sum(r * (logr - logm))
                 + 0.5 * np.sum(c * (logc - logm))) / math.log(2.0))
        if self._ref_score is not None and self._score_rows > 0:
            detectors["score_ratio"] = (
                self._score_sum / self._score_rows) / self._ref_score
        if self._guarded_rows > 0:
            detectors["near_tie_frac"] = (self._near_ties
                                          / self._guarded_rows)
        breaching = sorted(
            name for name, v in detectors.items()
            if v is not None and v > self.thresholds[name])
        self.windows += 1
        fired = recovered = False
        # A window where NO detector could evaluate (e.g. filled by
        # transform-only traffic — rows but no labels/scores) is not
        # evidence in either direction: it must neither reset a breach
        # streak nor count toward recovery.
        informative = any(v is not None for v in detectors.values())
        if not informative:
            pass
        elif breaching:
            self._consecutive += 1
            self._clean_streak = 0
            if self._consecutive >= self.debounce and not self.drifting:
                self.drifting = True
                self.events += 1
                fired = True
        else:
            self._consecutive = 0
            self._clean_streak += 1
            if self.drifting and self._clean_streak >= self.debounce:
                self.drifting = False
                recovered = True
        summary = {
            "kind": "window", "model": self.model_id,
            "ts": time.time(), "window": self.windows,
            "rows": self._rows_in_window,
            "label_rows": self._label_rows,
            "score_rows": self._score_rows,
            "guarded_rows": self._guarded_rows,
            "detectors": detectors, "breaching": breaching,
            "informative": informative,
            "consecutive": self._consecutive,
            "drifting": self.drifting,
        }
        self._history.append(summary)
        self._counts = np.zeros(self.k, np.float64)
        self._label_rows = 0
        self._score_sum = 0.0
        self._score_rows = 0
        self._near_ties = 0
        self._guarded_rows = 0
        self._rows_in_window = 0
        return {**summary, "fired": fired, "recovered": recovered}

    def _emit(self, closed: dict) -> None:
        """Deliver one closed window: the JSONL record always; on a
        debounced state CHANGE additionally the drift/recovered record,
        the tracer event, and the registry counters."""
        fired = closed.pop("fired")
        recovered = closed.pop("recovered")
        reg = _registry()
        reg.counter("serve.drift.windows").inc()
        self._sink(closed)
        if fired:
            reg.counter("serve.drift.events").inc()
            for name in closed["breaching"]:
                reg.counter(f"serve.drift.{name}").inc()
            attrs = {f"detector_{n}": v
                     for n, v in closed["detectors"].items()
                     if v is not None}
            _trace.event("serve.drift", model=self.model_id,
                         breaching=",".join(closed["breaching"]),
                         window=closed["window"], **attrs)
            self._sink({**closed, "kind": "drift"})
        elif recovered:
            reg.counter("serve.drift.recovered").inc()
            _trace.event("serve.drift.recovered", model=self.model_id,
                         window=closed["window"])
            self._sink({**closed, "kind": "recovered"})

    def _sink(self, rec: dict) -> None:
        if self.sink_path is None or self._file_failed:
            return
        with self._sink_lock:
            if self._file_failed:           # raced close()/failure
                return
            try:
                if self._file is None:
                    os.makedirs(os.path.dirname(self.sink_path) or ".",
                                exist_ok=True)
                    self._file = open(self.sink_path, "a")
                self._file.write(json.dumps(rec, default=str) + "\n")
                self._file.flush()
            except Exception:   # noqa: BLE001 — observer isolation
                self.sink_errors += 1
                self._file_failed = True

    # ----------------------------------------------------------- status

    def status(self) -> dict:
        """Operator-facing snapshot: the ``stats()['quality']`` block
        and the ``{"quality": true}`` serve-CLI payload."""
        with self._lock:
            last = self._history[-1] if self._history else None
            return {
                "model": self.model_id, "k": self.k,
                "reference": self.profile is not None,
                "score_kind": (self.profile or {}).get("score_kind"),
                "windows": self.windows, "rows": self.rows,
                "open_window_rows": self._rows_in_window,
                "drifting": self.drifting,
                "consecutive_breaches": self._consecutive,
                "events": self.events,
                "detectors": dict(last["detectors"]) if last else None,
                "breaching": list(last["breaching"]) if last else [],
                "thresholds": dict(self.thresholds),
                "window_rows": self.window_rows,
                "debounce": self.debounce,
                "sink_path": self.sink_path,
                "sink_errors": self.sink_errors,
            }

    def history(self) -> List[dict]:
        with self._lock:
            return [dict(w) for w in self._history]

    def record(self, kind: str, **fields) -> None:
        """Append one serve-and-learn decision record to
        this model's quality sink: the actuator's ``update``/
        ``rollback`` lines share the stream with the trigger's window/
        drift records so ``serve-status`` reads one file per (model,
        replica).  Sink-only — the caller owns its tracer events and
        registry counters (the learner's triple-recording contract);
        isolation and write-after-close behavior are ``_sink``'s."""
        if kind not in ("update", "rollback"):
            raise ValueError(
                f"record() writes serve-and-learn decision records "
                f"('update'/'rollback'), got kind {kind!r}")
        self._sink({"kind": kind, "model": self.model_id,
                    "ts": time.time(), **fields})

    def close(self) -> None:
        with self._sink_lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            # Unconditional: a monitor whose sink was
            # never lazily opened must not create and write the file
            # from an in-flight dispatch AFTER close.
            self._file_failed = True


# -------------------------------------------------- serve-status reading

def read_quality_log(path) -> List[dict]:
    """Quality JSONL -> records.  Tolerant of a torn trailing line (a
    live monitor may be mid-write — the serve-status use case), strict
    about everything else: a stream with no parseable quality record
    is malformed (the exit-2 classification, via TraceReadError)."""
    from kmeans_tpu_torch.obs.trace import TraceReadError
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError as e:
        raise TraceReadError(f"cannot read quality file {path}: {e}") \
            from e
    records = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            if i == len(lines) - 1:
                continue                # torn tail of a live writer
            raise TraceReadError(
                f"{path}:{i + 1}: not a JSON record ({e.msg})") from e
        if not isinstance(rec, dict) or rec.get("kind") not in \
                QUALITY_KINDS or "model" not in rec:
            raise TraceReadError(
                f"{path}:{i + 1}: not a serving-quality record "
                f"(kind must be one of {QUALITY_KINDS} with a "
                f"'model' field)")
        records.append(rec)
    if not records:
        raise TraceReadError(f"{path}: no serving-quality records")
    return records


def _is_quality_stream(path) -> bool:
    """First-line sniff: does this file hold quality records?  Used to
    skip co-located trace/heartbeat sinks when a DIRECTORY is given
    (an explicitly named file stays strict — read_quality_log)."""
    try:
        with open(path) as f:
            rec = json.loads(f.readline())
    except (OSError, ValueError):
        return False
    return isinstance(rec, dict) and rec.get("kind") in QUALITY_KINDS \
        and "model" in rec


def quality_report(paths) -> dict:
    """Aggregate quality sinks into the ``serve-status`` payload.

    ``paths``: files, directories, or globs
    (:func:`kmeans_tpu_torch.obs.fleet.expand_fleet_paths`);
    directories/globs keep only quality streams (trace/heartbeat sinks
    naturally share the directory), explicit files are read strictly.  Per model the CURRENT state is the newest record's
    debounced ``drifting`` flag; ``healthy`` mirrors ``fleet-status``:
    False when any model is drifting (exit 1)."""
    from kmeans_tpu_torch.obs.fleet import expand_fleet_paths
    from kmeans_tpu_torch.obs.trace import TraceReadError
    raw = [paths] if isinstance(paths, (str, os.PathLike)) else list(paths)
    # Explicitly named files stay strict (reading one as a quality log
    # is what the caller asked for); dir/glob expansions keep only the
    # quality streams — trace/heartbeat sinks naturally co-locate.
    explicit = {str(p) for p in raw if os.path.isfile(str(p))}
    files = expand_fleet_paths(raw)
    keep = [p for p in files
            if str(p) in explicit or _is_quality_stream(p)]
    if not keep:
        raise TraceReadError(
            f"no serving-quality streams among {files} (trace/"
            f"heartbeat files are read by 'trace summarize' / "
            f"'fleet-status')")
    files = keep
    records: List[dict] = []
    for p in files:
        records.extend(read_quality_log(p))
    records.sort(key=lambda r: r.get("ts", 0.0))
    models: Dict[str, dict] = {}
    for rec in records:
        row = models.setdefault(rec["model"], {
            "model": rec["model"], "windows": 0, "rows": 0,
            "events": 0, "reference": False, "detectors": None,
            "breaching": [], "drifting": False, "last_ts": None,
            "updates": 0, "update_failures": 0, "rollbacks": 0,
            "last_update": None})
        row["last_ts"] = rec.get("ts")
        if rec["kind"] == "profile":
            row["reference"] = True
            row["thresholds"] = rec.get("thresholds")
        elif rec["kind"] == "window":
            row["windows"] += 1
            row["rows"] += int(rec.get("rows", 0))
            row["detectors"] = rec.get("detectors")
            row["breaching"] = rec.get("breaching", [])
            row["drifting"] = bool(rec.get("drifting"))
        elif rec["kind"] == "drift":
            row["events"] += 1
            row["drifting"] = True
        elif rec["kind"] == "recovered":
            row["drifting"] = False
        elif rec["kind"] == "update":
            # Serve-and-learn actuator records.  Every
            # learner decision rides the stream (the triple-recording
            # contract), tagged by ``action``: only APPLIED updates
            # count as updates and only failed attempts as failures —
            # skips/evaluations are context, not actuation.
            act = rec.get("action", "applied" if rec.get("ok", True)
                          else "failed")
            if act == "applied":
                row["updates"] += 1
                row["last_update"] = rec.get("ts")
            elif act == "failed":
                row["update_failures"] += 1
        elif rec["kind"] == "rollback":
            row["rollbacks"] += 1
    drifting = sorted(m for m, r in models.items() if r["drifting"])
    return {"files": [str(f) for f in files],
            "models": dict(sorted(models.items())),
            "drifting": drifting,
            "healthy": not drifting,
            "thresholds": dict(COMMITTED_THRESHOLDS)}


def format_quality_status(report: dict) -> str:
    """The ``serve-status`` table: one row per model — windows, rows,
    latest detector readings, debounced state."""
    n = len(report["models"])
    head = (f"serving quality: {n} model{'s' if n != 1 else ''}, "
            f"{'HEALTHY' if report['healthy'] else 'DRIFTING: ' + str(report['drifting'])}")
    lines = [head,
             f"  {'model':<16} {'windows':>7} {'rows':>9} {'psi':>8} "
             f"{'js':>8} {'score_r':>8} {'neartie':>8} {'events':>6}"
             f"  state"]

    def _fmt(v):
        return f"{v:.4f}" if isinstance(v, (int, float)) else "-"

    for mid, row in report["models"].items():
        det = row.get("detectors") or {}
        state = "DRIFTING" if row["drifting"] else (
            "ok" if row.get("reference") else "no-reference")
        # Serve-and-learn annotation: the actuator's applied
        # updates / rollbacks ride the state column, so a drifting row
        # also says whether the loop already acted on it.
        learn = []
        if row.get("updates"):
            learn.append(f"{row['updates']}upd")
        if row.get("rollbacks"):
            learn.append(f"{row['rollbacks']}rb")
        if learn:
            state += f" ({','.join(learn)})"
        lines.append(
            f"  {mid[:16]:<16} {row['windows']:>7} {row['rows']:>9} "
            f"{_fmt(det.get('psi')):>8} {_fmt(det.get('js')):>8} "
            f"{_fmt(det.get('score_ratio')):>8} "
            f"{_fmt(det.get('near_tie_frac')):>8} "
            f"{row['events']:>6}  {state}")
    return "\n".join(lines)
