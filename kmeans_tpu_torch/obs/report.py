"""Time-to-first-iteration and device-cost reports, from spans and records.

Counterpart of the JAX package's ``obs/report.py``: run a fit under
``obs.tracing()`` and the span records alone give the table of what a user
waits for between calling ``fit`` and the end of the first iteration,
formatted through ``utils.profiling.phase_ceiling_table`` (share of the
total, the implied ceiling if the phase were free, the committed >= 15 %
"actionable" rule).  The reference's attribution rules:

* a phase row sums the SELF time (nested children excluded,
  ``trace.self_times``) of its spans that start before the end of the
  first ``dispatch`` span;
* ``first_dispatch`` is the first ``dispatch`` span's self time.  In the
  port it holds the first iteration's launches and its readback; the
  kernels' library loads and the device loop's graph capture are
  ``compile`` spans nested in it (``ops._build``,
  ``parallel.distributed``), so they land in the ``compile`` row;
* a ``segment`` span is never a row: it wraps dispatch attempts, so an
  out-of-memory replay cannot count twice.

:func:`device_cost_report` fits each family at a small shape under cost
capture (``obs.cost``) and reports the measured step program against the
hand formula and the memory plan (``obs.memory``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from kmeans_tpu_torch.obs import trace as _trace

__all__ = ["ttfi_ladder", "time_to_first_iteration",
           "format_phase_table", "TTFI_PHASES", "merge_cost",
           "format_cost_table", "device_cost_report", "REPORT_SPECS",
           "ingest_breakdown", "format_ingest_table"]

#: Lifecycle order of the phase rows before the first iteration.
TTFI_PHASES = ("place", "stage", "trace", "compile", "seed")


def ttfi_ladder(records: List[dict]) -> List[dict]:
    """Span records -> a ``measure_phase_ladder``-shaped ladder
    (``{"phase", "seconds", "cumulative", "spread"}`` in lifecycle order,
    ending with ``first_dispatch``; ``spread`` 0.0, one observed run).
    Raises ``ValueError`` when the trace holds no ``dispatch`` span."""
    spans = [r for r in records if r.get("kind") == "span"]
    dispatches = sorted((s for s in spans if s["name"] == "dispatch"),
                        key=lambda s: s["t0"])
    if not dispatches:
        raise ValueError(
            "trace holds no 'dispatch' span — nothing was dispatched, "
            "so there is no first iteration to decompose")
    fd = dispatches[0]
    fd_end = fd["t1"] if fd.get("t1") is not None else fd["t0"]
    selfs = _trace.self_times(records)
    totals: Dict[str, float] = {name: 0.0 for name in TTFI_PHASES}
    for s in spans:
        if s["name"] in totals and s["t0"] <= fd_end:
            totals[s["name"]] += selfs[s["id"]]
    ladder = []
    cum = 0.0
    for name in TTFI_PHASES:
        cum += totals[name]
        ladder.append({"phase": name, "seconds": totals[name],
                       "cumulative": cum, "spread": 0.0})
    fd_self = selfs.get(fd["id"], fd.get("dur") or 0.0)
    cum += fd_self
    ladder.append({"phase": "first_dispatch", "seconds": fd_self,
                   "cumulative": cum, "spread": 0.0})
    return ladder


def time_to_first_iteration(records: List[dict],
                            decision_share: Optional[float] = None,
                            comm_model: Optional[dict] = None
                            ) -> List[dict]:
    """The per-phase time-to-first-iteration table: one row per phase with
    ``ms`` / ``share`` / ``implied_ceiling_speedup`` / ``actionable``
    (``utils.profiling.phase_ceiling_table`` over :func:`ttfi_ladder`).
    ``comm_model`` (``obs.fleet.comm_bytes_model``) puts the collective
    bytes on the ``first_dispatch`` row.  Where the trace carries
    ``cost.record`` events, a row gains the flops and bytes of the
    programs first called under its phase (the ``dispatch`` phase for
    ``first_dispatch``)."""
    from kmeans_tpu_torch.utils import profiling
    share = profiling.PHASE_DECISION_SHARE if decision_share is None \
        else decision_share
    rows = profiling.phase_ceiling_table(ttfi_ladder(records),
                                         comm_model=comm_model,
                                         decision_share=share)
    cost = merge_cost(records)
    if cost:
        for row in rows:
            phase = "dispatch" if row["phase"] == "first_dispatch" \
                else row["phase"]
            c = cost.get(phase)
            if c and c["programs"]:
                row["flops"] = c["flops"]
                row["bytes_accessed"] = c["bytes_accessed"]
                row["ai"] = c["ai"]
    return rows


def ingest_breakdown(records: List[dict]) -> List[dict]:
    """Per-slab ingest rows from the ``stage`` spans that carry a ``slab``
    attribute: ``{"slab", "slabs", "rows", "bytes", "ms"}`` in upload
    order, ``ms`` the span's self time.  Empty without such spans."""
    spans = [r for r in records if r.get("kind") == "span"]
    selfs = _trace.self_times(records)
    rows = []
    for s in sorted(spans, key=lambda s: s["t0"]):
        attrs = s.get("attrs", {}) or {}
        if s["name"] == "stage" and "slab" in attrs:
            rows.append({"slab": int(attrs["slab"]),
                         "slabs": attrs.get("slabs"),
                         "rows": attrs.get("rows"),
                         "bytes": attrs.get("bytes"),
                         "ms": selfs[s["id"]] * 1e3})
    return rows


def format_ingest_table(rows: List[dict], title: str =
                        "ingest slabs (stage self-time per slab)") -> str:
    """Fixed-width rendering of an :func:`ingest_breakdown`."""
    lines = [f"{title}:",
             f"  {'slab':>6} {'rows':>10} {'bytes':>12} {'ms':>10}"]
    t_rows = t_bytes = 0
    t_ms = 0.0
    for r in rows:
        lines.append(f"  {r['slab']:>6} "
                     f"{(r['rows'] if r['rows'] is not None else '-'):>10} "
                     f"{(r['bytes'] if r['bytes'] is not None else '-'):>12} "
                     f"{r['ms']:>10.2f}")
        t_rows += int(r["rows"] or 0)
        t_bytes += int(r["bytes"] or 0)
        t_ms += r["ms"]
    lines.append(f"  {'TOTAL':>6} {t_rows:>10} {t_bytes:>12} "
                 f"{t_ms:>10.2f}")
    return "\n".join(lines)


def merge_cost(records: List[dict]) -> Dict[str, dict]:
    """``cost.record`` events rolled up by the span their program's first
    call ran under: ``{phase: {programs, flops, bytes_accessed,
    peak_bytes, ai, unavailable}}``; empty without cost records."""
    spans = {r["id"]: r for r in records if r.get("kind") == "span"}
    out: Dict[str, dict] = {}
    for r in records:
        if r.get("kind") != "event" or r.get("name") != "cost.record":
            continue
        attrs = r.get("attrs", {}) or {}
        parent = spans.get(r.get("parent"))
        phase = parent["name"] if parent else "-"
        agg = out.setdefault(phase, {
            "programs": 0, "flops": 0.0, "bytes_accessed": 0.0,
            "peak_bytes": 0, "unavailable": 0, "ai": None})
        if attrs.get("available"):
            agg["programs"] += 1
            agg["flops"] += float(attrs.get("flops") or 0.0)
            agg["bytes_accessed"] += float(attrs.get("bytes_accessed")
                                           or 0.0)
            agg["peak_bytes"] = max(agg["peak_bytes"],
                                    int(attrs.get("peak_bytes") or 0))
        else:
            agg["unavailable"] += 1
    for agg in out.values():
        if agg["bytes_accessed"]:
            agg["ai"] = agg["flops"] / agg["bytes_accessed"]
    return out


def format_phase_table(rows: List[dict], title: str =
                       "time-to-first-iteration") -> str:
    """Fixed-width rendering of a phase table (the reference's text)."""
    lines = [f"{title}:",
             f"  {'phase':<16} {'ms':>10} {'share':>7} "
             f"{'ceiling':>8}  actionable"]
    for r in rows:
        ceil = r.get("implied_ceiling_speedup")
        lines.append(
            f"  {r['phase']:<16} {r['ms']:>10.2f} {r['share']:>6.1%} "
            f"{(f'{ceil:.3f}x' if ceil is not None else '-'):>8}  "
            f"{'YES' if r.get('actionable') else 'no'}")
    total_ms = sum(r["ms"] for r in rows)
    lines.append(f"  {'TOTAL':<16} {total_ms:>10.2f}")
    for r in rows:
        if "comm_bytes_per_iter" in r:
            lines.append(
                f"  comm ({r['phase']}): "
                f"{r['comm_bytes_per_iter']:.0f} B/iter analytic "
                f"collectives, "
                f"{r['comm_wire_bytes_per_device']:.0f} B/iter wire "
                f"per device (ring)")
    return "\n".join(lines)


# ------------------------------------------------------ device cost

def _fmt_num(v, unit: str = "") -> str:
    if v is None:
        return "-"
    v = float(v)
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"),
                          (1e3, "k")):
        if abs(v) >= scale:
            return f"{v / scale:.2f}{suffix}{unit}"
    return f"{v:.2f}{unit}"


def format_cost_table(rows: List[dict],
                      title: str = "device cost") -> str:
    """Fixed-width rendering of :func:`device_cost_report` rows (the
    reference's columns)."""
    lines = [f"{title}:",
             f"  {'family':<10} {'program':<26} {'flops':>9} "
             f"{'analytic':>9} {'ratio':>6} {'agree':>5} {'ai':>7} "
             f"{'peak':>9} {'planned':>9}"]
    for r in rows:
        ratio = r.get("ratio")
        ratio_s = f"{ratio:.3f}" if ratio is not None else "-"
        agree_s = "-" if ratio is None else \
            ("yes" if r.get("agree") else "NO")
        ai = r.get("ai")
        ai_s = f"{ai:.2f}" if ai is not None else "-"
        lines.append(
            f"  {r['family']:<10} {r['program'][:26]:<26} "
            f"{_fmt_num(r.get('flops')):>9} "
            f"{_fmt_num(r.get('analytic_flops')):>9} "
            f"{ratio_s:>6} {agree_s:>5} {ai_s:>7} "
            f"{_fmt_num(r.get('peak_bytes'), 'B'):>9} "
            f"{_fmt_num(r.get('planned_peak_bytes'), 'B'):>9}")
    return "\n".join(lines)


#: The small shapes each family fits at (the reference's).
REPORT_SPECS = {
    "kmeans": dict(n=8192, d=128, k=64),
    "spherical": dict(n=8192, d=64, k=32),
    "bisecting": dict(n=4096, d=64, k=4),
    "minibatch": dict(n=8192, d=64, k=32, batch=2048),
    "gmm": dict(n=8192, d=64, k=32),
}


def device_cost_report(families=None, *, specs=None,
                       chunk: Optional[int] = None, device=None) -> dict:
    """Each family's small fit (``REPORT_SPECS``, overridden per family by
    ``specs``) under cost capture, on ``device`` (None: the card, as the
    estimators), by the device loop: the measured step program (the
    record with the most flops) against the hand formula
    (``obs.cost.crosscheck``) and the memory plan (``obs.memory``).
    Returns ``{"rows", "plans", "device_memory", "backend"}``.  On the
    CPU the records are the degraded form (no allocator peak), so the
    rows say ``available: False`` and keep the measured flops.  A record
    is taken at a step cache's miss, so the step caches are emptied before
    each family's fit (``utils.profiling.compile_caches``)."""
    import numpy as np
    import torch

    from kmeans_tpu_torch.models.kmeans import resolve_device
    from kmeans_tpu_torch.obs import cost as cost_mod
    from kmeans_tpu_torch.obs import memory as memory_mod
    from kmeans_tpu_torch.parallel.sharding import choose_chunk_size
    from kmeans_tpu_torch.utils.profiling import compile_caches

    dev = resolve_device(device)
    families = list(families or REPORT_SPECS)
    merged = dict(REPORT_SPECS)
    if specs:
        for fam, s in specs.items():
            merged[fam] = dict(merged.get(fam, {}), **s)
    backend = dev.type
    rows: List[dict] = []
    plans: List[dict] = []
    rng = np.random.default_rng(42)
    for family in families:
        spec = merged[family]
        n, d, k = spec["n"], spec["d"], spec["k"]
        X = (rng.standard_normal((n, d))
             + 3.0 * rng.integers(0, 3, size=(n, 1))).astype(np.float32)
        eff_chunk = int(chunk) if chunk else choose_chunk_size(n, k, d)
        for cache in compile_caches().values():
            cache.clear()
        with cost_mod.collecting() as col:
            model = _report_fit(family, X, k, eff_chunk, spec, dev)
        recs = col.records()
        step = max((r for r in recs if r.flops), key=lambda r: r.flops,
                   default=None)
        analytic = cost_mod.analytic_step_flops(
            family, n=spec.get("batch", n) if family == "minibatch"
            else n, d=d, k=k, chunk=eff_chunk)
        if family == "gmm":
            mode = model.estep_path_ if model.estep_path_ == "kernel" \
                else "torch"
        else:
            mode = model._mode()
        plan = memory_mod.plan_fit(
            family, n, d, k, chunk=eff_chunk, batch=spec.get("batch"),
            mode=mode, device=dev, records=recs)
        plans.append(plan)
        row = {"family": family, "backend": backend,
               "n": n, "d": d, "k": k, "chunk": eff_chunk, "mode": mode,
               "captured": len(recs),
               "available": bool(step is not None and step.available),
               "program": step.cache if step else "-",
               "planned_peak_bytes": plan["predicted_peak_bytes"]}
        if step is not None:
            row.update(step.to_dict())
            row["available"] = step.available
            row.update(cost_mod.crosscheck(analytic, step))
        else:
            row.update({"analytic_flops": analytic, "ratio": None,
                        "agree": False,
                        "error": "; ".join(sorted(
                            {r.error for r in recs if r.error}))
                        or "no program captured"})
        rows.append(row)
        del model, X
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return {"rows": rows, "plans": plans,
            "device_memory": memory_mod.device_memory_info(dev),
            "backend": backend}


def _report_fit(family: str, X, k: int, chunk: int, spec: dict, device):
    """One small fit through the family's device loop (the reference's
    settings); returns the fitted model."""
    from kmeans_tpu_torch.models.bisecting import BisectingKMeans
    from kmeans_tpu_torch.models.gmm import GaussianMixture
    from kmeans_tpu_torch.models.kmeans import KMeans
    from kmeans_tpu_torch.models.minibatch import MiniBatchKMeans
    from kmeans_tpu_torch.models.spherical import SphericalKMeans
    common = dict(max_iter=3, seed=0, verbose=False, device=device)
    if family == "gmm":
        return GaussianMixture(n_components=k, covariance_type="diag",
                               tol=0.0, init_params="random",
                               host_loop=False, chunk_size=chunk,
                               **common).fit(X)
    kw = dict(chunk_size=chunk, **common)
    if family == "minibatch":
        return MiniBatchKMeans(k=k, batch_size=spec.get("batch", 2048),
                               tolerance=1e-30, host_loop=False,
                               compute_labels=False, **kw).fit(X)
    if family == "bisecting":
        return BisectingKMeans(k=k, tolerance=1e-30, host_loop=False,
                               compute_labels=False, **kw).fit(X)
    if family == "spherical":
        return SphericalKMeans(k=k, tolerance=1e-30, host_loop=False,
                               empty_cluster="keep", compute_labels=False,
                               **kw).fit(X)
    return KMeans(k=k, tolerance=1e-30, host_loop=False,
                  empty_cluster="keep", compute_labels=False, **kw).fit(X)
