"""Fleet observability: merged timelines and straggler detection.

Counterpart of the half of the JAX package's ``obs/fleet.py`` that reads
telemetry files; it never adds a launch, a thread or a byte to the runs
it observes:

* **Merged timelines.**  :func:`merge_traces` aligns several processes'
  trace JSONL streams (``trace.p{idx}.jsonl``, ``obs.trace``) onto one
  clock and returns one record list.  Clock rule: processes leaving a
  SYNCED barrier (a ``fleet.barrier`` event with ``synced``) do so at the
  same instant up to the release skew, so the common barriers anchor each
  process's monotonic clock to the first process's; with two or more the
  spread of the per-barrier offsets bounds the drift (``skew_bound_s``,
  accepted under :data:`FLEET_SKEW_BOUND_S`).  Streams without synced
  barriers fall back to the wall-clock anchors of their headers
  (``align='wall'``).  Inputs with neither raise
  :class:`~kmeans_tpu_torch.obs.trace.TraceReadError`.
* **Stragglers.**  :func:`straggler_report` over merged heartbeats (the
  fits' ``obs.heartbeat`` sinks, or a serving fleet's ``hb.<replica>.jsonl``)
  flags per-process lag, slowness and stalls by the committed thresholds
  below; :func:`format_fleet_status` renders the table.

* **Collective bytes.**  :func:`comm_bytes_model` is the bill of the
  collectives a fit sends, site by site, in the port's form: every
  collective is an ``all_reduce`` (``parallel.mesh``), so a gather is a
  SUM of zero-embedded blocks, an owner pick a MIN of the distance then a
  MIN of the block index, the farthest point a MAX, a MIN and a SUM, and
  the statistics go as one packed buffer.  A site's ``count`` is its calls
  per iteration, one per axis group it reduces over.  The measured side is
  a cost record's ``collective_bytes`` (``parallel.mesh.COLLECTIVES``
  over one step call, or one device-loop iteration);
  :func:`comm_crosscheck` holds the two to :data:`COMM_AGREEMENT_RTOL`.
  Where a site is the same collective as the reference's (the
  statistics' psums), its bytes equal the reference's sum of them.

Pure stdlib.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence

from kmeans_tpu_torch.obs import trace as _trace
from kmeans_tpu_torch.obs.trace import TraceReadError

__all__ = [
    "expand_fleet_paths", "sniff_stream", "load_trace",
    "merge_traces",
    "read_heartbeats", "merge_heartbeats", "straggler_report",
    "format_fleet_status", "format_fleet_summary",
    "comm_bytes_model", "comm_crosscheck", "format_comm_table",
    "FLEET_SKEW_BOUND_S", "COMM_AGREEMENT_RTOL",
    "STRAGGLER_RATE_FACTOR", "STRAGGLER_BEHIND_ITERS",
    "STRAGGLER_STALL_FACTOR", "STRAGGLER_STALL_MIN_S",
    "TERMINAL_PHASES",
]

#: Committed barrier-alignment acceptance bound (seconds): the measured
#: per-host offset spread across common synced barriers must stay under
#: this for a merge to be trusted — asserted by the real multi-process
#: tests.  Localhost barrier release skew is ~ms; 250 ms leaves head-
#: room for loaded CI hosts while still catching a mis-paired barrier
#: (which skews by whole fit-lengths).
FLEET_SKEW_BOUND_S = 0.25

#: Committed modelled-against-measured collective-bytes band (the
#: reference's): |ratio - 1| <= 10 %.
COMM_AGREEMENT_RTOL = 0.10

#: Straggler decision rules, committed (the repo's pre-registration
#: discipline).  A host flags:
#: * ``slow``   — rows_per_sec < RATE_FACTOR x the fleet median,
#: * ``behind`` — iteration trails the fleet leader by >= BEHIND_ITERS,
#: * ``stalled`` — it is silent for longer than
#:   max(STALL_FACTOR x the fleet median beat interval, STALL_MIN_S)
#:   (the floor keeps sub-second CPU fits from flagging on scheduler
#:   jitter) AND either trails the leader, or — under an EXPLICIT
#:   ``now`` (a live monitor's wall clock) — its last
#:   beat is not a TERMINAL one.  Post-hoc reads (``now`` defaulted to
#:   the newest record) keep the behind-only rule: every host of a
#:   completed fleet is "old", and flagging them all would make every
#:   post-mortem read as a mass stall.  A live read is different: a
#:   host at the leader iteration whose last phase is mid-fit and that
#:   has gone silent past the window IS stalled (the whole fleet being
#:   paused must not read healthy), while a host whose last beat is
#:   terminal (:data:`TERMINAL_PHASES`) finished its fit and never
#:   flags.
STRAGGLER_RATE_FACTOR = 0.5
STRAGGLER_BEHIND_ITERS = 2
STRAGGLER_STALL_FACTOR = 3.0
STRAGGLER_STALL_MIN_S = 1.0

#: Heartbeat phases that mark a host's fit COMPLETE (the end-of-fit
#: completion beats: ``finished`` from the host-loop/stream engines,
#: ``fit`` from the one-dispatch completion record).  A terminal last
#: beat means silence is success, not a stall.
TERMINAL_PHASES = ("fit", "finished")


# ------------------------------------------------------------- loading

def expand_fleet_paths(paths) -> List[str]:
    """Resolve CLI inputs into trace/heartbeat files: a directory
    expands to its sorted ``*.jsonl`` members, a glob pattern to its
    matches, a file to itself.  Raises :class:`TraceReadError` when an
    input names nothing (the exit-2 contract)."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        p = str(p)
        if os.path.isdir(p):
            hits = sorted(glob.glob(os.path.join(p, "*.jsonl")))
            if not hits:
                raise TraceReadError(f"{p}: directory holds no .jsonl "
                                     f"files")
            out.extend(hits)
        elif glob.has_magic(p):
            hits = sorted(glob.glob(p))
            if not hits:
                raise TraceReadError(f"{p}: glob matched no files")
            out.extend(hits)
        else:
            if not os.path.exists(p):
                raise TraceReadError(f"cannot read trace file {p}: "
                                     f"no such file")
            out.append(p)
    seen = set()
    uniq = []
    for p in out:
        if p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq


def sniff_stream(path) -> str:
    """Cheap first-line content sniff: ``'trace'`` (a JSON object with
    ``"kind"`` — header/span/event records), ``'heartbeat'`` (a JSON
    object with ``"ts"`` and no ``"kind"``), else ``'unknown'``.  The
    ONE classification rule both CLIs use to tell co-located telemetry
    files apart (``obs.tracing`` and ``obs.heartbeat`` sinks naturally
    share a directory): each CLI skips the OTHER family and keeps
    ``'unknown'`` for its strict reader — a garbage file must classify
    as malformed (exit 2), never be silently dropped as "the other
    kind"."""
    try:
        with open(path) as f:
            first = f.readline()
        rec = json.loads(first)
    except (OSError, ValueError):
        return "unknown"
    if not isinstance(rec, dict):
        return "unknown"
    if "kind" in rec:
        return "trace"
    if "ts" in rec:
        return "heartbeat"
    return "unknown"


def load_trace(path) -> dict:
    """One host's trace stream: ``{"path", "header", "records",
    "process_index", "process_count", "host", "wall0"}``.  Identity is
    read from the header record or the first span/event's
    stamps; a stream carrying neither still loads (``process_index``
    None) — single-stream analyses work, fleet merges then key off
    file order."""
    records = _trace.read_jsonl(path)
    header = next((r for r in records if r.get("kind") == "header"), None)
    body = [r for r in records if r.get("kind") in ("span", "event")]
    src = header if header and "process_index" in header else \
        next((r for r in body if "process_index" in r), {})
    return {
        "path": str(path),
        "header": header,
        "records": body,
        "process_index": src.get("process_index"),
        "process_count": src.get("process_count"),
        "host": src.get("host"),
        "wall0": (header or {}).get("wall0"),
    }


def _barriers(stream: dict) -> List[dict]:
    """The stream's SYNCED fleet-barrier events, in occurrence order
    (only a barrier that really crossed processes anchors clocks; the
    single-process/simulated emission is a marker, not a sync)."""
    out = []
    for r in stream["records"]:
        if r.get("kind") == "event" and r.get("name") == "fleet.barrier":
            attrs = r.get("attrs", {}) or {}
            if attrs.get("synced"):
                out.append(r)
    return out


# ------------------------------------------------------------- merging

def merge_traces(paths_or_streams) -> dict:
    """Merge per-host trace streams into one clock-aligned timeline.

    Accepts paths (str/PathLike, dirs/globs expanded) or pre-loaded
    :func:`load_trace` dicts.  Returns::

        {"hosts":   [{process_index, host, path, offset_s, records}...],
         "align":   "single" | "barrier" | "wall",
         "barriers": <common synced barriers used>,
         "skew_bound_s": <measured drift bound; None under 'wall'>,
         "ntp_delta_s":  <wall-vs-barrier clock disagreement; info>,
         "records": [aligned span/event records, t-sorted]}

    Aligned records are COPIES stamped ``fleet_merged`` (their
    ``t0``/``t1`` live on the reference host's clock; chrome export
    tracks by ``process_index``).  Raises :class:`TraceReadError` for
    malformed streams, duplicate process indices, or clock-unalignable
    inputs (multiple hosts, no synced barriers, no wall anchors)."""
    streams = []
    for item in (paths_or_streams if isinstance(paths_or_streams,
                                                (list, tuple))
                 else [paths_or_streams]):
        if isinstance(item, dict):
            streams.append(item)
        else:
            for p in expand_fleet_paths(item):
                streams.append(load_trace(p))
    if not streams:
        raise TraceReadError("no trace streams to merge")
    # Stable identity per stream: stamped index, else file order.
    for i, s in enumerate(streams):
        if s.get("process_index") is None:
            s["process_index"] = i
        if not s.get("host"):
            s["host"] = f"host{s['process_index']}"
    idxs = [s["process_index"] for s in streams]
    if len(set(idxs)) != len(idxs):
        dupes = sorted({i for i in idxs if idxs.count(i) > 1})
        raise TraceReadError(
            f"duplicate process_index {dupes} across trace streams — "
            f"merging two files from the same process double-counts it")
    streams.sort(key=lambda s: s["process_index"])
    ref = streams[0]

    align = "single"
    barriers_used = 0
    skew_bound: Optional[float] = None
    ntp_delta: Optional[float] = None
    offsets: Dict[int, float] = {ref["process_index"]: 0.0}
    if len(streams) > 1:
        per_host = [_barriers(s) for s in streams]
        m = min(len(b) for b in per_host)
        if m >= 1:
            # Tag sequences must agree position-by-position: SPMD hosts
            # execute the same barriers in the same order; a mismatch
            # means the streams are from different runs.
            tags = [[(b.get("attrs") or {}).get("tag") for b in bs[:m]]
                    for bs in per_host]
            if any(t != tags[0] for t in tags[1:]):
                raise TraceReadError(
                    "clock-unalignable: fleet.barrier tag sequences "
                    f"disagree across hosts ({tags}) — streams are not "
                    f"from one run")
            align = "barrier"
            barriers_used = m
            ref_t = [b["t0"] for b in per_host[0]]
            skew_bound = 0.0
            for s, bs in zip(streams[1:], per_host[1:]):
                per_b = [ref_t[j] - bs[j]["t0"] for j in range(m)]
                offsets[s["process_index"]] = per_b[0]
                skew_bound = max(skew_bound,
                                 max(abs(o - per_b[0]) for o in per_b))
            if ref["wall0"] is not None and all(
                    s["wall0"] is not None for s in streams[1:]):
                ntp_delta = max(
                    (abs((s["wall0"] + bs[0]["t0"])
                         - (ref["wall0"] + ref_t[0]))
                     for s, bs in zip(streams[1:], per_host[1:])),
                    default=0.0)
        else:
            if any(s["wall0"] is None for s in streams):
                raise TraceReadError(
                    "clock-unalignable: streams share no synced "
                    "fleet.barrier event and lack wall-clock headers")
            align = "wall"
            for s in streams[1:]:
                offsets[s["process_index"]] = s["wall0"] - ref["wall0"]

    merged: List[dict] = []
    hosts = []
    for s in streams:
        off = offsets[s["process_index"]]
        hosts.append({"process_index": s["process_index"],
                      "host": s["host"], "path": s.get("path"),
                      "offset_s": off, "records": len(s["records"])})
        for r in s["records"]:
            r2 = dict(r)
            r2["t0"] = r["t0"] + off
            if r.get("t1") is not None:
                r2["t1"] = r["t1"] + off
            r2.setdefault("process_index", s["process_index"])
            r2.setdefault("host", s["host"])
            r2["fleet_merged"] = True
            merged.append(r2)
    merged.sort(key=lambda r: r["t0"])
    return {"hosts": hosts, "align": align, "barriers": barriers_used,
            "skew_bound_s": skew_bound, "ntp_delta_s": ntp_delta,
            "records": merged}


def format_fleet_summary(merged: dict) -> str:
    """One operator-facing block describing a merged timeline: host
    roster with clock offsets, the alignment rule used, and its
    measured skew bound."""
    lines = [f"fleet timeline: {len(merged['hosts'])} host"
             f"{'s' if len(merged['hosts']) != 1 else ''}, "
             f"{len(merged['records'])} records, "
             f"align={merged['align']}"
             + (f" ({merged['barriers']} barriers)"
                if merged["align"] == "barrier" else "")]
    if merged["skew_bound_s"] is not None:
        lines[0] += f", skew_bound={merged['skew_bound_s'] * 1e3:.3f}ms"
    if merged.get("ntp_delta_s") is not None:
        lines[0] += f", wall_delta={merged['ntp_delta_s'] * 1e3:.1f}ms"
    lines.append(f"  {'proc':>4} {'host':<20} {'offset ms':>12} "
                 f"{'records':>8}")
    for h in merged["hosts"]:
        lines.append(f"  {h['process_index']:>4} {h['host'][:20]:<20} "
                     f"{h['offset_s'] * 1e3:>12.3f} {h['records']:>8}")
    return "\n".join(lines)


# ---------------------------------------------------------- heartbeats

def read_heartbeats(path) -> List[dict]:
    """Heartbeat JSONL -> records.  Tolerant of trailing torn lines (a
    live fit's sink may be mid-write — the fleet-status use case) but
    classifies a file with NO parseable record as malformed."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError as e:
        raise TraceReadError(f"cannot read heartbeat file {path}: {e}") \
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
        if not isinstance(rec, dict) or "ts" not in rec:
            raise TraceReadError(
                f"{path}:{i + 1}: not a heartbeat record (missing 'ts')")
        records.append(rec)
    if not records:
        raise TraceReadError(f"{path}: no heartbeat records")
    return records


def merge_heartbeats(paths) -> List[dict]:
    """All hosts' heartbeat records, ts-sorted.  Heartbeats are merged
    on their wall clocks (records carry ``ts``): straggler thresholds
    are seconds-scale, far above same-fleet NTP skew; identity comes
    from each record's own stamps (falling back to file order)."""
    out: List[dict] = []
    for i, p in enumerate(expand_fleet_paths(paths)):
        for rec in read_heartbeats(p):
            rec = dict(rec)
            rec.setdefault("process_index", i)
            rec.setdefault("host", f"host{i}")
            out.append(rec)
    out.sort(key=lambda r: r.get("ts", 0.0))
    return out


def _median(vals: Sequence[float]) -> Optional[float]:
    """True median (midpoint-averaged for even counts) — NOT the
    nearest-rank rule the histograms use: on a 2-host fleet nearest
    rank degenerates to one host's own value, which would let that host
    define the 'fleet' it is compared against and never flag."""
    vals = sorted(vals)
    if not vals:
        return None
    mid = len(vals) // 2
    if len(vals) % 2:
        return vals[mid]
    return 0.5 * (vals[mid - 1] + vals[mid])


def straggler_report(records: List[dict], *, now: Optional[float] = None,
                     rate_factor: float = STRAGGLER_RATE_FACTOR,
                     behind_iters: int = STRAGGLER_BEHIND_ITERS,
                     stall_factor: float = STRAGGLER_STALL_FACTOR,
                     stall_min_s: float = STRAGGLER_STALL_MIN_S) -> dict:
    """Per-host progress/liveness/lag over merged heartbeat records,
    with the committed straggler rules (module docstring).  ``now``
    defaults to the newest record's ``ts`` (post-hoc analysis); a live
    monitor passes ``time.time()``.  Returns ``{"hosts": [row...],
    "flagged": [process_index...], "healthy": bool, ...}`` — the
    payload :func:`format_fleet_status` renders."""
    by_host: Dict[int, List[dict]] = {}
    names: Dict[int, str] = {}
    for r in records:
        idx = int(r.get("process_index", 0))
        by_host.setdefault(idx, []).append(r)
        names.setdefault(idx, str(r.get("host", f"host{idx}")))
    if not by_host:
        raise TraceReadError("no heartbeat records to report on")
    # An EXPLICIT now is a live monitor's wall clock; the default is
    # post-hoc analysis anchored to the newest record.  The stall rule
    # below is stricter under a live clock: a paused
    # fleet must not read healthy just because nobody is behind.
    live = now is not None
    if now is None:
        now = max(r.get("ts", 0.0) for r in records)

    rows = []
    for idx in sorted(by_host):
        recs = sorted(by_host[idx], key=lambda r: r.get("ts", 0.0))
        beats = [r for r in recs if not r.get("tick")]
        iters = [r["iteration"] for r in recs if "iteration" in r]
        rates = [r["rows_per_sec"] for r in beats
                 if r.get("rows_per_sec")]
        ts = [r["ts"] for r in beats]
        intervals = [b - a for a, b in zip(ts, ts[1:]) if b > a]
        rows.append({
            "process_index": idx, "host": names[idx],
            "beats": len(beats), "ticks": len(recs) - len(beats),
            "phase": recs[-1].get("phase"),
            "iteration": max(iters) if iters else None,
            "inertia": recs[-1].get("inertia"),
            "rows_per_sec": _median(rates),
            "beat_interval_s": _median(intervals),
            "ts": recs[-1].get("ts"),
            "last_age_s": max(0.0, now - recs[-1].get("ts", now)),
            "flags": [],
        })

    lead = max((r["iteration"] for r in rows
                if r["iteration"] is not None), default=None)
    fleet_rate = _median([r["rows_per_sec"] for r in rows
                          if r["rows_per_sec"]])
    fleet_interval = _median([r["beat_interval_s"] for r in rows
                              if r["beat_interval_s"]])
    for r in rows:
        behind = (lead - r["iteration"]
                  if lead is not None and r["iteration"] is not None
                  else 0)
        r["behind"] = behind
        if behind >= behind_iters:
            r["flags"].append("behind")
        if len(rows) > 1 and r["rows_per_sec"] and fleet_rate \
                and r["rows_per_sec"] < rate_factor * fleet_rate:
            r["flags"].append("slow")
        stall_after = max(stall_factor * (fleet_interval or 0.0),
                          stall_min_s)
        # Post-hoc (default now): behind-only, so a completed fleet's
        # uniformly-old beats stay silent.  Live (explicit now): a host
        # whose last beat is MID-FIT and silent past the window is
        # stalled even at the leader iteration — the live-but-paused
        # fleet a live monitor must see; terminal completion
        # beats (TERMINAL_PHASES) exempt finished hosts.
        mid_fit = r["phase"] not in TERMINAL_PHASES
        if (behind > 0 or (live and mid_fit)) \
                and r["last_age_s"] > stall_after:
            r["flags"].append("stalled")
    flagged = [r["process_index"] for r in rows if r["flags"]]
    return {"hosts": rows, "flagged": flagged,
            "healthy": not flagged, "now": now,
            "fleet": {"leader_iteration": lead,
                      "median_rows_per_sec": fleet_rate,
                      "median_beat_interval_s": fleet_interval},
            "thresholds": {"rate_factor": rate_factor,
                           "behind_iters": behind_iters,
                           "stall_factor": stall_factor,
                           "stall_min_s": stall_min_s}}


def format_fleet_status(report: dict) -> str:
    """The ``fleet-status`` table: one row per host —
    progress (iteration/phase), throughput, liveness, lag flags."""
    f = report["fleet"]
    head = (f"fleet status: {len(report['hosts'])} host"
            f"{'s' if len(report['hosts']) != 1 else ''}, leader at "
            f"iteration {f['leader_iteration']}, "
            f"{'HEALTHY' if report['healthy'] else 'STRAGGLERS: ' + str(report['flagged'])}")
    lines = [head,
             f"  {'proc':>4} {'host':<18} {'phase':<10} {'iter':>6} "
             f"{'behind':>6} {'rows/s':>10} {'beat s':>8} {'age s':>7}"
             f"  flags"]
    for r in report["hosts"]:
        rate = f"{r['rows_per_sec']:.0f}" if r["rows_per_sec"] else "-"
        beat = f"{r['beat_interval_s']:.3f}" \
            if r["beat_interval_s"] is not None else "-"
        it = r["iteration"] if r["iteration"] is not None else "-"
        lines.append(
            f"  {r['process_index']:>4} {r['host'][:18]:<18} "
            f"{str(r['phase'])[:10]:<10} {it:>6} {r['behind']:>6} "
            f"{rate:>10} {beat:>8} {r['last_age_s']:>7.2f}"
            f"  {','.join(r['flags']) or '-'}")
    return "\n".join(lines)


# ------------------------------------------------- collective accounting

def _ring_wire(result_bytes: float, group: int, collective: str) -> float:
    """Per-device bytes on the wire under the ring algorithm (the
    reference's): an all-reduce moves ``2 (S-1)/S`` of its payload, an
    all-gather ``(S-1)/S`` of its result; zero for a group of one."""
    if group <= 1:
        return 0.0
    if collective == "all-reduce":
        return 2.0 * (group - 1) / group * result_bytes
    return (group - 1) / group * result_bytes


def comm_bytes_model(family: str = "kmeans", *, k: int, d: int,
                     data_shards: int = 1, model_shards: int = 1,
                     acc_bytes: int = 4, compute_sse: bool = True,
                     empty_cluster: str = "keep", cov_type: str = "diag",
                     n_members: int = 1, n_chunks: int = 1,
                     seeding_rounds: int = 0, seeding_cap: int = 0,
                     processes: int = 1, k_shard: int = 0,
                     chunk_rows: int = 0, rows: int = 0,
                     need_sse_pc: bool = False) -> dict:
    """The collective bill of one fit in the port (the module's docstring),
    under the reference's keys: ``sites`` (``site``, ``collective``,
    ``result_bytes``, ``scope``, ``count``, ``group``, ``in_program``,
    ``wire_bytes_per_device``), ``per_iteration_bytes``,
    ``per_fit_bytes``, ``hlo_program_bytes`` (what one step call, or one
    device-loop iteration, sends: the in-program sites' bytes times their
    calls) and ``wire_bytes_per_device_per_iteration``.

    The port always sends the SSE in the statistics' buffer
    (``compute_sse`` changes nothing), and ``need_sse_pc`` adds the
    per-cluster SSE to it.  ``rows`` (a rank's rows) sizes the owner pick
    of a model axis.  ``n_chunks`` is the reference's argument; the
    port's K-Means steps send nothing per chunk.  The mixture on a model
    axis sends, for each chunk of ``chunk_rows`` of the rank's ``rows`` (the
    last one short), a MAX and a SUM of the chunk's row statistics over the
    axis (``chunk_rows=0``: one of each over all the rows, as the kernel
    mode sends them), and its statistics embedded into the padded table over
    both axes, as the K-Means statistics are."""
    S, M = int(data_shards), int(model_shards)
    group = S * M
    R = int(n_members)
    k_pad = -(-int(k) // M) * M if M > 1 else int(k)
    kl = k_pad // M
    both = 2 if M > 1 else 1              # axis calls of an (data, model)
    sites: List[dict] = []

    def site(name, result_bytes, *, scope, count=1, grp=group,
             in_program=True, op="sum"):
        sites.append({
            "site": name, "collective": "all-reduce", "op": op,
            "result_bytes": float(result_bytes), "scope": scope,
            "count": count, "group": grp, "in_program": in_program,
            "wire_bytes_per_device": _ring_wire(result_bytes, grp,
                                                "all-reduce")})

    kshard = bool(k_shard) and M > 1
    if family in ("kmeans", "spherical", "bisecting", "minibatch"):
        pc = 1 if need_sse_pc else 0
        if kshard:
            site("estep.psum_stats", R * (kl * d + kl + pc * kl)
                 * acc_bytes, scope="iteration", grp=S)
            site("estep.psum_sse", R * acc_bytes, scope="iteration",
                 count=both)
        else:
            site("estep.psum_stats", R * (k_pad * d + k_pad + 1
                                          + pc * k_pad) * acc_bytes,
                 scope="iteration", count=both)
        if M > 1:
            # The owner of each row over the model axis: MIN of its
            # distance, then MIN of the block index (int32).
            site("tp.pmin_owner_dist", R * rows * acc_bytes,
                 scope="iteration", grp=M, op="min")
            site("tp.pmin_owner_block", R * rows * 4, scope="iteration",
                 grp=M, op="min")
        if empty_cluster == "farthest":
            site("estep.pmax_farthest_dist", R * acc_bytes,
                 scope="iteration", count=both, op="max")
            site("estep.pmin_farthest_rank", R * 8, scope="iteration",
                 count=both, op="min")
            site("estep.psum_farthest_point", R * d * acc_bytes,
                 scope="iteration", count=both)
    elif family == "gmm":
        moment = {"diag": k_pad * d, "spherical": k_pad * d,
                  "tied": k_pad * d, "full": k_pad * d * d}
        if cov_type not in moment:
            raise ValueError(f"unknown covariance type {cov_type!r}")
        # resp (k), xsum (k, D), the second moment, loglik: one buffer
        # over the data axis ('tied' sends its zero squares along); on a
        # model axis over both, the blocks embedded in the padded table.
        stats = R * (k_pad + k_pad * d + moment[cov_type] + 1) * acc_bytes
        if M > 1:
            site("estep.psum_stats", stats, scope="iteration", count=both)
            # The softmax of each chunk (the kernel mode: of all the rows):
            # its rows' maximum, then their denominator, over the model
            # axis.
            chunk = int(chunk_rows) or int(rows)
            full, tail = divmod(int(rows), chunk) if chunk else (0, 0)
            for name, op in (("estep.pmax_row_max", "max"),
                             ("estep.psum_row_sum", "sum")):
                if full:
                    site(name, R * chunk * acc_bytes, scope="iteration",
                         count=full, grp=M, op=op)
                if tail:
                    site(name + "_tail", R * tail * acc_bytes,
                         scope="iteration", grp=M, op=op)
        else:
            site("estep.psum_stats", stats, scope="iteration", grp=S)
        site("fit.psum_weight_total", acc_bytes, scope="dispatch", grp=S,
             in_program=False)
        if cov_type == "tied":
            site("fit.psum_total_scatter", d * d * acc_bytes, scope="fit",
                 grp=S, in_program=False)
    else:
        raise ValueError(f"unknown family {family!r}")

    if seeding_rounds and seeding_cap:
        # k-means||: per round the candidates' scores and rows as SUMs of
        # zero-embedded blocks over the data axis.
        per_round = S * seeding_cap * (acc_bytes + d * acc_bytes)
        site("seed.psum_topk", per_round, scope="fit",
             count=seeding_rounds, grp=S, in_program=False)
    if processes > 1:
        site("data.psum_counts", processes * 8, scope="dataset",
             grp=processes, in_program=False)

    per_iter = sum(s["result_bytes"] * s["count"] for s in sites
                   if s["scope"] == "iteration")
    per_fit = sum(s["result_bytes"] * s["count"] for s in sites
                  if s["scope"] in ("dispatch", "fit", "dataset"))
    program = sum(s["result_bytes"] * s["count"] for s in sites
                  if s["in_program"])
    wire_iter = sum(s["wire_bytes_per_device"] * s["count"]
                    for s in sites if s["scope"] == "iteration")
    return {"family": family, "k": k, "k_pad": k_pad, "d": d,
            "data_shards": S, "model_shards": M, "acc_bytes": acc_bytes,
            "n_members": R, "k_shard": int(k_shard) if kshard else 0,
            "sites": sites,
            "per_iteration_bytes": per_iter,
            "per_fit_bytes": per_fit,
            "hlo_program_bytes": program,
            "wire_bytes_per_device_per_iteration": wire_iter}


def comm_crosscheck(model: dict, record,
                    rtol: float = COMM_AGREEMENT_RTOL) -> dict:
    """Modelled against measured collective bytes of one program (the
    reference's rule): ``ratio`` = the record's ``collective_bytes`` over
    the model's ``hlo_program_bytes``, ``agree`` within ``rtol``; None
    where nothing was measured."""
    measured = getattr(record, "collective_bytes", None)
    expected = model["hlo_program_bytes"]
    ratio = (measured / expected
             if measured is not None and expected > 0 else None)
    return {"analytic_bytes": expected, "measured_bytes": measured,
            "collectives": getattr(record, "collectives", None),
            "ratio": ratio,
            "agree": (None if ratio is None
                      else bool(abs(ratio - 1.0) <= rtol)),
            "rtol": rtol}


def format_comm_table(model: dict, crosscheck: Optional[dict] = None
                      ) -> str:
    """Fixed-width rendering of the bill, and the measured line where a
    crosscheck ran (the reference's layout; the collective column names
    the reduction)."""
    lines = [f"collective traffic (analytic, {model['family']} "
             f"k={model['k']} d={model['d']} "
             f"S={model['data_shards']}x{model['model_shards']}):",
             f"  {'site':<28} {'collective':<12} {'bytes':>10} "
             f"{'count':>6} {'scope':<10} {'wire/dev':>10}"]
    for s in model["sites"]:
        coll = f"{s['collective']}:{s.get('op', 'sum')}"
        lines.append(
            f"  {s['site']:<28} {coll:<12} "
            f"{s['result_bytes']:>10.0f} {s['count']:>6} "
            f"{s['scope']:<10} {s['wire_bytes_per_device']:>10.0f}")
    lines.append(
        f"  per-iteration {model['per_iteration_bytes']:.0f} B "
        f"(wire/dev {model['wire_bytes_per_device_per_iteration']:.0f} "
        f"B); per-fit extras {model['per_fit_bytes']:.0f} B; "
        f"fit-program collectives {model['hlo_program_bytes']:.0f} B")
    if crosscheck is not None:
        m = crosscheck["measured_bytes"]
        r = crosscheck["ratio"]
        lines.append(
            f"  measured (mesh.all_reduce): "
            f"{f'{m:.0f} B' if m is not None else '-'} "
            f"ratio={f'{r:.3f}' if r is not None else '-'} "
            f"agree={crosscheck['agree']} "
            f"(band ±{crosscheck['rtol']:.0%})")
    return "\n".join(lines)
