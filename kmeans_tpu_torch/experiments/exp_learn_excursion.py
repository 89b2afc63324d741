"""What lifts the serving p99 while a served model learns, on the card.

    python -m kmeans_tpu_torch.experiments.exp_learn_excursion \
        [reps] [out] [variants] [profile]

The protocol of ``chip_smoke.py``'s phase ``serve_learn`` (the JAX
package's ``bench_learn``): a ``MiniBatchKMeans`` at k = 1024, D = 128,
'pallas', fitted on the card, served with quality monitoring and
``learn=`` (``batch_rows`` 512, ``max_batches`` 2), fed 512-row requests;
each rep is a quiet wave of 200 ``call``s, then a wave of 200 while
another thread runs ``update_now(force=True)``.  The excursion of a rep is
p99(update wave) / p99(quiet wave); a variant's is the median over
``reps`` (default 9).  The variants (comma-separated, default all) run
interleaved within each rep, in a rotated order:

* ``update``: the update as the learner runs it (since the update gate,
  one exclusive slice between dispatches: ``serving.learn.UpdateGate``;
  run against an older tree, without it);
* ``switch``: the same with the interpreter's switch interval lowered to
  0.1 ms while it runs (CPython's default is 5 ms);
* ``nosnap``: the update with the snapshot write skipped;
* ``stream``: the update with its thread on its own CUDA stream;
* ``spin`` and ``spin_switch``: no update; the other thread runs a pure
  Python loop for the update's median wall, at the default and at the
  lowered switch interval (the control for GIL contention alone);
* ``sleep``: no update; the other thread sleeps as long (the control for
  noise);
* ``numpy`` and ``numpy_inplace``: no update; the other thread runs the
  float64 arithmetic of the host Sculley update on (1024, 128) arrays as
  long, each operation into a new array or into preallocated ones;
* ``snapshot_only``: no update; the other thread writes the model's
  snapshot (``checkpoint.save_state_rotating``) again and again as long;
* ``sleep0`` and ``tinyops``: no update; the other thread calls
  ``time.sleep(0)``, or a NumPy operation on 1,000 elements, again and
  again as long (each call lets the interpreter go and asks for it back:
  the cost of the hand-offs alone);
* ``nogc``: the update with the cyclic garbage collector off over the
  rep's two waves;
* ``inplace``: the update with the host Sculley arithmetic
  (``MiniBatchKMeans._apply_batch_stats``) written into preallocated
  (k, D) buffers, operation for operation (the same bits);
* ``memsnap``: the update with the snapshot's archive built in memory and
  written by one call (``checkpoint.save_state``);
* ``inplace_memsnap``: both.

With ``profile`` (a fourth argument ``1``), each part of a serving call
(``ServingEngine._validate``, ``_stage``, ``table_dev``, ``_place``, the
predict function's call, ``_host``, ``_record``, ``_observe_quality``,
``_feed_learner``) is timed on the serving thread, and its mean and
largest ms in the quiet and in the update waves are printed; then five
updates run with no traffic under ``cProfile`` (one profiler serves all
threads of an interpreter since Python 3.12, so it cannot run beside the
waves), and their costliest functions are printed.  Each wave also
records the process's CPU seconds over its wall seconds.

Each update's steps (snapshot, clone, each ``partial_fit``, swap) are
timed on the host clock, and each slow call of an update wave (over twice
the quiet p99) is set against the step it overlapped.  Prints one JSON
line per variant, writes every latency and step to ``out`` (default
``chiprun_out/exp_learn_excursion.json``), then the card's name and power
limit.  Needs one CUDA device."""

from __future__ import annotations

import contextlib
import cProfile
import gc
import io
import json
import os
import pstats
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

WAVE_CALLS = 200
ROWS = 512
LOWERED_SWITCH_S = 1e-4
VARIANTS = ("update", "switch", "nosnap", "stream", "spin", "spin_switch",
            "sleep", "numpy", "numpy_inplace", "snapshot_only", "nogc",
            "inplace", "memsnap", "inplace_memsnap", "sleep0", "tinyops")
_BUFS = {}


def _apply_batch_stats_inplace(self, sums, counts, centroids, seen,
                               iteration, log, *, sse, sse_scale,
                               candidates=None, do_reassign=False):
    """``MiniBatchKMeans._apply_batch_stats`` with its (k, D)
    temporaries in preallocated buffers, operation for operation."""
    key = (threading.get_ident(), centroids.shape)
    if key not in _BUFS:
        _BUFS[key] = (np.empty(centroids.shape), np.empty(centroids.shape),
                      np.empty(centroids.shape, bool))
    b1, b2, fin = _BUFS[key]
    seen += counts
    eta = np.divide(counts, np.maximum(seen, 1.0))[:, None]
    np.divide(sums, np.maximum(counts, 1.0)[:, None], out=b1)
    np.multiply(1.0 - eta, centroids, out=b2)
    np.multiply(eta, b1, out=b1)
    np.add(b2, b1, out=b2)
    new_centroids = np.array(centroids, np.float64, copy=True)
    np.copyto(new_centroids, b2, where=counts[:, None] > 0)
    if do_reassign and candidates is not None \
            and self.reassignment_ratio > 0:
        flagged = seen < self.reassignment_ratio * seen.max()
        slots = np.flatnonzero(flagged)[:len(candidates)]
        if slots.size:
            log.warn_reassign(slots.size)
            new_centroids[slots] = candidates[: slots.size]
            kept = seen[~flagged]
            seen[slots] = kept.min() if kept.size else 0.0
    if not np.isfinite(new_centroids, out=fin).all():
        self._raise_divergence("centroids", iteration + 1)
    if self.compute_sse:
        self.sse_history.append(sse * sse_scale)
    np.subtract(new_centroids, centroids, out=b1)
    np.multiply(b1, b1, out=b1)
    max_shift = float(np.max(np.sqrt(np.add.reduce(b1, axis=1))))
    log.iteration(iteration, max_shift, counts.astype(np.int64),
                  self.sse_history[-1] if
                  (self.compute_sse and self.sse_history) else None)
    self.centroids = new_centroids.astype(self.dtype)
    self._centroids_f64 = new_centroids
    self.cluster_sizes_ = counts.astype(np.int64)
    self.iterations_run = iteration + 1
    self._seen = seen.copy()
    from kmeans_tpu_torch.obs.heartbeat import note_progress
    note_progress(self, phase="iteration", shift=max_shift)
    return new_centroids, seen, max_shift


def _save_state_in_memory(path, state):
    """``checkpoint.save_state`` with the archive built in memory and
    written by one call."""
    from kmeans_tpu_torch.utils import checkpoint as ckpt
    path = ckpt._normalize(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in state.items()
              if isinstance(v, np.ndarray)}
    meta = {k: v for k, v in state.items() if k not in arrays}
    meta["__format_version__"] = ckpt.FORMAT_VERSION
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    buf = io.BytesIO()
    np.savez(buf, __meta__=json.dumps(meta), **arrays)
    try:
        with open(tmp, "wb") as f:
            f.write(buf.getbuffer())
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _numpy_load(end: float, inplace: bool) -> None:
    """The host Sculley update's float64 arithmetic until ``end``."""
    rng = np.random.default_rng(0)
    cents = rng.standard_normal((1024, 128))
    sums = rng.standard_normal((1024, 128))
    counts = rng.integers(0, 3, 1024).astype(np.float64)
    seen = np.ones(1024)
    bufs = [np.empty_like(cents) for _ in range(4)]
    while time.perf_counter() < end:
        if inplace:
            eta, mean, a, b = bufs
            np.divide(counts, np.maximum(seen, 1.0), out=eta[:, 0])
            np.divide(sums, np.maximum(counts, 1.0)[:, None], out=mean)
            np.multiply(1.0 - eta[:, :1], cents, out=a)
            np.multiply(eta[:, :1], mean, out=b)
            np.add(a, b, out=a)
            np.subtract(a, cents, out=b)
            np.multiply(b, b, out=b)
            float(np.max(b.sum(axis=1)))
        else:
            eta = np.divide(counts, np.maximum(seen, 1.0))[:, None]
            mean = sums / np.maximum(counts, 1.0)[:, None]
            new = np.where(counts[:, None] > 0,
                           (1.0 - eta) * cents + eta * mean, cents)
            float(np.max(np.linalg.norm(new - cents, axis=1)))
            new.astype(np.float32)


@contextlib.contextmanager
def _switch_interval(seconds):
    saved = sys.getswitchinterval()
    if seconds is not None:
        sys.setswitchinterval(seconds)
    try:
        yield
    finally:
        sys.setswitchinterval(saved)


class _Phases:
    """Per-part ms of the serving thread's calls, by wave kind."""

    def __init__(self):
        self.kind = None
        self.main = threading.get_ident()
        self.ms = {}

    def _note(self, tag, t0):
        if self.kind is not None and threading.get_ident() == self.main:
            self.ms.setdefault((self.kind, tag), []).append(
                (time.perf_counter() - t0) * 1e3)

    def wrap(self, owner, name, tag, static=False, returns_fn=False):
        orig = owner.__dict__[name]
        fn = orig.__func__ if static else orig
        ph = self

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
            finally:
                ph._note(tag, t0)
            if not returns_fn:
                return out

            def call(*a2, **kw2):
                t1 = time.perf_counter()
                try:
                    return out(*a2, **kw2)
                finally:
                    ph._note(tag + "()", t1)
            return call
        setattr(owner, name, staticmethod(timed) if static else timed)

    def table(self):
        rows = {}
        for (kind, tag), v in sorted(self.ms.items()):
            rows.setdefault(tag, {})[kind] = (
                round(statistics.fmean(v), 4), round(max(v), 4), len(v))
        return rows


def _top(stats: pstats.Stats, key: str, n: int):
    stats.sort_stats(key)
    rows = []
    for fn in stats.fcn_list[:n]:
        cc, nc, tt, ct, _ = stats.stats[fn]
        rows.append((f"{os.path.basename(fn[0])}:{fn[1]}({fn[2]})", nc,
                     round(tt * 1e3, 3), round(ct * 1e3, 3)))
    return rows




def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


class _Steps:
    """Host-clock intervals of the update's steps, while ``on``."""

    def __init__(self):
        self.on = False
        self.rows = []

    def wrap(self, owner, name, tag):
        orig = getattr(owner, name)
        steps = self

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                if steps.on:
                    steps.rows.append((tag, t0, time.perf_counter()))
        setattr(owner, name, timed)
        return orig


def main(argv) -> None:
    reps = int(argv[0]) if argv else 9
    out = Path(argv[1] if len(argv) > 1
               else "chiprun_out/exp_learn_excursion.json")
    variants = tuple(argv[2].split(",")) if len(argv) > 2 else VARIANTS
    profile = len(argv) > 3 and argv[3] == "1"
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    from kmeans_tpu_torch.models.minibatch import MiniBatchKMeans
    from kmeans_tpu_torch.serving import ServingEngine
    from kmeans_tpu_torch.serving import engine as serve_engine
    from kmeans_tpu_torch.serving import learn as serve_learn
    from kmeans_tpu_torch.utils import checkpoint as ckpt
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(42)
    x = rng.uniform(-1.0, 1.0, size=(262_144, 128)).astype(np.float32)
    t_fit = time.perf_counter()
    mb = MiniBatchKMeans(k=1024, max_iter=5, seed=0, batch_size=65_536,
                         init="forgy", distance_mode="pallas",
                         device=dev).fit(x)
    fit_s = time.perf_counter() - t_fit
    reqs = [x[i * ROWS:(i + 1) * ROWS] + np.float32(1.0)
            for i in range(min(64, x.shape[0] // ROWS))]

    steps = _Steps()
    steps.wrap(ckpt, "save_state_rotating", "snapshot")
    steps.wrap(MiniBatchKMeans, "_learn_clone", "clone")
    steps.wrap(MiniBatchKMeans, "partial_fit", "partial_fit")
    steps.wrap(serve_learn, "publish_tables", "swap")
    real_save = ckpt.save_state_rotating
    real_state = ckpt.save_state
    real_apply = MiniBatchKMeans._apply_batch_stats
    side = torch.cuda.Stream(dev)
    res = {v: dict(ratios=[], quiet_p99_ms=[], busy_p99_ms=[],
                   update_ms=[], slow_calls=[], steps=[], waves=[],
                   quiet_cpu=[], busy_cpu=[])
           for v in variants}
    phases = _Phases()
    if profile:
        se = serve_engine.ServingEngine
        for name in ("_validate", "_stage", "_place", "_record",
                     "_observe_quality", "_feed_learner"):
            phases.wrap(se, name, name)
        phases.wrap(se, "_host", "_host", static=True)
        phases.wrap(se, "_predict_fn", "_predict_fn", returns_fn=True)
        phases.wrap(serve_engine.ResidentModel, "table_dev", "table_dev")
        phases.wrap(se, "call", "call")
    update_prof = None
    spin_s = [0.05]

    with tempfile.TemporaryDirectory() as tmp:
        eng = ServingEngine(device=dev, start=False, quality=True,
                            quality_dir=tmp,
                            learn={"dir": tmp, "batch_rows": ROWS,
                                   "max_batches": 2, "cooldown_windows": 0,
                                   "update_budget": 10 * reps
                                   * len(variants) + 10,
                                   "min_rows": 1 << 40})
        try:
            eng.add_model("mb", mb)
            eng.warmup()
            ln = eng._residents["mb"].learner
            snap = Path(tmp) / "snapshot_only.npz"

            def wave(first, kind=None):
                t = np.empty((WAVE_CALLS, 2))
                c0, w0 = time.process_time(), time.perf_counter()
                phases.kind = kind
                for i in range(WAVE_CALLS):
                    t0 = time.perf_counter()
                    eng.call("mb", reqs[(first + i) % len(reqs)])
                    t[i] = (t0, time.perf_counter())
                phases.kind = None
                return t, (time.process_time() - c0) / (
                    time.perf_counter() - w0)

            wave(0)
            warm = ln.update_now(force=True, reason="warm")
            for rep in range(reps):
                order = variants[rep % len(variants):] \
                    + variants[:rep % len(variants)]
                for v in order:
                    lowered = LOWERED_SWITCH_S if v.endswith("switch") \
                        else None
                    if v == "nosnap":
                        ckpt.save_state_rotating = lambda *a, **k: None
                    if v.startswith("inplace"):
                        MiniBatchKMeans._apply_batch_stats = \
                            _apply_batch_stats_inplace
                    if v.endswith("memsnap"):
                        ckpt.save_state = _save_state_in_memory
                    if v == "nogc":
                        gc.disable()
                    quiet, quiet_cpu = wave(rep, f"{v}:quiet")
                    dec = [None]
                    span = [0.0, 0.0]

                    def work():
                        span[0] = time.perf_counter()
                        with _switch_interval(lowered):
                            end = span[0] + spin_s[0]
                            if v.startswith("spin"):
                                while time.perf_counter() < end:
                                    pass
                            elif v == "sleep":
                                time.sleep(spin_s[0])
                            elif v == "sleep0":
                                while time.perf_counter() < end:
                                    time.sleep(0)
                            elif v == "tinyops":
                                small = np.ones(1000)
                                while time.perf_counter() < end:
                                    np.multiply(small, 1.0, out=small)
                            elif v.startswith("numpy"):
                                _numpy_load(end, v == "numpy_inplace")
                            elif v == "snapshot_only":
                                state = mb._state_dict()
                                while time.perf_counter() < end:
                                    real_save(snap, state)
                            elif v == "stream":
                                with torch.cuda.stream(side):
                                    dec[0] = ln.update_now(force=True,
                                                           reason=v)
                                side.synchronize()
                            else:
                                dec[0] = ln.update_now(force=True,
                                                       reason=v)
                        span[1] = time.perf_counter()

                    steps.rows, steps.on = [], True
                    th = threading.Thread(target=work)
                    th.start()
                    busy, busy_cpu = wave(rep + 7, f"{v}:busy")
                    th.join(timeout=120.0)
                    steps.on = False
                    ckpt.save_state_rotating = real_save
                    ckpt.save_state = real_state
                    MiniBatchKMeans._apply_batch_stats = real_apply
                    gc.enable()
                    lq = quiet[:, 1] - quiet[:, 0]
                    lb = busy[:, 1] - busy[:, 0]
                    q99 = float(np.percentile(lq, 99))
                    b99 = float(np.percentile(lb, 99))
                    r = res[v]
                    r["quiet_cpu"].append(quiet_cpu)
                    r["busy_cpu"].append(busy_cpu)
                    r["ratios"].append(b99 / q99)
                    r["quiet_p99_ms"].append(q99 * 1e3)
                    r["busy_p99_ms"].append(b99 * 1e3)
                    r["update_ms"].append((span[1] - span[0]) * 1e3)
                    if dec[0] is not None:
                        r.setdefault("decisions", []).append(
                            (dec[0]["action"], dec[0]["detail"].get(
                                "fit_ms"), dec[0]["detail"].get("swap_ms")))
                    base = busy[0, 0]
                    rel = [(tag, (a - base) * 1e3, (b - base) * 1e3)
                           for tag, a, b in steps.rows]
                    r["steps"].append(rel)
                    slow = []
                    for (a, b) in busy:
                        if b - a > 2 * q99:
                            hit = sorted({tag for tag, s0, s1 in steps.rows
                                          if s0 < b and s1 > a})
                            if not hit and span[0] < b and span[1] > a:
                                hit = ["update-other"]
                            slow.append(((a - base) * 1e3, (b - a) * 1e3,
                                         hit or ["none"]))
                    r["slow_calls"].append(slow)
                    r["waves"].append({
                        "quiet_ms": (lq * 1e3).round(4).tolist(),
                        "busy_start_ms": ((busy[:, 0] - base) * 1e3)
                        .round(4).tolist(),
                        "busy_ms": (lb * 1e3).round(4).tolist(),
                        "update_span_ms": [(span[0] - base) * 1e3,
                                           (span[1] - base) * 1e3]})
                    if v == "update":
                        spin_s[0] = statistics.median(r["update_ms"]) / 1e3
            if profile:
                update_prof = cProfile.Profile()
                for rep in range(5):
                    wave(rep)
                    update_prof.enable()
                    ln.update_now(force=True, reason="profile")
                    update_prof.disable()
        finally:
            eng.close()
    summary = {}
    for v in variants:
        r = res[v]
        hits = {}
        for slow in r["slow_calls"]:
            for _, _, tags in slow:
                for tg in tags:
                    hits[tg] = hits.get(tg, 0) + 1
        summary[v] = dict(
            excursion=statistics.median(r["ratios"]),
            ratios=r["ratios"],
            quiet_p99_ms=statistics.median(r["quiet_p99_ms"]),
            busy_p99_ms=statistics.median(r["busy_p99_ms"]),
            update_ms=statistics.median(r["update_ms"]),
            slow_calls_per_wave=statistics.median(
                len(s) for s in r["slow_calls"]),
            slow_call_steps=hits,
            quiet_cpu_per_wall=statistics.median(r["quiet_cpu"]),
            busy_cpu_per_wall=statistics.median(r["busy_cpu"]),
            decisions=r.get("decisions", []))
        print(json.dumps({"variant": v, **summary[v]}), flush=True)
    profiles = None
    if profile:
        profiles = {"serving_parts_ms": phases.table()}
        print(json.dumps({"serving_parts": "mean ms, max ms, calls"}))
        for tag, kinds in profiles["serving_parts_ms"].items():
            print("   ", tag, json.dumps(kinds), flush=True)
        for key in ("tottime", "cumulative"):
            rows = _top(pstats.Stats(update_prof, stream=io.StringIO()),
                        key, 35)
            profiles[f"update_{key}_ms"] = rows
            print(json.dumps({"update_profile": key, "updates": 5}))
            for row in rows:
                print("   ", row, flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"fit_s": fit_s, "warm_update": warm,
                               "lowered_switch_interval_s":
                                   LOWERED_SWITCH_S,
                               "default_switch_interval_s":
                                   sys.getswitchinterval(),
                               "threads": len(os.listdir("/proc/self/task")),
                               "torch_threads": torch.get_num_threads(),
                               "summary": summary, "profiles": profiles,
                               "raw": res}))
    print(json.dumps({"card": _card(), "torch": torch.__version__,
                      "fit_s": fit_s, "warm_update": warm,
                      "out": str(out)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
