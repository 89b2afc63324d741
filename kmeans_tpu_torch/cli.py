"""The commands of ``python -m kmeans_tpu_torch``.

Counterpart of ``kmeans_tpu/cli.py``: the same commands, flags, JSON keys,
output files, exit codes and error messages, under the program name
``python -m kmeans_tpu_torch``.  One addition, the port's counterpart of
the reference's platform choice: every command that places data (``fit``,
``sweep``, ``serve``, ``warm``, ``cost-report``, ``plan``) takes
``--device``, which defaults to the card; without one it exits 2 with the
estimators' error, and ``--device cpu`` runs on the CPU on purpose.

* ``fit``: cluster an (n, D) ``.npy`` / ``.npz`` matrix; writes
  ``centroids.npy``, ``labels.npy`` and ``summary.json``.
* ``sweep``: model selection over a k range (``KMeans.sweep``,
  ``GaussianMixture.sweep``); writes ``centroids.npy`` and ``sweep.json``.
* ``serve``: a stdin / JSONL request loop over ``serving.ServingEngine``
  (or a ``ServingFleet`` of replicas).
* ``warm`` and ``ckpt-info``: the store of built kernel libraries
  (``utils.aot``) filled for a fit shape or a checkpoint, and a
  checkpoint's description with its shipped ``<ckpt>.aot`` directory and
  its memory plan.
* ``trace``, ``fleet-status``, ``serve-status``: the readers of the trace,
  heartbeat and quality JSONL files (``obs``).
* ``cost-report`` and ``plan``: the device cost report and the memory
  planner with the massive-k resolution.
* ``autopilot``: the elastic supervisor (``orchestrator``).
* ``lint``: the invariant linter over the package's sources
  (``analysis``); it touches no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

_MODELS = ("kmeans", "minibatch", "bisecting", "spherical")


def _add_device(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="where the data and the fit live: the card "
                             "by default; 'cpu' runs on the CPU on "
                             "purpose")


def _resolve_device(args):
    """The command's torch device (``models.kmeans.resolve_device``: None is
    the card); None after printing the estimators' error where the device
    cannot be had."""
    from kmeans_tpu_torch.models.kmeans import resolve_device
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return None


def _load_matrix(path: str, npz_key: str) -> np.ndarray:
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"no such file: {p}")
    if p.suffix == ".npz":
        with np.load(p) as z:
            keys = list(z.keys())
            if not keys:
                raise ValueError(f"{p} contains no arrays")
            key = npz_key or keys[0]
            if key not in keys:
                raise KeyError(f"{p} has no array {key!r}; "
                               f"available: {keys}")
            return np.asarray(z[key])
    return np.load(p)


def _parse_bucket(raw):
    """The ``--bucket`` grammar of ``fit`` and ``warm``: 'auto' | an int
    >= 0 (0: the exact shape), validated by the ``check_bucket`` the
    model constructors use."""
    from kmeans_tpu_torch.parallel.sharding import check_bucket
    return check_bucket(raw if raw == "auto" else int(raw))


def _build_model(args, device):
    from kmeans_tpu_torch import (BisectingKMeans, KMeans, MiniBatchKMeans,
                                  SphericalKMeans)
    common = dict(k=args.k, max_iter=args.max_iter, tolerance=args.tolerance,
                  seed=args.seed, compute_sse=args.sse, init=args.init,
                  n_init=args.n_init, verbose=not args.quiet,
                  bucket=_parse_bucket(getattr(args, "bucket", 0)),
                  device=device)
    if args.model == "minibatch":
        # n_init > 1 picks the best-scoring candidate init, then one
        # training session runs.
        return MiniBatchKMeans(batch_size=args.batch_size, **common)
    if args.model == "bisecting":
        return BisectingKMeans(**common)      # n_init applies per split
    if args.model == "spherical":
        return SphericalKMeans(**common)
    return KMeans(**common)


def main(argv=None) -> int:
    """``python -m kmeans_tpu_torch fit``: cluster an on-disk (n, D)
    matrix; ``centroids.npy``, ``labels.npy`` and ``summary.json`` land in
    ``--out-dir``."""
    parser = argparse.ArgumentParser(
        prog="python -m kmeans_tpu_torch fit",
        description="Cluster an (n, D) .npy/.npz matrix on the GPU/CPU")
    parser.add_argument("data", help="path to .npy or .npz with (n, D) floats")
    parser.add_argument("--npz-key", default="",
                        help=".npz array name (default: first key)")
    parser.add_argument("--k", type=int, required=True)
    parser.add_argument("--model", choices=_MODELS, default="kmeans")
    parser.add_argument("--max-iter", type=int, default=100)
    parser.add_argument("--tolerance", type=float, default=1e-4)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--init", default="forgy",
                        help="forgy | kmeans++ | kmeans|| (default forgy)")
    parser.add_argument("--n-init", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=4096,
                        help="minibatch model only")
    parser.add_argument("--sse", action="store_true",
                        help="track SSE per iteration")
    parser.add_argument("--bucket", default="0",
                        help="fit-shape bucket: 0 (exact, default) | "
                             "auto (committed ladder) | int step (warm "
                             "fleets reuse one built program across "
                             "nearby sizes)")
    parser.add_argument("--aot-cache", default=None, metavar="DIR",
                        help="store of built kernel libraries (also via "
                             "KMEANS_TPU_TORCH_AOT_CACHE): a library "
                             "stored here loads instead of an nvcc build "
                             "on later runs")
    parser.add_argument("--out-dir", default=".",
                        help="where centroids.npy/labels.npy/summary.json go")
    parser.add_argument("--no-labels", action="store_true",
                        help="skip writing per-point labels")
    parser.add_argument("--quiet", action="store_true")
    _add_device(parser)
    args = parser.parse_args(argv)

    try:
        X = _load_matrix(args.data, args.npz_key)
    except (OSError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if X.ndim != 2:
        print(f"error: expected (n, D) matrix, got shape {X.shape}",
              file=sys.stderr)
        return 2
    device = _resolve_device(args)
    if device is None:
        return 2
    # The first rung of the warm start: the build directory in use
    # (KMEANS_TPU_TORCH_BUILD_DIR), then the store when one is named.
    from kmeans_tpu_torch.utils import aot
    aot.enable_compilation_cache()
    if args.aot_cache:
        aot.configure(args.aot_cache)
    try:
        args.bucket = _parse_bucket(args.bucket)
    except ValueError:
        print(f"error: --bucket must be 'auto' or an int, got "
              f"{args.bucket!r}", file=sys.stderr)
        return 2
    model = _build_model(args, device)

    X = np.asarray(X, dtype=np.float32)
    start = time.perf_counter()
    model.fit(X)
    elapsed = time.perf_counter() - start
    # The real final inertia even without --sse (one fused pass).
    inertia = model.inertia_ if model.inertia_ is not None \
        else -model.score(X)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "centroids.npy", model.centroids)
    if not args.no_labels:
        np.save(out / "labels.npy", model.labels_)
    summary = {
        "model": args.model, "n": int(X.shape[0]), "d": int(X.shape[1]),
        "k": args.k, "iterations": model.iterations_run,
        "fit_seconds": round(elapsed, 3),
        "inertia": float(inertia),
        "sse_history": [float(s) for s in model.sse_history],
        "cluster_sizes": [int(c) for c in model.cluster_sizes_]
        if model.cluster_sizes_ is not None else None,
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    if not args.quiet:
        print(json.dumps(summary))
    return 0


def sweep_main(argv=None) -> int:
    """``python -m kmeans_tpu_torch sweep``: model selection over k.  Every
    (k, restart) member is fitted in one device loop, the criterion curve
    is scored, and the selected model's table lands in ``--out-dir``.

    ``--k-range`` is half-open ``lo:hi[:step]`` (``2:33`` is k in 2..32) or
    a comma list (``2,4,8``); an invalid or empty range exits 2.
    ``--criterion`` defaults to the family's rule: ``inertia`` (elbow) for
    kmeans and spherical, ``bic`` for gmm.  ``--sequential`` runs the
    per-member oracle.  ``--json`` prints the summary (selected k, per-k
    scores, dispatch count) on stdout."""
    parser = argparse.ArgumentParser(
        prog="python -m kmeans_tpu_torch sweep",
        description="Batched fit-many/pick-best model selection over a "
                    "k range — one device loop for the whole sweep")
    parser.add_argument("data", help="path to .npy or .npz with (n, D) "
                        "floats")
    parser.add_argument("--npz-key", default="",
                        help=".npz array name (default: first key)")
    parser.add_argument("--model", choices=("kmeans", "spherical", "gmm"),
                        default="kmeans")
    parser.add_argument("--k-range", required=True,
                        help="half-open 'lo:hi[:step]' (2:33 = k 2..32) "
                             "or comma list '2,4,8'")
    parser.add_argument("--criterion", default=None,
                        help="kmeans/spherical: inertia | silhouette | "
                             "calinski_harabasz | davies_bouldin; "
                             "gmm: bic | aic (default: inertia / bic)")
    parser.add_argument("--n-init", type=int, default=1,
                        help="restarts per k (default 1)")
    parser.add_argument("--max-iter", type=int, default=100)
    parser.add_argument("--tolerance", type=float, default=1e-4)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--init", default="forgy",
                        help="kmeans family init (default forgy)")
    parser.add_argument("--cov-type", default="diag",
                        choices=("diag", "spherical", "tied", "full"),
                        help="gmm only (batched sweep needs "
                             "diag/spherical)")
    parser.add_argument("--sequential", action="store_true",
                        help="run the per-member oracle (batched=0)")
    parser.add_argument("--out-dir", default=".",
                        help="where centroids.npy/sweep.json go")
    parser.add_argument("--json", action="store_true",
                        help="print the JSON summary on stdout")
    parser.add_argument("--quiet", action="store_true")
    _add_device(parser)
    args = parser.parse_args(argv)

    from kmeans_tpu_torch.sweep import (GMM_CRITERIA, KMEANS_CRITERIA,
                                        parse_k_range)
    try:
        ks = parse_k_range(args.k_range)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    criterion = args.criterion or ("bic" if args.model == "gmm"
                                   else "inertia")
    table = GMM_CRITERIA if args.model == "gmm" else KMEANS_CRITERIA
    if criterion not in table:
        print(f"error: criterion {criterion!r} is not valid for "
              f"--model {args.model} (valid: {sorted(table)})",
              file=sys.stderr)
        return 2
    try:
        X = _load_matrix(args.data, args.npz_key)
    except (OSError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if X.ndim != 2:
        print(f"error: expected (n, D) matrix, got shape {X.shape}",
              file=sys.stderr)
        return 2
    if ks[-1] >= X.shape[0]:
        print(f"error: k range max {ks[-1]} must be < n={X.shape[0]}",
              file=sys.stderr)
        return 2
    device = _resolve_device(args)
    if device is None:
        return 2

    X = np.asarray(X, dtype=np.float32)
    if args.model == "gmm":
        from kmeans_tpu_torch import GaussianMixture
        model = GaussianMixture(
            n_components=ks[-1], covariance_type=args.cov_type,
            max_iter=args.max_iter, tol=args.tolerance, seed=args.seed,
            n_init=args.n_init, verbose=False, device=device)
    else:
        from kmeans_tpu_torch import KMeans, SphericalKMeans
        cls = SphericalKMeans if args.model == "spherical" else KMeans
        model = cls(k=ks[-1], max_iter=args.max_iter,
                    tolerance=args.tolerance, seed=args.seed,
                    init=args.init, n_init=args.n_init, verbose=False,
                    device=device)

    start = time.perf_counter()
    try:
        result = model.sweep(X, k_range=ks, criterion=criterion,
                             batched=0 if args.sequential else True)
    except ValueError as e:
        # sweep() checks more than the checks above can (metric criteria
        # need k >= 2, every member non-finite): the same 'error: ...,
        # exit 2' contract.
        print(f"error: {e}", file=sys.stderr)
        return 2
    elapsed = time.perf_counter() - start

    summary = result.summary()
    summary.update({"model": args.model, "n": int(X.shape[0]),
                    "d": int(X.shape[1]),
                    "sweep_seconds": round(elapsed, 3)})
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    best = result.best_model
    np.save(out / "centroids.npy",
            best.centroids if args.model != "gmm" else best.means_)
    (out / "sweep.json").write_text(json.dumps(summary, indent=2))
    if args.json:
        print(json.dumps(summary))
    elif not args.quiet:
        curve = "  ".join(f"k={k}:{summary['scores'][str(k)]:.4g}"
                          if summary["scores"][str(k)] is not None
                          else f"k={k}:-" for k in result.k_range)
        print(f"sweep: selected k={result.selected_k} by {criterion} "
              f"({result.n_dispatches} dispatches, {elapsed:.2f}s)\n"
              f"  {curve}")
    return 0


def serve_main(argv=None) -> int:
    """``python -m kmeans_tpu_torch serve --model <ckpt> [--model ...]``: a
    stdin / JSONL request loop over the serving engine (no network: pipe
    requests in, read results out).

    Protocol, one JSON object per input line:

    * ``{"model": "<id>", "x": [[...], ...]}``: label the rows; optional
      ``"op"``: ``predict`` (default) | ``transform`` | ``score_rows`` |
      ``predict_proba`` | ``score_samples`` (as the family allows), and
      ``"id"``, echoed back.  Reply: ``{"model":..., "op":...,
      "result": [...]}``.  With one resident model ``"model"`` may be
      left out.
    * ``{"stats": true}``: the engine's stats.
    * ``{"quality": true}``: the drift monitors' snapshot per model
      (``--quality-dir`` also streams the ``quality.<id>.jsonl`` sinks that
      ``serve-status`` reads).
    * ``{"learn": true}``: with ``--learn``, the update status per model;
      an error line without it.
    * ``{"fleet_stats": true}``: with ``--replicas N``, the fleet's
      snapshot; an error line under one engine.  ``--quality-dir`` is also
      the fleet directory (per-replica quality and heartbeat sinks), and
      ``--slo-p99-ms`` commits the admission bound (a shed request errors
      its line).

    A malformed request errors its own line (``{"error": ...}``) and the
    loop goes on.  At EOF the engine drains; ``--json`` prints a final
    stats line on stdout, otherwise a summary goes to stderr.  Exit 0 after
    a clean drain, 2 when no model loaded."""
    parser = argparse.ArgumentParser(
        prog="python -m kmeans_tpu_torch serve",
        description="Serve fitted-model checkpoints over a stdin/JSONL "
                    "request loop (resident warm-kernel engine; each "
                    "line dispatches immediately — the pipe is serial)")
    parser.add_argument("--model", action="append", required=True,
                        metavar="CKPT", dest="models",
                        help="checkpoint path (repeatable; any family)")
    parser.add_argument("--id", action="append", default=None,
                        dest="ids", help="model id for the matching "
                        "--model (default: file stem)")
    parser.add_argument("--quantize", choices=["bf16"], default=None,
                        help="serve K-Means-family assignment through "
                             "the bf16 distance fast path")
    parser.add_argument("--max-wait-ms", type=float, default=2.0,
                        help="micro-batch flush timer for the engine's "
                             "queue (default 2.0; the serial stdin loop "
                             "itself dispatches immediately)")
    parser.add_argument("--buckets", default="8,64,512,4096",
                        help="request-batch bucket ladder")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip pre-building the bucket shapes")
    parser.add_argument("--replicas", type=int, default=1, metavar="N",
                        help="serve through an in-process fleet of N "
                             "replica engines behind the SLO-aware "
                             "router (default 1: a single engine)")
    parser.add_argument("--slo-p99-ms", type=float, default=None,
                        metavar="MS",
                        help="committed p99 latency bound for fleet "
                             "admission control (requests shed at the "
                             "bound error their line explicitly; "
                             "requires --replicas >= 1 fleet mode)")
    parser.add_argument("--quality-dir", default=None, metavar="DIR",
                        help="write per-model drift JSONL sinks "
                             "(quality.<id>.jsonl) here — the "
                             "serve-status input; implies monitoring "
                             "on")
    parser.add_argument("--quality", action="store_true",
                        help="force drift monitoring on (default "
                             "'auto': on on the card, off on the CPU)")
    parser.add_argument("--no-quality", action="store_true",
                        help="disable drift monitoring")
    parser.add_argument("--learn", action="store_true",
                        help="serve-and-learn: let eligible resident "
                             "models update in place from sampled "
                             "traffic when their drift monitor fires — "
                             "snapshot-before-update, atomic swap, "
                             "rollback-on-regression; implies quality "
                             "monitoring on")
    parser.add_argument("--json", action="store_true",
                        help="print the final stats snapshot as JSON "
                             "on stdout")
    _add_device(parser)
    args = parser.parse_args(argv)

    from kmeans_tpu_torch.serving import ServingEngine, ServingFleet
    ids = args.ids or []
    if len(ids) > len(args.models):
        print("error: more --id flags than --model flags",
              file=sys.stderr)
        return 2
    if args.replicas < 1:
        print("error: --replicas must be >= 1", file=sys.stderr)
        return 2
    buckets = tuple(int(b) for b in args.buckets.split(","))
    if args.quality and args.no_quality:
        print("error: --quality and --no-quality are mutually "
              "exclusive", file=sys.stderr)
        return 2
    quality = (False if args.no_quality else True if args.quality
               else "auto")
    if args.learn:
        if args.no_quality:
            print("error: --learn requires quality monitoring (the "
                  "serve-and-learn trigger IS the drift monitor); "
                  "drop --no-quality", file=sys.stderr)
            return 2
        # The learn trigger is the drift monitor, so 'auto' must not
        # resolve quality off on the CPU under --learn.
        if quality == "auto":
            quality = True
    device = _resolve_device(args)
    if device is None:
        return 2
    fleet_mode = args.replicas > 1 or args.slo_p99_ms is not None
    if fleet_mode:
        engine = ServingFleet(
            args.replicas, device=device, buckets=buckets,
            max_wait_ms=args.max_wait_ms, quality=quality,
            fleet_dir=(None if args.no_quality else args.quality_dir),
            slo_p99_ms=args.slo_p99_ms, learn=args.learn)
        print(f"serve: fleet of {args.replicas} replicas"
              + (f", SLO p99 <= {args.slo_p99_ms} ms"
                 if args.slo_p99_ms is not None else ""),
              file=sys.stderr)
    else:
        engine = ServingEngine(device=device, buckets=buckets,
                               max_wait_ms=args.max_wait_ms,
                               quality=quality,
                               quality_dir=(None if args.no_quality
                                            else args.quality_dir),
                               learn=args.learn)
    try:
        for i, path in enumerate(args.models):
            mid = ids[i] if i < len(ids) else None
            try:
                mid = engine.load(path, mid, quantize=args.quantize)
            except Exception as e:       # noqa: BLE001 -- operator-facing
                print(f"error: cannot load {path}: {e}", file=sys.stderr)
                return 2
            spec = engine.registry.spec(mid)
            print(f"serve: resident {mid!r}: {spec['model_class']} "
                  f"k={spec['k']} d={spec['d']} dtype={spec['dtype']}"
                  + (f" quantize={args.quantize}" if args.quantize
                     and spec["family"] == "kmeans" else ""),
                  file=sys.stderr)
        if not args.no_warmup:
            n = engine.warmup()
            print(f"serve: warmed {n} bucket shapes", file=sys.stderr)
        elif fleet_mode:
            # Replicas take traffic only in state 'serving': open the fleet
            # without building the buckets (the --no-warmup contract).
            engine.warmup(prewarm=False)
        default_model = engine.models()[0] \
            if len(engine.models()) == 1 else None

        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                if req.get("stats"):
                    print(json.dumps(engine.stats()), flush=True)
                    continue
                if req.get("quality"):
                    print(json.dumps(engine.quality_status()),
                          flush=True)
                    continue
                if req.get("learn"):
                    if not args.learn:
                        raise ValueError(
                            "learn status requires serving with "
                            "--learn (the serve-and-learn actuator "
                            "is off)")
                    print(json.dumps(engine.update_status()),
                          flush=True)
                    continue
                if req.get("fleet_stats"):
                    if not fleet_mode:
                        raise ValueError(
                            "fleet_stats requires --replicas N fleet "
                            "mode (a single engine has no fleet)")
                    print(json.dumps(engine.stats()), flush=True)
                    continue
                model_id = req.get("model", default_model)
                if model_id is None:
                    raise ValueError(
                        "request must name a 'model' (several are "
                        "resident)")
                op = req.get("op", "predict")
                # The stdin loop is serial (each reply is written before
                # the next line is read), so a queue could never coalesce
                # anything and would only add its flush timer: dispatch at
                # once.
                result = engine.call(model_id, req["x"], op=op)
                reply = {"model": model_id, "op": op,
                         "result": np.asarray(result).tolist()}
                if "id" in req:
                    reply["id"] = req["id"]
                print(json.dumps(reply), flush=True)
            except Exception as e:       # noqa: BLE001 -- per request
                print(json.dumps({"error": f"{type(e).__name__}: {e}"}),
                      flush=True)
    finally:
        engine.close()
    if args.json:
        print(json.dumps(engine.stats()))
    else:
        st = engine.stats()
        n_req = sum(m["requests"] for m in st["models"].values())
        n_models = st.get("models_resident", len(st["models"]))
        print(f"serve: done — {n_models} models, "
              f"{n_req} requests, "
              f"{st['dispatches']} dispatches"
              + (f" across {st['n_replicas']} replicas "
                 f"({st['routes']} routed, {st['sheds']} shed)"
                 if fleet_mode else ""), file=sys.stderr)
    return 0


def trace_main(argv=None) -> int:
    """``python -m kmeans_tpu_torch trace summarize <file.jsonl> [...]``:
    read the traces that ``obs.tracing(path=...)`` writes.

    One file: the per-phase rollup (count, total, p50, p99 of self time:
    a nested child's time is left out, so totals never count twice) and,
    where the trace holds a ``dispatch`` span, the time-to-first-iteration
    table.  Several files (or a directory, or a glob: the per-process
    ``trace.p{idx}.jsonl`` family): the streams are aligned and merged
    first (``obs.fleet.merge_traces``), the host roster and skew bound
    print above the rollup, and the time-to-first-iteration table is left
    out.  ``--json`` prints everything as JSON; ``--chrome out.json``
    converts to Chrome ``trace_event``.  Exit 2 on unreadable, malformed
    or unalignable inputs (``TraceReadError``)."""
    parser = argparse.ArgumentParser(
        prog="python -m kmeans_tpu_torch trace",
        description="Summarize kmeans_tpu_torch telemetry traces (JSONL "
                    "from obs.tracing): per-phase totals/percentiles + "
                    "the time-to-first-iteration table; several files / "
                    "a directory merge into one fleet timeline")
    parser.add_argument("action", choices=("summarize",),
                        help="analysis to run (summarize)")
    parser.add_argument("file", nargs="+",
                        help="trace JSONL path(s), a directory, or a "
                             "glob (per-host trace.p{idx}.jsonl files)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output on stdout")
    parser.add_argument("--chrome", metavar="OUT.JSON", default=None,
                        help="also write a Chrome trace_event file")
    parser.add_argument("--cost", action="store_true",
                        help="merge captured cost records (cost.record "
                             "events from obs.cost) into the per-phase "
                             "table — flops/bytes/arithmetic-intensity "
                             "columns, blank when the trace holds no "
                             "cost records")
    args = parser.parse_args(argv)

    from kmeans_tpu_torch.obs import fleet as obs_fleet
    from kmeans_tpu_torch.obs import trace as obs_trace
    from kmeans_tpu_torch.obs.report import (format_ingest_table,
                                             format_phase_table,
                                             ingest_breakdown, merge_cost,
                                             time_to_first_iteration)
    merged = None
    try:
        paths = obs_fleet.expand_fleet_paths(args.file)
        if len(paths) > 1:
            # A directory or glob holds the heartbeat sinks beside the
            # trace sinks: skip them instead of failing the merge (one
            # file named alone stays strict).
            trace_paths = [p for p in paths
                           if obs_fleet.sniff_stream(p)
                           != "heartbeat"]
            if not trace_paths:
                raise obs_trace.TraceReadError(
                    f"no trace streams among {paths} (heartbeat files "
                    f"are read by 'fleet-status')")
            paths = trace_paths
        if len(paths) == 1:
            records = obs_trace.read_jsonl(paths[0])
        else:
            merged = obs_fleet.merge_traces(paths)
            records = merged["records"]
    except obs_trace.TraceReadError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    summary = obs_trace.summarize(records)
    ttfi = None
    if merged is None:
        try:
            ttfi = time_to_first_iteration(records)
        except ValueError:
            ttfi = None              # no dispatch span: the summary only
    cost = merge_cost(records) if args.cost else None
    # The per-slab ingest attribution, wherever the trace holds slab
    # 'stage' spans.
    slabs = ingest_breakdown(records)

    if args.chrome:
        with open(args.chrome, "w") as f:
            json.dump({"traceEvents": obs_trace.chrome_events(records),
                       "displayTimeUnit": "ms"}, f)

    if args.json:
        from kmeans_tpu_torch.utils.profiling import sanitize_json
        out = {"files": paths, "phases": summary,
               "time_to_first_iteration": ttfi,
               "ingest_slabs": slabs or None,
               "chrome": args.chrome}
        if merged is not None:
            out["fleet"] = {k: merged[k] for k in
                            ("hosts", "align", "barriers",
                             "skew_bound_s", "ntp_delta_s")}
        if args.cost:
            out["cost"] = cost
        print(json.dumps(sanitize_json(out), indent=2))
        return 0

    n_spans = sum(1 for r in records if r.get("kind") == "span")
    n_events = sum(1 for r in records if r.get("kind") == "event")
    if merged is not None:
        print(obs_fleet.format_fleet_summary(merged))
        print()
    print(f"trace: {', '.join(paths)} — {n_spans} spans, "
          f"{n_events} events")
    header = (f"  {'phase':<20} {'count':>6} {'total ms':>10} "
              f"{'p50 ms':>9} {'p99 ms':>9} {'events':>7}")
    if args.cost:
        # flops, bytes and intensity of the captured programs, and no
        # wall-time rate: a record counts one pass, a span may hold many.
        header += f" {'flops':>10} {'bytes':>10} {'ai':>7}"
    print(header)
    for name in sorted(summary,
                       key=lambda n: -summary[n]["total"]):
        row = summary[name]
        line = (f"  {name:<20} {row['count']:>6} "
                f"{row['total'] * 1e3:>10.2f} {row['p50'] * 1e3:>9.3f} "
                f"{row['p99'] * 1e3:>9.3f} {row['events']:>7}")
        if args.cost:
            c = (cost or {}).get(name)
            if c and c["programs"]:
                ai = c.get("ai")
                line += (f" {c['flops']:>10.3g} "
                         f"{c['bytes_accessed']:>10.3g} "
                         + (f"{ai:>7.2f}" if ai is not None
                            else f"{'-':>7}"))
            else:
                line += f" {'-':>10} {'-':>10} {'-':>7}"
        print(line)
    if ttfi is not None:
        print()
        print(format_phase_table(ttfi))
    if slabs:
        print()
        print(format_ingest_table(slabs))
    if args.chrome:
        print(f"\nchrome trace written to {args.chrome} "
              f"(load in chrome://tracing or ui.perfetto.dev)")
    return 0


def fleet_status_main(argv=None) -> int:
    """``python -m kmeans_tpu_torch fleet-status <dir-or-files> [--json]``:
    progress, liveness and lag per host from the merged heartbeat streams
    (the table the autopilot acts on).

    Inputs: heartbeat JSONL files (the per-process ``hb.p{idx}.jsonl``
    family that ``obs.heartbeat`` writes), a directory, or a glob; trace
    files beside them are skipped.  The committed straggler rules of
    ``obs.fleet`` apply; ``--now`` anchors liveness at the wall clock (live
    monitoring) instead of the newest record, and then a host silent past
    the stall window in the middle of a fit flags ``stalled`` even at the
    leader's iteration.

    Exit 0: a healthy fleet.  Exit 1: stragglers flagged.  Exit 2:
    unreadable or malformed inputs, or no heartbeat records."""
    parser = argparse.ArgumentParser(
        prog="python -m kmeans_tpu_torch fleet-status",
        description="Per-host progress/liveness/lag table from merged "
                    "fleet heartbeat files")
    parser.add_argument("paths", nargs="+",
                        help="heartbeat JSONL file(s), directory, or "
                             "glob")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable report on stdout")
    parser.add_argument("--now", action="store_true",
                        help="anchor liveness at the current wall "
                             "clock (live monitoring) instead of the "
                             "newest record (post-hoc)")
    parser.add_argument("--rate-factor", type=float, default=None,
                        help="override the committed slow-host rows/s "
                             "factor")
    parser.add_argument("--behind-iters", type=int, default=None,
                        help="override the committed behind-leader "
                             "iteration threshold")
    args = parser.parse_args(argv)

    from kmeans_tpu_torch.obs import fleet as obs_fleet
    from kmeans_tpu_torch.obs.trace import TraceReadError
    try:
        files = obs_fleet.expand_fleet_paths(args.paths)
        hb_files = [p for p in files
                    if obs_fleet.sniff_stream(p) != "trace"]
        if not hb_files:
            raise TraceReadError(
                f"no heartbeat files among {files} (trace streams are "
                f"summarized by 'trace summarize')")
        records = obs_fleet.merge_heartbeats(hb_files)
        kwargs = {}
        if args.now:
            kwargs["now"] = time.time()
        if args.rate_factor is not None:
            kwargs["rate_factor"] = args.rate_factor
        if args.behind_iters is not None:
            kwargs["behind_iters"] = args.behind_iters
        report = obs_fleet.straggler_report(records, **kwargs)
    except TraceReadError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        from kmeans_tpu_torch.utils.profiling import sanitize_json
        print(json.dumps(sanitize_json({"files": hb_files, **report})))
    else:
        print(obs_fleet.format_fleet_status(report))
    return 0 if report["healthy"] else 1


def autopilot_main(argv=None) -> int:
    """``python -m kmeans_tpu_torch autopilot --spec spec.json --out dir
    --world N [--json]``: supervise a fleet of per-host ``fit(resume=)``
    workers under the committed rules of ``orchestrator.policy``: relaunch
    the preempted from the last rotating checkpoint, evict stalled hosts
    and shrink, grow back when capacity returns, back off deterministically
    on launch flakes, and refuse with the whole typed decision log when a
    committed budget is spent.  The spec's schema is in
    ``orchestrator.worker``.

    Exit 0: converged at the target world.  Exit 1: finished but degraded
    (a smaller fleet completed the fit).  Exit 2: gave up
    (``AutopilotGaveUpError``, the decision log on stderr) or bad
    inputs."""
    parser = argparse.ArgumentParser(
        prog="python -m kmeans_tpu_torch autopilot",
        description="Elastic supervising loop over per-host fit "
                    "workers (evict/shrink/grow/relaunch under "
                    "committed typed rules)")
    parser.add_argument("--spec", required=True,
                        help="worker spec JSON (orchestrator.worker)")
    parser.add_argument("--out", required=True,
                        help="run directory (checkpoints, heartbeats, "
                             "decision log, worker artifacts)")
    parser.add_argument("--world", type=int, required=True,
                        help="fleet size to launch")
    parser.add_argument("--target-world", type=int, default=None,
                        help="world size that counts as converged "
                             "(default: --world)")
    parser.add_argument("--no-grow", action="store_true",
                        help="never grow a shrunk fleet back")
    parser.add_argument("--poll-period", type=float, default=None,
                        help="override the committed poll period "
                             "(seconds)")
    parser.add_argument("--max-run-s", type=float, default=None,
                        help="override the committed run deadline")
    parser.add_argument("--coordinator-address", default=None,
                        help="torch.distributed init_method of a real "
                             "world, tcp://host:port (default: a "
                             "simulated fleet's environment)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable result on stdout")
    args = parser.parse_args(argv)

    from kmeans_tpu_torch.orchestrator import (Autopilot,
                                               AutopilotGaveUpError)
    from kmeans_tpu_torch.utils.profiling import sanitize_json
    kwargs = {}
    if args.target_world is not None:
        kwargs["target_world"] = args.target_world
    if args.poll_period is not None:
        kwargs["poll_period_s"] = args.poll_period
    if args.max_run_s is not None:
        kwargs["max_run_s"] = args.max_run_s
    if args.coordinator_address is not None:
        kwargs["coordinator_address"] = args.coordinator_address
    try:
        pilot = Autopilot(args.spec, args.out, args.world,
                          grow=not args.no_grow, **kwargs)
        result = pilot.run()
    except AutopilotGaveUpError as e:
        # The typed give-up is exit code 2, its decision log on stderr.
        if args.json:
            print(json.dumps(sanitize_json(
                {"outcome": "gave-up", "exit_code": 2,
                 "reason": e.reason,
                 "decisions": [d.as_dict() for d in e.decisions]})))
        print(e.report(), file=sys.stderr)
        return 2
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(sanitize_json(result.as_dict())))
    else:
        print(f"autopilot {result.outcome}: fleet of "
              f"{result.final_world}/{result.target_world} finished, "
              f"{len(result.decisions)} decisions "
              f"(log: {result.out_dir}/autopilot.decisions.jsonl)")
    return result.exit_code


def cost_report_main(argv=None) -> int:
    """``python -m kmeans_tpu_torch cost-report``: each family's small fit
    under cost capture (``obs.report.device_cost_report``): the measured
    step program's flops against the hand formula (the committed 10 %
    band), arithmetic intensity, its peak bytes against the memory plan,
    then the plan table and the device's free bytes (unreported on the
    CPU).  ``--json`` prints the payload; a device that cannot report
    gives ``available=False`` rows, never a failure.  Exit 0 whenever the
    fits succeed."""
    parser = argparse.ArgumentParser(
        prog="python -m kmeans_tpu_torch cost-report",
        description="Cost and memory analysis per built step program: "
                    "analytic-FLOPs cross-check, roofline, and the "
                    "device-memory footprint plan")
    parser.add_argument("--families", default=None,
                        help="comma list (default: kmeans,spherical,"
                             "bisecting,minibatch,gmm)")
    parser.add_argument("--n", type=int, default=None,
                        help="rows override for every family")
    parser.add_argument("--d", type=int, default=None)
    parser.add_argument("--k", type=int, default=None)
    parser.add_argument("--chunk", type=int, default=None,
                        help="explicit chunk (default: one whole "
                             "shard, the analytic-agreement regime)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable JSON on stdout")
    _add_device(parser)
    args = parser.parse_args(argv)

    from kmeans_tpu_torch.obs.memory import FAMILIES, format_plan_table
    from kmeans_tpu_torch.obs.report import (device_cost_report,
                                             format_cost_table)
    families = [f.strip() for f in args.families.split(",")] \
        if args.families else None
    for fam in families or ():
        if fam not in FAMILIES:
            print(f"error: unknown family {fam!r}; families: "
                  f"{','.join(FAMILIES)}", file=sys.stderr)
            return 2
    device = _resolve_device(args)
    if device is None:
        return 2
    override = {k: v for k, v in
                (("n", args.n), ("d", args.d), ("k", args.k))
                if v is not None}
    specs = {fam: dict(override)
             for fam in (families or FAMILIES)} if override else None
    rep = device_cost_report(families, specs=specs, chunk=args.chunk,
                             device=device)
    if args.json:
        from kmeans_tpu_torch.utils.profiling import sanitize_json
        print(json.dumps(sanitize_json(rep), default=str))
        return 0
    print(format_cost_table(rep["rows"],
                            title=f"device cost ({rep['backend']})"))
    print()
    print(format_plan_table(rep["plans"], device=device))
    return 0


def plan_main(argv=None) -> int:
    """``python -m kmeans_tpu_torch plan --n N --d D --k K [...]``: the
    memory planner and the massive-k resolution, alone: the dense
    per-device footprint at (N, D, k, mesh, chunk) in the distance mode a
    fit takes on ``--device`` ('auto' is the kernel on a CUDA device in
    float32), the k-sharded footprint when the mesh has a model axis, and
    the ``k_shard`` / ``assign`` values the 'auto' rule picks there: the
    fit's own rule (``obs.memory.dense_room``, which
    ``KMeans._resolve_large_k`` asks), counting what a fit has still to
    allocate, the rows included.  Arithmetic and one read of the
    allocator's numbers: nothing is placed."""
    parser = argparse.ArgumentParser(
        prog="python -m kmeans_tpu_torch plan",
        description="Per-device memory footprint plan + massive-k "
                    "k_shard/assign resolution for a fit shape")
    parser.add_argument("--n", type=int, required=True, help="rows")
    parser.add_argument("--d", type=int, required=True, help="features")
    parser.add_argument("--k", type=int, required=True, help="clusters")
    parser.add_argument("--data-shards", type=int, default=None,
                        help="default: the world size of an initialized "
                             "process group, else 1")
    parser.add_argument("--model-shards", type=int, default=1)
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--chunk", type=int, default=None,
                        help="torch-pass chunk (default: "
                             "choose_chunk_size)")
    parser.add_argument("--k-shard", default="auto",
                        help="auto | 0 | <model_shards> (the KMeans "
                             "knob grammar)")
    parser.add_argument("--assign", default="auto",
                        choices=("auto", "dense", "two_level"))
    parser.add_argument("--json", action="store_true")
    _add_device(parser)
    args = parser.parse_args(argv)

    from kmeans_tpu_torch.models.kmeans import resolve_distance_mode
    from kmeans_tpu_torch.obs import memory as _mem
    from kmeans_tpu_torch.parallel.mesh import world_size
    from kmeans_tpu_torch.parallel.sharding import choose_chunk_size
    # The port's data shards: the ranks of an initialized process group.
    S = args.data_shards if args.data_shards is not None \
        else world_size()
    M = int(args.model_shards)
    if args.k_shard != "auto":
        try:
            ks_req = int(args.k_shard)
        except ValueError:
            print(f"error: --k-shard must be 'auto' or an int, got "
                  f"{args.k_shard!r}", file=sys.stderr)
            return 2
        if ks_req not in (0, M) or (ks_req and M <= 1):
            print(f"error: --k-shard={ks_req} must be 0 or match "
                  f"--model-shards={M} (the table shards on the "
                  f"existing TP axis)", file=sys.stderr)
            return 2
    device = _resolve_device(args)
    if device is None:
        return 2
    chunk = args.chunk or choose_chunk_size(
        -(-args.n // S), max(args.k, M), args.d)
    room = _mem.dense_room(
        args.n, args.d, args.k, data_shards=S, model_shards=M,
        dtype=args.dtype, chunk=chunk,
        mode=resolve_distance_mode("auto", device, args.dtype),
        device=device)
    plans = [room["plan"]]
    if M > 1:
        # The k-sharded step runs the torch pass ('auto' is 'matmul' on
        # the large-k routes).
        plans.append(_mem.plan_fit("kmeans", args.n, args.d, args.k,
                                   data_shards=S, model_shards=M,
                                   dtype=args.dtype, chunk=chunk,
                                   k_shard=M, device=device))
    info, fits = room["device_memory"], room["fits"]
    ks, asg = _mem.auto_route(
        args.k_shard if args.k_shard == "auto" else int(args.k_shard),
        args.assign, fits, M)
    if asg == "two_level" and M != 1:
        print("error: assign='two_level' composes with data "
              "parallelism only (model_shards == 1); on a TP mesh use "
              "k_shard instead", file=sys.stderr)
        return 2
    why = ("allocator stats unavailable on this backend — dense "
           "oracles" if not info.get("available")
           else "dense plan fits in 80% of free HBM" if fits
           else "dense plan exceeds 80% of free HBM")
    resolution = {"k_shard": ks, "assign": asg,
                  "auto_rule": why,
                  "dense_predicted_peak_bytes":
                      plans[0]["predicted_peak_bytes"],
                  "device_memory": info}
    if args.json:
        from kmeans_tpu_torch.utils.profiling import sanitize_json
        print(json.dumps(sanitize_json(
            {"plans": plans, "resolution": resolution}), default=str))
        return 0
    print(_mem.format_plan_table(
        plans, title=f"hbm footprint plan ({S}x{M} mesh)", device=device))
    print()
    print(f"resolution     : k_shard={ks}, assign={asg!r}  [{why}]")
    if M > 1:
        dense, shard = plans[0], plans[1]
        saved = dense["predicted_peak_bytes"] \
            - shard["predicted_peak_bytes"]
        print(f"k-shard saves  : {saved:,} B/device of predicted peak "
              f"(replicated full-k stats accumulators -> local shard)")
    return 0


def lint_main(argv=None) -> int:
    """``python -m kmeans_tpu_torch lint [--json] [--rule ID] [paths]`` —
    the package's AST invariant linter (one rule per historical incident
    class of the original project; the reference's ``lint_main``).  Thin
    delegator: the implementation lives in
    :mod:`kmeans_tpu_torch.analysis.cli`; the analysis never imports or
    executes the modules it checks, so linting creates no CUDA context,
    runs no ``nvcc`` and loads no kernel library.  Exit 0 clean, 2 on
    findings or a malformed path."""
    from kmeans_tpu_torch.analysis.cli import main
    return main(argv)


def serve_status_main(argv=None) -> int:
    """``python -m kmeans_tpu_torch serve-status <dir-or-files> [--json]``:
    the serving-quality and drift table per model from the quality JSONL
    sinks a monitored ``ServingEngine`` writes (``quality.<id>.jsonl``
    under ``quality_dir`` / ``serve --quality-dir``).  A model is
    ``DRIFTING`` when its newest record's debounced state says so; trace
    and heartbeat files beside them are skipped.

    Exit 0: every monitored model healthy.  Exit 1: at least one model
    drifting.  Exit 2: unreadable or malformed inputs, or no quality
    records."""
    parser = argparse.ArgumentParser(
        prog="python -m kmeans_tpu_torch serve-status",
        description="Per-model serving-quality & drift table from a "
                    "monitored engine's quality JSONL sinks")
    parser.add_argument("paths", nargs="+",
                        help="quality JSONL file(s), directory, or "
                             "glob")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable report on stdout")
    args = parser.parse_args(argv)

    from kmeans_tpu_torch.obs import drift as obs_drift
    from kmeans_tpu_torch.obs.trace import TraceReadError
    try:
        report = obs_drift.quality_report(args.paths)
    except TraceReadError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report))
    else:
        print(obs_drift.format_quality_status(report))
    return 0 if report["healthy"] else 1


#: The families ``warm`` fits (the reference's table).
_WARM_FAMILIES = ("kmeans", "minibatch", "bisecting", "spherical", "gmm")


def _warm_class(name: str):
    import kmeans_tpu_torch as kt
    table = {"kmeans": kt.KMeans, "minibatch": kt.MiniBatchKMeans,
             "bisecting": kt.BisectingKMeans,
             "spherical": kt.SphericalKMeans,
             "gmm": kt.GaussianMixture,
             # model_class names from checkpoint metadata
             "KMeans": kt.KMeans, "MiniBatchKMeans": kt.MiniBatchKMeans,
             "BisectingKMeans": kt.BisectingKMeans,
             "SphericalKMeans": kt.SphericalKMeans,
             "GaussianMixture": kt.GaussianMixture}
    return table.get(name)


def _model_libraries(model) -> list:
    """The kernel libraries a fit of ``model`` launches, by its distance
    mode (``utils.aot.libraries_for`` of its fit builder's key)."""
    from kmeans_tpu_torch import GaussianMixture
    from kmeans_tpu_torch.utils import aot
    builder = "make_gmm_fit_fn" if isinstance(model, GaussianMixture) \
        else "make_fit_fn"
    return aot.libraries_for((builder, (), (("mode", model._mode()),)))


def warm_main(argv=None) -> int:
    """``python -m kmeans_tpu_torch warm <ckpt | --family F --shape NxD
    --k K>``: fill the store of built kernel libraries (``utils.aot``) for
    a (family, bucket, dtype) set.  One synthetic fit at the bucketed
    shape runs through the real fit engine (the device loop where the
    family has one) with the store active, so the next process (a fresh
    host resuming a shipped checkpoint, a fleet taking a new fit) loads
    its libraries (``compile`` spans ``via='aot-load'``) instead of
    building them with ``nvcc``.

    With a checkpoint the model's own parameters drive the fit and the
    libraries also go into the sibling ``<ckpt>.aot`` directory (what ships
    with the checkpoint).  The libraries of the model's mode are put into
    the store and its mirror even where this process had them loaded
    already (a warm fit then builds and loads nothing).  Prints what was
    built and loaded; ``--json`` prints the store's stats.  Exit 2 where
    no library can load (no CUDA card: ``available=False``) or the
    arguments do not resolve."""
    parser = argparse.ArgumentParser(
        prog="python -m kmeans_tpu_torch warm",
        description="Pre-populate the store of built kernel libraries "
                    "for a (family, bucket, dtype) set")
    parser.add_argument("ckpt", nargs="?", default=None,
                        help="checkpoint whose model (and sibling "
                             ".aot dir) to warm")
    parser.add_argument("--family", choices=_WARM_FAMILIES,
                        default="kmeans",
                        help="model family (no-checkpoint form)")
    parser.add_argument("--shape", default=None, metavar="NxD",
                        help="data shape to warm, e.g. 8192x32 "
                             "(default: 8192 rows x the checkpoint's "
                             "feature count)")
    parser.add_argument("--k", type=int, default=8,
                        help="clusters/components (no-checkpoint form)")
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--bucket", default="auto",
                        help="fit-shape bucket the programs commit to "
                             "(default auto)")
    parser.add_argument("--model-shards", type=int, default=1,
                        help="model axis size (the centroid sharding)")
    parser.add_argument("--max-iter", type=int, default=None,
                        help="device-loop segment length to warm "
                             "(default: the model's max_iter)")
    parser.add_argument("--aot-dir", default=None, metavar="DIR",
                        help="store directory (default: "
                             "KMEANS_TPU_TORCH_AOT_CACHE or "
                             "kmeans_tpu_torch_aot in the temporary "
                             "directory)")
    parser.add_argument("--json", action="store_true")
    _add_device(parser)
    args = parser.parse_args(argv)

    from kmeans_tpu_torch.ops import _build
    from kmeans_tpu_torch.utils import aot
    from kmeans_tpu_torch.utils.cache import AOT_ENV
    aot.enable_compilation_cache()
    ok, reason = aot.aot_supported()
    if not ok:
        print(f"error: this backend cannot serialize compiled "
              f"executables ({reason}); the AOT cache is unavailable "
              f"(available=False)", file=sys.stderr)
        return 2
    try:
        bucket = _parse_bucket(args.bucket)
    except ValueError:
        print(f"error: --bucket must be 'auto' or an int, got "
              f"{args.bucket!r}", file=sys.stderr)
        return 2
    device = _resolve_device(args)
    if device is None:
        return 2
    root = args.aot_dir or os.environ.get(AOT_ENV) \
        or os.path.join(tempfile.gettempdir(), "kmeans_tpu_torch_aot")
    mirror = aot.aot_dir_for(args.ckpt) if args.ckpt else None
    store = aot.configure(root, mirror=mirror)

    d = None
    if args.ckpt:
        from kmeans_tpu_torch.utils.checkpoint import describe_checkpoint
        info = describe_checkpoint(args.ckpt)
        cls = _warm_class(info.get("model_class") or "")
        if cls is None:
            print(f"error: {args.ckpt}: no loadable model "
                  f"(model_class={info.get('model_class')!r}, "
                  f"primary_error={info.get('primary_error')!r})",
                  file=sys.stderr)
            return 2
        model = cls.load(args.ckpt, device=device)
        table = getattr(model, "centroids", None)
        if table is None:
            table = getattr(model, "means_", None)
        d = int(np.asarray(table).shape[1]) if table is not None else None
    else:
        cls = _warm_class(args.family)
        kwargs = dict(seed=0, verbose=False, device=device)
        model = cls(**({"n_components": args.k} if args.family == "gmm"
                       else {"k": args.k}), dtype=args.dtype, **kwargs)
    if args.shape:
        try:
            n, d = (int(v) for v in args.shape.lower().split("x"))
        except ValueError:
            print(f"error: --shape must be NxD (e.g. 8192x32), got "
                  f"{args.shape!r}", file=sys.stderr)
            return 2
    else:
        n = 8192
        if d is None:
            print("error: --shape NxD is required without a fitted "
                  "checkpoint (the feature count cannot be inferred)",
                  file=sys.stderr)
            return 2
    if args.max_iter is not None:
        model.max_iter = args.max_iter
    model.bucket = bucket
    if hasattr(model, "model_shards"):
        # A model axis needs a world of that many ranks: the fit raises
        # the mesh's own error in a process of one.
        model.model_shards = args.model_shards
    # The warm fit: synthetic rows at the bucketed shape through the real
    # fit engine (the device loop where the family has one).
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, d)).astype(model.dtype)
    model.verbose = False
    if hasattr(model, "host_loop"):
        model.host_loop = False
    fit_k = getattr(model, "k", getattr(model, "n_components", 2))
    if n < fit_k:
        print(f"error: shape rows ({n}) must be >= k ({fit_k})",
              file=sys.stderr)
        return 2
    model.fit(X)
    # A process that had the libraries loaded already built and loaded
    # nothing in that fit: the mode's libraries go into the store and its
    # mirror all the same.
    for name in _model_libraries(model):
        _build.load(name)
        store.store(name, {}, _build.library_path(name))
    stats = store.stats()
    out = {"family": type(model).__name__, "n": n, "d": d,
           "k": int(fit_k), "bucket": bucket,
           "dtype": str(np.dtype(model.dtype)),
           "ckpt": args.ckpt, **stats}
    if args.json:
        print(json.dumps(out))
    else:
        print(f"warm: {out['family']} k={out['k']} {n}x{d} "
              f"bucket={bucket} -> compiled {stats['built']}, "
              f"loaded {stats['loaded']} (store {stats['root']}"
              + (f", shipped to {stats['mirror']}" if stats["mirror"]
                 else "") + ")")
    return 0


def _ckpt_plan(path, info: dict, plan_n: int) -> dict:
    """The ckpt-info planner block: ``plan_fit`` rows for this checkpoint's
    table on the mesh it was written on, at ``plan_n`` rows, in the
    distance mode a fit of it takes here (its ``distance_mode``, 'auto' on
    the card in float32 the kernel), and the ``k_shard`` / ``assign``
    resolution: the state's own explicit knobs where it carries them, the
    fit's 'auto' rule (``obs.memory.dense_room``) otherwise."""
    import torch

    from kmeans_tpu_torch.models.kmeans import (_FORMAT_MODES,
                                                resolve_distance_mode)
    from kmeans_tpu_torch.obs import memory as _mem
    from kmeans_tpu_torch.parallel.sharding import choose_chunk_size
    from kmeans_tpu_torch.utils.checkpoint import prev_path
    src = path if info["source"] == "primary" else str(prev_path(path))
    with np.load(src, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        name = "centroids" if "centroids" in z.files else next(
            f for f in z.files
            if f != "__meta__" and z[f].ndim == 2)
        d = int(z[name].shape[1])
    mesh = info.get("written_on_mesh") or {}
    S = int(mesh.get("data_shards") or 1)
    M = int(mesh.get("model_shards") or 1)
    k = int(info["k"])
    dtype = str(info.get("dtype") or "float32")
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    saved = str(meta.get("distance_mode", "auto"))
    mode = resolve_distance_mode(
        {v: m for m, v in _FORMAT_MODES.items()}.get(saved, saved),
        device, dtype)
    chunk = choose_chunk_size(-(-plan_n // S), max(k, M), d)
    room = _mem.dense_room(plan_n, d, k, data_shards=S, model_shards=M,
                           dtype=dtype, chunk=chunk, mode=mode,
                           device=device)
    plans = [room["plan"]]
    if M > 1:
        plans.append(_mem.plan_fit("kmeans", plan_n, d, k,
                                   data_shards=S, model_shards=M,
                                   dtype=dtype, chunk=chunk, k_shard=M,
                                   device=device))
    ks, asg = meta.get("k_shard", "auto"), meta.get("assign", "auto")
    # Any explicit knob in the state wins over the auto rule; only a state
    # of 'auto' knobs reports a resolution by the rule alone.
    src_note = "auto rule" if (ks == "auto" and asg == "auto") \
        else "checkpoint knobs"
    ks, asg = _mem.auto_route(ks, asg, room["fits"], M)
    return {"n_assumed": int(plan_n), "d": d, "k": k,
            "data_shards": S, "model_shards": M, "chunk": chunk,
            "plans": plans,
            "k_shard": int(ks), "assign": asg,
            "resolved_by": src_note,
            "table_bytes_per_device":
                plans[-1]["components"]["table_bytes"]}


def ckpt_info_main(argv=None) -> int:
    """``python -m kmeans_tpu_torch ckpt-info <path>``: a checkpoint's
    metadata (model class, k, completed iteration, the mesh it was written
    on, format version), whether the ``.prev`` rotation exists and loads,
    the kernel libraries shipped beside it (``<path>.aot``) and its memory
    plan.  Reads no array but one table's shape, and places nothing.
    Exit 0 where a usable state was found (primary or ``.prev``), 2
    otherwise."""
    parser = argparse.ArgumentParser(
        prog="python -m kmeans_tpu_torch ckpt-info",
        description="Describe a kmeans_tpu_torch checkpoint (topology "
                    "metadata + last-good rotation status)")
    parser.add_argument("path", help="checkpoint path (.npz)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable JSON only")
    parser.add_argument("--plan-n", type=int, default=1_000_000,
                        metavar="N",
                        help="rows assumed for the memory planner block "
                             "(default 1e6 — the table-side terms "
                             "dominate at massive k)")
    args = parser.parse_args(argv)

    from kmeans_tpu_torch.utils import aot
    from kmeans_tpu_torch.utils.checkpoint import describe_checkpoint
    info = describe_checkpoint(args.path)
    # The kernel libraries shipped beside this checkpoint (<path>.aot),
    # described from their zip records alone.
    info["aot"] = aot.describe_dir(aot.aot_dir_for(args.path))
    # The planner block: the table's footprint and the k_shard / assign
    # resolution of this state at --plan-n rows on its written-on mesh.
    # Any failure skips the block, never the report.
    info["plan"] = None
    if info.get("source") and info.get("k"):
        try:
            info["plan"] = _ckpt_plan(args.path, info, args.plan_n)
        except Exception:       # noqa: BLE001 -- the block is optional
            info["plan"] = None
    if args.json:
        print(json.dumps(info, indent=2))
        return 0 if info.get("source") else 2
    if info.get("source") is None:
        print(f"error: {info['path']}: no loadable state "
              f"(primary: {info.get('primary_error')}; "
              f".prev exists: {info['prev_exists']}"
              + (f", loads: {info.get('prev_loads')}"
                 if info["prev_exists"] else "") + ")",
              file=sys.stderr)
        return 2
    mesh = info.get("written_on_mesh") or {}
    lines = [
        f"checkpoint      : {info['path']}  [read from "
        f"{info['source']}]",
        f"model           : {info.get('model_class')} "
        f"(k={info.get('k')}, iteration {info.get('iteration')})",
        f"written on mesh : data_shards="
        f"{mesh.get('data_shards')}, model_shards="
        f"{mesh.get('model_shards')} (informational — state is "
        f"canonical; resume re-shards for any topology)",
        f"format version  : {info.get('format_version')}   "
        f"jax {info.get('jax_version')}   dtype {info.get('dtype')}",
        f".prev rotation  : exists={info['prev_exists']}"
        + (f", loads={info['prev_loads']}" if info["prev_exists"]
           else ""),
    ]
    a = info["aot"]
    if a["exists"]:
        libs = ", ".join(f"{lib['library']}@sm{lib['capability']}"
                         for lib in a["libraries"]) or "-"
        lines.append(
            f"aot libraries   : {a['artifacts']} artifacts "
            f"({a['bytes']:,} B) in {a['path']} [{libs}]"
            + (f", {a['unreadable']} unreadable" if a["unreadable"]
               else ""))
    else:
        lines.append(
            "aot libraries   : none shipped (run `python -m "
            "kmeans_tpu_torch warm <ckpt>` to pre-populate)")
    p = info.get("plan")
    if p:
        from kmeans_tpu_torch.obs.memory import _fmt_bytes
        lines.append(
            f"table footprint : "
            f"{_fmt_bytes(p['table_bytes_per_device'])}/device "
            f"(k={p['k']}, d={p['d']}, {p['data_shards']}x"
            f"{p['model_shards']} mesh)")
        lines.append(
            f"large-k route   : k_shard={p['k_shard']}, "
            f"assign={p['assign']!r}  [{p['resolved_by']}; planned at "
            f"n={p['n_assumed']:,}, predicted peak "
            f"{_fmt_bytes(p['plans'][-1]['predicted_peak_bytes'])}"
            f"/device]")
    if info.get("primary_error"):
        lines.append(f"primary error   : {info['primary_error']}")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
