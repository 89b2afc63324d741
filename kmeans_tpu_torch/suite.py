"""The original project's test suite, tests A to E, with a real exit code.

Counterpart of ``kmeans_tpu/suite.py``: the banners, the sequential tests
A (correctness), B (scale and performance), C (convergence), D (empty
clusters) and E (speedup graph), the PASSED / FAILED lines, and exit code 1
when any test failed.

Run: ``python -m kmeans_tpu_torch.suite`` on the card (one rank per card,
NCCL; with one card, test E sweeps one shard count), or
``python -m kmeans_tpu_torch.suite --device cpu --world 4`` for four gloo
ranks on the CPU.  Every rank runs every test over the mesh of the world;
rank 0 prints.

Differences from the JAX package's suite, by design:

* test A's oracle is a float64 NumPy Lloyd loop from the shared init,
  written here (no scikit-learn on the card), run to the fixed point
  scikit-learn's ``KMeans`` reaches from that init;
* the data come from this package's ``make_blobs`` and ``make_gaussian``;
* test E sweeps data-parallel rank counts 1, 2, 4 and 8 up to the world
  size, over sub-meshes of one world (ranks outside a sub-mesh wait), and
  writes ``speedup_graph.svg`` with the standard library (no matplotlib).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def _banner(title: str) -> None:
    print("\n" + "=" * 80)
    print(title)
    print("=" * 80)


def _result(name: str, ok: bool, detail: str = "") -> bool:
    mark = "✓" if ok else "✗"
    word = "PASSED" if ok else "FAILED"
    print(f"\n{mark} {name} {word}{(': ' + detail) if detail else ''}")
    sys.stdout.flush()
    return ok


def lloyd_oracle(X: np.ndarray, init: np.ndarray,
                 max_iter: int = 300) -> np.ndarray:
    """Float64 Lloyd iterations from ``init`` until no label changes (or
    ``max_iter``): nearest centre by the direct squared distance, lowest
    index on ties; an empty cluster keeps its centre.  The fixed point
    scikit-learn's ``KMeans(init=init, n_init=1)`` reaches."""
    X = np.asarray(X, np.float64)
    c = np.array(init, np.float64)
    labels = None
    for _ in range(max_iter):
        d2 = ((X[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        new = d2.argmin(1)
        if labels is not None and np.array_equal(new, labels):
            break
        labels = new
        for j in range(c.shape[0]):
            if np.any(labels == j):
                c[j] = X[labels == j].mean(0)
    return c


def test_a_correctness(mesh, device) -> bool:
    """1000 points, 3 centres, 2-D: sorted centroids against the float64
    oracle from the same init, within 1e-4."""
    from kmeans_tpu_torch import KMeans
    from kmeans_tpu_torch.data.synthetic import make_blobs

    _banner("TEST A: CORRECTNESS (The 'Blob' Test)")
    X, _ = make_blobs(1000, 3, 2, random_state=42, dtype=np.float64)
    # The shared init: centroid equality then tests the algorithm, not the
    # luck of the init draws.
    rng = np.random.RandomState(42)
    init = X[rng.choice(len(X), size=3, replace=False)]

    print("\n[kmeans_tpu_torch KMeans]")
    ours = KMeans(k=3, max_iter=300, tolerance=1e-12, seed=42,
                  compute_sse=True, init=init, mesh=mesh,
                  dtype=np.float64, device=device).fit(X)
    print("\n[float64 NumPy Lloyd oracle]")
    ref = lloyd_oracle(X, init)
    a = np.array(sorted(ours.centroids.tolist()))
    b = np.array(sorted(ref.tolist()))
    print("\nkmeans_tpu_torch centroids:\n", a)
    print("oracle centroids:\n", b)
    ok = np.allclose(a, b, atol=1e-4)
    detail = "" if ok else f"max diff {np.max(np.abs(a - b)):.3e}"
    return _result("TEST A", ok, detail or "centroids match within 1e-4")


def test_b_performance(mesh, device) -> bool:
    """100k x 10 standard-normal points, k=5, 20 iterations, SSE off."""
    from kmeans_tpu_torch import KMeans
    from kmeans_tpu_torch.data.synthetic import make_gaussian
    from kmeans_tpu_torch.parallel.mesh import mesh_shape

    _banner("TEST B: SCALE & PERFORMANCE (The 'Stress' Test)")
    X = make_gaussian(100_000, 10, random_state=42, dtype=np.float32)
    print(f"\nDataset: {X.shape[0]} points, {X.shape[1]} dimensions")
    data, model = mesh_shape(mesh)
    print(f"Mesh: {{'data': {data}, 'model': {model}}}")

    kw = dict(k=5, max_iter=20, tolerance=1e-4, seed=42, compute_sse=False,
              mesh=mesh, verbose=False, device=device)
    km_warm = KMeans(**kw)
    ds = km_warm.cache(X)
    km_warm.fit(ds)                       # warm-up (kernel loads), excluded
    km = KMeans(**kw)
    start = time.perf_counter()
    km.fit(ds)
    total = time.perf_counter() - start
    iters = km.iterations_run             # the true count
    print("\n[Performance Metrics]")
    print(f"Total Iterations: {iters}")
    print(f"Total Time: {total:.2f} seconds (warm; warm-up excluded)")
    print(f"Average Time per Iteration: {total / iters:.4f} seconds")
    ok = iters >= 1 and bool(np.all(np.isfinite(km.centroids)))
    return _result("TEST B", ok, "performance metrics reported")


def test_c_convergence(mesh, device) -> bool:
    """SSE monotonicity of a float64 fit."""
    from kmeans_tpu_torch import KMeans
    from kmeans_tpu_torch.data.synthetic import make_blobs

    _banner("TEST C: CONVERGENCE CHECK")
    X, _ = make_blobs(5000, 4, 5, random_state=42, dtype=np.float64)
    km = KMeans(k=4, max_iter=30, tolerance=1e-5, seed=42,
                compute_sse=True, mesh=mesh, dtype=np.float64,
                device=device).fit(X)
    print("\n[SSE History]")
    for i, sse in enumerate(km.sse_history):
        print(f"Iteration {i + 1}: SSE = {sse:.4f}")
    ok = all(km.sse_history[i] <= km.sse_history[i - 1] + 1e-6
             for i in range(1, len(km.sse_history)))
    return _result("TEST C", ok,
                   "SSE is monotonically decreasing (or stable)" if ok
                   else "SSE increased during iterations")


def test_d_empty_clusters(mesh, device) -> bool:
    """3 tight blobs, k=6 forces empties; all centroids must stay
    finite."""
    from kmeans_tpu_torch import KMeans
    from kmeans_tpu_torch.data.synthetic import make_blobs

    _banner("TEST D: EMPTY CLUSTER HANDLING")
    X, _ = make_blobs(800, 3, 2, cluster_std=0.5, random_state=42,
                      dtype=np.float64)
    print(f"\nDataset: {X.shape[0]} points with 3 natural clusters")
    print("Fitting k=6 clusters (forcing empty-cluster scenario)")
    try:
        km = KMeans(k=6, max_iter=30, tolerance=1e-4, seed=42,
                    compute_sse=True, mesh=mesh, device=device).fit(X)
        ok = bool(np.all(np.isfinite(km.centroids)))
        if ok:
            print(f"Final centroids shape: {km.centroids.shape}")
            print("All centroids are finite (no NaN/Inf values)")
        return _result("TEST D", ok,
                       "empty clusters handled correctly" if ok
                       else "invalid centroids detected")
    except Exception as e:                # noqa: BLE001 — the test's guard
        return _result("TEST D", False, f"exception occurred: {e}")


def test_e_speedup_graph(out_dir: Path, device) -> bool:
    """Strong-scaling sweep and its graph, over data-parallel rank counts
    (sub-meshes of the world; ranks outside one wait)."""
    from kmeans_tpu_torch import KMeans
    from kmeans_tpu_torch.data.synthetic import make_blobs
    from kmeans_tpu_torch.parallel import multihost
    from kmeans_tpu_torch.parallel.mesh import (barrier, in_mesh,
                                                make_mesh, world_size)
    from kmeans_tpu_torch.utils.plotting import save_speedup_graph

    _banner("TEST E: SPEEDUP GRAPH")
    X, _ = make_blobs(50_000, 5, 10, random_state=42, dtype=np.float32)
    world = world_size()
    shard_counts = [n for n in (1, 2, 4, 8) if n <= world]
    print(f"\nDataset: {X.shape[0]} points, {X.shape[1]} dimensions")
    print(f"K-Means Parameters: k=5, max_iter=10; shard counts: "
          f"{shard_counts}")
    if world == 1:
        print("One rank in the world (one card): the sweep has one shard "
              "count, so the graph shows no scaling.")

    times = {}
    for n in shard_counts:
        mesh = make_mesh(data=n, model=1, ranks=range(n))
        if in_mesh(mesh):
            kw = dict(k=5, max_iter=10, tolerance=1e-4, seed=42,
                      compute_sse=False, mesh=mesh, verbose=False,
                      device=device)
            km_warm = KMeans(**kw)
            ds = km_warm.cache(X)
            km_warm.fit(ds)               # warm-up, excluded
            km = KMeans(**kw)
            start = time.perf_counter()
            km.fit(ds)
            times[n] = time.perf_counter() - start
            print(f"Shards: {n} | Time: {times[n]:.4f}s")
        barrier(None)                     # ranks outside the mesh wait here
    out = out_dir / "speedup_graph.svg"
    if not multihost.is_primary():
        return True
    speedups = {n: times[shard_counts[0]] / times[n] for n in shard_counts}
    print("\n[Timing Summary]")
    for n in shard_counts:
        print(f"Shards: {n:2d} | Time: {times[n]:8.4f}s | "
              f"Speedup: {speedups[n]:6.4f}x")
    save_speedup_graph(shard_counts, speedups, out)
    print(f"Graph saved to: {out}")
    return _result("TEST E", out.exists(), "speedup graph generated")


#: The tests over the world's mesh, by their ``--only`` letter.
TESTS = {"a": ("A", "test_a_correctness"), "b": ("B", "test_b_performance"),
         "c": ("C", "test_c_convergence"), "d": ("D", "test_d_empty_clusters")}


def run(selected, out_dir: Path, device) -> int:
    """Every selected test over the world's mesh; the exit code: 1 when
    any failed.  Every rank runs it; rank 0 prints."""
    from kmeans_tpu_torch.parallel import multihost
    from kmeans_tpu_torch.parallel.mesh import make_mesh, world_size

    quiet = contextlib.nullcontext() if multihost.is_primary() else \
        contextlib.redirect_stdout(io.StringIO())
    with quiet:
        _banner("DISTRIBUTED K-MEANS (PyTorch) - PRODUCTION TEST SUITE")
        print(f"device: {device}, ranks: {world_size()}, backend: "
              f"{torch.distributed.get_backend()}")
        mesh = make_mesh()
        results = {}
        for key in "abcd":
            if key in selected:
                name, fn = TESTS[key]
                results[name] = globals()[fn](mesh, device)
        if "e" in selected:
            results["E"] = test_e_speedup_graph(out_dir, device)
        _banner("ALL TESTS COMPLETED")
        for name, ok in results.items():
            print(f"  TEST {name}: {'PASSED' if ok else 'FAILED'}")
    return 1 if not all(results.values()) else 0


def _rank_main(rank: int, world: int, store: str, selected, out_dir: str,
               device: str, codes: str) -> None:
    """One spawned rank: the world over ``store``, then :func:`run`; its
    exit code goes to ``codes.<rank>``."""
    from kmeans_tpu_torch.parallel import multihost
    if world > 1:
        torch.set_num_threads(1)          # the ranks share the host's cores
    multihost.initialize(f"file://{store}", world_size=world, rank=rank,
                         backend="nccl" if device == "cuda" else "gloo")
    try:
        code = run(selected, Path(out_dir), device)
    finally:
        torch.distributed.destroy_process_group()
    Path(f"{codes}.{rank}").write_text(str(code))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="kmeans_tpu_torch: the original project's tests A-E")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="cuda (the default where there is a card) or "
                             "cpu")
    parser.add_argument("--world", type=int, default=None,
                        help="ranks: one per card on cuda (the default is "
                             "the card count), gloo processes on cpu "
                             "(default 1)")
    parser.add_argument("--out-dir", default="artifacts",
                        help="directory for the speedup graph")
    parser.add_argument("--only", default=None,
                        help="comma-separated subset of a,b,c,d,e")
    args = parser.parse_args(argv)
    device = args.device or ("cuda" if torch.cuda.is_available() else None)
    if device is None:
        parser.error("torch.cuda.is_available() is False: pass --device cpu "
                     "to run on the CPU")
    if device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: torch.cuda.is_available() is False")
    world = args.world or (torch.cuda.device_count() if device == "cuda"
                           else 1)
    if world <= 0 or (device == "cuda" and world > torch.cuda.device_count()):
        parser.error(f"--world {world}: one rank per card on cuda")
    selected = set((args.only or "a,b,c,d,e").split(","))
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        store, codes = os.path.join(tmp, "store"), os.path.join(tmp, "code")
        if world == 1:
            _rank_main(0, 1, store, selected, str(out_dir), device, codes)
        else:
            import torch.multiprocessing as mp
            mp.start_processes(_rank_main, args=(
                world, store, selected, str(out_dir), device, codes),
                nprocs=world, start_method="spawn")
        # A real exit code: 1 when any test failed on any rank.
        return max(int(Path(f"{codes}.{r}").read_text())
                   for r in range(world))


if __name__ == "__main__":
    sys.exit(main())
