"""Whether a cost capture's profiler session keeps the device activities as
the process ages, on the card.

    python -m kmeans_tpu_torch.experiments.exp_profiler_loss [rounds] [seconds]

Kernel 1 (``ops.hopper_kernels.fused_assign_reduce``) at the main shape of
``chip_smoke.py`` (2,097,152 x 128, k = 1024): its CUDA-event median over
10 calls, then one capture (``obs.cost.measure_call``) at the start and
one after each of ``rounds`` (default 4) windows of ``seconds`` (default
45) of kernel-1 traffic outside any session.  Prints one JSON line per
capture: the process's age, the device activities recorded, kernel 1's
profiled ms and its ratio to the CUDA-event median, then an empty session
opened right after (what it received); then the card's name and power
limit.  Needs one CUDA device."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch


def _event_median(fn, runs: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv) -> None:
    rounds, seconds = ([int(a) for a in argv] + [4, 45][len(argv):])
    from kmeans_tpu_torch.obs import cost
    from kmeans_tpu_torch.ops import hopper_kernels as hk
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((2_097_152, 128), generator=gen, device=dev)
    c = x[:1024].contiguous()
    w = torch.ones(x.shape[0], device=dev)

    def kernel1():
        return hk.fused_assign_reduce(x, w, c)
    event_ms = _event_median(kernel1)
    parts = ("fused_assign_reduce_kernel", "reduce_partials_kernel",
             "split_centroids_kernel", "shift_kernel")

    def capture(round_):
        _, rec = cost.measure_call(kernel1, cache="exp_profiler_loss",
                                   args=(x, w, c))
        profiled = sum(k["ms"] for k in rec.kernels or []
                       if k["name"].startswith(parts))
        _, empty = cost.measure_call(lambda: None, cache="drain",
                                     args=(x,))
        print(json.dumps({
            "round": round_, "age_s": time.perf_counter() - t_start,
            "activities": sum(k["launches"] for k in rec.kernels or []),
            "kernel1_recorded": any(k["name"] == parts[0]
                                    for k in rec.kernels or []),
            "kernel1_profiled_ms": profiled, "kernel1_event_ms": event_ms,
            "profiled_over_event": profiled / event_ms,
            "error": rec.error,
            "following_empty_session_activities": sum(
                k["launches"] for k in empty.kernels or [])}), flush=True)

    capture(0)
    for round_ in range(1, rounds + 1):
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(10):
                kernel1()
            torch.cuda.synchronize()
        capture(round_)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("exp_profiler_loss needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    main(sys.argv[1:])
