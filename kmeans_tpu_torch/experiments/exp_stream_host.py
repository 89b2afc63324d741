"""Where the time of a streamed block goes, on the card.

    python -m kmeans_tpu_torch.experiments.exp_stream_host [n] [d] [k] [rows]

Writes n x d float32 rows (default the main shape of ``chip_smoke.py``:
2,097,152 x 128) as a ``.npy`` file under a temporary directory, then
times, per block of ``rows`` rows (default 262,144) read through a memory
map, each part of what ``KMeans.fit_stream`` does with it: the first read
of the mapped block (a float64 sum, page faults included), the non-finite
scan of ``data.io.resilient_blocks`` (``np.all(np.isfinite)``), the copy
into a pinned host slot (``parallel.sharding.BlockStager``), the copy to
the card, and the step (kernel 1 at k centroids, default 1024, with the
statistics copied back).  Two passes over the file; prints one JSON line
per pass with the mean ms per block of each part, then the card's name
and power limit.  Needs one CUDA device."""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def main(argv) -> None:
    n, d, k, rows = ([int(a) for a in argv] + [2_097_152, 128, 1024,
                                               262_144][len(argv):])
    from kmeans_tpu_torch.parallel import distributed as dist
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((n, d), generator=gen, device=dev)
    cents = x[:k].clone()
    step = dist.make_step_fn(chunk_size=rows, mode="kernel",
                             need_farthest=False, need_sse_pc=False)
    pinned = torch.empty((rows, d), pin_memory=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "rows.npy"
        np.save(path, x.cpu().numpy())
        for rep in range(2):
            arr = np.load(path, mmap_mode="r")
            parts = dict.fromkeys(("first_read", "nonfinite_scan",
                                   "pinned_copy", "to_card", "step"), 0.0)
            blocks = 0
            for lo in range(0, n, rows):
                block = arr[lo:lo + rows]
                m = block.shape[0]
                t0 = time.perf_counter()
                float(block.sum(dtype=np.float64))
                t1 = time.perf_counter()
                bool(np.all(np.isfinite(block)))
                t2 = time.perf_counter()
                np.copyto(pinned[:m].numpy(), block)
                t3 = time.perf_counter()
                points = pinned[:m].to(dev, non_blocking=True)
                torch.cuda.synchronize()
                t4 = time.perf_counter()
                st = step(points, torch.ones(m, device=dev), cents)
                torch.cat([st.sums.reshape(-1), st.counts,
                           st.sse.reshape(1)]).cpu()
                t5 = time.perf_counter()
                for key, a, b in (("first_read", t0, t1),
                                  ("nonfinite_scan", t1, t2),
                                  ("pinned_copy", t2, t3),
                                  ("to_card", t3, t4), ("step", t4, t5)):
                    parts[key] += b - a
                blocks += 1
            print(json.dumps({"pass": rep, "blocks": blocks, "rows": rows,
                              "ms_per_block": {key: v / blocks * 1e3
                                               for key, v in parts.items()},
                              "block_bytes": rows * d * 4}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
