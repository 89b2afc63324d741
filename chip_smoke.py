#!/usr/bin/env python3
"""Smoke run of kmeans_tpu_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds the CUDA kernels from the sources in this checkout (and four
compile-time variants of the K-Means kernel for the variant lab, all with
one ``nvcc`` each, started together), holds each kernel against its plain
PyTorch version on the card, and drives five paths: ``KMeans.fit`` then
``predict``, ``save`` and ``load`` at n = 2,097,152, D = 128, k = 1024 in
float32; the same with ``distance_mode='pallas_bf16'`` (the bf16
tensor-core kernels) plus ``score``; ``KMeans.fit`` at a ragged GloVe-like
shape; ``GaussianMixture.fit`` (k = 256, 'diag', internal KMeans init) then
``predict``, ``predict_proba``, ``score_samples``, ``save`` and ``load`` at
n = 2,097,152, D = 128, on blobs about 1e3 from the origin; and the variant
lab (``kmeans_tpu_torch.experiments.exp_pallas_kernel``) at the main shape.
Then the device loop (``host_loop=False``, a replayed CUDA graph per
iteration) on the main data in float32 and bf16 against the host loop, a
converging fit at the GloVe-like shape across in-flight depths, and each
empty-cluster policy with forced empties; k-means++ with its draws on the
device against the per-draw host version; the mixture fit's set-up in its
parts; a float64 mixture on the card (the torch E-step) against the same fit
on the CPU, and ``load`` on the card of its CPU checkpoint; ``transform``
against float64 distances.  The launch counters show that each path went
through its own kernels (the device loop counts its graph's launches at
each replay).  Each kernel is timed beside its plain version, a library
yardstick and its roofline bound.  Then the mesh (``torch.distributed``):
two gloo ranks spawned on the one card fit the main data on a data axis
and on a model axis, in float32 and bf16, hold one step at the one-device
centroids against the plain scatter, draw process-local k-means++ rows and
fit the mixture on a data axis (phases ``dp_shared_card``, ``dp_kmeanspp``,
``dp_gmm``: correctness, not scaling); one NCCL rank in this process fits
the main data by both loops bit for bit against the one-device fits
(``dp_world1``); and ``python -m kmeans_tpu_torch.suite`` runs the original
project's tests A to E (``suite``).  Each rank counts its own launches.
Model selection: every K-Means kernel with sentinel rows mixed into its
table (``kernels_sentinels``); the guarded bf16 rung by both loops against
a float64 argmin, beside 'matmul' (``guarded``); ``n_init=4`` as one
device loop of four members in both kernel modes and 'matmul' against
four single fits (``multi_fit``); k-means|| seeding through kernel 2 and
2b, then those kernels against their plain versions at the seeding's own
tables (``kmeans_parallel``); and ``KMeans.sweep`` over k = 256, 512,
1024, batched against the sequential oracle, its winners scored by a
sampled silhouette and their tables held through kernels 1 and 2
(``sweep``).
The other K-Means families: kernels 1 and 2 (1b, 2b) at the shapes they
give them, k = 2 and k = 1 on the main rows, a gathered 65,536-row batch at
k = 1024, unit rows at the GloVe-like shape (``kernels_families``);
``SphericalKMeans`` on the GloVe-like data by both loops, bit for bit, and
in bf16 (``spherical``); ``BisectingKMeans(k=16)`` on the main data by both
loops, twice, and in bf16, the same tree every time (``bisecting``); and
``MiniBatchKMeans`` (k = 1024, batch 65,536) by the per-iteration engine
and the captured loop, bit for bit, with a profile of its iteration, by
host sampling, in bf16, and ``partial_fit`` (``minibatch``).
The rest of the mixture: the device EM loop (``host_loop=False``, one
replayed CUDA graph per EM iteration around ``diag_estep``) at the mixture
shape against the host loop, 'diag' and 'spherical' (``gmm_device``);
'full' and 'tied' at 1,048,576 x 64, k = 32, by both loops against a
float64 fit of the same data on the card, with the jitter ladder
(``gmm_full_tied``); ``n_init=4`` in one device loop against four single
fits, bit for bit (``gmm_multi_fit``); ``GaussianMixture.sweep`` over k =
64, 128, 256, batched against the sequential oracle (``gmm_sweep``); and
``diag_estep`` with inert components (``estep_inert``).  The mesh phases
add the device EM loop on one NCCL rank and 'full' on the data axis of the
two gloo ranks.
Fault tolerance: the main data fitted plain, with ``checkpoint_every=2``
and killed after iteration 4 then resumed from its file by a fresh model,
by both loops through kernel 1 and by the device loop through 1b, bit for
bit, with the launches and captures counted (``fault_tolerance``,
``fault_tolerance_bf16``); a resume from a torn file (``resume_torn``); an
injected out-of-memory error on a segment (``oom_injected``) and a real
one, 'matmul' at k = 16,384 with the whole data as one chunk
(``oom_real``); the rollback to the last checkpoint on divergence and the
stale-checkpoint rule, both loops (``divergence_rollback``); each family
killed and resumed at the size of its own phase (``fault_families``); and
a checkpointed device-loop fit on one NCCL rank (``dp_world1``).

Ingest and the massive k: ``data.synthetic.device_shards`` at the main
shape (blobs around 1024 centres) made on the card, its first 65,536 rows
bit for bit against ``host_equivalent``, then ``KMeans(k=1024)`` on it
through kernel 1 (``synthetic``); the main data at k = 16,384 by the
two-level route (128 coarse cells, 16 probes; the coarse quantizer trained
through kernel 1), by the dense kernel fit, and the collapse case (every
cell probed) against the dense 'matmul' fit, with each fit's peak
allocated bytes against ``obs.memory.plan_fit`` (``large_k``); the main
data's file read by ``from_npy`` on the one-rank NCCL mesh by 'mono' and
by 'slab', byte for byte, timed (``ingest``, in ``dp_world1``); and
``k_shard=2`` on a model axis of the two gloo ranks at k = 4096, bit for
bit against the dense model-axis fit (``dp_shared_card_kshard``).

The product quantizer and serving: ``ProductQuantizer(m=8, k=256)`` on the
main data, its seconds per iteration and peak bytes beside ``plan_``, every
member bit-equal to a standalone ``KMeans`` of its subspace, ``encode`` and
``decode`` of 262,144 rows, ``adc_assign`` of 4096 queries against a
``for_table`` compression of the main k = 1024 table equal to the decoded
table's argmin (``pq``); the main float32 model resident in a
``ServingEngine``, ``call`` at every bucket and with one 10,000-row request,
labels bit-equal to ``predict``, kernel 2 once per dispatch, ``score_rows``
and ``transform`` against their references, p50 / p99 per bucket, quality
monitoring on against off (``serving``); ``quantize='bf16'`` and the bf16
model through kernel 2b (``serving_bf16``); four models in one packed
dispatch (``serving_packed``); the mixture's three ops (``serving_gmm``);
``submit`` from four threads (``serving_queue``); and kernels 2 and 2b at
the bucket shapes beside their bounds and library calls
(``serving_kernel_shapes``).  Their launches go into the kernel rows'
``serving_launches``.

The serving fleet, serve-and-learn and heartbeats: ``ServingFleet(3)``
serving the main model (a replica killed with queued requests, then 2000
direct calls, 400 queued requests from four threads, a packed
``predict_multi``, ``score``: labels bit-equal to ``predict``, kernel 2
once per dispatch, routes equal to the requests admitted; an explicit shed
under ``max_inflight=1``; ``add_replica``; p50 / p99 beside one engine),
and a bf16 fleet (the guarded route and kernel 2b) (``fleet``,
``fleet_bf16``); a ``MiniBatchKMeans`` learning in place from drifted
traffic (the drift monitor fires the update, kernel 1 once per update
batch, the quiesced model bit-equal to its offline replay, injected
failure and regression, the p99 excursion against the committed bound,
two fleet replicas sharing the model) (``serve_learn``); and the main
``KMeans`` fitted under ``obs.heartbeat`` by both loops with checkpoints,
bit-equal to the fits without, then the straggler report over the fleet's
heartbeats (``heartbeat``).  Their launches go into the kernel rows'
``fleet_learn_launches``.

Observability (``obs``): the main fit in a fresh interpreter that finds
the kernel libraries built, by both loops, traced, its time to first
iteration from the spans alone beside the process's wall time from before
the import (``ttfi``); ``device_cost_report`` for the five families, then
the main fit by both loops and in 'matmul', and the mixture's device EM
loop, each under a cost collector (``torch.profiler`` kernels and device
ms, the aten and declared operations, the allocator's peak beside
``plan_fit``), bit-equal to the same fits without capture, the 'matmul'
flops within the committed band, kernel 1's profiled ms beside phase
``timing``'s (``cost``); the statistics pass's phase ladder in 'matmul' by
CUDA events beside kernel 1's whole step (``phase_ladder``); the spans of
the host loop, the segmented, killed and resumed device loop, an injected
out-of-memory replay, the stream and ``predict_stream``, each bit-equal to
the run untraced (``spans``); and one captured step's collective bytes
against ``obs.fleet.comm_bytes_model`` on one NCCL rank and on the two
gloo ranks (``comm``, agreeing on ``data2``).  Their launches go into the
kernel rows' ``observability_launches``.  The time to first iteration
(``ttfi``) runs by both loops with ``overlap`` 0 and 1, with the library
built and from an empty build directory (``nvcc`` inside the fit).

Warm start and determinism: three fresh interpreters, each with an empty
build directory (``KMEANS_TPU_TORCH_BUILD_DIR``): A fits the main data
with a store of built libraries (``utils.aot``) and checkpoints, killed at
iteration 2, shipping the library into ``<ckpt>.aot``; B, ``nvcc`` hidden,
resumes from the checkpoint and predicts, loading the shipped library
(``via='aot-load'``, no ``nvcc``), bit-equal to the uninterrupted fit; C
finds the artefact with a byte flipped, counts ``aot.fallback``, rebuilds
the same kernel by ``nvcc`` and gives the same labels (``warm_start``);
the main data cut to 2,000,000 rows with ``bucket='auto'`` (padded to
2,097,152, labels equal to ``bucket=0``), a second fit of 1,900,000 rows in
the same bucket under ``recompilation_sentinel``: nothing built, one graph
captured by the device loop (``bucket``); ``check_determinism(runs=3)``
for kernels 1 and 2 by both loops, 1b and 2b, 'matmul', ``diag_estep`` and
the mini-batch, the two-level route printed (``determinism``).  Their
launches go into the kernel rows' ``warm_start_launches``.

Every phase prints one JSON line as it ends.  A phase that fails raises, so
the run ends with a non-zero code and without the result line.  The last line
is ``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit; the line before that is the table of kernels.

Needs one CUDA device and ``nvcc``; there is no CPU mode.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this run needs "
          "an NVIDIA GPU", file=sys.stderr)
    sys.exit(1)

sys.path.insert(0, str(Path(__file__).resolve().parent))

from kmeans_tpu_torch import (BisectingKMeans, GaussianMixture,  # noqa: E402
                              KMeans, MiniBatchKMeans, ProductQuantizer,
                              SphericalKMeans)
from kmeans_tpu_torch.data.io import iter_npy_blocks  # noqa: E402
from kmeans_tpu_torch.data.synthetic import make_blobs_device  # noqa: E402
from kmeans_tpu_torch.experiments import exp_kernel_edits as kernel_edits  # noqa: E402,E501
from kmeans_tpu_torch.experiments import exp_pallas_kernel as lab  # noqa: E402
from kmeans_tpu_torch.models import init as seeding  # noqa: E402
from kmeans_tpu_torch.models.fault_tolerance import (  # noqa: E402
    NumericalDivergenceError)
from kmeans_tpu_torch.models.kmeans import _FORMAT_MODES  # noqa: E402
from kmeans_tpu_torch.models.pq import default_subspaces  # noqa: E402
from kmeans_tpu_torch.ops import _build  # noqa: E402
from kmeans_tpu_torch.ops import compare as cmp  # noqa: E402
from kmeans_tpu_torch.ops import estep_kernels as ek  # noqa: E402
from kmeans_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from kmeans_tpu_torch.parallel import distributed as dist  # noqa: E402
from kmeans_tpu_torch.parallel import gmm_step  # noqa: E402
from kmeans_tpu_torch.parallel import sharding  # noqa: E402
from kmeans_tpu_torch.parallel.gmm_step import make_gmm_step_fn  # noqa: E402,E501
from kmeans_tpu_torch.parallel.sharding import (EM_MAX_CHUNK,  # noqa: E402
                                                weighted_mean)
from kmeans_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from kmeans_tpu_torch.serving import (FleetOverloadError,  # noqa: E402
                                      ServingEngine, ServingFleet)
from kmeans_tpu_torch.utils import faults  # noqa: E402

DEV = torch.device("cuda", 0)

# The main shape, and a ragged second one (GloVe-like).
MAIN = dict(n=2_097_152, d=128, k=1024, iters=5)
SECOND = dict(n=400_000, d=100, k=3000, iters=3)
PREDICT_ROWS = 262_144
# The mixture path: the shape of the JAX package's own mixture record
# (docs/PERFORMANCE.md, "The mixture family"), blobs about 1e3 from the
# origin so that centering and moment precision are exercised (made by
# exp_kernel_edits.estep_inputs, which the E-step ablations time too).
GMM = dict(n=2_097_152, d=128, k=256, iters=5)
# The converging device-loop fit at the GloVe-like shape: its tolerance is
# the largest shift of iteration CONVERGE_AT of a probe fit (times 1.001),
# so that it converges within CONVERGE_MAX iterations; the in-flight depths
# it is run at.
CONVERGE_AT, CONVERGE_MAX = 20, 40
IN_FLIGHT_DEPTHS = (0, 1, 2, 3)
DEPTH_REPS = 5
# Forced empties, each policy: the first EMPTY_DUPS centroids of the init
# are one row, so all but the first start empty.
EMPTY = dict(n=65_536, d=32, k=64, iters=10)
EMPTY_DUPS = 6
# The float64 mixture (C.5): a small 'diag' fit on the card against the
# same fit on the CPU, in the float64 parity class.
GMM64 = dict(n=65_536, d=16, k=8, iters=10)
F64_RTOL, F64_ATOL = 1e-12, 1e-10
# The device loop's final SSE against the host loop's.
DEVICE_SSE_RTOL = 1e-5
# The rest of the mixture.  The device EM loop's lower bound (float32
# M-step on the card) against the host loop's (float64 M-step on the host):
# LL_RTOL of ops/compare.py.  'full' and 'tied' (the JAX package's recorded
# full-covariance shape, docs/PERFORMANCE.md): float32 fits against the
# float64 fit of the same data and starting means on the card, the lower
# bound to FULL_LL_RTOL, the centered means and the covariances to
# |a - b| <= FULL_ATOL_SHARE max|b| + FULL_RTOL |b|.  The restarts and the
# sweep at the mixture shape; the inert components of estep_inert.
GMM_DEVICE_LL_RTOL = cmp.LL_RTOL
FULL = dict(n=1_048_576, d=64, k=32, iters=10)
FULL_LL_RTOL = 1e-5
FULL_RTOL, FULL_ATOL_SHARE = 1e-3, 1e-3
GMM_RESTARTS = 4
GMM_SWEEP_KS = (64, 128, 256)
INERT = 64
# Model selection (phases guarded, multi_fit, kmeans_parallel, sweep) on the
# main data: rows whose guarded labels are held against a float64 argmin;
# the restarts of the batched device loop; the sweep's k and the rows of its
# sampled silhouette.
GUARD_ROWS = 65_536
MULTI_RESTARTS = 4
SWEEP_KS = (256, 512, 1024)
SWEEP_SILHOUETTE_ROWS = 16_384
# The sentinel case of the K-Means kernels: one sentinel row before every
# SENTINEL_EVERY real centroids; (n, D, k, offset of data and centroids).
SENTINEL_EVERY = 5
SENTINEL_SHAPES = ((4099, 100, 300, 0.0), (8192, 128, 1024, 0.0),
                   (4099, 128, 1024, 1e3))

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates).
PEAK_FP32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12         # TF32 tensor cores
PEAK_BF16_FLOPS = 989e12         # bf16 tensor cores
PEAK_BYTES_PER_S = 3.35e12       # HBM3

# The variant lab's phase: four variants at the main shape, T iterations.
LAB_ITERS = 5
LAB_SPECS = ("f32_default=128,128,p", "f32_k64=128,64,p",
             "bf16_default=128,128,pb", "bf16_n64=64,128,pb")

# Tolerances, kernel against plain version: those of
# kmeans_tpu_torch/ops/compare.py, which says why (the variant lab checks its
# builds with the same module):
#   labels  equal outside MARGIN_RTOL * (||x||^2 + max ||c||^2) on the
#           float64 difference of the two centroids' distances (bf16: of the
#           scores from the bf16-rounded inputs)
#   mind2   |a - b| <= max(1e-4, 1e-6 S) + 1e-4 |b|, S = max ||x||^2 +
#           max ||c||^2
#   sums    |a - b| <= 1e-5 max|b| + 1e-4 |b|
#   counts  |a - b| <= 1e-5 |b|, and equal where all weights are 0 or 1
# The bf16 kernels are held to their bf16 plain versions with the same
# tolerances.
MARGIN_RTOL = cmp.MARGIN_RTOL
# The SSE history of a bf16 fit may rise by this share between iterations:
# its SSE is derived from sums of bf16-rounded products (2^-9 relative per
# coordinate), and its assignments are approximate.
BF16_SSE_SLACK = 1e-3
# A bf16 fit's final SSE lies within this share of the float32 fit's.
BF16_SSE_RATIO = 0.01
# diag_estep against diag_estep_reference (both float32 on the card), with
# the tolerances of ops/compare.py (ESTEP_RTOL, ESTEP_ATOL_SHARE, LL_RTOL):
#   rsum, s1, s2  |a - b| <= 1e-5 max|b| + 1e-4 |b|  (centered sums cancel
#                 to near zero, hence the share of the largest entry)
#   ll            |a - b| <= 1e-5 |b|
#   and two runs of the kernel give the same bits.
# The hard-init tables (inv_var = 1e6) are held on the rows outside the tie
# band: x_c^2 a and 2 x_c b are of order 1e8 and cancel, so a row whose two
# nearest means' float64 squared distances differ by less than
# MARGIN_RTOL * (||x_c||^2 + max ||mu_c||^2) may go to either mean.
# far_clusters (clusters 100 apart, unit noise) is held by its variances
# S2/R - (S1/R)^2 against the float64 plain version: within this factor of
# the float32 plain version's own error there (measured in the same run).
FAR_VAR_FACTOR = 4.0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


CARD = ""          # name and power limit, set by main(): beside every time


def clocks() -> str:
    """The card's SM clock, power draw and temperature now (beside a
    timing: a card below its power limit runs slower under load)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """The last name of a mangled kernel (``_Z<len><name>`` or, inside a
    namespace, ``_ZN<len><ns><len><name>``), with ``<0>`` / ``<1>`` for its
    bool template arguments (``ILb0E`` / ``ILb1ELb0EE`` as ``<1,0>``)."""
    nested = mangled.startswith("_ZN")
    if not mangled.startswith("_Z"):
        return mangled
    pos, name = (3 if nested else 2), mangled
    while m := re.compile(r"\d+").match(mangled, pos):
        name = mangled[m.end():m.end() + int(m.group())]
        pos = m.end() + int(m.group())
        if not nested:
            break
    if mangled.startswith("I", pos):
        args = re.match(r"I((?:Lb[01]E)+)E", mangled[pos:])
        if args:
            name += "<" + ",".join(re.findall(r"Lb([01])E",
                                              args.group(1))) + ">"
    return name


def resource_usage(library: Path) -> list:
    """Registers, stack frame (where spills go), local memory and shared
    memory (with the 1 KiB the system reserves) of each kernel in a built
    library, from ``cuobjdump --dump-resource-usage``.  A kernel templated
    on its vector loads appears once for each."""
    text = subprocess.run(
        [str(Path(_build.find_nvcc()).parent / "cuobjdump"),
         "--dump-resource-usage", str(library)], capture_output=True,
        text=True, check=True).stdout
    out = []
    for mangled, fields in re.findall(r"Function (\S+):\s*\n\s*(.*)", text):
        usage = re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", fields)
        out.append({"kernel": kernel_name(mangled),
                    **{key.lower(): int(value) for key, value in usage}})
    check(bool(out), f"cuobjdump found no kernel in {library.name}")
    return out


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


# ----------------------------------------------------------------- comparing


label_band, close, max_err = cmp.label_band, cmp.close, cmp.max_err


def compare_case(name, x, w, c, *, with_mind2=True, unit_weights=False,
                 expect_label=None, bf16=False):
    """Both kernels (the bf16 ones with ``bf16``) on one set of inputs
    against their plain versions.  ``expect_label`` is (row, label) that
    both kernels must give.  Returns the case's record; raises on any
    disagreement."""
    out = hk.fused_assign_reduce(x, w, c, with_mind2=with_mind2, bf16=bf16)
    again = hk.fused_assign_reduce(x, w, c, with_mind2=with_mind2,
                                   bf16=bf16)
    la, ma = hk.hopper_assign(x, c, bf16=bf16)
    la2, ma2 = hk.hopper_assign(x, c, bf16=bf16)
    torch.cuda.synchronize()
    ref = hk.fused_assign_reduce_reference(x, w, c, with_mind2=with_mind2,
                                           bf16=bf16)
    lr, mr = hk.assign_reference(x, c, bf16=bf16)
    torch.cuda.synchronize()
    labels, mind2, sums, counts = out
    m_atol = cmp.mind2_atol(x, c)
    n_diff, n_outside = label_band(x, c, labels, ref[0], bf16)
    check(n_outside == 0, f"{name}: {n_outside} labels of kernel 1 differ "
                          f"from the plain version outside the margin band")
    n_diff2, n_outside2 = label_band(x, c, la, lr, bf16)
    check(n_outside2 == 0, f"{name}: {n_outside2} labels of kernel 2 differ "
                           f"from the plain version outside the margin band")
    check(torch.equal(la, labels), f"{name}: labels of the two kernels differ")
    same = labels == ref[0]
    rec = {"case": name, "n": x.shape[0], "d": x.shape[1], "k": c.shape[0],
           "bf16": bf16, "with_mind2": with_mind2, "label_diff": n_diff,
           "label_diff_in_band": n_diff - n_outside}
    if with_mind2:
        check(close(mind2[same], ref[1][same], cmp.MIND2_RTOL, m_atol),
              f"{name}: mind2 of kernel 1 disagrees")
        rec["mind2_err"] = max_err(mind2[same], ref[1][same])
    else:
        check(mind2 is None, f"{name}: with_mind2=False returned a mind2")
    same2 = la == lr
    check(close(ma[same2], mr[same2], cmp.MIND2_RTOL, m_atol),
          f"{name}: mind2 of kernel 2 disagrees")
    rec["assign_mind2_err"] = max_err(ma[same2], mr[same2])
    if n_diff == 0:
        ref_sums, ref_counts = ref[2], ref[3]
    else:
        # A row on a near-tie sits in another cluster: hold the scatter
        # against index_add_ over the kernel's own labels.
        ref_sums, ref_counts = cmp.scatter_reference(x, w, labels, c.shape[0],
                                                     bf16)
    check(cmp.sums_close(sums, ref_sums), f"{name}: sums disagree")
    rec["sums_err"] = max_err(sums, ref_sums)
    if unit_weights:
        check(torch.equal(counts, ref_counts), f"{name}: counts differ")
    else:
        check(close(counts, ref_counts, cmp.COUNTS_RTOL, 0.0),
              f"{name}: counts disagree")
    rec["counts_err"] = max_err(counts, ref_counts)
    bitwise = (torch.equal(labels, again[0])
               and sums.view(torch.int32).equal(again[2].view(torch.int32))
               and counts.view(torch.int32).equal(
                   again[3].view(torch.int32)))
    check(bitwise, f"{name}: two runs of kernel 1 are not bit-identical")
    check(torch.equal(la, la2) and ma.view(torch.int32).equal(
        ma2.view(torch.int32)), f"{name}: two runs of kernel 2 are not "
                                f"bit-identical")
    rec["bitwise_repeat"] = True
    if expect_label is not None:
        row, want = expect_label
        check(int(labels[row]) == want and int(la[row]) == want,
              f"{name}: row {row} got label {int(labels[row])}, not {want}")
    return rec


def random_case(n, d, k, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device=DEV)
    c = torch.randn((k, d), generator=gen, device=DEV)
    w = torch.rand((n,), generator=gen, device=DEV) + 0.5
    w[::10] = 0.0                      # a tenth of the rows at weight 0
    return x, w, c


def phase_kernels(x_main, c_main, x_second, bf16=False):
    """The ten cases, for the float32 kernels, or (``bf16``) eleven for
    the bf16 ones."""
    records = []
    shapes = [(4099, 100, 3000), (8192, 128, 1024), (1000, 7, 5),
              (257, 784, 10)]
    if bf16:
        # Rows too wide for the x tile and the ring together: the bf16
        # kernels walk the features in slices, over several centroid tiles
        # and a ragged last one.
        shapes.append((4099, 520, 300))
    for i, (n, d, k) in enumerate(shapes):
        x, w, c = random_case(n, d, k, seed=100 + i)
        records.append(compare_case(f"random_{n}x{d}_k{k}", x, w, c,
                                    bf16=bf16))
    x, w, c = random_case(4099, 100, 3000, seed=7)
    records.append(compare_case("no_mind2", x, w, c, with_mind2=False,
                                bf16=bf16))
    x, w, c = random_case(2000, 40, 300, seed=8)
    c[200] = c[17]                     # duplicate centroids, one of them far
    c[3] = c[17]                       # down the table: lowest index wins
    x[5] = c[17]
    w[5] = 1.0
    records.append(compare_case("duplicate_centroids", x, w, c,
                                expect_label=(5, 3), bf16=bf16))
    x, w, c = random_case(2000, 40, 300, seed=9)
    x[7, 20] = float("nan")            # a NaN row gets label 0
    w[7] = 0.0
    records.append(compare_case("nan_row", x, w, c, expect_label=(7, 0),
                                bf16=bf16))
    # One +Inf coordinate: every score is +-inf, none NaN, so the row gets a
    # real label, the plain version's: the lowest centroid whose coordinate
    # is positive (a split that made Inf - Inf = NaN would give label 0; a
    # label other than the plain version's has a NaN margin, which
    # label_band counts as outside the band).  The other features sit near
    # 1e3, where the float32 kernels shift their frame: the shift must keep
    # those signs.
    x, w, c = random_case(2000, 40, 300, seed=10)
    x += 1e3
    c += 1e3
    c[:, 5] -= 1e3                     # a column of both signs, ...
    c[:3, 5] = -c[:3, 5].abs()         # ... negative for the first three
    x[11, 5] = float("inf")
    w[11] = 1.0
    want = int((c[:, 5] > 0).nonzero()[0])
    records.append(compare_case("inf_coordinate", x, w, c,
                                expect_label=(11, want), bf16=bf16))
    w_main = torch.ones(x_main.shape[0], device=DEV)
    records.append(compare_case("main_shape", x_main, w_main, c_main,
                                unit_weights=True, bf16=bf16))
    # The second path's own shape: 3125 row tiles over the persistent
    # blocks, so each block walks many tiles with a ragged last centroid
    # tile and a ragged feature slice.
    x2, w2, c2 = x_second
    records.append(compare_case("glove_shape", x2, w2, c2, bf16=bf16))
    suffix = "_bf16" if bf16 else ""
    emit("kernels" + suffix, cases=records,
         kernels=[{"name": "fused_assign_reduce" + suffix, "ok": True},
                  {"name": "hopper_assign" + suffix, "ok": True}])
    return records


# ------------------------------------------------------- the mixture's kernel


def estep_tables(means_c, var, log_w):
    """E-step tables (inv_var, log_det, log_weights) of a diagonal mixture."""
    var = var.contiguous()
    return (1.0 / var).contiguous(), torch.log(var).sum(1).contiguous(), \
        log_w.contiguous()


def clear_of_ties(x, shift, means_c, block=65536):
    """Rows whose two nearest means are farther apart (float64) than the
    tie band of the hard-init tables."""
    mc = means_c.double()
    out = torch.empty(x.shape[0], dtype=torch.bool, device=x.device)
    for lo in range(0, x.shape[0], block):
        xc = x[lo:lo + block].double() - shift.double()
        d2 = torch.cdist(xc, mc) ** 2
        two = d2.topk(2, dim=1, largest=False).values
        scale = (xc * xc).sum(1) + (mc * mc).sum(1).max()
        out[lo:lo + block] = (two[:, 1] - two[:, 0]) > MARGIN_RTOL * scale
    return out


def estep_case(name, x, w, shift, means_c, inv_var, log_det, log_w):
    """diag_estep against its plain version on one set of inputs; raises on
    any disagreement.  Returns the case's record."""
    args = (x, w, shift, means_c, inv_var, log_det, log_w)
    out = ek.diag_estep(*args)
    again = ek.diag_estep(*args)
    torch.cuda.synchronize()
    ref = ek.diag_estep_reference(*args)
    torch.cuda.synchronize()
    errs = cmp.estep_errors(out, ref)
    check(errs.pop("ok"), f"{name}: an output is not finite or disagrees "
                          f"(ll {float(out[3])} against {float(ref[3])}; "
                          f"largest errors {errs})")
    rec = {"case": name, "n": x.shape[0], "d": x.shape[1],
           "k": means_c.shape[0], **errs, "ll": float(out[3])}
    check(abs(float(out[0].sum()) - float(w.sum()))
          <= 1e-4 * float(w.sum()), f"{name}: rsum does not add up to sum w")
    bitwise = all(a.view(torch.int32).equal(b.view(torch.int32))
                  for a, b in zip(out, again))
    check(bitwise, f"{name}: two runs of diag_estep are not bit-identical")
    rec["bitwise_repeat"] = True
    return rec


def gmm_case(n, d, k, seed, *, spread=3.0, offset=0.0, hard=False,
             spherical=False):
    """Blobs, weights (a tenth 0), their weighted mean and the tables of a
    mixture near them (or the hard-init tables)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    centers = torch.randn((k, d), generator=gen, device=DEV) * spread + offset
    y = torch.randint(0, k, (n,), generator=gen, device=DEV)
    x = (centers[y] + torch.randn((n, d), generator=gen, device=DEV)
         ).contiguous()
    w = torch.rand((n,), generator=gen, device=DEV) + 0.5
    w[::10] = 0.0                      # a tenth of the rows at weight 0
    shift = weighted_mean(x, w).contiguous()
    if hard:
        means_c = (centers - shift).contiguous()
        tables = (torch.full((k, d), 1e6, device=DEV),
                  torch.zeros(k, device=DEV), torch.zeros(k, device=DEV))
        w = torch.where(clear_of_ties(x, shift, means_c), w,
                        torch.zeros_like(w))
        return x, w, shift, means_c, *tables
    means_c = (centers - shift + 0.3 * torch.randn(
        (k, d), generator=gen, device=DEV)).contiguous()
    var = torch.rand((k, 1 if spherical else d), generator=gen,
                     device=DEV) + 0.5
    log_w = torch.log_softmax(torch.randn(k, generator=gen, device=DEV), 0)
    return (x, w, shift, means_c,
            *estep_tables(means_c, var.expand(k, d), log_w))


def with_bad_rows(x, w, *tables):
    """Rows holding NaN, +Inf or -Inf, all at weight 0 (the shift and
    tables come from the clean data)."""
    bad = torch.arange(7, x.shape[0], 997, device=DEV)
    x[bad[0::3], 3] = float("nan")
    x[bad[1::3]] = float("inf")
    x[bad[2::3], 10] = -float("inf")
    w[bad] = 0.0
    return (x, w, *tables)


def variances(rsum, s1, s2):
    """The M-step's diagonal variances S2/R - (S1/R)^2, in float64."""
    r = rsum.double()[:, None]
    return s2.double() / r - (s1.double() / r) ** 2


def far_case(name, x, w, shift, means_c, inv_var, log_det, log_w):
    """Clusters 100 apart with unit noise, where S2/R - (S1/R)^2 cancels:
    the variances from the kernel's moments against those of the float64
    plain version, within 4 times the error that the float32 plain version
    shows against the same float64 one."""
    args = (x, w, shift, means_c, inv_var, log_det, log_w)
    out = ek.diag_estep(*args)
    again = ek.diag_estep(*args)
    plain = ek.diag_estep_reference(*args)
    exact = ek.diag_estep_reference(*(a.double() for a in args))
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(a).all()) for a in out),
          f"{name}: an output is not finite")
    want = variances(*exact[:3])
    kernel_err = float((variances(*out[:3]) - want).abs().max())
    plain_err = float((variances(*plain[:3]) - want).abs().max())
    check(kernel_err <= FAR_VAR_FACTOR * plain_err,
          f"{name}: variance error {kernel_err}, more than "
          f"{FAR_VAR_FACTOR} x the float32 plain version's {plain_err}")
    check(all(a.view(torch.int32).equal(b.view(torch.int32))
              for a, b in zip(out, again)),
          f"{name}: two runs of diag_estep are not bit-identical")
    return {"case": name, "n": x.shape[0], "d": x.shape[1],
            "k": means_c.shape[0], "variance_err": kernel_err,
            "plain_float32_variance_err": plain_err,
            "variance_factor": FAR_VAR_FACTOR,
            "ll_err_float64": max_err(out[3], exact[3].float()),
            "bitwise_repeat": True}


def phase_estep_kernel(x_gmm, gmm_tables):
    records = [estep_case("gmm_main_shape", x_gmm,
                          torch.ones(x_gmm.shape[0], device=DEV),
                          *gmm_tables)]
    cases = [
        ("ragged_400000x100_k3000", dict(n=400_000, d=100, k=3000)),
        ("tiny_d7_k5", dict(n=1000, d=7, k=5)),
        ("tiny_many_tiles", dict(n=20_011, d=7, k=5)),
        ("hard_init_tables", dict(n=50_000, d=64, k=32, hard=True)),
        ("spherical", dict(n=30_000, d=40, k=70, spherical=True)),
        # test_gmm_tpu.py's offset clusters: N(0, 25) + 1e3
        ("offset_clusters", dict(n=50_000, d=64, k=32, spread=5.0,
                                 offset=1e3)),
        ("nan_rows_at_weight_0", dict(n=20_000, d=64, k=32)),
        # the last component tile of 128 full, and one past it; then the
        # kernel's own tile of 256 and one past it (one component
        # recomputed, the rest kept)
        ("k_128", dict(n=30_000, d=64, k=128)),
        ("k_129", dict(n=30_000, d=64, k=129)),
        ("k_257", dict(n=30_000, d=48, k=257)),
        # rows too wide to stay in shared memory: read where needed
        ("wide_d200", dict(n=20_000, d=200, k=40)),
    ]
    for i, (name, kw) in enumerate(cases):
        case = gmm_case(seed=300 + i, **kw)
        if name == "nan_rows_at_weight_0":
            case = with_bad_rows(*case)
        records.append(estep_case(name, *case))
    records.append(far_case("far_clusters", *gmm_case(
        n=50_000, d=64, k=32, seed=300 + len(cases), spread=100.0)))
    emit("estep_kernel", cases=records,
         kernels=[{"name": "diag_estep", "ok": True}])
    return records


# ------------------------------------------------------------ the mixture path


def phase_gmm(x_gmm):
    """GaussianMixture fit, predict, predict_proba, score_samples, save,
    load and predict again on the card, at full width."""
    gm = GaussianMixture(n_components=GMM["k"], init_params="kmeans",
                         max_iter=GMM["iters"], tol=0.0, seed=7)
    bounds_seen = []
    m_step = gm._m_step

    def record(st):                    # the lower bound of every E-step
        out = m_step(st)
        bounds_seen.append(float(st.loglik) / out[0])
        return out

    gm._m_step = record
    hk.reset_launch_counts()           # this path's own counts
    t0 = time.perf_counter()
    gm.fit(x_gmm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(gm.estep_path_ == "kernel", f"E-step path {gm.estep_path_}")
    check(gm.n_iter_ == GMM["iters"], f"{gm.n_iter_} EM iterations")
    em = bounds_seen[1:]               # the hard-init pass first
    check(len(em) == GMM["iters"] and all(np.isfinite(em)),
          f"lower bounds {bounds_seen}")
    check(all(b >= a - 1e-5 * abs(a) for a, b in zip(em, em[1:])),
          f"the lower bound decreases: {em}")
    cov = gm.covariances_
    check(cov.shape == (GMM["k"], GMM["d"]) and bool(np.isfinite(cov).all()),
          "covariances_ are not finite (k, D)")
    median = float(np.median(cov))
    check(0.5 < median < 2.0, f"median covariance {median}, blobs have 1")
    check(float(cov.min()) > 0.1, f"a covariance collapsed: {cov.min()}")
    check(abs(float(gm.weights_.sum()) - 1.0) < 1e-9, "weights_ sum")

    rows = x_gmm[:PREDICT_ROWS]
    labels = gm.predict(rows)
    proba = gm.predict_proba(rows)
    scores = gm.score_samples(rows)
    check(labels.shape == (PREDICT_ROWS,) and labels.dtype == np.int32
          and 0 <= labels.min() and labels.max() < GMM["k"],
          "predict: labels out of range")
    check(proba.shape == (PREDICT_ROWS, GMM["k"])
          and np.allclose(proba.sum(1), 1.0, atol=1e-4),
          "predict_proba: rows do not sum to 1")
    check(bool((proba.argmax(1) == labels).all()),
          "predict is not the argmax of predict_proba")
    check(scores.shape == (PREDICT_ROWS,) and bool(np.isfinite(scores).all()),
          "score_samples is not finite")
    # Labels against a float64 posterior on a slice, outside the band where
    # the two best log-densities are closer than float32 can tell.
    sub = rows[:4096].double()
    shift = torch.from_numpy(gm.shift_).to(DEV)
    mc = torch.from_numpy(gm.means_).to(DEV) - shift
    var = torch.from_numpy(np.maximum(cov, gm.reg_covar)).to(DEV)
    logp = (torch.log(torch.from_numpy(gm.weights_).to(DEV))
            - 0.5 * ((((sub - shift)[:, None, :] - mc[None]) ** 2
                      / var[None]).sum(-1) + torch.log(var).sum(1)
                     + GMM["d"] * math.log(2 * math.pi)))
    top = logp.topk(2, dim=1).values
    clear = ((top[:, 0] - top[:, 1]) > 1e-2).cpu().numpy()
    want = logp.argmax(1).cpu().numpy()
    check(bool((labels[:4096][clear] == want[clear]).all()),
          "predict disagrees with a float64 posterior")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "gmm.npz"
        gm.save(path)
        loaded = GaussianMixture.load(path)
        again = loaded.predict(rows)
    check(loaded.device.type == "cuda", "the loaded mixture is not on cuda")
    check(bool((again == labels).all()), "labels differ after save and load")
    launches = check_path_launches("gmm")
    check(launches["diag_estep"] == 1 + GMM["iters"],
          f"diag_estep launched {launches['diag_estep']} times, not 1 hard "
          f"init + {GMM['iters']} EM iterations")
    emit("gmm", n=GMM["n"], d=GMM["d"], k=GMM["k"], iterations=gm.n_iter_,
         lower_bounds=em, covariance_median=median,
         covariance_min=float(cov.min()), covariance_max=float(cov.max()),
         fit_seconds=fit_s,
         seconds_per_iteration=statistics.median(gm.iter_times_),
         predict_rows=PREDICT_ROWS, float64_label_rows=int(clear.sum()),
         save_load_same_labels=True)
    return gm, launches, fit_s


def phase_gmm_offset():
    """The check the JAX package pins on its own hardware
    (tests/test_gmm_tpu.py): clusters N(0, 25) + 1e3, means_init at the
    true centers; every covariance near the true 1, lower bound < 0."""
    rng = np.random.default_rng(0)
    k, d, n = 32, 64, 50_000
    centers = rng.normal(size=(k, d)) * 5 + 1e3
    y = rng.integers(0, k, size=n)
    X = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    gm = GaussianMixture(n_components=k, means_init=centers, max_iter=3,
                         tol=0.0, seed=1).fit(X)
    cov = gm.covariances_
    check(float(cov.min()) > 0.5 and float(cov.max()) < 2.0,
          f"offset clusters: covariances in [{cov.min()}, {cov.max()}]")
    check(gm.lower_bound_ < 0, f"offset clusters: lower bound "
                               f"{gm.lower_bound_} >= 0")
    emit("gmm_offset", k=k, d=d, n=n, covariance_min=float(cov.min()),
         covariance_max=float(cov.max()), lower_bound=gm.lower_bound_)


# ------------------------------------------------------------------ the path


#: The kernels that each path must launch at least once.
PATH_KERNELS = {
    "main": ("fused_assign_reduce", "hopper_assign"),
    "main_bf16": ("fused_assign_reduce_bf16", "hopper_assign_bf16"),
    "main_device": ("fused_assign_reduce", "hopper_assign"),
    "main_bf16_device": ("fused_assign_reduce_bf16", "hopper_assign_bf16"),
    "glove_like": ("fused_assign_reduce", "hopper_assign"),
    "gmm": ("diag_estep", "fused_assign_reduce"),
    "gmm_device": ("diag_estep", "fused_assign_reduce"),
    "gmm_spherical_device": ("diag_estep", "fused_assign_reduce"),
    "gmm_full_tied": ("fused_assign_reduce",),
    "gmm_multi_fit": ("diag_estep", "fused_assign_reduce"),
    "gmm_sweep": ("diag_estep", "fused_assign_reduce"),
    "lab": tuple(lab.parse_spec(spec).counter for spec in LAB_SPECS),
    "multi_fit": ("fused_assign_reduce", "hopper_assign"),
    "multi_fit_bf16": ("fused_assign_reduce_bf16", "hopper_assign_bf16"),
    "kmeans_parallel": ("hopper_assign",),
    "kmeans_parallel_bf16": ("hopper_assign_bf16",),
    "sweep": ("fused_assign_reduce",),
    "spherical": ("fused_assign_reduce", "hopper_assign"),
    "spherical_device": ("fused_assign_reduce", "hopper_assign"),
    "spherical_bf16_device": ("fused_assign_reduce_bf16",
                              "hopper_assign_bf16"),
    "bisecting": ("fused_assign_reduce", "hopper_assign"),
    "bisecting_device": ("fused_assign_reduce", "hopper_assign"),
    "bisecting_bf16": ("fused_assign_reduce_bf16", "hopper_assign_bf16"),
    "minibatch": ("fused_assign_reduce", "hopper_assign"),
    "minibatch_device": ("fused_assign_reduce", "hopper_assign"),
    "minibatch_host": ("fused_assign_reduce", "hopper_assign"),
    "minibatch_bf16_device": ("fused_assign_reduce_bf16",
                              "hopper_assign_bf16"),
    "fault_host": ("fused_assign_reduce",),
    "fault_device": ("fused_assign_reduce",),
    "fault_bf16_device": ("fused_assign_reduce_bf16",),
    "resume_torn": ("fused_assign_reduce",),
    "oom_injected": ("fused_assign_reduce",),
    "divergence_host": ("fused_assign_reduce",),
    "divergence_device": ("fused_assign_reduce",),
    "fault_spherical": ("fused_assign_reduce",),
    "fault_bisecting": ("fused_assign_reduce", "hopper_assign"),
    "fault_minibatch": ("fused_assign_reduce",),
    "fault_gmm_diag": ("diag_estep", "fused_assign_reduce"),
    "fault_gmm_full": ("fused_assign_reduce",),
    "bucket": ("fused_assign_reduce", "hopper_assign"),
    "bucket_device": ("fused_assign_reduce", "hopper_assign"),
}


def check_path_launches(path: str) -> dict:
    """Reads the counters just after a path: every kernel the path names
    must have launched; kernels of other paths are not its business."""
    launches = dict(hk.LAUNCHES)
    missing = [name for name in PATH_KERNELS[path]
               if launches.get(name, 0) <= 0]
    check(not missing, f"kernels of the {path} path never launched: "
                       f"{missing} (counts {launches})")
    emit("launches", path=path, **launches)
    return launches


def largest_rise(history) -> float:
    """The largest rise of the SSE history between iterations, as a share
    of the earlier value (0 where it never rises)."""
    return max([(b - a) / a for a, b in zip(history, history[1:])] + [0.0])


def fit_shape(x, shape, label, distance_mode="auto"):
    """One fit on the card.  'auto' must resolve to the float32 kernel;
    'pallas_bf16' runs the bf16 one and may let the SSE rise by
    BF16_SSE_SLACK."""
    bf16 = distance_mode == "pallas_bf16"
    suffix = "_bf16" if bf16 else ""
    km = KMeans(k=shape["k"], max_iter=shape["iters"], seed=42,
                compute_sse=True, init="forgy", verbose=False,
                distance_mode=distance_mode)
    hk.reset_launch_counts()           # this path's own counts
    t0 = time.perf_counter()
    km.fit(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = hk.LAUNCHES["fused_assign_reduce" + suffix]
    check(x.is_cuda and km.device.type == "cuda",
          f"{label}: the fit did not run on cuda")
    want = "kernel" + suffix
    check(km._mode() == want, f"{label}: mode {km._mode()}, not {want}")
    check(launched >= km.iterations_run >= 1,
          f"{label}: {launched} launches of kernel 1 for "
          f"{km.iterations_run} iterations")
    check(km.centroids.shape == (shape["k"], shape["d"])
          and bool(torch.isfinite(torch.from_numpy(km.centroids)).all()),
          f"{label}: centroids are not finite (k, D)")
    rise = largest_rise(km.sse_history)
    check(len(km.sse_history) == km.iterations_run
          and rise <= (BF16_SSE_SLACK if bf16 else 1e-6),
          f"{label}: SSE history rises: {km.sse_history}")
    check(km.labels_.shape == (shape["n"],)
          and 0 <= int(km.labels_.min())
          and int(km.labels_.max()) < shape["k"],
          f"{label}: labels_ out of range")
    emit("fit", shape=label, n=shape["n"], d=shape["d"], k=shape["k"],
         distance_mode=distance_mode, iterations=km.iterations_run,
         sse_history=km.sse_history, largest_sse_rise=rise,
         seconds_per_iteration=statistics.median(km.iter_times_),
         iter_times=km.iter_times_,
         fit_seconds=wall, kernel1_launches=launched,
         kernel2_launches=hk.LAUNCHES["hopper_assign" + suffix])
    return km, wall


def phase_predict(km, x):
    """predict on the card against the plain version, then save, load and
    predict again; for a bf16 model also ``score``."""
    bf16 = km._mode() == "kernel_bf16"
    name = "hopper_assign_bf16" if bf16 else "hopper_assign"
    rows = x[:PREDICT_ROWS]
    before = hk.LAUNCHES[name]
    labels = km.predict(rows)
    launched = hk.LAUNCHES[name] - before
    check(launched == 1, f"predict launched kernel 2 {launched} times")
    cents = torch.from_numpy(km.centroids).to(DEV)
    ref, _ = hk.assign_reference(rows, cents, bf16=bf16)
    got = torch.from_numpy(labels).to(DEV)
    n_diff, n_outside = label_band(rows, cents, got, ref, bf16)
    check(n_outside == 0, f"predict: {n_outside} labels outside the band")
    fields = {}
    if bf16:
        before = hk.LAUNCHES["fused_assign_reduce_bf16"]
        fields["score"] = km.score(rows)
        check(hk.LAUNCHES["fused_assign_reduce_bf16"] == before + 1
              and math.isfinite(fields["score"]) and fields["score"] <= 0,
              f"score: {fields['score']}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "model.npz"
        km.save(path)
        with np.load(path) as z:
            saved_mode = json.loads(str(z["__meta__"]))["distance_mode"]
        loaded = KMeans.load(path)
        again = loaded.predict(rows)
    want = _FORMAT_MODES.get(km.distance_mode, km.distance_mode)
    check(saved_mode == want, f"the file names distance_mode={saved_mode!r}")
    check(loaded.distance_mode == km.distance_mode,
          f"loaded back as {loaded.distance_mode!r}")
    check(loaded.device.type == "cuda", "the loaded model is not on cuda")
    check(bool((again == labels).all()), "labels differ after save and load")
    emit("predict", mode=km._mode(), rows=PREDICT_ROWS, label_diff=n_diff,
         label_diff_in_band=n_diff - n_outside, kernel2_launches=launched,
         saved_distance_mode=saved_mode, save_load_same_labels=True,
         **fields)


# -------------------------------------------------------------- device loop


def phase_device_loop(x, host_models):
    """The main data through the device loop (``host_loop=False``) in
    float32 and bf16, against the host-loop fits of the same data and init:
    equal iterations, final SSE within DEVICE_SSE_RTOL, the largest centroid
    difference, and kernel 1's launches (counted at each graph replay) equal
    to the iterations.  Each fit runs twice on one cached dataset: the first
    captures the graph, the second only replays it.  Seconds per iteration
    are the device loop's own (``iter_times_``: its wall time over its
    iterations, without the init and ``labels_``), beside the host loop's
    median iteration; ``fit_seconds`` are the whole ``fit`` of each."""
    out, models = {}, {}
    for label, mode in (("main_device", "auto"),
                        ("main_bf16_device", "pallas_bf16")):
        host, host_wall = host_models[label[:-len("_device")]]
        suffix = "_bf16" if mode == "pallas_bf16" else ""
        km = KMeans(k=MAIN["k"], max_iter=MAIN["iters"], seed=42,
                    compute_sse=True, init="forgy", verbose=False,
                    distance_mode=mode, host_loop=False)
        ds = km.cache(x)
        walls, per_iteration = [], []
        for run in range(2):
            hk.reset_launch_counts()       # this path's own counts
            t0 = time.perf_counter()
            km.fit(ds)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_iteration.append(km.iter_times_[0])
            if run == 0:
                launches = check_path_launches(label)
        n = km.iterations_run
        check(km.loop_path_ == "device", f"{label}: loop {km.loop_path_}")
        check(launches["fused_assign_reduce" + suffix] == n,
              f"{label}: {launches['fused_assign_reduce' + suffix]} "
              f"launches of kernel 1 reached the card for {n} iterations")
        check(n == host.iterations_run,
              f"{label}: {n} iterations, the host loop {host.iterations_run}")
        rel = abs(km.sse_history[-1] - host.sse_history[-1]) / \
            host.sse_history[-1]
        check(rel <= DEVICE_SSE_RTOL, f"{label}: final SSE "
              f"{km.sse_history[-1]} against the host loop's "
              f"{host.sse_history[-1]}")
        diff = float(np.abs(km.centroids.astype(np.float64)
                            - host.centroids.astype(np.float64)).max())
        emit("device_loop", path=label, distance_mode=mode, iterations=n,
             sse_history=km.sse_history, host_sse_history=host.sse_history,
             final_sse_rel_diff=rel, max_centroid_diff=diff,
             kernel1_launches=launches["fused_assign_reduce" + suffix],
             kernel2_launches=launches["hopper_assign" + suffix],
             seconds_per_iteration_device_first_fit=per_iteration[0],
             seconds_per_iteration_device=per_iteration[1],
             seconds_per_iteration_host=statistics.median(host.iter_times_),
             fit_seconds_device=walls, fit_seconds_host=host_wall)
        out[label] = per_iteration[1]
        models[label] = km
    return out, models


def phase_device_converge(x):
    """A converging fit at the GloVe-like shape: the host loop and the
    device loop take the same number of iterations; at every in-flight
    depth the device loop gives the same bits as at depth 0 (the iterations
    queued past convergence are masked), with its wall time per iteration
    (median of DEPTH_REPS runs, the depths in turns) and the iterations run
    in vain."""
    kw = dict(k=SECOND["k"], max_iter=CONVERGE_MAX, seed=42,
              compute_sse=True, init="forgy", verbose=False)
    km = KMeans(host_loop=False, **kw)       # for its dataset and init
    ds = km.cache(x)
    c0 = torch.from_numpy(km._init_centroids(ds, 42)).to(DEV)
    chunk, mode = km._chunk_for(ds), km._mode()
    probe = dist.make_fit_fn(chunk_size=chunk, mode=mode,
                             max_iter=CONVERGE_MAX, tolerance=0.0,
                             empty_policy="resample")(ds, c0, 42)
    tol = float(probe.shift_history[CONVERGE_AT - 1]) * 1.001
    host = KMeans(tolerance=tol, host_loop=True, **kw).fit(ds)
    dev = KMeans(tolerance=tol, host_loop=False, **kw).fit(ds)
    check(dev.iterations_run == host.iterations_run < CONVERGE_MAX,
          f"converging fit: device {dev.iterations_run}, host "
          f"{host.iterations_run} iterations (cap {CONVERGE_MAX})")
    first = None
    walls = {depth: [] for depth in IN_FLIGHT_DEPTHS}
    launched = {}
    for _ in range(DEPTH_REPS):
        for depth in IN_FLIGHT_DEPTHS:
            fit_fn = dist.make_fit_fn(chunk_size=chunk, mode=mode,
                                      max_iter=CONVERGE_MAX, tolerance=tol,
                                      empty_policy="resample",
                                      in_flight=depth)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fit_fn(ds, c0, 42)
            walls[depth].append((time.perf_counter() - t0) / res.n_iters)
            check(res.n_iters == host.iterations_run and res.finite,
                  f"in flight {depth}: {res.n_iters} iterations")
            cents = res.centroids.cpu().numpy()
            if first is None:
                first = cents
            check(np.array_equal(cents, first), f"in flight {depth}: the "
                  f"masked iterations changed the state")
            launched[depth] = res.launched
    depths = [{"in_flight": depth, "launched": launched[depth],
               "masked_in_vain": launched[depth] - host.iterations_run,
               "seconds_per_iteration": statistics.median(walls[depth]),
               "runs": walls[depth]} for depth in IN_FLIGHT_DEPTHS]
    check(np.array_equal(first, dev.centroids),
          "the model's device fit differs from make_fit_fn's")
    emit("device_loop_converge", n=SECOND["n"], d=SECOND["d"],
         k=SECOND["k"], tolerance=tol, iterations=dev.iterations_run,
         host_iterations=host.iterations_run,
         host_seconds_per_iteration=statistics.median(host.iter_times_),
         max_centroid_diff_host=float(np.abs(
             dev.centroids.astype(np.float64)
             - host.centroids.astype(np.float64)).max()),
         depths=depths)


def phase_empty_policies():
    """Each empty-cluster policy with forced empties on a dataset without a
    host copy: the device loop's trajectory equals the host loop's (the
    same centroids, bit for bit, and the same SSE history).  The kernel
    mode for each policy, then the torch modes, whose graph captures
    cuBLAS products and the chunk loop: float64 (where 'auto' is
    'matmul'), and 'matmul_bf16' with the pipelined schedule."""
    x, _ = make_blobs_device(EMPTY["n"], 16, EMPTY["d"], device=DEV, seed=31)
    w = torch.ones(EMPTY["n"], device=DEV)
    w[::7] = 0.0                       # zero-weight rows are never drawn
    rows = [0] * EMPTY_DUPS + list(range(1, EMPTY["k"] - EMPTY_DUPS + 1))
    init = x[rows].cpu().numpy()
    records = []
    cases = [(policy, {}) for policy in ("keep", "farthest", "resample")]
    cases += [("resample", {"dtype": np.float64}),
              ("farthest", {"distance_mode": "matmul_bf16",
                            "pipeline": 1, "chunk_size": 8192})]
    for policy, extra in cases:
        kw = dict(k=EMPTY["k"], max_iter=EMPTY["iters"], init=init,
                  compute_sse=True, verbose=False, empty_cluster=policy,
                  **extra)
        host = KMeans(host_loop=True, **kw).fit(x, sample_weight=w)
        dev = KMeans(host_loop=False, **kw).fit(x, sample_weight=w)
        same = (dev.iterations_run == host.iterations_run
                and np.array_equal(dev.centroids, host.centroids)
                and dev.sse_history == host.sse_history)
        check(same, f"empty policy {policy} {extra}: the device loop's "
                    f"trajectory differs from the host loop's")
        records.append({"policy": policy, "mode": dev._mode(),
                        "dtype": str(dev.dtype),
                        "estep_path": dev.estep_path_,
                        "iterations": dev.iterations_run,
                        "final_sse": dev.sse_history[-1],
                        "identical": same})
    emit("device_loop_empty", n=EMPTY["n"], d=EMPTY["d"], k=EMPTY["k"],
         forced_empty=EMPTY_DUPS - 1, cases=records)


# ---------------------------------------------------------------- seeding


def cdf_gap(points, w, drawn, i, u):
    """Where the device and host draws first differ: the float64 CDF of the
    D^2 masses at draw ``i`` around the uniform ``u``."""
    mind2 = torch.full((points.shape[0],), float("inf"), device=DEV)
    for j in drawn[:i]:
        mind2 = torch.minimum(mind2, ((points - points[int(j)]) ** 2).sum(1))
    cdf = seeding._cdf(w.double() * mind2.double().clamp_min(0))
    at = int(torch.searchsorted(cdf, torch.tensor([u], device=DEV,
                                                  dtype=torch.float64))[0])
    lo, hi = max(at - 1, 0), min(at + 1, cdf.numel() - 1)
    return {"draw": i, "u": u, "cdf_around": cdf[lo:hi + 1].tolist(),
            "gap": float((cdf[lo:hi + 1] - u).abs().min())}


def phase_seeding(x_main, x_gmm):
    """k-means++ on the main data (k = 1024) and the mixture data
    (k = 256): the draws on the device against the per-draw host version
    on the same tensor, seconds of each, and the chosen rows."""
    records, drawn = [], {}
    for name, x, k in (("main", x_main, MAIN["k"]), ("gmm", x_gmm, GMM["k"])):
        w = torch.ones(x.shape[0], device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = seeding._kmeanspp_device_draws(
            x, w, k, np.random.default_rng(7)).cpu().numpy()
        device_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = seeding._kmeanspp_host_draws(
            None, np.ones(x.shape[0]), k, np.random.default_rng(7), points=x)
        host_s = time.perf_counter() - t0
        equal = int((got == want).sum())
        rec = {"data": name, "n": x.shape[0], "d": x.shape[1], "k": k,
               "device_seconds": device_s, "host_seconds": host_s,
               "equal_rows": equal}
        if equal < k:
            i = int(np.flatnonzero(got != want)[0])
            u = float(np.random.default_rng(7).random(k)[i])
            rec["first_difference"] = {"device_row": int(got[i]),
                                       "host_row": int(want[i]),
                                       **cdf_gap(x, w, want, i, u)}
        records.append(rec)
        drawn[name] = got
        emit("seeding", **rec)
        check(equal == k, f"seeding {name}: {equal} of {k} rows equal")
    return records, drawn


def phase_gmm_setup(x, gm, fit_seconds):
    """GaussianMixture.fit at the mixture shape in its parts, each timed on
    its own with the fit's own arguments: the dataset and its shift, the
    k-means++ seeding, the internal KMeans from those seeds, the
    hard-assignment init pass with its M-step; EM is the fit's own
    iterations (``iter_times_`` of the fit of phase ``gmm``)."""
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t0
        return result

    model = GaussianMixture(n_components=GMM["k"], init_params="kmeans",
                            max_iter=GMM["iters"], tol=0.0, seed=7)
    ds = timed("upload", lambda: model._dataset(x))
    model.shift_ = timed("shift", lambda: weighted_mean(
        ds.points, ds.weights).to(torch.float64).cpu().numpy())
    seeds = timed("seeding", lambda: seeding.kmeanspp_init(ds, GMM["k"], 7))
    km = timed("internal_kmeans", lambda: KMeans(
        k=GMM["k"], seed=7, init=seeds, max_iter=20, verbose=False,
        compute_labels=False, empty_cluster="resample").fit(ds))
    step = make_gmm_step_fn(chunk_size=model._chunk(ds),
                            mode=model._mode())
    means = np.asarray(km.centroids, np.float64)
    timed("hard_init", lambda: model._m_step(model._host(step(
        ds.points, ds.weights, *model._hard_tables(means, model.shift_)))))
    parts["em"] = float(sum(gm.iter_times_))
    emit("gmm_setup", n=GMM["n"], d=GMM["d"], k=GMM["k"],
         fit_seconds_of_phase_gmm=fit_seconds, parts_seconds=parts,
         parts_total=sum(parts.values()))


def phase_gmm_float64():
    """C.5: a float64 'diag' mixture on the card runs the torch E-step
    ('serial', no diag_estep launch) and matches the same fit on the CPU in
    the float64 parity class; a float64 checkpoint written on the CPU loads
    on the card and predicts the same labels."""
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(GMM64["k"], GMM64["d"])) * 4.0
    y = rng.integers(0, GMM64["k"], size=GMM64["n"])
    X = centers[y] + rng.normal(size=(GMM64["n"], GMM64["d"]))
    kw = dict(n_components=GMM64["k"], covariance_type="diag",
              max_iter=GMM64["iters"], tol=0.0, seed=1, dtype=np.float64)
    hk.reset_launch_counts()
    card = GaussianMixture(**kw).fit(X)
    check(card.estep_path_ == "serial", f"float64 E-step path "
                                        f"{card.estep_path_}")
    check(hk.LAUNCHES["diag_estep"] == 0, "a float64 mixture launched "
                                          "diag_estep")
    cpu = GaussianMixture(device="cpu", **kw).fit(X)
    errs = {}
    for name in ("weights_", "means_", "covariances_"):
        a, b = getattr(card, name), getattr(cpu, name)
        errs[name] = float(np.abs(a - b).max())
        check(np.allclose(a, b, rtol=F64_RTOL, atol=F64_ATOL),
              f"float64 mixture: {name} of the card and the CPU differ by "
              f"{errs[name]}")
    check(card.n_iter_ == cpu.n_iter_, "float64 mixture: EM iterations")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "gmm64.npz"
        cpu.save(path)
        loaded = GaussianMixture.load(path)
    check(loaded.device.type == "cuda" and loaded.dtype == np.float64,
          "the float64 checkpoint did not load on the card")
    same = bool((loaded.predict(X) == cpu.predict(X)).all())
    check(same, "the float64 checkpoint predicts other labels on the card")
    emit("gmm_float64", n=GMM64["n"], d=GMM64["d"], k=GMM64["k"],
         estep_path=card.estep_path_, diag_estep_launches=0,
         iterations=card.n_iter_, lower_bound=card.lower_bound_,
         max_diff_against_cpu=errs, rtol=F64_RTOL, atol=F64_ATOL,
         loaded_on_card_same_labels=same)


# ------------------------------------------------- the rest of the mixture


def em_loops(ds):
    """The device EM loops kept with a dataset."""
    return [v for v in ds._memo.values() if isinstance(v, gmm_step._EmLoop)]


def timed_fit(model, data):
    """One fit with the counters set to 0 just before it: ``(seconds,
    launches)``."""
    hk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(data)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(hk.LAUNCHES)


def phase_gmm_device(x_gmm, gm):
    """The device EM loop (``host_loop=False``) at the mixture shape: one
    captured CUDA graph per EM iteration around ``diag_estep``, fitted
    twice on one cached dataset (capture, then replay), beside the host
    loop of phase ``gmm`` ('diag') and a host-loop 'spherical' fit: the
    same iteration count, the lower bound within GMM_DEVICE_LL_RTOL, the
    two device fits bit-equal, ``diag_estep`` launched once by the
    hard-assignment init and once per EM iteration (the graph records one
    launch, counted at each replay).  The replayed iteration is timed by
    replaying the graph of the finished loop (its state masked)."""
    out = {}
    for ct in ("diag", "spherical"):
        path = "gmm_device" if ct == "diag" else "gmm_spherical_device"
        kw = dict(n_components=GMM["k"], covariance_type=ct,
                  init_params="kmeans", max_iter=GMM["iters"], tol=0.0,
                  seed=7)
        host = gm if ct == "diag" else GaussianMixture(**kw).fit(x_gmm)
        dev = GaussianMixture(host_loop=False, **kw)
        ds = dev._dataset(x_gmm)
        fits = []
        for run in range(2):               # capture, then replay
            seconds, launches = timed_fit(dev, ds)
            fits.append(dict(seconds=seconds, launches=launches,
                             per_iteration=dev.iter_times_[0],
                             lower_bound=dev.lower_bound_,
                             means=dev.means_.copy(),
                             covariances=dev.covariances_.copy()))
        check_path_launches(path)
        loops = em_loops(ds)
        check(len(loops) == 1 and loops[0].graph is not None,
              f"{path}: no captured EM iteration")
        check(loops[0].graph_launches == {"diag_estep": 1},
              f"{path}: the graph recorded {loops[0].graph_launches}")
        n = dev.n_iter_
        check(dev.estep_path_ == "kernel" and dev.loop_path_ == "device",
              f"{path}: {dev.estep_path_}, {dev.loop_path_}")
        check(n == host.n_iter_ == GMM["iters"],
              f"{path}: {n} iterations, host loop {host.n_iter_}")
        rel = abs(dev.lower_bound_ - host.lower_bound_) \
            / abs(host.lower_bound_)
        check(rel <= GMM_DEVICE_LL_RTOL, f"{path}: lower bound "
                                         f"{dev.lower_bound_} against the "
                                         f"host loop's {host.lower_bound_}")
        same = all(np.array_equal(fits[0][f], fits[1][f])
                   for f in ("lower_bound", "means", "covariances"))
        check(same, f"{path}: capture and replay fits differ")
        k_launches = fits[1]["launches"]["diag_estep"]
        check(k_launches == 1 + n, f"{path}: diag_estep launched "
                                   f"{k_launches} times, not 1 + {n}")
        replay_ms = median_ms(lambda: loops[0].graph.replay())
        out[path] = fits[1]["launches"]
        emit("gmm_device", path=path, covariance_type=ct, n=GMM["n"],
             d=GMM["d"], k=GMM["k"], iterations=n,
             lower_bound=dev.lower_bound_,
             host_lower_bound=host.lower_bound_, lower_bound_rel_diff=rel,
             lower_bound_rtol=GMM_DEVICE_LL_RTOL,
             max_mean_diff=float(np.abs(dev.means_ - host.means_).max()),
             max_covariance_diff=float(np.abs(
                 dev.covariances_ - host.covariances_).max()),
             capture_replay_bit_equal=same,
             diag_estep_launches=k_launches,
             loop_diag_estep_launches=k_launches - 1,
             fit_seconds=[f["seconds"] for f in fits],
             seconds_per_iteration_capture=fits[0]["per_iteration"],
             seconds_per_iteration_replay=fits[1]["per_iteration"],
             seconds_per_iteration_host=statistics.median(host.iter_times_),
             replayed_iteration_ms=replay_ms)
        if ct == "diag":
            ref = dev
    return ref, out


def full_data():
    """'full' and 'tied' data on the card: FULL["k"] clusters about 50 from
    the origin, each with its own correlated noise ``z A_c``, made from a
    seeded generator (the same rows in every process on the card)."""
    n, d, k = FULL["n"], FULL["d"], FULL["k"]
    gen = torch.Generator(device=DEV).manual_seed(31)
    centers = torch.randn((k, d), generator=gen, device=DEV) * 4.0 + 50.0
    mix = torch.randn((k, d, d), generator=gen, device=DEV) * 0.1 \
        + torch.eye(d, device=DEV)
    y = torch.randint(0, k, (n,), generator=gen, device=DEV)
    x = torch.randn((n, d), generator=gen, device=DEV)
    for c in range(k):
        rows = (y == c).nonzero().flatten()
        x[rows] = centers[c] + x[rows] @ mix[c]
    return x.contiguous()


def param_close(a, b) -> bool:
    """|a - b| <= FULL_ATOL_SHARE max|b| + FULL_RTOL |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool(np.all(np.abs(a - b) <= FULL_ATOL_SHARE * np.abs(b).max()
                       + FULL_RTOL * np.abs(b)))


def jitter_case(x, ct, means0):
    """A 'full' / 'tied' host-loop fit whose starting covariance is just
    past positive definite (one eigenvalue at -reg_covar / 2): the jitter
    ladder must rescue it."""
    k, d = FULL["k"], FULL["d"]
    bad = np.eye(d)
    bad[0, 0] = -2.0 / 1e-6                  # covariance -reg_covar / 2
    prec = bad if ct == "tied" else np.broadcast_to(np.eye(d),
                                                    (k, d, d)).copy()
    if ct == "full":
        prec[1] = bad
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gm = GaussianMixture(n_components=k, covariance_type=ct,
                             max_iter=2, tol=0.0, means_init=means0,
                             weights_init=np.full(k, 1.0 / k),
                             precisions_init=prec, seed=7).fit(x)
    check(gm.cov_jitter_retries_ > 0 and np.isfinite(gm.lower_bound_),
          f"{ct}: the jitter ladder did not rescue the covariance "
          f"(retries {gm.cov_jitter_retries_})")
    check(any("jitter ladder" in str(w.message) for w in caught),
          f"{ct}: no jitter ladder warning")
    return gm.cov_jitter_retries_


def phase_gmm_full_tied():
    """'full' and 'tied' at FULL (float32), 10 EM iterations, starting from
    the means of a KMeans fit through kernel 1 (the mixture's 'kmeans'
    seeding): the host loop, and the device loop fitted twice on one
    cached dataset (capture, then replay; 'full' and 'tied' factor their
    covariances inside the captured iteration with cholesky_ex), each held
    to a float64 host-loop fit of the same data and starting means on the
    card: the lower bound to FULL_LL_RTOL, the centered means and the
    covariances by param_close.  TF32 stays off (every float32 product a
    full float32 product, checked before the fits).  Then the jitter ladder
    on 65,536 rows.  Returns the one-device float32 'full' fit (the mesh
    phase's reference), its starting means and the path's launches."""
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the tied and full products must be full float32")
    x = full_data()
    k = FULL["k"]
    hk.reset_launch_counts()               # this path's own counts
    seed_km = KMeans(k=k, init="k-means++", seed=7, max_iter=20,
                     verbose=False, compute_labels=False).fit(x)
    means0 = np.asarray(seed_km.centroids, np.float64)
    launches = check_path_launches("gmm_full_tied")
    x64 = x.double()
    refs = {}
    for ct in ("full", "tied"):
        kw = dict(n_components=k, covariance_type=ct, max_iter=FULL["iters"],
                  tol=0.0, means_init=means0, seed=7)
        t0 = time.perf_counter()
        ref = GaussianMixture(dtype=np.float64, **kw).fit(x64)
        ref_s = time.perf_counter() - t0
        host = GaussianMixture(**kw)
        host_s, _ = timed_fit(host, x)
        dev = GaussianMixture(host_loop=False, **kw)
        ds = dev._dataset(x)
        dev_runs = [timed_fit(dev, ds) + (dev.iter_times_[0],)
                    for _ in range(2)]
        loops = em_loops(ds)
        check(len(loops) == 1 and loops[0].graph is not None,
              f"{ct}: the device loop's iteration was not captured")
        rec = {}
        for name, m in (("host", host), ("device", dev)):
            check(m.n_iter_ == ref.n_iter_ == FULL["iters"],
                  f"{ct} {name}: {m.n_iter_} iterations")
            rel = abs(m.lower_bound_ - ref.lower_bound_) \
                / abs(ref.lower_bound_)
            means_ok = param_close(m.means_ - m.shift_,
                                   ref.means_ - ref.shift_)
            cov_ok = param_close(m.covariances_, ref.covariances_)
            rec[name] = dict(
                lower_bound=m.lower_bound_, lower_bound_rel_diff=rel,
                max_mean_diff=float(np.abs(m.means_ - ref.means_).max()),
                max_covariance_diff=float(np.abs(
                    m.covariances_ - ref.covariances_).max()),
                within=bool(rel <= FULL_LL_RTOL and means_ok and cov_ok))
            check(rec[name]["within"], f"{ct} {name} loop against float64: "
                                       f"{rec[name]}")
        ds_h = host._dataset(x)
        step = host._step_fn(ds_h, "torch", 0)
        tables = host._params_dev()
        estep_ms = median_ms(lambda: step(ds_h.points, ds_h.weights,
                                          *tables), runs=5, warmup=1)
        replay_ms = median_ms(lambda: loops[0].graph.replay(), runs=5,
                              warmup=1)
        retries = jitter_case(x[:65_536], ct, means0)
        emit("gmm_full_tied", covariance_type=ct, n=FULL["n"], d=FULL["d"],
             k=k, iterations=FULL["iters"], float64_lower_bound=
             ref.lower_bound_, against_float64=rec,
             tolerances={"lower_bound_rtol": FULL_LL_RTOL,
                         "rtol": FULL_RTOL, "atol_share": FULL_ATOL_SHARE},
             tf32=bool(torch.backends.cuda.matmul.allow_tf32),
             chunk_rows=host._chunk(ds_h), estep_ms=estep_ms,
             replayed_iteration_ms=replay_ms,
             seconds_per_iteration_host=statistics.median(host.iter_times_),
             seconds_per_iteration_device_capture=dev_runs[0][2],
             seconds_per_iteration_device_replay=dev_runs[1][2],
             fit_seconds={"float64_host": ref_s, "host": host_s,
                          "device": [r[0] for r in dev_runs]},
             jitter_retries=retries)
        if ct == "full":
            refs = dict(means0=means0, lower_bound=host.lower_bound_,
                        means=host.means_, covariances=host.covariances_,
                        n_iter=host.n_iter_,
                        iter_times=list(host.iter_times_))
    return refs, launches


def phase_gmm_multi_fit(x_gmm):
    """``n_init=4`` with ``host_loop=False`` at the mixture shape: every
    restart in one device loop (each member the single fit's iteration at
    its k, one after another in each replayed graph), beside four single
    device-loop fits with the restarts' seeds: the lower bounds bit-equal,
    the same winner and its parameters; diag_estep launched per member once
    by its init and once per iteration."""
    kw = dict(n_components=GMM["k"], init_params="kmeans",
              max_iter=GMM["iters"], tol=0.0, seed=7, host_loop=False)
    multi = GaussianMixture(n_init=GMM_RESTARTS, **kw)
    ds = multi._dataset(x_gmm)
    seconds, launches = timed_fit(multi, ds)
    check_path_launches("gmm_multi_fit")
    singles = []
    for seed in multi._restart_seeds():
        one = GaussianMixture(**{**kw, "seed": seed})
        one.fit(ds)
        singles.append(one)
    lbs = [m.lower_bound_ for m in singles]
    win = singles[multi.best_restart_]
    same = {"restart_lower_bounds": bool(np.array_equal(
                multi.restart_lower_bounds_, lbs)),
            "best_restart": multi.best_restart_ == int(np.argmax(lbs)),
            "winner": all(np.array_equal(getattr(multi, f), getattr(win, f))
                          for f in ("means_", "covariances_", "weights_"))}
    per_member = launches["diag_estep"] / GMM_RESTARTS
    emit("gmm_multi_fit", n_init=GMM_RESTARTS, iterations=multi.n_iter_,
         loop_path=multi.loop_path_, best_restart=multi.best_restart_,
         restart_lower_bounds=list(multi.restart_lower_bounds_),
         single_fit_lower_bounds=lbs, bit_equal_to_single_fits=same,
         diag_estep_launches=launches["diag_estep"],
         diag_estep_launches_per_member=per_member, fit_seconds=seconds,
         seconds_per_iteration_all_members=multi.iter_times_[0],
         single_fit_seconds_per_iteration=statistics.median(
             [m.iter_times_[0] for m in singles]))
    check(multi.loop_path_ == "device-multi", f"{multi.loop_path_}")
    check(all(same.values()), f"gmm_multi_fit: not bit-equal to the single "
                              f"fits: {same}")
    check(per_member == 1 + GMM["iters"],
          f"gmm_multi_fit: {per_member} diag_estep launches per member")
    return launches


def phase_gmm_sweep(x_gmm):
    """``GaussianMixture.sweep`` over GMM_SWEEP_KS by BIC at the mixture
    shape: batched (every member in one device loop, padded to k_max with
    inert components, then one scoring E pass per member) against the
    sequential oracle (one device-loop fit and one ``bic`` per member): the
    same k selected and the member lower bounds bit-equal."""
    gm = GaussianMixture(init_params="kmeans", max_iter=GMM["iters"],
                         tol=0.0, seed=7)
    runs = {}
    for batched in (True, False):
        hk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = gm.sweep(x_gmm, k_range=GMM_SWEEP_KS, criterion="bic",
                       batched=batched)
        torch.cuda.synchronize()
        runs[batched] = (res, time.perf_counter() - t0, dict(hk.LAUNCHES))
        if batched:
            launches = check_path_launches("gmm_sweep")
    b, s = runs[True][0], runs[False][0]
    same = bool(np.array_equal(b.member_scores, s.member_scores))
    emit("gmm_sweep", k_range=list(GMM_SWEEP_KS), criterion="bic",
         selected_k=b.selected_k, sequential_selected_k=s.selected_k,
         scores=list(b.scores), sequential_scores=list(s.scores),
         member_lower_bounds=b.member_scores.ravel().tolist(),
         member_lower_bounds_bit_equal=same,
         seconds_batched=runs[True][1], seconds_sequential=runs[False][1],
         diag_estep_launches=runs[True][2]["diag_estep"],
         sequential_diag_estep_launches=runs[False][2]["diag_estep"])
    check(b.selected_k == s.selected_k,
          f"gmm_sweep: batched picks {b.selected_k}, sequential "
          f"{s.selected_k}")
    check(same, "gmm_sweep: member lower bounds differ from the oracle's")
    return launches


def phase_estep_inert(x_gmm, gmm_tables):
    """diag_estep at k = 256 whose last INERT components are inert (zero
    mean, unit variance, -inf log-weight), as a sweep member padded to
    k_max carries them: against its plain version on the same inputs, and
    against the same call on the real components alone, which it must give
    exactly (their rows bit-equal, the inert rows zero)."""
    shift, means_c, inv_var, log_det, log_w = gmm_tables
    k = means_c.shape[0]
    real = k - INERT
    pad = (means_c.clone(), inv_var.clone(), log_det.clone(), log_w.clone())
    pad[0][real:] = 0.0
    pad[1][real:] = 1.0
    pad[2][real:] = 0.0
    pad[3][real:] = -float("inf")
    w = torch.ones(x_gmm.shape[0], device=DEV)
    args = (x_gmm, w, shift, *pad)
    out = ek.diag_estep(*args)
    ref = ek.diag_estep_reference(*args)
    alone = ek.diag_estep(x_gmm, w, shift,
                          *(t[:real].contiguous() for t in gmm_tables[1:]))
    torch.cuda.synchronize()
    errs = cmp.estep_errors(out, ref)
    ok = errs.pop("ok")
    exact = all(a[:real].equal(b) for a, b in zip(out[:3], alone[:3])) \
        and bool(out[3].equal(alone[3]))
    inert_zero = all(bool((a[real:] == 0).all()) for a in out[:3])
    emit("estep_inert", n=x_gmm.shape[0], d=x_gmm.shape[1], k=k,
         inert=INERT, against_plain=errs, within_plain_tolerance=ok,
         real_rows_equal_unpadded_call=exact, inert_rows_zero=inert_zero)
    check(ok, f"estep_inert: kernel against its plain version {errs}")
    check(exact and inert_zero, "estep_inert: the padded call is not the "
                                "unpadded call's statistics")


def phase_transform(km, x):
    """``transform`` on PREDICT_ROWS rows of the main data against float64
    distances by the plain expanded form on the card (squared, with the
    mind2 tolerances of ops/compare.py), and in blocks of ``block_rows``
    against the whole."""
    rows = x[:PREDICT_ROWS]
    t0 = time.perf_counter()
    out = km.transform(rows)
    whole_s = time.perf_counter() - t0
    blocks = km.transform(rows, block_rows=100_000)
    check(out.shape == (PREDICT_ROWS, MAIN["k"]) and out.dtype == np.float32,
          f"transform: {out.shape} {out.dtype}")
    c = torch.from_numpy(km.centroids).to(DEV)
    x64, c64 = rows.double(), c.double()
    ref = torch.clamp_min((x64 * x64).sum(1)[:, None]
                          + (c64 * c64).sum(1)[None, :]
                          - 2.0 * x64 @ c64.T, 0.0)
    atol = cmp.mind2_atol(rows, c)
    errs = {}
    for name, got in (("whole", out), ("blocks", blocks)):
        got2 = torch.from_numpy(got).to(DEV).double() ** 2
        check(cmp.close(got2, ref, cmp.MIND2_RTOL, atol),
              f"transform ({name}) disagrees with float64 distances")
        errs[name] = max_err(got2, ref)
    emit("transform", rows=PREDICT_ROWS, k=MAIN["k"], seconds=whole_s,
         squared_err_whole=errs["whole"], squared_err_blocks=errs["blocks"],
         atol=atol, rtol=cmp.MIND2_RTOL,
         blocks_against_whole=float(np.abs(out - blocks).max()))


# ------------------------------------------------- model selection (A.1, A.5)


def sentinel_case(name, x, w, c, bf16=False):
    """Sentinel rows (``dist.PAD_CENTROID_VALUE``, as a sweep member's
    padding and the k-means|| buffer carry them) mixed into the table, for
    both kernels (1 and 2, or 1b and 2b) and their plain versions: no
    sentinel wins a row, and the real rows' labels, mind2, sums and counts
    equal those of the same call without the sentinels within
    ops/compare.py (labels outside the band of the real table; sums
    against the plain scatter of the call's own labels)."""
    k, d = c.shape
    real_pos = torch.arange(k, device=DEV) + torch.arange(
        k, device=DEV) // SENTINEL_EVERY + 1
    padded = torch.full((k + k // SENTINEL_EVERY + 1, d),
                        dist.PAD_CENTROID_VALUE, device=DEV)
    padded[real_pos] = c
    to_real = torch.full((padded.shape[0],), -1, dtype=torch.int64,
                         device=DEV)
    to_real[real_pos] = torch.arange(k, device=DEV)
    base = hk.fused_assign_reduce(x, w, c, bf16=bf16)
    base2 = hk.hopper_assign(x, c, bf16=bf16)
    calls = {"kernel_fused": hk.fused_assign_reduce(x, w, padded, bf16=bf16),
             "kernel_assign": hk.hopper_assign(x, padded, bf16=bf16),
             "plain_fused": hk.fused_assign_reduce_reference(
                 x, w, padded, bf16=bf16),
             "plain_assign": hk.assign_reference(x, padded, bf16=bf16)}
    torch.cuda.synchronize()
    m_atol = cmp.mind2_atol(x, c)
    rec = {"case": name, "n": x.shape[0], "d": d, "k": k,
           "sentinels": padded.shape[0] - k, "bf16": bf16}
    for call, out in calls.items():
        labels = to_real[out[0].to(torch.int64)]
        check(bool((labels >= 0).all()), f"{name} {call}: a sentinel row "
                                         f"won {int((labels < 0).sum())} rows")
        ref = base if call.endswith("fused") else base2
        n_diff, n_out = label_band(x, c, labels, ref[0], bf16)
        check(n_out == 0, f"{name} {call}: {n_out} labels differ from the "
                          f"call without sentinels outside the band")
        same = labels == ref[0].to(torch.int64)
        check(close(out[1][same], ref[1][same], cmp.MIND2_RTOL, m_atol),
              f"{name} {call}: mind2 disagrees with the call without "
              f"sentinels")
        rec[call] = {"label_diff": n_diff,
                     "mind2_err": max_err(out[1][same], ref[1][same])}
        if call.endswith("fused"):
            sums, counts = out[2], out[3]
            ref_sums, ref_counts = cmp.scatter_reference(
                x, w, labels.to(torch.int32), k, bf16)
            check(cmp.sums_close(sums[real_pos], ref_sums)
                  and close(counts[real_pos], ref_counts, cmp.COUNTS_RTOL,
                            0.0), f"{name} {call}: sums or counts disagree")
            pad_rows = to_real < 0
            check(float(counts[pad_rows].abs().sum()) == 0.0
                  and float(sums[pad_rows].abs().sum()) == 0.0,
                  f"{name} {call}: a sentinel row has sums or counts")
            rec[call]["sums_err"] = max_err(sums[real_pos], ref_sums)
    return rec


def phase_sentinels(bf16: bool):
    """The sentinel case at three kinds of data: both signs, near 1e3
    (the float32 kernels shift their frame there; a positive sentinel
    leaves the shift as it was), and the main shape's width and k."""
    records = []
    for i, (n, d, k, offset) in enumerate(SENTINEL_SHAPES):
        x, w, c = random_case(n, d, k, seed=300 + i)
        x += offset
        c += offset
        records.append(sentinel_case(f"sentinels_{n}x{d}_k{k}_at_{offset:g}",
                                     x, w, c, bf16))
    emit("kernels_sentinels" + ("_bf16" if bf16 else ""), cases=records)


def float64_band_labels(x, c, labels, rows=GUARD_ROWS):
    """Labels of the first ``rows`` rows against a float64 argmin of the
    distances to ``c``: ``(differing, outside the band)``."""
    xs, c64 = x[:rows].double(), torch.as_tensor(c, device=DEV).double()
    d2 = ((xs * xs).sum(1)[:, None] + (c64 * c64).sum(1)[None, :]
          - 2.0 * xs @ c64.T)
    ref = d2.argmin(dim=1)
    return label_band(x[:rows], c64.float(),
                      torch.as_tensor(labels[:rows], device=DEV), ref)


def phase_guarded(x, host_models, device_seconds):
    """'matmul_bf16_guarded' on the main data, 5 iterations, by the host
    loop and by the device loop (twice on one cached dataset: capture,
    then replay), beside 'matmul_bf16' and 'matmul' (float32, the labels
    the rung stands in for) fitted the same way and the 'kernel_bf16' fits
    of the main_bf16 paths: seconds per iteration, the
    device loop's ``bf16_guard_corrected_rows_``, the two loops bit-equal
    (centroids and SSE history), and the final labels of GUARD_ROWS rows
    against a float64 argmin: none differs outside the band.  No hand
    kernel runs here: the rung is torch (cuBLAS bf16 and float32
    products)."""
    out = {}
    for mode in (dist.GUARDED_MODE, "matmul_bf16", "matmul"):
        kw = dict(k=MAIN["k"], max_iter=MAIN["iters"], seed=42,
                  compute_sse=True, init="forgy", verbose=False,
                  distance_mode=mode)
        host = KMeans(host_loop=True, **kw)
        ds = host.cache(x)
        hk.reset_launch_counts()
        host.fit(ds)
        torch.cuda.synchronize()
        dev = KMeans(host_loop=False, **kw)
        per_iteration = []
        for _ in range(2):
            dev.fit(ds)
            torch.cuda.synchronize()
            per_iteration.append(dev.iter_times_[0])
        same = (dev.iterations_run == host.iterations_run
                and np.array_equal(dev.centroids, host.centroids)
                and dev.sse_history == host.sse_history)
        check(same, f"{mode}: the device loop's fit differs from the host "
                    f"loop's")
        rec = {"mode": mode, "iterations": dev.iterations_run,
               "sse_history": dev.sse_history,
               "seconds_per_iteration_host": statistics.median(
                   host.iter_times_),
               "seconds_per_iteration_device_first_fit": per_iteration[0],
               "seconds_per_iteration_device": per_iteration[1],
               "loops_bit_equal": same,
               "kernel_launches": {n: c for n, c in hk.LAUNCHES.items()
                                   if c}}
        if mode == dist.GUARDED_MODE:
            labels = dev.predict(x[:GUARD_ROWS])
            n_diff, n_out = float64_band_labels(x, dev.centroids, labels)
            check(n_out == 0, f"guarded: {n_out} of {GUARD_ROWS} labels "
                              f"differ from a float64 argmin outside the "
                              f"band")
            flagged = dev.bf16_guard_corrected_rows_
            check(flagged is not None and flagged >= 0,
                  "guarded: no bf16_guard_corrected_rows_")
            rec.update(bf16_guard_corrected_rows=flagged,
                       flagged_share_per_iteration=flagged / (
                           MAIN["n"] * dev.iterations_run),
                       labels_checked=GUARD_ROWS,
                       labels_differing_from_float64=n_diff,
                       outside_band=n_out)
        out[mode] = rec
    kernel_bf16 = {
        "seconds_per_iteration_host": statistics.median(
            host_models["main_bf16"][0].iter_times_),
        "seconds_per_iteration_device": device_seconds["main_bf16_device"]}
    emit("guarded", n=MAIN["n"], d=MAIN["d"], k=MAIN["k"],
         guarded=out[dist.GUARDED_MODE], matmul_bf16=out["matmul_bf16"],
         matmul=out["matmul"], kernel_bf16=kernel_bf16)


def phase_multi_fit(x):
    """``n_init=4`` by the device loop (one loop of four members,
    ``make_multi_fit_fn``) in 'kernel', 'kernel_bf16' and 'matmul' (the
    torch pass), 5 iterations (tolerance 1e-30, so every member runs them
    all): in the kernel modes kernel 1 (1b) launched members x iterations
    in the loop and once per member for the true final inertia, kernel 2
    (2b) once for ``labels_``, and the peak device memory of the fit below
    one copy of the points (no per-member copy); 'matmul' launches no hand
    kernel, its peak is recorded.  ``restart_inertias_``, ``best_restart_``
    and the winner's centroids bit-equal to four single fits with the
    restarts' seeds, whose seconds per iteration are recorded beside the
    four members'."""
    records, counts = [], {}
    for label, mode in (("multi_fit", "pallas"),
                        ("multi_fit_bf16", "pallas_bf16"),
                        ("multi_fit_matmul", "matmul")):
        kernels = mode != "matmul"
        suffix = "_bf16" if mode == "pallas_bf16" else ""
        kw = dict(k=MAIN["k"], max_iter=MAIN["iters"], tolerance=1e-30,
                  seed=42, compute_sse=True, init="forgy", verbose=False,
                  distance_mode=mode, host_loop=False)
        km = KMeans(n_init=MULTI_RESTARTS, **kw)
        ds = km.cache(x)
        km.fit(ds)                       # captures the loop's graph
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        hk.reset_launch_counts()         # this path's own counts
        t0 = time.perf_counter()
        km.fit(ds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        points_bytes = x.numel() * x.element_size()
        r, it = MULTI_RESTARTS, MAIN["iters"]
        if kernels:
            launches = check_path_launches(label)
            counts[label] = launches
            want1 = r * it + r
            check(launches["fused_assign_reduce" + suffix] == want1,
                  f"{label}: {launches['fused_assign_reduce' + suffix]} "
                  f"launches of kernel 1, not members x iterations + "
                  f"members = {want1}")
            check(launches["hopper_assign" + suffix] == 1,
                  f"{label}: kernel 2 launched "
                  f"{launches['hopper_assign' + suffix]} times")
            check(peak < points_bytes, f"{label}: the fit allocated {peak} "
                                       f"bytes, a copy of the points is "
                                       f"{points_bytes}")
        else:
            launches = {n: c for n, c in hk.LAUNCHES.items() if c}
            check(not launches, f"{label}: the torch mode launched "
                                f"{launches}")
        singles = []
        for s in km._restart_seeds():
            one = KMeans(n_init=1, **{**kw, "seed": s}).fit(ds)
            singles.append((one._sse(ds), one))
        inertias = np.asarray([s for s, _ in singles])
        best = int(np.argmin(inertias))
        same = (np.array_equal(inertias, km.restart_inertias_)
                and best == km.best_restart_
                and np.array_equal(singles[best][1].centroids, km.centroids)
                and singles[best][1].sse_history == km.sse_history)
        check(same, f"{label}: restart inertias {km.restart_inertias_} or "
                    f"the winner differ from four single fits' {inertias}")
        rec = {"path": label, "distance_mode": mode, "n_init": r,
               "iterations": km.iterations_run,
               "best_restart": km.best_restart_,
               "restart_inertias": km.restart_inertias_.tolist(),
               "single_fit_inertias": inertias.tolist(),
               "kernel1_launches": launches.get(
                   "fused_assign_reduce" + suffix, 0),
               "kernel2_launches": launches.get("hopper_assign" + suffix, 0),
               "peak_bytes_over_the_dataset": peak,
               "points_bytes": points_bytes,
               "fit_seconds": wall,
               "seconds_per_iteration": km.iter_times_[0],
               # The first single fit captures its graph: the other three.
               "single_fit_seconds_per_iteration": statistics.median(
                   one.iter_times_[0] for _, one in singles[1:]),
               "bit_equal_to_single_fits": same}
        records.append(rec)
        emit("multi_fit", **rec)
    return counts


def _seeding_sse(ds, centroids, mode):
    step = dist.make_step_fn(chunk_size=ds.n, mode=mode,
                             need_farthest=False, need_sse_pc=False)
    return float(step(ds.points, ds.weights,
                      torch.as_tensor(centroids, device=DEV),
                      dist.dataset_sqnorm(ds)).sse)


def buffer_case(name, x, buf, bf16):
    """Kernel 2 (2b) against its plain version on the main data at one
    table of the k-means|| pipeline (slots holding the buffer's sentinel,
    ``seeding._CAND_SENTINEL``, mixed in where a round drew fewer than
    ``cap`` rows): no sentinel slot wins a row under either, their labels
    agree outside the band of the real rows (ops/compare.py), and so does
    ``mind2`` where the labels agree."""
    real = (buf != seeding._CAND_SENTINEL).any(dim=1)
    to_real = torch.full((buf.shape[0],), -1, dtype=torch.int64, device=DEV)
    to_real[real] = torch.arange(int(real.sum()), device=DEV)
    la, ma = hk.hopper_assign(x, buf, bf16=bf16)
    lr, mr = hk.assign_reference(x, buf, bf16=bf16)
    torch.cuda.synchronize()
    ka, kr = to_real[la.to(torch.int64)], to_real[lr.to(torch.int64)]
    check(bool((ka >= 0).all()) and bool((kr >= 0).all()),
          f"{name}: a sentinel slot won {int((ka < 0).sum())} rows of the "
          f"kernel, {int((kr < 0).sum())} of the plain version")
    c = buf[real]
    n_diff, n_out = label_band(x, c, ka, kr, bf16)
    check(n_out == 0, f"{name}: {n_out} labels of kernel 2 differ from the "
                      f"plain version outside the margin band")
    same = ka == kr
    check(close(ma[same], mr[same], cmp.MIND2_RTOL, cmp.mind2_atol(x, c)),
          f"{name}: mind2 of kernel 2 disagrees")
    return {"case": name, "n": x.shape[0], "k": buf.shape[0],
            "sentinel_slots": int((~real).sum()), "bf16": bf16,
            "label_diff": n_diff, "label_diff_in_band": n_diff - n_out,
            "mind2_err": max_err(ma[same], mr[same])}


def phase_kmeans_parallel(x, forgy_fit, seeding_records):
    """``init='k-means||'`` at k = 1024 on the main data in 'kernel' and
    'kernel_bf16': the seeding's seconds beside phase ``seeding``'s
    k-means++ device draws, kernel 2 (2b) launched 1 + rounds + 1 times
    (the first candidate's fold, one fold per round, the mass pass), k
    distinct rows, the seeding's SSE beside k-means++'s, and the SSE of a
    5-iteration fit from it beside the Forgy and k-means++ fits.  Then
    kernel 2 (2b) against its plain version at the tables the seeding hands
    it, from the buffer the pipeline built (``buffer_case``): the first
    candidate (k = 1), one round's ``cap`` slots, and the whole buffer of
    the mass pass."""
    counts = {}
    kmpp = next(r for r in seeding_records if r["data"] == "main")
    ds = KMeans(k=MAIN["k"], verbose=False).cache(x)
    pp = KMeans(k=MAIN["k"], max_iter=MAIN["iters"], seed=7,
                compute_sse=True, init="k-means++", verbose=False)
    pp_seeds = pp._init_centroids(ds, 7)
    pp.fit(ds)
    rounds = max(5, -(-int(1.5 * MAIN["k"]) // min(2 * MAIN["k"], 2048)))
    for label, mode in (("kmeans_parallel", "kernel"),
                        ("kmeans_parallel_bf16", "kernel_bf16")):
        suffix = "_bf16" if mode == "kernel_bf16" else ""
        seeding.kmeans_parallel_init(ds, MAIN["k"], 7, mode=mode)  # warm
        torch.cuda.synchronize()
        hk.reset_launch_counts()         # this path's own counts
        t0 = time.perf_counter()
        seeds = seeding.kmeans_parallel_init(ds, MAIN["k"], 7, mode=mode)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = check_path_launches(label)
        counts[label] = launches
        want = rounds + 2
        check(launches["hopper_assign" + suffix] == want,
              f"{label}: kernel 2 launched "
              f"{launches['hopper_assign' + suffix]} times, not {want}")
        distinct = len(np.unique(seeds, axis=0))
        check(distinct == MAIN["k"] and np.isfinite(seeds).all(),
              f"{label}: {distinct} distinct rows of {MAIN['k']}")
        fit = KMeans(k=MAIN["k"], max_iter=MAIN["iters"], seed=7,
                     compute_sse=True, init="k-means||", verbose=False,
                     distance_mode=mode).fit(ds)
        emit("kmeans_parallel", mode=mode, k=MAIN["k"], rounds=rounds,
             seconds=seconds, kmeanspp_device_seconds=kmpp["device_seconds"],
             kernel2_launches=launches["hopper_assign" + suffix],
             seeding_sse=_seeding_sse(ds, seeds, "kernel"),
             kmeanspp_seeding_sse=_seeding_sse(ds, pp_seeds, "kernel"),
             fit_sse_history=fit.sse_history,
             kmeanspp_fit_sse_history=pp.sse_history,
             forgy_fit_sse_history=forgy_fit.sse_history)
        cap = min(2 * MAIN["k"], 2048)
        _, buf, _, _ = seeding._parallel_pipeline(
            ds, ds.points, ds.weights, MAIN["k"], 7, rounds=rounds, cap=cap,
            ell=2.0 * MAIN["k"], refine=4, mode=mode)
        bf16 = mode == "kernel_bf16"
        emit("kmeans_parallel_kernel_cases", mode=mode, cases=[
            buffer_case(f"{label}_first", ds.points, buf[:1], bf16),
            buffer_case(f"{label}_round", ds.points, buf[1:1 + cap], bf16),
            buffer_case(f"{label}_buffer", ds.points, buf, bf16)])
    return counts


def phase_sweep(x):
    """``KMeans.sweep`` on the main data, k in SWEEP_KS, 'kernel', criterion
    'inertia', 5 iterations: batched (one device loop of the three
    members, each member's kernel 1 at its own k) and ``batched=0`` (one
    device-loop fit per member) select the same k with bit-equal member
    inertias.  Then the per-k winners scored by
    ``metrics.batched_criterion_scores(..., 'silhouette',
    sample_size=SWEEP_SILHOUETTE_ROWS)`` (the sweep's own silhouette is the
    full O(n^2 D) score), their labels by one packed pass.  Kernels 1 and 2
    against their plain versions at each member's k, on the main data and
    the winner's table (``compare_case``)."""
    from kmeans_tpu_torch import metrics
    km = KMeans(k=MAIN["k"], max_iter=MAIN["iters"], seed=42,
                compute_sse=True, init="forgy", verbose=False,
                distance_mode="pallas")
    ds = km.cache(x)
    hk.reset_launch_counts()             # this path's own counts
    t0 = time.perf_counter()
    batched = km.sweep(ds, k_range=SWEEP_KS, criterion="inertia")
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    launches = check_path_launches("sweep")
    t0 = time.perf_counter()
    sequential = km.sweep(ds, k_range=SWEEP_KS, criterion="inertia",
                          batched=0)
    sequential_s = time.perf_counter() - t0
    check(batched.selected_k == sequential.selected_k
          and np.array_equal(batched.member_scores,
                             sequential.member_scores),
          f"sweep: batched {batched.selected_k} "
          f"{batched.member_scores.ravel()} against sequential "
          f"{sequential.selected_k} {sequential.member_scores.ravel()}")
    k_max = max(SWEEP_KS)
    stack = torch.full((len(SWEEP_KS), k_max, MAIN["d"]),
                       dist.PAD_CENTROID_VALUE, device=DEV)
    for i, c in enumerate(batched.winner_centroids):
        stack[i, : c.shape[0]] = torch.from_numpy(c).to(DEV)
    labels = dist.make_multi_predict_fn(
        chunk_size=1 << 15, mode="kernel", n_models=len(SWEEP_KS))(
        x, stack).cpu().numpy()
    t0 = time.perf_counter()
    sil = metrics.batched_criterion_scores(
        x.cpu().numpy(), labels, "silhouette",
        sample_size=SWEEP_SILHOUETTE_ROWS)
    sil_s = time.perf_counter() - t0
    check(np.isfinite(sil).all() and (np.abs(sil) <= 1).all(),
          f"sweep: silhouette scores {sil}")
    ones = torch.ones(MAIN["n"], device=DEV)
    cases = [compare_case(f"sweep_k{c.shape[0]}", x, ones,
                          torch.from_numpy(np.asarray(c, np.float32)).to(DEV),
                          unit_weights=True)
             for c in batched.winner_centroids]
    emit("sweep", n=MAIN["n"], d=MAIN["d"], k_range=list(SWEEP_KS),
         criterion="inertia", selected_k=batched.selected_k,
         member_inertias=batched.member_scores.ravel().tolist(),
         n_iters=batched.n_iters.ravel().tolist(),
         batched_seconds=batched_s, sequential_seconds=sequential_s,
         kernel1_launches_batched=launches["fused_assign_reduce"],
         silhouette_sampled=sil.tolist(),
         silhouette_rows=SWEEP_SILHOUETTE_ROWS, silhouette_seconds=sil_s,
         kernel_cases=cases)
    return {"sweep": launches}


# ------------------------------------------------ the other K-Means families

#: SphericalKMeans on the GloVe-like data (its docstring's workload).
SPHERE_ITERS = 3
#: BisectingKMeans on the main data: leaves, and each split's iteration cap.
BISECT = dict(k=16, iters=10)
#: MiniBatchKMeans on the main data: the JAX package's measured
#: configuration (k = 1024, batch 65,536), 20 iterations, reassignment 0.01,
#: three candidate inits; the host engine's iterations; the full-batch fit
#: from the same init that the final SSE is set beside.
MINIBATCH = dict(k=1024, batch=65_536, iters=20, ratio=0.01, n_init=3,
                 host_iters=5, full_iters=5)


def _unit_rows(x):
    """Rows divided by their norms, in float64, rounded to float32."""
    x = x.to(torch.float64)
    return (x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(
        torch.finfo(torch.float64).tiny)).to(torch.float32)


def _time_case(x, w, c, bf16):
    """Kernel 1 and its plain version at one of the families' shapes:
    ms of each and the bound (:func:`bounds`)."""
    n, d = x.shape
    k = c.shape[0]
    bound_ms, by, _, _, _ = bounds(n, d, k, True, bf16)
    return {"kernel1_ms": median_ms(
                lambda: hk.fused_assign_reduce(x, w, c, bf16=bf16), runs=5),
            "plain_ms": median_ms(
                lambda: hk.fused_assign_reduce_reference(x, w, c, bf16=bf16),
                runs=3, warmup=1),
            "kernel2_ms": median_ms(lambda: hk.hopper_assign(x, c, bf16=bf16),
                                    runs=5),
            "bound_ms": bound_ms, "bound_by": by}


def phase_family_kernels(x_main, c_main, x_glove, bf16):
    """Kernels 1 and 2 (1b and 2b with ``bf16``) against their plain
    versions at the shapes the families give them: k = 2 and k = 1 on the
    main rows with half of them at weight 0 (a bisecting split's pass), a
    gathered mini-batch of 65,536 rows at k = 1024, and unit rows at the
    GloVe-like shape (spherical).  Each case is timed beside its plain
    version and its bound."""
    records = []
    n = x_main.shape[0]
    w_split = torch.ones(n, device=DEV)
    w_split[1::2] = 0.0
    cases = [(f"bisect_k{k}", x_main, w_split, c_main[:k].contiguous(),
              False) for k in (2, 1)]
    keys = torch.from_numpy(dist.minibatch_keys(42)).to(DEV)
    batch = x_main.index_select(0, dist.minibatch_rows(
        n, MINIBATCH["batch"], dist.minibatch_streams(keys, 0)))
    cases.append(("minibatch_batch", batch,
                  torch.ones(batch.shape[0], device=DEV), c_main, True))
    xg = _unit_rows(x_glove)
    gen = torch.Generator(device=DEV).manual_seed(11)
    cg = xg[torch.randperm(xg.shape[0], generator=gen,
                           device=DEV)[:SECOND["k"]]].contiguous()
    cases.append(("sphere_glove", xg, torch.ones(xg.shape[0], device=DEV),
                  cg, True))
    for name, x, w, c, unit in cases:
        rec = compare_case(name, x, w, c, unit_weights=unit, bf16=bf16)
        rec.update(_time_case(x, w, c, bf16))
        records.append(rec)
    emit("kernels_families" + ("_bf16" if bf16 else ""), cases=records)
    return records


def phase_spherical(x_glove):
    """``SphericalKMeans`` on the GloVe-like data, 'pallas', SPHERE_ITERS
    iterations, by the host loop (path ``spherical``) and the device loop
    (``spherical_device``): kernel 1 once per iteration and kernel 2 once
    (``labels_``) in each; the loops equal bit for bit; every centroid
    unit-norm within 1e-6; ``labels_`` equal to kernel 2 on the normalised
    rows; the final SSE (one pass of kernel 1) within SUMS_RTOL of a
    float64 sum of w (2 - 2 cos).  Then one 'pallas_bf16' device-loop fit
    (``spherical_bf16_device``)."""
    kw = dict(k=SECOND["k"], max_iter=SPHERE_ITERS, tolerance=1e-30,
              seed=42, compute_sse=True, init="forgy", verbose=False)
    counts, fits = {}, {}
    ds = None
    for path, extra in (("spherical", dict(host_loop=True,
                                           distance_mode="pallas")),
                        ("spherical_device", dict(host_loop=False,
                                                  distance_mode="pallas")),
                        ("spherical_bf16_device",
                         dict(host_loop=False,
                              distance_mode="pallas_bf16"))):
        km = SphericalKMeans(**kw, **extra)
        ds = ds if ds is not None else km.cache(x_glove)
        hk.reset_launch_counts()             # this path's own counts
        t0 = time.perf_counter()
        km.fit(ds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = check_path_launches(path)
        counts[path] = launches
        suffix = "_bf16" if "bf16" in path else ""
        check(launches["fused_assign_reduce" + suffix] == km.iterations_run
              == SPHERE_ITERS and launches["hopper_assign" + suffix] == 1,
              f"{path}: kernel 1 launched "
              f"{launches['fused_assign_reduce' + suffix]} times for "
              f"{km.iterations_run} iterations, kernel 2 "
              f"{launches['hopper_assign' + suffix]}")
        norms = np.linalg.norm(km.centroids.astype(np.float64), axis=1)
        check(float(np.abs(norms - 1.0).max()) <= 1e-6,
              f"{path}: centroid norms {norms.min()}..{norms.max()}")
        fits[path] = (km, wall, float(np.abs(norms - 1.0).max()))
    host, dev = fits["spherical"][0], fits["spherical_device"][0]
    same = (host.iterations_run == dev.iterations_run
            and np.array_equal(host.centroids, dev.centroids)
            and host.sse_history == dev.sse_history
            and np.array_equal(host.labels_, dev.labels_))
    check(same, "spherical: the device loop differs from the host loop")
    # The first device-loop fit on a dataset captures its graph; a second
    # replays it.
    replay = SphericalKMeans(**kw, host_loop=False,
                             distance_mode="pallas").fit(ds)
    check(np.array_equal(replay.centroids, dev.centroids),
          "spherical: the replayed device loop differs from its capture")
    cents = torch.from_numpy(host.centroids).to(DEV)
    lab, _ = hk.hopper_assign(ds.points, cents)
    check(np.array_equal(lab.cpu().numpy(), host.labels_),
          "spherical: labels_ differ from kernel 2 on the normalised rows")
    sse = -host.score(ds)
    cos = (ds.points.to(torch.float64)
           * cents.to(torch.float64).index_select(0, lab.long())).sum(1)
    ref = float((ds.weights.to(torch.float64) * (2.0 - 2.0 * cos)).sum())
    check(abs(sse - ref) <= cmp.SUMS_RTOL * ref,
          f"spherical: final SSE {sse} against float64 {ref}")
    emit("spherical", n=SECOND["n"], d=SECOND["d"], k=SECOND["k"],
         iterations=host.iterations_run, loops_bit_equal=same,
         final_sse=sse, final_sse_float64=ref,
         sse_rel_err=abs(sse - ref) / ref,
         max_norm_err={p: f[2] for p, f in fits.items()},
         seconds_per_iteration={p: statistics.median(f[0].iter_times_)
                                for p, f in fits.items()},
         device_loop_replay_seconds_per_iteration=replay.iter_times_[0],
         fit_seconds={p: f[1] for p, f in fits.items()},
         bf16_final_sse=fits["spherical_bf16_device"][0].sse_history[-1])
    return counts


def device_profile(fn, iterations: int, top: int = 12) -> dict:
    """``torch.profiler`` over ``fn`` (``iterations`` iterations of a
    loop): the wall seconds, the device time summed over every kernel, the
    device's idle share of the wall time, and the kernels that took the
    most device time, each per iteration.  Empty where the trace shows no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    return {"iterations": iterations, "wall_ms_per_iteration":
            wall / iterations * 1e3,
            "device_ms_per_iteration": device_s / iterations * 1e3,
            "idle_share": 1.0 - device_s / wall if rows else None,
            "kernels": [{"name": key[:90], "device_ms_per_iteration":
                         us / 1e3 / iterations, "calls": count}
                        for us, key, count in rows[:top]]}


def _sse64(ds, centroids, labels, block=1 << 18):
    """Sum of w ||x - c(label)||^2 in float64 on the card."""
    c = torch.as_tensor(centroids, device=DEV).to(torch.float64)
    lab = torch.as_tensor(labels, device=DEV).long()
    total = 0.0
    for lo in range(0, ds.n, block):
        diff = ds.points[lo:lo + block].to(torch.float64) \
            - c.index_select(0, lab[lo:lo + block])
        total += float((ds.weights[lo:lo + block].to(torch.float64)
                        * (diff * diff).sum(1)).sum())
    return total


def phase_bisecting(x):
    """``BisectingKMeans(k=16)`` on the main data, inner ``max_iter`` 10,
    'pallas': by the host loop (path ``bisecting``), again (the same tree:
    the per-cluster SSE is summed in a fixed order), by the device loop
    (``bisecting_device``, the same tree bit for bit), and in 'pallas_bf16'
    (``bisecting_bf16``).  Kernel 2 launched once per split (15) for the
    memberships and kernel 1 once per split for the children's SSE plus
    once per inner iteration (``split_iterations_``), exactly; the sum of ``cluster_sse_`` within SUMS_RTOL of a
    float64 recomputation."""
    splits = BISECT["k"] - 1
    kw = dict(k=BISECT["k"], max_iter=BISECT["iters"], seed=42,
              compute_sse=True, init="forgy", verbose=False)
    counts, fits = {}, {}
    ds = None
    for path, extra in (("bisecting", dict(host_loop=True,
                                           distance_mode="pallas")),
                        ("bisecting_again", dict(host_loop=True,
                                                 distance_mode="pallas")),
                        ("bisecting_device", dict(host_loop=False,
                                                  distance_mode="pallas")),
                        ("bisecting_bf16", dict(host_loop=False,
                                                distance_mode="pallas_bf16"))):
        km = BisectingKMeans(**kw, **extra)
        ds = ds if ds is not None else km.cache(x)
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        km.fit(ds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(hk.LAUNCHES)
        if path != "bisecting_again":
            launches = check_path_launches(path)
            counts[path] = launches
        suffix = "_bf16" if "bf16" in path else ""
        k1 = launches.get("fused_assign_reduce" + suffix, 0)
        k2 = launches.get("hopper_assign" + suffix, 0)
        # Kernel 1: each inner iteration, then one stats pass per split.
        inner = sum(km.split_iterations_)
        check(km.iterations_run == splits and k2 == splits
              and k1 == inner + splits,
              f"{path}: {km.iterations_run} splits, kernel 2 launched {k2} "
              f"times, kernel 1 {k1} for {inner} inner iterations")
        check(np.all(np.isfinite(km.centroids))
              and sorted(np.unique(km.labels_)) == list(range(BISECT["k"])),
              f"{path}: centroids or labels_ out of range")
        fits[path] = (km, wall, k1, k2)
    ref = fits["bisecting"][0]
    for other in ("bisecting_again", "bisecting_device"):
        m = fits[other][0]
        check(np.array_equal(m.labels_, ref.labels_)
              and np.array_equal(m.cluster_sse_, ref.cluster_sse_)
              and np.array_equal(m.centroids, ref.centroids),
              f"{other}: a different tree than the host loop's")
    exact = _sse64(ds, ref.centroids, ref.labels_)
    total = float(np.sum(ref.cluster_sse_))
    check(abs(total - exact) <= cmp.SUMS_RTOL * exact,
          f"bisecting: sum of cluster_sse_ {total} against float64 {exact}")
    bf = fits["bisecting_bf16"][0]
    emit("bisecting", n=ds.n, d=ds.d, k=BISECT["k"], splits=splits,
         inner_max_iter=BISECT["iters"], trees_equal=True,
         cluster_sse_sum=total, float64_sse=exact,
         sse_rel_err=abs(total - exact) / exact,
         bf16_sse_ratio=float(np.sum(bf.cluster_sse_)) / total,
         kernel1_launches={p: f[2] for p, f in fits.items()},
         kernel2_launches={p: f[3] for p, f in fits.items()},
         seconds_per_split={p: statistics.median(f[0].iter_times_)
                            for p, f in fits.items()},
         fit_seconds={p: f[1] for p, f in fits.items()})
    return counts, ref


def phase_minibatch(x):
    """``MiniBatchKMeans`` on the main data at MINIBATCH, 'pallas': the
    per-iteration engine (path ``minibatch``, each iteration launched
    eagerly and read back) and the captured loop (``minibatch_device``),
    equal bit for bit; kernel 1 launched once per iteration plus once per
    candidate init, kernel 2 once for the lazy ``labels_``.  Each
    iteration's batch is distinct rows, one per rotated stratum.  The
    full-data SSE of the final centroids (kernel 1) is below that of the
    initial ones, and is set beside a full-batch fit of ``full_iters``
    iterations from the same init.  Then ``sampling='host'``
    (``minibatch_host``, ``host_iters`` iterations), one 'pallas_bf16'
    loop (``minibatch_bf16_device``) and ``partial_fit`` on one batch.
    Returns the path counts and the replayed loop fit (the one-device
    reference of ``dp_world1``)."""
    it, bs = MINIBATCH["iters"], MINIBATCH["batch"]
    n_init = MINIBATCH["n_init"]
    kw = dict(k=MINIBATCH["k"], batch_size=bs, seed=42, compute_sse=True,
              init="forgy", verbose=False, tolerance=1e-30, n_init=n_init,
              reassignment_ratio=MINIBATCH["ratio"])
    counts, fits = {}, {}
    ds = None
    runs = (("minibatch", dict(host_loop=True, distance_mode="pallas"), it),
            ("minibatch_device", dict(host_loop=False,
                                      distance_mode="pallas"), it),
            ("minibatch_host", dict(sampling="host", distance_mode="pallas"),
             MINIBATCH["host_iters"]),
            ("minibatch_bf16_device", dict(host_loop=False,
                                           distance_mode="pallas_bf16"), it))
    x_host = None
    for path, extra, iters in runs:
        km = MiniBatchKMeans(max_iter=iters, **kw, **extra)
        if path == "minibatch_host":
            x_host = x.cpu().numpy()
            data = x_host
        else:
            ds = ds if ds is not None else km.cache(x)
            data = ds
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        km.fit(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        suffix = "_bf16" if "bf16" in path else ""
        k1 = hk.LAUNCHES["fused_assign_reduce" + suffix]
        check(km.iterations_run == iters and k1 == iters + n_init,
              f"{path}: kernel 1 launched {k1} times for "
              f"{km.iterations_run} iterations and {n_init} candidate "
              f"inits")
        check(km.labels_.shape == (x.shape[0],), f"{path}: labels_ shape")
        launches = check_path_launches(path)
        counts[path] = launches
        check(launches["hopper_assign" + suffix] == 1,
              f"{path}: kernel 2 launched "
              f"{launches['hopper_assign' + suffix]} times for labels_")
        fits[path] = (km, wall)
    per, loop = fits["minibatch"][0], fits["minibatch_device"][0]
    replay = MiniBatchKMeans(max_iter=it, host_loop=False,
                             distance_mode="pallas", **kw).fit(ds)
    check(np.array_equal(replay.centroids, loop.centroids),
          "minibatch: the replayed loop differs from its capture")
    same = (np.array_equal(per.centroids, loop.centroids)
            and per.sse_history == loop.sse_history
            and np.array_equal(per._seen, loop._seen)
            and np.array_equal(per.labels_, loop.labels_))
    check(same, "minibatch: the loop differs from the per-iteration engine")
    n = x.shape[0]
    keys = torch.from_numpy(dist.minibatch_keys(kw["seed"])).to(DEV)
    stratum = n // bs
    for i in range(it):
        stream = dist.minibatch_streams(keys, i)
        rows = dist.minibatch_rows(n, bs, stream)
        rho = (stream[0] * n) >> 32
        strata = ((rows - rho) % n) // stratum
        check(torch.unique(rows).numel() == bs and torch.equal(
            strata, torch.arange(bs, device=DEV)),
            f"minibatch: the batch of iteration {i} is not one distinct row "
            f"per rotated stratum")
    final = per._sse(ds)
    init_sse = float(per.init_inertias_[per.best_init_])
    check(final < init_sse, f"minibatch: final SSE {final} not below the "
                            f"initial centroids' {init_sse}")
    init = seeding.resolve_init("forgy", ds, MINIBATCH["k"],
                                per._restart_seeds()[per.best_init_],
                                mode="kernel")
    full = KMeans(k=MINIBATCH["k"], max_iter=MINIBATCH["full_iters"],
                  tolerance=1e-30, init=init, verbose=False,
                  compute_labels=False, distance_mode="pallas").fit(ds)
    full_sse = full._sse(ds)
    hk.reset_launch_counts()
    pf = MiniBatchKMeans(k=MINIBATCH["k"], seed=42, verbose=False,
                         distance_mode="pallas").partial_fit(x_host[:bs])
    check(hk.LAUNCHES["fused_assign_reduce"] == 1
          and np.all(np.isfinite(pf.centroids)) and pf.iterations_run == 1,
          f"partial_fit: {hk.LAUNCHES['fused_assign_reduce']} launches of "
          f"kernel 1")
    per_s = statistics.median(per.iter_times_)
    loop_s = replay.iter_times_[0]
    eager = dist.make_minibatch_fit_fn(
        batch=bs, mode="kernel", k=MINIBATCH["k"], max_iter=it,
        tolerance=1e-30, reassignment_ratio=MINIBATCH["ratio"],
        reassign_every=per._reassign_every(bs), host_loop=True)
    cents = torch.from_numpy(per.centroids).to(DEV)
    profile = device_profile(lambda: eager(ds, cents, kw["seed"]), it)
    emit("minibatch", n=n, d=x.shape[1], k=MINIBATCH["k"], batch=bs,
         iterations=it, reassignment_ratio=MINIBATCH["ratio"],
         loops_bit_equal=same, batches_one_row_per_stratum=True,
         init_sse=init_sse, final_sse=final,
         full_batch_sse=full_sse, full_batch_iterations=full.iterations_run,
         final_over_full_batch=final / full_sse,
         bf16_final_sse=fits["minibatch_bf16_device"][0]._sse(ds),
         host_sampling_final_sse=fits["minibatch_host"][0]._sse(ds),
         seconds_per_iteration={p: statistics.median(f[0].iter_times_)
                                for p, f in fits.items()},
         device_loop_replay_seconds_per_iteration=loop_s,
         graph_saves_seconds_per_iteration=per_s - loop_s,
         per_iteration_engine_profile=profile,
         full_batch_seconds_per_iteration=statistics.median(
             full.iter_times_),
         fit_seconds={p: f[1] for p, f in fits.items()})
    return counts, replay


# ------------------------------------------------------------ fault tolerance

#: The checkpointed K-Means fits: max_iter, checkpoint_every, the boundary
#: the kill is armed at.
FAULT = dict(iters=6, every=2, kill=4)
#: The real out-of-memory fit: 'matmul' at k = 16,384 with the whole main
#: data as one chunk, whose (chunk, k) float32 distance tile is 137 GB.
OOM = dict(k=16_384, iters=2)
#: Bytes the real out-of-memory fit may leave allocated (its loop's state:
#: the centroid table, 8 MB, and small tensors).
OOM_LEFT_BYTES = 256 << 20
FAULT_SPHERE = dict(iters=4, every=2, kill=2)
FAULT_BISECT = dict(every=4, kill=8)
FAULT_MB = dict(iters=20, every=5, kill=10)
FAULT_GMM = dict(iters=6, every=2, kill=4)
FAULT_FULL = dict(iters=4, every=2, kill=2)
CKPT_WRITES = 5


def same_fit(a, b) -> bool:
    """Centroids, SSE history and iteration count bit for bit."""
    return (a.iterations_run == b.iterations_run
            and np.array_equal(a.centroids, b.centroids)
            and list(a.sse_history) == list(b.sse_history))


def same_mixture(a, b) -> bool:
    return (a.n_iter_ == b.n_iter_ and a.lower_bound_ == b.lower_bound_
            and all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in ("means_", "covariances_", "weights_")))


def counted(fn):
    """``fn()`` with the counters at 0 just before it: ``(result, seconds,
    launches)``."""
    hk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(hk.LAUNCHES)


def killed(fit, j, label):
    """``fit()`` with a kill armed at checkpoint boundary ``j``, the
    counters at 0 just before it: it must fire there.  Returns the
    launches."""
    hk.reset_launch_counts()
    with faults.inject_kill_after_iteration(j) as rec:
        try:
            fit()
        except faults.SimulatedPreemption:
            pass
    torch.cuda.synchronize()
    check(rec["fired_at"] == j,
          f"{label}: the kill armed at {j} fired at {rec['fired_at']}")
    return dict(hk.LAUNCHES)


def iteration_of(path, prev=False) -> int:
    """The completed iteration a checkpoint (or its ``.prev``) holds."""
    state = (ckpt._load_state_at(ckpt.prev_path(path)) if prev
             else ckpt.load_state(path))
    return int(state.get("iterations_run", state.get("n_iter_", 0)))


def captures() -> int:
    return sum(dist.CAPTURES.values())


def phase_fault_tolerance(x, tmp, bf16=False):
    """Checkpointed fits of the main data (Forgy seed 42, FAULT["iters"]
    iterations, tolerance 1e-30) on one cached dataset, 'auto' (kernel 1)
    by the host loop and the device loop (paths ``fault_host``,
    ``fault_device``), or 'pallas_bf16' (kernel 1b) by the device loop
    (``fault_bf16_device``): (a) a plain fit, (b) ``checkpoint_every=2``,
    (c) killed after iteration 4 and resumed from the file by a fresh
    model.  (b) and (c) equal (a) bit for bit, (b) wrote 3 checkpoints,
    the file holds iteration 4 and its ``.prev`` 2, kernel 1 (1b) launched
    6 times in (b) and 4 + 2 in (c), and the device loop's iteration was
    captured once on the dataset for all of them.  Prints the ms of one
    checkpoint write, the seconds per iteration of (b) beside (a) and the
    seconds from ``fit(resume=path)`` to its first iteration.  The float32
    device loop then runs phases ``resume_torn`` and ``oom_injected``."""
    suffix = "_bf16" if bf16 else ""
    k1 = "fused_assign_reduce" + suffix
    mode = "pallas_bf16" if bf16 else "auto"
    kw = dict(k=MAIN["k"], max_iter=FAULT["iters"], seed=42,
              tolerance=1e-30, compute_sse=True, init="forgy",
              verbose=False, compute_labels=False, distance_mode=mode)
    ck = dict(checkpoint_every=FAULT["every"])
    ds = KMeans(**kw).cache(x)
    counts, out = {}, {}
    for loop in (("device",) if bf16 else ("host", "device")):
        path = f"fault{suffix}_{loop}"
        lkw = dict(kw, host_loop=loop == "host")
        caps = captures()
        KMeans(**lkw).fit(ds)                  # the capture (device loop)
        a, a_s, a_l = counted(lambda: KMeans(**lkw).fit(ds))
        p_b, p_c = tmp / f"{path}_b.npz", tmp / f"{path}_c.npz"
        b, b_s, b_l = counted(lambda: KMeans(**lkw).fit(
            ds, checkpoint_path=p_b, **ck))
        kill_l = killed(lambda: KMeans(**lkw).fit(
            ds, checkpoint_path=p_c, **ck), FAULT["kill"], path)
        c = KMeans(**lkw)
        c, c_s, c_l = counted(lambda: c.fit(ds, resume=p_c))
        counts[path] = {n: a_l.get(n, 0) + b_l.get(n, 0) + kill_l.get(n, 0)
                        + c_l.get(n, 0) for n in set(a_l) | set(b_l)}
        hk.reset_launch_counts()
        hk.LAUNCHES.update(counts[path])
        check_path_launches(path)
        new_caps = captures() - caps
        check(same_fit(b, a) and same_fit(c, a),
              f"{path}: segmented {same_fit(b, a)}, resumed "
              f"{same_fit(c, a)} against the plain fit")
        check(b.checkpoint_segments_ == 3 and b.iterations_run == 6,
              f"{path}: {b.checkpoint_segments_} checkpoints")
        check((iteration_of(p_c), iteration_of(p_c, prev=True)) == (4, 2),
              f"{path}: the file holds {iteration_of(p_c)}, .prev "
              f"{iteration_of(p_c, prev=True)}")
        check(b_l[k1] == 6 and kill_l[k1] == 4 and c_l[k1] == 2,
              f"{path}: kernel launches {b_l[k1]} segmented, "
              f"{kill_l[k1]} + {c_l[k1]} killed and resumed")
        check(loop == "host" or new_caps == 1,
              f"{path}: {new_caps} captures on one dataset")
        state = b._state_dict()
        write_ms = []
        for _ in range(CKPT_WRITES):
            t0 = time.perf_counter()
            ckpt.save_state_primary(tmp / "w.npz", state, None, rotate=True)
            write_ms.append((time.perf_counter() - t0) * 1e3)
        out[loop] = dict(
            bit_equal=True, checkpoints=b.checkpoint_segments_,
            kernel1_launches={"plain": a_l[k1], "segmented": b_l[k1],
                              "killed": kill_l[k1], "resumed": c_l[k1]},
            captures=new_caps,
            checkpoint_write_ms=statistics.median(write_ms),
            checkpoint_bytes=p_b.stat().st_size,
            plain_fit_seconds=a_s, segmented_fit_seconds=b_s,
            # The loop's own wall (iter_times_: set-up and init left out;
            # the device loop's boundaries are inside it).
            plain_seconds_per_iteration=statistics.mean(a.iter_times_),
            segmented_seconds_per_iteration=statistics.mean(b.iter_times_),
            seconds_per_boundary=(b_s - a_s) / b.checkpoint_segments_,
            resume_to_first_iteration_s=c_s - sum(c.iter_times_),
            resume_fit_seconds=c_s)
        if loop == "device" and not bf16:
            counts.update(phase_resume_torn(ds, lkw, a, p_c))
            counts.update(phase_oom_injected(ds, lkw, a, tmp))
    emit("fault_tolerance" + suffix, n=ds.n, d=ds.d, k=MAIN["k"],
         iterations=FAULT["iters"], every=FAULT["every"],
         kill=FAULT["kill"], distance_mode=mode, **out)
    return counts


def phase_resume_torn(ds, kw, plain, path):
    """The killed fit's file truncated: the resume warns, starts from
    ``.prev`` (iteration 2) and ends bit-equal to the plain fit, kernel 1
    launched 4 times (path ``resume_torn``)."""
    blob = path.read_bytes()
    path.write_bytes(blob[: len(blob) // 3])
    m = KMeans(**kw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m, seconds, launches = counted(lambda: m.fit(ds, resume=path))
    warned = any("last-good rotation" in str(w.message) for w in caught)
    check(warned and same_fit(m, plain)
          and launches["fused_assign_reduce"] == 4,
          f"resume_torn: warned {warned}, bit-equal {same_fit(m, plain)}, "
          f"kernel 1 {launches['fused_assign_reduce']}")
    hk.reset_launch_counts()
    hk.LAUNCHES.update(launches)
    emit("resume_torn", bit_equal=True, warned=True, resumed_from=2,
         kernel1_launches=launches["fused_assign_reduce"],
         fit_seconds=seconds)
    return {"resume_torn": check_path_launches("resume_torn")}


def phase_oom_injected(ds, kw, plain, tmp):
    """``inject_oom_on_segment(1)`` on the segmented device loop: one
    backoff, ``effective_chunk_`` halved, the segment replayed from its
    boundary in the same mode (kernel 1, which takes no chunk: the graph
    captured for the dataset is replayed, no new capture), the result
    bit-equal (path ``oom_injected``)."""
    m = KMeans(**kw)
    caps = captures()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with faults.inject_oom_on_segment(1) as rec:
            m, seconds, launches = counted(lambda: m.fit(
                ds, checkpoint_every=FAULT["every"],
                checkpoint_path=tmp / "oom_injected.npz"))
    chunk = m._chunk_for(ds)
    check(rec["fired"] == 1 and m.oom_backoffs_ == 1
          and m.effective_chunk_ == sharding.backoff_chunk(chunk)
          and m._mode() == "kernel" and same_fit(m, plain)
          and launches["fused_assign_reduce"] == 6
          and captures() == caps,
          f"oom_injected: backoffs {m.oom_backoffs_}, chunk {chunk} -> "
          f"{m.effective_chunk_}, bit-equal {same_fit(m, plain)}, "
          f"launches {launches}, {captures() - caps} new captures")
    hk.reset_launch_counts()
    hk.LAUNCHES.update(launches)
    emit("oom_injected", backoffs=m.oom_backoffs_, chunk=chunk,
         effective_chunk=m.effective_chunk_, bit_equal=True,
         new_captures=0, fit_seconds=seconds)
    return {"oom_injected": check_path_launches("oom_injected")}


def phase_oom_real(x):
    """A real ``torch.cuda.OutOfMemoryError``, no injection armed: the
    main data in 'matmul' by the device loop at k = OOM["k"] with
    ``chunk_size`` the whole of n, whose (n, k) float32 distance tile
    alone is 137 GB.  The first eager iteration (or the capture) runs out
    of memory, the loop leaves the dataset's memo, its memory returns to
    the card, and the fit replays at the next chunk until one fits:
    ``oom_backoffs_ >= 1``, the result bit-equal to a clean fit started at
    the final ``effective_chunk_``, and ``torch.cuda.memory_allocated()``
    back within OOM_LEFT_BYTES of its value before the fit.  The model's
    explicit chunk is not clamped first (``_chunk_for``)."""
    n = x.shape[0]
    # assign='dense': the dense oracle's device loop ('auto' would take the
    # two-level route, plan_fit predicting that this tile cannot fit).
    kw = dict(k=OOM["k"], max_iter=OOM["iters"], seed=42, tolerance=1e-30,
              compute_sse=True, init="forgy", verbose=False,
              compute_labels=False, distance_mode="matmul",
              host_loop=False, chunk_size=n, assign="dense")
    m = KMeans(**kw)
    ds = m.cache(x)
    check(m._chunk_for(ds) == n, f"oom_real: the chunk was clamped to "
                                 f"{m._chunk_for(ds)}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    free0, total = torch.cuda.mem_get_info()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m, seconds, launches = counted(lambda: m.fit(ds))
    after = torch.cuda.memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    clean = KMeans(**dict(kw, chunk_size=m.effective_chunk_))
    clean, clean_s, _ = counted(lambda: clean.fit(ds))
    chunks = [n]
    while chunks[-1] != m.effective_chunk_ and len(chunks) < 20:
        chunks.append(sharding.backoff_chunk(chunks[-1]))
    check(m.oom_backoffs_ >= 1 and m._mode() == "matmul"
          and same_fit(m, clean)
          and after - before <= OOM_LEFT_BYTES
          and not any(key[0] == "device_loop" and key[2] != m.effective_chunk_
                      for key in ds._memo),
          f"oom_real: backoffs {m.oom_backoffs_}, bit-equal "
          f"{same_fit(m, clean)}, allocated {after - before} bytes more, "
          f"memo {[k for k in ds._memo if k[0] == 'device_loop']}")
    emit("oom_real", n=n, d=x.shape[1], k=OOM["k"], iterations=OOM["iters"],
         backoffs=m.oom_backoffs_, chunks=chunks,
         effective_chunk=m.effective_chunk_,
         tile_gb={c: c * OOM["k"] * 4 / 1e9 for c in chunks},
         warnings=len(caught), fit_seconds=seconds,
         clean_fit_seconds=clean_s, seconds_lost_to_backoffs=seconds
         - clean_s, clean_seconds_per_iteration=statistics.mean(
             clean.iter_times_), allocated_before=before,
         allocated_after=after,
         peak_reserved_bytes=peak_reserved, card_free_bytes=free0,
         card_total_bytes=total, bit_equal=True)
    del m, clean, ds
    torch.cuda.empty_cache()
    return {"oom_real": dict(launches)}


def phase_divergence_rollback(x, x_other, tmp):
    """The rollback on divergence, by the host loop and the device loop,
    kernel 1 (the elastic tests' recipe at the main shape): a fit of
    FAULT["iters"] iterations writes its checkpoints, then a fresh model
    resumes from that file onto the main data with row 100 poisoned
    (NaN): iteration 7 goes non-finite, ``NumericalDivergenceError``
    names it, ``rolled_back_to`` is 6 and the model holds the file's
    state.  Then a fit of other data (a NaN row) with the same path
    diverges before its first write: no rollback, the stale file of the
    first fit is neither restored nor overwritten."""
    bad = x.clone()
    bad[100] = float("nan")
    other = x_other.clone()
    other[5] = float("nan")
    counts, out = {}, {}
    for loop in ("host", "device"):
        path = tmp / f"diverge_{loop}.npz"
        kw = dict(k=MAIN["k"], max_iter=FAULT["iters"], seed=42,
                  tolerance=1e-30, init="forgy", verbose=False,
                  compute_labels=False, host_loop=loop == "host")
        hk.reset_launch_counts()
        KMeans(**kw).fit(x, checkpoint_every=FAULT["every"],
                         checkpoint_path=path)
        good = ckpt.load_state(path)
        m = KMeans(**dict(kw, max_iter=40))
        err = None
        try:
            m.fit(bad, resume=path, checkpoint_every=FAULT["every"],
                  checkpoint_path=path)
        except NumericalDivergenceError as e:
            err = e
        check(err is not None and err.iteration == 7
              and err.rolled_back_to == 6 == good["iterations_run"]
              and np.array_equal(m.centroids, good["centroids"])
              and m.iterations_run == 6,
              f"divergence_{loop}: {err!r}")
        stale = KMeans(**kw)
        serr = None
        try:
            stale.fit(other, checkpoint_every=FAULT["every"],
                      checkpoint_path=path)
        except NumericalDivergenceError as e:
            serr = e
        kept = ckpt.load_state(path)
        check(serr is not None and serr.rolled_back_to is None
              and (stale.centroids is None
                   or not np.array_equal(stale.centroids, good["centroids"]))
              and np.array_equal(kept["centroids"], good["centroids"]),
              f"divergence_{loop}: the stale checkpoint was restored or "
              f"overwritten: {serr!r}")
        counts[f"divergence_{loop}"] = check_path_launches(
            f"divergence_{loop}")
        out[loop] = dict(iteration=err.iteration,
                         rolled_back_to=err.rolled_back_to,
                         stale_iteration=serr.iteration,
                         stale_restored=False, message=str(err))
    emit("divergence_rollback", n=x.shape[0], d=x.shape[1], k=MAIN["k"],
         **out)
    return counts


def phase_fault_families(x, x_glove, x_gmm, tmp, refs):
    """Each family killed at a boundary and resumed from its file by a
    fresh model, bit-equal to its uninterrupted fit, at the sizes of its
    own phase: ``SphericalKMeans`` on the GloVe-like data by the device
    loop; ``BisectingKMeans`` (k = 16, the host loop) checkpointed every 4
    splits, killed after 8 (the tree and, over the two fits, kernel 1 =
    sum(``split_iterations_``) + splits, kernel 2 = splits);
    ``MiniBatchKMeans``' captured loop, 20 iterations, every 5, killed at
    10; ``GaussianMixture`` 'diag' on the mixture data by the device EM
    loop, every 2 of 6 (segmented: ``diag_estep`` 1 + 6; killed at 4 and
    resumed for the 2 iterations left, ``resume`` running ``max_iter``
    more); 'full' at 1,048,576 x 64, k = 32, by the host loop, 4
    iterations, killed at 2."""
    counts, out = {}, {}

    def family(path, plain, make, fit_ckpt, resume, same, extra=None):
        """(a) ``plain`` given; killed at its boundary, then resumed."""
        kill_l = killed(lambda: fit_ckpt(make()), FAULT_KILLS[path], path)
        m, seconds, res_l = counted(lambda: resume())
        ok = same(m, plain)
        total = {n: kill_l.get(n, 0) + res_l.get(n, 0)
                 for n in set(kill_l) | set(res_l)}
        hk.reset_launch_counts()
        hk.LAUNCHES.update(total)
        counts[path] = check_path_launches(path)
        check(ok, f"{path}: the resumed fit differs from the plain one")
        out[path] = dict(bit_equal=ok, resume_seconds=seconds,
                         launches={n: c for n, c in total.items() if c},
                         **(extra or {}))
        return m, kill_l, res_l

    # SphericalKMeans, device loop, GloVe-like.
    skw = dict(k=SECOND["k"], max_iter=FAULT_SPHERE["iters"],
               tolerance=1e-30, seed=42, compute_sse=True, init="forgy",
               verbose=False, compute_labels=False, host_loop=False,
               distance_mode="pallas")
    sds = SphericalKMeans(**skw).cache(x_glove)
    plain = SphericalKMeans(**skw).fit(sds)
    p = tmp / "spherical.npz"
    m, _, _ = family(
        "fault_spherical", plain, lambda: SphericalKMeans(**skw),
        lambda mm: mm.fit(sds, checkpoint_every=FAULT_SPHERE["every"],
                          checkpoint_path=p),
        lambda: SphericalKMeans(**skw).fit(sds, resume=p), same_fit)
    norms = np.linalg.norm(m.centroids.astype(np.float64), axis=1)
    check(np.all(np.abs(norms - 1.0) <= 1e-6), "fault_spherical: norms")

    # BisectingKMeans, host loop, main data.
    bkw = dict(k=BISECT["k"], max_iter=BISECT["iters"], seed=42,
               compute_sse=True, init="forgy", verbose=False,
               host_loop=True, distance_mode="pallas")
    bds = BisectingKMeans(**bkw).cache(x)
    plain = refs["bisecting"]
    p = tmp / "bisecting.npz"
    killed_model = {}

    def bisect_ckpt(mm):
        killed_model["m"] = mm
        mm.fit(bds, checkpoint_every=FAULT_BISECT["every"],
               checkpoint_path=p)

    def same_tree(a, b):
        return (np.array_equal(a.centroids, b.centroids)
                and np.array_equal(a.labels_, b.labels_)
                and np.array_equal(a.cluster_sse_, b.cluster_sse_)
                and a.iterations_run == b.iterations_run)

    m, kill_l, res_l = family(
        "fault_bisecting", plain, lambda: BisectingKMeans(**bkw),
        bisect_ckpt, lambda: BisectingKMeans(**bkw).fit(bds, resume=p),
        same_tree)
    splits = BISECT["k"] - 1
    inner = (sum(killed_model["m"].split_iterations_)
             + sum(m.split_iterations_))
    k1 = kill_l["fused_assign_reduce"] + res_l["fused_assign_reduce"]
    k2 = kill_l["hopper_assign"] + res_l["hopper_assign"]
    check(k1 == inner + splits and k2 == splits
          and len(m.split_iterations_) == splits - FAULT_BISECT["kill"],
          f"fault_bisecting: kernel 1 {k1} for {inner} inner iterations, "
          f"kernel 2 {k2} for {splits} splits")
    out["fault_bisecting"]["tree_bytes"] = p.stat().st_size

    # MiniBatchKMeans, captured loop, main data.
    mkw = dict(k=MINIBATCH["k"], batch_size=MINIBATCH["batch"], seed=42,
               compute_sse=True, init="forgy", verbose=False,
               tolerance=1e-30, max_iter=FAULT_MB["iters"],
               reassignment_ratio=MINIBATCH["ratio"], host_loop=False,
               distance_mode="pallas", compute_labels=False)
    mds = MiniBatchKMeans(**mkw).cache(x)
    plain = MiniBatchKMeans(**mkw).fit(mds)
    seg = MiniBatchKMeans(**mkw).fit(mds, checkpoint_every=FAULT_MB["every"],
                                     checkpoint_path=tmp / "mb_seg.npz")
    check(same_fit(seg, plain) and np.array_equal(seg._seen, plain._seen)
          and seg.checkpoint_segments_ == 4,
          "fault_minibatch: the segmented loop differs")
    p = tmp / "minibatch.npz"
    family("fault_minibatch", plain, lambda: MiniBatchKMeans(**mkw),
           lambda mm: mm.fit(mds, checkpoint_every=FAULT_MB["every"],
                             checkpoint_path=p),
           lambda: MiniBatchKMeans(**mkw).fit(mds, resume=p),
           lambda a, b: same_fit(a, b) and np.array_equal(a._seen, b._seen))

    # GaussianMixture 'diag', device EM loop, mixture data.
    gkw = dict(n_components=GMM["k"], init_params="kmeans",
               max_iter=FAULT_GMM["iters"], tol=0.0, seed=7,
               host_loop=False)
    gds = GaussianMixture(**gkw)._dataset(x_gmm)
    plain = GaussianMixture(**gkw).fit(gds)
    seg, seg_s, seg_l = counted(lambda: GaussianMixture(**gkw).fit(
        gds, checkpoint_every=FAULT_GMM["every"],
        checkpoint_path=tmp / "gmm_seg.npz"))
    check(same_mixture(seg, plain) and seg.checkpoint_segments_ == 3
          and seg_l["diag_estep"] == 1 + FAULT_GMM["iters"],
          f"fault_gmm_diag: segmented bit-equal {same_mixture(seg, plain)}, "
          f"diag_estep {seg_l['diag_estep']}")
    p = tmp / "gmm.npz"
    left = FAULT_GMM["iters"] - FAULT_GMM["kill"]
    family("fault_gmm_diag", plain, lambda: GaussianMixture(**gkw),
           lambda mm: mm.fit(gds, checkpoint_every=FAULT_GMM["every"],
                             checkpoint_path=p),
           lambda: GaussianMixture(**dict(gkw, max_iter=left)).fit(
               gds, resume=p), same_mixture,
           extra=dict(segmented_diag_estep=seg_l["diag_estep"],
                      segmented_seconds=seg_s))
    dev = sorted(k for k in ckpt.load_state(p) if k.startswith("dev_"))
    check(len(dev) == 5, f"fault_gmm_diag: the checkpoint holds {dev}")
    out["fault_gmm_diag"]["dev_tables"] = dev

    # GaussianMixture 'full', host loop.
    xf = full_data()
    fkw = dict(n_components=FULL["k"], covariance_type="full",
               init_params="kmeans", max_iter=FAULT_FULL["iters"], tol=0.0,
               seed=7, host_loop=True)
    fds = GaussianMixture(**fkw)._dataset(xf)
    plain = GaussianMixture(**fkw).fit(fds)
    p = tmp / "gmm_full.npz"
    left = FAULT_FULL["iters"] - FAULT_FULL["kill"]
    family("fault_gmm_full", plain, lambda: GaussianMixture(**fkw),
           lambda mm: mm.fit(fds, checkpoint_every=FAULT_FULL["every"],
                             checkpoint_path=p),
           lambda: GaussianMixture(**dict(fkw, max_iter=left)).fit(
               fds, resume=p), same_mixture)
    del xf, fds
    emit("fault_families", **out)
    return counts


#: The boundary each family's kill is armed at.
FAULT_KILLS = {"fault_spherical": FAULT_SPHERE["kill"],
               "fault_bisecting": FAULT_BISECT["kill"],
               "fault_minibatch": FAULT_MB["kill"],
               "fault_gmm_diag": FAULT_GMM["kill"],
               "fault_gmm_full": FAULT_FULL["kill"]}


# -------------------------------------------------------------------- timing


# ---------------------------------------------------------------- streaming
#
# The streams (ROADMAP A.10): the main data written once as a .npy file and
# read back in STREAM["rows"]-row blocks (``data.io.iter_npy_blocks``), each
# block decoded and copied to the card by ``parallel.sharding.BlockStager``
# (a pinned ring, a copy stream, an event per slot) in the prefetch thread,
# then the model's step on the consumer's stream.

STREAM = dict(rows=262_144, iters=5, prefetch=2)
# The stream larger than the card: the main file OVERSIZE_REPEATS times over
# in one epoch (96 x 1 GiB), peak allocated memory above the baseline under
# OVERSIZE_PEAK_BYTES.
OVERSIZE_REPEATS = 96
OVERSIZE_PEAK_BYTES = 4 << 30
# The streamed k-means|| fit's final SSE within this factor of the in-memory
# k-means|| fit's (tests/test_torch_kmeans_parallel.py's class).
QUALITY_FACTOR = 1.25
STREAM_GMM_LL_RTOL = 1e-5
STREAM_FULL = dict(iters=3, rows=131_072)
STREAM_GLOVE_ROWS = 65_536


def npy_of(x, path: Path) -> Path:
    """The rows of a tensor on the card written as a .npy file."""
    np.save(path, x.cpu().numpy())
    return path


def repeated_blocks(path: Path, rows: int, repeats: int):
    """A ``make_blocks`` that reads the file ``repeats`` times over in one
    epoch through one memory map (the page cache stands in for a disk of
    ``repeats`` times the file)."""
    def make_blocks():
        arr = np.load(path, mmap_mode="r")
        for _ in range(repeats):
            for start in range(0, arr.shape[0], rows):
                yield arr[start: start + rows]
    return make_blocks


def stream_fit(make_blocks, prefetch, **kw):
    """``KMeans.fit_stream`` with the counters at 0 just before it and the
    peak allocated memory measured from just before it: ``(model, seconds,
    launches, peak bytes above the baseline)``."""
    km = KMeans(verbose=False, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    km, seconds, launches = counted(
        lambda: km.fit_stream(make_blocks, prefetch=prefetch))
    return km, seconds, launches, torch.cuda.max_memory_allocated() - base


def labels_outside_band(x, c_a, c_b) -> tuple:
    """Rows whose nearest centroid (kernel 2) differs between two tables
    of two fits, those of them outside the margin band of ops/compare.py
    (on ``c_a``), and those of them that neither the band nor the move of
    their two centroids between the tables explains: a row labelled a
    under A and b under B has ``d_A(b) - d_A(a) <= e_a + e_b``, ``e_c =
    2 ||x - c_A|| ||c_A - c_B|| + ||c_A - c_B||^2``, since no distance to
    c moves by more than ``e_c`` between the tables."""
    pred = dist.make_predict_fn(chunk_size=1 << 17, mode="kernel")
    a = torch.from_numpy(np.ascontiguousarray(c_a)).to(DEV)
    b = torch.from_numpy(np.ascontiguousarray(c_b)).to(DEV)
    la, lb = pred(x, a), pred(x, b)
    diff = (la != lb).nonzero().flatten()
    xd, ad = x[diff].double(), a.double()
    ia, ib = la[diff].long(), lb[diff].long()
    margin = (((xd - ad[ib]) ** 2).sum(1) - ((xd - ad[ia]) ** 2).sum(1)).abs()
    move = (ad - b.double()).norm(dim=1)
    e_a = 2 * (xd - ad[ia]).norm(dim=1) * move[ia] + move[ia] ** 2
    e_b = 2 * (xd - ad[ib]).norm(dim=1) * move[ib] + move[ib] ** 2
    band = MARGIN_RTOL * ((xd * xd).sum(1) + (ad * ad).sum(1).max())
    return (int(diff.numel()), int((margin > band).sum()),
            int((margin > band + e_a + e_b).sum()))


def phase_stream(x, c0, tmp):
    """The main data as a stream (8 blocks) through ``KMeans.fit_stream``,
    'auto' (kernel 1), STREAM["iters"] epochs, tolerance 1e-30, from the
    main path's Forgy centroids ``c0``, 'keep' ('resample' draws from the
    epoch's reservoir in a stream and from the dataset in memory): prefetch
    0 and 2 bit-identical, and so under 'resample' (2 epochs); against the
    in-memory fit from ``c0`` in the class of phase ``device_loop``
    (iterations equal, final SSE within DEVICE_SSE_RTOL) and every label
    that differs explained by the band or by the move of its centroids
    (``labels_outside_band``: near ties flip where the float64 block sums
    round otherwise than the kernel's one pass, and a flip moves its
    centroids); kernel 1 exactly blocks x epochs;
    seconds per epoch, the host-to-device rate and the peak allocated
    memory above the baseline against (prefetch + 2) blocks plus the
    tables.  Then the same in bf16 (phase ``stream_bf16``): kernel 1b
    blocks x epochs, the final SSE within BF16_SSE_RATIO of the float32
    stream's."""
    path = npy_of(x, tmp / "main.npy")
    blocks = -(-MAIN["n"] // STREAM["rows"])
    make_blocks = iter_npy_blocks(path, STREAM["rows"])
    kw = dict(k=MAIN["k"], max_iter=STREAM["iters"], tolerance=1e-30,
              seed=42, compute_sse=True, init=c0, empty_cluster="keep")
    mem = KMeans(verbose=False, **kw).fit(x)
    block_bytes = STREAM["rows"] * MAIN["d"] * 4
    tables = MAIN["k"] * (MAIN["d"] + 1) * 4 * 4
    counts, fits = {}, {}
    for prefetch in (0, STREAM["prefetch"]):
        km, seconds, launches, peak = stream_fit(make_blocks, prefetch, **kw)
        fits[prefetch] = km
        path_name = f"stream_p{prefetch}"
        counts[path_name] = {k: v for k, v in launches.items() if v}
        epoch_s = statistics.median(km.iter_times_)
        emit("stream", prefetch=prefetch, blocks=blocks,
             block_rows=STREAM["rows"], iterations=km.iterations_run,
             sse_history=km.sse_history, fit_seconds=seconds,
             seconds_per_epoch=km.iter_times_,
             median_seconds_per_epoch=epoch_s,
             h2d_gb_per_s=MAIN["n"] * MAIN["d"] * 4 / epoch_s / 1e9,
             peak_allocated_bytes=peak,
             prefetch_plus_2_blocks_and_tables=(prefetch + 2) * block_bytes
             + tables, launches=counts[path_name])
        check(launches["fused_assign_reduce"] == blocks * STREAM["iters"],
              f"stream p{prefetch}: kernel 1 launched "
              f"{launches['fused_assign_reduce']} times, not "
              f"{blocks} x {STREAM['iters']}")
        # One more block than the ring holds: the step's sum w||x||^2
        # temporary.
        check(peak <= (prefetch + 3) * block_bytes + tables + (64 << 20),
              f"stream p{prefetch}: peak {peak} bytes above the baseline")
    a, b = fits[0], fits[STREAM["prefetch"]]
    check(same_fit(a, b), "stream: prefetch 0 and 2 not bit-identical")
    # 'resample' draws from the epoch's reservoir, offered the blocks on the
    # consumer's side: prefetch does not move its draws either.
    pair = [stream_fit(make_blocks, p, **dict(
        kw, max_iter=2, empty_cluster="resample"))[0]
        for p in (0, STREAM["prefetch"])]
    emit("stream", empty_cluster="resample", iterations=2,
         prefetch_bit_identical=same_fit(*pair),
         empty_clusters_last_iteration=int(
             (pair[0].cluster_sizes_ == 0).sum()))
    check(same_fit(*pair), "stream: 'resample' prefetch 0 and 2 not "
                           "bit-identical")
    rel = abs(b.sse_history[-1] - mem.sse_history[-1]) / mem.sse_history[-1]
    differ, outside, unexplained = labels_outside_band(x, b.centroids,
                                                       mem.centroids)
    emit("stream", against="in-memory fit", iterations=b.iterations_run,
         memory_iterations=mem.iterations_run, final_sse_rel_diff=rel,
         memory_sse_history=mem.sse_history,
         max_centroid_diff=float(np.abs(b.centroids.astype(np.float64)
                                        - mem.centroids).max()),
         labels_differ=differ, labels_differ_outside_band=outside,
         labels_differ_unexplained=unexplained,
         memory_seconds_per_iteration=statistics.median(mem.iter_times_))
    check(b.iterations_run == mem.iterations_run and rel <= DEVICE_SSE_RTOL
          and unexplained == 0,
          f"stream: against the in-memory fit: iterations "
          f"{b.iterations_run} / {mem.iterations_run}, SSE {rel}, "
          f"{unexplained} labels unexplained")

    km16, seconds, launches, peak = stream_fit(
        make_blocks, STREAM["prefetch"], distance_mode="pallas_bf16", **kw)
    counts["stream_bf16"] = {k: v for k, v in launches.items() if v}
    ratio = km16.sse_history[-1] / b.sse_history[-1]
    emit("stream_bf16", iterations=km16.iterations_run,
         sse_history=km16.sse_history, sse_ratio_to_f32_stream=ratio,
         fit_seconds=seconds, seconds_per_epoch=km16.iter_times_,
         peak_allocated_bytes=peak, launches=counts["stream_bf16"])
    check(launches["fused_assign_reduce_bf16"] == blocks * STREAM["iters"]
          and abs(ratio - 1.0) <= BF16_SSE_RATIO,
          f"stream_bf16: launches {launches}, SSE ratio {ratio}")
    return path, b, km16, counts


def phase_stream_infer(x, path, models):
    """``predict_stream`` (kernel 2 once per block) against ``predict``;
    ``score_stream`` (kernel 1 once per block) against ``score`` to
    SUMS_RTOL; ``transform_stream`` with prefetch 2 bit-equal to prefetch 0
    on the first block; for the float32 and the bf16 stream model."""
    blocks = -(-MAIN["n"] // STREAM["rows"])
    make_blocks = iter_npy_blocks(path, STREAM["rows"])
    block0 = np.load(path, mmap_mode="r")[: STREAM["rows"]]
    counts = {}
    for label, km in models.items():
        bf16 = km._mode() == "kernel_bf16"
        suffix = "_bf16" if bf16 else ""
        labels, p_seconds, p_launches = counted(lambda: np.concatenate(
            list(km.predict_stream(make_blocks))))
        want = km.predict(x)
        equal = int((labels == want).sum())
        differ, outside = label_band(
            x, torch.from_numpy(km.centroids).to(DEV),
            torch.from_numpy(labels).to(DEV), torch.from_numpy(want).to(DEV),
            bf16=bf16)
        sse, s_seconds, s_launches = counted(
            lambda: -km.score_stream(make_blocks))
        ref = -km.score(x)
        tiles = [list(km.transform_stream(lambda: iter([block0]),
                                          prefetch=p)) for p in (0, 2)]
        t_equal = all(np.array_equal(u, v) for u, v in zip(*tiles))
        del tiles
        counts[label + "_predict"] = {k: v for k, v in p_launches.items()
                                      if v}
        counts[label + "_score"] = {k: v for k, v in s_launches.items() if v}
        emit("stream_infer", model=label, predict_seconds=p_seconds,
             rows_per_second=MAIN["n"] / p_seconds,
             labels_equal_to_predict=equal, labels_differ=differ,
             labels_differ_outside_band=outside, score_stream=sse,
             score=ref, score_rel_diff=abs(sse - ref) / ref,
             score_seconds=s_seconds, transform_prefetch_bit_equal=t_equal,
             predict_launches=counts[label + "_predict"],
             score_launches=counts[label + "_score"])
        check(p_launches["hopper_assign" + suffix] == blocks
              and s_launches["fused_assign_reduce" + suffix] == blocks
              and outside == 0 and abs(sse - ref) <= cmp.SUMS_RTOL * ref
              and t_equal,
              f"stream_infer {label}: launches {p_launches} / "
              f"{s_launches}, {outside} labels outside the band, score "
              f"{sse} against {ref}, transform bit-equal {t_equal}")
    return counts


def phase_stream_init(x, path):
    """Streamed Forgy and streamed k-means|| at k = 1024 over the main
    stream (seconds, kernel 2 launches: none, and blocks x (1 + rounds +
    1)); then STREAM["iters"] epochs from the streamed k-means|| centres,
    whose final SSE (one ``score`` pass) lies within QUALITY_FACTOR of the
    in-memory k-means|| fit's, beside the in-memory k-means++ fit's."""
    blocks = -(-MAIN["n"] // STREAM["rows"])
    make_blocks = iter_npy_blocks(path, STREAM["rows"])
    d, k = MAIN["d"], MAIN["k"]
    (forgy, _), f_seconds, f_launches = counted(
        lambda: seeding.streamed_forgy_init(make_blocks, k, [42], d,
                                            np.float32))
    (par, _), p_seconds, p_launches = counted(
        lambda: seeding.streamed_kmeans_parallel_init(
            make_blocks, k, [42], d, np.float32, mode="kernel"))
    check(f_launches["hopper_assign"] == 0
          and p_launches["hopper_assign"] == blocks * 7
          and len(np.unique(par[0], axis=0)) == k,
          f"stream_init: kernel 2 launches {f_launches['hopper_assign']} "
          f"and {p_launches['hopper_assign']}")
    kw = dict(k=k, max_iter=STREAM["iters"], tolerance=1e-30, seed=42,
              compute_sse=True, verbose=False)
    streamed = KMeans(init=par[0], **kw).fit_stream(make_blocks)
    fits = {"stream_kmeans_parallel": -streamed.score(x)}
    for init in ("k-means||", "k-means++"):
        fits[init] = -KMeans(init=init, **kw).fit(x).score(x)
    ratio = fits["stream_kmeans_parallel"] / fits["k-means||"]
    emit("stream_init", forgy_seconds=f_seconds, forgy_kernel2_launches=0,
         kmeans_parallel_seconds=p_seconds,
         kmeans_parallel_kernel2_launches=p_launches["hopper_assign"],
         final_sse=fits, ratio_to_in_memory_kmeans_parallel=ratio)
    check(1 / QUALITY_FACTOR <= ratio <= QUALITY_FACTOR,
          f"stream_init: final SSE ratio {ratio}")
    return {"stream_init": {k2: v for k2, v in p_launches.items() if v}}


def phase_stream_oversize(x, path, c0):
    """The main file OVERSIZE_REPEATS times over in one epoch (201,326,592
    rows, 96 GiB, more than the card holds): ``fit_stream(max_iter=1)``,
    prefetch 2, 'keep', from ``c0``.  Every row gets the same label in any
    block, so the sums and counts are 96 times the single pass and the
    centroids equal the in-memory one-iteration fit's within ops/compare.py's
    sums rule; kernel 1 launches 8 x 96; the peak allocated memory above
    the baseline under OVERSIZE_PEAK_BYTES."""
    blocks = -(-MAIN["n"] // STREAM["rows"]) * OVERSIZE_REPEATS
    kw = dict(k=MAIN["k"], max_iter=1, seed=42, init=c0,
              empty_cluster="keep")
    mem = KMeans(verbose=False, **kw).fit(x)
    km, seconds, launches, peak = stream_fit(
        repeated_blocks(path, STREAM["rows"], OVERSIZE_REPEATS),
        STREAM["prefetch"], **kw)
    rows = MAIN["n"] * OVERSIZE_REPEATS
    close_ok = cmp.sums_close(torch.from_numpy(km.centroids.astype(
        np.float64)), torch.from_numpy(mem.centroids.astype(np.float64)))
    emit("stream_oversize", repeats=OVERSIZE_REPEATS, rows=rows,
         bytes=rows * MAIN["d"] * 4, blocks=blocks, seconds=seconds,
         gb_per_s=rows * MAIN["d"] * 4 / seconds / 1e9,
         rows_per_s=rows / seconds, peak_allocated_bytes=peak,
         kernel1_launches=launches["fused_assign_reduce"],
         max_centroid_diff=float(np.abs(km.centroids.astype(np.float64)
                                        - mem.centroids).max()),
         centroids_within_sums_rule=close_ok)
    check(launches["fused_assign_reduce"] == blocks and close_ok
          and peak < OVERSIZE_PEAK_BYTES,
          f"stream_oversize: launches {launches}, centroids close "
          f"{close_ok}, peak {peak}")
    return {"stream_oversize": {k: v for k, v in launches.items() if v}}


def phase_gmm_stream(x_gmm, tmp):
    """The mixture data as a stream (8 blocks), 'diag', float32,
    GMM["iters"] EM epochs from the same ``means_init`` as an in-memory
    host-loop fit: the lower bound within STREAM_GMM_LL_RTOL, prefetch 0
    and 2 bit-identical, ``diag_estep`` once per block of the hard epoch
    and of each EM epoch; then 'full' at FULL's shape, 3 epochs, against
    its in-memory fit."""
    path = npy_of(x_gmm, tmp / "gmm.npy")
    blocks = -(-GMM["n"] // STREAM["rows"])
    gen = torch.Generator(device=DEV).manual_seed(23)
    pick = torch.randperm(GMM["n"], generator=gen, device=DEV)[:GMM["k"]]
    means0 = x_gmm[pick].double().cpu().numpy()
    kw = dict(n_components=GMM["k"], max_iter=GMM["iters"], tol=0.0,
              means_init=means0)
    mem = GaussianMixture(**kw).fit(x_gmm)
    fits, counts = {}, {}
    for prefetch in (0, STREAM["prefetch"]):
        gm = GaussianMixture(**kw)
        gm, seconds, launches = counted(lambda: gm.fit_stream(
            iter_npy_blocks(path, STREAM["rows"]), prefetch=prefetch))
        fits[prefetch] = gm
        counts[f"gmm_stream_p{prefetch}"] = {k: v for k, v in
                                             launches.items() if v}
        want = blocks * (1 + GMM["iters"])
        rel = abs(gm.lower_bound_ - mem.lower_bound_) / abs(mem.lower_bound_)
        emit("gmm_stream", covariance_type="diag", prefetch=prefetch,
             fit_seconds=seconds, seconds_per_epoch=gm.iter_times_,
             lower_bound=gm.lower_bound_, memory_lower_bound=mem.lower_bound_,
             rel_diff=rel, estep_path=gm.estep_path_,
             diag_estep_launches=launches["diag_estep"],
             expected_diag_estep_launches=want,
             memory_seconds_per_iteration=statistics.median(mem.iter_times_))
        check(launches["diag_estep"] == want and rel <= STREAM_GMM_LL_RTOL,
              f"gmm_stream p{prefetch}: {launches['diag_estep']} launches "
              f"(want {want}), lower bound {rel} from the in-memory fit")
    check(same_mixture(fits[0], fits[STREAM["prefetch"]]),
          "gmm_stream: prefetch 0 and 2 not bit-identical")

    x_full = full_data()
    path_full = npy_of(x_full, tmp / "full.npy")
    km = KMeans(k=FULL["k"], max_iter=5, seed=3, verbose=False).fit(x_full)
    kw = dict(n_components=FULL["k"], covariance_type="full",
              max_iter=STREAM_FULL["iters"], tol=0.0,
              means_init=km.centroids.astype(np.float64))
    mem = GaussianMixture(**kw).fit(x_full)
    gm = GaussianMixture(**kw)
    gm, seconds, launches = counted(lambda: gm.fit_stream(
        iter_npy_blocks(path_full, STREAM_FULL["rows"])))
    rel = abs(gm.lower_bound_ - mem.lower_bound_) / abs(mem.lower_bound_)
    emit("gmm_stream", covariance_type="full", n=FULL["n"], d=FULL["d"],
         k=FULL["k"], fit_seconds=seconds, seconds_per_epoch=gm.iter_times_,
         lower_bound=gm.lower_bound_, memory_lower_bound=mem.lower_bound_,
         rel_diff=rel,
         memory_seconds_per_iteration=statistics.median(mem.iter_times_))
    check(rel <= STREAM_GMM_LL_RTOL and gm.n_iter_ == mem.n_iter_,
          f"gmm_stream full: lower bound {rel} from the in-memory fit")
    return counts


def phase_stream_faults(path, c0, ref, tmp):
    """On the main stream: one ``OSError`` injected into the read of block
    3, ``io_retries=2``: bit-identical to the clean stream ``ref`` (phase
    ``stream``), ``io_retries_used_ == 1``; a NaN block: 'error' names it,
    'skip' counts it (one epoch); ``checkpoint_every=2`` killed after epoch
    4 and resumed from its path: bit-identical to ``ref``."""
    make_blocks = iter_npy_blocks(path, STREAM["rows"])
    kw = dict(k=MAIN["k"], max_iter=STREAM["iters"], tolerance=1e-30,
              seed=42, compute_sse=True, init=c0, empty_cluster="keep",
              verbose=False)
    flaky = faults.flaky_blocks(make_blocks, fail_block=3, fail_times=1)
    km, seconds, launches = counted(lambda: KMeans(**kw).fit_stream(
        flaky, io_retries=2, io_backoff=0.0))
    retried = same_fit(km, ref) and km.io_retries_used_ == 1
    poisoned = faults.poison_blocks(make_blocks, block=2)
    try:
        KMeans(**dict(kw, max_iter=1)).fit_stream(poisoned)
        named = False
    except ValueError as e:
        named = "streamed block 2" in str(e)
    skipped = KMeans(**dict(kw, max_iter=1)).fit_stream(
        poisoned, on_nonfinite="skip")
    ck = tmp / "stream_ck"
    killed_launches = killed(lambda: KMeans(**kw).fit_stream(
        make_blocks, checkpoint_every=2, checkpoint_path=ck), 4,
        "stream_faults")
    resumed, r_seconds, r_launches = counted(lambda: KMeans(**kw).fit_stream(
        make_blocks, resume=ck, checkpoint_every=2, checkpoint_path=ck))
    blocks = -(-MAIN["n"] // STREAM["rows"])
    emit("stream_faults", retried_bit_identical=retried,
         io_retries_used=km.io_retries_used_, retried_seconds=seconds,
         nan_block_named=named, blocks_skipped=skipped.blocks_skipped_,
         killed_kernel1_launches=killed_launches["fused_assign_reduce"],
         resumed_kernel1_launches=r_launches["fused_assign_reduce"],
         resumed_bit_identical=same_fit(resumed, ref),
         resumed_seconds=r_seconds)
    check(retried and named and skipped.blocks_skipped_ == 1
          and same_fit(resumed, ref)
          and killed_launches["fused_assign_reduce"] == 4 * blocks
          and r_launches["fused_assign_reduce"] == blocks,
          "stream_faults: a recovery is not bit-identical or not counted")
    return {"stream_faults": {k: v for k, v in launches.items() if v}}


def phase_stream_spherical(x_glove, tmp):
    """The GloVe-like data as a stream of STREAM_GLOVE_ROWS-row blocks,
    normalised block by block, ``SphericalKMeans.fit_stream`` at k = 3000,
    SPHERE_ITERS epochs, against the in-memory fit from the same init
    (iterations equal, final SSE within DEVICE_SSE_RTOL, every label that
    differs explained as in phase ``stream``); kernel 1 once per block and
    epoch."""
    path = npy_of(x_glove, tmp / "glove.npy")
    blocks = -(-SECOND["n"] // STREAM_GLOVE_ROWS)
    gen = torch.Generator(device=DEV).manual_seed(24)
    pick = torch.randperm(SECOND["n"], generator=gen, device=DEV)
    c0 = x_glove[pick[:SECOND["k"]]].cpu().numpy()
    kw = dict(k=SECOND["k"], max_iter=SPHERE_ITERS, tolerance=1e-30,
              seed=42, compute_sse=True, init=c0, empty_cluster="keep",
              verbose=False)
    mem = SphericalKMeans(**kw).fit(x_glove)
    km = SphericalKMeans(**kw)
    km, seconds, launches = counted(lambda: km.fit_stream(
        iter_npy_blocks(path, STREAM_GLOVE_ROWS)))
    rel = abs(km.sse_history[-1] - mem.sse_history[-1]) / mem.sse_history[-1]
    differ, outside, unexplained = labels_outside_band(
        km.cache(x_glove).points, km.centroids, mem.centroids)
    emit("stream_spherical", blocks=blocks, iterations=km.iterations_run,
         final_sse_rel_diff=rel, labels_differ=differ,
         labels_differ_outside_band=outside,
         labels_differ_unexplained=unexplained, fit_seconds=seconds,
         seconds_per_epoch=km.iter_times_,
         kernel1_launches=launches["fused_assign_reduce"])
    check(km.iterations_run == mem.iterations_run and rel <= DEVICE_SSE_RTOL
          and unexplained == 0
          and launches["fused_assign_reduce"] == blocks * SPHERE_ITERS,
          f"stream_spherical: iterations {km.iterations_run} / "
          f"{mem.iterations_run}, SSE {rel}, {unexplained} unexplained, "
          f"launches {launches}")
    return {"stream_spherical": {k: v for k, v in launches.items() if v}}


def phase_streams(x, x_gmm, x_glove, c0, tmp):
    """Every stream phase; the main file stays for ``dp_world1``.  Returns
    the launches by path and ``(path, the prefetch-2 float32 stream fit)``,
    the reference of ``dp_world1``'s streamed fit."""
    path, ref, ref16, counts = phase_stream(x, c0, tmp)
    counts.update(phase_stream_infer(x, path, {"stream": ref,
                                               "stream_bf16": ref16}))
    counts.update(phase_stream_init(x, path))
    counts.update(phase_stream_oversize(x, path, c0))
    counts.update(phase_gmm_stream(x_gmm, tmp))
    counts.update(phase_stream_faults(path, c0, ref, tmp))
    counts.update(phase_stream_spherical(x_glove, tmp))
    for name in ("gmm.npy", "full.npy", "glove.npy"):
        (tmp / name).unlink()
    return counts, (path, c0, ref)


def _dp_world1_stream(mesh, path, c0, ref):
    """The float32 stream of phase ``stream`` on the one-rank NCCL mesh (the
    statistics' packed SUM an NCCL ``all_reduce`` per block), prefetch 2,
    bit for bit against the one-device stream ``ref``; kernel 1 once per
    block and epoch."""
    blocks = -(-MAIN["n"] // STREAM["rows"])
    km = KMeans(k=MAIN["k"], max_iter=STREAM["iters"], tolerance=1e-30,
                seed=42, compute_sse=True, init=c0, empty_cluster="keep",
                verbose=False, mesh=mesh)
    km, seconds, launches = counted(lambda: km.fit_stream(
        iter_npy_blocks(path, STREAM["rows"]), prefetch=STREAM["prefetch"]))
    launches = {k: v for k, v in launches.items() if v}
    emit("dp_world1", model="KMeans", stream=True,
         bit_identical=same_fit(km, ref), fit_seconds=seconds,
         seconds_per_epoch=km.iter_times_,
         one_device_seconds_per_epoch=ref.iter_times_, launches=launches)
    check(same_fit(km, ref)
          and launches.get("fused_assign_reduce", 0)
          == blocks * STREAM["iters"],
          f"dp_world1 stream: not bit-identical to one device, or "
          f"launches {launches}")
    return launches


# ---------------------------------------------- ingest and the massive k

# Phase ingest: the main data's .npy file (written by phase stream) read on
# a world-1 NCCL mesh by 'mono' and by 'slab', INGEST_REPS times each,
# interleaved.  Phase synthetic: device_shards at the main shape (blobs
# around SYNTH["k"] centres), held to host_equivalent on a prefix of
# SYNTH["prefix"] rows, then a KMeans fit on it.  Phase large_k: the main
# data at LARGE_K["k"] clusters, the two-level route (LARGE_K["cells"]
# coarse cells, LARGE_K["nprobe"] probes), its collapse case (every cell
# probed) against the dense 'matmul' fit, and the dense kernel fit;
# k_shard at KSHARD["k"] inside dp_shared_card.
INGEST_REPS = 3
SYNTH = dict(k=1024, iters=5, prefix=65_536, seed=11)
LARGE_K = dict(k=16_384, cells=128, nprobe=16, iters=3, collapse_iters=2)
LARGE_K_SSE_RTOL = 1e-6
KSHARD = dict(k=4096, iters=3)


def allocated_peak(fn, resident_bytes: int = 0):
    """``(fn(), peak bytes)``: the most allocated on the card while ``fn``
    ran, above what was allocated before it, plus ``resident_bytes`` that
    it uses but that were allocated before (a dataset's rows)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    base = torch.cuda.memory_allocated(DEV)
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated(DEV) - base + resident_bytes


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(
        a.view(torch.int32 if a.element_size() == 4 else torch.int64),
        b.view(torch.int32 if b.element_size() == 4 else torch.int64)))


def _dp_world1_ingest(mesh, path: Path, c0):
    """``data.io.from_npy`` of the main data's file (1 GiB, warm in the page
    cache: phase stream wrote and read it) on the one-rank NCCL mesh by
    'mono' (one host array, one copy) and by 'slab' (64 MiB slabs through
    the pinned ring, each slab's copy overlapping the next slab's host
    read), INGEST_REPS times each, interleaved: the placements byte for
    byte, median seconds and GB/s of each, the ratio mono/slab (the bar
    for 'auto' to take slab is 1.2), the slabs, and the peak allocated
    above the baseline.  Then a fit from c0 on each placement, bit for
    bit, kernel 1 once per iteration."""
    from kmeans_tpu_torch.data import io as pio
    from kmeans_tpu_torch.parallel.sharding import resolve_ingest
    nbytes = path.stat().st_size
    times = {"mono": [], "slab": []}
    peaks = {"mono": [], "slab": []}
    slabs = {}
    ref = None
    for _ in range(INGEST_REPS):
        for mode in ("mono", "slab"):
            t0 = time.perf_counter()
            ds, peak = allocated_peak(lambda: pio.from_npy(
                path, mesh, ingest=mode))
            times[mode].append(time.perf_counter() - t0)
            peaks[mode].append(peak)
            slabs[mode] = ds.slabs
            if ref is None:
                ref = ds
                continue
            check(same_bytes(ds.points, ref.points)
                  and same_bytes(ds.weights, ref.weights)
                  and (ds.offset, ds.local_rows) == (ref.offset,
                                                     ref.local_rows),
                  f"ingest: the {mode} placement differs from mono's")
            del ds
    med = {mode: statistics.median(t) for mode, t in times.items()}
    fits, counts = {}, {}
    for mode in ("mono", "slab"):
        ds = ref if mode == "mono" else pio.from_npy(path, mesh,
                                                     ingest="slab")
        km = KMeans(k=MAIN["k"], max_iter=2, tolerance=1e-30,
                    compute_sse=True, init=c0, verbose=False,
                    compute_labels=False, mesh=mesh)
        fits[mode], _, launches = counted(lambda: km.fit(ds))
        counts[f"dp_world1:ingest:{mode}"] = {
            k: v for k, v in launches.items() if v}
        check(launches["fused_assign_reduce"] == km.iterations_run == 2,
              f"ingest {mode} fit: launches {launches}")
    check(same_fit(fits["mono"], fits["slab"]),
          "ingest: the fits on the two placements differ")
    emit("ingest", rows=MAIN["n"], d=MAIN["d"], bytes=nbytes,
         warm_page_cache=True, reps=INGEST_REPS, seconds=times,
         median_seconds=med,
         gb_per_s={mode: nbytes / t / 1e9 for mode, t in med.items()},
         ratio_mono_over_slab=med["mono"] / med["slab"], adopt_bar=1.2,
         auto_resolves_to=resolve_ingest("auto"), slabs=slabs,
         peak_allocated_above_baseline=peaks, byte_identical=True,
         fits_bit_identical=True, launches=counts)
    return counts


def phase_synthetic():
    """``data.synthetic.device_shards`` at the main shape on the card
    (blobs around SYNTH["k"] centres): its seconds, the rows of its first
    SYNTH["prefix"] against ``host_equivalent`` (made on the CPU) bit for
    bit, no host copy; then ``KMeans(k=SYNTH["k"])`` for SYNTH["iters"]
    iterations on it, kernel 1 once per iteration."""
    from kmeans_tpu_torch.data import synthetic
    n, d = MAIN["n"], MAIN["d"]
    centers = np.random.default_rng(SYNTH["seed"]).uniform(
        -10.0, 10.0, size=(SYNTH["k"], d)).astype(np.float32)
    ds, seconds, _ = counted(lambda: synthetic.device_shards(
        n, d, kind="blobs", seed=SYNTH["seed"], centers=centers))
    t0 = time.perf_counter()
    host = synthetic.host_equivalent(SYNTH["prefix"], d, kind="blobs",
                                     seed=SYNTH["seed"], centers=centers)
    host_seconds = time.perf_counter() - t0
    equal = host.tobytes() == \
        ds.points[: SYNTH["prefix"]].cpu().numpy().tobytes()
    check(equal and ds.host is None and ds.n == n
          and bool((ds.weights == 1).all()),
          "synthetic: device_shards differs from host_equivalent")
    km = KMeans(k=SYNTH["k"], max_iter=SYNTH["iters"], tolerance=1e-30,
                seed=42, compute_sse=True, init="forgy", verbose=False,
                compute_labels=False)
    _, fit_seconds, launches = counted(lambda: km.fit(ds))
    launches = {k: v for k, v in launches.items() if v}
    check(launches.get("fused_assign_reduce", 0) == km.iterations_run
          == SYNTH["iters"] and largest_rise(km.sse_history) <= 1e-6,
          f"synthetic fit: launches {launches}, SSE {km.sse_history}")
    emit("synthetic", rows=n, d=d, kind="blobs", centres=SYNTH["k"],
         device_shards_seconds=seconds, gb_per_s=n * d * 4 / seconds / 1e9,
         prefix_rows=SYNTH["prefix"], prefix_bit_identical=equal,
         host_equivalent_seconds=host_seconds,
         fit_iterations=km.iterations_run, sse_history=km.sse_history,
         seconds_per_iteration=statistics.median(km.iter_times_),
         fit_seconds=fit_seconds, launches=launches)
    return {"synthetic": launches}


def phase_large_k(x):
    """The main data at k = LARGE_K["k"] from one table of rows: the
    two-level route (LARGE_K["cells"] cells, LARGE_K["nprobe"] probes,
    'auto' read as 'matmul' by the mode rule; its coarse quantizer trained
    through kernel 1), the dense kernel fit (kernel 1 per iteration), and
    the collapse case (every cell probed) against the dense 'matmul' fit:
    SSE ratio within LARGE_K_SSE_RTOL, and at the dense fit's centroids
    the two-level labels equal the dense labels outside the band of
    ops/compare.py.  Seconds per iteration of each, and each fit's peak
    allocated bytes against obs.memory.plan_fit's prediction."""
    from kmeans_tpu_torch.obs import memory
    n, d, k = MAIN["n"], MAIN["d"], LARGE_K["k"]
    gen = torch.Generator(device=DEV).manual_seed(3)
    c0 = x[torch.randperm(n, generator=gen, device=DEV)[:k]].cpu().numpy()
    rows_bytes = x.numel() * x.element_size()
    base_kw = dict(k=k, tolerance=1e-30, compute_sse=True, init=c0,
                   verbose=False, compute_labels=False, host_loop=True)
    runs = {
        "two_level": dict(assign="two_level", coarse_cells=LARGE_K["cells"],
                          nprobe=LARGE_K["nprobe"],
                          max_iter=LARGE_K["iters"]),
        "dense_kernel": dict(assign="dense", distance_mode="kernel",
                             max_iter=LARGE_K["iters"]),
        "collapse": dict(assign="two_level", coarse_cells=LARGE_K["cells"],
                         nprobe=LARGE_K["cells"],
                         max_iter=LARGE_K["collapse_iters"]),
        "dense_matmul": dict(assign="dense", distance_mode="matmul",
                             max_iter=LARGE_K["collapse_iters"]),
    }
    models, counts = {}, {}
    for name, kw in runs.items():
        km = KMeans(**base_kw, **kw)
        (_, seconds, launches), peak = allocated_peak(
            lambda: counted(lambda: km.fit(x)), rows_bytes)
        launches = {k_: v for k_, v in launches.items() if v}
        counts[f"large_k:{name}"] = launches
        ds = km.cache(x)
        two = km.assign == "two_level"
        mode = km._large_k_mode() if two else km._mode()
        if two:
            L = km._two_level_route_[1].shape[1]
            plan = memory.plan_fit(
                "kmeans", n, d, k, mode=mode, assign="two_level",
                coarse_cells=LARGE_K["cells"], nprobe=kw["nprobe"],
                member_width=L, chunk=km._two_level_chunk(
                    ds, LARGE_K["cells"], L, kw["nprobe"]), device=DEV)
            k1 = launches.get("fused_assign_reduce", 0)
            check(mode == "matmul" and km.estep_path_ == "serial"
                  and 1 <= k1 <= 25,
                  f"large_k {name}: mode {mode}, {km.estep_path_}, "
                  f"kernel 1 launched {k1} times in the coarse training")
        else:
            plan = memory.plan_fit("kmeans", n, d, k, mode=mode,
                                   chunk=km._chunk_for(ds), device=DEV)
            want = km.iterations_run if mode == "kernel" else 0
            check(launches.get("fused_assign_reduce", 0) == want,
                  f"large_k {name}: launches {launches}")
        del ds
        check(km.iterations_run == kw["max_iter"]
              and largest_rise(km.sse_history) <= 1e-6
              and np.all(np.isfinite(km.centroids)),
              f"large_k {name}: {km.iterations_run} iterations, SSE "
              f"{km.sse_history}")
        models[name] = km
        emit("large_k", run=name, k=k, distance_mode=mode,
             assign=km.assign_resolved_,
             coarse_cells=kw.get("coarse_cells"), nprobe=kw.get("nprobe"),
             member_width=km._two_level_route_[1].shape[1] if two else None,
             iterations=km.iterations_run, sse_history=km.sse_history,
             seconds_per_iteration=statistics.median(km.iter_times_),
             iter_times=km.iter_times_, fit_seconds=seconds,
             peak_allocated_bytes=peak,
             predicted_peak_bytes=plan["predicted_peak_bytes"],
             predicted_over_measured=plan["predicted_peak_bytes"] / peak,
             plan_components=plan["components"], launches=launches)
    ratio = [a / b for a, b in zip(models["collapse"].sse_history,
                                   models["dense_matmul"].sse_history)]
    dense = models["dense_matmul"]
    cents = torch.from_numpy(dense.centroids).to(DEV)
    coarse = models["collapse"]._two_level_route_[0]
    members = dense._build_members(dense.centroids.astype(np.float64),
                                   coarse)
    chunk = dense._two_level_chunk(dense.cache(x), LARGE_K["cells"],
                                   members.shape[1], LARGE_K["cells"])
    labels_two = dist.make_two_level_predict_fn(
        None, chunk_size=chunk, nprobe=LARGE_K["cells"], mode="matmul")(
        x, cents, coarse, members)
    labels_dense = dist.make_predict_fn(
        None, chunk_size=dense._chunk_for(dense.cache(x)), mode="matmul")(
        x, cents)
    n_diff, n_out = label_band(x, cents, labels_two, labels_dense)
    emit("large_k_collapse", k=k, sse_ratio=ratio, labels_differ=n_diff,
         labels_outside_band=n_out,
         seconds_per_iteration={name: statistics.median(m.iter_times_)
                                for name, m in models.items()})
    check(all(abs(r - 1.0) <= LARGE_K_SSE_RTOL for r in ratio),
          f"large_k collapse: SSE ratio {ratio}")
    check(n_out == 0, f"large_k collapse: {n_out} labels outside the band")
    return counts


# ------------------------------------------------ product quantizer, serving

PQ = dict(m=8, k=256, iters=10, rows=262_144, queries=4096)
#: Bucket shapes of the serving engine (``serving.batching.DEFAULT_BUCKETS``)
#: and the single request past the top bucket.
SERVE_BUCKETS = (8, 64, 512, 4096)
SERVE_BIG = 10_000
SERVE_CALLS = 200
SERVE_WARM_CALLS = 20
PACKED_MODELS = 4
QUEUE_THREADS = 4
QUEUE_REQUESTS = 100
QUEUE_TIMEOUT = 120.0


def phase_pq(x, km):
    """``ProductQuantizer(m=8, k=256)`` on the main data: seconds per
    iteration and the peak allocated bytes beside ``plan_``; every member
    bit-equal to a standalone device-loop ``KMeans`` of its subspace with
    the member's seed; ``encode`` and ``decode`` of PQ["rows"] rows; and
    ``adc_assign`` of 4096 queries against a ``for_table`` compression of
    the main fit's k = 1024 table, its labels equal to the float64 argmin
    over the decoded table.  No kernel is on the quantizer's path (the
    fits run 'matmul', as in the JAX package)."""
    host = x.cpu().numpy()
    m, k, iters = PQ["m"], PQ["k"], PQ["iters"]
    check(default_subspaces(host.shape[1]) == m, "default_subspaces(128)")
    hk.reset_launch_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pq = ProductQuantizer(m=m, k=k, max_iter=iters, tolerance=1e-4,
                          seed=3, device=DEV).fit(host)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    kernel_launches = {n: c for n, c in hk.LAUNCHES.items() if c}
    check(not kernel_launches, f"pq fit launched kernels: {kernel_launches}")
    d_sub = host.shape[1] // m
    seeds = pq._member_seeds(m)
    same, alone_s = [], []
    for j in range(m):
        sub = np.ascontiguousarray(host[:, j * d_sub:(j + 1) * d_sub])
        t1 = time.perf_counter()
        alone = KMeans(k=k, max_iter=iters, tolerance=1e-4, seed=seeds[j],
                       init="k-means++", empty_cluster="keep",
                       distance_mode="matmul", host_loop=False,
                       verbose=False).fit(sub)
        alone_s.append((time.perf_counter() - t1) / alone.iterations_run)
        same.append(bool(np.array_equal(alone.centroids, pq.codebooks_[j]))
                    and alone.iterations_run == int(pq.n_iters_[j]))
    check(all(same), f"pq: members against standalone fits {same}")
    rows = host[:PQ["rows"]]
    t1 = time.perf_counter()
    codes = pq.encode(rows)
    encode_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    dec = pq.decode(codes)
    decode_s = time.perf_counter() - t1
    check(codes.shape == (PQ["rows"], m) and codes.dtype == np.uint8
          and dec.shape == rows.shape, f"pq: codes {codes.shape}")
    probe = rows[:16_384].astype(np.float64)
    for j in (0, m - 1):
        cb = pq.codebooks_[j].astype(np.float64)
        sj = probe[:, j * d_sub:(j + 1) * d_sub]
        d2 = ((sj * sj).sum(1)[:, None] - 2.0 * sj @ cb.T
              + (cb * cb).sum(1)[None, :])
        check(bool(np.array_equal(codes[:16_384, j], d2.argmin(1))),
              f"pq: encode of subspace {j} against a float64 argmin")
    rel_mse = float(((dec - rows) ** 2).sum() / (rows.astype(np.float64)
                                                 ** 2).sum())
    t1 = time.perf_counter()
    tpq, tcodes = ProductQuantizer.for_table(km.centroids, seed=0,
                                             device=DEV)
    table_s = time.perf_counter() - t1
    queries = host[-PQ["queries"]:]
    t1 = time.perf_counter()
    labels, corrected = tpq.adc_assign(queries, tcodes)
    adc_s = time.perf_counter() - t1
    q = torch.from_numpy(queries).to(DEV).double()
    decoded = torch.from_numpy(tpq.decode(tcodes)).to(DEV)
    exact = torch.argmin((q * q).sum(1)[:, None] - 2.0 * q @ decoded.T
                         + (decoded * decoded).sum(1)[None, :], dim=1)
    check(bool(np.array_equal(labels, exact.cpu().numpy())),
          "pq: ADC labels differ from the decoded-table argmin")
    emit("pq", n=host.shape[0], d=host.shape[1], m=m, k=k, max_iter=iters,
         n_iters=pq.n_iters_.tolist(), fit_seconds=fit_s,
         seconds_per_iteration=fit_s / int(pq.n_iters_.max()),
         standalone_seconds_per_iteration=alone_s,
         members_bit_equal_to_standalone=same,
         peak_allocated_bytes=peak,
         plan_predicted_peak_bytes=pq.plan_["predicted_peak_bytes"],
         subspace_inertias=pq.subspace_inertias_.tolist(),
         encode_rows=PQ["rows"], encode_seconds=encode_s,
         decode_seconds=decode_s, reconstruction_rel_sq_err=rel_mse,
         compression_ratio=pq.compression_ratio(),
         table_k=int(km.centroids.shape[0]), table_pq_m=tpq.m_,
         table_pq_k=tpq.k, table_fit_seconds=table_s,
         adc_queries=PQ["queries"], adc_seconds=adc_s,
         adc_corrected=corrected, adc_labels_equal_decoded_argmin=True,
         launches=kernel_launches)


def _serve_rows(x):
    """Request rows as the engine receives them: host float32 arrays."""
    return x[:max(SERVE_BUCKETS[-1], SERVE_BIG) + 4096].cpu().numpy()


def _latency(fn, calls=SERVE_CALLS, warm=SERVE_WARM_CALLS):
    """(p50 ms, p99 ms) of ``calls`` host-timed calls after ``warm``."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return (statistics.median(times),
            times[min(len(times) - 1, math.ceil(0.99 * len(times)) - 1)])


def _counted(name: str) -> int:
    return int(hk.LAUNCHES.get(name, 0))


def phase_serving(x, km):
    """The main float32 model (k = 1024, 'auto', so kernel 2) resident in
    a ``ServingEngine`` on the card: ``call`` at every bucket and with one
    10,000-row request, labels bit-equal to ``model.predict``; kernel 2
    launched once per dispatch (counters zeroed after the warm-up, read
    at the end of the path); ``score_rows`` against kernel 2's ``mind2``
    within ``ops/compare.py``; ``transform`` against float64 distances;
    p50 and p99 per bucket over SERVE_CALLS calls; monitoring on against
    off (labels bit-equal, the time ratio); staging reuse off
    (``donate=False``, rows placed anew per dispatch) beside on, labels
    bit-equal.  Returns the path's counts."""
    host = _serve_rows(x)
    c = torch.from_numpy(km.centroids).to(DEV)
    sizes = SERVE_BUCKETS + (SERVE_BIG,)
    want = {m: km.predict(host[:m]) for m in sizes}
    ref_mind2 = hk.assign_reference(x[:SERVE_BUCKETS[-1]], c)[1]
    eng = ServingEngine(device=DEV, start=False, quality=False)
    eng_q = ServingEngine(device=DEV, start=False, quality=True)
    # Staging reuse off: every dispatch places its rows anew.
    eng_nd = ServingEngine(device=DEV, start=False, quality=False,
                           donate=False)
    try:
        for e in (eng, eng_q, eng_nd):
            e.add_model("main", km)
            e.warmup()
        check(eng._donate and eng_q._quality and not eng_nd._donate,
              "serving: 'auto' on the card")
        hk.reset_launch_counts()
        for m in sizes:
            got = eng.call("main", host[:m])
            check(bool(np.array_equal(got, want[m])),
                  f"serving: {m} rows differ from model.predict")
        check(_counted("hopper_assign") == eng.dispatches == len(sizes),
              f"serving: kernel 2 launched {_counted('hopper_assign')} "
              f"times for {eng.dispatches} dispatches")
        mind2 = eng.call("main", host[:SERVE_BUCKETS[-1]], op="score_rows")
        got2 = torch.from_numpy(mind2).to(DEV)
        check(cmp.close(got2, ref_mind2, cmp.MIND2_RTOL,
                        cmp.mind2_atol(x[:SERVE_BUCKETS[-1]], c)),
              "serving: score_rows against kernel 2's mind2")
        rows_t = x[:512].double()
        tile = torch.from_numpy(eng.call("main", host[:512],
                                         op="transform")).to(DEV).double()
        c64 = c.double()
        ref_t = torch.clamp_min((rows_t * rows_t).sum(1)[:, None]
                                + (c64 * c64).sum(1)[None, :]
                                - 2.0 * rows_t @ c64.T, 0.0)
        check(cmp.close(tile ** 2, ref_t, cmp.MIND2_RTOL,
                        cmp.mind2_atol(x[:512], c)),
              "serving: transform against float64 distances")
        latency = {}
        for m in sizes:
            rows = host[:m]
            p50, p99 = _latency(lambda: eng.call("main", rows))
            q50, q99 = _latency(lambda: eng_q.call("main", rows))
            n50, n99 = _latency(lambda: eng_nd.call("main", rows))
            check(bool(np.array_equal(eng_q.call("main", rows), want[m])),
                  f"serving: quality on changed the labels at {m} rows")
            check(bool(np.array_equal(eng_nd.call("main", rows), want[m])),
                  f"serving: donate=False changed the labels at {m} rows")
            latency[str(m)] = {"p50_ms": p50, "p99_ms": p99,
                               "rows_per_s": m / (p50 / 1e3),
                               "quality_on_p50_ms": q50,
                               "quality_on_p99_ms": q99,
                               "quality_time_ratio": q50 / p50,
                               "donate_off_p50_ms": n50,
                               "donate_off_p99_ms": n99}
        # Every dispatch but the one transform launches kernel 2 once.
        dispatches = eng.dispatches + eng_q.dispatches + eng_nd.dispatches \
            - 1
        launched = _counted("hopper_assign")
        check(launched == dispatches,
              f"serving: kernel 2 launched {launched} times for "
              f"{dispatches} dispatches")
        counts = {k: v for k, v in hk.LAUNCHES.items() if v}
        stats = eng.stats()
        emit("serving", k=int(km.k), d=int(km.centroids.shape[1]),
             mode=km._mode(), buckets=list(SERVE_BUCKETS),
             big_request_rows=SERVE_BIG, calls_per_bucket=SERVE_CALLS,
             labels_bit_equal=True, dispatches=dispatches,
             kernel2_launches=launched, latency=latency,
             score_rows_err=max_err(got2, ref_mind2),
             program_memory=stats["program_memory"],
             quality_status=eng_q.quality_status()["main"], launches=counts)
        return counts
    finally:
        eng.close()
        eng_q.close()
        eng_nd.close()


def phase_serving_bf16(x, km, km_bf16):
    """``quantize='bf16'`` on the main float32 model (labels bit-equal to
    its float32 ``predict``, the corrected rows, ``verify_quantized``),
    then the main bf16 model served in 'kernel_bf16': kernel 2b once per
    dispatch."""
    host = _serve_rows(x)
    sizes = SERVE_BUCKETS + (SERVE_BIG,)
    want = {m: km.predict(host[:m]) for m in sizes}
    want_b = {m: km_bf16.predict(host[:m]) for m in sizes}
    eng = ServingEngine(device=DEV, start=False, quality=False)
    try:
        rm = eng.add_model("q", km, quantize="bf16")
        eng.add_model("b", km_bf16)
        check(km_bf16._mode() == "kernel_bf16", "the bf16 model's mode")
        hk.reset_launch_counts()
        flagged = 0                   # dispatches whose guard flagged rows
        for m in sizes:
            before_rows = rm.bf16_corrected_rows
            check(bool(np.array_equal(eng.call("q", host[:m]), want[m])),
                  f"serving_bf16: quantized labels at {m} rows")
            flagged += rm.bf16_corrected_rows > before_rows
        fixups = _counted("hopper_assign")
        # Each dispatch with flagged rows relabels them in one float32
        # predict, one launch of kernel 2; the others launch none.
        check(fixups == flagged,
              f"serving_bf16: kernel 2 launched {fixups} times for "
              f"{flagged} dispatches with flagged rows")
        report = eng.verify_quantized("q", host[:SERVE_BUCKETS[-1]])
        check(report["labels_equal"], f"verify_quantized: {report}")
        before = eng.dispatches
        hk.reset_launch_counts()
        for m in sizes:
            check(bool(np.array_equal(eng.call("b", host[:m]), want_b[m])),
                  f"serving_bf16: kernel_bf16 labels at {m} rows")
        dispatched = eng.dispatches - before
        launched_2b = _counted("hopper_assign_bf16")
        check(launched_2b == dispatched and _counted("hopper_assign") == 0,
              f"serving_bf16: kernel 2b launched {launched_2b} times for "
              f"{dispatched} dispatches")
        counts = {k: v for k, v in hk.LAUNCHES.items() if v}
        counts["hopper_assign"] = fixups
        corrected = rm.bf16_corrected_rows
        p50, p99 = _latency(lambda: eng.call("b", host[:4096]), calls=50)
        q50, q99 = _latency(lambda: eng.call("q", host[:4096]), calls=50)
        emit("serving_bf16", corrected_rows=corrected,
             quantized_rows=sum(sizes),
             guard_fixup_kernel2_launches=fixups,
             guard_flagged_dispatches=flagged, verify=report,
             kernel_bf16_dispatches=dispatched,
             kernel2b_launches=launched_2b,
             kernel_bf16_4096_p50_ms=p50, kernel_bf16_4096_p99_ms=p99,
             quantized_4096_p50_ms=q50, quantized_4096_p99_ms=q99,
             launches=counts)
        return counts
    finally:
        eng.close()


def phase_serving_packed(x, km):
    """Four k = 1024 models of one shape (the main table, shifted) in one
    ``predict_multi``: equal to each model's sequential ``predict``, in
    one packed dispatch.  The models are 'matmul': the pack takes the
    matmul form of every mode (``make_multi_predict_fn``)."""
    host = _serve_rows(x)
    models = []
    for j in range(PACKED_MODELS):
        mj = KMeans(k=km.k, distance_mode="matmul", verbose=False)
        mj.centroids = (km.centroids + np.float32(0.05 * j)).astype(
            np.float32)
        models.append(mj)
    reqs = [(f"m{j}", host[j * 1000:(j + 1) * 1000])
            for j in range(PACKED_MODELS)]
    want = [models[j].predict(rows) for j, (_, rows) in enumerate(reqs)]
    eng = ServingEngine(device=DEV, start=False, quality=False)
    try:
        for j, mj in enumerate(models):
            eng.add_model(f"m{j}", mj)
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        outs = eng.predict_multi(reqs)
        packed_s = time.perf_counter() - t0
        same = [bool(np.array_equal(o, w)) for o, w in zip(outs, want)]
        check(all(same) and eng.packed_dispatches == 1
              and eng.dispatches == 1,
              f"serving_packed: {same}, {eng.packed_dispatches} packed")
        p50, p99 = _latency(lambda: eng.predict_multi(reqs), calls=50)
        s50, s99 = _latency(lambda: [eng.call(mid, rows)
                                     for mid, rows in reqs], calls=50)
        emit("serving_packed", models=PACKED_MODELS, rows=4000,
             equal_to_sequential=same, packed_dispatches=1,
             first_call_seconds=packed_s, packed_p50_ms=p50,
             packed_p99_ms=p99, sequential_p50_ms=s50,
             sequential_p99_ms=s99,
             launches={k: v for k, v in hk.LAUNCHES.items() if v})
        return {k: v for k, v in hk.LAUNCHES.items() if v}
    finally:
        eng.close()


def phase_serving_gmm(x_gmm, gm):
    """The mixture (k = 256 'diag') resident: ``predict``,
    ``predict_proba`` and ``score_samples`` at every bucket against the
    model's own calls.  The posterior pass is a torch pass, as in the JAX
    package (``diag_estep`` computes the fit's E-step statistics, not the
    posterior), so this path launches no kernel, and the counts say so."""
    host = x_gmm[:SERVE_BUCKETS[-1]].cpu().numpy()
    own = {m: (gm.predict(host[:m]), gm.predict_proba(host[:m]),
               gm.score_samples(host[:m])) for m in SERVE_BUCKETS}
    eng = ServingEngine(device=DEV, start=False, quality=False)
    try:
        eng.add_model("gm", gm)
        eng.warmup()
        hk.reset_launch_counts()
        errs = {}
        for m in SERVE_BUCKETS:
            rows = host[:m]
            labels, proba, lse = (eng.call("gm", rows, op=op) for op in (
                "predict", "predict_proba", "score_samples"))
            errs[str(m)] = {
                "labels_equal": bool(np.array_equal(labels, own[m][0])),
                "proba": float(np.abs(proba - own[m][1]).max()),
                "score_samples": float(np.abs(lse - own[m][2]).max())}
            check(errs[str(m)]["labels_equal"]
                  and np.allclose(proba, own[m][1], rtol=0, atol=1e-6)
                  and np.allclose(lse, own[m][2], rtol=cmp.LL_RTOL, atol=0),
                  f"serving_gmm: {errs[str(m)]}")
        dispatched = eng.dispatches
        counts = {k: v for k, v in hk.LAUNCHES.items() if v}
        latency = {}
        for m in SERVE_BUCKETS:
            p50, p99 = _latency(lambda: eng.call("gm", host[:m]), calls=50)
            latency[str(m)] = {"p50_ms": p50, "p99_ms": p99}
        emit("serving_gmm", k=int(gm.n_components),
             covariance_type=gm.covariance_type, errors=errs,
             latency=latency, engine_dispatches=dispatched,
             launches=counts)
        return counts
    finally:
        eng.close()


def phase_serving_queue(x, km):
    """``submit`` from QUEUE_THREADS threads (max_wait_ms=2, the worker
    thread on): every future resolves, each result equals ``call`` on its
    rows; dispatches, bucket fill and rows per second.  Every thread is
    joined with a timeout, and a thread that fails fails the phase."""
    import threading
    host = _serve_rows(x)
    rng = np.random.default_rng(5)
    plans = [[(int(lo), int(rng.integers(1, 65)))
              for lo in rng.integers(0, 8000, size=QUEUE_REQUESTS)]
             for _ in range(QUEUE_THREADS)]
    eng = ServingEngine(device=DEV, max_wait_ms=2.0, quality=False)
    results = [None] * QUEUE_THREADS
    errors = []
    try:
        eng.add_model("main", km)
        eng.warmup()

        def client(t):
            try:
                futs = [eng.submit("main", host[lo:lo + m])
                        for lo, m in plans[t]]
                results[t] = [f.result(timeout=QUEUE_TIMEOUT) for f in futs]
            except Exception as e:        # noqa: BLE001 — fails the phase
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(QUEUE_THREADS)]
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=QUEUE_TIMEOUT)
        wall = time.perf_counter() - t0
        alive = [th.name for th in threads if th.is_alive()]
        check(not alive and not errors, f"serving_queue: {alive} {errors}")
        stats = eng.stats()
        launched = _counted("hopper_assign")
        n_rows = sum(m for plan in plans for _, m in plan)
        for t, plan in enumerate(plans):
            for (lo, m), got in zip(plan, results[t]):
                check(bool(np.array_equal(got, eng.call("main",
                                                        host[lo:lo + m]))),
                      "serving_queue: a result differs from call")
        check(launched == stats["dispatches"],
              f"serving_queue: {launched} launches, {stats['dispatches']} "
              f"dispatches")
        emit("serving_queue", threads=QUEUE_THREADS,
             requests=QUEUE_THREADS * QUEUE_REQUESTS, rows=n_rows,
             max_wait_ms=2.0, dispatches=stats["dispatches"],
             queue=stats["queue"], batch_fill=stats["batch_fill"],
             wall_seconds=wall, rows_per_s=n_rows / wall,
             kernel2_launches=launched)
        return {"hopper_assign": launched}
    finally:
        eng.close()


def bucket_check(xm, c, bf16: bool, what: str) -> dict:
    """Kernel 2 (2b with ``bf16``) on one bucket's rows against its plain
    version on the same inputs: no label outside the margin band, and
    ``mind2`` within ``ops/compare.py`` on the rows whose labels agree.
    Raises on any disagreement."""
    la, ma = hk.hopper_assign(xm, c, bf16=bf16)
    lr, mr = hk.assign_reference(xm, c, bf16=bf16)
    torch.cuda.synchronize()
    n_diff, n_outside = label_band(xm, c, la, lr, bf16)
    check(n_outside == 0, f"{what}: {n_outside} labels differ from the "
                          f"plain version outside the margin band")
    same = la == lr
    check(close(ma[same], mr[same], cmp.MIND2_RTOL, cmp.mind2_atol(xm, c)),
          f"{what}: mind2 disagrees with the plain version")
    return {"label_diff": n_diff, "label_diff_in_band": n_diff - n_outside,
            "mind2_err": max_err(ma[same], mr[same])}


def phase_serving_kernel_shapes(x, c):
    """Kernels 2 and 2b at the bucket shapes (rows 8 to 4096, k = 1024,
    D = 128): each held against its plain version on the same inputs
    (``bucket_check``), on a full bucket and on the padded bucket the
    engine sends for a ragged request (real rows, then zero rows), the
    10,000-row request's 12,288 rows too; then the median ms of the full
    bucket beside the plain version, the bound (``bounds``) and the
    library call (cdist + argmin; bf16: a bf16 matmul + argmin).  Returns
    {kernel: {rows: record}}."""
    out = {"hopper_assign": {}, "hopper_assign_bf16": {}}
    k, d = c.shape
    padded = [(m - m // 3, m) for m in SERVE_BUCKETS] + [
        (SERVE_BIG, -(-SERVE_BIG // SERVE_BUCKETS[-1]) * SERVE_BUCKETS[-1])]
    for name, bf16 in (("hopper_assign", False),
                       ("hopper_assign_bf16", True)):
        pads = {}
        for real, rows in padded:
            xp = torch.zeros((rows, d), dtype=x.dtype, device=x.device)
            xp[:real] = x[:real]
            pads[f"{real}_in_{rows}"] = bucket_check(
                xp, c, bf16, f"serving_kernel_shapes: {name}, {real} rows "
                             f"padded to {rows}")
        emit("serving_kernel_shapes_padded", kernel=name, d=d, k=k,
             cases=pads)
        for m in SERVE_BUCKETS:
            xm = x[:m].contiguous()
            checked = bucket_check(xm, c, bf16, f"serving_kernel_shapes: "
                                                f"{name}, {m} rows")
            bound_ms, by, byt, ops, _ = bounds(m, d, k, False, bf16)
            rec = {"ms": median_ms(lambda: hk.hopper_assign(xm, c,
                                                            bf16=bf16),
                                   runs=50, warmup=5),
                   "plain_ms": median_ms(lambda: hk.assign_reference(
                       xm, c, bf16=bf16), runs=50, warmup=5),
                   "bound_ms": bound_ms, "bound_by": by,
                   "library_ms": median_ms(
                       (lambda: library_assign_bf16(xm, c)) if bf16
                       else (lambda: library_assign(xm, c)),
                       runs=50, warmup=5)}
            out[name][str(m)] = rec
            emit("serving_kernel_shapes", kernel=name, n=m, d=d, k=k,
                 bytes=byt, operations=ops, **checked, **rec)
    return out


# --------------------------------------- fleet, serve-and-learn, heartbeats

#: The serving fleet at the main shape: replicas, direct calls cycling
#: through the request sizes, queued requests (threads x requests), the
#: requests queued when a replica is killed, calls per latency figure,
#: the replicas' heartbeat interval (s).
FLEET = dict(replicas=3, calls=2000, sizes=(1, 8, 64, 512, 4096),
             queue_threads=4, queue_requests=100, kill_requests=48,
             latency_calls=200, heartbeat_s=0.1)
#: Serve-and-learn: rows per request (one drift window, one update
#: batch), the fixed offset of the drifted traffic, the requests before
#: the drift monitor must have fired, the probe rows of the label checks,
#: and the latency waves (the reference's ``bench_learn``: reps of a quiet
#: wave and an update wave; ``wave_calls`` 200, where the reference takes
#: 32, so that the p99 is the second slowest call and not the slowest; 9
#: reps, where it takes 5: single reps ranged from 1.5 to 3.6).
LEARN = dict(rows=512, shift=1.0, max_feed=64, probe=4096, reps=9,
             wave_calls=200)


def _joined(learner) -> None:
    """Wait for a learner's background update, if one runs."""
    t = learner._thread
    if t is not None:
        t.join(timeout=QUEUE_TIMEOUT)
        check(not t.is_alive(), "serve_learn: an update did not end")


def _applied_batches(*learners) -> int:
    return sum(len(b) for ln in learners for b in ln.applied_batches)


def _same_model(a, b) -> bool:
    return (np.array_equal(a.centroids, b.centroids)
            and np.array_equal(a._centroids_f64, b._centroids_f64)
            and np.array_equal(a._seen, b._seen)
            and a.iterations_run == b.iterations_run)


def phase_fleet(x, km, km_bf16, fleet_dir: Path):
    """The main float32 model (k = 1024, kernel 2) behind
    ``ServingFleet(3, device='cuda')`` with its sinks in ``fleet_dir``,
    beside a single engine: first one replica is killed with 48 queued
    requests (zero failed, a re-dispatch at least); then FLEET["calls"]
    direct calls of sizes 1 to 4096 rows, 400 queued requests from four
    threads, a packed ``predict_multi`` of four same-shape models and
    ``score``; every label bit-equal to ``km.predict`` (the score to the
    single engine's), kernel 2 launched once per dispatch, ``routes``
    equal to the requests admitted.  Then a ``max_inflight=1`` burst sheds
    explicitly, ``add_replica(prewarm=True)`` is timed, p50 / p99 per call
    at 64 and 4096 rows through the fleet and a single engine (both with
    quality monitoring, 'auto' on the card); then a bf16 fleet serving the
    main model with ``quantize='bf16'`` (the guarded route: labels equal
    to a single bf16 engine's and to ``predict``, kernel 2 once per
    dispatch whose guard flagged rows) and the main bf16 model
    ('kernel_bf16': kernel 2b once per dispatch, labels equal to its
    ``predict``).  Returns (path counts, the killed replica's name)."""
    import threading
    from kmeans_tpu_torch.obs import metrics_registry as obs_metrics
    host = _serve_rows(x)
    want = km.predict(host)            # labels are per row: slices of it
    rng = np.random.default_rng(7)
    packed = []
    for j in range(PACKED_MODELS):
        mj = KMeans(k=km.k, distance_mode="matmul", verbose=False)
        mj.centroids = (km.centroids + np.float32(0.05 * j)).astype(
            np.float32)
        packed.append(mj)
    reqs = [(f"p{j}", host[j * 1000:(j + 1) * 1000])
            for j in range(PACKED_MODELS)]
    want_packed = [m.predict(rows) for m, (_, rows) in zip(packed, reqs)]
    single = ServingEngine(device=DEV, start=False)
    fleet = ServingFleet(FLEET["replicas"], device=DEV,
                         fleet_dir=str(fleet_dir),
                         heartbeat_interval_s=FLEET["heartbeat_s"])
    counts = {}
    try:
        single.add_model("main", km)
        single.warmup()
        want_score = single.score("main", host[:SERVE_BUCKETS[-1]])
        check(fleet.add_model("main", km) == ["r0", "r1", "r2"],
              "fleet: placement")
        for j, mj in enumerate(packed):
            fleet.add_model(f"p{j}", mj)
        t0 = time.perf_counter()
        warm = fleet.warmup()
        warm_s = time.perf_counter() - t0
        hk.reset_launch_counts()
        # 1. A replica dies holding queued requests.
        plan = [(int(lo), int(m)) for lo, m in zip(
            rng.integers(0, 8000, size=FLEET["kill_requests"]),
            rng.integers(1, 65, size=FLEET["kill_requests"]))]
        with faults.inject_replica_kill(fleet, after_dispatches=0) as rec:
            futs = [fleet.submit("main", host[lo:lo + m]) for lo, m in plan]
            outs = [f.result(timeout=QUEUE_TIMEOUT) for f in futs]
        killed = rec["replica"]
        check(rec["killed"] and all(
            np.array_equal(o, want[lo:lo + m])
            for o, (lo, m) in zip(outs, plan)),
            "fleet: a request failed or differs after the kill")
        after_kill = fleet.stats()
        check(after_kill["redispatches"] >= 1
              and after_kill["n_serving"] == FLEET["replicas"] - 1
              and after_kill["replicas"][killed]["state"] == "dead",
              f"fleet: kill {rec}, {after_kill['redispatches']} "
              f"re-dispatches")
        routes0 = after_kill["routes"]
        # 2. Direct calls of every size.
        sizes = FLEET["sizes"]
        calls = [(int(lo), sizes[i % len(sizes)]) for i, lo in enumerate(
            rng.integers(0, host.shape[0] - sizes[-1], size=FLEET["calls"]))]
        t0 = time.perf_counter()
        bad = sum(not np.array_equal(fleet.call("main", host[lo:lo + m]),
                                     want[lo:lo + m]) for lo, m in calls)
        calls_s = time.perf_counter() - t0
        check(bad == 0, f"fleet: {bad} direct calls differ from predict")
        # 3. Queued requests from four threads.
        results = [None] * FLEET["queue_threads"]
        errors = []
        qplans = [[(int(lo), int(m)) for lo, m in zip(
            rng.integers(0, 8000, size=FLEET["queue_requests"]),
            rng.integers(1, 65, size=FLEET["queue_requests"]))]
            for _ in range(FLEET["queue_threads"])]

        def client(t):
            try:
                fs = [fleet.submit("main", host[lo:lo + m])
                      for lo, m in qplans[t]]
                results[t] = [f.result(timeout=QUEUE_TIMEOUT) for f in fs]
            except Exception as e:        # noqa: BLE001 — fails the phase
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(FLEET["queue_threads"])]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=QUEUE_TIMEOUT)
        check(not errors and not any(th.is_alive() for th in threads),
              f"fleet: queued requests {errors}")
        check(all(np.array_equal(got, want[lo:lo + m])
                  for t in range(FLEET["queue_threads"])
                  for got, (lo, m) in zip(results[t], qplans[t])),
              "fleet: a queued result differs from predict")
        # 4. Four same-shape models in one packed dispatch; 5. score.
        outs = fleet.predict_multi(reqs)
        check(all(np.array_equal(o, w) for o, w in zip(outs, want_packed)),
              "fleet: predict_multi differs from each model's predict")
        score = fleet.score("main", host[:SERVE_BUCKETS[-1]])
        check(score == want_score,
              f"fleet: score {score} against the engine's {want_score}")
        admitted = len(calls) + sum(len(p) for p in qplans) + len(reqs) + 1
        st = fleet.stats()
        check(st["routes"] - routes0 == admitted
              and st["redispatches"] == after_kill["redispatches"],
              f"fleet: {st['routes'] - routes0} routes for {admitted} "
              f"requests admitted")
        packed_n = sum(r["packed_dispatches"]
                       for r in st["replicas"].values())
        dispatched = st["dispatches"] - packed_n
        launched = _counted("hopper_assign")
        check(packed_n == 1 and launched == dispatched,
              f"fleet: kernel 2 launched {launched} times for {dispatched} "
              f"dispatches ({packed_n} packed)")
        counts["fleet"] = {k: v for k, v in hk.LAUNCHES.items() if v}
        emit("launches", path="fleet", **hk.LAUNCHES)
        # 6. A burst past max_inflight=1 sheds, explicitly and counted.
        shed0 = obs_metrics.REGISTRY.counter("fleet.shed").value
        with ServingFleet(FLEET["replicas"], device=DEV, start=False,
                          quality=False, max_inflight=1) as burst:
            burst.add_model("main", km)
            burst.warmup(prewarm=False)
            admitted_b, shed, msgs = [], 0, set()
            for i in range(2 * FLEET["replicas"]):
                try:
                    admitted_b.append((i, burst.submit("main",
                                                       host[i:i + 1])))
                except FleetOverloadError as e:
                    shed += 1
                    msgs.add(str(e))
            burst_stats = burst.stats()
            burst.close()
            check(len(admitted_b) == FLEET["replicas"]
                  and shed == FLEET["replicas"]
                  and burst_stats["sheds"] == shed
                  and obs_metrics.REGISTRY.counter("fleet.shed").value
                  - shed0 == shed
                  and all(np.array_equal(f.result(timeout=QUEUE_TIMEOUT),
                                         want[i:i + 1])
                          for i, f in admitted_b),
                  f"fleet: burst admitted {len(admitted_b)}, shed {shed}")
        # 7. A replica added warm; 8. latency beside a single engine.
        name = fleet.add_replica(prewarm=True)
        prewarm_s = fleet.stats()["replicas"][name]["prewarm_s"]
        latency = {}
        for m in (64, 4096):
            rows = host[:m]
            f50, f99 = _latency(lambda: fleet.call("main", rows),
                                calls=FLEET["latency_calls"])
            s50, s99 = _latency(lambda: single.call("main", rows),
                                calls=FLEET["latency_calls"])
            latency[str(m)] = {"fleet_p50_ms": f50, "fleet_p99_ms": f99,
                               "engine_p50_ms": s50, "engine_p99_ms": s99,
                               "fleet_over_engine_p50": f50 / s50}
        final = fleet.stats()
        emit("fleet", k=int(km.k), d=int(km.centroids.shape[1]),
             replicas=FLEET["replicas"], warm_dispatches=warm,
             warmup_seconds=warm_s, killed=killed,
             kill_queued_requests=len(plan),
             redispatches=after_kill["redispatches"],
             direct_calls=len(calls), direct_calls_seconds=calls_s,
             queued_requests=sum(len(p) for p in qplans),
             packed_models=PACKED_MODELS, routes_admitted=admitted,
             kernel2_launches=launched, dispatches=dispatched,
             burst_offered=2 * FLEET["replicas"], burst_shed=shed,
             burst_messages=sorted(msgs),
             add_replica=name, add_replica_prewarm_seconds=prewarm_s,
             latency=latency, labels_bit_equal=True,
             replicas_state={r: v["state"]
                             for r, v in final["replicas"].items()},
             replica_dispatches={r: v["dispatches"]
                                 for r, v in final["replicas"].items()})
    finally:
        fleet.close()
        single.close()
    # 9. The bf16 routes through a fleet.
    bsizes = SERVE_BUCKETS + (SERVE_BIG,)
    want_b = km_bf16.predict(host[:SERVE_BIG])
    beng = ServingEngine(device=DEV, start=False, quality=False)
    bfleet = ServingFleet(2, device=DEV, start=False, quality=False)
    try:
        for e in (beng, bfleet):
            e.add_model("q", km, quantize="bf16")
            e.add_model("b", km_bf16)
            e.warmup()
        check(km_bf16._mode() == "kernel_bf16", "fleet_bf16: the mode")
        want_q = {m: beng.call("q", host[:m]) for m in bsizes}
        want_bb = {m: beng.call("b", host[:m]) for m in bsizes}
        residents = [r.engine._residents["q"] for r in bfleet._replicas]
        hk.reset_launch_counts()
        flagged = 0
        for m in bsizes:
            before = sum(rm.bf16_corrected_rows for rm in residents)
            got = bfleet.call("q", host[:m])
            check(np.array_equal(got, want_q[m])
                  and np.array_equal(got, want[:m]),
                  f"fleet_bf16: guarded labels at {m} rows")
            flagged += sum(rm.bf16_corrected_rows
                           for rm in residents) > before
        fixups = _counted("hopper_assign")
        guarded_dispatches = bfleet.stats()["dispatches"]
        for m in bsizes:
            got = bfleet.call("b", host[:m])
            check(np.array_equal(got, want_bb[m])
                  and np.array_equal(got, want_b[:m]),
                  f"fleet_bf16: kernel_bf16 labels at {m} rows")
        dispatched_b = bfleet.stats()["dispatches"] - guarded_dispatches
        launched_2b = _counted("hopper_assign_bf16")
        check(launched_2b == dispatched_b and fixups == flagged
              and _counted("hopper_assign") == fixups,
              f"fleet_bf16: kernel 2b {launched_2b} for {dispatched_b} "
              f"dispatches, kernel 2 {fixups} for {flagged} flagged")
        counts["fleet_bf16"] = {k: v for k, v in hk.LAUNCHES.items() if v}
        emit("launches", path="fleet_bf16", **hk.LAUNCHES)
        emit("fleet_bf16", guarded_dispatches=guarded_dispatches,
             kernel_bf16_dispatches=dispatched_b,
             kernel2b_launches=launched_2b, guard_fixups=fixups,
             guard_flagged_dispatches=flagged,
             corrected_rows=sum(rm.bf16_corrected_rows
                                for rm in residents),
             labels_equal_to_engine=True)
    finally:
        bfleet.close()
        beng.close()
    return counts, killed


def phase_serve_learn(x, mb_ref, tmp: Path):
    """``MiniBatchKMeans`` fitted as in phase ``minibatch`` (k = 1024,
    D = 128, 'pallas'; a copy through ``save`` / ``load``) served with
    quality monitoring and ``learn={'dir': ...}``, fed 512-row requests of
    the main blobs shifted by LEARN["shift"]: the drift monitor fires an
    update on its own; kernel 1 launches equal the update batches applied;
    the quiesced model equals, bit for bit, an offline replay on the card
    of the learner's ``applied_batches`` from the pre-learning state and
    from the last snapshot; after each publication served labels equal
    ``predict``; an injected update failure fails no request and leaves the
    table bit-identical; an injected regression rolls back to the
    snapshot, bit-identical.  Then the p99 excursion as the reference's
    ``bench_learn`` measures it (quiet wave, update wave with one forced
    update on another thread; the automatic trigger held off by
    ``min_rows``), against ``LEARN_P99_EXCURSION_BOUND``, with the
    ``publish_tables`` seconds; and two fleet replicas with ``learn``
    sharing the model: an update while the model's lock is held is a
    'peer-updating' skip, two updates at once serialize, and both replicas
    serve the published table.  Returns the path counts."""
    import threading
    from kmeans_tpu_torch.serving import learn as serve_learn
    host = _serve_rows(x)
    rows = LEARN["rows"]
    drifted = host + np.float32(LEARN["shift"])
    reqs = [drifted[i * rows:(i + 1) * rows]
            for i in range(drifted.shape[0] // rows)]
    probe = drifted[:LEARN["probe"]]
    base = tmp / "minibatch.npz"
    mb_ref.save(base)

    def fresh():
        return MiniBatchKMeans.load(base)

    counts = {}
    # 1. The drift monitor fires; the replay; failure; regression.
    model = fresh()
    check(model._mode() == "kernel", f"serve_learn: mode {model._mode()}")
    start = fresh()
    eng = ServingEngine(device=DEV, start=False, quality=True,
                        quality_dir=str(tmp / "e1"),
                        learn={"dir": str(tmp / "e1")})
    try:
        eng.add_model("mb", model)
        eng.warmup()
        ln = eng._residents["mb"].learner
        check(ln is not None, "serve_learn: no learner attached")
        hk.reset_launch_counts()
        fed = 0
        while ln._thread is None and fed < LEARN["max_feed"]:
            eng.call("mb", reqs[fed % len(reqs)])
            fed += 1
        check(ln._thread is not None,
              f"serve_learn: no update fired in {fed} requests")
        _joined(ln)
        auto = [d for d in ln.status()["decisions"]
                if d["action"] == "update"]
        check(len(auto) == 1 and auto[0]["reason"] == "drift",
              f"serve_learn: decisions {ln.status()['decisions']}")
        k1 = _counted("fused_assign_reduce")
        batches = _applied_batches(ln)
        check(k1 == batches == len(ln.applied_batches[-1]),
              f"serve_learn: kernel 1 launched {k1} times for {batches} "
              f"update batches")
        drift_launches = {k: v for k, v in hk.LAUNCHES.items() if v}
        check(np.array_equal(eng.call("mb", probe), model.predict(probe)),
              "serve_learn: served labels after the drift update")
        # The offline replays (their launches are not the path's).
        replay = fresh()
        for bs in ln.applied_batches:
            for b in bs:
                replay.partial_fit(b)
        last = MiniBatchKMeans.load(ln.snapshot_path)
        for b in ln.applied_batches[-1]:
            last.partial_fit(b)
        check(_same_model(replay, model) and _same_model(last, model),
              "serve_learn: the quiesced model differs from its replay")
        check(not _same_model(start, model),
              "serve_learn: the update did not move the model")
        # Injected failure: nothing published, no request fails.
        hk.reset_launch_counts()
        applied0 = _applied_batches(ln)
        for r in reqs[:4]:
            eng.call("mb", r)
        _joined(ln)
        before = model.centroids
        before_bytes = np.array(before, copy=True)
        with faults.inject_update_failure("mb") as rec:
            dec_fail = ln.update_now(force=True)
        check(rec["fired"] == 1 and dec_fail["action"] == "update-failed"
              and model.centroids is before
              and np.array_equal(model.centroids, before_bytes),
              f"serve_learn: injected failure {dec_fail}")
        check(np.array_equal(eng.call("mb", probe), model.predict(probe)),
              "serve_learn: served labels after the failed update")
        # Injected regression: applied, then rolled back bit for bit.
        for r in reqs[4:8]:
            eng.call("mb", r)
        _joined(ln)
        pre = {n: np.array(getattr(model, n), copy=True) for n in
               ("centroids", "_centroids_f64", "_seen", "cluster_sizes_")}
        dec_up = ln.update_now(force=True)
        check(dec_up["action"] == "update"
              and not np.array_equal(model.centroids, pre["centroids"]),
              f"serve_learn: update before the regression {dec_up}")
        check(np.array_equal(eng.call("mb", probe), model.predict(probe)),
              "serve_learn: served labels after the forced update")
        with faults.inject_quality_regression("mb", ratio=10.0) as rec:
            ln.evaluate_now(force=True)
        rb = ln.rollbacks[-1] if ln.rollbacks else None
        check(rec["fired"] == 1 and rb is not None
              and rb.restored_from == "primary"
              and all(np.array_equal(getattr(model, n), v)
                      for n, v in pre.items()),
              "serve_learn: the rollback is not the snapshot")
        check(np.array_equal(eng.call("mb", probe), model.predict(probe)),
              "serve_learn: served labels after the rollback")
        k1 = _counted("fused_assign_reduce")
        check(k1 == _applied_batches(ln) - applied0,
              f"serve_learn: kernel 1 launched {k1} times for "
              f"{_applied_batches(ln) - applied0} update batches around "
              f"the failure and the regression")
        counts["serve_learn"] = drift_launches
        emit("launches", path="serve_learn", **drift_launches)
        status = ln.status()
    finally:
        eng.close()
    # 2. The p99 excursion, as the reference's bench_learn measures it.
    model2 = fresh()
    eng2 = ServingEngine(device=DEV, start=False, quality=True,
                         quality_dir=str(tmp / "e2"),
                         learn={"dir": str(tmp / "e2"), "batch_rows": rows,
                                "max_batches": 2, "cooldown_windows": 0,
                                "update_budget": LEARN["reps"] + 2,
                                "min_rows": 1 << 40})
    try:
        eng2.add_model("mb", model2)
        eng2.warmup()
        ln2 = eng2._residents["mb"].learner

        def wave(first):
            lats = []
            for i in range(LEARN["wave_calls"]):
                t0 = time.perf_counter()
                eng2.call("mb", reqs[(first + i) % len(reqs)])
                lats.append(time.perf_counter() - t0)
            return np.asarray(lats)

        wave(0)
        ln2.update_now(force=True, reason="warm")
        hk.reset_launch_counts()
        ratios, swaps, applied = [], [], 0
        for rep in range(LEARN["reps"]):
            quiet = wave(rep)
            dec = [None]
            t = threading.Thread(target=lambda: dec.__setitem__(
                0, ln2.update_now(force=True, reason="wave")))
            t.start()
            busy = wave(rep + LEARN["reps"])
            t.join(timeout=QUEUE_TIMEOUT)
            check(not t.is_alive(), "serve_learn: the wave's update hung")
            if dec[0] is not None and dec[0]["action"] == "update":
                applied += 1
                swaps.append(dec[0]["detail"]["swap_ms"])
            ratios.append(float(np.percentile(busy, 99))
                          / float(np.percentile(quiet, 99)))
        excursion = float(np.median(ratios))
        k1 = _counted("fused_assign_reduce")
        waves_batches = sum(len(b) for b in
                            list(ln2.applied_batches)[-applied:]) \
            if applied else 0
        check(applied >= 1 and k1 == waves_batches,
              f"serve_learn: {applied} wave updates, kernel 1 {k1} for "
              f"{waves_batches} batches")
        check(np.array_equal(eng2.call("mb", probe), model2.predict(probe)),
              "serve_learn: served labels after the wave updates")
        check(excursion <= serve_learn.LEARN_P99_EXCURSION_BOUND,
              f"serve_learn: p99 excursion {excursion} (ratios {ratios})")
    finally:
        eng2.close()
    # 3. Two fleet replicas learning on one shared model.
    model3 = fresh()
    fleet = ServingFleet(2, device=DEV, start=False,
                         fleet_dir=str(tmp / "fleet"),
                         learn={"dir": str(tmp / "fleet")})
    try:
        fleet.add_model("mb", model3)
        fleet.warmup()
        learners = [r.engine._residents["mb"].learner
                    for r in fleet._replicas]
        hk.reset_launch_counts()
        for r in reqs[:8]:
            fleet.call("mb", r)
        for lnf in learners:
            _joined(lnf)
        with serve_learn._model_update_lock(model3):
            held = [lnf.update_now(force=True) for lnf in learners]
        check(all(d["action"] == "update-skipped"
                  and d["reason"] == "peer-updating" for d in held),
              f"serve_learn: updates while the model's lock is held {held}")
        gate = threading.Barrier(2)
        both = [None, None]

        def update(i):
            gate.wait(QUEUE_TIMEOUT)
            both[i] = learners[i].update_now(force=True)

        threads = [threading.Thread(target=update, args=(i,))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=QUEUE_TIMEOUT)
        # The automatic trigger may have drained a reservoir before: an
        # update, a peer's skip or an empty reservoir, never two at once.
        actions = sorted((d["action"], d["reason"]) for d in both)
        check(all(a == "update" or r in ("peer-updating",
                                         "reservoir-underfilled")
                  for a, r in actions)
              and sum(lnf.updates_applied for lnf in learners) >= 1
              and not _same_model(model3, fresh()),
              f"serve_learn: fleet updates {actions}")
        for rep in fleet._replicas:
            check(np.array_equal(rep.engine.call("mb", probe),
                                 model3.predict(probe)),
                  f"serve_learn: replica {rep.name} serves a stale table")
        k1 = _counted("fused_assign_reduce")
        check(k1 == _applied_batches(*learners),
              f"serve_learn: fleet kernel 1 {k1} for "
              f"{_applied_batches(*learners)} batches")
        counts["serve_learn_fleet"] = {k: v for k, v in hk.LAUNCHES.items()
                                       if v}
        emit("launches", path="serve_learn_fleet", **hk.LAUNCHES)
        fleet_status = fleet.update_status()["mb"]
    finally:
        fleet.close()
    emit("serve_learn", k=int(model.k), d=int(model.centroids.shape[1]),
         rows_per_request=rows, shift=LEARN["shift"],
         requests_until_drift_update=fed,
         drift_update=auto[0], replay_bit_equal=True,
         injected_failure=dec_fail["action"], rolled_back=rb.as_dict(),
         decisions=[(d["action"], d["reason"])
                    for d in status["decisions"]],
         excursion_ratio=excursion, excursion_ratios=ratios,
         excursion_bound=serve_learn.LEARN_P99_EXCURSION_BOUND,
         wave_updates=applied, publish_tables_ms=swaps,
         fleet_updates_applied={r: s["updates_applied"]
                                for r, s in fleet_status.items()},
         fleet_actions=actions)
    return counts


def phase_heartbeat(x, fleet_dir: Path, killed: str):
    """The main ``KMeans`` fitted by the host loop and by the device loop
    with ``checkpoint_every=2``, each inside ``obs.heartbeat(path)`` and
    without: records at each iteration (host loop), each checkpoint (the
    segment boundaries), the device loop's end (phase 'fit') and the fit's
    end ('finished'); centroids, iteration counts, SSE histories and every
    kernel's launch count bit-equal without the heartbeat.  Then
    ``straggler_report(merge_heartbeats(...))`` over phase ``fleet``'s
    heartbeat sinks: every replica shows, the killed one is flagged.
    Returns the path counts."""
    from kmeans_tpu_torch import obs
    counts, summary = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for loop, host_loop in (("host", True), ("device", False)):
            runs = {}
            for hb in (False, True):
                km = KMeans(k=MAIN["k"], max_iter=MAIN["iters"], seed=42,
                            compute_sse=True, init="forgy", verbose=False,
                            host_loop=host_loop)
                ckpt_path = tmp / f"{loop}.{hb}.npz"
                hk.reset_launch_counts()
                t0 = time.perf_counter()
                if hb:
                    with obs.heartbeat(str(tmp / f"{loop}.jsonl")):
                        km.fit(x, checkpoint_every=2,
                               checkpoint_path=ckpt_path)
                else:
                    km.fit(x, checkpoint_every=2, checkpoint_path=ckpt_path)
                torch.cuda.synchronize()
                runs[hb] = (km, {k: v for k, v in hk.LAUNCHES.items() if v},
                            time.perf_counter() - t0)
            (plain, plain_l, plain_s), (beat, beat_l, beat_s) = \
                runs[False], runs[True]
            check(np.array_equal(plain.centroids, beat.centroids)
                  and plain.iterations_run == beat.iterations_run
                  and plain.sse_history == beat.sse_history
                  and plain_l == beat_l,
                  f"heartbeat_{loop}: the fit changed under a heartbeat "
                  f"({plain_l} against {beat_l})")
            recs = [json.loads(line) for line in
                    (tmp / f"{loop}.jsonl").read_text().splitlines()]
            phases = [(r["phase"], r.get("iteration")) for r in recs]
            n = beat.iterations_run
            ckpts = [("checkpoint", i) for i in range(2, n + 1, 2)] + (
                [("checkpoint", n)] if n % 2 else [])
            want = ([("iteration", i) for i in range(1, n + 1)]
                    if host_loop else []) + ckpts + (
                [] if host_loop else [("fit", n)]) + [("finished", n)]
            check(sorted(phases, key=str) == sorted(want, key=str)
                  and phases[-1] == ("finished", n),
                  f"heartbeat_{loop}: records {phases}, want {want}")
            counts[f"heartbeat_{loop}"] = beat_l
            emit("launches", path=f"heartbeat_{loop}", **beat_l)
            summary[loop] = {"records": phases, "iterations": n,
                             "fit_seconds": beat_s,
                             "fit_seconds_without": plain_s,
                             "launches": beat_l}
    report = obs.fleet.straggler_report(
        obs.fleet.merge_heartbeats(str(fleet_dir / "hb.*.jsonl")))
    hosts = {h["host"]: h for h in report["hosts"]}
    check(killed in hosts and hosts[killed]["flags"]
          and {"r0", "r1", "r2"} <= set(hosts),
          f"heartbeat: straggler report {report['hosts']}")
    print(obs.fleet.format_fleet_status(report), file=sys.stderr,
          flush=True)
    emit("heartbeat", fits=summary, fleet_hosts=sorted(hosts),
         killed=killed, flags={h: v["flags"] for h, v in hosts.items()},
         iterations={h: v["iteration"] for h, v in hosts.items()})
    return counts


def median_ms(fn, runs=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bounds(n, d, k, fused: bool, bf16: bool = False):
    """(bound ms, what bounds it, bytes, operations, scalar float32 bound
    ms): each input read once, each output written once.  The product's
    2nkD operations run on the tensor cores: with ``bf16`` at the bf16 rate,
    else as three TF32 products each (3xTF32, which keeps float32's
    accuracy) at the TF32 rate; the rest (h - x.c, the norms, the scatter)
    at the float32 rate outside them.  The two kinds issue side by side, so
    the operations take the longer of the two times.  The fifth field is
    the bound of a kernel that does every operation at the float32
    non-tensor rate."""
    byt = 4 * (n * d + k * d + 2 * n)              # x, c, labels, mind2
    if fused:
        byt += 4 * (n + k * d + k)                 # w, sums, counts
    # The kernel's operations, declared once beside the wrappers (the cost
    # records read the same function).
    product, ops = hk.declared_operations("fused" if fused else "assign",
                                          n, d, k)
    t_bytes = byt / PEAK_BYTES_PER_S * 1e3
    rest_ms = (ops - product) / PEAK_FP32_FLOPS * 1e3
    tensor_ms = (product / PEAK_BF16_FLOPS if bf16
                 else 3 * product / PEAK_TF32_FLOPS) * 1e3
    t_ops = max(tensor_ms, rest_ms)
    by = "operations" if t_ops >= t_bytes else "bytes"
    scalar_ms = max(t_bytes, ops / PEAK_FP32_FLOPS * 1e3)
    return max(t_bytes, t_ops), by, byt, ops, scalar_ms


def library_assign(x, c, block=65536):
    """The yardstick: torch.cdist + argmin over blocks of rows."""
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for lo in range(0, x.shape[0], block):
        out[lo:lo + block] = torch.cdist(x[lo:lo + block], c).argmin(dim=1)
    return out


def library_fused(x, w, c, assign=library_assign):
    labels = assign(x, c)
    sums = torch.zeros_like(c).index_add_(0, labels, w[:, None] * x)
    counts = torch.zeros(c.shape[0], device=x.device).index_add_(0, labels, w)
    return labels, sums, counts


def library_assign_bf16(x, c, block=65536):
    """The bf16 yardstick: a bf16 torch.matmul (cuBLAS, tensor cores) over
    blocks of rows, then h - score and argmin."""
    cb = c.to(torch.bfloat16).T
    h = 0.5 * (c * c).sum(1)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for lo in range(0, x.shape[0], block):
        score = (x[lo:lo + block].to(torch.bfloat16) @ cb).float()
        out[lo:lo + block] = (h - score).argmin(dim=1)
    return out


def phase_timing(x, c, errs, launches, iter_seconds, device_seconds):
    n, d = x.shape
    k = c.shape[0]
    w = torch.ones(n, device=DEV)
    rows = []
    f32_src = "kmeans_tpu_torch/csrc/assign_kernels.cu"
    bf16_src = "kmeans_tpu_torch/csrc/assign_bf16.cu"
    specs = [
        ("fused_assign_reduce", True, False, f32_src,
         "kmeans_tpu/ops/pallas_kernels.py:558",
         lambda: hk.fused_assign_reduce(x, w, c),
         lambda: hk.fused_assign_reduce_reference(x, w, c),
         lambda: library_fused(x, w, c)),
        ("hopper_assign", False, False, f32_src,
         "kmeans_tpu/ops/pallas_kernels.py:542",
         lambda: hk.hopper_assign(x, c),
         lambda: hk.assign_reference(x, c),
         lambda: library_assign(x, c)),
        ("fused_assign_reduce_bf16", True, True, bf16_src,
         "kmeans_tpu/ops/pallas_kernels.py:558 (bf16=True, :494)",
         lambda: hk.fused_assign_reduce(x, w, c, bf16=True),
         lambda: hk.fused_assign_reduce_reference(x, w, c, bf16=True),
         lambda: library_fused(x, w, c, library_assign_bf16)),
        ("hopper_assign_bf16", False, True, bf16_src,
         "kmeans_tpu/ops/pallas_kernels.py:542 (bf16=True, :494)",
         lambda: hk.hopper_assign(x, c, bf16=True),
         lambda: hk.assign_reference(x, c, bf16=True),
         lambda: library_assign_bf16(x, c)),
    ]
    for name, fused, bf16, source, replaces, kernel, plain, library in specs:
        bound_ms, by, byt, ops, scalar_ms = bounds(n, d, k, fused, bf16)
        before = clocks()
        ms = median_ms(kernel)
        after = clocks()
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms,
            "plain_ms": median_ms(plain), "bound_ms": bound_ms,
            "bound_by": by, "library_ms": median_ms(library)})
        emit("timing", kernel=name, n=n, d=d, k=k, kernel_ms=ms,
             plain_ms=rows[-1]["plain_ms"],
             library_ms=rows[-1]["library_ms"], bound_ms=bound_ms,
             bound_by=by, bytes=byt, operations=ops,
             tensor_core_rate="bf16" if bf16 else "3xTF32",
             scalar_float32_bound_ms=scalar_ms,
             roofline_share=bound_ms / ms,
             clocks_power_temperature=[before, after])
    # The scatter's share of the fused kernel: the fused pass less the
    # assignment-only pass on the same inputs.
    by_name = {row["name"]: row["ms"] for row in rows}
    for suffix in ("", "_bf16"):
        fused_ms = by_name["fused_assign_reduce" + suffix]
        scatter_ms = fused_ms - by_name["hopper_assign" + suffix]
        emit("scatter_share", kernel="fused_assign_reduce" + suffix,
             fused_ms=fused_ms, scatter_ms=scatter_ms,
             share=scatter_ms / fused_ms)
    # The step as the fit runs it (the fused kernel and the algebraic SSE,
    # from the dataset's sum of w ||x||^2, which is computed once per fit
    # and timed here on its own), beside the step with every statistic and
    # the sum in each step (the defaults of make_step_fn, which the fit ran
    # before the sum was hoisted), and the wall time of one iteration of
    # the host loop and of the device loop.
    x2w = dist._weighted_sqnorm_total(x, w)
    for mode, label in (("kernel", "main"), ("kernel_bf16", "main_bf16")):
        step = dist.make_step_fn(chunk_size=n, mode=mode,
                                 need_farthest=False, need_sse_pc=False)
        every = dist.make_step_fn(chunk_size=n, mode=mode)
        emit("timing", what=f"one Lloyd iteration of the {label} fit",
             step_ms=median_ms(lambda: step(x, w, c, x2w)),
             step_ms_every_statistic=median_ms(lambda: every(x, w, c)),
             weighted_sqnorm_ms_once_per_fit=median_ms(
                 lambda: dist._weighted_sqnorm_total(x, w)),
             seconds_per_iteration=iter_seconds[label],
             device_loop_seconds_per_iteration=device_seconds[
                 label + "_device"], n=n, d=d, k=k)
    return rows


def phase_lab(x, c, kernel_rows):
    """The variant lab at the main shape: each variant held against the
    plain version on a weighted slice and on the whole of the inputs it is
    timed on, then timed per Lloyd iteration (marginal method) with each
    variant's own launch count.  Returns the kernel table's rows of the two
    default variants (plain, bound and library times are those of the
    kernel rows of this run: the same function on the same inputs)."""
    variants = [lab.parse_spec(spec) for spec in LAB_SPECS]
    checks = {v.name: lab.check_variant(v, x, c) for v in variants}
    for v in variants:
        check(checks[v.name]["ok"], f"lab: variant {v.name} failed its "
                                    f"check: {checks[v.name]}")
    hk.reset_launch_counts()           # this path's own counts
    records = [lab.measure(v, x, c, LAB_ITERS, checked=checks[v.name])
               for v in variants]
    launches = check_path_launches("lab")
    for v, rec in zip(variants, records):
        rec["launches"] = launches[v.counter]
        print(lab.line(rec), flush=True)
    by_name = {row["name"]: row for row in kernel_rows}
    compare = {}
    rows = []
    for rec in records:
        if rec["name"] not in ("f32_default", "bf16_default"):
            continue
        kernel = by_name["fused_assign_reduce_bf16" if rec["bf16"]
                         else "fused_assign_reduce"]
        compare[rec["name"]] = {"lab_ms_per_iter": rec["ms_per_iter"],
                                "kernel_row_ms": kernel["ms"],
                                "ratio": rec["ms_per_iter"] / kernel["ms"]}
        errs = [part[key] for part in (rec["check"]["slice"],
                                       rec["check"]["timed_inputs"])
                for key in ("mind2_err", "sums_err", "counts_err")]
        rows.append({
            "name": f"exp_pallas_kernel:{rec['name']}", "route": "cuda",
            "source": "kmeans_tpu_torch/experiments/exp_pallas_kernel.py",
            "replaces": "experiments/exp_pallas_kernel.py:44",
            "launches": rec["launches"], "max_abs_err": max(errs),
            "ms": rec["ms_per_iter"], "plain_ms": kernel["plain_ms"],
            "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
            "library_ms": kernel["library_ms"]})
    emit("lab", iters=LAB_ITERS, variants=records,
         defaults_against_kernel_rows=compare)
    return rows


def library_estep(x, w, shift, means_c, inv_var, log_det, log_w,
                  chunk=EM_MAX_CHUNK):
    """The yardstick: the E-step as cuBLAS and torch calls over chunks of
    EM_MAX_CHUNK rows (TF32 off): addmm for logp, logsumexp and softmax,
    one product r^T [x_c, x_c^2]."""
    coef, c1 = ek.estep_coefficients(means_c, inv_var, log_det, log_w)
    k, d = means_c.shape
    rsum = torch.zeros(k, device=DEV)
    mom = torch.zeros((k, 2 * d), device=DEV)
    ll = torch.zeros((), device=DEV)
    for lo in range(0, x.shape[0], chunk):
        xc = x[lo:lo + chunk] - shift
        f = torch.cat([xc, xc * xc], dim=1)
        logp = torch.addmm(c1, f, coef.T)
        wc = w[lo:lo + chunk]
        r = torch.softmax(logp, dim=1) * wc[:, None]
        rsum += r.sum(0)
        mom += r.T @ f
        ll += (wc * torch.logsumexp(logp, dim=1)).sum()
    return rsum, mom[:, :d], mom[:, d:], ll


def estep_bounds(n, d, k):
    """(bound ms, what bounds it, bytes, operations, scalar float32 bound
    ms) of diag_estep: each input read once, each output written once; the
    operations are the two depth-2D products (8 n k D) on the tensor cores,
    as three TF32 products each (3xTF32, which keeps float32's accuracy) at
    the TF32 rate, and the softmax (max, subtract, exp, scale, sum: 5 n k)
    and the centering and squares (2 n D) at the float32 rate outside them;
    the two kinds issue side by side, so the longer counts.  The fifth
    field puts every operation at the float32 non-tensor rate."""
    byt = 4 * (n * d + n + d + 2 * k * d + 2 * k) + 4 * (k * (2 * d + 1) + 1)
    product, ops = hk.declared_operations("estep", n, d, k)
    t_bytes = byt / PEAK_BYTES_PER_S * 1e3
    tensor_ms = 3 * product / PEAK_TF32_FLOPS * 1e3
    rest_ms = (ops - product) / PEAK_FP32_FLOPS * 1e3
    t_ops = max(tensor_ms, rest_ms)
    scalar_ms = max(t_bytes, ops / PEAK_FP32_FLOPS * 1e3)
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                 else "bytes"), byt, ops, scalar_ms


def host_ms(fn, runs=5) -> float:
    """Median host wall time of a call that ends on the host."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_gmm_timing(x, tables, gm, err, launches):
    n, d = x.shape
    k = tables[1].shape[0]
    w = torch.ones(n, device=DEV)
    args = (x, w, *tables)
    bound_ms, by, byt, ops, scalar_ms = estep_bounds(n, d, k)
    ms = median_ms(lambda: ek.diag_estep(*args))
    plain = median_ms(lambda: ek.diag_estep_reference(*args))
    library = median_ms(lambda: library_estep(*args))
    row = {"name": "diag_estep", "route": "cuda",
           "source": "kmeans_tpu_torch/csrc/gmm_estep.cu",
           "replaces": "experiments/exp_gmm_estep_pallas.py:139",
           "launches": launches["diag_estep"], "max_abs_err": err,
           "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
           "bound_by": by, "library_ms": library}
    emit("timing", kernel="diag_estep", n=n, d=d, k=k, kernel_ms=ms,
         plain_ms=plain, library_ms=library, bound_ms=bound_ms, bound_by=by,
         bytes=byt, operations=ops, tensor_core_rate="3xTF32",
         scalar_float32_bound_ms=scalar_ms, roofline_share=bound_ms / ms)
    # One EM iteration of the fit, in its parts: the tables' upload, the
    # E-step on the device, the statistics' download and the float64
    # M-step on the host.
    ds = gm._dataset(x)
    step = lambda: ek.diag_estep(ds.points, ds.weights,  # noqa: E731
                                 *gm._params_dev())
    st = step()
    on_host = gm._host(st)
    emit("timing", what="one EM iteration of the mixture fit",
         seconds_per_iteration=statistics.median(gm.iter_times_),
         estep_ms=median_ms(step),
         tables_upload_ms=host_ms(lambda: gm._params_dev()),
         stats_download_ms=host_ms(lambda: gm._host(st)),
         m_step_ms=host_ms(lambda: gm._m_step(on_host)),
         n=n, d=d, k=k)
    return row


#: The tensor-core instruction each library's products must compile to:
#: wgmma (HGMMA) for the bf16 K-Means kernels, mma.sync (HMMA) for the
#: 3xTF32 float32 K-Means kernels and the mixture's E-step.
SASS_PRODUCTS = {hk.LIB_NAMES[True]: "HGMMA", hk.LIB_NAMES[False]: "HMMA",
                 ek.LIB_NAME: "HMMA"}


def phase_sass() -> None:
    """Every kernel class runs its products on the tensor cores: counts of
    HGMMA and HMMA instructions in each library's machine code."""
    counts = {}
    for lib_name, want in SASS_PRODUCTS.items():
        sass = subprocess.run(
            [str(Path(_build.find_nvcc()).parent / "cuobjdump"), "-sass",
             str(_build.library_path(lib_name))], capture_output=True,
            text=True, check=True).stdout.splitlines()
        counts[lib_name] = {op: sum(op in line for line in sass)
                            for op in ("HGMMA", "HMMA")}
        check(counts[lib_name][want] > 0,
              f"the {lib_name} library holds no {want} instruction")
    emit("sass", instructions=counts, required=SASS_PRODUCTS)


def phase_bf16_layout() -> None:
    """The bf16 kernels' scratch after prep_centroids_kernel, against its
    mirror in Python (hopper_kernels.tile_images): the tile images bit for
    bit, h = 0.5 ||c||^2 to float32 rounding."""
    lib = hk.bind(_build.load(hk.LIB_NAMES[True]), True)
    tile_k = lib.kmeans_tile_centroids()
    records = []
    for k, d in ((3000, 100), (1024, 128), (5, 7), (10, 784)):
        gen = torch.Generator(device=DEV).manual_seed(k + d)
        c = torch.randn((k, d), generator=gen, device=DEV)
        scratch = hk._scratch(lib, d, k, DEV)
        err = lib.kmeans_prep_centroids_bf16(
            c.data_ptr(), scratch.data_ptr(), d, k,
            torch.cuda.current_stream(DEV).cuda_stream)
        hk._raise_on(err, "prep_centroids")
        torch.cuda.synchronize()
        h, images = hk.split_bf16_scratch(scratch, k)
        want = hk.tile_images(c, tile_k)
        check(images.numel() == want.numel()
              and torch.equal(images.view(torch.int16),
                              want.view(torch.int16)),
              f"bf16 layout ({k}, {d}): the tile images differ from "
              f"hopper_kernels.tile_images")
        h_ref = 0.5 * (c.double() ** 2).sum(1)
        check(close(h.double(), h_ref, 1e-5, 0.0),
              f"bf16 layout ({k}, {d}): h disagrees")
        records.append({"k": k, "d": d, "tile_k": tile_k,
                        "image_bytes": 2 * images.numel(),
                        "h_err": max_err(h.double(), h_ref)})
    emit("bf16_layout", cases=records)


# ------------------------------------------------------------- the mesh

#: Ranks of the shared-card phases: two processes on the one card, over
#: gloo (NCCL refuses two ranks on one GPU).  A check of multi-rank
#: correctness with the real kernels, not a scaling figure.
DP_RANKS = 2
#: Rows of rank 0 in the process-local k-means++ check (rank 1 the rest).
DP_LOCAL_ROWS = 1_000_000
#: Seconds the shared-card children may take before they are killed.
DP_TIMEOUT = 600
DP_NOTE = "two ranks share one card over gloo; not a scaling figure"
MESHES = {"data2": (2, 1), "model2": (1, 2)}
#: Iterations of the mini-batch fit on the data axis of the shared card.
DP_MB_ITERS = 5
MESH_MODES = {"f32": "auto", "bf16": "pallas_bf16"}


def path_kernels(mode: str, model_shards: int) -> tuple:
    """The kernels a mesh fit with ``labels_`` must launch: kernel 1 (or
    1b) per iteration and kernel 2 (2b) for the labels on a data axis;
    kernel 2 (2b) alone under centroid sharding."""
    suffix = "_bf16" if mode == "pallas_bf16" else ""
    if model_shards > 1:
        return ("hopper_assign" + suffix,)
    return ("fused_assign_reduce" + suffix, "hopper_assign" + suffix)


def dp_child(rank: int, world: int, store: str, out: str) -> None:
    """One rank of the shared-card phases (spawned): the main data fitted
    on a data axis and a model axis of two ranks in float32 and bf16, one
    step at the reference's centroids on each, the mini-batch fit on the
    data axis, the device loop's refusal over gloo, process-local
    k-means++ and the mixture on the data axis.
    Writes its results and its own launch counts to ``out.<rank>``."""
    import pickle
    from kmeans_tpu_torch.obs import cost as obs_cost
    from kmeans_tpu_torch.parallel import multihost
    from kmeans_tpu_torch.parallel.mesh import make_mesh
    from kmeans_tpu_torch.parallel.sharding import from_process_local
    multihost.initialize(f"file://{store}", world_size=world, rank=rank,
                         backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(f"{out}.refs", "rb") as f:
        refs = pickle.load(f)
    x, _ = make_blobs_device(MAIN["n"], MAIN["k"], MAIN["d"], device=DEV,
                             seed=1)
    res = {}
    for label, shape in MESHES.items():
        mesh = make_mesh(*shape)
        for prec, mode in MESH_MODES.items():
            km = KMeans(k=MAIN["k"], max_iter=MAIN["iters"], seed=42,
                        compute_sse=True, init="forgy", verbose=False,
                        distance_mode=mode, mesh=mesh)
            hk.reset_launch_counts()       # this path's own counts
            t0 = time.perf_counter()
            km.fit(x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(hk.LAUNCHES)
            ds = km.cache(x)
            chunk = km._chunk_for(ds)
            c_ref = torch.from_numpy(refs[prec]).to(DEV)
            # The step under a cost collector: its collective bytes, the
            # measured side of phase comm.
            _clear_step_caches()
            with obs_cost.collecting() as col:
                st = _step_cached(
                    mesh, chunk_size=chunk, mode=km._mode(),
                    need_farthest=False, need_sse_pc=False)(
                    ds.points, ds.weights, c_ref, km._x2w(ds))
            step_rec = next(r for r in col.records()
                            if _built_by(r, "make_step_fn"))
            step_labels = ds.gather_rows(dist.make_predict_fn(
                mesh, chunk_size=chunk, mode=km._mode())(ds.points, c_ref))
            res[(label, prec)] = dict(
                centroids=km.centroids, labels=km.labels_,
                iterations=km.iterations_run, sse_history=km.sse_history,
                iter_times=km.iter_times_, fit_seconds=wall,
                launches=launches, step_sums=st.sums.cpu(),
                step_counts=st.counts.cpu(), step_labels=step_labels,
                comm=dict(collective_bytes=step_rec.collective_bytes,
                          collectives=step_rec.collectives,
                          rows=int(ds.points.shape[0])))
    # k_shard on the model axis against the dense model-axis fit, 'matmul',
    # from the same table; and one k-sharded step's blocks.
    kmesh = make_mesh(1, DP_RANKS)
    c_k = x[: KSHARD["k"]].cpu().numpy()
    for ks in (0, DP_RANKS):
        km = KMeans(k=KSHARD["k"], max_iter=KSHARD["iters"],
                    tolerance=1e-30, compute_sse=True, init=c_k,
                    verbose=False, compute_labels=False,
                    distance_mode="matmul", mesh=kmesh, k_shard=ks)
        hk.reset_launch_counts()           # this path's own counts
        t0 = time.perf_counter()
        km.fit(x)
        torch.cuda.synchronize()
        res["kshard", ks] = dict(
            centroids=km.centroids, iterations=km.iterations_run,
            sse_history=km.sse_history, iter_times=km.iter_times_,
            resolved=km.k_shard_resolved_, launches=dict(hk.LAUNCHES),
            fit_seconds=time.perf_counter() - t0)
    ds = km.cache(x)
    st = dist.make_kshard_step_fn(kmesh, chunk_size=km._chunk_for(ds))(
        ds.points, ds.weights, torch.from_numpy(c_k).to(DEV))
    res["kshard_block"] = (tuple(st.sums.shape), tuple(st.counts.shape),
                           st.sums.device.type)
    del ds, st, km
    mesh = make_mesh(DP_RANKS, 1)
    # The mini-batch engine on the data axis: each rank draws half of the
    # batch from its own block, statistics and candidates reduced.
    mb = MiniBatchKMeans(k=MINIBATCH["k"], batch_size=MINIBATCH["batch"],
                         max_iter=DP_MB_ITERS, seed=42, init="forgy",
                         n_init=MINIBATCH["n_init"], tolerance=1e-30,
                         reassignment_ratio=MINIBATCH["ratio"],
                         compute_sse=True, verbose=False, host_loop=True,
                         distance_mode="pallas", mesh=mesh)
    hk.reset_launch_counts()               # this path's own counts
    t0 = time.perf_counter()
    mb.fit(x)
    torch.cuda.synchronize()
    res["minibatch"] = dict(
        centroids=mb.centroids, seen=mb._seen, iterations=mb.iterations_run,
        sse_history=mb.sse_history, iter_times=mb.iter_times_,
        fit_seconds=time.perf_counter() - t0, launches=dict(hk.LAUNCHES),
        init_sse=float(mb.init_inertias_[mb.best_init_]),
        final_sse=mb._sse(mb._fit_ds))
    del mb
    try:
        KMeans(k=8, max_iter=2, verbose=False, host_loop=False,
               mesh=mesh).fit(x[:4096])
        res["device_loop_error"] = None
    except ValueError as e:
        res["device_loop_error"] = str(e)
    rows = slice(0, DP_LOCAL_ROWS) if rank == 0 else \
        slice(DP_LOCAL_ROWS, MAIN["n"])
    ds = from_process_local(x[rows].cpu().numpy(), mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    centres = seeding.kmeanspp_init(ds, MAIN["k"], 7, validate=False)
    res["kmeanspp"] = dict(centres=centres,
                           seconds=time.perf_counter() - t0,
                           local_rows=ds.local_rows)
    del x, ds
    x_gmm, _ = kernel_edits.estep_inputs(GMM["n"], GMM["d"], GMM["k"], DEV)
    gm = GaussianMixture(n_components=GMM["k"], init_params="kmeans",
                         max_iter=GMM["iters"], tol=0.0, seed=7, mesh=mesh)
    hk.reset_launch_counts()               # this path's own counts
    t0 = time.perf_counter()
    gm.fit(x_gmm)
    torch.cuda.synchronize()
    res["gmm"] = dict(weights=gm.weights_, means=gm.means_,
                      covariances=gm.covariances_, shift=gm.shift_,
                      lower_bound=gm.lower_bound_, n_iter=gm.n_iter_,
                      iter_times=gm.iter_times_,
                      fit_seconds=time.perf_counter() - t0,
                      launches=dict(hk.LAUNCHES),
                      labels=gm.predict(x_gmm[:PREDICT_ROWS]))
    # One E-step on the mesh at the one-device fit's parameters.
    for name, value in refs["gmm"].items():
        setattr(gm, name, value)
    ds = gm._dataset(x_gmm)
    res["gmm"]["estep"] = [t.cpu() for t in make_gmm_step_fn(
        mesh, chunk_size=gm._chunk(ds), mode=gm._mode())(
        ds.points, ds.weights, *gm._params_dev())]
    del x_gmm, ds, gm
    # 'full' on the data axis, from the one-device fit's starting means.
    gf = GaussianMixture(n_components=FULL["k"], covariance_type="full",
                         max_iter=FULL["iters"], tol=0.0, seed=7,
                         means_init=refs["full"]["means0"], mesh=mesh)
    hk.reset_launch_counts()               # this path's own counts
    t0 = time.perf_counter()
    gf.fit(full_data())
    torch.cuda.synchronize()
    res["gmm_full"] = dict(lower_bound=gf.lower_bound_, means=gf.means_,
                           covariances=gf.covariances_, n_iter=gf.n_iter_,
                           iter_times=gf.iter_times_,
                           fit_seconds=time.perf_counter() - t0,
                           launches=dict(hk.LAUNCHES))
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


def run_ranks(fn, world: int, *args) -> None:
    """``fn(rank, world, *args)`` in ``world`` spawned processes; a child
    that fails or outlives DP_TIMEOUT fails the phase, and every child is
    gone when this returns."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + DP_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"the ranks did not end within {DP_TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()


def phase_dp_shared_card(x, refs, seeding_idx):
    """Two gloo ranks on the one card (``dp_child``), each rank's results
    against the one-device fits of the run: the same iterations; labels
    equal outside the margin band of the reference's centroids; one step at
    the reference's centroids within the sums and counts tolerances
    (a whole fit's centroids move apart wherever a near-tie row changed
    cluster); the launch counts of every rank; the refusal of the device
    loop over gloo; process-local k-means++ rows against the one-device
    draws; the mini-batch fit on the data axis (each rank draws half of
    the batch from its block): both ranks the same bits, kernel 1 once per
    iteration and candidate init, the final SSE below the initial.
    Returns the results of rank 0 and every rank's counts."""
    import pickle
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "out")
        with open(f"{out}.refs", "wb") as f:
            pickle.dump({prec: ref["centroids"] for prec, ref in refs.items()
                         if prec not in ("gmm", "full")}
                        | {"gmm": refs["gmm"], "full": refs["full"]}, f)
        t0 = time.perf_counter()
        run_ranks(dp_child, DP_RANKS, str(Path(tmp) / "store"), out)
        spawn_seconds = time.perf_counter() - t0
        results = []
        for rank in range(DP_RANKS):
            with open(f"{out}.{rank}", "rb") as f:
                results.append(pickle.load(f))
    counts = {}
    w = torch.ones(x.shape[0], device=DEV)
    for label, (data_shards, model_shards) in MESHES.items():
        for prec, mode in MESH_MODES.items():
            ref = refs[prec]
            bf16 = prec == "bf16"
            c_ref = torch.from_numpy(ref["centroids"]).to(DEV)
            ref_labels = torch.from_numpy(ref["labels"]).to(DEV)
            for rank, res in enumerate(results):
                r = res[(label, prec)]
                path = f"dp_shared_card:{label}:{prec}:rank{rank}"
                missing = [name for name in path_kernels(mode, model_shards)
                           if r["launches"].get(name, 0) <= 0]
                check(not missing, f"{path}: kernels never launched: "
                                   f"{missing} ({r['launches']})")
                suffix = "_bf16" if bf16 else ""
                iters = r["iterations"]
                if model_shards > 1:
                    check(r["launches"]["fused_assign_reduce" + suffix] == 0
                          and r["launches"]["hopper_assign" + suffix]
                          == iters + 1,
                          f"{path}: kernel 2 per iteration and for labels_, "
                          f"no kernel 1: {r['launches']}")
                else:
                    check(r["launches"]["fused_assign_reduce" + suffix]
                          == iters, f"{path}: {r['launches']}")
                check(iters == ref["iterations"],
                      f"{path}: {iters} iterations, one device "
                      f"{ref['iterations']}")
                # The step at the reference's centroids: labels against the
                # one-device labels there (its labels_), sums and counts
                # against the plain scatter of the step's own labels.
                step_labels = torch.from_numpy(r["step_labels"]).to(DEV)
                n_diff, n_out = cmp.label_band(x, c_ref, step_labels,
                                               ref_labels, bf16)
                check(n_out == 0, f"{path}: {n_out} step labels outside "
                                  f"the band")
                want_sums, want_counts = cmp.scatter_reference(
                    x, w, step_labels, MAIN["k"], bf16)
                got_sums = r["step_sums"].to(DEV)
                sums_ok = cmp.sums_close(got_sums, want_sums)
                counts_ok = cmp.close(r["step_counts"].to(DEV), want_counts,
                                      cmp.COUNTS_RTOL, 0.0)
                check(sums_ok and counts_ok,
                      f"{path}: the step's sums or counts are off: "
                      f"{cmp.max_err(got_sums, want_sums)}")
                fit_diff, fit_out = cmp.label_band(
                    x, c_ref, torch.from_numpy(r["labels"]).to(DEV),
                    ref_labels, bf16)
                counts[path] = {k: v for k, v in r["launches"].items() if v}
                emit("dp_shared_card", mesh=label, data=data_shards,
                     model=model_shards, distance_mode=mode, rank=rank,
                     iterations=iters, sse_history=r["sse_history"],
                     one_device_sse_history=ref["sse_history"],
                     max_centroid_diff=float(np.abs(
                         r["centroids"].astype(np.float64)
                         - ref["centroids"]).max()),
                     fit_label_diff=fit_diff, fit_label_diff_outside=fit_out,
                     step_label_diff=n_diff, step_sums_within=sums_ok,
                     step_counts_within=counts_ok,
                     step_sums_err=cmp.max_err(got_sums, want_sums),
                     seconds_per_iteration=statistics.median(
                         r["iter_times"]),
                     one_device_seconds_per_iteration=statistics.median(
                         ref["iter_times"]),
                     fit_seconds=r["fit_seconds"], launches=counts[path],
                     note=DP_NOTE)
                # Phase comm: the step's bytes at mesh.all_reduce against
                # the port's bill; on the data axis of two ranks they agree.
                comm = r["comm"]
                line = comm_line(SimpleNamespace(**comm), data_shards,
                                 MAIN["k"], MAIN["d"], model_shards,
                                 comm["rows"])
                print(line["table"], flush=True)
                emit("comm", path=path, mesh=label, rank=rank,
                     crosscheck=line["crosscheck"], note=DP_NOTE)
                if label == "data2":
                    check(line["crosscheck"]["agree"] is True,
                          f"comm {path}: {line['crosscheck']}")
    mbs = [res["minibatch"] for res in results]
    for rank, m in enumerate(mbs):
        path = f"dp_shared_card:data2:minibatch:rank{rank}"
        k1 = m["launches"].get("fused_assign_reduce", 0)
        check(m["iterations"] == DP_MB_ITERS
              and k1 == DP_MB_ITERS + MINIBATCH["n_init"],
              f"{path}: kernel 1 launched {k1} times for {m['iterations']} "
              f"iterations and {MINIBATCH['n_init']} candidate inits")
        check(np.all(np.isfinite(m["centroids"]))
              and m["final_sse"] < m["init_sse"],
              f"{path}: final SSE {m['final_sse']} not below the initial "
              f"centroids' {m['init_sse']}")
        counts[path] = {k: v for k, v in m["launches"].items() if v}
    same = all(np.array_equal(m["centroids"], mbs[0]["centroids"])
               and np.array_equal(m["seen"], mbs[0]["seen"]) for m in mbs)
    check(same, "dp_shared_card minibatch: the ranks' centroids differ")
    emit("dp_shared_card_minibatch", mesh="data2", k=MINIBATCH["k"],
         batch=MINIBATCH["batch"], rows_per_rank=MINIBATCH["batch"]
         // DP_RANKS, iterations=DP_MB_ITERS, ranks_equal=same,
         init_sse=mbs[0]["init_sse"], final_sse=mbs[0]["final_sse"],
         sse_history=mbs[0]["sse_history"],
         seconds_per_iteration=statistics.median(mbs[0]["iter_times"]),
         fit_seconds=mbs[0]["fit_seconds"], note=DP_NOTE)
    seeding_rows = x[torch.from_numpy(seeding_idx).to(DEV)].cpu().numpy()
    for rank, res in enumerate(results):
        check(res["device_loop_error"] is not None
              and "NCCL" in res["device_loop_error"],
              f"rank {rank}: host_loop=False over gloo did not raise")
        pp = res["kmeanspp"]
        equal = int((pp["centres"] == seeding_rows).all(1).sum())
        rec = {"rank": rank, "k": MAIN["k"], "equal_rows": equal,
               "local_rows": pp["local_rows"], "seconds": pp["seconds"]}
        if equal < MAIN["k"]:
            i = int(np.flatnonzero(
                ~(pp["centres"] == seeding_rows).all(1))[0])
            u = float(np.random.default_rng(7).random(MAIN["k"])[i])
            rec["cdf_gap"] = cdf_gap(x, w, seeding_idx, i, u)
        emit("dp_kmeanspp", device_loop_refused=res["device_loop_error"],
             note=DP_NOTE, **rec)
        check(equal == MAIN["k"], f"process-local k-means++ rank {rank}: "
                                  f"{equal} of {MAIN['k']} rows equal")
    block = (-(-KSHARD["k"] // DP_RANKS), MAIN["d"])
    for rank, res in enumerate(results):
        dense, sharded = res["kshard", 0], res["kshard", DP_RANKS]
        same = {"centroids": bool(np.array_equal(sharded["centroids"],
                                                 dense["centroids"])),
                "iterations": sharded["iterations"] == dense["iterations"],
                "sse_history": sharded["sse_history"]
                == dense["sse_history"],
                "ranks": bool(np.array_equal(
                    sharded["centroids"],
                    results[0]["kshard", DP_RANKS]["centroids"]))}
        emit("dp_shared_card_kshard", mesh="model2", k=KSHARD["k"],
             distance_mode="matmul", rank=rank,
             resolved=(dense["resolved"], sharded["resolved"]),
             bit_identical=same, iterations=sharded["iterations"],
             sse_history=sharded["sse_history"],
             step_block=res["kshard_block"],
             seconds_per_iteration={
                 "dense": statistics.median(dense["iter_times"]),
                 "k_shard": statistics.median(sharded["iter_times"])},
             note=DP_NOTE + "; correctness only")
        check(all(same.values()) and sharded["resolved"] == DP_RANKS
              and res["kshard_block"] == (block, block[:1], "cuda"),
              f"dp_shared_card k_shard rank {rank}: {same}, block "
              f"{res['kshard_block']}")
    emit("dp_spawn", ranks=DP_RANKS, seconds=spawn_seconds, note=DP_NOTE)
    return results, counts


def phase_dp_gmm(results, gm, x_gmm, full_ref):
    """The mixture on a data axis of two gloo ranks (from ``dp_child``)
    against the one-device fit of phase ``gmm``: one E-step on the mesh at
    that fit's parameters within the E-step tolerances of the one-device
    E-step (a whole fit's parameters move apart with the summation order of
    its KMeans init and EM), the whole fit's lower bound within LL_RTOL,
    and diag_estep launched by every rank; the parameters' differences and
    the predict rows' labels are reported.  Then 'full' on the data axis
    against the one-device float32 host-loop fit of phase
    ``gmm_full_tied`` (the same starting means): the same iterations, the
    lower bound to FULL_LL_RTOL, the means and covariances by
    ``param_close``."""
    counts = {}
    for rank, res in enumerate(results):
        g = res["gmm_full"]
        rel = abs(g["lower_bound"] - full_ref["lower_bound"]) \
            / abs(full_ref["lower_bound"])
        within = bool(g["n_iter"] == full_ref["n_iter"]
                      and rel <= FULL_LL_RTOL
                      and param_close(g["means"], full_ref["means"])
                      and param_close(g["covariances"],
                                      full_ref["covariances"]))
        emit("dp_gmm_full", rank=rank, n=FULL["n"], d=FULL["d"],
             k=FULL["k"], iterations=g["n_iter"],
             lower_bound=g["lower_bound"],
             one_device_lower_bound=full_ref["lower_bound"],
             lower_bound_rel_diff=rel,
             max_mean_diff=float(np.abs(g["means"]
                                        - full_ref["means"]).max()),
             max_covariance_diff=float(np.abs(
                 g["covariances"] - full_ref["covariances"]).max()),
             within=within,
             seconds_per_iteration=statistics.median(g["iter_times"]),
             one_device_seconds_per_iteration=statistics.median(
                 full_ref["iter_times"]),
             fit_seconds=g["fit_seconds"], note=DP_NOTE)
        check(within, f"dp_gmm_full rank {rank}: off the one-device fit")
    one_device_labels = gm.predict(x_gmm[:PREDICT_ROWS])
    ds = gm._dataset(x_gmm)
    want = make_gmm_step_fn(chunk_size=gm._chunk(ds), mode=gm._mode())(
        ds.points, ds.weights, *gm._params_dev())
    for rank, res in enumerate(results):
        g = res["gmm"]
        path = f"dp_gmm:rank{rank}"
        check(g["launches"].get("diag_estep", 0) == 1 + GMM["iters"]
              and g["launches"].get("fused_assign_reduce", 0) > 0,
              f"{path}: launches {g['launches']}")
        check(g["n_iter"] == gm.n_iter_, f"{path}: {g['n_iter']} EM "
                                         f"iterations")
        estep = cmp.estep_errors([t.to(DEV) for t in g["estep"]], want)
        ll_rel = abs(g["lower_bound"] - gm.lower_bound_) / abs(
            gm.lower_bound_)
        same_labels = int((g["labels"] == one_device_labels).sum())
        counts[path] = {k: v for k, v in g["launches"].items() if v}
        emit("dp_gmm", rank=rank, n=GMM["n"], d=GMM["d"], k=GMM["k"],
             estep_at_one_device_parameters=estep,
             lower_bound=g["lower_bound"],
             one_device_lower_bound=gm.lower_bound_,
             lower_bound_rel_diff=ll_rel,
             max_mean_diff=float(np.abs(g["means"] - gm.means_).max()),
             max_covariance_diff=float(np.abs(
                 g["covariances"] - gm.covariances_).max()),
             predict_rows=PREDICT_ROWS, same_labels=same_labels,
             seconds_per_iteration=statistics.median(g["iter_times"]),
             one_device_seconds_per_iteration=statistics.median(
                 gm.iter_times_),
             fit_seconds=g["fit_seconds"], launches=counts[path],
             note=DP_NOTE)
        check(estep["ok"] and ll_rel <= cmp.LL_RTOL,
              f"{path}: the mesh mixture is off the one-device fit: "
              f"{estep}, lower bound {ll_rel}")
    return counts


def phase_dp_world1(x, refs, minibatch_ref, x_gmm, gmm_ref, stream_ref):
    """One NCCL rank in this process (a FileStore under a temp directory):
    the main data on a mesh of one rank, float32 and bf16, by the host loop
    and the device loop (whose captured graph then holds the NCCL
    collectives), bit for bit against the one-device fits of the run, with
    kernel 1 (1b) once per iteration and kernel 2 (2b) for ``labels_``.
    Then ``MiniBatchKMeans``'s captured loop on that mesh (the batch's
    gather an NCCL ``all_reduce`` inside the graph) bit for bit against the
    one-device loop of phase ``minibatch``, and the mixture's device EM
    loop (the E-step's reduction an NCCL ``all_reduce`` inside the graph)
    bit for bit against the one-device loop of phase ``gmm_device``, and
    the float32 stream of phase ``stream`` bit for bit against its
    one-device fit.
    Seconds per iteration beside
    the one-device figure: the cost of the collectives at world 1.  The
    process group is gone when it returns."""
    from kmeans_tpu_torch.parallel import multihost
    from kmeans_tpu_torch.parallel.mesh import make_mesh
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize(f"file://{tmp}/store", world_size=1, rank=0,
                             backend="nccl")
        try:
            mesh = make_mesh()
            for key, ref in refs.items():
                prec, loop = key
                mode = MESH_MODES[prec]
                km = KMeans(k=MAIN["k"], max_iter=MAIN["iters"], seed=42,
                            compute_sse=True, init="forgy", verbose=False,
                            distance_mode=mode, mesh=mesh,
                            host_loop=loop == "host")
                ds = km.cache(x)
                runs = 1 if loop == "host" else 2
                for run in range(runs):    # the device loop: capture, replay
                    hk.reset_launch_counts()   # this path's own counts
                    km.fit(ds)
                    torch.cuda.synchronize()
                    launches = dict(hk.LAUNCHES)
                path = f"dp_world1:{prec}:{loop}"
                suffix = "_bf16" if prec == "bf16" else ""
                n = km.iterations_run
                check(km.loop_path_ == loop, f"{path}: {km.loop_path_}")
                check(launches["fused_assign_reduce" + suffix] == n
                      and launches["hopper_assign" + suffix] == 1,
                      f"{path}: launches {launches} for {n} iterations")
                same = {"centroids": bool(np.array_equal(
                            km.centroids, ref.centroids)),
                        "sse_history": km.sse_history == ref.sse_history,
                        "labels": bool(np.array_equal(km.labels_,
                                                      ref.labels_)),
                        "iterations": n == ref.iterations_run}
                counts[path] = {k: v for k, v in launches.items() if v}
                emit("dp_world1", distance_mode=mode, loop=loop,
                     bit_identical=same, iterations=n,
                     seconds_per_iteration=statistics.median(km.iter_times_),
                     one_device_seconds_per_iteration=statistics.median(
                         ref.iter_times_), launches=counts[path])
                check(all(same.values()), f"{path}: not bit-identical to "
                                          f"the one-device fit: {same}")
            _dp_world1_comm(x, mesh)
            counts["dp_world1:checkpoint:device"] = _dp_world1_checkpoint(
                x, mesh, refs[("f32", "device")], Path(tmp))
            counts["dp_world1:minibatch:device"] = _dp_world1_minibatch(
                x, mesh, minibatch_ref)
            counts["dp_world1:gmm:device"] = _dp_world1_gmm(x_gmm, mesh,
                                                            gmm_ref)
            counts["dp_world1:stream"] = _dp_world1_stream(mesh,
                                                           *stream_ref)
            counts.update(_dp_world1_ingest(mesh, stream_ref[0],
                                            stream_ref[1]))
        finally:
            torch.distributed.destroy_process_group()
    return counts


def _dp_world1_comm(x, mesh):
    """Phase comm on one NCCL rank: one step of the main fit under a cost
    collector, its collectives against the port's bill.  A world of one
    still sends the statistics over the data axis (nothing is elided), so
    the bill counts them too."""
    from kmeans_tpu_torch.obs import cost as obs_cost
    km = KMeans(k=MAIN["k"], seed=42, init="forgy", verbose=False,
                mesh=mesh)
    ds = km.cache(x)
    _clear_step_caches()
    with obs_cost.collecting() as col:
        _step_cached(mesh, chunk_size=km._chunk_for(ds),
                     mode=km._mode(), need_farthest=False,
                     need_sse_pc=False)(
            ds.points, ds.weights, x[: MAIN["k"]].contiguous(), km._x2w(ds))
    rec = next(r for r in col.records() if _built_by(r, "make_step_fn"))
    line = comm_line(rec, 1, MAIN["k"], MAIN["d"])
    print(line["table"], flush=True)
    emit("comm", path="dp_world1", mesh="world1",
         crosscheck=line["crosscheck"], record=_record_line(rec, 4))
    check(rec.available and rec.collective_bytes > 0,
          f"comm dp_world1: {_record_line(rec, 4)}")


def _dp_world1_checkpoint(x, mesh, ref, tmp):
    """A checkpointed device-loop fit (every 2 of MAIN["iters"]
    iterations) on the one-rank NCCL mesh against the one-device device
    loop ``ref``, bit for bit; one writer, the file complete when ``fit``
    returns (iteration 5, its ``.prev`` 4); kernel 1 once per
    iteration."""
    path = tmp / "world1.npz"
    km = KMeans(k=MAIN["k"], max_iter=MAIN["iters"], seed=42,
                compute_sse=True, init="forgy", verbose=False,
                distance_mode="auto", mesh=mesh, host_loop=False)
    ds = km.cache(x)
    km, seconds, launches = counted(lambda: km.fit(
        ds, checkpoint_every=2, checkpoint_path=path))
    n = km.iterations_run
    same = {"centroids": bool(np.array_equal(km.centroids, ref.centroids)),
            "sse_history": km.sse_history == ref.sse_history,
            "iterations": n == ref.iterations_run,
            "labels": bool(np.array_equal(km.labels_, ref.labels_))}
    files = (iteration_of(path), iteration_of(path, prev=True))
    launches = {k: v for k, v in launches.items() if v}
    emit("dp_world1", model="KMeans", loop="device", checkpoint_every=2,
         bit_identical=same, iterations=n,
         checkpoints=km.checkpoint_segments_, files=files,
         fit_seconds=seconds, launches=launches)
    check(all(same.values()) and km.checkpoint_segments_ == 3
          and files == (n, n - 1)
          and launches.get("fused_assign_reduce", 0) == n,
          f"dp_world1 checkpoint: bit-identical {same}, files {files}, "
          f"launches {launches}")
    return launches


def _dp_world1_minibatch(x, mesh, ref):
    """The mini-batch loop on the one-rank mesh, fitted twice (capture,
    replay), against the one-device loop ``ref``: centroids, lifetime
    counts and SSE history bit for bit; kernel 1 once per iteration plus
    once per candidate init."""
    it, n_init = MINIBATCH["iters"], MINIBATCH["n_init"]
    mb = MiniBatchKMeans(k=MINIBATCH["k"], batch_size=MINIBATCH["batch"],
                         max_iter=it, seed=42, compute_sse=True,
                         init="forgy", verbose=False, tolerance=1e-30,
                         n_init=n_init, host_loop=False,
                         reassignment_ratio=MINIBATCH["ratio"],
                         distance_mode="pallas", mesh=mesh)
    ds = mb.cache(x)
    for _ in range(2):
        hk.reset_launch_counts()
        mb.fit(ds)
        torch.cuda.synchronize()
    launches = {k: v for k, v in hk.LAUNCHES.items() if v}
    same = {"centroids": bool(np.array_equal(mb.centroids, ref.centroids)),
            "seen": bool(np.array_equal(mb._seen, ref._seen)),
            "sse_history": mb.sse_history == ref.sse_history,
            "iterations": mb.iterations_run == ref.iterations_run}
    emit("dp_world1", model="MiniBatchKMeans", loop="device",
         bit_identical=same, iterations=mb.iterations_run,
         seconds_per_iteration=mb.iter_times_[0],
         one_device_seconds_per_iteration=ref.iter_times_[0],
         launches=launches)
    check(launches.get("fused_assign_reduce", 0) == it + n_init,
          f"dp_world1 minibatch: launches {launches}")
    check(all(same.values()), f"dp_world1 minibatch: not bit-identical to "
                              f"the one-device loop: {same}")
    return launches


def _dp_world1_gmm(x_gmm, mesh, ref):
    """The mixture's device EM loop on the one-rank mesh, fitted twice
    (capture, replay), against the one-device loop ``ref``: means,
    covariances, weights and lower bound bit for bit; diag_estep once for
    the init and once per iteration."""
    gm = GaussianMixture(n_components=GMM["k"], init_params="kmeans",
                         max_iter=GMM["iters"], tol=0.0, seed=7,
                         host_loop=False, mesh=mesh)
    ds = gm._dataset(x_gmm)
    for _ in range(2):
        seconds, launches = timed_fit(gm, ds)
    launches = {k: v for k, v in launches.items() if v}
    same = {f: bool(np.array_equal(getattr(gm, f), getattr(ref, f)))
            for f in ("means_", "covariances_", "weights_")}
    same["lower_bound"] = gm.lower_bound_ == ref.lower_bound_
    same["iterations"] = gm.n_iter_ == ref.n_iter_
    emit("dp_world1", model="GaussianMixture", loop="device",
         bit_identical=same, iterations=gm.n_iter_,
         seconds_per_iteration=gm.iter_times_[0],
         one_device_seconds_per_iteration=ref.iter_times_[0],
         launches=launches)
    check(launches.get("diag_estep", 0) == 1 + gm.n_iter_,
          f"dp_world1 gmm: launches {launches}")
    check(all(same.values()), f"dp_world1 gmm: not bit-identical to the "
                              f"one-device loop: {same}")
    return launches


def phase_suite():
    """``python -m kmeans_tpu_torch.suite`` as a subprocess on the card:
    tests A to E of the original project, exit code 0."""
    import os
    import signal
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        # A session of its own: on expiry the suite and any ranks it
        # spawned are killed together.
        proc = subprocess.Popen(
            [sys.executable, "-m", "kmeans_tpu_torch.suite", "--out-dir",
             tmp], cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, start_new_session=True)
        try:
            stdout, stderr = proc.communicate(timeout=DP_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise SmokeFailure(f"the suite did not end in {DP_TIMEOUT} s")
        seconds = time.perf_counter() - t0
        svg = (Path(tmp) / "speedup_graph.svg").is_file()
    for line in stdout.splitlines():
        print(line, flush=True)
    emit("suite", exit_code=proc.returncode, seconds=seconds,
         speedup_graph_svg=svg, stderr_tail=stderr[-2000:])
    check(proc.returncode == 0 and svg, f"the suite exited "
                                        f"{proc.returncode}")


# ----------------------------------------------- observability (A.13)

#: Iterations of the fits of phases ``ttfi`` and ``spans``.
TTFI_ITERS = 2
SPAN = dict(iters=3, dev_iters=4, every=2, kill=2, stream_iters=2)
#: The phase ladder: CUDA-event reps per rung, and the two chain lengths
#: whose difference is one pass.
LADDER_REPS = 5
LADDER_CHAIN = (1, 3)
#: Kernel 1's profiled device time against phase ``timing``'s CUDA-event
#: median: a ratio outside 1 +- this is a finding to write down, not a
#: failure.
PROFILE_BAND = 0.15
#: The kernels one launch of kernel 1 (``fused_assign_reduce``) runs.
KERNEL1_PARTS = ("fused_assign_reduce_kernel", "reduce_partials_kernel",
                 "split_centroids_kernel", "shift_kernel")

#: A fresh interpreter's fit of the main shape under a tracer, for the
#: time-to-first-iteration report: argv n, d, k, loop, repo root.  The data
#: is made with NumPy before the clock starts; the clock starts before
#: ``import torch`` and ``import kmeans_tpu_torch``.
TTFI_CHILD = r"""
import json, os, sys, time
import numpy as np
data, k, loop, root, iters, overlap = (
    sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4],
    int(sys.argv[5]), int(sys.argv[6]))
x = np.load(data)
t_start = time.perf_counter()
sys.path.insert(0, root)
import torch
from kmeans_tpu_torch import KMeans, obs
from kmeans_tpu_torch.ops import _build
from kmeans_tpu_torch.parallel import distributed as dist
with obs.tracing() as tr:
    km = KMeans(k=k, max_iter=iters, seed=42, init="forgy",
                tolerance=1e-30, compute_labels=False, verbose=False,
                host_loop=loop == "host", device="cuda", overlap=overlap)
    km.fit(x)
recs = tr.records()
rows = obs.time_to_first_iteration(recs)
first = min((r for r in recs if r.get("kind") == "span"
             and r["name"] == "dispatch"), key=lambda r: r["t0"])
spans = [r for r in recs if r.get("kind") == "span"]
via = [(r.get("attrs") or {}).get("via") for r in spans
       if r["name"] == "compile"]
libs = [{"via": r["attrs"]["via"], "ms": r["dur"] * 1e3}
        for r in spans if r["name"] == "compile"
        and "source" in r.get("attrs", {})]
main_tid = [r["tid"] for r in spans if r["name"] == "dispatch"][0]
# The copy's own span ('stage' of the placement), not the producer's
# 'stage' (via='prefetch') that holds the whole placement.
copy = [r for r in spans if r["name"] == "stage"
        and (r.get("attrs") or {}).get("via") != "prefetch"]
print(json.dumps({"rows": rows, "table": obs.format_phase_table(rows),
                  "wall": tr._t0 - t_start + first["t1"], "via": via,
                  "library_loads": libs,
                  "stage_ms": sum(r["dur"] for r in copy) * 1e3,
                  "stage_on_producer": all(r["tid"] != main_tid
                                           for r in copy),
                  "build_dir": str(_build.BUILD_DIR),
                  "nvcc_runs": _build.NVCC_RUNS,
                  "libraries": len(_build._LIBS),
                  "captures": sum(dist.CAPTURES.values()),
                  "loop_path": km.loop_path_,
                  "iterations": km.iterations_run}))
"""


def _ttfi_data(path: Path) -> Path:
    """The host data of the ``ttfi`` fits (the main shape: blobs around k
    uniform centres, NumPy's generator, seed 1), made once and written as
    ``.npy``; each child reads it before its clock starts."""
    n, d, k = MAIN["n"], MAIN["d"], MAIN["k"]
    rng = np.random.default_rng(1)
    centres = rng.uniform(-10, 10, size=(k, d)).astype(np.float32)
    x = centres[rng.integers(0, k, size=n)]
    x += rng.standard_normal((n, d), dtype=np.float32)
    np.save(path, x)
    return path


def _ttfi_run(data: Path, loop: str, overlap: int, build_dir=None) -> dict:
    """One fresh interpreter's traced main fit (:data:`TTFI_CHILD`) on the
    rows of ``data``; with ``build_dir`` an empty build directory
    (``KMEANS_TPU_TORCH_BUILD_DIR``), so the kernel library is built by
    ``nvcc`` inside the fit."""
    import os
    root = str(Path(__file__).resolve().parent)
    env = {k: v for k, v in os.environ.items()
           if k not in ("KMEANS_TPU_TORCH_BUILD_DIR",
                        "KMEANS_TPU_TORCH_AOT_CACHE")}
    if build_dir is not None:
        env["KMEANS_TPU_TORCH_BUILD_DIR"] = str(build_dir)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", TTFI_CHILD, str(data), str(MAIN["k"]), loop,
         root, str(TTFI_ITERS), str(overlap)],
        capture_output=True, text=True, timeout=600, env=env)
    check(proc.returncode == 0, f"ttfi {loop} overlap={overlap}: exit "
                                f"{proc.returncode}: {proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res["process_seconds"] = time.perf_counter() - t0
    return res


def _ttfi_check(res: dict, loop: str, overlap: int, cold: bool) -> None:
    """Print and check one ``ttfi`` process (:func:`phase_ttfi`)."""
    print(res["table"], flush=True)
    rows = {r["phase"]: r["ms"] for r in res["rows"]}
    total = sum(rows.values()) / 1e3
    graphs = res["via"].count("graph-capture")
    lib_via = [lv["via"] for lv in res["library_loads"]]
    label = f"{loop}/overlap={overlap}/" + ("cold" if cold else "built")
    emit("ttfi", loop=loop, overlap=overlap,
         build="cold" if cold else "built", rows_ms=rows,
         rows_seconds=total,
         wall_seconds_import_to_first_dispatch=res["wall"],
         compile_spans=res["via"], library_loads=res["library_loads"],
         stage_ms=res["stage_ms"],
         stage_on_producer=res["stage_on_producer"],
         nvcc_runs=res["nvcc_runs"], libraries=res["libraries"],
         captures=res["captures"], iterations=res["iterations"],
         process_seconds=res["process_seconds"])
    check(res["loop_path"] == loop and all(v >= 0 for v in rows.values())
          and (overlap or total <= res["wall"])
          and list(rows) == ["place", "stage", "trace", "compile", "seed",
                             "first_dispatch"],
          f"ttfi {label}: rows {rows} sum {total} s, wall {res['wall']} s")
    want = "nvcc" if cold else "load"
    check(len(lib_via) == res["libraries"] and set(lib_via) == {want}
          and res["nvcc_runs"] == (res["libraries"] if cold else 0)
          and graphs == res["captures"]
          and graphs == (1 if loop == "device" else 0)
          and res["stage_on_producer"] == bool(overlap),
          f"ttfi {label}: library loads {res['library_loads']}, "
          f"{res['nvcc_runs']} nvcc, compile spans {res['via']}, "
          f"{res['captures']} captures, stage on the producer "
          f"{res['stage_on_producer']}")


def phase_ttfi():
    """The main fit in fresh interpreters, traced: the time-to-first-
    iteration table from its spans alone (``obs.time_to_first_iteration``),
    beside the process's wall time from before ``import torch`` to the end
    of the first dispatch; by the host and the device loop, with
    ``overlap`` 0 and 1, once finding the kernel library built and once
    from an empty build directory (cold: ``nvcc`` inside the fit).  Every
    row >= 0; without overlap their sum at most that wall time; one library
    load per library (``via`` 'load' built, 'nvcc' cold), one ``compile``
    span per graph captured; with overlap the 1 GiB 'stage' runs on the
    producer thread beside the load.  Whether the wall drops by about the
    smaller of the stage and the library load is printed, a finding, not a
    gate.  No cost collector is on (its profiler's start-up would land in
    a span)."""
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = _ttfi_data(Path(tmp) / "ttfi.npy")
        for cold, loop, overlap in [(c, lp, o) for c in (False, True)
                                    for lp in ("host", "device")
                                    for o in (0, 1)]:
            res = _ttfi_run(data, loop, overlap,
                            Path(tmp) / f"build_{loop}_{overlap}"
                            if cold else None)
            _ttfi_check(res, loop, overlap, cold)
            walls[f"{loop}/overlap={overlap}/" +
                  ("cold" if cold else "built")] = res
    for cold in ("built", "cold"):
        for loop in ("host", "device"):
            serial = walls[f"{loop}/overlap=0/{cold}"]
            lapped = walls[f"{loop}/overlap=1/{cold}"]
            load_ms = sum(lv["ms"] for lv in serial["library_loads"])
            emit("ttfi_overlap", loop=loop, build=cold,
                 wall_overlap0_s=serial["wall"],
                 wall_overlap1_s=lapped["wall"],
                 wall_drop_ms=(serial["wall"] - lapped["wall"]) * 1e3,
                 stage_ms=serial["stage_ms"], library_load_ms=load_ms,
                 smaller_of_the_two_ms=min(serial["stage_ms"], load_ms))


#: The checkpointed fit of phase ``warm_start``: iterations in all, the
#: checkpoint cadence and the boundary process A stops at.
WARM = dict(iters=4, every=2, kill=2)

#: One process of phase ``warm_start`` (argv: repo root, a JSON config):
#: the main data made on the card (the same generator and seed as the
#: parent's), then by ``role``: 'ship' fits with a store and checkpoints and
#: is killed at ``WARM['kill']``; 'resume' and 'corrupt' resume the
#: checkpoint and predict.  ``hide_nvcc`` replaces ``_build.find_nvcc`` by
#: one that counts and raises.  Prints one JSON line; arrays go to files.
WARM_CHILD = r"""
import json, sys, time
t_start = time.perf_counter()
root, cfg = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, root)
import numpy as np
import torch
from kmeans_tpu_torch import KMeans, obs
from kmeans_tpu_torch.data.synthetic import make_blobs_device
from kmeans_tpu_torch.obs import metrics_registry
from kmeans_tpu_torch.ops import _build
from kmeans_tpu_torch.utils import aot, faults
find_calls = []
if cfg["hide_nvcc"]:
    def hidden():
        find_calls.append(1)
        raise _build.KernelCompileError("nvcc is hidden in this process")
    _build.find_nvcc = hidden
store = aot.configure(cfg["store"])
dev = torch.device(cfg["device"])
x, _ = make_blobs_device(cfg["n"], cfg["k"], cfg["d"], device=dev, seed=1)
kw = dict(k=cfg["k"], max_iter=cfg["iters"], seed=42, init="forgy",
          tolerance=1e-30, verbose=False, device=dev)
out = {"role": cfg["role"], "x_sum": float(x.double().sum())}
_build.reset_launch_counts()
with obs.tracing() as tr:
    if cfg["role"] == "ship":
        with faults.inject_kill_after_iteration(cfg["kill"]) as rec:
            try:
                KMeans(**kw).fit(x, checkpoint_every=cfg["every"],
                                 checkpoint_path=cfg["ckpt"])
            except faults.SimulatedPreemption:
                pass
        out["killed_at"] = rec["fired_at"]
        out["shipped"] = aot.describe_dir(aot.aot_dir_for(cfg["ckpt"]))
    else:
        km = KMeans(**kw).fit(x, resume=cfg["ckpt"])
        labels = km.predict(x)
        np.save(cfg["out"] + ".centroids.npy", km.centroids)
        np.save(cfg["out"] + ".labels.npy", labels)
        np.save(cfg["out"] + ".labels_.npy", km.labels_)
        out["iterations"] = km.iterations_run
        out["read_dirs"] = [str(d) for d in store.read_dirs]
recs = tr.records()
spans = [r for r in recs if r.get("kind") == "span"]
out["library_loads"] = [
    {"source": r["attrs"]["source"], "via": r["attrs"]["via"],
     "ms": r["dur"] * 1e3}
    for r in spans if r["name"] == "compile" and "source" in r["attrs"]]
out["compile_spans"] = [dict(r["attrs"], ms=r["dur"] * 1e3)
                        for r in spans if r["name"] == "compile"]
first = min((r for r in spans if r["name"] == "dispatch"),
            key=lambda r: r["t0"])
out["ttfi_rows"] = obs.time_to_first_iteration(recs)
out["wall_to_first_dispatch_s"] = tr._t0 - t_start + first["t1"]
out["nvcc_runs"] = _build.NVCC_RUNS
out["find_nvcc_calls"] = len(find_calls)
out["aot_fallback"] = metrics_registry.REGISTRY.counter(
    "aot.fallback").value
out["store"] = store.stats()
out["launches"] = {k: v for k, v in _build.LAUNCHES.items() if v}
print(json.dumps(out))
"""


def _warm_child(cfg: dict, *, hide_nvcc: bool, build_dir: Path) -> dict:
    """Run :data:`WARM_CHILD` with its own empty build directory; with
    ``hide_nvcc`` no ``nvcc`` on its ``PATH`` and ``CUDA_HOME`` /
    ``CUDA_PATH`` pointing nowhere (``find_nvcc`` is also replaced)."""
    import os
    root = str(Path(__file__).resolve().parent)
    env = {k: v for k, v in os.environ.items()
           if k not in ("KMEANS_TPU_TORCH_AOT_CACHE", "CUDA_HOME",
                        "CUDA_PATH")}
    env["KMEANS_TPU_TORCH_BUILD_DIR"] = str(build_dir)
    if hide_nvcc:
        env["PATH"] = os.pathsep.join(
            p for p in env.get("PATH", "").split(os.pathsep)
            if p and not (Path(p) / "nvcc").exists())
        env["CUDA_HOME"] = env["CUDA_PATH"] = str(build_dir / "no-cuda")
    cfg = dict(cfg, hide_nvcc=hide_nvcc, n=MAIN["n"], d=MAIN["d"],
               k=MAIN["k"], iters=WARM["iters"], every=WARM["every"],
               kill=WARM["kill"], device=str(DEV))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", WARM_CHILD, root,
                           json.dumps(cfg)], capture_output=True, text=True,
                          timeout=600, env=env)
    check(proc.returncode == 0, f"warm_start {cfg['role']}: exit "
                                f"{proc.returncode}: {proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res["process_seconds"] = time.perf_counter() - t0
    res["build_dir_files"] = sorted(p.name for p in build_dir.glob("*.so"))
    return res


def _corrupt_artifacts(aot_dir: Path) -> int:
    """Flip one byte of the library inside every artefact of ``aot_dir``
    (a valid zip whose bytes no longer match their sha256)."""
    import zipfile
    flipped = 0
    for art in sorted(aot_dir.glob("*.klib")):
        with zipfile.ZipFile(art) as z:
            meta, data = z.read("meta.json"), bytearray(z.read("lib.so"))
        data[len(data) // 2] ^= 0x01
        with zipfile.ZipFile(art, "w") as z:
            z.writestr("meta.json", meta)
            z.writestr("lib.so", bytes(data))
        flipped += 1
    return flipped


def phase_warm_start(x):
    """Warm start from the libraries a checkpoint ships, in three fresh
    interpreters, each with an empty build directory of its own
    (``KMEANS_TPU_TORCH_BUILD_DIR``).  A: with ``nvcc`` and a store under a
    temporary directory, the main fit checkpointed every
    ``WARM['every']`` iterations and killed at ``WARM['kill']``; the
    checkpoint's ``.aot`` directory lists the library of kernels 1 and 2
    (``assign_kernels``: one source, one library).  B: ``nvcc`` hidden, an
    empty store: ``fit(resume=ckpt)`` and ``predict``; no ``nvcc`` started,
    every library load ``via='aot-load'``, the centroids and labels bit-
    equal to an uninterrupted ``WARM['iters']``-iteration fit in this
    process.  C: the shipped artefact with one byte flipped: ``aot.fallback``
    counts 1, the kernel is rebuilt by ``nvcc`` (one run), the same labels.
    Prints each library load's ``compile`` span (a cold ``nvcc`` build
    against an ``aot-load``) and each process's time to first iteration.
    Returns the launches of B and C."""
    import shutil
    kw = dict(k=MAIN["k"], max_iter=WARM["iters"], seed=42, init="forgy",
              tolerance=1e-30, verbose=False)
    ref, _, ref_launches = counted(lambda: KMeans(**kw).fit(x))
    ref_labels = ref.predict(x)
    x_sum = float(x.double().sum())
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = tmp / "ship" / "model.npz"
        ckpt.parent.mkdir()
        a = _warm_child(dict(role="ship", store=str(tmp / "store_a"),
                             ckpt=str(ckpt)),
                        hide_nvcc=False, build_dir=tmp / "build_a")
        shipped = a["shipped"]
        libs = [d["library"] for d in shipped["libraries"]]
        emit("warm_start", process="A", killed_at=a["killed_at"],
             shipped=shipped, library_loads=a["library_loads"],
             nvcc_runs=a["nvcc_runs"], store=a["store"],
             ttfi_rows=a["ttfi_rows"],
             wall_to_first_dispatch_s=a["wall_to_first_dispatch_s"],
             process_seconds=a["process_seconds"])
        check(a["x_sum"] == x_sum and a["killed_at"] == WARM["kill"]
              and a["nvcc_runs"] >= 1 and "assign_kernels" in libs
              and shipped["unreadable"] == 0
              and all(lv["via"] == "nvcc" for lv in a["library_loads"]),
              f"warm_start A: killed at {a['killed_at']}, nvcc "
              f"{a['nvcc_runs']}, shipped {shipped}, loads "
              f"{a['library_loads']}")
        b = _warm_child(dict(role="resume", store=str(tmp / "store_b"),
                             ckpt=str(ckpt), out=str(tmp / "b")),
                        hide_nvcc=True, build_dir=tmp / "build_b")
        b_cents = np.load(tmp / "b.centroids.npy")
        b_labels = np.load(tmp / "b.labels.npy")
        bit_equal = (np.array_equal(b_cents, ref.centroids)
                     and np.array_equal(b_labels, ref_labels)
                     and np.array_equal(np.load(tmp / "b.labels_.npy"),
                                        ref.labels_))
        emit("warm_start", process="B", nvcc_runs=b["nvcc_runs"],
             find_nvcc_calls=b["find_nvcc_calls"],
             library_loads=b["library_loads"],
             compile_spans=b["compile_spans"], store=b["store"],
             read_dirs=b["read_dirs"], iterations=b["iterations"],
             bit_equal_to_uninterrupted=bit_equal,
             build_dir_files=b["build_dir_files"], launches=b["launches"],
             ttfi_rows=b["ttfi_rows"],
             wall_to_first_dispatch_s=b["wall_to_first_dispatch_s"],
             process_seconds=b["process_seconds"])
        check(b["x_sum"] == x_sum and b["nvcc_runs"] == 0
              and b["find_nvcc_calls"] == 0 and b["library_loads"]
              and all(lv["via"] == "aot-load"
                      for lv in b["library_loads"])
              and b["store"]["loaded"] == len(b["library_loads"])
              and b["store"]["fallbacks"] == 0
              and b["iterations"] == WARM["iters"] and bit_equal
              and b["launches"].get("fused_assign_reduce", 0) > 0
              and b["launches"].get("hopper_assign", 0) > 0,
              f"warm_start B: nvcc {b['nvcc_runs']} (find_nvcc "
              f"{b['find_nvcc_calls']}), loads {b['library_loads']}, store "
              f"{b['store']}, iterations {b['iterations']}, bit-equal "
              f"{bit_equal}, launches {b['launches']}")
        counts["warm_start_resume"] = b["launches"]
        bad = tmp / "bad" / "model.npz"
        shutil.copytree(ckpt.parent, bad.parent)
        flipped = _corrupt_artifacts(aot_dir := bad.with_name(
            bad.name + ".aot"))
        c = _warm_child(dict(role="corrupt", store=str(tmp / "store_c"),
                             ckpt=str(bad), out=str(tmp / "c")),
                        hide_nvcc=False, build_dir=tmp / "build_c")
        c_labels = np.load(tmp / "c.labels.npy")
        same = (np.array_equal(c_labels, b_labels)
                and np.array_equal(np.load(tmp / "c.centroids.npy"),
                                   b_cents))
        emit("warm_start", process="C", flipped=flipped,
             aot_dir=str(aot_dir), aot_fallback=c["aot_fallback"],
             nvcc_runs=c["nvcc_runs"], library_loads=c["library_loads"],
             store=c["store"], same_as_b=same, launches=c["launches"],
             ttfi_rows=c["ttfi_rows"],
             wall_to_first_dispatch_s=c["wall_to_first_dispatch_s"],
             process_seconds=c["process_seconds"])
        check(flipped >= 1 and c["aot_fallback"] == 1
              and c["store"]["fallbacks"] == 1 and c["nvcc_runs"] == 1
              and [lv["via"] for lv in c["library_loads"]] == ["nvcc"]
              and same,
              f"warm_start C: {flipped} flipped, aot.fallback "
              f"{c['aot_fallback']}, nvcc {c['nvcc_runs']}, loads "
              f"{c['library_loads']}, same labels {same}")
        counts["warm_start_corrupt"] = c["launches"]
    nvcc_ms = [lv["ms"] for lv in a["library_loads"]]
    load_ms = [lv["ms"] for lv in b["library_loads"]]
    emit("warm_start_summary", nvcc_build_ms=nvcc_ms, aot_load_ms=load_ms,
         ttfi_wall_s={"A": a["wall_to_first_dispatch_s"],
                      "B": b["wall_to_first_dispatch_s"],
                      "C": c["wall_to_first_dispatch_s"]},
         reference_launches={k_: v for k_, v in ref_launches.items() if v})
    return counts


#: Rows of the cut main data of phase ``bucket``, and of its second fit in
#: the same bucket (``bucket_rows`` of both: 2,097,152).
BUCKET = dict(rows=2_000_000, second=1_900_000, iters=3)


def phase_bucket(x):
    """The main data cut to ``BUCKET['rows']`` rows with ``bucket='auto'``:
    the dataset padded to 2,097,152 rows (weight 0), its labels equal to a
    ``bucket=0`` fit's and its centroids within the sums' class of
    ``ops/compare.py``; by the host loop and the device loop.  Then a fit on
    ``BUCKET['second']`` rows in the same bucket under
    ``recompilation_sentinel``: no step-cache entry and no library by the
    host loop; by the device loop exactly one new entry, the capture of
    the new dataset's graph.  Returns the launches of each path."""
    from kmeans_tpu_torch.utils.profiling import (CAPTURES,
                                                  recompilation_sentinel)
    n0, n1 = BUCKET["rows"], BUCKET["second"]
    check(sharding.bucket_rows(n0) == sharding.bucket_rows(n1)
          == MAIN["n"], "bucket: the two row counts share the bucket")
    counts = {}
    xa, xb = x[:n0], x[n0 - n1:n0]
    for loop in ("host", "device"):
        kw = dict(k=MAIN["k"], max_iter=BUCKET["iters"], seed=42,
                  init="forgy", tolerance=1e-30, verbose=False,
                  host_loop=loop == "host")
        path = "bucket" if loop == "host" else "bucket_device"
        exact, exact_s, _ = counted(lambda: KMeans(bucket=0, **kw).fit(xa))
        auto, auto_s, launches = counted(
            lambda: KMeans(bucket="auto", **kw).fit(xa))
        counts[path] = launches
        ds = KMeans(bucket="auto", **kw).cache(xa)
        padded = (ds.n, int(ds.points.shape[0]),
                  float(ds.weights[n0:].sum()))
        del ds
        labels_equal = np.array_equal(auto.labels_, exact.labels_)
        ca = torch.from_numpy(auto.centroids).to(DEV)
        ce = torch.from_numpy(exact.centroids).to(DEV)
        cents_ok = cmp.sums_close(ca, ce)
        with recompilation_sentinel(
                allowed_new=1 if loop == "device" else 0) as rec:
            second, second_s, _ = counted(
                lambda: KMeans(bucket="auto", **kw).fit(xb))
        new = {name: [repr(k_) for k_ in keys]
               for name, keys in rec["new"].items()}
        emit("bucket", loop=loop, rows=n0, padded_to=padded[1],
             real_rows=padded[0], pad_weight=padded[2],
             labels_equal=labels_equal, centroids_within_class=cents_ok,
             centroids_bit_equal=bool(np.array_equal(auto.centroids,
                                                     exact.centroids)),
             centroid_max_err=max_err(ca, ce),
             iterations=(exact.iterations_run, auto.iterations_run),
             fit_seconds={"bucket0": exact_s, "auto": auto_s,
                          "second": second_s},
             second_rows=n1, sentinel_new=new,
             launches={k_: v for k_, v in launches.items() if v})
        check(padded == (n0, MAIN["n"], 0.0) and labels_equal and cents_ok
              and exact.iterations_run == auto.iterations_run
              and second.labels_.shape == (n1,),
              f"bucket {loop}: padded {padded}, labels equal "
              f"{labels_equal}, centroids within class {cents_ok}")
        want = ({CAPTURES: 1} if loop == "device" else {})
        check({name: len(keys) for name, keys in new.items()} == want,
              f"bucket {loop}: the same-bucket fit made {new}")
        check_path_launches(path)
    return counts


#: Phase ``determinism``: runs of each check, and the Lloyd iterations.
DETERMINISM = dict(runs=3, iters=2)


def phase_determinism(x, x_gmm):
    """``utils.debug.check_determinism(runs=3)`` at the main shape, 2
    iterations, on the card: KMeans in 'kernel' by the host loop and the
    device loop (kernels 1 and 2), in 'kernel_bf16' (1b, 2b) and in
    'matmul'; ``GaussianMixture`` 'diag' at k = 256 (``diag_estep``) on the
    mixture data; ``MiniBatchKMeans``.  Each must be deterministic.
    ``assign='two_level'`` at k = 16,384 is run and its verdict printed,
    not asserted: its sums are a scatter-add (ROADMAP C)."""
    from kmeans_tpu_torch.utils.debug import check_determinism
    it = DETERMINISM["iters"]
    base = dict(seed=42, init="forgy", tolerance=1e-30, verbose=False,
                compute_sse=True)
    cases = {
        "kernel_host": lambda: KMeans(k=MAIN["k"], max_iter=it,
                                      distance_mode="kernel",
                                      host_loop=True, **base),
        "kernel_device": lambda: KMeans(k=MAIN["k"], max_iter=it,
                                        distance_mode="kernel",
                                        host_loop=False, **base),
        "kernel_bf16": lambda: KMeans(k=MAIN["k"], max_iter=it,
                                      distance_mode="kernel_bf16", **base),
        "matmul": lambda: KMeans(k=MAIN["k"], max_iter=it,
                                 distance_mode="matmul", **base),
        "minibatch": lambda: MiniBatchKMeans(
            k=MAIN["k"], batch_size=MINIBATCH["batch"], max_iter=it,
            seed=42, init="forgy", verbose=False),
        "gmm_diag": lambda: GaussianMixture(
            n_components=GMM["k"], covariance_type="diag", max_iter=it,
            tol=0.0, seed=7, init_params="random", verbose=False),
    }
    want = {"kernel_host": ("fused_assign_reduce", "hopper_assign"),
            "kernel_device": ("fused_assign_reduce", "hopper_assign"),
            "kernel_bf16": ("fused_assign_reduce_bf16",
                            "hopper_assign_bf16"),
            "matmul": (),
            "minibatch": ("fused_assign_reduce", "hopper_assign"),
            "gmm_diag": ("diag_estep",)}
    counts = {}
    for name, factory in cases.items():
        data = x_gmm if name == "gmm_diag" else x
        rep, seconds, launches = counted(
            lambda: check_determinism(factory, data,
                                      runs=DETERMINISM["runs"]))
        counts[f"determinism:{name}"] = launches
        emit("determinism", case=name, deterministic=rep["deterministic"],
             runs=rep["runs"], details=rep["details"], seconds=seconds,
             launches={k_: v for k_, v in launches.items() if v})
        check(rep["deterministic"] and all(
            launches.get(kn, 0) > 0 for kn in want[name]),
              f"determinism {name}: {rep}, launches {launches}")
    rep, seconds, launches = counted(lambda: check_determinism(
        lambda: KMeans(k=LARGE_K["k"], max_iter=it, assign="two_level",
                       coarse_cells=LARGE_K["cells"],
                       nprobe=LARGE_K["nprobe"], **base),
        x, runs=DETERMINISM["runs"]))
    emit("determinism", case="two_level", asserted=False,
         deterministic=rep["deterministic"], runs=rep["runs"],
         details=rep["details"], seconds=seconds,
         launches={k_: v for k_, v in launches.items() if v})
    return counts


def _record_line(rec, top: int = 8) -> dict:
    """A cost record's measured figures, its heaviest device kernels."""
    return {"program": rec.cache, "region": rec.region,
            "available": rec.available, "error": rec.error,
            "flops": rec.flops, "flops_source": rec.flops_source,
            "flops_aten": rec.flops_aten,
            "flops_declared": rec.flops_declared,
            "device_ms": rec.device_ms,
            "kernels": (rec.kernels or [])[:top],
            "hand_kernel_launches": rec.launches,
            "peak_bytes": rec.peak_bytes, "arg_bytes": rec.arg_bytes,
            "out_bytes": rec.out_bytes, "temp_bytes": rec.temp_bytes,
            "collective_bytes": rec.collective_bytes}


def _kernel1_ms(rec) -> float:
    """Kernel 1's profiled milliseconds per launch in a record."""
    ms = sum(k["ms"] for k in rec.kernels or []
             if any(k["name"].startswith(part) for part in KERNEL1_PARTS))
    return ms / max(rec.launches.get("fused_assign_reduce", 0), 1)


def _clear_step_caches():
    """Empty the step caches: a cost record is taken at a cache's miss."""
    from kmeans_tpu_torch.utils.profiling import compile_caches
    for cache in compile_caches().values():
        cache.clear()


def _step_cached(mesh, **kw):
    """``make_step_fn(mesh, **kw)`` through ``kmeans._STEP_CACHE``, where a
    cost collector sees it built."""
    from kmeans_tpu_torch.models import kmeans as km_mod
    from kmeans_tpu_torch.utils.cache import cached_build
    return cached_build(km_mod._STEP_CACHE, dist.make_step_fn, mesh, **kw)


def _built_by(rec, builder: str) -> bool:
    """Whether a cost record (named by its cache) is of ``builder``'s
    product: the cache key starts with the builder's name."""
    return rec.key.startswith(f"('{builder}',")


def _captured(fit):
    """``fit()`` under a cost collector, counted, from empty step caches:
    ``(model, launches, records)``."""
    from kmeans_tpu_torch.obs import cost
    _clear_step_caches()
    with cost.collecting() as col:
        model, _, launches = counted(fit)
    return model, launches, col.records()


def phase_cost(x, c0, x_gmm, kernel1_ms):
    """Cost records measured on the card (``obs.cost``):
    ``device_cost_report`` at ``REPORT_SPECS`` for the five families; the
    main fit by the host and by the device loop (kernel 1) and in the
    'matmul' mode; the mixture by the device EM loop (``diag_estep``).
    Each record's kernels with their device ms and launches, its flops
    and their source, its peak beside ``plan_fit``'s.  Checks: every
    captured fit bit-equal to the same fit without capture, with equal
    launches; the 'matmul' step's aten count within
    ``FLOPS_AGREEMENT_RTOL`` of 4 n D k.  Kernel 1's profiled ms against
    phase ``timing``'s CUDA-event median is printed (outside
    ``PROFILE_BAND``: a finding)."""
    from kmeans_tpu_torch import obs
    from kmeans_tpu_torch.obs import cost, memory
    n, d = x.shape
    k = MAIN["k"]
    rep = obs.device_cost_report(device=DEV)
    print(obs.format_cost_table(rep["rows"]), flush=True)
    print(memory.format_plan_table(rep["plans"], device=DEV), flush=True)
    for row, plan in zip(rep["rows"], rep["plans"]):
        emit("cost", what="device_cost_report", family=row["family"],
             mode=row["mode"], n=row["n"], d=row["d"], k=row["k"],
             program=row["program"], region=row.get("region"),
             flops=row.get("flops"), flops_source=row.get("flops_source"),
             analytic_flops=row.get("analytic_flops"),
             ratio=row.get("ratio"), device_ms=row.get("device_ms"),
             kernels=(row.get("kernels") or [])[:6],
             peak_bytes=row.get("peak_bytes"),
             predicted_peak_bytes=plan["predicted_peak_bytes"],
             observed_over_predicted=(
                 row["peak_bytes"] / plan["predicted_peak_bytes"]
                 if row.get("peak_bytes") else None))
        check(row["available"], f"cost: {row['family']} record not "
                                f"available: {row.get('error')}")
    counts = {}
    kw = dict(k=k, max_iter=2, seed=42, init=c0, tolerance=1e-30,
              compute_labels=False, verbose=False, device=DEV)
    for label, extra in (("host", dict(host_loop=True)),
                         ("device", dict(host_loop=False)),
                         ("matmul", dict(host_loop=True,
                                         distance_mode="matmul"))):
        plain, _, plain_launches = counted(
            lambda: KMeans(**kw, **extra).fit(x))
        model, launches, recs = _captured(
            lambda: KMeans(**kw, **extra).fit(x))
        step = max((r for r in recs if r.flops), key=lambda r: r.flops)
        mode = model._mode()
        plan = memory.plan_fit("kmeans", n, d, k, mode=mode,
                               chunk=model._chunk_for(model.cache(x)),
                               device=DEV)
        line = _record_line(step)
        line.update(path=f"cost:{label}", mode=mode,
                    predicted_peak_bytes=plan["predicted_peak_bytes"],
                    observed_over_predicted=(
                        step.peak_bytes / plan["predicted_peak_bytes"]
                        if step.peak_bytes else None),
                    bit_equal=same_fit(model, plain),
                    launches_equal=launches == plain_launches,
                    records=len(recs))
        if mode == "kernel":
            ms = _kernel1_ms(step)
            line.update(kernel1_profiled_ms=ms,
                        kernel1_timing_ms=kernel1_ms,
                        profiled_over_timing=ms / kernel1_ms,
                        within_band=abs(ms / kernel1_ms - 1.0)
                        <= PROFILE_BAND)
        if label == "matmul":
            chk = cost.crosscheck(cost.analytic_step_flops("kmeans", n, d,
                                                           k), step)
            line["crosscheck"] = chk
            check(chk["agree"], f"cost: the 'matmul' flops crosscheck "
                                f"{chk}")
        emit("cost", **line)
        check(step.available and line["bit_equal"]
              and line["launches_equal"],
              f"cost:{label}: available {step.available} ({step.error}), "
              f"bit-equal {line['bit_equal']}, launches {launches} "
              f"against {plain_launches}")
        counts[f"cost:{label}"] = {n_: c for n_, c in launches.items() if c}
    gkw = dict(n_components=GMM["k"], covariance_type="diag",
               init_params="random", max_iter=2, tol=0.0, seed=7,
               host_loop=False, verbose=False, device=DEV)
    plain, _, plain_launches = counted(
        lambda: GaussianMixture(**gkw).fit(x_gmm))
    model, launches, recs = _captured(
        lambda: GaussianMixture(**gkw).fit(x_gmm))
    loop = next(r for r in recs if _built_by(r, "make_gmm_fit_fn")
                or _built_by(r, "make_gmm_multi_fit_fn"))
    plan = memory.plan_fit("gmm", x_gmm.shape[0], x_gmm.shape[1], GMM["k"],
                           mode=model.estep_path_, device=DEV)
    line = _record_line(loop)
    line.update(path="cost:gmm_device", mode=model.estep_path_,
                estep_ms=sum(k_["ms"] for k_ in loop.kernels or []
                             if k_["name"].startswith("estep")),
                predicted_peak_bytes=plan["predicted_peak_bytes"],
                bit_equal=same_mixture(model, plain),
                launches_equal=launches == plain_launches)
    emit("cost", **line)
    check(loop.available and line["bit_equal"] and line["launches_equal"]
          and loop.launches.get("diag_estep", 0) == 1,
          f"cost:gmm_device: {line}")
    counts["cost:gmm_device"] = {n_: c for n_, c in launches.items() if c}
    return counts


def phase_ladder(x, c, kernel1_ms):
    """``measure_phase_ladder`` over ``make_estep_phase_fn`` ('distance',
    'assign', 'reduce') in the 'matmul' mode at the main shape, each rung
    the difference of two chain lengths timed by CUDA events
    (``utils.profiling.Timer``), ``LADDER_REPS`` reps; the ceiling table at
    4 n D k operations and the float32 rate that ``bounds`` uses, with
    kernel 1's whole step beside it.  The kernel modes refuse a ladder."""
    from kmeans_tpu_torch import obs
    from kmeans_tpu_torch.utils import profiling
    n, d = x.shape
    k = c.shape[0]
    w = torch.ones(n, device=DEV)
    chunk = sharding.choose_chunk_size(n, k, d)
    fns = {(phase, it): dist.make_estep_phase_fn(
        None, chunk_size=chunk, n_iters=it, phase=phase)
        for phase in dist.ESTEP_PHASES for it in LADDER_CHAIN}
    try:
        dist.make_estep_phase_fn(None, chunk_size=chunk, n_iters=1,
                                 phase="reduce", mode="kernel")
        refused = False
    except ValueError:
        refused = True

    def rung(phase):
        def measure():
            t = {}
            for it in LADDER_CHAIN:
                timer = profiling.Timer()
                with timer.measure(sync_on=x):
                    fns[phase, it](x, w, c)
                t[it] = timer.total
            lo, hi = LADDER_CHAIN
            return (t[hi] - t[lo]) / (hi - lo)
        return phase, measure

    for phase in dist.ESTEP_PHASES:
        fns[phase, LADDER_CHAIN[0]](x, w, c)
    torch.cuda.synchronize()
    ladder = profiling.measure_phase_ladder(
        [rung(p) for p in dist.ESTEP_PHASES], reps=LADDER_REPS)
    rows = profiling.phase_ceiling_table(
        ladder, flops_per_iter=4.0 * n * d * k,
        peak_tflops=PEAK_FP32_FLOPS / 1e12)
    print(obs.format_phase_table(rows, title="phase ladder ('matmul', "
                                             "one pass)"), flush=True)
    full_ms = ladder[-1]["cumulative"] * 1e3
    emit("phase_ladder", n=n, d=d, k=k, chunk=chunk, reps=LADDER_REPS,
         chain=list(LADDER_CHAIN), rows=profiling.sanitize_json(rows),
         matmul_pass_ms=full_ms, kernel1_full_step_ms=kernel1_ms,
         matmul_over_kernel1=full_ms / kernel1_ms,
         kernel_modes_refused=refused)
    check(refused and all(r["ms"] >= 0 for r in rows) and full_ms > 0,
          f"phase_ladder: {rows}, kernel modes refused {refused}")


def _spans(recs, name, **attrs):
    return [r for r in recs if r.get("kind") == "span"
            and r["name"] == name
            and all((r.get("attrs") or {}).get(a) == v
                    for a, v in attrs.items())]


def _traced(fn):
    """``fn()`` under a tracer, counted: ``(result, launches, records)``."""
    from kmeans_tpu_torch import obs
    with obs.tracing() as tr:
        out, _, launches = counted(fn)
    return out, launches, tr.records()


def phase_spans(x, stream_path, c0, tmp):
    """The lifecycle spans of the port on the card, each traced run
    bit-equal to the same run untraced with equal launches: the main fit
    by the host loop (``lloyd/step`` per iteration, ``place``, ``stage``,
    ``seed``, one ``fleet.barrier``); the device loop with
    ``checkpoint_every=2`` (one ``segment`` and one ``checkpoint.save`` per
    segment), killed and resumed (``checkpoint.restore``), and under
    ``inject_oom_on_segment(1)`` (the attempts nested in one segment); the
    main stream at ``prefetch`` 2 (one ``io.block`` per block read, one
    ``stage(via='prefetch')`` and one ``stream/block`` per block) and its
    ``predict_stream``.  Prints the median host-loop iteration time traced
    and untraced."""
    counts = {}
    kw = dict(k=MAIN["k"], max_iter=SPAN["iters"], seed=42, init="forgy",
              tolerance=1e-30, compute_labels=False, verbose=False,
              device=DEV)
    plain, _, plain_l = counted(lambda: KMeans(**kw).fit(x))
    traced, launches, recs = _traced(lambda: KMeans(**kw).fit(x))
    n_it = traced.iterations_run
    steps = _spans(recs, "dispatch", tag="lloyd/step")
    barriers = [r for r in recs if r.get("name") == "fleet.barrier"]
    host = dict(bit_equal=same_fit(plain, traced),
                launches_equal=plain_l == launches, iterations=n_it,
                dispatch_spans=len(steps),
                place=len(_spans(recs, "place")),
                stage=len(_spans(recs, "stage")),
                seed=len(_spans(recs, "seed")), barriers=len(barriers),
                iteration_seconds_traced=statistics.median(
                    traced.iter_times_),
                iteration_seconds_untraced=statistics.median(
                    plain.iter_times_))
    emit("spans", path="spans:host", **host)
    check(host["bit_equal"] and host["launches_equal"]
          and len(steps) == n_it and host["place"] == 1
          and host["stage"] >= 1 and host["seed"] == 1
          and len(barriers) == 1, f"spans:host: {host}")
    counts["spans:host"] = {n_: c for n_, c in launches.items() if c}

    dkw = dict(kw, max_iter=SPAN["dev_iters"], host_loop=False)
    every = SPAN["every"]
    plain, _, plain_l = counted(lambda: KMeans(**dkw).fit(
        x, checkpoint_every=every, checkpoint_path=tmp / "plain.npz"))
    seg, launches, recs = _traced(lambda: KMeans(**dkw).fit(
        x, checkpoint_every=every, checkpoint_path=tmp / "seg.npz"))
    segs = _spans(recs, "segment")
    attempts = _spans(recs, "dispatch", tag="fit/segment")
    saves = _spans(recs, "checkpoint.save")
    line = dict(bit_equal=same_fit(plain, seg),
                launches_equal=plain_l == launches,
                segments=seg.checkpoint_segments_, segment_spans=len(segs),
                attempt_spans=len(attempts), saves=len(saves),
                mem_plans=sum(r.get("name") == "mem.plan" for r in recs),
                graph_captures=len(_spans(recs, "compile",
                                          via="graph-capture")))
    emit("spans", path="spans:segmented", **line)
    check(line["bit_equal"] and line["launches_equal"]
          and len(segs) == len(attempts) == len(saves)
          == seg.checkpoint_segments_ == line["mem_plans"],
          f"spans:segmented: {line}")
    counts["spans:segmented"] = {n_: c for n_, c in launches.items() if c}

    path = tmp / "killed.npz"
    _, _, recs_k = _traced(lambda: killed(lambda: KMeans(**dkw).fit(
        x, checkpoint_every=every, checkpoint_path=path), SPAN["kill"],
        "spans:killed"))
    resumed, _, recs_r = _traced(lambda: KMeans(**dkw).fit(
        x, resume=path, checkpoint_every=every, checkpoint_path=path))
    line = dict(bit_equal=same_fit(plain, resumed),
                killed_saves=len(_spans(recs_k, "checkpoint.save")),
                restores=len(_spans(recs_r, "checkpoint.restore")),
                resumed_segments=len(_spans(recs_r, "segment")))
    emit("spans", path="spans:resumed", **line)
    check(line["bit_equal"] and line["restores"] >= 1
          and line["resumed_segments"] == resumed.checkpoint_segments_
          and line["killed_saves"] == SPAN["kill"] // every,
          f"spans:resumed: {line}")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with faults.inject_oom_on_segment(1) as rec:
            oom, launches, recs = _traced(lambda: KMeans(**dkw).fit(
                x, checkpoint_every=every, checkpoint_path=tmp / "oom.npz"))
    segs = {r["id"]: r for r in _spans(recs, "segment")}
    attempts = _spans(recs, "dispatch", tag="fit/segment")
    replayed = [a for a in attempts if a["attrs"].get("attempt") == 1]
    line = dict(fired=rec["fired"], backoffs=oom.oom_backoffs_,
                bit_equal=same_fit(plain, oom),
                segment_spans=len(segs), segments=oom.checkpoint_segments_,
                attempt_spans=len(attempts),
                replay_in_its_segment=bool(replayed)
                and replayed[0]["parent"] in segs)
    emit("spans", path="spans:oom", **line)
    check(rec["fired"] == 1 and line["bit_equal"]
          and len(segs) == oom.checkpoint_segments_
          and len(attempts) == len(segs) + 1 and len(replayed) == 1
          and line["replay_in_its_segment"], f"spans:oom: {line}")

    skw = dict(k=MAIN["k"], max_iter=SPAN["stream_iters"], init=c0,
               tolerance=1e-30, verbose=False, device=DEV)
    blocks = -(-MAIN["n"] // STREAM["rows"])

    def stream():
        return KMeans(**skw).fit_stream(
            iter_npy_blocks(stream_path, STREAM["rows"]), d=MAIN["d"],
            prefetch=2)
    plain, _, plain_l = counted(stream)
    traced, launches, recs = _traced(stream)
    epochs = traced.iterations_run
    line = dict(bit_equal=same_fit(plain, traced),
                launches_equal=plain_l == launches, epochs=epochs,
                blocks=blocks,
                io_block_reads=len([r for r in _spans(recs, "io.block")
                                    if "offset" in r.get("attrs", {})]),
                prefetch_stages=len(_spans(recs, "stage", via="prefetch")),
                block_dispatches=len(_spans(recs, "dispatch",
                                            tag="stream/block")))
    emit("spans", path="spans:stream", **line)
    check(line["bit_equal"] and line["launches_equal"]
          and line["io_block_reads"] == line["prefetch_stages"]
          == line["block_dispatches"] == blocks * epochs,
          f"spans:stream: {line}")
    counts["spans:stream"] = {n_: c for n_, c in launches.items() if c}

    def predict():
        return np.concatenate(list(traced.predict_stream(
            iter_npy_blocks(stream_path, STREAM["rows"]), prefetch=2)))
    labels, _, plain_l = counted(predict)
    labels_t, launches, recs = _traced(predict)
    line = dict(labels_equal=bool(np.array_equal(labels, labels_t)),
                launches_equal=plain_l == launches,
                io_block_reads=len([r for r in _spans(recs, "io.block")
                                    if "offset" in r.get("attrs", {})]),
                hopper_assign=launches.get("hopper_assign", 0))
    emit("spans", path="spans:predict_stream", **line)
    check(line["labels_equal"] and line["launches_equal"]
          and line["io_block_reads"] == blocks
          and line["hopper_assign"] == blocks,
          f"spans:predict_stream: {line}")
    counts["spans:predict_stream"] = {n_: c for n_, c in launches.items()
                                      if c}
    return counts


def comm_line(rec, data_shards: int, k: int, d: int,
              model_shards: int = 1, rows: int = 0) -> dict:
    """A captured step's collective bytes against the port's bill
    (``obs.fleet.comm_bytes_model`` of a step that sends neither the
    per-cluster SSE nor the farthest point)."""
    from kmeans_tpu_torch.obs import fleet
    model = fleet.comm_bytes_model("kmeans", k=k, d=d,
                                   data_shards=data_shards,
                                   model_shards=model_shards, rows=rows)
    chk = fleet.comm_crosscheck(model, rec)
    return {"crosscheck": chk, "table": fleet.format_comm_table(model, chk)}


def main() -> None:
    global CARD
    started = time.perf_counter()
    CARD = card_line()
    # Full float32 products in every torch matmul of the run (the default,
    # stated): the plain versions and yardsticks must not use TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("env", device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    # Every source of the main path and the lab's variants: one nvcc each,
    # all started together.
    t0 = time.perf_counter()
    lab_variants = [lab.parse_spec(spec) for spec in LAB_SPECS]
    _build.build_variants(
        [(name, {}) for name in _build.source_names()]
        + [(v.source, v.defines) for v in lab_variants])
    emit("build", sources=_build.source_names(),
         variants=[v.library_path().name for v in lab_variants],
         seconds=time.perf_counter() - t0)
    libraries = {name: _build.library_path(name)
                 for name in _build.source_names()}
    libraries.update({f"lab:{v.name}": v.library_path()
                      for v in lab_variants})
    emit("registers", **{name: resource_usage(path)
                         for name, path in libraries.items()})
    phase_sass()
    phase_bf16_layout()

    x_main, _ = make_blobs_device(MAIN["n"], MAIN["k"], MAIN["d"],
                                  device=DEV, seed=1)
    gen = torch.Generator(device=DEV).manual_seed(2)
    pick = torch.randperm(MAIN["n"], generator=gen, device=DEV)[:MAIN["k"]]
    c_main = x_main[pick].contiguous()
    x2, _ = make_blobs_device(SECOND["n"], 1000, SECOND["d"], device=DEV,
                              seed=5)
    pick2 = torch.randperm(SECOND["n"], generator=gen,
                           device=DEV)[:SECOND["k"]]
    w2 = torch.rand((SECOND["n"],), generator=gen, device=DEV) + 0.5
    w2[::10] = 0.0                     # a tenth of the rows at weight 0
    second = (x2, w2, x2[pick2].contiguous())
    errs = {}
    for bf16 in (False, True):
        records = phase_kernels(x_main, c_main, second, bf16)
        phase_sentinels(bf16)
        phase_family_kernels(x_main, c_main, x2, bf16)
        main_rec = next(r for r in records if r["case"] == "main_shape")
        suffix = "_bf16" if bf16 else ""
        errs["fused_assign_reduce" + suffix] = max(
            main_rec["sums_err"], main_rec["mind2_err"],
            main_rec["counts_err"])
        errs["hopper_assign" + suffix] = main_rec["assign_mind2_err"]
    del w2, second

    # Each path: counters to 0 just before it, read just after it, and only
    # the kernels that this path must launch are checked.
    km, km_wall = fit_shape(x_main, MAIN, "main")
    phase_predict(km, x_main)
    launches = check_path_launches("main")

    km_bf16, km_bf16_wall = fit_shape(x_main, MAIN, "main_bf16",
                                      "pallas_bf16")
    phase_predict(km_bf16, x_main)
    launches.update({name: count for name, count in
                     check_path_launches("main_bf16").items()
                     if name.endswith("_bf16")})
    ratio = km_bf16.sse_history[-1] / km.sse_history[-1]
    emit("sse_bf16_against_f32", main_bf16=km_bf16.sse_history[-1],
         main=km.sse_history[-1], ratio=ratio)
    check(abs(ratio - 1.0) <= BF16_SSE_RATIO,
          f"main_bf16: final SSE {ratio} times the float32 path's")
    device_seconds, device_models = phase_device_loop(
        x_main, {"main": (km, km_wall), "main_bf16": (km_bf16, km_bf16_wall)})
    phase_transform(km, x_main)
    phase_guarded(x_main, {"main_bf16": (km_bf16, km_bf16_wall)},
                  device_seconds)
    slice_counts = phase_multi_fit(x_main)

    fit_shape(x2, SECOND, "glove_like")
    check_path_launches("glove_like")
    phase_device_converge(x2)
    family_counts = phase_spherical(x2)
    phase_empty_policies()

    # The mixture: its kernel against the plain version, then its path.
    # The data (blobs about 1e3 from the origin) and the tables of a mixture
    # with means at random rows are those the E-step ablations time.
    x_gmm, gmm_tables = kernel_edits.estep_inputs(GMM["n"], GMM["d"],
                                                  GMM["k"], DEV)
    estep_records = phase_estep_kernel(x_gmm, gmm_tables)
    gmm_main = estep_records[0]
    gm, gmm_launches, gmm_fit_seconds = phase_gmm(x_gmm)
    phase_gmm_setup(x_gmm, gm, gmm_fit_seconds)
    seeding_records, drawn = phase_seeding(x_main, x_gmm)
    slice_counts.update(phase_kmeans_parallel(x_main, km, seeding_records))
    slice_counts.update(phase_sweep(x_main))
    bisect_counts, bisect_ref = phase_bisecting(x_main)
    family_counts.update(bisect_counts)
    minibatch_counts, minibatch_ref = phase_minibatch(x_main)
    family_counts.update(minibatch_counts)
    phase_gmm_offset()
    phase_gmm_float64()
    gmm_dev, mixture_counts = phase_gmm_device(x_gmm, gm)
    full_ref, mixture_counts["gmm_full_tied"] = phase_gmm_full_tied()
    mixture_counts["gmm_multi_fit"] = phase_gmm_multi_fit(x_gmm)
    mixture_counts["gmm_sweep"] = phase_gmm_sweep(x_gmm)
    phase_estep_inert(x_gmm, gmm_tables)

    # Fault tolerance: checkpointed, killed and resumed fits through the
    # same kernels, out-of-memory backoffs (injected and real) and the
    # rollback on divergence.
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        fault_counts = phase_fault_tolerance(x_main, tmp)
        fault_counts.update(phase_fault_tolerance(x_main, tmp, bf16=True))
        fault_counts.update(phase_divergence_rollback(x_main, x_gmm, tmp))
        fault_counts.update(phase_fault_families(
            x_main, x2, x_gmm, tmp, {"bisecting": bisect_ref}))
    fault_counts.update(phase_oom_real(x_main))

    # Ingest and the massive k: data made on the card, then the main data
    # at k = 16,384 by the two-level route and the dense fits.
    largek_counts = phase_synthetic()
    largek_counts.update(phase_large_k(x_main))

    # Streaming: the main data, the mixture data and the GloVe-like data
    # written as .npy files and read back block by block.
    stream_dir = tempfile.TemporaryDirectory()
    stream_tmp = Path(stream_dir.name)
    c0 = km._init_centroids(km.cache(x_main), km.seed)
    stream_counts, stream_ref = phase_streams(x_main, x_gmm, x2, c0,
                                              stream_tmp)
    del x2

    # The product quantizer, then the serving engine: each path's counters
    # zeroed just before it and read just after it.
    phase_pq(x_main, km)
    serving_counts = {
        "serving": phase_serving(x_main, km),
        "serving_bf16": phase_serving_bf16(x_main, km, km_bf16),
        "serving_packed": phase_serving_packed(x_main, km),
        "serving_gmm": phase_serving_gmm(x_gmm, gm),
        "serving_queue": phase_serving_queue(x_main, km)}
    bucket_times = phase_serving_kernel_shapes(x_main, c_main)

    # The serving fleet, serve-and-learn and heartbeats: each path's
    # counters zeroed just before it and read just after it.
    with tempfile.TemporaryDirectory() as fleet_tmp:
        fleet_tmp = Path(fleet_tmp)
        (fleet_tmp / "fleet").mkdir()
        fleet_counts, killed = phase_fleet(x_main, km, km_bf16,
                                           fleet_tmp / "fleet")
        fleet_counts.update(phase_serve_learn(x_main, minibatch_ref,
                                              fleet_tmp))
        fleet_counts.update(phase_heartbeat(x_main, fleet_tmp / "fleet",
                                            killed))

    rows = phase_timing(x_main, c_main, errs, launches,
                        {"main": statistics.median(km.iter_times_),
                         "main_bf16": statistics.median(km_bf16.iter_times_)},
                        device_seconds)
    rows.append(phase_gmm_timing(
        x_gmm, gmm_tables, gm,
        max(gmm_main[f"{s}_err"] for s in ("rsum", "s1", "s2", "ll")),
        gmm_launches))
    rows += phase_lab(x_main, c_main, rows)

    # Observability on the card: time to first iteration, cost records,
    # the phase ladder and the lifecycle spans (each path's counters
    # zeroed just before it and read just after it).
    kernel1_ms = next(r["ms"] for r in rows
                      if r["name"] == "fused_assign_reduce")
    phase_ttfi()
    # Warm start and determinism: the libraries shipped with a checkpoint
    # and loaded by fresh interpreters, the fit-shape bucket, and the
    # bit-for-bit verdicts of every kernel (each path's counters zeroed
    # just before it and read just after it).
    warm_counts = phase_warm_start(x_main)
    warm_counts.update(phase_bucket(x_main))
    warm_counts.update(phase_determinism(x_main, x_gmm))
    obs_counts = phase_cost(x_main, c0, x_gmm, kernel1_ms)
    phase_ladder(x_main, c_main, kernel1_ms)
    with tempfile.TemporaryDirectory() as span_tmp:
        obs_counts.update(phase_spans(x_main, stream_ref[0], c0,
                                      Path(span_tmp)))

    # The mesh: two gloo ranks sharing the card (K-Means on a data and a
    # model axis, process-local k-means++, the mixture on a data axis), one
    # NCCL rank in this process, then the suite.  Each rank counts its own
    # launches; they are read from every rank.
    refs = {prec: dict(centroids=m.centroids, labels=m.labels_,
                       iterations=m.iterations_run,
                       sse_history=m.sse_history, iter_times=m.iter_times_)
            for prec, m in (("f32", km), ("bf16", km_bf16))}
    refs["gmm"] = {name: getattr(gm, name) for name in (
        "weights_", "means_", "covariances_", "shift_")}
    refs["full"] = full_ref
    results, mesh_counts = phase_dp_shared_card(x_main, refs, drawn["main"])
    mesh_counts.update(phase_dp_gmm(results, gm, x_gmm, full_ref))
    del results
    mesh_counts.update(phase_dp_world1(x_main, {
        ("f32", "host"): km, ("bf16", "host"): km_bf16,
        ("f32", "device"): device_models["main_device"],
        ("bf16", "device"): device_models["main_bf16_device"]},
        minibatch_ref, x_gmm, gmm_dev, stream_ref))
    largek_counts.update({path: c for path, c in mesh_counts.items()
                          if path.startswith("dp_world1:ingest")})
    stream_dir.cleanup()
    phase_suite()
    for row in rows:
        row["mesh_launches"] = {path: c[row["name"]]
                                for path, c in mesh_counts.items()
                                if c.get(row["name"], 0) > 0}
        row["model_selection_launches"] = {
            path: c[row["name"]] for path, c in slice_counts.items()
            if c.get(row["name"], 0) > 0}
        row["family_launches"] = {
            path: c[row["name"]] for path, c in family_counts.items()
            if c.get(row["name"], 0) > 0}
        row["mixture_launches"] = {
            path: c[row["name"]] for path, c in mixture_counts.items()
            if c.get(row["name"], 0) > 0}
        row["fault_tolerance_launches"] = {
            path: c[row["name"]] for path, c in fault_counts.items()
            if c.get(row["name"], 0) > 0}
        row["stream_launches"] = {
            path: c[row["name"]] for path, c in stream_counts.items()
            if c.get(row["name"], 0) > 0}
        row["ingest_large_k_launches"] = {
            path: c[row["name"]] for path, c in largek_counts.items()
            if c.get(row["name"], 0) > 0}
        by_path = {path: c.get(row["name"], 0)
                   for path, c in serving_counts.items()}
        row["serving_launches"] = sum(by_path.values())
        row["serving_launches_by_path"] = {
            path: n for path, n in by_path.items() if n}
        row["fleet_learn_launches"] = {
            path: c[row["name"]] for path, c in fleet_counts.items()
            if c.get(row["name"], 0) > 0}
        row["observability_launches"] = {
            path: c[row["name"]] for path, c in obs_counts.items()
            if c.get(row["name"], 0) > 0}
        row["warm_start_launches"] = {
            path: c[row["name"]] for path, c in warm_counts.items()
            if c.get(row["name"], 0) > 0}
        if row["name"] in bucket_times:
            row["bucket_shapes"] = bucket_times[row["name"]]

    emit("total", seconds=time.perf_counter() - started)
    print(json.dumps({"kernels": rows}), flush=True)
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
