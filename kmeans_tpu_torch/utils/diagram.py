"""The architecture diagram and the one-page report, drawn from code.

Counterpart of ``kmeans_tpu/utils/diagram.py``: ``python -m
kmeans_tpu_torch report`` writes ``architecture_diagram.svg`` (the layer
map and one Lloyd iteration's data flow) and ``kmeans_tpu_report.svg``
(problem, parallelization, where the measurements live).  SVG from the
standard library, not PNG and PDF through matplotlib: the card's machine
has no matplotlib (as ``utils/plotting.py`` does for the suite's speedup
graph).  The report states no speed figure: the measured numbers, each
with its card and power limit, are in PERF.md.
"""

from __future__ import annotations

from pathlib import Path
from xml.sax.saxutils import escape

_LAYERS = [
    ("L4  Harness + CLI",
     ["suite.py (the original tests A-E, real exit codes) · chip_smoke.py ·",
      "python -m kmeans_tpu_torch fit / sweep / serve / warm / plan / "
      "autopilot · pytest against the JAX package"]),
    ("L3  Algorithm API",
     ["KMeans · MiniBatch · Bisecting · Spherical · GaussianMixture "
      "(diag/spherical/tied/full) · ProductQuantizer ·",
      "init strategies · checkpoint/resume · streams · serving engine "
      "and fleet · metrics"]),
    ("L2  Distributed primitives",
     ["torch.distributed mesh (data × model), one process per GPU · "
      "all_reduce of the statistics ·",
      "the device loop: one iteration captured as a CUDA graph and "
      "replayed · process-local loading"]),
    ("L1  Compute kernels",
     ["hand-written CUDA C++ for Hopper (sm_90a): fused assign + reduce "
      "(3xTF32 mma.sync),",
      "its bf16 form (wgmma, bulk-async centroid ring), assignment only, "
      "the mixture's E-step"]),
]

_FLOW = [
    ["points on the card,", "blocks of the data", "axis (resident)"],
    ["fused kernel:", "distances → argmin →", "weighted scatter"],
    ["(k, D) sums, counts", "and SSE per block", "(tensor cores)"],
    ["one all_reduce over", "the mesh → replicated", "statistics"],
    ["centroid update +", "convergence check", "(host or graph)"],
]

_COLOURS = ["#cfe3f7", "#d8f0d3", "#fbe6c2", "#f3d1d4"]


def _svg(width: int, height: int, body: list) -> str:
    return "\n".join(
        [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
         f'height="{height}" font-family="sans-serif">',
         f'<rect width="{width}" height="{height}" fill="white"/>']
        + body + ["</svg>"]) + "\n"


def _text(x, y, s, size=12, anchor="start", weight="normal") -> str:
    return (f'<text x="{x}" y="{y}" font-size="{size}" '
            f'text-anchor="{anchor}" font-weight="{weight}">'
            f'{escape(s)}</text>')


def _diagram_body(top: int = 0) -> list:
    """The layer map and the flow of one iteration, ``top`` pixels down."""
    out = [_text(550, top + 30, "kmeans_tpu_torch — distributed K-Means "
                 "on NVIDIA Hopper", 18, "middle", "bold"),
           _text(20, top + 60, "Layer map", 13, weight="bold")]
    for i, (title, body) in enumerate(_LAYERS):
        y = top + 70 + i * 95
        out.append(f'<rect x="20" y="{y}" width="1060" height="85" rx="8" '
                   f'fill="{_COLOURS[i]}" stroke="#444"/>')
        out.append(_text(35, y + 24, title, 14, weight="bold"))
        out += [_text(50, y + 48 + 18 * j, line, 12)
                for j, line in enumerate(body)]
    y0 = top + 70 + len(_LAYERS) * 95 + 30
    out.append(_text(20, y0, "One Lloyd iteration = one step on the card "
                     "(the original project's broadcast / shuffle / "
                     "collect round trip becomes one all_reduce)", 13,
                     weight="bold"))
    w = 190
    for i, lines in enumerate(_FLOW):
        x = 20 + i * (w + 27)
        out.append(f'<rect x="{x}" y="{y0 + 15}" width="{w}" height="80" '
                   f'rx="8" fill="#eeeeee" stroke="#444"/>')
        out += [_text(x + w / 2, y0 + 40 + 18 * j, line, 12, "middle")
                for j, line in enumerate(lines)]
        if i:
            ax = x - 25
            out.append(f'<line x1="{ax}" y1="{y0 + 55}" x2="{x - 4}" '
                       f'y2="{y0 + 55}" stroke="#333" stroke-width="2"/>'
                       f'<polygon points="{x - 2},{y0 + 55} {x - 10},'
                       f'{y0 + 50} {x - 10},{y0 + 60}" fill="#333"/>')
    return out


def render_architecture(path) -> Path:
    """Write the layer map and one iteration's data flow to ``path`` as
    SVG (the visual counterpart of the original project's architecture
    picture)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(_svg(1100, 620, _diagram_body()))
    return path


_REPORT = [
    ("Problem formulation.",
     ["Partition n points in R^D into k clusters, minimizing the "
      "within-cluster sum of squared distances (SSE),",
      "at scales where one machine's memory and arithmetic are not "
      "enough: millions of rows, about a hundred features,",
      "hundreds to tens of thousands of centroids; also Gaussian "
      "mixtures, spherical, bisecting and mini-batch K-Means."]),
    ("Parallelization strategy.",
     ["The points are split over the data axis of a torch.distributed "
      "mesh (one process per GPU) and stay on the cards",
      "for the whole fit; the centroids are replicated, or split over a "
      "model axis when k·D is large.  Each iteration is",
      "one step per card: a hand-written CUDA kernel computes the "
      "distances in matmul form on the tensor cores, keeps a",
      "running argmin and scatters the weighted rows into per-block "
      "(k, D) sums, counts and SSE; one all_reduce",
      "replicates the statistics.  With host_loop=False the iteration is "
      "captured once as a CUDA graph and replayed,",
      "the convergence test included.  A bf16 form of the kernel (wgmma) "
      "serves the throughput mode."]),
    ("Performance.",
     ["Every time, bound and launch count is measured on an NVIDIA H100 "
      "by the committed chip_smoke.py and written",
      "down in PERF.md, each beside the card's name and power limit; "
      "this page states none of them."]),
]


def render_report(path, *, diagram: Path = None,
                  speedup: Path = None) -> Path:
    """Write the one-page report to ``path`` as SVG: problem,
    parallelization strategy, where the measurements are, with the
    diagram and (where ``speedup`` exists) the suite's speedup graph
    drawn in."""
    body = [_text(550, 35, "kmeans_tpu_torch: distributed K-Means on "
                  "NVIDIA Hopper", 20, "middle", "bold"),
            _text(550, 58, "Project report (regenerated by `python -m "
                  "kmeans_tpu_torch report`)", 11, "middle")]
    y = 95
    for head, lines in _REPORT:
        body.append(_text(40, y, head, 13, weight="bold"))
        y += 20
        for line in lines:
            body.append(_text(55, y, line, 12))
            y += 17
        y += 12
    if diagram is not None and Path(diagram).exists():
        body.append(f'<g transform="translate(0,{y})">')
        body += _diagram_body()
        body.append("</g>")
        y += 620
    if speedup is not None and Path(speedup).exists():
        inner = Path(speedup).read_text()
        inner = inner[inner.index(">", inner.index("<svg")) + 1:
                      inner.rindex("</svg>")]
        body.append(f'<g transform="translate(100,{y + 10}) scale(0.9)">'
                    f'{inner}</g>')
        y += 500
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(_svg(1100, y + 20, body))
    return path


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m kmeans_tpu_torch report",
        description="Regenerate the architecture diagram + project "
                    "report artifacts")
    parser.add_argument("--out-dir", default="artifacts")
    args = parser.parse_args(argv)
    out = Path(args.out_dir)
    diagram = render_architecture(out / "architecture_diagram.svg")
    print(f"wrote {diagram}")
    report = render_report(out / "kmeans_tpu_report.svg",
                           diagram=diagram,
                           speedup=out / "speedup_graph.svg")
    print(f"wrote {report}")
    return 0
