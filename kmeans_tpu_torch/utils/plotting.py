"""The speedup graph of the suite's test E, as SVG from the standard library.

Counterpart of ``kmeans_tpu/utils/plotting.py`` with its layout: ideal
(y = x, blue, circles) against actual (orange, squares), the axes "Number of
Shards" and "Speedup", the title "Speedup vs Number of Shards", a legend and
a light grid.  SVG, not PNG: the card's machine has no matplotlib.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence
from xml.sax.saxutils import escape

WIDTH, HEIGHT = 900, 540
LEFT, RIGHT, TOP, BOTTOM = 80, 30, 60, 70


def _polyline(points, colour: str) -> str:
    xy = " ".join(f"{x:.1f},{y:.1f}" for x, y in points)
    return (f'<polyline points="{xy}" fill="none" stroke="{colour}" '
            f'stroke-width="2"/>')


def save_speedup_graph(shard_counts: Sequence[int],
                       speedups: Dict[int, float], path) -> Path:
    """Ideal against actual speedup over the shard counts, written to
    ``path`` as an SVG file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    xs = [int(n) for n in shard_counts]
    actual = [float(speedups[n]) for n in shard_counts]
    x_hi = max(xs + [2])
    y_hi = max(actual + xs + [2]) * 1.1
    w, h = WIDTH - LEFT - RIGHT, HEIGHT - TOP - BOTTOM

    def at(x, y):
        return LEFT + w * (x - 1) / max(x_hi - 1, 1), TOP + h * (1 - y / y_hi)

    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{WIDTH}" '
             f'height="{HEIGHT}" font-family="sans-serif">',
             f'<rect width="{WIDTH}" height="{HEIGHT}" fill="white"/>']
    for n in xs:                                   # grid and x ticks
        gx, _ = at(n, 0)
        parts.append(f'<line x1="{gx:.1f}" y1="{TOP}" x2="{gx:.1f}" '
                     f'y2="{TOP + h}" stroke="#000" stroke-opacity="0.1"/>')
        parts.append(f'<text x="{gx:.1f}" y="{TOP + h + 20}" '
                     f'text-anchor="middle" font-size="12">{n}</text>')
    for i in range(6):                             # grid and y ticks
        y = y_hi * i / 5
        _, gy = at(1, y)
        parts.append(f'<line x1="{LEFT}" y1="{gy:.1f}" x2="{LEFT + w}" '
                     f'y2="{gy:.1f}" stroke="#000" stroke-opacity="0.1"/>')
        parts.append(f'<text x="{LEFT - 8}" y="{gy + 4:.1f}" '
                     f'text-anchor="end" font-size="12">{y:.2f}</text>')
    parts.append(f'<rect x="{LEFT}" y="{TOP}" width="{w}" height="{h}" '
                 f'fill="none" stroke="black"/>')
    ideal = [at(n, n) for n in xs]
    real = [at(n, s) for n, s in zip(xs, actual)]
    parts.append(_polyline(ideal, "blue"))
    parts += [f'<circle cx="{x:.1f}" cy="{y:.1f}" r="5" fill="blue"/>'
              for x, y in ideal]
    parts.append(_polyline(real, "orange"))
    parts += [f'<rect x="{x - 5:.1f}" y="{y - 5:.1f}" width="10" '
              f'height="10" fill="orange"/>' for x, y in real]
    parts.append(f'<text x="{WIDTH / 2}" y="{TOP - 25}" text-anchor="middle" '
                 f'font-size="14" font-weight="bold">'
                 f'{escape("Speedup vs Number of Shards")}</text>')
    parts.append(f'<text x="{LEFT + w / 2}" y="{HEIGHT - 20}" '
                 f'text-anchor="middle" font-size="12">Number of Shards'
                 f'</text>')
    parts.append(f'<text x="20" y="{TOP + h / 2}" text-anchor="middle" '
                 f'font-size="12" transform="rotate(-90 20 {TOP + h / 2})">'
                 f'Speedup</text>')
    lx, ly = LEFT + 15, TOP + 20                   # the legend
    parts.append(f'<line x1="{lx}" y1="{ly}" x2="{lx + 30}" y2="{ly}" '
                 f'stroke="blue" stroke-width="2"/><text x="{lx + 38}" '
                 f'y="{ly + 4}" font-size="11">Ideal</text>')
    parts.append(f'<line x1="{lx}" y1="{ly + 20}" x2="{lx + 30}" '
                 f'y2="{ly + 20}" stroke="orange" stroke-width="2"/>'
                 f'<text x="{lx + 38}" y="{ly + 24}" font-size="11">Actual'
                 f'</text>')
    parts.append("</svg>")
    path.write_text("\n".join(parts) + "\n")
    return path
