"""Work counts: the bytes and float32 operations a step of these inputs
needs, worked out from shapes and from the plain reference's walk of the
cell's own scene (the program's `walk_stats`; for `panoptic_dynamic`
`reference/train.py::walk_stats`), never from the program's counters, so
that any implementation is held to the same work. A program's
`step_counts` adds them up over the launches of its step.

Each count is a lower one: every input byte read once, every output byte
written once, and only the operations the result cannot do without. A
roofline share over such a count can only read low, never past 100 %.

  * K1 (forward tile compositing): the record table's 8 + CV rows of each
    pair a tile reads (those of the chunks it walks before it stops), its
    outputs (CV accumulators and the log-transmittance per pixel) and the
    tile ranges; per (pixel, read pair) cell `K1_CELL_OPS` operations for
    the gaussian's power and the transmittance, and 2 per value row;
  * K2 (backward): the table read and its gradient rows written, the
    upstream gradient and the transmittance read; per cell the forward's
    alpha again (`K1_CELL_OPS`) and 4 per value row;
  * E1 (pair emission): each table row's inputs once (x, y, the conic,
    opacity, radius and the valid flag: `E1_ROW_BYTES`) and 8 bytes per
    live pair written (its tile key and slot);
  * P1 (the physics losses' edge terms): per foreground edge its index,
    weight, distance and offset (`EDGE_BYTES`), per foreground row its
    means, rotations and their gradients (`FG_ROW_BYTES`); `EDGE_OPS` an
    edge;
  * a render (`render`): K1 + K2 + E1, the projection and its gradient
    over the live rows, and the image losses (L1 and SSIM, forward and
    backward) over the pixels;
  * what a step does once (`update`): the physics losses over the
    foreground's edges and the live rows, and Adam over the parameters;
  * the step of one render (`step`): the two added.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

TILE_PIXELS = 256
GEOM_ROWS = 8
E1_ROW_BYTES = 29          # x, y, a, b, c, opacity (f32), radius (i32), valid
K1_CELL_OPS = 10           # dx, dy, the quadratic form, op * exp, 1 - alpha
K2_CELL_OPS = K1_CELL_OPS
PROJ_ROW_BYTES = (14 + 8) * 4   # means, scales, rotation, opacity in; 8 out
PROJ_ROW_OPS = 150         # view and clip transforms, J W Sigma W^T J^T
EDGE_BYTES = 24            # index, weight, distance, t - 1 offset
EDGE_OPS = 100             # rigid, rot and iso terms, forward and backward
FG_ROW_BYTES = 72          # means, rotation, inverse rotation; two gradients
ROW_LOSS_BYTES = 120       # floor, bg and colour terms' inputs and gradients
ROW_LOSS_OPS = 30
PIXEL_LOSS_BYTES = 12      # render and ground truth read, gradient written
PIXEL_LOSS_OPS = 444       # 5 separable 11-tap blurs, forward and backward
ADAM_BYTES = 28            # p, g, mu, nu read; p, mu, nu written
ADAM_OPS = 10

PEAKS_FILE = os.path.join(os.path.dirname(__file__), "peaks.json")


def value_rows(n_chan: int) -> int:
    """CV: the channels, depth and alpha, padded to a multiple of 8."""
    return -(-(n_chan + 2) // 8) * 8


def k1(read_pairs: int, tiles: int, n_chan: int) -> Dict[str, float]:
    cv = value_rows(n_chan)
    cells = read_pairs * TILE_PIXELS
    return dict(
        bytes=(read_pairs * (GEOM_ROWS + cv) * 4
               + tiles * TILE_PIXELS * (cv + 1) * 4 + tiles * 3 * 4),
        flops=cells * (K1_CELL_OPS + 2 * (n_chan + 2)))


def k2(read_pairs: int, tiles: int, n_chan: int) -> Dict[str, float]:
    cv = value_rows(n_chan)
    cells = read_pairs * TILE_PIXELS
    return dict(
        bytes=(2 * read_pairs * (GEOM_ROWS + cv) * 4
               + tiles * TILE_PIXELS * (cv + 1) * 4 + tiles * 3 * 4),
        flops=cells * (K2_CELL_OPS + 4 * (n_chan + 2)))


def e1(table_rows: int, live_pairs: int) -> Dict[str, float]:
    return dict(bytes=table_rows * E1_ROW_BYTES + live_pairs * 8, flops=0)


def p1(fg_rows: int, edges: int) -> Dict[str, float]:
    return dict(bytes=edges * EDGE_BYTES + fg_rows * FG_ROW_BYTES,
                flops=edges * EDGE_OPS)


def add(*parts: Dict[str, float]) -> Dict[str, float]:
    """The sum of counts."""
    return dict(bytes=sum(p["bytes"] for p in parts),
                flops=sum(p["flops"] for p in parts))


def render(walk: Dict, cfg: Dict) -> Dict[str, float]:
    """One camera's render and its image losses, forward and backward
    (`walk`: the reference's live and read pairs, tiles and live rows)."""
    n_chan = 6 + cfg["semantic_dim"]
    rows = walk["rows"]
    pixels = cfg["width"] * cfg["height"]
    loss_elems = 6 * pixels
    if cfg["semantic_dim"]:
        fh, fw = cfg["feature_hw"]
        loss_elems += fh * fw * cfg["semantic_dim"]
    return add(k1(walk["read_pairs"], walk["tiles"], n_chan),
               k2(walk["read_pairs"], walk["tiles"], n_chan),
               e1(cfg["capacity"], walk["live_pairs"]),
               dict(bytes=2 * rows * PROJ_ROW_BYTES,
                    flops=rows * PROJ_ROW_OPS),
               dict(bytes=loss_elems * PIXEL_LOSS_BYTES,
                    flops=loss_elems * PIXEL_LOSS_OPS))


def update(walk: Dict, cfg: Dict) -> Dict[str, float]:
    """What a step does once, whatever its renders: the physics losses
    and Adam (`walk`: live and foreground rows, edges, parameter
    floats)."""
    rows, edges = walk["rows"], walk["edges"]
    return add(p1(walk["fg_rows"], edges),
               dict(bytes=rows * ROW_LOSS_BYTES, flops=rows * ROW_LOSS_OPS),
               dict(bytes=walk["param_floats"] * ADAM_BYTES,
                    flops=walk["param_floats"] * ADAM_OPS))


def step(walk: Dict, cfg: Dict) -> Dict[str, float]:
    """The whole step's counts for a step of one camera's render."""
    return add(render(walk, cfg), update(walk, cfg))


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The card's published float32 and memory peaks, or None for a card
    the table does not hold."""
    with open(PEAKS_FILE) as fh:
        return json.load(fh)["cards"].get(kind)


def least_seconds(count: Dict[str, float], peak: Dict[str, float]) -> float:
    """The larger of the operations' and the bytes' floor."""
    return max(count["flops"] / peak["fp32_flops_per_s"],
               count["bytes"] / peak["bytes_per_s"])
