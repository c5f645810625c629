"""The tile kernels' footprint cull, through its Python mirror.

K1 and K2 skip a (warp, record) pair when the record's conservative box
(`csrc/alpha.cuh::record_box`, mirrored by
`ops/cuda/raster_fwd.py::footprint_boxes`) misses the warp's pixels. That
is exact only if the box holds every pixel at which the record passes the
1/255 gate. These tests hold the mirror to that against the plain alpha
chain (the float32 operations of `composite_tiles_torch`), with
`hypothesis` drawing conics down to near-degenerate ones and opacities at
and just above the gate; and they hold the thread-to-pixel map the
kernels use. No JAX: the reference has no cull.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamic3dgaussians_tpu_torch.ops.compositing import ALPHA_EPS, ALPHA_MAX
from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import (
    footprint_boxes, warp_pixel_map)

torch.set_num_threads(1)

EPS32 = float(np.float32(ALPHA_EPS))
HALF = 64    # pixels checked on each side of the record's centre


def _record(x, y, a, b, c, op):
    return torch.tensor([[x], [y], [a], [b], [c], [op]], dtype=torch.float32)


def _live_pixels(rec):
    """(px, py, live) over the window around the record: the plain alpha
    chain of `composite_tiles_torch`, one rounding at a time."""
    x, y, ca, cb, cc, op = (rec[i, 0] for i in range(6))
    cx, cy = int(math.floor(float(x))), int(math.floor(float(y)))
    px = torch.arange(cx - HALF, cx + HALF + 1, dtype=torch.float32)
    py = torch.arange(cy - HALF, cy + HALF + 1, dtype=torch.float32)
    py, px = torch.meshgrid(py, px, indexing="ij")
    dx, dy = x - px, y - py
    power = torch.clamp(-0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy,
                        max=0.0)
    alpha = torch.clamp(op * torch.exp2(power), max=ALPHA_MAX)
    return px, py, alpha >= ALPHA_EPS


def _assert_box_holds_live(rec):
    box = footprint_boxes(rec)[:, 0]
    px, py, live = _live_pixels(rec)
    inside = ((px >= box[0]) & (px <= box[1]) & (py >= box[2])
              & (py <= box[3]))
    missed = live & ~inside
    assert not bool(missed.any()), (rec[:, 0].tolist(), box.tolist(),
                                    int(missed.sum()))
    return box, live


near_one = st.sampled_from([1 - 1e-3, 1 - 1e-4, 1 - 1e-5, 1 - 1e-6])
rho = st.one_of(st.floats(-0.999, 0.999), near_one, near_one.map(lambda r: -r))
opacity = st.one_of(
    st.floats(EPS32, 1.0),
    # at the gate and a few float32 steps above it
    st.integers(0, 64).map(lambda k: float(np.float32(EPS32)
                                           * np.float32(1 + k * 2.0 ** -23))),
    st.floats(0.9, 0.99))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(la=st.floats(-3.0, 1.0), lc=st.floats(-3.0, 1.0), r=rho, op=opacity,
       fx=st.floats(0.0, 1.0, exclude_max=True),
       fy=st.floats(0.0, 1.0, exclude_max=True))
def test_box_holds_every_live_pixel(la, lc, r, op, fx, fy):
    a, c = 10.0 ** la, 10.0 ** lc
    b = r * math.sqrt(a * c)
    _assert_box_holds_live(_record(100.0 + fx, 80.0 + fy, a, b, c, op))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(la=st.floats(-3.0, 1.0), lc=st.floats(-3.0, 1.0), r=rho, op=opacity,
       axis=st.sampled_from(["x", "y"]), sign=st.sampled_from([-1.0, 1.0]),
       k=st.floats(1.0, 8.0))
def test_box_holds_a_live_pixel_at_the_extreme(la, lc, r, op, axis, sign, k):
    """The record is placed so that pixel (100, 80) lies a relative 10^-k
    inside the extreme point of its live ellipse along x or y, where the
    box is tightest."""
    a, c = 10.0 ** la, 10.0 ** lc
    b = r * math.sqrt(a * c)
    two_l = 2.0 * math.log2(op / EPS32)
    det = a * c - b * b
    t = sign * (1.0 - 10.0 ** -k)
    if axis == "y":     # max dy on the ellipse: dx = -(b / a) dy
        dy = t * math.sqrt(two_l * a / det)
        dx = -(b / a) * dy
    else:
        dx = t * math.sqrt(two_l * c / det)
        dy = -(b / c) * dx
    if max(abs(dx), abs(dy)) > HALF - 1:
        return
    _assert_box_holds_live(_record(100.0 + dx, 80.0 + dy, a, b, c, op))


@pytest.mark.parametrize("op", [EPS32, float(np.nextafter(np.float32(EPS32),
                                                           np.float32(1)))])
def test_box_holds_a_cell_exactly_at_the_gate(op):
    """A record centred on a pixel with opacity at the gate is live there,
    with alpha exactly 1/255 (power 0): its box must hold that pixel."""
    box, live = _assert_box_holds_live(_record(40.0, 30.0, 0.7, 0.1, 0.4, op))
    assert int(live.sum()) >= 1
    assert float(box[0]) <= 40.0 <= float(box[1])


def test_dead_and_unbounded_records():
    below = float(np.nextafter(np.float32(EPS32), np.float32(0)))
    recs = torch.cat([
        _record(5.0, 5.0, 0.5, 0.0, 0.5, below),          # dead everywhere
        _record(5.0, 5.0, 0.5, 0.6, 0.5, 0.8),            # not pos. definite
        _record(5.0, 5.0, -0.5, 0.0, 0.5, 0.8),           # negative a
        _record(5.0, 5.0, float("nan"), 0.0, 0.5, 0.8),   # NaN conic
        _record(5.0, 5.0, 0.5, 0.0, 0.5, float("nan")),   # NaN opacity
    ], dim=1)
    box = footprint_boxes(recs)
    inf = float("inf")
    assert box[:, 0].tolist() == [inf, -inf, inf, -inf]
    for j in range(1, 5):
        assert box[:, j].tolist() == [-inf, inf, -inf, inf], j
    _, _, live = _live_pixels(recs[:, :1])
    assert not bool(live.any())


def test_box_is_tight_for_a_round_splat():
    """The margins are small: a round splat's box is its live disk's
    radius plus at most ~0.02 px."""
    a = 0.5
    op = 0.5
    box = footprint_boxes(_record(10.0, 10.0, a, 0.0, a, op))[:, 0]
    r = math.sqrt(2.0 * math.log2(op / EPS32) / a)
    assert r <= float(box[1]) - 10.0 <= r + 0.02


@pytest.mark.parametrize("shape", [(16, 16), (8, 32), (4, 8), (16, 8),
                                   (6, 16), (4, 4)])
def test_warp_pixel_map(shape):
    """The kernels' thread-to-pixel map is a permutation of the tile; with
    8x4 blocks available each warp is one, else 32 row-major pixels."""
    th, tw = shape
    m = warp_pixel_map(th, tw)
    assert sorted(m.tolist()) == list(range(th * tw))
    xs, ys = m % tw, m // tw
    for w in range(-(-th * tw // 32)):
        wx, wy = xs[32 * w:32 * w + 32], ys[32 * w:32 * w + 32]
        if tw % 8 == 0 and th % 4 == 0:
            assert int(wx.max() - wx.min()) == 7
            assert int(wy.max() - wy.min()) == 3
        else:
            assert m[32 * w:32 * w + 32].tolist() == list(
                range(32 * w, min(32 * w + 32, th * tw)))
