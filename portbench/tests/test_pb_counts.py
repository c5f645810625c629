"""The work counts against hand counts on tiny tables."""

import pytest
import torch

from portbench import counts
from portbench.reference import render as R


def test_value_rows_pad_channels_depth_and_alpha_to_eight():
    assert counts.value_rows(6) == 8
    assert counts.value_rows(38) == 40


def test_k1_hand_count():
    # 3 pairs read on 2 tiles at 6 channels: 16 table rows of 4 B a pair;
    # 8 accumulators and the log transmittance per pixel; 3 ints a tile
    c = counts.k1(3, 2, 6)
    assert c["bytes"] == 3 * 16 * 4 + 2 * 256 * 9 * 4 + 2 * 12
    assert c["flops"] == 3 * 256 * (10 + 2 * 8)


def test_k2_hand_count():
    c = counts.k2(3, 2, 6)
    assert c["bytes"] == 2 * 3 * 16 * 4 + 2 * 256 * 9 * 4 + 2 * 12
    assert c["flops"] == 3 * 256 * (10 + 4 * 8)


def test_e1_hand_count():
    assert counts.e1(5, 3) == {"bytes": 5 * 29 + 3 * 8, "flops": 0}


def test_step_sums_its_parts():
    walk = dict(read_pairs=3, live_pairs=4, tiles=2, rows=5, fg_rows=2,
                edges=4, param_floats=50)
    cfg = dict(semantic_dim=0, capacity=8, width=4, height=2)
    got = counts.step(walk, cfg)
    parts = [counts.k1(3, 2, 6), counts.k2(3, 2, 6), counts.e1(8, 4),
             dict(bytes=2 * 5 * 88, flops=5 * 150),
             dict(bytes=4 * 24 + 2 * 72 + 5 * 120, flops=4 * 100 + 5 * 30),
             dict(bytes=6 * 8 * 12, flops=6 * 8 * 444),
             dict(bytes=50 * 28, flops=50 * 10)]
    assert got == {"bytes": sum(p["bytes"] for p in parts),
                   "flops": sum(p["flops"] for p in parts)}


def test_p1_hand_count():
    # 24 B an edge, 72 B a foreground row, 100 operations an edge
    assert counts.p1(3, 7) == {"bytes": 7 * 24 + 3 * 72, "flops": 7 * 100}


def test_a_step_is_its_render_and_its_update():
    walk = dict(read_pairs=3, live_pairs=4, tiles=2, rows=5, fg_rows=2,
                edges=4, param_floats=50)
    cfg = dict(semantic_dim=0, capacity=8, width=4, height=2)
    render, update = counts.render(walk, cfg), counts.update(walk, cfg)
    assert update == {"bytes": 4 * 24 + 2 * 72 + 5 * 120 + 50 * 28,
                      "flops": 4 * 100 + 5 * 30 + 50 * 10}
    assert counts.add(render, update) == counts.step(walk, cfg)


def test_least_seconds_takes_the_larger_floor():
    peak = {"fp32_flops_per_s": 1e3, "bytes_per_s": 1e2}
    assert counts.least_seconds({"flops": 4e3, "bytes": 1e2}, peak) == 4.0
    assert counts.least_seconds({"flops": 1e3, "bytes": 5e2}, peak) == 5.0
    assert counts.peaks("NVIDIA H100 80GB HBM3")["bytes_per_s"] == 3.35e12
    assert counts.peaks("no such card") is None


def _one_view(points, scales, k_slots=64):
    cam = R.make_cam([[50.0, 0, 32.0], [0, 50.0, 16.0], [0, 0, 1]],
                     [[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 5.0],
                      [0, 0, 0, 1]], 64, 32, "cpu")
    n = len(points)
    means = torch.tensor(points, dtype=torch.float32)
    sc = torch.tensor(scales, dtype=torch.float32)[:, None].repeat(1, 3)
    quats = torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1)
    vals = torch.ones((n, 6))
    return R.render(means, sc, quats, torch.full((n,), 0.9), vals, cam,
                    k_slots, 128)[1]


@pytest.mark.parametrize("k_slots,live", [(64, 8), (4, 4)])
def test_walk_counts_pairs_by_hand(k_slots, live):
    # a 64x32 image is 4 x 2 tiles; a point at the image centre with a
    # wide splat reaches all 8 tiles, one at pixel (8, 8) with a 0.01 px
    # splat (0.3 px of blur) only its own
    st = _one_view([[0.0, 0.0, 0.0]], [1.0], k_slots)
    assert st["tiles"] == 8
    assert st["live_pairs"] == live and st["read_pairs"] == live
    st = _one_view([[-2.35, -0.75, 0.0]], [0.001])
    assert st["live_pairs"] == 1 and st["read_pairs"] == 1
