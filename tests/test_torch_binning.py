"""Port parity: pair emission and tile ranges against the JAX package.

Emission is integer plumbing on float32 geometry computed identically on
both sides, so keys and drop counts must agree exactly, with the exact
cull on and off, including a big-splat scene whose K slots overflow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.ops import binning as jbin
from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.ops import projection as jproj
from dynamic3dgaussians_tpu_torch.ops import binning as tbin
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import projection as tproj
from tests.scenes import random_scene

torch.set_num_threads(1)

W, H, F = 64, 48, 50.0
TH = TW = 16
GH, GW = -(-H // TH), -(-W // TW)


def _projected(n, seed, scale_lo, scale_hi):
    k = [[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]]
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    means, _, opac, scales, quats = random_scene(n, seed=seed,
                                                 scale_lo=scale_lo,
                                                 scale_hi=scale_hi)
    jp = jproj.project(jnp.asarray(means), jnp.asarray(scales),
                       jnp.asarray(quats), jcam.make_camera(W, H, k, w2c))
    tp = tproj.project(torch.as_tensor(means), torch.as_tensor(scales),
                       torch.as_tensor(quats),
                       tcam.make_camera(W, H, k, w2c, device="cpu"))
    jop = jnp.where(jp.valid, jnp.asarray(opac), 0.0)
    top = torch.where(tp.valid, torch.as_tensor(opac), 0.0)
    return jp, tp, jop, top


# (scene scale range, K, exact cull, expect drops)
CASES = {
    "small_plain": ((0.02, 0.12), 8, False, False),
    "small_cull": ((0.02, 0.12), 8, True, False),
    "big_plain": ((0.3, 0.6), 4, False, True),
    "big_cull": ((0.3, 0.6), 4, True, True),
    "big_cull_k8": ((0.3, 0.6), 8, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emit_pairs_matches(case):
    (lo, hi), k_cap, cull, expect_drops = CASES[case]
    jp, tp, jop, top = _projected(200, 21, lo, hi)
    cap = max(16, 2 * k_cap) if cull else 0
    jk, jg, jd = jbin.emit_pairs(jp, TH, TW, GH, GW, k_cap,
                                 opacity=jop if cull else None, enum_cap=cap)
    tk, tg, td = tbin.emit_pairs(tp, TH, TW, GH, GW, k_cap,
                                 opacity=top if cull else None, enum_cap=cap)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert int(td) == int(jd)
    assert (int(td) > 0) == expect_drops
    assert tk.dtype == torch.int32 and int((tk < GH * GW).sum()) > 0


def test_exact_cull_drops_fewer_pairs():
    jp, tp, jop, top = _projected(200, 22, 0.3, 0.6)
    _, _, plain = tbin.emit_pairs(tp, TH, TW, GH, GW, 4)
    _, _, cull = tbin.emit_pairs(tp, TH, TW, GH, GW, 4, opacity=top,
                                 enum_cap=16)
    assert int(cull) <= int(plain)


def test_tile_ranges_matches():
    rng = np.random.RandomState(5)
    num_tiles = 12
    keys = np.sort(rng.randint(0, num_tiles + 1, 500)).astype(np.int32)
    keys[:40] = 0
    keys = np.sort(keys)
    js, jc = jbin.tile_ranges(jnp.asarray(keys), num_tiles)
    ts, tc = tbin.tile_ranges(torch.as_tensor(keys), num_tiles)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc.sum()) == int((keys < num_tiles).sum())
