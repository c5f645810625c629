"""Port parity: render gradients.

Gradients of one scalar loss with respect to means, colors, opacity,
scales, quaternions, an extra-channel table and the `mean2d_probe_ndc`
densification probe, through the port's `render(method="torch")` (the
autograd Function over the plain versions of K1 and K2), against:

* the port's `method="reference"` (plain autograd through the oracle);
* the JAX package's `render(method="pallas")` (its custom_vjp, Pallas
  kernels in interpret mode on the CPU) and `method="tiled"` (autodiff of
  its pure-XLA path);
* the frozen gradients of `tests/fixtures/golden_render_*.npz`.

Tolerance: |port - target| <= rel x max(|target|, 1) elementwise, rel 1e-3
against the live implementations (the same float32 sums over pairs and
pixels, taken in other orders) and 1e-2 against the fixtures, the CPU
gradient row of `tests/fixtures/TOLERANCES.md`. Every JAX-side render
asserts n_dropped_rect == 0.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.ops import rasterize as jrast
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import rasterize as trast
from tests.scenes import random_scene

torch.set_num_threads(1)

REL_LIVE, REL_FIXTURE = 1e-3, 1e-2
NAMES = ("means", "colors", "opacity", "scales", "quats", "extra", "probe")
FIXTURES = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "fixtures", "golden_render_*.npz")))


def _assert_rel(got, want, rel, name):
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() <= rel, (name, float(err.max()))


def _scene(n=150, seed=0, w=64, h=48, f=50.0):
    k = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    arrays = list(random_scene(n, seed=seed))
    rng = np.random.RandomState(seed + 100)
    arrays.append(rng.rand(n, 3).astype(np.float32))         # extra
    arrays.append(np.zeros((n, 2), np.float32))              # probe
    cot = dict(rgb=rng.normal(size=(h, w, 3)).astype(np.float32),
               depth=rng.normal(size=(h, w)).astype(np.float32),
               extra=rng.normal(size=(h, w, 3)).astype(np.float32))
    return (jcam.make_camera(w, h, k, w2c),
            tcam.make_camera(w, h, k, w2c, device="cpu"), arrays, cot)


BG = np.array([0.2, 0.1, 0.4], np.float32)


def _torch_grads(cam, arrays, cot, method, cfg=None, grad_mask=None):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    m, c, o, s, q, e, p = ts
    out = trast.render(cam, m, c, o, s, q, extra_channels=e,
                       mean2d_probe_ndc=p, bg=torch.as_tensor(BG),
                       grad_mask=grad_mask, method=method,
                       config=cfg or trast.RasterConfig(
                           max_tiles_per_gaussian=64), device="cpu")
    assert int(out.n_dropped_rect) == 0
    loss = (torch.sum(out.rgb * torch.as_tensor(cot["rgb"]))
            + torch.sum(out.depth * torch.as_tensor(cot["depth"]))
            + torch.sum(out.extra * torch.as_tensor(cot["extra"]))
            + 0.3 * torch.sum(out.alpha))
    return [g.numpy() for g in torch.autograd.grad(loss, ts)]


def _jax_grads(cam, arrays, cot, method):
    cfg = jrast.RasterConfig(max_tiles_per_gaussian=64, max_per_tile=512,
                             pairs_per_gaussian=64)

    def loss(m, c, o, s, q, e, p):
        out = jrast.render(cam, m, c, o, s, q, extra_channels=e,
                           mean2d_probe_ndc=p, bg=jnp.asarray(BG),
                           method=method, config=cfg)
        return (jnp.sum(out.rgb * cot["rgb"])
                + jnp.sum(out.depth * cot["depth"])
                + jnp.sum(out.extra * cot["extra"])
                + 0.3 * jnp.sum(out.alpha)), out

    # jitted: one compile of the interpret-mode kernels instead of eager
    # dispatch of their every grid step
    grads, out = jax.jit(jax.grad(loss, argnums=tuple(range(7)),
                                  has_aux=True))(*map(jnp.asarray, arrays))
    assert int(out.n_dropped_rect) == 0
    assert int(out.n_dropped_capacity) == 0
    assert int(out.n_dropped_tile_overflow) == 0
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("target", ["port_reference", "jax_pallas",
                                    "jax_tiled"])
def test_render_grads_match(target):
    jc, tc, arrays, cot = _scene()
    ours = _torch_grads(tc, arrays, cot, "torch")
    if target == "port_reference":
        want = _torch_grads(tc, arrays, cot, "reference")
    else:
        want = _jax_grads(jc, arrays, cot, target.split("_")[1])
    for name, a, b in zip(NAMES, ours, want):
        _assert_rel(a, b, REL_LIVE, name)
    assert all(np.abs(g).max() > 0 for g in ours)


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_grads_match_frozen_fixture(path):
    fx = dict(np.load(path))
    w, h, f = int(fx["w"]), int(fx["h"]), float(fx["f"])
    cam = tcam.make_camera(w, h, [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                           fx["w2c"], device="cpu")
    cfg = trast.RasterConfig(tile_h=16, tile_w=16, chunk=128,
                             max_tiles_per_gaussian=int(fx["k_cap"]))
    ts = [torch.tensor(fx[k], requires_grad=True)
          for k in ("means", "colors", "opac", "scales", "quats")]
    kw = {}
    if "extra_in" in fx:
        kw["extra_channels"] = torch.as_tensor(fx["extra_in"])
    out = trast.render(cam, *ts, method="torch", config=cfg, device="cpu",
                       **kw)
    assert int(out.n_dropped_rect) == 0
    loss = (torch.sum(out.rgb * torch.as_tensor(fx["ct_rgb"]))
            + torch.sum(out.depth * torch.as_tensor(fx["ct_depth"])))
    if out.extra is not None:
        loss = loss + torch.sum(out.extra * 0.1)
    grads = torch.autograd.grad(loss, ts)
    for key, g in zip(("d_means", "d_colors", "d_opac", "d_scales",
                       "d_quats"), grads):
        _assert_rel(g.numpy(), fx[key], REL_FIXTURE, key)


def test_grad_mask_zeroes_masked_rows():
    """grad_mask (the reference's `label` gating) zeroes every gradient of
    the masked gaussians, leaves the others' gradients and the image as
    they are, and matches the JAX package's gating."""
    jc, tc, arrays, cot = _scene(n=60, seed=4, w=32, h=32)
    mask = (np.arange(60) % 3 != 0).astype(np.float32)
    free = _torch_grads(tc, arrays, cot, "torch")
    gated = _torch_grads(tc, arrays, cot, "torch",
                         grad_mask=torch.as_tensor(mask))
    for name, a, b in zip(NAMES, free, gated):
        if name == "probe":        # the probe is not gated
            np.testing.assert_array_equal(a, b)
            continue
        np.testing.assert_array_equal(b[mask == 0], 0.0)
        np.testing.assert_array_equal(b[mask == 1], a[mask == 1])
    assert np.abs(free[0][mask == 0]).max() > 0

    def jloss(m):
        out = jrast.render(jc, m, *map(jnp.asarray, arrays[1:5]),
                           grad_mask=jnp.asarray(mask), method="reference")
        return jnp.sum(out.rgb * cot["rgb"][:32, :32])
    jg = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(arrays[0])))
    m = torch.tensor(arrays[0], requires_grad=True)
    out = trast.render(tc, m, *map(torch.as_tensor, arrays[1:5]),
                       grad_mask=torch.as_tensor(mask), method="torch",
                       device="cpu")
    (tg,) = torch.autograd.grad(
        torch.sum(out.rgb * torch.as_tensor(cot["rgb"][:32, :32])), m)
    _assert_rel(tg.numpy(), jg, REL_LIVE, "means")
