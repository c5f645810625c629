"""Port parity: the optical-flow priors (`train/flow.py`) against the JAX
package on the CPU.

Tolerances, each with its reason:
* the warp, composition and loss functions: values and gradients atol
  1e-6 (the same float32 formulas), the values also rel 1e-6
  (trimmed_mse sums its k smallest terms in another order: 1 ulp of a
  mean ~20); a coordinate on the border gets half the gradient in both
  (the clip's tie);
* `render_flow` through the port's plain path against the reference's
  tiled path: the alpha-weighted flow (flow x alpha, what the two renders
  composite) atol 3e-5 x (1 + the largest |displacement|), the
  TOLERANCES.md budget of a composited channel scaled by the channel's
  size; the flow itself wherever alpha > 0.1 at 10x that (dividing by
  alpha); its gradients rel 1e-2 of max(|g|, 1), the gradient row of
  TOLERANCES.md.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.ops.rasterize import RasterConfig as JRC
from dynamic3dgaussians_tpu.ops.rasterize import render as jrender
from dynamic3dgaussians_tpu.train import flow as JF
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig as TRC
from dynamic3dgaussians_tpu_torch.train import flow as TF

torch.set_num_threads(1)
jax.config.update("jax_default_matmul_precision", "highest")

ATOL = 1e-6


def _both(tfn, jfn, args, grad_args=None):
    """Values and the gradients of sum(w * out) w.r.t. `grad_args` (the
    indices of float arguments) of both packages."""
    grad_args = list(range(len(args))) if grad_args is None else grad_args
    jv = jfn(*[jnp.asarray(a) for a in args])
    w = np.random.RandomState(0).normal(size=np.shape(jv)).astype(np.float32)

    def jsum(*xs):
        return jnp.sum(jfn(*xs) * w)

    jg = jax.grad(jsum, argnums=tuple(grad_args))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.tensor(np.array(a), requires_grad=i in grad_args)
             for i, a in enumerate(args)]
    tv = tfn(*targs)
    tg = torch.autograd.grad(torch.sum(tv * torch.as_tensor(w)),
                             [targs[i] for i in grad_args])
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               atol=ATOL, rtol=ATOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)
    return tv.detach().numpy()


def _flow(h, w, seed, scale=2.5):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, scale, (h, w, 2))).astype(np.float32)


def test_bilinear_sample_and_warp_match():
    rng = np.random.RandomState(1)
    img = rng.rand(12, 16, 3).astype(np.float32)
    # inside, on the border and beyond it (clamped)
    coords = rng.uniform(-3, 19, (30, 2)).astype(np.float32)
    coords[:4] = [[0, 0], [15, 11], [15.5, -2], [7.25, 11]]
    _both(TF.bilinear_sample, JF.bilinear_sample, [img, coords])
    out = _both(TF.warp_image, JF.warp_image, [img, _flow(12, 16, 2)])
    assert out.shape == (12, 16, 3)
    # zero flow is the identity
    np.testing.assert_array_equal(
        TF.warp_image(torch.as_tensor(img),
                      torch.zeros(12, 16, 2)).numpy(), img)


def test_compose_and_accumulate_flows_match():
    flows = [_flow(10, 14, s, 1.5) for s in range(3)]
    _both(TF.compose_flows, JF.compose_flows, flows[:2])
    _both(lambda *f: TF.accumulate_flows(list(f)),
          lambda *f: JF.accumulate_flows(list(f)), flows)
    # a translation composed with a translation adds up
    a = torch.full((10, 14, 2), 1.0)
    b = torch.full((10, 14, 2), 0.5)
    np.testing.assert_array_equal(TF.compose_flows(a, b)[:8, :12].numpy(),
                                  1.5)


@pytest.mark.parametrize("trim", [0.0, 0.1, 0.5])
def test_trimmed_mse_and_consistency_loss_match(trim):
    rng = np.random.RandomState(3)
    err = rng.normal(size=(9, 11)).astype(np.float32)
    _both(lambda e: TF.trimmed_mse(e, trim), lambda e: JF.trimmed_mse(e, trim),
          [err])
    m, p = _flow(9, 11, 4), _flow(9, 11, 5)
    mask = (rng.rand(9, 11) > 0.3).astype(np.float32)
    _both(lambda a, b: TF.flow_consistency_loss(a, b, trim=trim),
          lambda a, b: JF.flow_consistency_loss(a, b, trim=trim), [m, p])
    _both(lambda a, b, k: TF.flow_consistency_loss(a, b, k, trim=trim),
          lambda a, b, k: JF.flow_consistency_loss(a, b, k, trim=trim),
          [m, p, mask], grad_args=[0, 1])
    # the trimmed share is left out: one huge error does not count
    e = torch.ones(10)
    e[3] = 100.0
    assert float(TF.trimmed_mse(e, 0.1)) == 1.0


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("channel_first", [False, True])
def test_load_flow_npz_matches(tmp_path, kind, channel_first):
    flow = _flow(6, 8, 6)
    disk = flow.transpose(2, 0, 1) if channel_first else flow
    a, b = (3, 5) if kind == "fwd" else (3, 1)
    np.savez(tmp_path / f"{a:05d}_{kind}.npz", flow=disk.astype(np.float64),
             mask=np.ones((6, 8)))
    got = TF.load_flow_npz(str(tmp_path), a, b)
    assert got.dtype == np.float32 and got.shape == (6, 8, 2)
    np.testing.assert_array_equal(got, flow)
    np.testing.assert_array_equal(got, JF.load_flow_npz(str(tmp_path), a, b))


def _flow_scene(seed=7, n=60):
    rng = np.random.RandomState(seed)
    means0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    means1 = means0 + rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    colors = rng.rand(n, 3).astype(np.float32)
    opac = rng.uniform(0.3, 0.9, (n,)).astype(np.float32)
    scales = rng.uniform(0.05, 0.15, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    k = [[40.0, 0, 24], [0, 40.0, 16], [0, 0, 1]]
    return (means0, means1, colors, opac, scales, quats,
            jcam.make_camera(48, 32, k, w2c),
            tcam.make_camera(48, 32, k, w2c, device="cpu"))


def test_render_flow_matches_tiled_reference():
    m0, m1, col, op, sc, q, jc, tc = _flow_scene()
    jcfg = JRC(chunk=64, max_per_tile=256, max_tiles_per_gaussian=16,
               pairs_per_gaussian=16)
    tcfg = TRC(chunk=64, max_tiles_per_gaussian=16)

    def jflow(a, b):
        return JF.render_flow(jc, a, b, jnp.asarray(col), jnp.asarray(op),
                              jnp.asarray(sc), jnp.asarray(q), config=jcfg,
                              method="tiled")

    def tflow(a, b):
        return TF.render_flow(tc, a, b, col, op, sc, q, config=tcfg,
                              method="torch", device="cpu")

    alpha = np.asarray(jrender(jc, jnp.asarray(m0), jnp.asarray(col),
                               jnp.asarray(op), jnp.asarray(sc),
                               jnp.asarray(q), config=jcfg,
                               method="tiled").alpha)
    assert (alpha > 0.1).mean() > 0.3
    jv = np.asarray(jflow(jnp.asarray(m0), jnp.asarray(m1)))
    t0 = torch.tensor(m0, requires_grad=True)
    t1 = torch.tensor(m1, requires_grad=True)
    tv = tflow(t0, t1)
    assert tv.shape == (32, 48, 2)
    span = 1.0 + float(np.abs(jv[alpha > 0.1]).max())
    np.testing.assert_allclose(tv.detach().numpy() * alpha[..., None],
                               jv * alpha[..., None], atol=3e-5 * span)
    cov = alpha > 0.1
    np.testing.assert_allclose(tv.detach().numpy()[cov], jv[cov],
                               atol=3e-4 * span)
    # zero motion is zero flow
    assert float(torch.abs(tflow(t0, t0)).detach().max()) == 0.0
    # gradients through both projections and the render
    w = np.random.RandomState(8).normal(size=jv.shape).astype(np.float32)
    w = w * (alpha[..., None] > 0.1)
    jg = jax.grad(lambda a, b: jnp.sum(jflow(a, b) * w), argnums=(0, 1))(
        jnp.asarray(m0), jnp.asarray(m1))
    tg = torch.autograd.grad(torch.sum(tv * torch.as_tensor(w)), [t0, t1])
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        assert (np.abs(a.numpy() - b) / np.maximum(np.abs(b), 1.0)).max() \
            <= 1e-2


def test_raft_flow_fn_never_downloads(tmp_path, monkeypatch):
    """Without torchvision, or without the weights file, it raises; it
    never reaches for the network."""
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="RAFT"):
        TF.make_torch_raft_flow_fn(device="cpu")
    with pytest.raises(RuntimeError, match="RAFT"):
        TF.make_torch_raft_flow_fn(str(tmp_path / "missing.pth"),
                                   device="cpu")
