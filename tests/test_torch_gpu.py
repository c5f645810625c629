"""The port's CUDA kernels on the card (marker `gpu`; skipped without one).

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch with CUDA and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

(`--noconftest`: the suite's conftest sets JAX up.) Each kernel is held
against its plain PyTorch version on the same card. Tolerances of the
forward kernel K1: channel rows atol 1e-4, depth row and log2 transmittance
1e-3 -- the alpha chain is computed identically, the sums in another order
(sequential against cumsum + bmm) -- and n_active exact. Of the backward
kernel K2: per gradient row, |kernel - plain| <= 1e-3 |plain| + 1e-4 x the
row's largest magnitude -- the kernel sums the tile's pixels in a shuffle
tree and the suffix sequentially, the plain version with torch.sum and
cumsum, so float32 sums of up to 256 x 128 terms are reassociated.
"""

import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import rasterize as trast
from dynamic3dgaussians_tpu_torch.ops.cuda import raster_bwd as K2
from dynamic3dgaussians_tpu_torch.ops.cuda import raster_fwd as K1
from test_torch_cases import CASES, kernel_kw, record_table

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain(cuda_device, case):
    spec = dict(CASES[case])
    chunk = spec["chunk"]
    rec, starts, counts, n_chan = record_table(**spec)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (rec, starts, counts)]
    before = K1.composite_tiles.launches
    kraw, klogt, knact = K1.composite_tiles(*args, **kernel_kw(chunk))
    torch.cuda.synchronize()
    assert K1.composite_tiles.launches == before + 1
    praw, plogt, pnact = K1.composite_tiles_torch(*args, **kernel_kw(chunk))
    rows = [i for i in range(kraw.shape[-1]) if i != n_chan]
    torch.testing.assert_close(kraw[..., rows], praw[..., rows], atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(kraw[..., n_chan], praw[..., n_chan],
                               atol=1e-3, rtol=0)
    torch.testing.assert_close(klogt, plogt, atol=1e-3, rtol=0)
    assert torch.equal(knact, pnact)


def test_cuda_kernel_refuses_unbuilt_width(cuda_device):
    """CV = 56 has no kernel instance: a CUDA tensor raises, it never falls
    back to the plain version."""
    rec, starts, counts, _ = record_table(seed=6, counts=[5] * 12,
                                          n_chan=50, chunk=64)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (rec, starts, counts)]
    before = K1.composite_tiles.launches
    with pytest.raises(ValueError):
        K1.composite_tiles(*args, **kernel_kw(64))
    assert K1.composite_tiles.launches == before


def _scene(n, seed):
    rng = np.random.RandomState(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, (n,)).astype(np.float32)
    scales = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    seg = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return (means, colors, opac, scales, quats), seg


def test_cuda_render_matches_torch_path(cuda_device):
    arrays, seg = _scene(300, seed=3)
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    cam = tcam.make_camera(128, 96, [[90.0, 0, 64], [0, 90.0, 48],
                                     [0, 0, 1]], w2c, device=cuda_device)
    args = [torch.as_tensor(a, device=cuda_device) for a in arrays]
    extra = torch.as_tensor(seg, device=cuda_device)
    before = K1.composite_tiles.launches
    k = trast.render(cam, *args, extra_channels=extra, device=cuda_device)
    assert K1.composite_tiles.launches == before + 1
    p = trast.render(cam, *args, extra_channels=extra, method="torch",
                     device=cuda_device)
    assert K1.composite_tiles.launches == before + 1
    assert int(k.n_dropped_rect) == 0
    for name in ("rgb", "alpha", "extra"):
        torch.testing.assert_close(getattr(k, name), getattr(p, name),
                                   atol=1e-4, rtol=0)
    torch.testing.assert_close(k.depth, p.depth, atol=1e-3, rtol=0)
    torch.testing.assert_close(k.radii, p.radii, atol=0, rtol=0)


def assert_rows_close(got, want, rtol=1e-3, row_atol=1e-4):
    """|got - want| <= rtol |want| + row_atol * max |want| of the row."""
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    err = (got - want).abs() - rtol * want.abs() - row_atol * scale
    assert float(err.max()) <= 0.0, float(err.max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_bwd_kernel_matches_plain(cuda_device, case):
    spec = dict(CASES[case])
    chunk = spec["chunk"]
    rec, starts, counts, _ = record_table(**spec)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (rec, starts, counts)]
    kw = kernel_kw(chunk)
    raw, log_t, n_active = K1.composite_tiles(*args, **kw)
    d_raw = torch.as_tensor(np.random.RandomState(11).normal(
        size=tuple(raw.shape)).astype(np.float32), device=cuda_device)
    bwd_args = args + [n_active.reshape(-1), log_t, d_raw]
    before = K2.composite_tiles_bwd.launches
    k = K2.composite_tiles_bwd(*bwd_args, **kw)
    torch.cuda.synchronize()
    assert K2.composite_tiles_bwd.launches == before + 1
    p = K2.composite_tiles_bwd_torch(*bwd_args, **kw)
    assert torch.isfinite(k).all()
    assert float(k.abs().max()) > 0
    assert_rows_close(k, p)


def test_cuda_bwd_kernel_refuses_unbuilt_width(cuda_device):
    rec, starts, counts, _ = record_table(seed=6, counts=[5] * 12,
                                          n_chan=50, chunk=64)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (rec, starts, counts)]
    n_val = rec.shape[0] - 8
    before = K2.composite_tiles_bwd.launches
    with pytest.raises(ValueError):
        K2.composite_tiles_bwd(
            *args, torch.ones(12, dtype=torch.int32, device=cuda_device),
            torch.zeros((12, 256, 1), device=cuda_device),
            torch.zeros((12, 256, n_val), device=cuda_device),
            **kernel_kw(64))
    assert K2.composite_tiles_bwd.launches == before


def test_cuda_train_step(cuda_device):
    """One train step through both kernels on the card: the gradients are
    finite and agree with the plain versions' on the same card (per group,
    rel 1e-3 against max(|g|, 1)), and the step updates the parameters."""
    from dynamic3dgaussians_tpu_torch.data import synthetic
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.train import optim
    from dynamic3dgaussians_tpu_torch.train import trainer as T
    from dynamic3dgaussians_tpu_torch.train.config import (RasterSettings,
                                                           TrainConfig)

    scene = synthetic.make_gt_scene(n_fg=60, n_bg=120, seed=0)
    data, w2c, _ = synthetic.make_dataset(scene, 1, num_cams=2, w=64, h=48,
                                          f=55.0, device=cuda_device)
    pt = synthetic.init_point_cloud(scene, noise=0.05)

    def grads(method):
        cfg = TrainConfig(num_timesteps=1, capacity=1024, raster=RasterSettings(
            chunk=64, max_tiles_per_gaussian=64, method=method))
        params, variables = G.init_params(pt, w2c, capacity=1024,
                                          device=cuda_device)
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        probe = torch.zeros((1024, 2), device=cuda_device,
                            requires_grad=True)
        loss, _ = T.compute_loss(leaves, probe, data[0][0], variables,
                                 is_initial=True, cfg=cfg,
                                 rcfg=T.raster_config(cfg))
        keys = ["means3D", "rgb_colors", "logit_opacities", "log_scales",
                "unnorm_rotations"]
        g = torch.autograd.grad(loss, [leaves[k] for k in keys] + [probe])
        return cfg, params, variables, float(loss.detach()), dict(zip(keys + ["probe"],
                                                             g))

    k1, k2 = K1.composite_tiles.launches, K2.composite_tiles_bwd.launches
    cfg, params, variables, loss_k, g_k = grads("cuda")
    assert K1.composite_tiles.launches == k1 + 1
    assert K2.composite_tiles_bwd.launches == k2 + 1
    _, _, _, loss_p, g_p = grads("torch")
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for name, g in g_k.items():
        assert torch.isfinite(g).all(), name
        scale = torch.clamp(g_p[name].abs(), min=1.0)
        assert float(((g - g_p[name]).abs() / scale).max()) <= 1e-3, name
    assert float(g_k["means3D"].abs().max()) > 0

    step = T.make_train_step(cfg, T.raster_config(cfg))
    lrs = {k: torch.tensor(cfg.lrs.get(k, 0.0), device=cuda_device)
           for k in params}
    new_params, _, new_vars, metrics = step(
        {k: v.detach() for k, v in params.items()}, optim.init(params),
        variables, data[0][1], lrs, True)
    assert np.isfinite(float(metrics["loss"]))
    assert float((new_params["rgb_colors"] - params["rgb_colors"].detach())
                 .abs().max()) > 0
    assert float(new_vars["denom"].sum()) > 0
