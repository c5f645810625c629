"""Feature-3DGS OO trainer: RGB and a distilled semantic-feature field.

Port of `dynamic3dgaussians_tpu/train/feature_trainer.py`:

  training(frames, model, ...)
    per iteration: one frame from a seeded permutation stream, one render
      of RGB (SH at the model's full degree, the coefficients above the
      active degree zeroed) and the gaussians' semantic features in the
      same pass
    loss = (1 - l) L1 + l (1 - SSIM) + feature_weight * L1(features, GT)
      with the rendered feature map resized (bilinear, antialiased when
      shrinking) to the GT map's size, optionally decoded first by
      `FeatureDecoder` (1x1 convs up to the GT feature width)
    Adam on the gaussians (scheduled means lr) and on the decoder (1e-3),
    densify / prune and opacity reset at their cadence, the SH degree
    raised every `sh_increase_every` iterations, capture() checkpoints, and
    an optional network-GUI poll per iteration

The render goes through `ops/rasterize.py::render` with method "auto": the
CUDA kernels K1 and K2 on the card, their plain versions on the CPU. The
trainer renders with the caller's RasterConfig and never raises K, as in
the reference; rect drops, if any, are the reference's too.

The decoder's weights load from the reference's dict {w1, b1, w2, b2}
(`FeatureDecoder.from_jax`); its 1x1 convs are matmuls.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.models.gaussian_model import GaussianModel
from dynamic3dgaussians_tpu_torch.ops import quat
from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig, render
from dynamic3dgaussians_tpu_torch.ops.ssim import calc_ssim
from dynamic3dgaussians_tpu_torch.train import losses as L
from dynamic3dgaussians_tpu_torch.train import optim
from dynamic3dgaussians_tpu_torch.train.trainer import resize_feature_map

DECODER_LR = 1e-3


class FeatureDecoder(nn.Module):
    """The speed-up decoder: (H, W, in_dim) -> (H, W, out_dim) through two
    1x1 convolutions with a ReLU between them, as matmuls."""

    def __init__(self, in_dim: int, out_dim: int, hidden: int = 64,
                 device: DeviceLike = None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=resolve_device(device))
        self.w1 = nn.Parameter(torch.zeros((in_dim, hidden), **f32))
        self.b1 = nn.Parameter(torch.zeros((hidden,), **f32))
        self.w2 = nn.Parameter(torch.zeros((hidden, out_dim), **f32))
        self.b2 = nn.Parameter(torch.zeros((out_dim,), **f32))

    def forward(self, fmap: torch.Tensor) -> torch.Tensor:
        h = torch.relu(torch.matmul(fmap, self.w1) + self.b1)
        return torch.matmul(h, self.w2) + self.b2

    @classmethod
    def from_jax(cls, dec: Dict, device: DeviceLike = None
                 ) -> "FeatureDecoder":
        """The reference's decoder dict {w1, b1, w2, b2} (arrays)."""
        w1, w2 = np.asarray(dec["w1"]), np.asarray(dec["w2"])
        out = cls(w1.shape[0], w2.shape[1], hidden=w1.shape[1],
                  device=device)
        with torch.no_grad():
            for k, p in out.named_parameters():
                p.copy_(torch.as_tensor(np.array(dec[k], np.float32)))
        return out

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The weights as the reference's dict of arrays."""
        return {k: p.detach().cpu().numpy()
                for k, p in self.named_parameters()}


def init_feature_decoder(generator: torch.Generator, in_dim: int,
                         out_dim: int, hidden: int = 64,
                         device: DeviceLike = None) -> FeatureDecoder:
    """He-normal weights from `generator`, zero biases."""
    dec = FeatureDecoder(in_dim, out_dim, hidden, device=device)
    with torch.no_grad():
        for w, fan_in in ((dec.w1, in_dim), (dec.w2, hidden)):
            w.copy_(math.sqrt(2.0 / fan_in) * torch.randn(
                tuple(w.shape), generator=generator, dtype=torch.float32,
                device=w.device))
    return dec


def make_feature_train_step(rcfg: RasterConfig, lambda_dssim: float = 0.2,
                            feature_weight: float = 1.0,
                            sh_degree: int = 0,
                            use_decoder: bool = False):
    """step_fn(params, variables, decoder, batch, active_sh_degree) ->
    (loss, aux, grads of the gaussians, grads of the decoder (None without
    it), grad of the mean2d probe). The render runs at `sh_degree` with the
    coefficients above the active degree zeroed (one shape for the whole
    ramp, and the zeroed coefficients get zero gradient)."""

    def step_fn(params, variables, decoder, batch, active_sh_degree):
        alive = variables["alive"]
        keys = list(params)
        p = {k: params[k].detach().requires_grad_(True) for k in keys}
        probe = torch.zeros((alive.shape[0], 2), dtype=torch.float32,
                            device=alive.device, requires_grad=True)
        sh = torch.cat([p["features_dc"], p["features_rest"]], dim=1)
        # coefficient k belongs to degree floor(sqrt(k))
        k_idx = torch.arange(sh.shape[1], device=sh.device,
                             dtype=torch.float32)
        live = torch.floor(torch.sqrt(k_idx)) <= float(active_sh_degree)
        sh = sh * live.to(torch.float32)[None, :, None]
        opacity = torch.sigmoid(p["logit_opacities"][:, 0])
        cam = batch["camera"]
        out = render(cam, p["means3D"], torch.zeros_like(p["means3D"]),
                     torch.where(alive, opacity, torch.zeros_like(opacity)),
                     torch.exp(p["log_scales"]),
                     quat.normalize(p["unnorm_rotations"]),
                     sh=sh, sh_degree=sh_degree,
                     extra_channels=p.get("semantic_feature"),
                     mean2d_probe_ndc=probe, config=rcfg, device=cam.device)
        im = torch.clamp(out.rgb, 0.0, 1.0)
        l1 = L.l1_loss_v1(im, batch["im"])
        ssim = calc_ssim(im, batch["im"])
        total = (1 - lambda_dssim) * l1 + lambda_dssim * (1 - ssim)
        aux = {"l1": l1, "ssim": ssim, "radii": out.radii}
        if out.extra is not None and "gt_feature" in batch:
            fmap = out.extra
            if use_decoder:
                fmap = decoder(fmap)
            gt = batch["gt_feature"]
            fmap = resize_feature_map(fmap, gt.shape[:2])
            floss = L.l1_loss_v1(fmap, gt)
            total = total + feature_weight * floss
            aux["feature_l1"] = floss
        dec = dict(decoder.named_parameters()) if use_decoder else {}
        dkeys = list(dec)
        grads = torch.autograd.grad(
            total, [p[k] for k in keys] + [dec[k] for k in dkeys] + [probe],
            allow_unused=True)

        def zero_if_none(g, like):
            return torch.zeros_like(like) if g is None else g

        gp = {k: zero_if_none(g, p[k]) for k, g in zip(keys, grads)}
        gdec = ({k: zero_if_none(g, dec[k])
                 for k, g in zip(dkeys, grads[len(keys):-1])}
                if use_decoder else None)
        gprobe = zero_if_none(grads[-1], probe)
        aux = {k: v.detach() for k, v in aux.items()}
        return total.detach(), aux, gp, gdec, gprobe

    return step_fn


def training(frames: List[Dict], model: GaussianModel,
             iterations: int = 7000,
             rcfg: Optional[RasterConfig] = None,
             gt_feature_dim: Optional[int] = None,
             lambda_dssim: float = 0.2,
             feature_weight: float = 1.0,
             densify_from: int = 500, densify_until: int = 5000,
             densify_every: int = 100, opacity_reset_every: int = 3000,
             sh_increase_every: int = 1000,
             checkpoint_iterations: Optional[List[int]] = None,
             checkpoint_cb: Optional[Callable] = None,
             gui=None, seed: int = 0,
             report_cb: Optional[Callable] = None):
    """The feature-field training loop.

    frames: {camera, im (H, W, 3), gt_feature (h, w, F)?} datapoints on the
    model's device; model: a GaussianModel after create_from_pcd and
    training_setup. gt_feature_dim: when set and not model.semantic_dim,
    train the decoder from the rendered features up to this width, its
    initial weights He-normal from a generator seeded with `seed`. gui: an
    optional `viz.network_gui.NetworkGUI`, polled once per iteration.
    report_cb(it, scalars, loss) every 100 iterations;
    checkpoint_cb(it, model.capture(), decoder weights) at
    `checkpoint_iterations`.

    Returns (model, decoder); decoder is None when it is not used.
    """
    rcfg = rcfg or RasterConfig()
    rng = np.random.RandomState(seed)
    use_decoder = bool(gt_feature_dim and model.semantic_dim
                       and gt_feature_dim != model.semantic_dim)
    decoder = None
    if use_decoder:
        gen = torch.Generator(device=model.device).manual_seed(seed)
        decoder = init_feature_decoder(gen, model.semantic_dim,
                                       gt_feature_dim, device=model.device)
    dec_opt = optim.init(dict(decoder.named_parameters())) if decoder \
        else None
    step_fn = make_feature_train_step(
        rcfg, lambda_dssim, feature_weight,
        sh_degree=model.max_sh_degree, use_decoder=use_decoder)

    todo: List[int] = []
    for it in range(1, iterations + 1):
        if it % sh_increase_every == 0:
            model.oneupSHdegree()
        if not todo:
            todo = list(rng.permutation(len(frames)))
        batch = frames[todo.pop()]
        loss, aux, gp, gdec, gprobe = step_fn(
            model.params, model.variables, decoder, batch,
            model.active_sh_degree)
        model.add_densification_stats(gprobe, aux["radii"])
        model.step(gp)
        if use_decoder:
            with torch.no_grad():
                cur = {k: v.detach() for k, v in decoder.named_parameters()}
                lr = torch.tensor(DECODER_LR, dtype=torch.float32,
                                  device=model.device)
                new, dec_opt = optim.step(cur, gdec, dec_opt,
                                          {k: lr for k in cur})
                for k, p in decoder.named_parameters():
                    p.copy_(new[k])

        if densify_from <= it <= densify_until and it % densify_every == 0:
            model.densify_and_prune(it)
        if it % opacity_reset_every == 0 and it <= densify_until:
            model.reset_opacity()
        if checkpoint_iterations and it in checkpoint_iterations \
                and checkpoint_cb:
            checkpoint_cb(it, model.capture(),
                          decoder.to_numpy() if decoder else None)
        if report_cb and it % 100 == 0:
            report_cb(it, {k: float(v) for k, v in aux.items()
                           if v.dim() == 0}, float(loss))
        if gui is not None:
            _serve_gui(gui, model, rcfg, training_paused=False)
    return model, decoder


def _serve_gui(gui, model: GaussianModel, rcfg: RasterConfig,
               training_paused: bool):
    """One non-blocking network-GUI poll: a connected viewer's request is
    rendered from the model as it stands."""
    from dynamic3dgaussians_tpu_torch.utils.image_utils import \
        render_net_image

    def render_fn(cam, render_mode, scaling_modifier):
        with torch.no_grad():
            out = render(cam, **model.render_args(), config=rcfg,
                         scale_modifier=scaling_modifier, device=cam.device)
        return render_net_image(out, render_mode).cpu().numpy()

    gui.poll(render_fn,
             metrics_fn=lambda: {"num_points": model.num_points})
