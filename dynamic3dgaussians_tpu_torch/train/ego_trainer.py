"""Ego + static dual-dataset trainer.

Port of `dynamic3dgaussians_tpu/train/ego_trainer.py`:

  * per step, ONE frame of the ego camera stream drives the primary image
    loss, masked by its validity mask; with `rot90_ego` the rendered image
    is turned by -90 degrees before it is masked against the (already
    turned) ground truth
  * EVERY static frame is rendered each step for the held-out loss: the
    mean masked image loss and the mean L1 depth loss over the static
    frames, the depth at weight `stat_depth_weight`
  * the per-camera colour correction exp(cam_m) * im + cam_c on both
  * t > 0 adds the physics losses through the canonical trainer's
    machinery (`train/trainer.py`)

The step's metrics are the reference's: the loss and each term. (The
reference also computes the ego render's PSNR, 0 on the rotated path, and
drops it; the port does not compute it.)

All renders share one mean2d probe, so its gradient (the densification
statistic) sums over the ego and every static render, while the screen
radii come from the ego render alone, as in the reference. The reference
vmaps the static renders inside one jitted step; here they run in a loop,
one render (one K1 and one K2 launch on the card) per frame, and the means
are taken over the same frames.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.models import gaussians as G
from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig, render
from dynamic3dgaussians_tpu_torch.train import densify as densify_mod
from dynamic3dgaussians_tpu_torch.train import losses as L
from dynamic3dgaussians_tpu_torch.train import optim
from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
from dynamic3dgaussians_tpu_torch.train.trainer import (
    densify_with_growth, initialize_per_timestep,
    initialize_post_first_timestep, params_to_cpu, raster_config)


def _render_rgb_depth(params, probe, cam, variables, rcfg):
    act = G.activated(params, variables["alive"])
    return render(cam, act["means3d"], act["colors"], act["opacity"],
                  act["scales"], act["rotations"],
                  extra_channels=params["seg_colors"],
                  mean2d_probe_ndc=probe, config=rcfg, device=cam.device)


def _masked_frame_loss(out, params, batch, *, rot90: bool):
    """Masked image loss of one frame. batch: {im, cam_id, mask (H, W) in
    {0, 1}}; `rot90` turns the colour-corrected render by -90 degrees
    (torch.rot90(k=-1) on the spatial axes) before masking."""
    cam_id = int(batch["cam_id"])
    im = L.apply_cam_correction(out.rgb, params["cam_m"][cam_id],
                                params["cam_c"][cam_id])
    if rot90:
        im = torch.rot90(im, k=-1, dims=(0, 1))
    return L.masked_image_loss(im, batch["im"], batch["mask"])


def make_ego_step(cfg: TrainConfig, rcfg: RasterConfig, *,
                  rot90_ego: bool, stat_depth_weight: float = 0.01):
    """step(params, opt_state, variables, ego_batch, stat_frames, lrs,
    is_initial) -> (params, opt_state, variables, metrics); stat_frames is
    the list from `_stack_stat`, or None for no static rig."""

    def loss_fn(params, probe, ego_batch, stat_frames, variables,
                is_initial):
        losses = {}
        out = _render_rgb_depth(params, probe, ego_batch["camera"],
                                variables, rcfg)
        losses["im"] = _masked_frame_loss(out, params, ego_batch,
                                          rot90=rot90_ego)
        if stat_frames is not None:
            img_ls, d_ls = [], []
            for b in stat_frames:
                o = _render_rgb_depth(params, probe, b["camera"], variables,
                                      rcfg)
                img_ls.append(_masked_frame_loss(o, params, b, rot90=False))
                d_ls.append(L.depth_l1_loss(o.depth, b["gt_depth"],
                                            alpha=o.alpha, mask=b["mask"]))
            losses["stat_im"] = torch.mean(torch.stack(img_ls))
            losses["depth"] = torch.mean(torch.stack(d_ls))
        if not is_initial:
            act = G.activated(params, variables["alive"])
            is_fg = params["seg_colors"][:, 0] > 0.5
            losses.update(L.physics_losses(
                act["means3d"], act["rotations"], params["rgb_colors"],
                variables, is_fg, variables["alive"]))
        # stat_im takes the im weight unless set; the depth weight is
        # explicit
        w = dict(cfg.loss_weights)
        w.setdefault("stat_im", w.get("im", 1.0))
        w["depth"] = stat_depth_weight
        total = sum(float(w.get(k, 0.0)) * v for k, v in losses.items())
        return total, {"losses": losses, "radii": out.radii}

    def step(params, opt_state, variables, ego_batch, stat_frames, lrs,
             is_initial: bool):
        keys = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        alive = variables["alive"]
        probe = torch.zeros((alive.shape[0], 2), dtype=torch.float32,
                            device=alive.device, requires_grad=True)
        loss, aux = loss_fn(leaves, probe, ego_batch, stat_frames, variables,
                            is_initial)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys] + [probe],
                                    allow_unused=True)
        with torch.no_grad():
            gp = {}
            for k, g in zip(keys, grads[:-1]):
                g = torch.zeros_like(params[k]) if g is None else g
                if k not in G.CAMERA_KEYS:
                    m = alive.reshape((-1,) + (1,) * (g.dim() - 1))
                    g = torch.where(m, g, torch.zeros_like(g))
                gp[k] = g
            gprobe = grads[-1] if grads[-1] is not None else \
                torch.zeros_like(probe)
            new_params, new_opt = optim.step(
                {k: params[k].detach() for k in keys}, gp, opt_state, lrs)
            new_vars = densify_mod.accumulate_stats(variables, gprobe,
                                                    aux["radii"])
            metrics = {"loss": loss.detach(),
                       **{f"loss_{k}": v.detach()
                          for k, v in aux["losses"].items()}}
        return new_params, new_opt, new_vars, metrics

    return step


def _stack_stat(stat_frames: List[Dict]) -> Optional[List[Dict]]:
    """The static frames with their defaults filled in (mask all ones,
    gt_depth all zeros: no depth term), or None for an empty rig. The
    frames must share H and W, as the reference's stacking requires."""
    if not stat_frames:
        return None
    filled = []
    for f in stat_frames:
        f = dict(f)
        h, w = f["im"].shape[:2]
        dev = f["im"].device
        f.setdefault("mask", torch.ones((h, w), dtype=torch.float32,
                                        device=dev))
        f.setdefault("gt_depth", torch.zeros((h, w), dtype=torch.float32,
                                             device=dev))
        filled.append(f)
    shapes = {tuple(f["im"].shape) for f in filled}
    if len(shapes) != 1:
        raise ValueError(f"static frames of different shapes: {shapes}")
    return filled


def train_ego(ego_dataset, stat_dataset, cfg: TrainConfig,
              pt_cld: np.ndarray, w2c_stack: np.ndarray, *,
              rot90_ego: bool = False, stat_depth_weight: float = 0.01,
              callbacks: Optional[Dict] = None, device: DeviceLike = None):
    """Dual-dataset dynamic optimisation over every timestep.

    ego_dataset[t] (or a callable t -> list): ego frames {camera, im,
    cam_id, mask?}; stat_dataset[t]: static frames {camera, im, cam_id,
    mask?, gt_depth?}, ALL rendered every step (an empty list: no static
    path). rot90_ego: turn the rendered ego image by -90 degrees (the GT
    ego frames come turned). Callbacks: on_step(t, i, metrics) every
    `cfg.report_every` steps, on_densify(t, i, stats). Runs on `device`
    (default `cuda`), where the frames must be.

    Returns (output_params, params, variables).
    """
    dev = resolve_device(device)
    callbacks = callbacks or {}
    rng = np.random.RandomState(cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    params, variables = G.init_params(
        pt_cld, w2c_stack,
        capacity=cfg.capacity or G.round_capacity(pt_cld.shape[0] * 4),
        semantic_dim=cfg.semantic_dim, seed=cfg.seed, generator=gen,
        device=dev)
    opt_state = optim.init(params)
    rcfg = raster_config(cfg)
    step = make_ego_step(cfg, rcfg, rot90_ego=rot90_ego,
                         stat_depth_weight=stat_depth_weight)

    get_ego = ego_dataset if callable(ego_dataset) \
        else ego_dataset.__getitem__
    get_stat = stat_dataset if callable(stat_dataset) \
        else stat_dataset.__getitem__

    def lr_tree(frozen: bool):
        lrs = {}
        for k in params:
            base = cfg.lrs.get(k, 0.0)
            if k == "means3D":
                base = base * float(variables["scene_radius"])
            if frozen and k in cfg.freeze_after_t0:
                base = 0.0
            lrs[k] = torch.tensor(base, dtype=torch.float32, device=dev)
        return lrs

    output_params = []
    for t in range(cfg.num_timesteps):
        is_initial = t == 0
        ego_t = get_ego(t)
        stat_t = _stack_stat(get_stat(t))
        if not is_initial:
            params, variables, opt_state = initialize_per_timestep(
                params, variables, opt_state)
        num_iters = (cfg.iters_first_timestep if is_initial
                     else cfg.iters_per_timestep)
        lrs = lr_tree(frozen=not is_initial)
        todo: List[int] = []
        for i in range(num_iters):
            if not todo:
                todo = list(rng.permutation(len(ego_t)))
            ego_batch = ego_t[todo.pop()]
            if "mask" not in ego_batch:
                ego_batch = dict(ego_batch)
                h, w = ego_batch["im"].shape[:2]
                ego_batch["mask"] = torch.ones((h, w), dtype=torch.float32,
                                               device=dev)
            params, opt_state, variables, metrics = step(
                params, opt_state, variables, ego_batch, stat_t, lrs,
                is_initial)
            if is_initial and cfg.densify_start <= i <= cfg.densify_end \
                    and i % cfg.densify_every == 0:
                params, variables, opt_state, dstats = densify_with_growth(
                    params, variables, opt_state, i, cfg, gen)
                if "on_densify" in callbacks:
                    callbacks["on_densify"](t, i, dstats)
            if "on_step" in callbacks and i % cfg.report_every == 0:
                callbacks["on_step"](t, i, metrics)
        if is_initial:
            params, variables, opt_state, _ = G.compact_with_optimizer(
                params, variables, opt_state)
            params, variables, opt_state = initialize_post_first_timestep(
                params, variables, cfg, opt_state)
        output_params.append(params_to_cpu(params, variables, is_initial))
    return output_params, params, variables
