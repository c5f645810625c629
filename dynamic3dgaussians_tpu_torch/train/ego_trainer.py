"""Ego + static dual-dataset trainer.

Port of `dynamic3dgaussians_tpu/train/ego_trainer.py`:

  * per step, ONE frame of the ego camera stream drives the primary image
    loss, masked by its validity mask; with `rot90_ego` the rendered image
    is turned by -90 degrees before it is masked against the (already
    turned) ground truth (here the ground truth is turned back instead:
    the same loss)
  * EVERY static frame is rendered each step for the held-out loss: the
    mean masked image loss and the mean L1 depth loss over the static
    frames, the depth at weight `stat_depth_weight`
  * the per-camera colour correction exp(cam_m) * im + cam_c on both
  * t > 0 adds the physics losses through the canonical trainer's
    machinery (`train/trainer.py`)

The step's loss metrics are the reference's: the loss and each term,
which `train_ego` reports. (The reference also computes the ego render's
PSNR, 0 on the rotated path, and drops it; the port does not compute it.)
Beside them the step counts its renders' drops, as the Panoptic step does.

All renders share one mean2d probe, so its gradient (the densification
statistic) sums over the ego and every static render, while the screen
radii come from the ego render alone, as in the reference. The reference
vmaps the static renders inside one jitted step; here the ego view and
the static views (where they share the ego's image size) are projected at
once (`rasterize.render_views`) and then emitted, sorted and composited
one by one (one K1 and one K2 launch on the card a view), and their image
losses are taken at once, the ego's against its ground truth turned back
(`_unturned`). The table is activated once a step, for every render and
the physics losses.

The step has `make_train_step`'s signature, so that `make_train_scan` runs
it in windows (on the card a CUDA graph of the step, `step_graph.py`):
`train_ego` with `steps_per_call` W > 1 runs the steps between its host
actions (densify at t = 0, report steps, a timestep's last step) as
windows of W, the ego frames stacked on the device and gathered by index.
The static rig is no batch: it lives in device buffers (`StaticRig`)
that the step reads whole, and that `train_ego` loads in place at each
timestep, so a new timestep's frames need no capture. With
`steps_per_call` 1 every step runs eagerly, as before.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.models import gaussians as G
from dynamic3dgaussians_tpu_torch.ops.camera import Camera, stack_views
from dynamic3dgaussians_tpu_torch.ops.rasterize import (RasterConfig,
                                                      render_views)
from dynamic3dgaussians_tpu_torch.ops.ssim import calc_ssim
from dynamic3dgaussians_tpu_torch.train import densify as densify_mod
from dynamic3dgaussians_tpu_torch.train import losses as L
from dynamic3dgaussians_tpu_torch.train import optim
from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
from dynamic3dgaussians_tpu_torch.train.trainer import (
    densify_with_growth, initialize_per_timestep,
    initialize_post_first_timestep, make_train_scan, mask_dead_rows,
    next_host_action, params_to_cpu, raster_config, stack_timestep_data)
from dynamic3dgaussians_tpu_torch.utils import logging as LG

CAMERA_STATIC = ("height", "width", "near", "far")
DROPS = ("n_dropped", "n_dropped_rect")    # in the step's metrics, not reported


def _unturned(x: torch.Tensor, rot90: bool) -> torch.Tensor:
    """An ego ground truth (turned by -90 degrees with `rot90`) in the
    render's orientation: turned back by +90 degrees. The masked image
    loss of the turned render against the turned ground truth is that of
    the render against this, the same pixel pairs under SSIM's symmetric
    window, so the ego view's loss is taken with the static views'."""
    return torch.rot90(x, k=1, dims=(0, 1)) if rot90 else x


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


def _same_size(a: Camera, b: Camera) -> bool:
    return all(getattr(a, k) == getattr(b, k) for k in CAMERA_STATIC)


def _joins(cam: Camera, rig: Optional["StaticRig"]) -> bool:
    """Whether the ego view is rendered and its loss taken with the static
    views: a rig whose views share the ego camera's image size."""
    return rig is not None and _same_size(cam, rig.cams[0])


class StaticRig:
    """The static frames of a timestep in device buffers that the ego step
    reads whole, the B views batched: `cams` their cameras, `im` (H, W, 3B)
    their frames side by side on the channel axis, `mask_rgb` (H, W, 3B)
    their masks (all ones unless given) over each view's channels and
    `mask` (B, H, W) the same once a view, `gt_depth` (B, H, W) (zeros
    unless given: no depth term) and `cam_id` (B,) int64. A CUDA graph
    captured on the rig reads these buffers, so `load` copies a new
    timestep's frames in place and the graph stays valid; `fits` tells
    whether frames have the rig's views, cameras and image sizes."""

    def __init__(self, stat_frames: List[Dict]):
        self.__dict__.update(self._batched(stat_frames))

    @staticmethod
    def _batched(stat_frames: List[Dict]) -> Dict:
        filled = _stack_stat(stat_frames)
        cams = [dataclasses.replace(f["camera"], **{
            k.name: getattr(f["camera"], k.name).clone()
            for k in dataclasses.fields(Camera)
            if k.name not in CAMERA_STATIC}) for f in filled]
        if not all(_same_size(c, cams[0]) for c in cams):
            raise ValueError("the static views differ in " + ", ".join(
                CAMERA_STATIC))
        dev = cams[0].device
        mask = torch.stack([f["mask"].to(torch.float32)
                            for f in filled]).to(dev)
        return dict(
            cams=cams,
            im=torch.cat([f["im"] for f in filled], dim=-1).to(dev),
            mask=mask,
            mask_rgb=mask.permute(1, 2, 0).repeat_interleave(
                3, dim=-1).contiguous(),
            gt_depth=torch.stack([f["gt_depth"] for f in filled]).to(dev),
            cam_id=torch.as_tensor([int(f["cam_id"]) for f in filled],
                                   dtype=torch.int64, device=dev))

    @staticmethod
    def _buffers(rig: Dict) -> List[torch.Tensor]:
        return ([getattr(c, f.name) for c in rig["cams"]
                 for f in dataclasses.fields(Camera)
                 if f.name not in CAMERA_STATIC]
                + [rig[k] for k in ("im", "mask", "mask_rgb", "gt_depth",
                                    "cam_id")])

    def _matches(self, new: Dict) -> bool:
        return (len(new["cams"]) == len(self.cams)
                and _same_size(new["cams"][0], self.cams[0])
                and all(a.shape == b.shape for a, b in
                        zip(self._buffers(new), self._buffers(vars(self)))))

    def fits(self, stat_frames: List[Dict]) -> bool:
        try:
            return bool(stat_frames) and self._matches(
                self._batched(stat_frames))
        except ValueError:
            return False

    def load(self, stat_frames: List[Dict]) -> None:
        """Copy a timestep's frames into the buffers, in place."""
        new = self._batched(stat_frames)
        if not self._matches(new):
            raise ValueError("the static frames do not fit the rig")
        with torch.no_grad():
            for dst, src in zip(self._buffers(vars(self)),
                                self._buffers(new)):
                dst.copy_(src)


def _image_terms(outs, params, cam_id: torch.Tensor, gt: torch.Tensor,
                 mask_rgb: torch.Tensor) -> torch.Tensor:
    """(V,) each view's masked image loss (`losses.masked_image_loss`) of
    V views of one size, taken at once: the colour-corrected renders side
    by side on the channel axis against `gt` (H, W, 3V), masked by
    `mask_rgb` (H, W, 3V), the L1 and SSIM means per channel (SSIM blurs
    each channel alone) and then per view; cam_id (V,) int64."""
    im = L.apply_cam_correction(
        torch.cat([o.rgb for o in outs], dim=-1),
        params["cam_m"].index_select(0, cam_id).reshape(-1),
        params["cam_c"].index_select(0, cam_id).reshape(-1))
    comp = im * mask_rgb + gt * (1.0 - mask_rgb)
    l1 = torch.mean(L._abs(comp - gt), dim=(0, 1))
    ssim = calc_ssim(comp, gt, size_average=False)
    per_view = 0.8 * l1 + 0.2 * (1.0 - ssim)
    return per_view.reshape(len(outs), -1).mean(dim=-1)


def _depth_terms(outs, rig: StaticRig) -> torch.Tensor:
    """(B,) each static view's L1 of depth over alpha against its ground
    truth (`losses.depth_l1_loss`), over its own valid pixels."""
    depth = torch.stack([o.depth for o in outs])
    alpha = torch.stack([o.alpha for o in outs])
    d = depth / torch.clamp(alpha, min=1e-6)
    valid = (rig.gt_depth > 1e-6) & (rig.mask > 0.5)
    err = torch.where(valid, L._abs(d - rig.gt_depth), torch.zeros_like(d))
    return (torch.sum(err, dim=(1, 2))
            / torch.clamp(torch.sum(valid.to(d.dtype), dim=(1, 2)),
                          min=1.0))


def make_ego_step(cfg: TrainConfig, rcfg: RasterConfig, *,
                  rot90_ego: bool, stat_depth_weight: float = 0.01,
                  rig: Optional[StaticRig] = None):
    """The ego step, with `make_train_step`'s signature:
    step(params, opt_state, variables, batch, lrs, is_initial,
    pair_cap=None, pair_stats=False) -> (params, opt_state, variables,
    metrics). `batch` is one ego frame {camera, im, cam_id, mask}; `rig`
    the static rig (None: no static path), read whole at every step.

    The forward runs in phase order: the table activated once, the
    renders (`render_views`: one projection of the ego view and the
    static views of its size, then each view's emission, sort and
    composite, the ego's first); the views' image losses, taken at once
    (`_image_terms`), and the static depth terms (`_depth_terms`); the
    physics losses at t > 0. A pair_cap renders all of them with record
    tables of that one capacity (no host read, for a captured step); with
    it or pair_stats the metrics also hold the largest live-pair count over
    the renders and the summed overflow past it (`n_live_pairs`,
    `n_pair_overflow`). The metrics hold the renders' summed drops
    (`n_dropped`, `n_dropped_rect`), as `make_train_step`'s do.

    With tracing on (`utils/logging.py::set_tracing`) the step marks the
    seven phases of `LG.PHASES` once each, and two view marks inside
    them: `static_rig` where the first static view's own render (its
    emission, sort and composite) begins, and `ego` where the backward
    reaches the ego render's outputs. Autograd runs nodes in reverse order
    of creation, so in render_bwd the static views' own backward comes
    first, and the shared projection's last.
    """
    weights = dict(cfg.loss_weights)
    # stat_im takes the im weight unless set; the depth weight is explicit
    weights.setdefault("stat_im", weights.get("im", 1.0))
    weights["depth"] = stat_depth_weight
    method = cfg.raster.render_method()

    def loss_fn(params, probe, batch, variables, is_initial, pair_cap,
                pair_stats, phases):
        alive = variables["alive"]
        phases.enter("render")
        act = G.activated(params, alive)
        inputs = (act["means3d"], act["colors"], act["opacity"],
                  act["scales"], act["rotations"])
        kw = dict(extra_channels=params["seg_colors"],
                  mean2d_probe_ndc=probe, config=rcfg, method=method,
                  pair_cap=pair_cap, pair_stats=pair_stats)
        cam = batch["camera"]
        joint = _joins(cam, rig)

        def before_view(b):
            if b == 1:
                phases.view("static_rig")
        outs = render_views(stack_views([cam] + (rig.cams if joint else [])),
                            *inputs, before_view=before_view if joint
                            else None, **kw)
        if rig is not None and not joint:
            phases.view("static_rig")
            outs += render_views(stack_views(rig.cams), *inputs, **kw)

        phases.enter("image_loss")
        ego_id = torch.as_tensor(batch["cam_id"], dtype=torch.int64,
                                 device=params["cam_m"].device).reshape(1)
        ego_gt = _unturned(batch["im"], rot90_ego)
        ego_mask = _unturned(batch["mask"], rot90_ego)[..., None].expand(
            *ego_gt.shape)
        if joint:
            terms = _image_terms(
                outs, params, torch.cat([ego_id, rig.cam_id]),
                torch.cat([ego_gt, rig.im], dim=-1),
                torch.cat([ego_mask, rig.mask_rgb], dim=-1))
        else:
            terms = _image_terms(outs[:1], params, ego_id, ego_gt, ego_mask)
            if rig is not None:
                terms = torch.cat([terms, _image_terms(
                    outs[1:], params, rig.cam_id, rig.im, rig.mask_rgb)])
        losses = {"im": terms[0]}
        if rig is not None:
            losses["stat_im"] = torch.mean(terms[1:])
            losses["depth"] = torch.mean(_depth_terms(outs[1:], rig))
        frame_losses = list(losses.values())

        phases.enter("physics")
        if not is_initial:
            is_fg = params["seg_colors"][:, 0] > 0.5
            losses.update(L.physics_losses(
                act["means3d"], act["rotations"], params["rgb_colors"],
                variables, is_fg, alive))
        total = sum(float(weights.get(k, 0.0)) * v
                    for k, v in losses.items())

        def outputs(o):
            return (o.rgb, o.extra, o.depth, o.alpha)

        phases.enter_on(frame_losses, "image_loss_bwd")
        phases.enter_on([t for o in outs for t in outputs(o)], "render_bwd")
        if rig is not None:
            phases.view_on(outputs(outs[0]), "ego")
        aux = {"losses": losses, "radii": outs[0].radii,
               "n_dropped": sum(o.n_dropped_capacity + o.n_dropped_rect
                                + o.n_dropped_tile_overflow for o in outs),
               "n_dropped_rect": sum(o.n_dropped_rect for o in outs)}
        if outs[0].n_live_pairs is not None:
            aux["n_live_pairs"] = torch.stack(
                [o.n_live_pairs for o in outs]).amax()
            aux["n_pair_overflow"] = torch.stack(
                [o.n_pair_overflow for o in outs]).sum()
        return total, aux

    def step(params, opt_state, variables, batch, lrs, is_initial,
             pair_cap=None, pair_stats=False):
        alive = variables["alive"]
        phases = LG.phases(alive.device)
        keys = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        probe = torch.zeros((alive.shape[0], 2), dtype=torch.float32,
                            device=alive.device, requires_grad=True)
        loss, aux = loss_fn(leaves, probe, batch, variables, is_initial,
                            pair_cap, pair_stats, phases)
        phases.enter("physics_bwd")
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys] + [probe],
                                    allow_unused=True)
        phases.enter("update")
        with torch.no_grad():
            gp = mask_dead_rows(
                {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(keys, grads[:-1])}, alive)
            gprobe = grads[-1] if grads[-1] is not None else \
                torch.zeros_like(probe)
            new_params, new_opt = optim.step(
                {k: params[k].detach() for k in keys}, gp, opt_state, lrs)
            new_vars = densify_mod.accumulate_stats(variables, gprobe,
                                                    aux["radii"])
            metrics = {"loss": loss.detach(),
                       "n_dropped": aux["n_dropped"],
                       "n_dropped_rect": aux["n_dropped_rect"],
                       **{f"loss_{k}": v.detach()
                          for k, v in aux["losses"].items()}}
            if "n_live_pairs" in aux:
                metrics["n_live_pairs"] = aux["n_live_pairs"]
                metrics["n_pair_overflow"] = aux["n_pair_overflow"]
        phases.close()
        return new_params, new_opt, new_vars, metrics

    return step


def _with_mask(frame: Dict, device) -> Dict:
    """An ego frame with its mask (all ones unless given)."""
    if "mask" in frame:
        return frame
    h, w = frame["im"].shape[:2]
    return dict(frame, mask=torch.ones((h, w), dtype=torch.float32,
                                       device=device))


def train_ego(ego_dataset, stat_dataset, cfg: TrainConfig,
              pt_cld: np.ndarray, w2c_stack: np.ndarray, *,
              rot90_ego: bool = False, stat_depth_weight: float = 0.01,
              callbacks: Optional[Dict] = None, device: DeviceLike = None,
              graph_factory=None):
    """Dual-dataset dynamic optimisation over every timestep.

    ego_dataset[t] (or a callable t -> list): ego frames {camera, im,
    cam_id, mask?}; stat_dataset[t]: static frames {camera, im, cam_id,
    mask?, gt_depth?}, ALL rendered every step (an empty list: no static
    path). rot90_ego: turn the rendered ego image by -90 degrees (the GT
    ego frames come turned). Callbacks: on_step(t, i, metrics) every
    `cfg.report_every` steps (the loss and its terms, as the reference
    reports them), on_densify(t, i, stats). Runs on `device`
    (default `cuda`), where the frames must be. With `cfg.steps_per_call`
    W > 1 the steps between host actions run as windows of W
    (`make_train_scan`; `graph_factory`, for tests, stands in for the CUDA
    graph); the camera stream and the result are those of W = 1.

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
    scan_w = max(1, int(cfg.steps_per_call))
    rig, step, scan = None, None, None

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
        ego_t = [_with_mask(b, dev) for b in get_ego(t)]
        stat_t = get_stat(t)
        if rig is not None and rig.fits(stat_t):
            rig.load(stat_t)          # in place: a captured step stays valid
        elif step is None or rig is not None or stat_t:
            rig = StaticRig(stat_t) if stat_t else None
            step = make_ego_step(cfg, rcfg, rot90_ego=rot90_ego,
                                 stat_depth_weight=stat_depth_weight, rig=rig)
            if scan_w > 1:
                scan = make_train_scan(
                    cfg, rcfg, step, graph_factory=graph_factory,
                    window=None if scan is None else scan.window)
        if not is_initial:
            params, variables, opt_state = initialize_per_timestep(
                params, variables, opt_state)
        num_iters = (cfg.iters_first_timestep if is_initial
                     else cfg.iters_per_timestep)
        lrs = lr_tree(frozen=not is_initial)
        todo: List[int] = []
        use_scan = scan_w > 1 and len(ego_t) > 0
        if use_scan:
            ego_stack = stack_timestep_data(ego_t)

        def pick():
            nonlocal todo
            if not todo:
                todo = list(rng.permutation(len(ego_t)))
            return int(todo.pop())

        i = 0
        while i < num_iters:
            if use_scan and next_host_action(
                    i, num_iters, cfg, initial=is_initial,
                    opacity_reset=False) - i + 1 >= scan_w:
                sel = torch.as_tensor([pick() for _ in range(scan_w)],
                                      dtype=torch.int64, device=dev)
                params, opt_state, variables, metrics = scan(
                    params, opt_state, variables, ego_stack, sel, lrs,
                    is_initial)
                i += scan_w - 1             # the last step that ran
            else:
                params, opt_state, variables, metrics = step(
                    params, opt_state, variables, ego_t[pick()], lrs,
                    is_initial)
            if is_initial and cfg.densify_start <= i <= cfg.densify_end \
                    and i % cfg.densify_every == 0:
                params, variables, opt_state, dstats = densify_with_growth(
                    params, variables, opt_state, i, cfg, gen)
                if "on_densify" in callbacks:
                    callbacks["on_densify"](t, i, dstats)
            if "on_step" in callbacks and i % cfg.report_every == 0:
                callbacks["on_step"](t, i, {k: v for k, v in metrics.items()
                                            if k not in DROPS})
            i += 1
        if is_initial:
            params, variables, opt_state, _ = G.compact_with_optimizer(
                params, variables, opt_state)
            params, variables, opt_state = initialize_post_first_timestep(
                params, variables, cfg, opt_state)
        output_params.append(params_to_cpu(params, variables, is_initial))
    return output_params, params, variables
