"""Motion-basis training: one canonical gaussian set over the whole sequence.

Port of `dynamic3dgaussians_tpu/train/motion_trainer.py`. Instead of
re-optimizing positions per timestep, the canonical gaussians are posed at
frame t by blended SE(3) basis transforms (`models/motion_bases.py`), and
{canonical parameters, bases, coefficients} are optimized jointly from one
randomly drawn (frame, camera) pair per step. Foreground gaussians
(`label` > 0.5) move; the background stays canonical.

Each step renders once (one K1 and one K2 launch on the card) through the
render method of `cfg.raster` ("auto": the kernels on the card, their plain
versions on the CPU; the reference always renders with "auto"). The frame
and camera picks use `np.random.RandomState(cfg.seed)` as the reference
does, so they replay bitwise; the inits' draws come from a generator
seeded with `cfg.seed`, or are passed in (`bases_noise=`, `kmeans_idx=`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.models import gaussians as G
from dynamic3dgaussians_tpu_torch.models import motion_bases as MB
from dynamic3dgaussians_tpu_torch.ops import quat
from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig, render
from dynamic3dgaussians_tpu_torch.train import losses as L
from dynamic3dgaussians_tpu_torch.train import optim
from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
from dynamic3dgaussians_tpu_torch.train.trainer import raster_config

MOTION_LRS = {"rots": 1.6e-4, "transls": 1.6e-4, "coefs": 1e-2}
# rows of the nearest-canonical-track map per chunk: (rows, tracks, 3)
# float32 differences at a time instead of the whole (N, M, 3) grid
NEAREST_CHUNK = 4096


def posed_gaussians(params: Dict, t) -> Dict:
    """Canonical gaussians posed at frame t (an int) by the motion bases:
    {"means3D", "rotations" (unit wxyz)}. Foreground rows (label > 0.5)
    move; background rows keep their canonical values bitwise."""
    dev = params["means3D"].device
    ts = torch.as_tensor(t, device=dev).reshape(-1).long()
    tf = MB.compute_transforms(
        {"rots": params["motion_rots"], "transls": params["motion_transls"]},
        ts, params["motion_coefs"])[:, 0]                    # (G, 3, 4)
    moved = MB.apply_transforms(tf[:, None], params["means3D"])[:, 0]
    q_delta = quat.rotmat_to_quat(tf[..., :3])
    rot = quat.normalize(params["unnorm_rotations"])
    moved_rot = quat.quat_mult(q_delta, rot)
    is_fg = (params["label"] > 0.5)[:, None]
    return {"means3D": torch.where(is_fg, moved, params["means3D"]),
            "rotations": torch.where(is_fg, moved_rot, rot)}


def motion_loss(params: Dict, batch: Dict, variables: Dict, t, *,
                cfg: TrainConfig, rcfg: RasterConfig):
    """(loss, psnr) of the gaussians posed at frame t seen by one camera
    datapoint {camera, im, seg, optional gt_depth}: the image and seg
    losses (and the depth Pearson loss with gt_depth), weighted by
    `cfg.loss_weights` (1 where a term has no weight). One render."""
    posed = posed_gaussians(params, t)
    opacity = torch.sigmoid(params["logit_opacities"][:, 0])
    opacity = torch.where(variables["alive"], opacity,
                          torch.zeros_like(opacity))
    cam = batch["camera"]
    out = render(cam, posed["means3D"], params["rgb_colors"], opacity,
                 torch.exp(params["log_scales"]), posed["rotations"],
                 extra_channels=params["seg_colors"], config=rcfg,
                 method=cfg.raster.render_method(), device=cam.device)
    losses = {"im": L.image_loss(out.rgb, batch["im"]),
              "seg": L.image_loss(out.extra, batch["seg"])}
    if "gt_depth" in batch:
        losses["depth"] = L.depth_pearson_loss(out.depth, batch["gt_depth"])
    w = cfg.loss_weights
    total = sum(float(w.get(k, 1.0)) * v for k, v in losses.items())
    return total, L.psnr(torch.clamp(out.rgb, 0, 1), batch["im"])


def make_motion_step(cfg: TrainConfig, rcfg: RasterConfig):
    """step(params, opt_state, variables, batch, t, lrs) -> (params,
    opt_state, {"loss", "psnr"}): `motion_loss`'s gradients, zeroed on
    dead rows except in the camera and `motion_*` groups (a group the loss
    does not reach, `label` or the camera tables, takes a zero gradient,
    as the reference's does), then Adam."""

    def step(params, opt_state, variables, batch, t, lrs):
        keys = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        loss, psnr = motion_loss(leaves, batch, variables, t, cfg=cfg,
                                 rcfg=rcfg)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys],
                                    allow_unused=True)
        alive = variables["alive"]
        with torch.no_grad():
            gp = {}
            for k, g in zip(keys, grads):
                g = torch.zeros_like(params[k]) if g is None else g
                if not (k in G.CAMERA_KEYS or k.startswith("motion_")):
                    m = alive.reshape((-1,) + (1,) * (g.dim() - 1))
                    g = torch.where(m, g, torch.zeros_like(g))
                gp[k] = g
            new_params, new_opt = optim.step(
                {k: params[k].detach() for k in keys}, gp, opt_state, lrs)
        return new_params, new_opt, {"loss": loss.detach(),
                                     "psnr": psnr.detach()}

    return step


def _motion_lrs(params: Dict, cfg: TrainConfig, scene_radius: float,
                dev) -> Dict[str, torch.Tensor]:
    lrs = {}
    for k in params:
        if k.startswith("motion_"):
            lr = MOTION_LRS[k[len("motion_"):]]
        elif k == "means3D":
            lr = cfg.lrs["means3D"] * scene_radius
        else:
            lr = cfg.lrs.get(k, 0.0)
        lrs[k] = torch.tensor(lr, dtype=torch.float32, device=dev)
    return lrs


def nearest_rows(points: torch.Tensor, anchors: torch.Tensor,
                 chunk: int = NEAREST_CHUNK) -> torch.Tensor:
    """(N,) index of each point's nearest anchor (the first on ties): the
    sum of squared differences, `chunk` rows at a time."""
    return torch.cat([
        torch.argmin(torch.sum((points[s:s + chunk, None] - anchors[None])
                               ** 2, dim=-1), dim=-1)
        for s in range(0, points.shape[0], chunk)])


def init_motion_state(pt_cld: np.ndarray, w2c_stack: np.ndarray,
                      cfg: TrainConfig, num_frames: int, num_bases: int,
                      features=None, tracks_3d=None, cano_t: int = 0,
                      bases_noise=None, kmeans_idx=None,
                      device: DeviceLike = None):
    """The parameters and variables `train_motion` starts from: the
    gaussians of `pt_cld` with `label` (seg > 0.5) and the motion bases,
    from the Procrustes init on `tracks_3d` (coefficients mapped to the
    gaussians by the nearest canonical track) or near the identity with
    k-means coefficients of `features` (default: the positions)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    params, variables = G.init_params(
        pt_cld, w2c_stack,
        capacity=cfg.capacity or G.round_capacity(pt_cld.shape[0]),
        device=dev)
    cap = variables["alive"].shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    params["label"] = G.pad_params(
        {"label": torch.as_tensor(pt_cld[:, 6] > 0.5, **f32)}, cap)["label"]
    if tracks_3d is not None:
        if tracks_3d.shape[1] != num_frames:
            raise ValueError(f"tracks have {tracks_3d.shape[1]} frames, the "
                             f"dataset {num_frames}")
        t3d = torch.as_tensor(np.asarray(tracks_3d, np.float32), device=dev)
        bases, track_coefs, _ = MB.init_motion_params_with_procrustes(
            t3d, num_bases, cano_t, gen, init_idx=kmeans_idx)
        pts = torch.as_tensor(np.asarray(pt_cld[:, :3], np.float32), **f32)
        coefs = track_coefs[nearest_rows(pts, t3d[:, cano_t])]
    else:
        bases = MB.init_motion_bases(num_bases, num_frames, gen,
                                     noise=bases_noise, device=dev)
        feats = torch.as_tensor(np.asarray(
            features if features is not None else pt_cld[:, :3],
            np.float32), device=dev)
        # the reference draws the k-means rows from a second key; a fresh
        # draw of the same generator stands in for it
        coefs = MB.coefs_from_features(feats, num_bases, gen,
                                       init_idx=kmeans_idx)
    params["motion_rots"] = bases["rots"]
    params["motion_transls"] = bases["transls"]
    params["motion_coefs"] = G.pad_params({"c": coefs}, cap)["c"]
    return params, variables


def train_motion(dataset: List[List[Dict]], cfg: TrainConfig,
                 pt_cld: np.ndarray, w2c_stack: np.ndarray,
                 num_bases: int = 10, num_iters: int = 2000,
                 features: Optional[np.ndarray] = None,
                 tracks_3d: Optional[np.ndarray] = None,
                 cano_t: int = 0, callbacks: Optional[Dict] = None, *,
                 bases_noise=None, kmeans_idx=None,
                 device: DeviceLike = None):
    """Whole-sequence motion-basis optimization.

    dataset[t]: the camera datapoints of frame t ({camera, im, seg,
    optional gt_depth}, on `device`). features: optional (N, D)
    per-gaussian features for the coefficient init (positions when None).
    tracks_3d: optional (M, T, 3) 3D tracks; they switch the init to the
    weighted Procrustes solve. bases_noise (K, T, 6) N(0, 1) and kmeans_idx
    (K,) replay the reference's draws. Callbacks: on_step(0, i, metrics)
    every `cfg.report_every` steps. Runs on `device` (default `cuda`).

    Returns (params, variables).
    """
    dev = resolve_device(device)
    callbacks = callbacks or {}
    num_frames = len(dataset)
    rng = np.random.RandomState(cfg.seed)
    params, variables = init_motion_state(
        pt_cld, w2c_stack, cfg, num_frames, num_bases, features=features,
        tracks_3d=tracks_3d, cano_t=cano_t, bases_noise=bases_noise,
        kmeans_idx=kmeans_idx, device=dev)
    opt_state = optim.init(params)
    lrs = _motion_lrs(params, cfg, float(variables["scene_radius"]), dev)
    step = make_motion_step(cfg, raster_config(cfg))
    for i in range(num_iters):
        t = rng.randint(num_frames)
        batch = dataset[t][rng.randint(len(dataset[t]))]
        params, opt_state, metrics = step(params, opt_state, variables,
                                          batch, t, lrs)
        if "on_step" in callbacks and i % cfg.report_every == 0:
            callbacks["on_step"](0, i, metrics)
    return params, variables


def reverse_window_schedule(num_frames: int, step: int = 3,
                            window: int = 6):
    """Anchors walk the sequence in reverse with stride `step`; each trains
    on the frames [anchor, anchor + window) clipped to the sequence.
    Yields (anchor, [window frames])."""
    for anchor in range(num_frames - 1, -1, -step):
        yield anchor, list(range(anchor, min(anchor + window, num_frames)))


def train_motion_windowed(dataset, cfg: TrainConfig, pt_cld, w2c_stack,
                          num_bases: int = 10,
                          iters_per_window: int = 500,
                          window_step: int = 3, window: int = 6,
                          features=None, callbacks=None, *,
                          bases_noise=None, kmeans_idx=None,
                          device: DeviceLike = None):
    """`train_motion` in the reverse window schedule: later frames first,
    `iters_per_window` steps per window on its frames. It starts from
    `train_motion`'s k-means init (it takes no tracks, as the reference's
    does not). Callbacks: on_step(anchor, it, metrics) every
    `cfg.report_every` steps. Runs on `device` (default `cuda`).

    Returns (params, variables).
    """
    dev = resolve_device(device)
    callbacks = callbacks or {}
    rng = np.random.RandomState(cfg.seed)
    num_frames = len(dataset)
    params, variables = init_motion_state(
        pt_cld, w2c_stack, cfg, num_frames, num_bases, features=features,
        bases_noise=bases_noise, kmeans_idx=kmeans_idx, device=dev)
    opt_state = optim.init(params)
    lrs = _motion_lrs(params, cfg, float(variables["scene_radius"]), dev)
    step = make_motion_step(cfg, raster_config(cfg))
    it = 0
    for anchor, frames in reverse_window_schedule(num_frames, window_step,
                                                  window):
        for _ in range(iters_per_window):
            t = frames[rng.randint(len(frames))]
            batch = dataset[t][rng.randint(len(dataset[t]))]
            params, opt_state, metrics = step(params, opt_state, variables,
                                              batch, t, lrs)
            if "on_step" in callbacks and it % cfg.report_every == 0:
                callbacks["on_step"](anchor, it, metrics)
            it += 1
    return params, variables
