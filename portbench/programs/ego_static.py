"""ego_static: the port's ego + static trainer at t > 0
(`train/ego_trainer.py`), eager or in CUDA-graph windows, against the plain
ego step of `reference/ego.py`.

A step renders one ego frame and every static view: the ego render turned
by -90 degrees and masked, each static view's masked image loss and its
depth L1 over alpha, the physics losses once. So K1, K2 and E1 run once a
render, five times a step with the 4 static views, and P1 once.

Inputs (`make`): `scene.make` for the cloud and the static views (its
ring of `num_cams` cameras), and from the plain reference render
(`reference/render.py`) the static views' depth and the ego frames.
The loop (`ProgramRun`) is `loop.ProgramRun`'s state and loop with the
ego step (`make_ego_step` on a `StaticRig` of the static views) in place of
the Panoptic one: the first call one eager step, then windows of the
traffic's `steps_per_call` through `make_train_scan`, as `train_ego` runs
them; the host's report reads the loss and the five renders' summed rect
drops, as for the Panoptic step. (`loop.ProgramRun` builds the Panoptic
step, which is replaced: `loop.py` takes no step of a caller's.)
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.train.ego_trainer import (StaticRig,
                                                            make_ego_step)
from portbench import counts, loop, scene
from portbench.loop import Schedule
from portbench.reference import ego as ref_ego
from portbench.reference import render as R
from portbench.reference.train import normalize

__all__ = ["make", "ProgramRun", "first_cams", "follow", "walk_stats",
           "step_counts"]

follow = ref_ego.follow
LOSS_CHANNELS = 3          # the masked image loss: rgb only


def _truth(cfg: Dict, seed: int, device):
    """The ground-truth scene at the trained timestep, drawn as `scene.make`
    draws it (same generator, same order): (moved means, colours, opacity,
    scales, rotations, segmentation)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device)
    n, e = cfg["n_gaussians"], cfg["extent"]

    def uniform(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f32)

    means = uniform(-e, e, (n, 3))
    colors = uniform(0.0, 1.0, (n, 3))
    opac = uniform(*cfg["opacity"], (n,))
    scales = uniform(*cfg["scales"], (n, 3))
    quats = normalize(torch.randn((n, 4), generator=gen, **f32))
    seg = (torch.rand((n,), generator=gen, **f32)
           < cfg["foreground_share"]).to(torch.float32)
    rot, shift = scene.foreground_motion(cfg)
    moved = torch.where(seg[:, None] > 0.5,
                        means @ torch.tensor(rot, **f32).T
                        + torch.tensor(shift, **f32), means)
    return moved, colors, opac, scales, quats, seg


def ego_cameras(cfg: Dict):
    """[(K 3x3, w2c 4x4)] float64 of the ego frames of the trained
    timestep: on the ego path from `ego_radius` [0] to [1] and
    `ego_azimuth` [0] to [1] over the sequence, at `ego_height`, looking at
    the origin (`scene.ring_cameras`' convention)."""
    out = []
    n_frames = cfg["ego_frames_per_timestep"]
    total = cfg["num_timesteps"] * n_frames
    f, w, h = cfg["focal"], cfg["width"], cfg["height"]
    for j in range(n_frames):
        frac = (cfg["timestep"] * n_frames + j) / max(total - 1, 1)
        r = cfg["ego_radius"][0] + frac * (cfg["ego_radius"][1]
                                           - cfg["ego_radius"][0])
        a = cfg["ego_azimuth"][0] + frac * (cfg["ego_azimuth"][1]
                                            - cfg["ego_azimuth"][0])
        eye = np.array([r * np.cos(a), cfg["ego_height"], r * np.sin(a)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(fwd, right), fwd
        c2w[:3, 3] = eye
        k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float64)
        out.append((k, np.linalg.inv(c2w)))
    return out


def triangular_mask(h: int, w: int, device) -> torch.Tensor:
    """(h, w) {0, 1}: 1 but for the bottom-right triangle of half the
    height and width (the rig's corner, masked out of the ego loss)."""
    y = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) / h
    x = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) / w
    return ((y[:, None] + x[None, :]) <= 1.5).to(torch.float32)


def make(cfg: Dict, seed: int, device) -> Dict:
    """`scene.make`'s inputs, its frames the static views with their depth
    (depth / alpha of the plain render where alpha > 0.5, else 0) and mask
    (all ones), and under "ego" the ego frames: {"mats", "cam", "im" (the
    clipped render turned by -90 degrees, zero outside the mask), "mask"
    (the triangular mask in the turned frame)}."""
    inputs = scene.make(cfg, seed, device)
    moved, colors, opac, scales, quats, seg = _truth(cfg, seed, device)
    if not (torch.equal(inputs["cloud"][:, 3:6], colors)
            and torch.equal(inputs["cloud"][:, 6], seg)):
        raise RuntimeError("the ground truth is not scene.make's")
    frames, ego = [], []
    with torch.no_grad():
        for cam, frame in zip(inputs["cams"], inputs["frames"]):
            vals = torch.cat([colors, ref_ego.depth_channels(moved, cam)], -1)
            img, _ = R.render(moved, scales, quats, opac, vals, cam,
                              cfg["k_slots"], cfg["enum_cap"])
            alpha = img[..., 4]
            depth = torch.where(alpha > 0.5, img[..., 3] / torch.clamp(
                alpha, min=ref_ego.ALPHA_FLOOR), torch.zeros_like(alpha))
            frames.append(dict(frame, depth=depth.contiguous(),
                               mask=torch.ones_like(alpha)))
        mask = triangular_mask(cfg["width"], cfg["height"], device)
        for k, w2c in ego_cameras(cfg):
            cam = R.make_cam(k, w2c, cfg["width"], cfg["height"], device)
            img, _ = R.render(moved, scales, quats, opac, colors, cam,
                              cfg["k_slots"], cfg["enum_cap"])
            turned = torch.rot90(torch.clamp(img, 0.0, 1.0), k=-1,
                                 dims=(0, 1))
            ego.append(dict(mats=(k, w2c), cam=cam, mask=mask,
                            im=(turned * mask[..., None]).contiguous()))
    return dict(inputs, frames=frames, ego=ego)


class ProgramRun(loop.ProgramRun):
    """`loop.ProgramRun`'s t > 0 state (init from the cloud, the kNN graph
    and reorder, the extrapolation; the static cameras' scene radius) and
    loop, with the ego step: the static views in a `StaticRig`, the ego
    frames as the timestep's data, stacked for the windows."""

    def __init__(self, inputs: Dict, cfg: Dict, traffic: Dict, seed: int,
                 device, graph_factory=None):
        from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
        from dynamic3dgaussians_tpu_torch.train import trainer as T
        super().__init__(inputs, cfg, traffic, seed, device,
                         graph_factory=graph_factory)
        dev, w, h = self.dev, cfg["width"], cfg["height"]
        self.rig = StaticRig([
            dict(camera=make_camera(w, h, kmat, w2c, device=dev),
                 im=frame["im"], mask=frame["mask"], gt_depth=frame["depth"],
                 cam_id=c)
            for c, ((kmat, w2c), frame) in enumerate(zip(inputs["mats"],
                                                         inputs["frames"]))])
        self.data_t = [dict(camera=make_camera(w, h, *e["mats"], device=dev),
                            im=e["im"], mask=e["mask"],
                            cam_id=cfg["ego_cam_id"])
                       for e in inputs["ego"]]
        rcfg = T.raster_config(self.tcfg)
        self.step = make_ego_step(self.tcfg, rcfg,
                                  rot90_ego=cfg["rot90_ego"],
                                  stat_depth_weight=cfg["stat_depth_weight"],
                                  rig=self.rig)
        self.scan = self.data_stack = None
        if traffic["steps_per_call"] > 1:
            self.scan = T.make_train_scan(self.tcfg, rcfg, self.step,
                                          graph_factory=graph_factory)
            self.data_stack = T.stack_timestep_data(self.data_t)
        self.schedule = Schedule(traffic, len(self.data_t),
                                 self.tcfg.iters_per_timestep, seed)

    def free(self) -> None:
        super().free()
        self.rig = None


def first_cams(cfg: Dict, traffic: Dict, seed: int) -> List[int]:
    """The ego frames of the calls that `ProgramRun.first_steps` runs."""
    return Schedule(traffic, cfg["ego_frames_per_timestep"],
                    cfg["iters_per_timestep"], seed).first_cams(
                        traffic["check_min_steps"])


def walk_stats(inputs: Dict, cfg: Dict, cams: List[int]) -> List[Dict]:
    """Per step, its five renders' walks at the seeded start and its rows
    and edges (the reference's, `reference/ego.py::walk_stats`)."""
    return ref_ego.walk_stats(inputs, cfg, cams)


def _render(r: Dict, cfg: Dict, n_chan: int) -> Dict[str, float]:
    """One view's render and its masked image loss, forward and backward:
    K1, K2, E1, the projection and the loss over the rgb pixels."""
    loss_elems = LOSS_CHANNELS * cfg["width"] * cfg["height"]
    return counts.add(
        counts.k1(r["read_pairs"], r["tiles"], n_chan),
        counts.k2(r["read_pairs"], r["tiles"], n_chan),
        counts.e1(cfg["capacity"], r["live_pairs"]),
        dict(bytes=2 * r["rows"] * counts.PROJ_ROW_BYTES,
             flops=r["rows"] * counts.PROJ_ROW_OPS),
        dict(bytes=loss_elems * counts.PIXEL_LOSS_BYTES,
             flops=loss_elems * counts.PIXEL_LOSS_OPS))


def step_counts(walk: Dict, cfg: Dict) -> Dict[str, Dict[str, float]]:
    """The step's counts: K1, K2 and E1 over its five renders, P1 once, and
    the whole step as five renders' work and one update."""
    n_chan = 6 + cfg["semantic_dim"]          # rgb and seg
    rs = walk["renders"]
    return dict(
        k1=counts.add(*(counts.k1(r["read_pairs"], r["tiles"], n_chan)
                        for r in rs)),
        k2=counts.add(*(counts.k2(r["read_pairs"], r["tiles"], n_chan)
                        for r in rs)),
        e1=counts.add(*(counts.e1(cfg["capacity"], r["live_pairs"])
                        for r in rs)),
        p1=counts.p1(walk["fg_rows"], walk["edges"]),
        step=counts.add(*(_render(r, cfg, n_chan) for r in rs),
                        counts.update(walk, cfg)))
