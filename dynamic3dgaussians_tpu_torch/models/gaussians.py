"""Gaussian scene parameters: capacity-padded tables and activations.

Port of `dynamic3dgaussians_tpu/models/gaussians.py`. Parameters keep the reference's key names so
checkpoints are interchangeable:

    means3D (N,3)  rgb_colors (N,3)  seg_colors (N,3)
    unnorm_rotations (N,4)  logit_opacities (N,1)  log_scales (N,3)
    cam_m (C,3)  cam_c (C,3)   [+ semantic_feature (N,F), label (N,)]

As in the reference, every per-gaussian table is padded to a `capacity`
with an `alive` mask in `variables`: densification writes into free slots
and flips the mask instead of reallocating, and dead slots render with
opacity 0.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.ops import quat
from dynamic3dgaussians_tpu_torch.ops.knn import mean3_sq_dist
from dynamic3dgaussians_tpu_torch.train import optim

Params = Dict[str, torch.Tensor]
Variables = Dict[str, torch.Tensor]

GAUSSIAN_KEYS = ("means3D", "rgb_colors", "seg_colors", "unnorm_rotations",
                 "logit_opacities", "log_scales", "semantic_feature", "label")
CAMERA_KEYS = ("cam_m", "cam_c")
# per-gaussian densification statistics carried in `variables`
STAT_KEYS = ("alive", "means2D_gradient_accum", "denom", "max_2D_radius")


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def activated(params: Params, alive: Optional[torch.Tensor] = None) -> Params:
    """Render inputs from parameters: normalized quats, sigmoid opacity
    (zeroed where not alive), exp scales; colors raw."""
    opacity = torch.sigmoid(params["logit_opacities"][:, 0])
    if alive is not None:
        opacity = torch.where(alive, opacity, torch.zeros_like(opacity))
    out = {
        "means3d": params["means3D"],
        "colors": params["rgb_colors"],
        "rotations": quat.normalize(params["unnorm_rotations"]),
        "opacity": opacity,
        "scales": torch.exp(params["log_scales"]),
    }
    if "semantic_feature" in params:
        out["semantic_feature"] = params["semantic_feature"]
    return out


def round_capacity(n: int, multiple: int = 1024) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def init_params(pt_cld: np.ndarray, w2c_stack: np.ndarray, *,
                max_cams: Optional[int] = None,
                capacity: Optional[int] = None,
                semantic_dim: int = 0, seed: int = 0,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None):
    """Parameters and variables from an (N, 7) [xyz, rgb, seg] point cloud.

    Identity rotations, zero opacity logits, log scales from the square
    root of the mean squared distance to the 3 nearest neighbours, the
    scene radius from the spread of the cameras `w2c_stack` (C, 4, 4), and
    every per-gaussian table padded to `capacity` (default 4 N, rounded).
    The colour-correction tables `cam_m` / `cam_c` have `max_cams` rows,
    by default one per camera of `w2c_stack` and at least 5. (The
    reference fixes 5 and clamps a camera id past them onto the last row,
    so cameras 4 and up share one correction; here an id past an explicit
    `max_cams` raises.)
    `semantic_feature` (semantic_dim > 0) is 0.01 * N(0, 1), drawn from
    `generator` (default: a generator seeded with `seed`). Runs on `device`
    (default `cuda`).
    """
    dev = resolve_device(device)
    if max_cams is None:
        max_cams = max(5, len(w2c_stack))
    n = pt_cld.shape[0]
    cap = capacity or round_capacity(int(n * 4))
    f32 = dict(dtype=torch.float32, device=dev)
    seg = torch.as_tensor(np.asarray(pt_cld[:, 6], np.float32), **f32)
    means = torch.as_tensor(np.asarray(pt_cld[:, :3], np.float32), **f32)
    m3sq = mean3_sq_dist(means)
    log_scales = torch.log(torch.sqrt(m3sq))[:, None].repeat(1, 3)
    params = {
        "means3D": means,
        "rgb_colors": torch.as_tensor(np.asarray(pt_cld[:, 3:6], np.float32),
                                      **f32),
        "seg_colors": torch.stack([seg, torch.zeros_like(seg), 1.0 - seg],
                                  dim=-1),
        "unnorm_rotations": torch.tensor([1.0, 0.0, 0.0, 0.0],
                                         **f32).repeat(n, 1),
        "logit_opacities": torch.zeros((n, 1), **f32),
        "log_scales": log_scales,
        "cam_m": torch.zeros((max_cams, 3), **f32),
        "cam_c": torch.zeros((max_cams, 3), **f32),
    }
    if semantic_dim:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        params["semantic_feature"] = 0.01 * torch.randn(
            (n, semantic_dim), generator=generator, **f32)
    params = pad_params(params, cap)
    cam_centers = np.linalg.inv(np.asarray(w2c_stack))[:, :3, 3]
    scene_radius = 1.1 * float(np.max(np.linalg.norm(
        cam_centers - cam_centers.mean(0, keepdims=True), axis=-1)))
    variables = {
        "alive": torch.arange(cap, device=dev) < n,
        "scene_radius": torch.tensor(scene_radius, **f32),
        "means2D_gradient_accum": torch.zeros(cap, **f32),
        "denom": torch.zeros(cap, **f32),
        "max_2D_radius": torch.zeros(cap, **f32),
    }
    return params, variables


def _pad_rows(v: torch.Tensor, rows: int) -> torch.Tensor:
    pad = torch.zeros((rows,) + tuple(v.shape[1:]), dtype=v.dtype,
                      device=v.device)
    return torch.cat([v, pad])


def pad_params(params: Params, capacity: int) -> Params:
    """Pad every per-gaussian table to `capacity` rows of zeros."""
    out = {}
    for k, v in params.items():
        if k in CAMERA_KEYS:
            out[k] = v
            continue
        n = v.shape[0]
        if n > capacity:
            raise ValueError(f"{k}: {n} rows > capacity {capacity}")
        out[k] = _pad_rows(v, capacity - n)
    return out


def num_alive(variables: Variables) -> torch.Tensor:
    return torch.sum(variables["alive"].to(torch.int32))


def rows_of(tree: Params, fn) -> Params:
    return {k: (v if k in CAMERA_KEYS else fn(v)) for k, v in tree.items()}


def grow_capacity(params: Params, variables: Variables, new_capacity: int,
                  opt_state=None):
    """Pad every per-gaussian table (params, statistics and, when given,
    the Adam moments) from the current capacity to `new_capacity`; the new
    slots are dead."""
    extra = new_capacity - variables["alive"].shape[0]
    grown = pad_params(params, new_capacity)
    var = dict(variables)
    for k in STAT_KEYS:
        var[k] = _pad_rows(variables[k], extra)
    if opt_state is None:
        return grown, var
    pad = lambda v: _pad_rows(v, extra)          # noqa: E731
    return grown, var, optim.AdamState(mu=rows_of(opt_state.mu, pad),
                                       nu=rows_of(opt_state.nu, pad),
                                       step=opt_state.step)


def compact(params: Params, variables: Variables):
    """Repack the alive gaussians to the front, in their order; returns
    (params, variables, order) with order the row permutation applied."""
    order = torch.argsort((~variables["alive"]).to(torch.int8), stable=True)
    out = rows_of(params, lambda v: v[order])
    var = dict(variables)
    for k in STAT_KEYS:
        var[k] = variables[k][order]
    return out, var, order


def compact_with_optimizer(params: Params, variables: Variables, opt_state):
    """compact() plus the same row reorder of the Adam moments."""
    params, variables, order = compact(params, variables)
    take = lambda v: v[order]                    # noqa: E731
    return params, variables, optim.AdamState(
        mu=rows_of(opt_state.mu, take), nu=rows_of(opt_state.nu, take),
        step=opt_state.step), order


def compose_scenes(static_params: Params, dynamic_params: Params,
                   capacity: Optional[int] = None,
                   device: DeviceLike = None):
    """A trained static background scene and a dynamic foreground set in
    one table: the static rows first with `label` 0, then the dynamic rows
    with `label` 1 (the label that gates what moves and learns).

    Only the per-gaussian keys both sides have are kept. A static table
    with a leading time axis (a stacked per-timestep checkpoint) gives its
    timestep 0. The camera tables come from the static side when it has
    them, else from the dynamic one; `scene_radius` from the static side
    (default 1). Values may be arrays or tensors. Returns (params,
    variables) padded to `capacity` (default: the row count rounded up),
    on `device` (default `cuda`).
    """
    dev = resolve_device(device)

    def t(v):
        return torch.as_tensor(v if isinstance(v, torch.Tensor)
                               else np.asarray(v)).to(dev)

    f32 = dict(dtype=torch.float32, device=dev)
    s_means = t(static_params["means3D"])
    n_s = s_means.shape[-2] if s_means.dim() == 3 else s_means.shape[0]
    n_d = t(dynamic_params["means3D"]).shape[0]
    out: Params = {}
    for k in dict(static_params, **dynamic_params):
        s, d = static_params.get(k), dynamic_params.get(k)
        if k not in GAUSSIAN_KEYS or s is None or d is None:
            continue
        s = t(s)
        if s.dim() == 3:
            s = s[0]
        out[k] = torch.cat([s, t(d)], dim=0)
    out["label"] = torch.cat([torch.zeros(n_s, **f32),
                              torch.ones(n_d, **f32)])
    for k in CAMERA_KEYS:
        if k in static_params:
            out[k] = t(static_params[k])
        elif k in dynamic_params:
            out[k] = t(dynamic_params[k])
    n = n_s + n_d
    cap = capacity or round_capacity(n)
    variables = {
        "alive": torch.arange(cap, device=dev) < n,
        "scene_radius": t(static_params.get("scene_radius",
                                            1.0)).to(torch.float32),
        "means2D_gradient_accum": torch.zeros(cap, **f32),
        "denom": torch.zeros(cap, **f32),
        "max_2D_radius": torch.zeros(cap, **f32),
    }
    return pad_params(out, cap), variables
