"""Gaussian scene parameters and their activations.

Port of the render-side part of `dynamic3dgaussians_tpu/models/gaussians.py`.
Parameters keep the reference's key names so checkpoints are
interchangeable:

    means3D (N,3)  rgb_colors (N,3)  seg_colors (N,3)
    unnorm_rotations (N,4)  logit_opacities (N,1)  log_scales (N,3)
    cam_m (C,3)  cam_c (C,3)   [+ semantic_feature (N,F), label (N,)]
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from dynamic3dgaussians_tpu_torch.ops import quat

Params = Dict[str, torch.Tensor]

GAUSSIAN_KEYS = ("means3D", "rgb_colors", "seg_colors", "unnorm_rotations",
                 "logit_opacities", "log_scales", "semantic_feature", "label")


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
