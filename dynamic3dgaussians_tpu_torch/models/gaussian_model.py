"""OO GaussianModel: the 3DGS-style class API over the functional core.

Port of `dynamic3dgaussians_tpu/models/gaussian_model.py`, a thin object
over `models/gaussians.py`, `train/optim.py` and `train/densify.py`:

  * activation properties get_xyz / get_scaling / get_rotation /
    get_opacity / get_features / get_semantic_feature, `oneupSHdegree`
  * create_from_pcd: SH-DC colour init and the 3-NN scale init
  * training_setup: per-group lrs and the exponential decay of the means'
    lr (`expon_lr`)
  * step / add_densification_stats / densify_and_prune / reset_opacity
  * capture() / restore(): the full state, Adam moments included, as
    numpy dicts in the reference's layout, so a reference `capture()`
    restores here unchanged (and the other way round)
  * render_args: the inputs of `ops/rasterize.py::render`

Colour is stored as SH: features_dc (N, 1, 3) and features_rest
(N, K - 1, 3). Densification copies only `models/gaussians.py`'s
GAUSSIAN_KEYS, which name neither, as in the reference (ROADMAP.md §3).

Randomness: `semantic_feature` at creation and the split noise of
`densify_and_prune` come from the model's `torch.Generator` (seed 0), where
the reference draws from `jax.random`; both take the values as arguments
too, so that a test can hand both packages the same draws.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.models import gaussians as G
from dynamic3dgaussians_tpu_torch.ops import quat
from dynamic3dgaussians_tpu_torch.ops.knn import mean3_sq_dist
from dynamic3dgaussians_tpu_torch.ops.sh import rgb_to_sh
from dynamic3dgaussians_tpu_torch.train import densify as D
from dynamic3dgaussians_tpu_torch.train import optim


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000):
    """Exponential lr schedule: log-linear from lr_init to lr_final over
    max_steps, with an optional sine-eased delay."""
    t = np.clip(step / max_steps, 0, 1)
    log_lerp = np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
            0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    return float(delay_rate * log_lerp)


class GaussianModel:
    """Capacity-padded gaussians with SH colour, on `device` (default
    `cuda`)."""

    def __init__(self, sh_degree: int = 3, semantic_dim: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.max_sh_degree = sh_degree
        self.active_sh_degree = 0
        self.semantic_dim = semantic_dim
        self.params: Dict[str, torch.Tensor] = {}
        self.variables: Dict[str, torch.Tensor] = {}
        self.opt_state: Optional[optim.AdamState] = None
        self.lr_cfg: Dict[str, float] = {}
        self.xyz_schedule = None
        self.step_count = 0
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    # ------- activations -------
    @property
    def get_xyz(self):
        return self.params["means3D"]

    @property
    def get_scaling(self):
        return torch.exp(self.params["log_scales"])

    @property
    def get_rotation(self):
        return quat.normalize(self.params["unnorm_rotations"])

    @property
    def get_opacity(self):
        return torch.sigmoid(self.params["logit_opacities"])

    @property
    def get_features(self):
        """(N, K, 3) SH coefficients (dc + rest)."""
        return torch.cat([self.params["features_dc"],
                          self.params["features_rest"]], dim=1)

    @property
    def get_semantic_feature(self):
        return self.params.get("semantic_feature")

    @property
    def alive(self):
        return self.variables["alive"]

    @property
    def num_points(self):
        return int(G.num_alive(self.variables))

    def oneupSHdegree(self):
        if self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1

    # ------- init -------
    def create_from_pcd(self, points: np.ndarray, colors: np.ndarray,
                        spatial_lr_scale: float = 1.0,
                        capacity: Optional[int] = None,
                        semantic_feature: Optional[np.ndarray] = None):
        """Gaussians at `points` (N, 3) with `colors` (N, 3) in [0, 1]:
        identity rotations, opacity 0.1, log scales from the 3-NN mean
        squared distance, every table padded to `capacity` (default 4 N,
        rounded). `semantic_feature` (N, semantic_dim) defaults to
        0.01 * N(0, 1) from the model's generator."""
        n = points.shape[0]
        cap = capacity or G.round_capacity(n * 4)
        k = (self.max_sh_degree + 1) ** 2
        f32 = dict(dtype=torch.float32, device=self.device)
        pts = torch.as_tensor(np.asarray(points, np.float32), **f32)
        m3sq = mean3_sq_dist(pts)
        params = {
            "means3D": pts,
            "features_dc": rgb_to_sh(torch.as_tensor(
                np.asarray(colors, np.float32), **f32))[:, None, :],
            "features_rest": torch.zeros((n, k - 1, 3), **f32),
            "unnorm_rotations": torch.tensor([1.0, 0.0, 0.0, 0.0],
                                             **f32).repeat(n, 1),
            "logit_opacities": G.inverse_sigmoid(
                0.1 * torch.ones((n, 1), **f32)),
            "log_scales": torch.log(torch.sqrt(m3sq))[:, None].repeat(1, 3),
        }
        if self.semantic_dim:
            if semantic_feature is None:
                params["semantic_feature"] = 0.01 * torch.randn(
                    (n, self.semantic_dim), generator=self.generator, **f32)
            else:
                params["semantic_feature"] = torch.tensor(
                    np.asarray(semantic_feature, np.float32), **f32)
        self.params = G.pad_params(params, cap)
        self.variables = {
            "alive": torch.arange(cap, device=self.device) < n,
            "scene_radius": torch.tensor(spatial_lr_scale, **f32),
            "means2D_gradient_accum": torch.zeros(cap, **f32),
            "denom": torch.zeros(cap, **f32),
            "max_2D_radius": torch.zeros(cap, **f32),
        }
        self.spatial_lr_scale = spatial_lr_scale
        return self

    # ------- optimizer -------
    def training_setup(self, position_lr_init=0.00016,
                       position_lr_final=0.0000016,
                       position_lr_max_steps=30_000,
                       feature_lr=0.0025, opacity_lr=0.05, scaling_lr=0.005,
                       rotation_lr=0.001, semantic_feature_lr=0.001):
        self.opt_state = optim.init(self.params)
        self.lr_cfg = {
            "means3D": position_lr_init * self.spatial_lr_scale,
            "features_dc": feature_lr,
            "features_rest": feature_lr / 20.0,
            "logit_opacities": opacity_lr,
            "log_scales": scaling_lr,
            "unnorm_rotations": rotation_lr,
            "semantic_feature": semantic_feature_lr,
        }
        self.xyz_schedule = lambda step: expon_lr(
            step, position_lr_init * self.spatial_lr_scale,
            position_lr_final * self.spatial_lr_scale,
            max_steps=position_lr_max_steps)
        return self

    def _lrs(self):
        lrs = {k: self.lr_cfg.get(k, 0.0) for k in self.params}
        if self.xyz_schedule is not None:
            lrs["means3D"] = self.xyz_schedule(self.step_count)
        return {k: torch.tensor(v, dtype=torch.float32, device=self.device)
                for k, v in lrs.items()}

    def step(self, grads: Dict[str, torch.Tensor]):
        """One Adam step with the current (scheduled) lrs; dead slots get a
        zero gradient."""
        alive = self.variables["alive"]
        grads = {k: torch.where(alive.reshape((-1,) + (1,) * (v.dim() - 1)),
                                v, torch.zeros_like(v))
                 for k, v in grads.items()}
        self.step_count += 1
        self.params, self.opt_state = optim.step(self.params, grads,
                                                 self.opt_state, self._lrs())

    # ------- densification -------
    def add_densification_stats(self, probe_grad, radii):
        self.variables = D.accumulate_stats(self.variables, probe_grad, radii)

    def densify_and_prune(self, iteration: int,
                          noise: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None):
        """One clone / split / prune pass; the split noise is `noise` or
        drawn from the model's generator."""
        self.params, self.variables, self.opt_state, stats = D.densify(
            self.params, self.variables, self.opt_state, iteration,
            generator=self.generator, noise=noise)
        return stats

    def reset_opacity(self):
        self.params, self.opt_state = D.reset_opacity(self.params,
                                                      self.opt_state)

    # ------- checkpointing -------
    def capture(self) -> Dict:
        def host(tree):
            return {k: v.detach().cpu().numpy() for k, v in tree.items()}

        opt = self.opt_state
        return {
            "active_sh_degree": self.active_sh_degree,
            "step_count": self.step_count,
            "spatial_lr_scale": getattr(self, "spatial_lr_scale", 1.0),
            "params": host(self.params),
            "variables": host(self.variables),
            "opt_mu": host(opt.mu) if opt else None,
            "opt_nu": host(opt.nu) if opt else None,
            "opt_step": int(opt.step) if opt else 0,
        }

    def restore(self, state: Dict):
        """Load a `capture()` of either package."""
        from dynamic3dgaussians_tpu_torch.convert import (adam_state_from_jax,
                                                          params_from_jax)
        self.active_sh_degree = int(state["active_sh_degree"])
        self.step_count = int(state["step_count"])
        self.spatial_lr_scale = float(state["spatial_lr_scale"])
        self.params = params_from_jax(state["params"], self.device)
        self.variables = params_from_jax(state["variables"], self.device)
        if state["opt_mu"] is not None:
            self.opt_state = adam_state_from_jax(
                state["opt_mu"], state["opt_nu"], state["opt_step"],
                self.device)
        return self

    # ------- render plumbing -------
    def render_args(self) -> Dict:
        """Inputs of ops.rasterize.render (the SH path, with the semantic
        features as extra channels)."""
        opacity = torch.sigmoid(self.params["logit_opacities"][:, 0])
        args = dict(
            means3d=self.params["means3D"],
            colors=torch.zeros_like(self.params["means3D"]),
            opacity=torch.where(self.alive, opacity,
                                torch.zeros_like(opacity)),
            scales=torch.exp(self.params["log_scales"]),
            rotations=quat.normalize(self.params["unnorm_rotations"]),
            sh=self.get_features,
            sh_degree=self.active_sh_degree,
        )
        if "semantic_feature" in self.params:
            args["extra_channels"] = self.params["semantic_feature"]
        return args
