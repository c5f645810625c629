"""OO Scene: the camera frames and the GaussianModel they train.

Port of `dynamic3dgaussians_tpu/models/scene.py`. A Scene owns the train
and test frame lists and the GaussianModel, initialises the gaussians from
the scene's point cloud (or restores them from a saved PLY), and saves PLY
snapshots under its output directory, at
point_cloud/iteration_N/point_cloud.ply, where 3DGS viewers look. Sources:

  * the reference's dynamic data layout (train_meta.json + init_pt_cld.npz)
    through `data/dataset.py` (`scene_from_reference_dataset`)
  * a COLMAP reconstruction through `data/colmap.py` (`scene_from_colmap`;
    its frames carry no "im": the caller attaches the images)
  * an in-memory frame list and point cloud

As in the reference, a reload from PLY restores only what the splat PLY
holds: features_rest comes back zero, the active SH degree drops to 0 (with
a warning when the model's degree is above 0), and the tables are padded to
`round_capacity(n)`, which leaves densify no free slots beyond that
rounding (ROADMAP.md §3).
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch import native
from dynamic3dgaussians_tpu_torch.models import gaussians as G
from dynamic3dgaussians_tpu_torch.models.gaussian_model import GaussianModel


class Scene:
    def __init__(self, gaussians: GaussianModel,
                 model_path: str = "./output/scene",
                 frames: Optional[List[Dict]] = None,
                 test_frames: Optional[List[Dict]] = None,
                 point_cloud: Optional[np.ndarray] = None,
                 spatial_lr_scale: Optional[float] = None,
                 capacity: Optional[int] = None,
                 load_iteration: Optional[int] = None):
        """gaussians: an uninitialised GaussianModel; frames / test_frames:
        camera datapoints ({camera, im, ...}); point_cloud: (N, >= 6)
        [xyz rgb ...] initial points, needed unless `load_iteration`
        restores point_cloud/iteration_{i}/point_cloud.ply (-1: the
        latest)."""
        self.gaussians = gaussians
        self.model_path = model_path
        self.train_frames = frames or []
        self.test_frames = test_frames or []

        if load_iteration is not None:
            it = self._resolve_iteration(load_iteration)
            self.loaded_iter = it
            self._load_ply(it)
        else:
            if point_cloud is None:
                raise ValueError("need point_cloud or load_iteration")
            if spatial_lr_scale is None:
                spatial_lr_scale = self._nerfpp_radius()
            gaussians.create_from_pcd(point_cloud[:, :3],
                                      point_cloud[:, 3:6],
                                      spatial_lr_scale=spatial_lr_scale,
                                      capacity=capacity)
            self.loaded_iter = None

    # ---- the reference Scene API ----
    def getTrainCameras(self) -> List[Dict]:
        return self.train_frames

    def getTestCameras(self) -> List[Dict]:
        return self.test_frames

    def save(self, iteration: int) -> str:
        """PLY snapshot at point_cloud/iteration_{iteration}/ of table rows
        [0, num_points), as the reference writes it: the alive gaussians
        until a prune leaves dead rows among them (ROADMAP.md §3). Returns
        that directory."""
        d = os.path.join(self.model_path, "point_cloud",
                         f"iteration_{iteration}")
        os.makedirs(d, exist_ok=True)
        n = self.gaussians.num_points
        p = {k: v[:n].detach().cpu().numpy()
             for k, v in self.gaussians.params.items()}
        native.ply_write(os.path.join(d, "point_cloud.ply"), p["means3D"],
                         p["features_dc"][:, 0, :],
                         p["logit_opacities"][:, 0], p["log_scales"],
                         p["unnorm_rotations"])
        return d

    # ---- helpers ----
    def _resolve_iteration(self, it: int) -> int:
        base = os.path.join(self.model_path, "point_cloud")
        if it >= 0:
            return it
        its = [int(d.split("_")[-1]) for d in os.listdir(base)
               if d.startswith("iteration_")]
        if not its:
            raise FileNotFoundError(f"no checkpoints under {base}")
        return max(its)

    def _load_ply(self, iteration: int):
        path = os.path.join(self.model_path, "point_cloud",
                            f"iteration_{iteration}", "point_cloud.ply")
        data = native.ply_read(path)
        n = data["means3D"].shape[0]
        g = self.gaussians
        k = (g.max_sh_degree + 1) ** 2
        f32 = dict(dtype=torch.float32, device=g.device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), **f32)

        params = {
            "means3D": t(data["means3D"]),
            "features_dc": t(data["f_dc"])[:, None, :],
            "features_rest": torch.zeros((n, k - 1, 3), **f32),
            "logit_opacities": t(data["logit_opacities"]),
            "log_scales": t(data["log_scales"]),
            "unnorm_rotations": t(data["unnorm_rotations"]),
        }
        cap = G.round_capacity(n)
        g.params = G.pad_params(params, cap)
        g.variables = {
            "alive": torch.arange(cap, device=g.device) < n,
            "scene_radius": torch.tensor(self._nerfpp_radius(), **f32),
            "means2D_gradient_accum": torch.zeros(cap, **f32),
            "denom": torch.zeros(cap, **f32),
            "max_2D_radius": torch.zeros(cap, **f32),
        }
        g.spatial_lr_scale = float(g.variables["scene_radius"])
        # the splat PLY holds only the DC SH: say so in the active degree
        g.active_sh_degree = 0
        if g.max_sh_degree > 0:
            warnings.warn(
                f"{path}: splat PLY carries only DC SH; features_rest "
                "zeroed and active_sh_degree reset to 0 "
                f"(model max_sh_degree={g.max_sh_degree})")

    def _nerfpp_radius(self) -> float:
        if not self.train_frames:
            return 1.0
        centers = [np.linalg.inv(f["camera"].w2c.cpu().numpy())[:3, 3]
                   for f in self.train_frames]
        centers = np.stack(centers)
        return 1.1 * float(np.max(np.linalg.norm(
            centers - centers.mean(0), axis=-1))) or 1.0


def scene_from_reference_dataset(root: str, seq: str,
                                 gaussians: GaussianModel,
                                 model_path: str = "./output/scene",
                                 t: int = 0, **kw) -> Scene:
    """Scene over the reference's dynamic data layout at timestep t, its
    frames on the model's device."""
    from dynamic3dgaussians_tpu_torch.data import dataset as D
    md = D.load_meta(root, seq)
    frames = D.load_timestep(root, seq, md, t, device=gaussians.device)
    pt = D.load_init_point_cloud(root, seq)
    return Scene(gaussians, model_path=model_path, frames=frames,
                 point_cloud=pt, **kw)


def scene_from_colmap(root: str, gaussians: GaussianModel,
                      model_path: str = "./output/scene", **kw) -> Scene:
    """Scene from a COLMAP reconstruction under root/sparse/0: one frame
    {camera, name} per image, on the model's device, and the model
    initialised from the reconstruction's points at the nerf++ radius."""
    from dynamic3dgaussians_tpu_torch.data.colmap import read_colmap_scene
    from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
    info = read_colmap_scene(root)
    frames = []
    for im in info.images:
        cam_info = info.cameras[im.camera_id]
        frames.append({"camera": make_camera(
            cam_info.width, cam_info.height, cam_info.intrinsics, im.w2c,
            device=gaussians.device), "name": im.name})
    cloud = np.concatenate([info.points, info.point_colors], axis=1)
    return Scene(gaussians, model_path=model_path, frames=frames,
                 point_cloud=cloud.astype(np.float32),
                 spatial_lr_scale=info.nerf_norm_radius, **kw)
