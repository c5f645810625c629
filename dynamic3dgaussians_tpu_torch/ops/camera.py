"""Pinhole camera with an OpenGL-style projection.

Port of `dynamic3dgaussians_tpu/ops/camera.py`. Convention (column vectors):
p_view = w2c @ [p; 1], p_clip = proj @ p_view.

Every matrix is float32, as in the reference. The two 4x4 products of
`make_camera` run with TF32 switched off
(`torch.backends.cuda.matmul.allow_tf32 = False`, restored afterwards): at
TF32's ~10-bit mantissa `full_proj` would move every projected splat center
by a fraction of a pixel, the same failure the reference guards against on
the TPU with HIGHEST matmul precision.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.device import (DeviceLike, no_tf32,
                                                 resolve_device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera tensors (float32, on one device) plus static image metadata."""

    w2c: torch.Tensor          # (4, 4) world -> camera
    proj: torch.Tensor         # (4, 4) camera -> clip
    full_proj: torch.Tensor    # (4, 4) proj @ w2c
    cam_center: torch.Tensor   # (3,) camera center in world coordinates
    fx: torch.Tensor           # () focal length in pixels
    fy: torch.Tensor
    cx: torch.Tensor           # () principal point in pixels
    cy: torch.Tensor
    height: int = 0
    width: int = 0
    near: float = 0.01
    far: float = 100.0

    @property
    def device(self) -> torch.device:
        return self.w2c.device

    @property
    def tan_fovx(self) -> torch.Tensor:
        return self.width / (2.0 * self.fx)

    @property
    def tan_fovy(self) -> torch.Tensor:
        return self.height / (2.0 * self.fy)


def opengl_projection(fx, fy, cx, cy, w: int, h: int, near: float,
                      far: float) -> torch.Tensor:
    """OpenGL-style projection from OpenCV intrinsics (0-d float32 tensors).

    z_clip = far/(far-near) * z_view - far*near/(far-near); w_clip = z_view.
    """
    z = torch.zeros((), dtype=torch.float32, device=fx.device)
    row0 = torch.stack([2 * fx / w + z, z, -(w - 2 * cx) / w + z, z])
    row1 = torch.stack([z, 2 * fy / h + z, -(h - 2 * cy) / h + z, z])
    row2 = torch.stack([z, z, z + far / (far - near),
                        z - (far * near) / (far - near)])
    row3 = torch.stack([z, z, z + 1.0, z])
    return torch.stack([row0, row1, row2, row3]).to(torch.float32)


def make_camera(w: int, h: int, k, w2c, near: float = 0.01,
                far: float = 100.0, device: DeviceLike = None) -> Camera:
    """Camera from a 3x3 intrinsics matrix and a 4x4 world-to-camera
    extrinsic (array-likes), on `device` (default `cuda`)."""
    dev = resolve_device(device)
    k = torch.as_tensor(np.asarray(k, np.float32), device=dev)
    w2c = torch.as_tensor(np.asarray(w2c, np.float32), device=dev)
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    proj = opengl_projection(fx, fy, cx, cy, w, h, near, far)
    with no_tf32():
        c2w = torch.linalg.inv(w2c)
        full_proj = proj @ w2c
    return Camera(w2c=w2c, proj=proj, full_proj=full_proj,
                  cam_center=c2w[:3, 3], fx=fx, fy=fy, cx=cx, cy=cy,
                  height=int(h), width=int(w), near=float(near),
                  far=float(far))


def orbit_cameras(center, radius: float, height: float, n: int, w: int,
                  h: int, f: float, near: float = 0.01, far: float = 100.0,
                  device: DeviceLike = None):
    """n cameras on a circle looking at `center` (y-down scenes)."""
    cams = []
    center = np.asarray(center, np.float64)
    for i in range(n):
        a = 2 * np.pi * i / max(n, 1)
        eye = center + np.array([radius * np.cos(a), height,
                                 radius * np.sin(a)])
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right = right / np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up2, fwd, eye
        w2c = np.linalg.inv(c2w)
        k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float64)
        cams.append(make_camera(w, h, k, w2c, near, far, device=device))
    return cams


def stack_cameras(cams) -> Camera:
    """One Camera whose tensor fields carry a leading batch axis, stacked
    field by field; the cameras must share one image size, and the static
    fields (height, width, near, far) are the first camera's."""
    first = cams[0]
    if not all((c.width, c.height) == (first.width, first.height)
               for c in cams):
        # the reference's assertion, raised under -O too
        raise AssertionError("stack_cameras: mixed image sizes")
    stacked = {f.name: torch.stack([getattr(c, f.name) for c in cams])
               for f in dataclasses.fields(Camera)
               if f.name not in ("height", "width", "near", "far")}
    return dataclasses.replace(first, **stacked)


def select_camera(stacked: Camera, idx: torch.Tensor) -> Camera:
    """Camera `idx` of a `stack_cameras` batch, by a (1,) int64 index
    tensor on the cameras' device: a gather per field, with no host read
    (so it can run inside a captured CUDA graph)."""
    fields = {f.name: getattr(stacked, f.name).index_select(0, idx)[0]
              for f in dataclasses.fields(Camera)
              if f.name not in ("height", "width", "near", "far")}
    return dataclasses.replace(stacked, **fields)
