"""EWA projection: the per-gaussian geometry stage.

Port of `dynamic3dgaussians_tpu/ops/projection.py`, formula for formula and
in the same operation order (float32 results, integer radii, must match the
reference exactly):

  cov3D  = R S^2 R^T
  cov2D  = J W cov3D W^T J^T + 0.3*I   (principal-point-aware clamp)
  conic  = inverse(cov2D)
  radius = ceil(3*sqrt(max eigenvalue))
  ndc2pix(v, S) = ((v+1)*S - 1)/2

Every per-gaussian quantity is a flat (N,) tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from dynamic3dgaussians_tpu_torch.ops.camera import Camera

COV2D_BLUR = 0.3
EIG_GUARD = 0.1


@dataclasses.dataclass(frozen=True)
class Projected:
    """Screen-space primitives from `project`; every field is flat (N,)."""

    x2d: torch.Tensor
    y2d: torch.Tensor
    conic_a: torch.Tensor
    conic_b: torch.Tensor
    conic_c: torch.Tensor
    depth: torch.Tensor
    radius: torch.Tensor    # int32, 0 => culled
    valid: torch.Tensor     # bool

    @property
    def mean2d(self) -> torch.Tensor:
        return torch.stack([self.x2d, self.y2d], dim=-1)

    @property
    def conic(self) -> torch.Tensor:
        return torch.stack([self.conic_a, self.conic_b, self.conic_c], dim=-1)


def _sq(v):
    return v * v


def _cov3d_components(scales, rotations, scale_modifier=1.0):
    """Packed symmetric 3D covariance [xx, xy, xz, yy, yz, zz] as six flat
    tensors, from (N, 3) activated scales and (N, 4) unit wxyz quats."""
    r, x, y, z = rotations.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    sx, sy, sz = scales.unbind(-1)
    s0 = _sq(scale_modifier * sx)
    s1 = _sq(scale_modifier * sy)
    s2_ = _sq(scale_modifier * sz)
    return (
        s0 * r00 * r00 + s1 * r01 * r01 + s2_ * r02 * r02,
        s0 * r00 * r10 + s1 * r01 * r11 + s2_ * r02 * r12,
        s0 * r00 * r20 + s1 * r01 * r21 + s2_ * r02 * r22,
        s0 * r10 * r10 + s1 * r11 * r11 + s2_ * r12 * r12,
        s0 * r10 * r20 + s1 * r11 * r21 + s2_ * r12 * r22,
        s0 * r20 * r20 + s1 * r21 * r21 + s2_ * r22 * r22,
    )


def build_cov3d(scales: torch.Tensor, rotations: torch.Tensor,
                scale_modifier: float = 1.0) -> torch.Tensor:
    """3D covariance R diag(s)^2 R^T of (N, 3) activated scales and (N, 4)
    unit wxyz quaternions, packed (N, 6) [xx, xy, xz, yy, yz, zz]: the
    components `project` uses, stacked."""
    return torch.stack(_cov3d_components(scales, rotations, scale_modifier),
                       dim=-1)


def unpack_sym3(packed: torch.Tensor) -> torch.Tensor:
    """(..., 6) [xx, xy, xz, yy, yz, zz] -> (..., 3, 3) symmetric."""
    xx, xy, xz, yy, yz, zz = packed.unbind(-1)
    return torch.stack([torch.stack([xx, xy, xz], dim=-1),
                        torch.stack([xy, yy, yz], dim=-1),
                        torch.stack([xz, yz, zz], dim=-1)], dim=-2)


def _ewa_cov2d(mx, my, mz, cov6, cam: Camera):
    """EWA 2D covariance (cxx, cxy, cyy) with the +0.3 low-pass."""
    V = cam.w2c
    tx0 = V[0, 0] * mx + V[0, 1] * my + V[0, 2] * mz + V[0, 3]
    ty0 = V[1, 0] * mx + V[1, 1] * my + V[1, 2] * mz + V[1, 3]
    tz = V[2, 0] * mx + V[2, 1] * my + V[2, 2] * mz + V[2, 3]
    txtz = tx0 / tz
    tytz = ty0 / tz
    # principal-point-aware view limits (the symmetric 1.3*tan_fov clamp of
    # the original is overwritten by these, so only they apply)
    lim_x_pos = (cam.width - cam.cx) / cam.fx + 0.3 * cam.tan_fovx
    lim_x_neg = cam.cx / cam.fx + 0.3 * cam.tan_fovx
    lim_y_pos = (cam.height - cam.cy) / cam.fy + 0.3 * cam.tan_fovy
    lim_y_neg = cam.cy / cam.fy + 0.3 * cam.tan_fovy
    tx = torch.clamp(txtz, -lim_x_neg, lim_x_pos) * tz
    ty = torch.clamp(tytz, -lim_y_neg, lim_y_pos) * tz

    fx, fy = cam.fx, cam.fy
    W = cam.w2c[:3, :3]
    a0 = fx / tz
    a2 = -fx * tx / (tz * tz)
    b1 = fy / tz
    b2 = -fy * ty / (tz * tz)
    t0x = a0 * W[0, 0] + a2 * W[2, 0]
    t0y = a0 * W[0, 1] + a2 * W[2, 1]
    t0z = a0 * W[0, 2] + a2 * W[2, 2]
    t1x = b1 * W[1, 0] + b2 * W[2, 0]
    t1y = b1 * W[1, 1] + b2 * W[2, 1]
    t1z = b1 * W[1, 2] + b2 * W[2, 2]

    vxx, vxy, vxz, vyy, vyz, vzz = cov6

    def quad(ux, uy, uz, vx, vy, vz):
        return (ux * vx * vxx + uy * vy * vyy + uz * vz * vzz
                + (ux * vy + uy * vx) * vxy
                + (ux * vz + uz * vx) * vxz
                + (uy * vz + uz * vy) * vyz)

    cxx = quad(t0x, t0y, t0z, t0x, t0y, t0z) + COV2D_BLUR
    cxy = quad(t0x, t0y, t0z, t1x, t1y, t1z)
    cyy = quad(t1x, t1y, t1z, t1x, t1y, t1z) + COV2D_BLUR
    return cxx, cxy, cyy


def ndc2pix(v, size):
    """NDC in [-1, 1] -> continuous pixel coordinate."""
    return ((v + 1.0) * size - 1.0) * 0.5


def project(means3d: torch.Tensor,
            scales: Optional[torch.Tensor],
            rotations: Optional[torch.Tensor],
            cam: Camera,
            scale_modifier: float = 1.0,
            cov3d_precomp: Optional[torch.Tensor] = None,
            mean2d_probe_ndc: Optional[torch.Tensor] = None) -> Projected:
    """Project (N, 3) gaussians to screen space.

    `cov3d_precomp` (N, 6) packed covariance overrides scales/rotations.
    `mean2d_probe_ndc` (N, 2), zeros, is added to the NDC position before
    the pixel mapping: its gradient is the densification statistic, in NDC
    units as the CUDA original accumulates it.
    `valid` combines the near cull (z > near), the positive-determinant cull
    and the zero-extent cull (3-sigma rect misses the image).
    """
    M = cam.full_proj
    mx, my, mz = means3d.unbind(-1)
    px_hom = M[0, 0] * mx + M[0, 1] * my + M[0, 2] * mz + M[0, 3]
    py_hom = M[1, 0] * mx + M[1, 1] * my + M[1, 2] * mz + M[1, 3]
    p_w_hom = M[3, 0] * mx + M[3, 1] * my + M[3, 2] * mz + M[3, 3]
    inv_w = 1.0 / (p_w_hom + 1e-7)
    ndc_x = px_hom * inv_w
    ndc_y = py_hom * inv_w
    if mean2d_probe_ndc is not None:
        ndc_x = ndc_x + mean2d_probe_ndc[..., 0]
        ndc_y = ndc_y + mean2d_probe_ndc[..., 1]
    x2d = ndc2pix(ndc_x, cam.width)
    y2d = ndc2pix(ndc_y, cam.height)

    V = cam.w2c
    depth = V[2, 0] * mx + V[2, 1] * my + V[2, 2] * mz + V[2, 3]
    in_front = depth > cam.near

    if cov3d_precomp is not None:
        cov6 = tuple(cov3d_precomp[..., i] for i in range(6))
    else:
        cov6 = _cov3d_components(scales, rotations, scale_modifier)
    cxx, cxy, cyy = _ewa_cov2d(mx, my, mz, cov6, cam)
    det = cxx * cyy - cxy * cxy
    det_ok = det > 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = 1.0 / safe_det
    conic_a = cyy * inv_det
    conic_b = -cxy * inv_det
    conic_c = cxx * inv_det

    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=EIG_GUARD))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
    valid = in_front & det_ok
    radius = torch.where(valid, radius_f,
                         torch.zeros_like(radius_f)).to(torch.int32)

    on_screen = ((x2d + radius_f >= 0)
                 & (x2d - radius_f <= cam.width - 1)
                 & (y2d + radius_f >= 0)
                 & (y2d - radius_f <= cam.height - 1))
    valid = valid & on_screen & (radius > 0)
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return Projected(x2d=x2d, y2d=y2d, conic_a=conic_a, conic_b=conic_b,
                     conic_c=conic_c, depth=depth, radius=radius, valid=valid)


def tile_rect(proj: Projected, tile_h: int, tile_w: int, grid_h: int,
              grid_w: int):
    """Per-gaussian tile rectangle (max side exclusive, clamped to the grid)
    and touched-tile count: flat int32 (tx0, ty0, tx1, ty1, count)."""
    r = proj.radius.to(torch.float32)
    x, y = proj.x2d, proj.y2d
    i32 = torch.int32
    tx0 = torch.clamp(torch.floor((x - r) / tile_w), 0, grid_w).to(i32)
    ty0 = torch.clamp(torch.floor((y - r) / tile_h), 0, grid_h).to(i32)
    tx1 = torch.clamp(torch.floor((x + r) / tile_w) + 1, 0, grid_w).to(i32)
    ty1 = torch.clamp(torch.floor((y + r) / tile_h) + 1, 0, grid_h).to(i32)
    count = torch.where(proj.valid, (tx1 - tx0) * (ty1 - ty0),
                        torch.zeros_like(tx0))
    return tx0, ty0, tx1, ty1, count
