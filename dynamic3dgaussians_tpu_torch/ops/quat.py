"""Quaternion helpers, (w, x, y, z) on the last axis.

Port of `dynamic3dgaussians_tpu/ops/quat.py`: the render path's helpers,
`rotate`, and the rotation forms of the motion bases (6D continuous <->
matrix, matrix -> quaternion).
"""

from __future__ import annotations

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along the last axis; finite at q == 0 (padding rows)."""
    sumsq = torch.sum(q * q, dim=-1, keepdim=True)
    return q * torch.rsqrt(torch.clamp(sumsq, min=eps * eps))


def quat_mult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (..., 4) wxyz quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate (inverse rotation for unit quaternions)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_to_rotmat(q: torch.Tensor, normalized: bool = False) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    if not normalized:
        q = normalize(q)
    r, x, y, z = q.unbind(-1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                        2 * (x * z + r * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - r * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                        1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by (..., 4) wxyz quaternions, through
    `quat_to_rotmat` (which normalises q). The product is elementwise, so
    it is float32 on the card whatever the TF32 setting."""
    R = quat_to_rotmat(q)
    return torch.sum(R * v[..., None, :], dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    # finite in value and gradient at v == 0 (capacity-padding rows, whose
    # blended 6D vector is 0): rsqrt of a clamped sum of squares, where
    # norm-then-divide would backprop sqrt'(0) = inf
    sumsq = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp(sumsq, min=1e-24))


def cont_6d_to_rotmat(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) continuous rotation representation -> (..., 3, 3) rotation
    matrix: Gram-Schmidt on the two column vectors (Zhou et al., CVPR'19)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = _unit(a1)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = _unit(a2p)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_cont_6d(R: torch.Tensor) -> torch.Tensor:
    """Inverse of cont_6d_to_rotmat: the first two columns."""
    return torch.cat([R[..., :, 0], R[..., :, 1]], dim=-1)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz unit quaternion.

    The reference's branch-free Shepperd form: the four diagonal-dominance
    candidates, the one of largest trace term picked by argmax (the first
    on ties), so the sign of the result is the reference's.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    sw = safe_sqrt(tw) * 2
    sx = safe_sqrt(tx) * 2
    sy = safe_sqrt(ty) * 2
    sz = safe_sqrt(tz) * 2
    qw = torch.stack([0.25 * sw, (m21 - m12) / sw,
                      (m02 - m20) / sw, (m10 - m01) / sw], dim=-1)
    qx = torch.stack([(m21 - m12) / sx, 0.25 * sx,
                      (m01 + m10) / sx, (m02 + m20) / sx], dim=-1)
    qy = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy,
                      0.25 * sy, (m12 + m21) / sy], dim=-1)
    qz = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz,
                      (m12 + m21) / sz, 0.25 * sz], dim=-1)
    best = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1),
                        dim=-1)[..., None]
    q = torch.where(best == 0, qw,
                    torch.where(best == 1, qx,
                                torch.where(best == 2, qy, qz)))
    return normalize(q)
