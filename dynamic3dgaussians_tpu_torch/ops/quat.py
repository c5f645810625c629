"""Quaternion helpers, (w, x, y, z) on the last axis.

Port of `dynamic3dgaussians_tpu/ops/quat.py` (the subset the render path
needs).
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
