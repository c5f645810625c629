"""Camera paths: slerp interpolation, spiral and spherified orbits.

Port of `dynamic3dgaussians_tpu/utils/pose_utils.py`. The pose arithmetic
is NumPy on the host (float64); each path is a list of the port's
`Camera`s on the device of the camera it starts from.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dynamic3dgaussians_tpu_torch.ops.camera import Camera, make_camera


def quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion (numerically safe branches)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = np.argmax(np.diag(R))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def matrix_from_quat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def _w2c(cam: Camera) -> np.ndarray:
    return cam.w2c.detach().cpu().numpy()


def _intrinsics(cam: Camera) -> np.ndarray:
    return np.array([[float(cam.fx), 0, float(cam.cx)],
                     [0, float(cam.fy), float(cam.cy)], [0, 0, 1]])


def _camera_like(base: Camera, c2w: np.ndarray, k: np.ndarray) -> Camera:
    return make_camera(base.width, base.height, k, np.linalg.inv(c2w),
                       base.near, base.far, device=base.device)


def interpolate_cameras(cam0: Camera, cam1: Camera, n: int) -> List[Camera]:
    """n cameras from cam0 to cam1: slerp of the rotation, lerp of the
    centre, cam0's intrinsics."""
    c2w0, c2w1 = np.linalg.inv(_w2c(cam0)), np.linalg.inv(_w2c(cam1))
    q0, q1 = quat_from_matrix(c2w0[:3, :3]), quat_from_matrix(c2w1[:3, :3])
    k = _intrinsics(cam0)
    cams = []
    for i in range(n):
        t = i / max(n - 1, 1)
        c2w = np.eye(4)
        c2w[:3, :3] = matrix_from_quat(slerp(q0, q1, t))
        c2w[:3, 3] = (1 - t) * c2w0[:3, 3] + t * c2w1[:3, 3]
        cams.append(_camera_like(cam0, c2w, k))
    return cams


def spiral_path(base_cam: Camera, n: int = 120, rads=(0.3, 0.3, 0.1),
                zrate: float = 0.5, rots: int = 2) -> List[Camera]:
    """LLFF-style spiral of n cameras around a base camera."""
    c2w = np.linalg.inv(_w2c(base_cam))
    k = _intrinsics(base_cam)
    cams = []
    rads = np.asarray(list(rads) + [1.0])
    focal = float(base_cam.fx)
    for theta in np.linspace(0, 2 * np.pi * rots, n + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * zrate), 1.0]) * rads)
        z = c - c2w[:3, :4] @ np.array([0, 0, -focal * 0.05, 1.0])
        z = z / np.linalg.norm(z)
        up = c2w[:3, 1]
        x = np.cross(up, z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        new_c2w = np.eye(4)
        new_c2w[:3, 0], new_c2w[:3, 1], new_c2w[:3, 2], new_c2w[:3, 3] = \
            x, y, z, c
        cams.append(_camera_like(base_cam, new_c2w, k))
    return cams


def spherify_path(cams: List[Camera], n: int = 120) -> List[Camera]:
    """n cameras on the sphere through the input camera centres, looking
    at its centre, at the inputs' mean elevation."""
    c2ws = [np.linalg.inv(_w2c(c)) for c in cams]
    centers = np.stack([m[:3, 3] for m in c2ws])
    center = centers.mean(0)
    radius = max(float(np.linalg.norm(centers - center, axis=-1).mean()),
                 1e-6)
    up = -np.stack([m[:3, 1] for m in c2ws]).mean(0)
    up = up / np.linalg.norm(up)
    elev = float(np.mean((centers - center) @ up) / radius)
    base = cams[0]
    k = _intrinsics(base)
    # orthonormal frame around `up`
    a = np.array([1.0, 0, 0])
    if abs(a @ up) > 0.9:
        a = np.array([0, 0, 1.0])
    u = np.cross(up, a)
    u /= np.linalg.norm(u)
    v = np.cross(up, u)
    out = []
    for th in np.linspace(0, 2 * np.pi, n + 1)[:-1]:
        pos = center + radius * (np.cos(th) * u + np.sin(th) * v
                                 + elev * up)
        z = center - pos
        z = z / np.linalg.norm(z)
        x = np.cross(-up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, pos
        out.append(_camera_like(base, c2w, k))
    return out
