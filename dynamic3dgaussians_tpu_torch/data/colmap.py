"""COLMAP and Blender-synthetic scene readers.

Port of `dynamic3dgaussians_tpu/data/colmap.py` (NumPy only; the port keeps
its own copy):

  * cameras.bin / images.bin / points3D.bin parsers, with the .txt
    fallbacks, and `convert_bin_to_txt`
  * the transforms_{split}.json (Blender) reader
  * SceneInfo with the nerf++ scene radius (`nerfpp_norm`)
  * the per-image semantic-feature sidecar (.npy next to the image)

Parsing is byte for byte the reference's, including the quaternion (wxyz)
to world-to-camera convention of `ColmapImage.w2c`.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from dynamic3dgaussians_tpu_torch.utils.pose_utils import (matrix_from_quat,
                                                           quat_from_matrix)

# COLMAP camera model id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class ColmapCamera:
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def intrinsics(self) -> np.ndarray:
        if self.model == "SIMPLE_PINHOLE" or self.model == "SIMPLE_RADIAL":
            f, cx, cy = self.params[:3]
            fx = fy = f
        else:  # PINHOLE / OPENCV family: fx fy cx cy leading
            fx, fy, cx, cy = self.params[:4]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


@dataclass
class ColmapImage:
    name: str
    camera_id: int
    qvec: np.ndarray   # wxyz
    tvec: np.ndarray

    @property
    def w2c(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = matrix_from_quat(self.qvec)
        m[:3, 3] = self.tvec
        return m


@dataclass
class SceneInfo:
    cameras: Dict[int, ColmapCamera]
    images: List[ColmapImage]
    points: np.ndarray       # (N, 3)
    point_colors: np.ndarray  # (N, 3) in [0, 1]
    nerf_norm_radius: float = 1.0
    nerf_norm_center: np.ndarray = field(
        default_factory=lambda: np.zeros(3))


def _read(fh, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fh.read(size))


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = ColmapCamera(name, int(w), int(h), params)
    return cams


def read_images_bin(path: str) -> List[ColmapImage]:
    images = []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            _img_id, qw, qx, qy, qz, tx, ty, tz, cam_id = _read(f, "<idddddddi")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.read(24 * n_pts)  # skip the 2D points (x, y, point3D_id)
            images.append(ColmapImage(name.decode(), cam_id,
                                      np.array([qw, qx, qy, qz]),
                                      np.array([tx, ty, tz])))
    return sorted(images, key=lambda im: im.name)


def read_points3d_bin(path: str):
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3))
        for i in range(n):
            _pid, x, y, z, r, g, b, _err = _read(f, "<QdddBBBd")
            xyz[i] = (x, y, z)
            rgb[i] = (r, g, b)
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
    return xyz, rgb / 255.0


def read_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    for line in open(path):
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split()
        cams[int(parts[0])] = ColmapCamera(
            parts[1], int(parts[2]), int(parts[3]),
            np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_txt(path: str) -> List[ColmapImage]:
    images = []
    lines = [l for l in open(path)
             if not l.startswith("#") and l.strip()]
    for meta in lines[0::2]:
        p = meta.split()
        images.append(ColmapImage(
            p[9], int(p[8]),
            np.array([float(x) for x in p[1:5]]),
            np.array([float(x) for x in p[5:8]])))
    return sorted(images, key=lambda im: im.name)


def read_points3d_txt(path: str):
    xyz, rgb = [], []
    for line in open(path):
        if line.startswith("#") or not line.strip():
            continue
        p = line.split()
        xyz.append([float(x) for x in p[1:4]])
        rgb.append([float(x) for x in p[4:7]])
    return np.asarray(xyz), np.asarray(rgb) / 255.0


def nerfpp_norm(w2c_list: List[np.ndarray]):
    """Scene centre and radius from the camera centres: 1.1 x the largest
    distance of a centre from their mean."""
    centers = np.stack([np.linalg.inv(m)[:3, 3] for m in w2c_list])
    center = centers.mean(0)
    radius = 1.1 * float(np.max(np.linalg.norm(centers - center, axis=-1)))
    return center, radius


def read_colmap_scene(root: str, sparse_dir: str = "sparse/0") -> SceneInfo:
    base = os.path.join(root, sparse_dir)
    if os.path.exists(os.path.join(base, "cameras.bin")):
        cams = read_cameras_bin(os.path.join(base, "cameras.bin"))
        images = read_images_bin(os.path.join(base, "images.bin"))
        xyz, rgb = read_points3d_bin(os.path.join(base, "points3D.bin"))
    else:
        cams = read_cameras_txt(os.path.join(base, "cameras.txt"))
        images = read_images_txt(os.path.join(base, "images.txt"))
        xyz, rgb = read_points3d_txt(os.path.join(base, "points3D.txt"))
    center, radius = nerfpp_norm([im.w2c for im in images])
    return SceneInfo(cams, images, xyz, rgb, radius, center)


def read_blender_scene(root: str, split: str = "train",
                       white_background: bool = False) -> SceneInfo:
    """transforms_{split}.json reader; the initial cloud is 100,000 random
    points in [-1.3, 1.3]^3 (seed 0)."""
    with open(os.path.join(root, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    fovx = meta["camera_angle_x"]
    images, cams = [], {}
    for i, frame in enumerate(meta["frames"]):
        c2w = np.array(frame["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1  # blender -> colmap camera convention
        w2c = np.linalg.inv(c2w)
        images.append(ColmapImage(
            frame["file_path"], i, quat_from_matrix(w2c[:3, :3]),
            w2c[:3, 3]))
        # the resolution is the consumer's to read; 800 unless stated
        w = h = int(meta.get("w", meta.get("h", 800)))
        f_len = 0.5 * w / np.tan(0.5 * fovx)
        cams[i] = ColmapCamera("PINHOLE", w, h,
                               np.array([f_len, f_len, w / 2, h / 2]))
    center, radius = nerfpp_norm([im.w2c for im in images])
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1.3, 1.3, (100_000, 3))
    cols = rng.uniform(0, 1, (100_000, 3))
    return SceneInfo(cams, images, pts, cols, radius, center)


def load_semantic_sidecar(image_path: str) -> Optional[np.ndarray]:
    """The per-image semantic feature map saved next to the image as .npy,
    or None."""
    p = os.path.splitext(image_path)[0] + ".npy"
    return np.load(p) if os.path.exists(p) else None


def convert_bin_to_txt(sparse_dir: str, out_dir: str = None) -> str:
    """COLMAP binary model -> text model.

    Writes cameras.txt / images.txt / points3D.txt next to (or instead of)
    the .bin files in COLMAP's documented text format.
    """
    out_dir = out_dir or sparse_dir
    os.makedirs(out_dir, exist_ok=True)
    cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
    imgs = read_images_bin(os.path.join(sparse_dir, "images.bin"))
    xyz, rgb = read_points3d_bin(os.path.join(sparse_dir, "points3D.bin"))
    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for cid, c in cams.items():
            params = " ".join(repr(float(p)) for p in c.params)
            f.write(f"{cid} {c.model} {c.width} {c.height} {params}\n")
    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID "
                "NAME\n#   (2D points omitted)\n")
        for iid, im in enumerate(imgs, start=1):
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{iid} {q} {t} {im.camera_id} {im.name}\n\n")
    rgb255 = np.clip(rgb * 255.0, 0, 255).astype(np.int64)
    with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR (TRACK[] "
                "omitted)\n")
        for i in range(xyz.shape[0]):
            f.write(f"{i + 1} {float(xyz[i, 0])!r} {float(xyz[i, 1])!r} {float(xyz[i, 2])!r} "
                    f"{rgb255[i, 0]} {rgb255[i, 1]} {rgb255[i, 2]} 0.0\n")
    return out_dir
