"""Reader of the Dynamic3DGaussians on-disk data layout.

Port of `dynamic3dgaussians_tpu/data/dataset.py`, with the native
prefetching loader (`native.FileLoader`) as an option:

  <root>/<seq>/train_meta.json     md["fn"|"hw"|"k"|"w2c"][t][c]
  <root>/<seq>/ims/<fn>            RGB jpg/png
  <root>/<seq>/seg/<fn .png>       grayscale {0,1} dynamic mask
  <root>/<seq>/init_pt_cld.npz     {"data": (N, 7) [xyz rgb seg]}
  optional <root>/<seq>/depth/<c>/depth_<t>.npz  {"depth_map": (H, W)}

Images load per timestep as channels-last float32 in [0, 1], on the device
the caller names (default `cuda`).
"""

from __future__ import annotations

import io
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.ops.camera import make_camera


def _load_image(path: str, loader=None) -> np.ndarray:
    """An image as float32 in [0, 1]; its bytes from `loader` when given."""
    from PIL import Image
    src = io.BytesIO(loader.take(path)) if loader is not None else path
    with Image.open(src) as img:
        return np.asarray(img, dtype=np.float32) / 255.0


def timestep_paths(root: str, seq: str, md: Dict, t: int) -> List[str]:
    """Every file load_timestep(t) reads."""
    paths = []
    for c in range(len(md["fn"][t])):
        fn = md["fn"][t][c]
        paths.append(os.path.join(root, seq, "ims", fn))
        paths.append(os.path.join(root, seq, "seg",
                                  fn.replace(".jpg", ".png")))
    return paths


def load_meta(root: str, seq: str) -> Dict:
    with open(os.path.join(root, seq, "train_meta.json")) as f:
        return json.load(f)


def load_init_point_cloud(root: str, seq: str,
                          filename: str = "init_pt_cld.npz") -> np.ndarray:
    return np.load(os.path.join(root, seq, filename))["data"]


def load_timestep(root: str, seq: str, md: Dict, t: int,
                  cameras: Optional[List[int]] = None,
                  load_depth: bool = False, loader=None,
                  prefetch_next: bool = False,
                  device: DeviceLike = None) -> List[Dict]:
    """The trainer's camera datapoints of timestep t, on `device`.

    `loader`: optional `native.FileLoader`; the image bytes come from its
    background threads. With `prefetch_next`, timestep t + 1's files are
    queued before t's are decoded, so the disk reads of t + 1 overlap the
    training steps of t.
    """
    dev = resolve_device(device)
    if loader is not None and prefetch_next and t + 1 < len(md["fn"]):
        loader.prefetch(timestep_paths(root, seq, md, t + 1))
    frames = []
    cam_ids = cameras if cameras is not None else range(len(md["fn"][t]))
    for c in cam_ids:
        h, w = md["hw"][c]
        k = np.asarray(md["k"][t][c], np.float64)
        w2c = np.asarray(md["w2c"][t][c], np.float64)
        fn = md["fn"][t][c]
        im = _load_image(os.path.join(root, seq, "ims", fn), loader)
        seg = _load_image(os.path.join(root, seq, "seg",
                                       fn.replace(".jpg", ".png")), loader)
        if seg.ndim == 3:
            seg = seg[..., 0]
        seg = (seg > 0.5).astype(np.float32)
        seg_col = np.stack([seg, np.zeros_like(seg), 1.0 - seg], axis=-1)
        frame = {
            "camera": make_camera(w, h, k, w2c, near=0.01, far=100.0,
                                  device=dev),
            "im": torch.as_tensor(np.ascontiguousarray(im[..., :3]),
                                  device=dev),
            "seg": torch.as_tensor(seg_col, device=dev),
            "cam_id": int(c),
        }
        if load_depth:
            dpath = os.path.join(root, seq, "depth", str(int(c)),
                                 f"depth_{t}.npz")
            if os.path.exists(dpath):
                frame["gt_depth"] = torch.as_tensor(
                    np.load(dpath)["depth_map"].astype(np.float32),
                    device=dev)
        frames.append(frame)
    return frames


def scene_w2c_stack(md: Dict, t: int = 0) -> np.ndarray:
    """(C, 4, 4) extrinsics at timestep t (the scene-radius estimate)."""
    return np.asarray(md["w2c"][t], np.float64)
