"""Reader of the Dynamic3DGaussians on-disk data layout.

Port of `dynamic3dgaussians_tpu/data/dataset.py` (the synchronous reader;
the native prefetching loader is not ported yet):

  <root>/<seq>/train_meta.json     md["fn"|"hw"|"k"|"w2c"][t][c]
  <root>/<seq>/ims/<fn>            RGB jpg/png
  <root>/<seq>/seg/<fn .png>       grayscale {0,1} dynamic mask
  <root>/<seq>/init_pt_cld.npz     {"data": (N, 7) [xyz rgb seg]}
  optional <root>/<seq>/depth/<c>/depth_<t>.npz  {"depth_map": (H, W)}

Images load per timestep as channels-last float32 in [0, 1], on the device
the caller names (default `cuda`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.ops.camera import make_camera


def _load_image(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as img:
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
                  device: DeviceLike = None) -> List[Dict]:
    """The trainer's camera datapoints of timestep t, on `device`.

    `loader` is the reference's native prefetcher, not ported: only None
    is accepted.
    """
    if loader is not None:
        raise NotImplementedError("the native prefetching loader is not "
                                  "ported yet; pass loader=None")
    dev = resolve_device(device)
    frames = []
    cam_ids = cameras if cameras is not None else range(len(md["fn"][t]))
    for c in cam_ids:
        h, w = md["hw"][c]
        k = np.asarray(md["k"][t][c], np.float64)
        w2c = np.asarray(md["w2c"][t][c], np.float64)
        fn = md["fn"][t][c]
        im = _load_image(os.path.join(root, seq, "ims", fn))
        seg = _load_image(os.path.join(root, seq, "seg",
                                       fn.replace(".jpg", ".png")))
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
