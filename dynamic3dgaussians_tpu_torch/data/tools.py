"""Dataset tooling: frame folder -> video, npz / meta inspection, mask checks.

Port of `dynamic3dgaussians_tpu/data/tools.py` (numpy and PIL, the same
functions and outputs):

  * `frames_to_video`: an image folder to an mp4 through imageio, or to an
    animated GIF through PIL where imageio cannot write the file
  * `inspect_npz` / `inspect_meta`: shape, dtype and range reports of
    checkpoints and train_meta.json
  * `verify_masks`: masks laid over frames, with coverage statistics
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np


def frames_to_video(frame_dir: str, out_path: str, fps: int = 30,
                    pattern: str = "", limit: Optional[int] = None) -> str:
    """Encode an image folder into a video/GIF (data_ego/to_videos.py).

    Uses imageio when available (mp4 via ffmpeg plugin); falls back to an
    animated GIF via PIL for environments without ffmpeg.
    """
    from PIL import Image

    names = sorted(f for f in os.listdir(frame_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg"))
                   and pattern in f)
    if limit:
        names = names[:limit]
    assert names, f"no frames matching '{pattern}' in {frame_dir}"
    frames = [np.asarray(Image.open(os.path.join(frame_dir, n)))
              for n in names]
    try:
        import imageio.v2 as imageio
        imageio.mimwrite(out_path, frames, fps=fps)
    except Exception:
        if not out_path.endswith(".gif"):
            out_path = os.path.splitext(out_path)[0] + ".gif"
        ims = [Image.fromarray(f) for f in frames]
        ims[0].save(out_path, save_all=True, append_images=ims[1:],
                    duration=int(1000 / fps), loop=0)
    return out_path


def inspect_npz(path: str) -> Dict[str, Dict]:
    """Shape/dtype/range report of an npz checkpoint (data_ego/inspect.py)."""
    data = np.load(path, allow_pickle=True)
    report = {}
    for k in data.files:
        v = data[k]
        entry = {"shape": tuple(v.shape), "dtype": str(v.dtype)}
        if np.issubdtype(v.dtype, np.number) and v.size:
            entry.update(min=float(v.min()), max=float(v.max()),
                         mean=float(v.mean()))
        report[k] = entry
    return report


def inspect_meta(data_root: str, seq: str) -> Dict:
    """Summary of a train_meta.json (data_ego/insp_data.py)."""
    with open(os.path.join(data_root, seq, "train_meta.json")) as f:
        md = json.load(f)
    t = len(md["fn"])
    cams = len(md["fn"][0]) if t else 0
    return {"timesteps": t, "cameras_per_timestep": cams,
            "image_hw": (md.get("h"), md.get("w")),
            "keys": sorted(md.keys()),
            "first_frames": md["fn"][0][:4] if t else []}


def verify_masks(frames: List[np.ndarray], masks: List[np.ndarray],
                 out_dir: Optional[str] = None, color=(255, 0, 0),
                 alpha: float = 0.45) -> Dict:
    """Overlay masks on frames; report coverage stats (mask_verify.py).

    Returns {mean_coverage, min_coverage, max_coverage, n}; optionally writes
    overlay PNGs to out_dir.
    """
    from PIL import Image

    covs = []
    for i, (fr, mk) in enumerate(zip(frames, masks)):
        m = np.asarray(mk, np.float32)
        if m.ndim == 3:
            m = m[..., 0]
        m = (m > 0.5).astype(np.float32)
        covs.append(float(m.mean()))
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            img = np.asarray(fr, np.float32).copy()
            if img.max() <= 1.0:
                img = img * 255
            over = img * (1 - alpha * m[..., None]) + \
                np.asarray(color, np.float32) * alpha * m[..., None]
            Image.fromarray(over.astype(np.uint8)).save(
                os.path.join(out_dir, f"overlay_{i:05d}.png"))
    return {"mean_coverage": float(np.mean(covs)) if covs else 0.0,
            "min_coverage": float(np.min(covs)) if covs else 0.0,
            "max_coverage": float(np.max(covs)) if covs else 0.0,
            "n": len(covs)}
