"""Evaluation of trained sequences against their images.

Port of `dynamic3dgaussians_tpu/eval/suite.py`: `evaluate_sequence` renders
every (timestep, camera) view of one trained sequence through
`render_frame` (on the card, the forward tile kernel; one launch per view)
with `RasterConfig(depth_mode="exact")`, so the float32 view depth rides in
the record table instead of the depth bucket of the fused sort key, and
scores it with PSNR and SSIM (and depth abs-rel through a point-cloud
reprojection where the sequence has ground-truth depth). `evaluate_suite`
does the same for many (seq, params.npz) pairs and aggregates, as `cli
evaluate` and `cli evaluate-suite` print them.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.data import dataset as D
from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.eval import metrics as M
from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig
from dynamic3dgaussians_tpu_torch.viz.export import load_params
from dynamic3dgaussians_tpu_torch.viz.render import params_at_t, render_frame

# metric renders keep the exact float32 depth of each record
EVAL_RASTER = RasterConfig(depth_mode="exact")


def evaluate_sequence(stacked: Dict, data_root: str, seq: str,
                      max_timesteps: int = 10, max_cams: int = 4,
                      device: DeviceLike = None) -> Tuple[Dict, List[Dict]]:
    """Render-against-image metrics of one trained sequence, on `device`
    (default `cuda`).

    Returns (summary, rows): the summary holds the mean psnr and ssim
    (and depth_abs_rel where ground-truth depth exists) and n_views; each
    row the values of one (t, cam).
    """
    dev = resolve_device(device)
    md = D.load_meta(data_root, seq)
    num_t = stacked["means3D"].shape[0] if stacked["means3D"].ndim == 3 else 1
    rows: List[Dict] = []
    for t in range(min(num_t, max_timesteps)):
        frames = D.load_timestep(data_root, seq, md, t, device=dev)
        params_t = params_at_t(stacked, t)
        for f in frames[:max_cams]:
            out = render_frame(params_t, f["camera"], config=EVAL_RASTER,
                               device=dev)
            rgb = torch.clamp(out.rgb, 0, 1)
            row = {"t": t, "cam": int(f["cam_id"]),
                   "psnr": float(M.masked_psnr(rgb, f["im"])),
                   "ssim": float(M.masked_ssim(rgb, f["im"]))}
            if "gt_depth" in f:
                cam = f["camera"]
                k = torch.tensor([[float(cam.fx), 0, float(cam.cx)],
                                  [0, float(cam.fy), float(cam.cy)],
                                  [0, 0, 1]], dtype=torch.float32,
                                 device=dev)
                d = out.depth / torch.clamp(out.alpha, min=1e-6)
                row["depth_abs_rel"] = float(M.depth_abs_rel_reprojected(
                    d, f["gt_depth"], k))
            rows.append(row)
    summary: Dict = {
        "psnr": float(np.mean([r["psnr"] for r in rows])),
        "ssim": float(np.mean([r["ssim"] for r in rows])),
        "n_views": len(rows),
    }
    d_rows = [r["depth_abs_rel"] for r in rows if "depth_abs_rel" in r]
    if d_rows:
        summary["depth_abs_rel"] = float(np.mean(d_rows))
    return summary, rows


def evaluate_suite(pairs: List[Tuple[str, str]], data_root: str,
                   max_timesteps: int = 10, max_cams: int = 4,
                   out_path: Optional[str] = None,
                   device: DeviceLike = None) -> Dict:
    """Evaluate many (seq, params_path) pairs and aggregate.

    Returns {"scenes": {seq: summary}, "mean": {...}}; a sequence named
    twice gets the keys seq, seq#2, ... (with its params_path in the
    summary). `out_path` also receives the rows of every view.
    """
    dev = resolve_device(device)
    scenes: Dict[str, Dict] = {}
    all_rows: Dict[str, List[Dict]] = {}
    for seq, params_path in pairs:
        stacked = load_params(params_path)
        summary, rows = evaluate_sequence(stacked, data_root, seq,
                                          max_timesteps, max_cams,
                                          device=dev)
        key_name, dup = seq, 2
        while key_name in scenes:
            key_name = f"{seq}#{dup}"
            dup += 1
        if key_name != seq:
            summary = dict(summary, params_path=params_path)
        scenes[key_name] = summary
        all_rows[key_name] = rows
    mean = {}
    for key in ("psnr", "ssim", "depth_abs_rel"):
        vals = [s[key] for s in scenes.values() if key in s]
        if vals:
            mean[key] = float(np.mean(vals))
    result = {"scenes": scenes, "mean": mean}
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"scenes": scenes, "mean": mean,
                       "rows": all_rows}, f, indent=2)
    return result
