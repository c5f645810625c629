"""Run logging: JSONL scalars, image dumps, seeding.

Port of `safe_state` and `RunLogger` of
`dynamic3dgaussians_tpu/utils/logging.py`. Scalars go to
`<out_dir>/metrics.jsonl` (one JSON object per call), images to PNGs; a
wandb run is attached only when asked for and the package is importable.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Dict, Optional

import numpy as np
import torch


def safe_state(seed: int = 0) -> None:
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class RunLogger:
    """JSONL scalar logging, optional image dumps, optional wandb."""

    def __init__(self, out_dir: str, use_wandb: bool = False,
                 project: str = "dynamic3dgaussians_tpu",
                 run_name: Optional[str] = None):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._f = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project=project, name=run_name,
                                         dir=out_dir)
            except Exception:
                self._wandb = None

    def log(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        row = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            row[(prefix + k) if prefix else k] = float(v)
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(row, step=step)

    def log_image(self, step: int, name: str, img) -> str:
        from PIL import Image
        if isinstance(img, torch.Tensor):
            img = img.detach().cpu().numpy()
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        path = os.path.join(self.out_dir, f"{name}_{step:07d}.png")
        Image.fromarray(arr).save(path)
        return path

    def close(self):
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
