"""Stacked `params.npz` checkpoints (numpy on the host).

Port of `save_params` / `load_params` of
`dynamic3dgaussians_tpu/viz/export.py`, same file layout: keys present at
every timestep are stacked along a leading T axis, keys of the first
timestep only are stored unstacked.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def save_params(output_params: List[Dict[str, np.ndarray]], out_dir: str,
                filename: str = "params") -> str:
    """Stack per-timestep parameter dicts into `<out_dir>/<filename>.npz`."""
    to_save = {}
    later_keys = set(output_params[1].keys()) if len(output_params) > 1 \
        else set(output_params[0].keys())
    for k in output_params[0].keys():
        if k in later_keys:
            to_save[k] = np.stack([np.asarray(p[k]) for p in output_params])
        else:
            to_save[k] = np.asarray(output_params[0][k])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    np.savez(path, **to_save)
    return path + ".npz"


def load_params(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
