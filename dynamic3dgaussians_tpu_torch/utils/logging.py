"""Run logging: JSONL scalars, image dumps, seeding, timers, traces.

Port of `dynamic3dgaussians_tpu/utils/logging.py`. Scalars go to
`<out_dir>/metrics.jsonl` (one JSON object per call), images to PNGs; a
wandb run is attached only when asked for and the package is importable.
`Throughput` counts rays/s and gaussians/s, `phase_timer` times a block
(waiting for the device of a tensor when given one), and
`start_profiler_trace` / `stop_profiler_trace` wrap `torch.profiler`.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Dict, Optional, Union

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


class Throughput:
    """Rays/s and gaussians/s counters over the time since `reset`."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._iters = 0
        self._rays = 0
        self._gaussians = 0

    def update(self, n_pixels: int, n_gaussians: int, iters: int = 1):
        self._iters += iters
        self._rays += n_pixels * iters
        self._gaussians += n_gaussians * iters

    def rates(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {"iters_per_s": self._iters / dt,
                "rays_per_s": self._rays / dt,
                "gaussians_per_s": self._gaussians / dt}


def _sync(tree) -> None:
    """Wait for the devices of every CUDA tensor in `tree` (a tensor, or a
    dict, list or tuple of them)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _sync(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _sync(v)


class phase_timer:
    """Context-manager wall timer. With `sync` (a tensor, or a dict, list
    or tuple of them) it waits on exit for the device that computes them,
    so that the time covers the device's work; `log[name]` gets the
    seconds."""

    def __init__(self, name: str, sync=None, log: Optional[Dict] = None):
        self.name, self.sync, self.log = name, sync, log

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            _sync(self.sync)
        self.dt = time.perf_counter() - self.t0
        if self.log is not None:
            self.log[self.name] = self.dt


def start_profiler_trace(log_dir: Union[str, os.PathLike]):
    """Start a `torch.profiler` trace of the host and, where there is one,
    the CUDA device; returns the profiler, which `stop_profiler_trace`
    stops and writes as a Chrome trace JSON under `log_dir` (view it in
    Perfetto or chrome://tracing). Unlike the reference's process-wide JAX
    trace, the caller holds the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(
            os.fspath(log_dir)))
    prof.start()
    return prof


def stop_profiler_trace(prof) -> None:
    prof.stop()
