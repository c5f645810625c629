"""Run logging: JSONL scalars, image dumps, seeding, timers, traces.

Port of `dynamic3dgaussians_tpu/utils/logging.py`. Scalars go to
`<out_dir>/metrics.jsonl` (one JSON object per call), images to PNGs; a
wandb run is attached only when asked for and the package is importable.
`phase_timer` times a block (waiting for the device of a tensor when given
one).

Tracing, off by default and switched process-wide by `set_tracing`: `span`
opens a host span (a `torch.profiler.record_function` range, on the
profiler's clock), `mark` marks where a phase of the train step begins on
the device's timeline (a marker kernel, `csrc/mark.cu`, that a CUDA graph
captures and replays), and `phases` strings a step's phases together, span
and mark each. `view_mark` marks where a step's work on a group of views
begins inside a phase (`VIEWS`: a second marker kernel, which no reader of
the phase marks sees). With tracing off each is a flag test and nothing
more.
`start_profiler_trace` / `stop_profiler_trace` wrap `torch.profiler` and
write what it saw, spans and marks included, as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import time
from typing import Dict, Iterable, Optional, Union

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


# ------------------------------------------------------------------ tracing

# The phases of a train step, in the order a step marks them (`csrc/mark.cu`
# instantiates its kernel in this order): the render forward, the image
# losses, the physics losses and the weighted sum, their backwards in
# reverse, then the update.
PHASES = ("render", "image_loss", "physics", "physics_bwd", "image_loss_bwd",
          "render_bwd", "update")

# The groups of views a step can mark (`view_mark`; the view index of
# `csrc/mark.cu`'s d3g_view_mark_launch): the ego + static trainer's static
# rig, and its ego view.
VIEWS = ("static_rig", "ego")

_tracing = False
_NO_SPAN = contextlib.nullcontext()


def set_tracing(on: bool) -> None:
    """Turn the spans and marks on or off for the whole process (off by
    default). A `StepWindow` keeps the setting in its graph key, so its
    next window captures the step again."""
    global _tracing
    _tracing = bool(on)


def tracing() -> bool:
    return _tracing


def span(name: str):
    """A host span: with tracing on, a `torch.profiler.record_function`
    range named `name`; off, a shared no-op context."""
    return torch.profiler.record_function(name) if _tracing else _NO_SPAN


def mark(phase: str, device) -> None:
    """With tracing on, where `phase` (one of PHASES) begins on `device`'s
    timeline: on a CUDA device the phase's marker kernel, on the current
    stream (a CUDA graph that captures it replays it); elsewhere a
    zero-length `record_function("mark.<phase>")` on the host."""
    if not _tracing:
        return
    index = PHASES.index(phase)
    dev = torch.device(device)
    if dev.type != "cuda":
        with torch.profiler.record_function(f"mark.{phase}"):
            pass
        return
    _launch_marker("d3g_mark_launch", index, dev, f"mark {phase}")


def view_mark(view: str, device) -> None:
    """With tracing on, where the work on `view` (one of VIEWS) begins on
    `device`'s timeline: a zero-length host span `view_mark.<view>` and, on
    a CUDA device, the view's marker kernel on the current stream (a CUDA
    graph that captures it replays it)."""
    if not _tracing:
        return
    index = VIEWS.index(view)
    with torch.profiler.record_function(f"view_mark.{view}"):
        pass
    dev = torch.device(device)
    if dev.type == "cuda":
        _launch_marker("d3g_view_mark_launch", index, dev, f"view mark {view}")


def _launch_marker(entry: str, index: int, dev: torch.device,
                   what: str) -> None:
    """Launch marker kernel `index` of `csrc/mark.cu`'s entry point `entry`
    on `dev`'s current stream."""
    from dynamic3dgaussians_tpu_torch import _build
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib, getattr(lib, entry)(index, stream), what)


def _on_first_grad(tensors, fn) -> None:
    """Call `fn()` once, from autograd hooks on `tensors`, when the
    backward reaches the first of their nodes; the hooks return None, so no
    gradient changes."""
    fired = []

    def hook(_grad):
        if not fired:
            fired.append(True)
            fn()

    for t in tensors:
        if t is not None and t.requires_grad:
            t.register_hook(hook)


class Phases:
    """A step's phases in order, each a host span and a device mark.
    `enter(name)` ends the open phase's span, marks `name` (`mark`) and
    opens its span. `enter_on(tensors, name)` enters `name` from autograd
    hooks on `tensors`, when the backward reaches the first of their nodes;
    the hooks return None, so no gradient changes. `close()` ends the last
    span. A span entered from a hook opens on the autograd thread and may
    end on another, which `record_function` allows. `view(name)` and
    `view_on(tensors, name)` mark where the work on a group of views begins
    (`view_mark`), now or from hooks, inside the open phase."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._span = None

    def enter(self, name: str) -> None:
        self.close()
        mark(name, self.device)
        self._span = torch.profiler.record_function(name)
        self._span.__enter__()

    def enter_on(self, tensors: Iterable[Optional[torch.Tensor]],
                 name: str) -> None:
        _on_first_grad(tensors, lambda: self.enter(name))

    def view(self, name: str) -> None:
        view_mark(name, self.device)

    def view_on(self, tensors: Iterable[Optional[torch.Tensor]],
                name: str) -> None:
        _on_first_grad(tensors, lambda: self.view(name))

    def close(self) -> None:
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None


class _NoPhases:
    """`Phases` with tracing off: registers no hook, launches nothing."""

    def enter(self, name: str) -> None:
        pass

    def enter_on(self, tensors, name: str) -> None:
        pass

    def view(self, name: str) -> None:
        pass

    def view_on(self, tensors, name: str) -> None:
        pass

    def close(self) -> None:
        pass


NO_PHASES = _NoPhases()


def phases(device):
    """A step's `Phases` on `device`; with tracing off the shared no-op
    `NO_PHASES`."""
    return Phases(device) if _tracing else NO_PHASES
