"""The program under test, driven as a traffic file says.

`ProgramRun` builds the port's training state at timestep `timestep` of a
configuration from the seeded inputs, as `train/trainer.py::train` reaches
it (init from the cloud, `initialize_post_first_timestep`,
`initialize_per_timestep`), and runs the loop of `train` over that
timestep: cameras from the without-replacement permutation of
`numpy.random.RandomState(seed)`; with `steps_per_call` W > 1 a window of
W steps (`make_train_scan`) wherever no host action falls inside it, else
one step (`make_train_step`); every `report_every` steps the host reads
the loss and the summed rect drops, as `train` does for its K check.

Each call into the program sits in a `record_function` span of the
benchmark's own (`SPANS`), which label the trace's idle gaps.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

SPANS = ("window_call", "eager_step", "pick_cams", "report_read",
         "host_read")
ADAM_B1 = 0.9          # the program's Adam: mu after one step is 0.1 g


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Schedule:
    """The camera stream and the call sizes of `train`'s loop over one
    timestep: cameras from the without-replacement permutation of
    `numpy.random.RandomState(seed)`; a window of `steps_per_call` steps
    wherever no host action (a report step, the timestep's last step)
    falls strictly inside it, else one step."""

    def __init__(self, traffic: Dict, n_cams: int, iters: int, seed: int):
        self.every = traffic["report_every"]
        self.width = max(1, int(traffic["steps_per_call"]))
        self.n_cams, self.iters = n_cams, iters
        self.rng = np.random.RandomState(int(seed) % (2 ** 32))
        self.todo: List[int] = []
        self.i = 0

    def next_call(self):
        """(window?, cameras) of the next call; advances the stream."""
        if self.i >= self.iters:
            raise RuntimeError(f"the run outlasted the timestep's "
                               f"{self.iters} steps")
        action = min(x for x in (self.iters - 1,
                                 -(-self.i // self.every) * self.every)
                     if x >= self.i)
        window = self.width > 1 and action - self.i + 1 >= self.width
        cams = []
        for _ in range(self.width if window else 1):
            if not self.todo:
                self.todo = list(self.rng.permutation(self.n_cams))
            cams.append(int(self.todo.pop()))
        return window, cams

    def done(self, n: int) -> bool:
        """Count a call of n steps; True when its last step reports."""
        self.i += n
        return (self.i - 1) % self.every == 0

    def first_cams(self, min_steps: int) -> List[int]:
        """The cameras of the calls that reach `min_steps` steps."""
        cams: List[int] = []
        while len(cams) < min_steps:
            _, c = self.next_call()
            self.done(len(c))
            cams += c
        return cams


class ProgramRun:
    def __init__(self, inputs: Dict, cfg: Dict, traffic: Dict, seed: int,
                 device, graph_factory=None):
        from dynamic3dgaussians_tpu_torch.models import gaussians as G
        from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
        from dynamic3dgaussians_tpu_torch.train import optim
        from dynamic3dgaussians_tpu_torch.train import trainer as T
        from dynamic3dgaussians_tpu_torch.train.config import (
            RasterSettings, TrainConfig)
        self.dev = dev = torch.device(device)
        k = cfg["k_slots"]
        self.tcfg = TrainConfig(
            num_timesteps=cfg["num_timesteps"],
            iters_per_timestep=cfg["iters_per_timestep"],
            capacity=cfg["capacity"], num_knn=cfg["num_knn"],
            semantic_dim=cfg["semantic_dim"],
            raster=RasterSettings(max_tiles_per_gaussian=k,
                                  pairs_per_gaussian=k),
            seed=int(seed) % (2 ** 32), report_every=traffic["report_every"],
            cams_per_step=1, steps_per_call=traffic["steps_per_call"])
        w2cs = np.stack([w for _, w in inputs["mats"]])
        gen = torch.Generator(device=dev).manual_seed(inputs["feature_seed"])
        params, variables = G.init_params(
            inputs["cloud"].cpu().numpy(), w2cs, capacity=cfg["capacity"],
            semantic_dim=cfg["semantic_dim"], generator=gen, device=dev)
        opt = optim.init(params)
        self.timings: Dict[str, float] = {}
        params, variables, opt = T.initialize_post_first_timestep(
            params, variables, self.tcfg, opt, timings=self.timings)
        self.params, self.variables, self.opt = T.initialize_per_timestep(
            params, variables, opt)
        self.data_t = []
        for c, (kmat, w2c) in enumerate(inputs["mats"]):
            frame = inputs["frames"][c]
            d = {"camera": make_camera(cfg["width"], cfg["height"], kmat, w2c,
                                       device=dev),
                 "im": frame["im"], "seg": frame["seg"], "cam_id": c}
            if "feature" in frame:
                d["gt_feature"] = frame["feature"]
            self.data_t.append(d)
        radius = float(self.variables["scene_radius"])
        self.lrs = {
            key: torch.tensor(
                0.0 if key in self.tcfg.freeze_after_t0 else
                self.tcfg.lrs.get(key, 0.0) * (radius if key == "means3D"
                                               else 1.0),
                dtype=torch.float32, device=dev)
            for key in self.params}
        rcfg = T.raster_config(self.tcfg)
        self.step = T.make_train_step(self.tcfg, rcfg)
        self.scan = None
        if traffic["steps_per_call"] > 1:
            self.scan = T.make_train_scan(self.tcfg, rcfg, self.step,
                                          graph_factory=graph_factory)
            self.data_stack = T.stack_timestep_data(self.data_t)
        self.schedule = Schedule(traffic, len(self.data_t),
                                 self.tcfg.iters_per_timestep, seed)
        self.rect_drops = torch.zeros((), dtype=torch.int32, device=dev)
        self.reports: List[Dict] = []
        self.windows = 0
        self.cam_log: List[int] = []

    # -- the loop of `train` ---------------------------------------------
    def call(self) -> Dict:
        """One call of the loop: a window or one step, then the host's
        report read when its step is a report step. Returns {"steps",
        "metrics", "cams"}."""
        with record_function("pick_cams"):
            window, cams = self.schedule.next_call()
        self.cam_log.extend(cams)
        if window:
            with record_function("window_call"):
                sel = torch.as_tensor(cams, dtype=torch.int64,
                                      device=self.dev)
                self.params, self.opt, self.variables, metrics = self.scan(
                    self.params, self.opt, self.variables, self.data_stack,
                    sel, self.lrs, False)
            self.windows += 1
        else:
            with record_function("eager_step"):
                self.params, self.opt, self.variables, metrics = self.step(
                    self.params, self.opt, self.variables,
                    self.data_t[cams[0]], self.lrs, False)
        self.rect_drops = self.rect_drops + metrics["n_dropped_rect"]
        if self.schedule.done(len(cams)):
            with record_function("report_read"):
                self.reports.append(dict(
                    i=self.schedule.i - 1, loss=float(metrics["loss"]),
                    rect_drops=int(self.rect_drops)))
            self.rect_drops = torch.zeros_like(self.rect_drops)
        return dict(steps=len(cams), metrics=metrics, cams=cams)

    def window_stats(self) -> Optional[Dict]:
        if self.scan is None or self.scan.window is None:
            return None
        return dict(self.scan.window.stats, windows=self.windows)

    # -- set-up: the first steps, read for the comparison -----------------
    def first_steps(self, min_steps: int) -> Dict:
        """Run the loop's calls until at least `min_steps` steps are done,
        and read what the reference is held to: each step's loss, the
        first step's gradient per table as Adam holds it (mu / (1 - b1)
        after one step from zero moments) and each table's change."""
        start = {k: v.clone() for k, v in self.params.items()}
        parts: List[torch.Tensor] = []
        grad_norms = None
        while sum(p.numel() for p in parts) < min_steps:
            out = self.call()
            if out["steps"] == 1:
                parts.append(out["metrics"]["loss"].reshape(1))
            else:
                parts.append(self.scan.window.last_steps["loss"].reshape(-1))
            if grad_norms is None:
                if out["steps"] != 1:
                    raise RuntimeError("the first call ran a window: the "
                                       "first gradient is not readable")
                grad_norms = {k: torch.linalg.vector_norm(v.double())
                              / (1.0 - ADAM_B1)
                              for k, v in self.opt.mu.items()}
        with record_function("host_read"):
            change = {k: float(torch.linalg.vector_norm(
                (self.params[k] - start[k]).double())) for k in start}
            out = dict(losses=[float(x) for x in torch.cat(parts)],
                       grad_norms={k: float(v) for k, v in
                                   grad_norms.items()},
                       change_norms=change, cams=list(self.cam_log))
        del start
        return out

    def free(self) -> None:
        """Drop the program's state, so that the reference's memory is its
        own."""
        for name in ("params", "opt", "variables", "scan", "step", "data_t",
                     "data_stack"):
            if hasattr(self, name):
                setattr(self, name, None)
