"""Typed configuration of a training run, serialisable as JSON.

Port of `dynamic3dgaussians_tpu/train/config.py` with the same fields and
the same JSON, so a `cfg_args.json` written by the reference loads here
unchanged. What the port makes of the fields that exist for the TPU:

  * raster.method: "auto" and "pallas" take the kernel path (the CUDA
    kernels on the card, their plain versions on the CPU), "torch" forces
    the plain versions and "cuda" the kernels; "tiled" is the reference's
    pure-XLA path, plain PyTorch here.
  * raster.max_per_tile and raster.pairs_per_gaussian size only the tiled
    path. scan_impl and unsort_impl only change how the TPU schedules the
    same result and are ignored; power_impl "mxu_fused" and
    pack_records=True change the numerics and raise.
  * steps_per_call > 1 runs the steps between host actions in windows of
    that many, as the reference does (`trainer.make_train_scan`): on the
    card a CUDA graph of the step replayed once per step, no host read
    inside a window; the steps, their camera stream and their result are
    those of steps_per_call = 1.
  * knn_method "approx" builds the graph with `ops/knn.py::knn_approx`;
    neighbor_window (the TPU's windowed neighbour fetch) is not ported and
    raises.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

from dynamic3dgaussians_tpu_torch.train.losses import DEFAULT_LOSS_WEIGHTS
from dynamic3dgaussians_tpu_torch.train.optim import DEFAULT_LRS

# raster.method -> the port's render method
RENDER_METHODS = {"auto": "auto", "pallas": "auto", "torch": "torch",
                  "cuda": "cuda", "tiled": "tiled"}


@dataclasses.dataclass
class RasterSettings:
    tile_h: int = 16
    tile_w: int = 16
    chunk: int = 128
    max_per_tile: int = 1024           # tiled path only
    # per-gaussian emission slots; overflow is counted in the step metrics
    max_tiles_per_gaussian: int = 8
    pairs_per_gaussian: int = 8        # tiled path only
    exact_cull: bool = True
    power_impl: str = "vpu"
    scan_impl: str = "matmul_split3"
    pack_records: bool = False
    unsort_impl: str = "sort"
    method: str = "auto"

    def render_method(self) -> str:
        """The port's render method for `method`; raises for what the port
        does not run."""
        if self.method not in RENDER_METHODS:
            raise ValueError(f"raster.method {self.method!r} is not ported "
                             f"(one of {sorted(RENDER_METHODS)})")
        if self.power_impl not in ("vpu", "mxu"):
            raise ValueError(f"raster.power_impl {self.power_impl!r} changes "
                             f"the numerics and is not ported")
        if self.pack_records:
            raise ValueError("raster.pack_records=True changes the numerics "
                             "and is not ported")
        return RENDER_METHODS[self.method]


@dataclasses.dataclass
class TrainConfig:
    # schedule
    num_timesteps: int = 3
    iters_first_timestep: int = 5000
    iters_per_timestep: int = 2000
    # densification schedule
    densify_start: int = 500
    densify_end: int = 5000
    densify_every: int = 100
    opacity_reset_every: int = 3000
    # model
    capacity: Optional[int] = None     # default: 4x initial points
    # grow the capacity when densification runs out of free slots;
    # max_capacity caps it (0 = unbounded)
    grow_capacity: bool = True
    max_capacity: int = 0
    # double raster.max_tiles_per_gaussian whenever a step since the last
    # report counted rect-cap truncation
    grow_tiles: bool = True
    pairs_budget_cap: int = 0          # tiled path only
    num_knn: int = 20
    knn_weight_beta: float = 2000.0    # exp(-2000 * d^2)
    knn_method: str = "exact"
    neighbor_window: bool = False
    semantic_dim: int = 0
    sh_degree: int = 0
    loss_weights: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_LOSS_WEIGHTS))
    lrs: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_LRS))
    # groups frozen after the first timestep
    freeze_after_t0: Tuple[str, ...] = ("logit_opacities", "log_scales",
                                        "cam_m", "cam_c")
    raster: RasterSettings = dataclasses.field(default_factory=RasterSettings)
    seed: int = 0
    report_every: int = 100
    cams_per_step: int = 1
    steps_per_call: int = 1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "TrainConfig":
        d = json.loads(s)
        d["raster"] = RasterSettings(**d.get("raster", {}))
        d["freeze_after_t0"] = tuple(d.get("freeze_after_t0", ()))
        return TrainConfig(**d)
