"""PyTorch + CUDA (Hopper) port of dynamic3dgaussians_tpu.

The JAX package `dynamic3dgaussians_tpu` is the reference; this package
imports `torch`, numpy and scipy, never `jax` and nothing of the JAX
package.
Its module tree mirrors the reference where a module has a counterpart
(`ops/projection.py` <-> `ops/projection.py`, ...). Every TPU kernel on a
ported path is a hand-written Hopper kernel under `csrc/`, bound with ctypes
(`_build.py`), next to a plain PyTorch version of the same function.

Entry points run on `cuda` unless the caller passes `device=...`; without
CUDA and without an explicit device they raise (see `device.resolve_device`).

Ported so far: the forward render of a trained scene (`cli visualize`),
training over every timestep (`cli train`: the render's gradient through
the backward kernel, losses, Adam, densification, compaction, the exact or
approximate kNN graph and the RCM reorder at t = 0; forward extrapolation,
the neighbour lookup and the physics losses at t > 0; full-state
checkpoints and resume; images streamed by the native prefetching loader),
the splat PLY codec (`native.py`, `viz/export.py`), evaluation and pixel
tracking (`eval/`, `cli evaluate`, `cli evaluate-suite`), the
speed-of-light probe of the tile walk (`tools/bench_sol.py`), and the
serving path: cached-order playback (`ops/playback.py`, `cli visualize
--resort-every N`), the live viewer and network GUI (`viz/`, `cli view`),
the render utilities (`utils/`, `ops/debug.py`) and the plain "tiled"
render method; the 3DGS-style OO stack with the Feature-3DGS trainer and
the ego + static trainer (`models/gaussian_model.py`, `models/scene.py`,
`train/feature_trainer.py`, `train/ego_trainer.py`); and the
Shape-of-Motion path: the motion-basis trainer and its bases
(`train/motion_trainer.py`, `models/motion_bases.py`), the flow priors
with `render_flow` (`train/flow.py`), track lifting, init clouds and the
data tools (`data/`), `compose_scenes`, the logging extras and the CLIP
helpers.
"""

from dynamic3dgaussians_tpu_torch.ops.camera import (  # noqa: F401
    Camera, make_camera)
from dynamic3dgaussians_tpu_torch.ops.playback import (  # noqa: F401
    PlaybackCache, build_cache, render_playback)
from dynamic3dgaussians_tpu_torch.ops.rasterize import (  # noqa: F401
    RasterConfig, RenderOutput, render)
