"""Pair emission (E1): the CUDA kernel's wrapper.

The JAX package's `ops/binning.py::emit_pairs` is left to XLA; its plain
PyTorch port, `ops/binning.py::emit_pairs`, follows it op for op, with the
static-shape rank compaction of the TPU (one where + sum over the
(enum_cap, N) cell grid per slot). The kernel `csrc/emit.cu` walks each
gaussian's rect cells once, in one thread, and writes the same keys in the
same slots and the same `n_dropped_rect`, bitwise, on the same card (its
source note says how). `emit_pairs_cuda` takes `emit_pairs`'s arguments and
returns what it returns: (tile_key (K*N,) int32 k-major, gid (K*N,)
int32, n_dropped_rect () int32).

The plain version's Python scalars become float32 constants as PyTorch's
CUDA ops round them: each is cast to float32, and a division of a tensor by
one is a multiplication by its float32 reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.ops.binning import (emit_pairs,
                                                      slot_gaussian_ids)
from dynamic3dgaussians_tpu_torch.ops.compositing import ALPHA_EPS
from dynamic3dgaussians_tpu_torch.ops.cuda import launches
from dynamic3dgaussians_tpu_torch.ops.projection import Projected, tile_rect

F32 = np.float32
CULL_GATE = F32(ALPHA_EPS * 0.999)       # bound >= ALPHA_EPS * 0.999
CULL_INV_GATE = F32(1.0) / CULL_GATE     # safe_op / (ALPHA_EPS * 0.999)
CULL_EPS = F32(ALPHA_EPS)                # clamp(opacity, min=ALPHA_EPS)
CULL_LAM_FLOOR = F32(1e-12)              # clamp(lam_min, min=1e-12)
MATH_FNS = ("exp", "log", "sqrt")


def cull_consts(tile_h: int, tile_w: int, grid_h: int, grid_w: int):
    """The float32 constants of the cull, in the order of the C entry
    point: gate, 1 / gate, eps, lam floor, dmax cap, 1 / tile_w,
    1 / tile_h."""
    cap = F32((grid_w + 1) * tile_w + (grid_h + 1) * tile_h)
    return (CULL_GATE, CULL_INV_GATE, CULL_EPS, CULL_LAM_FLOOR, cap,
            F32(1.0) / F32(tile_w), F32(1.0) / F32(tile_h))


def _f32_vector(name: str, t: torch.Tensor, n: int, dev) -> torch.Tensor:
    if t.dtype != torch.float32 or tuple(t.shape) != (n,):
        raise ValueError(f"{name} must be float32 of shape ({n},), got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the projection on {dev}")
    return t.contiguous()


def emit_pairs_cuda(proj: Projected, tile_h: int, tile_w: int, grid_h: int,
                    grid_w: int, max_tiles_per_gaussian: int,
                    opacity: torch.Tensor = None, enum_cap: int = 0):
    """`emit_pairs` through the kernel on a CUDA projection.

    A CPU projection takes the plain version (`ops/binning.py::
    emit_pairs`); a CUDA one launches `csrc/emit.cu` or raises. The rect
    comes from `tile_rect`; the exact cull runs where `emit_pairs` runs it
    (opacity given and enum_cap > K). Each launch adds one to
    `emit_pairs_cuda.launches`; each run of the kernel, eager or replayed
    from a CUDA graph, adds one to its device counter (`launches.py`).
    Launches on the current stream, with no host synchronisation.
    """
    dev = proj.depth.device
    if dev.type == "cpu":
        return emit_pairs(proj, tile_h, tile_w, grid_h, grid_w,
                          max_tiles_per_gaussian, opacity=opacity,
                          enum_cap=enum_cap)
    args = kernel_inputs(proj, tile_h, tile_w, grid_h, grid_w,
                         max_tiles_per_gaussian, opacity, enum_cap)
    n = args["n"]
    tile_key = torch.empty((max_tiles_per_gaussian * n,), dtype=torch.int32,
                           device=dev)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    if n:
        launch(args, tile_key, dropped)
    return tile_key, slot_gaussian_ids(n, max_tiles_per_gaussian,
                                       dev), dropped


def kernel_inputs(proj: Projected, tile_h: int, tile_w: int, grid_h: int,
                  grid_w: int, k_cap: int, opacity, enum_cap: int) -> dict:
    """The kernel's inputs on a CUDA projection: the rect (`tile_rect`),
    and for the cull the contiguous geometry and opacity and the float32
    constants. Raises on what the kernel does not take."""
    dev = proj.depth.device
    if dev.type != "cuda":
        raise ValueError(f"emit_pairs_cuda runs on cuda or cpu tensors, got "
                         f"{dev}")
    n = proj.depth.shape[0]
    if k_cap <= 0:
        raise ValueError(f"max_tiles_per_gaussian must be positive, got "
                         f"{k_cap}")
    if k_cap * n >= 2 ** 31:
        raise ValueError(f"{k_cap} x {n} emission slots exceed int32")
    cull = opacity is not None and enum_cap > k_cap
    tx0, ty0, tx1, _, raw = tile_rect(proj, tile_h, tile_w, grid_h, grid_w)
    geo, consts = [None] * 6, [0.0] * 7
    if cull:
        geo = [_f32_vector(name, t, n, dev) for name, t in (
            ("x2d", proj.x2d), ("y2d", proj.y2d), ("conic_a", proj.conic_a),
            ("conic_b", proj.conic_b), ("conic_c", proj.conic_c),
            ("opacity", opacity))]
        consts = [float(c) for c in cull_consts(tile_h, tile_w, grid_h,
                                                grid_w)]
    return dict(n=n, k_cap=k_cap, cull=cull, enum_cap=enum_cap if cull else 0,
                tile_h=tile_h, tile_w=tile_w, grid_w=grid_w,
                num_tiles=grid_h * grid_w, geo=geo,
                rect=[tx0, ty0, tx1, raw], consts=consts)


def launch(args: dict, tile_key: torch.Tensor, dropped: torch.Tensor):
    """One launch of the kernel on `kernel_inputs`: writes every slot of
    tile_key (K*N,) int32 and ADDS the drops to dropped () int32."""
    from dynamic3dgaussians_tpu_torch import _build
    lib = _build.load_library()
    dev = tile_key.device
    ptrs = [None if t is None else t.data_ptr() for t in args["geo"]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.d3g_emit_pairs(
            *ptrs, *[t.data_ptr() for t in args["rect"]], args["n"],
            args["k_cap"], int(args["cull"]), args["enum_cap"],
            args["tile_h"], args["tile_w"], args["grid_w"],
            args["num_tiles"], *args["consts"], tile_key.data_ptr(),
            dropped.data_ptr(),
            launches.counter(emit_pairs_cuda, dev).data_ptr(), stream)
    _build.check(lib, err, "emit_pairs kernel launch")
    launches.count_launch(emit_pairs_cuda, 0)


emit_pairs_cuda.launches = 0
emit_pairs_cuda.launches_by_variant = {}


def emit_math(x: torch.Tensor, fn: str) -> torch.Tensor:
    """The kernel's expf, logf or IEEE sqrt of a float32 CUDA tensor,
    elementwise: what the cull evaluates, to hold against torch.exp,
    torch.log and torch.sqrt on the card."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"emit_math takes a float32 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    if fn not in MATH_FNS:
        raise ValueError(f"fn must be one of {MATH_FNS}, got {fn!r}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    from dynamic3dgaussians_tpu_torch import _build
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.d3g_emit_math(x.data_ptr(), x.numel(), MATH_FNS.index(fn),
                                out.data_ptr(), stream)
    _build.check(lib, err, "emit_math kernel launch")
    return out
