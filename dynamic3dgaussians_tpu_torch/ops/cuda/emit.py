"""Pair emission (E1): the CUDA kernel's wrapper.

The JAX package's `ops/binning.py::emit_pairs` is left to XLA; its plain
PyTorch port, `ops/binning.py::emit_pairs`, follows it op for op and writes
K slots per gaussian, and `ops/binning.py::compact_pairs` keeps the live
ones in slot order. The kernel `csrc/emit.cu` does both at once: it
computes each gaussian's tile rect, walks its rect cells and writes only
the live pairs, compacted in slot order, with the same tile keys, slots,
live count and `n_dropped_rect`, bitwise, as the plain composition
(`ops/binning.py::emit_live_pairs`) on the same card (its source note
says how). `emit_pairs_cuda` takes `emit_pairs`'s arguments and a pair
capacity and returns `ops/binning.py::Pairs`.

The plain version's Python scalars become float32 constants as PyTorch's
CUDA ops round them: each is cast to float32, and a division of a tensor by
one is a multiplication by its float32 reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.ops.binning import Pairs, emit_live_pairs
from dynamic3dgaussians_tpu_torch.ops.compositing import ALPHA_EPS
from dynamic3dgaussians_tpu_torch.ops.cuda import launches
from dynamic3dgaussians_tpu_torch.ops.projection import Projected
from dynamic3dgaussians_tpu_torch.utils.logging import span

F32 = np.float32
CULL_GATE = F32(ALPHA_EPS * 0.999)       # bound >= ALPHA_EPS * 0.999
CULL_INV_GATE = F32(1.0) / CULL_GATE     # safe_op / (ALPHA_EPS * 0.999)
CULL_EPS = F32(ALPHA_EPS)                # clamp(opacity, min=ALPHA_EPS)
CULL_LAM_FLOOR = F32(1e-12)              # clamp(lam_min, min=1e-12)
MATH_FNS = ("exp", "log", "sqrt")
BLOCK = 256      # gaussians per block of the kernel (csrc/emit.cu BLOCK)
MAX_K = 512      # emission slots per gaussian the kernel takes
SOLO = 16        # a lane walks a rect of at most SOLO cells (csrc/emit.cu)


def cull_consts(tile_h: int, tile_w: int, grid_h: int, grid_w: int):
    """The float32 constants of the cull, in the order of the C entry
    points: gate, 1 / gate, eps, lam floor, dmax cap, 1 / tile_w,
    1 / tile_h (the last two also the rect's)."""
    cap = F32((grid_w + 1) * tile_w + (grid_h + 1) * tile_h)
    return (CULL_GATE, CULL_INV_GATE, CULL_EPS, CULL_LAM_FLOOR, cap,
            F32(1.0) / F32(tile_w), F32(1.0) / F32(tile_h))


def _vector(name: str, t: torch.Tensor, n: int, dtype, dev) -> torch.Tensor:
    if t.dtype != dtype or tuple(t.shape) != (n,):
        raise ValueError(f"{name} must be {dtype} of shape ({n},), got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the projection on {dev}")
    return t.contiguous()


def emit_pairs_cuda(proj: Projected, tile_h: int, tile_w: int, grid_h: int,
                    grid_w: int, max_tiles_per_gaussian: int,
                    opacity: torch.Tensor = None, enum_cap: int = 0,
                    pair_cap: int = None) -> Pairs:
    """The live pairs of the emission through the kernel on a CUDA
    projection.

    A CPU projection takes the plain version (`ops/binning.py::
    emit_live_pairs`); a CUDA one launches `csrc/emit.cu` or raises. The
    exact cull runs where `emit_pairs` runs it (opacity given and enum_cap
    > K). Without a pair_cap the output holds the live pairs, sized by one
    host read of their count; with one, pair_cap columns and no host read
    (a CUDA graph can capture it). Each emission adds one to
    `emit_pairs_cuda.launches`; each run, eager or replayed from a CUDA
    graph, adds one to its device counter (`launches.py`). Launches on the
    current stream. With tracing on, the host read is the span
    `emit.count_read`.
    """
    dev = proj.depth.device
    if dev.type == "cpu":
        return emit_live_pairs(proj, tile_h, tile_w, grid_h, grid_w,
                               max_tiles_per_gaussian, opacity=opacity,
                               enum_cap=enum_cap, pair_cap=pair_cap)
    args = kernel_inputs(proj, tile_h, tile_w, grid_h, grid_w,
                         max_tiles_per_gaussian, opacity, enum_cap)
    if args["n"] == 0:
        cap = pair_cap or 0
        return Pairs(
            torch.full((cap,), grid_h * grid_w, dtype=torch.int32,
                       device=dev),
            torch.zeros((cap,), dtype=torch.int32, device=dev),
            torch.zeros((2,), dtype=torch.int64, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev), 0)
    return launch(args, pair_cap)


def kernel_inputs(proj: Projected, tile_h: int, tile_w: int, grid_h: int,
                  grid_w: int, k_cap: int, opacity, enum_cap: int) -> dict:
    """The kernel's inputs on a CUDA projection: the rect's (x2d, y2d,
    radius, valid), for the cull the conic and opacity, and the float32
    constants. Raises on what the kernel does not take."""
    dev = proj.depth.device
    if dev.type != "cuda":
        raise ValueError(f"emit_pairs_cuda runs on cuda or cpu tensors, got "
                         f"{dev}")
    n = proj.depth.shape[0]
    if not 0 < k_cap <= MAX_K:
        raise ValueError(f"max_tiles_per_gaussian must be in 1..{MAX_K}, "
                         f"got {k_cap}")
    if k_cap * n >= 2 ** 31:
        raise ValueError(f"{k_cap} x {n} emission slots exceed int32")
    cull = opacity is not None and enum_cap > k_cap
    f32, i32 = torch.float32, torch.int32
    rect = [_vector("x2d", proj.x2d, n, f32, dev),
            _vector("y2d", proj.y2d, n, f32, dev),
            _vector("radius", proj.radius, n, i32, dev),
            _vector("valid", proj.valid, n, torch.bool, dev)]
    geo = [None] * 4
    if cull:
        geo = [_vector(name, t, n, f32, dev) for name, t in (
            ("conic_a", proj.conic_a), ("conic_b", proj.conic_b),
            ("conic_c", proj.conic_c), ("opacity", opacity))]
    return dict(n=n, k_cap=k_cap, cull=cull, enum_cap=enum_cap if cull else 0,
                tile_h=tile_h, tile_w=tile_w, grid_h=grid_h, grid_w=grid_w,
                rect=rect, geo=geo,
                consts=[float(c) for c in cull_consts(tile_h, tile_w, grid_h,
                                                      grid_w)])


def _common(args: dict) -> list:
    """The C entry points' shared leading arguments."""
    ptrs = [t.data_ptr() for t in args["rect"]] + [
        None if t is None else t.data_ptr() for t in args["geo"]]
    return [*ptrs, args["n"], args["k_cap"], int(args["cull"]),
            args["enum_cap"], args["tile_h"], args["tile_w"], args["grid_h"],
            args["grid_w"], *args["consts"], -(-args["n"] // BLOCK)]


def launch(args: dict, pair_cap: int = None) -> Pairs:
    """One emission on `kernel_inputs`: the counting pass and the scan,
    then (pair_cap None: after one host read of the live count) the
    writing pass. Returns the `Pairs`."""
    from dynamic3dgaussians_tpu_torch import _build
    lib = _build.load_library()
    dev = args["rect"][0].device
    n, k_cap = args["n"], args["k_cap"]
    nb = -(-n // BLOCK)
    i32 = torch.int32
    n_each = torch.empty((n,), dtype=torch.int16, device=dev)
    cnt = torch.empty(((k_cap + 1) * nb,), dtype=i32, device=dev)
    totals = torch.empty((k_cap + 1,), dtype=i32, device=dev)
    common = _common(args)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.d3g_emit_count(*common, n_each.data_ptr(), cnt.data_ptr(),
                                 totals.data_ptr(), stream)
        _build.check(lib, err, "emit_pairs count launch")
        cap = pair_cap
        if cap is None:
            with span("emit.count_read"):
                cap = sum(totals[:k_cap].tolist())
        tile = torch.empty((cap,), dtype=i32, device=dev)
        slot = torch.empty((cap,), dtype=i32, device=dev)
        counts = torch.empty((2,), dtype=torch.int64, device=dev)
        dropped = torch.empty((), dtype=i32, device=dev)
        err = lib.d3g_emit_write(
            *common, n_each.data_ptr(), cnt.data_ptr(), totals.data_ptr(),
            cap, tile.data_ptr(), slot.data_ptr(), counts.data_ptr(),
            dropped.data_ptr(),
            launches.counter(emit_pairs_cuda, dev).data_ptr(), stream)
        _build.check(lib, err, "emit_pairs write launch")
    launches.count_launch(emit_pairs_cuda, 0)
    return Pairs(tile, slot, counts, dropped, k_cap * n)


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
