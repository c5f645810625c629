"""Forward tile compositing (K1): the CUDA kernel's wrapper and its plain
PyTorch version.

Port of `dynamic3dgaussians_tpu/ops/pallas/raster_fwd.py::
pallas_composite_tiles`, default `power_impl="vpu"` semantics. The kernel
is `csrc/raster_fwd.cu` (one thread block per tile, one thread per pixel;
its source note says what bounds it). Both functions here take the
reference's interface unchanged:

  rec_t   (8 + CV, NE_pad) float32 merged record table in (tile, depth)
          order: rows [x, y, conic a, b, c (pre-scaled by log2 e), opacity,
          0, 0] then CV value rows [channels..., depth, 1, zero pad],
          CV % 8 == 0, NE_pad % chunk == 0
  starts, counts  (T,) int32 segment [start, start + count) of each tile

and return (raw (T, P, CV), log_t (T, P, 1), n_active (T, 1, 1) int32):
the accumulators (the last two value rows give sum z*w and sum w), the
final per-pixel log2 transmittance, and the chunks processed per tile.

Per record and pixel: power = min(-(a dx^2 + c dy^2)/2 - b dx dy, 0),
alpha = min(0.99, op * 2^power), zeroed below 1/255 or outside the segment;
log2T += log2(1 - alpha); w = alpha * 2^log2T_before; acc += w * vals. A
tile walks its chunks at global-aligned offsets (start rounded down to a
chunk) and stops after a chunk once every pixel's log2T <= log2(1e-4);
chunk 0 always runs, an empty tile processes 0 chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.device import no_tf32
from dynamic3dgaussians_tpu_torch.ops.cuda import launches
from dynamic3dgaussians_tpu_torch.ops.compositing import ALPHA_EPS, ALPHA_MAX

GEOM_ROWS = 8        # x, y, conic a, b, c, opacity, pad, pad
T_DEAD = 1e-4        # early-termination transmittance
LOG2_T_DEAD = -13.287712379549449   # log2(T_DEAD)
KERNEL_CV = (8, 16, 24, 32, 40, 48)  # value-row counts the kernel is built for


def _check_args(rec_t, tile_starts, tile_counts, num_tiles, tile_h, tile_w,
                chunk):
    if rec_t.dtype != torch.float32 or rec_t.dim() != 2:
        raise ValueError(f"rec_t must be a 2-d float32 table, got "
                         f"{tuple(rec_t.shape)} {rec_t.dtype}")
    n_val = rec_t.shape[0] - GEOM_ROWS
    if n_val <= 0 or n_val % 8:
        raise ValueError(f"value rows must be a positive multiple of 8, got "
                         f"{n_val}")
    if chunk <= 0 or rec_t.shape[1] % chunk:
        raise ValueError(f"NE_pad {rec_t.shape[1]} must be a multiple of "
                         f"chunk {chunk}")
    for name, t in (("tile_starts", tile_starts),
                    ("tile_counts", tile_counts)):
        if t.dtype != torch.int32 or tuple(t.shape) != (num_tiles,):
            raise ValueError(f"{name} must be int32 of shape ({num_tiles},),"
                             f" got {tuple(t.shape)} {t.dtype}")
        if t.device != rec_t.device:
            raise ValueError(f"{name} is on {t.device}, rec_t on "
                             f"{rec_t.device}")
    if not 0 < tile_h * tile_w <= 1024:
        raise ValueError(f"tile_h*tile_w must be in [1, 1024], got "
                         f"{tile_h * tile_w}")
    return n_val


def tile_pixel_coords(num_tiles: int, grid_w: int, tile_h: int, tile_w: int,
                      device):
    """(T, P) float32 pixel centers (px, py) of every tile's pixels, row-major
    within a tile."""
    f32 = torch.float32
    tile = torch.arange(num_tiles, device=device)
    lin = torch.arange(tile_h * tile_w, device=device)
    px = ((tile % grid_w).to(f32) * tile_w)[:, None] + (lin % tile_w).to(f32)
    py = (torch.div(tile, grid_w, rounding_mode="floor").to(f32)
          * tile_h)[:, None] + torch.div(lin, tile_w,
                                         rounding_mode="floor").to(f32)
    return px, py


def footprint_boxes(rec_t: torch.Tensor) -> torch.Tensor:
    """(4, NE_pad) float32 rows [x_lo, x_hi, y_lo, y_hi]: per record, a box
    holding every pixel centre at which it can pass the 1/255 gate.

    The kernels' footprint cull (`csrc/alpha.cuh::record_box`), in the same
    float32 operations: with L = log2(op / EPS) and det = a c - b^2 taken
    from below, half extents sqrt(q c / det) and sqrt(q a / det) for q =
    (2 L + 1e-5)(1 + 1e-5 + 2^-18 a c / det), widened by 1e-4 relative and
    0.01 px. op < EPS gives an empty box (dead at every pixel); a conic that
    is not positive definite, or NaN or infinite inputs, an unbounded one.
    """
    f32 = np.float32
    x, y, a, b, c, op = (rec_t[i] for i in range(6))
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=rec_t.device)
    ac = a * c
    det = ac * f32(1.0 - 2.0 ** -20) - (b * b) * f32(1.0 + 2.0 ** -20)
    l2 = 2.0 * torch.log2(op / f32(ALPHA_EPS))
    q = (l2 + f32(1e-5)) * ((f32(1.0) + f32(1e-5))
                            + f32(2.0 ** -18) * (ac / det))
    bounded = (a > 0) & (c > 0) & (det > 0) & (q < inf)
    rx = torch.sqrt(q * c / det) * f32(1.0001) + f32(0.01)
    ry = torch.sqrt(q * a / det) * f32(1.0001) + f32(0.01)
    box = torch.stack([torch.where(bounded, x - rx, -inf),
                       torch.where(bounded, x + rx, inf),
                       torch.where(bounded, y - ry, -inf),
                       torch.where(bounded, y + ry, inf)])
    empty = torch.stack([inf, -inf, inf, -inf])[:, None]
    return torch.where((op < f32(ALPHA_EPS))[None, :], empty, box)


def warp_pixel_map(tile_h: int, tile_w: int) -> torch.Tensor:
    """(P,) int64: the row-major tile pixel of each kernel thread. A warp
    takes an 8x4 block of pixels when the tile divides into them (lanes
    row-major inside the block, blocks row-major over the tile), else 32
    consecutive row-major pixels (`csrc/alpha.cuh::pixel_of_thread`)."""
    tid = torch.arange(tile_h * tile_w)
    if tile_w % 8 == 0 and tile_h % 4 == 0:
        warp, lane = tid // 32, tid % 32
        per_row = tile_w // 8
        lx = (warp % per_row) * 8 + lane % 8
        ly = (warp // per_row) * 4 + lane // 8
        return ly * tile_w + lx
    return tid


def composite_tiles_torch(rec_t: torch.Tensor, tile_starts: torch.Tensor,
                          tile_counts: torch.Tensor, *, num_tiles: int,
                          grid_w: int, tile_h: int, tile_w: int,
                          chunk: int = 128):
    """Plain PyTorch version of the kernel: every tile at once, one loop
    step per chunk index, with the reference kernel's order of operations
    (prefix sum of log2(1 - alpha) within a chunk, tile-level stop rule)."""
    n_val = _check_args(rec_t, tile_starts, tile_counts, num_tiles, tile_h,
                        tile_w, chunk)
    dev = rec_t.device
    f32 = torch.float32
    p = tile_h * tile_w
    ne_pad = rec_t.shape[1]
    starts = tile_starts.long()
    counts = tile_counts.long()
    base = torch.div(starts, chunk, rounding_mode="floor") * chunk
    shift = starts - base
    n_chunks = torch.where(
        counts == 0, torch.zeros_like(counts),
        torch.div(shift + counts + chunk - 1, chunk, rounding_mode="floor"))

    px, py = tile_pixel_coords(num_tiles, grid_w, tile_h, tile_w, dev)
    px, py = px[:, :, None], py[:, :, None]            # (T, P, 1)
    lane = torch.arange(chunk, device=dev)

    log_t = torch.zeros((num_tiles, p), dtype=f32, device=dev)
    acc = torch.zeros((num_tiles, p, n_val), dtype=f32, device=dev)
    n_active = torch.zeros((num_tiles,), dtype=torch.int32, device=dev)
    alive = n_chunks > 0
    max_chunks = int(n_chunks.max()) if num_tiles else 0
    for k in range(max_chunks):
        if k > 0:
            alive = alive & (k < n_chunks) & (log_t.amax(dim=1) > LOG2_T_DEAD)
        if not bool(alive.any()):
            break
        idx = torch.clamp(base[:, None] + k * chunk + lane[None, :],
                          max=ne_pad - 1)
        g = rec_t[:, idx]                               # (R, T, G)
        lo = (shift - k * chunk)[:, None]
        hi = (shift + counts - k * chunk)[:, None]
        ok = (lane >= lo) & (lane < hi) & alive[:, None]
        x, y = g[0][:, None, :], g[1][:, None, :]       # (T, 1, G)
        ca, cb, cc = g[2][:, None, :], g[3][:, None, :], g[4][:, None, :]
        op = g[5][:, None, :]
        dx = x - px                                     # (T, P, G)
        dy = y - py
        power = torch.clamp(
            -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy, max=0.0)
        alpha = torch.clamp(op * torch.exp2(power), max=ALPHA_MAX)
        alpha = torch.where((alpha >= ALPHA_EPS) & ok[:, None, :], alpha,
                            torch.zeros_like(alpha))
        logs = torch.log2(1.0 - alpha)
        cum_incl = torch.cumsum(logs, dim=-1)
        cum_excl = cum_incl - logs
        w = alpha * torch.exp2(cum_excl + log_t[:, :, None])
        vals = g[GEOM_ROWS:].permute(1, 2, 0)           # (T, G, CV)
        with no_tf32():
            acc = acc + torch.bmm(w, vals)
        log_t = log_t + cum_incl[:, :, -1]
        n_active += alive.to(torch.int32)
    return (acc, log_t[:, :, None], n_active.reshape(num_tiles, 1, 1))


def composite_tiles(rec_t: torch.Tensor, tile_starts: torch.Tensor,
                    tile_counts: torch.Tensor, *, num_tiles: int,
                    grid_w: int, tile_h: int, tile_w: int,
                    chunk: int = 128):
    """Run the forward tile kernel on a CUDA tensor.

    A CPU tensor takes the plain version (`composite_tiles_torch`); a CUDA
    tensor launches `csrc/raster_fwd.cu` or raises. Each launch adds one to
    `composite_tiles.launches`; each run of the kernel, eager or replayed
    from a CUDA graph, adds one to its device counter (`launches.py`).
    """
    n_val = _check_args(rec_t, tile_starts, tile_counts, num_tiles, tile_h,
                        tile_w, chunk)
    if rec_t.device.type == "cpu":
        return composite_tiles_torch(
            rec_t, tile_starts, tile_counts, num_tiles=num_tiles,
            grid_w=grid_w, tile_h=tile_h, tile_w=tile_w, chunk=chunk)
    if rec_t.device.type != "cuda":
        raise ValueError(f"composite_tiles runs on cuda or cpu tensors, got "
                         f"{rec_t.device}")
    if n_val not in KERNEL_CV:
        raise ValueError(f"the CUDA kernel is built for CV in {KERNEL_CV}, "
                         f"got {n_val}")
    for name, t in (("rec_t", rec_t), ("tile_starts", tile_starts),
                    ("tile_counts", tile_counts)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from dynamic3dgaussians_tpu_torch import _build
    lib = _build.load_library()
    dev = rec_t.device
    p = tile_h * tile_w
    raw = torch.empty((num_tiles, p, n_val), dtype=torch.float32, device=dev)
    log_t = torch.empty((num_tiles, p, 1), dtype=torch.float32, device=dev)
    n_active = torch.empty((num_tiles, 1, 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.d3g_raster_fwd(
            rec_t.data_ptr(), rec_t.shape[1], rec_t.shape[0],
            tile_starts.data_ptr(), tile_counts.data_ptr(), num_tiles,
            grid_w, tile_h, tile_w, chunk, raw.data_ptr(), log_t.data_ptr(),
            n_active.data_ptr(),
            launches.counter(composite_tiles, dev).data_ptr(), stream)
    _build.check(lib, err, "raster_fwd kernel launch")
    composite_tiles.launches += 1
    return raw, log_t, n_active


composite_tiles.launches = 0
