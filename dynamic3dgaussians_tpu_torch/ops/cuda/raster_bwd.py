"""Backward tile compositing (K2): the CUDA kernel's wrapper and its plain
PyTorch version.

Port of `dynamic3dgaussians_tpu/ops/pallas/raster_bwd.py::
pallas_composite_tiles_bwd`, default `power_impl="vpu"` semantics (the mxu
paths, `_power_moments` and `scan_impl` are TPU workarounds). The kernel is
`csrc/raster_bwd.cu` (one thread block per tile, one thread per pixel; its
source note says what bounds it). Both functions take the reference's
interface unchanged:

  rec_t, tile_starts, tile_counts   the forward kernel's inputs
  n_active  (T,) int32 chunks the forward processed per tile
  log_t     (T, P, 1) final log2 transmittance from the forward
  d_raw     (T, P, CV) cotangent of the forward's accumulators

and return d_out (8 + CV, NE_pad): per-pair gradients at each pair's sorted
slot, rows 0-5 = d{x, y, conic a, b, c (as stored, pre-scaled by log2 e),
opacity}, rows 8.. = d(value rows). Rows 6-7, slots outside every tile's
segment and slots of chunks past a tile's stop point are zero.

Per tile, walking its n_active chunks in reverse with T rebuilt in log space
(never by dividing by 1 - alpha), per record and pixel, with d_acc the
pixel's row of d_raw and raw = opacity * 2^power before the 0.99 clamp:
  w = alpha * T,  dw = d_acc . vals,  d_vals = sum_p d_acc * w,
  suffix = sum of dw * w over all later records,
  d_alpha = dw * T - suffix / (1 - alpha),
  g = d_alpha where the cell passed the gate and raw <= 0.99, else 0,
  d_power = g * raw * ln 2 where power < 0, then the chain rule to x, y
  and the conic, and d_opacity = sum_p g * 2^power.
"""

from __future__ import annotations

import math

import torch

from dynamic3dgaussians_tpu_torch.device import no_tf32
from dynamic3dgaussians_tpu_torch.ops.cuda import launches
from dynamic3dgaussians_tpu_torch.ops.compositing import ALPHA_EPS, ALPHA_MAX
from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import (
    GEOM_ROWS, KERNEL_CV, _check_args, tile_pixel_coords)

LN2 = math.log(2.0)


def _check_bwd_args(rec_t, tile_starts, tile_counts, n_active, log_t, d_raw,
                    num_tiles, tile_h, tile_w, chunk):
    n_val = _check_args(rec_t, tile_starts, tile_counts, num_tiles, tile_h,
                        tile_w, chunk)
    p = tile_h * tile_w
    for name, t, shape, dtype in (
            ("n_active", n_active, (num_tiles,), torch.int32),
            ("log_t", log_t, (num_tiles, p, 1), torch.float32),
            ("d_raw", d_raw, (num_tiles, p, n_val), torch.float32)):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != rec_t.device:
            raise ValueError(f"{name} is on {t.device}, rec_t on "
                             f"{rec_t.device}")
    return n_val


def composite_tiles_bwd_torch(rec_t: torch.Tensor, tile_starts: torch.Tensor,
                              tile_counts: torch.Tensor,
                              n_active: torch.Tensor, log_t: torch.Tensor,
                              d_raw: torch.Tensor, *, num_tiles: int,
                              grid_w: int, tile_h: int, tile_w: int,
                              chunk: int = 128) -> torch.Tensor:
    """Plain PyTorch version of the kernel: every tile at once, one loop
    step per chunk index from the last active one down, with the reference
    kernel's order of operations (in-chunk prefix sums of log2(1 - alpha)
    and of dw * w)."""
    n_val = _check_bwd_args(rec_t, tile_starts, tile_counts, n_active, log_t,
                            d_raw, num_tiles, tile_h, tile_w, chunk)
    dev = rec_t.device
    ne_pad = rec_t.shape[1]
    d_out = torch.zeros((GEOM_ROWS + n_val, ne_pad), dtype=torch.float32,
                        device=dev)
    if num_tiles == 0:
        return d_out
    starts = tile_starts.long()
    counts = tile_counts.long()
    nact = n_active.long()
    base = torch.div(starts, chunk, rounding_mode="floor") * chunk
    shift = starts - base
    px, py = tile_pixel_coords(num_tiles, grid_w, tile_h, tile_w, dev)
    px, py = px[:, :, None], py[:, :, None]            # (T, P, 1)
    lane = torch.arange(chunk, device=dev)
    log_t_end = log_t[:, :, 0].clone()                 # (T, P)
    s_carry = torch.zeros_like(log_t_end)
    max_chunks = int(nact.max())
    for k in range(max_chunks - 1, -1, -1):
        active = k < nact                              # (T,)
        slot = base[:, None] + k * chunk + lane[None, :]
        idx = torch.clamp(slot, max=ne_pad - 1)
        g = rec_t[:, idx]                              # (R, T, G)
        ok = ((lane >= (shift - k * chunk)[:, None])
              & (lane < (shift + counts - k * chunk)[:, None])
              & active[:, None])                       # (T, G)
        x, y = g[0][:, None, :], g[1][:, None, :]      # (T, 1, G)
        ca, cb, cc = g[2][:, None, :], g[3][:, None, :], g[4][:, None, :]
        op = g[5][:, None, :]
        dx = x - px                                    # (T, P, G)
        dy = y - py
        p0 = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        e = torch.exp2(torch.clamp(p0, max=0.0))
        raw = op * e
        alive = (raw >= ALPHA_EPS) & ok[:, None, :]
        zero = torch.zeros_like(raw)
        alpha = torch.where(alive, torch.clamp(raw, max=ALPHA_MAX), zero)
        logs = torch.log2(1.0 - alpha)
        cum_incl = torch.cumsum(logs, dim=-1)
        cum_excl = cum_incl - logs
        log_t_start = log_t_end - cum_incl[..., -1]
        t_exc = torch.exp2(log_t_start[..., None] + cum_excl)
        w = alpha * t_exc
        vals = g[GEOM_ROWS:].permute(1, 0, 2)          # (T, CV, G)
        with no_tf32():
            dw = torch.bmm(d_raw, vals)                # (T, P, G)
            d_vals = torch.bmm(d_raw.transpose(1, 2), w)   # (T, CV, G)
        u = dw * w
        u_incl = torch.cumsum(u, dim=-1)
        u_tot = u_incl[..., -1]
        suffix = (u_tot[..., None] - u_incl) + s_carry[..., None]
        d_alpha = dw * t_exc - suffix / (1.0 - alpha)
        d_rawv = torch.where(alive & (raw <= ALPHA_MAX), d_alpha, zero)
        d_pow = torch.where(p0 < 0.0, d_rawv * raw * LN2, zero)
        rows = torch.stack([
            torch.sum(d_pow * -(ca * dx + cb * dy), dim=1),
            torch.sum(d_pow * -(cc * dy + cb * dx), dim=1),
            torch.sum(d_pow * (-0.5 * dx * dx), dim=1),
            torch.sum(d_pow * (-dx * dy), dim=1),
            torch.sum(d_pow * (-0.5 * dy * dy), dim=1),
            torch.sum(d_rawv * e, dim=1)])             # (6, T, G)
        # every in-segment slot belongs to one tile: a plain indexed store
        sel = ok.reshape(-1)
        dst = slot.reshape(-1)[sel]
        d_out[:6, dst] = rows.reshape(6, -1)[:, sel]
        d_out[GEOM_ROWS:, dst] = d_vals.permute(1, 0, 2).reshape(
            n_val, -1)[:, sel]
        log_t_end = torch.where(active[:, None], log_t_start, log_t_end)
        s_carry = torch.where(active[:, None], s_carry + u_tot, s_carry)
    return d_out


def composite_tiles_bwd(rec_t: torch.Tensor, tile_starts: torch.Tensor,
                        tile_counts: torch.Tensor, n_active: torch.Tensor,
                        log_t: torch.Tensor, d_raw: torch.Tensor, *,
                        num_tiles: int, grid_w: int, tile_h: int,
                        tile_w: int, chunk: int = 128) -> torch.Tensor:
    """Run the backward tile kernel on a CUDA tensor.

    A CPU tensor takes the plain version (`composite_tiles_bwd_torch`); a
    CUDA tensor launches `csrc/raster_bwd.cu` or raises. Each launch adds
    one to `composite_tiles_bwd.launches`; each run of the kernel, eager or
    replayed from a CUDA graph, adds one to its device counter
    (`launches.py`).
    """
    n_val = _check_bwd_args(rec_t, tile_starts, tile_counts, n_active, log_t,
                            d_raw, num_tiles, tile_h, tile_w, chunk)
    if rec_t.device.type == "cpu":
        return composite_tiles_bwd_torch(
            rec_t, tile_starts, tile_counts, n_active, log_t, d_raw,
            num_tiles=num_tiles, grid_w=grid_w, tile_h=tile_h,
            tile_w=tile_w, chunk=chunk)
    if rec_t.device.type != "cuda":
        raise ValueError(f"composite_tiles_bwd runs on cuda or cpu tensors, "
                         f"got {rec_t.device}")
    if n_val not in KERNEL_CV:
        raise ValueError(f"the CUDA kernel is built for CV in {KERNEL_CV}, "
                         f"got {n_val}")
    if (tile_h * tile_w) % 32:
        raise ValueError(f"the CUDA backward kernel needs tile_h*tile_w to "
                         f"be a multiple of 32, got {tile_h * tile_w}")
    for name, t in (("rec_t", rec_t), ("tile_starts", tile_starts),
                    ("tile_counts", tile_counts), ("n_active", n_active),
                    ("log_t", log_t), ("d_raw", d_raw)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from dynamic3dgaussians_tpu_torch import _build
    lib = _build.load_library()
    d_out = torch.zeros((GEOM_ROWS + n_val, rec_t.shape[1]),
                        dtype=torch.float32, device=rec_t.device)
    order = torch.empty((num_tiles,), dtype=torch.int32, device=rec_t.device)
    with torch.cuda.device(rec_t.device):
        stream = torch.cuda.current_stream(rec_t.device).cuda_stream
        err = lib.d3g_raster_bwd(
            rec_t.data_ptr(), rec_t.shape[1], rec_t.shape[0],
            tile_starts.data_ptr(), tile_counts.data_ptr(),
            n_active.data_ptr(), log_t.data_ptr(), d_raw.data_ptr(),
            num_tiles, grid_w, tile_h, tile_w, chunk, order.data_ptr(),
            d_out.data_ptr(),
            launches.counter(composite_tiles_bwd, rec_t.device).data_ptr(),
            stream)
    _build.check(lib, err, "raster_bwd kernel launch")
    composite_tiles_bwd.launches += 1
    return d_out


composite_tiles_bwd.launches = 0
