"""Plain PyTorch gaussian-splat render: the benchmark's yardstick.

Written from the semantics of the system under test, in float32, with no
kernel and nothing imported from the program:

  * EWA projection (3DGS): view and clip transforms as matrix products,
    J W Sigma W^T J^T + 0.3 I with the principal-point-aware view clamp,
    conic = inverse, radius = ceil(3 sqrt(largest eigenvalue, guarded at
    0.1)), culled when behind the near plane, when the determinant is not
    positive or when the 3-sigma square misses the image;
  * pair emission on 16x16 tiles: each gaussian's tile rectangle in row
    order, the first `enum_cap` cells tested against the 1/255 alpha gate
    by the conic's smallest eigenvalue over the tile's pixel box (a cell
    that cannot pass is never a pair), and the first K passing cells kept;
  * order: by tile, then by depth quantised to 21 bits over the frame's
    live depth range, ties in emission order (k, then gaussian);
  * compositing front to back, alpha = min(0.99, op exp(power)) (0 below
    1/255); each tile walks its pairs in chunks of 128 aligned to the
    frame's pair list and stops after a chunk once every pixel's
    transmittance is at most 1e-4.

`render` returns the channels and, for the work counts, the pairs each
tile read. With gradients on, each chunk of the walk is recomputed in the
backward (`torch.utils.checkpoint`), so memory stays at one chunk of
(tiles, 256 pixels, 128 pairs).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.utils.checkpoint

TILE = 16
CHUNK = 128
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_STOP = 1e-4
EIG_GUARD = 0.1
COV2D_BLUR = 0.3
CULL_MARGIN = 0.999         # the emission's gate margin against float noise
EMIT_BLOCK = 65_536         # gaussians per block of the emission


@dataclasses.dataclass(frozen=True)
class Cam:
    w2c: torch.Tensor        # (4, 4)
    full_proj: torch.Tensor  # (4, 4) clip from world
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    near: float = 0.01


def make_cam(k, w2c, width: int, height: int, device, near: float = 0.01,
             far: float = 100.0) -> Cam:
    """OpenGL-style clip transform from 3x3 intrinsics and a 4x4
    world-to-camera matrix (nested lists or arrays of float64)."""
    f32 = dict(dtype=torch.float32, device=device)
    fx, fy, cx, cy = (float(k[0][0]), float(k[1][1]), float(k[0][2]),
                      float(k[1][2]))
    proj = torch.tensor([
        [2 * fx / width, 0.0, -(width - 2 * cx) / width, 0.0],
        [0.0, 2 * fy / height, -(height - 2 * cy) / height, 0.0],
        [0.0, 0.0, far / (far - near), -(far * near) / (far - near)],
        [0.0, 0.0, 1.0, 0.0]], **f32)
    w2c_t = torch.tensor(w2c, **f32)
    return Cam(w2c=w2c_t, full_proj=proj @ w2c_t, fx=fx, fy=fy, cx=cx,
               cy=cy, width=width, height=height, near=near)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) unit wxyz -> (N, 3, 3)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def project(means, scales, quats, cam: Cam) -> Dict[str, torch.Tensor]:
    """Screen-space gaussians: x, y, conic (a, b, c), depth, radius
    (int32, 0 when culled) and valid, each (N,)."""
    n = means.shape[0]
    hom = torch.cat([means, torch.ones_like(means[:, :1])], -1)
    clip = hom @ cam.full_proj.T
    inv_w = 1.0 / (clip[:, 3] + 1e-7)
    x = ((clip[:, 0] * inv_w + 1.0) * cam.width - 1.0) * 0.5
    y = ((clip[:, 1] * inv_w + 1.0) * cam.height - 1.0) * 0.5
    view = hom @ cam.w2c.T
    tz = view[:, 2]
    lim_x = ((cam.width - cam.cx) / cam.fx + 0.3 * cam.width / (2 * cam.fx),
             cam.cx / cam.fx + 0.3 * cam.width / (2 * cam.fx))
    lim_y = ((cam.height - cam.cy) / cam.fy
             + 0.3 * cam.height / (2 * cam.fy),
             cam.cy / cam.fy + 0.3 * cam.height / (2 * cam.fy))
    tx = torch.clamp(view[:, 0] / tz, -lim_x[1], lim_x[0]) * tz
    ty = torch.clamp(view[:, 1] / tz, -lim_y[1], lim_y[0]) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([
        torch.stack([cam.fx / tz, zero, -cam.fx * tx / (tz * tz)], -1),
        torch.stack([zero, cam.fy / tz, -cam.fy * ty / (tz * tz)], -1)], -2)
    t = jac @ cam.w2c[:3, :3]                                   # (N, 2, 3)
    rs = quat_to_rotmat(quats) * scales[:, None, :]             # R S
    cov3 = rs @ rs.transpose(1, 2)
    cov2 = t @ cov3 @ t.transpose(1, 2)
    cxx = cov2[:, 0, 0] + COV2D_BLUR
    cxy = cov2[:, 0, 1]
    cyy = cov2[:, 1, 1] + COV2D_BLUR
    det = cxx * cyy - cxy * cxy
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=EIG_GUARD))
    r = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
    on_screen = ((x + r >= 0) & (x - r <= cam.width - 1)
                 & (y + r >= 0) & (y - r <= cam.height - 1))
    valid = (tz > cam.near) & det_ok & on_screen & (r > 0)
    radius = torch.where(valid, r, torch.zeros_like(r)).to(torch.int32)
    assert radius.shape == (n,)
    return dict(x=x, y=y, a=cyy * inv_det, b=-cxy * inv_det,
                c=cxx * inv_det, depth=tz, radius=radius, valid=valid)


def grid(cam: Cam):
    return -(-cam.height // TILE), -(-cam.width // TILE)


def emit(proj: Dict[str, torch.Tensor], op: torch.Tensor, cam: Cam,
         k_slots: int, enum_cap: int):
    """The live (gaussian, tile, k) pairs: int64 (P,) each, in emission
    order (k, then gaussian). No gradient flows here."""
    grid_h, grid_w = grid(cam)
    dev = op.device
    x, y = proj["x"].detach(), proj["y"].detach()
    a, b, c = (proj[k].detach() for k in "abc")
    r = proj["radius"].to(torch.float32)
    tx0 = torch.clamp(torch.floor((x - r) / TILE), 0, grid_w)
    ty0 = torch.clamp(torch.floor((y - r) / TILE), 0, grid_h)
    tx1 = torch.clamp(torch.floor((x + r) / TILE) + 1, 0, grid_w)
    ty1 = torch.clamp(torch.floor((y + r) / TILE) + 1, 0, grid_h)
    count = torch.where(proj["valid"], (tx1 - tx0) * (ty1 - ty0),
                        torch.zeros_like(tx0)).to(torch.int64)
    mid = 0.5 * (a + c)
    dif = 0.5 * (a - c)
    lam_min = torch.clamp(mid - torch.sqrt(dif * dif + b * b), min=0.0)
    op = op.detach()
    gs, tiles, ks = [], [], []
    cells = torch.arange(enum_cap, device=dev)
    for g in torch.nonzero(count > 0).squeeze(1).split(EMIT_BLOCK):
        rw = torch.clamp(tx1[g] - tx0[g], min=1).to(torch.int64)[:, None]
        ty = ty0[g].to(torch.int64)[:, None] + cells // rw
        tx = tx0[g].to(torch.int64)[:, None] + cells % rw
        in_rect = cells[None, :] < torch.clamp(count[g], max=enum_cap)[:, None]
        bx0 = (tx * TILE).to(torch.float32)
        by0 = (ty * TILE).to(torch.float32)
        xg, yg = x[g, None], y[g, None]
        ddx = torch.clamp(torch.maximum(bx0 - xg, xg - (bx0 + (TILE - 1))),
                          min=0.0)
        ddy = torch.clamp(torch.maximum(by0 - yg, yg - (by0 + (TILE - 1))),
                          min=0.0)
        bound = op[g, None] * torch.exp(-0.5 * lam_min[g, None]
                                        * (ddx * ddx + ddy * ddy))
        ok = in_rect & (bound >= ALPHA_EPS * CULL_MARGIN)
        rank = torch.cumsum(ok.to(torch.int64), 1) - 1
        keep = ok & (rank < k_slots)
        gi, ci = torch.nonzero(keep, as_tuple=True)
        gs.append(g[gi])
        tiles.append(ty[gi, ci] * grid_w + tx[gi, ci])
        ks.append(rank[gi, ci])
    if not gs:
        empty = torch.zeros((0,), dtype=torch.int64, device=dev)
        return empty, empty, empty
    g, tile, k = torch.cat(gs), torch.cat(tiles), torch.cat(ks)
    order = torch.argsort(k * op.shape[0] + g)            # emission order
    return g[order], tile[order], k[order]


def sort_pairs(g: torch.Tensor, tile: torch.Tensor, depth: torch.Tensor,
               num_tiles: int):
    """(gaussian, tile) sorted by (tile, quantised depth), stable."""
    bits_z = 31 - max(1, num_tiles.bit_length())
    d = depth.detach()[g]
    dmin, dmax = d.min(), d.max()
    inv_width = 1.0 / torch.clamp(dmax - dmin, min=1e-20)
    u = torch.clamp((d - dmin) * inv_width, 0.0, 1.0)
    top = (1 << bits_z) - 1
    zq = torch.clamp((u * float(top) + 0.5).to(torch.int64), max=top)
    key = (tile << bits_z) | zq
    order = torch.sort(key, stable=True).indices
    return g[order], tile[order]


def _tile_pixels(num_tiles: int, grid_w: int, device):
    t = torch.arange(num_tiles, device=device)
    p = torch.arange(TILE * TILE, device=device)
    px = ((t % grid_w) * TILE)[:, None] + p % TILE
    py = (torch.div(t, grid_w, rounding_mode="floor") * TILE)[:, None] \
        + torch.div(p, TILE, rounding_mode="floor")
    return px.to(torch.float32), py.to(torch.float32)


def _chunk(t_all, acc_all, act, gid, inseg, px, py, x, y, a, b, c, op,
           vals):
    """One chunk of the walk for the active tiles `act`: returns the new
    (transmittance (T, 256), accumulators (T, 256, C))."""
    dx = x[gid][:, None, :] - px[:, :, None]                 # (A, 256, 128)
    dy = y[gid][:, None, :] - py[:, :, None]
    power = (-0.5 * (a[gid][:, None, :] * dx * dx
                     + c[gid][:, None, :] * dy * dy)
             - b[gid][:, None, :] * dx * dy)
    alpha = torch.clamp(op[gid][:, None, :]
                        * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_MAX)
    alpha = torch.where((alpha >= ALPHA_EPS) & inseg[:, None, :], alpha,
                        torch.zeros_like(alpha))
    keep = torch.cumprod(1.0 - alpha, dim=-1)
    before = torch.cat([torch.ones_like(keep[..., :1]), keep[..., :-1]], -1)
    t_in = t_all.index_select(0, act)
    w = alpha * before * t_in[:, :, None]
    contrib = torch.bmm(w, vals[gid])                        # (A, 256, C)
    return (t_all.index_copy(0, act, t_in * keep[..., -1]),
            acc_all.index_add(0, act, contrib))


def composite(g: torch.Tensor, tile: torch.Tensor, proj, op: torch.Tensor,
              vals: torch.Tensor, cam: Cam):
    """Front-to-back walk of the sorted pairs. Returns (image (H, W, C),
    stats) with stats the int counts: live pairs, pairs read (those of
    the chunks each tile walked) and tiles."""
    grid_h, grid_w = grid(cam)
    num_tiles = grid_h * grid_w
    dev = vals.device
    n_pairs = g.shape[0]
    counts = torch.bincount(tile, minlength=num_tiles)
    starts = torch.cumsum(counts, 0) - counts
    base = torch.div(starts, CHUNK, rounding_mode="floor") * CHUNK
    n_chunks = torch.where(counts > 0, -torch.div(
        -(starts - base + counts), CHUNK, rounding_mode="floor"),
        torch.zeros_like(counts))
    px_all, py_all = _tile_pixels(num_tiles, grid_w, dev)
    lane = torch.arange(CHUNK, device=dev)
    t_all = torch.ones((num_tiles, TILE * TILE), dtype=torch.float32,
                       device=dev)
    acc = torch.zeros((num_tiles, TILE * TILE, vals.shape[1]),
                      dtype=torch.float32, device=dev)
    alive = n_chunks > 0
    n_read = 0
    args = (proj["x"], proj["y"], proj["a"], proj["b"], proj["c"], op, vals)
    gpad = torch.cat([g, g.new_zeros(1)])
    for k in range(int(n_chunks.max()) if num_tiles else 0):
        if k > 0:
            alive = alive & (k < n_chunks) & (t_all.detach().amax(1) > T_STOP)
        act = torch.nonzero(alive).squeeze(1)
        if act.numel() == 0:
            break
        pos = base[act, None] + k * CHUNK + lane
        inseg = (pos >= starts[act, None]) & (pos < (starts + counts)[act,
                                                                      None])
        gid = gpad[torch.where(inseg, pos, torch.full_like(pos, n_pairs))]
        n_read += int(inseg.sum())
        fargs = (t_all, acc, act, gid, inseg, px_all[act], py_all[act]) + args
        if torch.is_grad_enabled():
            t_all, acc = torch.utils.checkpoint.checkpoint(
                _chunk, *fargs, use_reentrant=False)
        else:
            t_all, acc = _chunk(*fargs)
    img = acc.reshape(grid_h, grid_w, TILE, TILE, -1).permute(0, 2, 1, 3, 4)
    img = img.reshape(grid_h * TILE, grid_w * TILE, -1)[:cam.height,
                                                        :cam.width]
    return img, dict(live_pairs=n_pairs, read_pairs=n_read,
                     tiles=num_tiles)


def render(means, scales, quats, opacity, vals, cam: Cam, k_slots: int,
           enum_cap: int):
    """(H, W, C) composite of the channels `vals` (N, C) over black, and
    the work stats of `composite`."""
    proj = project(means, scales, quats, cam)
    op = torch.where(proj["valid"], opacity, torch.zeros_like(opacity))
    g, tile, _ = emit(proj, op, cam, k_slots, enum_cap)
    grid_h, grid_w = grid(cam)
    g, tile = sort_pairs(g, tile, proj["depth"], grid_h * grid_w)
    return composite(g, tile, proj, op, vals, cam)
