"""Pair-emission tables and a numpy model of the emission kernel E1 (no JAX).

Shared by the CPU tests (`test_torch_emit.py`) and the kernel-on-card
tests (`test_torch_gpu.py`, which run where JAX is absent).

`emit_table` draws a projected scene (the port's `Projected`, CPU tensors)
on a 320x208 grid of 16-px tiles (260 tiles, so a rect can outgrow every
enum_cap tested) with what the emission must get right: rects larger than
enum_cap, gaussians off screen (raw count 0) and invalid ones, dead
capacity rows at opacity 0, conics that are not positive definite, and
gaussians whose alpha bound at one of their cells sits on the cull's gate
(within an ulp or two).

`e1_model` is E1 written as a per-gaussian loop in numpy float32: test the
first min(count, enum_cap) rect cells in rect order, give the r-th passing
cell slot r while r < K, fill the other slots with the sentinel, and add
each gaussian's drop terms. Its arithmetic is that of the plain emission
on a device (`device_math`): exp, log and sqrt are torch's there (on the
CPU they are vectorised approximations: even sqrt is not always correctly
rounded), and `recip` says how it divides a tensor by a Python scalar
(PyTorch's CUDA ops multiply by the float32 reciprocal, its CPU ops
divide).
"""

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.ops.compositing import ALPHA_EPS
from dynamic3dgaussians_tpu_torch.ops.projection import Projected, tile_rect

F32 = np.float32
TILE = 16
W, H = 320, 208
GRID_W, GRID_H = W // TILE, H // TILE
GATE = F32(ALPHA_EPS * 0.999)


def torch_fn(name, device):
    """numpy float32 array -> torch.<name> of it on `device` -> numpy."""
    fn = getattr(torch, name)
    return lambda a: fn(torch.from_numpy(np.ascontiguousarray(
        a, F32)).to(device)).cpu().numpy()


def device_math(device="cpu"):
    """The plain emission's arithmetic on `device`: torch's exp, log and
    sqrt there, and whether a division by a Python scalar is a
    multiplication by its float32 reciprocal."""
    dev = torch.device(device)
    return dict(exp=torch_fn("exp", dev), log=torch_fn("log", dev),
                sqrt=torch_fn("sqrt", dev), recip=dev.type == "cuda")


def _rect_cells(tx0, ty0, tx1, n_cells, tile_h, tile_w):
    c = np.arange(n_cells, dtype=np.int64)
    rw = max(int(tx1) - int(tx0), 1)
    ty = int(ty0) + c // rw
    tx = int(tx0) + c % rw
    return tx, ty, (tx * tile_w).astype(F32), (ty * tile_h).astype(F32)


def _lam_min(a, b, c, sqrt):
    mid = F32(0.5) * (a + c)
    dif = F32(0.5) * (a - c)
    rad = np.array([dif * dif + b * b], F32)
    return np.maximum(mid - sqrt(rad)[0], F32(0.0))


def _cell_arg(x, y, lam, bx0, by0, tile_h, tile_w):
    """exp's argument -lam/2 |d|^2 at each cell box, the plain order."""
    ddx = np.maximum(np.maximum(bx0 - x, x - (bx0 + F32(tile_w - 1))),
                     F32(0.0))
    ddy = np.maximum(np.maximum(by0 - y, y - (by0 + F32(tile_h - 1))),
                     F32(0.0))
    return (F32(-0.5) * lam) * (ddx * ddx + ddy * ddy)


def e1_model(proj: Projected, opacity, tile_h, tile_w, grid_h, grid_w,
             k_cap, enum_cap, math, near_gate=None):
    """(tile_key (K*N,) int32 k-major, n_dropped_rect int32) of E1 in the
    arithmetic `math` (`device_math`). opacity None: the emission without
    the cull. `near_gate`, a list: appended the number of tested cells
    whose bound lies within one ulp of the gate."""
    exp, log, sqrt = math["exp"], math["log"], math["sqrt"]
    tx0, ty0, tx1, _, raw = (t.cpu().numpy() for t in tile_rect(
        proj, tile_h, tile_w, grid_h, grid_w))
    n, num_tiles = raw.shape[0], grid_h * grid_w
    key = np.full((k_cap, n), num_tiles, np.int32)
    total = 0
    if opacity is None or enum_cap <= k_cap:
        for g in range(n):
            count = min(int(raw[g]), k_cap)
            tx, ty, _, _ = _rect_cells(tx0[g], ty0[g], tx1[g], count, tile_h,
                                       tile_w)
            key[:count, g] = ty * grid_w + tx
            total += int(raw[g]) - count
        return key.reshape(-1), np.int64(total).astype(np.int32)

    def by_scalar(v, s):
        return v * (F32(1.0) / F32(s)) if math["recip"] else v / F32(s)

    x2d, y2d, ca, cb, cc, op = (t.cpu().numpy().astype(F32) for t in (
        proj.x2d, proj.y2d, proj.conic_a, proj.conic_b, proj.conic_c,
        opacity))
    cap = F32((grid_w + 1) * tile_w + (grid_h + 1) * tile_h)
    for g in range(n):
        lam = _lam_min(ca[g], cb[g], cc[g], sqrt)
        cells = max(min(int(raw[g]), enum_cap), 0)
        tx, ty, bx0, by0 = _rect_cells(tx0[g], ty0[g], tx1[g], cells, tile_h,
                                       tile_w)
        bound = op[g] * exp(_cell_arg(x2d[g], y2d[g], lam, bx0, by0, tile_h,
                                      tile_w))
        passing = (ty * grid_w + tx)[bound >= GATE]
        if near_gate is not None:
            near_gate.append(int(((bound >= np.nextafter(GATE, F32(0.0)))
                                  & (bound <= np.nextafter(GATE, F32(1.0))))
                                 .sum()))
        rank = passing.shape[0]
        key[:min(rank, k_cap), g] = passing[:k_cap]
        safe_op = np.maximum(op[g], F32(ALPHA_EPS))
        ratio = by_scalar(np.array([safe_op], F32), ALPHA_EPS * 0.999)
        dmax = sqrt(np.array([F32(2.0) * log(ratio)[0]
                              / np.maximum(lam, F32(1e-12))], F32))[0]
        dmax = np.minimum(dmax, cap)
        nx = (np.floor(by_scalar(x2d[g] + dmax, tile_w))
              - np.floor(by_scalar(x2d[g] - dmax, tile_w)) + F32(1.0))
        ny = (np.floor(by_scalar(y2d[g] + dmax, tile_h))
              - np.floor(by_scalar(y2d[g] - dmax, tile_h)) + F32(1.0))
        passable = int(F32(nx * ny))
        beyond = min(max(int(raw[g]) - enum_cap, 0), passable)
        total += max(rank - k_cap, 0) + beyond
    return key.reshape(-1), np.int64(total).astype(np.int32)


def emit_table(seed, n=60, enum_cap=128, math=None):
    """(Projected, opacity (N,) float32), CPU tensors, of a drawn scene on
    the GRID_H x GRID_W grid, and the number of gaussians placed on the
    gate, in the arithmetic `math` of the device the table is for
    (`device_math`, default the CPU's)."""
    math = math or device_math()
    rng = np.random.RandomState(seed)
    x = rng.uniform(-80, W + 80, n).astype(F32)
    y = rng.uniform(-80, H + 80, n).astype(F32)
    size = rng.choice(3, n, p=[0.5, 0.3, 0.2])
    radius = np.where(size == 0, rng.randint(0, 24, n),
                      np.where(size == 1, rng.randint(24, 90, n),
                               rng.randint(150, 420, n))).astype(np.int32)
    a = np.exp(rng.uniform(np.log(1e-4), np.log(0.3), n)).astype(F32)
    c = np.exp(rng.uniform(np.log(1e-4), np.log(0.3), n)).astype(F32)
    rho = np.where(rng.uniform(size=n) < 0.1, rng.uniform(1.0, 1.5, n),
                   rng.uniform(-0.99, 0.99, n))
    b = (rho * np.sqrt(a.astype(np.float64) * c)).astype(F32)
    valid = rng.uniform(size=n) > 0.1
    op = rng.uniform(0.003, 1.0, n).astype(F32)
    op[rng.uniform(size=n) < 0.15] = 0.0                 # dead rows
    op[rng.uniform(size=n) < 0.05] = F32(ALPHA_EPS)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
    proj = Projected(x2d=t(x), y2d=t(y), conic_a=t(a), conic_b=t(b),
                     conic_c=t(c), depth=t(rng.uniform(1, 9, n).astype(F32)),
                     radius=t(radius), valid=t(valid))
    tx0, ty0, tx1, _, raw = (v.numpy() for v in tile_rect(
        proj, TILE, TILE, GRID_H, GRID_W))
    # gaussians on the gate: opacity set so that the bound at one cell of
    # the tested window is the gate, nudged by -1, 0 or +1 ulp
    on_gate = 0
    for g in np.flatnonzero(rng.uniform(size=n) < 0.3):
        cells = min(int(raw[g]), enum_cap)
        if cells == 0:
            continue
        _, _, bx0, by0 = _rect_cells(tx0[g], ty0[g], tx1[g], cells, TILE,
                                     TILE)
        j = rng.randint(cells)
        lam = _lam_min(a[g], b[g], c[g], math["sqrt"])
        e = math["exp"](_cell_arg(x[g], y[g], lam, bx0[j:j + 1],
                                  by0[j:j + 1], TILE, TILE))[0]
        if not e > F32(ALPHA_EPS):
            continue
        o = F32(GATE / e)
        step = rng.randint(-1, 2)
        if step:
            o = np.nextafter(o, F32(np.inf if step > 0 else 0.0))
        if o <= F32(1.0):
            op[g] = o
            on_gate += 1
    return proj, t(op), on_gate
