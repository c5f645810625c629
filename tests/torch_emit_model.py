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

`gaussian_walks` is the emission written as a per-gaussian loop in numpy
float32: test the first min(count, enum_cap) rect cells in rect order
and keep the passing ones, with each gaussian's drop terms. `e1_model`
lays them out in the reference's K slots (the r-th passing cell in slot r
while r < K, the sentinel in the others); `e1_compact_model` is the
kernel E1's three passes, which write the live pairs compacted in slot
order. Their arithmetic is that of the plain emission on a device
(`device_math`): exp, log and sqrt are torch's there (on the CPU they are
vectorised approximations: even sqrt is not always correctly rounded),
and `recip` says how it divides a tensor by a Python scalar (PyTorch's
CUDA ops multiply by the float32 reciprocal, its CPU ops divide).
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
    sqrt there, whether a division by a Python scalar is a multiplication
    by its float32 reciprocal, and the int32 a NaN casts to there."""
    dev = torch.device(device)
    nan_i32 = int(torch.tensor([float("nan")], device=dev).to(torch.int32)
                  .cpu()[0])
    return dict(exp=torch_fn("exp", dev), log=torch_fn("log", dev),
                sqrt=torch_fn("sqrt", dev), recip=dev.type == "cuda",
                nan_i32=nan_i32)


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


def gaussian_walks(proj: Projected, opacity, tile_h, tile_w, grid_h,
                   grid_w, k_cap, enum_cap, math, near_gate=None,
                   skip_dead=False):
    """Per gaussian, in the arithmetic `math` (`device_math`): (the tile
    keys of its passing cells in rect order, all of them; its drop
    terms). opacity None (or enum_cap <= K): the emission without the
    cull, whose "passing" cells are the first min(count, K) rect cells.
    `near_gate`, a list: appended the number of tested cells whose bound
    lies within one ulp of the gate. skip_dead: E1's early-out, no walk
    for a gaussian with !(op >= gate)."""
    exp, log, sqrt = math["exp"], math["log"], math["sqrt"]
    tx0, ty0, tx1, _, raw = (t.cpu().numpy() for t in tile_rect(
        proj, tile_h, tile_w, grid_h, grid_w))
    n = raw.shape[0]
    keys, drops = [], []
    if opacity is None or enum_cap <= k_cap:
        for g in range(n):
            count = min(int(raw[g]), k_cap)
            tx, ty, _, _ = _rect_cells(tx0[g], ty0[g], tx1[g],
                                       max(count, 0), tile_h, tile_w)
            keys.append((ty * grid_w + tx).astype(np.int32))
            drops.append(int(raw[g]) - count)
        return keys, drops

    def by_scalar(v, s):
        return v * (F32(1.0) / F32(s)) if math["recip"] else v / F32(s)

    x2d, y2d, ca, cb, cc, op = (t.cpu().numpy().astype(F32) for t in (
        proj.x2d, proj.y2d, proj.conic_a, proj.conic_b, proj.conic_c,
        opacity))
    cap = F32((grid_w + 1) * tile_w + (grid_h + 1) * tile_h)
    for g in range(n):
        lam = _lam_min(ca[g], cb[g], cc[g], sqrt)
        cells = max(min(int(raw[g]), enum_cap), 0)
        if skip_dead and not op[g] >= GATE:
            cells = 0
        tx, ty, bx0, by0 = _rect_cells(tx0[g], ty0[g], tx1[g], cells, tile_h,
                                       tile_w)
        bound = op[g] * exp(_cell_arg(x2d[g], y2d[g], lam, bx0, by0, tile_h,
                                      tile_w))
        keys.append((ty * grid_w + tx)[bound >= GATE].astype(np.int32))
        if near_gate is not None:
            near_gate.append(int(((bound >= np.nextafter(GATE, F32(0.0)))
                                  & (bound <= np.nextafter(GATE, F32(1.0))))
                                 .sum()))
        safe_op = np.maximum(op[g], F32(ALPHA_EPS))
        ratio = by_scalar(np.array([safe_op], F32), ALPHA_EPS * 0.999)
        dmax = sqrt(np.array([F32(2.0) * log(ratio)[0]
                              / np.maximum(lam, F32(1e-12))], F32))[0]
        dmax = np.minimum(dmax, cap)
        nx = (np.floor(by_scalar(x2d[g] + dmax, tile_w))
              - np.floor(by_scalar(x2d[g] - dmax, tile_w)) + F32(1.0))
        ny = (np.floor(by_scalar(y2d[g] + dmax, tile_h))
              - np.floor(by_scalar(y2d[g] - dmax, tile_h)) + F32(1.0))
        area = F32(nx * ny)
        passable = math["nan_i32"] if np.isnan(area) else int(area)
        beyond = min(max(int(raw[g]) - enum_cap, 0), passable)
        drops.append(max(keys[-1].shape[0] - k_cap, 0) + beyond)
    return keys, drops


def e1_model(proj: Projected, opacity, tile_h, tile_w, grid_h, grid_w,
             k_cap, enum_cap, math, near_gate=None):
    """(tile_key (K*N,) int32 k-major, n_dropped_rect int32) of the K-slot
    emission in the arithmetic `math` (`device_math`): the r-th passing
    cell in slot r while r < K, the sentinel in the other slots, each
    gaussian's drop terms added. opacity None: the emission without the
    cull. `near_gate` as in `gaussian_walks`."""
    keys, drops = gaussian_walks(proj, opacity, tile_h, tile_w, grid_h,
                                 grid_w, k_cap, enum_cap, math, near_gate)
    n = len(keys)
    key = np.full((k_cap, n), grid_h * grid_w, np.int32)
    for g, kg in enumerate(keys):
        key[:min(kg.shape[0], k_cap), g] = kg[:k_cap]
    return key.reshape(-1), np.int64(sum(drops)).astype(np.int32)


def e1_compact_model(proj: Projected, opacity, tile_h, tile_w, grid_h,
                     grid_w, k_cap, enum_cap, math, pair_cap=None,
                     block=256):
    """E1's three passes in numpy: (tile (M,) int32, slot (M,) int32,
    counts [live pairs, past the capacity], n_dropped_rect int32), M the
    live count or pair_cap.

    Pass 1: each gaussian's pairs n(g) (its walk skipped where !(op >=
    gate)), per block b of `block` gaussians and slot k the count #{g in
    b : n(g) > k} and the block's drops (uint32, modular); pass 2: each
    slot row's exclusive prefix over blocks and its total; pass 3: slot
    k's pairs start at the sum of the earlier rows' totals, the block's
    at that plus its prefix, a gaussian's at that plus the pairs of the
    block's earlier warps (popc of their ballots of n > k) plus its rank
    among its warp's lanes (popc of the ballot below its lane)."""
    keys, drops = gaussian_walks(proj, opacity, tile_h, tile_w, grid_h,
                                 grid_w, k_cap, enum_cap, math,
                                 skip_dead=True)
    n = len(keys)
    num_tiles = grid_h * grid_w
    n_of = np.array([min(k.shape[0], k_cap) for k in keys], np.int64)
    nb = -(-n // block)
    # pass 1
    cnt = np.zeros((k_cap + 1, nb), np.uint32)
    for b in range(nb):
        ng = n_of[b * block:(b + 1) * block]
        for k in range(k_cap):
            cnt[k, b] = np.uint32((ng > k).sum())
        cnt[k_cap, b] = np.uint32(sum(drops[b * block:(b + 1) * block])
                                  % 2 ** 32)
    # pass 2
    totals = cnt.sum(1, dtype=np.uint64) % 2 ** 32
    prefix = np.cumsum(cnt, 1, dtype=np.uint64) - cnt
    # pass 3
    base = np.cumsum(totals[:k_cap]) - totals[:k_cap]
    n_live = int(totals[:k_cap].sum())
    cap = n_live if pair_cap is None else pair_cap
    tile = np.full((cap,), num_tiles, np.int32)
    slot = np.full((cap,), k_cap * n, np.int32)
    for b in range(nb):
        lo = b * block
        ng = np.zeros((block,), np.int64)
        ng[:min(block, n - lo)] = n_of[lo:lo + block]
        warps = ng.reshape(-1, 32)
        bal = [[sum(1 << lane for lane in range(32) if w[lane] > k)
                for k in range(k_cap)] for w in warps]
        pre = np.zeros((len(warps), k_cap), np.int64)
        for w in range(1, len(warps)):
            pre[w] = pre[w - 1] + [bin(v).count("1") for v in bal[w - 1]]
        for i in range(min(block, n - lo)):
            g, w, lane = lo + i, i // 32, i % 32
            for r in range(int(ng[i])):
                at = int(base[r] + prefix[r, b] + pre[w, r]
                         + bin(bal[w][r] & ((1 << lane) - 1)).count("1"))
                if at < cap:
                    tile[at] = keys[g][r]
                    slot[at] = r * n + g
    counts = np.array([n_live, max(n_live - cap, 0)], np.int64)
    return tile, slot, counts, np.int32(np.int64(totals[k_cap]) - (
        2 ** 32 if totals[k_cap] >= 2 ** 31 else 0))


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
