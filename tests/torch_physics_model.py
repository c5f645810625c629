"""Edge graphs and a numpy model of the physics-loss kernel P1 (no JAX).

Shared by the CPU tests (`test_torch_physics_kernel.py`) and the
kernel-on-card tests (`test_torch_gpu.py`, which run where JAX is absent).

`edge_graph` draws the inputs of the edge terms as the trainer lays them
out at t > 0: a capacity-padded table whose foreground prefix carries every
kNN edge (the plan built with n_dst, rounded up to 8 by
`build_edge_reduction`), slots with idx -1, prefix rows that are not
foreground or not alive, foreground rows past the prefix (no edges), and
optionally dead prefix rows with NaN means and rotations and no edges, as
the trainer's padding rows are.

`p1_model` is P1's four passes (`csrc/physics.cu`) in numpy float32: each
edge's forward in the kernel's order of operations, the per-block partial
sums (thread t of a block walking its edges t, t + 256, ... in order, then
the shared-memory tree) and their fixed-order final sum; in the backward
each edge's own part summed per row in order, the neighbour part scattered
to its destination-sorted slot rank[e] and each destination's run summed
in order, then the row's gradient through normalize and the quaternion
product. Its arithmetic is the CPU's: numpy's float32 operations are
correctly rounded, rsqrt is 1 / sqrt (PyTorch's CPU rsqrt; the card's
rsqrtf is within 2 ulp of it), and there is no FMA contraction (the
kernel's backward may contract).
"""

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.ops.cuda.physics import (THREADS,
                                                           rows_per_block)
from dynamic3dgaussians_tpu_torch.ops.neighbor import build_edge_reduction

F32 = np.float32
EPS2 = F32(1e-24)      # quat.normalize's clamp, eps * eps
TINY = F32(1e-20)      # the terms' sqrt floor


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(F32)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(F32)


def edge_graph(seed: int, cap: int, n_pre: int, k: int, full_plan=False,
               dead_nan=False):
    """(act_means, act_rots, variables, fg, alive) as CPU tensors, fg the
    foreground & alive mask the terms take: a (cap, k)
    graph on the first n_pre rows, its plan over that prefix (rounded up to
    8) or, with full_plan, over every row. With dead_nan some prefix rows
    are dead, with NaN means and rotations and every slot -1."""
    rng = np.random.RandomState(seed)
    means = rng.normal(scale=0.5, size=(cap, 3)).astype(F32)
    rots = _unit_quats(rng, cap)
    prev = _unit_quats(rng, cap)
    alive = np.ones(cap, bool)
    is_fg = np.zeros(cap, bool)
    is_fg[:n_pre] = True
    # prefix rows that are background, or dead with finite values, keep
    # their edges: the mask alone must drop them
    is_fg[rng.choice(n_pre, max(1, n_pre // 10), replace=False)] = False
    alive[rng.choice(n_pre, max(1, n_pre // 10), replace=False)] = False
    # foreground rows past the prefix carry no edges
    is_fg[n_pre + rng.choice(cap - n_pre, max(1, (cap - n_pre) // 4),
                             replace=False)] = True
    idx = np.full((cap, k), -1, np.int32)
    idx[:n_pre] = rng.randint(0, n_pre, size=(n_pre, k))
    idx[:n_pre][rng.uniform(size=(n_pre, k)) < 0.1] = -1
    idx[rng.randint(0, n_pre), :] = -1             # a row with no edge
    if dead_nan:
        dead = rng.choice(n_pre, max(1, n_pre // 8), replace=False)
        alive[dead] = False
        means[dead] = np.nan
        rots[dead[::2]] = np.nan
        idx[dead] = -1
        idx[np.isin(idx, dead)] = -1
    sq = rng.uniform(0.0, 0.02, size=(cap, k)).astype(F32)
    sq[idx < 0] = 0.0
    nb = means[np.maximum(idx, 0)]
    offset = (nb - means[:, None, :]
              + rng.normal(scale=0.05, size=(cap, k, 3))).astype(F32)
    plan = build_edge_reduction(idx, n_dst=None if full_plan else n_pre)
    variables = {
        "neighbor_indices": torch.as_tensor(idx),
        "edge_rank": plan.rank, "edge_row_ptr": plan.row_ptr,
        "neighbor_weight": torch.as_tensor(np.exp(-50.0 * sq).astype(F32)),
        "neighbor_dist": torch.as_tensor(np.sqrt(sq)),
        "prev_inv_rot": torch.as_tensor(
            prev * np.array([1, -1, -1, -1], F32)),
        "prev_offset": torch.as_tensor(offset),
    }
    return (torch.as_tensor(means), torch.as_tensor(rots), variables,
            torch.as_tensor(is_fg & alive), torch.as_tensor(alive))


def quat_mult(a, b):
    """ops/quat.py::quat_mult on (..., 4) float32 arrays, in its order."""
    w1, x1, y1, z1 = (a[..., c] for c in range(4))
    w2, x2, y2, z2 = (b[..., c] for c in range(4))
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], axis=-1)


def _normalize(v):
    """(v * inv, inv, |v|^2) with inv = 1 / sqrt(clamp(|v|^2, 1e-24))."""
    ss = ((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
          + v[..., 2] * v[..., 2]) + v[..., 3] * v[..., 3]
    with np.errstate(invalid="ignore"):
        inv = F32(1.0) / np.sqrt(np.where(np.isnan(ss), ss,
                                          np.maximum(ss, EPS2)))
    return v * inv[..., None], inv, ss


def _rotmat(q):
    """R[..., a, b] of the plain version's elementwise build."""
    w, x, y, z = (q[..., c] for c in range(4))
    two, one = F32(2.0), F32(1.0)
    return np.stack([
        np.stack([one - two * (y * y + z * z), two * (x * y - w * z),
                  two * (x * z + w * y)], -1),
        np.stack([two * (x * y + w * z), one - two * (x * x + z * z),
                  two * (y * z - w * x)], -1),
        np.stack([two * (x * z - w * y), two * (y * z + w * x),
                  one - two * (x * x + y * y)], -1)], -2)


def _edges(a):
    """Every prefix edge's forward, as the kernel forms it."""
    n_dst, k = a["n_dst"], a["k"]
    i = np.repeat(np.arange(n_dst), k)
    j = a["idx"][:n_dst].reshape(-1)
    valid = (j >= 0) & a["fg"][i]
    jj = np.maximum(j, 0)
    rel, _, _ = _normalize(quat_mult(a["rots"], a["prev_inv"]))
    m, n, q, nq = a["means"][i], a["means"][jj], rel[i], rel[jj]
    R = _rotmat(q)
    w = a["w"][:n_dst].reshape(-1)
    d = a["dist"][:n_dst].reshape(-1)
    po = a["po"][:n_dst].reshape(-1, 3)
    with np.errstate(invalid="ignore", over="ignore"):
        o = n - m
        c = np.stack([(R[:, 0, b] * o[:, 0] + R[:, 1, b] * o[:, 1])
                      + R[:, 2, b] * o[:, 2] for b in range(3)], -1)
        e = c - po
        rigid = np.sqrt(((e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1])
                         + e[:, 2] * e[:, 2]) * w + TINY)
        dq = nq - q
        rot = np.sqrt((((dq[:, 0] * dq[:, 0] + dq[:, 1] * dq[:, 1])
                        + dq[:, 2] * dq[:, 2]) + dq[:, 3] * dq[:, 3]) * w
                      + TINY)
        mag = np.sqrt(((o[:, 0] * o[:, 0] + o[:, 1] * o[:, 1])
                       + o[:, 2] * o[:, 2]) + TINY)
        t = mag - d
        iso = np.sqrt((t * t) * w + TINY)
    return dict(i=i, j=j, valid=valid, q=q, R=R, w=w, o=o, e=e, dq=dq,
                mag=mag, t=t, terms=np.stack([rigid, rot, iso], -1))


def _tree(acc):
    """The kernel's shared-memory tree over the last axis (THREADS)."""
    acc = acc.copy()
    s = THREADS // 2
    while s > 0:
        acc[..., :s] = acc[..., :s] + acc[..., s:2 * s]
        s //= 2
    return acc[..., 0]


def _block_sums(values, n_dst, k):
    """Pass 1: per block of rows_per_block rows, thread t's in-order sum of
    the block's edges t, t + THREADS, ..., then the tree. values: (n_dst
    K, C) with 0 where an edge is not summed."""
    rpb = rows_per_block(k)
    nb = -(-n_dst // rpb)
    per = rpb * k
    pad = np.zeros((nb * per, values.shape[1]), values.dtype)
    pad[:values.shape[0]] = values
    trips = -(-per // THREADS)
    blk = np.zeros((nb, trips * THREADS, values.shape[1]), values.dtype)
    blk[:, :per] = pad.reshape(nb, per, -1)
    blk = blk.reshape(nb, trips, THREADS, -1)
    acc = np.zeros((nb, THREADS, values.shape[1]), values.dtype)
    for r in range(trips):
        acc = acc + blk[:, r]
    return _tree(np.moveaxis(acc, 1, -1))              # (nb, C)


def _final_sum(part):
    """Pass 2: thread t sums partials t, t + THREADS, ... in order, then the
    tree. part: (nb, C)."""
    trips = max(1, -(-part.shape[0] // THREADS))
    blk = np.zeros((trips * THREADS, part.shape[1]), part.dtype)
    blk[:part.shape[0]] = part
    blk = blk.reshape(trips, THREADS, -1)
    acc = np.zeros((THREADS, part.shape[1]), part.dtype)
    for r in range(trips):
        acc = acc + blk[r]
    return _tree(acc.T)


def _rotmat_backward(q, dR):
    """d q of R(q) (csrc/physics.cu::rotmat_backward, term for term)."""
    w, x, y, z = (q[:, c] for c in range(4))
    dq = np.zeros_like(q)
    four, two = F32(4.0), F32(2.0)
    dq[:, 2] -= four * y * dR[:, 0, 0]
    dq[:, 3] -= four * z * dR[:, 0, 0]
    dq[:, 1] -= four * x * dR[:, 1, 1]
    dq[:, 3] -= four * z * dR[:, 1, 1]
    dq[:, 1] -= four * x * dR[:, 2, 2]
    dq[:, 2] -= four * y * dR[:, 2, 2]
    a01, a10 = two * dR[:, 0, 1], two * dR[:, 1, 0]
    dq[:, 1] += y * (a01 + a10)
    dq[:, 2] += x * (a01 + a10)
    dq[:, 0] += z * (a10 - a01)
    dq[:, 3] += w * (a10 - a01)
    a02, a20 = two * dR[:, 0, 2], two * dR[:, 2, 0]
    dq[:, 1] += z * (a02 + a20)
    dq[:, 3] += x * (a02 + a20)
    dq[:, 0] += y * (a02 - a20)
    dq[:, 2] += w * (a02 - a20)
    a12, a21 = two * dR[:, 1, 2], two * dR[:, 2, 1]
    dq[:, 2] += z * (a12 + a21)
    dq[:, 3] += y * (a12 + a21)
    dq[:, 0] += x * (a21 - a12)
    dq[:, 1] += w * (a21 - a12)
    return dq


def p1_model(act_means, act_rots, variables, fg, g=(1.0, 1.0, 1.0)):
    """P1's passes on CPU tensors: ((rigid, rot, iso), count, d_means (cap,
    3), d_rots (cap, 4)) as numpy float32, the gradient of g[0] rigid +
    g[1] rot + g[2] iso."""
    row_ptr = variables["edge_row_ptr"].numpy().astype(np.int64)
    a = dict(means=act_means.numpy(), rots=act_rots.numpy(),
             prev_inv=variables["prev_inv_rot"].numpy(), fg=fg.numpy(),
             idx=variables["neighbor_indices"].numpy(),
             w=variables["neighbor_weight"].numpy(),
             dist=variables["neighbor_dist"].numpy(),
             po=variables["prev_offset"].numpy(),
             n_dst=row_ptr.shape[0] - 1,
             k=variables["neighbor_indices"].shape[1])
    n_dst, k, cap = a["n_dst"], a["k"], a["means"].shape[0]
    f = _edges(a)
    valid = f["valid"]

    # forward: passes 1 and 2
    terms = np.where(valid[:, None], f["terms"], F32(0.0)).astype(F32)
    if n_dst:
        sums = _final_sum(_block_sums(terms, n_dst, k))
    else:
        sums = np.zeros(3, F32)
    count = F32(int(valid.sum()))
    den = max(count, F32(1.0))
    losses = (sums / den).astype(F32)

    # backward, pass 3: each edge's gradient
    gr, gq, gi = (F32(F32(x) / den) for x in g)
    R, o, e, dq, w = f["R"], f["o"], f["e"], f["dq"], f["w"]
    rigid, rot, iso = (f["terms"][:, c] for c in range(3))
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        dc = ((gr / (F32(2.0) * rigid)) * w)[:, None] * (F32(2.0) * e)
        do = np.einsum("nab,nb->na", R, dc).astype(F32)
        dR = (o[:, :, None] * dc[:, None, :]).astype(F32)
        dqi = _rotmat_backward(f["q"], dR)
        dqj = ((gq / (F32(2.0) * rot)) * w)[:, None] * (F32(2.0) * dq)
        dqi = dqi - dqj
        so = ((gi / (F32(2.0) * iso)) * w * (F32(2.0) * f["t"])
              / (F32(2.0) * f["mag"]))
        do = do + so[:, None] * (F32(2.0) * o)
    own = np.where(valid[:, None], np.concatenate([-do, dqi], -1), F32(0.0))
    nbr = np.where(valid[:, None], np.concatenate([do, dqj], -1), F32(0.0))
    own = own.astype(F32).reshape(n_dst, k, 7)
    own_sum = np.zeros((n_dst, 7), F32)
    for kk in range(k):                    # each row's K edges in order
        own_sum = own_sum + own[:, kk]
    scat = np.zeros((n_dst * k, 7), F32)
    has_j = f["j"] >= 0
    scat[variables["edge_rank"].numpy()[has_j]] = nbr[has_j]

    # pass 4: each destination's run in order, plus its own part
    run = np.zeros((n_dst, 7), F32)
    lens = row_ptr[1:] - row_ptr[:-1]
    for p in range(int(lens.max()) if n_dst else 0):
        on = lens > p
        run[on] = run[on] + scat[row_ptr[:-1][on] + p]
    tot = np.zeros((cap, 7), F32)
    tot[:n_dst] = own_sum + run
    d_means = tot[:, :3].copy()
    g4 = tot[:, 3:]
    v = quat_mult(a["rots"], a["prev_inv"])
    _, inv, ss = _normalize(v)
    with np.errstate(invalid="ignore", over="ignore"):
        dot = ((g4[:, 0] * v[:, 0] + g4[:, 1] * v[:, 1])
               + g4[:, 2] * v[:, 2]) + g4[:, 3] * v[:, 3]
        dss = np.where(ss >= EPS2, F32(-0.5) * dot * (inv * inv * inv),
                       F32(0.0))
        dv = g4 * inv[:, None] + dss[:, None] * (F32(2.0) * v)
    q2 = a["prev_inv"]
    w2, x2, y2, z2 = (q2[:, c] for c in range(4))
    d0, d1, d2, d3 = (dv[:, c] for c in range(4))
    d_rots = np.stack([d0 * w2 + d1 * x2 + d2 * y2 + d3 * z2,
                       -d0 * x2 + d1 * w2 - d2 * z2 + d3 * y2,
                       -d0 * y2 + d1 * z2 + d2 * w2 - d3 * x2,
                       -d0 * z2 - d1 * y2 + d2 * x2 + d3 * w2], -1)
    d_rots = np.where((g4 != 0).any(-1)[:, None], d_rots, F32(0.0))
    return losses, count, d_means, d_rots.astype(F32)
