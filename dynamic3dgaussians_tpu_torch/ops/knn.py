"""k-nearest neighbours: exact by blocked distance matrix products, and
approximate by Morton-order windows.

Port of `dynamic3dgaussians_tpu/ops/knn.py`: `knn`, `mean3_sq_dist`,
`morton_codes` and `knn_approx`.
Squared distances are |a|^2 + |b|^2 - 2 a.b, the cross term a product of a
row block with a column block (float32, TF32 off on the card); a running
top-k merge over the column blocks keeps memory at row_chunk x col_chunk
and the result exact.

One difference in the mechanics: masked-out points are dropped before the
blocks are formed instead of being carried at infinite distance, so the
work scales with the points that take part, not with the table's capacity.
Equal distances may order their neighbours differently from the reference.

`knn_approx` sorts the points by 30-bit Morton code and takes the +-window
neighbours in that order as candidates, on `grids` differently shifted and
interleaved curves, merging each grid's k best into the running best with
the indices already held dropped. Plain PyTorch sorts, gathers and top-k,
as the reference computes it outside any kernel; the candidate distance
keeps the reference's order of operations, and each grid's result goes back
to the input order by the inverse of its sort permutation. The sorts here
are stable and the reference's are not, so points with equal Morton codes
may meet different candidates.
"""

from __future__ import annotations

from typing import Optional

import torch

from dynamic3dgaussians_tpu_torch.device import no_tf32


def _taking_part(points: torch.Tensor, mask: Optional[torch.Tensor]):
    """The rows of the points that query and serve (all without a mask)
    and those points as float32."""
    sel = (torch.arange(points.shape[0], device=points.device)
           if mask is None else torch.nonzero(mask).squeeze(1))
    return sel, points[sel].to(torch.float32)


def _scatter_rows(n: int, sel: torch.Tensor, best_d: torch.Tensor,
                  best_i: torch.Tensor):
    """(N, k) results from those of the rows `sel`: neighbour positions
    within `sel` become table rows; rows outside `sel` and unfound slots
    hold inf / -1."""
    k, dev = best_d.shape[1], best_d.device
    dists = torch.full((n, k), float("inf"), dtype=torch.float32, device=dev)
    idx = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    found = torch.isfinite(best_d) & (best_i >= 0)
    gi = torch.where(found, sel[torch.clamp(best_i, min=0)],
                     torch.full_like(best_i, -1))
    dists[sel] = best_d
    idx[sel] = gi.to(torch.int32)
    return dists, idx


def knn(points: torch.Tensor, k: int, *, mask: Optional[torch.Tensor] = None,
        row_chunk: int = 4096, col_chunk: int = 16384,
        exclude_self: bool = True):
    """Exact k-NN over a point set.

    points (N, D) float32; mask (N,) bool: masked-out points neither query
    nor serve as neighbours (their rows return inf / -1); exclude_self drops
    the zero-distance self match. Returns (sq_dists (N, k) float32 ascending,
    indices (N, k) int32), inf / -1 where fewer than k neighbours exist.
    """
    dev = points.device
    sel, pts = _taking_part(points, mask)
    m = pts.shape[0]
    sq = torch.sum(pts * pts, dim=-1)
    inf = torch.tensor(float("inf"), device=dev)
    out_d = [torch.empty((0, k), device=dev)]
    out_i = [torch.empty((0, k), dtype=torch.long, device=dev)]
    with no_tf32():
        for r0 in range(0, m, row_chunk):
            rows = pts[r0:r0 + row_chunk]
            rid = torch.arange(r0, r0 + rows.shape[0], device=dev)
            best_d = torch.full((rows.shape[0], k), float("inf"),
                                dtype=torch.float32, device=dev)
            best_i = torch.full((rows.shape[0], k), -1, dtype=torch.long,
                                device=dev)
            for c0 in range(0, m, col_chunk):
                cols = pts[c0:c0 + col_chunk]
                cid = torch.arange(c0, c0 + cols.shape[0], device=dev)
                d2 = (sq[r0:r0 + rows.shape[0], None] + sq[None, c0:c0
                                                           + cols.shape[0]]
                      - 2.0 * (rows @ cols.T))
                d2 = torch.clamp(d2, min=0.0)
                if exclude_self:
                    d2 = torch.where(rid[:, None] == cid[None, :], inf, d2)
                cand_d = torch.cat([best_d, d2], dim=1)
                cand_i = torch.cat([best_i, cid.expand(rows.shape[0], -1)],
                                   dim=1)
                best_d, pos = torch.topk(cand_d, k, dim=1, largest=False)
                best_i = torch.gather(cand_i, 1, pos)
            out_d.append(best_d)
            out_i.append(best_i)
    return _scatter_rows(points.shape[0], sel, torch.cat(out_d),
                         torch.cat(out_i))


def mean3_sq_dist(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  clip_min: float = 1e-7) -> torch.Tensor:
    """Mean squared distance to the 3 nearest neighbours (the log-scale
    initialisation of the original training script)."""
    d, _ = knn(points, 3, mask=mask)
    d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
    return torch.clamp(torch.mean(d, dim=-1), min=clip_min)


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every third bit (the Morton interleave)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_codes(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 shift: float = 0.0, order=(0, 1, 2)) -> torch.Tensor:
    """30-bit Morton codes (int32) of (N, 3) points in the [lo, hi] box.

    `shift` (a fraction of the domain, in [0, 0.5]) and `order` (the axis
    interleave) give differently placed curves: Morton locality breaks at
    power-of-2 cell boundaries, and shifted grids break at other ones.
    """
    # 680 of the 1024 cells: room for the shift. A true division (a Python
    # number over a tensor is a reciprocal times the number in torch)
    scale = torch.full_like(hi, 680.0) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((points - lo) * scale + shift * 680.0,
                    0.0, 1023.0).to(torch.int32)
    a, b, c = order
    return (_part1by2(q[:, a]) | (_part1by2(q[:, b]) << 1)
            | (_part1by2(q[:, c]) << 2))


# (shift, axis order) of each grid, cycled
GRIDS = ((0.0, (0, 1, 2)), (0.37, (1, 2, 0)), (0.21, (2, 0, 1)),
         (0.5, (0, 1, 2)))


def knn_approx(points: torch.Tensor, k: int, *,
               mask: Optional[torch.Tensor] = None, window: int = 32,
               grids: int = 2):
    """Approximate k-NN over Morton-order windows, O(N * window * grids).

    points (N, 3) float32; mask (N,) bool as in `knn`. Returns (sq_dists
    (N, k) float32 ascending, indices (N, k) int32), inf / -1 where no
    candidate was found.
    """
    dev = points.device
    inf = float("inf")
    sel, pts = _taking_part(points, mask)
    m = pts.shape[0]
    best_d = torch.full((m, k), inf, dtype=torch.float32, device=dev)
    best_i = torch.full((m, k), -1, dtype=torch.long, device=dev)
    if m == 0:
        return _scatter_rows(points.shape[0], sel, best_d, best_i)
    lo, hi = pts.amin(0), pts.amax(0)
    # candidate columns in the reference's order: +1, -1, +2, -2, ...
    offs = torch.tensor([o * s for o in range(1, window + 1) for s in (1, -1)],
                        device=dev)
    pos = torch.arange(m, device=dev)[:, None] + window + offs[None, :]
    pad_p = torch.full((window, 3), inf, device=dev)
    pad_i = torch.full((window,), -1, dtype=torch.long, device=dev)
    for g in range(grids):
        shift, order = GRIDS[g % len(GRIDS)]
        code = morton_codes(pts, lo, hi, shift=shift, order=order)
        perm = torch.sort(code, stable=True).indices
        s = pts[perm]
        o = torch.cat([pad_p, s, pad_p])[pos]              # (m, 2W, 3)
        ci = torch.cat([pad_i, perm, pad_i])[pos]
        d2 = ((s[:, None, 0] - o[..., 0]) ** 2 + (s[:, None, 1] - o[..., 1])
              ** 2 + (s[:, None, 2] - o[..., 2]) ** 2)
        d2 = torch.where(ci >= 0, d2, torch.full_like(d2, inf))
        gd, top = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        gi = torch.gather(ci, 1, top)
        # back to the input order
        ud, ui = torch.empty_like(gd), torch.empty_like(gi)
        ud[perm], ui[perm] = gd, gi
        # an index the running best holds already is a duplicate
        dup = (ui[:, :, None] == best_i[:, None, :]).any(-1) & (ui >= 0)
        cat_d = torch.cat([best_d, torch.where(dup, torch.full_like(ud, inf),
                                               ud)], dim=1)
        cat_i = torch.cat([best_i, ui], dim=1)
        best_d, top = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
        best_i = torch.gather(cat_i, 1, top)
    return _scatter_rows(points.shape[0], sel, best_d, best_i)
