"""Exact k-nearest neighbours by blocked distance matrix products.

Port of `knn` and `mean3_sq_dist` of `dynamic3dgaussians_tpu/ops/knn.py`.
Squared distances are |a|^2 + |b|^2 - 2 a.b, the cross term a product of a
row block with a column block (float32, TF32 off on the card); a running
top-k merge over the column blocks keeps memory at row_chunk x col_chunk
and the result exact.

One difference in the mechanics: masked-out points are dropped before the
blocks are formed instead of being carried at infinite distance, so the
work scales with the points that take part, not with the table's capacity.
Equal distances may order their neighbours differently from the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from dynamic3dgaussians_tpu_torch.device import no_tf32


def knn(points: torch.Tensor, k: int, *, mask: Optional[torch.Tensor] = None,
        row_chunk: int = 4096, col_chunk: int = 16384,
        exclude_self: bool = True):
    """Exact k-NN over a point set.

    points (N, D) float32; mask (N,) bool: masked-out points neither query
    nor serve as neighbours (their rows return inf / -1); exclude_self drops
    the zero-distance self match. Returns (sq_dists (N, k) float32 ascending,
    indices (N, k) int32), inf / -1 where fewer than k neighbours exist.
    """
    n = points.shape[0]
    dev = points.device
    dists = torch.full((n, k), float("inf"), dtype=torch.float32, device=dev)
    idx = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    sel = (torch.arange(n, device=dev) if mask is None
           else torch.nonzero(mask).squeeze(1))
    pts = points[sel].to(torch.float32)
    m = pts.shape[0]
    if m == 0:
        return dists, idx
    sq = torch.sum(pts * pts, dim=-1)
    inf = torch.tensor(float("inf"), device=dev)
    out_d, out_i = [], []
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
            out_i.append(torch.where(torch.isfinite(best_d), best_i,
                                     torch.full_like(best_i, -1)))
    bd = torch.cat(out_d)
    bi = torch.cat(out_i)
    gi = torch.where(bi >= 0, sel[torch.clamp(bi, min=0)],
                     torch.full_like(bi, -1))
    dists[sel] = bd
    idx[sel] = gi.to(torch.int32)
    return dists, idx


def mean3_sq_dist(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  clip_min: float = 1e-7) -> torch.Tensor:
    """Mean squared distance to the 3 nearest neighbours (the log-scale
    initialisation of the original training script)."""
    d, _ = knn(points, 3, mask=mask)
    d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
    return torch.clamp(torch.mean(d, dim=-1), min=clip_min)
