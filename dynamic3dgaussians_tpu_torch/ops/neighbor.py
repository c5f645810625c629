"""The fixed neighbour graph: its host-side plans and the lookup of t > 0.

Port of `dynamic3dgaussians_tpu/ops/neighbor.py`:

  * `locality_order`: reverse Cuthill-McKee order of the foreground kNN
    subgraph (scipy), foreground rows first, so that every edge's index
    span is bounded;
  * `build_edge_reduction`: the static plan of the neighbour lookup's
    backward, rank[e] = position of edge slot e in destination-sorted order
    and row_ptr the run boundaries per destination;
  * `neighbor_lookup` / `lookup_components`: the row gather of every
    gaussian's K neighbours, whose backward sums each destination's edges
    over that plan in a fixed order (no atomics).

Layout: row-major, (cap, K, F) records and (cap, K) components; the
reference keeps them feature-major (F, K, cap) only for the TPU's lanes.
The reference's `WindowPlan` (`neighbor_window=True`: a TPU matrix-unit
fetch of the same neighbours, exact and slower there too) has no
counterpart: the port runs `neighbor_lookup` for it, the same values.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import reverse_cuthill_mckee


class EdgeReduction(NamedTuple):
    """Static backward plan for a fixed neighbour graph."""
    rank: torch.Tensor     # (rows * K,) int32 destination-sorted position
    row_ptr: torch.Tensor  # (rows + 1,) int32 run boundaries per destination
    n_valid: int           # number of valid edges


def locality_order(idx: np.ndarray, rows: np.ndarray, cap: int) -> np.ndarray:
    """(cap,) permutation: `rows` first, in reverse Cuthill-McKee order of
    their subgraph of the (cap, K) kNN graph `idx` (-1 = no edge), then the
    other rows in their order."""
    idx = np.asarray(idx)
    rows = np.asarray(rows)
    n_sub = rows.shape[0]
    inv_sub = np.full(cap, -1, np.int64)
    inv_sub[rows] = np.arange(n_sub)
    sub_idx = inv_sub[np.maximum(idx[rows], 0)]
    sub_idx[idx[rows] < 0] = -1
    src = np.repeat(np.arange(n_sub), sub_idx.shape[1])
    dst = sub_idx.reshape(-1)
    ok = dst >= 0
    a = coo_matrix((np.ones(ok.sum(), np.int8), (src[ok], dst[ok])),
                   shape=(n_sub, n_sub)).tocsr()
    a = a + a.T
    sub_order = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))
    rest = np.ones(cap, bool)
    rest[rows] = False
    return np.concatenate([rows[sub_order], np.flatnonzero(rest)])


def build_edge_reduction(idx: np.ndarray, n_dst: Optional[int] = None,
                         device="cpu") -> EdgeReduction:
    """The backward plan of the (cap, K) neighbour indices `idx` (-1 =
    invalid), as tensors on `device`.

    n_dst restricts the plan to the first n_dst destination rows (rounded
    up to 8), for a graph that lives on a prefix of the table (the
    foreground rows after the locality reorder); every valid edge must then
    lie in that prefix, source and destination.
    """
    idx = np.asarray(idx)
    cap = idx.shape[0]
    if n_dst is not None and n_dst < cap:
        n_dst = min(-(-n_dst // 8) * 8, cap)
        if not (idx[n_dst:] < 0).all():
            raise ValueError("valid edges beyond n_dst: reorder the "
                             "foreground rows to the front first")
        if not (idx[:n_dst] < n_dst).all():
            raise ValueError("an edge source lies outside the prefix")
        idx = idx[:n_dst]
    rows = idx.shape[0]
    j = idx.reshape(-1).astype(np.int64)
    invalid = j < 0
    order = np.argsort(np.where(invalid, rows, j), kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    counts = np.bincount(j[~invalid], minlength=rows)
    row_ptr = np.zeros(rows + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return EdgeReduction(
        torch.as_tensor(rank.astype(np.int32), device=device),
        torch.as_tensor(row_ptr.astype(np.int32), device=device),
        int((~invalid).sum()))


class _Lookup(torch.autograd.Function):
    """rec[i, k] = tbl[idx[i, k]] over the plan's destination prefix; the
    backward sums each table row's edges in destination-sorted order."""

    @staticmethod
    def forward(ctx, tbl, idx, rank, row_ptr):
        cap = idx.shape[0]
        n_dst = row_ptr.shape[0] - 1
        rec = tbl[torch.clamp(idx[:n_dst], min=0).long()]   # (n_dst, K, F)
        if n_dst < cap:
            rec = torch.cat([rec, rec.new_zeros((cap - n_dst,)
                                                + rec.shape[1:])])
        ctx.save_for_backward(rank, row_ptr)
        ctx.tbl_shape = tuple(tbl.shape)
        return rec

    @staticmethod
    def backward(ctx, d_rec):
        rank, row_ptr = ctx.saved_tensors
        cap, f = ctx.tbl_shape
        n_dst = row_ptr.shape[0] - 1
        d_edges = d_rec[:n_dst].reshape(-1, f)             # (n_dst * K, F)
        # destination-sorted: a permutation, so a plain indexed store
        s = torch.empty_like(d_edges)
        s[rank.long()] = d_edges
        # each destination's run summed in order; the invalid edges sort
        # past row_ptr[-1] and drop out
        d_tbl = d_rec.new_zeros((cap, f))
        d_tbl[:n_dst] = torch.segment_reduce(s, "sum",
                                             offsets=row_ptr.long(), axis=0)
        return d_tbl, None, None, None


def neighbor_lookup(tbl: torch.Tensor, idx: torch.Tensor,
                    plan: EdgeReduction) -> torch.Tensor:
    """(cap, K, F) records rec[i, k] = tbl[idx[i, k]], differentiable in
    `tbl`.

    An invalid slot (idx < 0) reads row 0 and passes no gradient; under a
    prefix plan (built with n_dst < cap) the rows at or past n_dst read
    0.0. Downstream masks both. `plan` must be `build_edge_reduction` of
    the same `idx`. The backward is deterministic: every table row sums its
    edges over the plan's static destination order.
    """
    return _Lookup.apply(tbl, idx, plan.rank, plan.row_ptr)


def lookup_components(tbl_cols: Sequence[torch.Tensor], idx: torch.Tensor,
                      plan: EdgeReduction) -> Tuple[torch.Tensor, ...]:
    """(cap,) columns in, one (cap, K) neighbour component per column out."""
    rec = neighbor_lookup(torch.stack(list(tbl_cols), dim=-1), idx, plan)
    return tuple(rec.unbind(-1))
