"""The fixed neighbour graph's host-side plans (built once after t = 0).

Port of the host half of `dynamic3dgaussians_tpu/ops/neighbor.py`:

  * `locality_order`: reverse Cuthill-McKee order of the foreground kNN
    subgraph (scipy), foreground rows first, so that every edge's index
    span is bounded;
  * `build_edge_reduction`: the static plan of the neighbour lookup's
    backward, rank[e] = position of edge slot e in destination-sorted order
    and row_ptr the run boundaries per destination.

The lookup itself (`neighbor_lookup`, `lookup_components`) is part of the
t > 0 step and is not ported yet; the reference's `WindowPlan` (a TPU
matrix-unit fetch, slower there too) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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
