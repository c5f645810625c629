"""The render backward's pair-to-gaussian sum (U1): the CUDA kernel's
wrapper and its plain version.

The JAX package leaves the unsort and the sum over the K emission slots to
XLA (`dynamic3dgaussians_tpu/ops/sorted_raster.py::composite_bwd`). Here
the backward kernel K2 hands over one gradient column per sorted pair and
each pair's emission slot (slot = k * N + gaussian, k-major); the gradient
of the record table is, for each gaussian g and each row that carries a
gradient, the sum over its live pairs in ascending k. Both versions take
that sum starting from +0.0 and adding only the live pairs' terms, in the
same order, so they agree bitwise; neither holds a float K*N buffer.
`ops/sorted_raster.py::slot_sum` (the zeroed per-slot buffer summed over
K) is the yardstick the tests hold both to.

Columns whose slot lies outside [0, n_slots) (the static form's sink slot
n_slots = K * N) add nothing. A gaussian's live slots may be any subset of
its K slots; live slots are unique.

`unsort_sum_cuda` takes the plain version for CPU tensors and launches
`csrc/unsort.cu` for CUDA ones (two launches, no host read, so a CUDA graph
captures it; its source note says what bounds it). Each launch adds one to
`unsort_sum_cuda.launches`; each run, eager or replayed from a CUDA graph,
adds one to its device counter (`launches.py`).
"""

from __future__ import annotations

import torch

from dynamic3dgaussians_tpu_torch.ops.cuda import launches

MAX_RW = 92    # floats of a pair-major record the kernel takes (csrc MAX_RW)


def _check(slot: torch.Tensor, d_pairs: torch.Tensor, n_slots: int,
           n_gauss: int, n_rows: int) -> None:
    if d_pairs.dim() != 2 or slot.shape != (d_pairs.shape[1],):
        raise ValueError(f"slot {tuple(slot.shape)} must hold one slot per "
                         f"column of d_pairs {tuple(d_pairs.shape)}")
    if n_gauss < 0 or n_slots < 0 or (n_slots and not n_gauss) or (
            n_gauss and n_slots % n_gauss):
        raise ValueError(f"n_slots {n_slots} must be K x n_gauss {n_gauss}")
    if not 0 <= n_rows <= d_pairs.shape[0]:
        raise ValueError(f"n_rows {n_rows} must be in 0..{d_pairs.shape[0]}")


def unsort_sum_plain(slot: torch.Tensor, d_pairs: torch.Tensor,
                     n_slots: int, n_gauss: int,
                     n_rows: int) -> torch.Tensor:
    """(R, n_gauss): row r < n_rows of gaussian g is the sum, in ascending
    k, of d_pairs[r, j] (R, M) over the columns j with slot[j] (M,) = k *
    n_gauss + g; rows n_rows.. are 0. Each step is torch.where(live, acc +
    d, acc) over (n_rows, n_gauss), through an int map from slot to
    column."""
    _check(slot, d_pairs, n_slots, n_gauss, n_rows)
    rows, m = d_pairs.shape
    dev = d_pairs.device
    out = torch.zeros((rows, n_gauss), dtype=d_pairs.dtype, device=dev)
    if n_slots == 0 or n_rows == 0:
        return out
    slot = slot.long()
    live = (slot >= 0) & (slot < n_slots)
    # column m: no pair (the sink collects the dead columns, then is cut)
    col = torch.full((n_slots + 1,), m, dtype=torch.int64, device=dev)
    col[torch.where(live, slot, n_slots)] = torch.arange(m, device=dev)
    col = col[:n_slots].view(-1, n_gauss)
    d = torch.cat([d_pairs[:n_rows],
                   d_pairs.new_zeros((n_rows, 1))], 1)
    acc = torch.zeros((n_rows, n_gauss), dtype=d_pairs.dtype, device=dev)
    for c in col:
        acc = torch.where(c < m, acc + d[:, c], acc)
    out[:n_rows] = acc
    return out


def unsort_sum_cuda(slot: torch.Tensor, d_pairs: torch.Tensor,
                    n_slots: int, n_gauss: int,
                    n_rows: int) -> torch.Tensor:
    """`unsort_sum_plain`'s sum through U1 on CUDA tensors (the plain
    version on CPU ones; raises on another device). d_pairs float32 with
    unit column stride (any row stride: K2's output sliced to the pairs),
    slot int64 (cast otherwise)."""
    _check(slot, d_pairs, n_slots, n_gauss, n_rows)
    dev = d_pairs.device
    if dev.type == "cpu":
        return unsort_sum_plain(slot, d_pairs, n_slots, n_gauss, n_rows)
    if dev.type != "cuda" or slot.device != dev:
        raise ValueError(f"unsort_sum_cuda runs on cuda or cpu tensors, got "
                         f"d_pairs on {dev}, slot on {slot.device}")
    if d_pairs.dtype != torch.float32:
        raise ValueError(f"d_pairs must be float32, got {d_pairs.dtype}")
    if n_slots >= 2 ** 31:
        raise ValueError(f"{n_slots} emission slots exceed int32")
    nq = (n_rows + 1 + 3) // 4
    if 4 * nq > MAX_RW:
        raise ValueError(f"the kernel sums at most {MAX_RW - 1} rows, got "
                         f"{n_rows}")
    rows, m = d_pairs.shape
    if n_gauss == 0 or rows == 0:
        return torch.zeros((rows, n_gauss), dtype=torch.float32, device=dev)
    if m > 1 and d_pairs.stride(1) != 1:
        d_pairs = d_pairs.contiguous()
    slot = slot.to(torch.int64).contiguous()
    rec = torch.empty((max(m, 1) * nq * 4,), dtype=torch.float32, device=dev)
    slot_map = torch.empty((max(n_slots, 1),), dtype=torch.int32, device=dev)
    kend = torch.empty((n_gauss,), dtype=torch.int32, device=dev)
    out = torch.empty((rows, n_gauss), dtype=torch.float32, device=dev)
    from dynamic3dgaussians_tpu_torch import _build
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.d3g_unsort_sum(
            slot.data_ptr(), d_pairs.data_ptr(), max(d_pairs.stride(0), m),
            m, n_rows, rows, n_gauss, n_slots, rec.data_ptr(),
            slot_map.data_ptr(), kend.data_ptr(), out.data_ptr(),
            launches.counter(unsort_sum_cuda, dev).data_ptr(), stream)
    _build.check(lib, err, "unsort sum launch")
    launches.count_launch(unsort_sum_cuda, 0)
    return out


unsort_sum_cuda.launches = 0
unsort_sum_cuda.launches_by_variant = {}
