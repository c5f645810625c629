"""The edge terms of the physics losses (P1): the CUDA kernel's wrapper.

The JAX package's `train/losses.py::physics_losses` is left to XLA; the
port's plain version of its three edge terms, rigid, rot and iso, is
`train/losses.py::edge_losses_torch`, PyTorch ops over every (capacity row,
neighbour) pair. The kernel `csrc/physics.cu` computes the same three
masked means and their gradient into the activated means and rotations
over the edge plan's destination prefix only (its source note says how,
and what bounds it): four launches, two forward and two backward, fixed-
order sums and no float atomics, so a replayed window is bitwise
repeatable. `physics_losses` sends the edge terms here for CUDA tensors.

`edge_losses_cuda` is differentiable in `act_means` and `act_rots`. Each
forward adds one to `edge_losses_cuda.launches` and each backward one to
`edge_grads_cuda.launches`; each run, eager or replayed from a CUDA graph,
adds one to the function's device counter (`launches.py`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from dynamic3dgaussians_tpu_torch.ops.cuda import launches

THREADS = 256      # threads of a block (csrc/physics.cu THREADS)
MAX_EDGES = 1024   # edges of a block (csrc/physics.cu MAX_EDGES)
MAX_K = MAX_EDGES  # neighbours per row the kernel takes
SCAT_F = 8         # floats of a scatter record and of a row's own part


def rows_per_block(k: int) -> int:
    """Rows of a block: as many as keep its edges within MAX_EDGES."""
    return max(1, min(THREADS, MAX_EDGES // k))


def _tensor(name: str, t: torch.Tensor, shape, dtype, dev) -> torch.Tensor:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, "
                         f"got {tuple(t.shape)} {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the means on {dev}")
    t = t.contiguous()
    # the kernel reads rows of 4 floats as float4
    return t if t.data_ptr() % 16 == 0 else t.clone()


class Inputs(NamedTuple):
    """The kernel's tensors, in the order of the C entry points."""
    means: torch.Tensor        # (cap, 3)
    rots: torch.Tensor         # (cap, 4) normalised
    prev_inv: torch.Tensor     # (cap, 4)
    fg: torch.Tensor           # (cap,) bool, foreground & alive
    idx: torch.Tensor          # (cap, K) int32, -1 = none
    weight: torch.Tensor       # (cap, K)
    dist: torch.Tensor         # (cap, K)
    prev_offset: torch.Tensor  # (cap, K, 3)
    rank: torch.Tensor         # (n_dst K,) int32
    row_ptr: torch.Tensor      # (n_dst + 1,) int32

    @property
    def n_dst(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def k(self) -> int:
        return self.idx.shape[1]

    def common(self) -> list:
        """The C entry points' shared leading arguments."""
        return [t.data_ptr() for t in self[:8]] + [
            self.n_dst, self.k, rows_per_block(self.k)]


def kernel_inputs(act_means: torch.Tensor, act_rots: torch.Tensor,
                  variables: Dict, fg: torch.Tensor) -> Inputs:
    """The kernel's tensors, checked. Raises on what the kernel does not
    take; neighbour indices of another integer type are cast to int32."""
    dev = act_means.device
    if dev.type != "cuda":
        raise ValueError(f"edge_losses_cuda runs on cuda tensors, got {dev}")
    f32, i32 = torch.float32, torch.int32
    idx = variables["neighbor_indices"]
    if idx.dim() != 2:
        raise ValueError(f"neighbor_indices must be (cap, K), got "
                         f"{tuple(idx.shape)}")
    cap, k = idx.shape
    if not 0 < k <= MAX_K:
        raise ValueError(f"the kernel takes 1..{MAX_K} neighbours, got {k}")
    if idx.dtype != i32:
        idx = idx.to(i32)
    row_ptr = variables["edge_row_ptr"]
    n_dst = row_ptr.shape[0] - 1
    if not 0 <= n_dst <= cap:
        raise ValueError(f"the edge plan has {n_dst} rows, the table {cap}")
    if n_dst * k >= 2 ** 31:
        raise ValueError(f"{n_dst} x {k} edges exceed int32")
    return Inputs(
        _tensor("act_means", act_means, (cap, 3), f32, dev),
        _tensor("act_rots", act_rots, (cap, 4), f32, dev),
        _tensor("prev_inv_rot", variables["prev_inv_rot"], (cap, 4), f32,
                dev),
        _tensor("fg", fg, (cap,), torch.bool, dev),
        _tensor("neighbor_indices", idx, (cap, k), i32, dev),
        _tensor("neighbor_weight", variables["neighbor_weight"], (cap, k),
                f32, dev),
        _tensor("neighbor_dist", variables["neighbor_dist"], (cap, k), f32,
                dev),
        _tensor("prev_offset", variables["prev_offset"], (cap, k, 3), f32,
                dev),
        _tensor("edge_rank", variables["edge_rank"], (n_dst * k,), i32, dev),
        _tensor("edge_row_ptr", row_ptr, (n_dst + 1,), i32, dev))


def edge_losses_fwd(ins: Inputs) -> Tuple[torch.Tensor, ...]:
    """Passes 1 and 2: (rigid, rot, iso, count), 0-d float32 tensors."""
    from dynamic3dgaussians_tpu_torch import _build
    lib = _build.load_library()
    dev = ins.means.device
    nb = max(1, -(-ins.n_dst // rows_per_block(ins.k)))
    part = torch.empty((nb * 3,), dtype=torch.float32, device=dev)
    part_count = torch.empty((nb,), dtype=torch.int32, device=dev)
    out = [torch.empty((), dtype=torch.float32, device=dev)
           for _ in range(4)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.d3g_physics_fwd(
            *ins.common(), part.data_ptr(), part_count.data_ptr(),
            *[t.data_ptr() for t in out],
            launches.counter(edge_losses_cuda, dev).data_ptr(), stream)
    _build.check(lib, err, "physics edge losses launch")
    launches.count_launch(edge_losses_cuda, 0)
    return tuple(out)


def edge_grads_cuda(ins: Inputs, count: torch.Tensor, g_rigid, g_rot,
                    g_iso) -> Tuple[torch.Tensor, torch.Tensor]:
    """Passes 3 and 4: (d act_means (cap, 3), d act_rots (cap, 4)) of
    rigid g_rigid + rot g_rot + iso g_iso, the upstream 0-d tensors read
    on the device (None: 0); `count` is the forward's."""
    from dynamic3dgaussians_tpu_torch import _build
    lib = _build.load_library()
    dev = ins.means.device
    cap = ins.means.shape[0]
    scat = torch.empty((max(ins.n_dst * ins.k, 1) * SCAT_F,),
                       dtype=torch.float32, device=dev)
    own = torch.empty((max(ins.n_dst, 1) * SCAT_F,), dtype=torch.float32,
                      device=dev)
    d_means = torch.empty((cap, 3), dtype=torch.float32, device=dev)
    d_rots = torch.empty((cap, 4), dtype=torch.float32, device=dev)
    gs = [None if g is None else _tensor(name, g, (), torch.float32, dev)
          for name, g in (("g_rigid", g_rigid), ("g_rot", g_rot),
                          ("g_iso", g_iso))]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.d3g_physics_bwd(
            *ins.common(), cap, *[None if g is None else g.data_ptr()
                                  for g in gs],
            count.data_ptr(), ins.rank.data_ptr(),
            ins.row_ptr.data_ptr(), scat.data_ptr(), own.data_ptr(),
            d_means.data_ptr(), d_rots.data_ptr(),
            launches.counter(edge_grads_cuda, dev).data_ptr(), stream)
    _build.check(lib, err, "physics edge gradients launch")
    launches.count_launch(edge_grads_cuda, 0)
    return d_means, d_rots


class _EdgeLosses(torch.autograd.Function):
    """(rigid, rot, iso) of the kernel; the backward recomputes every
    edge's forward (nothing per edge is saved)."""

    @staticmethod
    def forward(ctx, *tensors):
        rigid, rot, iso, count = edge_losses_fwd(Inputs(*tensors))
        ctx.save_for_backward(*tensors, count)
        return rigid, rot, iso

    @staticmethod
    def backward(ctx, g_rigid, g_rot, g_iso):
        *tensors, count = ctx.saved_tensors
        none = (None,) * (len(tensors) - 2)
        if not any(ctx.needs_input_grad[:2]):
            return (None, None) + none
        return edge_grads_cuda(Inputs(*tensors), count, g_rigid, g_rot,
                               g_iso) + none


def edge_losses_cuda(act_means: torch.Tensor, act_rots: torch.Tensor,
                     variables: Dict, fg: torch.Tensor) -> Dict:
    """{"rigid", "rot", "iso"} of `train/losses.py::edge_losses_torch`
    through the kernel, for CUDA tensors (raises for others): act_means
    (cap, 3), act_rots (cap, 4) normalised, fg (cap,) foreground & alive,
    and `variables`' neighbor_indices, neighbor_weight, neighbor_dist,
    prev_inv_rot, prev_offset, edge_rank and edge_row_ptr."""
    rigid, rot, iso = _EdgeLosses.apply(
        *kernel_inputs(act_means, act_rots, variables, fg))
    return {"rigid": rigid, "rot": rot, "iso": iso}


edge_losses_cuda.launches = 0
edge_losses_cuda.launches_by_variant = {}
edge_grads_cuda.launches = 0
edge_grads_cuda.launches_by_variant = {}
