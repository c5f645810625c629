"""The collectives of `parallel/`, with the gradients `shard_map` gives them.

The reference runs its parallel code under `shard_map(..., check_vma=False)`
and differentiates through `jax.lax` collectives. Here each rank runs the
body itself, and these functions carry the same backward rules as
`torch.autograd.Function`s:

  psum          all-reduce sum                 backward: psum
  pmean         psum / K                       backward: psum / K
  pmax          all-reduce max (no gradient: the radii are integers)
  all_gather    tiled along dim 0              backward: psum_scatter
  psum_scatter  sum, rank's rows along dim 0   backward: all_gather
  axis_index    this rank's index in the group

and the two rules of `shard_map`'s own transpose for values that every
rank holds whole (`in_specs` / `out_specs` `P()`):

  enter_replicated  identity; backward psum (the input cotangents of the
                    ranks are summed)
  exit_replicated   identity; backward / K (each rank's output cotangent
                    is one K-th of the loss that every rank computes whole)

Together they make a replicated input's gradient equal the single-device
gradient on every rank, where a body ends in `all_gather` or `psum` of a
replicated output: the output cotangent is cut to 1/K, the gather's
backward sums K such shares back to one, and the input's partial
gradients of the ranks are summed. Without `exit_replicated` the same
graph would give K times the gradient.

Which call implements a collective is chosen from the group's backend
(`_nccl`), and `implementation` names it: NCCL has every collective for
CUDA tensors; gloo has all-reduce and the list form of all-gather for CUDA
tensors but no reduce-scatter, so there the reduce-scatter is an
all-reduce followed by the rank's own rows (the same sums, K times the
bytes). Every call leaves
the data on the device it came on.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist


def axis_index(group=None) -> int:
    """This rank's index in `group`: the reference's `lax.axis_index`."""
    return dist.get_rank(group)


def axis_size(group=None) -> int:
    return dist.get_world_size(group)


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def implementation(group=None) -> Dict[str, str]:
    """The call behind each collective for `group`'s backend."""
    if _nccl(group):
        return {"all_reduce": "all_reduce",
                "all_gather": "all_gather_into_tensor",
                "reduce_scatter": "reduce_scatter_tensor"}
    return {"all_reduce": "all_reduce", "all_gather": "all_gather",
            "reduce_scatter": "all_reduce+own_rows"}


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    k = dist.get_world_size(group)
    x = x.detach().contiguous()
    if not _nccl(group):
        parts = [torch.empty_like(x) for _ in range(k)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, 0)
    out = x.new_empty((k * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    k = dist.get_world_size(group)
    if x.shape[0] % k:
        raise ValueError(f"psum_scatter: {x.shape[0]} rows do not divide by "
                         f"the group's {k} ranks")
    if not _nccl(group):
        full = _all_reduce(x, dist.ReduceOp.SUM, group)
        return full.chunk(k, 0)[dist.get_rank(group)].clone()
    x = x.detach().contiguous()
    out = x.new_empty((x.shape[0] // k,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, dist.ReduceOp.SUM, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _reduce_scatter(ct, ctx.group), None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_gather(ct, ctx.group), None


class _EnterReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, dist.ReduceOp.SUM, ctx.group), None


class _ExitReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.k = dist.get_world_size(group)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct / ctx.k, None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks of `group`; `lax.psum`."""
    return _Psum.apply(x, group)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the ranks of `group`; `lax.pmean`."""
    return _Psum.apply(x, group) / dist.get_world_size(group)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max over the ranks of `group`; `lax.pmax`. No gradient."""
    return _all_reduce(x, dist.ReduceOp.MAX, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' `x` concatenated along dim 0 in rank order;
    `lax.all_gather(..., tiled=True)`."""
    return _AllGather.apply(x, group)


def psum_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's 1/K of the rows of the sum over ranks;
    `lax.psum_scatter(..., scatter_dimension=0, tiled=True)`."""
    return _PsumScatter.apply(x, group)


def enter_replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mark `x` as an input every rank holds whole (see the module note)."""
    return _EnterReplicated.apply(x, group)


def exit_replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mark `x` as an output every rank holds whole (see the module note)."""
    return _ExitReplicated.apply(x, group)
