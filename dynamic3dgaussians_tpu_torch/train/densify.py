"""Densification and pruning in a capacity-padded table: clone, split, prune.

Port of `dynamic3dgaussians_tpu/train/densify.py`, same thresholds and
schedule:

  * statistics per step: ||dL/d(mean2D_ndc)||, a visibility count and the
    largest screen radius of each gaussian (`accumulate_stats`)
  * every `densify_every` steps of the first timestep:
      clone  grad >= 2e-4 and max(scale) <= 0.01 * scene_radius
             -> copy the row into a free slot (zeroed Adam moments there)
      split  grad >= 2e-4 and max(scale) >  0.01 * scene_radius
             -> two children x + R @ N(0, scale), scale / 1.6; child 1
                overwrites the parent, child 2 takes a free slot
      prune  opacity < 0.005 (0.25 at step 5000), and after step 3000 also
             max(scale) > 0.1 * scene_radius -> alive = False
      statistics reset to zero
  * every `opacity_reset_every` steps: opacity to 0.01, moments reset

More clones and splits than free slots: the excess is dropped and counted
in the returned statistics, never silently. The split noise comes from a
`torch.Generator` (the reference draws it from `jax.random`, whose numbers
differ): `densify` takes the noise as an argument too, so that a test can
hand both packages the same draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from dynamic3dgaussians_tpu_torch.models.gaussians import (
    GAUSSIAN_KEYS, Params, Variables, inverse_sigmoid)
from dynamic3dgaussians_tpu_torch.ops.quat import quat_to_rotmat
from dynamic3dgaussians_tpu_torch.train import optim

GRAD_THRESH = 2e-4
CLONE_SCALE_FRAC = 0.01    # of scene_radius
BIG_POINT_FRAC = 0.1
OPACITY_PRUNE = 0.005
OPACITY_PRUNE_FINAL = 0.25  # at the last densify step (i == 5000)
SPLIT_SCALE_DIV = 1.6
DENSIFY_END = 5000
BIG_PRUNE_START = 3000


class DensifyStats(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped_capacity: torch.Tensor
    n_alive: torch.Tensor


def accumulate_stats(variables: Variables, probe_grad: torch.Tensor,
                     radii: torch.Tensor) -> Variables:
    """Fold one step's densification signals in.

    probe_grad (cap, 2): gradient of the loss w.r.t. the NDC mean2d probe;
    radii (cap,) int32 screen radii of the render.
    """
    seen = radii > 0
    out = dict(variables)
    zero = torch.zeros_like(variables["denom"])
    out["means2D_gradient_accum"] = variables["means2D_gradient_accum"] + \
        torch.where(seen, torch.linalg.norm(probe_grad, dim=-1), zero)
    out["denom"] = variables["denom"] + seen.to(torch.float32)
    out["max_2D_radius"] = torch.maximum(
        variables["max_2D_radius"], torch.where(seen, radii.to(torch.float32),
                                                zero))
    return out


def _scatter_rows(params: Params, dest: torch.Tensor, src_vals: Params,
                  keys) -> Params:
    """params[k][dest[i]] = src_vals[k][i] for every key; dest == capacity
    marks a row that is not written."""
    cap = dest.shape[0]
    ok = dest < cap
    rows = torch.nonzero(ok).squeeze(1)
    out = dict(params)
    for k in keys:
        if k in params:
            v = params[k].clone()
            v[dest[rows]] = src_vals[k][rows]
            out[k] = v
    return out


def densify(params: Params, variables: Variables, opt_state: optim.AdamState,
            i: int, generator: Optional[torch.Generator] = None,
            noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> Tuple[Params, Variables, optim.AdamState, DensifyStats]:
    """One clone / split / prune pass at step i.

    The split children's noise is `noise` = (n1, n2), each (cap, 3) standard
    normal, or else drawn from `generator`.
    """
    alive = variables["alive"]
    cap = alive.shape[0]
    dev = alive.device
    r = variables["scene_radius"]

    grads = variables["means2D_gradient_accum"] / torch.clamp(
        variables["denom"], min=1e-12)
    grads = torch.nan_to_num(grads, nan=0.0)
    scales = torch.exp(params["log_scales"])
    max_scale = torch.amax(scales, dim=-1)

    hot = (grads >= GRAD_THRESH) & alive
    to_clone = hot & (max_scale <= CLONE_SCALE_FRAC * r)
    to_split = hot & (max_scale > CLONE_SCALE_FRAC * r)

    # free slots: clones first, then the split's second children
    i32 = torch.int32
    free_slots = torch.argsort(alive.to(torch.int8), stable=True)  # dead 1st
    n_free = cap - torch.sum(alive.to(i32))
    clone_rank = torch.cumsum(to_clone.to(i32), 0, dtype=i32) - 1
    n_clone_want = torch.sum(to_clone.to(i32))
    split_rank = torch.cumsum(to_split.to(i32), 0, dtype=i32) - 1 + \
        torch.minimum(n_clone_want, n_free)

    clone_ok = to_clone & (clone_rank < n_free)
    split2_ok = to_split & (split_rank < n_free)
    no_slot = torch.full_like(free_slots, cap)
    clone_dest = torch.where(
        clone_ok, free_slots[torch.clamp(clone_rank, 0, cap - 1)], no_slot)
    split2_dest = torch.where(
        split2_ok, free_slots[torch.clamp(split_rank, 0, cap - 1)], no_slot)

    # clone: copy rows verbatim into free slots
    new_params = _scatter_rows(params, clone_dest, params, GAUSSIAN_KEYS)

    # split: jitter the children by R @ N(0, scale), shrink their scales
    if noise is None:
        noise = tuple(torch.randn((cap, 3), generator=generator,
                                  dtype=torch.float32, device=dev)
                      for _ in range(2))
    R = quat_to_rotmat(params["unnorm_rotations"])

    def child(eps):
        vals = dict(params)
        vals["means3D"] = params["means3D"] + torch.einsum(
            "nij,nj->ni", R, eps * scales)
        vals["log_scales"] = params["log_scales"] - math.log(SPLIT_SCALE_DIV)
        return vals

    c1, c2 = child(noise[0]), child(noise[1])
    for k in GAUSSIAN_KEYS:           # child 1 overwrites the parent slot
        if k in new_params:
            m = to_split.reshape((-1,) + (1,) * (new_params[k].dim() - 1))
            new_params[k] = torch.where(m, c1[k], new_params[k])
    new_params = _scatter_rows(new_params, split2_dest, c2, GAUSSIAN_KEYS)

    def mark(dest):
        out = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
        out[dest.long()] = True
        return out[:cap]

    born = mark(clone_dest) | mark(split2_dest)
    alive = alive | born
    # fresh rows get fresh moments: new slots and overwritten parents
    opt_state = optim.mask_moments(opt_state, born | to_split, GAUSSIAN_KEYS)

    # prune
    opacity = torch.sigmoid(new_params["logit_opacities"][:, 0])
    thr = OPACITY_PRUNE_FINAL if i == DENSIFY_END else OPACITY_PRUNE
    to_remove = opacity < thr
    big = torch.amax(torch.exp(new_params["log_scales"]), dim=-1) > \
        BIG_POINT_FRAC * r
    if i >= BIG_PRUNE_START:
        to_remove = to_remove | big
    to_remove = to_remove & alive
    alive = alive & ~to_remove
    opt_state = optim.mask_moments(opt_state, to_remove, GAUSSIAN_KEYS)

    new_vars = dict(variables)
    new_vars["alive"] = alive
    for k in ("means2D_gradient_accum", "denom", "max_2D_radius"):
        new_vars[k] = torch.zeros_like(variables[k])

    n_cloned = torch.sum(clone_ok.to(i32))
    n_split = torch.sum(to_split.to(i32))
    stats = DensifyStats(
        n_cloned=n_cloned, n_split=n_split,
        n_pruned=torch.sum(to_remove.to(i32)),
        n_dropped_capacity=(n_clone_want - n_cloned + n_split
                            - torch.sum(split2_ok.to(i32))),
        n_alive=torch.sum(alive.to(i32)))
    return new_params, new_vars, opt_state, stats


def reset_opacity(params: Params, opt_state: optim.AdamState
                  ) -> Tuple[Params, optim.AdamState]:
    """Opacity reset to 0.01, with its moments zeroed."""
    new_params = dict(params)
    new_params["logit_opacities"] = torch.full_like(
        params["logit_opacities"],
        float(inverse_sigmoid(torch.tensor(0.01, dtype=torch.float32))))
    return new_params, optim.reset_moments(opt_state, "logit_opacities")
