"""Camera data-parallel training: each rank renders its slice of the camera
batch, and the ranks agree on one step.

Port of `dynamic3dgaussians_tpu/parallel/camera_dp.py`. Parameters,
variables and the camera batch are the same on every rank; each rank takes
its contiguous 1/K of the cameras (the reference's `P(axis)`), computes the
mean loss over them and its gradients locally (`train/trainer.py::
loss_and_grads`), and then, by `reduce`:

  "pmean"         the gradients, the probe gradient and the loss averaged
                  over the ranks (one all-reduce of one flat buffer), the
                  dead rows masked as in `make_train_step`, Adam replicated.
  "psum_scatter"  the per-gaussian gradients reduce-scattered over rows and
                  divided by K (one collective for every group), masked by
                  the rank's own `alive` rows; the camera groups
                  (`G.CAMERA_KEYS`) averaged and kept whole; Adam on the
                  rank's row shard; the updated rows all-gathered. Adam's
                  moments of the per-gaussian groups live across steps as
                  the rank's row shard and never cross the wire
                  (`shard_adam_state`, `gather_adam_state`).

In both, the radii take the max over ranks, the PSNR the mean and the drop
count the sum, and the densification statistics accumulate the averaged
probe gradient with the max radii.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.models import gaussians as G
from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig
from dynamic3dgaussians_tpu_torch.parallel import collectives as C
from dynamic3dgaussians_tpu_torch.train import densify as densify_mod
from dynamic3dgaussians_tpu_torch.train import optim
from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
from dynamic3dgaussians_tpu_torch.train.trainer import (loss_and_grads,
                                                        mask_dead_rows)

REDUCE_MODES = ("pmean", "psum_scatter")


def collate(frames) -> List[Dict]:
    """The camera batch: the datapoints in order, as a list (the form
    `make_train_step` takes; the reference stacks them into one pytree).
    Kept as the reference's entry point; the steps take any sequence."""
    return list(frames)


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat, like):
    parts = torch.split(flat, [t.numel() for t in like])
    return [p.reshape(t.shape) for p, t in zip(parts, like)]


def _row_shard(k: int, r: int, x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0] // k
    return x[r * n:(r + 1) * n]


def _check_rows(cap: int, k: int):
    if cap % k:
        raise ValueError(f"capacity {cap} must divide by the group's {k} "
                         f"ranks for reduce='psum_scatter'")


def shard_adam_state(state: optim.AdamState, group=None) -> optim.AdamState:
    """A full AdamState -> this rank's shard: the rank's 1/K of the rows of
    every per-gaussian group, the camera groups whole."""
    k, r = C.axis_size(group), C.axis_index(group)

    def shard(tree):
        out = {}
        for key, v in tree.items():
            if key not in G.CAMERA_KEYS:
                _check_rows(v.shape[0], k)
                v = _row_shard(k, r, v).clone()
            out[key] = v
        return out
    return optim.AdamState(mu=shard(state.mu), nu=shard(state.nu),
                           step=state.step)


def gather_adam_state(state: optim.AdamState, group=None) -> optim.AdamState:
    """The ranks' shards (`shard_adam_state`) -> the full AdamState, on
    every rank."""
    def gather(tree):
        return {key: v if key in G.CAMERA_KEYS else C.all_gather(v, group)
                for key, v in tree.items()}
    return optim.AdamState(mu=gather(state.mu), nu=gather(state.nu),
                           step=state.step)


def make_dp_train_step(cfg: TrainConfig, rcfg: RasterConfig, group=None,
                       reduce: str = "pmean", device: DeviceLike = None):
    """The data-parallel train step over `group` (default: the world group)
    on `device` (default `cuda`; raises without one).

    dp_train_step(params, opt_state, variables, batch, lrs, is_initial) ->
    (params, opt_state, variables, metrics {loss, psnr, n_dropped}). Every
    rank passes the same params, variables and full camera batch (a list of
    datapoints, its length divisible by the group's size) and gets the same
    params back. With reduce="psum_scatter" `opt_state` is the rank's shard
    (`shard_adam_state`) and the capacity must divide by the group's size.
    """
    if reduce not in REDUCE_MODES:
        raise ValueError(f"reduce must be one of {REDUCE_MODES}, got "
                         f"{reduce!r}")
    dev = resolve_device(device)

    def dp_train_step(params, opt_state, variables, batch, lrs,
                      is_initial: bool):
        k, r = C.axis_size(group), C.axis_index(group)
        alive = variables["alive"]
        if alive.device != dev:
            raise ValueError(f"variables are on {alive.device}, the step's "
                             f"device is {dev}")
        batch = list(batch)
        if len(batch) % k:
            raise ValueError(f"camera batch of {len(batch)} must divide by "
                             f"the group's {k} ranks")
        if reduce == "psum_scatter":
            _check_rows(alive.shape[0], k)
        per = len(batch) // k
        loss, aux, gp, gprobe = loss_and_grads(
            params, variables, batch[r * per:(r + 1) * per],
            is_initial=is_initial, cfg=cfg, rcfg=rcfg)
        with torch.no_grad():
            row_keys = [key for key in gp if key not in G.CAMERA_KEYS]
            mean_keys = list(gp) if reduce == "pmean" else \
                [key for key in gp if key in G.CAMERA_KEYS]
            mean_in = [gp[key] for key in mean_keys] + [
                gprobe, loss.reshape(1), aux["psnr"].reshape(1)]
            mean_out = _unflat(C.pmean(_flat(mean_in), group), mean_in)
            gp = dict(gp, **dict(zip(mean_keys, mean_out)))
            gprobe, loss, psnr = mean_out[-3], mean_out[-2][0], \
                mean_out[-1][0]
            radii = C.pmax(aux["radii"], group)
            n_dropped = C.psum(aux["n_dropped"].reshape(1), group)[0]
            if reduce == "pmean":
                new_params, new_opt = optim.step(
                    {key: v.detach() for key, v in params.items()},
                    mask_dead_rows(gp, alive), opt_state, lrs)
            else:
                new_params, new_opt = _sharded_adam(
                    params, gp, row_keys, opt_state, lrs, alive, k, r,
                    group)
            new_vars = densify_mod.accumulate_stats(variables, gprobe,
                                                    radii)
        metrics = {"loss": loss, "psnr": psnr, "n_dropped": n_dropped}
        return new_params, new_opt, new_vars, metrics

    return dp_train_step


def _sharded_adam(params, gp, row_keys, opt_shard, lrs, alive, k, r, group):
    """Reduce-scatter the per-gaussian gradients, Adam on the rank's rows,
    all-gather the updated rows. The groups travel as one (K, S) buffer
    whose row j holds rank j's rows of every group, flattened."""
    shard_like = [_row_shard(k, r, gp[key]) for key in row_keys]
    by_rank = torch.cat([gp[key].reshape(k, -1) for key in row_keys], 1)
    g_sh = _unflat(C.psum_scatter(by_rank, group)[0] / k, shard_like)
    grads = mask_dead_rows(dict(zip(row_keys, g_sh)),
                           _row_shard(k, r, alive))
    p_sh = {}
    for key, v in params.items():
        if key in G.CAMERA_KEYS:
            grads[key] = gp[key]
        else:
            v = _row_shard(k, r, v)
        p_sh[key] = v.detach()
    new_sh, new_opt = optim.step(p_sh, grads, opt_shard, lrs)
    gathered = C.all_gather(_flat([new_sh[key] for key in row_keys])[None],
                            group)
    cols = dict(zip(row_keys, torch.split(
        gathered, [t.numel() for t in shard_like], 1)))
    return {key: new_sh[key] if key in G.CAMERA_KEYS else
            cols[key].reshape(v.shape) for key, v in params.items()}, new_opt
