"""Bring the JAX package's training state and raster settings into the port.

The port never imports the JAX package: callers hand over plain values,
e.g. `params_from_jax(jax.tree.map(np.asarray, params), "cuda")`, numpy
copies of `variables` and of the Adam state's fields, a restored
checkpoint tree as numpy, and any object with the reference RasterConfig's
attributes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig

# Reference settings that exist only for the TPU. Each maps to the values
# that leave the numerics of the default path unchanged; anything else is
# refused rather than silently rendered differently.
_TPU_ONLY = {
    "pack_records": (False,),                   # f16 transport of records
    "power_impl": ("vpu", "mxu"),               # mxu_fused: log2-op rows
    "kernel_precision": ("highest", "high"),    # default: bf16 matmuls
}
_SEMANTIC = tuple(f.name for f in dataclasses.fields(RasterConfig))


def params_from_jax(params: Dict[str, np.ndarray],
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Host arrays of the reference's parameter dict -> tensors on `device`
    (default `cuda`); floating arrays become float32."""
    dev = resolve_device(device)
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32, copy=False)
        # a copy: host arrays may be read-only views
        out[k] = torch.tensor(a, device=dev)
    return out


def variables_from_jax(variables: Dict[str, np.ndarray],
                       device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Host arrays of the reference's `variables` (alive mask, scene
    radius, densification statistics, the kNN graph and the t - 1 state of
    a timestep t > 0) -> tensors on `device` (default `cuda`); floating
    arrays become float32, booleans stay bool. `prev_offset` goes from the
    reference's feature-major (3, K, cap) to the port's (cap, K, 3). The
    TPU's windowed neighbour fetch (`win_*`) has no counterpart and is
    refused."""
    win = sorted(k for k in variables if k.startswith("win_"))
    if win:
        raise ValueError(f"the windowed neighbour fetch {win} is not "
                         f"ported; build the state with neighbor_window "
                         f"off")
    out = params_from_jax(variables, device)
    if "prev_offset" in out:
        out["prev_offset"] = out["prev_offset"].permute(2, 1, 0).contiguous()
    return out


def adam_state_from_jax(mu: Dict[str, np.ndarray], nu: Dict[str, np.ndarray],
                        step, device: DeviceLike = None):
    """The reference's AdamState, given as numpy copies of its mu and nu
    dicts and its step count -> the port's `optim.AdamState` on `device`
    (default `cuda`)."""
    from dynamic3dgaussians_tpu_torch.train.optim import AdamState
    dev = resolve_device(device)
    return AdamState(mu=params_from_jax(mu, dev), nu=params_from_jax(nu, dev),
                     step=torch.tensor(int(np.asarray(step)),
                                       dtype=torch.int32, device=dev))


def checkpoint_from_jax(tree: Dict, device: DeviceLike = None):
    """The reference's restored checkpoint tree, as numpy ({params, opt_mu,
    opt_nu, opt_step, variables, cursor}, the layout of its
    `train/checkpoint.py::_to_pytree`) -> the port's (params, opt_state,
    variables, cursor) on `device` (default `cuda`), ready for
    `CheckpointManager.save`."""
    dev = resolve_device(device)
    cursor = {k: int(np.asarray(v)) for k, v in tree["cursor"].items()}
    return (params_from_jax(tree["params"], dev),
            adam_state_from_jax(tree["opt_mu"], tree["opt_nu"],
                                tree["opt_step"], dev),
            variables_from_jax(tree["variables"], dev), cursor)


def raster_config_from_jax(cfg) -> RasterConfig:
    """Port RasterConfig from the reference's semantic fields.

    Raises ValueError when a TPU-only field is set to a value that changes
    the numerics (pack_records=True, power_impl="mxu_fused",
    kernel_precision="default"); the other TPU-only fields (scan_impl,
    tile_batch, unsort_impl, the tiled path's capacities) only change how
    the TPU schedules the same result and are ignored.
    """
    for name, ok in _TPU_ONLY.items():
        val = getattr(cfg, name, ok[0])
        if val not in ok:
            raise ValueError(f"RasterConfig.{name}={val!r} changes the "
                             f"render's numerics and has no counterpart in "
                             f"the port (allowed: {ok})")
    return RasterConfig(**{name: getattr(cfg, name) for name in _SEMANTIC})
