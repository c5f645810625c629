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

_FIELDS = tuple(f.name for f in dataclasses.fields(RasterConfig))


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
    plan of the TPU's windowed neighbour fetch (`win_*`, neighbor_window)
    is left out: the port fetches the same neighbours through its prefix
    gather (`neighbor_indices`, `edge_rank`, `edge_row_ptr`)."""
    out = params_from_jax({k: v for k, v in variables.items()
                           if not k.startswith("win_")}, device)
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


def gaussian_model_from_jax(state: Dict, device: DeviceLike = None):
    """The reference's `GaussianModel.capture()` (numpy dicts) -> the
    port's `GaussianModel` on `device` (default `cuda`), restored from it
    unchanged; the SH degree and the semantic width are read off the
    tables. The lr settings are not part of a capture: call
    `training_setup` to train on."""
    from dynamic3dgaussians_tpu_torch.models.gaussian_model import \
        GaussianModel
    params = state["params"]
    k = np.asarray(params["features_rest"]).shape[1] + 1
    sem = params.get("semantic_feature")
    model = GaussianModel(sh_degree=int(round(np.sqrt(k))) - 1,
                          semantic_dim=0 if sem is None
                          else int(np.asarray(sem).shape[1]),
                          device=device)
    return model.restore(state)


def raster_config_from_jax(cfg) -> RasterConfig:
    """The port's RasterConfig with every field of the reference's, copied
    as it is (the two have the same fields)."""
    return RasterConfig(**{name: getattr(cfg, name) for name in _FIELDS})
