"""Adam with per-group runtime learning rates and moment surgery.

Port of `dynamic3dgaussians_tpu/train/optim.py`: Adam with eps 1e-15 and
torch-style bias correction over a dict of parameter tables, plus the
surgery densification needs (`reset_moments` for a replaced table,
`mask_moments` for freed or rewritten rows). It stays hand-rolled rather
than `torch.optim.Adam`, because densification edits the moment tables row
by row at the capacity-padded shapes of the parameters.

Learning rates are per-group scalars passed at each step, so a group is
frozen by passing 0.0. The state is functional, as in the reference: `step`
returns new tables and leaves its inputs untouched.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    mu: Params            # first moments, same keys and shapes as params
    nu: Params            # second moments
    step: torch.Tensor    # () int32


# lrs of the original training script; means3D is scaled by the scene
# radius at run time
DEFAULT_LRS: Dict[str, float] = {
    "means3D": 0.00016,
    "rgb_colors": 0.0025,
    "seg_colors": 0.0,
    "unnorm_rotations": 0.001,
    "logit_opacities": 0.05,
    "log_scales": 0.001,
    "cam_m": 1e-4,
    "cam_c": 1e-4,
    "semantic_feature": 0.0025,
    "label": 0.0,
}


def init(params: Params) -> AdamState:
    dev = next(iter(params.values())).device
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     step=torch.zeros((), dtype=torch.int32, device=dev))


def step(params: Params, grads: Params, state: AdamState,
         lrs: Dict[str, torch.Tensor], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-15) -> Tuple[Params, AdamState]:
    """One Adam step with torch-style bias correction, in float32."""
    t = state.step + 1
    tf = t.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=tf.device)
    # torch.full, not torch.tensor: no host-to-device copy, so the step can
    # be captured in a CUDA graph
    bc1 = 1.0 - torch.full((), b1, **f32) ** tf
    bc2 = 1.0 - torch.full((), b2, **f32) ** tf
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu = b1 * state.mu[k] + (1.0 - b1) * g
        nu = b2 * state.nu[k] + (1.0 - b2) * g * g
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        new_p[k] = p - lrs[k] * update
        new_mu[k], new_nu[k] = mu, nu
    return new_p, AdamState(mu=new_mu, nu=new_nu, step=t)


def _zero_rows(x: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return torch.zeros_like(x)
    m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
    return torch.where(m, torch.zeros_like(x), x)


def reset_moments(state: AdamState, key: str,
                  mask: torch.Tensor = None) -> AdamState:
    """Zero the moments of one group (optionally only the masked rows)."""
    mu, nu = dict(state.mu), dict(state.nu)
    mu[key] = _zero_rows(mu[key], mask)
    nu[key] = _zero_rows(nu[key], mask)
    return AdamState(mu=mu, nu=nu, step=state.step)


def mask_moments(state: AdamState, row_mask: torch.Tensor,
                 gaussian_keys) -> AdamState:
    """Zero the moment rows where row_mask is True, in every per-gaussian
    group."""
    mu, nu = dict(state.mu), dict(state.nu)
    for k in gaussian_keys:
        if k in mu:
            mu[k] = _zero_rows(mu[k], row_mask)
            nu[k] = _zero_rows(nu[k], row_mask)
    return AdamState(mu=mu, nu=nu, step=state.step)
