"""Front-to-back alpha compositing of depth-ordered chunks (plain PyTorch).

Port of `dynamic3dgaussians_tpu/ops/compositing.py`. Per chunk of G
gaussians against P pixels:

  alpha[g, p] = min(0.99, opacity_g * exp(power_{g,p}))   (zeroed < 1/255)
  w[g, p]     = alpha * prod_{j<g} (1 - alpha[j, p]) * T_in[p]
  acc[p, :]  += w.T @ values[g, :]
  T_out[p]    = T_in[p] * prod_g (1 - alpha[g, p])

The values rows carry the channels, the view depth and a constant 1 (the
accumulated alpha). The oracle renderer (`rasterize_ref.py`) is built on
these functions.
"""

from __future__ import annotations

from typing import Tuple

import torch

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99


def chunk_alpha(mean2d: torch.Tensor, conic: torch.Tensor,
                opacity: torch.Tensor, valid: torch.Tensor,
                px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """(G, P) alpha of one chunk with the clamp/skip rules applied.

    mean2d (G, 2), conic (G, 3), opacity (G,), valid (G,) bool, px/py (P,).
    """
    dx = mean2d[:, 0:1] - px[None, :]
    dy = mean2d[:, 1:2] - py[None, :]
    a, b, c = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    power = torch.clamp(power, max=0.0)
    alpha = torch.clamp(opacity[:, None] * torch.exp(power), max=ALPHA_MAX)
    alpha = torch.where(alpha < ALPHA_EPS, torch.zeros_like(alpha), alpha)
    return torch.where(valid[:, None], alpha, torch.zeros_like(alpha))


def composite_chunk(T_in: torch.Tensor, acc_in: torch.Tensor,
                    alpha: torch.Tensor, values: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one depth-ordered chunk into the running composite.

    T_in (P,), acc_in (P, C), alpha (G, P), values (G, C) -> (T_out, acc_out).
    """
    one_minus = 1.0 - alpha
    cp = torch.cumprod(one_minus, dim=0)
    tw_excl = torch.cat([torch.ones_like(cp[:1]), cp[:-1]], dim=0)
    w = alpha * tw_excl * T_in[None, :]
    acc_out = acc_in + w.T @ values
    return T_in * cp[-1], acc_out


def pack_values(colors: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Stack the linear channel rows: [colors..., view_z, 1]."""
    ones = torch.ones_like(depth)
    return torch.cat([colors, depth[:, None], ones[:, None]], dim=-1)


def finalize(T: torch.Tensor, acc: torch.Tensor, bg: torch.Tensor):
    """Split the accumulator and add the background: C + T_final * bg.

    Returns (channels (P, C), depth (P,), alpha (P,)).
    """
    n_chan = acc.shape[-1] - 2
    channels = acc[:, :n_chan] + T[:, None] * bg[None, :n_chan]
    return channels, acc[:, n_chan], acc[:, n_chan + 1]
