"""Training losses: image, segmentation, depth and the physics terms.

Port of `dynamic3dgaussians_tpu/train/losses.py`:

  * l1 / weighted-l2 primitives, masked mean, PSNR, Pearson correlation
  * 0.8 * L1 + 0.2 * DSSIM image loss
  * the depth Pearson loss (min over two inverse-depth variants)
  * the per-camera colour correction exp(m) * img + c
  * the default loss weights
  * the physics losses of t > 0 (`physics_losses`): rigid, rot, iso,
    floor, bg and soft_col_cons, masked at full capacity; on the card the
    edge terms (rigid, rot, iso) run through the kernel P1
  * the trainer variants' terms: total variation, the masked image loss,
    the L1 depth loss and the disparity Pearson loss
"""

from __future__ import annotations

from typing import Dict

import torch

from dynamic3dgaussians_tpu_torch.ops import quat
from dynamic3dgaussians_tpu_torch.ops.cuda import physics as P1
from dynamic3dgaussians_tpu_torch.ops.neighbor import (EdgeReduction,
                                                       lookup_components)
from dynamic3dgaussians_tpu_torch.ops.ssim import calc_ssim

DEFAULT_LOSS_WEIGHTS: Dict[str, float] = {
    "im": 5.0, "seg": 2.0, "depth": 0.0, "rigid": 4.0, "rot": 4.0,
    "iso": 2.0, "floor": 2.0, "bg": 20.0, "soft_col_cons": 0.01,
    "feature": 0.1,
}


def _abs(x):
    """|x| with derivative +1 at 0, the reference's convention (torch.abs
    has 0 there): an exact tie, such as a segmentation channel that is 0
    in both render and ground truth, then gets the reference's gradient."""
    return torch.where(x >= 0, x, -x)


def l1_loss_v1(x, y):
    return torch.mean(_abs(x - y))


def l1_loss_v2(x, y):
    return torch.mean(torch.sum(_abs(x - y), dim=-1))


def weighted_l2_loss_v1(x, y, w):
    return torch.mean(torch.sqrt((x - y) ** 2 * w + 1e-20))


def weighted_l2_loss_v2(x, y, w):
    return torch.mean(torch.sqrt(torch.sum((x - y) ** 2, dim=-1) * w
                                 + 1e-20))


def masked_mean(x, mask):
    # where (not multiply): NaN or inf in masked-out rows must not reach the
    # sum or its gradient
    m = mask.to(x.dtype)
    return (torch.sum(torch.where(mask, x, torch.zeros_like(x)))
            / torch.clamp(torch.sum(m), min=1.0))


def psnr(pred, gt):
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def pearson_corrcoef(x, y):
    x = x.reshape(-1) - torch.mean(x)
    y = y.reshape(-1) - torch.mean(y)
    denom = torch.sqrt(torch.sum(x * x) * torch.sum(y * y)) + 1e-12
    return torch.sum(x * y) / denom


def image_loss(pred, gt, l1_weight: float = 0.8):
    """0.8 * L1 + 0.2 * (1 - SSIM), channels-last images."""
    return l1_weight * l1_loss_v1(pred, gt) + (1.0 - l1_weight) * (
        1.0 - calc_ssim(pred, gt))


def depth_pearson_loss(pred_depth, gt_depth):
    """min over the two inverse-depth Pearson variants."""
    a = 1.0 - pearson_corrcoef(-gt_depth, pred_depth)
    b = 1.0 - pearson_corrcoef(1.0 / (gt_depth + 200.0), pred_depth)
    return torch.minimum(a, b)


def apply_cam_correction(img, cam_m, cam_c):
    """Per-camera affine colour correction exp(m) * img + c."""
    return torch.exp(cam_m)[None, None, :] * img + cam_c[None, None, :]


def physics_losses(act_means: torch.Tensor, act_rots: torch.Tensor,
                   rgb_colors: torch.Tensor, variables: Dict,
                   is_fg: torch.Tensor, alive: torch.Tensor) -> Dict:
    """rigid / rot / iso / floor / bg / soft_col_cons for t > 0.

    All capacity-padded: act_means (cap, 3), act_rots (cap, 4) normalised,
    rgb_colors (cap, 3) raw, is_fg and alive (cap,). `variables` carries
    the t - 1 state and the kNN graph: neighbor_indices (cap, K) (-1 =
    none), edge_rank / edge_row_ptr (its `EdgeReduction`),
    neighbor_weight and neighbor_dist (cap, K), prev_inv_rot (cap, 4),
    prev_offset (cap, K, 3), prev_col (cap, 3), init_bg_pts (cap, 3) and
    init_bg_rot (cap, 4).

    The edge terms (rigid, rot, iso) run as the plain `edge_losses_torch`
    on CPU tensors and through the kernel P1 (`ops/cuda/physics.py`) on
    CUDA ones; any other device raises.
    """
    fg = is_fg & alive
    dev = act_means.device
    if dev.type == "cpu":
        losses = edge_losses_torch(act_means, act_rots, variables, fg)
    elif dev.type == "cuda":
        losses = P1.edge_losses_cuda(act_means, act_rots, variables, fg)
    else:
        raise ValueError(f"physics_losses runs on cuda or cpu tensors, got "
                         f"{dev}")

    y = act_means[:, 1]
    losses["floor"] = masked_mean(torch.maximum(y, torch.zeros_like(y)), fg)

    # |x| with the reference's derivative at 0: on the first step of each
    # t > 0 these differences are exactly 0 (see `_abs`)
    bg = (~is_fg) & alive
    losses["bg"] = (
        masked_mean(_abs(act_means - variables["init_bg_pts"]).sum(dim=-1),
                    bg)
        + masked_mean(_abs(act_rots - variables["init_bg_rot"]).sum(dim=-1),
                      bg))
    losses["soft_col_cons"] = masked_mean(
        _abs(rgb_colors - variables["prev_col"]).sum(dim=-1), alive)
    return losses


def edge_losses_torch(act_means: torch.Tensor, act_rots: torch.Tensor,
                      variables: Dict, fg: torch.Tensor) -> Dict:
    """{"rigid", "rot", "iso"}: the edge terms of `physics_losses` over
    every (capacity row, neighbour) pair, masked to fg (foreground & alive)
    rows' valid edges. The plain version of P1 (`ops/cuda/physics.py`)."""
    idx = variables["neighbor_indices"]
    plan = EdgeReduction(variables["edge_rank"], variables["edge_row_ptr"],
                         0)
    w = variables["neighbor_weight"]                          # (cap, K)
    row_ok = fg[:, None] & (idx >= 0)

    rel_rot = quat.normalize(quat.quat_mult(act_rots,
                                            variables["prev_inv_rot"]))
    mx, my, mz = act_means.unbind(-1)
    q0, q1, q2, q3 = rel_rot.unbind(-1)
    nx, ny, nz, nq0, nq1, nq2, nq3 = lookup_components(
        (mx, my, mz, q0, q1, q2, q3), idx, plan)             # (cap, K) each
    ox, oy, oz = nx - mx[:, None], ny - my[:, None], nz - mz[:, None]

    # R^T @ offset, R built elementwise from the relative quaternion (the
    # reference's order of operations)
    r00 = 1 - 2 * (q2 * q2 + q3 * q3)
    r01 = 2 * (q1 * q2 - q0 * q3)
    r02 = 2 * (q1 * q3 + q0 * q2)
    r10 = 2 * (q1 * q2 + q0 * q3)
    r11 = 1 - 2 * (q1 * q1 + q3 * q3)
    r12 = 2 * (q2 * q3 - q0 * q1)
    r20 = 2 * (q1 * q3 - q0 * q2)
    r21 = 2 * (q2 * q3 + q0 * q1)
    r22 = 1 - 2 * (q1 * q1 + q2 * q2)
    cx = r00[:, None] * ox + r10[:, None] * oy + r20[:, None] * oz
    cy = r01[:, None] * ox + r11[:, None] * oy + r21[:, None] * oz
    cz = r02[:, None] * ox + r12[:, None] * oy + r22[:, None] * oz

    pox, poy, poz = variables["prev_offset"].unbind(-1)       # (cap, K)
    losses = {"rigid": masked_mean(torch.sqrt(
        ((cx - pox) ** 2 + (cy - poy) ** 2 + (cz - poz) ** 2) * w + 1e-20),
        row_ok)}
    losses["rot"] = masked_mean(torch.sqrt(
        ((nq0 - q0[:, None]) ** 2 + (nq1 - q1[:, None]) ** 2
         + (nq2 - q2[:, None]) ** 2 + (nq3 - q3[:, None]) ** 2) * w + 1e-20),
        row_ok)
    curr_mag = torch.sqrt(ox * ox + oy * oy + oz * oz + 1e-20)
    losses["iso"] = masked_mean(torch.sqrt(
        (curr_mag - variables["neighbor_dist"]) ** 2 * w + 1e-20), row_ok)
    return losses


def tv_loss(img) -> torch.Tensor:
    """Total-variation smoothness over the first two axes."""
    dh = torch.mean(_abs(img[1:, :] - img[:-1, :]))
    dw = torch.mean(_abs(img[:, 1:] - img[:, :-1]))
    return dh + dw


def masked_image_loss(pred, gt, mask, l1_weight: float = 0.8):
    """Image loss over the masked pixels only (the ego trainer's mask
    compositing): pixels outside the mask take the ground truth's value, so
    that neither the L1 nor the SSIM window sees an error there."""
    m = mask[..., None].to(pred.dtype) if mask.dim() == pred.dim() - 1 \
        else mask.to(pred.dtype)
    comp = pred * m + gt * (1.0 - m)
    return image_loss(comp, gt, l1_weight)


def depth_l1_loss(pred_depth, gt_depth, alpha=None, mask=None):
    """L1 depth loss over the pixels with ground truth (and inside `mask`);
    the rendered depth is un-premultiplied by `alpha` when given."""
    d = pred_depth if alpha is None else \
        pred_depth / torch.clamp(alpha, min=1e-6)
    valid = gt_depth > 1e-6
    if mask is not None:
        valid = valid & (mask > 0.5)
    return masked_mean(_abs(d - gt_depth), valid)


def disparity_pearson_loss(pred_depth, gt_depth, alpha=None):
    """1 - Pearson correlation of the two disparity maps."""
    d = pred_depth if alpha is None else \
        pred_depth / torch.clamp(alpha, min=1e-6)
    return 1.0 - pearson_corrcoef(1.0 / (d + 1e-6), 1.0 / (gt_depth + 1e-6))
