"""Plain PyTorch ego + static training at t > 0: the yardstick of the
`ego_static` program (`programs/ego_static.py`).

From the program's seeded inputs alone (the bench scene's initial cloud,
the static cameras' images and depth, the ego frames turned by -90
degrees and their masks), with nothing taken from the program: the t = 1
state, the physics losses and Adam of `train.py::Reference`, and a step
of its own:

  * five renders (`render.py`), one of the ego view and one of each
    static view, each of the channels [rgb, z, 1] with z the view depth:
    the composited z is the depth, the composited 1 the alpha;
  * the ego frame: the render colour-corrected by its camera's row
    (exp(cam_m) im + cam_c), turned by -90 degrees (torch.rot90, k = -1),
    composited under its mask with the ground truth (pred m + gt (1 - m))
    and held to it by 0.8 L1 + 0.2 (1 - SSIM);
  * each static frame: the same masked image loss under its mask, and the
    L1 of depth / max(alpha, 1e-6) against the ground truth depth over the
    pixels that have one (> 1e-6) inside the mask;
  * the loss: 5 x the ego term + 5 x the static terms' mean + 0.01 x the
    depth terms' mean + the physics losses, weighted as in `train.py`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.reference import render as R
from portbench.reference import train as ref_train
from portbench.reference.train import image_loss, normalize, sabs

EGO_WEIGHTS = {"im": 5.0, "stat_im": 5.0}
ALPHA_FLOOR = 1e-6
DEPTH_FLOOR = 1e-6


def depth_channels(means: torch.Tensor, cam: R.Cam) -> torch.Tensor:
    """(N, 2) [view depth, 1]: composited, the depth and the alpha."""
    hom = torch.cat([means, torch.ones_like(means[:, :1])], -1)
    z = (hom @ cam.w2c.T)[:, 2:3]
    return torch.cat([z, torch.ones_like(z)], -1)


def masked_image_loss(pred, gt, mask):
    m = mask[..., None]
    return image_loss(pred * m + gt * (1.0 - m), gt)


def depth_l1(depth, alpha, gt, mask):
    d = depth / torch.clamp(alpha, min=ALPHA_FLOOR)
    valid = (gt > DEPTH_FLOOR) & (mask > 0.5)
    return (torch.where(valid, sabs(d - gt), torch.zeros_like(d)).sum()
            / torch.clamp(valid.to(torch.float32).sum(), min=1.0))


class EgoReference(ref_train.Reference):
    """`train.py::Reference` with the ego + static step. inputs: the
    program's (`ego_static.make`): the static views under "cams" and
    "frames" (cam ids 0, 1, ...; each frame with "im", "depth", "mask"),
    the ego frames under "ego" (each {"cam", "im", "mask"}, the image and
    mask turned)."""

    def __init__(self, inputs: Dict, cfg: Dict):
        super().__init__(inputs, cfg)
        self.ego = inputs["ego"]
        self.weights = dict(ref_train.LOSS_WEIGHTS, **EGO_WEIGHTS,
                            depth=cfg["stat_depth_weight"])

    def loss(self, p: Dict[str, torch.Tensor], cam_id: int,
             half_batch: bool = False):
        """The loss of the step of ego frame `cam_id`; `half_batch` (a
        planted fault) takes half the rows out of all five image losses."""
        cfg = self.cfg
        means = p["means3D"]
        rots = normalize(p["unnorm_rotations"])
        scales = torch.exp(p["log_scales"])
        op = torch.sigmoid(p["logit_opacities"][:, 0])

        def draw(cam):
            vals = torch.cat([p["rgb_colors"], depth_channels(means, cam)],
                             -1)
            img, _ = R.render(means, scales, rots, op, vals, cam,
                              cfg["k_slots"], cfg["enum_cap"])
            return img

        def corrected(img, row):
            return (torch.exp(p["cam_m"][row])[None, None] * img[..., :3]
                    + p["cam_c"][row][None, None])

        def frame_loss(pred, gt, mask):
            if half_batch:
                h = pred.shape[0] // 2
                pred, gt, mask = pred[:h], gt[:h], mask[:h]
            return masked_image_loss(pred, gt, mask)

        ego = self.ego[cam_id]
        img = draw(ego["cam"])
        im = torch.rot90(corrected(img, cfg["ego_cam_id"]), k=-1, dims=(0, 1))
        losses = {"im": frame_loss(im, ego["im"], ego["mask"])}
        stat_im, depth = [], []
        for row, (cam, frame) in enumerate(zip(self.cams, self.frames)):
            img = draw(cam)
            stat_im.append(frame_loss(corrected(img, row), frame["im"],
                                      frame["mask"]))
            depth.append(depth_l1(img[..., 3], img[..., 4], frame["depth"],
                                  frame["mask"]))
        losses["stat_im"] = torch.stack(stat_im).mean()
        losses["depth"] = torch.stack(depth).mean()
        losses.update(self.physics(means, rots, p["rgb_colors"]))
        return sum(self.weights[k] * v for k, v in losses.items())


def follow(inputs: Dict, cfg: Dict, cam_ids: List[int],
           fault: Optional[str] = None) -> Dict:
    """The reference over the steps of ego frames `cam_ids` from the seeded
    start: each step's loss, the first step's gradient norm per table and
    the norm of each table's change after the last step.

    fault (planted, for the control readings): "unchanged", the state
    left as it was by every step; "half_batch", each step's five image
    losses over half of their rows."""
    ref = EgoReference(inputs, cfg)
    start = {k: v.clone() for k, v in ref.params.items()}
    losses, grad_norms = [], None
    for i, cam_id in enumerate(cam_ids):
        saved = {k: v.clone() for k, v in ref.params.items()} \
            if fault == "unchanged" else None
        loss, grads = ref.step(cam_id, half_batch=fault == "half_batch")
        if saved is not None:
            ref.params = saved
        losses.append(loss)
        if i == 0:
            grad_norms = ref_train.norms(grads)
        del grads
    change = ref_train.norms({k: ref.params[k] - start[k] for k in start})
    return dict(losses=losses, grad_norms=grad_norms, change_norms=change)


def walk_stats(inputs: Dict, cfg: Dict, cam_ids: List[int]) -> List[Dict]:
    """Per step, the work at the seeded start: each of its five renders'
    live pairs, pairs read and tiles (`render.composite`) and live rows,
    and the step's foreground rows, edges, rows and parameter floats."""
    ref = EgoReference(inputs, cfg)
    p = ref.params
    means = p["means3D"]
    rows = int(means.shape[0])
    args = (torch.exp(p["log_scales"]), normalize(p["unnorm_rotations"]),
            torch.sigmoid(p["logit_opacities"][:, 0]))
    out, seen = [], {}
    with torch.no_grad():
        for cam_id in cam_ids:
            if cam_id not in seen:
                renders = []
                for cam in [ref.ego[cam_id]["cam"]] + list(ref.cams):
                    vals = torch.cat([p["rgb_colors"],
                                      depth_channels(means, cam)], -1)
                    _, st = R.render(means, *args, vals, cam,
                                     cfg["k_slots"], cfg["enum_cap"])
                    renders.append(dict(st, rows=rows))
                seen[cam_id] = dict(
                    renders=renders, rows=rows,
                    fg_rows=int(ref.fg_rows.shape[0]),
                    edges=int(ref.nbr.numel()),
                    param_floats=int(sum(v.numel() for v in p.values())))
            out.append(seen[cam_id])
    return out
