"""Plain PyTorch training at t > 0: the benchmark's yardstick for a step.

From the benchmark's seeded inputs alone (the initial cloud, the cameras,
the ground-truth images), with nothing taken from the program:

  * the initial parameters: identity rotations, opacity logits 0, log
    scales from the mean squared distance to the 3 nearest points, the
    colour-correction tables at 0, semantic features 0.01 N(0, 1) from
    the seeded generator;
  * the frozen t = 0 state and the t = 1 extrapolation: the 20-NN graph
    of the foreground with weights exp(-2000 d^2) and distances d, the
    neighbour offsets, the colours, the background's start; means and
    rotations extrapolated as x + (x - x_prev);
  * one step: render (`render.py`), the per-camera colour correction, the
    image and segmentation losses (0.8 L1 + 0.2 (1 - SSIM)), the feature
    loss on the rendered features resized to the ground truth's size, the
    physics losses (rigid, rot, iso, floor, bg, soft_col_cons), their
    weighted sum, autograd, and Adam (eps 1e-15, bias-corrected, the
    learning rates of the training script, means scaled by the scene
    radius, opacities, scales and the colour correction frozen after
    t = 0).

Only the live rows exist here: the program's capacity rows past them are
dead and hold no gradient, so per-table norms compare directly. |x| has
derivative +1 at 0, the system's convention (the background and colour
terms are exactly 0 at the first step of a timestep).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference import render as R

LOSS_WEIGHTS = {"im": 5.0, "seg": 2.0, "feature": 0.1, "rigid": 4.0,
                "rot": 4.0, "iso": 2.0, "floor": 2.0, "bg": 20.0,
                "soft_col_cons": 0.01}
LRS = {"means3D": 0.00016, "rgb_colors": 0.0025, "seg_colors": 0.0,
       "unnorm_rotations": 0.001, "logit_opacities": 0.05,
       "log_scales": 0.001, "cam_m": 1e-4, "cam_c": 1e-4,
       "semantic_feature": 0.0025}
FROZEN_AFTER_T0 = ("logit_opacities", "log_scales", "cam_m", "cam_c")
KNN_BETA = 2000.0
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-15
KNN_ROWS = 4096


def knn(points: torch.Tensor, k: int):
    """Exact k nearest (self excluded): squared distances |a|^2 + |b|^2 -
    2 a.b by blocks of rows, (M, k) ascending, and their indices."""
    sq = (points * points).sum(-1)
    ds, ids = [], []
    for r0 in range(0, points.shape[0], KNN_ROWS):
        rows = points[r0:r0 + KNN_ROWS]
        d2 = torch.clamp(sq[r0:r0 + KNN_ROWS, None] + sq[None, :]
                         - 2.0 * (rows @ points.T), min=0.0)
        self_idx = torch.arange(r0, r0 + rows.shape[0], device=points.device)
        d2[torch.arange(rows.shape[0], device=points.device), self_idx] = \
            float("inf")
        d, i = torch.topk(d2, k, dim=1, largest=False)
        ds.append(d)
        ids.append(i)
    return torch.cat(ds), torch.cat(ids)


def sabs(x: torch.Tensor) -> torch.Tensor:
    """|x| with derivative +1 at 0."""
    return torch.where(x >= 0, x, -x)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of (H, W, C) images: 11x11 Gaussian window (sigma 1.5),
    zero padding, c1 = 0.01^2, c2 = 0.03^2."""
    xs = torch.arange(11, dtype=torch.float64) - 5
    g = torch.exp(-xs * xs / (2 * 1.5 ** 2))
    g = (g / g.sum()).to(torch.float32)
    ch = img1.shape[-1]
    win = (g[:, None] * g[None, :]).to(img1.device).expand(ch, 1, 11, 11)
    a = img1.permute(2, 0, 1)[None]
    b = img2.permute(2, 0, 1)[None]

    def blur(x):
        return F.conv2d(x, win, padding=5, groups=ch)

    mu1, mu2 = blur(a), blur(b)
    s11 = blur(a * a) - mu1 * mu1
    s22 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()


def image_loss(pred, gt):
    return 0.8 * sabs(pred - gt).mean() + 0.2 * (1.0 - ssim(pred, gt))


def normalize(q):
    return q * torch.rsqrt(torch.clamp((q * q).sum(-1, keepdim=True),
                                       min=1e-24))


def quat_mult(p, q):
    w1, x1, y1, z1 = p.unbind(-1)
    w2, x2, y2, z2 = q.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def conjugate(q):
    return torch.cat([q[:, :1], -q[:, 1:]], -1)


class Reference:
    """The t > 0 training state and step of one configuration.

    inputs: the benchmark's scene (`portbench/scene.py`): cloud (N, 7)
    [xyz, rgb, seg], cams (name -> reference `Cam`), frames (cam id ->
    {"im", "seg", ["feature"]}), scene_radius, feature_seed."""

    def __init__(self, inputs: Dict, cfg: Dict):
        self.cfg = cfg
        self.frames = inputs["frames"]
        self.cams = inputs["cams"]
        cloud = inputs["cloud"]
        dev = cloud.device
        n = cloud.shape[0]
        means = cloud[:, :3].contiguous()
        seg = cloud[:, 6]
        d3, _ = knn(means, 3)
        m3 = torch.clamp(d3.mean(-1), min=1e-7)
        p = {
            "means3D": means,
            "rgb_colors": cloud[:, 3:6].contiguous(),
            "seg_colors": torch.stack([seg, torch.zeros_like(seg), 1 - seg],
                                      -1),
            "unnorm_rotations": torch.tensor([1.0, 0, 0, 0],
                                             device=dev).repeat(n, 1),
            "logit_opacities": torch.zeros((n, 1), device=dev),
            "log_scales": torch.log(torch.sqrt(m3))[:, None].repeat(1, 3),
            "cam_m": torch.zeros((max(5, len(self.cams)), 3), device=dev),
            "cam_c": torch.zeros((max(5, len(self.cams)), 3), device=dev),
        }
        if cfg["semantic_dim"]:
            gen = torch.Generator(device=dev).manual_seed(
                inputs["feature_seed"])
            p["semantic_feature"] = 0.01 * torch.randn(
                (n, cfg["semantic_dim"]), generator=gen, device=dev)
        # the frozen t = 0 state, then the extrapolation to t = 1
        self.fg = seg > 0.5
        fg_rows = torch.nonzero(self.fg).squeeze(1)
        sq, nb = knn(means[fg_rows], cfg["num_knn"])
        self.nbr = fg_rows[nb]                                # (F, K)
        self.fg_rows = fg_rows
        self.w = torch.exp(-KNN_BETA * sq)
        self.dist = torch.sqrt(sq)
        rot = normalize(p["unnorm_rotations"])
        prev_pts, prev_rot = means, rot
        pts = p["means3D"]
        self.prev_offset = pts[self.nbr] - pts[fg_rows, None, :]
        self.prev_inv_rot = conjugate(rot)
        self.prev_col = p["rgb_colors"]
        self.init_bg_pts, self.init_bg_rot = means, rot
        p["means3D"] = pts + (pts - prev_pts)
        p["unnorm_rotations"] = normalize(rot + (rot - prev_rot))
        self.params = p
        self.mu = {k: torch.zeros_like(v) for k, v in p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in p.items()}
        self.step_count = 0
        radius = float(inputs["scene_radius"])
        self.lrs = {k: (0.0 if k in FROZEN_AFTER_T0 else
                        LRS[k] * (radius if k == "means3D" else 1.0))
                    for k in p}

    # -- the loss --------------------------------------------------------
    def physics(self, means, rots, rgb):
        fg_rows, nbr = self.fg_rows, self.nbr
        rel = normalize(quat_mult(rots, self.prev_inv_rot))
        rel_f = rel[fg_rows]
        offset = means[nbr] - means[fg_rows, None, :]          # (F, K, 3)
        rot_t = R.quat_to_rotmat(rel_f).transpose(1, 2)        # R^T
        in_prev = (rot_t[:, None] @ offset[..., None])[..., 0]
        w = self.w
        out = {"rigid": torch.sqrt(((in_prev - self.prev_offset) ** 2)
                                   .sum(-1) * w + 1e-20).mean()}
        out["rot"] = torch.sqrt(((rel[nbr] - rel_f[:, None]) ** 2).sum(-1)
                                * w + 1e-20).mean()
        mag = torch.sqrt((offset ** 2).sum(-1) + 1e-20)
        out["iso"] = torch.sqrt((mag - self.dist) ** 2 * w + 1e-20).mean()
        out["floor"] = torch.clamp(means[fg_rows, 1], min=0.0).mean()
        bg = ~self.fg
        out["bg"] = (sabs(means[bg] - self.init_bg_pts[bg]).sum(-1).mean()
                     + sabs(rots[bg] - self.init_bg_rot[bg]).sum(-1).mean())
        out["soft_col_cons"] = sabs(rgb - self.prev_col).sum(-1).mean()
        return out

    def loss(self, p: Dict[str, torch.Tensor], cam_id: int,
             half_batch: bool = False):
        cfg = self.cfg
        cam = self.cams[cam_id]
        frame = self.frames[cam_id]
        rots = normalize(p["unnorm_rotations"])
        chans = [p["rgb_colors"], p["seg_colors"]]
        if "semantic_feature" in p:
            chans.append(p["semantic_feature"])
        img, _ = R.render(p["means3D"], torch.exp(p["log_scales"]), rots,
                          torch.sigmoid(p["logit_opacities"][:, 0]),
                          torch.cat(chans, -1), cam, cfg["k_slots"],
                          cfg["enum_cap"])
        im = (torch.exp(p["cam_m"][cam_id])[None, None] * img[..., :3]
              + p["cam_c"][cam_id][None, None])
        gt_im, gt_seg = frame["im"], frame["seg"]
        seg = img[..., 3:6]
        if half_batch:          # a planted fault: half the rows left out
            h = im.shape[0] // 2
            im, gt_im, seg, gt_seg = im[:h], gt_im[:h], seg[:h], gt_seg[:h]
        losses = {"im": image_loss(im, gt_im), "seg": image_loss(seg, gt_seg)}
        if "semantic_feature" in p:
            gt_f = frame["feature"]
            feat = F.interpolate(img[..., 6:].permute(2, 0, 1)[None],
                                 size=tuple(gt_f.shape[:2]), mode="bilinear",
                                 align_corners=False,
                                 antialias=True)[0].permute(1, 2, 0)
            losses["feature"] = image_loss(feat, gt_f)
        losses.update(self.physics(p["means3D"], rots, p["rgb_colors"]))
        return sum(LOSS_WEIGHTS[k] * v for k, v in losses.items())

    def step(self, cam_id: int, half_batch: bool = False):
        """One training step; returns (loss, gradients)."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self.params.items()}
        loss = self.loss(leaves, cam_id, half_batch)
        keys = list(leaves)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [leaves[k] for k in keys], allow_unused=True)))
        grads = {k: torch.zeros_like(self.params[k]) if g is None else g
                 for k, g in grads.items()}
        self.step_count += 1
        bc1 = 1.0 - B1 ** self.step_count
        bc2 = 1.0 - B2 ** self.step_count
        with torch.no_grad():
            for k, g in grads.items():
                self.mu[k] = B1 * self.mu[k] + (1 - B1) * g
                self.nu[k] = B2 * self.nu[k] + (1 - B2) * g * g
                upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                            + ADAM_EPS)
                self.params[k] = self.params[k] - self.lrs[k] * upd
        return float(loss.detach()), grads


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tree.items()}


def follow(inputs: Dict, cfg: Dict, cam_ids: List[int],
           fault: Optional[str] = None) -> Dict:
    """The reference over the steps `cam_ids` from the seeded start:
    each step's loss, the first step's gradient norm per table and the
    norm of each table's change after the last step.

    fault (planted, for the control readings): "unchanged", the state
    left as it was by every step; "half_batch", each step's image and
    segmentation losses over half of the rows."""
    ref = Reference(inputs, cfg)
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
            grad_norms = norms(grads)
        del grads
    change = norms({k: ref.params[k] - start[k] for k in start})
    return dict(losses=losses, grad_norms=grad_norms, change_norms=change)


def walk_stats(inputs: Dict, cfg: Dict, cam_ids: List[int]) -> List[Dict]:
    """The work of each camera's render at the seeded start: live pairs,
    pairs read and tiles (`render.composite`), for the work counts."""
    ref = Reference(inputs, cfg)
    p = ref.params
    chans = [p["rgb_colors"], p["seg_colors"]]
    if "semantic_feature" in p:
        chans.append(p["semantic_feature"])
    out = []
    with torch.no_grad():
        for cam_id in cam_ids:
            _, st = R.render(p["means3D"], torch.exp(p["log_scales"]),
                             normalize(p["unnorm_rotations"]),
                             torch.sigmoid(p["logit_opacities"][:, 0]),
                             torch.cat(chans, -1), ref.cams[cam_id],
                             cfg["k_slots"], cfg["enum_cap"])
            st["fg_rows"] = int(ref.fg_rows.shape[0])
            st["edges"] = int(ref.nbr.numel())
            st["rows"] = int(p["means3D"].shape[0])
            st["param_floats"] = int(sum(v.numel() for k, v in p.items()))
            out.append(st)
    return out

