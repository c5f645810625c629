"""LPIPS perceptual distance over an AlexNet feature tower.

Port of `dynamic3dgaussians_tpu/eval/lpips.py`: `LPIPSNet` is the AlexNet
convolution tower (features tapped after each ReLU, max-pooling 3/2 after
the first two) with the LPIPS linear heads, as an `nn.Module`; the
convolutions are `F.conv2d` with TF32 off, as the reference computes them
outside any kernel. Weights are OIHW here and HWIO in the reference;
`state_sha256` hashes them in the reference's HWIO order, so one set of
weights has one digest in both packages.

No pretrained weights ship with the repository and nothing is downloaded:
`load_torch_weights` reads a torchvision AlexNet state dict (optionally
with the lpips package's heads) from a file and raises without one.
`random_features_params` draws a fixed random tower from numpy exactly as
the reference draws it; its distances are not LPIPS, only a repeatable
perceptual-style distance for tests.

Masked use (mLPIPS): pixels outside `mask` take gt's values, and each tap's
spatial map is averaged over the mask resized to the tap by nearest
neighbour with half-pixel centres (`nearest-exact`, as `jax.image.resize`).
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dynamic3dgaussians_tpu_torch.device import no_tf32

# AlexNet tower: (out_ch, kernel, stride, pad) per layer; a tap after each
# ReLU, max-pooling after the first two
ALEX = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
        (256, 3, 1, 1))
POOL_AFTER = (0, 1)
# torchvision's alexnet().features indices of the five convolutions
TORCHVISION_CONVS = (0, 3, 6, 8, 10)

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "weights", "lpips_alex.pth")


class LPIPSNet(nn.Module):
    """The AlexNet tower and one linear head per tap."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList()
        cin = 3
        for cout, k, s, p in ALEX:
            self.convs.append(nn.Conv2d(cin, cout, k, stride=s, padding=p))
            cin = cout
        for i, (cout, _, _, _) in enumerate(ALEX):
            self.register_buffer(f"lin{i}", torch.full((cout,), 1.0 / cout))

    @property
    def lins(self) -> List[torch.Tensor]:
        return [getattr(self, f"lin{i}") for i in range(len(ALEX))]

    def features(self, img: torch.Tensor) -> List[torch.Tensor]:
        """img (H, W, 3) in [0, 1] -> the five (h, w, c) ReLU maps."""
        shift = torch.as_tensor(_SHIFT, device=img.device)
        scale = torch.as_tensor(_SCALE, device=img.device)
        x = ((img * 2.0 - 1.0 - shift) / scale).permute(2, 0, 1)[None]
        feats = []
        with no_tf32():
            for li, (conv, (_, _, s, p)) in enumerate(zip(self.convs, ALEX)):
                x = F.conv2d(x, conv.weight, stride=s, padding=p)
                x = F.relu(x + conv.bias[:, None, None])
                feats.append(x[0].permute(1, 2, 0))
                if li in POOL_AFTER:
                    x = F.max_pool2d(x, 3, 2)
        return feats

    def forward(self, pred, gt, mask=None):
        return lpips_fn(self, pred, gt, mask)


def random_features_params(seed: int = 0) -> LPIPSNet:
    """A random (fixed by `seed`) tower: NOT LPIPS.

    The same numpy draws as the reference's `random_features_params`, so
    both packages hold the same weights; for tests and regression-style
    distances only. The trained metric comes from `load_torch_weights`.
    """
    rng = np.random.RandomState(seed)
    net = LPIPSNet()
    cin = 3
    with torch.no_grad():
        for conv, (cout, k, _, _) in zip(net.convs, ALEX):
            w = rng.normal(0, np.sqrt(2.0 / (k * k * cin)),
                           (k, k, cin, cout)).astype(np.float32)
            conv.weight.copy_(torch.as_tensor(w.transpose(3, 2, 0, 1)))
            conv.bias.zero_()
            cin = cout
    return net


def from_torch_modules(convs: Sequence[nn.Conv2d],
                       lins: Optional[Sequence] = None) -> LPIPSNet:
    """An LPIPSNet from five torch AlexNet convolutions in tower order
    (e.g. the Conv2d members of torchvision's alexnet().features) and,
    optionally, the lpips package's five trained heads (default: uniform
    averaging). Raises ValueError when the geometry is not the tower's."""
    convs = list(convs)
    if len(convs) != len(ALEX):
        raise ValueError(f"expected {len(ALEX)} conv layers, got "
                         f"{len(convs)}")
    net = LPIPSNet()
    cin = 3
    with torch.no_grad():
        for dst, conv, (cout, k, s, p) in zip(net.convs, convs, ALEX):
            if tuple(conv.weight.shape) != (cout, cin, k, k):
                raise ValueError(f"conv weight {tuple(conv.weight.shape)} "
                                 f"!= OIHW {(cout, cin, k, k)}")
            if tuple(conv.stride) != (s, s) or tuple(conv.padding) != (p, p):
                raise ValueError(
                    f"conv stride/pad {conv.stride}/{conv.padding} != "
                    f"alex tower ({s},{s})/({p},{p})")
            dst.weight.copy_(conv.weight.detach().float())
            dst.bias.copy_(conv.bias.detach().float())
            cin = cout
        if lins is not None:
            lins = list(lins)
            if len(lins) != len(ALEX):
                raise ValueError("need one linear head per tap")
            for i, h in enumerate(lins):
                getattr(net, f"lin{i}").copy_(torch.as_tensor(
                    np.asarray(h, np.float32).reshape(-1)))
    return net


def load_torch_weights(expected_sha256: Optional[str] = None,
                       path: str = DEFAULT_WEIGHTS) -> LPIPSNet:
    """The trained tower from a torchvision AlexNet state dict at `path`
    (keys features.<i>.weight / .bias, optionally the lpips heads as
    lin<i>.model.1.weight), behind a checksum gate: with
    `expected_sha256` (see `state_sha256`), a mismatch raises instead of
    loading the wrong weights. Raises RuntimeError when the file is
    missing; nothing is downloaded."""
    if not os.path.exists(path):
        raise RuntimeError(
            f"pretrained AlexNet unavailable (no weights at {path}); convert "
            "your own checkpoint with from_torch_modules, or use the "
            "quarantined random_features_params for smoke tests")
    state = torch.load(path, map_location="cpu", weights_only=True)
    convs = []
    for i, (cout, k, s, p) in zip(TORCHVISION_CONVS, ALEX):
        w = state[f"features.{i}.weight"]
        conv = nn.Conv2d(w.shape[1], w.shape[0], w.shape[2], stride=s,
                         padding=p)
        with torch.no_grad():
            conv.weight.copy_(w)
            conv.bias.copy_(state[f"features.{i}.bias"])
        convs.append(conv)
    lins = None
    if "lin0.model.1.weight" in state:
        lins = [state[f"lin{i}.model.1.weight"].reshape(-1).numpy()
                for i in range(len(ALEX))]
    net = from_torch_modules(convs, lins)
    if expected_sha256 is not None:
        got = state_sha256(net)
        if got != expected_sha256:
            raise RuntimeError(
                f"AlexNet weight checksum mismatch: {got} != "
                f"{expected_sha256}: wrong or corrupted checkpoint on disk")
    return net


def state_sha256(net: LPIPSNet) -> str:
    """Hex sha256 of every conv weight (in HWIO order) and bias, float32
    little-endian, in tower order: the reference's digest."""
    h = hashlib.sha256()
    for conv in net.convs:
        w = conv.weight.detach().cpu().numpy().transpose(2, 3, 1, 0)
        h.update(np.ascontiguousarray(w, "<f4").tobytes())
        h.update(np.asarray(conv.bias.detach().cpu().numpy(), "<f4")
                 .tobytes())
    return h.hexdigest()


def lpips_fn(net: LPIPSNet, pred: torch.Tensor, gt: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LPIPS distance between (H, W, 3) images in [0, 1]; with `mask`
    (H, W), the masked spatial mean of each tap (mLPIPS)."""
    if mask is not None:
        m = mask[..., None].to(pred.dtype)
        pred = pred * m + gt * (1 - m)
    fp = net.features(pred)
    fg = net.features(gt)
    total = torch.zeros((), dtype=torch.float32, device=pred.device)
    for lin, a, b in zip(net.lins, fp, fg):
        a = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True),
                            min=1e-10)
        b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True),
                            min=1e-10)
        d = ((a - b) ** 2) @ lin                           # (h, w)
        if mask is not None:
            ms = F.interpolate(mask.to(torch.float32)[None, None],
                               size=tuple(d.shape), mode="nearest-exact")[0, 0]
            total = total + torch.sum(d * ms) / torch.clamp(torch.sum(ms),
                                                            min=1.0)
        else:
            total = total + torch.mean(d)
    return total
