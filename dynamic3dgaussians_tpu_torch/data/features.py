"""Offline dense-feature extraction (DINOv2-style) for feature fields.

Port of `dynamic3dgaussians_tpu/data/features.py`: per-frame dense ViT
patch features blended from an overlapping multi-crop pyramid, one GLOBAL
PCA fit down to `out_dim` (32) channels, and per-frame .npy maps that the
feature-field trainers read as ground truth.

The extractor is pluggable: any
`extract_fn(image (h, w, 3) float in [0, 1]) -> (h // patch, w // patch, F)`
works. `make_dinov2_extractor` wraps a DINOv2 module: one the caller passes
in, or the one in the local torch-hub cache when its code and weights are
already there. Nothing is downloaded: without either it raises.

The pyramid and PCA math is NumPy (offline data preparation), the same
arithmetic as the reference's.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


def multicrop_boxes(h: int, w: int, crop: int, overlap: float = 0.5
                    ) -> List[Tuple[int, int]]:
    """Top-left corners of overlapping square crops covering (h, w):
    stride crop * (1 - overlap), the last row and column snapped to the
    border."""
    stride = max(1, int(crop * (1.0 - overlap)))

    def starts(size):
        ss = list(range(0, max(size - crop, 0) + 1, stride))
        if not ss or ss[-1] != size - crop:
            ss.append(max(size - crop, 0))
        return sorted(set(ss))

    return [(y, x) for y in starts(h) for x in starts(w)]


def _bilinear_resize(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Bilinear resize with half-pixel centres, edges clamped (NumPy)."""
    h, w = img.shape[:2]
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None, None]
    fx = np.clip(xs - x0, 0, 1)[None, :, None]
    v = img if img.ndim == 3 else img[..., None]
    out = ((1 - fy) * (1 - fx) * v[y0][:, x0]
           + (1 - fy) * fx * v[y0][:, x1]
           + fy * (1 - fx) * v[y1][:, x0]
           + fy * fx * v[y1][:, x1])
    return out if img.ndim == 3 else out[..., 0]


def blend_feature_pyramid(image: np.ndarray, extract_fn: Callable,
                          crop_sizes: Sequence[int] = (224, 448),
                          out_hw: Optional[Tuple[int, int]] = None,
                          overlap: float = 0.5) -> np.ndarray:
    """Dense (H', W', F) feature map from overlapping multi-scale crops:
    each crop's patch features are upsampled bilinearly to its footprint in
    the output, and overlapping contributions are averaged."""
    h, w = image.shape[:2]
    oh, ow = out_hw or (h, w)
    acc: Optional[np.ndarray] = None
    weight = np.zeros((oh, ow, 1), np.float32)
    sy, sx = oh / h, ow / w
    for crop in crop_sizes:
        c = min(crop, h, w)
        for (y, x) in multicrop_boxes(h, w, c, overlap):
            feats = extract_fn(image[y:y + c, x:x + c])
            f = np.asarray(feats, np.float32)
            oy0, ox0 = int(round(y * sy)), int(round(x * sx))
            oy1, ox1 = int(round((y + c) * sy)), int(round((x + c) * sx))
            up = _bilinear_resize(f, max(oy1 - oy0, 1), max(ox1 - ox0, 1))
            if acc is None:
                acc = np.zeros((oh, ow, up.shape[-1]), np.float32)
            acc[oy0:oy1, ox0:ox1] += up
            weight[oy0:oy1, ox0:ox1] += 1.0
    assert acc is not None, "no crops produced features"
    return acc / np.maximum(weight, 1.0)


class GlobalPCA:
    """PCA to `out_dim` channels, fit once across all frames, applied per
    frame, persisted as a pickle."""

    def __init__(self, out_dim: int = 32):
        self.out_dim = out_dim
        self.mean: Optional[np.ndarray] = None
        self.components: Optional[np.ndarray] = None   # (F, out_dim)

    def fit(self, feature_maps: Sequence[np.ndarray],
            max_samples: int = 200_000, seed: int = 0) -> "GlobalPCA":
        x = np.concatenate([fm.reshape(-1, fm.shape[-1])
                            for fm in feature_maps], 0)
        if x.shape[0] > max_samples:
            idx = np.random.RandomState(seed).choice(
                x.shape[0], max_samples, replace=False)
            x = x[idx]
        self.mean = x.mean(0, keepdims=True)
        xc = x - self.mean
        # eigenvectors of the (F, F) covariance
        cov = xc.T @ xc / max(x.shape[0] - 1, 1)
        eigval, eigvec = np.linalg.eigh(cov)
        order = np.argsort(eigval)[::-1][:self.out_dim]
        self.components = eigvec[:, order].astype(np.float32)
        return self

    def transform(self, feature_map: np.ndarray) -> np.ndarray:
        assert self.components is not None, "fit() first"
        shape = feature_map.shape[:-1]
        x = feature_map.reshape(-1, feature_map.shape[-1]) - self.mean
        return (x @ self.components).reshape(*shape, self.out_dim)

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump({"mean": self.mean, "components": self.components,
                         "out_dim": self.out_dim}, f)

    @classmethod
    def load(cls, path: str) -> "GlobalPCA":
        with open(path, "rb") as f:
            d = pickle.load(f)
        pca = cls(d["out_dim"])
        pca.mean, pca.components = d["mean"], d["components"]
        return pca


def extract_sequence(images: Sequence[np.ndarray], extract_fn: Callable,
                     out_dir: str, out_dim: int = 32,
                     crop_sizes: Sequence[int] = (224,),
                     out_hw: Optional[Tuple[int, int]] = None,
                     masks: Optional[Sequence[np.ndarray]] = None
                     ) -> GlobalPCA:
    """The offline pipeline: blend every frame's pyramid, fit ONE global
    PCA, save the reduced maps as `{i:05d}.npy` and the PCA as `pca.pkl`.
    `masks` zero out background features before the fit."""
    os.makedirs(out_dir, exist_ok=True)
    maps = []
    for i, im in enumerate(images):
        fm = blend_feature_pyramid(np.asarray(im, np.float32), extract_fn,
                                   crop_sizes=crop_sizes, out_hw=out_hw)
        if masks is not None:
            m = np.asarray(masks[i], np.float32)
            if m.shape[:2] != fm.shape[:2]:
                m = _bilinear_resize(m, fm.shape[0], fm.shape[1])
            fm = fm * (m[..., None] if m.ndim == 2 else m)
        maps.append(fm)
    pca = GlobalPCA(out_dim).fit(maps)
    for i, fm in enumerate(maps):
        np.save(os.path.join(out_dir, f"{i:05d}.npy"),
                pca.transform(fm).astype(np.float32))
    pca.save(os.path.join(out_dir, "pca.pkl"))
    return pca


def load_feature_map(out_dir: str, frame: int) -> np.ndarray:
    return np.load(os.path.join(out_dir, f"{frame:05d}.npy"))


def _hub_dinov2(model_name: str):
    """DINOv2 from the local torch-hub cache only: the hub checkout of
    facebookresearch/dinov2 and the model's pretrained weights must both be
    there already, or this raises without touching the network."""
    import torch
    hub = torch.hub.get_dir()
    repo = os.path.join(hub, "facebookresearch_dinov2_main")
    arch = model_name.replace("_reg", "")
    weights = os.path.join(hub, "checkpoints", f"{arch}_reg4_pretrain.pth"
                           if model_name.endswith("_reg")
                           else f"{arch}_pretrain.pth")
    missing = [p for p in (repo, weights) if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"not in the local torch-hub cache: "
                                f"{missing}")
    return torch.hub.load(repo, model_name, source="local")


def make_dinov2_extractor(model_name: str = "dinov2_vits14_reg",
                          patch: int = 14, model=None) -> Callable:
    """DINOv2 patch-feature extractor (ViT-S/14 with registers by default).

    `model` injects a ready module with DINOv2's `forward_features`
    contract; without one the model comes from the local torch-hub cache
    (nothing is downloaded) and a clear error is raised when it is not
    there. The extractor crops to a patch multiple, normalises with the
    ImageNet statistics, runs on the model's device and returns a
    (h // patch, w // patch, F) NumPy map in row-major patch order.
    """
    import torch
    if model is None:
        try:
            model = _hub_dinov2(model_name)
        except Exception as e:
            raise RuntimeError(
                f"DINOv2 unavailable ({e}); pass a custom extract_fn instead")
    model.eval()
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    first = next(iter(model.parameters()), None)
    dev = first.device if first is not None else torch.device("cpu")

    def extract_fn(image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        ch, cw = (h // patch) * patch, (w // patch) * patch
        x = (image[:ch, :cw] - mean) / std
        t = torch.from_numpy(x.transpose(2, 0, 1))[None].to(dev)
        with torch.no_grad():
            tokens = model.forward_features(t)["x_norm_patchtokens"][0]
        return tokens.reshape(ch // patch, cw // patch, -1).cpu().numpy()

    return extract_fn
