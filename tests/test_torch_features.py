"""Port parity: offline dense-feature extraction (`data/features.py`).

The crop enumeration, the bilinear resize, the multi-crop pyramid, the
global PCA and the whole `extract_sequence` pipeline against the
reference on numpy-seeded images and a synthetic extractor; the DINOv2
wrapper through an injected stub module (no weights ship and nothing is
downloaded), and its error without one.

Tolerances: the pyramid and PCA are the same NumPy arithmetic on both
sides, so maps, PCA means and components, and the saved .npy files are
compared exactly; the DINOv2 stub's golden value at atol 1e-4 (float32
matmul against NumPy), as tests/test_weight_hooks.py holds the reference.
"""

import os

import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.data import features as JF
from dynamic3dgaussians_tpu_torch.data import features as TF

torch.set_num_threads(1)


def _fake_extract(crop):
    """4x4 patches, 8-dim features from the patch's mean colour."""
    h, w = crop.shape[:2]
    f = crop[: h // 4 * 4, : w // 4 * 4].reshape(
        h // 4, 4, w // 4, 4, 3).mean((1, 3))
    return np.concatenate([f, f * 0.5, f * 0.25 - 0.1,
                           np.roll(f, 1, -1) * 0.3], axis=-1)[..., :8]


@pytest.mark.parametrize("h,w,crop,overlap", [(32, 40, 24, 0.5),
                                              (360, 640, 224, 0.5),
                                              (30, 20, 40, 0.25)])
def test_multicrop_boxes_match(h, w, crop, overlap):
    assert TF.multicrop_boxes(h, w, crop, overlap) == \
        JF.multicrop_boxes(h, w, crop, overlap)


@pytest.mark.parametrize("shape,out", [((7, 9, 5), (25, 45)),
                                       ((25, 45, 3), (7, 11)),
                                       ((16, 20), (5, 3))])
def test_bilinear_resize_matches(shape, out):
    img = np.random.RandomState(0).rand(*shape).astype(np.float32)
    np.testing.assert_array_equal(TF._bilinear_resize(img, *out),
                                  JF._bilinear_resize(img, *out))


def test_pyramid_pca_and_sequence_match(tmp_path):
    rng = np.random.RandomState(0)
    imgs = [rng.rand(32, 40, 3).astype(np.float32) for _ in range(3)]
    masks = [(rng.rand(16, 20) > 0.3).astype(np.float32) for _ in range(3)]
    for crops in ((24,), (16, 28)):
        np.testing.assert_array_equal(
            TF.blend_feature_pyramid(imgs[0], _fake_extract, crops,
                                     out_hw=(16, 20)),
            JF.blend_feature_pyramid(imgs[0], _fake_extract, crops,
                                     out_hw=(16, 20)))
    kw = dict(out_dim=4, crop_sizes=(24,), out_hw=(16, 20), masks=masks)
    tp = TF.extract_sequence(imgs, _fake_extract, str(tmp_path / "t"), **kw)
    jp = JF.extract_sequence(imgs, _fake_extract, str(tmp_path / "j"), **kw)
    np.testing.assert_array_equal(tp.mean, jp.mean)
    np.testing.assert_array_equal(tp.components, jp.components)
    for i in range(3):
        fm = TF.load_feature_map(str(tmp_path / "t"), i)
        assert fm.shape == (16, 20, 4)
        np.testing.assert_array_equal(
            fm, JF.load_feature_map(str(tmp_path / "j"), i))
    loaded = TF.GlobalPCA.load(os.path.join(str(tmp_path / "j"), "pca.pkl"))
    np.testing.assert_array_equal(loaded.components, jp.components)
    x = rng.rand(5, 6, 8).astype(np.float32)
    np.testing.assert_array_equal(loaded.transform(x), jp.transform(x))


def test_global_pca_subsamples_like_the_reference():
    rng = np.random.RandomState(4)
    maps = [rng.normal(size=(30, 40, 12)).astype(np.float32)
            for _ in range(2)]
    tp = TF.GlobalPCA(5).fit(maps, max_samples=500, seed=3)
    jp = JF.GlobalPCA(5).fit(maps, max_samples=500, seed=3)
    np.testing.assert_array_equal(tp.mean, jp.mean)
    np.testing.assert_array_equal(tp.components, jp.components)


class _StubDinov2(torch.nn.Module):
    """DINOv2's forward_features contract: per-patch channel means through
    a fixed linear map."""

    def __init__(self, patch=14, dim=16):
        super().__init__()
        self.patch, self.dim = patch, dim
        self.proj = torch.nn.Linear(3, dim)
        with torch.no_grad():
            g = torch.Generator().manual_seed(0)
            self.proj.weight.copy_(torch.randn((dim, 3), generator=g))
            self.proj.bias.copy_(torch.randn((dim,), generator=g))
        self.seen = {}

    def forward_features(self, x):
        self.seen["shape"] = tuple(x.shape)
        self.seen["min"] = float(x.min())
        b, c, h, w = x.shape
        p = self.patch
        xp = x.reshape(b, c, h // p, p, w // p, p).mean(dim=(3, 5))
        tok = self.proj(xp.permute(0, 2, 3, 1))
        return {"x_norm_patchtokens": tok.reshape(b, -1, self.dim)}


def test_dinov2_extractor_through_a_stub():
    stub = _StubDinov2()
    t_ext = TF.make_dinov2_extractor(model=stub)
    img = np.random.RandomState(2).uniform(0, 1, (100, 131, 3)) \
        .astype(np.float32)
    out = t_ext(img)
    assert stub.seen["shape"] == (1, 3, 98, 126)   # cropped to 14-multiples
    assert out.shape == (7, 9, 16)
    assert stub.seen["min"] < -0.5                 # ImageNet normalisation
    np.testing.assert_array_equal(
        out, JF.make_dinov2_extractor(model=stub)(img))
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    xp = ((img[:98, :126] - mean) / std).reshape(7, 14, 9, 14, 3).mean(
        axis=(1, 3))
    want = xp @ stub.proj.weight.detach().numpy().T + \
        stub.proj.bias.detach().numpy()
    np.testing.assert_allclose(out, want, atol=1e-4)
    # the pyramid at ViT-S/14's patch grid of a 360x640 frame: 25 x 45
    big = np.random.RandomState(3).rand(360, 640, 3).astype(np.float32)
    fm = TF.blend_feature_pyramid(big, t_ext, (224,), out_hw=(25, 45))
    assert fm.shape == (25, 45, 16) and np.isfinite(fm).all()


def test_dinov2_without_a_model_raises(monkeypatch, tmp_path):
    """No model and nothing in the local hub cache: the reference's error,
    and no download is attempted."""
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path))

    def no_download(*a, **k):
        raise AssertionError("a download was attempted")

    monkeypatch.setattr(torch.hub, "load", no_download)
    with pytest.raises(RuntimeError, match="DINOv2 unavailable.*extract_fn"):
        TF.make_dinov2_extractor()
