"""CLIP image and text encoders for feature-field experiments.

Port of `dynamic3dgaussians_tpu/utils/clip_utils.py`. The encoders load
through `transformers` only from a checkpoint already on disk (a local
directory, or the Hugging Face cache): nothing is downloaded, and without
`transformers` or the checkpoint `make_clip_encoders` raises. Downstream
code treats the encoders as a pluggable `encode_image` / `encode_text`
pair, the contract `data/features.py` uses for its extractor.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def make_clip_encoders(model_name: str = "openai/clip-vit-base-patch32"
                       ) -> Tuple[Callable, Callable]:
    """(encode_image(img01 (H, W, 3)) -> (D,), encode_text(str) -> (D,)),
    unit-norm CLIP embeddings on the CPU.

    `model_name` is a local checkpoint directory or a hub name already in
    the Hugging Face cache; the checkpoint is read with
    `local_files_only=True`, so nothing is fetched. Raises RuntimeError
    without `transformers` or the checkpoint.
    """
    try:
        import torch
        from transformers import CLIPModel, CLIPProcessor
    except ImportError as e:
        raise RuntimeError(f"CLIP unavailable ({e}); supply your own encode "
                           f"fns") from e
    try:
        model = CLIPModel.from_pretrained(model_name, local_files_only=True)
        proc = CLIPProcessor.from_pretrained(model_name,
                                             local_files_only=True)
    except (OSError, ValueError) as e:
        raise RuntimeError(
            f"CLIP checkpoint {model_name!r} is not on disk ({e}); nothing "
            f"is downloaded: supply the checkpoint or your own encode fns"
        ) from e
    model.eval()

    def encode_image(img01: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            inp = proc(images=(np.asarray(img01) * 255).astype(np.uint8),
                       return_tensors="pt")
            f = model.get_image_features(**inp)[0]
        return (f / f.norm()).numpy()

    def encode_text(text: str) -> np.ndarray:
        with torch.no_grad():
            inp = proc(text=[text], return_tensors="pt", padding=True)
            f = model.get_text_features(**inp)[0]
        return (f / f.norm()).numpy()

    return encode_image, encode_text


def similarity_map(feature_map: np.ndarray, text_feature: np.ndarray
                   ) -> np.ndarray:
    """(H, W, D) rendered feature map x (D,) text embedding -> (H, W)
    cosine-similarity heatmap (the reference's language-query use)."""
    fm = np.asarray(feature_map, np.float32)
    fm = fm / np.maximum(np.linalg.norm(fm, axis=-1, keepdims=True), 1e-9)
    t = np.asarray(text_feature, np.float32)
    t = t / max(np.linalg.norm(t), 1e-9)
    return fm @ t
