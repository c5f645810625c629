"""Device selection shared by the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


@contextlib.contextmanager
def no_tf32():
    """Run float32 matmuls and convolutions at full float32 on the card
    (TF32 off), and put the caller's settings back afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller says.

    There is no silent drop to the CPU: with no device given and no CUDA
    device present this raises, so a missing card never turns into a slow
    CPU run that looks like a GPU one.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        # "cuda" and "cuda:<current>" name one device; tensors report the
        # indexed form, so compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
