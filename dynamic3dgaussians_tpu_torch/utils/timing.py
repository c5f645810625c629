"""Sustained per-call time of a function on the device.

Port of `dynamic3dgaussians_tpu/utils/timing.py`: issue every call, then
wait once for the device. PyTorch returns from a CUDA call before the card
has finished, so the wait is `torch.cuda.synchronize()` (the reference's
`block_until_ready`); a CPU call has finished when it returns.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _wait():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def pipelined_ms(fn, iters: int = 30) -> float:
    """Milliseconds per call of `fn(scalar)` at sustained throughput.

    `fn` takes one float32 scalar and folds it into its work (e.g.
    `means + s`), so every call computes something new. The first call
    warms up (kernel builds, allocator) and is not timed.
    """
    fn(np.float32(0.0))
    _wait()
    t0 = time.perf_counter()
    outs = [fn(np.float32(1e-7 * (i + 1))) for i in range(iters)]
    _wait()
    elapsed = time.perf_counter() - t0
    del outs
    return elapsed / iters * 1e3
