"""The port's CUDA kernels on the card (marker `gpu`; skipped without one).

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch with CUDA and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

(`--noconftest`: the suite's conftest sets JAX up.) Each kernel is held
against its plain PyTorch version on the same card. Tolerances: channel
rows atol 1e-4, depth row and log2 transmittance 1e-3 -- the alpha chain
is computed identically, the sums in another order (sequential against
cumsum + bmm) -- and n_active exact.
"""

import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import rasterize as trast
from dynamic3dgaussians_tpu_torch.ops.cuda import raster_fwd as K1
from test_torch_cases import CASES, kernel_kw, record_table

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain(cuda_device, case):
    spec = dict(CASES[case])
    chunk = spec["chunk"]
    rec, starts, counts, n_chan = record_table(**spec)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (rec, starts, counts)]
    before = K1.composite_tiles.launches
    kraw, klogt, knact = K1.composite_tiles(*args, **kernel_kw(chunk))
    torch.cuda.synchronize()
    assert K1.composite_tiles.launches == before + 1
    praw, plogt, pnact = K1.composite_tiles_torch(*args, **kernel_kw(chunk))
    rows = [i for i in range(kraw.shape[-1]) if i != n_chan]
    torch.testing.assert_close(kraw[..., rows], praw[..., rows], atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(kraw[..., n_chan], praw[..., n_chan],
                               atol=1e-3, rtol=0)
    torch.testing.assert_close(klogt, plogt, atol=1e-3, rtol=0)
    assert torch.equal(knact, pnact)


def test_cuda_kernel_refuses_unbuilt_width(cuda_device):
    """CV = 56 has no kernel instance: a CUDA tensor raises, it never falls
    back to the plain version."""
    rec, starts, counts, _ = record_table(seed=6, counts=[5] * 12,
                                          n_chan=50, chunk=64)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (rec, starts, counts)]
    before = K1.composite_tiles.launches
    with pytest.raises(ValueError):
        K1.composite_tiles(*args, **kernel_kw(64))
    assert K1.composite_tiles.launches == before


def _scene(n, seed):
    rng = np.random.RandomState(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, (n,)).astype(np.float32)
    scales = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    seg = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return (means, colors, opac, scales, quats), seg


def test_cuda_render_matches_torch_path(cuda_device):
    arrays, seg = _scene(300, seed=3)
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    cam = tcam.make_camera(128, 96, [[90.0, 0, 64], [0, 90.0, 48],
                                     [0, 0, 1]], w2c, device=cuda_device)
    args = [torch.as_tensor(a, device=cuda_device) for a in arrays]
    extra = torch.as_tensor(seg, device=cuda_device)
    before = K1.composite_tiles.launches
    k = trast.render(cam, *args, extra_channels=extra, device=cuda_device)
    assert K1.composite_tiles.launches == before + 1
    p = trast.render(cam, *args, extra_channels=extra, method="torch",
                     device=cuda_device)
    assert K1.composite_tiles.launches == before + 1
    assert int(k.n_dropped_rect) == 0
    for name in ("rgb", "alpha", "extra"):
        torch.testing.assert_close(getattr(k, name), getattr(p, name),
                                   atol=1e-4, rtol=0)
    torch.testing.assert_close(k.depth, p.depth, atol=1e-3, rtol=0)
    torch.testing.assert_close(k.radii, p.radii, atol=0, rtol=0)
