"""Port parity: the backward tile kernel K2.

`composite_tiles_bwd_torch` (the plain PyTorch version of the CUDA kernel)
against three targets, on the record tables of `test_torch_cases.CASES`,
with the forward's log_t / n_active from K1's plain version and a
numpy-seeded cotangent:

* the JAX package's `pallas_composite_tiles_bwd`, run in Pallas interpret
  mode on the CPU as `tests/test_pallas.py` runs it, compared on the pair
  slots inside a tile segment (the reference leaves slots past the last
  pair unwritten);
* plain autograd through `composite_tiles_torch`, an independent oracle of
  the same function;
* finite differences of whole renders, mirroring
  `tests/test_pallas.py::test_pallas_custom_vjp_grads_match` and
  `::test_pallas_grads_match_finite_differences`.

Tolerance for the table comparisons: per gradient row,
|port - target| <= 1e-4 |target| + 1e-5 x the row's largest magnitude. The
three compute the same float32 sums over a tile's pixels and a chunk's
records in different orders (prefix scans by matmul in the reference,
cumsum here, autograd's own order in the oracle).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.ops.pallas.raster_bwd import \
    pallas_composite_tiles_bwd
from dynamic3dgaussians_tpu_torch.ops import camera as tcam
from dynamic3dgaussians_tpu_torch.ops import rasterize as trast
from dynamic3dgaussians_tpu_torch.ops.cuda import raster_bwd as K2
from dynamic3dgaussians_tpu_torch.ops.cuda import raster_fwd as K1
from test_torch_cases import CASES, kernel_kw, record_table
from tests.scenes import random_scene

torch.set_num_threads(1)


def _rows_close(got, want, rtol=1e-4, row_atol=1e-5):
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-30)
    excess = np.abs(got - want) - rtol * np.abs(want) - row_atol * scale
    assert excess.max() <= 0.0, (excess.max(), np.unravel_index(
        excess.argmax(), excess.shape))


def _case(case):
    spec = dict(CASES[case])
    chunk = spec["chunk"]
    rec, starts, counts, n_chan = record_table(**spec)
    t = [torch.as_tensor(a) for a in (rec, starts, counts)]
    raw, log_t, n_active = K1.composite_tiles_torch(*t, **kernel_kw(chunk))
    d_raw = np.random.RandomState(7).normal(
        size=tuple(raw.shape)).astype(np.float32)
    return rec, starts, counts, n_chan, chunk, t, raw, log_t, n_active, d_raw


def _rows(d_out, n_val):
    return np.concatenate([d_out[:6], d_out[8:8 + n_val]])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_bwd_kernel(case):
    (rec, starts, counts, _, chunk, t, _, log_t, n_active,
     d_raw) = _case(case)
    kw = kernel_kw(chunk)
    ours = K2.composite_tiles_bwd_torch(
        *t, n_active.reshape(-1), log_t, torch.as_tensor(d_raw), **kw)
    ref = pallas_composite_tiles_bwd(
        jnp.asarray(rec), jnp.asarray(starts), jnp.asarray(counts),
        jnp.asarray(n_active.numpy().reshape(-1)),
        jnp.asarray(log_t.numpy()), jnp.asarray(d_raw), **kw)
    n_val = rec.shape[0] - 8
    ne = int(counts.sum())            # segments are back to back from 0
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape
    _rows_close(_rows(ours, n_val)[:, :ne], _rows(ref, n_val)[:, :ne])
    np.testing.assert_array_equal(ours[6:8], 0.0)
    np.testing.assert_array_equal(ours[:, ne:], 0.0)
    assert np.abs(ours[:6, :ne]).max() > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_autograd_of_forward(case):
    (rec, _, _, _, chunk, t, _, log_t, n_active, d_raw) = _case(case)
    kw = kernel_kw(chunk)
    rec_t = t[0].clone().requires_grad_(True)
    raw, _, _ = K1.composite_tiles_torch(rec_t, t[1], t[2], **kw)
    (oracle,) = torch.autograd.grad(raw, rec_t, torch.as_tensor(d_raw))
    ours = K2.composite_tiles_bwd_torch(
        *t, n_active.reshape(-1), log_t, torch.as_tensor(d_raw), **kw)
    n_val = rec.shape[0] - 8
    _rows_close(_rows(ours.numpy(), n_val), _rows(oracle.numpy(), n_val))


def test_wrapper_takes_plain_version_on_cpu():
    (_, _, _, _, chunk, t, _, log_t, n_active, d_raw) = _case("unaligned_cv8")
    args = (*t, n_active.reshape(-1), log_t, torch.as_tensor(d_raw))
    before = K2.composite_tiles_bwd.launches
    out = K2.composite_tiles_bwd(*args, **kernel_kw(chunk))
    assert K2.composite_tiles_bwd.launches == before
    assert torch.equal(out, K2.composite_tiles_bwd_torch(
        *args, **kernel_kw(chunk)))


@pytest.mark.parametrize("bad", ["n_active_shape", "log_t_dtype",
                                 "d_raw_width"])
def test_wrapper_rejects_bad_arguments(bad):
    (_, _, _, _, chunk, t, _, log_t, n_active, d_raw) = _case("unaligned_cv8")
    n_active, d_raw = n_active.reshape(-1), torch.as_tensor(d_raw)
    if bad == "n_active_shape":
        n_active = n_active[:-1]
    elif bad == "log_t_dtype":
        log_t = log_t.double()
    else:
        d_raw = d_raw[..., :-1]
    with pytest.raises(ValueError):
        K2.composite_tiles_bwd(*t, n_active, log_t, d_raw,
                               **kernel_kw(chunk))


def _render_args(n, seed, w, h):
    k = [[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]]
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    cam = tcam.make_camera(w, h, k, w2c, device="cpu")
    return cam, random_scene(n, seed=seed)


CFG = trast.RasterConfig(chunk=64, max_tiles_per_gaussian=64)


def test_custom_function_grads_match_reference_autograd():
    """The Function (K1 + K2 plain versions, pair-to-gaussian sum) against
    plain autograd through the O(N*H*W) oracle, as the reference holds its
    custom_vjp against its tiled path: atol 1e-5, rtol 1e-3."""
    cam, arrays = _render_args(80, 3, 32, 32)

    def grads(method):
        ts = [torch.tensor(a, requires_grad=True) for a in arrays]
        out = trast.render(cam, *ts, method=method, config=CFG, device="cpu")
        loss = (torch.mean((out.rgb - 0.3) ** 2) + 0.05 * out.depth.mean()
                + 0.01 * out.alpha.mean())
        return torch.autograd.grad(loss, ts)

    g_ref, g_fn = grads("reference"), grads("torch")
    for a, b in zip(g_ref, g_fn):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5,
                                   rtol=1e-3)
    assert any(float(g.abs().max()) > 0 for g in g_fn)


def test_custom_function_grads_match_finite_differences():
    """Central differences of the render's loss w.r.t. the means. The
    render is piecewise smooth (alpha clamp and gate, EWA view limits), so,
    as in the reference's test, a solid majority of the sampled coordinates
    whose FD is stable across two step sizes must match within 8 % + 5e-4.
    """
    cam, arrays = _render_args(12, 5, 32, 16)
    means = arrays[0]
    rest = [torch.as_tensor(a) for a in arrays[1:]]

    def loss_of(m):
        out = trast.render(cam, m, *rest, method="torch", config=CFG,
                           device="cpu")
        return torch.sum(out.rgb * 0.7) + 0.2 * torch.sum(out.alpha)

    m = torch.tensor(means, requires_grad=True)
    (g,) = torch.autograd.grad(loss_of(m), m)
    g = g.numpy()

    def loss_np(mm):
        with torch.no_grad():
            return float(loss_of(torch.as_tensor(mm)))

    def fd_at(i, j, eps):
        mp, mm = means.copy(), means.copy()
        mp[i, j] += eps
        mm[i, j] -= eps
        return (loss_np(mp) - loss_np(mm)) / (2 * eps)

    rng = np.random.RandomState(0)
    checked = matched = 0
    for _ in range(12):
        i, j = rng.randint(0, means.shape[0]), rng.randint(0, 3)
        if abs(g[i, j]) < 1e-4:
            continue
        fd1, fd2 = fd_at(i, j, 3e-3), fd_at(i, j, 1.5e-3)
        if abs(fd1 - fd2) > 0.05 * max(abs(fd1), abs(fd2), 1e-3):
            continue
        checked += 1
        matched += abs(g[i, j] - fd2) <= 0.08 * abs(fd2) + 5e-4
    assert checked >= 3 and matched >= 0.7 * checked, (checked, matched)

