"""Port parity: the forward tile kernel K1.

`composite_tiles_torch` (the plain PyTorch version of the CUDA kernel)
against the JAX package's `pallas_composite_tiles`, run in Pallas interpret
mode on the CPU as `tests/test_pallas.py` runs it, on the same record table.
Tolerances: raw channel rows atol 2e-5, depth row 2e-4 (values ~z <= 8),
log2 transmittance 1e-4, n_active exact. The CUDA kernel itself is held
against the plain version in `test_torch_gpu.py`, which needs a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.ops.pallas.raster_fwd import \
    pallas_composite_tiles
from dynamic3dgaussians_tpu_torch.ops.cuda import raster_fwd as K1
from test_torch_cases import CASES, GRID_H, GRID_W, kernel_kw, record_table

torch.set_num_threads(1)


def _n_chunks(starts, counts, chunk):
    shift = starts % chunk
    return np.where(counts == 0, 0, (shift + counts + chunk - 1) // chunk)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_kernel(case):
    spec = dict(CASES[case])
    chunk = spec["chunk"]
    rec, starts, counts, n_chan = record_table(**spec)
    jraw, jlogt, jnact = pallas_composite_tiles(
        jnp.asarray(rec), jnp.asarray(starts), jnp.asarray(counts),
        **kernel_kw(chunk))
    traw, tlogt, tnact = K1.composite_tiles_torch(
        torch.as_tensor(rec), torch.as_tensor(starts),
        torch.as_tensor(counts), **kernel_kw(chunk))
    assert tuple(traw.shape) == tuple(jraw.shape)
    assert tuple(tlogt.shape) == tuple(jlogt.shape)
    assert tuple(tnact.shape) == tuple(jnact.shape)
    assert tnact.dtype == torch.int32
    jraw, traw = np.asarray(jraw), traw.numpy()
    rows = [i for i in range(traw.shape[-1]) if i != n_chan]
    np.testing.assert_allclose(traw[..., rows], jraw[..., rows], atol=2e-5)
    np.testing.assert_allclose(traw[..., n_chan], jraw[..., n_chan],
                               atol=2e-4)
    np.testing.assert_allclose(tlogt.numpy(), np.asarray(jlogt), atol=1e-4)
    np.testing.assert_array_equal(tnact.numpy(), np.asarray(jnact))

    n_chunks = _n_chunks(starts, counts, chunk)
    nact = tnact.numpy().reshape(-1)
    assert (nact[counts == 0] == 0).all()
    if case == "opaque_stop":
        assert (nact == 1).all() and (n_chunks > 1).all()
        assert float(traw[..., n_chan + 1].min()) > 0.99
    else:
        assert (nact[counts > 0] >= 1).all()


def test_stop_rule_at_later_chunks_matches_reference_cut():
    """Tiles that die after chunk 0 stop at the first dead chunk boundary.

    The reference kernel in interpret mode re-tests the stop rule only after
    chunk 0 (its while_loop condition sees the log-transmittance scratch as
    of loop entry), so it walks such tiles to their end; the compiled kernel
    and the port stop at every boundary. Hold the port to the rule through
    the reference itself: run it on each segment cut at the port's stop
    point, where the outputs must agree and the tile must be dead, and on
    the segment cut one chunk earlier, where it must still be alive.
    """
    chunk = 32
    rec, starts, counts, n_chan = record_table(
        seed=5, counts=np.full(GRID_W * GRID_H, 300), n_chan=3, chunk=chunk,
        opaque=True)
    traw, tlogt, tnact = K1.composite_tiles_torch(
        torch.as_tensor(rec), torch.as_tensor(starts),
        torch.as_tensor(counts), **kernel_kw(chunk))
    nact = tnact.numpy().reshape(-1)
    shift = starts % chunk
    assert (nact < _n_chunks(starts, counts, chunk)).all()
    assert (nact > 1).any()

    def cut(k):
        return np.clip(np.minimum(counts, k * chunk - shift), 0,
                       None).astype(np.int32)

    def ref(c):
        out = pallas_composite_tiles(jnp.asarray(rec), jnp.asarray(starts),
                                     jnp.asarray(c), **kernel_kw(chunk))
        return [np.asarray(o) for o in out]

    jraw, jlogt, jnact = ref(cut(nact))
    np.testing.assert_array_equal(jnact.reshape(-1), nact)
    rows = [i for i in range(traw.shape[-1]) if i != n_chan]
    np.testing.assert_allclose(traw.numpy()[..., rows], jraw[..., rows],
                               atol=2e-5)
    np.testing.assert_allclose(traw.numpy()[..., n_chan], jraw[..., n_chan],
                               atol=2e-4)
    np.testing.assert_allclose(tlogt.numpy(), jlogt, atol=1e-4)
    assert (jlogt.max(axis=(1, 2)) <= K1.LOG2_T_DEAD).all()
    _, jlogt_early, _ = ref(cut(nact - 1))
    alive_early = jlogt_early.max(axis=(1, 2)) > K1.LOG2_T_DEAD
    assert alive_early[nact > 1].all()


def test_wrapper_takes_plain_version_on_cpu():
    rec, starts, counts, _ = record_table(**CASES["unaligned_cv8"])
    args = (torch.as_tensor(rec), torch.as_tensor(starts),
            torch.as_tensor(counts))
    before = K1.composite_tiles.launches
    out = K1.composite_tiles(*args, **kernel_kw(64))
    ref = K1.composite_tiles_torch(*args, **kernel_kw(64))
    assert K1.composite_tiles.launches == before     # no kernel launched
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["cv_not_multiple_of_8", "ne_pad_vs_chunk",
                                 "int64_starts", "starts_shape",
                                 "tile_too_big"])
def test_wrapper_rejects_bad_arguments(bad):
    rec, starts, counts, _ = record_table(**CASES["unaligned_cv8"])
    rec_t, st, ct = (torch.as_tensor(rec), torch.as_tensor(starts),
                     torch.as_tensor(counts))
    kw = kernel_kw(64)
    if bad == "cv_not_multiple_of_8":
        rec_t = rec_t[:-3]
    elif bad == "ne_pad_vs_chunk":
        rec_t = rec_t[:, :-5]
    elif bad == "int64_starts":
        st = st.long()
    elif bad == "starts_shape":
        st = st[:-1]
    else:
        kw.update(tile_h=64, tile_w=32)
    with pytest.raises(ValueError):
        K1.composite_tiles(rec_t, st, ct, **kw)
