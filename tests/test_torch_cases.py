"""Record tables for the forward tile kernel's tests (numpy only, no JAX).

Shared by the CPU parity tests (`test_torch_raster_fwd.py`) and the
kernel-on-card tests (`test_torch_gpu.py`), which run where JAX is absent;
the test here holds each table to the layout the kernel takes.
"""

import numpy as np
import pytest

TH = TW = 16
GRID_W, GRID_H = 4, 3
LOG2E = 1.4426950408889634


def record_table(seed, counts, n_chan, chunk, opaque=False):
    """A (tile, depth)-sorted merged record table with the given segment
    sizes: records scattered over and around their tile.

    Returns (rec (8 + CV, NE_pad) float32, starts, counts, n_chan).
    """
    rng = np.random.RandomState(seed)
    counts = np.asarray(counts, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    ne = int(counts.sum())
    ne_pad = (-(-ne // chunk) + 1) * chunk
    n_val = -(-(n_chan + 2) // 8) * 8
    rec = np.zeros((8 + n_val, ne_pad), np.float32)
    for t, (s, c) in enumerate(zip(starts, counts)):
        ox, oy = (t % GRID_W) * TW, (t // GRID_W) * TH
        seg = slice(s, s + c)
        rec[0, seg] = ox + rng.uniform(-6, TW + 6, c)
        rec[1, seg] = oy + rng.uniform(-6, TH + 6, c)
        lo, hi = (40.0, 400.0) if opaque else (0.5, 25.0)
        sxx, syy = rng.uniform(lo, hi, c), rng.uniform(lo, hi, c)
        sxy = rng.uniform(-0.5, 0.5, c) * np.sqrt(sxx * syy)
        det = sxx * syy - sxy * sxy
        rec[2, seg] = syy / det * LOG2E
        rec[3, seg] = -sxy / det * LOG2E
        rec[4, seg] = sxx / det * LOG2E
        rec[5, seg] = (np.full(c, 0.97) if opaque
                       else rng.uniform(0.1, 0.99, c))
        rec[8:8 + n_chan, seg] = rng.uniform(0, 1, (n_chan, c))
        rec[8 + n_chan, seg] = np.sort(rng.uniform(1.0, 8.0, c))
        rec[8 + n_chan + 1, seg] = 1.0
    return rec, starts, counts, n_chan


def _cases():
    rng = np.random.RandomState(0)
    unaligned = rng.randint(1, 200, GRID_W * GRID_H)
    unaligned[[3, 7]] = 0
    empty = np.zeros(GRID_W * GRID_H, np.int32)
    empty[[5, 6]] = [70, 3]
    return {
        # unaligned segments (and two empty tiles), RGB + 3 seg: CV = 8
        "unaligned_cv8": dict(seed=1, counts=unaligned, n_chan=6, chunk=64),
        # all but two tiles empty, one tile shorter than a chunk
        "empty_tiles": dict(seed=2, counts=empty, n_chan=3, chunk=64),
        # large opaque splats: every tile dies within its first chunk and
        # stops there (segments of 4 chunks + 2, so shifts stay small)
        "opaque_stop": dict(seed=3, counts=np.full(GRID_W * GRID_H, 258),
                            n_chan=3, chunk=64, opaque=True),
        # RGB + 32 features: CV = 40
        "feature_cv40": dict(seed=4, counts=unaligned, n_chan=35, chunk=64),
    }


CASES = _cases()


def kernel_kw(chunk):
    """Grid arguments of the kernel for these tables."""
    return dict(num_tiles=GRID_W * GRID_H, grid_w=GRID_W, tile_h=TH,
                tile_w=TW, chunk=chunk)


@pytest.mark.parametrize("case", sorted(CASES))
def test_record_table_layout(case):
    """The merged record table of the reference kernel's interface:
    (8 + CV) rows with CV % 8 == 0, NE_pad a multiple of the chunk with at
    least one chunk of zero slack, back-to-back tile segments, depth
    sorted and the ones row set inside each segment, zeros outside."""
    spec = CASES[case]
    chunk = spec["chunk"]
    rec, starts, counts, n_chan = record_table(**spec)
    n_val = rec.shape[0] - 8
    assert n_val % 8 == 0 and n_val >= n_chan + 2
    assert rec.dtype == np.float32 and rec.shape[1] % chunk == 0
    ne = int(counts.sum())
    assert rec.shape[1] - ne >= chunk
    assert starts.dtype == counts.dtype == np.int32
    assert starts.shape == counts.shape == (GRID_W * GRID_H,)
    np.testing.assert_array_equal(starts[1:], (starts + counts)[:-1])
    np.testing.assert_array_equal(rec[:, ne:], 0.0)
    np.testing.assert_array_equal(rec[6:8], 0.0)
    np.testing.assert_array_equal(rec[8 + n_chan + 1, :ne], 1.0)
    for s, c in zip(starts, counts):
        assert (np.diff(rec[8 + n_chan, s:s + c]) >= 0).all()
