"""Port parity: the speed-of-light probe of the tile walk (K3).

`ops/cuda/sol_probe.py::sol_probe_torch` (the kernel's plain version) and
`tools/bench_sol.py` against the reference probe `tools/bench_vpu_sol.py`,
whose Pallas kernels run here in interpret mode at `--small` (4 blocks of
256 records): the reference's `timed` is replaced by a recorder that keeps
what each `warm[...]` call returns and skips the `time[...]` calls.

Each walk gives two parts whose sum is the reference's scalar (see the
module); the reference returns only the scalar, so that is what is held.
Tolerance: 1e-5 relative on each scalar. The reference's power is a bf16
three-round split (about 2^-24 relative) and its scan a matmul in interpret
mode; the plain version computes the power in float32 and scans with
torch.cumsum, so the ~10^5 cells of a sum round differently.
"""

import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu_torch.ops.cuda import sol_probe as K3
from dynamic3dgaussians_tpu_torch.tools import bench_sol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


@pytest.fixture(scope="module")
def reference_values(tmp_path_factory):
    """{variant: scalar} of the reference probe at --small, interpret mode."""
    path = os.path.join(REPO, "tools", "bench_vpu_sol.py")
    spec = importlib.util.spec_from_file_location("bench_vpu_sol_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = {}

    def recorder(name, fn, *a, **k):
        if name.startswith("warm["):
            got[name[len("warm["):-1]] = fn(*a, **k)
            return got[name[len("warm["):-1]]
        return None

    mp = pytest.MonkeyPatch()
    cache_dir = jax.config.jax_compilation_cache_dir
    try:
        mp.setattr(sys, "argv", ["bench_vpu_sol.py", "--small"])
        mp.setenv("D3G_COMPILE_CACHE",
                  str(tmp_path_factory.mktemp("jax_cache")))
        mp.setattr(mod, "timed", recorder)
        mod.main()
    finally:
        mp.undo()
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return got


@pytest.mark.parametrize("kind", K3.KINDS)
def test_plain_version_matches_reference_probe(reference_values, kind):
    rec, _ = bench_sol.probe_inputs(small=True)
    got = float(K3.total(K3.sol_probe_torch(torch.as_tensor(rec), kind)))
    want = float(reference_values[kind])
    assert abs(got - want) <= RTOL * abs(want), (got, want)


def test_exp2_line_matches_reference(reference_values):
    _, bigx = bench_sol.probe_inputs(small=True)
    got = float(torch.exp2(torch.as_tensor(bigx)).sum())
    want = float(reference_values["exp2_xla"])
    assert abs(got - want) <= RTOL * abs(want), (got, want)


def test_bench_entry_point_on_cpu(reference_values, capsys):
    """`python -m ...tools.bench_sol --small --device cpu`: one line per
    variant with the reference's scalar, and no time."""
    assert bench_sol.main(["--small", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    result = json.loads(lines[-1][len("SOL_RESULT "):])
    assert set(result) == set(K3.KINDS) | {"exp2"}
    for kind in K3.KINDS:
        line = result[kind]
        want = float(reference_values[kind])
        assert abs(line["value"] - want) <= RTOL * abs(want)
        assert list(line["parts"]) == list(K3.PARTS[kind])
        assert line["value"] == np.float32(sum(line["parts"].values()))
        assert line["ms"] == "not measured"
        assert line["n_chunks"] == 4 and line["cells"] == 4 * 256 * 256
    assert result["exp2"]["ms"] == "not measured"


@pytest.mark.parametrize("kind", K3.KINDS)
def test_batch_of_walks_matches_single_walks(kind):
    rec = bench_sol.card_table(3, 2, "cpu", seed=5)
    both = K3.sol_probe(rec, kind)
    assert both.shape == (3, 2)
    for b in range(3):
        one = K3.sol_probe_torch(rec[b], kind)
        assert one.shape == (2,)
        torch.testing.assert_close(both[b], one, rtol=1e-6, atol=0)


def test_parts_split_the_scalar():
    """The two parts of a compute walk are the acc half and the log2T half
    of the reference's scalar: a table whose value rows are 0 zeroes the
    acc part alone, and dma_only's parts are its two corners."""
    rec = bench_sol.card_table(2, 3, "cpu", seed=7)
    flat = rec.clone()
    flat[:, K3.VAL_ROW:] = 0.0
    for kind in ("compute_only", "stream_compute"):
        parts, zeroed = K3.sol_probe(rec, kind), K3.sol_probe(flat, kind)
        assert bool((parts[:, 0].abs() > 1.0).all())
        assert bool((zeroed[:, 0] == 0).all())
        torch.testing.assert_close(zeroed[:, 1], parts[:, 1], rtol=0, atol=0)
    blocks = rec.reshape(2, 16, 3, 256)
    corners = torch.stack([blocks[:, 0:8, :, 0:128].sum(dim=(1, 2, 3)),
                           blocks[:, 8:16, :, 128:256].sum(dim=(1, 2, 3))], -1)
    torch.testing.assert_close(K3.sol_probe(rec, "dma_only"), corners,
                               rtol=1e-5, atol=1e-4)


def test_wrapper_routing(monkeypatch):
    """A CPU tensor takes the plain version without building anything;
    other devices raise, as do malformed tables; the launch count moves
    only on a kernel launch."""
    from dynamic3dgaussians_tpu_torch import _build
    monkeypatch.setattr(_build, "load_library", lambda: pytest.fail(
        "the CPU path must not build the kernel"))
    rec = bench_sol.card_table(1, 1, "cpu")[0]
    before = K3.sol_probe.launches
    assert torch.equal(K3.sol_probe(rec, "dma_only"),
                       K3.sol_probe_torch(rec, "dma_only"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        K3.sol_probe(rec.to("meta"), "compute_only")
    with pytest.raises(ValueError, match="kind"):
        K3.sol_probe(rec, "exp2")
    with pytest.raises(ValueError, match="rows"):
        K3.sol_probe(rec[:, :100], "compute_only")
    with pytest.raises(ValueError, match="float32"):
        K3.sol_probe(rec.double(), "compute_only")
    assert K3.sol_probe.launches == before


def test_bound_and_work_counts():
    """The bound the smoke reports: operations for the compute variants
    (compute_only reads one block per walk), bytes for dma_only."""
    w = bench_sol.work("compute_only", 2, 3, 132, 1.98e9)
    assert w["cells"] == 2 * 3 * 256 * 256 and w["bound_by"] == "operations"
    assert w["bytes"] == 2 * 16 * 256 * 4 + 2 * 4
    s = bench_sol.work("stream_compute", 2, 3, 132, 1.98e9)
    assert s["bytes"] == s["table_bytes"] + 2 * 4 == 2 * 16 * 768 * 4 + 8
    d = bench_sol.work("dma_only", 2, 3, 132, 1.98e9)
    assert d["bound_by"] == "bytes"
    np.testing.assert_allclose(d["bound_ms"], d["bytes"]
                               / bench_sol.PEAK_BYTES_S * 1e3)


def test_sfu_floor_counts():
    """`work` puts the SFU floor beside the bound: 3 transcendentals per
    cell over 16 per clock per SM, the SM count and the clock; the bound
    itself (38 operations per cell at the float32 peak) does not depend on
    them, and dma_only has no transcendentals."""
    sms, clock = 132, 1.98e9
    for kind in ("compute_only", "stream_compute"):
        w = bench_sol.work(kind, 528, 2143, sms, clock)
        cells = 528 * 2143 * 256 * 256
        assert w["cells"] == cells
        np.testing.assert_allclose(w["sfu_floor_ms"],
                                   3 * cells / (16 * sms * clock) * 1e3,
                                   rtol=1e-12)
        # about 53 ms for the card-wide call at 1.98 GHz
        assert 52.0 < w["sfu_floor_ms"] < 54.0
        # the bound stays the 42.06 ms that earlier versions were held to
        assert w["bound_by"] == "operations"
        assert 42.0 < w["bound_ms"] < 42.1
        other = bench_sol.work(kind, 528, 2143, 66, 1.0e9)
        assert other["bound_ms"] == w["bound_ms"]
    np.testing.assert_allclose(
        bench_sol.work("stream_compute", 1, 4, 66, 1.0e9)["sfu_floor_ms"],
        3 * 4 * 256 * 256 / (16 * 66 * 1.0e9) * 1e3, rtol=1e-12)
    assert bench_sol.work("dma_only", 2, 3, sms, clock)["sfu_floor_ms"] \
        is None


def probe_float64(rec, kind):
    """The compute variants' two parts per walk, recomputed from the
    (B, 16, n) float32 table in float64 with numpy."""
    b, _, ne = rec.shape
    r = rec.astype(np.float64).reshape(b, 16, ne // 256, 256)
    lin = np.arange(256)
    px, py = (lin % 16)[:, None], (lin // 16)[:, None]
    out = []
    for wk in range(b):
        log_t, acc = np.zeros(256), np.zeros((256, 8))
        for k in range(ne // 256):
            g = r[wk, :, 0 if kind == "compute_only" else k, :]
            dx, dy = g[0] - px, g[1] - py
            p0 = -0.5 * (g[2] * dx * dx + g[4] * dy * dy) - g[3] * dx * dy
            m = np.minimum(p0 + g[6], g[7])
            m = np.where(m >= K3.LOG2_ALPHA_EPS, m, K3.DEAD_EXP)
            lg = np.log2(1.0 - np.exp2(m))
            cum = np.cumsum(lg, axis=1)
            acc += np.exp2(m + (cum - lg) + log_t[:, None]) @ g[8:16].T
            log_t += cum[:, -1]
        out.append([acc.sum(), log_t.sum()])
    return np.array(out)


@pytest.mark.parametrize("kind", ("compute_only", "stream_compute"))
def test_wide_alpha_table_plain_vs_float64(kind):
    """On the wide-alpha table a live cell's alpha spans [1/255, 0.99]
    (most live cells above the bench table's cap of 0.25), and the plain
    version's two parts agree with a float64 recomputation within 2e-6
    relative each (float32 rounding of the same pipeline; measured ~4e-7)."""
    rec = bench_sol.wide_alpha_table(2, 3, "cpu", seed=3)
    g = rec[:, :8].double()
    lin = torch.arange(256, dtype=torch.float64)
    dx = g[:, 0, None, :] - (lin % 16)[None, :, None]
    dy = g[:, 1, None, :] - torch.div(lin, 16, rounding_mode="floor")[
        None, :, None]
    p0 = -0.5 * (g[:, 2, None] * dx * dx + g[:, 4, None] * dy * dy) \
        - g[:, 3, None] * dx * dy
    m = torch.minimum(p0 + g[:, 6, None], g[:, 7, None])
    alpha = torch.exp2(m[m >= K3.LOG2_ALPHA_EPS])
    assert float(alpha.min()) < 0.005 and float(alpha.max()) > 0.98
    assert float((alpha > 0.25).double().mean()) > 0.5
    assert float(alpha.max()) <= 0.99 + 1e-6
    got = K3.sol_probe_torch(rec, kind).double().numpy()
    want = probe_float64(rec.numpy(), kind)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
