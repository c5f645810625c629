"""Port parity: the scale run (`dynamic3dgaussians_tpu_torch/tools/
scale_run.py`) against the reference's `tools/scale_run.py`, at a small
size on the CPU.

Both tools on the same (port-rendered) images up to the first densify
pass at step 100, the reference on its kernel path ("pallas", interpret
mode) as on its TPU, since both tools ship `pack_records=True`, which the
reference's CPU path ("tiled") ignores: the loss of every step within
1e-4 relative, the whole-run bound of
tests/test_torch_physics.py (over 100 steps Adam turns rounding-level
gradient differences into +-lr moves that accumulate: 1e-7 - 5e-7 over
the first 70 steps, up to 3.8e-5 by step 100; with the record pack's
bf16 gradient rounding, up to 7.0e-5), PSNR at the reports within one
step of the logs' 1e-3 rounding, and the densify counts equal with the reference's split
noise injected (`densify(noise=)`). Past that the random streams differ
(`torch.Generator`, `jax.random`), so a longer run holds the port's own
invariants: alive <= capacity, a grow event when the free slots run
out, K doubling at a report with rect drops, and the `--min_gain_db`
exit.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.train import trainer as jtr
from dynamic3dgaussians_tpu_torch.tools import scale_run
from dynamic3dgaussians_tpu_torch.train import densify as tden
from dynamic3dgaussians_tpu_torch.train import trainer as ttr
from tests.test_torch_tools import _jax_frames, _run_reference, _step_recorder

torch.set_num_threads(1)

SR_ARGV = ["--n", "300", "--hw", "48", "--cams", "3", "--iters", "101",
           "--report", "20", "--densify_every", "100", "--k_cap", "16"]


def _on_kernel_path(make):
    """The reference's make_train_step with its raster method set to
    "pallas": the path its tool's settings are for."""
    def wrapped(cfg, rcfg, *a, **kw):
        cfg = dataclasses.replace(cfg, raster=dataclasses.replace(
            cfg.raster, method="pallas"))
        return make(cfg, rcfg, *a, **kw)
    return wrapped


def test_scale_run_matches_reference_tool_up_to_first_densify(tmp_path):
    """Both tools on the port-rendered images; at i = 100 the first
    densify pass, its split noise the reference's draws (PRNGKey(0), one
    split per pass, then densify's own split into the two children)."""
    args = scale_run.parse_args(SR_ARGV + ["--device", "cpu",
                                           "--out", str(tmp_path / "p.json")])
    tds, w2c, _ = scale_run.build_data(args, "cpu")
    jds = [_jax_frames(tds[0])]
    key = jax.random.PRNGKey(0)
    _, sub = jax.random.split(key)
    ref_keys = jax.random.split(sub)

    def noise_for(cap):
        return tuple(torch.tensor(np.asarray(jax.random.normal(k, (cap, 3))))
                     for k in ref_keys)

    port_losses, jax_losses = [], []
    densify = tden.densify
    with pytest.MonkeyPatch.context() as mp:
        # the reference renders the ground truth itself; give it the port's
        # images (the camera orbit is the same in both)
        mp.setattr("dynamic3dgaussians_tpu.data.synthetic.make_dataset",
                   lambda *a, **kw: (jds, w2c, None))
        mp.setattr(jtr, "make_train_step",
                   _on_kernel_path(jtr.make_train_step))
        mp.setattr(jtr, "make_train_step", _step_recorder(jtr, jax_losses))
        _run_reference(mp, "scale_run",
                       SR_ARGV + ["--out", str(tmp_path / "r.json")])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "make_train_step", _step_recorder(ttr, port_losses))
        mp.setattr(tden, "densify", lambda p, v, o, i, generator=None:
                   densify(p, v, o, i, noise=noise_for(
                       int(v["alive"].shape[0]))))
        got = scale_run.run(args)
    with open(tmp_path / "r.json") as f:
        want = json.load(f)
    assert len(port_losses) == len(jax_losses) == 101
    for tl, jl in zip(port_losses, jax_losses):
        assert abs(tl - jl) <= 1e-4 * abs(jl), (tl, jl)
    assert [p["i"] for p in got["psnr"]] == [p["i"] for p in want["psnr"]]
    for a, b in zip(got["psnr"], want["psnr"]):
        # both logs round PSNR to 1e-3: at most one step apart, counted in
        # steps (the float difference of two rounded values one step apart
        # can exceed 1e-3 by a representation error)
        assert abs(round(a["psnr"] * 1000) - round(b["psnr"] * 1000)) <= 1, \
            (a, b)
    assert got["densify"] == want["densify"]
    assert got["densify"][0]["cloned"] + got["densify"][0]["split"] > 0
    assert got["grow_tiles"] == want["grow_tiles"] == []
    assert got["n_dropped_rect"] == want["n_dropped_rect"] == 0
    assert set(want) <= set(got)


def test_scale_run_own_invariants(tmp_path):
    """Past the first densify pass: twice the ground truth to fit, K = 2
    and densify every 50 steps from 100. The tables must grow when a pass
    runs out of free slots, K must double at a report with rect drops,
    alive never passes capacity, and an unreachable --min_gain_db exits
    non-zero after writing the whole log."""
    out = tmp_path / "s.json"
    with pytest.raises(SystemExit, match="PSNR gain"):
        scale_run.main(["--n", "300", "--gt_mult", "2", "--hw", "48",
                        "--cams", "3", "--iters", "160", "--report", "20",
                        "--densify_every", "50", "--k_cap", "2",
                        "--min_gain_db", "1000", "--device", "cpu",
                        "--out", str(out)])
    with open(out) as f:
        log = json.load(f)
    assert log["completed"] and log["psnr_gain_db"] > 2.0
    ev = log["densify"]
    assert [e["i"] for e in ev] == [100, 150]
    for e in ev:
        assert e["alive"] <= e["capacity"] and e["dropped"] == 0
    assert log["final_alive"] <= log["final_capacity"]
    assert ev[-1]["capacity"] > ev[0]["capacity"] == 1024
    ks = [g["k"] for g in log["grow_tiles"]]
    assert ks[:2] == [4, 8] and all(g["dropped_rect"] > 0
                                    for g in log["grow_tiles"])
    assert log["n_dropped_rect"] >= sum(g["dropped_rect"]
                                        for g in log["grow_tiles"])
    reports = [p["i"] for p in log["psnr"]]
    assert [s["i"] for s in log["rect_split"]] == reports
    for s in log["rect_split"]:
        assert 0 <= s["live_rows"] <= s["all_rows"]
        assert s["alive"] <= s["rows"]
