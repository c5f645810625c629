"""The ego + static cell (`bike_ego_t1_window`: configuration
`cmu_bike_ego`, program `programs/ego_static.py`, reference
`reference/ego.py`) at a tiny size on the CPU: a run through the harness
is correct, each planted fault and a port without its depth term are not;
the step's counts hold five renders and one update; `static_views_ms`
reduces a synthetic trace of marked steps, and reads None where a view
mark is missing."""

import functools

import pytest
import torch

from dynamic3dgaussians_tpu_torch.train import ego_trainer as TE
from portbench import counts, harness, manifest
from portbench.metrics import static_views_ms as SV
from portbench.reference import ego as ref_ego
from portbench.tests.conftest import TINY, TINY_WINDOW, Deferred

CELL = "bike_ego_t1_window"
EGO_TINY = dict(TINY, num_cams=4)          # the configuration's 4 static views


# a traced run's 2 x trace_steps steps cut to 2 x 10: five renders a step
# on the CPU
TRAFFIC = dict(TINY_WINDOW, trace_steps=10)


def ego_run(trace=False, seed=20240611):
    torch.set_num_threads(4)
    return harness.run_cell(CELL, seed, 0.2, trace, device="cpu",
                            graph_factory=Deferred, cfg_override=EGO_TINY,
                            traffic_override=TRAFFIC)


def test_the_cell_runs_correct_through_the_harness():
    result, lines = ego_run(trace=True)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    # no device: the trace's readers are silent, the counter is not
    assert set(result["metrics"]) == {"window_redo_share"}
    assert lines[1].startswith("portbench: program ")
    assert lines[2].startswith("portbench: reference ")


def _no_depth_term(outs, rig):
    return torch.stack([o.depth.sum() * 0.0 for o in outs])


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_depth"])
def test_a_fault_is_not_correct(monkeypatch, fault):
    if fault == "no_depth":           # the port without its depth term
        monkeypatch.setattr(TE, "_depth_terms", _no_depth_term)
    else:                             # the reference's planted fault
        monkeypatch.setattr(ref_ego, "follow", functools.partial(
            ref_ego.follow, fault=fault))
    result, lines = ego_run()
    assert result["correct"] is False, lines[-3:]


RENDERS = [dict(read_pairs=3000 + 100 * j, live_pairs=3500 + 50 * j,
                tiles=24, rows=1500) for j in range(5)]
STEP = dict(rows=1500, fg_rows=700, edges=14000, param_floats=21000)


def test_step_counts_hold_five_renders_and_one_update():
    cfg = dict(manifest.config("cmu_bike_ego"), **EGO_TINY)
    prog = manifest.program(cfg)
    got = prog.step_counts(dict(STEP, renders=RENDERS), cfg)
    n_chan = 6
    for name, fn, args in (
            ("k1", counts.k1, lambda r: (r["read_pairs"], r["tiles"],
                                         n_chan)),
            ("k2", counts.k2, lambda r: (r["read_pairs"], r["tiles"],
                                         n_chan)),
            ("e1", counts.e1, lambda r: (cfg["capacity"],
                                         r["live_pairs"]))):
        assert got[name] == counts.add(*(fn(*args(r)) for r in RENDERS))
    assert got["p1"] == counts.p1(STEP["fg_rows"], STEP["edges"])
    one = prog.step_counts(dict(STEP, renders=RENDERS[:1]), cfg)
    update = counts.update(STEP, cfg)
    for k in ("bytes", "flops"):
        render = one["step"][k] - update[k]
        assert render > 0
        # five renders' work, the update once
        assert got["step"][k] == pytest.approx(
            sum(prog.step_counts(dict(STEP, renders=[r]), cfg)["step"][k]
                - update[k] for r in RENDERS) + update[k], rel=1e-12)


def test_walk_stats_render_the_ego_and_every_static_view():
    cfg = dict(manifest.config("cmu_bike_ego"), **EGO_TINY)
    prog = manifest.program(cfg)
    inputs = prog.make(cfg, 5, "cpu")
    (walk,) = prog.walk_stats(inputs, cfg, [0])
    assert len(walk["renders"]) == 1 + cfg["num_cams"]
    assert all(r["live_pairs"] > 0 and r["read_pairs"] > 0
               for r in walk["renders"])
    assert walk["fg_rows"] > 0 and walk["edges"] == 20 * walk["fg_rows"]


# ------------------------------------------------ static_views_ms reduction

LEN = dict(render=100, image_loss=40, physics=20, physics_bwd=30,
           image_loss_bwd=60, render_bwd=150, update=50)
# where each view mark lies: (phase, us after the phase's mark)
VIEWS = (("render", 30, "static_rig"), ("render_bwd", 110, "ego"))
STATIC_US = (100 - 30) + 110


def build(n_windows=2, n_steps=3, drop=None):
    """(device ops, stretch) of n_windows windows of n_steps marked steps,
    each with its two view marks (but the one at index `drop` of the
    first step), and a window's read at its end."""
    ops, t, k = [], 0.0, 0
    for _ in range(n_windows):
        ops.append((t, t + 5, "Memcpy HtoD (Pageable -> Device)"))
        t += 10
        for _ in range(n_steps):
            for p in LEN:
                ops.append((t, t + 1, f"void d3g_mark<d3g_phase::{p}>()"))
                ops.append((t + 1, t + LEN[p], f"kernel_{p}"))
                for i, (q, at, view) in enumerate(VIEWS):
                    if q == p and not (k == 0 and i == drop):
                        ops.append((t + at, t + at + 1,
                                    f"void d3g_view_mark<d3g_view::{view}>"
                                    f"()"))
                t += LEN[p]
            k += 1
        ops.append((t, t + 4, "Memcpy DtoH (Device -> Pageable)"))
        t += 10
    return ops, (0.0, t)


def test_static_views_ms_reduces_a_marked_stretch():
    ops, window = build()
    assert SV.reduce(ops, window, 6, 2) == pytest.approx(STATIC_US * 1e-3)


@pytest.mark.parametrize("drop", range(len(VIEWS)))
def test_static_views_ms_reads_none_without_a_view_mark(drop):
    ops, window = build(drop=drop)
    assert SV.reduce(ops, window, 6, 2) is None


def test_static_views_ms_reads_none_with_a_view_mark_out_of_its_phase():
    ops, window = build()
    # the first step's ego mark moved out of render_bwd into update
    at = next(i for i, (_, _, n) in enumerate(ops) if "d3g_view::ego" in n)
    s, e, n = ops[at]
    ops[at] = (s + 60, e + 60, n)
    assert SV.reduce(ops, window, 6, 2) is None


def test_static_views_ms_reads_none_without_a_trace():
    class Run:
        probes = {}
    assert SV.read(Run()) is None
