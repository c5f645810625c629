"""The ego + static trainer's windowed step (`train/ego_trainer.py`) on the
CPU at a tiny size.

* The step against the benchmark's plain reference of it
  (`portbench/reference/ego.py`), from the same seeded inputs
  (`portbench/programs/ego_static.py::make` at 96x64, 1,500 gaussians, 4
  static views and a turned, masked ego frame, t = 1 with the physics
  losses), with the ego view rendered and its loss taken with the static
  views (joint) and on the path for static views of another size
  (apart): the first 3 steps' losses, the first step's gradient norm per
  table and each table's change. Tolerances, each with its reason: the
  losses 1e-6 relative and the gradients 1e-6 of max(the table's, the
  median table's) -- the same float32 terms, summed in another order and
  through the plain kernels against the reference's chunked walk (seen 9e-8
  and 3e-8); the changes 5e-3 of max(the table's, the median moved
  table's) -- Adam turns rounding-level gradients into steps of +-lr (seen
  3e-4, unnorm_rotations). The step without its depth term moves the loss
  by 3e-3 and the gradients by 3e-5, and the ego image turned the other
  way moves them by 3e-3 and 2e-2: both fail.
* `train_ego` in windows of 4 under a stand-in for the CUDA graph
  (`Deferred`) against the same run's steps one by one, over 3 timesteps
  whose static frames differ: bitwise, with one static rig loaded in place
  at each timestep and no capture for the third timestep's new frames.
* With tracing on, each step's seven phase marks once each, in order, and
  its view marks inside them: static_rig in render, where the first
  static view's own render begins, and ego in render_bwd, after the static
  views' own backward.
* `train_ego` with steps_per_call 1: every step eager, one ego frame each
  in the camera stream of `RandomState(cfg.seed)`, no window made.
* `rasterize.render_views` of 4 views against `render` of each.
"""

import statistics

import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
from dynamic3dgaussians_tpu_torch.train import config as tconf
from dynamic3dgaussians_tpu_torch.train import ego_trainer as TE
from dynamic3dgaussians_tpu_torch.utils import logging as LG
from portbench import manifest

SEED = 7
TINY = dict(n_gaussians=1500, capacity=6144, width=96, height=64,
            focal=80.0)
EAGER = dict(steps_per_call=1)
LOSS_REL = 1e-6
GRAD_REL = 1e-6
CHANGE_REL = 5e-3
PHYSICS = ("rigid", "rot", "iso", "floor", "bg", "soft_col_cons")


class Deferred:
    """The CUDA graph's stand-in: capture keeps the step, each replay runs
    it on the static buffers, as a replay of the captured kernels does."""

    def capture(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


# ----------------------------------------------- the step and its reference

@pytest.fixture(scope="module")
def bench():
    """(program module, cfg, traffic, inputs, the reference's numbers)."""
    torch.set_num_threads(4)
    cfg = dict(manifest.config("cmu_bike_ego"), **TINY)
    traffic = dict(manifest.traffic("t1_window"), **EAGER)
    prog = manifest.program(cfg)
    inputs = prog.make(cfg, SEED, torch.device("cpu"))
    cams = prog.first_cams(cfg, traffic, SEED)
    return prog, cfg, traffic, inputs, prog.follow(inputs, cfg, cams)


def _program(bench, **cfg_extra):
    prog, cfg, traffic, inputs, _ = bench
    run = prog.ProgramRun(inputs, dict(cfg, **cfg_extra), traffic, SEED,
                          torch.device("cpu"))
    return run.first_steps(traffic["check_min_steps"])


def _hold(got, want):
    assert len(got["losses"]) == len(want["losses"]) == 3
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= LOSS_REL * abs(b), (a, b)
    g_med = statistics.median(want["grad_norms"].values())
    for k, b in want["grad_norms"].items():
        a = got["grad_norms"][k]
        assert abs(a - b) <= GRAD_REL * max(b, g_med), (k, a, b)
    moved = [v for v in want["change_norms"].values() if v > 0]
    c_med = statistics.median(moved)
    for k, b in want["change_norms"].items():
        a = got["change_norms"][k]
        assert abs(a - b) <= CHANGE_REL * max(b, c_med), (k, a, b)


@pytest.mark.parametrize("views", ["joint", "apart"])
def test_ego_step_matches_the_plain_reference(bench, monkeypatch, views):
    """joint: the ego view rendered and its loss taken with the static
    views of its size; apart: the path for static views of another size,
    the ego view alone and then the static views."""
    *_, want = bench
    if views == "apart":
        monkeypatch.setattr(TE, "_joins", lambda cam, rig: False)
    got = _program(bench)
    _hold(got, want)
    # the step moved what it trains and nothing it freezes
    for k in ("means3D", "rgb_colors", "unnorm_rotations"):
        assert got["change_norms"][k] > 0
    for k in ("logit_opacities", "log_scales", "cam_m", "cam_c"):
        assert got["change_norms"][k] == 0
        assert got["grad_norms"][k] > 0


def _turned_the_other_way(x, rot90):
    return torch.rot90(x, k=-1, dims=(0, 1)) if rot90 else x


@pytest.mark.parametrize("broken", ["no_depth_term", "rot90_other_way"])
def test_the_comparison_sees_a_broken_step(bench, monkeypatch, broken):
    *_, want = bench
    if broken == "no_depth_term":
        got = _program(bench, stat_depth_weight=0.0)
    else:
        monkeypatch.setattr(TE, "_unturned", _turned_the_other_way)
        got = _program(bench)
    with pytest.raises(AssertionError):
        _hold(got, want)


# --------------------------------------------------------- train_ego runs

def _dataset(num_t=3, w=40, h=32):
    """A 3-timestep scene of 4 cameras: 0-1 the ego stream (turned, masked:
    the triangular mask), 2-3 the static rig with flat depth ground truth
    that changes with the timestep."""
    scene = tsyn.make_gt_scene(n_fg=20, n_bg=40, seed=0)
    tds, w2c, _ = tsyn.make_dataset(scene, num_t=num_t, num_cams=4, w=w,
                                    h=h, f=28.0, device="cpu")
    pt = tsyn.init_point_cloud(scene, noise=0.05)
    y = (torch.arange(w, dtype=torch.float32) + 0.5) / w
    x = (torch.arange(h, dtype=torch.float32) + 0.5) / h
    mask = ((y[:, None] + x[None, :]) <= 1.5).to(torch.float32)
    ego, stat = [], []
    for t, frames in enumerate(tds):
        ego.append([dict(camera=fr["camera"], cam_id=4, mask=mask,
                         im=torch.rot90(fr["im"], k=-1, dims=(0, 1)))
                    for fr in frames[:2]])
        stat.append([dict(camera=fr["camera"], cam_id=fr["cam_id"],
                          im=fr["im"], gt_depth=torch.full((h, w),
                                                           4.0 + 0.1 * t))
                     for fr in frames[2:]])
    return ego, stat, pt, w2c


def _config(steps_per_call, num_timesteps=3):
    return tconf.TrainConfig(
        num_timesteps=num_timesteps, iters_first_timestep=7, iters_per_timestep=11,
        capacity=128, densify_start=1000, densify_end=0, report_every=5,
        num_knn=8, steps_per_call=steps_per_call,
        raster=tconf.RasterSettings(chunk=64, max_per_tile=256,
                                    max_tiles_per_gaussian=16,
                                    pairs_per_gaussian=16))


def _train(steps_per_call, graph_factory=None, log=None):
    ego, stat, pt, w2c = _dataset()
    on_step = None if log is None else (
        lambda t, i, m: log.append((t, i, {k: v.clone()
                                           for k, v in m.items()})))
    return TE.train_ego(ego, stat, _config(steps_per_call), pt, w2c,
                        rot90_ego=True, device="cpu",
                        graph_factory=graph_factory,
                        callbacks={"on_step": on_step} if on_step else None)


def test_windowed_train_ego_is_its_eager_steps(monkeypatch):
    torch.set_num_threads(1)
    eager_log, window_log = [], []
    eager = _train(1, log=eager_log)
    rigs, windows = [], []
    make_rig, make_scan = TE.StaticRig, TE.make_train_scan

    class Kept(make_rig):
        def __init__(self, frames):
            super().__init__(frames)
            self.loads = 0
            rigs.append(self)

        def load(self, frames):
            self.loads += 1
            super().load(frames)

    def kept_scan(*a, **kw):
        scan = make_scan(*a, **kw)
        windows.append(scan.window)
        return scan
    monkeypatch.setattr(TE, "StaticRig", Kept)
    monkeypatch.setattr(TE, "make_train_scan", kept_scan)
    windowed = _train(4, graph_factory=Deferred, log=window_log)

    # one rig, loaded in place at t = 1 and t = 2; one window, whose graph
    # is captured at t = 0 and at t = 1 (after the compaction), not at t = 2
    (rig,) = rigs
    assert rig.loads == 2
    assert torch.equal(rig.gt_depth, torch.full_like(rig.gt_depth, 4.2))
    (window,) = windows
    assert window.stats["captures"] == 2
    assert window.stats["replays"] > 0 and window.stats["redos"] == 0

    (out_e, p_e, v_e), (out_w, p_w, v_w) = eager, windowed
    assert len(out_e) == len(out_w) == 3
    for a, b in zip(out_e, out_w):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in p_e:
        assert torch.equal(p_e[k], p_w[k]), k
    for k, v in v_e.items():
        assert torch.equal(v, v_w[k]), k
    assert [x[:2] for x in eager_log] == [x[:2] for x in window_log]
    for (_, _, a), (_, _, b) in zip(eager_log, window_log):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_train_ego_one_step_a_call_is_the_eager_loop(monkeypatch):
    """steps_per_call 1: no window is made, every step runs the ego step
    once, eagerly, on one ego frame of the camera stream of
    RandomState(seed) without replacement (each timestep's permutations
    drawn anew); the reports carry the reference's metrics."""
    steps, log = [], []
    make_step = TE.make_ego_step

    def logged(*a, **kw):
        step = make_step(*a, **kw)

        def run(params, opt, variables, batch, lrs, is_initial, **skw):
            assert skw == {}
            steps.append((id(batch), is_initial))
            return step(params, opt, variables, batch, lrs, is_initial)
        return run

    def no_scan(*a, **kw):
        raise AssertionError("a window was made")
    monkeypatch.setattr(TE, "make_ego_step", logged)
    monkeypatch.setattr(TE, "make_train_scan", no_scan)
    ego, stat, pt, w2c = _dataset()
    cfg = _config(1)
    TE.train_ego(ego, stat, cfg, pt, w2c, rot90_ego=True, device="cpu",
                 callbacks={"on_step": lambda t, i, m: log.append(
                     (t, i, sorted(m)))})
    rng = np.random.RandomState(cfg.seed)
    want = []
    for t, n in enumerate((7, 11, 11)):
        todo = []                     # each timestep's stream starts anew
        for _ in range(n):
            if not todo:
                todo = list(rng.permutation(2))
            want.append((id(ego[t][todo.pop()]), t == 0))
    assert steps == want
    assert [x[:2] for x in log] == [(0, 0), (0, 5), (1, 0), (1, 5),
                                    (1, 10), (2, 0), (2, 5), (2, 10)]
    base = ["loss", "loss_depth", "loss_im", "loss_stat_im"]   # no drops
    assert log[0][2] == base
    assert log[-1][2] == sorted(base + [f"loss_{k}" for k in PHYSICS])


# ------------------------------------------------------------------ marks

class Ranges(list):
    """Stands in for `torch.profiler.record_function`: logs the names of
    the host ranges in the order the host enters them."""

    def range(self, name):
        log = self

        class Range:
            def __enter__(self):
                log.append(name)
                return self

            def __exit__(self, *exc):
                pass
        return Range()


STEP_MARKS = ["mark.render", "view_mark.static_rig", "mark.image_loss",
              "mark.physics", "mark.physics_bwd", "mark.image_loss_bwd",
              "mark.render_bwd", "view_mark.ego", "mark.update"]


@pytest.mark.parametrize("how", ["eager", "window"])
def test_each_step_marks_its_phases_and_views_in_order(monkeypatch, how):
    torch.set_num_threads(1)
    ranges = Ranges()
    ego, stat, pt, w2c = _dataset(num_t=2)
    cfg = _config(4 if how == "window" else 1, num_timesteps=2)
    steps = 7 + 11
    monkeypatch.setattr(torch.profiler, "record_function", ranges.range)
    LG.set_tracing(True)
    try:
        TE.train_ego(ego, stat, cfg, pt, w2c, rot90_ego=True, device="cpu",
                     graph_factory=Deferred)
    finally:
        LG.set_tracing(False)
    marks = [n for n in ranges if n.startswith(("mark.", "view_mark."))]
    assert marks == STEP_MARKS * steps
    assert [n[len("mark."):] for n in marks if n.startswith("mark.")] == \
        list(LG.PHASES) * steps


# ----------------------------------------------------------- render_views

def test_render_views_is_each_views_render():
    """`rasterize.render_views` of 4 views of one size against `render`
    of each: the same outputs, since the views' projection is the same
    elementwise operations broadcast over the views, and the gradients of
    the shared inputs those of the summed renders to 1e-6 of their norm,
    summed over the views in another order (seen 8e-8)."""
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.ops.camera import stack_views
    from dynamic3dgaussians_tpu_torch.ops.rasterize import (
        RasterConfig, render, render_views)
    torch.set_num_threads(1)
    ego, stat, pt, w2c = _dataset(num_t=1)
    cams = [f["camera"] for f in ego[0] + stat[0]]
    params, variables = G.init_params(pt, w2c, capacity=128, device="cpu")
    act = G.activated(params, variables["alive"])
    names = ("means3d", "colors", "opacity", "scales", "rotations")
    seg = params["seg_colors"]
    rcfg = RasterConfig(chunk=64, max_tiles_per_gaussian=16)
    weights = [torch.rand((32, 40, n), generator=torch.Generator()
                          .manual_seed(j), dtype=torch.float32)
               for j, n in enumerate((3, 3, 1, 1))]

    def run(draw):
        leaves = [act[k].detach().requires_grad_(True) for k in names]
        probe = torch.zeros((leaves[0].shape[0], 2), requires_grad=True)
        outs = draw(leaves, probe)
        loss = sum(torch.sum(w * t.reshape(w.shape)) for o in outs
                   for w, t in zip(weights, (o.rgb, o.extra, o.depth,
                                             o.alpha)))
        return outs, torch.autograd.grad(loss, leaves + [probe])

    kw = dict(extra_channels=seg, config=rcfg, method="torch")
    each, g_each = run(lambda x, p: [
        render(c, *x, mean2d_probe_ndc=p, device="cpu", **kw) for c in cams])
    views, g_views = run(lambda x, p: render_views(
        stack_views(cams), *x, mean2d_probe_ndc=p, **kw))
    assert len(views) == len(cams)
    for a, b in zip(each, views):
        for k in ("rgb", "extra", "depth", "alpha", "radii",
                  "n_dropped_rect"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    for a, b in zip(g_each, g_views):
        assert torch.linalg.vector_norm(a - b) <= \
            1e-6 * torch.linalg.vector_norm(a)
