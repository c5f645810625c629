"""Port parity: the multi-step training window (`steps_per_call`).

The reference's window (`make_train_scan`, `stack_timestep_data`, the
window loop of `train`) against the port's, on the world of
`tests/test_train_scan.py` (64x48, 3 cameras, 2 timesteps, its
RasterSettings). On the card the port's window is one train step captured
as a CUDA graph and replayed (`train/step_graph.py`); here the graph is
replaced by a stand-in that keeps the captured step and runs it at each
replay (`Deferred`), so the static buffers, the fixed pair capacity of the
record table (`prepare_records_static`), the write-back and the redo after
an overflow all run on the CPU.

Tolerances, each with its reason:
* the port's window against the port's single steps, the static record
  table against the eager one, `train(steps_per_call=W)` against
  `train(steps_per_call=1)`: bitwise (`torch.equal`), since both run the
  same operations in the same order on the same values;
* the port's `train(steps_per_call=4)` against the reference's: as
  `tests/test_torch_physics.py` holds the whole run (the total loss per
  report rel 1e-4, the image and segmentation losses rel 1e-5, parameters
  within 2 lr per step, grown through the forward extrapolation);
* the window's summed drop count against the reference's window: equal
  (integer counts of the same emission on states that agree to rounding);
* host actions (densify, opacity reset, report, checkpoint, K escalation)
  and the camera stream: equal step for step, with the trainers' device
  math replaced by stand-ins so that only the loops are held.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamic3dgaussians_tpu.train.checkpoint as jckpt
from dynamic3dgaussians_tpu.data import synthetic as jsyn
from dynamic3dgaussians_tpu.models import gaussians as JG
from dynamic3dgaussians_tpu.ops import camera as jcam
from dynamic3dgaussians_tpu.train import config as jconf
from dynamic3dgaussians_tpu.train import optim as jopt
from dynamic3dgaussians_tpu.train import trainer as jtr
from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
from dynamic3dgaussians_tpu_torch.models import gaussians as TG
from dynamic3dgaussians_tpu_torch.ops import rasterize as trast
from dynamic3dgaussians_tpu_torch.ops import sorted_raster as SR
from dynamic3dgaussians_tpu_torch.ops.cuda import launches
from dynamic3dgaussians_tpu_torch.ops.cuda import raster_bwd, raster_fwd
from dynamic3dgaussians_tpu_torch.ops.projection import project
from dynamic3dgaussians_tpu_torch.train import config as tconf
from dynamic3dgaussians_tpu_torch.train import optim as topt
from dynamic3dgaussians_tpu_torch.train import step_graph
from dynamic3dgaussians_tpu_torch.train import trainer as ttr

torch.set_num_threads(1)

RS = dict(chunk=64, max_per_tile=512, max_tiles_per_gaussian=64,
          pairs_per_gaussian=16)
SCENE_KW = dict(n_fg=50, n_bg=90, seed=3)
W, H, F = 64, 48, 55.0
SEL = [0, 2, 1, 0]


class Deferred:
    """The CUDA graph's stand-in: capture keeps the step, each replay runs
    it on the static buffers, as a replay of the captured kernels does."""

    def capture(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


class AtCapture:
    """A stand-in that runs the step's host code at capture, as a CUDA
    capture does, and nothing at a replay, as the host sees a replay."""

    def capture(self, fn):
        fn()

    def replay(self):
        pass


@pytest.fixture(scope="module")
def world():
    """The scene of tests/test_train_scan.py rendered by the port into 2
    timesteps of 3 cameras, as datapoints of both packages."""
    scene = tsyn.make_gt_scene(**SCENE_KW)
    tds, w2c, _ = tsyn.make_dataset(scene, num_t=2, num_cams=3, w=W, h=H,
                                    f=F, device="cpu")
    pt = tsyn.init_point_cloud(scene, noise=0.05)
    np.testing.assert_array_equal(pt, jsyn.init_point_cloud(
        jsyn.make_gt_scene(**SCENE_KW), noise=0.05))
    k = [[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]]
    ds = [[{"camera": jcam.make_camera(W, H, k, np.asarray(
                fr["camera"].w2c.numpy(), np.float64), near=0.01,
                far=100.0),
            "im": jnp.asarray(fr["im"].numpy()),
            "seg": jnp.asarray(fr["seg"].numpy()),
            "cam_id": jnp.int32(fr["cam_id"])} for fr in frames]
          for frames in tds]
    return ds, tds, pt, w2c


def _tcfg(**kw):
    rs = dict(RS, **kw.pop("raster", {}))
    return tconf.TrainConfig(raster=tconf.RasterSettings(**rs), **kw)


def _start(world, is_initial, k):
    """(state, frames, cfg, lrs) of a window at t = 0 or, through the
    port's own t = 0 -> t = 1 transition, at t = 1 (physics terms on)."""
    _, tds, pt, w2c = world
    cfg = _tcfg(num_timesteps=2, capacity=512, num_knn=8,
                raster=dict(max_tiles_per_gaussian=k))
    params, variables = TG.init_params(pt, w2c, capacity=512, device="cpu")
    opt = topt.init(params)
    if not is_initial:
        params, variables, opt, _ = TG.compact_with_optimizer(
            params, variables, opt)
        params, variables, opt = ttr.initialize_post_first_timestep(
            params, variables, cfg, opt)
        params, variables, opt = ttr.initialize_per_timestep(
            params, variables, opt)
    lrs = {key: torch.tensor(1e-3) for key in params}
    return (params, opt, variables), tds[0 if is_initial else 1], cfg, lrs


def _assert_state_equal(a, b):
    (pa, oa, va), (pb, ob, vb) = a, b
    for key in pa:
        assert torch.equal(pa[key], pb[key]), f"params.{key}"
    for m in ("mu", "nu"):
        for key in oa.mu:
            assert torch.equal(getattr(oa, m)[key], getattr(ob, m)[key]), \
                f"{m}.{key}"
    assert torch.equal(oa.step, ob.step)
    assert set(va) == set(vb)
    for key in va:
        if isinstance(va[key], torch.Tensor):
            assert torch.equal(va[key], vb[key]), f"vars.{key}"


# ------------------------------------------- the window against its steps

@pytest.mark.parametrize("k", [64, 4])
@pytest.mark.parametrize("is_initial", [True, False])
@pytest.mark.parametrize("graph", [False, True])
def test_scan_matches_single_steps(world, graph, is_initial, k):
    """make_train_scan(4 steps) is bitwise 4 sequential train_step calls,
    as the loop (CPU) and as the graph window (the stand-in), at t = 0
    and t > 0; its metrics are the last step's, its drop counts the sum of
    the steps' (K = 4 drops pairs, K = 64 none)."""
    state, frames, cfg, lrs = _start(world, is_initial, k)
    rcfg = ttr.raster_config(cfg)
    step = ttr.make_train_step(cfg, rcfg)
    p, o, v = state
    ms = []
    for c in SEL:
        p, o, v, m = step(p, o, v, frames[c], lrs, is_initial)
        ms.append(m)
    scan = ttr.make_train_scan(cfg, rcfg, step,
                               graph_factory=Deferred if graph else None)
    p2, o2, v2, m2 = scan(*state, ttr.stack_timestep_data(frames),
                          torch.tensor(SEL), lrs, is_initial)
    _assert_state_equal((p, o, v), (p2, o2, v2))
    assert torch.equal(m2["loss"], ms[-1]["loss"])
    for key in ("n_dropped", "n_dropped_rect"):
        want = sum(int(x[key]) for x in ms)
        assert int(m2[key]) == want and m2[key].dtype == ms[-1][key].dtype
    assert (sum(int(x["n_dropped_rect"]) for x in ms) > 0) == (k == 4)
    assert set(m2) == set(ms[-1])
    if graph:
        win = scan.window
        assert win.stats["captures"] == 1 and win.stats["replays"] == 2
        assert win.stats["eager_steps"] == 2 and win.stats["redos"] == 0
        assert torch.equal(win.last_steps["loss"],
                           torch.stack([x["loss"] for x in ms]))
        assert win.stats["max_live"] <= win.pair_cap


def test_window_overflow_is_redone(world):
    """A capacity below a step's live pairs: the window's result is thrown
    away, the capacity grows, the step is captured again and the window
    runs again from the caller's tensors, which it never wrote: the result
    is still bitwise the single steps'."""
    state, frames, cfg, lrs = _start(world, True, 64)
    rcfg = ttr.raster_config(cfg)
    step = ttr.make_train_step(cfg, rcfg)
    before = [t.clone() for t in state[0].values()]
    p, o, v = state
    for c in SEL:
        p, o, v, _ = step(p, o, v, frames[c], lrs, True)
    scan = ttr.make_train_scan(cfg, rcfg, step, graph_factory=Deferred)
    data = ttr.stack_timestep_data(frames)
    scan(*state, data, torch.tensor(SEL), lrs, True)
    win = scan.window
    win.pair_cap = 16                   # far below the live pairs
    out = scan(*state, data, torch.tensor(SEL), lrs, True)
    _assert_state_equal((p, o, v), out[:3])
    assert win.stats["redos"] == 1 and win.stats["captures"] == 3
    assert win.pair_cap >= win.stats["max_live"]
    for a, b in zip(before, state[0].values()):
        assert torch.equal(a, b)


def test_window_carries_capacity_across_k(world):
    """After a K escalation `train` goes on with the same StepWindow
    (`make_train_scan(..., window=)`): the new step is captured again, the
    pair capacity is kept (grown by a redo if the new K's live pairs pass
    it), and the window is still bitwise the single steps at the new K."""
    state, frames, cfg, lrs = _start(world, True, 4)
    data = ttr.stack_timestep_data(frames)
    scan = ttr.make_train_scan(cfg, ttr.raster_config(cfg),
                               graph_factory=Deferred)
    state = scan(*state, data, torch.tensor(SEL), lrs, True)[:3]
    win = scan.window
    cap, seeded = win.pair_cap, win.stats["eager_steps"]
    cfg16 = dataclasses.replace(cfg, raster=dataclasses.replace(
        cfg.raster, max_tiles_per_gaussian=16))
    rcfg16 = ttr.raster_config(cfg16)
    step16 = ttr.make_train_step(cfg16, rcfg16)
    scan16 = ttr.make_train_scan(cfg16, rcfg16, step16, window=win)
    assert scan16.window is win and win.k_slots == 16
    p, o, v = state
    for c in SEL:
        p, o, v, _ = step16(p, o, v, frames[c], lrs, True)
    out = scan16(*state, data, torch.tensor(SEL), lrs, True)
    _assert_state_equal((p, o, v), out[:3])
    # the K = 16 live pairs still fit: the capacity is kept, and the new
    # step costs one warm-up and one capture, no seed step
    assert win.stats["max_live"] <= cap and win.stats["redos"] == 0
    assert win.pair_cap == cap and win.stats["captures"] == 2
    assert win.stats["eager_steps"] == seeded + 1


def test_host_counts_launches_not_replays(world, monkeypatch):
    """The wrappers count a launch on the host where they make it, and a
    replay makes none: with a stand-in that runs the step's host code at
    capture and nothing at a replay, a 5-step window counts K1 and K2 3
    times each (2 eager steps and the capture), while 3 replays run. The
    kernels' own device counters count the replays on the card."""
    fwd, bwd = raster_fwd.composite_tiles, raster_bwd.composite_tiles_bwd
    plain_f, plain_b = SR.composite_tiles_torch, SR.composite_tiles_bwd_torch

    def counted_f(*a, **kw):
        fwd.launches += 1
        return plain_f(*a, **kw)

    def counted_b(*a, **kw):
        bwd.launches += 1
        return plain_b(*a, **kw)
    monkeypatch.setattr(SR, "composite_tiles_torch", counted_f)
    monkeypatch.setattr(SR, "composite_tiles_bwd_torch", counted_b)
    monkeypatch.setattr(fwd, "launches", 0)
    monkeypatch.setattr(bwd, "launches", 0)
    state, frames, cfg, lrs = _start(world, True, 64)
    rcfg = ttr.raster_config(cfg)
    scan = ttr.make_train_scan(cfg, rcfg, graph_factory=AtCapture)
    scan(*state, ttr.stack_timestep_data(frames), torch.tensor(SEL + [1]),
         lrs, True)
    stats = scan.window.stats
    assert (stats["eager_steps"], stats["captures"], stats["replays"]) == \
        (2, 1, 3)
    assert (fwd.launches, bwd.launches) == (3, 3)


def test_run_counters(monkeypatch):
    """A wrapper's device counter is made once per device and zeroed in
    place (a captured graph keeps its address); made for the first time
    inside a capture, it raises."""
    def fn():
        pass
    fn.launches = 4
    c = launches.counter(fn, torch.device("cpu"))
    assert launches.counter(fn, torch.device("cpu")) is c
    c += 3
    assert launches.runs(fn) == 3
    ptr = c.data_ptr()
    launches.zero(fn)
    assert launches.runs(fn) == 0 and fn.launches == 0
    assert launches.counter(fn, torch.device("cpu")).data_ptr() == ptr
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="before capturing"):
        launches.counter(fn, torch.device("cuda", 0))


# ------------------------------------------------ the static record table

def _emission(world, k=64):
    _, tds, pt, w2c = world
    params, variables = TG.init_params(pt, w2c, capacity=512, device="cpu")
    act = TG.activated(params, variables["alive"])
    cam = tds[0][1]["camera"]
    proj = project(act["means3d"], act["scales"], act["rotations"], cam)
    op = torch.where(proj.valid, act["opacity"],
                     torch.zeros_like(act["opacity"]))
    chans = torch.cat([act["colors"], params["seg_colors"]], dim=-1)
    tile_key, gid, _ = SR.emit(H, W, proj, op, tile_h=16, tile_w=16,
                               max_tiles_per_gaussian=k, exact_cull=True,
                               enum_cap=0)
    table = SR.record_columns(proj, chans, op).detach()
    return tile_key, gid, table, chans.shape[1]


@pytest.mark.parametrize("depth_mode", ["quantized", "exact", "total"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("room", [0, 300])
def test_static_records_match_eager(world, depth_mode, fused, room):
    """With pair_cap >= the live count (exactly it, or more) the static
    table, tile ranges and slots are bitwise the eager ones on the live
    pairs, the columns past them zero with distinct unused slots, the
    stats [live, 0]."""
    tile_key, gid, table, n_chan = _emission(world)
    num_tiles = 12
    kw = dict(n_chan=n_chan, num_tiles=num_tiles, chunk=64,
              bits_z=SR.depth_key_bits(num_tiles) if fused else 0,
              depth_mode=depth_mode)
    rec_e, st_e, cn_e, slot_e = SR.prepare_records(tile_key, gid, table,
                                                   **kw)
    n_live = slot_e.shape[0]
    assert n_live > 0
    rec_s, st_s, cn_s, slot_s, stats = SR.prepare_records_static(
        tile_key, gid, table, pair_cap=n_live + room, **kw)
    assert stats.tolist() == [n_live, 0]
    assert rec_s.shape[1] == (-(-(n_live + room) // 64) + 1) * 64
    assert torch.equal(rec_s[:, :n_live], rec_e[:, :n_live])
    assert not bool(rec_s[:, n_live:].any())
    assert torch.equal(st_s, st_e) and torch.equal(cn_s, cn_e)
    assert torch.equal(slot_s[:n_live], slot_e)
    # the unused columns: distinct unused emission slots
    assert bool((tile_key[slot_s[n_live:]] == num_tiles).all())
    assert torch.unique(slot_s).numel() == slot_s.numel()


def test_static_records_count_overflow(world):
    """A pair_cap below the live count: the overflow is counted on the
    device and the table holds pair_cap pairs."""
    tile_key, gid, table, n_chan = _emission(world)
    n_live = int((tile_key < 12).sum())
    cap = n_live // 2
    rec_s, st_s, cn_s, slot_s, stats = SR.prepare_records_static(
        tile_key, gid, table, n_chan=n_chan, num_tiles=12, chunk=64,
        bits_z=SR.depth_key_bits(12), depth_mode="quantized", pair_cap=cap)
    assert stats.tolist() == [n_live, n_live - cap]
    assert int(cn_s.sum()) == cap and bool((slot_s < tile_key.shape[0]).all())


def test_static_render_gradients_bitwise(world):
    """`render` with a pair_cap gives bitwise the eager render and
    gradients, reports the live pairs, and reports an overflow past a
    small capacity instead of folding it into the drop counts."""
    _, tds, pt, w2c = world
    params, variables = TG.init_params(pt, w2c, capacity=512, device="cpu")
    cam = tds[0][2]["camera"]

    def run(cap):
        leaves = {key: params[key].detach().clone().requires_grad_(True)
                  for key in ("means3D", "rgb_colors", "logit_opacities",
                              "log_scales", "unnorm_rotations")}
        act = TG.activated(dict(params, **leaves), variables["alive"])
        out = trast.render(cam, act["means3d"], act["colors"],
                           act["opacity"], act["scales"], act["rotations"],
                           extra_channels=params["seg_colors"],
                           method="torch", device="cpu", pair_cap=cap)
        loss = (out.rgb.square().sum() + out.depth.sum()
                + out.extra.sum() * 0.5)
        return out, torch.autograd.grad(loss, list(leaves.values()))

    eager, g_eager = run(None)
    assert eager.n_live_pairs is None
    n_live = int(run(512 * 8)[0].n_live_pairs)
    static, g_static = run(n_live + 100)
    for name in ("rgb", "depth", "alpha", "extra", "radii",
                 "n_dropped_rect"):
        assert torch.equal(getattr(static, name), getattr(eager, name)), name
    for a, b in zip(g_static, g_eager):
        assert torch.equal(a, b)
    assert int(static.n_pair_overflow) == 0 and n_live > 0
    small, _ = run(n_live - 10)
    assert int(small.n_pair_overflow) == 10
    assert int(small.n_dropped_rect) == int(eager.n_dropped_rect)


# ------------------------------------------------------- train() windows

def _events(log):
    return {"on_step": lambda t, i, m: log.append(
                ("report", t, i, float(m["loss"]), int(m["n_dropped"]),
                 int(m["n_dropped_rect"]))),
            "on_densify": lambda t, i, s: log.append(("densify", t, i)),
            "on_grow_tiles": lambda t, i, k: log.append(("grow", t, i, k))}


@pytest.mark.parametrize("steps_per_call", [4, 5])
def test_train_windows_equal_single_steps(world, steps_per_call,
                                          monkeypatch):
    """The port's train() with windows (the graph stand-in, K escalated
    from 4 at reports, densify at 8 and 16) gives bitwise the outputs of
    steps_per_call = 1, with densify, K escalation and reports on the same
    steps and the same losses; only a report's drop counts differ, being
    the window's sums."""
    _, tds, pt, w2c = world

    def run(spc):
        cfg = _tcfg(num_timesteps=2, iters_first_timestep=24,
                    iters_per_timestep=12, densify_start=8, densify_every=8,
                    densify_end=16, capacity=512, report_every=4,
                    steps_per_call=spc, seed=7,
                    raster=dict(max_tiles_per_gaussian=4))
        log = []
        out = ttr.train(tds, cfg, pt, w2c, callbacks=_events(log),
                        device="cpu")[0]
        return out, log

    out1, log1 = run(1)
    make = ttr.make_train_scan
    monkeypatch.setattr(ttr, "make_train_scan", lambda c, r, s=None, **kw:
                        make(c, r, s, graph_factory=Deferred, **kw))
    out_w, log_w = run(steps_per_call)
    for t in range(2):
        assert set(out1[t]) == set(out_w[t])
        for key in out1[t]:
            np.testing.assert_array_equal(out1[t][key], out_w[t][key])
    assert [e[:4] for e in log1] == [e[:4] for e in log_w]
    assert [e[0] for e in log1].count("grow") == 2


# ------------------------------------- the reference's train(), windowed

RUN_KW = dict(num_timesteps=2, iters_first_timestep=12, iters_per_timestep=8,
              densify_start=10 ** 9, capacity=512, report_every=4, seed=7,
              steps_per_call=4, num_knn=8)


@pytest.fixture(scope="module")
def runs(world):
    """The reference's train() and the port's (its window through the
    graph stand-in), steps_per_call = 4, method "pallas" on both sides
    (the reference's kernels in interpret mode, the port's plain
    versions)."""
    ds, tds, pt, w2c = world
    jcfg = jconf.TrainConfig(raster=jconf.RasterSettings(
        method="pallas", **RS), **RUN_KW)
    tcfg = _tcfg(raster=dict(method="pallas"), **RUN_KW)
    jlog, tlog = [], []

    def rec(log):
        return {"on_step": lambda t, i, m: log.append(
            (t, i, {key: float(v) for key, v in m.items()}))}
    jout = jtr.train(ds, jcfg, pt, w2c, callbacks=rec(jlog))[0]
    make = ttr.make_train_scan
    ttr.make_train_scan = lambda c, r, s=None, **kw: make(
        c, r, s, graph_factory=Deferred, **kw)
    try:
        tout, _, tvars = ttr.train(tds, tcfg, pt, w2c, callbacks=rec(tlog),
                                   device="cpu")
    finally:
        ttr.make_train_scan = make
    return dict(jlog=jlog, tlog=tlog, jout=jout, tout=tout, tcfg=tcfg,
                radius=float(tvars["scene_radius"]))


def test_train_window_losses_match_jax(runs):
    jlog, tlog = runs["jlog"], runs["tlog"]
    assert [x[:2] for x in tlog] == [x[:2] for x in jlog] == [
        (0, 0), (0, 4), (0, 8), (1, 0), (1, 4)]
    for (t, i, tm), (_, _, jm) in zip(tlog, jlog):
        assert abs(tm["loss"] - jm["loss"]) <= 1e-4 * abs(jm["loss"]), \
            (t, i, tm["loss"], jm["loss"])
        for key in ("loss_im", "loss_seg"):
            assert abs(tm[key] - jm[key]) <= 1e-5 * abs(jm[key]), (t, i, key)
        assert tm["n_dropped"] == jm["n_dropped"] == 0


def test_train_window_outputs_match_jax(runs):
    jout, tout, tcfg = runs["jout"], runs["tout"], runs["tcfg"]
    its = (RUN_KW["iters_first_timestep"], RUN_KW["iters_per_timestep"])
    for t in range(2):
        assert set(tout[t]) == set(jout[t])
        for key in tout[t]:
            lr = tcfg.lrs.get(key, 0.0) * (
                runs["radius"] if key == "means3D" else 1.0)
            # 2 lr per step, doubled by the extrapolation into t = 1
            bound = 2 * lr * its[0] * (1 if t == 0 else 2) + (
                2 * lr * its[1] if t else 0.0)
            np.testing.assert_allclose(tout[t][key], np.asarray(jout[t][key]),
                                       atol=bound + 1e-6, rtol=0,
                                       err_msg=f"t{t} {key}")


def test_window_drop_sums_match_jax_scan(world):
    """The reference's make_train_scan and the port's (the graph stand-in)
    over the same 4 steps at K = 4: the summed n_dropped_rect and
    n_dropped are the same counts, and are the sums of the steps'."""
    ds, tds, pt, w2c = world
    jcfg = jconf.TrainConfig(raster=jconf.RasterSettings(
        **dict(RS, method="pallas", max_tiles_per_gaussian=4)))
    jp, jv = JG.init_params(pt, w2c, capacity=512)
    lrs = {key: jnp.float32(1e-3) for key in jp}
    jscan = jtr.make_train_scan(jcfg, jtr.raster_config(jcfg))
    *_, jm = jscan(jp, jopt.init(jp), jv, jtr.stack_timestep_data(ds[0]),
                   jnp.asarray(SEL, jnp.int32), lrs, True)
    state, frames, cfg, tlrs = _start(world, True, 4)
    cfg = dataclasses.replace(cfg, raster=dataclasses.replace(
        cfg.raster, method="pallas"))
    scan = ttr.make_train_scan(cfg, ttr.raster_config(cfg),
                               graph_factory=Deferred)
    *_, tm = scan(*state, ttr.stack_timestep_data(frames), torch.tensor(SEL),
                  tlrs, True)
    assert int(tm["n_dropped_rect"]) == int(jm["n_dropped_rect"]) > 0
    assert int(tm["n_dropped"]) == int(jm["n_dropped"])
    assert int(tm["n_dropped_rect"]) == int(
        scan.window.last_steps["n_dropped_rect"].sum())


# ------------------------------------- host actions, step for step

class _Ckpt:
    def __init__(self, log):
        self.log = log

    def save(self, step, params, opt_state, variables, cursor, wait=False):
        self.log.append(("ckpt", step, cursor["t"], cursor["i"]))

    def load(self, *a, **kw):
        return None

    def close(self):
        pass


def _loop_only(mod, log, monkeypatch, densify_with_growth):
    """Replace a trainer module's device math with stand-ins that log:
    a step records its camera and reports one rect drop while K < 16 (so
    the K escalation runs twice), a window runs the stand-in step per
    camera row and sums the drops; densify, opacity reset, checkpoints
    and the timestep transitions only log."""
    def make_step(cfg, rcfg):
        k = rcfg.max_tiles_per_gaussian

        def step(params, opt_state, variables, batch, lrs, is_initial):
            log.append(("cam", int(batch["cam_id"])))
            drop = 1 if k < 16 else 0
            return params, opt_state, variables, {
                "loss": 0.0, "n_dropped": drop, "n_dropped_rect": drop}
        return step

    def make_scan(cfg, rcfg, train_step=None, window=None):
        step = make_step(cfg, rcfg)

        def scan(params, opt_state, variables, data_stack, cam_sel, lrs,
                 is_initial):
            total = 0
            ids = np.asarray(data_stack["cam_id"])
            for c in np.asarray(cam_sel).reshape(-1):
                m = step(params, opt_state, variables,
                         {"cam_id": ids[int(c)]}, lrs, is_initial)[3]
                total += m["n_dropped_rect"]
            return params, opt_state, variables, {
                "loss": 0.0, "n_dropped": total, "n_dropped_rect": total}
        scan.window = None
        return scan

    monkeypatch.setattr(mod, "make_train_step", make_step)
    monkeypatch.setattr(mod, "make_train_scan", make_scan)
    monkeypatch.setattr(mod, "densify_with_growth", densify_with_growth)
    monkeypatch.setattr(mod.densify_mod, "reset_opacity", lambda p, o: (
        log.append(("reset",)), (p, o))[1])
    monkeypatch.setattr(mod, "initialize_per_timestep",
                        lambda p, v, o: (p, v, o))
    monkeypatch.setattr(mod, "initialize_post_first_timestep",
                        lambda p, v, cfg, o=None, **kw: (p, v, o))
    monkeypatch.setattr(mod.G, "compact_with_optimizer",
                        lambda p, v, o: (p, v, o, None))


SCHEDULE_KW = dict(num_timesteps=2, iters_first_timestep=30,
                   iters_per_timestep=13, densify_start=5, densify_every=7,
                   densify_end=20, opacity_reset_every=12, report_every=6,
                   capacity=512, seed=3)


@pytest.mark.parametrize("steps_per_call", [1, 4, 5])
def test_host_actions_on_jax_steps(world, steps_per_call, monkeypatch,
                                   tmp_path):
    """Densify, opacity reset, reports (with the window's summed drops),
    checkpoints, K escalation and the camera stream of the port's loop are
    the reference's, step for step, at steps_per_call 1, 4 and 5."""
    ds, tds, pt, w2c = world
    logs = {}
    for name, mod, data, conf in (("jax", jtr, ds, jconf),
                                  ("torch", ttr, tds, tconf)):
        log = logs[name] = []

        def densify(*a, _log=log, _at=1 if name == "jax" else 0):
            params, variables, opt_state, i = a[_at:_at + 4]
            _log.append(("densify", int(i)))
            return params, variables, opt_state, None
        _loop_only(mod, log, monkeypatch, densify)
        if name == "jax":
            monkeypatch.setattr(jckpt, "CheckpointManager",
                                lambda d, _log=log: _Ckpt(_log))
        else:
            monkeypatch.setattr(ttr, "CheckpointManager",
                                lambda d, _log=log: _Ckpt(_log))
        cfg = conf.TrainConfig(
            steps_per_call=steps_per_call,
            raster=conf.RasterSettings(**dict(RS, max_tiles_per_gaussian=4)),
            **SCHEDULE_KW)
        cbs = {"on_step": lambda t, i, m, _log=log: _log.append(
                   ("report", t, i, int(m["n_dropped_rect"]))),
               "on_grow_tiles": lambda t, i, k, _log=log: _log.append(
                   ("grow", t, i, k))}
        kw = {} if name == "jax" else {"device": "cpu"}
        mod.train(data, cfg, pt, w2c, callbacks=cbs,
                  checkpoint_dir=str(tmp_path / name), checkpoint_every=9,
                  **kw)
        monkeypatch.undo()
    assert logs["torch"] == logs["jax"]
    kinds = [e[0] for e in logs["jax"]]
    assert kinds.count("cam") == 30 + 13
    for kind in ("densify", "reset", "report", "ckpt", "grow"):
        assert kind in kinds, kind


@pytest.mark.parametrize("n_live", [0, 1, 960, 1_182_541, 51_249_152])
def test_pair_capacity_rule(n_live):
    """The capacity holds the live pairs with HEADROOM, rounded up by less
    than an eighth of itself (or 1,024), never past K * N."""
    n_slots = 64 * 800_768
    cap = step_graph.pair_capacity(n_live, n_slots)
    want = n_live * step_graph.HEADROOM
    assert cap <= n_slots and cap >= min(want, n_slots) and cap >= 1
    assert cap < want + max(want / 8, 1024) + 1
