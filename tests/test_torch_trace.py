"""The port's tracing (`utils/logging.py`: `set_tracing`, `span`, `mark`,
`Phases`) in the train step and in `StepWindow`, on the CPU at a tiny size.

A t = 1 state of a 140-gaussian scene (64x48, 3 cameras; the physics
losses on) runs eager steps and windows of 4 steps through
`train/step_graph.py::StepWindow` with a stand-in for the CUDA graph
(`Deferred`: capture keeps the step, each replay runs it). On the CPU a
mark is a zero-length host range `mark.<phase>`, so a CPU profile shows the
order of the marks; on the card it is the phase's marker kernel, which the
`gpu` case reads from a profiled CUDA-graph replay. Tracing must change no
number: states and losses are held bitwise, with tracing on against off
and a traced window against its eager steps.
"""

import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
from dynamic3dgaussians_tpu_torch.models import gaussians as TG
from dynamic3dgaussians_tpu_torch.train import config as tconf
from dynamic3dgaussians_tpu_torch.train import optim as topt
from dynamic3dgaussians_tpu_torch.train import trainer as ttr
from dynamic3dgaussians_tpu_torch.utils import logging as LG

RS = dict(chunk=64, max_per_tile=512, max_tiles_per_gaussian=64,
          pairs_per_gaussian=16)
W, H, F = 64, 48, 55.0
SEL = [0, 2, 1, 0]
WINDOW_SPANS = ("window.load", "window.eager", "window.capture",
                "window.replay", "window.read", "window.result")
MARK_KERNEL = re.compile(r"d3g_mark<d3g_phase::(\w+)>")


class Deferred:
    """The CUDA graph's stand-in: capture keeps the step, each replay runs
    it on the static buffers, as a replay of the captured kernels does."""

    def capture(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def make_world(device):
    """(start state, the t = 1 frames, their stack, cfg, lrs) on `device`."""
    scene = tsyn.make_gt_scene(n_fg=50, n_bg=90, seed=3)
    tds, w2c, _ = tsyn.make_dataset(scene, num_t=2, num_cams=3, w=W, h=H,
                                    f=F, device=device)
    pt = tsyn.init_point_cloud(scene, noise=0.05)
    cfg = tconf.TrainConfig(raster=tconf.RasterSettings(**RS),
                            num_timesteps=2, capacity=512, num_knn=8)
    params, variables = TG.init_params(pt, w2c, capacity=512, device=device)
    opt = topt.init(params)
    params, variables, opt, _ = TG.compact_with_optimizer(params, variables,
                                                          opt)
    params, variables, opt = ttr.initialize_post_first_timestep(
        params, variables, cfg, opt)
    params, variables, opt = ttr.initialize_per_timestep(params, variables,
                                                         opt)
    state = (params, opt, variables)
    lrs = {key: torch.tensor(1e-3, device=device) for key in params}
    return (state, tds[1], ttr.stack_timestep_data(tds[1]), cfg, lrs)


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    return make_world("cpu")


@pytest.fixture
def tracing_on():
    LG.set_tracing(True)
    yield
    LG.set_tracing(False)


def _scan(world, graph_factory=Deferred):
    _, _, _, cfg, lrs = world
    rcfg = ttr.raster_config(cfg)
    return ttr.make_train_scan(cfg, rcfg, ttr.make_train_step(cfg, rcfg),
                               graph_factory=graph_factory)


def _window(scan, world, state=None):
    start, _, stack, _, lrs = world
    return scan(*(state or start), stack, torch.tensor(SEL), lrs, False)


class Ranges(list):
    """Stands in for `torch.profiler.record_function` (which `span`,
    `mark` and `Phases` call): logs ("enter", name) and ("exit", name) in
    the order the host enters and leaves its ranges, without the profiler's
    cost per op."""

    def range(self, name):
        log = self

        class Range:
            def __enter__(self):
                log.append(("enter", name))
                return self

            def __exit__(self, *exc):
                log.append(("exit", name))
        return Range()

    def entered(self, keep=lambda n: True):
        return [n for what, n in self if what == "enter" and keep(n)]


@pytest.fixture
def ranges(monkeypatch):
    log = Ranges()
    monkeypatch.setattr(torch.profiler, "record_function", log.range)
    return log


def _marks(names):
    return [n[len("mark."):] for n in names if n.startswith("mark.")]


def _phase_ranges(names):
    return [n for n in names if n in LG.PHASES or n.startswith("mark.")]


MARKED = [x for p in LG.PHASES for x in (f"mark.{p}", p)]


def _assert_state_equal(a, b):
    (pa, oa, va), (pb, ob, vb) = a[:3], b[:3]
    for key in pa:
        assert torch.equal(pa[key], pb[key]), f"params.{key}"
    for m in ("mu", "nu"):
        for key in oa.mu:
            assert torch.equal(getattr(oa, m)[key], getattr(ob, m)[key]), \
                f"{m}.{key}"
    assert torch.equal(oa.step, ob.step)
    for key in va:
        if isinstance(va[key], torch.Tensor):
            assert torch.equal(va[key], vb[key]), f"vars.{key}"


def test_tracing_off_enters_no_span_mark_or_hook(world, ranges,
                                                 monkeypatch):
    """Off (the default): an eager step and a window enter no host range
    (no span, no mark) and register no autograd hook."""
    hooks = []
    register = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda t, fn: hooks.append(fn) or register(t, fn))
    assert not LG.tracing()
    start, frames, _, cfg, lrs = world
    ttr.make_train_step(cfg, ttr.raster_config(cfg))(*start, frames[0], lrs,
                                                     False)
    _window(_scan(world), world)
    assert ranges == [] and hooks == []
    assert LG.span("x") is LG.span("y")          # the shared no-op
    assert LG.phases("cpu") is LG.NO_PHASES


def test_an_eager_step_profiles_its_marks_in_order(world, tracing_on):
    """Tracing on, under the profiler: an eager step's trace holds the
    seven marks in order, each followed by its phase's host span."""
    start, frames, _, cfg, lrs = world
    step = ttr.make_train_step(cfg, ttr.raster_config(cfg))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(*start, frames[0], lrs, False)
    names = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)]
    assert _phase_ranges(names) == MARKED


@pytest.mark.parametrize("how", ["eager", "window"])
def test_each_step_marks_its_seven_phases_in_order(world, ranges,
                                                   tracing_on, how):
    """Tracing on: every step, eager or in a window (its eager first steps
    and its replays), gives the seven marks in order, each followed by its
    phase's host span."""
    start, frames, _, cfg, lrs = world
    if how == "eager":
        step = ttr.make_train_step(cfg, ttr.raster_config(cfg))
        p, o, v, _ = step(*start, frames[0], lrs, False)
        step(p, o, v, frames[1], lrs, False)
        n_steps = 2
    else:
        _window(_scan(world), world)
        n_steps = len(SEL)
    assert _marks(ranges.entered()) == list(LG.PHASES) * n_steps
    assert _phase_ranges(ranges.entered()) == MARKED * n_steps
    assert ranges.count(("exit", "update")) == n_steps   # every span ends


def test_window_spans_nest_inside_the_callers(world, ranges, tracing_on):
    """The first window's host spans (one copy-in, two eager steps, one
    capture, a replay per remaining step, one read, one result) open and
    close inside the caller's span, and each replay holds its step's
    marks."""
    with torch.profiler.record_function("caller"):
        _window(_scan(world), world)
    assert ranges[0] == ("enter", "caller")
    assert ranges[-1] == ("exit", "caller")
    spans = ranges.entered(lambda n: n.startswith("window."))
    assert spans == ["window.load", "window.eager", "window.eager",
                     "window.capture"] + ["window.replay"] * (len(SEL) - 2) \
        + ["window.read", "window.result"]
    assert ranges.count(("exit", "caller")) == 1
    for i, ev in enumerate(ranges):
        if ev == ("enter", "window.replay"):
            end = ranges.index(("exit", "window.replay"), i)
            assert _marks(Ranges(ranges[i:end]).entered()) == list(LG.PHASES)


def test_toggling_tracing_captures_again(world):
    """The switch is part of the graph's key: turning tracing on or off
    captures the step again at the next window, and only then."""
    scan = _scan(world)
    captures = []
    for on in (False, True, True, False):
        LG.set_tracing(on)
        try:
            _window(scan, world)
        finally:
            LG.set_tracing(False)
        captures.append(scan.window.stats["captures"])
    assert captures == [1, 2, 2, 3]


def test_tracing_changes_no_number(world):
    """Params, Adam state, variables and every step's loss of 3 windows in
    a row are bitwise equal with tracing on and off."""
    runs = []
    for on in (False, True):
        LG.set_tracing(on)
        try:
            scan, state, losses = _scan(world), None, []
            for _ in range(3):
                state = _window(scan, world, state)[:3]
                losses.append(scan.window.last_steps["loss"])
        finally:
            LG.set_tracing(False)
        runs.append((state, torch.cat(losses)))
    _assert_state_equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_traced_window_is_its_eager_steps(world, tracing_on):
    """With tracing on a window is still bitwise its eager steps."""
    start, frames, _, cfg, lrs = world
    step = ttr.make_train_step(cfg, ttr.raster_config(cfg))
    state, losses = start, []
    for c in SEL:
        *state, m = step(*state, frames[c], lrs, False)
        losses.append(m["loss"])
    scan = _scan(world)
    out = _window(scan, world)
    _assert_state_equal(tuple(state), out)
    assert torch.equal(scan.window.last_steps["loss"], torch.stack(losses))
    assert torch.equal(out[3]["loss"], losses[-1])


@pytest.mark.gpu
def test_replayed_window_marks_each_step_on_the_card():
    """On the card: a profiled window of replays shows the marker kernels,
    seven a step, in order, each named by its phase."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the marker kernel has no CPU "
                    "mode)")
    cuda_world = make_world(torch.device("cuda"))
    LG.set_tracing(True)
    try:
        scan = _scan(cuda_world, graph_factory=None)
        _window(scan, cuda_world)                  # captures the marks
        torch.cuda.synchronize()
        captures = scan.window.stats["captures"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _window(scan, cuda_world)
            torch.cuda.synchronize()
    finally:
        LG.set_tracing(False)
    assert scan.window.stats["captures"] == captures == 1
    marks = sorted((e.time_range.start, MARK_KERNEL.search(e.name).group(1))
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and MARK_KERNEL.search(e.name))
    assert [p for _, p in marks] == list(LG.PHASES) * len(SEL)
