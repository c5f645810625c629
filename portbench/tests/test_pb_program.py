"""A configuration names the program that drives it (`programs/<program>.py`,
found by `manifest.program`): the default named explicitly changes nothing,
a program written as a new file runs end to end with no file of the
harness edited, and an unknown name fails before any device work."""

import pytest

from portbench import counts, harness, manifest, readers
from portbench.tests.conftest import tiny_run

H100 = "NVIDIA H100 80GB HBM3"
KERNEL_S = 1e-3                 # the stand-in's device time of a kernel

# A program of two renders a step, written by the test as a later change
# would add one: x moves to the step's view target by gradient descent.
STANDIN = '''
import torch

from portbench import counts

LR = 0.1
REF_SCALE = @REF_SCALE@      # the reference's loss scale: 1.0 is sound
RENDER = @RENDER@
STEP = @STEP@


def make(cfg, seed, device):
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return dict(x=torch.rand(8, generator=gen, device=device),
                target=torch.rand((cfg["num_cams"], 8), generator=gen,
                                  device=device))


def _step(x, target, scale=1.0, fault=None):
    leaf = x.detach().requires_grad_(True)
    rows = slice(0, 4) if fault == "half_batch" else slice(None)
    loss = scale * ((leaf - target) ** 2)[rows].mean()
    (g,) = torch.autograd.grad(loss, [leaf])
    return float(loss.detach()), g, x if fault == "unchanged" else x - LR * g


class ProgramRun:
    def __init__(self, inputs, cfg, traffic, seed, device,
                 graph_factory=None):
        self.x, self.target = inputs["x"].clone(), inputs["target"]
        self.n_cams = cfg["num_cams"]
        self.scan, self.timings, self.reports, self.i = None, {}, [], 0

    def call(self):
        cam = self.i % self.n_cams
        loss, _, self.x = _step(self.x, self.target[cam])
        self.i += 1
        self.reports.append(dict(loss=loss))
        return dict(steps=1, metrics=dict(loss=torch.tensor(loss)),
                    cams=[cam])

    def first_steps(self, n):
        start, grad = self.x.clone(), None
        cams = first_cams(dict(num_cams=self.n_cams),
                          dict(check_min_steps=n), 0)
        losses = []
        for cam in cams:
            if grad is None:
                _, grad, _ = _step(self.x, self.target[cam])
            losses.append(float(self.call()["metrics"]["loss"]))
        return dict(losses=losses, grad_norms=dict(x=float(grad.norm())),
                    change_norms=dict(x=float((self.x - start).norm())),
                    cams=cams)

    def window_stats(self):
        return None

    def free(self):
        self.x = None


def first_cams(cfg, traffic, seed):
    return [i % cfg["num_cams"] for i in range(traffic["check_min_steps"])]


def follow(inputs, cfg, cams, fault=None):
    x, losses, grad = inputs["x"].clone(), [], None
    for cam in cams:
        loss, g, x_next = _step(x, inputs["target"][cam], REF_SCALE, fault)
        grad = g if grad is None else grad
        losses.append(loss)
        x = x_next
    return dict(losses=losses, grad_norms=dict(x=float(grad.norm())),
                change_norms=dict(x=float((x - inputs["x"]).norm())))


def walk_stats(inputs, cfg, cams):
    return [dict(renders=[dict(RENDER), dict(RENDER)], step=dict(STEP))
            for _ in cams]


def step_counts(walk, cfg):
    # K1, K2 and E1 run once a render, P1 and the update once a step
    n_chan = 6 + cfg["semantic_dim"]
    rs, st = walk["renders"], walk["step"]
    return dict(
        k1=counts.add(*(counts.k1(r["read_pairs"], r["tiles"], n_chan)
                        for r in rs)),
        k2=counts.add(*(counts.k2(r["read_pairs"], r["tiles"], n_chan)
                        for r in rs)),
        e1=counts.add(*(counts.e1(cfg["capacity"], r["live_pairs"])
                        for r in rs)),
        p1=counts.p1(st["fg_rows"], st["edges"]),
        step=counts.add(*(counts.render(r, cfg) for r in rs),
                        counts.update(st, cfg)))
'''
RENDER = dict(read_pairs=3000, live_pairs=3500, tiles=24, rows=1500)
STEP = dict(rows=1500, fg_rows=700, edges=14000, param_floats=21000)


def _comparable(result):
    """The result line without what the host's clock sets: the steps the
    window reached and the end-to-end metrics' values."""
    out = {k: v for k, v in result.items() if k != "attempted"}
    out["metrics"] = {k: v["unit"] for k, v in result["metrics"].items()}
    return out


def test_the_default_program_named_explicitly_changes_nothing():
    plain, plain_lines = tiny_run("sports_t1_window", seed=31)
    named, named_lines = tiny_run(
        "sports_t1_window", seed=31,
        cfg_extra={"program": manifest.DEFAULT_PROGRAM})
    assert plain["correct"] is True
    assert _comparable(named) == _comparable(plain)
    # the program's first steps, the reference's and the three numbers
    assert named_lines[1:] == plain_lines[1:]
    assert named_lines[1].startswith("portbench: program ")
    assert named_lines[2].startswith("portbench: reference ")


@pytest.fixture
def standin(monkeypatch, tmp_path):
    """Writes the stand-in program under tmp_path, points the manifest's
    search there, and gives the readers the card's peaks and KERNEL_S of
    device time per kernel a step. Returns (writer, the runs made)."""
    monkeypatch.setattr(manifest, "PROGRAMS", str(tmp_path))
    monkeypatch.setattr(readers, "card_peaks",
                        lambda run: counts.peaks(H100))
    monkeypatch.setattr(harness.Run, "kernel_time",
                        lambda self, parts, main: KERNEL_S)
    runs = []

    class Kept(harness.Run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)
    monkeypatch.setattr(harness, "Run", Kept)

    def write(ref_scale):
        (tmp_path / "standin.py").write_text(
            STANDIN.replace("@REF_SCALE@", repr(ref_scale)).replace(
                "@RENDER@", repr(RENDER)).replace("@STEP@", repr(STEP)))
    return write, runs


@pytest.mark.parametrize("ref_scale,correct", [(1.0, True), (1.01, False)])
def test_a_new_program_runs_through_the_harness(standin, ref_scale,
                                                correct):
    write, runs = standin
    write(ref_scale)
    result, lines = tiny_run("sports_t1_window", trace=True,
                             cfg_extra={"program": "standin"})
    assert result["correct"] is correct
    assert result["failed"] == 0 and result["attempted"] >= 100
    (run,) = runs
    assert run.program_module.__name__ == "portbench_program_standin"
    peak = counts.peaks(H100)
    cfg = run.cfg
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    # the kernels of a render counted for both renders, P1 once a step
    n_chan = 6 + cfg["semantic_dim"]
    for name, times, count in (
            ("k1_roofline", 2, counts.k1(RENDER["read_pairs"],
                                         RENDER["tiles"], n_chan)),
            ("k2_roofline", 2, counts.k2(RENDER["read_pairs"],
                                         RENDER["tiles"], n_chan)),
            ("e1_roofline", 2, counts.e1(cfg["capacity"],
                                         RENDER["live_pairs"])),
            ("p1_roofline", 1, counts.p1(STEP["fg_rows"], STEP["edges"]))):
        one = 100.0 * counts.least_seconds(count, peak) / KERNEL_S
        assert metrics[name] == pytest.approx(times * one, rel=1e-12)
    # the step: both renders and the update once
    render, update = counts.render(RENDER, cfg), counts.update(STEP, cfg)
    step = {k: 2 * render[k] + update[k] for k in render}
    assert metrics["step_mfu"] == pytest.approx(
        100.0 * counts.least_seconds(step, peak) / run.untraced_step_s,
        rel=1e-12)
    double = {k: 2 * (render[k] + update[k]) for k in render}
    assert counts.least_seconds(step, peak) < counts.least_seconds(
        double, peak)
    # the stand-in runs no window and has no marks to read
    assert "window_redo_share" not in metrics
    assert "render_ms" not in metrics


def test_an_unknown_program_fails_before_any_device_work():
    with pytest.raises(FileNotFoundError,
                       match="programs/no_such_program.py"):
        manifest.program({"name": "x", "program": "no_such_program"})
    # a device that cannot be named: the manifest's error comes first
    with pytest.raises(FileNotFoundError, match="no_such_program"):
        harness.run_cell("sports_t1_window", 1, 0.1, False,
                         device="no-such-device",
                         cfg_override={"program": "no_such_program"})
