"""The reduction of the program's phase marks and host spans
(`portbench/spans.py::reduce`) on synthetic profiler events: phases from
marks, busy and idle per phase, the two identities, gap labels by the
innermost span, and None where the marks are not whole."""

import pytest

from portbench import spans

LEN = dict(render=100, image_loss=40, physics=200, physics_bwd=300,
           image_loss_bwd=60, render_bwd=150, update=50)
IDLE = dict(render=10, image_loss=0, physics=5, physics_bwd=20,
            image_loss_bwd=0, render_bwd=8, update=7)
EDGE_IN = 35          # the copy-in before a window's first step
EDGE_IN_IDLE = 10
EDGE_OUT = 40         # the read and the clones after its last step
EDGE_OUT_IDLE = 12
BENCH = ("window_call",)


def mark_name(phase):
    return f"void d3g_mark<d3g_phase::{phase}>()"


def build(n_windows=2, n_steps=3):
    """(device ops, host spans, stretch) of n_windows windows of n_steps
    replayed steps: each phase a mark, one op, then IDLE[phase] idle; the
    last step's update ends at its op, then the read and the clones."""
    ops, host, t = [], [], 0.0
    for _ in range(n_windows):
        w_start = t
        host.append((t, t + EDGE_IN, "window.load"))
        ops.append((t, t + 10, "Memcpy HtoD (Pageable -> Device)"))
        ops.append((t + 20, t + EDGE_IN, "Memcpy DtoD (Device -> Device)"))
        t += EDGE_IN
        for k in range(n_steps):
            last = k == n_steps - 1
            for p in spans.PHASES:
                ops.append((t, t + 1, mark_name(p)))
                busy_end = t + LEN[p] - IDLE[p]
                ops.append((t + 1, busy_end, f"kernel_{p}"))
                t = busy_end if (last and p == "update") else t + LEN[p]
        # the update's idle, then the read, idle, the clones
        t += IDLE["update"]
        host.append((t - 3, t + 20, "window.read"))
        ops.append((t, t + 8, "Memcpy DtoH (Device -> Pageable)"))
        t += 8 + EDGE_OUT_IDLE - IDLE["update"]
        ops.append((t, t + EDGE_OUT - 8 - (EDGE_OUT_IDLE - IDLE["update"]),
                    "Memcpy DtoD (Device -> Device)"))
        t = ops[-1][1]
        host.append((w_start, t, "window_call"))
    return ops, host, (0.0, t)


def test_phases_from_marks():
    ops, host, window = build()
    out = spans.reduce(ops, host, window, 6, 2, BENCH)
    m = out["metrics"]
    assert m["render_ms"] == pytest.approx(
        (LEN["render"] + LEN["render_bwd"]) * 1e-3)
    assert m["image_loss_ms"] == pytest.approx(
        (LEN["image_loss"] + LEN["image_loss_bwd"]) * 1e-3)
    assert m["physics_step_ms"] == pytest.approx(
        (LEN["physics"] + LEN["physics_bwd"]) * 1e-3)
    # the last step of each window ends at its update's last op
    assert m["update_ms"] == pytest.approx(
        (LEN["update"] - IDLE["update"] / 3) * 1e-3)
    assert set(m) == set(spans.METRICS) | {"graph_idle_ms",
                                           "window_gap_ms"}


def test_busy_and_idle_per_phase():
    ops, host, window = build()
    line = spans.reduce(ops, host, window, 6, 2, BENCH)["line"]
    for p in spans.PHASES:
        idle = IDLE[p] * (2 / 3 if p == "update" else 1)
        length = LEN[p] - (IDLE[p] / 3 if p == "update" else 0)
        assert line["phases"][p]["idle_ms"] == pytest.approx(idle * 1e-3)
        assert line["phases"][p]["busy_ms"] == pytest.approx(
            (length - idle) * 1e-3)
        # the phase's own op leads its list; the marks are left out
        top = line["top_ops"][p]
        assert top[0][0] == f"kernel_{p}" and len(top) == 1


def test_the_two_identities():
    ops, host, window = build(n_windows=3, n_steps=4)
    out = spans.reduce(ops, host, window, 12, 3, BENCH)
    m, line = out["metrics"], out["line"]
    assert sum(m[k] for k in spans.METRICS) == pytest.approx(line["step_ms"])
    assert line["step_ms"] == pytest.approx(
        (sum(LEN.values()) - IDLE["update"] / 4) * 1e-3)
    stretch_ms = (window[1] - window[0]) * 1e-3
    total_idle = line["idle_share"] / 100 * stretch_ms
    assert m["graph_idle_ms"] * 12 + m["window_gap_ms"] * 3 == \
        pytest.approx(total_idle)
    assert m["window_gap_ms"] == pytest.approx(
        (EDGE_IN_IDLE + EDGE_OUT_IDLE) * 1e-3)
    assert m["graph_idle_ms"] == pytest.approx(
        (sum(IDLE.values()) - IDLE["update"] / 4) * 1e-3)


def test_gap_labels_by_innermost_span():
    ops, host, window = build(n_windows=1, n_steps=1)
    gaps = spans.reduce(ops, host, window, 1, 1, BENCH)["line"]["gaps"]
    got = {(label, where, round(ms * 1e3, 6)) for label, where, ms in gaps}
    # in a step: no host span overlaps it, so the benchmark's window_call
    assert ("window_call", "physics_bwd", IDLE["physics_bwd"]) in got
    # at the edge: a program span that overlaps it, before the benchmark's
    assert ("window.read", "edge", IDLE["update"]) in got
    assert ("window.load", "edge", EDGE_IN_IDLE) in got
    assert [g[2] for g in gaps] == sorted((g[2] for g in gaps), reverse=True)
    # of two program spans overlapping a gap alike, the shorter; none at
    # all: no_span
    gap = (100.0, 110.0)
    assert spans._label(gap, [(90, 120, "window.replay"),
                              (100, 110, "render")],
                        spans.PROGRAM_SPANS) == "render"
    assert spans._label(gap, [(0, 50, "window.read")],
                        spans.PROGRAM_SPANS) is None


@pytest.mark.parametrize("fault", ["missing", "swapped", "steps", "windows"])
def test_none_where_marks_are_not_whole(fault):
    ops, host, window = build()
    n_steps, n_windows = 6, 2
    marks = [i for i, (_, _, n) in enumerate(ops) if "d3g_mark" in n]
    if fault == "missing":
        del ops[marks[9]]
    elif fault == "swapped":
        a, b = marks[3], marks[4]
        ops[a], ops[b] = ((ops[a][0], ops[a][1], ops[b][2]),
                          (ops[b][0], ops[b][1], ops[a][2]))
    elif fault == "steps":
        n_steps = 5
    else:
        n_windows = 3
    assert spans.reduce(ops, host, window, n_steps, n_windows, BENCH) is None


def test_device_ops_past_the_hosts_end_stay_in_the_stretch():
    # the device's clock may read past the host's end of the stretch: the
    # last step's update mark and the window's read lie after it
    ops, host, window = build()
    whole = spans.reduce(ops, host, window, 6, 2, BENCH)
    last_update = max(s for s, _, n in ops if n == mark_name("update"))
    cut = (window[0], last_update - 1)
    assert spans.reduce(ops, host, cut, 6, 2, BENCH) == whole
