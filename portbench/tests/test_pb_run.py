"""A whole run of each cell at a tiny size on the CPU: the result line,
and `correct` false where the program's step is broken underneath."""

import json
import math

import pytest

from dynamic3dgaussians_tpu_torch.train import losses as L
from dynamic3dgaussians_tpu_torch.train import trainer as T
from portbench import manifest
from portbench.tests.conftest import tiny_run

CELLS = [w["name"] for w in manifest.load_benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS + ["sports_t1_eager"])
def test_sound_run_is_correct_and_its_line_is_whole(eager_cell, workload):
    result, lines = tiny_run(workload)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "check"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    bench = manifest.load_benchmark()
    want = {m["name"] for m in manifest.metrics_of(bench, workload, False)}
    assert set(result["metrics"]) == want
    for m in result["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    names = list(result["check"])
    assert names == ["loss_gap", "grad_gap", "change_gap"]
    for name, ln in zip(names, lines[-3:]):
        assert ln.startswith(f"{name} ") and " limit " in ln
    json.loads(json.dumps(result))


def test_traced_run_reads_its_layers():
    result, _ = tiny_run("sports_t1_window", trace=True)
    assert result["correct"] is True
    # no device here: the readers of the trace's device time are silent,
    # the counter is not
    assert set(result["metrics"]) == {"window_redo_share"}
    assert result["device"]["window_s"] > 0
    assert "device_ops" in result["breakdown"]


def _unchanged(make):
    def make_broken(cfg, rcfg):
        step = make(cfg, rcfg)

        def broken(params, opt_state, variables, batch, lrs, is_initial,
                   **kw):
            _, _, new_vars, metrics = step(params, opt_state, variables,
                                           batch, lrs, is_initial, **kw)
            return params, opt_state, new_vars, metrics
        return broken
    return make_broken


def _half_rows(loss):
    def half(pred, gt, *a, **kw):
        h = pred.shape[0] // 2
        return loss(pred[:h], gt[:h], *a, **kw)
    return half


@pytest.mark.parametrize("workload", ["sports_t1_window", "sports_t1_eager"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(monkeypatch, eager_cell, workload,
                                      fault):
    if fault == "unchanged":
        monkeypatch.setattr(T, "make_train_step",
                            _unchanged(T.make_train_step))
    else:
        monkeypatch.setattr(L, "image_loss", _half_rows(L.image_loss))
    result, lines = tiny_run(workload)
    assert result["correct"] is False, lines[-3:]
