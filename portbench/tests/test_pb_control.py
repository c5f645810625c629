"""The control comes out not correct: the reference in TF32 (the
precision below the configurations' float32), put in the program's place,
fails one of each cell's limits. On the card, at each cell's own size."""

import pytest

from portbench import calibrate, check, manifest

CELLS = [w["name"] for w in manifest.load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(gpu, workload):
    limits = manifest.limits(workload)["limits"]
    (rec,) = calibrate.readings(workload, 4242, ["control"], device=gpu)
    correct, shown = check.judge(rec["numbers"], limits)
    assert not correct, shown


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_planted_faults_are_not_correct(gpu, fault):
    limits = manifest.limits("sports_t1_window")["limits"]
    (rec,) = calibrate.readings("sports_t1_window", 4243, [fault],
                                device=gpu)
    correct, shown = check.judge(rec["numbers"], limits)
    assert not correct, shown
