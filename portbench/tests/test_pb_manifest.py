"""The manifest and the files the harness finds by name."""

import json
import os
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
BENCH = manifest.load_benchmark()


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    path = os.path.join(manifest.root(), "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_one_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert _one_line(entry["source"]) and _one_line(entry["why"])
    assert entry["file"].startswith("portbench/")
    cfg = manifest.config(entry["name"])
    assert cfg["name"] == entry["name"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and key in cfg["reduced"] and key in cfg
    with open(os.path.join(manifest.root(), entry["file"])) as fh:
        assert json.load(fh) == cfg


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_finds_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and _one_line(cell["why"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = manifest.traffic(cell["traffic"])
    assert traffic["name"] == cell["traffic"]
    limits = manifest.limits(cell["name"])["limits"]
    assert set(limits) == {"loss_gap", "grad_gap", "change_gap"}
    e2e = manifest.metrics_of(BENCH, cell["name"], False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert manifest.metrics_of(BENCH, cell["name"], True)


def test_pairs_and_names_are_unique():
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry_and_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    kind = "metrics" if "layer" in metric else "e2e"
    if kind == "e2e":
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
    else:
        assert metric["source"] in SOURCES and _one_line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        for w in metric["workloads"]:
            assert metric["moves"] in {
                m["name"] for m in manifest.metrics_of(BENCH, w, False)}
    assert callable(manifest.reader(kind, metric["name"]).read)


def test_a_metric_without_workloads_follows_its_moves():
    bench = dict(BENCH, per_layer=[{"name": "x", "moves": "train_step_ms"}])
    assert manifest.metrics_of(bench, "sports_t1_window", True)
    bench = dict(bench, end_to_end=[
        dict(m, workloads=["feat32_t1_window"]) if m["name"] ==
        "train_step_ms" else m for m in BENCH["end_to_end"]])
    assert not manifest.metrics_of(bench, "sports_t1_window", True)


def test_the_prepared_eager_cell_finds_its_files(eager_cell):
    bench = manifest.load_benchmark()
    cell = manifest.cell(bench, "sports_t1_eager")
    assert manifest.traffic(cell["traffic"])["steps_per_call"] == 1
    assert set(manifest.limits("sports_t1_eager")["limits"]) == {
        "loss_gap", "grad_gap", "change_gap"}
    for kind, trace in (("e2e", False), ("metrics", True)):
        for m in manifest.metrics_of(bench, "sports_t1_eager", trace):
            assert callable(manifest.reader(kind, m["name"]).read)
