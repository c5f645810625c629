"""Shared pieces of the benchmark's tests: a tiny size of each cell that
runs on the CPU in seconds, and the CUDA graph's stand-in."""

import pytest
import torch

from portbench import harness, manifest

TINY = dict(n_gaussians=1500, capacity=6144, width=96, height=64,
            num_cams=5, focal=80.0)
TINY_FEATURES = dict(semantic_dim=32, feature_hw=[48, 80])
TINY_WINDOW = dict(steps_per_call=5)


class Deferred:
    """The CUDA graph's stand-in: capture keeps the step, each replay runs
    it on the static buffers, as a replay of the captured kernels does."""

    def capture(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def tiny_run(workload, seed=20240611, trace=False, cfg_extra=None):
    """One run of `workload` at the tiny size on the CPU, the harness's
    look for a card skipped; `cfg_extra` adds to its configuration."""
    torch.set_num_threads(4)
    cfg = dict(TINY, **(TINY_FEATURES if workload.startswith("feat32")
                        else {}), **(cfg_extra or {}))
    traffic = TINY_WINDOW if workload.endswith("window") else None
    return harness.run_cell(workload, seed, 0.2, trace, device="cpu",
                            graph_factory=Deferred, cfg_override=cfg,
                            traffic_override=traffic)


@pytest.fixture
def gpu():
    """Skips the test where there is no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# The eager cell that `portbench/` is ready for but `BENCHMARK.json` leaves
# out (its host-paced step swings with the host's speed; PERF.md section
# 7): its traffic file, readers and limits are in place.
EAGER = {
    "workloads": [{"name": "sports_t1_eager", "config": "panoptic_sports",
                   "traffic": "t1_eager", "chips": 1, "why": "eager"}],
    "end_to_end": [{"name": "eager_step_ms", "unit": "ms", "better": "lower",
                    "bound": 0.25, "source": "host_clock",
                    "workloads": ["sports_t1_eager"]}],
    "per_layer": [{"name": n, "unit": u, "better": "lower",
                   "source": "device_trace", "layer": "eager dispatch",
                   "moves": "eager_step_ms",
                   "workloads": ["sports_t1_eager"]}
                  for n, u in (("host_launches.eager", "launches/step"),
                               ("host_syncs.eager", "syncs/step"),
                               ("device_idle.eager", "%"))]}


@pytest.fixture
def eager_cell(monkeypatch):
    """BENCHMARK.json with the prepared eager cell added."""
    load = manifest.load_benchmark

    def with_eager(base=None):
        bench = load(base)
        for key, extra in EAGER.items():
            bench[key] = bench[key] + extra
        return bench
    monkeypatch.setattr(manifest, "load_benchmark", with_eager)
