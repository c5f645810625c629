"""panoptic_dynamic: the port's Panoptic dynamic trainer at t > 0
(`train/trainer.py`), eager or in CUDA-graph windows, against the plain
training step of `reference/train.py`.

A configuration with no "program" key runs this program. Its inputs are
`scene.make`'s, its driver is `loop.ProgramRun`, its reference
`reference/train.py::follow`. A step renders one camera, so K1, K2 and E1
run once a step, as P1 does.
"""

from typing import Dict, List

from portbench import counts, scene
from portbench.loop import ProgramRun, Schedule
from portbench.reference import train as ref_train

__all__ = ["make", "ProgramRun", "first_cams", "follow", "walk_stats",
           "step_counts"]

make = scene.make
follow = ref_train.follow


def first_cams(cfg: Dict, traffic: Dict, seed: int) -> List[int]:
    """The cameras of the calls that `ProgramRun.first_steps` runs."""
    return Schedule(traffic, cfg["num_cams"], cfg["iters_per_timestep"],
                    seed).first_cams(traffic["check_min_steps"])


def walk_stats(inputs: Dict, cfg: Dict, cams: List[int]) -> List[Dict]:
    """Per step, its one render's walk at the seeded start (the reference's:
    read and live pairs, tiles, live and foreground rows, edges, parameter
    floats)."""
    return ref_train.walk_stats(inputs, cfg, cams)


def step_counts(walk: Dict, cfg: Dict) -> Dict[str, Dict[str, float]]:
    """The step's counts: each kernel's over its one launch a step, and the
    whole step's."""
    n_chan = 6 + cfg["semantic_dim"]
    return dict(k1=counts.k1(walk["read_pairs"], walk["tiles"], n_chan),
                k2=counts.k2(walk["read_pairs"], walk["tiles"], n_chan),
                e1=counts.e1(cfg["capacity"], walk["live_pairs"]),
                p1=counts.p1(walk["fg_rows"], walk["edges"]),
                step=counts.step(walk, cfg))
