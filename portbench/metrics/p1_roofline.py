"""p1_roofline: the physics losses' edge terms P1 (`csrc/physics.cu`: two
forward and two backward passes), against `counts.p1` of the step's
foreground rows and edges (from the reference's walk), so that any
implementation is held to the same work. Nothing where the program has no
such kernel."""

from portbench import readers

PARTS = ("p1_fwd_partial", "p1_fwd_final", "p1_bwd_edges", "p1_bwd_rows")
MAIN = "p1_bwd_rows"


def read(run):
    return readers.roofline(run, PARTS, MAIN, "p1")
