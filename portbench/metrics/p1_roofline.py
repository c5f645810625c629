"""p1_roofline: the physics losses' edge terms P1 (`csrc/physics.cu`: two
forward and two backward passes), against the edge part of the step's
physics count (`counts.EDGE_BYTES` a foreground edge and
`counts.FG_ROW_BYTES` a foreground row, `counts.EDGE_OPS` an edge) from
the reference's walk, so that any implementation is held to the same
work. Nothing where the program has no such kernel."""

from portbench import counts, readers

PARTS = ("p1_fwd_partial", "p1_fwd_final", "p1_bwd_edges", "p1_bwd_rows")
MAIN = "p1_bwd_rows"


def p1(fg_rows: int, edges: int):
    return dict(bytes=edges * counts.EDGE_BYTES
                + fg_rows * counts.FG_ROW_BYTES,
                flops=edges * counts.EDGE_OPS)


def read(run):
    return readers.roofline(run, PARTS, MAIN,
                            lambda w, cfg: p1(w["fg_rows"], w["edges"]))
