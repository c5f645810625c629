"""k1_roofline: the forward tile kernel K1 (`csrc/raster_fwd.cu`)."""

from portbench import counts, readers

PARTS = ("raster_fwd_kernel",)
MAIN = "raster_fwd_kernel"


def read(run):
    return readers.roofline(run, PARTS, MAIN, lambda w, cfg: counts.k1(
        w["read_pairs"], w["tiles"], 6 + cfg["semantic_dim"]))
