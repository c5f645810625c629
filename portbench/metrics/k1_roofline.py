"""k1_roofline: the forward tile kernel K1 (`csrc/raster_fwd.cu`)."""

from portbench import readers

PARTS = ("raster_fwd_kernel",)
MAIN = "raster_fwd_kernel"


def read(run):
    return readers.roofline(run, PARTS, MAIN, "k1")
