"""k2_roofline: the backward tile kernel K2 (`csrc/raster_bwd.cu`: its tile
order pass and the kernel)."""

from portbench import readers

PARTS = ("raster_bwd_kernel", "tile_order_kernel")
MAIN = "raster_bwd_kernel"


def read(run):
    return readers.roofline(run, PARTS, MAIN, "k2")
