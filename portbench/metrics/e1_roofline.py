"""e1_roofline: the pair emission E1 (`csrc/emit.cu`: count, scan, write)."""

from portbench import readers

PARTS = ("emit_count_kernel", "emit_scan_kernel", "emit_write_kernel")
MAIN = "emit_write_kernel"


def read(run):
    return readers.roofline(run, PARTS, MAIN, "e1")
