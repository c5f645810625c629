"""setup_s: from the process's start to the window's: imports, the seeded
inputs, the program's state (its kNN graph and reorder), the kernels'
build where they are not built yet, and the first steps (the eager step's
shapes and a window's capture)."""


def read(run):
    return run.setup_s
