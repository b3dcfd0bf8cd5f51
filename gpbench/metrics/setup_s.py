"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, weights, inputs, the warm prefills and the decode
step's capture."""
KIND, UNIT = "end_to_end", "s"


def read(run):
    return run.setup_s
