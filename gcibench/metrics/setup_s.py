"""Seconds from the process's start to the window's: imports, the read sets
made from the seed, the kernels' build or load, one warm assessment."""
UNIT = "s"


def read(run):
    return run.setup_s
