"""The 95th percentile of assessment latency, nearest rank, over every
assessment that completed in the window (host clock)."""
import math

UNIT = "s"


def read(run):
    if not run.latencies:
        return None
    x = sorted(run.latencies)
    return x[math.ceil(0.95 * len(x)) - 1]
