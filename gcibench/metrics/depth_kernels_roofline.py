"""The depth work's share of its bandwidth bound, from the device trace.

The work, not the kernels that do it: each genome-wide depth that the
outputs are defined on (one per read type, and their maximum where there
are two) needs 12 bytes a genome slot: its delta read once, its depth
written once and read once more for the run boundaries and issue edges.
The bound is those bytes at the card's HBM bandwidth (``peaks.json``); the
share is the bound over the summed time of every device operation per
completed assessment, copies included.  A port that stops making per-slot
depth would need this count revised.
"""
UNIT = "%"
BYTES_PER_SLOT = 12


def read(run):
    bw = run.peaks.get("hbm_bytes_per_s")
    if run.trace is None or not run.trace.device_events or not bw or not run.completed:
        return None
    bound_s = BYTES_PER_SLOT * run.slots * run.depths / bw
    return 100 * bound_s / (run.trace.device_s / run.completed)
