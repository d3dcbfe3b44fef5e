"""Genome bases assessed per second: the genome length of every assessment
that completed, over the time from the window's start to the end of the
last one (host clock)."""
UNIT = "Gbp/s"


def read(run):
    if not run.completed:
        return None
    return run.completed * run.genome_bp / run.window_s / 1e9
