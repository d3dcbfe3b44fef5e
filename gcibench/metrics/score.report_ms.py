"""Milliseconds per completed assessment in the benchmark's span around
``compute_continuity_report`` (the .gci scores)."""
UNIT = "ms"


def read(run):
    return run.span_ms("score.report")
