"""The process's peak resident set (``ru_maxrss``) when the window closes,
in 10^9 bytes."""
UNIT = "GB"


def read(run):
    return run.host_peak_bytes / 1e9
