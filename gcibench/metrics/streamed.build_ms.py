"""Milliseconds per completed assessment in the benchmark's span around
``events_from_reads_streamed`` (the host sort of the events, per chunk the scatter, K2 and the run form, the runs per chromosome)."""
UNIT = "ms"


def read(run):
    return run.span_ms("streamed.build")
