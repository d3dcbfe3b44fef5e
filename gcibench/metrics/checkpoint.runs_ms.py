"""Milliseconds per completed assessment in the benchmark's span around
``to_events`` of each resident depth (the checkpoint's runs: boundaries expanded per chromosome on the host)."""
UNIT = "ms"


def read(run):
    return run.span_ms("checkpoint.runs")
