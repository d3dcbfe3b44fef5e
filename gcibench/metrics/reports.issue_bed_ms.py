"""Milliseconds per completed assessment in the benchmark's span around
``emit_issue_bed`` of every depth (issue intervals and their BED)."""
UNIT = "ms"


def read(run):
    return run.span_ms("reports.issue_bed")
