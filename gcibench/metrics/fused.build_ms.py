"""Milliseconds per completed assessment in the benchmark's span around
``DeviceDepth.from_reads`` (the host pack, the scatter, K1, the flag compaction and its readback)."""
UNIT = "ms"


def read(run):
    return run.span_ms("fused.build")
