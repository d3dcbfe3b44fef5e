"""Milliseconds per completed assessment in the program's span
``fused.readback`` (inside ``DeviceDepth.from_reads``: the flag-form
compaction of the scan's rise, fall and change bits, its count's sync, the
gather of each run's depth and the one D2H copy), from the port's registry
(``gci_tpu_torch.utils.metrics``), which records while the window's
profiler does; None where the program has no such span."""
from gci_tpu_torch.utils import metrics

UNIT = "ms"
SPANS = ("fused.readback",)


def read(run):
    totals = getattr(metrics.get_metrics(), "span_totals", None)
    if run.trace is None or not run.completed or totals is None:
        return None
    got = totals()
    if not any(s in got for s in SPANS):
        return None
    return 1000 * sum(got[s]["seconds"] for s in SPANS if s in got) / run.completed
