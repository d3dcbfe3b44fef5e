"""Milliseconds per completed assessment in the program's span
``fused.pack`` (inside ``DeviceDepth.from_reads``: the host pack of the
reads into global start and stop slots, ``pack_read_deltas``, and the gap
and scan-window events), from the port's registry
(``gci_tpu_torch.utils.metrics``), which records while the window's
profiler does; None where the program has no such span."""
from gci_tpu_torch.utils import metrics

UNIT = "ms"
SPANS = ("fused.pack",)


def read(run):
    totals = getattr(metrics.get_metrics(), "span_totals", None)
    if run.trace is None or not run.completed or totals is None:
        return None
    got = totals()
    if not any(s in got for s in SPANS):
        return None
    return 1000 * sum(got[s]["seconds"] for s in SPANS if s in got) / run.completed
