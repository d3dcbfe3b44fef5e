"""Milliseconds per completed assessment in the program's spans of the
streamed path's chunks: ``streamed.scatter`` (the host's index prep and
range check, the H2D copy, ``index_add_`` and the scan's launch),
``streamed.compact`` (the run form of the compaction and its count's sync)
and ``streamed.readback`` (the D2H copy), from the port's registry
(``gci_tpu_torch.utils.metrics``), which records while the window's
profiler does; None where the program has no such span."""
from gci_tpu_torch.utils import metrics

UNIT = "ms"
SPANS = ("streamed.scatter", "streamed.compact", "streamed.readback")


def read(run):
    totals = getattr(metrics.get_metrics(), "span_totals", None)
    if run.trace is None or not run.completed or totals is None:
        return None
    got = totals()
    if not any(s in got for s in SPANS):
        return None
    return 1000 * sum(got[s]["seconds"] for s in SPANS if s in got) / run.completed
