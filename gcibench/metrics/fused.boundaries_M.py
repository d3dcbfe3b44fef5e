"""10^6 run boundaries per completed assessment that the resident build
read back: the program's counter ``fused.boundaries`` (the run form that
``DeviceDepth.from_reads`` hands its checkpoint, slot 0 included), from
the port's registry (``gci_tpu_torch.utils.metrics``), which counts while
the window's profiler records; None where the program has no such
counter."""
from gci_tpu_torch.utils import metrics

UNIT = "M"
COUNTER = "fused.boundaries"


def read(run):
    totals = getattr(metrics.get_metrics(), "counter_totals", None)
    if run.trace is None or not run.completed or totals is None:
        return None
    n = totals().get(COUNTER)
    return None if n is None else n / 1e6 / run.completed
