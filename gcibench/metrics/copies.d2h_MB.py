"""10^6 bytes per completed assessment that the program read back from the
card: its counter ``copies.d2h_bytes`` (the run boundaries and edges with
their values), from the port's registry (``gci_tpu_torch.utils.metrics``),
which counts while the window's profiler records; None where the program
has no such counter."""
from gci_tpu_torch.utils import metrics

UNIT = "MB"
COUNTER = "copies.d2h_bytes"


def read(run):
    totals = getattr(metrics.get_metrics(), "counter_totals", None)
    if run.trace is None or not run.completed or totals is None:
        return None
    n = totals().get(COUNTER)
    return None if n is None else n / 1e6 / run.completed
