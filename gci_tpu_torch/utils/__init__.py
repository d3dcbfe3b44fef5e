"""Stage metrics and file preconditions of the port (counterpart of
``gci_tpu.utils``)."""
from .metrics import StageMetrics, get_metrics, stage

__all__ = ["StageMetrics", "get_metrics", "stage"]
