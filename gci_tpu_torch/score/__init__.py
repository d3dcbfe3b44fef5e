"""N50 and GCI score math and the continuity report of the port
(counterpart of ``gci_tpu.score``)."""
from .metrics import compute_n50, gci_score

__all__ = ["compute_n50", "gci_score"]
