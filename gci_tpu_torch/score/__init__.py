"""Continuity report of the port (counterpart of ``gci_tpu.score``)."""
