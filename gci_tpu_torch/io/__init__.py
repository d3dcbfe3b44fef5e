"""Checkpoint writer of the port (counterpart of ``gci_tpu.io``)."""
