"""File preconditions of the port (counterpart of ``gci_tpu.utils``)."""
