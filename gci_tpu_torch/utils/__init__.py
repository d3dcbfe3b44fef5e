"""Stage metrics and file preconditions of the port (counterpart of
``gci_tpu.utils``)."""
