"""Process identity of the port (counterpart of ``gci_tpu.parallel``)."""
