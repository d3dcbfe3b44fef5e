"""N50 and GCI score math and the continuity report of the port
(counterpart of ``gci_tpu.score``)."""
