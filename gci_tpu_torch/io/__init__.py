"""I/O of the port: FASTA, BAM, PAF and BED readers, the BAM writer and the
``.depth.gz`` checkpoint writer (counterpart of ``gci_tpu.io``)."""
