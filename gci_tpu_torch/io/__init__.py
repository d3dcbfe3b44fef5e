"""I/O of the port: FASTA, BAM, PAF and BED readers, the BAM writer and the
``.depth.gz`` checkpoint writer (counterpart of ``gci_tpu.io``).

Importing it builds and loads nothing: the native codec loads on its first
use."""
from .fasta import read_fasta_lengths, scan_fasta, scan_fasta_gaps
from .depth_file import read_depth_gz, write_depth_gz
from .bed import read_bed_dict, write_bed_dict

__all__ = [
    "read_fasta_lengths",
    "scan_fasta",
    "scan_fasta_gaps",
    "read_depth_gz",
    "write_depth_gz",
    "read_bed_dict",
    "write_bed_dict",
]
