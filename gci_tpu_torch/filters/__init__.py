from .cascade import bam_filter_mask, dedup_last_wins, paf_filter_mask
from .election import elect_primary_targets
from .curation import curate_files, CurationInput

__all__ = [
    "bam_filter_mask",
    "paf_filter_mask",
    "dedup_last_wins",
    "elect_primary_targets",
    "curate_files",
    "CurationInput",
]
