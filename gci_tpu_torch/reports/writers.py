"""Byte-compatible report emitters (counterpart of ``gci_tpu.reports.writers``).

* ``emit_issue_bed`` — reference GCI.py:393-419 ``merge_depth``: collapse
  depth <= threshold into intervals and write
  ``{prefix}.{threshold}.depth.bed``.
* ``emit_gaps_bed`` — reference GCI.py:37-44: write gap intervals when any.
"""
from __future__ import annotations

import numpy as np

from gci_tpu_torch.depth.base import ResidentDepth
from gci_tpu_torch.intervals import collapse_depth_dict
from gci_tpu_torch.io.bed import write_bed_dict
from gci_tpu_torch.utils.metrics import stage
from gci_tpu_torch.parallel.distributed import is_primary_host
from gci_tpu_torch.utils.files import require_writable


def emit_issue_bed(
    depths: dict[str, np.ndarray],
    prefix: str = "GCI",
    threshold: int = 0,
    flank_len: int = 15,
    directory: str = ".",
    force: bool = False,
    log_reads_type: str = "",
    precomputed: dict[str, list[tuple[int, int]]] | None = None,
) -> dict[str, list[tuple[int, int]]]:
    """Write the issues BED and return the interval dict (GCI.py:393-419).

    ``precomputed`` hands over intervals already extracted elsewhere
    (identical semantics), skipping the scan.
    """
    print(f"Getting {log_reads_type} issues bed file detected by GCI ...")
    path = f"{directory}/{prefix}.{threshold}.depth.bed"
    require_writable(path, force)
    with stage(f"issue_bed:{prefix}"):
        if precomputed is not None:
            merged = precomputed
        elif isinstance(depths, ResidentDepth):
            # device path: kernel-cached edges or one on-device edge pass
            merged = depths.collapse_dict(-1, threshold, flank_len, 0)
        else:
            merged = collapse_depth_dict(depths, -1, threshold, flank_len, 0)
        if is_primary_host():
            write_bed_dict(path, merged)
    print(f"Getting {log_reads_type} issues bed file done!!!\n\n")
    return merged


def emit_gaps_bed(
    gaps: dict[str, list[tuple[int, int]]] | None,
    prefix: str = "GCI",
    directory: str = ".",
    force: bool = False,
) -> str | None:
    """Write {prefix}.gaps.bed when gaps exist; return path or None (GCI.py:37-44)."""
    if not gaps:
        return None
    path = f"{directory}/{prefix}.gaps.bed"
    require_writable(path, force)
    if is_primary_host():
        write_bed_dict(path, gaps)
    return path
