"""Process identity of a run (counterpart of ``gci_tpu.parallel.distributed``).

This slice runs one process on one device, so every run is single-process
and its one process writes the outputs.  The multi-GPU slice replaces these
with ``torch.distributed`` ranks.
"""
from __future__ import annotations


def process_count() -> int:
    return 1


def is_primary_host() -> bool:
    """True on the process that owns file writes: always, single-process."""
    return True
