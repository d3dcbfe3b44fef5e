"""File-precondition helper: the reference's overwrite protection.

Counterpart of ``gci_tpu.utils.files``, multi-process aware: the primary
process's view of the filesystem decides, the decision is broadcast, and
every process exits together (if only the primary exited, the others would
hang in the next collective).
"""
from __future__ import annotations

import os
import sys

from gci_tpu_torch.parallel.distributed import broadcast_flag, process_count


def require_writable(path: str, force: bool) -> None:
    """``sys.exit`` (on all processes) when ``path`` exists and not ``force``
    (GCI.py:196-197)."""
    blocked = os.path.exists(path) and not force
    if process_count() > 1:
        # the primary's filesystem is authoritative (it is the only writer)
        blocked = broadcast_flag(blocked)
    if blocked:
        sys.exit(
            f'ERROR!!! The file "{path}" exists\nPlease use "-f" or "--force" to rewrite'
        )
