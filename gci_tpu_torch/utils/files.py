"""File-precondition helper: the reference's overwrite protection.

Counterpart of ``gci_tpu.utils.files`` for a single-process run.
"""
from __future__ import annotations

import os
import sys


def require_writable(path: str, force: bool) -> None:
    """``sys.exit`` when ``path`` exists and not ``force`` (GCI.py:196-197)."""
    if os.path.exists(path) and not force:
        sys.exit(
            f'ERROR!!! The file "{path}" exists\nPlease use "-f" or "--force" to rewrite'
        )
