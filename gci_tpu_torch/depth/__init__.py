"""Depth backends of the port (counterpart of ``gci_tpu.depth``)."""
from __future__ import annotations

import os

from .accum import (
    GenomeLayout,
    accumulate_depth,
    accumulate_depth_numpy,
    depth_dict_from_flat,
)

# backends this port runs
PORTED_BACKENDS = ("device", "streamed", "sharded", "events", "numpy")


def resolve_auto_backend() -> str:
    """``device``: the run goes on the card, and raises where there is none.

    The host backends run only when they are named, through ``--device`` or
    ``GCI_AUTO_BACKEND`` (restricted to the ported backends).
    """
    override = os.environ.get("GCI_AUTO_BACKEND")
    if override:
        if override not in PORTED_BACKENDS:
            raise ValueError(
                f"GCI_AUTO_BACKEND={override!r} is not a ported depth backend"
                f" (expected one of {sorted(PORTED_BACKENDS)})"
            )
        return override
    return "device"


__all__ = [
    "GenomeLayout",
    "PORTED_BACKENDS",
    "accumulate_depth",
    "accumulate_depth_numpy",
    "depth_dict_from_flat",
    "resolve_auto_backend",
]
