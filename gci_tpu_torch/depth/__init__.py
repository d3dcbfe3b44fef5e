"""Depth backends of the port (counterpart of ``gci_tpu.depth``)."""
from __future__ import annotations

import os

# backends this port runs; sharded and streamed come with later slices
PORTED_BACKENDS = ("device", "events", "numpy")


def resolve_auto_backend() -> str:
    """``device`` when CUDA is present, else ``events``.

    ``GCI_AUTO_BACKEND`` overrides, restricted to the ported backends.
    """
    override = os.environ.get("GCI_AUTO_BACKEND")
    if override:
        if override not in PORTED_BACKENDS:
            raise ValueError(
                f"GCI_AUTO_BACKEND={override!r} is not a ported depth backend"
                f" (expected one of {sorted(PORTED_BACKENDS)})"
            )
        return override
    import torch

    return "device" if torch.cuda.is_available() else "events"
