"""Torch device resolution.  The device is always passed down explicitly."""
from __future__ import annotations

import torch


def resolve_device(spec: str | torch.device) -> torch.device:
    """``torch.device`` for ``spec``; raise when it names CUDA and none exists."""
    dev = torch.device(spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA was requested but torch.cuda.is_available() is false")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported torch device {dev}")
    return dev
