"""The depth path's two scan kernels and their plain PyTorch versions.

Counterpart of ``gci_tpu/depth/pallas_scan.py``:

* ``depth_scan`` — inclusive int32 prefix sum, wrapping mod 2^32
  (pallas_scan.py ``depth_scan``);
* ``fused_depth_scan_packed`` — depth plus a flag byte from one packed event
  word per slot (pallas_scan.py ``fused_depth_scan_packed``).

Each wrapper runs its plain version for a tensor on the CPU, and for a CUDA
tensor launches its hand-written kernel (``gci_tpu_torch/csrc/scan.cu``) or
raises: it never falls back.  The plain versions define the semantics; the
CPU tests hold them against the JAX package, and the card's smoke run holds
the kernels against them.
"""
from __future__ import annotations

import torch

from gci_tpu_torch import kernels


def _route(x: torch.Tensor) -> bool:
    """True for the plain CPU version; raise for a device with no kernel."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def depth_scan_torch(delta: torch.Tensor) -> torch.Tensor:
    """Plain version of ``depth_scan``: int32 cumsum that wraps like jnp's."""
    return torch.cumsum(delta, 0, dtype=torch.int32)


def depth_scan(delta: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum of a 1-D int32 tensor (wraps mod 2^32)."""
    if _route(delta):
        return depth_scan_torch(delta)
    return kernels.launch_depth_scan(delta)


def fused_depth_scan_packed_torch(word: torch.Tensor, leftmost: int,
                                  rightmost: int):
    """Plain version of ``fused_depth_scan_packed``.

    ``word[i] = read_delta<<2 | gap_event<<1 | valid_event``; the prefix
    ``sw`` carries depth in bits 2..31, the in-gap state in bit 1 and the
    scan-window state in bit 0.  Returns (depth int32, flags int8) with
    bit0 rise, bit1 fall, bit2 change (forced at 0), bit3 in-gap.
    """
    sw = torch.cumsum(word, 0, dtype=torch.int32)
    # torch's >> on int32 is arithmetic: mask back to the logical shift
    raw = (sw >> 2) & 0x3FFFFFFF
    gap = (sw & 2) != 0
    valid = (sw & 1) != 0
    masked = torch.where(gap, 0, raw)
    m = (masked > leftmost) & (masked <= rightmost) & valid
    prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=m.device), m[:-1]])
    rise = m & ~prev
    fall = ~m & prev
    prev_raw = torch.cat([raw[:1] - 1, raw[:-1]])  # forces change at 0
    change = raw != prev_raw
    out = (
        rise.to(torch.int8)
        + fall.to(torch.int8) * 2
        + change.to(torch.int8) * 4
        + gap.to(torch.int8) * 8
    )
    return raw, out


def fused_depth_scan_packed(word: torch.Tensor, leftmost: int, rightmost: int):
    """(depth, flags) of a packed event word; see the plain version.

    Callers guarantee depth < 2^29 and that the gap and scan-window interval
    sets are each disjoint (so their prefix bits stay in {0, 1}).
    """
    if _route(word):
        return fused_depth_scan_packed_torch(word, leftmost, rightmost)
    return kernels.launch_packed_scan(word, leftmost, rightmost)
