"""Per-base depth accumulation over the concatenated genome axis.

The reference walks reads one at a time doing
``depths[target][start+flank : end-flank+1] += 1`` (GCI.py:302-306).  We
reformulate as a difference array: +1 at the clamped interval start, −1 at
its exclusive stop, then a single prefix sum.  Laying every target out on one
concatenated axis with one sentinel slot per target (so a stop at position
L_t stays inside the target's slots) makes the prefix sum *global*: within
each target the deltas cancel, so the running sum re-zeroes at every target
boundary and one cumsum yields all per-base depths.  On a torch device
that is one ``index_add_`` and one ``depth_scan`` kernel (resident), or the
same per chunk (``gci_tpu_torch.depth.streamed``) for a genome past
``stream_slot_limit``.

Clamp semantics replicate numpy/python slice arithmetic on the reference's
``[start+flank : end-flank+1]`` — including the negative-stop wraparound for
alignments shorter than the flank (a documented reference quirk).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_INT32_MAX = int(np.iinfo(np.int32).max)

# Bytes per genome slot that the resident device path (depth/fused.py) holds
# on the card at its peak, in a dual-type run with gaps.  Through the
# two-type stage each read type's gap-masked depth and flag bytes (4 + 1,
# twice) and the two-type maximum (4) stay resident, 14 B/slot.  The largest
# transient on top of them is the two-type issue pass (``collapse_dict``):
# its rise and fall bitmaps (1 + 1), the bool bitmap ``_batched_readback``
# counts (1) and the int64 copy that ``sum`` of a bool tensor makes (8),
# 25 B/slot in all.  The card measured 9,897,666,048 B at 395,765,512
# slots, 25.009 B/slot (an H100 80GB HBM3 at 700 W, chip_smoke.py).
RESIDENT_BYTES_PER_SLOT = 25


def stream_slot_limit(device: torch.device) -> int:
    """Most genome slots the resident device path takes on ``device``;
    a larger genome takes the streamed path.

    Two limits: the resident path indexes slots with int32 (2^31 - 1), and
    on a CUDA device its peak (``RESIDENT_BYTES_PER_SLOT``) must fit in the
    free memory ``torch.cuda.mem_get_info`` reports.
    """
    if device.type != "cuda":
        return _INT32_MAX
    free, _ = torch.cuda.mem_get_info(device)
    return min(_INT32_MAX, free // RESIDENT_BYTES_PER_SLOT)


@dataclass(frozen=True)
class GenomeLayout:
    """Concatenated coordinate axis: one slot span of L_t + 1 per target."""

    names: tuple[str, ...]
    lengths: np.ndarray  # int64, per target
    offsets: np.ndarray  # int64, size n_targets + 1; stride = length + 1

    @classmethod
    def from_targets(cls, targets_length: dict[str, int]) -> "GenomeLayout":
        names = tuple(targets_length.keys())
        lengths = np.array(list(targets_length.values()), dtype=np.int64)
        offsets = np.zeros(len(names) + 1, dtype=np.int64)
        np.cumsum(lengths + 1, out=offsets[1:])
        return cls(names, lengths, offsets)

    @property
    def total_slots(self) -> int:
        return int(self.offsets[-1])


def clamp_read_intervals(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Python-slice-exact [s, e) bounds per read, in local target coordinates.

    Replicates ``a[start+flank : end-flank+1] += 1`` slice clamping:
    negative stop wraps by +L (then clamps at 0), and both bounds clamp to
    [0, L].
    """
    L = layout.lengths[target_id]
    s = start.astype(np.int64) + flank_len
    e = end.astype(np.int64) - flank_len + 1
    e = np.where(e < 0, e + L, e)
    e = np.clip(e, 0, L)
    s = np.clip(s, 0, L)
    return s, e


def accumulate_depth_numpy(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int = 15,
) -> np.ndarray:
    """Flat per-slot depth (int32) over the concatenated axis (host path)."""
    s, e = clamp_read_intervals(layout, target_id, start, end, flank_len)
    live = e > s
    base = layout.offsets[target_id]
    gs = (base + s)[live]
    ge = (base + e)[live]
    total = layout.total_slots
    delta = np.bincount(gs, minlength=total).astype(np.int64)
    delta -= np.bincount(ge, minlength=total + 1)[:total]
    return np.cumsum(delta).astype(np.int32)


def accumulate_depth(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int = 15,
    backend: str = "auto",
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Flat per-slot int32 depth, on a torch device or the host numpy oracle.

    ``backend``: ``"auto"`` and ``"device"`` run on ``device`` (default: the
    current CUDA device; raises without one), ``"numpy"`` on the host; both
    give identical results.  On the device, one ``index_add_`` of the read
    deltas and one ``depth_scan`` up to ``stream_slot_limit`` slots, the
    streamed chunked scan past it.
    """
    if backend == "numpy":
        return accumulate_depth_numpy(layout, target_id, start, end, flank_len)
    if backend not in ("auto", "device"):
        raise ValueError(f"unknown accumulate_depth backend {backend!r}")
    from gci_tpu_torch.device import resolve_device

    dev = resolve_device("cuda" if device is None else device)
    if layout.total_slots > stream_slot_limit(dev):
        from gci_tpu_torch.depth.streamed import accumulate_depth_streamed

        return accumulate_depth_streamed(
            layout, target_id, start, end, flank_len, device=dev
        )
    from gci_tpu_torch.depth.device import pack_read_deltas, scatter_events
    from gci_tpu_torch.depth.scan import depth_scan

    gs, ge, live = pack_read_deltas(layout, target_id, start, end, flank_len)
    delta = scatter_events(layout.total_slots, dev, [(gs, live), (ge, -live)])
    return depth_scan(delta).cpu().numpy()


def depth_dict_from_flat(layout: GenomeLayout, flat: np.ndarray) -> dict[str, np.ndarray]:
    """Slice the concatenated axis back into per-target arrays (no sentinel)."""
    out: dict[str, np.ndarray] = {}
    for k, name in enumerate(layout.names):
        o = layout.offsets[k]
        out[name] = flat[o : o + layout.lengths[k]]
    return out
