"""Host helpers of the single-GPU depth path and the device prefix sum.

Counterpart of ``gci_tpu/depth/device.py``.  ``pack_read_deltas``,
``build_scan_valid`` and ``edge_indices_to_intervals`` are host numpy code,
copied because their JAX module imports jax at its top; the rest of that
module (the sharded mesh programs) belongs to the multi-GPU slice.
"""
from __future__ import annotations

import numpy as np
import torch

from gci_tpu.depth.accum import GenomeLayout, clamp_read_intervals
from gci_tpu_torch.depth.scan import depth_scan

_INT32_MAX = np.iinfo(np.int32).max


def pack_read_deltas(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int,
    pad_to: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global (start_slot, stop_slot, live) arrays with slice-exact clamping.

    int32 slot indices: only valid for single-device layouts below 2^31
    slots.
    """
    if layout.total_slots > _INT32_MAX:
        raise OverflowError(
            f"{layout.total_slots} slots exceed int32 global indexing"
        )
    s, e = clamp_read_intervals(layout, target_id, start, end, flank_len)
    base = layout.offsets[target_id]
    gs = (base + s).astype(np.int32)
    ge = (base + e).astype(np.int32)
    live = (e > s).astype(np.int32)
    if pad_to is not None and gs.shape[0] < pad_to:
        padn = pad_to - gs.shape[0]
        gs = np.concatenate([gs, np.zeros(padn, np.int32)])
        ge = np.concatenate([ge, np.zeros(padn, np.int32)])
        live = np.concatenate([live, np.zeros(padn, np.int32)])
    return gs, ge, live


def _local_prefix_sum(delta: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum on the tensor's device (``depth_scan``)."""
    return depth_scan(delta)


def build_scan_valid(layout: GenomeLayout, flank_len: int,
                     pad_to: int | None = None) -> np.ndarray:
    """Boolean per-slot mask of positions inside each target's scan window.

    Scan window = [flank, L-flank) per target (empty when L <= 2*flank),
    matching the slice the reference iterates (GCI.py:374).
    """
    total = layout.total_slots
    valid = np.zeros(pad_to or total, dtype=bool)
    for k in range(len(layout.names)):
        L = int(layout.lengths[k])
        if L - 2 * flank_len <= 0:
            continue
        o = int(layout.offsets[k])
        valid[o + flank_len : o + L - flank_len] = True
    return valid


def edge_indices_to_intervals(
    layout: GenomeLayout,
    rise_idx: np.ndarray,
    fall_idx: np.ndarray,
    flank_len: int,
    start_pos: int = 0,
) -> dict[str, list[tuple[int, int]]]:
    """Reference-exact interval dicts from sorted global edge indices.

    Applies the reference emission quirks (drop when the run terminates at a
    scan index <= flank_len; final-position closure).
    """
    from gci_tpu.intervals.collapse import runs_to_intervals

    out: dict[str, list[tuple[int, int]]] = {}
    for k, name in enumerate(layout.names):
        L = int(layout.lengths[k])
        o = int(layout.offsets[k])
        n_scan = L - 2 * flank_len
        if n_scan <= 0:
            out[name] = []
            continue
        w_lo = o + flank_len
        w_hi = o + L - flank_len  # exclusive end of scan window
        r = rise_idx[(rise_idx >= w_lo) & (rise_idx < w_hi)] - w_lo
        f = fall_idx[(fall_idx >= w_lo) & (fall_idx <= w_hi)] - w_lo
        # a run still open at the final scanned position has no fall edge
        # inside the window: close it at n_scan
        if r.shape[0] > f.shape[0]:
            f = np.concatenate([f, [n_scan]])
        elif f.shape[0] > r.shape[0]:  # defensive; cannot happen with valid masks
            f = f[: r.shape[0]]
        f = np.minimum(f, n_scan)
        out[name] = runs_to_intervals(r, f, n_scan, flank_len, start_pos)
    return out
