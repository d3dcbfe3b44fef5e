"""Host helpers of the single-GPU depth path, the device scatter and scans.

Counterpart of ``gci_tpu/depth/device.py``.  ``pack_read_deltas``,
``build_scan_valid`` and ``edge_indices_to_intervals`` are host numpy code,
copied because their JAX module imports jax at its top;
``depth_and_edges_fused`` is the single-chip fused entry.  The rest of that
module (the sharded mesh programs) belongs to the multi-GPU slice.
"""
from __future__ import annotations

import numpy as np
import torch

from gci_tpu.depth.accum import GenomeLayout, clamp_read_intervals
from gci_tpu_torch.depth.scan import depth_scan, fused_depth_scan

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


def scatter_events(pad_total: int, device: torch.device, events) -> torch.Tensor:
    """int32 zeros(pad_total) plus every (indices, value) event, in one
    ``index_add_``.

    The reference's scatter drops out-of-range indices silently; torch's
    raises (CPU) or asserts (CUDA), so the range is checked here on the host
    and an index outside ``[0, pad_total)`` raises IndexError.  Integer adds
    commute, so the atomics' order on the card cannot change the result.
    """
    idx = [np.asarray(i, np.int64) for i, _ in events]
    val = [
        np.broadcast_to(np.asarray(v, np.int32), i.shape) for i, (_, v) in zip(idx, events)
    ]
    idx = np.concatenate(idx) if idx else np.empty(0, np.int64)
    val = np.concatenate(val) if val else np.empty(0, np.int32)
    w = torch.zeros(pad_total, dtype=torch.int32, device=device)
    if idx.shape[0] == 0:
        return w
    if int(idx.min()) < 0 or int(idx.max()) >= pad_total:
        raise IndexError(
            f"event index outside [0, {pad_total}): "
            f"[{int(idx.min())}, {int(idx.max())}]"
        )
    w.index_add_(0, torch.from_numpy(idx).to(device), torch.from_numpy(val).to(device))
    return w


def _local_prefix_sum(delta: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum on the tensor's device (``depth_scan``)."""
    return depth_scan(delta)


def depth_and_edges_fused(gs, ge, live, valid_i8, leftmost: int, rightmost: int,
                          total_padded: int, *, device: torch.device):
    """Scatter of the read deltas plus the fused scan on one device.

    ``gs``, ``ge`` and ``live`` are host arrays as ``pack_read_deltas``
    gives them; ``valid_i8`` is the int8 scan-window mask of
    ``total_padded`` slots (nonzero is valid).  Returns (depth, rise int8,
    fall int8) of ``leftmost < depth <= rightmost`` inside ``valid_i8``.
    The reference drops out-of-range read indices silently; here a read
    index outside ``[0, total_padded)`` raises IndexError.  Any
    ``total_padded`` works: the kernel has no chunk multiple.
    """
    delta = scatter_events(total_padded, device, [(gs, live), (ge, -np.asarray(live))])
    valid = torch.as_tensor(valid_i8, dtype=torch.int8, device=device)
    return fused_depth_scan(delta, valid, leftmost, rightmost)


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
