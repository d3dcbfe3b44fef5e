"""Shared machinery for device-resident whole-genome depth values.

``ResidentDepth`` is the common base for device-resident depth values —
``gci_tpu_torch.depth.fused.DeviceDepth`` (one GPU, one fused scan kernel
pass) and ``gci_tpu_torch.depth.sharded.ShardedDepth`` (gp shards over a
mesh).  Pipeline dispatch sites (checkpoint writer, gap masker, issue-bed
emitter, two-type merge, host views) test against this base.  The
interface every subclass provides:

* ``mask_gaps(gaps) -> ResidentDepth``   — zero depth over N-gap intervals
* ``maximum(other) -> ResidentDepth``    — per-base two-type max
* ``collapse_dict(lo, hi, flank, start_pos)`` — issue intervals (host dict)
* ``to_events() -> {target: DepthEvents}`` — O(runs) host view
* ``materialize_dict()``                 — per-base arrays (tests/oracles)
"""
from __future__ import annotations

import numpy as np


class ResidentDepth:
    """Marker base: whole-genome depth resident on accelerator memory."""


def gap_interval_events(layout, gaps):
    """Clamped global (starts, stops) int64 arrays for N-gap intervals.

    Shared by the single-chip and sharded gap-mask builders so the clamp
    semantics (``max(0, min(x, L))``, empty-interval drop, unknown-target
    skip) cannot diverge between backends.
    """
    index = {n: k for k, n in enumerate(layout.names)}
    starts: list[int] = []
    stops: list[int] = []
    for t, segs in (gaps or {}).items():
        k = index.get(t)
        if k is None:
            continue
        o = int(layout.offsets[k])
        L = int(layout.lengths[k])
        for s, e in segs:
            s, e = max(0, min(int(s), L)), max(0, min(int(e), L))
            if e > s:
                starts.append(o + s)
                stops.append(o + e)
    return (
        np.asarray(starts, np.int64),
        np.asarray(stops, np.int64),
    )


def events_from_change_indices(layout, idx: np.ndarray, gather):
    """Build per-target ``DepthEvents`` from global run-boundary indices.

    ``idx`` — sorted int64 indices into the concatenated genome axis where
    the depth value changes; ``gather(all_idx) -> int64 values`` reads the
    depth at those indices (backend-specific: a host lookup in values
    already read back, or a device gather).  A boundary is forced at every target start so each
    target's event list is self-contained.
    """
    from gci_tpu_torch.depth.eventspace import DepthEvents

    names = layout.names
    gather_list: list[np.ndarray] = []
    spans: list[tuple[int, int, int]] = []  # (gather_lo, gather_hi, L)
    cursor = 0
    for k in range(len(names)):
        o = int(layout.offsets[k])
        L = int(layout.lengths[k])
        lo = np.searchsorted(idx, o, side="left")
        hi = np.searchsorted(idx, o + L, side="left")
        b = idx[lo:hi]
        if b.shape[0] == 0 or b[0] != o:
            b = np.concatenate([[o], b])
        gather_list.append(b)
        spans.append((cursor, cursor + b.shape[0], L))
        cursor += b.shape[0]
    all_idx = (
        np.concatenate(gather_list) if gather_list else np.empty(0, np.int64)
    )
    vals = (
        gather(all_idx.astype(np.int64))
        if all_idx.shape[0]
        else np.empty(0, np.int64)
    )
    out: dict[str, DepthEvents] = {}
    for k, name in enumerate(names):
        glo, ghi, L = spans[k]
        b = gather_list[k] - int(layout.offsets[k])
        out[name] = DepthEvents(b.astype(np.int64), vals[glo:ghi], L)._dedup()
    return out
