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


def events_from_boundaries(layout, idx: np.ndarray, vals: np.ndarray):
    """{target: DepthEvents} from the whole genome's run form.

    ``idx`` and ``vals`` are int64 host arrays: the slots where the depth
    changes, strictly increasing with ``idx[0] == 0``, and the depth of the
    run each of them starts, neighbouring ``vals`` different.  A target's
    events are then the slice of the boundaries inside it, shifted to its
    start, with a boundary put at slot 0 where none falls there, valued by
    the run that holds the target's start: already the canonical form, so
    nothing is gathered or merged.  Boundaries past the last target (a
    backend's padding) are not read.  The events may hold views of ``idx``
    and ``vals``.
    """
    from gci_tpu_torch.depth.eventspace import DepthEvents

    starts = layout.offsets[:-1]
    lo = np.searchsorted(idx, starts)
    hi = np.searchsorted(idx, starts + layout.lengths)
    # the run holding each start (a zero-length target may start on a boundary)
    holding = vals[np.searchsorted(idx, starts, side="right") - 1]
    out = {}
    for k, name in enumerate(layout.names):
        o, a, b = int(starts[k]), int(lo[k]), int(hi[k])
        if a < b and idx[a] == o:
            bounds, values = idx[a:b] - o, vals[a:b]
        else:
            bounds = np.empty(b - a + 1, np.int64)
            bounds[0] = 0
            np.subtract(idx[a:b], o, out=bounds[1:])
            values = np.empty(b - a + 1, np.int64)
            values[0] = holding[k]
            values[1:] = vals[a:b]
        out[name] = DepthEvents(bounds, values, int(layout.lengths[k]))
    return out
