"""Run-length extraction of depth ranges (vectorized).

Behavioral contract (reference: GCI.py:356-390 ``collapse_depth_range``):
positions ``i`` (0-based, relative to the scanned slice
``depth[flank_len : L - flank_len]``) whose depth ``d`` satisfies
``leftmost < d <= rightmost`` are collapsed into maximal runs, with the
reference's exact edge semantics:

* a run that is still open at the final scanned index closes with
  ``end = L - flank_len`` (GCI.py:380-382);
* a run that terminates at scanned index ``e`` (first out-of-range position)
  is emitted as ``(start + flank_len, e + flank_len)`` ONLY when
  ``e > flank_len`` (the ``if i > flank_len`` quirk at GCI.py:385) —
  otherwise it is silently dropped;
* both coordinates are offset by ``start_pos`` (region sub-slice support);
* an empty scan slice (``L <= 2*flank_len``) yields no runs.

The scan itself is an embarrassingly parallel mask + edge detection, which is
how the device path computes it (elementwise compare + shifted XOR over the
genome axis); this module is the host-side/numpy engine plus the shared
edge→interval compaction used by both paths.
"""
from __future__ import annotations

import numpy as np


def _runs_from_mask(mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (starts, ends_exclusive) of maximal True runs in a 1-D bool mask.

    ``ends_exclusive[k]`` is the index of the first False after run k, or
    ``len(mask)`` for a run that reaches the end.
    """
    n = mask.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    m = mask.astype(np.int8)
    d = np.diff(m)
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if m[0]:
        starts = np.concatenate(([0], starts))
    if m[-1]:
        ends = np.concatenate((ends, [n]))
    return starts.astype(np.int64), ends.astype(np.int64)


def runs_to_intervals(
    starts: np.ndarray,
    ends: np.ndarray,
    n_scan: int,
    flank_len: int,
    start_pos: int,
) -> list[tuple[int, int]]:
    """Apply the reference emission rules to raw (start, end_exclusive) runs.

    ``starts``/``ends`` are scan-slice relative (0-based over ``n_scan``
    positions). Returns genome-coordinate intervals.
    """
    out: list[tuple[int, int]] = []
    for s, e in zip(starts.tolist(), ends.tolist()):
        if e >= n_scan:
            # run open at the final scanned index: closed as end = i+flank+1
            # with i == n_scan-1 (GCI.py:380-382)
            out.append((s + flank_len + start_pos, n_scan - 1 + flank_len + 1 + start_pos))
        elif e > flank_len:
            out.append((s + flank_len + start_pos, e + flank_len + start_pos))
        # else: dropped (GCI.py:385 `if i > flank_len` quirk)
    return out


def collapse_depth_runs(
    depth: np.ndarray,
    leftmost: float = -1,
    rightmost: float = 0,
    flank_len: int = 15,
    start_pos: int = 0,
) -> list[tuple[int, int]]:
    """Collapse positions with depth in ``(leftmost, rightmost]`` into intervals.

    Vectorized equivalent of the reference per-base scan (GCI.py:356-390),
    including all edge quirks — see module docstring.
    """
    depth = np.asarray(depth)
    L = depth.shape[0]
    n_scan = L - 2 * flank_len
    if n_scan <= 0:
        return []
    s = depth[flank_len : L - flank_len]
    mask = (s > leftmost) & (s <= rightmost)
    starts, ends = _runs_from_mask(mask)
    return runs_to_intervals(starts, ends, n_scan, flank_len, start_pos)


def collapse_depth_dict(
    depths: dict[str, np.ndarray],
    leftmost: float = -1,
    rightmost: float = 0,
    flank_len: int = 15,
    start_pos: int = 0,
) -> dict[str, list[tuple[int, int]]]:
    """Per-target collapse over a depth dictionary (GCI.py:356-390).

    Values may be per-base arrays or event-space ``DepthEvents`` (identical
    output either way — the event path is oracle-tested against this one).
    """
    return {
        target: collapse_depth(depth, leftmost, rightmost, flank_len, start_pos)
        for target, depth in depths.items()
    }


def collapse_depth(
    depth,
    leftmost: float = -1,
    rightmost: float = 0,
    flank_len: int = 15,
    start_pos: int = 0,
) -> list[tuple[int, int]]:
    """Collapse one target's depth — per-base array or ``DepthEvents``."""
    from gci_tpu_torch.depth.eventspace import DepthEvents

    if isinstance(depth, DepthEvents):
        return depth.collapse(leftmost, rightmost, flank_len, start_pos)
    return collapse_depth_runs(depth, leftmost, rightmost, flank_len, start_pos)
