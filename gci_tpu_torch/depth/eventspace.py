"""Event-space per-target depth: piecewise-constant representation + ops.

Every per-base operation the pipeline needs — gap masking, two-type max,
interval collapse, run-length checkpoint serialization, mean depth — has an
exact O(#events) counterpart on the piecewise-constant depth function.  This
representation makes whole-genome wall-clock independent of genome length
(only read counts and interval counts matter) and is oracle-tested against
the per-base arrays.

``DepthEvents`` is one target's depth as (boundaries, values):
``values[k]`` holds on [boundaries[k], boundaries[k+1]) with an implicit
final boundary at ``length``; boundaries[0] == 0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

from gci_tpu_torch.intervals.collapse import runs_to_intervals

if TYPE_CHECKING:
    from gci_tpu_torch.depth.accum import GenomeLayout


@dataclass
class DepthEvents:
    boundaries: np.ndarray  # int64 ascending, [0] == 0, all < length
    values: np.ndarray      # int64, same shape
    length: int

    # ------------------------------------------------------------------ build
    @classmethod
    def from_reads(cls, starts: np.ndarray, stops: np.ndarray, length: int) -> "DepthEvents":
        """From clamped increment slots (stop exclusive), like a[s:e] += 1."""
        starts = np.asarray(starts, np.int64)
        stops = np.asarray(stops, np.int64)
        live = stops > starts
        starts, stops = starts[live], stops[live]
        pos = np.concatenate([starts, stops])
        delta = np.concatenate(
            [np.ones(starts.shape[0], np.int64), -np.ones(stops.shape[0], np.int64)]
        )
        order = np.argsort(pos, kind="stable")
        pos, delta = pos[order], delta[order]
        if pos.shape[0]:
            uniq = np.concatenate([[True], pos[1:] != pos[:-1]])
            upos = pos[uniq]
            seg = np.cumsum(uniq) - 1
            sums = np.zeros(upos.shape[0], np.int64)
            np.add.at(sums, seg, delta)
            levels = np.cumsum(sums)
        else:
            upos = np.empty(0, np.int64)
            levels = np.empty(0, np.int64)
        if upos.shape[0] == 0 or upos[0] != 0:
            upos = np.concatenate([[0], upos])
            levels = np.concatenate([[0], levels])
        keep = upos < length
        return cls(upos[keep], levels[keep], length)._dedup()

    @classmethod
    def from_array(cls, depth: np.ndarray) -> "DepthEvents":
        depth = np.asarray(depth, np.int64)
        L = depth.shape[0]
        if L == 0:
            return cls(np.zeros(1, np.int64), np.zeros(1, np.int64), 0)
        change = np.concatenate([[True], depth[1:] != depth[:-1]])
        b = np.flatnonzero(change).astype(np.int64)
        return cls(b, depth[b], L)

    def _dedup(self) -> "DepthEvents":
        """Merge adjacent equal-value segments (canonical form)."""
        if self.values.shape[0] <= 1:
            return self
        keep = np.concatenate([[True], self.values[1:] != self.values[:-1]])
        return DepthEvents(self.boundaries[keep], self.values[keep], self.length)

    # ------------------------------------------------------------------- ops
    def run_lengths(self) -> tuple[np.ndarray, np.ndarray]:
        """(values, counts) run-length form over the full [0, length)."""
        if self.length == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        ends = np.concatenate([self.boundaries[1:], [self.length]])
        return self.values, ends - self.boundaries

    def materialize(self) -> np.ndarray:
        vals, counts = self.run_lengths()
        return np.repeat(vals, counts)

    def total(self) -> int:
        vals, counts = self.run_lengths()
        return int((vals * counts).sum())

    def mask_intervals(self, intervals: list[tuple[int, int]]) -> "DepthEvents":
        """Zero depth over intervals (gap masking, GCI.py:315-329).

        One vectorized merge pass over all intervals — O((runs + gaps) log)
        — instead of a per-interval boundary rebuild (which would be
        O(gaps * runs): a fragmented draft assembly has tens of thousands
        of N-gaps).  Intervals may overlap or arrive unsorted.
        """
        if not len(intervals):
            return self
        arr = np.asarray(intervals, dtype=np.int64).reshape(-1, 2)
        s = np.clip(arr[:, 0], 0, self.length)
        e = np.clip(arr[:, 1], 0, self.length)
        live = e > s
        s, e = s[live], e[live]
        if s.shape[0] == 0:
            return self
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        # coalesce overlapping/touching intervals so membership tests below
        # can use one searchsorted against disjoint sorted ranges
        cmax = np.maximum.accumulate(e)
        new = np.empty(s.shape[0], dtype=bool)
        new[0] = True
        new[1:] = s[1:] > cmax[:-1]
        gs = s[new]
        starts_idx = np.flatnonzero(new)
        ge = cmax[np.append(starts_idx[1:] - 1, s.shape[0] - 1)]
        # candidate boundaries: original runs + gap edges; value at each is
        # 0 inside a gap, the underlying run value outside
        pos = np.unique(
            np.concatenate([self.boundaries, gs, ge[ge < self.length]])
        )
        gi = np.searchsorted(gs, pos, side="right") - 1
        in_gap = (gi >= 0) & (pos < ge[np.clip(gi, 0, None)])
        orig = self.values[
            np.searchsorted(self.boundaries, pos, side="right") - 1
        ]
        vals = np.where(in_gap, 0, orig)
        return DepthEvents(pos, vals, self.length)._dedup()

    def maximum(self, other: "DepthEvents") -> "DepthEvents":
        """Per-base max of two depth functions (two-type merge, GCI.py:332-353)."""
        assert self.length == other.length
        b = np.union1d(self.boundaries, other.boundaries)
        va = self.values[np.searchsorted(self.boundaries, b, side="right") - 1]
        vb = other.values[np.searchsorted(other.boundaries, b, side="right") - 1]
        return DepthEvents(b, np.maximum(va, vb), self.length)._dedup()

    def collapse(
        self,
        leftmost: float = -1,
        rightmost: float = 0,
        flank_len: int = 15,
        start_pos: int = 0,
    ) -> list[tuple[int, int]]:
        """Reference-exact interval collapse (GCI.py:356-390 semantics)."""
        L = self.length
        n_scan = L - 2 * flank_len
        if n_scan <= 0:
            return []
        next_b = np.concatenate([self.boundaries[1:], [L]])
        lo = np.maximum(self.boundaries, flank_len)
        hi = np.minimum(next_b, L - flank_len)
        sel = hi > lo
        lo, hi = lo[sel], hi[sel]
        if lo.shape[0] == 0:
            return []
        m = (self.values[sel] > leftmost) & (self.values[sel] <= rightmost)
        d = np.diff(m.astype(np.int8))
        rs = np.flatnonzero(d == 1) + 1
        re_ = np.flatnonzero(d == -1) + 1
        if m[0]:
            rs = np.concatenate([[0], rs])
        if m[-1]:
            re_ = np.concatenate([re_, [m.shape[0]]])
        r_starts = lo[rs] - flank_len
        closed = re_ < m.shape[0]
        end_from_hi = hi[re_ - 1] - flank_len
        r_ends = np.where(closed, end_from_hi, n_scan)
        return runs_to_intervals(
            r_starts.astype(np.int64), r_ends.astype(np.int64), n_scan, flank_len, start_pos
        )

    def slice(self, start: int, end: int) -> "DepthEvents":
        """Depth over [start, end) re-based to 0 (regions support)."""
        start = max(0, min(start, self.length))
        end = max(start, min(end, self.length))
        b, v = self.boundaries, self.values
        i0 = np.searchsorted(b, start, side="right") - 1
        i1 = np.searchsorted(b, end, side="left")
        nb = b[i0:i1].copy()
        nv = v[i0:i1].copy()
        if nb.shape[0]:
            nb[0] = start
        nb -= start
        return DepthEvents(nb, nv, end - start)._dedup()


def events_dict_from_reads(
    layout: "GenomeLayout",
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int = 15,
) -> dict[str, "DepthEvents"]:
    """Per-target DepthEvents from curated reads (event-space depth backend).

    Uses the same slice-clamp semantics as the per-base paths
    (``clamp_read_intervals``) so outputs are bit-identical to
    ``depths[t][start+flank : end-flank+1] += 1`` (GCI.py:302-306).
    """
    from gci_tpu_torch.depth.accum import clamp_read_intervals

    s, e = clamp_read_intervals(layout, target_id, start, end, flank_len)
    order = np.argsort(target_id, kind="stable")
    tid_sorted = target_id[order]
    s, e = s[order], e[order]
    bounds = np.searchsorted(tid_sorted, np.arange(len(layout.names) + 1))
    out: dict[str, DepthEvents] = {}
    for k, name in enumerate(layout.names):
        lo, hi = bounds[k], bounds[k + 1]
        out[name] = DepthEvents.from_reads(s[lo:hi], e[lo:hi], int(layout.lengths[k]))
    return out
