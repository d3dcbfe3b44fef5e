"""Single-GPU device-resident depth: the ``device`` backend's production path.

Counterpart of ``gci_tpu/depth/fused.py``.  One scatter builds the packed
event word ``read_delta<<2 | gap_event<<1 | valid_event`` on the device, and
one launch of the packed-word scan kernel (``depth/scan.py``) turns it into
depth plus a flag byte (bit0 rise, bit1 fall, bit2 change, bit3 in-gap).
Where the depth could reach the packed word's bound (``PACKED_DEPTH_LIMIT``),
the construction scatters a plain read delta instead, builds an int8 flag
byte per slot (bit0 in-gap, bit1 scan-window valid) from interval events,
and runs the flags scan kernel, which is exact at any depth.
Everything that leaves the device is O(reads + runs + edges): run boundaries
and issue edges are compacted on the device with a prefix sum (the
``depth_scan`` kernel) and ``searchsorted``, then read back in one transfer.

Plain XLA ops of the reference are plain torch ops here: the scatter-add,
``where``, ``maximum``, counts, ``searchsorted`` and gathers.  The torch
device is explicit: every constructor takes it, and every value keeps its
tensors there.
"""
from __future__ import annotations

import numpy as np
import torch

from gci_tpu_torch.depth.accum import GenomeLayout, depth_dict_from_flat
from gci_tpu_torch.depth.base import (
    ResidentDepth,
    events_from_change_indices,
    gap_interval_events,
)
from gci_tpu_torch.depth.device import (
    _local_prefix_sum,
    edge_indices_to_intervals,
    pack_read_deltas,
    scatter_events,
    scatter_events_into,
)
from gci_tpu_torch.depth.scan import (
    fused_depth_scan_flags,
    fused_depth_scan_packed,
    rise_fall,
    run_boundaries,
)

# depth-field bound of the packed event word (read_delta<<2): the scan is
# exact iff depth < 2^29 at every position.  At or above it the constructors
# take the flags scan.  Read at call time, so a test can lower it.
PACKED_DEPTH_LIMIT = 1 << 29


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _check_disjoint(starts: np.ndarray, stops: np.ndarray) -> None:
    """The packed word needs disjoint gap intervals (prefix bit in {0, 1})."""
    if starts.shape[0] < 2:
        return
    order = np.argsort(starts, kind="stable")
    if (starts[order][1:] < stops[order][:-1]).any():
        raise ValueError("gap intervals overlap; the packed event word needs them disjoint")


def _valid_intervals(layout: GenomeLayout, flank_len: int):
    """[flank, L-flank) scan-window intervals per target (GCI.py:374)."""
    starts: list[int] = []
    stops: list[int] = []
    for k in range(len(layout.names)):
        L = int(layout.lengths[k])
        if L - 2 * flank_len <= 0:
            continue
        o = int(layout.offsets[k])
        starts.append(o + flank_len)
        stops.append(o + L - flank_len)
    return starts, stops


def _mask(d: torch.Tensor, marks: torch.Tensor, gap_bit: int) -> torch.Tensor:
    """Gap-zeroing select (the reference's ``_mask_fn``); ``gap_bit`` is bit0
    in ``_flags``-built marks, bit3 in the packed kernel's flag byte."""
    return torch.where((marks & gap_bit) != 0, 0, d)


def _edges(depth: torch.Tensor, valid: torch.Tensor, lo: int, hi: int):
    """Rise/fall bitmaps of the issue mask (``_elementwise_fns``)."""
    return rise_fall((depth > lo) & (depth <= hi) & ((valid & 2) != 0))


def _flags(pad_total: int, device: torch.device, gap_s, gap_e, val_s, val_e):
    """Flag bytes: bit0 in-gap, bit1 scan-window valid, from O(intervals)
    scatters and two device prefix sums (the reference's ``_flags_fn``)."""
    gd = scatter_events(pad_total, device, [(gap_s, 1), (gap_e, -1)])
    out = (_local_prefix_sum(gd) > 0).to(torch.int8)
    del gd
    vd = scatter_events(pad_total, device, [(val_s, 1), (val_e, -1)])
    out += (_local_prefix_sum(vd) > 0).to(torch.int8) * 2
    return out


def flags_for(layout: GenomeLayout, gaps, flank_len: int, pad_total: int,
              device: torch.device) -> torch.Tensor:
    """Device int8 flag bytes: bit0 = in-N-gap, bit1 = scan-window valid."""
    gap_s, gap_e = gap_interval_events(layout, gaps)
    val_s, val_e = _valid_intervals(layout, flank_len)
    return _flags(pad_total, device, gap_s, gap_e, val_s, val_e)


def valid_marks_for(layout: GenomeLayout, flank_len: int, pad_total: int,
                    device: torch.device) -> torch.Tensor:
    """Device int8 flag bytes with only the valid bit (bit1) populated."""
    return flags_for(layout, None, flank_len, pad_total, device)


def _compact(bits: torch.Tensor, count: int) -> torch.Tensor:
    """Sorted indices of the ``count`` set entries of a bool bitmap: the
    k-th is ``searchsorted(prefix_sum(bits), k)`` (the reference's
    ``_compact_fn``).  The bitmap is scanned as the int8 bytes it is (a free
    view), so no int32 copy of it is made; the int32 prefix buffer dies on
    return."""
    pos = _local_prefix_sum(bits.view(torch.int8))
    k = torch.arange(1, count + 1, dtype=torch.int32, device=bits.device)
    return torch.searchsorted(pos, k)


def _batched_readback(array: torch.Tensor, layout: GenomeLayout, bitmap,
                      n_streams: int, gather_stream: int):
    """Compact ``n_streams`` bitmaps and read ``array`` at the gather
    stream's indices and at every target offset, in one transfer.

    ``bitmap(k)`` builds stream k's bool bitmap on demand, so at most one
    bitmap and one prefix buffer live at a time.  Counts are exact (the
    reference pads them to powers of two for static XLA shapes).  Returns
    (list of int64 index arrays, gathered values, values at the offsets).
    """
    counts = torch.stack([bitmap(k).sum() for k in range(n_streams)]).tolist()
    idx = []
    for k, c in enumerate(counts):
        if c == 0:
            idx.append(torch.empty(0, dtype=torch.int64, device=array.device))
        else:
            idx.append(_compact(bitmap(k), c))
    offsets = torch.as_tensor(
        np.asarray(layout.offsets[:-1], np.int64), device=array.device
    )
    parts = idx + [array[idx[gather_stream]], array[offsets]]
    packed = torch.cat([p.to(torch.int64) for p in parts]).cpu().numpy()
    out_idx = []
    cursor = 0
    for c in counts:
        out_idx.append(packed[cursor : cursor + c])
        cursor += c
    g_count = counts[gather_stream]
    gathered = packed[cursor : cursor + g_count]
    offset_vals = packed[cursor + g_count :]
    return out_idx, gathered, offset_vals


def _batched_flags_readback(array, layout: GenomeLayout, flags, masks: tuple,
                            gather_stream: int):
    """``_batched_readback`` over bit-masks of one flag array (the kernel's
    rise/fall/change output)."""
    return _batched_readback(
        array, layout, lambda k: (flags & masks[k]) != 0, len(masks),
        gather_stream,
    )


def _batched_edge_readback(array, layout: GenomeLayout, bitmaps,
                           gather_stream: int):
    """``_batched_readback`` over separate bitmaps."""
    return _batched_readback(
        array, layout, lambda k: bitmaps[k] != 0, len(bitmaps), gather_stream
    )


def compact_indices(bitmap: torch.Tensor) -> np.ndarray:
    """Device-side compaction of a nonzero bitmap into sorted int64 indices
    (count first, then an exact-size compaction; O(k) transfer)."""
    bits = bitmap != 0
    n = int(bits.sum())
    if n == 0:
        return np.empty(0, np.int64)
    return _compact(bits, n).cpu().numpy().astype(np.int64)


def packed_event_word(layout: GenomeLayout, target_id: np.ndarray,
                      start: np.ndarray, end: np.ndarray, flank_len: int,
                      gaps, device: torch.device) -> torch.Tensor:
    """The packed event word ``read_delta<<2 | gap_event<<1 | valid_event``
    of one read set, built on the device by one scatter (the reference's
    ``_packed_events_fn`` up to its scan)."""
    gs, ge, live = pack_read_deltas(layout, target_id, start, end, flank_len)
    gap_s, gap_e = gap_interval_events(layout, gaps)
    _check_disjoint(gap_s, gap_e)
    val_s, val_e = _valid_intervals(layout, flank_len)
    live4 = live << 2
    return scatter_events(DeviceDepth.pad_total_for(layout.total_slots), device, [
        (gs, live4), (ge, -live4), (gap_s, 2), (gap_e, -2), (val_s, 1), (val_e, -1),
    ])


# ---------------------------------------------------------------------------
# the resident-depth value
# ---------------------------------------------------------------------------

class DeviceDepth(ResidentDepth):
    """One read-type's whole-genome depth resident on one torch device.

    Drop-in value for the pipeline's depth dictionaries: gap masking,
    two-type max, interval collapse and checkpoint serialization stay on
    the device; issue intervals for the run's threshold come pre-extracted
    from the fused kernel pass.
    """

    def __init__(self, layout: GenomeLayout, array: torch.Tensor, pad_total: int,
                 gap_marks: torch.Tensor | None = None, gaps_src=None,
                 edge_cache=None, change_idx: np.ndarray | None = None,
                 gap_bit: int = 1):
        self.layout = layout
        self.array = array          # int32 (pad_total,) — current depth
        self.pad_total = pad_total
        self.gap_marks = gap_marks  # int8 gap indicator, shared per run
        self.gap_bit = gap_bit      # which bit of gap_marks means "in gap"
        self._gaps_src = gaps_src   # the gaps dict gap_marks was built from
        self._edge_cache: dict = dict(edge_cache or {})
        self._change_idx = change_idx  # run boundaries of self.array
        self._pending_masked_edges = None  # (key, intervals) valid post-mask
        self._events = None
        # host value lookup for to_events: sorted positions + values at
        # (change indices union target offsets), filled by the batched
        # readback so to_events needs no further device round-trips
        self._gather_pos: np.ndarray | None = None
        self._gather_vals: np.ndarray | None = None

    @property
    def device(self) -> torch.device:
        return self.array.device

    def _set_gather_map(self, change_idx, change_vals, offset_vals) -> None:
        pos = np.concatenate(
            [change_idx, np.asarray(self.layout.offsets[:-1], np.int64)]
        )
        vals = np.concatenate([change_vals, offset_vals])
        order = np.argsort(pos, kind="stable")
        self._gather_pos = pos[order]
        self._gather_vals = vals[order]

    # ------------------------------------------------------------ construct
    @staticmethod
    def pad_total_for(total: int) -> int:
        """Genome-axis size on the device: the kernels take any length, so
        there is no padding (the reference buckets sizes for TPU compiles)."""
        return total

    @staticmethod
    def gap_marks_for(layout: GenomeLayout, gaps, pad_total: int,
                      device: torch.device):
        """Device int8 flag bytes with only the gap bit (bit0) populated
        (None if no gaps) — built on device from O(gaps) scatter events."""
        starts, stops = gap_interval_events(layout, gaps)
        if starts.shape[0] == 0:
            return None
        empty = np.empty(0, np.int64)
        return _flags(pad_total, device, starts, stops, empty, empty)

    @classmethod
    def from_reads(
        cls,
        layout: GenomeLayout,
        target_id: np.ndarray,
        start: np.ndarray,
        end: np.ndarray,
        flank_len: int,
        gaps=None,
        issue_range: tuple[int, int] = (-1, 0),
        *,
        device: torch.device,
    ) -> "DeviceDepth":
        """One fused pass: depth + checkpoint run boundaries + issue edges.

        ``issue_range=(leftmost, rightmost]`` is the run's issue threshold;
        the edges the kernel extracts are of the *gap-masked* depth, so the
        resulting intervals become this object's cached issue BED once
        ``mask_gaps`` is applied (they are valid at once when there are no
        gaps).  Depth is bounded by the read count: below
        ``PACKED_DEPTH_LIMIT`` reads the packed word is scanned, else a
        plain delta under separate flag bytes.
        """
        if start.shape[0] < PACKED_DEPTH_LIMIT:
            # no local name for the word: _from_word frees it once it is scanned
            return cls._from_word(
                layout,
                packed_event_word(layout, target_id, start, end, flank_len, gaps, device),
                gaps, flank_len, issue_range,
            )
        pad_total = cls.pad_total_for(layout.total_slots)
        # the flags first: their transient prefix buffers then do not
        # coexist with the delta
        flags = flags_for(layout, gaps, flank_len, pad_total, device)
        gs, ge, live = pack_read_deltas(layout, target_id, start, end, flank_len)
        return cls._from_flags_scan(
            layout, scatter_events(pad_total, device, [(gs, live), (ge, -live)]),
            flags, gaps, flank_len, issue_range,
        )

    @classmethod
    def from_delta(
        cls,
        layout: GenomeLayout,
        delta: torch.Tensor,
        flank_len: int,
        gaps=None,
        issue_range: tuple[int, int] = (-1, 0),
    ) -> "DeviceDepth":
        """Like ``from_reads`` but on an already-accumulated int32 read delta
        on the device (the pack<->scatter overlap entry,
        ``overlap.DeltaAccumulator``).

        The value takes ownership of ``delta``: on the packed path the event
        word is built in it (``delta * 4`` plus the gap and scan-window
        events, in place), so no second genome-sized array exists, and it
        is freed once scanned if the caller holds no other reference.
        A read delta's depth is never negative and at most the sum of its
        positive entries; where that sum reaches ``PACKED_DEPTH_LIMIT`` the
        packed word could wrap, so the flags scan runs instead.
        """
        pad_total = int(delta.shape[0])
        if pad_total != cls.pad_total_for(layout.total_slots):
            raise ValueError(f"delta has {pad_total} slots, layout {layout.total_slots}")
        if int(delta.clamp(min=0).sum(dtype=torch.int64)) >= PACKED_DEPTH_LIMIT:
            flags = flags_for(layout, gaps, flank_len, pad_total, delta.device)
            return cls._from_flags_scan(layout, delta, flags, gaps, flank_len,
                                        issue_range)
        gap_s, gap_e = gap_interval_events(layout, gaps)
        _check_disjoint(gap_s, gap_e)
        val_s, val_e = _valid_intervals(layout, flank_len)
        scatter_events_into(delta.mul_(4), [
            (gap_s, 2), (gap_e, -2), (val_s, 1), (val_e, -1),
        ])
        lo, hi = issue_range
        raw, out_flags = fused_depth_scan_packed(delta, int(lo), int(hi))
        del delta
        return cls._from_packed_scan(layout, pad_total, raw, out_flags, gaps,
                                     flank_len, lo, hi)

    @classmethod
    def _from_word(cls, layout, word, gaps, flank_len, issue_range):
        lo, hi = issue_range
        raw, out_flags = fused_depth_scan_packed(word, int(lo), int(hi))
        pad_total = word.shape[0]
        del word
        return cls._from_packed_scan(layout, pad_total, raw, out_flags, gaps,
                                     flank_len, lo, hi)

    @classmethod
    def _from_packed_scan(cls, layout, pad_total, raw, out_flags, gaps,
                          flank_len, lo, hi):
        # the flag byte's bit3 is the gap mask, kept only when there are gaps
        has_gaps = gap_interval_events(layout, gaps)[0].shape[0] > 0
        return cls._from_kernel_outputs(
            layout, pad_total, raw, out_flags,
            out_flags if has_gaps else None, gaps, flank_len, lo, hi,
            gap_bit=8,
        )

    @classmethod
    def _from_flags_scan(cls, layout, delta, flags, gaps, flank_len, issue_range):
        """The flags scan of a plain read delta under ``flags_for`` bytes;
        the flags become the gap marks (bit0) when there are gaps."""
        lo, hi = issue_range
        raw, out_flags = fused_depth_scan_flags(delta, flags, int(lo), int(hi))
        pad_total = delta.shape[0]
        del delta
        has_gaps = gap_interval_events(layout, gaps)[0].shape[0] > 0
        return cls._from_kernel_outputs(
            layout, pad_total, raw, out_flags, flags if has_gaps else None,
            gaps, flank_len, lo, hi, gap_bit=1,
        )

    @classmethod
    def _from_kernel_outputs(cls, layout, pad_total, raw, out_flags,
                             gap_marks, gaps, flank_len, lo, hi,
                             gap_bit: int = 1):
        # one batched readback for all three edge bit-streams + run values
        # at the change indices and target offsets
        (rise_idx, fall_idx, change_idx), change_vals, offset_vals = (
            _batched_flags_readback(raw, layout, out_flags, (1, 2, 4), 2)
        )
        intervals = edge_indices_to_intervals(
            layout, rise_idx, fall_idx, flank_len
        )
        dd = cls(layout, raw, pad_total, gap_marks, gaps_src=gaps,
                 change_idx=change_idx, gap_bit=gap_bit)
        dd._set_gather_map(change_idx, change_vals, offset_vals)
        key = (float(lo), float(hi), int(flank_len))
        dd._pending_masked_edges = (key, intervals)
        if gap_marks is None:
            dd._edge_cache[key] = intervals
        return dd

    @classmethod
    def from_state(cls, layout: GenomeLayout, array, gap_marks=None,
                   gap_bit: int = 1, *, device: torch.device,
                   gaps_src=None) -> "DeviceDepth":
        """A value from host arrays of resident state, e.g.
        ``np.asarray(jax_dd.array)`` and ``np.asarray(jax_dd.gap_marks)``.

        Slots past the layout (another backend's padding) must be zero and
        are dropped.  Run boundaries and edges are recomputed on demand.
        """
        pad_total = cls.pad_total_for(layout.total_slots)

        def load(a, dtype):
            a = np.asarray(a, dtype)
            if a.shape[0] < pad_total or a[pad_total:].any():
                raise ValueError(
                    f"state of {a.shape[0]} slots does not fit a layout of "
                    f"{pad_total} (or its padding is not zero)"
                )
            return torch.tensor(a[:pad_total], device=device)

        marks = None if gap_marks is None else load(gap_marks, np.int8)
        return cls(layout, load(array, np.int32), pad_total, marks,
                   gaps_src=gaps_src, gap_bit=gap_bit)

    # ------------------------------------------------------------------ ops
    def mask_gaps(self, gaps) -> "DeviceDepth":
        """Zero depth over N-gap intervals, on device (GCI.py:315-329)."""
        if not gaps:
            return self
        marks = self.gap_marks
        gap_bit = self.gap_bit
        pending = self._pending_masked_edges
        if marks is None or gaps is not self._gaps_src:
            marks = self.gap_marks_for(self.layout, gaps, self.pad_total, self.device)
            gap_bit = 1
            if marks is None:
                return self
            pending = None  # kernel edges were computed under different gaps
        arr = _mask(self.array, marks, gap_bit)
        cache = {pending[0]: pending[1]} if pending is not None else {}
        return DeviceDepth(self.layout, arr, self.pad_total, marks,
                           gaps_src=gaps, edge_cache=cache, gap_bit=gap_bit)

    def maximum(self, other: "DeviceDepth") -> "DeviceDepth":
        """Per-base two-type max, on device (GCI.py:332-353)."""
        if self.pad_total != other.pad_total:
            raise ValueError("two-type max of depths over different layouts")
        return DeviceDepth(
            self.layout, torch.maximum(self.array, other.array), self.pad_total,
            self.gap_marks, gaps_src=self._gaps_src, gap_bit=self.gap_bit,
        )

    def collapse_dict(
        self,
        leftmost: float = -1,
        rightmost: float = 0,
        flank_len: int = 15,
        start_pos: int = 0,
    ) -> dict[str, list[tuple[int, int]]]:
        """Issue intervals (GCI.py:356-390): cached from the fused kernel
        pass when the query matches the run threshold, else one edge pass +
        O(edges) compaction."""
        key = (float(leftmost), float(rightmost), int(flank_len))
        if start_pos == 0 and key in self._edge_cache:
            return self._edge_cache[key]
        valid = valid_marks_for(self.layout, flank_len, self.pad_total, self.device)
        rise, fall = _edges(self.array, valid, int(leftmost), int(rightmost))
        del valid
        (rise_idx, fall_idx), _, _ = _batched_edge_readback(
            self.array, self.layout, (rise, fall), 0
        )
        out = edge_indices_to_intervals(
            self.layout, rise_idx, fall_idx, flank_len, start_pos,
        )
        if start_pos == 0:
            self._edge_cache[key] = out
        return out

    # ------------------------------------------------------------ host view
    def to_events(self):
        """O(runs) host view: {target: DepthEvents} (checkpoint, regions,
        plotting).  Run boundaries come straight from the fused kernel when
        available; values from the same batched readback."""
        if self._events is not None:
            return self._events
        if self._change_idx is None or self._gather_pos is None:
            # masked/merged objects: recompute run boundaries with the same
            # batched readback the construction path uses
            change = run_boundaries(self.array)
            (self._change_idx,), change_vals, offset_vals = (
                _batched_edge_readback(self.array, self.layout, (change,), 0)
            )
            del change
            self._set_gather_map(self._change_idx, change_vals, offset_vals)

        def gather(all_idx: np.ndarray) -> np.ndarray:
            # all_idx ⊆ change indices ∪ target offsets — both already on
            # host from the packed readback; no device round-trip
            j = np.searchsorted(self._gather_pos, all_idx)
            return self._gather_vals[j]

        self._events = events_from_change_indices(
            self.layout, self._change_idx, gather
        )
        return self._events

    def materialize_dict(self) -> dict[str, np.ndarray]:
        """Per-target per-base arrays (tests/oracles only — O(genome) host)."""
        flat = self.array[: self.layout.total_slots].cpu().numpy()
        return depth_dict_from_flat(self.layout, flat)
