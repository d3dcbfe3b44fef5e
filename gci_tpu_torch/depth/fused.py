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
and issue edges are compacted on the device by the stream-compaction kernel
(``scan.compact_flags`` over the flag byte, ``scan.compact_runs`` over a
depth), then read back in one transfer.  The reference compacts with a prefix
sum and ``searchsorted``, to power-of-two sizes; the counts here are exact.
Each compaction gets a capacity from what built its input: a run boundary
or an edge falls only where a scatter row landed (a read end, a gap border,
a scan-window border) or at slot 0, so those rows plus one bound it
(``DeviceDepth.change_bound`` carries the bound through mask and max); a
bound that would size buffers of more than an eighth of a byte a slot
counts first instead (``scan.capacity_for``).

Plain XLA ops of the reference are plain torch ops here: the scatter-add,
``where``, ``maximum`` and gathers.  The torch
device is explicit: every constructor takes it, and every value keeps its
tensors there.
"""
from __future__ import annotations

import numpy as np
import torch

from gci_tpu_torch.depth.accum import GenomeLayout, depth_dict_from_flat
from gci_tpu_torch.depth.base import (
    ResidentDepth,
    events_from_boundaries,
    gap_interval_events,
)
from gci_tpu_torch.depth.device import (
    _local_prefix_sum,
    _to_host,
    edge_indices_to_intervals,
    pack_read_deltas,
    scatter_events,
    scatter_events_into,
)
from gci_tpu_torch.depth.scan import (
    capacity_for,
    compact_flags,
    compact_runs,
    fused_depth_scan_flags,
    fused_depth_scan_packed,
    rise_fall,
)
from gci_tpu_torch.utils.metrics import count, span

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


def _edges(depth: torch.Tensor, valid: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Edge bytes of the issue mask (``_elementwise_fns``): bit0 rise, bit1
    fall, so one compaction reads both."""
    rise, fall = rise_fall((depth > lo) & (depth <= hi) & ((valid & 2) != 0))
    return rise.view(torch.int8) + fall.view(torch.int8) * 2


def _flags(total: int, device: torch.device, gap_s, gap_e, val_s, val_e):
    """Flag bytes: bit0 in-gap, bit1 scan-window valid, from O(intervals)
    scatters and two device prefix sums (the reference's ``_flags_fn``)."""
    gd = scatter_events(total, device, [(gap_s, 1), (gap_e, -1)])
    out = (_local_prefix_sum(gd) > 0).to(torch.int8)
    del gd
    vd = scatter_events(total, device, [(val_s, 1), (val_e, -1)])
    out += (_local_prefix_sum(vd) > 0).to(torch.int8) * 2
    return out


def flags_for(layout: GenomeLayout, gaps, flank_len: int, total: int,
              device: torch.device) -> torch.Tensor:
    """Device int8 flag bytes: bit0 = in-N-gap, bit1 = scan-window valid."""
    gap_s, gap_e = gap_interval_events(layout, gaps)
    val_s, val_e = _valid_intervals(layout, flank_len)
    return _flags(total, device, gap_s, gap_e, val_s, val_e)


def valid_marks_for(layout: GenomeLayout, flank_len: int, total: int,
                    device: torch.device) -> torch.Tensor:
    """Device int8 flag bytes with only the valid bit (bit1) populated."""
    return flags_for(layout, None, flank_len, total, device)


def _batched_flags_readback(array, flags, masks: tuple, gather_stream: int,
                            capacity: int | None = None):
    """One compaction of the bit-masks of one flag byte array (the kernel's
    rise/fall/change output; ``capacity``, a bound on each count, sizes its
    buffers through ``capacity_for``), then ``array`` at the gather
    stream's indices, all read back in one transfer.  Counts are exact (the
    reference pads them to powers of two for static XLA shapes).  Returns
    (list of int64 index arrays, gathered values)."""
    with span("fused.readback"):
        idx = compact_flags(flags, masks, capacity_for(capacity, flags.shape[0], len(masks)))
        *out_idx, gathered = _to_host(idx + [array[idx[gather_stream]]])
    return out_idx, gathered


def _runs_readback(array, capacity: int | None = None):
    """(run-boundary indices, the depth of each run) as int64 host arrays:
    one run-form compaction (``capacity`` bounds its count, as in
    ``_batched_flags_readback``), one transfer."""
    idx, vals = compact_runs(array, None, capacity_for(capacity, array.shape[0], 1, True))
    return tuple(_to_host([idx, vals]))


def compact_indices(bitmap: torch.Tensor) -> np.ndarray:
    """Device-side compaction of a nonzero bitmap into sorted int64 indices
    (one exact-size compaction; O(k) transfer, counted in
    ``copies.d2h_bytes`` from a CUDA device)."""
    if bitmap.dtype in (torch.bool, torch.int8, torch.uint8):
        x, mask = bitmap.view(torch.int8), 0xFF
    else:
        x, mask = (bitmap != 0).view(torch.int8), 1
    (idx,) = compact_flags(x, (mask,))
    if idx.is_cuda:
        count("copies.d2h_bytes", idx.nbytes)
    return idx.cpu().numpy()


def _event_rows(layout: GenomeLayout, n_reads: int, gaps, flank_len: int) -> int:
    """Rows of the scatters that build a read set's flag byte: a start and
    a stop for each read, gap interval and scan window.  Its run boundaries
    and edges fall only on those rows' slots or at slot 0."""
    n_gaps = gap_interval_events(layout, gaps)[0].shape[0]
    return 2 * (n_reads + n_gaps + len(_valid_intervals(layout, flank_len)[0]))


def _scatter(total: int, device: torch.device, events) -> torch.Tensor:
    """``scatter_events`` in the span ``fused.scatter``."""
    with span("fused.scatter"):
        return scatter_events(total, device, events)


def packed_event_word(layout: GenomeLayout, target_id: np.ndarray,
                      start: np.ndarray, end: np.ndarray, flank_len: int,
                      gaps, device: torch.device) -> torch.Tensor:
    """The packed event word ``read_delta<<2 | gap_event<<1 | valid_event``
    of one read set, built on the device by one scatter (the reference's
    ``_packed_events_fn`` up to its scan).  Spans ``fused.pack`` (the host
    pack) and ``fused.scatter``."""
    with span("fused.pack"):
        gs, ge, live = pack_read_deltas(layout, target_id, start, end, flank_len)
        gap_s, gap_e = gap_interval_events(layout, gaps)
        _check_disjoint(gap_s, gap_e)
        val_s, val_e = _valid_intervals(layout, flank_len)
        live4 = live << 2
    return _scatter(layout.total_slots, device, [
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

    def __init__(self, layout: GenomeLayout, array: torch.Tensor,
                 gap_marks: torch.Tensor | None = None, gaps_src=None,
                 edge_cache=None, runs: tuple | None = None,
                 gap_bit: int = 1, change_bound: int | None = None):
        self.layout = layout
        self.array = array          # int32 (layout.total_slots,) — current depth
        # at most this many run boundaries of array (slot 0 included), the
        # capacity of its compactions; None where not known
        self.change_bound = change_bound
        self.gap_marks = gap_marks  # int8 gap indicator, shared per run
        self.gap_bit = gap_bit      # which bit of gap_marks means "in gap"
        self._gaps_src = gaps_src   # the gaps dict gap_marks was built from
        self._edge_cache: dict = dict(edge_cache or {})
        # (run-boundary slots, the depth of each run) of self.array, int64
        # host arrays; None until read back
        self._runs = runs
        self._pending_masked_edges = None  # (key, intervals) valid post-mask
        self._events = None

    @property
    def device(self) -> torch.device:
        return self.array.device

    # ------------------------------------------------------------ construct
    @staticmethod
    def gap_marks_for(layout: GenomeLayout, gaps, total: int,
                      device: torch.device):
        """Device int8 flag bytes with only the gap bit (bit0) populated
        (None if no gaps) — built on device from O(gaps) scatter events."""
        starts, stops = gap_interval_events(layout, gaps)
        if starts.shape[0] == 0:
            return None
        empty = np.empty(0, np.int64)
        return _flags(total, device, starts, stops, empty, empty)

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

        The whole is the span ``fused.build``; inside it ``fused.pack``,
        ``fused.scatter``, ``fused.scan``, ``fused.readback`` and
        ``fused.intervals``.  The counter ``fused.boundaries`` adds the run
        boundaries read back (slot 0 included).
        """
        with span("fused.build"):
            rows = _event_rows(layout, start.shape[0], gaps, flank_len)
            if start.shape[0] < PACKED_DEPTH_LIMIT:
                # no local name for the word: _from_word frees it once it is scanned
                return cls._from_word(
                    layout,
                    packed_event_word(layout, target_id, start, end, flank_len, gaps, device),
                    gaps, flank_len, issue_range, rows,
                )
            # the flags first: their transient prefix buffers then do not
            # coexist with the delta
            with span("fused.scatter"):
                flags = flags_for(layout, gaps, flank_len, layout.total_slots, device)
            with span("fused.pack"):
                gs, ge, live = pack_read_deltas(layout, target_id, start, end, flank_len)
            return cls._from_flags_scan(
                layout, _scatter(layout.total_slots, device, [(gs, live), (ge, -live)]),
                flags, gaps, flank_len, issue_range, rows,
            )

    @classmethod
    def from_delta(
        cls,
        layout: GenomeLayout,
        delta: torch.Tensor,
        flank_len: int,
        gaps=None,
        issue_range: tuple[int, int] = (-1, 0),
        rows: int | None = None,
    ) -> "DeviceDepth":
        """Like ``from_reads`` but on an already-accumulated int32 read delta
        on the device (the pack<->scatter overlap entry,
        ``overlap.DeltaAccumulator``).  ``rows`` is the number of scatter
        rows that built it (``DeltaAccumulator.rows``), which bounds its
        compactions; without it they count before they write.

        The value takes ownership of ``delta``: on the packed path the event
        word is built in it (``delta * 4`` plus the gap and scan-window
        events, in place), so no second genome-sized array exists, and it
        is freed once scanned if the caller holds no other reference.
        A read delta's depth is never negative and at most the sum of its
        positive entries; where that sum reaches ``PACKED_DEPTH_LIMIT`` the
        packed word could wrap, so the flags scan runs instead.  Spans as
        in ``from_reads``, with no ``fused.pack``.
        """
        if delta.shape[0] != layout.total_slots:
            raise ValueError(f"delta has {delta.shape[0]} slots, layout {layout.total_slots}")
        if rows is not None:
            rows += _event_rows(layout, 0, gaps, flank_len)
        with span("fused.build"):
            if int(delta.clamp(min=0).sum(dtype=torch.int64)) >= PACKED_DEPTH_LIMIT:
                with span("fused.scatter"):
                    flags = flags_for(layout, gaps, flank_len, layout.total_slots, delta.device)
                return cls._from_flags_scan(layout, delta, flags, gaps, flank_len,
                                            issue_range, rows)
            gap_s, gap_e = gap_interval_events(layout, gaps)
            _check_disjoint(gap_s, gap_e)
            val_s, val_e = _valid_intervals(layout, flank_len)
            with span("fused.scatter"):
                scatter_events_into(delta.mul_(4), [
                    (gap_s, 2), (gap_e, -2), (val_s, 1), (val_e, -1),
                ])
            lo, hi = issue_range
            with span("fused.scan"):
                raw, out_flags = fused_depth_scan_packed(delta, int(lo), int(hi))
            del delta
            return cls._from_packed_scan(layout, raw, out_flags, gaps, flank_len, lo, hi, rows)

    @classmethod
    def _from_word(cls, layout, word, gaps, flank_len, issue_range, rows):
        lo, hi = issue_range
        with span("fused.scan"):
            raw, out_flags = fused_depth_scan_packed(word, int(lo), int(hi))
        del word
        return cls._from_packed_scan(layout, raw, out_flags, gaps, flank_len, lo, hi, rows)

    @classmethod
    def _from_packed_scan(cls, layout, raw, out_flags, gaps, flank_len, lo, hi, rows):
        # the flag byte's bit3 is the gap mask, kept only when there are gaps
        has_gaps = gap_interval_events(layout, gaps)[0].shape[0] > 0
        return cls._from_kernel_outputs(
            layout, raw, out_flags,
            out_flags if has_gaps else None, gaps, flank_len, lo, hi, rows,
            gap_bit=8,
        )

    @classmethod
    def _from_flags_scan(cls, layout, delta, flags, gaps, flank_len, issue_range, rows):
        """The flags scan of a plain read delta under ``flags_for`` bytes;
        the flags become the gap marks (bit0) when there are gaps."""
        lo, hi = issue_range
        with span("fused.scan"):
            raw, out_flags = fused_depth_scan_flags(delta, flags, int(lo), int(hi))
        del delta
        has_gaps = gap_interval_events(layout, gaps)[0].shape[0] > 0
        return cls._from_kernel_outputs(
            layout, raw, out_flags, flags if has_gaps else None,
            gaps, flank_len, lo, hi, rows, gap_bit=1,
        )

    @classmethod
    def _from_kernel_outputs(cls, layout, raw, out_flags, gap_marks, gaps,
                             flank_len, lo, hi, rows, gap_bit: int = 1):
        # one batched readback for all three edge bit-streams + run values
        # at the change indices, which with them are the run form; a bit of
        # the flag byte is set only where the word or delta and flags got a
        # scatter row, or at slot 0: ``rows`` + 1 bounds each stream
        (rise_idx, fall_idx, change_idx), change_vals = _batched_flags_readback(
            raw, out_flags, (1, 2, 4), 2, None if rows is None else rows + 1)
        count("fused.boundaries", change_idx.shape[0])
        with span("fused.intervals"):
            intervals = edge_indices_to_intervals(
                layout, rise_idx, fall_idx, flank_len
            )
            dd = cls(layout, raw, gap_marks, gaps_src=gaps,
                     runs=(change_idx, change_vals), gap_bit=gap_bit,
                     change_bound=change_idx.shape[0])
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
        total = layout.total_slots

        def load(a, dtype):
            a = np.asarray(a, dtype)
            if a.shape[0] < total or a[total:].any():
                raise ValueError(
                    f"state of {a.shape[0]} slots does not fit a layout of "
                    f"{total} (or its padding is not zero)"
                )
            return torch.tensor(a[:total], device=device)

        marks = None if gap_marks is None else load(gap_marks, np.int8)
        return cls(layout, load(array, np.int32), marks,
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
            marks = self.gap_marks_for(self.layout, gaps, self.array.shape[0], self.device)
            gap_bit = 1
            if marks is None:
                return self
            pending = None  # kernel edges were computed under different gaps
        arr = _mask(self.array, marks, gap_bit)
        cache = {pending[0]: pending[1]} if pending is not None else {}
        # a boundary of the masked depth is one of the depth's or a gap border
        bound = self.change_bound
        if bound is not None:
            bound += 2 * gap_interval_events(self.layout, gaps)[0].shape[0]
        return DeviceDepth(self.layout, arr, marks,
                           gaps_src=gaps, edge_cache=cache, gap_bit=gap_bit,
                           change_bound=bound)

    def maximum(self, other: "DeviceDepth") -> "DeviceDepth":
        """Per-base two-type max, on device (GCI.py:332-353); span
        ``merge.max``."""
        if self.array.shape[0] != other.array.shape[0]:
            raise ValueError("two-type max of depths over different layouts")
        # a boundary of the max is a boundary of either depth
        bound = (None if self.change_bound is None or other.change_bound is None
                 else self.change_bound + other.change_bound)
        with span("merge.max"):
            return DeviceDepth(
                self.layout, torch.maximum(self.array, other.array),
                self.gap_marks, gaps_src=self._gaps_src, gap_bit=self.gap_bit,
                change_bound=bound,
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
        valid = valid_marks_for(self.layout, flank_len, self.array.shape[0], self.device)
        edges = _edges(self.array, valid, int(leftmost), int(rightmost))
        del valid
        # an edge falls on a run boundary or on a scan-window border
        bound = self.change_bound
        if bound is not None:
            bound += _event_rows(self.layout, 0, None, flank_len)
        rise_idx, fall_idx = _to_host(compact_flags(
            edges, (1, 2), capacity_for(bound, edges.shape[0], 2)))
        del edges
        out = edge_indices_to_intervals(
            self.layout, rise_idx, fall_idx, flank_len, start_pos,
        )
        if start_pos == 0:
            self._edge_cache[key] = out
        return out

    # ------------------------------------------------------------ host view
    def to_events(self):
        """O(runs) host view: {target: DepthEvents} (checkpoint, regions,
        plotting), from the run form: the fused kernel's change bit and the
        depth of each run when the value came from a scan, else one run-form
        compaction.  The span ``checkpoint.runs``, where the events are not
        cached yet."""
        if self._events is not None:
            return self._events
        with span("checkpoint.runs"):
            if self._runs is None:
                # masked, merged and from_state values
                self._runs = _runs_readback(self.array, self.change_bound)
                self.change_bound = self._runs[0].shape[0]
            self._events = events_from_boundaries(self.layout, *self._runs)
        return self._events

    def materialize_dict(self) -> dict[str, np.ndarray]:
        """Per-target per-base arrays (tests/oracles only — O(genome) host)."""
        flat = self.array[: self.layout.total_slots].cpu().numpy()
        return depth_dict_from_flat(self.layout, flat)
