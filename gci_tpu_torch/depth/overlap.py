"""Pack <-> device-scatter overlap for the one-BAM, no-PAF read type.

Counterpart of ``gci_tpu/depth/overlap.py``.  With one BAM per read type and
no PAF, curation is an identity fold, so the last-wins name dedup can fold
chunk by chunk: a record whose name already appeared retracts the stored
record's interval (-1) and adds its own (+1), and the running sum equals the
scatter of the final last-wins survivors exactly, because integer
scatter-adds commute.  Each packed BAM chunk's deltas go to the card (an
asynchronous ``index_add_``) while the native producer inflates the next.

* ``DeltaAccumulator``: a resident int32 delta of exactly ``total_slots``
  for ``DeviceDepth.from_delta``;
* ``SweepAccumulator``: a coordinate sweep over ``streamed`` chunks, which
  scans and frees each genome chunk that a coordinate-sorted BAM has
  passed while the next BAM chunk inflates;
* ``feed_bam``: the pack loop that feeds either from one BAM.

``pipeline.run_filter`` does not take this path: on the H100 it was slower
than the depth of the curated reads in every case measured (PERF.md), so
only the tests and ``chip_smoke.py`` run it, against that path.

Only live rows are scattered, at exact indices: torch's ``index_add_`` has
no ``mode="drop"``, so neither the reference's power-of-two padding of the
event arrays nor its out-of-range drop sentinels exist here, and the
host range check of ``device.scatter_events_into`` holds for every index.
``index_add_`` adds in place, so the reference's buffer donation has no
counterpart.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from gci_tpu_torch.depth import streamed
from gci_tpu_torch.depth.accum import GenomeLayout, clamp_read_intervals
from gci_tpu_torch.depth.device import scatter_events_into
from gci_tpu_torch.depth.scan import depth_scan
from gci_tpu_torch.depth.streamed import chunk_runs, events_from_runs
from gci_tpu_torch.filters import bam_filter_mask, dedup_last_wins
from gci_tpu_torch.io.bam import BamStream
from gci_tpu_torch.io.names import keys_view


class LastWinsFold:
    """Incremental last-wins name dedup across packed chunks.

    Chunks arrive in file order, already deduped *within* the chunk.  For
    each chunk, returns the rows that a record in this chunk replaces (the
    currently-live record of the same name from an earlier chunk); those
    rows' intervals are retracted from the device delta.  Membership tests
    run against per-chunk sorted "pockets" (no global re-sort per chunk).
    """

    def __init__(self) -> None:
        # per pocket: (sorted void16 keys, rows (n, 3) int64, alive mask)
        self._pockets: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def fold(
        self, kv: np.ndarray, tid: np.ndarray, start: np.ndarray,
        end: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fold one chunk; returns (tid, start, end) rows to retract.

        ``kv`` is the chunk's void16 key view (unique within the chunk).
        """
        retract: list[np.ndarray] = []
        if kv.shape[0]:
            for keys, rows, alive in self._pockets:
                pos = np.searchsorted(keys, kv)
                posc = np.minimum(pos, keys.shape[0] - 1)
                hit = (keys[posc] == kv) & alive[posc]
                if hit.any():
                    h = posc[hit]
                    retract.append(rows[h])
                    alive[h] = False
            order = np.argsort(kv)
            rows = np.stack(
                [tid.astype(np.int64), start.astype(np.int64),
                 end.astype(np.int64)], axis=1,
            )[order]
            self._pockets.append(
                (kv[order], rows, np.ones(kv.shape[0], dtype=bool))
            )
        if retract:
            r = np.concatenate(retract)
            return r[:, 0], r[:, 1], r[:, 2]
        e = np.empty(0, np.int64)
        return e, e, e


def _global_intervals(layout: GenomeLayout, flank_len: int, tid, start, end):
    """Clamped int64 global [gs, ge) slots per row (``ge <= gs``: no depth)."""
    s, e = clamp_read_intervals(layout, tid, start, end, flank_len)
    base = layout.offsets[tid]
    return base + s, base + e


class _Folding:
    """An accumulator's last-wins fold and its counts: BAM chunks folded,
    rows retracted, and host seconds spent in the fold."""

    def __init__(self) -> None:
        self._fold = LastWinsFold()
        self.chunks_added = 0
        self.rows_retracted = 0
        self.fold_seconds = 0.0

    def _fold_chunk(self, kv, tid, start, end):
        t0 = time.perf_counter()
        rows = self._fold.fold(kv, tid, start, end)
        self.fold_seconds += time.perf_counter() - t0
        self.chunks_added += 1
        self.rows_retracted += int(rows[0].shape[0])
        return rows


class DeltaAccumulator(_Folding):
    """Device-resident int32 read delta of exactly ``layout.total_slots``
    slots (the length ``DeviceDepth.from_delta`` takes), fed one packed BAM
    chunk at a time.  Each chunk is one ``index_add_`` (its retractions and
    additions together), queued on the card while the host goes back to
    inflating and filtering the next chunk.
    """

    def __init__(self, layout: GenomeLayout, flank_len: int, *, device: torch.device):
        super().__init__()
        self.layout = layout
        self.flank_len = flank_len
        self.delta = torch.zeros(layout.total_slots, dtype=torch.int32, device=device)

    def add_chunk(self, kv, tid, start, end) -> None:
        """Fold one packed chunk (unique names within the chunk) into the
        resident delta: retract replaced records, add the new ones."""
        retract = self._fold_chunk(kv, tid, start, end)
        events = []
        for rows, sign in ((retract, -1), ((tid, start, end), 1)):
            gs, ge = _global_intervals(self.layout, self.flank_len, *rows)
            live = ge > gs
            events += [(gs[live], sign), (ge[live], -sign)]
        scatter_events_into(self.delta, events)

    def take_delta(self) -> torch.Tensor:
        """The accumulated delta; the accumulator lets go of it, so the
        caller owns it (pass it straight to ``from_delta``, which builds its
        event word in it)."""
        delta, self.delta = self.delta, None
        return delta


def _adjust_range(idx: np.ndarray, vals: np.ndarray, a: int, b: int,
                  dv: int, insert_a: bool, val_at_a: int,
                  insert_b: bool, val_at_b: int):
    """Event-space fixup: depth += ``dv`` over [a, b) applied to one
    finalized chunk's (global idx, vals) run-boundary lists.

    Runs with boundaries in [a, b) shift by ``dv``.  ``insert_a`` adds a
    boundary at ``a`` (value ``val_at_a + dv``) — needed only for the
    range START's chunk (continuation chunks inherit the shifted value
    from the previous chunk's last event).  ``insert_b`` adds a boundary
    at ``b`` (original value ``val_at_b``) — needed only when the range
    ends strictly inside this chunk.  Both prevailing values are resolved
    by the caller BEFORE any modification.  Retro fixups are rare, so
    per-call O(runs-in-chunk) is fine.
    """
    lo = np.searchsorted(idx, a, side="left")
    hi = np.searchsorted(idx, b, side="left")
    new_idx = [idx[:lo]]
    new_vals = [vals[:lo]]
    if insert_a and (lo == idx.shape[0] or idx[lo] != a):
        new_idx.append(np.asarray([a], np.int64))
        new_vals.append(np.asarray([val_at_a + dv], np.int64))
    new_idx.append(idx[lo:hi])
    new_vals.append(vals[lo:hi] + dv)
    if insert_b and (hi == idx.shape[0] or idx[hi] != b):
        new_idx.append(np.asarray([b], np.int64))
        new_vals.append(np.asarray([val_at_b], np.int64))
    new_idx.append(idx[hi:])
    new_vals.append(vals[hi:])
    return np.concatenate(new_idx), np.concatenate(new_vals)


class SweepAccumulator(_Folding):
    """Coordinate-sweep pack <-> scan overlap for the streamed backend.

    A coordinate-sorted BAM visits the concatenated genome axis in order,
    so only the genome chunks near the read frontier need a live device
    delta: once every future read starts past a chunk's end, the chunk is
    final, and its scan and run-boundary compaction (``depth_scan`` and
    ``streamed.chunk_runs``) run at once, while the native producer
    inflates the next BAM chunk, and its buffer frees.  Device memory is
    O(live chunks) at any genome size.  Chunks have ``chunk_slots`` slots
    (``streamed.CHUNK_SLOTS`` unless given), and each chunk's buffer has the
    chunk's own length (the last one ``total - a``).

    Last-wins retraction: a re-appearing read name retracts the stored
    record as a -1 range update, split at the finalization frontier: the
    live part scatters like any delta, the (rare) finalized part is an
    exact event-space fixup on the already-compacted runs.  An unsorted
    input stops early finalization for good once a BAM chunk starts before
    an earlier one: the chunks not yet final stay live until ``finish``
    (heavier on memory), and a row behind the frontier becomes a fixup
    (one host pass over the runs of each finalized chunk it covers).
    """

    def __init__(self, layout: GenomeLayout, flank_len: int,
                 chunk_slots: int | None = None, *, device: torch.device):
        super().__init__()
        self.layout = layout
        self.flank_len = flank_len
        self.device = device
        self.total = layout.total_slots
        chunk = streamed.CHUNK_SLOTS if chunk_slots is None else int(chunk_slots)
        if not 0 < chunk < 2**31:
            raise ValueError(f"chunk of {chunk} slots: expected 1 to {2**31 - 1}")
        self.chunk_slots = min(chunk, self.total)
        self.n_chunks = -(-self.total // self.chunk_slots)
        self._live: dict[int, torch.Tensor] = {}  # chunk -> device delta
        self._chunk_events: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.frontier = 0  # first chunk not finalized
        self._carry = 0    # depth at the last slot before the frontier
        self._max_seen_start = -1
        self._unsorted = False

    # ------------------------------------------------------------- internals
    def _bounds(self, c: int) -> tuple[int, int]:
        a = c * self.chunk_slots
        return a, min(a + self.chunk_slots, self.total)

    def _chunk_buf(self, c: int) -> torch.Tensor:
        buf = self._live.get(c)
        if buf is None:
            a, b = self._bounds(c)
            buf = torch.zeros(b - a, dtype=torch.int32, device=self.device)
            self._live[c] = buf
        return buf

    def _scatter_points(self, pos: np.ndarray, val: np.ndarray) -> None:
        """Scatter point deltas (global positions) into live chunk buffers,
        one ``index_add_`` per chunk touched."""
        if pos.shape[0] == 0:
            return
        c_of = pos // self.chunk_slots
        order = np.argsort(c_of, kind="stable")
        pos, val, c_of = pos[order], val[order], c_of[order]
        bounds = np.flatnonzero(np.concatenate(([True], c_of[1:] != c_of[:-1])))
        bounds = np.append(bounds, pos.shape[0])
        for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
            c = int(c_of[lo])
            scatter_events_into(self._chunk_buf(c),
                                [(pos[lo:hi] - c * self.chunk_slots, val[lo:hi])])

    def _range_update(self, gs: np.ndarray, ge: np.ndarray, sign: int) -> None:
        """Apply depth ``sign`` over [gs, ge) per row, split at the
        finalization frontier."""
        live_from = self.frontier * self.chunk_slots
        keep = ge > gs
        gs, ge = gs[keep], ge[keep]
        if gs.shape[0] == 0:
            return
        # finalized portion (retraction rows, or on an unsorted input a
        # late-arriving add, reaching behind the frontier)
        back = gs < live_from
        for s, e in zip(gs[back].tolist(), np.minimum(ge[back], live_from).tolist()):
            self._fixup_finalized(s, e, sign)
        # live portion: ordinary point deltas, clipped at the frontier
        ls = np.maximum(gs, live_from)
        le = ge
        live_rows = le > ls
        n = int(live_rows.sum())
        pos = np.concatenate([ls[live_rows], le[live_rows]])
        val = np.concatenate([np.full(n, sign, np.int32), np.full(n, -sign, np.int32)])
        inside = pos < self.total  # a stop at the axis end adds nothing
        self._scatter_points(pos[inside], val[inside])

    def _value_at(self, p: int) -> int:
        """Prevailing finalized depth value at global slot ``p`` (the last
        run boundary at or before ``p``, searching back through chunks)."""
        c = int(p // self.chunk_slots)
        while c >= 0:
            ev = self._chunk_events.get(c)
            if ev is not None and ev[0].shape[0]:
                idx, vals = ev
                j = np.searchsorted(idx, p, side="right") - 1
                if j >= 0:
                    return int(vals[j])
            c -= 1
        return 0  # before the forced boundary at slot 0 (cannot happen)

    def _fixup_finalized(self, a: int, b: int, sign: int) -> None:
        """Depth += ``sign`` over the finalized range [a, b).

        The live continuation of the range (>= frontier) is handled by the
        caller's scatter (its boundary delta sits at the frontier), so the
        carry needs no adjustment here.  Prevailing values at both
        endpoints are resolved before any event list is modified.
        """
        val_at_a = self._value_at(a)
        val_at_b = self._value_at(b)  # original value where the range ends
        c0 = a // self.chunk_slots
        c1 = min((b - 1) // self.chunk_slots, self.frontier - 1)
        for c in range(int(c0), int(c1) + 1):
            clo, chi = self._bounds(c)
            ra, rb = max(a, clo), min(b, chi)
            if rb <= ra:
                continue
            idx, vals = self._chunk_events.get(
                c, (np.empty(0, np.int64), np.empty(0, np.int64))
            )
            idx, vals = _adjust_range(
                idx, vals, ra, rb, sign,
                insert_a=(ra == a), val_at_a=val_at_a,
                insert_b=(rb == b and rb < chi), val_at_b=val_at_b,
            )
            self._chunk_events[c] = (idx, vals)

    def _finalize_through(self, min_future_start: int) -> None:
        """Finalize every chunk wholly before ``min_future_start``."""
        while (
            self.frontier < self.n_chunks
            and (self.frontier + 1) * self.chunk_slots <= min_future_start
        ):
            self._finalize_one()

    def _finalize_one(self) -> None:
        """Scan the frontier chunk and compact its run boundaries: the carry
        at its slot 0, the int32 scan, the boundary bitmap seeded with the
        carry and its int8 scan, then one readback.  The next carry is the
        depth at the chunk's last slot, the value of its last run."""
        c = self.frontier
        a, b = self._bounds(c)
        delta = self._live.pop(c, None)
        if delta is None:
            delta = torch.zeros(b - a, dtype=torch.int32, device=self.device)
        delta[:1] += self._carry  # one more event at the chunk's slot 0
        depth = depth_scan(delta)
        del delta
        idx, vals = chunk_runs(depth, a, self._carry)
        del depth
        if idx.shape[0]:
            self._chunk_events[c] = (idx, vals)
            self._carry = int(vals[-1])
        self.frontier += 1

    # ------------------------------------------------------------------ API
    def add_chunk(self, kv, tid, start, end) -> None:
        """Fold one packed chunk (unique names within the chunk), scatter
        its deltas, finalize and scan every chunk the sweep has passed."""
        retract = self._fold_chunk(kv, tid, start, end)
        if retract[0].shape[0]:
            self._range_update(
                *_global_intervals(self.layout, self.flank_len, *retract), -1
            )
        gs, ge = _global_intervals(self.layout, self.flank_len, tid, start, end)
        self._range_update(gs, ge, +1)
        live = ge > gs
        if live.any():
            batch_min = int(gs[live].min())
            if batch_min < self._max_seen_start:
                # unsorted input: stop finalizing early, for good; the
                # chunks not yet final stay live until finish()
                self._unsorted = True
            self._max_seen_start = max(self._max_seen_start, batch_min)
            if not self._unsorted:
                self._finalize_through(batch_min)

    def finish(self):
        """Finalize the tail and assemble {target: DepthEvents}."""
        while self.frontier < self.n_chunks:
            self._finalize_one()
        return events_from_runs(
            self.layout, [self._chunk_events[c] for c in sorted(self._chunk_events)]
        )


def feed_bam(
    acc, path: str, *, map_qual: int = 30, clip_percent: float = 0.1,
    iden_percent: float = 0.9, threads: int = 4, chunk_bytes: int = 64 << 20,
) -> int:
    """Pack one BAM into ``acc``, filtered as ``pipeline.run_filter``
    filters a read type over every target of the header: per chunk, the
    records that pass, deduped last-wins within the chunk, folded in file
    order while the native producer inflates the next chunk.  ``acc``'s
    layout must be the header's targets in order.  Returns the number of
    BAM chunks read."""
    n_chunks = 0
    with BamStream(path, threads=threads, keep_names=False,
                   chunk_bytes=chunk_bytes) as stream:
        if list(acc.layout.names) != list(stream.references):
            raise ValueError(f"{path}: the layout is not the header's targets")
        n_refs = len(stream.references)
        for chunk in stream:
            n_chunks += 1
            ref_id = chunk.columns["ref_id"]
            tid = np.where((ref_id >= 0) & (ref_id < n_refs), ref_id, -1)
            mask = (tid >= 0) & bam_filter_mask(
                chunk.columns, map_qual, clip_percent, iden_percent
            )
            surv = dedup_last_wins(chunk.name_keys, mask)
            if surv.size:
                acc.add_chunk(
                    keys_view(chunk.name_keys[surv]),
                    tid[surv].astype(np.int32),
                    chunk.columns["pos"][surv].astype(np.int64),
                    chunk.columns["ref_end"][surv].astype(np.int64),
                )
    return n_chunks
