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

``pipeline.run_filter`` builds either accumulator for a read type of one
BAM and no PAF (``pipeline._make_overlap_accumulator``) and feeds it
chunk by chunk as ``feed_bam`` does.

Only live rows are scattered, at exact indices: torch's ``index_add_`` has
no ``mode="drop"``, so neither the reference's power-of-two padding of the
event arrays nor its out-of-range drop sentinels exist here, and the
host range check of ``device.scatter_events_into`` holds for every index.
``index_add_`` adds in place, so the reference's buffer donation has no
counterpart.
"""
from __future__ import annotations

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
from gci_tpu_torch.utils.metrics import span


def _lex_searchsorted(ka, kb, qa, qb) -> np.ndarray:
    """Left insertion points of the keys (qa, qb) among (ka, kb), sorted as
    pairs of uint64 words.  The search runs on the first word; a query
    whose first word a row shares is placed past it by the second, and the
    rare run of rows sharing a first word (a 64-bit collision) is searched
    on its own."""
    n = ka.shape[0]
    lo = np.searchsorted(ka, qa)
    if n == 0:
        return lo
    at = np.minimum(lo, n - 1)
    pos = lo + ((ka[at] == qa) & (kb[at] < qb))
    nxt = np.minimum(lo + 1, n - 1)
    for i in np.flatnonzero((lo + 1 < n) & (ka[nxt] == qa)).tolist():
        hi = int(np.searchsorted(ka, qa[i], side="right"))
        pos[i] = lo[i] + np.searchsorted(kb[lo[i]:hi], qb[i])
    return pos


class _Pocket:
    """Live-key index of one or more consecutive chunks, sorted by key: the
    key's two uint64 words, each row's id in the fold's row table, whether
    it is still live, and how many chunks were folded into it."""

    __slots__ = ("ka", "kb", "rid", "alive", "chunks")

    def __init__(self, ka, kb, rid, chunks: int) -> None:
        self.ka, self.kb, self.rid = ka, kb, rid
        self.alive = np.ones(ka.shape[0], dtype=bool)
        self.chunks = chunks

    def take(self, qa, qb) -> tuple[np.ndarray, np.ndarray]:
        """(query positions, row ids) of the queries live here; those rows
        are no longer live."""
        posc = np.minimum(_lex_searchsorted(self.ka, self.kb, qa, qb), self.ka.shape[0] - 1)
        q = np.flatnonzero((self.ka[posc] == qa) & (self.kb[posc] == qb) & self.alive[posc])
        self.alive[posc[q]] = False
        return q, self.rid[posc[q]]

    def merged_with(self, newer: "_Pocket") -> "_Pocket":
        """One pocket of both pockets' live rows, sorted by key.  A name is
        live in at most one pocket, so the live keys of the two are distinct
        and each of ``newer``'s goes where the search puts it."""
        a, b = np.flatnonzero(self.alive), np.flatnonzero(newer.alive)
        at_b = _lex_searchsorted(self.ka[a], self.kb[a], newer.ka[b], newer.kb[b])
        at_b += np.arange(b.shape[0])
        from_a = np.ones(a.shape[0] + b.shape[0], dtype=bool)
        from_a[at_b] = False
        at_a = np.flatnonzero(from_a)
        parts = []
        for old, new in ((self.ka, newer.ka), (self.kb, newer.kb), (self.rid, newer.rid)):
            out = np.empty(from_a.shape[0], old.dtype)
            out[at_b], out[at_a] = new[b], old[a]
            parts.append(out)
        return _Pocket(*parts, self.chunks + newer.chunks)


class LastWinsFold:
    """Incremental last-wins name dedup across packed chunks.

    Chunks arrive in file order, already deduped *within* the chunk.  For
    each chunk, returns the rows that a record in this chunk replaces (the
    currently-live record of the same name from an earlier chunk); those
    rows' intervals are retracted from the device delta.

    Every row folded is kept in a row table; membership tests run against
    sorted "pockets" of keys and row ids, merged in a log-structured way:
    each chunk starts a pocket of its own, and while the newest pocket holds
    at least half as many chunks as the one before it, the two merge into
    one of their live rows.  Pocket ``i`` then holds more than twice the
    chunks of pocket ``i + 1``, so after ``C`` chunks at most
    ``floor(log2 C) + 1`` pockets exist: each chunk probes O(log C) pockets,
    and each row is merged O(log C) times.  (``gci_tpu`` keeps one pocket
    per chunk, so each chunk probes every earlier one.)  Keys are searched
    as two uint64 words, not as one structured value.  The retracted rows
    come back in ``gci_tpu``'s order: by the chunk they came from, then in
    the order of the probing chunk's keys.
    """

    def __init__(self) -> None:
        self._pockets: list[_Pocket] = []  # oldest first
        # (tid, start, end, index of the non-empty chunk) by row id
        self._rows = np.empty((1024, 4), np.int64)
        self._n_rows = 0
        self._chunks = 0  # non-empty chunks folded so far

    def _append_rows(self, tid, start, end) -> np.ndarray:
        """The chunk's rows into the table (grown by doubling); their ids."""
        n0, n1 = self._n_rows, self._n_rows + tid.shape[0]
        if n1 > self._rows.shape[0]:
            grown = np.empty((max(n1, 2 * self._rows.shape[0]), 4), np.int64)
            grown[:n0] = self._rows[:n0]
            self._rows = grown
        for j, col in enumerate((tid, start, end, self._chunks)):
            self._rows[n0:n1, j] = col
        self._n_rows = n1
        self._chunks += 1
        return np.arange(n0, n1, dtype=np.int64)

    def fold(
        self, kv: np.ndarray, tid: np.ndarray, start: np.ndarray,
        end: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fold one chunk; returns (tid, start, end) rows to retract.

        ``kv`` is the chunk's void16 key view (unique within the chunk).
        """
        e = np.empty(0, np.int64)
        if kv.shape[0] == 0:
            return e, e, e
        qa, qb = np.ascontiguousarray(kv["a"]), np.ascontiguousarray(kv["b"])
        hits = [p.take(qa, qb) for p in self._pockets]  # (query positions, row ids)
        rid = self._append_rows(tid, start, end)
        # the last-wins dedup hands its survivors over sorted by key already
        if not np.all((qa[1:] > qa[:-1]) | ((qa[1:] == qa[:-1]) & (qb[1:] > qb[:-1]))):
            order = np.lexsort((qb, qa))
            qa, qb, rid = qa[order], qb[order], rid[order]
        self._pockets.append(_Pocket(qa, qb, rid, 1))
        while (len(self._pockets) > 1
               and 2 * self._pockets[-1].chunks >= self._pockets[-2].chunks):
            newer = self._pockets.pop()
            merged = self._pockets.pop().merged_with(newer)
            if merged.ka.shape[0]:
                self._pockets.append(merged)
        q, h = (np.concatenate(c) for c in zip(*hits)) if hits else (e, e)
        if q.shape[0] == 0:
            return e, e, e
        r = self._rows[h]
        r = r[np.lexsort((q, r[:, 3]))]
        return r[:, 0], r[:, 1], r[:, 2]


def _global_intervals(layout: GenomeLayout, flank_len: int, tid, start, end):
    """Clamped int64 global [gs, ge) slots per row (``ge <= gs``: no depth)."""
    s, e = clamp_read_intervals(layout, tid, start, end, flank_len)
    base = layout.offsets[tid]
    return base + s, base + e


class _Folding:
    """An accumulator's last-wins fold and its counts: BAM chunks folded and
    rows retracted; the fold's host time is the span ``overlap.fold``."""

    def __init__(self) -> None:
        self._fold = LastWinsFold()
        self.chunks_added = 0
        self.rows_retracted = 0

    def _fold_chunk(self, kv, tid, start, end):
        with span("overlap.fold"):
            rows = self._fold.fold(kv, tid, start, end)
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
        self.rows = 0  # scattered so far: ``from_delta``'s bound on its boundaries

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
        self.rows += sum(e[0].shape[0] for e in events)

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
        self._rows: dict[int, int] = {}  # chunk -> rows scattered into it
        self._chunk_events: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.frontier = 0  # first chunk not finalized
        self._carry = 0    # depth at the last slot before the frontier
        self._max_seen_start = -1
        self._unsorted = False
        self._fixed_up = False  # a fixup may leave adjacent runs of one depth

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
            self._rows[c] = self._rows.get(c, 0) + hi - lo

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
        carry, the seed of the next chunk's scan, needs no adjustment here.
        The comparison at that chunk's slot 0 does: ``_finalize_one`` makes
        it against the finalized depth at ``a - 1``, which this fixup may
        have shifted.  Where ``b`` is the first slot of a finalized chunk,
        that chunk gets a boundary at ``b`` with the value there, which the
        shift would otherwise carry into it.  Prevailing values at both
        endpoints are resolved before any event list is modified.
        """
        self._fixed_up = True
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
        if b % self.chunk_slots == 0 and b < min(self.frontier * self.chunk_slots,
                                                 self.total):
            c = b // self.chunk_slots
            idx, vals = self._chunk_events.get(
                c, (np.empty(0, np.int64), np.empty(0, np.int64))
            )
            self._chunk_events[c] = _adjust_range(
                idx, vals, b, b, 0, insert_a=False, val_at_a=0,
                insert_b=True, val_at_b=val_at_b,
            )

    def _finalize_through(self, min_future_start: int) -> None:
        """Finalize every chunk wholly before ``min_future_start``."""
        while (
            self.frontier < self.n_chunks
            and (self.frontier + 1) * self.chunk_slots <= min_future_start
        ):
            self._finalize_one()

    def _finalize_one(self) -> None:
        """Scan the frontier chunk and compact its run boundaries: the carry
        at its slot 0, the int32 scan, then the run form of the compaction
        and one readback.  The scan is seeded with the carry, the scanned
        depth at ``a - 1``; slot 0 is compared with the finalized depth
        there, which a retraction reaching the frontier may have shifted
        since (``_fixup_finalized``).  The next carry is the depth at the
        chunk's last slot: the value of its last run, or, with no boundary,
        the value compared with at slot 0."""
        c = self.frontier
        a, b = self._bounds(c)
        delta = self._live.pop(c, None)
        if delta is None:
            delta = torch.zeros(b - a, dtype=torch.int32, device=self.device)
        delta[:1] += self._carry  # one more event at the chunk's slot 0
        depth = depth_scan(delta)
        del delta
        prev = self._value_at(a - 1) if a > 0 else 0
        idx, vals = chunk_runs(depth, a, prev, self._rows.pop(c, 0))
        del depth
        if idx.shape[0]:
            self._chunk_events[c] = (idx, vals)
        self._carry = int(vals[-1]) if idx.shape[0] else prev
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
        """Finalize the tail and assemble {target: DepthEvents}.  After a
        fixup, adjacent runs of one depth (within a chunk or across a
        border) merge first, as ``events_from_runs`` expects."""
        while self.frontier < self.n_chunks:
            self._finalize_one()
        runs = [self._chunk_events[c] for c in sorted(self._chunk_events)]
        if self._fixed_up and runs:
            idx = np.concatenate([r[0] for r in runs])
            vals = np.concatenate([r[1] for r in runs])
            keep = np.concatenate([[True], vals[1:] != vals[:-1]])
            runs = [(idx[keep], vals[keep])]
        return events_from_runs(self.layout, runs)


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
