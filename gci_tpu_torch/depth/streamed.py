"""Streamed depth for genomes past the resident device path.

Counterpart of ``gci_tpu/depth/streamed.py``.  The resident path
(``depth/fused.py``) indexes genome slots with int32 and holds about 24 B per
slot on the card (``accum.RESIDENT_BYTES_PER_SLOT``), so a human T2T
assembly (3.1 Gbp) is past the first limit and near the second on an 80 GB
card.  This path scans the concatenated genome axis in chunks of
``CHUNK_SLOTS``:

* the read events (start +1, stop -1) are clamped and partitioned by
  chunk once on the host (one counting sort in the host library), each
  chunk's as chunk-local int32 slots;
* a chunk's carry, the depth just before it, is exact:
  ``#starts < a - #stops < a``;
* per chunk, one ``index_add_`` scatters its event slice at chunk-local
  int32 indices, with the carry as one more event at slot 0, and one
  ``depth_scan`` (the int32 form of the scan kernel) turns it into depth.

Only chunk-local indices (below ``CHUNK_SLOTS`` <= 2^31 - 1) reach the card;
host positions stay int64 throughout.  Device memory is O(chunk),
independent of the genome's size.  Consumers:

* ``accumulate_depth_streamed``: the flat per-slot host array (tests, and
  ``accum.accumulate_depth`` past its switch point);
* ``events_from_reads_streamed``: run-length ``DepthEvents`` per target, the
  pipeline's ``streamed`` backend.  Each chunk's run boundaries (seeded with
  the carry, so a run across a chunk border makes no boundary) are
  compacted on the card with their values (``chunk_runs``: the run form of
  the compaction kernel) and read back, so no per-base array exists
  anywhere, on the host or the card;
* ``overlap.SweepAccumulator``, which runs ``chunk_runs`` on each chunk
  the coordinate sweep has passed;
* ``events_from_delta2d_streamed``: the same read-out of a resident delta
  that the pack <-> scatter overlap accumulated (``overlap.DeltaAccumulator``),
  chunk by chunk, for genomes past int32 slots.
"""
from __future__ import annotations

import numpy as np
import torch

from gci_tpu_torch.depth.accum import GenomeLayout, clamp_read_intervals
from gci_tpu_torch.depth.base import events_from_boundaries
from gci_tpu_torch.depth.device import scatter_events
from gci_tpu_torch.depth.scan import capacity_for, compact_runs, depth_scan
from gci_tpu_torch.native import HostCodecError, partition_read_events_native
from gci_tpu_torch.utils.metrics import count, span

_INT32_MAX = int(np.iinfo(np.int32).max)

# Slots per chunk, read at call time so a caller can lower it.  A chunk of
# 2^28 slots holds at most 8 B/slot on the card (the delta and its depth at
# the scan; the compaction after it, beside the depth alone, sizes its
# buffers within ``scan.capacity_for``'s limit, 64 MiB here), about 2 GiB,
# and each chunk pays two host syncs (its boundary count, its readback),
# which at this size are small beside the chunk's own passes over its 2^28
# slots.
CHUNK_SLOTS = 1 << 28


def _sorted_events(layout, target_id, start, end, flank_len, chunk_slots):
    """The live reads' events sorted by chunk, by a counting sort on the
    chunk number: ``(bounds, starts, stops, s_at, e_at)``.

    Chunk c covers global slots ``[bounds[c], bounds[c + 1])`` (int64; the
    chunk size must fit int32 indices); its events are
    ``starts[s_at[c]:s_at[c + 1]]`` and ``stops[e_at[c]:e_at[c + 1]]``, int32
    slots local to the chunk, in read order inside it (the scatter's adds
    commute, so no order is needed there).  ``s_at[c] - e_at[c]`` is the
    depth just before the chunk.  One pass of the host library
    (``native.partition_read_events_native``) clamps, drops the dead reads
    and partitions; where the library does not load, its numpy twin
    ``_partition_numpy`` gives the same arrays.  The events partitioned
    count in ``streamed.events_native`` or ``streamed.events_numpy``.
    """
    if not 0 < chunk_slots <= _INT32_MAX:
        raise ValueError(f"chunk of {chunk_slots} slots: expected 1 to {_INT32_MAX}")
    total = layout.total_slots
    n_chunks = -(-total // chunk_slots)
    bounds = np.minimum(np.arange(n_chunks + 1, dtype=np.int64) * chunk_slots, total)
    try:
        parts = partition_read_events_native(
            target_id, start, end, layout.lengths, layout.offsets, flank_len,
            chunk_slots, n_chunks)
        counter = "streamed.events_native"
    except HostCodecError:
        parts = _partition_numpy(layout, target_id, start, end, flank_len,
                                 chunk_slots, n_chunks)
        counter = "streamed.events_numpy"
    count(counter, parts[0].shape[0] + parts[1].shape[0])
    return (bounds, *parts)


def _partition_numpy(layout, target_id, start, end, flank_len, chunk_slots, n_chunks):
    """``partition_read_events_native`` in numpy: the clamp, then a stable
    ``argsort`` of the chunk numbers and a gather, so the same order."""
    s, e = clamp_read_intervals(layout, target_id, start, end, flank_len)
    live = e > s
    base = layout.offsets[target_id][live]
    out, at = [], []
    for slots in (base + s[live], base + e[live]):
        chunk = slots // chunk_slots
        order = np.argsort(chunk, kind="stable")
        out.append((slots - chunk * chunk_slots)[order].astype(np.int32))
        offsets = np.zeros(n_chunks + 1, np.int64)
        np.cumsum(np.bincount(chunk, minlength=n_chunks), out=offsets[1:])
        at.append(offsets)
    return out[0], out[1], at[0], at[1]


def _iter_depth_chunks(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int,
    chunk_slots: int,
    device: torch.device,
):
    """Yield ``(a, b, depth, carry, rows)`` per chunk: ``depth`` is the
    int32 depth of global slots ``[a, b)`` on ``device``, ``carry`` the
    depth at slot ``a - 1`` (0 for the first chunk), ``rows`` the read
    events scattered into it.  A consumer drops ``depth`` before it asks for
    the next chunk, so one chunk lives at a time.

    Spans: ``streamed.sort`` (``_sorted_events``: the clamp and the
    partition by chunk), and per chunk ``streamed.scatter`` (the scatter
    and the scan's launch), each closed before the ``yield``."""
    with span("streamed.sort"):
        bounds, starts, stops, s_at, e_at = _sorted_events(
            layout, target_id, start, end, flank_len, chunk_slots)
    for c in range(bounds.shape[0] - 1):
        a, b = int(bounds[c]), int(bounds[c + 1])
        carry = int(s_at[c] - e_at[c])
        with span("streamed.scatter"):
            # the delta is a temporary: it dies once its scan is launched
            depth = depth_scan(scatter_events(b - a, device, [
                (starts[s_at[c]:s_at[c + 1]], 1),
                (stops[e_at[c]:e_at[c + 1]], -1),
                ((0,), carry),
            ]))
        yield a, b, depth, carry, int(s_at[c + 1] - s_at[c] + e_at[c + 1] - e_at[c])
        del depth  # before the next chunk's delta is allocated


def accumulate_depth_streamed(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int = 15,
    chunk_slots: int | None = None,
    *,
    device: torch.device,
) -> np.ndarray:
    """Flat per-slot int32 depth on the host, computed chunk by chunk on
    ``device`` (``CHUNK_SLOTS`` per chunk unless ``chunk_slots`` is given)."""
    out = np.empty(layout.total_slots, dtype=np.int32)
    for a, b, depth, _, _ in _iter_depth_chunks(
        layout, target_id, start, end, flank_len,
        CHUNK_SLOTS if chunk_slots is None else chunk_slots, device,
    ):
        out[a:b] = depth.cpu().numpy()
        del depth
    return out


def events_from_reads_streamed(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int = 15,
    chunk_slots: int | None = None,
    *,
    device: torch.device,
):
    """{target: DepthEvents} of a genome of any size; O(chunk) on the card
    and O(runs) on the host.

    Per chunk, ``chunk_runs``: its run boundaries and their depths,
    compacted on the card and read back.  The whole is the span
    ``streamed.build``; ``streamed.runs`` is the host's runs per target.
    """
    with span("streamed.build"):
        runs = []
        for a, _, depth, carry, rows in _iter_depth_chunks(
            layout, target_id, start, end, flank_len,
            CHUNK_SLOTS if chunk_slots is None else chunk_slots, device,
        ):
            runs.append(chunk_runs(depth, a, carry, rows))
            del depth
        with span("streamed.runs"):
            return events_from_runs(layout, runs)


def resident_chunk_slots(total: int, chunk_slots: int | None = None) -> int:
    """The chunk size of ``events_from_delta2d_streamed`` over ``total``
    slots: ``chunk_slots`` (``CHUNK_SLOTS`` unless given), never more than
    the genome and at least 1.  The reference aligns and buckets it to its
    Pallas tiles; the kernels here take any length."""
    chunk = CHUNK_SLOTS if chunk_slots is None else int(chunk_slots)
    return max(1, min(chunk, total))


def events_from_delta2d_streamed(layout: GenomeLayout, delta: torch.Tensor,
                                 chunk_slots: int | None = None, rows: int | None = None):
    """{target: DepthEvents} from a resident read delta, read out in chunks
    of ``resident_chunk_slots(total, chunk_slots)`` slots; O(chunk) on the
    card beside the delta and O(runs) on the host.

    ``delta`` is the flat int32 tensor of exactly ``layout.total_slots``
    slots that ``overlap.DeltaAccumulator.take_delta`` hands over (the
    reference holds it as (n_chunks, chunk_slots) rows), on any device.
    ``rows``, the events scattered into it (``DeltaAccumulator.rows``),
    bounds every chunk's run boundaries together, and so each chunk's.

    Per chunk: ``depth_scan`` over the chunk's slice with the carry added at
    its slot 0, then ``chunk_runs``, the run form of the compaction with
    the carry as slot 0's predecessor, and one readback.  The carry is the
    depth at the chunk's slot ``a - 1``: the value of the previous chunk's
    last run, or, where that chunk made no boundary, its own carry (the
    reference takes it from one more pass of per-chunk sums).  Only
    chunk-local indices reach the kernels, so the genome may pass 2^31
    slots.  The delta is consumed: each chunk's slot 0 keeps the carry added
    to it, so the caller must not read the delta afterwards.
    """
    total = layout.total_slots
    if delta.dtype != torch.int32 or delta.shape != (total,):
        raise ValueError(f"expected an int32 delta of {total} slots, got {delta.dtype} "
                         f"of shape {tuple(delta.shape)}")
    chunk = resident_chunk_slots(total, chunk_slots)
    if chunk > _INT32_MAX:
        raise ValueError(f"chunk of {chunk} slots: expected 1 to {_INT32_MAX}")
    runs = []
    carry = 0
    for a in range(0, total, chunk):
        x = delta[a:a + chunk]
        x[:1] += carry  # one more event at the chunk's slot 0
        if x.data_ptr() % 16:  # the scan kernel reads 16-byte aligned words
            x = x.clone()
        depth = depth_scan(x)
        del x
        idx, vals = chunk_runs(depth, a, carry, rows)
        del depth  # before the next chunk's scan
        runs.append((idx, vals))
        if idx.shape[0]:
            carry = int(vals[-1])
    return events_from_runs(layout, runs)


def chunk_runs(depth: torch.Tensor, a: int, carry: int, rows: int | None = None):
    """(global slots, depths) of the run boundaries of one chunk's depth,
    both int64 on the host, each boundary with the depth of its run.

    The chunk starts at global slot ``a``; ``carry`` is the depth at
    ``a - 1``.  The run form of the compaction compares slot 0 with the
    carry (the first chunk's slot 0 is always a boundary), so a run across
    a chunk border makes no boundary; it writes each boundary's depth
    beside its index, and both come back in one transfer after the count's
    host sync.  ``rows``, the events scattered into the chunk, bounds its
    boundaries: one falls only on an event's slot or at slot 0
    (``capacity_for`` makes that bound the compaction's capacity).

    Spans ``streamed.compact`` (the compaction and its count's sync) and
    ``streamed.readback``; the bytes read back count in ``copies.d2h_bytes``.
    """
    with span("streamed.compact"):
        capacity = capacity_for(None if rows is None else rows + 1, depth.shape[0], 1, True)
        idx, vals = compact_runs(depth, carry if a > 0 else None, capacity)
    with span("streamed.readback"):
        got = torch.cat([idx, vals.to(torch.int64)])
        if got.is_cuda:
            count("copies.d2h_bytes", got.nbytes)
        got = got.cpu().numpy()
        n = idx.shape[0]
        return got[:n] + a, got[n:]


def events_from_runs(layout: GenomeLayout, runs):
    """{target: DepthEvents} from the chunks' ``chunk_runs`` in genome order.

    The concatenated runs must be what ``chunk_runs`` makes of a genome, the
    run form ``events_from_boundaries`` takes: each chunk's slot 0 is
    compared with its carry, so adjacent depths differ across chunk borders
    too.  The boundaries read back count in ``streamed.boundaries``.
    """
    runs = [r for r in runs if r[0].shape[0]]
    count("streamed.boundaries", sum(r[0].shape[0] for r in runs))
    if runs:
        idx = np.concatenate([r[0] for r in runs])
        vals = np.concatenate([r[1] for r in runs])
    else:  # a genome of no slots
        idx = vals = np.zeros(1, np.int64)
    return events_from_boundaries(layout, idx, vals)
