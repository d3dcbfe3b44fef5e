"""Streamed depth for genomes past the resident device path.

Counterpart of ``gci_tpu/depth/streamed.py``.  The resident path
(``depth/fused.py``) indexes genome slots with int32 and holds about 25 B per
slot on the card (``accum.RESIDENT_BYTES_PER_SLOT``), so a human T2T
assembly (3.1 Gbp) is past the first limit and near the second on an 80 GB
card.  This path scans the concatenated genome axis in chunks of
``CHUNK_SLOTS``:

* the read events (start +1, stop -1) are clamped and sorted once on the
  host as int64 global slots, and each chunk's slice is found by binary
  search;
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
  compacted on the card (``chunk_runs``: the int8 form of the scan kernel
  and ``searchsorted``) and read back with their values, so no per-base
  array exists anywhere, on the host or the card;
* ``overlap.SweepAccumulator``, which runs ``chunk_runs`` on each chunk
  the coordinate sweep has passed.
"""
from __future__ import annotations

import numpy as np
import torch

from gci_tpu_torch.depth.accum import GenomeLayout, clamp_read_intervals
from gci_tpu_torch.depth.base import events_from_change_indices
from gci_tpu_torch.depth.device import scatter_events
from gci_tpu_torch.depth.scan import depth_scan

_INT32_MAX = int(np.iinfo(np.int32).max)

# Slots per chunk, read at call time so a caller can lower it.  A chunk of
# 2^28 slots holds at most 9 B/slot on the card (the delta and its depth at
# the scan; the depth, the boundary bitmap and the compaction's int32
# prefix after it), about 2.3 GiB, and each chunk pays two host syncs (its
# boundary count, its readback), which at this size are small beside the
# chunk's own passes over its 2^28 slots.
CHUNK_SLOTS = 1 << 28


def _sorted_events(layout, target_id, start, end, flank_len):
    """Sorted int64 global start and stop slots of the live reads."""
    s, e = clamp_read_intervals(layout, target_id, start, end, flank_len)
    live = e > s
    base = layout.offsets[target_id]
    gs = np.sort((base + s)[live].astype(np.int64))
    ge = np.sort((base + e)[live].astype(np.int64))
    return gs, ge


def _chunk_plan(total: int, gs: np.ndarray, ge: np.ndarray, chunk_slots: int):
    """(n_chunks, bounds, gs_lo, gs_hi, ge_lo, ge_hi): chunk c covers global
    slots ``[bounds[c], bounds[c + 1])`` and its events are
    ``gs[gs_lo[c]:gs_hi[c]]`` and ``ge[ge_lo[c]:ge_hi[c]]``.  Every bound is
    int64; the chunk size must fit int32 indices."""
    if not 0 < chunk_slots <= _INT32_MAX:
        raise ValueError(f"chunk of {chunk_slots} slots: expected 1 to {_INT32_MAX}")
    n_chunks = -(-total // chunk_slots)
    bounds = np.minimum(np.arange(n_chunks + 1, dtype=np.int64) * chunk_slots, total)
    gs_at = np.searchsorted(gs, bounds)
    ge_at = np.searchsorted(ge, bounds)
    return n_chunks, bounds, gs_at[:-1], gs_at[1:], ge_at[:-1], ge_at[1:]


def _iter_depth_chunks(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int,
    chunk_slots: int,
    device: torch.device,
):
    """Yield ``(a, b, depth, carry)`` per chunk: ``depth`` is the int32
    depth of global slots ``[a, b)`` on ``device``, ``carry`` the depth at
    slot ``a - 1`` (0 for the first chunk).  A consumer drops ``depth``
    before it asks for the next chunk, so one chunk lives at a time."""
    gs, ge = _sorted_events(layout, target_id, start, end, flank_len)
    n_chunks, bounds, gs_lo, gs_hi, ge_lo, ge_hi = _chunk_plan(
        layout.total_slots, gs, ge, chunk_slots
    )
    for c in range(n_chunks):
        a, b = int(bounds[c]), int(bounds[c + 1])
        carry = int(gs_lo[c] - ge_lo[c])
        # the delta is a temporary: it dies once its scan is launched
        depth = depth_scan(scatter_events(b - a, device, [
            (gs[gs_lo[c]:gs_hi[c]] - a, 1),
            (ge[ge_lo[c]:ge_hi[c]] - a, -1),
            ((0,), carry),
        ]))
        yield a, b, depth, carry
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
    for a, b, depth, _ in _iter_depth_chunks(
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

    Per chunk: the run-boundary bitmap on the card, seeded with the carry
    (``-1`` before the first chunk, which forces a boundary at slot 0), its
    int32 prefix sum (the int8 form of the scan kernel), whose last entry
    is the boundary count (one host sync; a ``sum`` of the bool bitmap
    would make an int64 copy of it, 8 B/slot), then ``searchsorted`` of the
    ranks and a value gather, read back in one transfer.
    """
    runs = []
    for a, _, depth, carry in _iter_depth_chunks(
        layout, target_id, start, end, flank_len,
        CHUNK_SLOTS if chunk_slots is None else chunk_slots, device,
    ):
        runs.append(chunk_runs(depth, a, carry))
        del depth
    return events_from_runs(layout, runs)


def chunk_runs(depth: torch.Tensor, a: int, carry: int):
    """(global slots, depths) of the run boundaries of one chunk's depth,
    both int64 on the host, each boundary with the depth of its run.

    The chunk starts at global slot ``a``; ``carry`` is the depth at
    ``a - 1``.  The boundary bitmap is seeded with the carry (``-1``
    before the first chunk, which forces a boundary at slot 0), so a run
    across a chunk border makes no boundary.  Its int32 prefix sum (the
    int8 form of the scan kernel) gives the boundary count as its last
    entry (one host sync; a ``sum`` of the bool bitmap would make an int64
    copy of it, 8 B/slot), then ``searchsorted`` of the ranks and a value
    gather are read back in one transfer.
    """
    change = torch.empty(depth.shape[0], dtype=torch.bool, device=depth.device)
    torch.ne(depth[1:], depth[:-1], out=change[1:])
    change[:1] = depth[:1] != (carry if a > 0 else -1)
    pos = depth_scan(change.view(torch.int8))
    del change
    n = int(pos[-1])
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    k = torch.arange(1, n + 1, dtype=torch.int32, device=pos.device)
    idx = torch.searchsorted(pos, k)
    del pos
    got = torch.cat([idx, depth[idx].to(torch.int64)]).cpu().numpy()
    return got[:n] + a, got[n:]


def events_from_runs(layout: GenomeLayout, runs):
    """{target: DepthEvents} from the chunks' ``chunk_runs`` in genome order."""
    runs = [r for r in runs if r[0].shape[0]]
    idx = np.concatenate([r[0] for r in runs]) if runs else np.zeros(1, np.int64)
    vals = np.concatenate([r[1] for r in runs]) if runs else np.zeros(1, np.int64)

    def gather(query: np.ndarray) -> np.ndarray:
        # the value of the run holding each queried slot (a target start
        # may fall inside a run)
        pos = np.searchsorted(idx, query, side="right") - 1
        return vals[np.clip(pos, 0, None)]

    return events_from_change_indices(layout, idx, gather)

