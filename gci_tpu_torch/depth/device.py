"""Host helpers of the depth paths, the device scatter, scans and the
sharded (dp, gp) programs.

Counterpart of ``gci_tpu/depth/device.py``: the host numpy helpers
``pack_read_deltas``, ``pack_read_deltas_sharded``, ``build_scan_valid``
and ``edge_indices_to_intervals``, the device scatter,
``depth_and_edges_fused`` (the single-GPU fused entry), and the programs of
the sharded backend over a ``parallel.mesh.Mesh``.

The sharded programs hold a genome of ``total_slots`` slots as gp equal
shards, each a tensor on the device of its column's first position that
this process owns (``{gp index: tensor}``; a process holds the columns of
its own positions, one copy each).  The reference's collectives map so:

* ``psum`` over dp: each position scatters its dp row's events into its
  column's shard (positions on one device share the buffer), and processes
  that hold the same column then ``all_reduce`` it in its dp group;
* the prefix sum: ``depth_scan`` (the K2 kernel on CUDA) per shard, then
  each shard adds the wrapped sum of the totals of the shards left of it,
  from one host all-gather of the shard totals;
* the ``ppermute`` of a shard's last element to its right neighbour: one
  host all-gather of every shard's last element.

Shard-local indices are int32 on the device; global positions are int64
on the host only.  Rows are selected per shard on the host and scattered
exactly, so no padding row or out-of-range sentinel exists.
"""
from __future__ import annotations

import numpy as np
import torch

from gci_tpu_torch.depth.accum import GenomeLayout, clamp_read_intervals
from gci_tpu_torch.depth.scan import depth_scan, fused_depth_scan
from gci_tpu_torch.parallel import distributed

_INT32_MAX = np.iinfo(np.int32).max


def pack_read_deltas(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int,
    pad_to: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global (start_slot, stop_slot, live) arrays with slice-exact clamping.

    int32 slot indices: only valid for single-device layouts below 2^31
    slots.
    """
    if layout.total_slots > _INT32_MAX:
        raise OverflowError(
            f"{layout.total_slots} slots exceed int32 global indexing"
        )
    s, e = clamp_read_intervals(layout, target_id, start, end, flank_len)
    base = layout.offsets[target_id]
    gs = (base + s).astype(np.int32)
    ge = (base + e).astype(np.int32)
    live = (e > s).astype(np.int32)
    if pad_to is not None and gs.shape[0] < pad_to:
        padn = pad_to - gs.shape[0]
        gs = np.concatenate([gs, np.zeros(padn, np.int32)])
        ge = np.concatenate([ge, np.zeros(padn, np.int32)])
        live = np.concatenate([live, np.zeros(padn, np.int32)])
    return gs, ge, live


def pack_read_deltas_sharded(
    layout: GenomeLayout,
    target_id: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    flank_len: int,
    shard_slots: int,
) -> tuple[np.ndarray, ...]:
    """(gs_shard, gs_off, ge_shard, ge_off, live), all int32.

    Global slot arithmetic stays int64 on the host; each event is addressed
    as (genome-shard index, shard-local offset), so a layout past 2^31
    slots never touches an int32 global index.
    """
    s, e = clamp_read_intervals(layout, target_id, start, end, flank_len)
    base = layout.offsets[target_id]
    gs = base + s
    ge = base + e
    return (
        (gs // shard_slots).astype(np.int32),
        (gs % shard_slots).astype(np.int32),
        (ge // shard_slots).astype(np.int32),
        (ge % shard_slots).astype(np.int32),
        (e > s).astype(np.int32),
    )


def scatter_events(pad_total: int, device: torch.device, events) -> torch.Tensor:
    """int32 zeros(pad_total) plus every (indices, value) event, in one
    ``index_add_`` (``scatter_events_into`` a new buffer)."""
    return scatter_events_into(
        torch.zeros(pad_total, dtype=torch.int32, device=device), events
    )


def scatter_events_into(buf: torch.Tensor, events) -> torch.Tensor:
    """Add every (indices, value) event into the 1-D int32 ``buf`` in place,
    in one ``index_add_``; returns ``buf``.  A value is a scalar or an array
    of the indices' shape.

    The reference's scatter drops out-of-range indices silently; torch's
    raises (CPU) or asserts (CUDA), so the range is checked here on the host
    and an index outside ``[0, len(buf))`` raises IndexError.  Checked
    indices go to the device as int32 where the length allows it (half the
    bytes of int64).  Integer adds commute, so the atomics' order on the
    card cannot change the result.
    """
    idx = [np.asarray(i, np.int64) for i, _ in events]
    val = [
        np.broadcast_to(np.asarray(v, np.int32), i.shape) for i, (_, v) in zip(idx, events)
    ]
    idx = np.concatenate(idx) if idx else np.empty(0, np.int64)
    val = np.concatenate(val) if val else np.empty(0, np.int32)
    if idx.shape[0] == 0:
        return buf
    n = int(buf.shape[0])
    if int(idx.min()) < 0 or int(idx.max()) >= n:
        raise IndexError(
            f"event index outside [0, {n}): [{int(idx.min())}, {int(idx.max())}]"
        )
    if n <= _INT32_MAX:
        idx = idx.astype(np.int32)
    buf.index_add_(0, torch.from_numpy(idx).to(buf.device),
                   torch.from_numpy(val).to(buf.device))
    return buf


def _local_prefix_sum(delta: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum on the tensor's device (``depth_scan``)."""
    return depth_scan(delta)


def depth_and_edges_fused(gs, ge, live, valid_i8, leftmost: int, rightmost: int,
                          total_padded: int, *, device: torch.device):
    """Scatter of the read deltas plus the fused scan on one device.

    ``gs``, ``ge`` and ``live`` are host arrays as ``pack_read_deltas``
    gives them; ``valid_i8`` is the int8 scan-window mask of
    ``total_padded`` slots (nonzero is valid).  Returns (depth, rise int8,
    fall int8) of ``leftmost < depth <= rightmost`` inside ``valid_i8``.
    The reference drops out-of-range read indices silently; here a read
    index outside ``[0, total_padded)`` raises IndexError.  Any
    ``total_padded`` works: the kernel has no chunk multiple.
    """
    delta = scatter_events(total_padded, device, [(gs, live), (ge, -np.asarray(live))])
    valid = torch.as_tensor(valid_i8, dtype=torch.int8, device=device)
    return fused_depth_scan(delta, valid, leftmost, rightmost)


def build_scan_valid(layout: GenomeLayout, flank_len: int,
                     pad_to: int | None = None) -> np.ndarray:
    """Boolean per-slot mask of positions inside each target's scan window.

    Scan window = [flank, L-flank) per target (empty when L <= 2*flank),
    matching the slice the reference iterates (GCI.py:374).
    """
    total = layout.total_slots
    valid = np.zeros(pad_to or total, dtype=bool)
    for k in range(len(layout.names)):
        L = int(layout.lengths[k])
        if L - 2 * flank_len <= 0:
            continue
        o = int(layout.offsets[k])
        valid[o + flank_len : o + L - flank_len] = True
    return valid


def edge_indices_to_intervals(
    layout: GenomeLayout,
    rise_idx: np.ndarray,
    fall_idx: np.ndarray,
    flank_len: int,
    start_pos: int = 0,
) -> dict[str, list[tuple[int, int]]]:
    """Reference-exact interval dicts from sorted global edge indices.

    Applies the reference emission quirks (drop when the run terminates at a
    scan index <= flank_len; final-position closure).
    """
    from gci_tpu_torch.intervals.collapse import runs_to_intervals

    out: dict[str, list[tuple[int, int]]] = {}
    for k, name in enumerate(layout.names):
        L = int(layout.lengths[k])
        o = int(layout.offsets[k])
        n_scan = L - 2 * flank_len
        if n_scan <= 0:
            out[name] = []
            continue
        w_lo = o + flank_len
        w_hi = o + L - flank_len  # exclusive end of scan window
        r = rise_idx[(rise_idx >= w_lo) & (rise_idx < w_hi)] - w_lo
        f = fall_idx[(fall_idx >= w_lo) & (fall_idx <= w_hi)] - w_lo
        # a run still open at the final scanned position has no fall edge
        # inside the window: close it at n_scan
        if r.shape[0] > f.shape[0]:
            f = np.concatenate([f, [n_scan]])
        elif f.shape[0] > r.shape[0]:  # defensive; cannot happen with valid masks
            f = f[: r.shape[0]]
        f = np.minimum(f, n_scan)
        out[name] = runs_to_intervals(r, f, n_scan, flank_len, start_pos)
    return out


# ---------------------------------------------------------------------------
# sharded (dp, gp) programs
# ---------------------------------------------------------------------------

def _wrap_int32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def shard_values(mesh, values: dict[int, int]) -> list[int]:
    """One integer per gp shard, on every process, from ``values`` of this
    process's shards: the host all-gather that stands for the reference's
    ``all_gather`` and ``ppermute`` over gp."""
    rows = np.asarray(sorted(values.items()), dtype=np.int64).reshape(-1, 2)
    if distributed.process_count() > 1:
        (rows,) = distributed.allgather_concat([rows])
    out: dict[int, int] = {}
    for g, v in rows.tolist():
        out.setdefault(g, v)
    return [out[g] for g in range(mesh.shape["gp"])]


def sharded_depth(mesh, total_slots: int, packed, n_rows: int,
                  first_row: int = 0) -> dict[int, torch.Tensor]:
    """The sharded depth step: {gp index: int32 inclusive prefix sum of the
    events} for this process's shards of a ``total_slots`` genome axis.

    ``packed`` holds ``pack_read_deltas_sharded``'s five arrays for rows
    ``[first_row, first_row + len)`` of a table of ``n_rows`` rows, which
    the dp rows split into runs of ``ceil(n_rows / dp)`` (the reference
    pads the table to a multiple of dp).  Each position scatters the live
    events of its dp row that fall in its gp shard; the partials are summed
    over dp (in the shard's buffer, then across processes), the shard is
    scanned by ``depth_scan`` and then carries the wrapped sum of the
    totals of the shards left of it.
    """
    gp = mesh.shape["gp"]
    if total_slots % gp:
        raise ValueError("pad the genome axis to the gp shard count")
    shard = total_slots // gp
    chunk = -(-n_rows // mesh.shape["dp"])
    gs_sh, gs_off, ge_sh, ge_off, live = packed
    delta: dict[int, torch.Tensor] = {}
    for g in mesh.local_gp():
        dev = mesh.shard_device(g)
        buf = torch.zeros(shard, dtype=torch.int32, device=dev)
        for d, dev_d in mesh.local_positions(g):
            rows = slice(max(d * chunk - first_row, 0), max((d + 1) * chunk - first_row, 0))
            lv = live[rows]
            a = (gs_sh[rows] == g) & (lv != 0)
            b = (ge_sh[rows] == g) & (lv != 0)
            events = [(gs_off[rows][a], lv[a]), (ge_off[rows][b], -lv[b])]
            if dev_d == dev:
                scatter_events_into(buf, events)
            else:
                buf += scatter_events(shard, dev_d, events).to(dev)
        delta[g] = buf
    for g in range(gp):  # every process in the same order
        group = mesh.dp_group(g)
        if group is not None:
            torch.distributed.all_reduce(delta[g], group=group)
    local = {g: depth_scan(delta.pop(g)) for g in list(delta)}
    totals = shard_values(mesh, {g: int(x[-1]) for g, x in local.items()})
    for g, x in local.items():
        carry = _wrap_int32(sum(totals[:g]))
        if carry:
            x += carry
    return local


def sharded_interval_edges(mesh, depth: dict, valid: dict, leftmost: int,
                           rightmost: int):
    """Rise and fall bool bitmaps per shard of the in-range mask
    ``leftmost < depth <= rightmost`` inside the bool ``valid``; a run that
    crosses a shard border makes no edge there."""
    m = {g: (x > leftmost) & (x <= rightmost) & valid[g] for g, x in depth.items()}
    last = shard_values(mesh, {g: int(x[-1]) for g, x in m.items()})
    rise, fall = {}, {}
    for g, x in m.items():
        prev = torch.empty_like(x)
        prev[1:] = x[:-1]
        prev[:1] = bool(last[g - 1]) if g else False
        rise[g] = x & ~prev
        fall[g] = ~x & prev
    return rise, fall


def sharded_change(mesh, depth: dict) -> dict[int, torch.Tensor]:
    """Run-boundary bool bitmaps per shard: depth[i] != depth[i-1], across a
    shard border against the left shard's last value; global slot 0 is
    always a boundary."""
    last = shard_values(mesh, {g: int(x[-1]) for g, x in depth.items()})
    out = {}
    for g, x in depth.items():
        c = torch.empty(x.shape[0], dtype=torch.bool, device=x.device)
        torch.ne(x[1:], x[:-1], out=c[1:])
        c[:1] = (x[:1] != last[g - 1]) if g else True
        out[g] = c
    return out


def sharded_compact_gather(mesh, bitmaps: dict, values: dict | None = None,
                           offsets: dict | None = None):
    """{gp index: (idx, vals, offset_vals)} for every shard, int64 host
    arrays: the sorted shard-local indices of a bool bitmap's set entries,
    and, given ``values``, the values there and at the shard-local
    ``offsets[g]``.

    Per shard of this process: the bitmap's prefix sum (the int8 form of
    ``depth_scan``), whose last entry is the count (a ``sum`` of the bitmap
    would make an int64 copy, 8 B/slot), ``searchsorted`` of the ranks and
    the gathers, read back in one transfer; then one host all-gather across
    processes.
    """
    out = {}
    for g, bits in bitmaps.items():
        pos = depth_scan(bits.view(torch.int8))
        n = int(pos[-1])
        idx = torch.searchsorted(pos, torch.arange(1, n + 1, dtype=torch.int32,
                                                   device=pos.device))
        del pos
        parts = [idx]
        k = 0
        if values is not None:
            off = torch.as_tensor(offsets[g], dtype=torch.int64, device=idx.device)
            k = off.shape[0]
            parts += [values[g][idx].to(torch.int64), values[g][off].to(torch.int64)]
        got = torch.cat(parts).cpu().numpy()
        nv = n if values is not None else 0
        out[g] = (got[:n], got[n : n + nv], got[n + nv : n + nv + k])
    if distributed.process_count() == 1:
        return out
    # self-delimiting records [g, n, k, idx, vals, offset_vals] of each
    # process's shards, in process order; the first holder's copy is kept
    flat = [np.concatenate([[g, len(i), len(o)], i, v, o]).astype(np.int64)
            for g, (i, v, o) in out.items()]
    (flat,) = distributed.allgather_concat(
        [np.concatenate(flat) if flat else np.empty(0, np.int64)])
    out, p = {}, 0
    while p < flat.shape[0]:
        g, n, k = (int(x) for x in flat[p : p + 3])
        nv = n if values is not None else 0
        p += 3
        rec = (flat[p : p + n], flat[p + n : p + n + nv], flat[p + n + nv : p + n + nv + k])
        out.setdefault(g, rec)
        p += n + nv + k
    return out
