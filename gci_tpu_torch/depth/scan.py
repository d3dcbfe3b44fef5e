"""The depth path's scan kernels and their plain PyTorch versions.

Counterpart of ``gci_tpu/depth/pallas_scan.py``; every function there that
reaches ``pl.pallas_call`` has its wrapper here:

* ``depth_scan`` — inclusive int32 prefix sum of int32 or int8 slots,
  wrapping mod 2^32;
* ``fused_depth_scan_packed`` — depth plus a flag byte from one packed event
  word per slot (the main path);
* ``fused_depth_scan_flags`` — raw depth plus a flag byte from a read delta
  and a gap/valid flag byte per slot (the path beyond the packed word's
  depth bound);
* ``fused_depth_scan_masked`` — the same math with unpacked int8 streams;
* ``fused_depth_scan`` — depth and the edges of ``lo < depth <= hi`` inside
  a valid stream, with no gap mask (``device.depth_and_edges_fused``).

Beside them, the stream compaction that ``gci_tpu`` builds on
``depth_scan`` and ``searchsorted`` (``gci_tpu/depth/fused.py``
``_compact_fn``, ``gci_tpu/depth/device.py``
``make_sharded_compact_gather_fn``), as one kernel of two forms:

* ``compact_flags`` — the ascending indices of the slots where
  ``(x & m) != 0``, for up to three masks of one int8 stream;
* ``compact_runs`` — the run boundaries of an int32 depth and the depth of
  each run.

Each wrapper runs its plain version for a tensor on the CPU, and for a CUDA
tensor launches its hand-written kernel (``gci_tpu_torch/csrc/scan.cu``) or
raises: it never falls back.  The plain versions define the semantics; the
CPU tests hold them against the JAX package, and the card's smoke run holds
the kernels against them.
"""
from __future__ import annotations

import torch

from gci_tpu_torch import kernels


def _route(x: torch.Tensor) -> bool:
    """True for the plain CPU version; raise for a device with no kernel."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def rise_fall(m: torch.Tensor):
    """Rise and fall bitmaps of a bool mask; the slot before 0 is outside."""
    prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=m.device), m[:-1]])
    return m & ~prev, ~m & prev


def run_boundaries(x: torch.Tensor) -> torch.Tensor:
    """Run boundaries: x[i] != x[i-1], forced at position 0."""
    return x != torch.cat([x[:1] - 1, x[:-1]])


# input types of depth_scan: int32 deltas, and int8 bitmaps (a bool bitmap
# viewed as int8) for the compaction
SCAN_DTYPES = (torch.int32, torch.int8)


def depth_scan_torch(delta: torch.Tensor) -> torch.Tensor:
    """Plain version of ``depth_scan``: int32 cumsum that wraps like jnp's
    (int8 slots are sign-extended, as ``jnp.cumsum(x.astype(jnp.int32))``)."""
    return torch.cumsum(delta, 0, dtype=torch.int32)


def depth_scan(delta: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum of a 1-D int32 or int8 tensor (wraps mod
    2^32).  Other types and shapes raise ValueError on every device."""
    if delta.dtype not in SCAN_DTYPES or delta.dim() != 1:
        raise ValueError(
            f"depth_scan: expected a 1-D int32 or int8 tensor, got {delta.dtype} "
            f"of shape {tuple(delta.shape)}"
        )
    if _route(delta):
        return depth_scan_torch(delta)
    return kernels.launch_depth_scan(delta)


def fused_depth_scan_packed_torch(word: torch.Tensor, leftmost: int,
                                  rightmost: int):
    """Plain version of ``fused_depth_scan_packed``.

    ``word[i] = read_delta<<2 | gap_event<<1 | valid_event``; the prefix
    ``sw`` carries depth in bits 2..31, the in-gap state in bit 1 and the
    scan-window state in bit 0.  Returns (depth int32, flags int8) with
    bit0 rise, bit1 fall, bit2 change (forced at 0), bit3 in-gap.
    """
    sw = torch.cumsum(word, 0, dtype=torch.int32)
    # torch's >> on int32 is arithmetic: mask back to the logical shift
    raw = (sw >> 2) & 0x3FFFFFFF
    gap = (sw & 2) != 0
    valid = (sw & 1) != 0
    masked = torch.where(gap, 0, raw)
    rise, fall = rise_fall((masked > leftmost) & (masked <= rightmost) & valid)
    out = (
        rise.to(torch.int8)
        + fall.to(torch.int8) * 2
        + run_boundaries(raw).to(torch.int8) * 4
        + gap.to(torch.int8) * 8
    )
    return raw, out


def fused_depth_scan_packed(word: torch.Tensor, leftmost: int, rightmost: int):
    """(depth, flags) of a packed event word; see the plain version.

    Callers guarantee depth < 2^29 and that the gap and scan-window interval
    sets are each disjoint (so their prefix bits stay in {0, 1}).
    """
    if _route(word):
        return fused_depth_scan_packed_torch(word, leftmost, rightmost)
    return kernels.launch_packed_scan(word, leftmost, rightmost)


def fused_depth_scan_masked_torch(delta: torch.Tensor, gap: torch.Tensor,
                                  valid: torch.Tensor, leftmost: int,
                                  rightmost: int):
    """Plain version of ``fused_depth_scan_masked`` (pallas_scan.py
    ``fused_depth_scan_masked_xla``).

    ``gap`` and ``valid`` are int8 streams, nonzero meaning true.  Returns
    (raw depth int32; rise, fall and change as 0/1 int8): rise and fall are
    the edges of the gap-masked depth in ``(leftmost, rightmost]`` inside
    ``valid``; change marks the raw depth's run boundaries, forced at 0.
    """
    raw = torch.cumsum(delta, 0, dtype=torch.int32)
    masked = torch.where(gap != 0, 0, raw)
    rise, fall = rise_fall((masked > leftmost) & (masked <= rightmost) & (valid != 0))
    return (raw, rise.to(torch.int8), fall.to(torch.int8),
            run_boundaries(raw).to(torch.int8))


def fused_depth_scan_masked(delta: torch.Tensor, gap: torch.Tensor,
                            valid: torch.Tensor, leftmost: int, rightmost: int):
    """(raw depth, rise, fall, change); see the plain version."""
    if _route(delta):
        return fused_depth_scan_masked_torch(delta, gap, valid, leftmost, rightmost)
    return kernels.launch_masked_scan(delta, gap, valid, leftmost, rightmost)


def fused_depth_scan_flags_torch(delta: torch.Tensor, flags: torch.Tensor,
                                 leftmost: int, rightmost: int):
    """Plain version of ``fused_depth_scan_flags`` (pallas_scan.py
    ``fused_depth_scan_flags_xla``): the masked scan with gap = flags bit0
    and valid = flags bit1, its three streams packed as out bits 0-2."""
    raw, rise, fall, change = fused_depth_scan_masked_torch(
        delta, flags & 1, flags & 2, leftmost, rightmost
    )
    return raw, rise + fall * 2 + change * 4


def fused_depth_scan_flags(delta: torch.Tensor, flags: torch.Tensor,
                           leftmost: int, rightmost: int):
    """(raw depth int32, out flags int8: bit0 rise, bit1 fall, bit2 change)
    of an int32 read delta under int8 flags (bit0 in-gap, bit1 scan-window
    valid).  Exact at any depth: the sum wraps only mod 2^32."""
    if _route(delta):
        return fused_depth_scan_flags_torch(delta, flags, leftmost, rightmost)
    return kernels.launch_flags_scan(delta, flags, leftmost, rightmost)


def fused_depth_scan_torch(delta: torch.Tensor, valid: torch.Tensor,
                           leftmost: int, rightmost: int):
    """Plain version of ``fused_depth_scan`` (``_scan_kernel``; the JAX
    package has no XLA twin): (depth int32; rise and fall as 0/1 int8) of
    ``leftmost < depth <= rightmost`` inside ``valid != 0``."""
    depth = torch.cumsum(delta, 0, dtype=torch.int32)
    rise, fall = rise_fall((depth > leftmost) & (depth <= rightmost) & (valid != 0))
    return depth, rise.to(torch.int8), fall.to(torch.int8)


def fused_depth_scan(delta: torch.Tensor, valid: torch.Tensor, leftmost: int,
                     rightmost: int):
    """(depth, rise, fall) of a read delta; see the plain version."""
    if _route(delta):
        return fused_depth_scan_torch(delta, valid, leftmost, rightmost)
    return kernels.launch_edges_scan(delta, valid, leftmost, rightmost)


# ---------------------------------------------------------------------------
# stream compaction
# ---------------------------------------------------------------------------

def _signed_byte(m: int) -> int:
    """Mask m (1-255) as the int8 value of the same bits."""
    return m - 256 if m > 127 else m


def compact_flags_torch(x: torch.Tensor, masks) -> list[torch.Tensor]:
    """Plain version of ``compact_flags``: a mask and ``nonzero`` per mask."""
    return [torch.nonzero((x & _signed_byte(int(m))) != 0).squeeze(1) for m in masks]


CAPACITY_FLOOR_BYTES = 64 << 20


def capacity_for(bound: int | None, n: int, n_streams: int = 1,
                 values: bool = False) -> int | None:
    """A device caller's bound on each count of a compaction over ``n``
    slots, as the capacity to pass it; None (the kernel counts first) where
    the buffers it would size, 8 B an index per stream and 4 B a run depth
    (``values``), pass an eighth of a byte per slot or
    ``CAPACITY_FLOOR_BYTES``, whichever is more.  A bound is the scatter
    rows plus one, and the rows can outnumber the slots (the flags path
    holds 2^29 reads and more), so the bound alone could size a buffer of
    many bytes a slot."""
    if bound is None:
        return None
    size = min(bound, n) * (8 * n_streams + 4 * values)
    return bound if size <= max(n // 8, CAPACITY_FLOOR_BYTES) else None


def _count_overflow(name: str, capacity: int | None, totals) -> None:
    """The CPU route's side of the kernel's capacity: a call whose total
    exceeds the capacity counts in ``kernels.RELAUNCHES`` as it does on the
    card."""
    if capacity is not None and max(totals, default=0) > capacity:
        kernels.RELAUNCHES[name] += 1


def compact_flags(x: torch.Tensor, masks, capacity: int | None = None) -> list[torch.Tensor]:
    """Ascending int64 indices of the slots of a 1-D int8 tensor where
    ``(x & m) != 0``, one tensor per mask (1 to 3 masks, each 1-255), each
    exactly as long as its count.  A bool bitmap is this with mask 1 on
    ``bits.view(torch.int8)``.  The counts cost one host sync.

    ``capacity`` is the caller's bound on every count: the kernel writes
    into buffers of that size and launches again at the exact size where a
    count exceeds it (``kernels.RELAUNCHES``); without one it counts first.
    """
    masks = tuple(int(m) for m in masks)
    if x.dtype != torch.int8 or x.dim() != 1:
        raise ValueError(f"compact_flags: expected a 1-D int8 tensor, got {x.dtype} "
                         f"of shape {tuple(x.shape)}")
    if not 1 <= len(masks) <= 3 or not all(1 <= m <= 255 for m in masks):
        raise ValueError(f"compact_flags: expected 1 to 3 masks in 1..255, got {masks}")
    capacity = kernels.check_capacity(capacity)
    if _route(x):
        out = compact_flags_torch(x, masks)
        _count_overflow("compact_flags", capacity, [o.shape[0] for o in out])
        return out
    return kernels.launch_compact_flags(x, masks, capacity)


def compact_runs_torch(depth: torch.Tensor, carry: int | None = None):
    """Plain version of ``compact_runs``: the boundary bitmap, ``nonzero``
    and a gather."""
    change = torch.empty(depth.shape[0], dtype=torch.bool, device=depth.device)
    torch.ne(depth[1:], depth[:-1], out=change[1:])
    change[:1] = True if carry is None else depth[:1] != carry
    idx = torch.nonzero(change).squeeze(1)
    return idx, depth[idx]


def compact_runs(depth: torch.Tensor, carry: int | None = None,
                 capacity: int | None = None):
    """(int64 indices, int32 depths) of the run boundaries of a 1-D int32
    depth: ``depth[i] != depth[i-1]``, slot 0 compared against ``carry``
    (the depth just before it), or always a boundary when ``carry`` is
    None; each boundary with the depth of its run.  Exactly sized; the
    count costs one host sync.  ``capacity`` bounds the count as in
    ``compact_flags``."""
    if depth.dtype != torch.int32 or depth.dim() != 1:
        raise ValueError(f"compact_runs: expected a 1-D int32 tensor, got {depth.dtype} "
                         f"of shape {tuple(depth.shape)}")
    capacity = kernels.check_capacity(capacity)
    if _route(depth):
        idx, vals = compact_runs_torch(depth, carry)
        _count_overflow("compact_runs", capacity, [idx.shape[0]])
        return idx, vals
    return kernels.launch_compact_runs(depth, carry, capacity)
