"""BAI (BAM index) writer (counterpart of ``gci_tpu.io.bai``, copied).

Native replacement for `samtools index`.

Implements the SAM spec's binning index: R-tree bins via reg2bin, 16 kb
linear index, BGZF virtual file offsets.  Works with BAM files produced by
gci_tpu_torch.io.bam_writer (fixed 0xff00-byte BGZF payload chunking, which makes
uncompressed-offset -> virtual-offset mapping deterministic).
"""
from __future__ import annotations

import struct

import numpy as np

CHUNK = 0xFF00


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def bgzf_block_offsets(blob: bytes) -> np.ndarray:
    """Compressed file offset of each BGZF block (scans BSIZE fields)."""
    offs = []
    off = 0
    n = len(blob)
    while off + 18 <= n:
        xlen = blob[off + 10] | (blob[off + 11] << 8)
        bsize = None
        q = off + 12
        qe = q + xlen
        while q + 4 <= qe:
            slen = blob[q + 2] | (blob[q + 3] << 8)
            if blob[q] == 66 and blob[q + 1] == 67 and slen == 2:
                bsize = (blob[q + 4] | (blob[q + 5] << 8)) + 1
            q += 4 + slen
        if bsize is None:
            raise ValueError("not a BGZF stream")
        offs.append(off)
        off += bsize
    return np.array(offs, dtype=np.int64)


def voffset(coffsets: np.ndarray, payload_off: int) -> int:
    """Virtual offset for an uncompressed payload byte offset."""
    block = payload_off // CHUNK
    return (int(coffsets[block]) << 16) | (payload_off % CHUNK)


def write_bai(
    path: str,
    n_ref: int,
    ref_ids: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    payload_offsets: np.ndarray,  # uncompressed offset of each record's block_size field
    payload_end_offsets: np.ndarray,
    bgzf_blob: bytes,
) -> None:
    coffsets = bgzf_block_offsets(bgzf_blob)
    out = [b"BAI\x01", struct.pack("<i", n_ref)]
    order = np.argsort(ref_ids, kind="stable")
    for ref in range(n_ref):
        sel = order[ref_ids[order] == ref]
        bins: dict[int, list[tuple[int, int]]] = {}
        n_intv = 0
        linear: dict[int, int] = {}
        for k in sel.tolist():
            beg, end = int(starts[k]), int(ends[k])
            if end <= beg:
                end = beg + 1
            b = reg2bin(beg, end)
            vo_s = voffset(coffsets, int(payload_offsets[k]))
            vo_e = voffset(coffsets, int(payload_end_offsets[k]))
            bins.setdefault(b, []).append((vo_s, vo_e))
            for w in range(beg >> 14, ((end - 1) >> 14) + 1):
                if w not in linear or vo_s < linear[w]:
                    linear[w] = vo_s
                n_intv = max(n_intv, w + 1)
        out.append(struct.pack("<i", len(bins)))
        for b in sorted(bins):
            chunks = bins[b]
            # merge adjacent chunks
            merged = []
            for s, e in chunks:
                if merged and s <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], e))
                else:
                    merged.append((s, e))
            out.append(struct.pack("<Ii", b, len(merged)))
            for s, e in merged:
                out.append(struct.pack("<QQ", s, e))
        out.append(struct.pack("<i", n_intv))
        filled = 0
        for w in range(n_intv):
            if w in linear:
                filled = linear[w]
            out.append(struct.pack("<Q", linear.get(w, filled)))
        # note: empty windows inherit the previous filled offset (htslib style)
    out.append(struct.pack("<Q", 0))  # n_no_coor
    with open(path, "wb") as f:
        f.write(b"".join(out))
