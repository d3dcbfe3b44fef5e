"""BAM writing (from-scratch): header/record encoding + BGZF framing.

Used by the synthetic-alignment test fixtures and by the filtered-BAM export
tool (the native replacement for the reference's pysam write + subprocessed
``samtools sort``/``index``, utility/filter_bam.py:196-210).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_CODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}

# byte -> 4-bit code lookup (unknown bases -> N=15), upper and lower case
_SEQ_LUT = np.full(256, 15, dtype=np.uint8)
for _c, _i in _SEQ_CODE.items():
    _SEQ_LUT[ord(_c)] = _i
    _SEQ_LUT[ord(_c.lower())] = _i


def _pack_seq(seq: str) -> bytes:
    """4-bit pack a base string (vectorized; the hot part of record encode)."""
    codes = _SEQ_LUT[np.frombuffer(seq.encode(), dtype=np.uint8)]
    if codes.shape[0] % 2:
        codes = np.concatenate([codes, np.zeros(1, np.uint8)])
    return ((codes[0::2] << 4) | codes[1::2]).tobytes()


def encode_cigar(cigar: str) -> list[int]:
    """'100M2I3S' -> BAM op words (len<<4 | op)."""
    out = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append((int(num) << 4) | _CIGAR_OPS.index(ch))
            num = ""
    if num:
        raise ValueError(f"bad cigar: {cigar}")
    return out


def build_header(
    references: list[str],
    lengths: list[int],
    header_text: str | None = None,
) -> bytes:
    if header_text is None:
        header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{r}\tLN:{l}\n" for r, l in zip(references, lengths)
        )
    ht = header_text.encode()
    parts = [b"BAM\x01", struct.pack("<i", len(ht)), ht, struct.pack("<i", len(references))]
    for r, l in zip(references, lengths):
        nb = r.encode() + b"\x00"
        parts.append(struct.pack("<i", len(nb)))
        parts.append(nb)
        parts.append(struct.pack("<i", int(l)))
    return b"".join(parts)


def build_record(
    name: str | bytes,
    ref_id: int,
    pos: int,
    mapq: int,
    cigar: str,
    flag: int = 0,
    seq_len: int | None = None,
    nm: int | None = 0,
    seq: str | None = None,
    extra_tags: bytes = b"",
) -> bytes:
    """Encode one alignment record.

    ``seq_len`` defaults to the query length implied by the CIGAR
    (M/I/S/=/X); the sequence itself is synthesized as 'A's unless given.
    """
    if isinstance(name, str):
        name = name.encode()
    ops = encode_cigar(cigar)
    q_consume = {0, 1, 4, 7, 8}
    implied = sum(c >> 4 for c in ops if (c & 0xF) in q_consume)
    l_seq = implied if seq_len is None else seq_len
    if seq is None:
        packed_seq = b"\x11" * (l_seq // 2) + (b"\x10" if l_seq % 2 else b"")  # all 'A'
    else:
        packed_seq = _pack_seq(seq)
    qual = b"\xff" * l_seq
    name_z = name + b"\x00"
    tags = b""
    if nm is not None:
        tags += b"NMi" + struct.pack("<i", nm)
    tags += extra_tags
    body = (
        struct.pack(
            "<iiBBHHHiiii",
            ref_id,
            pos,
            len(name_z),
            mapq,
            0,  # bin (unused by our reader)
            len(ops),
            flag,
            l_seq,
            -1,
            -1,
            0,
        )
        + name_z
        + struct.pack(f"<{len(ops)}I", *ops)
        + bytes(packed_seq)
        + qual
        + tags
    )
    return struct.pack("<I", len(body)) + body


def bgzf_compress(data: bytes, level: int = 6, threads: int = 4) -> bytes:
    """BGZF-frame arbitrary bytes (native fast path, Python fallback)."""
    try:
        from gci_tpu_torch.native import bgzf_compress_native

        return bgzf_compress_native(data, level, threads)
    except (ImportError, OSError):
        return _bgzf_compress_py(data, level)


_BGZF_EOF = bytes(
    [0x1F, 0x8B, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xFF, 0x06, 0x00,
     0x42, 0x43, 0x02, 0x00, 0x1B, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
     0x00, 0x00, 0x00, 0x00]
)


def _bgzf_compress_py(data: bytes, level: int) -> bytes:
    out = bytearray()
    CHUNK = 0xFF00
    for s in range(0, max(len(data), 1), CHUNK):
        chunk = data[s : s + CHUNK]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        comp = co.compress(chunk) + co.flush()
        bsize = len(comp) + 26
        out += bytes([0x1F, 0x8B, 8, 4, 0, 0, 0, 0, 0, 0xFF, 6, 0])
        out += bytes([66, 67, 2, 0, (bsize - 1) & 0xFF, ((bsize - 1) >> 8) & 0xFF])
        out += comp
        out += struct.pack("<II", zlib.crc32(chunk), len(chunk))
    out += _BGZF_EOF
    return bytes(out)


def write_bam(
    path: str,
    references: list[str],
    lengths: list[int],
    records: list[bytes],
    header_text: str | None = None,
    level: int = 6,
    threads: int = 4,
) -> None:
    payload = build_header(references, lengths, header_text) + b"".join(records)
    with open(path, "wb") as f:
        f.write(bgzf_compress(payload, level, threads))


def write_bam_stream(
    path: str,
    references: list[str],
    lengths: list[int],
    record_iter,
    header_text: str | None = None,
    level: int = 6,
    threads: int = 4,
    batch_bytes: int = 1 << 28,
) -> None:
    """Write a BAM from a record *iterator* with bounded memory.

    Records are compressed in ~``batch_bytes`` BGZF member groups as they
    arrive (BGZF blocks are independent; readers see one stream), so a
    multi-GB BAM never materializes uncompressed in RAM.  One EOF block
    terminates the file.
    """
    with open(path, "wb") as f:
        buf: list[bytes] = [build_header(references, lengths, header_text)]
        size = len(buf[0])

        def flush():
            nonlocal buf, size
            if not buf:
                return
            blob = bgzf_compress(b"".join(buf), level, threads)
            f.write(blob[:-28])  # strip the per-call EOF block
            buf, size = [], 0

        for rec in record_iter:
            buf.append(rec)
            size += len(rec)
            if size >= batch_bytes:
                flush()
        flush()
        f.write(_BGZF_EOF)


def sort_record_blobs(records: list[bytes]) -> list[bytes]:
    """Coordinate-sort encoded records (replacement for `samtools sort`)."""
    def sort_key(rec: bytes):
        ref_id, pos = struct.unpack_from("<ii", rec, 4)
        # unmapped (ref_id == -1) sort last, like samtools
        return (ref_id if ref_id >= 0 else np.iinfo(np.int32).max, pos)

    return sorted(records, key=sort_key)
