"""BAM ingestion: packed fixed-width record columns.

The host packer replaces the reference's per-record pysam loop
(GCI.py:146-169) with a single pass that emits numpy columns ready for
vectorized filtering and device upload:

  ref_id, pos (reference_start), ref_end (pos + reference-consumed CIGAR
  span), qlen (l_seq, pysam's ``query_length``), mapq, flag,
  m/i/d/s/eq/x (per-op CIGAR base totals, pysam ``get_cigar_stats()[0]``),
  nm (NM tag value, -1 when absent), plus a 128-bit read-name key.

Default path is the C++ packer (gci_tpu_torch.native, multithreaded BGZF
inflate);
a pure-Python struct parser is the fallback so the framework works without a
toolchain.  Both produce identical columns and name keys.
"""
from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

from gci_tpu_torch.io.names import hash_names, key128

_COL_NAMES = (
    "ref_id", "pos", "ref_end", "qlen", "mapq", "flag",
    "m", "i", "d", "s", "eq", "x", "nm",
)

FLAG_UNMAPPED = 4
FLAG_SECONDARY = 256
FLAG_SUPPLEMENTARY = 2048


@dataclass
class BamData:
    references: list[str]
    lengths: list[int]
    header_text: str
    columns: dict[str, np.ndarray]
    name_keys: np.ndarray  # (n, 2) uint64
    names: list[bytes] | None = None
    body: bytes | None = None  # raw record stream (keep_raw)
    record_offsets: np.ndarray | None = None

    @property
    def n_records(self) -> int:
        return int(self.columns["ref_id"].shape[0])

    def targets_length(self) -> dict[str, int]:
        """BAM-header target->length map in header order (GCI.py:201-207)."""
        return dict(zip(self.references, self.lengths))


def read_bam_header(path: str) -> tuple[list[str], list[int]]:
    """References + lengths only (cheap; reads the first BGZF blocks)."""
    refs: list[str] = []
    lens: list[int] = []
    with gzip.open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", f.read(4))
        f.read(l_text)
        (n_ref,) = struct.unpack("<i", f.read(4))
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", f.read(4))
            name = f.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", f.read(4))
            refs.append(name)
            lens.append(l_ref)
    return refs, lens


def read_bam(
    path: str,
    threads: int = 4,
    keep_names: bool = True,
    keep_raw: bool = False,
) -> BamData:
    """Parse a whole BAM into packed columns (native packer, Python fallback).

    Without ``keep_raw`` this drains the bounded-memory stream (peak RSS is
    O(chunk), not O(inflated file)); ``keep_raw`` needs the full record body
    resident for filtered-BAM export, so it takes the whole-file path.
    """
    if not keep_raw:
        stream = BamStream(path, threads=threads, keep_names=keep_names)
        with stream:
            chunks = list(stream)
        cols = {
            k: (
                np.concatenate([c.columns[k] for c in chunks])
                if chunks else np.empty(0, dtype=np.int32)
            )
            for k in _COL_NAMES
        }
        keys = (
            np.concatenate([c.name_keys for c in chunks])
            if chunks
            else np.empty((0, 2), dtype=np.uint64)
        )
        names = None
        if keep_names:
            names = [n for c in chunks for n in (c.names or [])]
        return BamData(
            references=stream.references,
            lengths=stream.lengths,
            header_text=stream.header_text,
            columns=cols,
            name_keys=keys,
            names=names,
        )
    try:
        return _read_bam_native_whole(path, threads, keep_names, keep_raw)
    except (ImportError, OSError):
        return _read_bam_python(path, keep_names=keep_names, keep_raw=keep_raw)


def _read_bam_native_whole(
    path: str, threads: int, keep_names: bool, keep_raw: bool
) -> BamData:
    """Whole-file native parse (also the only path for uncompressed BAMs)."""
    from gci_tpu_torch.native import NativeBam

    nb = NativeBam(path, nthreads=threads, keep_names=keep_names, keep_raw=keep_raw)
    names = None
    if keep_names:
        offs = nb.name_offsets
        blob = nb.name_blob
        names = [bytes(blob[offs[i] : offs[i + 1]]) for i in range(len(offs) - 1)]
    return BamData(
        references=nb.references,
        lengths=nb.lengths,
        header_text=nb.header_text,
        columns=nb.columns,
        name_keys=key128(nb.name_hash, nb.name_hash2),
        names=names,
        body=nb.body,
        record_offsets=nb.record_offsets,
    )


@dataclass
class BamChunk:
    """One streamed batch of packed BAM record columns."""

    columns: dict[str, np.ndarray]
    name_keys: np.ndarray  # (n, 2) uint64
    names: list[bytes] | None = None
    body: bytes | None = None  # raw record bytes (keep_raw streams)
    record_offsets: np.ndarray | None = None

    @property
    def n_records(self) -> int:
        return int(self.columns["ref_id"].shape[0])


class BamStream:
    """Bounded-memory streaming BAM reader.

    The reference fetches (target, window) tasks via pysam (GCI.py:146-169,
    task split GCI.py:260-270) with the whole file resident in the BGZF
    layer; here a native producer thread streams BGZF chunks (read ->
    parallel inflate -> record parse) while the consumer filters the
    previous chunk, so peak memory is O(chunk), not O(file).

    ``comp_range=(start, end)`` restricts the stream to records that START
    in a BGZF block whose compressed file offset is inside [start, end) —
    the per-host input shard unit for multi-host runs.  Shards partition a
    file exactly: every record belongs to the one range containing its
    first byte's block.
    """

    def __init__(
        self,
        path: str,
        threads: int = 4,
        keep_names: bool = False,
        comp_range: tuple[int, int] | None = None,
        chunk_bytes: int | None = None,
        keep_raw: bool = False,
    ):
        self._path = path
        self._native = None
        self._fallback = None
        try:
            from gci_tpu_torch.native import NativeBamStream, UncompressedBamError

            try:
                self._native = NativeBamStream(
                    path, nthreads=threads, keep_names=keep_names,
                    comp_range=comp_range, chunk_bytes=chunk_bytes,
                    keep_raw=keep_raw,
                )
            except UncompressedBamError:
                # plain (non-BGZF) BAM: no block framing to stream; parse
                # whole-file (gci_native.cpp handles the uncompressed case)
                if comp_range is not None:
                    raise ValueError(
                        f"{path}: uncompressed BAM cannot be range-sharded"
                    )
                self._fallback = _read_bam_native_whole(
                    path, threads, keep_names, keep_raw
                )
        except (ImportError, OSError):
            if comp_range is not None:
                raise  # range shards need the native reader
            # pure-Python fallback: whole file as a single chunk
            self._fallback = _read_bam_python(
                path, keep_names=keep_names, keep_raw=keep_raw
            )
        src = self._native if self._native is not None else self._fallback
        self.references = src.references
        self.lengths = src.lengths
        self.header_text = src.header_text

    def targets_length(self) -> dict[str, int]:
        return dict(zip(self.references, self.lengths))

    def __iter__(self):
        if self._fallback is not None:
            fb = self._fallback
            yield BamChunk(
                columns=fb.columns, name_keys=fb.name_keys, names=fb.names,
                body=fb.body, record_offsets=fb.record_offsets,
            )
            return
        from gci_tpu_torch.io.names import key128

        for ch in self._native:
            yield BamChunk(
                columns=ch.columns,
                name_keys=key128(ch.name_hash, ch.name_hash2),
                names=ch.names,
                body=ch.body,
                record_offsets=ch.record_offsets,
            )

    def close(self) -> None:
        if self._native is not None:
            self._native.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# pure-Python fallback parser
# ---------------------------------------------------------------------------

_CIGAR_REF_CONSUME = {0, 2, 3, 7, 8}  # M D N = X


def _read_bam_python(path: str, keep_names: bool, keep_raw: bool) -> BamData:
    with gzip.open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM stream")
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4
    header_text = data[off : off + l_text].decode(errors="replace")
    off += l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    refs: list[str] = []
    lens: list[int] = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        refs.append(data[off : off + l_name - 1].decode())
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        lens.append(l_ref)

    body_start = off
    cols: dict[str, list[int]] = {k: [] for k in _COL_NAMES}
    names: list[bytes] = []
    rec_offs: list[int] = []
    n = len(data)
    while off + 4 <= n:
        (block_size,) = struct.unpack_from("<I", data, off)
        rec_offs.append(off - body_start)
        off += 4
        rec = data[off : off + block_size]
        ref_id, pos = struct.unpack_from("<ii", rec, 0)
        l_read_name = rec[8]
        mapq = rec[9]
        (n_cigar,) = struct.unpack_from("<H", rec, 12)
        (flag,) = struct.unpack_from("<H", rec, 14)
        (l_seq,) = struct.unpack_from("<i", rec, 16)
        name = rec[32 : 32 + l_read_name - 1]
        cig_off = 32 + l_read_name
        cigars = struct.unpack_from(f"<{n_cigar}I", rec, cig_off)
        aux_off = cig_off + 4 * n_cigar + (l_seq + 1) // 2 + l_seq
        nm, cg = _parse_aux(rec, aux_off)
        if cg is not None and n_cigar == 2 and (cigars[0] & 0xF) == 4 and (cigars[0] >> 4) == l_seq:
            cigars = cg
        stats = [0] * 9
        rspan = 0
        for c in cigars:
            op, ln = c & 0xF, c >> 4
            if op < 9:
                stats[op] += ln
            if op in _CIGAR_REF_CONSUME:
                rspan += ln
        cols["ref_id"].append(ref_id)
        cols["pos"].append(pos)
        cols["ref_end"].append(pos + rspan)
        cols["qlen"].append(l_seq)
        cols["mapq"].append(mapq)
        cols["flag"].append(flag)
        cols["m"].append(stats[0])
        cols["i"].append(stats[1])
        cols["d"].append(stats[2])
        cols["s"].append(stats[4])
        cols["eq"].append(stats[7])
        cols["x"].append(stats[8])
        cols["nm"].append(nm)
        names.append(name)
        off += block_size

    np_cols = {k: np.array(v, dtype=np.int32) for k, v in cols.items()}
    return BamData(
        references=refs,
        lengths=lens,
        header_text=header_text,
        columns=np_cols,
        name_keys=hash_names(names),
        names=names if keep_names else None,
        body=data[body_start:] if keep_raw else None,
        record_offsets=np.array(rec_offs, dtype=np.int64) if keep_raw else None,
    )


_AUX_SIZE = {
    ord("A"): 1, ord("c"): 1, ord("C"): 1,
    ord("s"): 2, ord("S"): 2,
    ord("i"): 4, ord("I"): 4, ord("f"): 4, ord("d"): 8,
}
_AUX_FMT = {
    ord("c"): "<b", ord("C"): "<B", ord("s"): "<h", ord("S"): "<H",
    ord("i"): "<i", ord("I"): "<I",
}


def _parse_aux(rec: bytes, off: int) -> tuple[int, tuple | None]:
    """Scan aux tags for NM (int value, -1 if absent) and CG long cigar."""
    nm = -1
    cg = None
    n = len(rec)
    while off + 3 <= n:
        tag = rec[off : off + 2]
        typ = rec[off + 2]
        off += 3
        if typ in (ord("Z"), ord("H")):
            end = rec.index(b"\x00", off)
            off = end + 1
        elif typ == ord("B"):
            sub = rec[off]
            (cnt,) = struct.unpack_from("<I", rec, off + 1)
            es = _AUX_SIZE.get(sub)
            if es is None:
                break
            if tag == b"CG" and sub == ord("I"):
                cg = struct.unpack_from(f"<{cnt}I", rec, off + 5)
            off += 5 + es * cnt
        else:
            es = _AUX_SIZE.get(typ)
            if es is None:
                break
            if tag == b"NM" and typ in _AUX_FMT:
                (nm,) = struct.unpack_from(_AUX_FMT[typ], rec, off)
            off += es
    return nm, cg
