"""FASTA ingestion: record ids/lengths and N-gap (assembly gap) scanning.

Behavioral contract (reference: GCI.py:18-46 ``get_Ns_ref``): every maximal
run of ``N``/``n`` in each record yields a half-open interval
``(start, end)`` in sequence coordinates; records with no Ns are absent from
the result; an assembly with no Ns at all yields ``None``.

Implementation is vectorized over the raw byte buffer (no per-base Python
loop): newline-compaction + boolean run extraction.
Plain and gzip-compressed FASTA are supported.
"""
from __future__ import annotations

import gzip

import numpy as np

_NL = 10  # \n
_CR = 13  # \r
_GT = 62  # >


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _iter_records(data: bytes):
    """Yield (record_id, raw_sequence_slice) pairs from FASTA bytes."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = arr.shape[0]
    if n == 0:
        return
    # line starts
    nl = np.flatnonzero(arr == _NL)
    starts = np.concatenate(([0], nl + 1))
    starts = starts[starts < n]
    header_starts = starts[arr[starts] == _GT]
    # end of each header line
    header_line_end = np.searchsorted(nl, header_starts)
    for k, hs in enumerate(header_starts):
        line_end = nl[header_line_end[k]] if header_line_end[k] < nl.shape[0] else n
        header = data[hs + 1 : line_end].split(b"\r")[0]
        record_id = header.split(None, 1)[0].decode() if header.strip() else ""
        seq_start = line_end + 1
        seq_end = header_starts[k + 1] if k + 1 < header_starts.shape[0] else n
        yield record_id, arr[seq_start:seq_end]


def _compact_sequence(raw: np.ndarray) -> np.ndarray:
    """Strip newlines/CR/whitespace from a raw sequence byte slice."""
    keep = (raw != _NL) & (raw != _CR) & (raw != 32) & (raw != 9)
    return raw[keep]


def read_fasta_lengths(path: str) -> dict[str, int]:
    """Record id -> sequence length, in file order (GCI.py:939-941 usage)."""
    data = _read_bytes(path)
    return {
        rid: int(_compact_sequence(raw).shape[0]) for rid, raw in _iter_records(data)
    }


def scan_fasta_gaps(path: str) -> dict[str, list[tuple[int, int]]] | None:
    """Find maximal N/n runs per record (GCI.py:18-35 semantics).

    Returns {target: [(start, end), ...]} for targets that contain gaps, or
    None when the assembly has no Ns (matching the reference's sentinel).
    Also returns per-record lengths via ``read_fasta_lengths`` if needed
    separately.
    """
    data = _read_bytes(path)
    gaps: dict[str, list[tuple[int, int]]] = {}
    for rid, raw in _iter_records(data):
        seq = _compact_sequence(raw)
        is_n = (seq == 78) | (seq == 110)  # 'N' | 'n'
        if not is_n.any():
            continue
        m = is_n.astype(np.int8)
        d = np.diff(m)
        starts = np.flatnonzero(d == 1) + 1
        ends = np.flatnonzero(d == -1) + 1
        if m[0]:
            starts = np.concatenate(([0], starts))
        if m[-1]:
            ends = np.concatenate((ends, [m.shape[0]]))
        segs = [(int(s), int(e)) for s, e in zip(starts, ends)]
        if segs:
            gaps[rid] = segs
    return gaps if gaps else None


def scan_fasta(
    path: str,
) -> tuple[dict[str, int], dict[str, list[tuple[int, int]]] | None]:
    """ONE-pass scan: (record->length, N-gap dict or None).

    Serves both the reference's record consistency check (GCI.py:939-941)
    and get_Ns_ref (GCI.py:18-46) with a single file read.  Native C++
    scanner when available, numpy fallback otherwise.
    """
    try:
        from gci_tpu_torch.native import scan_fasta_native

        lengths, gaps = scan_fasta_native(path)
        return lengths, (gaps if gaps else None)
    except (ImportError, OSError):
        return read_fasta_lengths(path), scan_fasta_gaps(path)


def mask_gaps_in_depths(
    depths: dict[str, np.ndarray],
    gaps: dict[str, list[tuple[int, int]]] | None,
) -> dict[str, np.ndarray]:
    """Zero depth over gap intervals in-place (reference GCI.py:315-329).

    Values may be per-base arrays or event-space ``DepthEvents``.
    """
    if gaps is None:
        return depths
    from gci_tpu_torch.depth.base import ResidentDepth
    from gci_tpu_torch.depth.eventspace import DepthEvents

    if isinstance(depths, ResidentDepth):
        return depths.mask_gaps(gaps)

    for target, segments in gaps.items():
        if target in depths:
            d = depths[target]
            if isinstance(d, DepthEvents):
                depths[target] = d.mask_intervals(segments)
            else:
                for start, end in segments:
                    d[start:end] = 0
    return depths
