"""PAF ingestion -> packed columns.

Column contract (reference: GCI.py:218-229): query name, query length,
query start/end, target name, target start/end, num matching residues,
alignment block length, mapq (PAF standard columns 1-12; columns 5 and 7
unused by the cascade).  Extension/optional fields are ignored.

Targets are a deduped table (``target_names``) with per-row int32 ``tid``
— a multi-million-row PAF maps to a handful of contigs, so per-row Python
strings would be pure object churn.  ``targets`` materializes the per-row
string list lazily for oracle/test use.  ``byte_range=(lo, hi)`` parses
only the lines whose first byte lies in the half-open range — the
per-host input shard of a shared PAF (ranges partition the row stream).
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass, field

import numpy as np

from gci_tpu_torch.io.names import hash_names


@dataclass
class PafData:
    _names: list[bytes] | None
    name_keys: np.ndarray  # (n, 2) uint64
    tid: np.ndarray  # (n,) int32 into target_names
    target_names: list[str]
    qlen: np.ndarray
    qstart: np.ndarray
    qend: np.ndarray
    tstart: np.ndarray
    tend: np.ndarray
    nmatch: np.ndarray
    alnlen: np.ndarray
    mapq: np.ndarray
    _name_blob: bytes | None = field(default=None, repr=False)
    _name_offsets: np.ndarray | None = field(default=None, repr=False)
    _targets: list[str] | None = field(default=None, repr=False)

    @property
    def n_records(self) -> int:
        return int(self.name_keys.shape[0])

    @property
    def targets(self) -> list[str]:
        """Per-row target names (materialized once, on demand)."""
        if self._targets is None:
            self._targets = [
                self.target_names[t] for t in self.tid.tolist()
            ]
        return self._targets

    @property
    def names(self) -> list[bytes]:
        """Per-row query names (materialized on demand)."""
        if self._names is None:
            offs = self._name_offsets
            blob = self._name_blob
            self._names = [
                bytes(blob[offs[i] : offs[i + 1]])
                for i in range(self.n_records)
            ]
        return self._names


def read_paf(
    path: str,
    threads: int = 2,
    byte_range: tuple[int, int] | None = None,
    shard: tuple[int, int] | None = None,
) -> PafData:
    """Parse a PAF file (native C++ fast path, Python fallback).

    ``shard=(h, H)`` parses host h's [n*h/H, n*(h+1)/H) line range of the
    UNCOMPRESSED bytes — valid for .paf and .paf.gz alike (gzip has no
    random access, so every host still inflates the whole stream, but the
    tokenize — the expensive part — splits H ways; ranges computed
    post-inflate agree on every host, so shards partition the rows).
    """
    try:
        from gci_tpu_torch.native import NativePaf

        np_ = NativePaf(path, nthreads=threads, byte_range=byte_range,
                        shard=shard)
        ints = np_.ints
        return PafData(
            _names=None,
            name_keys=np.stack([np_.name_hash, np_.name_hash2], axis=1),
            tid=np_.tid,
            target_names=np_.target_names,
            qlen=ints[:, 0],
            qstart=ints[:, 1],
            qend=ints[:, 2],
            tstart=ints[:, 3],
            tend=ints[:, 4],
            nmatch=ints[:, 5],
            alnlen=ints[:, 6],
            mapq=ints[:, 7],
            _name_blob=np_.name_blob,
            _name_offsets=np_.name_offsets,
        )
    except (ImportError, OSError):
        return _read_paf_python(path, byte_range, shard)


def _read_paf_python(
    path: str,
    byte_range: tuple[int, int] | None = None,
    shard: tuple[int, int] | None = None,
) -> PafData:
    names: list[bytes] = []
    tids: list[int] = []
    target_names: list[str] = []
    target_lookup: dict[str, int] = {}
    ints: list[tuple[int, int, int, int, int, int, int, int]] = []
    if path.endswith(".gz"):
        if byte_range is not None:
            raise ValueError("byte_range unsupported for gzipped PAF")
        opener = gzip.open
    else:
        opener = open
    if shard is not None:
        h, H = shard
        with opener(path, "rb") as f:
            data = f.read()
        if H > 1:
            lo = len(data) * h // H
            hi = len(data) * (h + 1) // H if h < H - 1 else len(data)
            s0 = lo
            if s0 > 0:
                nl = data.find(b"\n", s0 - 1)
                s0 = nl + 1 if nl >= 0 else len(data)
            e0 = hi
            if e0 > s0 and e0 < len(data) and data[e0 - 1: e0] != b"\n":
                nl = data.find(b"\n", e0)
                e0 = nl + 1 if nl >= 0 else len(data)
            data = data[s0:e0] if s0 < e0 else b""
        lines = data.splitlines()
    else:
        with opener(path, "rb") as f:
            if byte_range is not None:
                lo, hi = byte_range
                if lo > 0:
                    f.seek(lo - 1)
                    f.readline()  # partial line: owned by the previous shard
                data = f.read(max(hi - f.tell(), 0))
                # the shard owns every line *starting* before hi: finish the
                # last line if the range cut it mid-line
                tail = f.readline() if data and data[-1:] != b"\n" else b""
                lines = (data + tail).splitlines()
            else:
                lines = f.read().splitlines()
    for line in lines:
        p = line.rstrip(b"\r").split(b"\t")
        if len(p) < 12:
            continue
        names.append(p[0])
        t = p[5].decode()
        k = target_lookup.get(t)
        if k is None:
            k = len(target_names)
            target_lookup[t] = k
            target_names.append(t)
        tids.append(k)
        ints.append(
            (
                int(p[1]), int(p[2]), int(p[3]),
                int(p[7]), int(p[8]), int(p[9]), int(p[10]), int(p[11]),
            )
        )
    arr = np.array(ints, dtype=np.int64).reshape(-1, 8)
    return PafData(
        _names=names,
        name_keys=hash_names(names),
        tid=np.array(tids, dtype=np.int32),
        target_names=target_names,
        qlen=arr[:, 0],
        qstart=arr[:, 1],
        qend=arr[:, 2],
        tstart=arr[:, 3],
        tend=arr[:, 4],
        nmatch=arr[:, 5],
        alnlen=arr[:, 6],
        mapq=arr[:, 7],
    )
