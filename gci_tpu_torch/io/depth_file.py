"""``.depth.gz`` checkpoint codec (counterpart of ``gci_tpu.io.depth_file``).

Format: gzip-compressed text, one ``>target`` header line per target
followed by one decimal depth per base per line (GCI.py:113-117 writer,
utility/GCI_score.py:11-39 reader).  Copied from the JAX package: the
readers (``decode_depth_text``, ``read_depth_gz``, ``read_depth_gz_events``,
``iter_depth_targets``) whole, and the writer ``write_depth_gz`` with
its multi-process form and the run-length and text helpers it needs, so
the bytes are the reference writer's.
"""
from __future__ import annotations

import gzip
import os

import numpy as np

from gci_tpu_torch.depth.base import ResidentDepth
from gci_tpu_torch.depth.eventspace import DepthEvents
from gci_tpu_torch.parallel.distributed import (
    allgather_concat,
    is_primary_host,
    process_count,
    process_index,
)

_NL = 10
_GT = 62


def _parse_uint_lines(arr: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorized decimal parse of fixed positions: value per (start, len) line."""
    out = np.zeros(starts.shape[0], dtype=np.int64)
    if starts.shape[0] == 0:
        return out
    max_w = int(lens.max())
    for w in range(1, max_w + 1):
        sel = lens == w
        if not sel.any():
            continue
        s = starts[sel]
        vals = np.zeros(s.shape[0], dtype=np.int64)
        for j in range(w):
            vals = vals * 10 + (arr[s + j].astype(np.int64) - 48)
        out[sel] = vals
    return out


def decode_depth_text(data: bytes) -> dict[str, np.ndarray]:
    """Decode uncompressed depth text into {target: int64 array}."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = arr.shape[0]
    if n == 0:
        return {}
    nl = np.flatnonzero(arr == _NL)
    # tolerate a missing trailing newline
    if nl.shape[0] == 0 or nl[-1] != n - 1:
        nl = np.concatenate((nl, [n]))
    starts = np.concatenate(([0], nl[:-1] + 1)).astype(np.int64)
    lens = nl - starts
    # drop empty lines (e.g. trailing)
    keep = lens > 0
    starts, lens = starts[keep], lens[keep]
    is_header = arr[starts] == _GT
    header_idx = np.flatnonzero(is_header)
    if header_idx.shape[0] == 0:
        raise ValueError("depth file has no '>' target header")
    values = np.zeros(starts.shape[0], dtype=np.int64)
    num_sel = ~is_header
    values[num_sel] = _parse_uint_lines(arr, starts[num_sel], lens[num_sel])

    out: dict[str, np.ndarray] = {}
    bounds = np.concatenate((header_idx, [starts.shape[0]]))
    for k in range(header_idx.shape[0]):
        hs = starts[header_idx[k]]
        # reference splits on '>' and takes the last field (GCI_score.py:32)
        name = data[hs : hs + lens[header_idx[k]]].decode().strip().split(">")[-1]
        out[name] = values[bounds[k] + 1 : bounds[k + 1]].copy()
    return out


def read_depth_gz(path: str) -> tuple[dict[str, np.ndarray], dict[str, int]]:
    """Read a .depth.gz checkpoint -> (depths, targets_length).

    Mirrors utility/GCI_score.py:11-39 ``parse_depth``.
    """
    try:
        from gci_tpu_torch.native import decode_depth_file_native

        depths = decode_depth_file_native(path)
    except (ImportError, OSError):
        with gzip.open(path, "rb") as f:
            data = f.read()
        depths = decode_depth_text(data)
    targets_length = {t: int(v.shape[0]) for t, v in depths.items()}
    return depths, targets_length


def read_depth_gz_events(path: str):
    """Read a .depth.gz checkpoint into event space (O(runs), not O(genome)).

    Returns (dict target -> DepthEvents, targets_length).  Same content
    contract as ``read_depth_gz`` (utility/GCI_score.py:11-39), but resuming
    a whole-genome run costs run-count memory instead of per-base arrays.
    """
    def from_runs(values: np.ndarray, counts: np.ndarray) -> DepthEvents:
        if values.shape[0] == 0:
            return DepthEvents(
                np.zeros(1, np.int64), np.zeros(1, np.int64), 0
            )
        bounds = np.concatenate(([0], np.cumsum(counts)[:-1]))
        return DepthEvents(bounds, values, int(counts.sum()))

    try:
        from gci_tpu_torch.native import decode_depth_runs_native

        runs = decode_depth_runs_native(path)
        depths = {t: from_runs(v, c) for t, (v, c) in runs.items()}
    except (ImportError, OSError):
        arrays, _ = read_depth_gz(path)
        depths = {}
        for t, a in arrays.items():
            if a.shape[0] == 0:
                depths[t] = from_runs(np.zeros(0, np.int64), np.zeros(0, np.int64))
                continue
            b = np.flatnonzero(np.diff(a) != 0) + 1
            bounds = np.concatenate(([0], b))
            depths[t] = DepthEvents(bounds, a[bounds].astype(np.int64), int(a.size))
    targets_length = {t: ev.length for t, ev in depths.items()}
    return depths, targets_length


def iter_depth_targets(path: str, chunk_bytes: int = 1 << 25):
    """Stream a .depth.gz checkpoint target-by-target: yields (name, int64).

    O(one target + one inflate chunk) memory instead of O(genome) — the
    streaming analogue of ``read_depth_gz`` (format: GCI.py:113-117).  An
    early-`break` by the consumer closes the file without inflating the
    rest (the reference's SynchronizedDepthReader early-exit,
    depth_plotter_v2.py:690-799).  Values are parsed with the same
    vectorized decimal decoder as the batch reader.
    """

    def parse_block(block: bytes) -> np.ndarray:
        arr = np.frombuffer(block, dtype=np.uint8)
        if arr.shape[0] == 0:
            return np.empty(0, np.int64)
        nl = np.flatnonzero(arr == _NL)
        starts = np.concatenate(([0], nl[:-1] + 1)).astype(np.int64)
        lens = nl - starts
        keep = lens > 0
        return _parse_uint_lines(arr, starts[keep], lens[keep])

    name: str | None = None
    parts: list[np.ndarray] = []
    pending = b""
    with gzip.open(path, "rb") as f:
        while True:
            data = f.read(chunk_bytes)
            if not data:
                break
            data = pending + data
            cut = data.rfind(b"\n")
            if cut < 0:
                pending = data
                continue
            pending = data[cut + 1 :]
            block = data[: cut + 1]
            pos = 0
            n = len(block)
            while pos < n:
                if block[pos : pos + 1] == b">":
                    nl_pos = block.find(b"\n", pos)
                    if name is not None:
                        yield name, (
                            np.concatenate(parts) if parts else np.empty(0, np.int64)
                        )
                    # reference header parse: last '>'-field (GCI_score.py:32)
                    name = block[pos:nl_pos].decode().strip().split(">")[-1]
                    parts = []
                    pos = nl_pos + 1
                else:
                    # '>' only occurs at line starts (value lines are digits)
                    nxt = block.find(b">", pos)
                    end = nxt if nxt >= 0 else n
                    parts.append(parse_block(block[pos:end]))
                    pos = end
    if pending:  # final line without trailing newline
        if pending.startswith(b">"):
            if name is not None:
                yield name, (
                    np.concatenate(parts) if parts else np.empty(0, np.int64)
                )
            name = pending.decode().strip().split(">")[-1]
            parts = []
        else:
            parts.append(parse_block(pending + b"\n"))
    if name is not None:
        yield name, (np.concatenate(parts) if parts else np.empty(0, np.int64))


def _encode_uint_lines(vals: np.ndarray) -> bytes:
    """Vectorized 'one decimal int per line' encoding."""
    n = vals.shape[0]
    if n == 0:
        return b""
    if vals.min() < 0:
        raise ValueError("negative depth value")
    # digits per value
    widths = np.ones(n, dtype=np.int64)
    v = vals.copy()
    big = v >= 10
    while big.any():
        v[big] //= 10
        widths[big] += 1
        big = v >= 10
    line_len = widths + 1
    offs = np.concatenate(([0], np.cumsum(line_len)))
    buf = np.empty(offs[-1], dtype=np.uint8)
    buf[offs[1:] - 1] = _NL
    # fill digits from least significant, right-aligned before the newline
    right = offs[1:] - 2  # rightmost digit position per line
    for j in range(int(widths.max())):
        active = widths > j
        d = ((vals[active] // (10**j)) % 10).astype(np.uint8) + 48
        buf[right[active] - j] = d
    return buf.tobytes()


def _encode_rle_lines(values: np.ndarray, counts: np.ndarray) -> bytes:
    """'value\\n' repeated count times per run — byte-identical to per-base."""
    try:
        from gci_tpu_torch.native import encode_depth_runs_native

        return encode_depth_runs_native(values, counts)
    except (ImportError, OSError):
        pass
    parts: list[bytes] = []
    for v, c in zip(values.tolist(), counts.tolist()):
        parts.append(b"%d\n" % v * c)
    return b"".join(parts)


def _target_text(vals) -> bytes:
    """Per-base text for one target: per-base array or DepthEvents."""
    if isinstance(vals, DepthEvents):
        return _encode_rle_lines(*vals.run_lengths())
    try:
        from gci_tpu_torch.native import encode_depth_lines_native

        return encode_depth_lines_native(np.asarray(vals, dtype=np.int64))
    except (ImportError, OSError):
        return _encode_uint_lines(np.asarray(vals, dtype=np.int64))


def _target_runs(vals) -> tuple[np.ndarray, np.ndarray]:
    """(values, counts) run-length form of one target's depth."""
    if isinstance(vals, DepthEvents):
        return vals.run_lengths()
    a = np.asarray(vals, dtype=np.int64)
    if a.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    b = np.flatnonzero(np.diff(a) != 0) + 1
    bounds = np.concatenate(([0], b))
    counts = np.diff(np.concatenate((bounds, [a.shape[0]])))
    return a[bounds], counts


def _bgzf_ranges(depths: dict, compresslevel: int) -> list[np.ndarray]:
    """This process's disjoint BGZF block range of every target, encoded.

    The runs->BGZF encoder frames blocks at fixed uncompressed byte offsets,
    so the processes' ranges concatenate to exactly the single writer's
    bytes: the reference's per-chunk gzip fan-out plus ``cat``
    (GCI.py:99-143), spread over processes.  Raises ImportError or OSError
    without the native encoder.
    """
    from gci_tpu_torch.native import (
        depth_runs_bgzf_nblocks_native,
        depth_runs_to_bgzf_range_native,
    )

    h, H = process_index(), process_count()
    nthreads = os.cpu_count() or 1
    local: list[np.ndarray] = []
    for target, vals in depths.items():
        values, counts = _target_runs(vals)
        header = b">" + target.encode() + b"\n"
        nblocks = depth_runs_bgzf_nblocks_native(values, counts, len(header))
        lo = nblocks * h // H
        hi = nblocks * (h + 1) // H if h < H - 1 else nblocks
        blob = depth_runs_to_bgzf_range_native(
            values, counts, header, lo, hi, compresslevel, nthreads
        )
        local.append(np.frombuffer(blob, dtype=np.uint8))
    return local


def write_depth_gz(path: str, depths: dict, compresslevel: int = 1) -> None:
    """Write the .depth.gz checkpoint (content-identical to GCI.py:113-117).

    Values may be per-base arrays, event-space ``DepthEvents`` or a
    device-resident depth (read back as run boundaries only, O(runs)).
    BGZF-framed through the native runs->BGZF encoder when it loads, one
    gzip member of the same text otherwise.  On a multi-process run every
    process takes part in the readback, and, with the native encoder, the
    processes compress disjoint block ranges that the primary concatenates
    into the single writer's bytes.
    """
    if isinstance(depths, ResidentDepth):
        depths = depths.to_events()
    if process_count() > 1:
        try:
            local = _bgzf_ranges(depths, compresslevel)
        except (ImportError, OSError):
            local = None  # no native codec: the single writer below
        if local is not None:
            # one gather per target: blob lengths differ per target, and
            # allgather_concat sizes its padding off a single shared row count
            gathered = [allgather_concat([arr])[0] for arr in local]
            if is_primary_host():
                from gci_tpu_torch.native import bgzf_eof_native

                with open(path, "wb") as f:
                    for blob in gathered:
                        f.write(blob.tobytes())
                    f.write(bgzf_eof_native())
            return
    if not is_primary_host():
        return
    try:
        from gci_tpu_torch.native import bgzf_eof_native, depth_runs_to_bgzf_native

        nthreads = os.cpu_count() or 1
        with open(path, "wb") as f:
            for target, vals in depths.items():
                header = b">" + target.encode() + b"\n"
                values, counts = _target_runs(vals)
                f.write(
                    depth_runs_to_bgzf_native(
                        values, counts, header, compresslevel, nthreads
                    )
                )
            f.write(bgzf_eof_native())
        return
    except (ImportError, OSError):
        pass
    chunks: list[bytes] = []
    for target, vals in depths.items():
        chunks.append(b">" + target.encode() + b"\n")
        chunks.append(_target_text(vals))
    with open(path, "wb") as f:
        f.write(gzip.compress(b"".join(chunks), compresslevel=compresslevel))
