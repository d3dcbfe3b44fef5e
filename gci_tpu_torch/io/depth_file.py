"""``.depth.gz`` checkpoint writer (counterpart of ``gci_tpu.io.depth_file``).

The single-writer branch of ``gci_tpu.io.depth_file.write_depth_gz`` with
the run-length and text helpers it needs, copied, so the bytes are the
reference writer's: gzip-compressed text, one ``>target`` header line per
target followed by one decimal depth per base per line (GCI.py:113-117).
"""
from __future__ import annotations

import gzip
import os

import numpy as np

from gci_tpu_torch.depth.base import ResidentDepth
from gci_tpu_torch.depth.eventspace import DepthEvents
from gci_tpu_torch.parallel.distributed import is_primary_host

_NL = 10


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


def write_depth_gz(path: str, depths: dict, compresslevel: int = 1) -> None:
    """Write the .depth.gz checkpoint (content-identical to GCI.py:113-117).

    Values may be per-base arrays, event-space ``DepthEvents`` or a
    device-resident depth (read back as run boundaries only, O(runs)).
    BGZF-framed through the native runs->BGZF encoder when it loads, one
    gzip member of the same text otherwise.
    """
    if isinstance(depths, ResidentDepth):
        depths = depths.to_events()
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
