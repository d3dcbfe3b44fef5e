"""``.depth.gz`` checkpoint writer (counterpart of ``gci_tpu.io.depth_file``).

The single-writer branch of ``gci_tpu.io.depth_file.write_depth_gz``; the
run-length helpers and the native BGZF encoders are reused by import, so the
bytes are the reference writer's.
"""
from __future__ import annotations

import gzip
import os

from gci_tpu.depth.base import ResidentDepth
from gci_tpu.io.depth_file import _target_runs, _target_text
from gci_tpu_torch.parallel.distributed import is_primary_host


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
        from gci_tpu.native import bgzf_eof_native, depth_runs_to_bgzf_native

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
