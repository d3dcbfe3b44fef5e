"""Build, load and launch the package's CUDA kernels (``csrc/scan.cu``).

The source compiles with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface, bound through ``ctypes``.  The library lands in
``build/gci_tpu_torch/`` at the repository root, named by the hash of its
source, so an edited source rebuilds and an unchanged one loads at once.
Nothing builds or loads on import: the first launch on a CUDA tensor does it.

Each launcher counts its launches in ``LAUNCHES`` (one plain integer per
kernel), so a run can show which kernels its main path went through.  The
compaction also counts in ``RELAUNCHES`` each call that had to launch again
because a total exceeded the capacity its caller gave.
"""
from __future__ import annotations

import ctypes
import hashlib
import numbers
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "scan.cu"
BUILD_DIR = _PKG.parent / "build" / "gci_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

# launches per kernel, counted by the launchers below and nowhere else
LAUNCHES = {
    "depth_scan": 0,
    "depth_scan_int8": 0,
    "fused_depth_scan_packed": 0,
    "fused_depth_scan_flags": 0,
    "fused_depth_scan": 0,
    "fused_depth_scan_masked": 0,
    "compact_flags": 0,
    "compact_runs": 0,
}
# calls of the compaction launched a second time at the exact size (a total
# past the caller's capacity, or no capacity given)
RELAUNCHES = {"compact_flags": 0, "compact_runs": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, RELAUNCHES):
        for name in counts:
            counts[name] = 0


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgci_scan_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if this source has no library yet; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(SOURCE)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    if verbose and r.stderr:
        print(r.stderr, end="")
    os.replace(tmp, out)
    return out


_P, _I64, _I32, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int
# C entry -> argtypes: the streams' pointers (inputs, then outputs), the
# scratch, n, then lo and hi where the kernel has them, the device and stream
_SIGNATURES = {
    "gci_depth_scan": [_P, _P, _P, _I64, _I, _P],
    "gci_depth_scan_i8": [_P, _P, _P, _I64, _I, _P],
    "gci_packed_scan": [_P, _P, _P, _P, _I64, _I32, _I32, _I, _P],
    "gci_flags_scan": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _I, _P],
    "gci_edges_scan": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I, _P],
    "gci_masked_scan": [_P] * 8 + [_I64, _I32, _I32, _I, _P],
    "gci_compact_flags": [_P, ctypes.c_uint32, _I, _P, _I64, _I64, _P, _P, _P, _I, _P, _P],
    "gci_compact_runs": [_P, _I32, _I, _P, _I64, _I64, _P, _P, _I, _P, _P],
}


def load() -> ctypes.CDLL:
    """Build if needed, then load and bind the kernel library (once)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name in ("gci_scan_tile_slots", "gci_depth_scan_tile_slots",
                         "gci_compact_flags_tile_slots", "gci_compact_runs_tile_slots"):
                getattr(lib, name).restype = ctypes.c_int
                getattr(lib, name).argtypes = []
            lib.gci_cuda_error_string.restype = ctypes.c_char_p
            lib.gci_cuda_error_string.argtypes = [ctypes.c_int]
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def _check_stream(x: torch.Tensor, what: str, dtype: torch.dtype,
                  like: torch.Tensor | None = None, align: int | None = None) -> None:
    """Raise unless x is a contiguous 1-D CUDA tensor of ``dtype``, aligned
    for the kernel's vector access (``align`` bytes; by default 16 for int32
    streams, 8 for int8), and, given ``like``, of its length and on its
    device."""
    if x.dtype != dtype or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous 1-D {dtype} tensor, got "
            f"{x.dtype} of shape {tuple(x.shape)}"
        )
    if like is not None and x.shape[0] != like.shape[0]:
        raise ValueError(f"{what}: {x.shape[0]} slots, expected {like.shape[0]}")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if like is not None and x.device != like.device:
        raise ValueError(f"{what}: on {x.device}, expected {like.device}")
    if align is None:
        align = 16 if dtype == torch.int32 else 8
    if x.data_ptr() % align:
        raise ValueError(f"{what}: the kernel needs a {align}-byte aligned buffer")


def _tile_sums(lib: ctypes.CDLL, x: torch.Tensor) -> torch.Tensor:
    """Scratch of the reduce-then-scan kernels: one uint32 per tile."""
    return torch.empty(-(-x.shape[0] // lib.gci_scan_tile_slots()), dtype=torch.int32,
                       device=x.device)


def _tile_status(lib: ctypes.CDLL, x: torch.Tensor) -> torch.Tensor:
    """Scratch of the look-back scan: one zeroed 64-bit status word per tile,
    then the zeroed tile counter (zeroed on the current stream, part of the
    call)."""
    return torch.zeros(-(-x.shape[0] // lib.gci_depth_scan_tile_slots()) + 1,
                       dtype=torch.int64, device=x.device)


def _raise_on(lib: ctypes.CDLL, name: str, rc: int) -> None:
    if rc != 0:
        msg = lib.gci_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")


def _launch(name: str, entry: str, delta: torch.Tensor, streams, *scalars,
            alloc_scratch=_tile_sums) -> None:
    """Run C entry ``entry`` over delta's slots: ``streams`` are its tensors
    in the entry's order, ``scalars`` follow n, and ``alloc_scratch(lib,
    delta)`` allocates the entry's scratch.  Counts one launch of ``name``;
    raises on a CUDA error."""
    n = delta.shape[0]
    if n == 0:
        return
    lib = load()
    scratch = alloc_scratch(lib, delta)
    stream = torch.cuda.current_stream(delta.device).cuda_stream
    rc = getattr(lib, entry)(
        *(t.data_ptr() for t in streams), scratch.data_ptr(), n, *scalars,
        delta.device.index, stream,
    )
    _raise_on(lib, name, rc)
    LAUNCHES[name] += 1


def _empty_bytes(like: torch.Tensor, count: int):
    return [torch.empty(like.shape[0], dtype=torch.int8, device=like.device)
            for _ in range(count)]


# input dtype -> (launch count, C entry) of the look-back scan
_SCAN_FORMS = {
    torch.int32: ("depth_scan", "gci_depth_scan"),
    torch.int8: ("depth_scan_int8", "gci_depth_scan_i8"),
}


def launch_depth_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum of a 16-byte aligned int32 or int8 CUDA
    tensor (kernels ``gci_depth_scan`` and ``gci_depth_scan_i8``; int8 slots
    are sign-extended)."""
    if x.dtype not in _SCAN_FORMS:
        raise ValueError(f"depth_scan: expected an int32 or int8 tensor, got {x.dtype}")
    _check_stream(x, "depth_scan", x.dtype, align=16)
    name, entry = _SCAN_FORMS[x.dtype]
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    _launch(name, entry, x, [x, out], alloc_scratch=_tile_status)
    return out


def launch_packed_scan(word: torch.Tensor, lo: int, hi: int):
    """(depth int32, flags int8) of a CUDA packed event word (``gci_packed_scan``)."""
    _check_stream(word, "fused_depth_scan_packed", torch.int32)
    depth = torch.empty_like(word)
    (flags,) = _empty_bytes(word, 1)
    _launch("fused_depth_scan_packed", "gci_packed_scan", word, [word, depth, flags],
            int(lo), int(hi))
    return depth, flags


def launch_flags_scan(delta: torch.Tensor, flags: torch.Tensor, lo: int, hi: int):
    """(raw depth int32, out flags int8) of a CUDA read delta under flag
    bytes (``gci_flags_scan``)."""
    what = "fused_depth_scan_flags"
    _check_stream(delta, what, torch.int32)
    _check_stream(flags, f"{what} flags", torch.int8, like=delta)
    depth = torch.empty_like(delta)
    (out,) = _empty_bytes(delta, 1)
    _launch(what, "gci_flags_scan", delta, [delta, flags, depth, out], int(lo), int(hi))
    return depth, out


def launch_edges_scan(delta: torch.Tensor, valid: torch.Tensor, lo: int, hi: int):
    """(depth int32, rise int8, fall int8) of a CUDA read delta under a
    valid stream (``gci_edges_scan``)."""
    what = "fused_depth_scan"
    _check_stream(delta, what, torch.int32)
    _check_stream(valid, f"{what} valid", torch.int8, like=delta)
    depth = torch.empty_like(delta)
    rise, fall = _empty_bytes(delta, 2)
    _launch(what, "gci_edges_scan", delta, [delta, valid, depth, rise, fall],
            int(lo), int(hi))
    return depth, rise, fall


def launch_masked_scan(delta: torch.Tensor, gap: torch.Tensor, valid: torch.Tensor,
                       lo: int, hi: int):
    """(raw depth int32, rise, fall, change int8) of a CUDA read delta under
    gap and valid streams (``gci_masked_scan``)."""
    what = "fused_depth_scan_masked"
    _check_stream(delta, what, torch.int32)
    _check_stream(gap, f"{what} gap", torch.int8, like=delta)
    _check_stream(valid, f"{what} valid", torch.int8, like=delta)
    depth = torch.empty_like(delta)
    rise, fall, change = _empty_bytes(delta, 3)
    _launch(what, "gci_masked_scan", delta,
            [delta, gap, valid, depth, rise, fall, change], int(lo), int(hi))
    return depth, rise, fall, change


def check_capacity(capacity) -> int | None:
    """The compaction's capacity: None, or a count of entries >= 0."""
    if capacity is None:
        return None
    if isinstance(capacity, bool) or not isinstance(capacity, numbers.Integral) or capacity < 0:
        raise ValueError(f"capacity: expected None or an integer >= 0, got {capacity!r}")
    return int(capacity)


def _compact(name: str, x: torch.Tensor, n_streams: int, tile_slots: int,
             capacity: int | None, values: bool, entry, *args) -> list[torch.Tensor]:
    """One compaction of x by C entry ``entry`` (``args`` before its
    scratch) into buffers of ``capacity`` entries a stream (0 without one;
    never more than x's slots), and (``values``) as many int32 values.  The
    entry zeroes the scratch, launches, and returns the exact totals after
    the call's one host sync; where one exceeds the capacity the kernel is
    launched once more at the exact sizes and the call is counted in
    ``RELAUNCHES``.  Counts each launch of ``name``; returns each stream's
    indices (then the values), exactly sized views into one allocation."""
    n = x.shape[0]
    words = n_streams * (-(-n // tile_slots) + 1)
    # the current stream's handle; torch.cuda.current_stream() costs ~8 us
    # of host time a call, a fifth of a small call's
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    totals = (ctypes.c_int64 * n_streams)()
    sizes = [min(capacity or 0, n)] * n_streams
    while True:
        # the scratch, then each stream's indices, then the values (two
        # int32 a word)
        starts = [words]
        for c in sizes:
            starts.append(starts[-1] + c)
        buf = torch.empty(starts[-1] + ((sizes[0] + 1) // 2 if values else 0),
                          dtype=torch.int64, device=x.device)
        ptr = buf.data_ptr()
        ptrs = [ptr + 8 * a for a in starts[: n_streams + values]]
        if not values:  # the flag entry takes three index pointers
            ptrs += [None] * (3 - n_streams)
        rc = entry(*args, ptr, n, max(sizes), *ptrs, x.device.index, stream, totals)
        if rc:
            _raise_on(load(), name, rc)
        LAUNCHES[name] += 1
        got = list(totals)
        if all(t <= c for t, c in zip(got, sizes)):
            break
        RELAUNCHES[name] += 1
        sizes = got
    outs = [buf[a:a + t] for a, t in zip(starts, got)]
    if values:
        outs.append(buf[starts[-1]:].view(torch.int32)[: got[0]])
    return outs


def launch_compact_flags(x: torch.Tensor, masks, capacity: int | None = None
                         ) -> list[torch.Tensor]:
    """Ascending int64 indices of the slots where ``(x & m) != 0``, one
    tensor per mask (1 to 3 masks, each 1-255, as ``depth.scan`` checks
    them), of a 16-byte aligned int8 CUDA tensor (``gci_compact_flags``),
    each exactly as long as its count, written into a buffer of
    ``capacity`` entries."""
    _check_stream(x, "compact_flags", torch.int8, align=16)
    if x.shape[0] == 0:
        return [torch.empty(0, dtype=torch.int64, device=x.device) for _ in masks]
    lib = load()
    packed = sum(int(m) << (8 * s) for s, m in enumerate(masks))
    return _compact("compact_flags", x, len(masks), lib.gci_compact_flags_tile_slots(),
                    capacity, False, lib.gci_compact_flags, x.data_ptr(), packed, len(masks))


def launch_compact_runs(depth: torch.Tensor, carry: int | None,
                        capacity: int | None = None):
    """(int64 indices, int32 depths) of the run boundaries of a 16-byte
    aligned int32 CUDA tensor: ``depth[i] != depth[i-1]``, slot 0 against
    ``carry``, or always a boundary when ``carry`` is None
    (``gci_compact_runs``), each exactly as long as the count, written into
    buffers of ``capacity`` entries."""
    _check_stream(depth, "compact_runs", torch.int32)
    if depth.shape[0] == 0:
        return (torch.empty(0, dtype=torch.int64, device=depth.device),
                torch.empty(0, dtype=torch.int32, device=depth.device))
    lib = load()
    has, c = (0, 0) if carry is None else (1, int(carry))
    idx, vals = _compact("compact_runs", depth, 1, lib.gci_compact_runs_tile_slots(),
                         capacity, True, lib.gci_compact_runs, depth.data_ptr(), c, has)
    return idx, vals
