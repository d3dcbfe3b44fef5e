"""Build, load and launch the package's CUDA kernels (``csrc/scan.cu``).

The source compiles with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface, bound through ``ctypes``.  The library lands in
``build/gci_tpu_torch/`` at the repository root, named by the hash of its
source, so an edited source rebuilds and an unchanged one loads at once.
Nothing builds or loads on import: the first launch on a CUDA tensor does it.

Each launcher counts its launches in ``LAUNCHES`` (one plain integer per
kernel), so a run can show which kernels its main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
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
LAUNCHES = {"depth_scan": 0, "fused_depth_scan_packed": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def load() -> ctypes.CDLL:
    """Build if needed, then load and bind the kernel library (once)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            c = ctypes
            lib.gci_scan_tile_slots.restype = c.c_int
            lib.gci_scan_tile_slots.argtypes = []
            lib.gci_cuda_error_string.restype = c.c_char_p
            lib.gci_cuda_error_string.argtypes = [c.c_int]
            lib.gci_depth_scan.restype = c.c_int
            lib.gci_depth_scan.argtypes = [
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64, c.c_int,
                c.c_void_p,
            ]
            lib.gci_packed_scan.restype = c.c_int
            lib.gci_packed_scan.argtypes = [
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64,
                c.c_int32, c.c_int32, c.c_int, c.c_void_p,
            ]
            _lib = lib
    return _lib


def _check_input(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous 1-D int32 tensor, got "
            f"{x.dtype} of shape {tuple(x.shape)}"
        )
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: the kernel needs a 16-byte aligned buffer")


def _scratch(lib: ctypes.CDLL, n: int, device: torch.device) -> torch.Tensor:
    tile = lib.gci_scan_tile_slots()
    return torch.empty(-(-n // tile), dtype=torch.int32, device=device)


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.gci_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def launch_depth_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum of a CUDA tensor (kernel ``gci_depth_scan``)."""
    _check_input(x, "depth_scan")
    lib = load()
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    scratch = _scratch(lib, n, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.gci_depth_scan(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, x.device.index,
        stream,
    )
    _raise_on(lib, rc, "depth_scan")
    LAUNCHES["depth_scan"] += 1
    return out


def launch_packed_scan(word: torch.Tensor, lo: int, hi: int):
    """(depth int32, flags int8) of a CUDA packed event word (``gci_packed_scan``)."""
    _check_input(word, "fused_depth_scan_packed")
    lib = load()
    n = word.shape[0]
    depth = torch.empty_like(word)
    flags = torch.empty(n, dtype=torch.int8, device=word.device)
    if n == 0:
        return depth, flags
    scratch = _scratch(lib, n, word.device)
    stream = torch.cuda.current_stream(word.device).cuda_stream
    rc = lib.gci_packed_scan(
        word.data_ptr(), depth.data_ptr(), flags.data_ptr(), scratch.data_ptr(),
        n, int(lo), int(hi), word.device.index, stream,
    )
    _raise_on(lib, rc, "fused_depth_scan_packed")
    LAUNCHES["fused_depth_scan_packed"] += 1
    return depth, flags
