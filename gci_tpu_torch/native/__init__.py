"""ctypes bindings for the gci_native C++ host codec (``csrc/gci_native.cpp``).

The shared library is built with g++ on first use (plain C ABI + ctypes)
into ``build/gci_tpu_torch/`` at the repository root, named by the hash of
its source and flags, so an edited source rebuilds and an unchanged one
loads at once.  The codec is written against libdeflate's API.  Where
libdeflate is not installed the build fails, and a library built on another
machine may not load; either way the same source is then built against
``csrc/zlib_deflate_shim/libdeflate.h``, libdeflate's API on zlib: the same
codec, with zlib doing the deflate work.  ``ensure_host_codec`` says which
build loaded.  Callers of the codec functions catch ImportError/OSError and
fall back to the pure-numpy codecs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from gci_tpu_torch.kernels import BUILD_DIR

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SRC = _CSRC / "gci_native.cpp"
_SHIM_DIR = _CSRC / "zlib_deflate_shim"
# the builds in the order they are tried: build -> (g++ flags, libraries)
_BUILDS = {
    "libdeflate": ([], ["-lz", "-ldeflate"]),
    "zlib shim": ([f"-I{_SHIM_DIR}"], ["-lz"]),
}
_lock = threading.Lock()
_lib = None
_loaded_build: str | None = None


class HostCodecError(OSError):
    """Neither build of the host codec loads."""


def _library_path(build: str) -> Path:
    flags, libs = _BUILDS[build]
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(flags + libs).encode())
    if build == "zlib shim":
        h.update((_SHIM_DIR / "libdeflate.h").read_bytes())
    return BUILD_DIR / f"_gci_native_{build.replace(' ', '_')}_{h.hexdigest()[:16]}.so"


def _compile(build: str, out: Path) -> None:
    """Build ``out`` with g++; raises CalledProcessError (with the
    compiler's stderr) when it fails."""
    flags, libs = _BUILDS[build]
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-fvisibility=hidden", *flags, str(_SRC), *libs, "-lpthread",
        "-o", str(tmp),
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)


def _load(build: str) -> ctypes.CDLL:
    out = _library_path(build)
    if not out.exists():
        _compile(build, out)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    i32p = c.POINTER(c.c_int32)
    i64p = c.POINTER(c.c_int64)
    u64p = c.POINTER(c.c_uint64)
    f64p = c.POINTER(c.c_double)
    lib.gci_buffer_free.argtypes = [c.c_void_p]
    lib.gci_buffer_data.restype = u8p
    lib.gci_buffer_data.argtypes = [c.c_void_p]
    lib.gci_buffer_size.restype = c.c_int64
    lib.gci_buffer_size.argtypes = [c.c_void_p]
    lib.gci_gzip_decompress_file.restype = c.c_void_p
    lib.gci_gzip_decompress_file.argtypes = [c.c_char_p]
    lib.gci_gzip_compress.restype = c.c_void_p
    lib.gci_gzip_compress.argtypes = [u8p, c.c_int64, c.c_int]
    lib.gci_depth_decode_file.restype = c.c_void_p
    lib.gci_depth_decode_file.argtypes = [c.c_char_p, c.c_int]
    lib.gci_depth_free.argtypes = [c.c_void_p]
    lib.gci_depth_error.restype = c.c_char_p
    lib.gci_depth_error.argtypes = [c.c_void_p]
    lib.gci_depth_num_targets.restype = c.c_int64
    lib.gci_depth_num_targets.argtypes = [c.c_void_p]
    lib.gci_depth_target_name.restype = c.c_char_p
    lib.gci_depth_target_name.argtypes = [c.c_void_p, c.c_int64]
    lib.gci_depth_target_len.restype = c.c_int64
    lib.gci_depth_target_len.argtypes = [c.c_void_p, c.c_int64]
    lib.gci_depth_copy_target.argtypes = [c.c_void_p, c.c_int64, i64p]
    lib.gci_depth_encode_lines.restype = c.c_void_p
    lib.gci_depth_encode_lines.argtypes = [i64p, c.c_int64]
    lib.gci_depth_encode_runs.restype = c.c_void_p
    lib.gci_depth_encode_runs.argtypes = [i64p, i64p, c.c_int64]
    lib.gci_depth_decode_runs_file.restype = c.c_void_p
    lib.gci_depth_decode_runs_file.argtypes = [c.c_char_p, c.c_int]
    lib.gci_druns_free.argtypes = [c.c_void_p]
    lib.gci_druns_error.restype = c.c_char_p
    lib.gci_druns_error.argtypes = [c.c_void_p]
    lib.gci_druns_num_targets.restype = c.c_int64
    lib.gci_druns_num_targets.argtypes = [c.c_void_p]
    lib.gci_druns_target_name.restype = c.c_char_p
    lib.gci_druns_target_name.argtypes = [c.c_void_p, c.c_int64]
    lib.gci_druns_target_nruns.restype = c.c_int64
    lib.gci_druns_target_nruns.argtypes = [c.c_void_p, c.c_int64]
    lib.gci_druns_copy_target.argtypes = [c.c_void_p, c.c_int64, i64p, i64p]
    lib.gci_depth_runs_to_bgzf.restype = c.c_void_p
    lib.gci_depth_runs_to_bgzf.argtypes = [i64p, i64p, c.c_int64, u8p, c.c_int64, c.c_int, c.c_int]
    lib.gci_depth_runs_to_bgzf_range.restype = c.c_void_p
    lib.gci_depth_runs_to_bgzf_range.argtypes = [i64p, i64p, c.c_int64, u8p, c.c_int64, c.c_int, c.c_int, c.c_int64, c.c_int64]
    lib.gci_depth_runs_bgzf_nblocks.restype = c.c_int64
    lib.gci_depth_runs_bgzf_nblocks.argtypes = [i64p, c.c_int64, i64p, c.c_int64]
    lib.gci_bgzf_eof_block.restype = c.c_void_p
    lib.gci_bgzf_eof_block.argtypes = []
    lib.gci_bam_open.restype = c.c_void_p
    lib.gci_bam_open.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_int]
    lib.gci_bgzf_inflate_floor.restype = c.c_int64
    lib.gci_bgzf_inflate_floor.argtypes = [c.c_char_p, c.c_int, f64p]
    lib.gci_bam_stream_phase.restype = c.c_double
    lib.gci_bam_stream_phase.argtypes = [c.c_void_p, c.c_int]
    lib.gci_bam_free.argtypes = [c.c_void_p]
    lib.gci_bam_error.restype = c.c_char_p
    lib.gci_bam_error.argtypes = [c.c_void_p]
    lib.gci_bam_num_refs.restype = c.c_int64
    lib.gci_bam_num_refs.argtypes = [c.c_void_p]
    lib.gci_bam_ref_name.restype = c.c_char_p
    lib.gci_bam_ref_name.argtypes = [c.c_void_p, c.c_int64]
    lib.gci_bam_ref_len.restype = c.c_int64
    lib.gci_bam_ref_len.argtypes = [c.c_void_p, c.c_int64]
    lib.gci_bam_num_records.restype = c.c_int64
    lib.gci_bam_num_records.argtypes = [c.c_void_p]
    lib.gci_bam_copy_columns.argtypes = [c.c_void_p] + [i32p] * 13 + [u64p]
    lib.gci_bam_name_blob_size.restype = c.c_int64
    lib.gci_bam_name_blob_size.argtypes = [c.c_void_p]
    lib.gci_bam_copy_names.argtypes = [c.c_void_p, u8p, i64p]
    lib.gci_bam_copy_hash2.argtypes = [c.c_void_p, u64p]
    lib.gci_bam_body_size.restype = c.c_int64
    lib.gci_bam_body_size.argtypes = [c.c_void_p]
    lib.gci_bam_copy_body.argtypes = [c.c_void_p, u8p]
    lib.gci_bam_copy_rec_offsets.argtypes = [c.c_void_p, i64p]
    lib.gci_bam_header_text_size.restype = c.c_int64
    lib.gci_bam_header_text_size.argtypes = [c.c_void_p]
    lib.gci_bam_copy_header_text.argtypes = [c.c_void_p, u8p]
    lib.gci_bgzf_compress.restype = c.c_void_p
    lib.gci_bgzf_compress.argtypes = [u8p, c.c_int64, c.c_int, c.c_int]
    lib.gci_paf_open.restype = c.c_void_p
    lib.gci_paf_open.argtypes = [c.c_char_p, c.c_int, c.c_int64, c.c_int64]
    lib.gci_paf_open_shard.restype = c.c_void_p
    lib.gci_paf_open_shard.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_int]
    lib.gci_paf_free.argtypes = [c.c_void_p]
    lib.gci_paf_num_rows.restype = c.c_int64
    lib.gci_paf_num_rows.argtypes = [c.c_void_p]
    lib.gci_paf_copy_ints.argtypes = [c.c_void_p, i64p]
    lib.gci_paf_copy_hashes.argtypes = [c.c_void_p, u64p, u64p]
    lib.gci_paf_name_blob_size.restype = c.c_int64
    lib.gci_paf_name_blob_size.argtypes = [c.c_void_p]
    lib.gci_paf_copy_names.argtypes = [c.c_void_p, u8p, i64p]
    lib.gci_paf_num_targets.restype = c.c_int64
    lib.gci_paf_num_targets.argtypes = [c.c_void_p]
    lib.gci_paf_target_name.restype = c.c_char_p
    lib.gci_paf_target_name.argtypes = [c.c_void_p, c.c_int64]
    lib.gci_paf_copy_tids.argtypes = [c.c_void_p, i32p]
    lib.gci_seg_sum_f64.argtypes = [f64p, i64p, c.c_int64, c.c_int64, f64p]
    lib.gci_fasta_scan.restype = c.c_void_p
    lib.gci_fasta_scan.argtypes = [c.c_char_p]
    lib.gci_fasta_free.argtypes = [c.c_void_p]
    lib.gci_fasta_error.restype = c.c_char_p
    lib.gci_fasta_error.argtypes = [c.c_void_p]
    lib.gci_fasta_num_targets.restype = c.c_int64
    lib.gci_fasta_num_targets.argtypes = [c.c_void_p]
    lib.gci_fasta_target_name.restype = c.c_char_p
    lib.gci_fasta_target_name.argtypes = [c.c_void_p, c.c_int64]
    lib.gci_fasta_target_len.restype = c.c_int64
    lib.gci_fasta_target_len.argtypes = [c.c_void_p, c.c_int64]
    lib.gci_fasta_num_gaps.restype = c.c_int64
    lib.gci_fasta_num_gaps.argtypes = [c.c_void_p]
    lib.gci_fasta_copy_gaps.argtypes = [c.c_void_p, i64p, i64p, i64p]
    lib.gci_bam_stream_open.restype = c.c_void_p
    lib.gci_bam_stream_open.argtypes = [
        c.c_char_p, c.c_int, c.c_int, c.c_int64, c.c_int64, c.c_int64,
        c.c_int,
    ]
    lib.gci_bam_stream_free.argtypes = [c.c_void_p]
    lib.gci_bam_stream_error.restype = c.c_char_p
    lib.gci_bam_stream_error.argtypes = [c.c_void_p]
    lib.gci_bam_stream_num_refs.restype = c.c_int64
    lib.gci_bam_stream_num_refs.argtypes = [c.c_void_p]
    lib.gci_bam_stream_ref_name.restype = c.c_char_p
    lib.gci_bam_stream_ref_name.argtypes = [c.c_void_p, c.c_int64]
    lib.gci_bam_stream_ref_len.restype = c.c_int64
    lib.gci_bam_stream_ref_len.argtypes = [c.c_void_p, c.c_int64]
    lib.gci_bam_stream_header_text_size.restype = c.c_int64
    lib.gci_bam_stream_header_text_size.argtypes = [c.c_void_p]
    lib.gci_bam_stream_copy_header_text.argtypes = [c.c_void_p, u8p]
    lib.gci_bam_stream_next.restype = c.c_void_p
    lib.gci_bam_stream_next.argtypes = [c.c_void_p]
    lib.gci_chunk_free.argtypes = [c.c_void_p]
    lib.gci_chunk_num_records.restype = c.c_int64
    lib.gci_chunk_num_records.argtypes = [c.c_void_p]
    lib.gci_chunk_copy_columns.argtypes = [c.c_void_p] + [i32p] * 13 + [u64p, u64p]
    lib.gci_chunk_name_blob_size.restype = c.c_int64
    lib.gci_chunk_name_blob_size.argtypes = [c.c_void_p]
    lib.gci_chunk_body_size.restype = c.c_int64
    lib.gci_chunk_body_size.argtypes = [c.c_void_p]
    lib.gci_chunk_copy_body.argtypes = [c.c_void_p, u8p, i64p]
    lib.gci_chunk_copy_names.argtypes = [c.c_void_p, u8p, i64p]


class UncompressedBamError(ValueError):
    """A plain (non-BGZF) BAM was given to the block-streaming reader.

    Plain BAMs have no BGZF framing to stream or range-shard; callers
    catch this and use the whole-file reader (``NativeBam`` handles the
    uncompressed case directly).
    """


def get_lib() -> ctypes.CDLL:
    """The loaded codec library, built on first use (see the module doc).

    Raises HostCodecError with each build's message when none loads.
    """
    global _lib, _loaded_build
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        errors = []
        for build in _BUILDS:
            try:
                lib = _load(build)
            except subprocess.CalledProcessError as exc:  # the build failed
                errors.append(f"{build}: {(exc.stderr or b'').decode(errors='replace')}")
            except OSError as exc:  # a library that does not load here
                errors.append(f"{build}: {exc}")
            else:
                _lib, _loaded_build = lib, build
                return _lib
        raise HostCodecError("the host codec did not build:\n" + "\n".join(errors))


def ensure_host_codec() -> str:
    """Load the host codec; return the build that loaded, ``"libdeflate"``
    or ``"zlib shim"``.  Raises HostCodecError when neither works."""
    get_lib()
    return _loaded_build


def _as_ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _take_buffer(lib, handle) -> bytes:
    if not handle:
        raise OSError("gci_native buffer operation failed")
    try:
        size = lib.gci_buffer_size(handle)
        data = ctypes.string_at(lib.gci_buffer_data(handle), size)
    finally:
        lib.gci_buffer_free(handle)
    return data


def decode_depth_file_native(path: str, nthreads: int | None = None) -> dict[str, np.ndarray]:
    """Parse a .depth.gz (or plain text) checkpoint via C++ streaming decode.

    BGZF-framed files (our writer's output) decompress on a thread pool;
    plain-gzip files (the reference writer) inflate serially.
    """
    lib = get_lib()
    if nthreads is None:
        nthreads = os.cpu_count() or 1
    h = lib.gci_depth_decode_file(path.encode(), nthreads)
    if not h:
        raise OSError(f"cannot read depth file: {path}")
    try:
        err = lib.gci_depth_error(h)
        if err:
            raise ValueError(err.decode())
        out: dict[str, np.ndarray] = {}
        for i in range(lib.gci_depth_num_targets(h)):
            name = lib.gci_depth_target_name(h, i).decode()
            n = lib.gci_depth_target_len(h, i)
            arr = np.empty(n, dtype=np.int64)
            if n:
                lib.gci_depth_copy_target(h, i, _as_ptr(arr, ctypes.c_int64))
            out[name] = arr
    finally:
        lib.gci_depth_free(h)
    return out


def decode_depth_runs_native(
    path: str, nthreads: int | None = None
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Parse .depth.gz into per-target run-length (values, counts) arrays."""
    lib = get_lib()
    if nthreads is None:
        nthreads = os.cpu_count() or 1
    h = lib.gci_depth_decode_runs_file(path.encode(), nthreads)
    if not h:
        raise OSError(f"cannot read depth file: {path}")
    try:
        err = lib.gci_druns_error(h)
        if err:
            raise ValueError(err.decode())
        out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        for i in range(lib.gci_druns_num_targets(h)):
            name = lib.gci_druns_target_name(h, i).decode()
            m = lib.gci_druns_target_nruns(h, i)
            values = np.empty(m, dtype=np.int64)
            counts = np.empty(m, dtype=np.int64)
            if m:
                lib.gci_druns_copy_target(
                    h, i, _as_ptr(values, ctypes.c_int64),
                    _as_ptr(counts, ctypes.c_int64),
                )
            out[name] = (values, counts)
    finally:
        lib.gci_druns_free(h)
    return out


def encode_depth_lines_native(vals: np.ndarray) -> bytes:
    """Format int64 values as one-decimal-per-line text via C++."""
    lib = get_lib()
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    h = lib.gci_depth_encode_lines(_as_ptr(vals, ctypes.c_int64), vals.shape[0])
    return _take_buffer(lib, h)


def encode_depth_runs_native(vals: np.ndarray, counts: np.ndarray) -> bytes:
    """Run-length 'value\\n'xcount text via C++ (event-space serializer)."""
    lib = get_lib()
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    h = lib.gci_depth_encode_runs(
        _as_ptr(vals, ctypes.c_int64), _as_ptr(counts, ctypes.c_int64),
        vals.shape[0],
    )
    return _take_buffer(lib, h)


def depth_runs_to_bgzf_native(
    vals: np.ndarray, counts: np.ndarray, header: bytes,
    level: int = 6, nthreads: int = 4,
) -> bytes:
    """header + run-length depth text, BGZF-compressed (no EOF block)."""
    lib = get_lib()
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    hdr = np.frombuffer(header, dtype=np.uint8)
    h = lib.gci_depth_runs_to_bgzf(
        _as_ptr(vals, ctypes.c_int64), _as_ptr(counts, ctypes.c_int64),
        vals.shape[0], _as_ptr(hdr, ctypes.c_uint8), hdr.shape[0],
        level, nthreads,
    )
    return _take_buffer(lib, h)


def depth_runs_bgzf_nblocks_native(
    vals: np.ndarray, counts: np.ndarray, header_len: int
) -> int:
    """BGZF block count the runs->BGZF encoder will emit for this stream."""
    lib = get_lib()
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    return int(
        lib.gci_depth_runs_bgzf_nblocks(
            _as_ptr(counts, ctypes.c_int64), counts.shape[0],
            _as_ptr(vals, ctypes.c_int64), header_len,
        )
    )


def depth_runs_to_bgzf_range_native(
    vals: np.ndarray, counts: np.ndarray, header: bytes,
    block_lo: int, block_hi: int, level: int = 6, nthreads: int = 4,
) -> bytes:
    """BGZF blocks [block_lo, block_hi) of the (header + runs) stream.

    Framing is deterministic in uncompressed byte offsets, so disjoint
    ranges (compressed on different hosts) concatenate to exactly the
    single-call ``depth_runs_to_bgzf_native`` output.
    """
    lib = get_lib()
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    hdr = np.frombuffer(header, dtype=np.uint8)
    h = lib.gci_depth_runs_to_bgzf_range(
        _as_ptr(vals, ctypes.c_int64), _as_ptr(counts, ctypes.c_int64),
        vals.shape[0], _as_ptr(hdr, ctypes.c_uint8), hdr.shape[0],
        level, nthreads, block_lo, block_hi,
    )
    return _take_buffer(lib, h)


def bgzf_eof_native() -> bytes:
    lib = get_lib()
    return _take_buffer(lib, lib.gci_bgzf_eof_block())


def gzip_compress_native(data: bytes, level: int = 6) -> bytes:
    lib = get_lib()
    arr = np.frombuffer(data, dtype=np.uint8)
    h = lib.gci_gzip_compress(_as_ptr(arr, ctypes.c_uint8), arr.shape[0], level)
    return _take_buffer(lib, h)


def gzip_decompress_file_native(path: str) -> bytes:
    lib = get_lib()
    h = lib.gci_gzip_decompress_file(path.encode())
    return _take_buffer(lib, h)


def bgzf_inflate_floor(path: str, nthreads: int = 4) -> tuple[float, int]:
    """Decompression floor of a BGZF file: (inflate wall seconds, inflated
    bytes) with per-thread reused scratch — the irreducible libdeflate cost
    the BAM pack stage cannot go below (diagnostic for bench attribution)."""
    lib = get_lib()
    secs = ctypes.c_double(0.0)
    n = lib.gci_bgzf_inflate_floor(path.encode(), nthreads, ctypes.byref(secs))
    if n < 0:
        raise OSError(f"{path}: not a BGZF file or inflate failed")
    return float(secs.value), int(n)


def bgzf_compress_native(data: bytes, level: int = 6, nthreads: int = 4) -> bytes:
    lib = get_lib()
    arr = np.frombuffer(data, dtype=np.uint8)
    h = lib.gci_bgzf_compress(
        _as_ptr(arr, ctypes.c_uint8), arr.shape[0], level, nthreads
    )
    return _take_buffer(lib, h)


class NativePaf:
    """Packed PAF columns parsed by the C++ parser.

    Targets arrive as a deduped table (``target_names``) + per-row int32
    ``tid`` — no per-row Python strings.  Query names stay a raw blob +
    offsets; ``names`` materializes the per-row list lazily (only the
    oracle/test paths want it — production uses the 128-bit name hashes).
    ``byte_range=(lo, hi)`` parses only the lines whose first byte lies in
    the range (per-host input sharding of a shared plain-text PAF).
    """

    def __init__(
        self,
        path: str,
        nthreads: int = 2,
        byte_range: tuple[int, int] | None = None,
        shard: tuple[int, int] | None = None,
    ):
        lib = get_lib()
        if shard is not None:
            # host h of H: the [n*h/H, n*(h+1)/H) line range of the
            # UNCOMPRESSED bytes — works for .paf and .paf.gz alike (gz
            # inflates whole on every host; only the tokenize shards)
            h = lib.gci_paf_open_shard(
                path.encode(), nthreads, shard[0], shard[1]
            )
        else:
            lo, hi = byte_range if byte_range is not None else (-1, -1)
            h = lib.gci_paf_open(path.encode(), nthreads, lo, hi)
        if not h:
            raise OSError(f"cannot read PAF file: {path}")
        try:
            n = int(lib.gci_paf_num_rows(h))
            ints = np.empty(n * 8, dtype=np.int64)
            h1 = np.empty(n, dtype=np.uint64)
            h2 = np.empty(n, dtype=np.uint64)
            tid = np.empty(n, dtype=np.int32)
            if n:
                lib.gci_paf_copy_ints(h, _as_ptr(ints, ctypes.c_int64))
                lib.gci_paf_copy_hashes(
                    h, _as_ptr(h1, ctypes.c_uint64), _as_ptr(h2, ctypes.c_uint64)
                )
                lib.gci_paf_copy_tids(h, _as_ptr(tid, ctypes.c_int32))
            self.ints = ints.reshape(n, 8)
            self.name_hash = h1
            self.name_hash2 = h2
            self.tid = tid
            self.target_names = [
                lib.gci_paf_target_name(h, i).decode()
                for i in range(int(lib.gci_paf_num_targets(h)))
            ]
            nb = lib.gci_paf_name_blob_size(h)
            nblob = np.empty(max(nb, 1), dtype=np.uint8)
            noffs = np.empty(n + 1, dtype=np.int64)
            lib.gci_paf_copy_names(h, _as_ptr(nblob, ctypes.c_uint8), _as_ptr(noffs, ctypes.c_int64))
            self.name_blob = nblob[:nb].tobytes()
            self.name_offsets = noffs
        finally:
            lib.gci_paf_free(h)

    @property
    def names(self) -> list[bytes]:
        offs = self.name_offsets
        blob = self.name_blob
        return [
            bytes(blob[offs[i]: offs[i + 1]])
            for i in range(self.ints.shape[0])
        ]


def seg_sum_f64_native(values: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Per-segment sequential float64 sums (segment k = [starts[k], starts[k+1]))."""
    lib = get_lib()
    values = np.ascontiguousarray(values, dtype=np.float64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    out = np.empty(starts.shape[0], dtype=np.float64)
    lib.gci_seg_sum_f64(
        _as_ptr(values, ctypes.c_double), _as_ptr(starts, ctypes.c_int64),
        starts.shape[0], values.shape[0], _as_ptr(out, ctypes.c_double),
    )
    return out


class NativeBam:
    """Packed BAM columns parsed by the C++ packer."""

    def __init__(
        self,
        path: str,
        nthreads: int = 4,
        keep_names: bool = True,
        keep_raw: bool = False,
    ):
        lib = get_lib()
        self._lib = lib
        h = lib.gci_bam_open(path.encode(), nthreads, int(keep_names), int(keep_raw))
        if not h:
            raise OSError(f"cannot read BAM file: {path}")
        err = lib.gci_bam_error(h)
        if err:
            msg = err.decode()
            lib.gci_bam_free(h)
            raise ValueError(f"{path}: {msg}")
        try:
            self.references = [
                lib.gci_bam_ref_name(h, i).decode()
                for i in range(lib.gci_bam_num_refs(h))
            ]
            self.lengths = [
                int(lib.gci_bam_ref_len(h, i))
                for i in range(lib.gci_bam_num_refs(h))
            ]
            n = int(lib.gci_bam_num_records(h))
            cols = {
                name: np.empty(n, dtype=np.int32)
                for name in (
                    "ref_id", "pos", "ref_end", "qlen", "mapq", "flag",
                    "m", "i", "d", "s", "eq", "x", "nm",
                )
            }
            name_hash = np.empty(n, dtype=np.uint64)
            name_hash2 = np.empty(n, dtype=np.uint64)
            if n:
                lib.gci_bam_copy_columns(
                    h,
                    *[_as_ptr(cols[k], ctypes.c_int32) for k in cols],
                    _as_ptr(name_hash, ctypes.c_uint64),
                )
                lib.gci_bam_copy_hash2(h, _as_ptr(name_hash2, ctypes.c_uint64))
            self.columns = cols
            self.name_hash = name_hash
            self.name_hash2 = name_hash2
            blob_size = lib.gci_bam_name_blob_size(h)
            self.name_offsets = np.empty(n + 1, dtype=np.int64)
            blob = np.empty(max(blob_size, 1), dtype=np.uint8)
            if keep_names:
                lib.gci_bam_copy_names(
                    h,
                    _as_ptr(blob, ctypes.c_uint8),
                    _as_ptr(self.name_offsets, ctypes.c_int64),
                )
                self.name_blob = blob[:blob_size].tobytes()
            else:
                lib.gci_bam_copy_names(h, None, _as_ptr(self.name_offsets, ctypes.c_int64))
                self.name_blob = b""
            ht_size = lib.gci_bam_header_text_size(h)
            ht = np.empty(max(ht_size, 1), dtype=np.uint8)
            if ht_size:
                lib.gci_bam_copy_header_text(h, _as_ptr(ht, ctypes.c_uint8))
            self.header_text = ht[:ht_size].tobytes().decode(errors="replace")
            if keep_raw:
                body_size = lib.gci_bam_body_size(h)
                body = np.empty(max(body_size, 1), dtype=np.uint8)
                self.record_offsets = np.empty(n, dtype=np.int64)
                if body_size:
                    lib.gci_bam_copy_body(h, _as_ptr(body, ctypes.c_uint8))
                if n:
                    lib.gci_bam_copy_rec_offsets(
                        h, _as_ptr(self.record_offsets, ctypes.c_int64)
                    )
                self.body = body[:body_size].tobytes()
            else:
                self.body = None
                self.record_offsets = None
        finally:
            lib.gci_bam_free(h)


def scan_fasta_native(path: str) -> tuple[dict[str, int], dict[str, list[tuple[int, int]]]]:
    """One-pass FASTA scan: (record->length, record->N-gap intervals).

    Gap dict only contains records that have gaps (GCI.py:18-46 semantics);
    raises OSError on unreadable/corrupt input so callers can fall back.
    """
    lib = get_lib()
    h = lib.gci_fasta_scan(path.encode())
    if not h:
        raise OSError(f"gci_fasta_scan failed for {path}")
    try:
        err = lib.gci_fasta_error(h)
        if err:
            raise OSError(f"gci_fasta_scan: {err.decode()}: {path}")
        nt = lib.gci_fasta_num_targets(h)
        names = [lib.gci_fasta_target_name(h, i).decode() for i in range(nt)]
        lengths = {names[i]: int(lib.gci_fasta_target_len(h, i)) for i in range(nt)}
        ng = lib.gci_fasta_num_gaps(h)
        gaps: dict[str, list[tuple[int, int]]] = {}
        if ng:
            tgt = np.empty(ng, np.int64)
            gs = np.empty(ng, np.int64)
            ge = np.empty(ng, np.int64)
            lib.gci_fasta_copy_gaps(
                h, _as_ptr(tgt, ctypes.c_int64), _as_ptr(gs, ctypes.c_int64),
                _as_ptr(ge, ctypes.c_int64),
            )
            for k in range(ng):
                gaps.setdefault(names[int(tgt[k])], []).append((int(gs[k]), int(ge[k])))
        return lengths, gaps
    finally:
        lib.gci_fasta_free(h)


class NativeBamChunk:
    """Packed columns for one streamed batch of BAM records."""

    __slots__ = ("columns", "name_hash", "name_hash2", "names", "body",
                 "record_offsets")

    def __init__(self, lib, handle, keep_names: bool, keep_raw: bool = False):
        try:
            n = int(lib.gci_chunk_num_records(handle))
            cols = {
                name: np.empty(n, dtype=np.int32)
                for name in (
                    "ref_id", "pos", "ref_end", "qlen", "mapq", "flag",
                    "m", "i", "d", "s", "eq", "x", "nm",
                )
            }
            h1 = np.empty(n, dtype=np.uint64)
            h2 = np.empty(n, dtype=np.uint64)
            if n:
                lib.gci_chunk_copy_columns(
                    handle,
                    *[_as_ptr(cols[k], ctypes.c_int32) for k in cols],
                    _as_ptr(h1, ctypes.c_uint64),
                    _as_ptr(h2, ctypes.c_uint64),
                )
            self.columns = cols
            self.name_hash = h1
            self.name_hash2 = h2
            self.names = None
            if keep_names:
                bsz = lib.gci_chunk_name_blob_size(handle)
                blob = np.empty(max(bsz, 1), dtype=np.uint8)
                offs = np.empty(n + 1, dtype=np.int64)
                if n:
                    lib.gci_chunk_copy_names(
                        handle, _as_ptr(blob, ctypes.c_uint8),
                        _as_ptr(offs, ctypes.c_int64),
                    )
                else:
                    offs[:] = 0
                raw = blob[:bsz].tobytes()
                self.names = [
                    raw[offs[i]: offs[i + 1]] for i in range(n)
                ]
            self.body = None
            self.record_offsets = None
            if keep_raw:
                bsize = lib.gci_chunk_body_size(handle)
                body = np.empty(max(bsize, 1), dtype=np.uint8)
                roffs = np.empty(max(n, 1), dtype=np.int64)
                if n:
                    lib.gci_chunk_copy_body(
                        handle, _as_ptr(body, ctypes.c_uint8),
                        _as_ptr(roffs, ctypes.c_int64),
                    )
                self.body = body[:bsize].tobytes()
                self.record_offsets = roffs[:n]
        finally:
            lib.gci_chunk_free(handle)

    @property
    def n_records(self) -> int:
        return int(self.columns["ref_id"].shape[0])


class NativeBamStream:
    """Bounded-memory streaming BAM reader (C++ producer pipeline).

    Replaces the whole-file inflate of ``NativeBam`` for the filter path:
    the reference streams windows via pysam fetch (GCI.py:146-169); here a
    background C++ thread reads + inflates + parses BGZF chunks while the
    consumer filters the previous one.  ``comp_range=(start, end)`` limits
    the stream to records starting in BGZF blocks within the compressed
    byte range — the per-host input shard unit.
    """

    def __init__(
        self,
        path: str,
        nthreads: int = 2,
        keep_names: bool = False,
        comp_range: tuple[int, int] | None = None,
        chunk_bytes: int | None = None,
        keep_raw: bool = False,
    ):
        lib = get_lib()
        self._lib = lib
        self._keep_names = keep_names
        self._keep_raw = keep_raw
        start, end = comp_range if comp_range is not None else (0, -1)
        if chunk_bytes is None:
            # measured r5 (2-vCPU host, 8.7 GB-inflated bench BAM): 32 MiB
            # chunks pack 0.9 s vs 1.3-1.5 s at 64 MiB — small enough for
            # cache-friendlier inflate->parse reuse, large enough that
            # per-chunk overheads stay negligible; override to tune
            chunk_bytes = int(
                os.environ.get("GCI_BAM_CHUNK_MB", 32)
            ) << 20
        h = lib.gci_bam_stream_open(
            path.encode(), nthreads, int(keep_names), start, end, chunk_bytes,
            int(keep_raw),
        )
        if not h:
            raise OSError(f"cannot open BAM file: {path}")
        self._h = h
        err = lib.gci_bam_stream_error(h)
        if err:
            msg = err.decode()
            self.close()
            if msg.startswith("uncompressed BAM"):
                # plain (non-BGZF) BAM: no block framing to stream — the
                # caller should fall back to the whole-file reader
                raise UncompressedBamError(f"{path}: {msg}")
            raise ValueError(f"{path}: {msg}")
        nref = int(lib.gci_bam_stream_num_refs(h))
        self.references = [
            lib.gci_bam_stream_ref_name(h, i).decode() for i in range(nref)
        ]
        self.lengths = [
            int(lib.gci_bam_stream_ref_len(h, i)) for i in range(nref)
        ]
        ht_size = lib.gci_bam_stream_header_text_size(h)
        ht = np.empty(max(ht_size, 1), dtype=np.uint8)
        if ht_size:
            lib.gci_bam_stream_copy_header_text(h, _as_ptr(ht, ctypes.c_uint8))
        self.header_text = ht[:ht_size].tobytes().decode(errors="replace")

    def __iter__(self):
        while True:
            ch = self._lib.gci_bam_stream_next(self._h)
            if not ch:
                err = self._lib.gci_bam_stream_error(self._h)
                if err:
                    raise ValueError(err.decode())
                return
            yield NativeBamChunk(self._lib, ch, self._keep_names, self._keep_raw)

    def phase_seconds(self) -> dict[str, float]:
        """Producer wall per phase (read/inflate/walk/parse/wait) — call
        after draining the stream; attribution for the pack stage."""
        names = ("read", "inflate", "walk", "parse", "wait")
        return {
            nm: float(self._lib.gci_bam_stream_phase(self._h, i))
            for i, nm in enumerate(names)
        }

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.gci_bam_stream_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
