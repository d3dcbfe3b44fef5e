"""Smoke run of gci_tpu_torch on one CUDA card, at the size of a real genome.

    python3 chip_smoke.py

Phases, each printing its results:

1. environment: the card (nvidia-smi name and power limit), torch, CUDA and
   nvcc versions, and how the reused C++ host codec built;
2. build of the CUDA kernels (csrc/scan.cu), timed;
3. each of the five kernels against its plain PyTorch version at MH63 size
   (395,765,512 genome slots: 12 chromosomes, 395,765,500 bp), on read
   deltas and on +-2^23 deltas with random truth bytes, exact equality
   required, with the median of 5 CUDA-event timings of each; depth_scan in
   both its forms (int32 deltas and bitmaps; int8 bool bitmaps and
   full-range bytes), each also launched 20 times on one input, every
   result exact (a look-back ordering fault shows only sometimes); the
   three unpacked-stream kernels against each other and against the packed
   one; the on-device compaction as built (the int8 depth_scan of the
   bitmap + searchsorted) beside torch.nonzero; and a small DeviceDepth, on
   the packed and on the flags path, against the numpy depth oracle;
4. the public entries of the two kernels no CLI path runs:
   ``depth.device.depth_and_edges_fused`` (fused_depth_scan) and
   ``depth.scan.fused_depth_scan_masked``, at MH63 size, each checked
   against its plain version;
5. the main path: ``gci_tpu_torch.cli.main`` on an MH63-shaped reference
   with a HiFi and an ONT BAM and a regions BED, with ``--device device``
   (the packed path), again with ``--device device`` and
   ``gci_tpu_torch.depth.fused.PACKED_DEPTH_LIMIT`` set to 1 in this process
   (the flags path every read count at or above 2^29 takes), and with
   ``--device events``; both device runs' nine outputs must be identical to
   the events run's;
6. the streamed path (``depth/streamed.py``): (a) the same MH63-shaped
   inputs with ``--device streamed`` and
   ``gci_tpu_torch.depth.streamed.CHUNK_SLOTS`` lowered so that 4 chunks run
   and every chunk border falls inside a run, nine outputs identical to the
   events run of phase 5; (b) a human-T2T-sized dual-type genome,
   3,100,000,000 bp in 24 chromosomes (3,100,000,024 slots) with N runs, a
   regions BED and 160,000 HiFi and 160,000 ONT reads, run with ``--device
   device``, which must take the streamed path at its switch point
   (``accum.stream_slot_limit``), and with ``--device events``, nine outputs
   identical.  Each prints its chunks, walls, stages, peak device memory
   and host peak RSS;
7. the side-car tools (``gci_tpu_torch.tools``) on what the device paths of
   phases 5 and 6 wrote, each with its wall time and host RSS above its
   start: (a) ``score_only.main`` on the packed run's three MH63
   checkpoints and (b) on the T2T device run's three 3.1 Gbp checkpoints,
   each reproducing that run's ``.gci``, ``.regions.gci`` and ``.gaps.bed``,
   and as ``<prefix>.0.depth.bed`` its two-type issue BED (the type scored
   last writes the shared name); (c) ``filter_bam.main -t 8`` on the
   200,000-record HiFi BAM, read back coordinate-sorted with every BAI
   chunk start decoding to a record of its reference; (d)
   ``convert_depth.main`` on a ``samtools depth`` text of the first 2 Mbp
   of two chromosomes of the packed run's HiFi depth, read back equal.  The
   tools launch no kernel.  The plot tools are not run here (the card's
   machine is not known to have matplotlib); the CPU tests hold them
   against ``gci_tpu``'s;
8. the pack<->scatter overlap (``depth/overlap.py``), which the CLI does
   not take: each read type's BAM packed by ``overlap.feed_bam`` into an
   accumulator on the card ("on"), against ``pipeline.run_filter`` on the
   same BAM chunks ("off", the depth of the curated reads), each for the
   HiFi and the ONT BAM: (a) the MH63-shaped inputs into the resident
   delta, then ``DeviceDepth.from_delta``'s packed branch (K1 once per
   type, K3 not), (b) the same with ``PACKED_DEPTH_LIMIT`` 1 (its flags
   branch: K3 once per type, K1 not), (c) the same inputs into the
   coordinate sweep over phase 6a's 4 chunks and (d) phase 6b's 3.1 Gbp
   inputs into the sweep over its 12 chunks (K2 and K2 int8 once per
   chunk and type in both).  The BAMs are read in chunks of 128 KiB (at
   least 20 per BAM, checked) and, in (a) and (d), again at run_filter's
   default 64 MiB.  Every checkpoint, on and off, must equal the events
   run's of phase 5 or 6b; the peak device memory must be at most the
   resident path's (``RESIDENT_MH63_PEAK``) in (a) and (b); at 128 KiB the
   sweep must finalize genome chunks during pack and stay below that
   peak.  Each prints, on and off, the pack and depth seconds, the
   last-wins fold's seconds, BAM chunks, rows retracted, chunks finalized
   during pack, peak device memory and host RSS;
9. the sharded backend (``depth/sharded.py``) on phase 5's MH63-shaped
   inputs: (a) ``cli.main`` with ``--device sharded --mesh 1,1
   --coordinator 127.0.0.1:<free port> --num-processes 1 --process-id 0``,
   which starts an NCCL process group of one process and destroys it at
   the end, with ``--profile-trace`` (a ``torch.profiler`` trace must be
   written); (b) ``run_gci(depth_backend="sharded")`` on meshes of 4
   positions, all on ``cuda:0``, shaped (2,2), (1,4) and (4,1).  Positions
   on one card hold the programs and their launches per shard, not several
   cards.  Each run's nine outputs must be identical to phase 5's events
   run, K2 and its int8 form must launch exactly ``SHARDED_SCANS_PER_SHARD``
   times per gp shard and no other kernel at all; each prints its wall,
   stages, peak device memory and host RSS.

Launch counts are set to 0 just before each path of phases 4 to 9 runs and
read just after, and each path of phases 4 to 6, 8 and 9 must have launched its
kernels (and not the scans of the other paths).  The script prints one JSON line with each
kernel's launches on its path and on every path, error, times and bound,
then as its last line ``{"ok": true, "device": {...}}``.  Any failed check
raises and exits nonzero; so does a machine without CUDA.  Inputs are
generated from a seed in a temporary directory that is removed at the end.
"""
from __future__ import annotations

import gzip
import json
import os
import resource
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from gci_tpu_torch import cli, kernels
from gci_tpu_torch.depth import accum, fused, streamed
from gci_tpu_torch.depth.accum import GenomeLayout, accumulate_depth_numpy
from gci_tpu_torch.depth.device import (
    depth_and_edges_fused,
    pack_read_deltas,
    scatter_events,
)
from gci_tpu_torch.depth.fused import DeviceDepth, _compact, flags_for, packed_event_word
from gci_tpu_torch.depth.scan import (
    depth_scan,
    depth_scan_torch,
    fused_depth_scan,
    fused_depth_scan_flags,
    fused_depth_scan_flags_torch,
    fused_depth_scan_masked,
    fused_depth_scan_masked_torch,
    fused_depth_scan_packed,
    fused_depth_scan_packed_torch,
    fused_depth_scan_torch,
)
from gci_tpu_torch.intervals.collapse import collapse_depth_runs
from gci_tpu_torch.io.bam import BamStream
from gci_tpu_torch.io.bam_writer import build_record, write_bam
from gci_tpu_torch.depth.overlap import DeltaAccumulator, SweepAccumulator, feed_bam
from gci_tpu_torch.io.depth_file import read_depth_gz, read_depth_gz_events, write_depth_gz
from gci_tpu_torch.io.fasta import scan_fasta
from gci_tpu_torch.native import ensure_host_codec
from gci_tpu_torch.parallel.distributed import init_multihost, shutdown_multihost
from gci_tpu_torch.parallel.mesh import make_mesh
from gci_tpu_torch.pipeline import run_filter, run_gci
from gci_tpu_torch.tools import convert_depth, filter_bam, score_only
from gci_tpu_torch.utils.metrics import get_metrics, trace_path

SEED = 63
# MH63 rice: 12 chromosomes, 395,765,500 bp; the split between chromosomes
# is synthetic, proportional to rice chromosome sizes
MH63_TOTAL_BP = 395_765_500
CHROM_WEIGHTS = [43.3, 35.9, 36.4, 35.5, 29.9, 31.2, 29.7, 28.4, 23.0, 23.2, 31.2, 27.5]
N_HIFI, HIFI_MEAN, HIFI_SD = 200_000, 18_000, 4_000
N_ONT, ONT_MEAN, ONT_SD = 100_000, 25_000, 10_000
TIMED_RUNS = 5
REPEATED_LAUNCHES = 20  # of each depth_scan form on one input
PREFIX = "MH63"
# phase 6a: 4 chunks of the MH63-shaped genome, borders away from chromosome
# starts
MH63_STREAM_CHUNK = 100_000_007
# phase 6b: a human T2T assembly's size, 3.1 Gbp in 24 chromosomes; the split
# is synthetic, proportional to the T2T-CHM13v2.0 chromosome sizes (chr1-22,
# X, Y).  Only the reads are cut, from the ~9M reads of 58x HiFi to 160,000
# per type.
T2T_PREFIX = "T2T"
T2T_TOTAL_BP = 3_100_000_000
T2T_SIZES_MBP = [
    248.39, 242.70, 201.11, 193.57, 182.05, 172.13, 160.57, 146.26, 150.62,
    134.76, 135.13, 133.32, 113.57, 101.16, 99.75, 96.33, 84.28, 80.54, 61.71,
    66.21, 45.09, 51.32, 154.26, 62.46,
]
T2T_READS = 160_000  # per read type
RESIDENT_MH63_PEAK = 9_897_666_048  # bytes, the resident path's peak at MH63 size
CONVERT_BP = 2_000_000  # phase 7d: lines of samtools-depth text per chromosome
# phase 8: BAM chunks of 128 KiB inflated, so that each BAM arrives in at
# least 20 (at run_filter's default 64 MiB the MH63 HiFi BAM is one)
OVERLAP_BAM_CHUNK_BYTES = 128 << 10
DEFAULT_BAM_CHUNK_BYTES = 64 << 20
OVERLAP_MIN_BAM_CHUNKS = 20
OVERLAP_CASES = {
    # launches_by_path key: the case's label and inputs, its accumulator,
    # run_filter's --device for the run without it, the sweep's chunk,
    # PACKED_DEPTH_LIMIT, the BAM chunk sizes (the first one's launches
    # count) and exact launch counts of the two read types' overlap runs
    "overlap_packed": dict(
        label="8a MH63 resident delta", inputs="mh63", acc="delta", backend="device",
        bam_chunk_bytes=(OVERLAP_BAM_CHUNK_BYTES, DEFAULT_BAM_CHUNK_BYTES),
        exact={"fused_depth_scan_packed": 2, "fused_depth_scan_flags": 0}),
    "overlap_flags": dict(
        label="8b MH63 resident delta, PACKED_DEPTH_LIMIT 1", inputs="mh63", acc="delta",
        backend="device", limit=1, bam_chunk_bytes=(OVERLAP_BAM_CHUNK_BYTES,),
        exact={"fused_depth_scan_flags": 2, "fused_depth_scan_packed": 0}),
    "overlap_sweep_mh63": dict(
        label="8c MH63 sweep", inputs="mh63", acc="sweep", backend="streamed",
        chunk=MH63_STREAM_CHUNK, bam_chunk_bytes=(OVERLAP_BAM_CHUNK_BYTES,)),
    "overlap_sweep_3g": dict(
        label="8d T2T sweep", inputs="t2t", acc="sweep", backend="device",
        bam_chunk_bytes=(OVERLAP_BAM_CHUNK_BYTES, DEFAULT_BAM_CHUNK_BYTES)),
}
# the stages of a run_filter call from the BAM to the depth on the host
PACK_TO_DEPTH_STAGES = ("bam_pack", "curation", "depth_accumulate", "checkpoint_readback")
# phase 9: launches of a dual-type sharded run with regions and N gaps, per
# gp shard, counted from the code: K2 for the two read sets, their two gap
# masks, the two-type mask and the three scan windows (one per issue BED);
# its int8 form for the three checkpoints' run boundaries, the three host
# views of the regions report and the two edge bitmaps of each issue BED
SHARDED_SCANS_PER_SHARD = {"depth_scan": 8, "depth_scan_int8": 12}
SHARDED_MESHES = ((2, 2), (1, 4), (4, 1))  # positions on cuda:0, phase 9b


def outputs(prefix: str) -> list[str]:
    """The nine outputs of a dual-type run with regions and N gaps."""
    return [
        f"{prefix}_hifi.depth.gz", f"{prefix}_nano.depth.gz", f"{prefix}_two_type.depth.gz",
        f"{prefix}_hifi.0.depth.bed", f"{prefix}_nano.0.depth.bed",
        f"{prefix}_two_type.0.depth.bed", f"{prefix}.gci", f"{prefix}.regions.gci",
        f"{prefix}.gaps.bed",
    ]


SOURCE = "gci_tpu_torch/csrc/scan.cu"
KERNEL_ROWS = {
    # wrapper name -> (the TPU kernel it replaces, the path whose launches
    # count, bytes per slot: each input read once and each output written
    # once, integer operations per slot the function needs, the one PyTorch
    # call that computes the same function or None)
    "fused_depth_scan_packed": ("gci_tpu/depth/pallas_scan.py:605", "packed", 9, 18, None),
    "depth_scan": ("gci_tpu/depth/pallas_scan.py:208", "streamed_3g", 8, 1,
                   lambda x: torch.cumsum(x, 0, dtype=torch.int32)),
    "depth_scan_int8": ("gci_tpu/depth/pallas_scan.py:208", "streamed_3g", 5, 1,
                        lambda x: torch.cumsum(x, 0, dtype=torch.int32)),
    "fused_depth_scan_flags": ("gci_tpu/depth/pallas_scan.py:467", "flags", 10, 16, None),
    "fused_depth_scan": ("gci_tpu/depth/pallas_scan.py:252", "entries", 11, 10, None),
    "fused_depth_scan_masked": ("gci_tpu/depth/pallas_scan.py:336", "entries", 13, 16, None),
}
# the card's peaks at 700 W (NVIDIA's H100 SXM data sheet): memory bytes/s,
# and float32 operations/s outside the tensor cores, the rate each integer
# operation is counted at
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# the kernels each CLI path must launch, and the scans it must not
PATH_KERNELS = {
    "packed": (("fused_depth_scan_packed", "depth_scan", "depth_scan_int8"),
               ("fused_depth_scan_flags",)),
    "flags": (("fused_depth_scan_flags", "depth_scan", "depth_scan_int8"),
              ("fused_depth_scan_packed",)),
    "streamed": (("depth_scan", "depth_scan_int8"),
                 ("fused_depth_scan_packed", "fused_depth_scan_flags")),
}
WIDE = (-(2**30), 2**30)  # an issue range holding about half of random depths


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def median_ms(fn, runs: int = TIMED_RUNS) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def max_abs_err(got, want) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def hold(name: str, kernel, plain, cases, timed) -> dict:
    """Each case through the kernel and its plain version, every output
    exactly equal; then the median times of both, and of the one PyTorch
    call computing the same function where there is one, on ``timed``, and
    the kernel's bound on those inputs."""
    before = kernels.LAUNCHES[name]
    err = 0
    for k, args in enumerate(cases):
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        for g, w in zip(got, want, strict=True):
            check(g.dtype == w.dtype and torch.equal(g, w), f"{name} != plain on case {k}")
            err = max(err, max_abs_err(g, w))
        del got, want
    check(kernels.LAUNCHES[name] == before + len(cases),
          f"{name} launch count did not advance")
    ms = median_ms(lambda: kernel(*timed))
    plain_ms = median_ms(lambda: plain(*timed))
    _, _, bytes_per_slot, ops_per_slot, library = KERNEL_ROWS[name]
    library_ms = None if library is None else median_ms(lambda: library(timed[0]))
    n = timed[0].shape[0]
    bound_ms, bound_by = max(
        (n * bytes_per_slot / PEAK_BYTES_PER_S * 1e3, "bytes"),
        (n * ops_per_slot / PEAK_OPS_PER_S * 1e3, "operations"),
    )
    log(f"[kernels] {name} exact on {len(cases)} inputs, {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms, library {library_ms} ms; bound {bound_ms:.4f} ms "
        f"({bound_by}, {bytes_per_slot} B/slot at {n} slots), "
        f"{100 * bound_ms / ms:.1f}% of it")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def hold_repeats(name: str, x: torch.Tensor) -> None:
    """REPEATED_LAUNCHES launches of depth_scan on x, back to back, then
    every result against the plain one."""
    want = depth_scan_torch(x)
    before = kernels.LAUNCHES[name]
    got = [depth_scan(x) for _ in range(REPEATED_LAUNCHES)]
    torch.cuda.synchronize()
    check(kernels.LAUNCHES[name] == before + REPEATED_LAUNCHES,
          f"{name} repeated launches not counted")
    bad = [k for k, g in enumerate(got) if not torch.equal(g, want)]
    check(not bad, f"{name} != plain on repeated launches {bad}")
    log(f"[kernels] {name} exact on all {REPEATED_LAUNCHES} back-to-back launches "
        f"on one input")


# ---------------------------------------------------------------------------
# 1. environment
# ---------------------------------------------------------------------------

def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    nvcc = subprocess.run(
        [kernels.find_nvcc(), "--version"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[-1]
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: {nvcc}")
    log(f"[env] device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    log(f"[env] gci_tpu_torch.native host codec built with: {ensure_host_codec()}")
    return smi


# ---------------------------------------------------------------------------
# 2. kernel build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    path = kernels.build(verbose=True)  # prints ptxas' registers and spills
    kernels.load()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def chrom_lengths() -> dict[str, int]:
    w = np.asarray(CHROM_WEIGHTS)
    lens = np.floor(w / w.sum() * MH63_TOTAL_BP).astype(np.int64)
    lens[0] += MH63_TOTAL_BP - int(lens.sum())
    return {f"Chr{k + 1:02d}_MH63": int(L) for k, L in enumerate(lens)}


def gap_runs(lengths: dict[str, int]) -> dict[str, list[tuple[int, int]]]:
    """A few N runs: mid-chromosome, at a chromosome start and at its end."""
    names = list(lengths)
    return {
        names[1]: [(5_000_000, 5_050_000), (20_000_000, 20_000_100)],
        names[4]: [(0, 10_000)],
        names[8]: [(lengths[names[8]] - 30_000, lengths[names[8]])],
        names[10]: [(12_345_678, 12_445_678)],
    }


def write_fasta(path: str, lengths, gaps, rng) -> None:
    lut = np.frombuffer(b"ACGT", np.uint8)
    width = 60
    with open(path, "wb") as f:
        for name, L in lengths.items():
            seq = lut[rng.integers(0, 4, L, dtype=np.uint8)]
            for s, e in gaps.get(name, []):
                seq[s:e] = ord("N")
            f.write(b">" + name.encode() + b"\n")
            n_full = L // width
            body = np.empty((n_full, width + 1), np.uint8)
            body[:, :width] = seq[: n_full * width].reshape(n_full, width)
            body[:, width] = 10
            f.write(body)
            if L % width:
                f.write(seq[n_full * width:].tobytes() + b"\n")


def write_reads_bam(path: str, lengths, n, mean, sd, prefix, rng) -> None:
    """Alignments with a realistic filter mix: most pass, some fail on
    mapping quality, flags or clipping, and 1% repeat an earlier name."""
    names = list(lengths)
    lens = np.asarray([lengths[t] for t in names], np.int64)
    ref = rng.choice(len(names), size=n, p=lens / lens.sum())
    span = np.clip(rng.normal(mean, sd, n), 1_000, 4 * mean).astype(np.int64)
    span = np.minimum(span, lens[ref] - 1)
    pos = (rng.random(n) * (lens[ref] - span)).astype(np.int64)
    mapq = np.where(rng.random(n) < 0.9, 60, rng.choice([0, 10, 20, 40], n))
    flag = rng.choice([0, 16, 256, 2048], size=n, p=[0.45, 0.5, 0.03, 0.02])
    clip = np.where(rng.random(n) < 0.03, span // 4, span // 100)
    read_id = np.arange(n)
    dup = rng.random(n) < 0.01
    read_id[dup] = rng.integers(0, n, int(dup.sum()))
    order = np.lexsort((pos, ref))
    recs = [
        build_record(
            f"{prefix}{read_id[k]}", int(ref[k]), int(pos[k]), int(mapq[k]),
            f"{clip[k]}S{span[k]}M", flag=int(flag[k]), seq_len=0,
            nm=int(span[k] // 100),
        )
        for k in order
    ]
    write_bam(path, names, [lengths[t] for t in names], recs, level=1, threads=8)


def make_inputs(root: str, lengths, gaps, n_hifi: int, n_ont: int, whole: str,
                seed: int) -> dict[str, str]:
    """FASTA with ``gaps`` as N runs, HiFi and ONT BAMs, and a regions BED
    (two stretches of the first two chromosomes and all of ``whole``)."""
    paths = {k: os.path.join(root, f) for k, f in (
        ("ref", "ref.fa"), ("hifi", "hifi.bam"), ("ont", "ont.bam"),
        ("regions", "regions.bed"))}
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    write_fasta(paths["ref"], lengths, gaps, rng)
    write_reads_bam(paths["hifi"], lengths, n_hifi, HIFI_MEAN, HIFI_SD, "h", rng)
    write_reads_bam(paths["ont"], lengths, n_ont, ONT_MEAN, ONT_SD, "o", rng)
    names = list(lengths)
    with open(paths["regions"], "w") as f:
        f.write(f"{names[0]}\t1000000\t9000000\n{names[1]}\t4000000\t30000000\n"
                f"{whole}\t0\t{lengths[whole]}\n")
    log(f"[inputs] generated {sum(lengths.values())} bp, {n_hifi} HiFi + {n_ont} "
        f"ONT reads in {time.perf_counter() - t0:.1f} s under {root}")
    return paths


def t2t_lengths() -> dict[str, int]:
    w = np.asarray(T2T_SIZES_MBP)
    lens = np.floor(w / w.sum() * T2T_TOTAL_BP).astype(np.int64)
    lens[0] += T2T_TOTAL_BP - int(lens.sum())
    names = [f"chr{k}" for k in range(1, 23)] + ["chrX", "chrY"]
    return {name: int(L) for name, L in zip(names, lens)}


def t2t_gap_runs(lengths: dict[str, int]) -> dict[str, list[tuple[int, int]]]:
    """N runs mid-chromosome, at a chromosome start and at an end."""
    return {
        "chr1": [(120_000_000, 120_100_000)],
        "chr9": [(0, 20_000), (60_000_000, 60_000_500)],
        "chr13": [(5_000_000, 5_400_000)],
        "chrY": [(lengths["chrY"] - 50_000, lengths["chrY"])],
    }


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def synthetic_reads(rng, layout, n_reads=N_HIFI):
    tid = rng.integers(0, len(layout.names), n_reads).astype(np.int32)
    start = (rng.random(n_reads) * layout.lengths[tid]).astype(np.int64)
    end = start + rng.integers(1_000, 40_000, n_reads)
    return tid, start, end


def read_delta(layout, tid, start, end, dev):
    gs, ge, live = pack_read_deltas(layout, tid, start, end, 15)
    return scatter_events(layout.total_slots, dev, [(gs, live), (ge, -live)])


def phase_kernels(dev: torch.device) -> dict[str, dict]:
    rng = np.random.default_rng(SEED + 1)
    lengths = chrom_lengths()
    gaps = gap_runs(lengths)
    layout = GenomeLayout.from_targets(lengths)
    n = layout.total_slots
    log(f"[kernels] {n} slots")
    rows = {}

    # K1 on the port's own packed-word scatter of synthetic reads with N-gaps
    tid, start, end = synthetic_reads(rng, layout)
    word = packed_event_word(layout, tid, start, end, 15, gaps, dev)
    rows["fused_depth_scan_packed"] = hold(
        "fused_depth_scan_packed", fused_depth_scan_packed, fused_depth_scan_packed_torch,
        [(word, -1, 0), (word, -1, 1)], (word, -1, 0),
    )

    # compaction as built (int8 depth_scan + searchsorted) vs torch.nonzero
    k1_depth, k1_flags = fused_depth_scan_packed(word, -1, 0)
    del word
    bits = (k1_flags & 4) != 0
    count = int(bits.sum())
    check(torch.equal(_compact(bits, count), torch.nonzero(bits).squeeze(1)),
          "compaction != torch.nonzero")
    c_ms = median_ms(lambda: _compact(bits, count))
    nz_ms = median_ms(lambda: torch.nonzero(bits).squeeze(1))
    log(f"[kernels] compaction of {count} change bits: int8 depth_scan+searchsorted "
        f"{c_ms:.4f} ms, torch.nonzero {nz_ms:.4f} ms")
    del bits

    # K2's int32 form on +-2^23 deltas (wraps mod 2^32) and on a 0/1 bitmap;
    # its int8 form on a bool bitmap viewed as int8 and on bytes in
    # [-128, 127] (sign-extended)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    xs = [torch.randint(lo, hi, (n,), dtype=torch.int32, device=dev, generator=g)
          for lo, hi in ((-(2**23), 2**23), (0, 2))]
    rows["depth_scan"] = hold("depth_scan", depth_scan, depth_scan_torch,
                              [(x,) for x in xs], (xs[1],))
    bs = [xs[1].to(torch.bool).view(torch.int8),
          torch.randint(-128, 128, (n,), dtype=torch.int32, device=dev,
                        generator=g).to(torch.int8)]
    rows["depth_scan_int8"] = hold("depth_scan_int8", depth_scan, depth_scan_torch,
                                   [(b,) for b in bs], (bs[0],))
    hold_repeats("depth_scan", xs[0])
    hold_repeats("depth_scan_int8", bs[1])
    del xs, bs
    torch.cuda.empty_cache()

    # K3, K5, K4 on the same reads and intervals as K1 (a plain delta and
    # flag bytes), and on +-2^23 deltas under random truth bytes
    delta = read_delta(layout, tid, start, end, dev)
    flags = flags_for(layout, gaps, 15, n, dev)
    gap, valid = flags & 1, flags & 2

    def random_bytes(p):
        b = torch.randint(-128, 128, (n,), dtype=torch.int32, device=dev, generator=g)
        return torch.where(torch.rand(n, device=dev, generator=g) < p, b, 0).to(torch.int8)

    r_delta = torch.randint(-(2**23), 2**23, (n,), dtype=torch.int32, device=dev,
                            generator=g)
    r_flags, r_gap, r_valid = random_bytes(1.0), random_bytes(0.15), random_bytes(0.8)
    rows["fused_depth_scan_flags"] = hold(
        "fused_depth_scan_flags", fused_depth_scan_flags, fused_depth_scan_flags_torch,
        [(delta, flags, -1, 0), (delta, flags, -1, 1), (r_delta, r_flags, *WIDE)],
        (delta, flags, -1, 0),
    )
    rows["fused_depth_scan_masked"] = hold(
        "fused_depth_scan_masked", fused_depth_scan_masked, fused_depth_scan_masked_torch,
        [(delta, gap, valid, -1, 0), (r_delta, r_gap, r_valid, *WIDE)],
        (delta, gap, valid, -1, 0),
    )
    rows["fused_depth_scan"] = hold(
        "fused_depth_scan", fused_depth_scan, fused_depth_scan_torch,
        [(delta, valid, -1, 0), (r_delta, r_valid, *WIDE)], (delta, valid, -1, 0),
    )
    del r_delta, r_flags, r_gap, r_valid

    # the three agree with each other and with K1 on matching inputs
    d3, o3 = fused_depth_scan_flags(delta, flags, -1, 0)
    check(torch.equal(d3, k1_depth) and torch.equal(o3, k1_flags & 7),
          "fused_depth_scan_flags != fused_depth_scan_packed & 7")
    del k1_depth, k1_flags
    d5, r5, f5, c5 = fused_depth_scan_masked(delta, gap, valid, -1, 0)
    check(torch.equal(d5, d3) and torch.equal(r5, o3 & 1)
          and torch.equal(f5, (o3 >> 1) & 1) and torch.equal(c5, (o3 >> 2) & 1),
          "fused_depth_scan_masked != fused_depth_scan_flags bits 0-2")
    del d5, r5, f5, c5
    d4, r4, f4 = fused_depth_scan(delta, valid, -1, 0)
    _, r0, f0, _ = fused_depth_scan_masked(delta, torch.zeros_like(gap), valid, -1, 0)
    check(torch.equal(d4, d3) and torch.equal(r4, r0) and torch.equal(f4, f0),
          "fused_depth_scan != fused_depth_scan_masked without gaps")
    log("[kernels] fused_depth_scan_flags, _masked and fused_depth_scan agree with "
        "each other and with fused_depth_scan_packed")
    del delta, flags, gap, valid, d3, o3, d4, r4, f4, r0, f0
    phase_small_oracle(dev)
    torch.cuda.empty_cache()
    return rows


def phase_small_oracle(dev: torch.device) -> None:
    """A small DeviceDepth on the card against the numpy depth oracle."""
    rng = np.random.default_rng(SEED + 2)
    layout = GenomeLayout.from_targets({"a": 50_000, "b": 20, "c": 30_000})
    tid = rng.integers(0, 3, 2_000).astype(np.int32)
    start = rng.integers(0, 25_000, 2_000).astype(np.int64)
    end = start + rng.integers(40, 3_000, 2_000)
    gaps = {"a": [(100, 900), (40_000, 40_500)], "c": [(0, 64)]}
    flat = accumulate_depth_numpy(layout, tid, start, end, 15)
    limit = fused.PACKED_DEPTH_LIMIT
    for path, gap_bit in (("packed", 8), ("flags", 1)):
        fused.PACKED_DEPTH_LIMIT = limit if path == "packed" else 0
        try:
            dd = DeviceDepth.from_reads(layout, tid, start, end, 15, gaps=gaps,
                                        issue_range=(-1, 1), device=dev)
        finally:
            fused.PACKED_DEPTH_LIMIT = limit
        check(dd.gap_bit == gap_bit, f"small DeviceDepth did not take the {path} path")
        got = dd.materialize_dict()
        masked = dd.mask_gaps(gaps)
        for k, name in enumerate(layout.names):
            o, L = int(layout.offsets[k]), int(layout.lengths[k])
            want = flat[o : o + L].copy()
            check(np.array_equal(got[name], want), f"small DeviceDepth != numpy ({path}, {name})")
            check(np.array_equal(dd.to_events()[name].materialize(), want),
                  f"small DeviceDepth events != numpy ({path}, {name})")
            for s, e in gaps.get(name, []):
                want[s:e] = 0
            check(masked.collapse_dict(-1, 1, 15)[name] == collapse_depth_runs(want, -1, 1, 15),
                  f"small DeviceDepth issue intervals != numpy ({path}, {name})")
    log("[kernels] small DeviceDepth on the card equals the numpy oracle on the "
        "packed and the flags path")


# ---------------------------------------------------------------------------
# 4. the public entries of fused_depth_scan and fused_depth_scan_masked
# ---------------------------------------------------------------------------

def phase_entries(dev: torch.device) -> dict[str, int]:
    rng = np.random.default_rng(SEED + 3)
    lengths = chrom_lengths()
    layout = GenomeLayout.from_targets(lengths)
    n = layout.total_slots
    tid, start, end = synthetic_reads(rng, layout)
    gs, ge, live = pack_read_deltas(layout, tid, start, end, 15)
    flags = flags_for(layout, gap_runs(lengths), 15, n, dev)
    gap, valid = flags & 1, flags & 2
    del flags
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    edges = depth_and_edges_fused(gs, ge, live, valid, -1, 0, n, device=dev)
    delta = read_delta(layout, tid, start, end, dev)
    masked = fused_depth_scan_masked(delta, gap, valid, -1, 0)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for name in ("fused_depth_scan", "fused_depth_scan_masked"):
        check(launches[name] == 1, f"{name} was not launched by its entry")
    for got, want in ((edges, fused_depth_scan_torch(delta, valid, -1, 0)),
                      (masked, fused_depth_scan_masked_torch(delta, gap, valid, -1, 0))):
        check(all(torch.equal(a, b) for a, b in zip(got, want, strict=True)),
              "an entry's outputs differ from the plain version")
    log(f"[entries] depth_and_edges_fused and fused_depth_scan_masked exact at {n} "
        f"slots; launches {launches}")
    del edges, masked, delta, gap, valid
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 5. the main path
# ---------------------------------------------------------------------------

def _same_file(p1: str, p2: str) -> bool:
    """Same content: equal bytes, or for .gz equal inflated bytes."""
    with open(p1, "rb") as a, open(p2, "rb") as b:
        while True:
            x, y = a.read(1 << 26), b.read(1 << 26)
            if x != y:
                break
            if not x:
                return True
    if not p1.endswith(".gz"):
        return False
    with gzip.open(p1, "rb") as a, gzip.open(p2, "rb") as b:
        while True:
            x, y = a.read(1 << 26), b.read(1 << 26)
            if x != y:
                return False
            if not x:
                return True


def check_same_outputs(dir1: str, dir2: str, prefix: str, what: str) -> None:
    for name in outputs(prefix):
        check(_same_file(os.path.join(dir1, name), os.path.join(dir2, name)),
              f"{name}: {what} differs from --device events")


def run_cli(paths, out_dir: str, backend: str, prefix: str = PREFIX) -> tuple[float, list]:
    get_metrics().reset()
    t0 = time.perf_counter()
    cli.main([
        "-r", paths["ref"], "--hifi", paths["hifi"], "--nano", paths["ont"],
        "-R", paths["regions"], "-d", out_dir, "-o", prefix, "-t", "8", "-f",
        "--device", backend, "--profile",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, [r.as_dict() for r in get_metrics().records]


def run_device_path(paths, out_dir: str, backend: str, path: str, label: str,
                    prefix: str = PREFIX):
    """One ``--device backend`` CLI run with the launch counts set to 0 just
    before it and read just after; the path's kernels must have launched
    and the other paths' scans not.  Returns (launches, peak device bytes)."""
    required, absent = PATH_KERNELS[path]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    wall, stages = run_cli(paths, out_dir, backend, prefix)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in required:
        check(launches[name] > 0, f"{name} was not launched on the {path} path")
    for name in absent:
        check(launches[name] == 0, f"{name} was launched on the {path} path")
    log(f"{label}: --device {backend} run {wall:.3f} s; launches {launches}")
    log(f"{label}: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB; "
        f"{before} bytes allocated before the run)")
    log(f"{label}: stages " + json.dumps(stages))
    return launches, peak


def phase_main_path(paths, work: str):
    """Returns the launches of each path and the packed path's peak."""
    dirs = {k: os.path.join(work, k) for k in ("packed", "flags", "events")}
    launches = {}
    launches["packed"], packed_peak = run_device_path(
        paths, dirs["packed"], "device", "packed", "[main] packed path")
    limit = fused.PACKED_DEPTH_LIMIT
    fused.PACKED_DEPTH_LIMIT = 1  # every read count takes the flags path
    try:
        launches["flags"], _ = run_device_path(
            paths, dirs["flags"], "device", "flags", "[main] flags path")
    finally:
        fused.PACKED_DEPTH_LIMIT = limit
    wall_ev, stages_ev = run_cli(paths, dirs["events"], "events")
    for path in ("packed", "flags"):
        check_same_outputs(dirs[path], dirs["events"], PREFIX,
                           f"--device device ({path} path)")
    log(f"[main] events run {wall_ev:.3f} s; all {len(outputs(PREFIX))} outputs of "
        "both device paths identical to it")
    log("[main] stages events " + json.dumps(stages_ev))
    return launches, packed_peak


# ---------------------------------------------------------------------------
# 6. the streamed path
# ---------------------------------------------------------------------------

class StreamedCalls:
    """While active: ``streamed.CHUNK_SLOTS`` set to ``chunk_slots`` (if
    given), and each result of the streamed path kept in ``results`` (the
    pipeline looks the function up at each call)."""

    def __init__(self, chunk_slots: int | None = None):
        self.chunk_slots = chunk_slots
        self.results = []

    def __enter__(self):
        self._real, self._chunk = streamed.events_from_reads_streamed, streamed.CHUNK_SLOTS

        def spy(*args, **kwargs):
            self.results.append(self._real(*args, **kwargs))
            return self.results[-1]

        streamed.events_from_reads_streamed = spy
        if self.chunk_slots is not None:
            streamed.CHUNK_SLOTS = self.chunk_slots
        return self

    def __exit__(self, *exc):
        streamed.events_from_reads_streamed = self._real
        streamed.CHUNK_SLOTS = self._chunk


def rss_bytes() -> int:
    """This process's resident set size now."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize()


class RssPeak:
    """This process's resident set size when entered (``start``) and the
    largest while active (``peak``), sampled every 10 ms by a thread (the
    kernel's own peak mark covers the whole process and cannot always be
    reset)."""

    def __enter__(self):
        self.start = self.peak = rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self) -> None:
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, rss_bytes())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def check_streamed_launches(launches, n_chunks: int, label: str) -> None:
    """Two read types, each chunk of each: one int32 scan (its depth) and
    one int8 scan (its boundary bitmap's prefix)."""
    for name in ("depth_scan", "depth_scan_int8"):
        check(launches[name] == 2 * n_chunks,
              f"{label}: {name} launched {launches[name]} times, expected {2 * n_chunks}")


def phase_streamed_mh63(paths, work: str) -> dict[str, int]:
    """6a: --device streamed on the MH63-shaped inputs, 4 chunks whose
    borders fall inside runs, against phase 5's events run."""
    lengths = chrom_lengths()
    layout = GenomeLayout.from_targets(lengths)
    n_chunks = -(-layout.total_slots // MH63_STREAM_CHUNK)
    log(f"[streamed] MH63: {n_chunks} chunks of {MH63_STREAM_CHUNK} slots over "
        f"{layout.total_slots}")
    check(n_chunks >= 4, "fewer than 4 chunks")
    out = os.path.join(work, "streamed")
    with StreamedCalls(MH63_STREAM_CHUNK) as calls:
        launches, _ = run_device_path(paths, out, "streamed", "streamed",
                                      "[streamed] MH63")
    check(len(calls.results) == 2, "the streamed path did not run for both read types")
    check_streamed_launches(launches, n_chunks, "MH63 streamed")
    for c in range(1, n_chunks):
        a = c * MH63_STREAM_CHUNK
        k = int(np.searchsorted(layout.offsets, a, side="right")) - 1
        local, name = a - int(layout.offsets[k]), layout.names[k]
        check(0 < local < int(layout.lengths[k]), f"chunk border {a} is not inside a target")
        for ev in calls.results:
            check(local not in set(ev[name].boundaries.tolist()),
                  f"chunk border {a} is a run boundary of {name}")
    log(f"[streamed] MH63: all {n_chunks - 1} chunk borders fall inside runs of "
        "both read types")
    check_same_outputs(out, os.path.join(work, "events"), PREFIX, "--device streamed")
    log(f"[streamed] MH63: all {len(outputs(PREFIX))} outputs identical to the "
        "events run")
    return launches


def phase_streamed_t2t(work: str, packed_peak: int) -> tuple[dict[str, int], dict, str]:
    """6b: a 3.1 Gbp dual-type genome through --device device, which must
    take the streamed path, against --device events.  Returns the launches,
    the inputs and the device run's directory."""
    lengths = t2t_lengths()
    layout = GenomeLayout.from_targets(lengths)
    check(layout.total_slots == T2T_TOTAL_BP + len(lengths), "T2T slot count")
    paths = make_inputs(os.path.join(work, "t2t_inputs"), lengths, t2t_gap_runs(lengths),
                        T2T_READS, T2T_READS, "chrX", SEED + 5)
    limit = accum.stream_slot_limit(torch.device("cuda", torch.cuda.current_device()))
    n_chunks = -(-layout.total_slots // streamed.CHUNK_SLOTS)
    log(f"[streamed] T2T: {layout.total_slots} slots, switch point {limit} slots; "
        f"{n_chunks} chunks of {streamed.CHUNK_SLOTS} slots")
    check(layout.total_slots > limit, "the T2T genome is below the switch point")
    dirs = {k: os.path.join(work, f"t2t_{k}") for k in ("device", "events")}
    with RssPeak() as rss, StreamedCalls() as calls:
        launches, peak = run_device_path(paths, dirs["device"], "device", "streamed",
                                         "[streamed] T2T", T2T_PREFIX)
    check(len(calls.results) == 2, "--device device did not take the streamed path")
    check_streamed_launches(launches, n_chunks, "T2T --device device")
    check(peak < packed_peak and peak < RESIDENT_MH63_PEAK,
          f"T2T streamed peak {peak} bytes is not below the resident path's")
    log(f"[streamed] T2T: host RSS during the device run: {rss.start} bytes at its "
        f"start, peak {rss.peak} bytes ({rss.peak / 2**30:.3f} GiB, sampled every "
        f"10 ms), {rss.peak - rss.start} bytes above the start; process peak so far "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024} bytes")
    wall_ev, stages_ev = run_cli(paths, dirs["events"], "events", T2T_PREFIX)
    log(f"[streamed] T2T: events run {wall_ev:.3f} s; stages " + json.dumps(stages_ev))
    check_same_outputs(dirs["device"], dirs["events"], T2T_PREFIX,
                       "--device device (streamed path)")
    log(f"[streamed] T2T: all {len(outputs(T2T_PREFIX))} outputs identical to the "
        "events run")
    return launches, paths, dirs["device"]


# ---------------------------------------------------------------------------
# 7. the side-car tools on what the device paths wrote
# ---------------------------------------------------------------------------

def run_tool(label: str, main, argv: list[str]) -> float:
    """``main(argv)`` with its wall time and host RSS above its start."""
    with RssPeak() as rss:
        t0 = time.perf_counter()
        main(argv)
        wall = time.perf_counter() - t0
    log(f"[tools] {label}: {wall:.3f} s wall; host RSS {rss.start} bytes at its start, "
        f"peak {rss.peak} bytes, {rss.peak - rss.start} bytes above the start")
    return wall


def phase_tools_score(paths, run_dir: str, out_dir: str, prefix: str, label: str) -> None:
    """7a/7b: gci-torch-score on a dual-type run's three checkpoints; the
    run's .gci, .regions.gci and .gaps.bed again, and the two-type issue BED
    under the shared name (the type scored last writes it)."""
    argv = ["-r", paths["ref"]]
    for kind, flag in (("hifi", "--hifi"), ("nano", "--nano"), ("two_type", "--two-type")):
        argv += [flag, os.path.join(run_dir, f"{prefix}_{kind}.depth.gz")]
    argv += ["-R", paths["regions"], "-d", out_dir, "-o", prefix, "-f"]
    run_tool(f"{label} gci-torch-score on 3 checkpoints", score_only.main, argv)
    for name in (f"{prefix}.gci", f"{prefix}.regions.gci", f"{prefix}.gaps.bed"):
        check(_same_file(os.path.join(out_dir, name), os.path.join(run_dir, name)),
              f"{label}: rescored {name} differs from the device run's")
    check(_same_file(os.path.join(out_dir, f"{prefix}.0.depth.bed"),
                     os.path.join(run_dir, f"{prefix}_two_type.0.depth.bed")),
          f"{label}: rescored {prefix}.0.depth.bed differs from the two-type issue BED")
    log(f"[tools] {label}: {prefix}.gci, {prefix}.regions.gci, {prefix}.gaps.bed and "
        "the two-type issue BED identical to the device run's")


def bai_chunk_starts(bam_path: str) -> list[tuple[int, int, bytes]]:
    """(reference of the bin, ref_id, read name) of the record at every
    chunk start of the BAI: each virtual offset decoded into its BGZF block
    and the record there, which may run on into the next block."""
    with open(bam_path + ".bai", "rb") as f:
        index = f.read()
    check(index[:4] == b"BAI\x01", "the BAI's magic")
    with open(bam_path, "rb") as f:
        blob = f.read()
    blocks: dict[int, bytes] = {}

    def inflate(coff: int) -> tuple[bytes, int]:
        """The payload of the block at coff, and the next block's offset."""
        xlen = blob[coff + 10] | (blob[coff + 11] << 8)
        (bsize,) = struct.unpack_from("<H", blob, coff + 16)
        end = coff + bsize + 1
        return zlib.decompress(blob[coff + 12 + xlen : end - 8], -15), end

    (n_ref,) = struct.unpack_from("<i", index, 4)
    off, found = 8, []
    for ref in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", index, off)
        off += 4
        for _ in range(n_bin):
            _bin, n_chunk = struct.unpack_from("<Ii", index, off)
            off += 8
            for _ in range(n_chunk):
                vo_s, _vo_e = struct.unpack_from("<QQ", index, off)
                off += 16
                coff, uoff = vo_s >> 16, vo_s & 0xFFFF
                if coff not in blocks:
                    payload, nxt = inflate(coff)
                    if nxt < len(blob):  # a record is shorter than a block
                        payload += inflate(nxt)[0]
                    blocks[coff] = payload
                rec = blocks[coff][uoff:]
                (ref_id,) = struct.unpack_from("<i", rec, 4)
                found.append((ref, ref_id, rec[36 : 36 + rec[12] - 1]))
        (n_intv,) = struct.unpack_from("<i", index, off)
        off += 4 + 8 * n_intv
    return found


def phase_tools_filter_bam(paths, out_dir: str) -> None:
    """7c: gci-torch-filter-bam on the 200,000-record HiFi BAM, read back;
    every BAI chunk start a record of the BAM on the bin's reference."""
    wall = run_tool("MH63 gci-torch-filter-bam -t 8", filter_bam.main,
                    [paths["hifi"], "-d", out_dir, "-t", "8", "-f"])
    out = os.path.join(out_dir, "hifi.filter.bam")
    names, keys = set(), []
    with BamStream(out, threads=8, keep_names=True) as stream:
        for chunk in stream:
            names.update(chunk.names)
            keys.append(chunk.columns["ref_id"].astype(np.int64) << 32
                        | chunk.columns["pos"].astype(np.int64))
    keys = np.concatenate(keys)
    n_records = keys.shape[0]
    check(n_records > N_HIFI // 2, f"filter-bam kept only {n_records} records")
    check(len(names) == n_records, "filter-bam wrote a read name twice")
    check(bool(np.all(np.diff(keys) >= 0)), "filter-bam output is not coordinate-sorted")
    starts = bai_chunk_starts(out)
    check(all(ref == ref_id and name in names for ref, ref_id, name in starts),
          "a BAI offset does not decode to a record of its reference")
    log(f"[tools] MH63 filter-bam: {N_HIFI} input records, {n_records} kept, "
        f"coordinate-sorted, {N_HIFI / wall:.1f} input records/s; all {len(starts)} "
        "BAI chunk starts decode to records of their reference")


def phase_tools_convert(run_dir: str, out_dir: str) -> None:
    """7d: a samtools-depth text of the first CONVERT_BP of two chromosomes
    of the packed run's HiFi depth, through gci-torch-convert-depth, read
    back equal."""
    depths, _ = read_depth_gz_events(os.path.join(run_dir, f"{PREFIX}_hifi.depth.gz"))
    want = {t: depths[t].slice(0, CONVERT_BP).materialize() for t in list(depths)[:2]}
    src = os.path.join(out_dir, "samtools.depth")
    os.makedirs(out_dir, exist_ok=True)
    with open(src, "w") as f:
        for t, v in want.items():
            f.write("".join(f"{t}\t{i}\t{d}\n" for i, d in enumerate(v.tolist(), 1)))
    prefix = os.path.join(out_dir, "converted")
    wall = run_tool(f"gci-torch-convert-depth of {len(want)} x {CONVERT_BP} lines",
                    convert_depth.main, [src, prefix])
    got, _ = read_depth_gz(prefix + ".depth.gz")
    check(list(got) == list(want) and all(np.array_equal(got[t], want[t]) for t in want),
          "convert-depth output differs from its input")
    log(f"[tools] convert-depth: read back equal, {len(want) * CONVERT_BP / wall:.1f} "
        "lines/s")


def phase_tools(paths, t2t_paths, t2t_dir: str, work: str) -> None:
    """7: the side-car tools on the outputs of phases 5 and 6; they launch
    no kernel."""
    kernels.reset_launch_counts()
    phase_tools_score(paths, os.path.join(work, "packed"), os.path.join(work, "score_mh63"),
                      PREFIX, "MH63")
    phase_tools_score(t2t_paths, t2t_dir, os.path.join(work, "score_t2t"), T2T_PREFIX, "T2T")
    phase_tools_filter_bam(paths, os.path.join(work, "filter_bam"))
    phase_tools_convert(os.path.join(work, "packed"), os.path.join(work, "convert"))
    check(not any(kernels.LAUNCHES.values()), "a side-car tool launched a kernel")
    log("[tools] no kernel launched by the side-car tools")


# ---------------------------------------------------------------------------
# 8. the pack<->scatter overlap
# ---------------------------------------------------------------------------

class _Setting:
    """While active: ``GCI_BAM_CHUNK_BYTES`` in this process's environment
    and ``fused.PACKED_DEPTH_LIMIT`` (unless None) set, restored after."""

    def __init__(self, chunk_bytes: int, limit: int | None):
        self.chunk_bytes, self.limit = chunk_bytes, limit

    def __enter__(self):
        self._env = os.environ.get("GCI_BAM_CHUNK_BYTES")
        self._limit = fused.PACKED_DEPTH_LIMIT
        os.environ["GCI_BAM_CHUNK_BYTES"] = str(self.chunk_bytes)
        if self.limit is not None:
            fused.PACKED_DEPTH_LIMIT = self.limit
        return self

    def __exit__(self, *exc):
        fused.PACKED_DEPTH_LIMIT = self._limit
        if self._env is None:
            os.environ.pop("GCI_BAM_CHUNK_BYTES", None)
        else:
            os.environ["GCI_BAM_CHUNK_BYTES"] = self._env


def overlap_on(case, layout, bam: str, gaps, chunk_bytes: int, dev, ckpt: str) -> dict:
    """One BAM through ``feed_bam`` into the case's accumulator, then its
    depth (``from_delta`` and the boundary readback, or the sweep's
    ``finish``), written to ``ckpt``; its seconds and counts."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss:
        t0 = time.perf_counter()
        if case["acc"] == "delta":
            acc = DeltaAccumulator(layout, 15, device=dev)
        else:
            acc = SweepAccumulator(layout, 15, case.get("chunk"), device=dev)
        n_bam = feed_bam(acc, bam, threads=8, chunk_bytes=chunk_bytes)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        finalized = getattr(acc, "frontier", 0)
        if case["acc"] == "delta":
            depths = DeviceDepth.from_delta(layout, acc.take_delta(), 15, gaps=gaps,
                                            issue_range=(-1, 0))
            depths.to_events()
        else:
            depths = acc.finish()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    write_depth_gz(ckpt, depths)
    del depths
    return dict(pack_s=t1 - t0, depth_s=t2 - t1, sum_s=t2 - t0,
                fold_s=acc.fold_seconds, bam_chunks=n_bam,
                rows_retracted=acc.rows_retracted, chunks_finalized_in_pack=finalized,
                peak=peak, rss_above_start=rss.peak - rss.start)


def overlap_off(case, bam: str, gaps, read_type: str, dev, out_dir: str, prefix: str) -> dict:
    """The same BAM through ``run_filter`` (the depth of the curated
    reads); its pack-to-depth stages in seconds."""
    get_metrics().reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss, StreamedCalls(case.get("chunk")):
        depths, _ = run_filter([], [bam], prefix, directory=out_dir, force=True,
                               log_reads_type=read_type, threads=8,
                               depth_backend=case["backend"], torch_device=dev,
                               gaps=gaps, threshold=0)
        torch.cuda.synchronize()
    del depths
    out = {}
    for r in get_metrics().records:
        kind = r.name.partition(":")[2].partition(":")[0]  # <type>:bam_pack:<path>
        if kind in PACK_TO_DEPTH_STAGES:
            out[f"{kind}_s"] = r.seconds
    out["sum_s"] = sum(out.values())
    return dict(out, peak=torch.cuda.max_memory_allocated(),
                rss_above_start=rss.peak - rss.start)


def phase_overlap(inputs, dev) -> dict[str, dict[str, int]]:
    """8: each OVERLAP_CASES case for both read types, with the overlap
    ("on") and through run_filter ("off"), every checkpoint equal to the
    events run's.  Returns the launches of each case's overlap runs at its
    first BAM chunk size."""
    launches = {}
    for key, case in OVERLAP_CASES.items():
        paths, prefix, events_dir, lengths, work = inputs[case["inputs"]]
        layout = GenomeLayout.from_targets(lengths)
        gaps = scan_fasta(paths["ref"])[1]
        n_chunks = -(-layout.total_slots // case.get("chunk", streamed.CHUNK_SLOTS))
        for chunk_bytes in case["bam_chunk_bytes"]:
            label = f"{case['label']}, BAM chunks of {chunk_bytes} bytes"
            out = os.path.join(work, f"{key}_{chunk_bytes}")
            os.makedirs(out)
            runs = {"on": {}, "off": {}}
            with _Setting(chunk_bytes, case.get("limit")):
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                for typ, name in (("hifi", "hifi"), ("ont", "nano")):
                    ckpt = os.path.join(out, f"on_{name}.depth.gz")
                    runs["on"][typ] = overlap_on(case, layout, paths[typ], gaps, chunk_bytes,
                                                 dev, ckpt)
                    check(_same_file(ckpt, os.path.join(events_dir,
                                                        f"{prefix}_{name}.depth.gz")),
                          f"{label}: the {typ} overlap checkpoint differs from the events run")
                torch.cuda.synchronize()
                counts = dict(kernels.LAUNCHES)
                for typ, name in (("hifi", "hifi"), ("ont", "nano")):
                    runs["off"][typ] = overlap_off(case, paths[typ], gaps, typ, dev, out,
                                                   f"off_{name}")
                    check(_same_file(os.path.join(out, f"off_{name}.depth.gz"),
                                     os.path.join(events_dir, f"{prefix}_{name}.depth.gz")),
                          f"{label}: the {typ} run_filter checkpoint differs from the events run")
            shutil.rmtree(out)
            first = chunk_bytes == case["bam_chunk_bytes"][0]
            for typ, r in runs["on"].items():
                if first:
                    check(r["bam_chunks"] >= OVERLAP_MIN_BAM_CHUNKS,
                          f"{label}: {typ} BAM in {r['bam_chunks']} chunks, fewer than "
                          f"{OVERLAP_MIN_BAM_CHUNKS}")
                    check(case["acc"] == "delta" or r["chunks_finalized_in_pack"] > 0,
                          f"{label}: the sweep finalized no chunk during the {typ} pack")
                    # a BAM in one chunk leaves every sweep chunk live until
                    # finish: its peak is then the whole genome's delta
                    check(case["acc"] == "delta" or r["peak"] < RESIDENT_MH63_PEAK,
                          f"{label}: {typ} peak {r['peak']} bytes not below the resident path's")
                check(case["acc"] == "sweep" or r["peak"] <= RESIDENT_MH63_PEAK,
                      f"{label}: {typ} peak {r['peak']} bytes above the resident path's")
            log(f"[overlap] {label}: both checkpoints, on and off, identical to the events "
                f"run; launches on {counts}")
            for state in ("on", "off"):
                log(f"[overlap] {label}: {state} " + json.dumps(runs[state]))
            if not first:
                continue
            if case["acc"] == "sweep":
                check_streamed_launches(counts, n_chunks, label)
                absent = ("fused_depth_scan_packed", "fused_depth_scan_flags")
                check(not any(counts[k] for k in absent),
                      f"{label}: a resident scan was launched")
            else:
                check(counts["depth_scan_int8"] > 0,
                      f"{label}: the boundary readback launched no int8 scan")
            for k, n in case.get("exact", {}).items():
                check(counts[k] == n, f"{label}: {k} launched {counts[k]} times, expected {n}")
            launches[key] = counts
    return launches


# ---------------------------------------------------------------------------
# 9. the sharded backend
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_sharded(label: str, gp: int, out_dir: str, events_dir: str, call) -> dict[str, int]:
    """``call()`` (a dual-type sharded run into ``out_dir``) with the launch
    counts set to 0 just before it and read just after; the counts must be
    ``SHARDED_SCANS_PER_SHARD`` times ``gp`` and nothing else, the nine
    outputs the events run's."""
    get_metrics().reset()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {name: SHARDED_SCANS_PER_SHARD.get(name, 0) * gp for name in launches}
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    check_same_outputs(out_dir, events_dir, PREFIX, f"--device sharded ({label})")
    log(f"{label}: run {wall:.3f} s; launches {launches} (as predicted: "
        f"{SHARDED_SCANS_PER_SHARD} per gp shard x {gp}); all "
        f"{len(outputs(PREFIX))} outputs identical to the events run")
    log(f"{label}: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB; {before} bytes "
        f"allocated before the run); host RSS {rss.start} bytes at its start, peak "
        f"{rss.peak} bytes, {rss.peak - rss.start} bytes above the start")
    log(f"{label}: stages " + json.dumps([r.as_dict() for r in get_metrics().records]))
    return launches


def phase_sharded(paths, work: str, dev: torch.device) -> dict[str, dict[str, int]]:
    """9: the sharded backend through the CLI on an NCCL group of one process
    (with a profiler trace), then through run_gci on meshes of 4 positions
    on ``dev``.  Returns the launches of each run."""
    import torch.distributed as dist

    events_dir = os.path.join(work, "events")
    # what 9a's wall holds besides the run: an NCCL group of one process
    # started and destroyed alone
    t0 = time.perf_counter()
    init_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    t1 = time.perf_counter()
    shutdown_multihost()
    log(f"[sharded] an NCCL group of one process alone: start {t1 - t0:.3f} s, "
        f"destroy {time.perf_counter() - t1:.3f} s")
    launches = {}
    out = os.path.join(work, "sharded_1x1")
    trace = os.path.join(work, "sharded_trace")
    argv = [
        "-r", paths["ref"], "--hifi", paths["hifi"], "--nano", paths["ont"],
        "-R", paths["regions"], "-d", out, "-o", PREFIX, "-t", "8", "-f", "--profile",
        "--device", "sharded", "--mesh", "1,1", "--coordinator", f"127.0.0.1:{free_port()}",
        "--num-processes", "1", "--process-id", "0", "--profile-trace", trace,
    ]
    launches["sharded_1x1"] = run_sharded(
        "[sharded] 9a --mesh 1,1, NCCL group of 1 process, traced", 1, out, events_dir,
        lambda: cli.main(argv))
    check(not dist.is_initialized(), "the CLI left its process group behind")
    trace_file = trace_path(trace, 0)
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    on_card = sum(1 for e in events if e.get("cat") == "kernel")
    check(len(events) > 0, "the profiler trace holds no event")
    log(f"[sharded] 9a: --profile-trace wrote {os.path.getsize(trace_file)} bytes, "
        f"{len(events)} events, {on_card} of them CUDA kernels")
    for dp, gp in SHARDED_MESHES:
        out = os.path.join(work, f"sharded_{dp}x{gp}")
        mesh = make_mesh(dp * gp, dp=dp, devices=[dev] * (dp * gp))
        launches[f"sharded_{dp}x{gp}"] = run_sharded(
            f"[sharded] 9b mesh ({dp},{gp}) on {dev}", gp, out, events_dir,
            lambda: run_gci(
                hifi=[paths["hifi"]], nano=[paths["ont"]], reference=paths["ref"],
                regions=paths["regions"], directory=out, prefix=PREFIX, threads=8,
                force=True, depth_backend="sharded", mesh=mesh, torch_device=dev))
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = phase_environment()
    phase_build()
    rows = phase_kernels(dev)
    launches = {"entries": phase_entries(dev)}
    with tempfile.TemporaryDirectory(prefix="gci_tpu_torch_smoke_") as work:
        lengths = chrom_lengths()
        paths = make_inputs(os.path.join(work, "inputs"), lengths, gap_runs(lengths),
                            N_HIFI, N_ONT, list(lengths)[10], SEED)
        main_launches, packed_peak = phase_main_path(paths, work)
        launches.update(main_launches)
        launches["streamed_mh63"] = phase_streamed_mh63(paths, work)
        launches["streamed_3g"], t2t_paths, t2t_dir = phase_streamed_t2t(work, packed_peak)
        phase_tools(paths, t2t_paths, t2t_dir, work)
        launches.update(phase_overlap({
            "mh63": (paths, PREFIX, os.path.join(work, "events"), lengths, work),
            "t2t": (t2t_paths, T2T_PREFIX, os.path.join(work, "t2t_events"), t2t_lengths(),
                    work),
        }, dev))
        launches.update(phase_sharded(paths, work, dev))
    check("jax" not in sys.modules and "gci_tpu" not in sys.modules,
          "jax or the JAX package was imported")

    kernels_line = {"kernels": [
        dict(name=name, route="cuda", source=SOURCE, replaces=row[0],
             launches=launches[row[1]][name],
             launches_by_path={path: counts[name] for path, counts in launches.items()},
             **rows[name])
        for name, row in KERNEL_ROWS.items()
    ]}
    log(json.dumps(kernels_line))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
