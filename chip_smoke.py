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
   one; the stream compaction in both its forms (flag form: K1's flag byte
   under one and three masks, the change bits as a bool bitmap, dense
   random bytes; run form: K1's depth without, with an equal and with a
   different carry, an offset slice, dense random depths, the depth of
   58x reads), exact against the plain versions, at, past and without a
   capacity, and on 20 back-to-back launches, each row timed in turns with
   torch.nonzero (share of bound, ratio); and a small DeviceDepth, on the
   packed and on the flags path, against the numpy depth oracle;
4. the public entries of the two kernels no CLI path runs:
   ``depth.device.depth_and_edges_fused`` (fused_depth_scan) and
   ``depth.scan.fused_depth_scan_masked``, at MH63 size, each checked
   against its plain version;
5. the main path without the pack<->scatter overlap (``GCI_NO_OVERLAP``
   set for phases 5 and 6; phase 11 takes it):
   ``gci_tpu_torch.cli.main`` on an MH63-shaped reference
   with a HiFi and an ONT BAM and a regions BED, with ``--device device``
   (the packed path), again with ``--device device`` and
   ``gci_tpu_torch.depth.fused.PACKED_DEPTH_LIMIT`` set to 1 in this process
   (the flags path every read count at or above 2^29 takes), and with
   ``--device events``; both device runs' nine outputs must be identical to
   the events run's, and each one's peak device memory at most
   ``accum.RESIDENT_BYTES_PER_SLOT`` per genome slot;
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
8. the pack<->scatter overlap (``depth/overlap.py``) outside the CLI:
   each read type's BAM packed by ``overlap.feed_bam`` into an
   accumulator on the card ("on"), against ``pipeline.run_filter`` with
   ``GCI_NO_OVERLAP`` on the same BAM chunks ("off", the depth of the
   curated reads), each for the
   HiFi and the ONT BAM: (a) the MH63-shaped inputs into the resident
   delta, then ``DeviceDepth.from_delta``'s packed branch (K1 once per
   type, K3 not), (b) the same with ``PACKED_DEPTH_LIMIT`` 1 (its flags
   branch: K3 once per type, K1 not), (c) the same inputs into the
   coordinate sweep over phase 6a's 4 chunks and (d) phase 6b's 3.1 Gbp
   inputs into the sweep over its 12 chunks (K2 and the run form of the
   compaction once per chunk and type in both).  The BAMs are read in chunks of 128 KiB (at
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
   run, K2 and the two forms of the compaction must launch exactly
   ``SHARDED_SCANS_PER_SHARD`` times per gp shard and no other kernel at
   all; each prints its wall,
   stages, peak device memory and host RSS;
10. the remaining helpers on the card: (a) the read-out of a resident
   delta (``streamed.events_from_delta2d_streamed``): each read type's BAM
   packed by ``overlap.feed_bam`` into a ``DeltaAccumulator`` at
   run_filter's default 64 MiB BAM chunk, then read out in chunks, the
   MH63-shaped inputs in phase 6a's 4 chunks and phase 6b's 3.1 Gbp inputs
   in 12 chunks of 2^28 slots; each checkpoint (``write_depth_gz``) must
   equal the events run's of phase 5 or 6b, each type launch exactly one
   K2 and one run-form compaction per chunk with no relaunch, and the
   read-out's peak device memory stay within the delta plus
   ``READOUT_BYTES_PER_CHUNK_SLOT`` per chunk slot (under 16 GB at
   3.1 Gbp); each prints the pack and read-out walls, both peaks and the
   host RSS; (b) at MH63 size, ``depth.device.depth_single`` over each
   type's curated reads against the numpy depth oracle,
   ``interval_edges`` + ``edges_to_intervals`` at (-1, 0) over the HiFi
   depth against ``collapse_depth_dict`` of it, ``two_type_max`` of the
   two depths against ``torch.maximum`` on the host, and
   ``filters.device.bam_filter_mask_device`` over every record of both
   BAMs on the card against the same on the CPU (and, for information,
   how many records it decides otherwise than the float64 host mask);
11. the CLI through the overlap: the default gate must keep it off on the
   card; then the dual-type ``cli.main`` with ``--device device`` and
   ``GCI_FORCE_OVERLAP``, where each read type's one BAM folds into an
   accumulator on the card during pack: (a) the MH63-shaped
   inputs (the resident delta, then ``DeviceDepth.from_delta``'s packed
   branch), (b) the same with ``PACKED_DEPTH_LIMIT`` 1 (its flags branch),
   (c) phase 6b's 3.1 Gbp inputs (the coordinate sweep over 12 chunks of
   2^28 slots), each at run_filter's default 64 MiB BAM chunk and at 128
   KiB, in ``CLI_OVERLAP_TURNS`` turns alternating with the same run under
   ``GCI_NO_OVERLAP``.  Every run's nine outputs must be identical to the
   events run's, its launches those of the path without the overlap, the
   MH63 peaks at most ``accum.RESIDENT_BYTES_PER_SLOT`` per slot, the T2T
   peaks without the overlap and with it at 128 KiB below
   ``RESIDENT_MH63_PEAK``; each case prints the walls with and without the
   overlap (median and spread), the peaks, and per read type the BAM
   chunks, the fold's seconds and share of the pack stage, and the rows
   retracted, and the seconds in ``add_chunk``.

Launch counts are set to 0 just before each path of phases 4 to 11 runs and
read just after, and each path of phases 4 to 6 and 8 to 11 must have
launched exactly the kernels counted from its code (``PATH_LAUNCHES``,
``check_streamed_launches``, ``OVERLAP_CASES``, ``SHARDED_SCANS_PER_SHARD``,
``READOUT_CASES``, ``HELPER_LAUNCHES``, ``CLI_OVERLAP_CASES``): K2's int8 form none on any path,
and no compaction relaunched past its caller's capacity (the helpers'
edges, which have no bound, count first: one relaunch).  The script prints one JSON line with each
kernel's launches on its path and on every path, error, times and bound,
then as its last line ``{"ok": true, "device": {...}}``.  Any failed check
raises and exits nonzero; so does a machine without CUDA.  Inputs are
generated from a seed in a temporary directory that is removed at the end.
"""
from __future__ import annotations

import gc
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

from gci_tpu_torch import cli, kernels, pipeline
from gci_tpu_torch.depth import accum, fused, streamed
from gci_tpu_torch.depth.accum import GenomeLayout, accumulate_depth_numpy, depth_dict_from_flat
from gci_tpu_torch.depth.device import (
    build_scan_valid,
    depth_and_edges_fused,
    depth_single,
    edges_to_intervals,
    interval_edges,
    pack_read_deltas,
    scatter_events,
    two_type_max,
)
from gci_tpu_torch.depth.fused import DeviceDepth, flags_for, packed_event_word
from gci_tpu_torch.depth.scan import (
    compact_flags,
    compact_flags_torch,
    compact_runs,
    compact_runs_torch,
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
from gci_tpu_torch.filters import bam_filter_mask, dedup_last_wins
from gci_tpu_torch.filters.device import bam_filter_mask_device
from gci_tpu_torch.intervals.collapse import collapse_depth_dict, collapse_depth_runs
from gci_tpu_torch.io.bam import BamStream, read_bam
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
COMPACTION_TIMED_RUNS = 21  # the compaction rows: calls of 0.1-1 ms, host-bound at small sizes
REPEATED_LAUNCHES = 20  # of each depth_scan and compaction form on one input
DENSE_SLOTS = 10_000_019  # the compaction's dense cases: no tile multiple
# the compaction's real-depth case: reads at 58x over the MH63-sized genome
# (synthetic_reads' spans average 20.5 kb), about one run boundary per 177
# slots, as at a 58x human genome
REAL_DEPTH_READS = 1_120_000
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
# bytes, the resident path's peak at MH63 size when its compaction was the
# int8 scan and searchsorted: the overlap's and the streamed path's ceiling
RESIDENT_MH63_PEAK = 9_897_666_048
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
        exact={"fused_depth_scan_packed": 2, "compact_flags": 2}),
    "overlap_flags": dict(
        label="8b MH63 resident delta, PACKED_DEPTH_LIMIT 1", inputs="mh63", acc="delta",
        backend="device", limit=1, bam_chunk_bytes=(OVERLAP_BAM_CHUNK_BYTES,),
        exact={"fused_depth_scan_flags": 2, "depth_scan": 4, "compact_flags": 2}),
    "overlap_sweep_mh63": dict(
        label="8c MH63 sweep", inputs="mh63", acc="sweep", backend="streamed",
        chunk=MH63_STREAM_CHUNK, bam_chunk_bytes=(OVERLAP_BAM_CHUNK_BYTES,)),
    "overlap_sweep_3g": dict(
        label="8d T2T sweep", inputs="t2t", acc="sweep", backend="device",
        bam_chunk_bytes=(OVERLAP_BAM_CHUNK_BYTES, DEFAULT_BAM_CHUNK_BYTES)),
}
# phase 11: the dual-type CLI with --device device through the overlap, at
# the default BAM chunk and at 128 KiB: launches_by_path key -> its label,
# inputs, PACKED_DEPTH_LIMIT and the path whose launches it must have.  The
# overlap launches what the path without it launches: per read type
# from_delta's K1 (or K3 and K2 twice) and flag compaction in place of
# from_reads', the sweep's K2 and run form per genome chunk in place of the
# streamed path's
CLI_OVERLAP_CASES = {
    "cli_overlap_packed": dict(label="11a MH63 packed", inputs="mh63", path="packed"),
    "cli_overlap_flags": dict(label="11b MH63 flags, PACKED_DEPTH_LIMIT 1", inputs="mh63",
                              path="flags", limit=1),
    "cli_overlap_3g": dict(label="11c T2T --device device (the sweep)", inputs="t2t",
                           path="streamed_3g", chunks=12),
}
CLI_OVERLAP_TURNS = 3  # runs with the overlap, alternating with as many without
# the stages of a run_filter call from the BAM to the depth on the host
PACK_TO_DEPTH_STAGES = ("bam_pack", "curation", "depth_accumulate", "checkpoint_readback")
# phase 9: launches of a dual-type sharded run with regions and N gaps, per
# gp shard, counted from the code: K2 for the two read sets, their two gap
# masks, the two-type mask and the three scan windows (one per issue BED);
# the run form of the compaction for the three checkpoints' run boundaries
# and the three host views of the regions report; its flag form for the
# edge byte of each issue BED
SHARDED_SCANS_PER_SHARD = {"depth_scan": 8, "compact_runs": 6, "compact_flags": 3}
SHARDED_MESHES = ((2, 2), (1, 4), (4, 1))  # positions on cuda:0, phase 9b
# phase 10a: launches_by_path key -> (inputs, chunk slots, chunks) of the
# read-out of a resident delta; per read type and chunk one K2 (the chunk's
# depth) and one run-form compaction (its run boundaries)
READOUT_CASES = {
    "delta_readout_mh63": ("mh63", MH63_STREAM_CHUNK, 4),
    "delta_readout_3g": ("t2t", 1 << 28, 12),
}
# the read-out's device memory beside the delta, per slot of a chunk: the
# chunk's depth (4 B), an aligned copy of an unaligned chunk for the scan
# (4 B), and under 1 B of scan scratch and compaction buffers
READOUT_BYTES_PER_CHUNK_SLOT = 9
READOUT_3G_PEAK_LIMIT = 16_000_000_000  # bytes: the 3.1 Gbp delta plus O(chunk)
# phase 10b: K2 for each type's depth_single; the flag form twice for the
# edges, which have no bound and count first (one relaunch)
HELPER_LAUNCHES = {"depth_scan": 2, "compact_flags": 2}


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
    # call that computes the same function or None).  Where the work depends
    # on the data, bytes and operations are functions of the timed inputs
    # and the plain version's outputs on them, and give totals.
    "fused_depth_scan_packed": ("gci_tpu/depth/pallas_scan.py:605", "packed", 9, 18, None),
    "depth_scan": ("gci_tpu/depth/pallas_scan.py:208", "streamed_3g", 8, 1,
                   lambda x: torch.cumsum(x, 0, dtype=torch.int32)),
    "depth_scan_int8": ("gci_tpu/depth/pallas_scan.py:208", "streamed_3g", 5, 1,
                        lambda x: torch.cumsum(x, 0, dtype=torch.int32)),
    "fused_depth_scan_flags": ("gci_tpu/depth/pallas_scan.py:467", "flags", 10, 16, None),
    "fused_depth_scan": ("gci_tpu/depth/pallas_scan.py:252", "entries", 11, 10, None),
    "fused_depth_scan_masked": ("gci_tpu/depth/pallas_scan.py:336", "entries", 13, 16, None),
    # the compaction gci_tpu builds on depth_scan + searchsorted: 1 B/slot
    # in, 8 B per index out; one test per slot and mask
    "compact_flags": ("gci_tpu/depth/fused.py:158", "packed",
                      lambda args, outs: args[0].shape[0] + 8 * sum(o.shape[0] for o in outs),
                      lambda args, outs: args[0].shape[0] * len(args[1]),
                      lambda x: torch.nonzero(x)),
    # 4 B/slot in, 8 B per index and 4 per depth out; one compare per slot
    "compact_runs": ("gci_tpu/depth/fused.py:106", "packed",
                     lambda args, outs: 4 * args[0].shape[0] + 12 * outs[0].shape[0],
                     lambda args, outs: args[0].shape[0],
                     lambda x: torch.unique_consecutive(x, return_counts=True)),
}
# the card's peaks at 700 W (NVIDIA's H100 SXM data sheet): memory bytes/s,
# and float32 operations/s outside the tensor cores, the rate each integer
# operation is counted at
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# the launches of each resident CLI path (dual type, regions, N gaps),
# counted from the code: per read type K1 or K3 and one three-mask flag
# compaction of its flag byte (flags path: K2 twice more for its flag
# bytes); the scan windows of the two-type issue BED (K2 twice) and its
# edge byte (one flag compaction); the run form for the two-type checkpoint
# and the three host views of the regions report.  Every other count is 0.
PATH_LAUNCHES = {
    "packed": {"fused_depth_scan_packed": 2, "depth_scan": 2, "compact_flags": 3,
               "compact_runs": 4},
    "flags": {"fused_depth_scan_flags": 2, "depth_scan": 6, "compact_flags": 3,
              "compact_runs": 4},
}
WIDE = (-(2**30), 2**30)  # an issue range holding about half of random depths


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def median_ms(fn, runs: int = TIMED_RUNS) -> float:
    """The median CUDA-event time of ``runs`` calls of fn after one warm-up,
    Python's garbage collector paused (a pass over a large heap is
    milliseconds of host time inside a call)."""
    fn()
    torch.cuda.synchronize()
    gc.disable()
    try:
        return _median_ms(fn, runs)
    finally:
        gc.enable()


def median_ms_in_turns(fn_a, fn_b, runs: int) -> tuple[float, float]:
    """The median CUDA-event times of fn_a and fn_b, timed in turns (a b, b
    a, ...) after one warm-up each, the garbage collector paused, so drifts
    of the host or the card fall on both alike."""
    fn_a()
    fn_b()
    torch.cuda.synchronize()
    times = ([], [])
    gc.disable()
    try:
        for k in range(runs):
            for j in ((0, 1) if k % 2 == 0 else (1, 0)):
                times[j].append(_median_ms((fn_a, fn_b)[j], 1))
    finally:
        gc.enable()
    return tuple(sorted(t)[len(t) // 2] for t in times)


def _median_ms(fn, runs: int) -> float:
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
    if got.numel() == 0:
        return 0
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
    if callable(bytes_per_slot):
        outs = plain(*timed)
        n_bytes, n_ops = bytes_per_slot(timed, outs), ops_per_slot(timed, outs)
        del outs
    else:
        n_bytes, n_ops = n * bytes_per_slot, n * ops_per_slot
    bound_ms, bound_by = max(
        (n_bytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
        (n_ops / PEAK_OPS_PER_S * 1e3, "operations"),
    )
    log(f"[kernels] {name} exact on {len(cases)} inputs, {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms, library {library_ms} ms; bound {bound_ms:.4f} ms "
        f"({bound_by}, {n_bytes / n:.4f} B/slot at {n} slots), "
        f"{100 * bound_ms / ms:.1f}% of it")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def _equal(got, want) -> bool:
    if isinstance(got, torch.Tensor):
        return torch.equal(got, want)
    return all(torch.equal(g, w) for g, w in zip(got, want, strict=True))


def hold_repeats(name: str, x: torch.Tensor, kernel=depth_scan, plain=depth_scan_torch,
                 *args) -> None:
    """REPEATED_LAUNCHES launches of the kernel on x, back to back, then
    every result against the plain one."""
    want = plain(x, *args)
    before = kernels.LAUNCHES[name]
    got = [kernel(x, *args) for _ in range(REPEATED_LAUNCHES)]
    torch.cuda.synchronize()
    check(kernels.LAUNCHES[name] == before + REPEATED_LAUNCHES,
          f"{name} repeated launches not counted")
    bad = [k for k, g in enumerate(got) if not _equal(g, want)]
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

    k1_depth, k1_flags = fused_depth_scan_packed(word, -1, 0)
    del word
    rows.update(phase_compaction(dev, k1_depth, k1_flags))

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


def compaction_inputs(dev: torch.device, depth=None, flags=None) -> dict:
    """The compaction's timed inputs, key -> (input, args after it, capacity):
    K1's change bits under one mask, its flag byte under masks (1, 2, 4) and
    its depth at MH63 size (built here unless given; capacity the code's
    bound, the scatter rows plus one), the depth of REAL_DEPTH_READS reads
    (the same bound), and DENSE_SLOTS random bytes and depths (their exact
    counts)."""
    lengths = chrom_lengths()
    layout = GenomeLayout.from_targets(lengths)
    gaps = gap_runs(lengths)
    if depth is None:
        tid, start, end = synthetic_reads(np.random.default_rng(SEED + 1), layout)
        depth, flags = fused_depth_scan_packed(
            packed_event_word(layout, tid, start, end, 15, gaps, dev), -1, 0)
    cap = fused._event_rows(layout, N_HIFI, gaps, 15) + 1
    tid, start, end = synthetic_reads(np.random.default_rng(SEED + 9), layout,
                                      REAL_DEPTH_READS)
    real = depth_scan(read_delta(layout, tid, start, end, dev))
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    # about half of random bytes have bit 7 set, and 2/3 of random depths
    # in 0..2 differ from the one before
    dense = torch.randint(-128, 128, (DENSE_SLOTS,), dtype=torch.int32, device=dev,
                          generator=g).to(torch.int8)
    runs = torch.randint(0, 3, (DENSE_SLOTS,), dtype=torch.int32, device=dev, generator=g)
    inputs = {
        "one_mask": (((flags & 4) != 0).view(torch.int8), ((1,),), cap),
        "three_masks": (flags, ((1, 2, 4),), cap),
        "runs": (depth, (None,), cap),
        "real_depth_runs": (real, (None,), 2 * REAL_DEPTH_READS + 1),
        "dense_flags": (dense, ((0x80,),), None),
        "dense_runs": (runs, (None,), None),
    }
    for key in ("dense_flags", "dense_runs"):
        x, args, _ = inputs[key]
        inputs[key] = (x, args, max(o.shape[0] for o in _plain(x)(x, *args)[:1]))
    return inputs


def _kernel(x: torch.Tensor):
    return compact_flags if x.dtype == torch.int8 else compact_runs


def _plain(x: torch.Tensor):
    """The plain version of x's form, taking (and ignoring) a capacity."""
    if x.dtype == torch.int8:
        return lambda x, masks, capacity=None: compact_flags_torch(x, masks)
    return lambda x, carry, capacity=None: compact_runs_torch(x, carry)


def nonzero_calls(inputs: dict) -> dict:
    """key -> the torch.nonzero yardstick of each input, as the compaction's
    earlier rows were timed: torch.nonzero of ready bool
    bitmaps (one per mask, or a depth's run boundaries), except on dense
    depths, where the bitmap ``depth[1:] != depth[:-1]`` is built in the
    timed call."""
    out = {}
    for key, (x, args, _) in inputs.items():
        if key == "dense_runs":
            out[key] = lambda x=x: torch.nonzero(x[1:] != x[:-1])
            continue
        if x.dtype == torch.int8:
            bitmaps = [(x.view(torch.uint8) & m) != 0 for m in args[0]]
        else:
            change = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
            torch.ne(x[1:], x[:-1], out=change[1:])
            bitmaps = [change]
        out[key] = lambda bitmaps=bitmaps: [torch.nonzero(b) for b in bitmaps]
    return out


def compaction_row(key: str, x, args, cap, nonzero) -> dict:
    """The kernel's median ms on one input and torch.nonzero's on the same
    function, timed in turns, its bound (each input byte read once, 8 B per index and 4 per
    run depth written once) and share of it, and the ratio to
    torch.nonzero."""
    name = "compact_flags" if x.dtype == torch.int8 else "compact_runs"
    kernel = _kernel(x)
    ms, nz_ms = median_ms_in_turns(lambda: kernel(x, *args, cap), nonzero,
                                   COMPACTION_TIMED_RUNS)
    outs = _plain(x)(x, *args)
    _, _, n_bytes, n_ops, _ = KERNEL_ROWS[name]
    bound_ms = max(n_bytes((x, *args), outs) / PEAK_BYTES_PER_S,
                   n_ops((x, *args), outs) / PEAK_OPS_PER_S) * 1e3
    counts = [o.shape[0] for o in (outs if name == "compact_flags" else outs[:1])]
    row = dict(ms=ms, nonzero_ms=nz_ms, ratio_to_nonzero=ms / nz_ms, bound_ms=bound_ms,
               share_of_bound=bound_ms / ms, slots=x.shape[0], counts=counts)
    log(f"[kernels] {name} {key} ({x.shape[0]} slots, {counts} set): {ms:.4f} ms, "
        f"{100 * bound_ms / ms:.1f}% of its bound {bound_ms:.4f} ms; torch.nonzero "
        f"{nz_ms:.4f} ms, ratio {ms / nz_ms:.3f}")
    return row


def phase_compaction(dev: torch.device, depth: torch.Tensor, flags: torch.Tensor):
    """Both forms of the stream compaction against their plain versions on
    K1's outputs at MH63 size, at real read depth and on dense random
    inputs, at, past and without a capacity, on repeated launches, and
    timed beside torch.nonzero."""
    inputs = compaction_inputs(dev, depth, flags)
    nonzero = nonzero_calls(inputs)
    rows = {}
    bits, _, cap = inputs["one_mask"]
    dense, ones = inputs["dense_flags"][0], torch.ones(DENSE_SLOTS, dtype=torch.int8, device=dev)
    plain_flags = _plain(bits)
    # capacities: K1's bound, and each other case's largest count exactly
    cases = [(flags, (1, 2, 4), cap), (bits, (1,), cap), (flags, (8, 3), None),
             (dense, (0x80, 0x7F, 0xFF), None), (dense[4096:], (0x40,), None),
             (dense[:1], (1, 2), None), (ones, (1,), None), (ones, (2,), None),
             (flags[: 3 * 16384 + 5], (1, 2, 4), None)]
    cases = [(x, m, c if c is not None else max(o.shape[0] for o in plain_flags(x, m)))
             for x, m, c in cases]
    rows["compact_flags"] = hold("compact_flags", compact_flags, plain_flags, cases,
                                 (bits, (1,), cap))
    hold_repeats("compact_flags", flags, compact_flags, plain_flags, (1, 2, 4), cap)
    runs = inputs["dense_runs"][0]
    plain_runs = _plain(runs)
    d0 = int(depth[0])
    cases = [(depth, None, cap), (depth, d0, cap), (depth, d0 + 1, cap),
             (depth[4096:], int(depth[4095]), cap), (runs, None, None), (runs, 1, None),
             (runs[:1], 5, None), (torch.full_like(runs, 7), 7, None),
             (inputs["real_depth_runs"][0], None, inputs["real_depth_runs"][2])]
    cases = [(x, c, k if k is not None else plain_runs(x, c)[0].shape[0]) for x, c, k in cases]
    rows["compact_runs"] = hold("compact_runs", compact_runs, plain_runs, cases,
                                (depth, None, cap))
    hold_repeats("compact_runs", depth, compact_runs, plain_runs, None, cap)
    hold_capacities(inputs)
    check(torch.equal(compact_runs(depth, None, cap)[0], compact_flags(flags, (4,), cap)[0]),
          "the run form of K1's depth != the flag form of its change bits")
    relaunched = dict(kernels.RELAUNCHES)
    for key, (x, args, c) in inputs.items():
        row = compaction_row(key, x, args, c, nonzero[key])
        name = "compact_flags" if x.dtype == torch.int8 else "compact_runs"
        if key in ("one_mask", "runs"):
            rows[name].update(row)
        else:
            rows[name][key] = row
    check(kernels.RELAUNCHES == relaunched,
          f"the compaction relaunched within its capacities: {kernels.RELAUNCHES}")
    # torch.nonzero from the depth itself: the bitmap's build counts too
    rows["compact_runs"]["nonzero_of_depth_ms"] = median_ms(
        lambda: torch.nonzero(depth[1:] != depth[:-1]))
    del inputs, nonzero, bits, dense, ones, runs
    torch.cuda.empty_cache()
    return rows


def hold_capacities(inputs: dict) -> None:
    """Each timed input with its count exactly at capacity (one launch), one
    past it (the kernel's writes stop there, then one exact relaunch) and
    without one (a counting launch, then the exact one); every result equal
    to the plain version's."""
    for key, (x, args, _) in inputs.items():
        name = "compact_flags" if x.dtype == torch.int8 else "compact_runs"
        want = _plain(x)(x, *args)
        top = max(w.shape[0] for w in (want if name == "compact_flags" else want[:1]))
        check(top > 0, f"{name} {key}: no slot set")
        for cap, launches, relaunches in ((top, 1, 0), (top - 1, 2, 1), (None, 2, 1)):
            before, again = kernels.LAUNCHES[name], kernels.RELAUNCHES[name]
            got = _kernel(x)(x, *args, cap)
            torch.cuda.synchronize()
            check(_equal(got, want), f"{name} {key} at capacity {cap} != plain")
            check(kernels.LAUNCHES[name] - before == launches
                  and kernels.RELAUNCHES[name] - again == relaunches,
                  f"{name} {key} at capacity {cap}: {kernels.LAUNCHES[name] - before} "
                  f"launches, {kernels.RELAUNCHES[name] - again} relaunches")
        log(f"[kernels] {name} {key}: exact at capacity {top}, at {top - 1} (relaunched) "
            "and without one (counted, then launched)")


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


def check_no_relaunch(label: str) -> None:
    """Every compaction of the path fit the capacity its caller gave."""
    check(not any(kernels.RELAUNCHES.values()),
          f"{label}: the compaction relaunched past its caller's bound {kernels.RELAUNCHES}")


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
    before it and read just after; a resident path's counts must be its
    ``PATH_LAUNCHES`` (the streamed path's are checked by the caller).
    Returns (launches, peak device bytes)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    wall, stages = run_cli(paths, out_dir, backend, prefix)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_no_relaunch(label)
    if path in PATH_LAUNCHES:
        want = {name: PATH_LAUNCHES[path].get(name, 0) for name in launches}
        check(launches == want, f"{label}: launches {launches}, expected {want}")
    log(f"{label}: --device {backend} run {wall:.3f} s; launches {launches}, "
        f"relaunches {kernels.RELAUNCHES}")
    log(f"{label}: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB; "
        f"{before} bytes allocated before the run)")
    log(f"{label}: stages " + json.dumps(stages))
    return launches, peak


def phase_main_path(paths, work: str):
    """Returns the launches of each path and the packed path's peak."""
    dirs = {k: os.path.join(work, k) for k in ("packed", "flags", "events")}
    launches, peaks = {}, {}
    launches["packed"], peaks["packed"] = run_device_path(
        paths, dirs["packed"], "device", "packed", "[main] packed path")
    limit = fused.PACKED_DEPTH_LIMIT
    fused.PACKED_DEPTH_LIMIT = 1  # every read count takes the flags path
    try:
        launches["flags"], peaks["flags"] = run_device_path(
            paths, dirs["flags"], "device", "flags", "[main] flags path")
    finally:
        fused.PACKED_DEPTH_LIMIT = limit
    # the switch point assumes the resident peak per slot
    slots = GenomeLayout.from_targets(chrom_lengths()).total_slots
    for path, peak in peaks.items():
        log(f"[main] {path} path: peak {peak / slots:.4f} B/slot at {slots} slots "
            f"(accum.RESIDENT_BYTES_PER_SLOT {accum.RESIDENT_BYTES_PER_SLOT})")
        check(peak <= accum.RESIDENT_BYTES_PER_SLOT * slots,
              f"the {path} path's peak {peak} bytes exceeds RESIDENT_BYTES_PER_SLOT")
    wall_ev, stages_ev = run_cli(paths, dirs["events"], "events")
    for path in ("packed", "flags"):
        check_same_outputs(dirs[path], dirs["events"], PREFIX,
                           f"--device device ({path} path)")
    log(f"[main] events run {wall_ev:.3f} s; all {len(outputs(PREFIX))} outputs of "
        "both device paths identical to it")
    log("[main] stages events " + json.dumps(stages_ev))
    return launches, peaks["packed"]


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
    one run-form compaction (its run boundaries); nothing else."""
    want = {name: 0 for name in launches}
    want.update(depth_scan=2 * n_chunks, compact_runs=2 * n_chunks)
    check(launches == want, f"{label}: launches {launches}, expected {want}")


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
    log(f"[streamed] T2T: peak {peak / streamed.CHUNK_SLOTS:.4f} B/slot of a "
        f"{streamed.CHUNK_SLOTS}-slot chunk")
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

class Environ:
    """While active: the given variables of this process's environment set
    (None unsets one), restored after."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self._old = {k: os.environ.get(k) for k in self.values}
        self._set(self.values)
        return self

    def __exit__(self, *exc):
        self._set(self._old)

    @staticmethod
    def _set(values) -> None:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)


class _Setting:
    """While active: ``GCI_BAM_CHUNK_BYTES`` in this process's environment
    and ``fused.PACKED_DEPTH_LIMIT`` (unless None) set, restored after."""

    def __init__(self, chunk_bytes: int, limit: int | None):
        self.env, self.limit = Environ(GCI_BAM_CHUNK_BYTES=chunk_bytes), limit

    def __enter__(self):
        self.env.__enter__()
        self._limit = fused.PACKED_DEPTH_LIMIT
        if self.limit is not None:
            fused.PACKED_DEPTH_LIMIT = self.limit
        return self

    def __exit__(self, *exc):
        fused.PACKED_DEPTH_LIMIT = self._limit
        self.env.__exit__(*exc)


def fold_seconds() -> float:
    """The registry's seconds in the span ``overlap.fold`` so far (recorded
    while ``StageMetrics.enabled`` is set: ``--profile``, ``SpansOn``)."""
    return get_metrics().span_totals().get("overlap.fold", {}).get("seconds", 0.0)


class SpansOn:
    """While active: the registry's spans record, as under ``--profile``."""

    def __enter__(self):
        m = get_metrics()
        self._was, m.enabled = m.enabled, True
        return self

    def __exit__(self, *exc):
        get_metrics().enabled = self._was


def overlap_on(case, layout, bam: str, gaps, chunk_bytes: int, dev, ckpt: str) -> dict:
    """One BAM through ``feed_bam`` into the case's accumulator, then its
    depth (``from_delta`` and the boundary readback, or the sweep's
    ``finish``), written to ``ckpt``; its seconds and counts."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fold0 = fold_seconds()
    with RssPeak() as rss, SpansOn():
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
                                            issue_range=(-1, 0), rows=acc.rows)
            depths.to_events()
        else:
            depths = acc.finish()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    write_depth_gz(ckpt, depths)
    del depths
    return dict(pack_s=t1 - t0, depth_s=t2 - t1, sum_s=t2 - t0,
                fold_s=fold_seconds() - fold0, bam_chunks=n_bam,
                rows_retracted=acc.rows_retracted, chunks_finalized_in_pack=finalized,
                peak=peak, rss_above_start=rss.peak - rss.start)


def overlap_off(case, bam: str, gaps, read_type: str, dev, out_dir: str, prefix: str) -> dict:
    """The same BAM through ``run_filter`` without the overlap (the depth
    of the curated reads); its pack-to-depth stages in seconds."""
    get_metrics().reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss, StreamedCalls(case.get("chunk")), Environ(GCI_NO_OVERLAP=1):
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
                check_no_relaunch(label)
                for typ, name in (("hifi", "hifi"), ("ont", "nano")):
                    runs["off"][typ] = overlap_off(case, paths[typ], gaps, typ, dev, out,
                                                   f"off_{name}")
                    check(_same_file(os.path.join(out, f"off_{name}.depth.gz"),
                                     os.path.join(events_dir, f"{prefix}_{name}.depth.gz")),
                          f"{label}: the {typ} run_filter checkpoint differs from the events run")
                check_no_relaunch(f"{label}, run_filter")
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
            else:
                want = {name: case["exact"].get(name, 0) for name in counts}
                check(counts == want, f"{label}: launches {counts}, expected {want}")
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
    check_no_relaunch(label)
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


# ---------------------------------------------------------------------------
# 10. the remaining helpers on the card
# ---------------------------------------------------------------------------

def delta_readout(label: str, layout, bam: str, chunk_slots: int, n_chunks: int,
                  dev, ckpt: str) -> tuple[dict[str, int], int]:
    """One BAM through ``feed_bam`` into a ``DeltaAccumulator`` at the
    default BAM chunk, then ``events_from_delta2d_streamed`` in chunks of
    ``chunk_slots``, written to ``ckpt``; launch counts set to 0 before the
    pack and read after the read-out.  Returns the launches and the
    read-out's peak device bytes above what was allocated before the pack."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    acc = DeltaAccumulator(layout, 15, device=dev)
    n_bam = feed_bam(acc, bam, threads=8, chunk_bytes=DEFAULT_BAM_CHUNK_BYTES)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pack_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss:
        t2 = time.perf_counter()
        events = streamed.events_from_delta2d_streamed(layout, acc.take_delta(), chunk_slots,
                                                       rows=acc.rows)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.LAUNCHES)
    check_no_relaunch(label)
    want = {name: 0 for name in launches}
    want.update(depth_scan=n_chunks, compact_runs=n_chunks)
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    delta_bytes = 4 * layout.total_slots
    beside = peak - before - delta_bytes
    check(beside <= READOUT_BYTES_PER_CHUNK_SLOT * chunk_slots,
          f"{label}: read-out peak {peak} bytes, {beside} beside the delta, past "
          f"{READOUT_BYTES_PER_CHUNK_SLOT} B per slot of a {chunk_slots}-slot chunk")
    t4 = time.perf_counter()
    write_depth_gz(ckpt, events)
    t5 = time.perf_counter()
    log(f"{label}: {n_bam} BAM chunks, {acc.rows} rows, {acc.rows_retracted} retracted; "
        f"pack {t1 - t0:.3f} s, read-out {t3 - t2:.3f} s in {n_chunks} chunks of "
        f"{chunk_slots} slots, checkpoint {t5 - t4:.3f} s; launches {launches}")
    log(f"{label}: read-out peak device memory {peak} bytes ({peak / 2**30:.3f} GiB; "
        f"{before} allocated before the pack, the delta {delta_bytes}, "
        f"{beside} beside it: {beside / chunk_slots:.4f} B per chunk slot); pack peak "
        f"{pack_peak} bytes; host RSS during the read-out {rss.start} bytes at its start, "
        f"peak {rss.peak}, {rss.peak - rss.start} above the start")
    return launches, peak - before


def phase_delta_readout(inputs, dev) -> dict[str, dict[str, int]]:
    """10a: each READOUT_CASES genome, both read types, every checkpoint
    equal to the events run's.  Returns the launches of each type's run."""
    launches = {}
    for key, (which, chunk_slots, n_chunks) in READOUT_CASES.items():
        paths, prefix, events_dir, lengths, work = inputs[which]
        layout = GenomeLayout.from_targets(lengths)
        check(-(-layout.total_slots // chunk_slots) == n_chunks,
              f"{key}: {layout.total_slots} slots are not {n_chunks} chunks")
        for typ, name in (("hifi", "hifi"), ("ont", "nano")):
            label = f"[readout] 10a {key} {typ}"
            ckpt = os.path.join(work, f"{key}_{name}.depth.gz")
            launches[f"{key}_{typ}"], peak = delta_readout(label, layout, paths[typ],
                                                           chunk_slots, n_chunks, dev, ckpt)
            if which == "t2t":
                check(peak < READOUT_3G_PEAK_LIMIT,
                      f"{label}: peak {peak} bytes not under {READOUT_3G_PEAK_LIMIT}")
            check(_same_file(ckpt, os.path.join(events_dir, f"{prefix}_{name}.depth.gz")),
                  f"{label}: the checkpoint differs from the events run's")
            os.remove(ckpt)
            log(f"{label}: checkpoint identical to the events run's")
    return launches


def curated_reads(bam: str, layout) -> tuple[dict, np.ndarray]:
    """Every record's columns as int64, and the rows run_filter keeps of a
    read type with one BAM and no PAF: those on a target that pass the
    float64 host mask, the last of each name."""
    data = read_bam(bam, threads=8, keep_names=False)
    cols = {k: np.asarray(v, np.int64) for k, v in data.columns.items()}
    ok = (cols["ref_id"] >= 0) & (cols["ref_id"] < len(layout.names))
    keep = dedup_last_wins(data.name_keys, ok & bam_filter_mask(cols))
    return cols, keep


FILTER_COLUMNS = ("flag", "mapq", "m", "i", "d", "s", "eq", "x", "nm")


def phase_helpers(paths, dev) -> dict[str, int]:
    """10b: depth_single, the interval edges, two_type_max and the device
    filter mask at MH63 size against their references.  Returns the
    launches of the device calls."""
    layout = GenomeLayout.from_targets(chrom_lengths())
    depths = {}
    kernels.reset_launch_counts()
    for typ in ("hifi", "ont"):
        cols, keep = curated_reads(paths[typ], layout)
        tid, start, end = cols["ref_id"][keep], cols["pos"][keep], cols["ref_end"][keep]
        gs, ge, live = pack_read_deltas(layout, tid, start, end, 15)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        depths[typ] = depth_single(gs, ge, live, layout.total_slots, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = accumulate_depth_numpy(layout, tid, start, end, 15)
        check(np.array_equal(depths[typ].cpu().numpy(), want),
              f"[helpers] depth_single over the {typ} reads differs from the numpy oracle")
        log(f"[helpers] 10b depth_single over {keep.shape[0]} curated {typ} reads: "
            f"{t1 - t0:.4f} s, equal to the numpy oracle")
        if typ == "hifi":
            valid = torch.from_numpy(build_scan_valid(layout, 15)).to(dev)
            t0 = time.perf_counter()
            m, rise, fall = interval_edges(depths[typ], valid, -1, 0)
            got = edges_to_intervals(layout, rise, fall, m, 15)
            t1 = time.perf_counter()
            del m, rise, fall, valid
            ref = collapse_depth_dict(depth_dict_from_flat(layout, want), -1, 0, 15, 0)
            check(got == ref, "[helpers] interval_edges + edges_to_intervals differ from "
                  "collapse_depth_dict")
            n_iv = sum(len(v) for v in got.values())
            check(n_iv > 0, "[helpers] no interval at (-1, 0)")
            log(f"[helpers] 10b interval_edges + edges_to_intervals at (-1, 0): "
                f"{t1 - t0:.4f} s, {n_iv} intervals, equal to collapse_depth_dict")
        del want
        host = bam_filter_mask(cols)
        on_card = bam_filter_mask_device(
            *(torch.from_numpy(cols[c]).to(dev) for c in FILTER_COLUMNS))
        on_cpu = bam_filter_mask_device(*(torch.from_numpy(cols[c]) for c in FILTER_COLUMNS))
        check(torch.equal(on_card.cpu(), on_cpu),
              f"[helpers] bam_filter_mask_device on the card differs from the CPU ({typ})")
        log(f"[helpers] 10b bam_filter_mask_device over {host.shape[0]} {typ} records: equal "
            f"on the card and the CPU, {int(on_cpu.sum())} pass; "
            f"{int((on_cpu.numpy() != host).sum())} decided otherwise than the float64 "
            "host mask")
    mx = two_type_max(depths["hifi"], depths["ont"])
    check(torch.equal(mx.cpu(), torch.maximum(depths["hifi"].cpu(), depths["ont"].cpu())),
          "[helpers] two_type_max differs from torch.maximum on the host")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {name: HELPER_LAUNCHES.get(name, 0) for name in launches}
    check(launches == want, f"[helpers] launches {launches}, expected {want}")
    check(kernels.RELAUNCHES == {"compact_flags": 1, "compact_runs": 0},
          f"[helpers] relaunches {kernels.RELAUNCHES}, expected the edges' one")
    log(f"[helpers] 10b two_type_max equal to torch.maximum on the host; launches "
        f"{launches}, relaunches {kernels.RELAUNCHES}")
    return launches


# ---------------------------------------------------------------------------
# 11. the CLI through the overlap
# ---------------------------------------------------------------------------

class OverlapCalls:
    """While active: each accumulator ``pipeline._make_overlap_accumulator``
    returns (None where the gate turns the overlap off) kept in ``made``
    (``run_filter`` looks the function up at each call), with the seconds
    spent in its ``add_chunk`` calls, the fold's included, in its
    ``add_seconds``, and of those in the fold (the span ``overlap.fold``,
    recorded under ``--profile``) in its ``fold_seconds``."""

    def __enter__(self):
        self.made = []
        self._real = pipeline._make_overlap_accumulator

        def spy(*args, **kwargs):
            acc = self._real(*args, **kwargs)
            if acc is not None:
                acc.add_seconds, acc.fold_seconds, add = 0.0, 0.0, acc.add_chunk

                def timed(*a):
                    f0, t0 = fold_seconds(), time.perf_counter()
                    add(*a)
                    acc.add_seconds += time.perf_counter() - t0
                    acc.fold_seconds += fold_seconds() - f0

                acc.add_chunk = timed
            self.made.append(acc)
            return acc

        pipeline._make_overlap_accumulator = spy
        return self

    def __exit__(self, *exc):
        pipeline._make_overlap_accumulator = self._real


def cli_overlap_run(case, paths, prefix: str, events_dir: str, out: str, on: bool,
                    label: str) -> dict:
    """One dual-type CLI run, ``--device device``, with ``GCI_FORCE_OVERLAP``
    (``on``) or with ``GCI_NO_OVERLAP`` set, launch counts set to 0 just
    before it and read just after; its launches must be the path's, its
    nine outputs the events run's and its peak within the case's bound.
    Returns its wall, launches, peak and, with the overlap, per read type
    the BAM chunks folded, the seconds in ``add_chunk`` and in the fold,
    the rows retracted and the pack stage's seconds."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with Environ(GCI_NO_OVERLAP=None if on else 1, GCI_FORCE_OVERLAP=1 if on else None), \
            OverlapCalls() as calls:
        wall, stages = run_cli(paths, out, "device", prefix)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_no_relaunch(label)
    if case["path"] in PATH_LAUNCHES:
        want = {name: PATH_LAUNCHES[case["path"]].get(name, 0) for name in launches}
        check(launches == want, f"{label}: launches {launches}, expected {want}")
    else:
        check_streamed_launches(launches, case["chunks"], label)
    check(len(calls.made) == 2, f"{label}: {len(calls.made)} read types through the gate")
    if on:
        check(all(a is not None for a in calls.made),
              f"{label}: GCI_FORCE_OVERLAP did not turn the overlap on")
    else:
        check(calls.made == [None, None], f"{label}: GCI_NO_OVERLAP did not turn it off")
    check_same_outputs(out, events_dir, prefix, label)
    if case["inputs"] == "mh63":
        slots = GenomeLayout.from_targets(chrom_lengths()).total_slots
        check(peak <= accum.RESIDENT_BYTES_PER_SLOT * slots,
              f"{label}: peak {peak} bytes exceeds RESIDENT_BYTES_PER_SLOT")
    pack = {r["stage"].split(":")[0]: r["seconds"] for r in stages
            if r["stage"].split(":")[1:2] == ["bam_pack"]}
    types = [dict(type=t, bam_chunks=a.chunks_added, add_chunk_s=a.add_seconds,
                  fold_s=a.fold_seconds, rows_retracted=a.rows_retracted, pack_s=pack[t],
                  fold_share_of_pack=a.fold_seconds / pack[t])
             for t, a in zip(("HiFi", "ONT"), calls.made) if a is not None]
    return dict(wall=wall, launches=launches, peak=peak, types=types, stages=stages)


def phase_cli_overlap(inputs) -> dict[str, dict[str, int]]:
    """11: the default gate keeps the overlap off on the card; then each
    CLI_OVERLAP_CASES case at each BAM chunk size, in CLI_OVERLAP_TURNS
    turns of ``GCI_FORCE_OVERLAP`` alternating with ``GCI_NO_OVERLAP`` (on
    off, off on, ...).  Returns the launches of each case's runs at 128
    KiB."""
    dev = torch.device("cuda", torch.cuda.current_device())
    layout = GenomeLayout.from_targets(chrom_lengths())
    with Environ(GCI_NO_OVERLAP=None, GCI_FORCE_OVERLAP=None):
        for backend in ("device", "streamed"):
            check(pipeline._make_overlap_accumulator(backend, [], ["x.bam"], False, layout,
                                                     15, dev) is None,
                  f"the default gate turned the overlap on for --device {backend}")
    log("[cli overlap] the default gate keeps the overlap off on the card "
        "(device and streamed backends)")
    launches = {}
    for key, case in CLI_OVERLAP_CASES.items():
        paths, prefix, events_dir, _, work = inputs[case["inputs"]]
        for chunk_bytes in (DEFAULT_BAM_CHUNK_BYTES, OVERLAP_BAM_CHUNK_BYTES):
            label = f"[cli overlap] {case['label']}, BAM chunks of {chunk_bytes} bytes"
            runs = {True: [], False: []}
            with _Setting(chunk_bytes, case.get("limit")):
                for turn in range(CLI_OVERLAP_TURNS):
                    for on in ((True, False) if turn % 2 == 0 else (False, True)):
                        out = os.path.join(work, f"{key}_{'on' if on else 'off'}")
                        runs[on].append(cli_overlap_run(case, paths, prefix, events_dir,
                                                        out, on, label))
            for on in (True, False):
                shutil.rmtree(os.path.join(work, f"{key}_{'on' if on else 'off'}"))
            for r in runs[True]:
                check(r["launches"] == runs[False][0]["launches"],
                      f"{label}: launches with the overlap differ from without it")
            peaks = {on: max(r["peak"] for r in runs[on]) for on in runs}
            if chunk_bytes == OVERLAP_BAM_CHUNK_BYTES:
                for r in runs[True]:
                    check(min(t["bam_chunks"] for t in r["types"]) >= OVERLAP_MIN_BAM_CHUNKS,
                          f"{label}: fewer than {OVERLAP_MIN_BAM_CHUNKS} BAM chunks a type")
                if case["inputs"] == "t2t":
                    check(peaks[True] < RESIDENT_MH63_PEAK,
                          f"{label}: sweep peak {peaks[True]} bytes not below the "
                          "resident path's")
                launches[key] = runs[True][0]["launches"]
            if case["inputs"] == "t2t":
                check(peaks[False] < RESIDENT_MH63_PEAK,
                      f"{label}: streamed peak {peaks[False]} bytes not below the "
                      "resident path's")
            walls = {on: sorted(r["wall"] for r in runs[on]) for on in runs}
            log(f"{label}: all {len(outputs(prefix))} outputs of every run identical to "
                f"the events run; launches {runs[True][0]['launches']} with and without "
                "the overlap")
            for on, name in ((True, "GCI_FORCE_OVERLAP"), (False, "GCI_NO_OVERLAP")):
                w = walls[on]
                log(f"{label}: {name} walls {json.dumps(w)} s, median {w[len(w) // 2]:.4f}, "
                    f"spread {w[-1] - w[0]:.4f}; peak {peaks[on]} bytes")
            for r in runs[True]:
                log(f"{label}: GCI_FORCE_OVERLAP per type " + json.dumps(r["types"]))
            log(f"{label}: stages GCI_FORCE_OVERLAP " + json.dumps(runs[True][-1]["stages"]))
            log(f"{label}: stages GCI_NO_OVERLAP " + json.dumps(runs[False][-1]["stages"]))
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
        with Environ(GCI_NO_OVERLAP=1):  # phases 5 and 6: the path without the overlap
            main_launches, packed_peak = phase_main_path(paths, work)
            launches.update(main_launches)
            launches["streamed_mh63"] = phase_streamed_mh63(paths, work)
            launches["streamed_3g"], t2t_paths, t2t_dir = phase_streamed_t2t(
                work, packed_peak)
        phase_tools(paths, t2t_paths, t2t_dir, work)
        inputs = {
            "mh63": (paths, PREFIX, os.path.join(work, "events"), lengths, work),
            "t2t": (t2t_paths, T2T_PREFIX, os.path.join(work, "t2t_events"), t2t_lengths(),
                    work),
        }
        launches.update(phase_overlap(inputs, dev))
        launches.update(phase_sharded(paths, work, dev))
        launches.update(phase_delta_readout(inputs, dev))
        launches["helpers"] = phase_helpers(paths, dev)
        launches.update(phase_cli_overlap(inputs))
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
