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
   the events run's.

Launch counts are set to 0 just before each path of phases 4 and 5 runs and
read just after, and each path must have launched its kernels (and the
packed and flags paths not each other's scan).  The script prints one JSON
line with each kernel's launches on its path, error and times, then as its
last line ``{"ok": true, "device": {...}}``.  Any failed check raises and
exits nonzero; so does a machine without CUDA.  Inputs are generated from a
seed in a temporary directory that is removed at the end.
"""
from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gci_tpu.depth.accum import GenomeLayout, accumulate_depth_numpy
from gci_tpu.intervals.collapse import collapse_depth_runs
from gci_tpu.io.bam_writer import build_record, write_bam
from gci_tpu_torch import cli, kernels
from gci_tpu_torch.depth import fused
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
from gci_tpu_torch.native import ensure_host_codec
from gci_tpu.utils import get_metrics

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
OUTPUTS = [
    f"{PREFIX}_hifi.depth.gz", f"{PREFIX}_nano.depth.gz", f"{PREFIX}_two_type.depth.gz",
    f"{PREFIX}_hifi.0.depth.bed", f"{PREFIX}_nano.0.depth.bed",
    f"{PREFIX}_two_type.0.depth.bed", f"{PREFIX}.gci", f"{PREFIX}.regions.gci",
    f"{PREFIX}.gaps.bed",
]
SOURCE = "gci_tpu_torch/csrc/scan.cu"
KERNEL_ROWS = {
    # wrapper name -> (the TPU kernel it replaces, the path whose launches count)
    "fused_depth_scan_packed": ("gci_tpu/depth/pallas_scan.py:605", "packed"),
    "depth_scan": ("gci_tpu/depth/pallas_scan.py:208", "packed"),
    "depth_scan_int8": ("gci_tpu/depth/pallas_scan.py:208", "packed"),
    "fused_depth_scan_flags": ("gci_tpu/depth/pallas_scan.py:467", "flags"),
    "fused_depth_scan": ("gci_tpu/depth/pallas_scan.py:252", "entries"),
    "fused_depth_scan_masked": ("gci_tpu/depth/pallas_scan.py:336", "entries"),
}
# the kernels each CLI path must launch, and the scan it must not
PATH_KERNELS = {
    "packed": (("fused_depth_scan_packed", "depth_scan", "depth_scan_int8"),
               "fused_depth_scan_flags"),
    "flags": (("fused_depth_scan_flags", "depth_scan", "depth_scan_int8"),
              "fused_depth_scan_packed"),
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
    exactly equal; then the median times of both on ``timed``."""
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
    log(f"[kernels] {name} exact on {len(cases)} inputs, {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


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
    log(f"[env] gci_tpu.native host codec built with: {ensure_host_codec()}")
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
            f.write(body.tobytes())
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


def make_inputs(root: str) -> dict[str, str]:
    paths = {k: os.path.join(root, f) for k, f in (
        ("ref", "ref.fa"), ("hifi", "hifi.bam"), ("ont", "ont.bam"),
        ("regions", "regions.bed"))}
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    lengths = chrom_lengths()
    write_fasta(paths["ref"], lengths, gap_runs(lengths), rng)
    write_reads_bam(paths["hifi"], lengths, N_HIFI, HIFI_MEAN, HIFI_SD, "h", rng)
    write_reads_bam(paths["ont"], lengths, N_ONT, ONT_MEAN, ONT_SD, "o", rng)
    names = list(lengths)
    with open(paths["regions"], "w") as f:
        f.write(f"{names[0]}\t1000000\t9000000\n{names[1]}\t4000000\t30000000\n"
                f"{names[10]}\t0\t{lengths[names[10]]}\n")
    log(f"[inputs] generated {sum(lengths.values())} bp, {N_HIFI} HiFi + {N_ONT} "
        f"ONT reads in {time.perf_counter() - t0:.1f} s under {root}")
    return paths


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
    opener = gzip.open if p1.endswith(".gz") else open
    with opener(p1, "rb") as a, opener(p2, "rb") as b:
        while True:
            x, y = a.read(1 << 26), b.read(1 << 26)
            if x != y:
                return False
            if not x:
                return True


def run_cli(paths, out_dir: str, backend: str) -> tuple[float, list]:
    get_metrics().reset()
    t0 = time.perf_counter()
    cli.main([
        "-r", paths["ref"], "--hifi", paths["hifi"], "--nano", paths["ont"],
        "-R", paths["regions"], "-d", out_dir, "-o", PREFIX, "-t", "8", "-f",
        "--device", backend, "--profile",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, [r.as_dict() for r in get_metrics().records]


def run_device_path(paths, out_dir: str, path: str):
    """One ``--device device`` CLI run with the launch counts set to 0 just
    before it and read just after; the path's kernels must have launched."""
    required, absent = PATH_KERNELS[path]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    wall, stages = run_cli(paths, out_dir, "device")
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in required:
        check(launches[name] > 0, f"{name} was not launched on the {path} path")
    check(launches[absent] == 0, f"{absent} was launched on the {path} path")
    log(f"[main] {path} path: device run {wall:.3f} s; launches {launches}")
    log(f"[main] {path} path: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    log(f"[main] {path} path: stages " + json.dumps(stages))
    return launches


def phase_main_path(paths, work: str) -> dict[str, dict]:
    dirs = {k: os.path.join(work, k) for k in ("packed", "flags", "events")}
    launches = {"packed": run_device_path(paths, dirs["packed"], "packed")}
    limit = fused.PACKED_DEPTH_LIMIT
    fused.PACKED_DEPTH_LIMIT = 1  # every read count takes the flags path
    try:
        launches["flags"] = run_device_path(paths, dirs["flags"], "flags")
    finally:
        fused.PACKED_DEPTH_LIMIT = limit
    wall_ev, stages_ev = run_cli(paths, dirs["events"], "events")
    for path in ("packed", "flags"):
        for name in OUTPUTS:
            check(_same_file(os.path.join(dirs[path], name),
                             os.path.join(dirs["events"], name)),
                  f"{name}: --device device ({path} path) differs from --device events")
    check("jax" not in sys.modules, "jax was imported")
    log(f"[main] events run {wall_ev:.3f} s; all {len(OUTPUTS)} outputs of both "
        "device paths identical to it")
    log("[main] stages events " + json.dumps(stages_ev))
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
        paths = make_inputs(os.path.join(work, "inputs"))
        launches.update(phase_main_path(paths, work))

    kernels_line = {"kernels": [
        dict(name=name, route="cuda", source=SOURCE, replaces=replaces,
             launches=launches[path][name], **rows[name])
        for name, (replaces, path) in KERNEL_ROWS.items()
    ]}
    log(json.dumps(kernels_line))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
