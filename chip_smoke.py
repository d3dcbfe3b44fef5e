"""Smoke run of gci_tpu_torch on one CUDA card, at the size of a real genome.

    python3 chip_smoke.py

Phases, each printing its results:

1. environment: the card (nvidia-smi name and power limit), torch, CUDA and
   nvcc versions, and how the reused C++ host codec built;
2. build of the CUDA kernels (csrc/scan.cu), timed;
3. each kernel against its plain PyTorch version at MH63 size (395,765,512
   genome slots: 12 chromosomes, 395,765,500 bp), exact equality required,
   with the median of 5 CUDA-event timings of each; the on-device compaction
   as built (depth_scan + searchsorted) beside torch.nonzero; and a small
   DeviceDepth against the numpy depth oracle;
4. the main path: ``gci_tpu_torch.cli.main`` on an MH63-shaped reference
   with a HiFi and an ONT BAM and a regions BED, once with ``--device
   device`` and once with ``--device events``; all nine outputs must be
   identical, and every kernel must have launched during the device run.

It prints one JSON line with each kernel's launches, error and times, then
as its last line ``{"ok": true, "device": {...}}``.  Any failed check raises
and exits nonzero; so does a machine without CUDA.  Inputs are generated from
a seed in a temporary directory that is removed at the end.
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
from gci_tpu_torch.depth.fused import DeviceDepth, _compact, packed_event_word
from gci_tpu_torch.depth.scan import (
    depth_scan,
    depth_scan_torch,
    fused_depth_scan_packed,
    fused_depth_scan_packed_torch,
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
PREFIX = "MH63"
OUTPUTS = [
    f"{PREFIX}_hifi.depth.gz", f"{PREFIX}_nano.depth.gz", f"{PREFIX}_two_type.depth.gz",
    f"{PREFIX}_hifi.0.depth.bed", f"{PREFIX}_nano.0.depth.bed",
    f"{PREFIX}_two_type.0.depth.bed", f"{PREFIX}.gci", f"{PREFIX}.regions.gci",
    f"{PREFIX}.gaps.bed",
]
KERNEL_ROWS = {
    # wrapper name -> (source, the TPU kernel it replaces)
    "fused_depth_scan_packed": ("gci_tpu_torch/csrc/scan.cu",
                                "gci_tpu/depth/pallas_scan.py:605"),
    "depth_scan": ("gci_tpu_torch/csrc/scan.cu", "gci_tpu/depth/pallas_scan.py:208"),
}


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

def phase_kernels(dev: torch.device) -> dict[str, dict]:
    rng = np.random.default_rng(SEED + 1)
    lengths = chrom_lengths()
    layout = GenomeLayout.from_targets(lengths)
    n = layout.total_slots
    log(f"[kernels] {n} slots")
    rows = {}

    # K1 on the port's own packed-word scatter of synthetic reads with N-gaps
    tid = rng.integers(0, len(lengths), N_HIFI).astype(np.int32)
    start = (rng.random(N_HIFI) * layout.lengths[tid]).astype(np.int64)
    end = start + rng.integers(1_000, 40_000, N_HIFI)
    word = packed_event_word(layout, tid, start, end, 15, gap_runs(lengths), dev)
    before = kernels.LAUNCHES["fused_depth_scan_packed"]
    err = 0
    for hi in (0, 1):
        got = fused_depth_scan_packed(word, -1, hi)
        want = fused_depth_scan_packed_torch(word, -1, hi)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"fused_depth_scan_packed != plain (hi={hi})")
            err = max(err, max_abs_err(g, w))
    check(kernels.LAUNCHES["fused_depth_scan_packed"] == before + 2,
          "fused_depth_scan_packed launch count did not advance")
    ms = median_ms(lambda: fused_depth_scan_packed(word, -1, 0))
    plain_ms = median_ms(lambda: fused_depth_scan_packed_torch(word, -1, 0))
    rows["fused_depth_scan_packed"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    log(f"[kernels] fused_depth_scan_packed exact, {ms:.4f} ms vs plain {plain_ms:.4f} ms")

    # compaction as built (depth_scan + searchsorted) vs torch.nonzero
    _, flags = fused_depth_scan_packed(word, -1, 0)
    del word
    bits = (flags & 4) != 0
    count = int(bits.sum())
    check(torch.equal(_compact(bits, count), torch.nonzero(bits).squeeze(1)),
          "compaction != torch.nonzero")
    c_ms = median_ms(lambda: _compact(bits, count))
    nz_ms = median_ms(lambda: torch.nonzero(bits).squeeze(1))
    log(f"[kernels] compaction of {count} change bits: depth_scan+searchsorted "
        f"{c_ms:.4f} ms, torch.nonzero {nz_ms:.4f} ms")
    del flags, bits

    # K2 on +-2^23 deltas (wraps mod 2^32) and on a 0/1 bitmap
    before = kernels.LAUNCHES["depth_scan"]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    err = 0
    for lo, hi in ((-(2**23), 2**23), (0, 2)):
        x = torch.randint(lo, hi, (n,), dtype=torch.int32, device=dev, generator=g)
        got, want = depth_scan(x), depth_scan_torch(x)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"depth_scan != plain on [{lo}, {hi})")
        err = max(err, max_abs_err(got, want))
        del got, want
    check(kernels.LAUNCHES["depth_scan"] == before + 2,
          "depth_scan launch count did not advance")
    ms = median_ms(lambda: depth_scan(x))
    plain_ms = median_ms(lambda: depth_scan_torch(x))
    rows["depth_scan"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    log(f"[kernels] depth_scan exact, {ms:.4f} ms vs plain {plain_ms:.4f} ms")
    del x
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
    dd = DeviceDepth.from_reads(layout, tid, start, end, 15, gaps=gaps,
                                issue_range=(-1, 1), device=dev)
    flat = accumulate_depth_numpy(layout, tid, start, end, 15)
    got = dd.materialize_dict()
    masked = dd.mask_gaps(gaps)
    for k, name in enumerate(layout.names):
        o, L = int(layout.offsets[k]), int(layout.lengths[k])
        want = flat[o : o + L].copy()
        check(np.array_equal(got[name], want), f"small DeviceDepth != numpy ({name})")
        check(np.array_equal(dd.to_events()[name].materialize(), want),
              f"small DeviceDepth events != numpy ({name})")
        for s, e in gaps.get(name, []):
            want[s:e] = 0
        check(masked.collapse_dict(-1, 1, 15)[name] == collapse_depth_runs(want, -1, 1, 15),
              f"small DeviceDepth issue intervals != numpy ({name})")
    log("[kernels] small DeviceDepth on the card equals the numpy oracle")


# ---------------------------------------------------------------------------
# 4. the main path
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


def phase_main_path(paths, work: str) -> dict[str, int]:
    d_dev, d_ev = os.path.join(work, "device"), os.path.join(work, "events")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    wall_dev, stages_dev = run_cli(paths, d_dev, "device")
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    wall_ev, stages_ev = run_cli(paths, d_ev, "events")
    for name in OUTPUTS:
        check(_same_file(os.path.join(d_dev, name), os.path.join(d_ev, name)),
              f"{name}: --device device differs from --device events")
    check("jax" not in sys.modules, "jax was imported")
    log(f"[main] device run {wall_dev:.3f} s, events run {wall_ev:.3f} s; "
        f"all {len(OUTPUTS)} outputs identical; launches {launches}")
    log(f"[main] peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    log("[main] stages device " + json.dumps(stages_dev))
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
    with tempfile.TemporaryDirectory(prefix="gci_tpu_torch_smoke_") as work:
        paths = make_inputs(os.path.join(work, "inputs"))
        launches = phase_main_path(paths, work)

    kernels_line = {"kernels": [
        dict(name=name, route="cuda", source=KERNEL_ROWS[name][0],
             replaces=KERNEL_ROWS[name][1], launches=launches[name], **rows[name])
        for name in KERNEL_ROWS
    ]}
    log(json.dumps(kernels_line))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
