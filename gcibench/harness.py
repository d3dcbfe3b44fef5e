"""One run of one cell: set-up, the measured window, the check, the result line.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json`` and each metric it reports in
``metrics/<metric>.py``, a reader with ``UNIT`` and ``read(run)``, which
returns None where the run has nothing for it to read.

The window is a closed loop of one client: assessments start while less
than ``seconds`` have passed since the window opened, the read sets taking
turns, and the last one runs to its end.  The end-to-end metrics are taken
over the assessments that complete.  With ``trace`` the profiler records
the window and the per-layer metrics are reported instead.

Set-up makes the read sets and runs one warm assessment of the first, whole.

``correct`` comes from the comparison with the plain reference
(``reference/gci_ref.py``, ``checks.py``), made once the window has closed
and the device's peak has been read: the last assessment and ``checked``
more, drawn from the seed among those that completed (a reservoir sample),
each against the reference's outputs for its own read set.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import random
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import torch

from gcibench import checks, traffic
from gcibench.engine import Assessor
from gcibench.reference import gci_ref
from gcibench.spans import TRACE_PREFIX, Spans
from gcibench.trace import TraceSummary, profiler, summarize

# top-level modules that may not be loaded in a run's process: JAX and the
# JAX package the port was made from (compared whole: the port's own name
# begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "gci_tpu")


@dataclass
class Run:
    """What the metric readers read."""
    cell: dict
    config: dict
    mix: dict
    device_name: str
    completed: int
    window_s: float
    latencies: list
    setup_s: float
    device_peak_bytes: int | None
    host_peak_bytes: int
    spans: dict
    trace: TraceSummary | None
    peaks: dict = field(default_factory=dict)

    @property
    def genome_bp(self) -> int:
        return int(sum(self.config["chromosomes"].values()))

    @property
    def slots(self) -> int:
        """Genome slots of the port's layout: each chromosome and one more."""
        return self.genome_bp + len(self.config["chromosomes"])

    @property
    def depths(self) -> int:
        """Genome-wide depths the outputs are defined on: one per read type,
        and their maximum where there are two."""
        n = len(self.mix["read_types"])
        return n + (n == 2)

    def span_ms(self, name: str):
        if name not in self.spans or not self.completed:
            return None
        return 1000 * self.spans[name] / self.completed


def load_json(root: Path, *parts: str) -> dict:
    with open(root.joinpath(*parts)) as f:
        return json.load(f)


def load_reader(root: Path, name: str):
    path = root / "gcibench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("gcibench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _power_limit() -> str | None:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else None


def _plain(outputs: dict) -> dict:
    """An assessment's outputs as the comparison takes them: runs as arrays,
    files as text (read before the next assessment overwrites them)."""
    return {
        "runs": {k: {t: (ev.boundaries, ev.values) for t, ev in d.items()}
                 for k, d in outputs["runs"].items()},
        "beds": {k: Path(p).read_text() for k, p in outputs["beds"].items()},
        "gci": Path(outputs["gci"]).read_text(),
    }


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> tuple[int, dict | None]:
    """Run one cell once; returns (exit code, result).  The caller has
    checked that the cell's chips are there; ``t_start`` is the process's
    start on the ``time.perf_counter`` clock."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        print(f"no workload {workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2, None
    cell = cells[workload]
    config = load_json(root, "gcibench", "configs", f"{cell['config']}.json")
    mix = load_json(root, "gcibench", "traffic", f"{cell['traffic']}.json")
    wanted = [m for m in bench["per_layer" if trace else "end_to_end"] if applies(m, workload)]
    readers = {m["name"]: load_reader(root, m["name"]) for m in wanted}
    peaks = load_json(root, "gcibench", "peaks.json")
    lengths, gaps = config["chromosomes"], config["gaps"]

    t = time.perf_counter()
    read_sets = traffic.make_read_sets(lengths, gaps, mix, seed)
    print(f"read sets made in {time.perf_counter() - t:.3f} s", file=sys.stderr)
    outdir = tempfile.mkdtemp(prefix="gcibench-")
    spans = Spans()
    cuda = device.type == "cuda"
    try:
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            assessor = Assessor(lengths, gaps, mix, outdir, device, spans)
            t = time.perf_counter()
            assessor.assess(read_sets[0])
            _sync(device)
            print(f"warm assessment {time.perf_counter() - t:.3f} s", file=sys.stderr)
            spans.reset()
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            # the assessments to compare besides the last: a uniform sample,
            # drawn from the seed, of those that complete
            draw, size = random.Random(seed), int(mix["checked"])
            kept, last = [], None
            latencies, attempted, failed = [], 0, 0
            prof = profiler(cuda) if trace else contextlib.nullcontext()
            spans.traced = trace
            setup_s = time.perf_counter() - t_start
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            with prof:
                with torch.profiler.record_function(TRACE_PREFIX + "window") if trace \
                        else contextlib.nullcontext():
                    t0 = time.perf_counter()
                    while time.perf_counter() - t0 < seconds:
                        which = attempted % len(read_sets)
                        attempted += 1
                        last = out = None
                        ts = time.perf_counter()
                        try:
                            out = assessor.assess(read_sets[which])
                            _sync(device)
                        except Exception:  # a failed assessment counts, and the loop goes on
                            if not failed:
                                traceback.print_exc(file=sys.stderr)
                            failed += 1
                            continue
                        latencies.append(time.perf_counter() - ts)
                        i = len(latencies) - 1
                        j = i if i < size else draw.randrange(i + 1)
                        if j < size:
                            got = (i, which, _plain(out))
                            kept[j:j + 1] = [got]
                        last = (i, which, out)
                    t1 = time.perf_counter()
            spans.traced = False
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        host_peak = ru1.ru_maxrss * 1024
        print("window rusage: " + ", ".join(
            f"{k} {getattr(ru1, k) - getattr(ru0, k):.6g}"
            for k in ("ru_utime", "ru_stime", "ru_minflt", "ru_majflt", "ru_nvcsw", "ru_nivcsw")),
            file=sys.stderr)
        device_peak = torch.cuda.max_memory_allocated(device) if cuda else None
        summary = summarize(prof) if trace else None
        del assessor
        if cuda:
            torch.cuda.empty_cache()
        if last is not None and last[0] not in {i for i, *_ in kept}:
            kept.append((last[0], last[1], _plain(last[2])))
        last = None

        lat = sorted(latencies)
        print(f"window {t1 - t0:.3f} s, {len(latencies)} assessments; latency s: first "
              f"{[round(x, 4) for x in latencies[:3]]}, median {lat[len(lat) // 2] if lat else None}, "
              f"max {lat[-1] if lat else None}", file=sys.stderr)
        t = time.perf_counter()
        # the comparison with the reference, per read set once
        counts = {k: 0 for k in checks.LIMITS}
        want = {}
        for _, which, got in kept:
            if which not in want:
                want[which] = gci_ref.assess(lengths, gaps, read_sets[which], int(mix["flank"]),
                                             int(mix["threshold"]), float(mix["dist_percent"]))
            counts = checks.add(counts, checks.compare(got, want[which]))
        print("spans, ms per assessment: " + ", ".join(
            f"{k} {1000 * v / max(1, len(latencies)):.2f}" for k, v in spans.totals.items()),
            file=sys.stderr)
        print(f"reference and comparison {time.perf_counter() - t:.3f} s; assessments compared "
              f"{sorted(i for i, *_ in kept)}", file=sys.stderr)
        if kept:
            print("the program's .gci, genome rows: " + "; ".join(
                line for line in max(kept, key=lambda k: k[0])[2]["gci"].splitlines() if line.startswith("Genome")),
                file=sys.stderr)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)

    run = Run(cell=cell, config=config, mix=mix,
              device_name=torch.cuda.get_device_name(device) if cuda else "cpu",
              completed=len(latencies), window_s=t1 - t0, latencies=latencies,
              setup_s=setup_s, device_peak_bytes=device_peak, host_peak_bytes=host_peak,
              spans=dict(spans.totals), trace=summary,
              peaks=peaks.get(torch.cuda.get_device_name(device) if cuda else "", {}))
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": run.device_name, "count": 1,
           "memory_peak_bytes": device_peak or 0}
    if cuda:
        dev["power_limit"] = _power_limit()
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    numbers = {k: {"value": v, "limit": checks.LIMITS[k]} for k, v in counts.items()}
    numbers["checked"] = {"value": len(kept), "at_least": 1}
    correct = (failed == 0 and len(kept) >= 1
               and all(v <= checks.LIMITS[k] for k, v in counts.items()))
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result["checks"] = numbers

    found = forbidden_modules()
    if found:
        print(f"loaded in this process, which the benchmark forbids: {', '.join(found)}",
              file=sys.stderr)
        return 3, None
    for k, v in counts.items():
        print(f"check {k}: {v} (limit {checks.LIMITS[k]})", file=sys.stderr)
    print(f"check checked: {len(kept)} (at least 1)", file=sys.stderr)
    return 0, result
