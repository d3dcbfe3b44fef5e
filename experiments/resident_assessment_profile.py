"""Per-assessment times of one benchmark cell, span by span, in one process.

    python experiments/resident_assessment_profile.py --workload mh63rs3.hifi39x \
        --seed 1 --seconds 30 --out build/profile/p1.jsonl

Builds the cell's read sets and the benchmark's ``Assessor`` as
``gcibench/harness.py`` does, runs one warm assessment, then assesses the
read sets in turn for ``--seconds`` with the port's span registry on (as
``--profile`` sets it) and no profiler.  After each assessment it records
its latency, each span's seconds in it (the benchmark's spans and the
program's), the process's user and system CPU seconds and its page faults
in it; these rows go to ``--out``, one JSON line each.  Prints one summary
line: per quantity the median, 10th and 90th percentile and the sum, over
the assessments.  ``--config`` and ``--traffic`` take other files than the
cell's (a small rehearsal on the CPU: ``--device cpu``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from gcibench import traffic  # noqa: E402
from gcibench.engine import Assessor  # noqa: E402
from gcibench.spans import Spans  # noqa: E402
from gci_tpu_torch.utils.metrics import get_metrics  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = {c["name"]: c for c in json.load(f)["workloads"]}[args.workload]
    cfg_path = args.config or os.path.join(ROOT, "gcibench/configs", cell["config"] + ".json")
    mix_path = args.traffic or os.path.join(ROOT, "gcibench/traffic", cell["traffic"] + ".json")
    with open(cfg_path) as f:
        config = json.load(f)
    with open(mix_path) as f:
        mix = json.load(f)
    device = torch.device(args.device)
    lengths, gaps = config["chromosomes"], config["gaps"]
    read_sets = traffic.make_read_sets(lengths, gaps, mix, args.seed)
    reg = get_metrics()
    spans = Spans()
    rows = []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with tempfile.TemporaryDirectory() as outdir, \
            open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        assessor = Assessor(lengths, gaps, mix, outdir, device, spans)
        assessor.assess(read_sets[0])
        sync()
        reg.enabled = True
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < args.seconds:
            reg.reset()
            spans.reset()
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            ts = time.perf_counter()
            assessor.assess(read_sets[k % len(read_sets)])
            sync()
            lat = time.perf_counter() - ts
            ru1 = resource.getrusage(resource.RUSAGE_SELF)
            row = {"k": k, "latency_ms": 1000 * lat,
                   "utime_ms": 1000 * (ru1.ru_utime - ru0.ru_utime),
                   "stime_ms": 1000 * (ru1.ru_stime - ru0.ru_stime),
                   "minflt": ru1.ru_minflt - ru0.ru_minflt}
            row.update({"b." + n: 1000 * v for n, v in spans.totals.items()})
            row.update({"p." + n: 1000 * v["self_seconds"] for n, v in reg.span_totals().items()})
            rows.append(row)
            k += 1
        reg.enabled = False
    with open(args.out, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    keys = sorted({key for row in rows for key in row if key != "k"})
    summary = {"workload": args.workload, "seed": args.seed, "assessments": len(rows)}
    for key in keys:
        x = np.array([row.get(key, 0.0) for row in rows])
        summary[key] = [round(float(np.median(x)), 3), round(float(np.percentile(x, 10)), 3),
                        round(float(np.percentile(x, 90)), 3), round(float(x.sum()), 1)]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
