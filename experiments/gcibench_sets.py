"""Run one benchmark cell on one or two checkouts, in turns, and summarize
the spread of each end-to-end metric.

    python experiments/gcibench_sets.py --workload mh63rs3.hifi39x --seconds 51 \
        --side P=build/parent_tree --side C=. --seeds 1 2 3 4 5 6 \
        [--trace-seed 7] --out build/sets/a

Each side is a checkout holding ``BENCHMARK.json`` and ``gcibench/``; each
run is ``python3 gcibench/run.py --workload W --seed S --seconds T --trace
0`` from the root of that checkout, in its own process.  For the k-th seed
the sides run in the order given when k is even and reversed when k is odd
(P C, C P, P C, ...).  With ``--trace-seed`` every side then makes one
``--trace 1`` run on that seed.  Each run's stdout and stderr go to
``OUT/<side>_<seed>.log``.  The card's name and power limit come first;
then one JSON line per run (its end-to-end metrics, ``correct``, the
harness's window rusage and span totals); then one summary line per side:
per metric the values, the median, the IQR spread (the distance between
the first and third quartile of ``statistics.quantiles(n=4)``) and the range
spread of the runs left after dropping the one farthest from the median,
both as shares of that side's median and of the first side's median.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time


def card() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "no nvidia-smi"


def parse_log(text: str) -> dict:
    """The result line and what the harness prints to stderr about the window."""
    out: dict = {"result": None, "rusage": {}, "spans_ms": {}}
    for line in text.splitlines():
        if line.startswith("{") and '"correct"' in line:
            out["result"] = json.loads(line)
        elif line.startswith("window rusage: "):
            for part in line[len("window rusage: "):].split(", "):
                k, v = part.split(" ")
                out["rusage"][k] = float(v)
        elif line.startswith("spans, ms per assessment: "):
            for part in line[len("spans, ms per assessment: "):].split(", "):
                k, v = part.rsplit(" ", 1)
                out["spans_ms"][k] = float(v)
        elif line.startswith("window "):
            m = re.match(r"window ([\d.]+) s, (\d+) assessments.*median ([\d.]+), max ([\d.]+)",
                         line)
            if m:
                out["window_s"], out["assessments"] = float(m[1]), int(m[2])
                out["median_latency_s"], out["max_latency_s"] = float(m[3]), float(m[4])
    return out


def spreads(values: list, base: float) -> dict:
    """IQR and range-of-the-rest spreads of ``values`` as shares of ``base``."""
    med = statistics.median(values)
    q = statistics.quantiles(values, n=4) if len(values) >= 2 else [med, med, med]
    rest = list(values)
    if len(rest) > 2:
        rest.remove(max(rest, key=lambda v: abs(v - med)))
    return {"median": med, "iqr": q[2] - q[0], "iqr_share": (q[2] - q[0]) / base,
            "range5": max(rest) - min(rest), "range5_share": (max(rest) - min(rest)) / base}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--side", action="append", required=True, help="NAME=DIR")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace-seed", type=int)
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=600)
    args = ap.parse_args(argv)
    sides = [s.split("=", 1) for s in args.side]
    os.makedirs(args.out, exist_ok=True)
    print(json.dumps({"card": card(), "workload": args.workload, "sides": sides}), flush=True)

    def one(name, root, seed, trace):
        cmd = [sys.executable, "gcibench/run.py", "--workload", args.workload, "--seed",
               str(seed), "--seconds", str(args.seconds), "--trace", str(trace)]
        t = time.perf_counter()
        r = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=args.timeout)
        log = os.path.join(args.out, f"{name}_{seed}{'_t' if trace else ''}.log")
        with open(log, "w") as f:
            f.write(r.stderr + r.stdout)
        got = parse_log(r.stderr + r.stdout)
        res = got.pop("result") or {}
        line = {"side": name, "seed": seed, "trace": trace, "rc": r.returncode,
                "wall_s": round(time.perf_counter() - t, 1), "correct": res.get("correct"),
                "metrics": {k: v["value"] for k, v in res.get("metrics", {}).items()},
                "checks": {k: v["value"] for k, v in res.get("checks", {}).items()}, **got}
        if trace and res:
            line["device"] = res.get("device")
            line["breakdown"] = res.get("breakdown")
        print(json.dumps(line), flush=True)
        return line

    runs = {name: [] for name, _ in sides}
    for k, seed in enumerate(args.seeds):
        for name, root in (sides if k % 2 == 0 else sides[::-1]):
            runs[name].append(one(name, root, seed, 0))
    if args.trace_seed is not None:
        for name, root in sides:
            one(name, root, args.trace_seed, 1)

    base = {}
    for name, _ in sides:
        ok = [r for r in runs[name] if r["rc"] == 0 and r["metrics"]]
        summary = {"side": name, "runs": len(runs[name]), "ok": len(ok),
                   "all_correct": all(r["correct"] for r in runs[name])}
        for metric in sorted({m for r in ok for m in r["metrics"]}):
            vals = [r["metrics"][metric] for r in ok if metric in r["metrics"]]
            med = statistics.median(vals)
            first = base.setdefault(metric, med)
            s = spreads(vals, med)
            summary[metric] = {"values": vals, **s,
                               "range5_of_first_median": s["range5"] / first,
                               "iqr_of_first_median": s["iqr"] / first}
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
