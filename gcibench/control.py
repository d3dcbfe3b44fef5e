"""The control of the comparison that decides ``correct``: it has to fail.

The configurations state base-resolution depth.  The control is the plain
reference put in the program's place with that guarantee broken the way a
later change might be tempted to break it: the depth held once every
``BIN_BP`` bases, as a genome axis of half the slots would hold it.  For
each seed it makes the cell's first read set, runs the
reference and the control over it, and prints the comparison's numbers
with their limits; every number of a sound run is 0.

    python3 gcibench/control.py --workload <cell> --seeds 1 2 3
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BIN_BP = 2


def control_numbers(root: Path, workload: str, seed: int) -> dict:
    from gcibench import checks, traffic
    from gcibench.harness import load_json
    from gcibench.reference import gci_ref

    cell = {c["name"]: c for c in load_json(root, "BENCHMARK.json")["workloads"]}[workload]
    config = load_json(root, "gcibench", "configs", f"{cell['config']}.json")
    mix = load_json(root, "gcibench", "traffic", f"{cell['traffic']}.json")
    lengths, gaps = config["chromosomes"], config["gaps"]
    read_set = traffic.make_read_sets(lengths, gaps, mix, seed)[0]
    args = (lengths, gaps, read_set, int(mix["flank"]), int(mix["threshold"]),
            float(mix["dist_percent"]))
    want = gci_ref.assess(*args)
    got = gci_ref.assess(*args, bin_bp=BIN_BP)
    return checks.compare(got, want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from gcibench.checks import LIMITS

    for seed in args.seeds:
        t = time.perf_counter()
        numbers = control_numbers(ROOT, args.workload, seed)
        failed = any(v > LIMITS[k] for k, v in numbers.items())
        print(json.dumps({"workload": args.workload, "seed": seed, "bin_bp": BIN_BP,
                          "numbers": numbers, "limits": LIMITS, "control_fails": failed,
                          "seconds": round(time.perf_counter() - t, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
