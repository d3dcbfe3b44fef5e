"""Run one cell of the benchmark once and print its result as the last line.

    python3 gcibench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; see ``gcibench/harness.py``.  Exits with a code other
than 0, and prints no result, where CUDA is missing or has fewer cards than
the cell asks for, where the port is not in this checkout, and where JAX or
the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the port builds its CUDA library once into build/gci_tpu_torch/ of this
# checkout, a fixed place, and loads it from there in every later run
ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    with open(ROOT / "BENCHMARK.json") as f:
        cells = {c["name"]: c for c in json.load(f)["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    import gci_tpu_torch

    if ROOT not in Path(gci_tpu_torch.__file__).resolve().parents:
        print(f"gci_tpu_torch was loaded from {gci_tpu_torch.__file__}, not from this checkout",
              file=sys.stderr)
        return 2
    from gcibench.harness import run_cell

    rc, result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START)
    if result is not None:
        sys.stdout.flush()
        print(json.dumps(result))
    return rc


if __name__ == "__main__":
    sys.exit(main())
