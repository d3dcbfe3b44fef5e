"""Time gci_tpu_torch's stream compaction against an earlier version of it
on one CUDA card, both in one process on the same inputs.

    python experiments/torch_compact_against_parent.py --parent DIR [--rounds 5]

DIR holds a checkout of the earlier commit (``git archive``).  Its
``gci_tpu_torch/kernels.py``, which imports nothing of its package, is
loaded beside this checkout's under another module name and builds its own
``csrc/scan.cu`` into DIR's ``build/``; its launchers
``launch_compact_flags(x, masks)`` and ``launch_compact_runs(depth, carry)``
get the capacity too where they take one.  On the inputs of ``chip_smoke.py``'s phase 3 (K1's change
bits, its flag byte under masks (1, 2, 4) and its depth at MH63 size, the
depth of 58x reads, dense random inputs) both versions are first held
exactly against the plain version.  Then each round times, per input, this
checkout's launcher (with phase 3's capacity), the earlier one and
``torch.nonzero`` (phase 3's yardstick) in turns, the order rotated every
call: the median of 21 CUDA-event timings each, every call with its one
host sync.  Prints the card's name and power limit, one JSON line per
round, then one summary line: per input the median over the rounds of
each time and of the ratio to ``torch.nonzero``, and the rounds this
checkout's launcher was the faster.  With ``--profile``, one more line:
per input and version, the device time of each kernel and memory
operation a call makes, averaged over 20 calls traced by
``torch.profiler``, beside the call's CUDA-event time, so what of a call
is the kernels' and what is host time the card waits through shows.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import inspect
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke as cs  # noqa: E402
from gci_tpu_torch import kernels  # noqa: E402


def load_parent_kernels(parent: str):
    """The earlier checkout's kernels module, built and loaded."""
    path = os.path.join(parent, "gci_tpu_torch", "kernels.py")
    spec = importlib.util.spec_from_file_location("parent_gci_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.load()
    return mod


def launchers(mod, x, args, cap):
    """(this checkout's call, the earlier one's) on one input."""
    name = "launch_compact_flags" if x.dtype == torch.int8 else "launch_compact_runs"
    new, old = getattr(kernels, name), getattr(mod, name)
    old_args = (*args, cap) if "capacity" in inspect.signature(old).parameters else args
    return lambda: new(x, *args, cap), lambda: old(x, *old_args)


def in_turns(fns, runs: int) -> list[float]:
    """Median CUDA-event ms of each of fns, timed in turns (the order
    rotated every run) after one warm-up each, the collector paused."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    gc.disable()
    try:
        for k in range(runs):
            for j in range(len(fns)):
                i = (j + k) % len(fns)
                times[i].append(cs._median_ms(fns[i], 1))
    finally:
        gc.enable()
    return [sorted(t)[len(t) // 2] for t in times]


def profile_calls(calls: dict, runs: int = 20) -> dict:
    """key -> version -> {"call_ms": event ms a call, kernel or memory
    operation name: its device ms a call} over ``runs`` traced calls."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for key, fns in calls.items():
        out[key] = {}
        for label, fn in zip(("this", "earlier"), fns[:2]):
            row = {"call_ms": in_turns([fn], runs)[0]}
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(runs):
                    fn()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                dev_us = getattr(e, "device_time_total", None)
                if dev_us is None:
                    dev_us = e.cuda_time_total
                if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                    row[e.key] = dev_us / runs / 1e3
            out[key][label] = row
    return out


def median(values):
    return sorted(values)[len(values) // 2]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="checkout of the earlier commit")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--profile", action="store_true",
                    help="also trace each version's calls with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_compact_against_parent: needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = cs.phase_environment()
    kernels.load()
    parent = load_parent_kernels(args.parent)
    inputs = cs.compaction_inputs(dev)
    nonzero = cs.nonzero_calls(inputs)
    calls = {}
    for key, (x, a, cap) in inputs.items():
        new, old = launchers(parent, x, a, cap)
        want = cs._plain(x)(x, *a)
        for label, fn in (("this", new), ("earlier", old)):
            if not cs._equal(fn(), want):
                sys.exit(f"{label} compaction of {key} != plain")
        calls[key] = (new, old, nonzero[key])
    rounds = []
    for r in range(args.rounds):
        row = {}
        for key, fns in calls.items():
            ms, parent_ms, nz_ms = in_turns(fns, cs.COMPACTION_TIMED_RUNS)
            row[key] = dict(ms=ms, parent_ms=parent_ms, nonzero_ms=nz_ms)
        rounds.append(row)
        print(json.dumps({"round": r, **row}), flush=True)
    summary = {}
    for key in calls:
        got = [row[key] for row in rounds]
        summary[key] = dict(
            ms=median([g["ms"] for g in got]),
            parent_ms=median([g["parent_ms"] for g in got]),
            nonzero_ms=median([g["nonzero_ms"] for g in got]),
            ratio=median([g["ms"] / g["nonzero_ms"] for g in got]),
            parent_ratio=median([g["parent_ms"] / g["nonzero_ms"] for g in got]),
            wins=sum(g["ms"] < g["parent_ms"] for g in got), rounds=len(got))
    print(json.dumps({"summary": summary, "card": smi}), flush=True)
    if args.profile:
        print(json.dumps({"profile": profile_calls(calls), "card": smi}), flush=True)


if __name__ == "__main__":
    main()
