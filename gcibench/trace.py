"""The profiler over the measured window, and what the benchmark reads from its trace.

``torch.profiler`` records CPU and CUDA activity; its Chrome trace is read
once the window has closed.  The card is busy wherever a kernel, a copy or
a memset runs on it.  Read from the trace, within the window (the
``gcibench.window`` range):

* ``busy_s``: the union of the card's busy intervals; ``window_s``: the
  window's length;
* ``device_s``: the sum of every device operation's time (what a roofline
  share divides by);
* ``device_ops``: that sum by operation name, the largest ten;
* ``idle_gaps``: the longest stretches with nothing on the card, each named
  by the innermost benchmark span the host was in and the runtime call
  that ended the gap.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from gcibench.spans import TRACE_PREFIX

WINDOW = TRACE_PREFIX + "window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CALL_CATS = {"cuda_runtime", "cuda_driver"}
TOP = 10


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s: float
    device_events: int
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def profiler(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def summarize(prof) -> TraceSummary:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events: list) -> TraceSummary:
    """The summary of a Chrome trace's events (times in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if win:
        w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    else:
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in xs]
        w0, w1 = (min(s for s, _ in spans), max(e for _, e in spans)) if spans else (0, 0)
    by_name = defaultdict(float)
    clipped = []
    for e in dev:
        s, z = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if z > s:
            clipped.append((s, z))
            by_name[e["name"]] += (z - s) / 1e6
    busy = _union(clipped)
    # the gaps between busy stretches, and at the window's two ends
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[2 * k], edges[2 * k + 1]) for k in range(len(edges) // 2)
                   if edges[2 * k + 1] > edges[2 * k]), key=lambda g: g[0] - g[1])[:TOP]
    marks = [e for e in xs if e.get("cat") == "user_annotation"
             and e["name"].startswith(TRACE_PREFIX) and e["name"] != WINDOW]
    calls = sorted((e["ts"], e["name"]) for e in xs if e.get("cat") in HOST_CALL_CATS)
    named = []
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        inside = [m for m in marks if m["ts"] <= mid <= m["ts"] + m["dur"]]
        where = (max(inside, key=lambda m: m["ts"])["name"][len(TRACE_PREFIX):]
                 if inside else "outside the spans")
        before = [n for t, n in calls if g0 <= t <= g1]
        named.append([f"{where}, then {before[-1] if before else 'the window ends'}",
                      (g1 - g0) / 1e6])
    return TraceSummary(
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(z - s for s, z in busy) / 1e6,
        device_s=sum(by_name.values()),
        device_events=len(clipped),
        device_ops=[[n, t] for n, t in sorted(by_name.items(), key=lambda x: -x[1])[:TOP]],
        idle_gaps=named,
    )
