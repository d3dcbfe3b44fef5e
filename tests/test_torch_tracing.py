"""The port's tracing (``gci_tpu_torch.utils.metrics``): spans, counters and
their profiler ranges.

Off (no ``--profile``, no profiler), a span reads no clock and opens no
range.  On, the engine's spans nest as the code does, on each thread, and
sit in a ``torch.profiler`` trace as ``gci.`` ranges inside their parents.
The ``cuda``-marked case holds the copy counters to the bytes the shapes
give, on the card.  No JAX here: nothing is compared with ``gci_tpu``.
"""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from gci_tpu_torch.depth import streamed
from gci_tpu_torch.depth.accum import (
    GenomeLayout,
    accumulate_depth_numpy,
    clamp_read_intervals,
)
from gci_tpu_torch.depth.device import build_scan_valid, scatter_events_into
from gci_tpu_torch.depth.fused import DeviceDepth
from gci_tpu_torch.depth.overlap import DeltaAccumulator
from gci_tpu_torch.filters.cascade import dedup_last_wins
from gci_tpu_torch.io.names import hash_names, keys_view
from gci_tpu_torch.reports import emit_issue_bed
from gci_tpu_torch.utils import metrics
from gci_tpu_torch.utils.metrics import count, get_metrics, span, stage

TARGETS = {"a": 9000, "b": 7000, "c": 150}
CPU = torch.device("cpu")
STREAMED_CHILDREN = ("streamed.sort", "streamed.scatter", "streamed.compact",
                     "streamed.readback", "streamed.runs")
FUSED_CHILDREN = ("fused.pack", "fused.scatter", "fused.scan", "fused.readback",
                  "fused.intervals")


@pytest.fixture(autouse=True)
def registry():
    """An empty registry, off, for each test; restored after."""
    m = get_metrics()
    was = m.enabled
    m.enabled = False
    m.reset()
    yield m
    m.enabled = was
    m.reset()


@pytest.fixture
def on(registry, monkeypatch):
    """Tracing on, as ``--profile`` sets it."""
    monkeypatch.setattr(registry, "enabled", True)
    return registry


def _reads(n=400, seed=5, targets=TARGETS):
    rng = np.random.default_rng(seed)
    lens = np.array(list(targets.values()))
    tid = rng.integers(0, len(lens), n)
    start = (rng.random(n) * np.maximum(lens[tid] - 30, 1)).astype(np.int64)
    end = start + (rng.random(n) * 4000).astype(np.int64) + 5
    return tid.astype(np.int64), start, end


def _global_events(layout, tid, start, end, flank):
    """int64 global start and stop slots of the live reads."""
    s, e = clamp_read_intervals(layout, tid, start, end, flank)
    live = e > s
    base = layout.offsets[tid][live]
    return base + s[live], base + e[live]


def _ranges(prof, tmp_path) -> list:
    """The ``gci.`` ranges of a profiler's Chrome trace: [name, start, end]
    in microseconds, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(([e["name"][len(metrics.TRACE_PREFIX):], e["ts"], e["ts"] + e["dur"]]
                   for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith(metrics.TRACE_PREFIX)), key=lambda r: r[1])


def _inside(child, parent, eps=1e-3) -> bool:
    return parent[1] - eps <= child[1] and child[2] <= parent[2] + eps


def _check_nesting(totals, parent, children):
    """Children sum to no more than their parent; every self time >= 0."""
    assert sum(totals[c]["seconds"] for c in children if c in totals) <= totals[parent]["seconds"]
    assert all(v["self_seconds"] >= 0 for v in totals.values()), totals


def test_profiler_flag_is_pinned():
    """The flag spans test is the one ``torch.profiler`` sets: off outside a
    profile, on inside one, off after it.  A torch that moves it fails here."""
    from torch.autograd import profiler as autograd_profiler

    assert metrics._autograd_profiler is autograd_profiler
    assert autograd_profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


def test_off_a_span_reads_no_clock_and_opens_no_range(registry, monkeypatch, tmp_path):
    """No ``--profile``, no profiler: spans and counters on the streamed
    path and in the issue BED read no clock, open no range and leave the
    registry as it was."""
    def boom(*a, **k):
        raise AssertionError("read while tracing is off")

    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _reads()
    monkeypatch.setattr(time, "perf_counter", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    with span("x"):
        with span("y"):
            count("c", 5)
    depths = streamed.events_from_reads_streamed(layout, tid, start, end, 15, 4096,
                                                 device=CPU)
    emit_issue_bed(depths, "T", 0, 15, str(tmp_path), True, "HiFi")
    assert registry.span_totals() == {} and registry.counter_totals() == {}
    assert registry.records == []


def test_span_totals_self_time_and_report(on):
    with span("outer"):
        time.sleep(0.01)
        for _ in range(3):
            with span("inner"):
                time.sleep(0.002)
    count("bytes", 7)
    count("bytes", 5)
    t = on.span_totals()
    assert t["outer"]["calls"] == 1 and t["inner"]["calls"] == 3
    assert t["outer"]["seconds"] >= t["inner"]["seconds"] + t["outer"]["self_seconds"] - 1e-9
    assert t["outer"]["self_seconds"] >= 0.01
    assert t["inner"]["self_seconds"] == t["inner"]["seconds"]
    assert on.counter_totals() == {"bytes": 12}
    with stage("demo", items=4, unit="reads"):
        pass
    lines = [json.loads(line) for line in on.report().splitlines()]
    assert lines[0]["stage"] == "demo" and lines[0]["items"] == 4
    assert {x.get("span") for x in lines[1:3]} == {"outer", "inner"}
    assert all(set(x) == {"span", "seconds", "self_seconds", "calls"} for x in lines[1:3])
    assert lines[3] == {"counter": "bytes", "value": 12}
    on.reset()
    assert on.report() == "" and on.span_totals() == {} and on.counter_totals() == {}


def test_spans_nest_per_thread_and_lose_no_update(on):
    """Threads keep their own stacks; 24 threads (more than the cores) at a
    short switch interval lose no call, second or count."""
    n_threads, n_spans = 24, 400
    errors = []

    def work():
        try:
            for _ in range(n_spans):
                with span("t.outer"):
                    with span("t.inner"):
                        count("t.count", 3)
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors
    t = on.span_totals()
    assert t["t.outer"]["calls"] == t["t.inner"]["calls"] == n_threads * n_spans
    assert on.counter_totals() == {"t.count": 3 * n_threads * n_spans}
    # each outer's self time leaves out only its own thread's inner span
    assert t["t.outer"]["self_seconds"] >= 0
    assert t["t.outer"]["seconds"] - t["t.outer"]["self_seconds"] == pytest.approx(
        t["t.inner"]["seconds"], rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("chunk_slots", [1000, 4096])
def test_streamed_spans_under_the_profiler(registry, tmp_path, chunk_slots):
    """Under a CPU profiler: ``streamed.build`` once, the sort and the runs
    once, scatter, compact and readback once per chunk; the children within
    the parent, in the registry and as ``gci.`` ranges of the Chrome trace;
    no scatter range holds any of the consumer's compact or readback."""
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _reads()
    n_chunks = -(-layout.total_slots // chunk_slots)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        streamed.events_from_reads_streamed(layout, tid, start, end, 15, chunk_slots,
                                            device=CPU)
    totals = registry.span_totals()
    assert {k: v["calls"] for k, v in totals.items()} == {
        "streamed.build": 1, "streamed.sort": 1, "streamed.runs": 1,
        "streamed.scatter": n_chunks, "streamed.compact": n_chunks,
        "streamed.readback": n_chunks}
    _check_nesting(totals, "streamed.build", STREAMED_CHILDREN)
    # on the CPU no copy is counted, only the boundaries and the events
    flat = accumulate_depth_numpy(layout, tid, start, end, 15)
    gs, ge = _global_events(layout, tid, start, end, 15)
    assert registry.counter_totals() == {"streamed.boundaries": _boundaries(flat),
                                         "streamed.events_native": gs.size + ge.size}
    ranges = _ranges(prof, tmp_path)
    by_name = {}
    for r in ranges:
        by_name.setdefault(r[0], []).append(r)
    assert {k: len(v) for k, v in by_name.items()} == {k: v["calls"] for k, v in totals.items()}
    (build,) = by_name["streamed.build"]
    assert all(_inside(r, build) for r in ranges)
    consumer = by_name["streamed.compact"] + by_name["streamed.readback"]
    for s in by_name["streamed.scatter"]:
        assert not any(c[1] < s[2] and s[1] < c[2] for c in consumer), s
    # per chunk: its scatter, then the consumer's compact and readback
    order = [r[0] for r in ranges if r[0] in ("streamed.scatter", "streamed.compact",
                                              "streamed.readback")]
    assert order == ["streamed.scatter", "streamed.compact", "streamed.readback"] * n_chunks


def test_stage_is_a_range_under_the_profiler(registry, tmp_path):
    """A stage keeps its record, and under a profiler is a ``gci.`` range."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with stage("HiFi:demo"):
            with span("inner"):
                pass
    assert [r.name for r in registry.records] == ["HiFi:demo"]
    ranges = _ranges(prof, tmp_path)
    assert [r[0] for r in ranges] == ["HiFi:demo", "inner"]
    assert _inside(ranges[1], ranges[0])


@pytest.mark.parametrize("depth_kind", ["events", "resident"])
def test_issue_bed_spans_and_no_stage_record(on, tmp_path, depth_kind):
    """``emit_issue_bed``: ``reports.issue_bed`` around ``reports.collapse``
    and ``reports.write``, each once; no stage record.  On event-space depth
    the counters ``collapse.runs`` and ``collapse.candidates`` hold every run
    read and the runs in ``(-1, 0]``; the resident path bypasses them."""
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _reads(60)
    if depth_kind == "events":
        depths = streamed.events_from_reads_streamed(layout, tid, start, end, 15,
                                                     device=CPU)
    else:
        depths = DeviceDepth.from_reads(layout, tid, start, end, 15, device=CPU)
    on.reset()
    emit_issue_bed(depths, "T", 0, 15, str(tmp_path), True, "HiFi")
    totals = on.span_totals()
    assert {k: v["calls"] for k, v in totals.items()} == {
        "reports.issue_bed": 1, "reports.collapse": 1, "reports.write": 1}
    _check_nesting(totals, "reports.issue_bed", ("reports.collapse", "reports.write"))
    assert on.records == []
    counters = on.counter_totals()
    if depth_kind == "events":
        values = [d.values for d in depths.values()]
        zero = sum(int(((v > -1) & (v <= 0)).sum()) for v in values)
        assert zero > 0
        assert counters == {"collapse.runs": sum(v.shape[0] for v in values),
                            "collapse.candidates": zero}
    else:
        assert "collapse.runs" not in counters and "collapse.candidates" not in counters


@pytest.mark.parametrize("limit", [None, 1])
def test_fused_spans(on, monkeypatch, limit):
    """``DeviceDepth.from_reads`` (the packed word, and the flags scan at a
    lowered limit), ``to_events`` and ``maximum`` on the CPU."""
    from gci_tpu_torch.depth import fused

    if limit is not None:
        monkeypatch.setattr(fused, "PACKED_DEPTH_LIMIT", limit)
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _reads()
    d = DeviceDepth.from_reads(layout, tid, start, end, 15, gaps={"a": [(100, 300)]},
                               device=CPU)
    d.maximum(d).to_events()
    d.to_events()
    d.to_events()  # cached: no second span
    totals = on.span_totals()
    calls = {k: v["calls"] for k, v in totals.items()}
    assert calls.pop("fused.scatter") == (2 if limit else 1)
    assert calls == {"fused.build": 1, "fused.pack": 1, "fused.scan": 1,
                     "fused.readback": 1, "fused.intervals": 1, "merge.max": 1,
                     "checkpoint.runs": 2}
    _check_nesting(totals, "fused.build", FUSED_CHILDREN)


@pytest.mark.parametrize("build", ["packed", "flags", "delta"])
def test_fused_boundaries_counter_is_the_run_form(registry, monkeypatch, build):
    """``fused.boundaries``, once per resident build: the length of the run
    form the value hands its checkpoint (slot 0 included), on the packed
    word, the flags scan at a lowered limit and ``from_delta``; counted only
    while the registry records."""
    from gci_tpu_torch.depth import fused

    if build == "flags":
        monkeypatch.setattr(fused, "PACKED_DEPTH_LIMIT", 1)
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _reads()

    def one():
        if build == "delta":
            gs, ge = _global_events(layout, tid, start, end, 15)
            delta = torch.zeros(layout.total_slots, dtype=torch.int32)
            scatter_events_into(delta, [(gs, 1), (ge, -1)])
            return DeviceDepth.from_delta(layout, delta, 15, rows=2 * gs.shape[0])
        return DeviceDepth.from_reads(layout, tid, start, end, 15, device=CPU)

    one()
    assert registry.counter_totals() == {}
    registry.enabled = True
    d = one()
    flat = accumulate_depth_numpy(layout, tid, start, end, 15)
    assert registry.counter_totals() == {"fused.boundaries": d._runs[0].shape[0]}
    assert d._runs[0].shape[0] == _boundaries(flat)
    d.to_events()
    one()
    assert registry.counter_totals() == {"fused.boundaries": 2 * _boundaries(flat)}


@pytest.mark.parametrize("caller", ["reads", "delta", "sweep"])
def test_boundaries_counter_is_the_runs_read_back(on, monkeypatch, caller):
    """``streamed.boundaries``, once per ``events_from_runs``: the run
    boundaries the chunks read back (the sum over ``chunk_runs``), for each
    of its three callers on the CPU, 4096-slot chunks."""
    from gci_tpu_torch.depth import overlap

    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _reads()
    read_back = []
    real = streamed.chunk_runs

    def spy(*args):
        got = real(*args)
        read_back.append(got[0].shape[0])
        return got

    monkeypatch.setattr(streamed, "chunk_runs", spy)
    monkeypatch.setattr(overlap, "chunk_runs", spy)
    gs, ge = _global_events(layout, tid, start, end, 15)
    if caller == "reads":
        streamed.events_from_reads_streamed(layout, tid, start, end, 15, 4096, device=CPU)
    elif caller == "delta":
        delta = torch.zeros(layout.total_slots, dtype=torch.int32)
        scatter_events_into(delta, [(gs, 1), (ge, -1)])
        streamed.events_from_delta2d_streamed(layout, delta, 4096, rows=2 * gs.shape[0])
    else:
        order = np.argsort(layout.offsets[tid] + start, kind="stable")
        keys = hash_names([f"r{k}".encode() for k in range(tid.shape[0])])
        acc = overlap.SweepAccumulator(layout, 15, 4096, device=CPU)
        acc.add_chunk(keys_view(keys), tid[order], start[order], end[order])
        acc.finish()
    flat = accumulate_depth_numpy(layout, tid, start, end, 15)
    assert len(read_back) == -(-layout.total_slots // 4096)
    # the reads' caller also partitions their events
    events = {"streamed.events_native": 2 * gs.size} if caller == "reads" else {}
    assert on.counter_totals() == {"streamed.boundaries": sum(read_back), **events}
    assert sum(read_back) == _boundaries(flat)


def test_overlap_fold_span(on):
    """``overlap.fold`` once per chunk folded into an accumulator."""
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _reads(300)
    names = [f"r{i % 200}".encode() for i in range(300)]
    keys = hash_names(names)
    acc = DeltaAccumulator(layout, 15, device=CPU)
    for lo, hi in ((0, 100), (100, 200), (200, 300)):
        surv = dedup_last_wins(keys[lo:hi], np.ones(hi - lo, bool)) + lo
        acc.add_chunk(keys_view(keys[surv]), tid[surv], start[surv], end[surv])
    assert acc.chunks_added == 3 and acc.rows_retracted > 0
    assert on.span_totals()["overlap.fold"]["calls"] == 3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _boundaries(flat: np.ndarray) -> int:
    """Run boundaries of a flat depth, slot 0 included."""
    return 1 + int(np.count_nonzero(flat[1:] != flat[:-1]))


def _edges(flat: np.ndarray, valid: np.ndarray) -> int:
    """Rises and falls of the issue mask ``depth == 0`` inside ``valid``."""
    m = (flat <= 0) & valid
    prev = np.concatenate([[False], m[:-1]])
    return int(np.count_nonzero(m & ~prev) + np.count_nonzero(~m & prev))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_slots", [1000, 4096, 50_000])
def test_copy_counters_on_cuda_streamed(on, cuda_device, chunk_slots):
    """The streamed path: 8 B to the card per event (an int32 index and
    value: each live read's start and stop, and each chunk's carry) and 16 B
    back per run boundary (int64 index and depth), exactly."""
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _reads(2000)
    s, e = clamp_read_intervals(layout, tid, start, end, 15)
    n_live = int(np.count_nonzero(e > s))
    n_chunks = -(-layout.total_slots // chunk_slots)
    flat = accumulate_depth_numpy(layout, tid, start, end, 15)
    streamed.events_from_reads_streamed(layout, tid, start, end, 15, chunk_slots,
                                        device=cuda_device)
    torch.cuda.synchronize()
    assert on.counter_totals() == {"copies.h2d_bytes": 8 * (2 * n_live + n_chunks),
                                   "copies.d2h_bytes": 16 * _boundaries(flat),
                                   "streamed.boundaries": _boundaries(flat),
                                   "streamed.events_native": 2 * n_live}


@pytest.mark.cuda
def test_copy_counters_on_cuda_resident(on, cuda_device):
    """The resident path: 8 B to the card per scatter row (each read's start
    and stop, each scan window's two borders) and 8 B back per rise, fall,
    run boundary and run value, exactly; ``fused.boundaries`` the run
    boundaries."""
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _reads(2000)
    flat = accumulate_depth_numpy(layout, tid, start, end, 15)
    valid = build_scan_valid(layout, 15)
    n_windows = sum(1 for L in TARGETS.values() if L > 30)
    d = DeviceDepth.from_reads(layout, tid, start, end, 15, device=cuda_device)
    d.to_events()
    torch.cuda.synchronize()
    assert on.counter_totals() == {
        "copies.h2d_bytes": 8 * (2 * tid.shape[0] + 2 * n_windows),
        "copies.d2h_bytes": 8 * (_edges(flat, valid) + 2 * _boundaries(flat)),
        "fused.boundaries": _boundaries(flat)}
