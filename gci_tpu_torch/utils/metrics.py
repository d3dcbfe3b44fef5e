"""The port's tracing: stage records, spans, counters and the profiler.

The reference has no tracing at all (SURVEY.md §5: stdout prints only).
Here one process registry holds three things:

* **stages** (``stage``): one record per call of a pipeline stage, with its
  wall time and item count, kept on every call (the CLI's ingest stages);
* **spans** (``span``): wall time under a static name, summed (seconds,
  calls, and self seconds: the time no child span covers), at the layer
  boundaries inside the engine;
* **counters** (``count``): sums, such as the bytes copied between the host
  and the card.

Spans and counters record only while tracing is on: while
``StageMetrics.enabled`` is set (``--profile``) or while a
``torch.profiler`` records.  Off, a span is one flag test: it reads no
clock and opens nothing.  While a profiler records, every span and every
stage is also a ``torch.profiler.record_function`` range named ``"gci." +
name``, so the host's spans sit on the profiler's clock in the same trace
as the card's kernels and copies.  ``--profile`` prints the stage records,
then one line per span and per counter; ``--profile-trace DIR`` writes a
``torch.profiler`` trace of the run.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_PREFIX = "gci."


@dataclass
class StageRecord:
    name: str
    seconds: float
    items: int | None = None
    unit: str = ""

    def as_dict(self) -> dict:
        d = {"stage": self.name, "seconds": round(self.seconds, 4)}
        if self.items is not None:
            d["items"] = self.items
            d["unit"] = self.unit
            if self.seconds > 0:
                d["per_second"] = round(self.items / self.seconds, 1)
        return d


@dataclass
class StageMetrics:
    records: list[StageRecord] = field(default_factory=list)
    enabled: bool = False
    # name -> [seconds, self seconds, calls]; name -> sum
    spans: dict[str, list] = field(default_factory=dict)
    counters: dict[str, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def span_totals(self) -> dict[str, dict]:
        """{span: {"seconds", "self_seconds", "calls"}} since the last reset."""
        with self._lock:
            return {k: {"seconds": s, "self_seconds": own, "calls": n}
                    for k, (s, own, n) in self.spans.items()}

    def counter_totals(self) -> dict[str, int]:
        """{counter: sum} since the last reset."""
        with self._lock:
            return dict(self.counters)

    def report(self) -> str:
        lines = [json.dumps(r.as_dict()) for r in self.records]
        lines += [json.dumps({"span": k, "seconds": round(v["seconds"], 4),
                              "self_seconds": round(v["self_seconds"], 4), "calls": v["calls"]})
                  for k, v in self.span_totals().items()]
        lines += [json.dumps({"counter": k, "value": v}) for k, v in self.counter_totals().items()]
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self.records.clear()
            self.spans.clear()
            self.counters.clear()

    def _add_span(self, name: str, seconds: float, own: float) -> None:
        with self._lock:
            t = self.spans.get(name)
            if t is None:
                self.spans[name] = [seconds, own, 1]
            else:
                t[0] += seconds
                t[1] += own
                t[2] += 1

    def _add_count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n


_METRICS = StageMetrics()
# each thread's open spans, innermost last (the overlap path packs on a thread)
_open = threading.local()


def get_metrics() -> StageMetrics:
    return _METRICS


def _range(name: str):
    """An entered profiler range ``"gci." + name``; None when no profiler
    records."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    rf = torch.profiler.record_function(TRACE_PREFIX + name)
    rf.__enter__()
    return rf


class _Span:
    __slots__ = ("name", "rf", "t0", "child")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = _range(self.name)
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        stack.append(self)
        self.child = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        stack = _open.stack
        stack.pop()
        if stack:
            stack[-1].child += dt
        _METRICS._add_span(self.name, dt, dt - self.child)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """Context manager: add the block's wall time to span ``name`` (a static
    name), its self time (less the child spans opened inside it on this
    thread) and one call, while tracing is on; otherwise it does nothing.
    Close a span before a generator's ``yield``, so the consumer's time
    never lands in it."""
    if _METRICS.enabled or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _METRICS.enabled or _autograd_profiler._is_profiler_enabled:
        _METRICS._add_count(name, int(n))


@contextlib.contextmanager
def stage(name: str, items: int | None = None, unit: str = ""):
    """Time a pipeline stage; records even when profiling output is off.

    Yields the StageRecord so streaming stages can set ``items``/``unit``
    once the count is known (e.g. records packed per host shard).
    """
    rec = StageRecord(name, 0.0, items, unit)
    rf = _range(name)
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        rec.seconds = time.perf_counter() - t0
        _METRICS.records.append(rec)
        if rf is not None:
            rf.__exit__(None, None, None)


def trace_path(trace_dir: str, process: int) -> str:
    """The Chrome trace file ``maybe_trace`` writes for one process."""
    return os.path.join(trace_dir, f"gci_tpu_torch.process{process}.trace.json")


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None, cuda: bool = False):
    """``torch.profiler`` over the block, exported as a Chrome trace into
    ``trace_dir`` (``trace_path``; one file per process), when it is given.
    CPU activity always, CUDA activity for a run on the card (the
    counterpart of ``gci_tpu.utils.metrics.maybe_jax_trace``)."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from gci_tpu_torch.parallel.distributed import process_index

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(trace_path(trace_dir, process_index()))
