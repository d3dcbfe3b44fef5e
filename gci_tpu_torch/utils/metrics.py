"""Per-stage wall-clock / throughput observability.

The reference has no tracing at all (SURVEY.md §5: stdout prints only).
Here every pipeline stage records wall time and item counts into a process
metrics registry; ``--profile`` dumps a JSON stage report, and
``--profile-trace DIR`` writes a ``torch.profiler`` trace of the run.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field


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

    def add(self, name: str, seconds: float, items: int | None = None, unit: str = ""):
        self.records.append(StageRecord(name, seconds, items, unit))

    def report(self) -> str:
        return "\n".join(json.dumps(r.as_dict()) for r in self.records)

    def reset(self) -> None:
        self.records.clear()


_METRICS = StageMetrics()


def get_metrics() -> StageMetrics:
    return _METRICS


@contextlib.contextmanager
def stage(name: str, items: int | None = None, unit: str = ""):
    """Time a pipeline stage; records even when profiling output is off.

    Yields the StageRecord so streaming stages can set ``items``/``unit``
    once the count is known (e.g. records packed per host shard).
    """
    rec = StageRecord(name, 0.0, items, unit)
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        rec.seconds = time.perf_counter() - t0
        _METRICS.records.append(rec)


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
