"""Per-stage wall-clock / throughput observability.

The reference has no tracing at all (SURVEY.md §5: stdout prints only).
Here every pipeline stage records wall time and item counts into a process
metrics registry; ``--profile`` dumps a JSON stage report.
"""
from __future__ import annotations

import contextlib
import json
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

