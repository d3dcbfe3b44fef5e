"""Spans of the benchmark's own code around each call into a layer.

Each span adds its host-clock duration to a total by name; while the
profiler records, it is also a ``record_function`` range, so the trace
shows what the host was doing in each idle gap of the card.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

TRACE_PREFIX = "gcibench."


class Spans:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.traced = False

    @contextmanager
    def span(self, name: str):
        rf = torch.profiler.record_function(TRACE_PREFIX + name) if self.traced else None
        if rf is not None:
            rf.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t
            if rf is not None:
                rf.__exit__(None, None, None)

    def reset(self) -> None:
        self.totals.clear()
