"""The readers of the program's own spans and copy counters
(``gci_tpu_torch.utils.metrics``): per completed assessment from a registry
filled by hand, None without a trace, and read in a traced run of the
streamed path on the CPU."""
import time

import pytest
import torch

from conftest import ROOT
from gcibench import harness
from gcibench.trace import TraceSummary
from gci_tpu_torch.utils.metrics import get_metrics

# reader: (what the registry holds, the value it reads for 4 assessments)
READERS = {
    "streamed.sort_ms": ({"streamed.sort": 2.0}, 500.0),
    "streamed.chunks_ms": ({"streamed.scatter": 0.4, "streamed.compact": 0.2,
                            "streamed.readback": 0.6}, 300.0),
    "streamed.runs_ms": ({"streamed.runs": 6.0}, 1500.0),
    "reports.collapse_ms": ({"reports.collapse": 1.2}, 300.0),
    "copies.h2d_MB": ({"copies.h2d_bytes": 644_000_000}, 161.0),
    "copies.d2h_MB": ({"copies.d2h_bytes": 1_280_000_000}, 320.0),
}


@pytest.fixture
def registry():
    m = get_metrics()
    m.reset()
    yield m
    m.reset()


def _run(completed, trace=True):
    summary = TraceSummary(window_s=50.0, busy_s=1.0, device_s=1.0, device_events=1)
    return harness.Run(cell={}, config={"chromosomes": {"c": 1}}, mix={"read_types": [{}]},
                       device_name="cpu", completed=completed, window_s=50.0,
                       latencies=[1.0] * completed, setup_s=1.0, device_peak_bytes=None,
                       host_peak_bytes=1, spans={}, trace=summary if trace else None)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_per_assessment_and_none_without_a_trace(registry, name):
    reader = harness.load_reader(ROOT, name)
    held, want = READERS[name]
    assert reader.read(_run(4)) is None  # nothing recorded
    for key, value in held.items():
        if key.startswith("copies."):
            registry.counters[key] = value
        else:
            registry.spans[key] = [value, value, 3]
    assert reader.read(_run(4)) == pytest.approx(want, rel=1e-12)
    assert reader.read(_run(4, trace=False)) is None
    assert reader.read(_run(0)) is None


def test_traced_streamed_run_reads_the_program_spans(tree, streamed, registry):
    """A traced run of the streamed path on the CPU reports the four span
    metrics, within the benchmark's own span around the same call, and no
    copy counters (nothing is counted on the CPU)."""
    rc, result = harness.run_cell(tree, "tiny2.dual", 2**31 + 13, 0.5, True,
                                  torch.device("cpu"), time.perf_counter())
    assert rc == 0 and result["correct"], result
    got = {k: v["value"] for k, v in result["metrics"].items()}
    parts = got["streamed.sort_ms"] + got["streamed.chunks_ms"] + got["streamed.runs_ms"]
    assert 0 < parts <= got["streamed.build_ms"]
    assert 0 < got["reports.collapse_ms"] <= got["reports.issue_bed_ms"]
    assert not got.keys() & {"copies.h2d_MB", "copies.d2h_MB"}
