"""The benchmark's resident cell, ``mh63rs3.hifi39x``, on the CPU.

* The resident path through ``gcibench.engine.Assessor`` on a tiny gap-free
  layout under ``hifi39x``'s shape (pile-ups past 127 and 255, zero-coverage
  windows, four read sets in turn): its runs, BED rows and ``.gci`` lines
  equal the plain reference's (``gcibench/reference/gci_ref.py``), also
  while the outputs of earlier assessments are still held.
* The cell's readers (``gcibench/metrics/fused.*``) on a hand-made ``Run``:
  the value from known span, counter and device-operation totals, and None
  where the run has nothing for them to read.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gcibench import checks, harness, traffic  # noqa: E402
from gcibench.engine import Assessor  # noqa: E402
from gcibench.reference import gci_ref  # noqa: E402
from gcibench.spans import Spans  # noqa: E402
from gcibench.trace import TraceSummary  # noqa: E402
from gci_tpu_torch.utils.metrics import get_metrics  # noqa: E402

CELL = "mh63rs3.hifi39x"
# four chromosomes of MH63RS3's gap-free layout, each cut to a 300th
LENGTHS = {"Chr01_MH63": 150_090, "Chr02_MH63": 127_303, "Chr03_MH63": 129_076,
           "Chr04_MH63": 125_884}


def _mix() -> dict:
    """``hifi39x`` at the tiny layout's scale: the same coverage, pile-up
    depths (+100 to +400) and read sets, reads and stretches shorter, and
    more windows and pile-ups per Gbp, so that each read set has some."""
    mix = json.loads((ROOT / "gcibench/traffic/hifi39x.json").read_text())
    kind = mix["read_types"][0]
    kind["length"].update(mean=3000, sd=700, min=500)
    kind.update(windows_per_Gbp=1e4, window_bp=[500, 2000], pileups_per_Gbp=8e3,
                pileup_bp=[2000, 5000])
    return mix


def test_cell_is_the_resident_path_on_the_published_layout():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {c["name"]: c for c in bench["workloads"]}[CELL]
    config = harness.load_json(ROOT, "gcibench", "configs", f"{cell['config']}.json")
    mix = harness.load_json(ROOT, "gcibench", "traffic", f"{cell['traffic']}.json")
    assert cell["chips"] == 1 and config["gaps"] == {}
    assert sum(config["chromosomes"].values()) == config["genome_bp"] == 395_765_500
    assert traffic.read_count(mix["read_types"][0], config["genome_bp"]) == 857_492
    for name in ("fused.build_ms", "checkpoint.runs_ms", "fused.pack_ms", "fused.readback_ms",
                 "fused.boundaries_M", "fused.k1_roofline"):
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL] and m["moves"] == "assess_Gbp_per_s"


def _held(out: dict) -> dict:
    """An assessment's outputs as it handed them back: its runs' arrays
    themselves, not copies (the files are read at once: the next
    assessment overwrites them)."""
    return {"runs": {k: {t: (ev.boundaries, ev.values) for t, ev in d.items()}
                     for k, d in out["runs"].items()},
            "beds": {k: Path(p).read_text() for k, p in out["beds"].items()},
            "gci": Path(out["gci"]).read_text()}


@pytest.mark.parametrize("seed", [3, 2**31 + 26, 2**40 + 1])
def test_resident_assessments_equal_the_reference(tmp_path, seed):
    mix = _mix()
    sets = traffic.make_read_sets(LENGTHS, {}, mix, seed)
    assert len(sets) == 4
    eng = Assessor(LENGTHS, {}, mix, str(tmp_path), torch.device("cpu"), Spans())
    assert eng.resident
    held = [_held(eng.assess(read_set)) for read_set in sets + sets[:1]]
    for k, got in enumerate(held):
        want = gci_ref.assess(LENGTHS, {}, sets[k % 4], mix["flank"], mix["threshold"],
                              mix["dist_percent"])
        assert checks.compare(got, want) == {key: 0 for key in checks.LIMITS}
        values = np.concatenate([v for _, v in got["runs"]["hifi"].values()])
        assert values.max() > 255 and (values == 0).any()
        assert want["beds"]["hifi"].count("\n") > 0
    # an assessment of the same read set hands back equal, separate arrays
    for t, (b, v) in held[0]["runs"]["hifi"].items():
        b4, v4 = held[4]["runs"]["hifi"][t]
        np.testing.assert_array_equal(b, b4)
        np.testing.assert_array_equal(v, v4)
        assert not np.shares_memory(v, v4) and not np.shares_memory(b, b4)


# --- the readers ------------------------------------------------------------

K1 = ("(anonymous namespace)::packed_scan_tiles_kernel(int const*, unsigned int const*, long, "
      "int, int, int*, signed char*)")
SUMS = "(anonymous namespace)::tile_sums_kernel(int const*, long, unsigned int*)"
CARRY = "(anonymous namespace)::tile_carry_kernel(unsigned int*, long)"


@pytest.fixture
def registry():
    m = get_metrics()
    m.reset()
    yield m
    m.reset()


def _run(completed=4, trace=True, device_ops=(), read_types=1):
    summary = TraceSummary(window_s=50.0, busy_s=1.0, device_s=1.0, device_events=1,
                           device_ops=[list(op) for op in device_ops])
    return harness.Run(cell={}, config={"chromosomes": {"a": 1_000_000}},
                       mix={"read_types": [{}] * read_types}, device_name="cpu",
                       completed=completed, window_s=50.0, latencies=[1.0] * completed,
                       setup_s=1.0, device_peak_bytes=None, host_peak_bytes=1, spans={},
                       trace=summary if trace else None,
                       peaks={"hbm_bytes_per_s": 3e12})


# reader: (what the registry holds, the value it reads for 4 assessments)
PROGRAM_READERS = {
    "fused.pack_ms": ({"fused.pack": 0.2}, 50.0),
    "fused.readback_ms": ({"fused.readback": 0.06}, 15.0),
    "fused.boundaries_M": ({"fused.boundaries": 6_851_200}, 1.7128),
}


@pytest.mark.parametrize("name", sorted(PROGRAM_READERS))
def test_program_readers(registry, name):
    reader = harness.load_reader(ROOT, name)
    held, want = PROGRAM_READERS[name]
    assert reader.read(_run()) is None  # nothing recorded
    for key, value in held.items():
        if key == "fused.boundaries":
            registry.counters[key] = value
        else:
            registry.spans[key] = [value, value, 4]
    assert reader.read(_run()) == pytest.approx(want, rel=1e-12)
    assert reader.read(_run(trace=False)) is None
    assert reader.read(_run(completed=0)) is None


@pytest.mark.parametrize("read_types", [1, 2])
def test_k1_roofline(read_types):
    """K1's three kernels' time against 9 B a slot; None where any of the
    three is missing from the trace's operations, so that a pass the
    summary dropped never reads as a higher share."""
    reader = harness.load_reader(ROOT, "fused.k1_roofline")
    assert reader.bytes_per_call(10) == 90
    # 1,000,001 slots: 9,000,009 B a call, 3.000003 us at 3e12 B/s; the
    # three kernels take 4, 1.5 and 0.5 us a call, 4 assessments
    ops = [("Memcpy DtoH (Device -> Pageable)", 5.0), (K1, 4 * read_types * 4e-6),
           (SUMS, 4 * read_types * 1.5e-6), (CARRY, 4 * read_types * 0.5e-6),
           ("void at::native::vectorized_elementwise_kernel<4>", 1.0)]
    assert reader.read(_run(device_ops=ops, read_types=read_types)) == pytest.approx(
        100 * 9_000_009 / 3e12 / 6e-6, rel=1e-12)
    for gone in (1, 2, 3):  # the scan, the tile sums, the tile carries
        assert reader.read(_run(device_ops=ops[:gone] + ops[gone + 1:])) is None
    assert reader.read(_run(device_ops=ops, trace=False)) is None
    assert reader.read(_run(device_ops=ops, completed=0)) is None
