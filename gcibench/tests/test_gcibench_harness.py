"""The harness: what it may import, the names in BENCHMARK.json, cells added
as files alone, and runs with the timed path broken that must come out as
not correct.  Run with ``python -m pytest gcibench/tests -q``; the tests
marked ``cuda`` run on a card and skip elsewhere."""
import ast
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import ROOT, make_tree
from gcibench import engine, harness

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def _imports(path: Path) -> set:
    """Top-level names of every module a file imports."""
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.add(node.module.split(".")[0])
    return found


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "gcibench").rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & {"jax", "jaxlib", "flax", "gci_tpu"}, f


def test_reference_imports_nothing_of_the_port():
    for f in sorted((ROOT / "gcibench" / "reference").rglob("*.py")):
        assert not _imports(f) & {"gci_tpu_torch", "gci_tpu", "jax"}, f
        assert _imports(f) <= {"__future__", "math", "numpy"}, f


def test_benchmark_json_names_and_units():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    assert all(NAME.fullmatch(n) for n in names), names
    assert all(UNIT.fullmatch(m["unit"]) for m in bench["end_to_end"] + bench["per_layer"])
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "gcibench" / "metrics" / f"{m['name']}.py").exists()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("gcibench/")
    for w in bench["workloads"]:
        assert (ROOT / "gcibench" / "traffic" / f"{w['traffic']}.json").exists()


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _run(tree, cell, trace=False, seconds=0.5, seed=2**31 + 11):
    return harness.run_cell(tree, cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter())


def test_cells_configs_mixes_and_metrics_are_added_as_files(tree):
    before = _digest(ROOT / "gcibench")
    (tree / "gcibench/metrics/assessments_per_s.py").write_text(
        'UNIT = "1/s"\n\n\ndef read(run):\n    return run.completed / run.window_s\n')
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "assessments_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["tiny1.hifi"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, result = _run(tree, "tiny1.hifi")
    assert rc == 0 and result["correct"], result
    assert result["metrics"]["assessments_per_s"]["value"] > 0
    assert {"assess_Gbp_per_s", "assess_p95_s", "host_peak_GB", "setup_s"} <= result["metrics"].keys()
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert _digest(ROOT / "gcibench") == before


@pytest.mark.parametrize("cell", ["tiny1.hifi", "tiny2.dual"])
def test_traced_run_reports_the_per_layer_metrics(tree, cell):
    rc, result = _run(tree, cell, trace=True)
    assert rc == 0 and result["correct"], result
    names = set(result["metrics"])
    assert {"fused.build_ms", "checkpoint.runs_ms", "reports.issue_bed_ms",
            "score.report_ms"} <= names
    # no card: nothing is read under a device metric
    assert not names & {"device.idle_pct", "depth_kernels_roofline"}
    assert result["device"]["window_s"] > 0 and "breakdown" in result


def test_streamed_cell(tree, streamed):
    rc, result = _run(tree, "tiny2.dual", trace=True)
    assert rc == 0 and result["correct"], result
    assert "streamed.build_ms" in result["metrics"] and "fused.build_ms" not in result["metrics"]


# --- the timed path broken underneath: each fault must make correct false


def _half_the_reads(monkeypatch, module, name):
    real = getattr(module, name)

    def half(layout, tid, start, end, *a, **k):
        keep = np.arange(tid.shape[0]) % 2 == 0
        return real(layout, tid[keep], start[keep], end[keep], *a, **k)

    monkeypatch.setattr(module, name, half)


def _state_unchanged(monkeypatch):
    """Every assessment hands back the first one's outputs."""
    real, first = engine.Assessor.assess, {}

    def stale(self, read_set):
        if "out" not in first:
            first["out"] = real(self, read_set)
        return first["out"]

    monkeypatch.setattr(engine.Assessor, "assess", stale)


def _altered_bed_row(monkeypatch):
    from gci_tpu_torch.reports import writers

    real = writers.write_bed_dict

    def altered(path, intervals):
        intervals = dict(intervals)
        t = next(t for t, v in intervals.items() if v)
        (s, e), *rest = intervals[t]
        intervals[t] = [(s, e + 1), *rest]
        real(path, intervals)

    monkeypatch.setattr(writers, "write_bed_dict", altered)


def _altered_depth(monkeypatch):
    from gci_tpu_torch.depth.eventspace import DepthEvents

    real = DepthEvents._dedup

    def altered(self):
        out = real(self)
        if out.values.shape[0] > 2:
            v = out.values.copy()
            v[1] += 1
            out = DepthEvents(out.boundaries, v, out.length)
        return out

    monkeypatch.setattr(DepthEvents, "_dedup", altered)


def _mask_does_nothing(monkeypatch):
    monkeypatch.setattr(engine, "mask_gaps_in_depths", lambda depths, gaps: depths)


def _int8_depth(monkeypatch):
    """Depths held as int8, saturating at 127."""
    from gci_tpu_torch.depth.eventspace import DepthEvents

    real = DepthEvents._dedup

    def saturated(self):
        out = real(self)
        return real(DepthEvents(out.boundaries, np.minimum(out.values, 127), out.length))

    monkeypatch.setattr(DepthEvents, "_dedup", saturated)


@pytest.mark.parametrize("fault", ["half_reads", "state_unchanged", "bed_row", "depth_value",
                                   "mask_nothing", "int8_depth"])
@pytest.mark.parametrize("path", ["resident", "streamed"])
def test_faults_make_the_run_incorrect(tree, monkeypatch, fault, path):
    from gci_tpu_torch.depth import fused, streamed as streamed_mod

    if path == "streamed":
        from gci_tpu_torch.depth import accum

        monkeypatch.setattr(accum, "stream_slot_limit", lambda device: 0)
        monkeypatch.setattr(streamed_mod, "CHUNK_SLOTS", 50_000)
    if fault == "half_reads":
        if path == "resident":
            _half_the_reads(monkeypatch, fused, "pack_read_deltas")
        else:
            _half_the_reads(monkeypatch, streamed_mod, "_sorted_events")
    elif fault == "state_unchanged":
        _state_unchanged(monkeypatch)
    elif fault == "bed_row":
        _altered_bed_row(monkeypatch)
    elif fault == "depth_value":
        _altered_depth(monkeypatch)
    elif fault == "mask_nothing":
        _mask_does_nothing(monkeypatch)
    else:
        _int8_depth(monkeypatch)
    rc, result = _run(tree, "tiny2.dual", seconds=1.0)
    assert rc == 0
    assert result["correct"] is False, result["checks"]
    assert any(v["value"] > v["limit"] for k, v in result["checks"].items() if "limit" in v)


def test_run_refuses_without_the_chips_it_needs(tmp_path):
    """A nonzero exit and no result line where the checkout holds only
    BENCHMARK.json and the benchmark's folder, and, with no card, anywhere."""
    roots = [make_tree(tmp_path)] + ([] if torch.cuda.is_available() else [ROOT])
    for root in roots:
        r = subprocess.run([sys.executable, str(root / "gcibench/run.py"), "--workload",
                            "chm13v2.hifi58x", "--seed", "1", "--seconds", "1", "--trace", "0"],
                           capture_output=True, text=True, cwd=root, timeout=300)
        assert r.returncode != 0 and r.stdout.strip() == "", r.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny1.hifi", "tiny2.dual"])
def test_tiny_cells_on_the_card(tree, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc, result = harness.run_cell(tree, cell, 2**31 + 21, 2.0, True, torch.device("cuda", 0),
                                  time.perf_counter())
    assert rc == 0 and result["correct"], result
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert 0 < result["metrics"]["depth_kernels_roofline"]["value"] <= 100
