"""Shared set-up of the benchmark's tests: a copy of the benchmark with two
tiny cells added as new files, which the harness finds by name."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIGS = {
    "tiny1": {"chromosomes": {"c1": 200_000, "c2": 150_000, "c3": 90_000},
              "gaps": {"c2": [[1000, 3000], [50_000, 50_100]], "c3": [[89_000, 90_000]]}},
    "tiny2": {"chromosomes": {"c1": 300_000, "c2": 150_017},
              "gaps": {"c1": [[0, 500]]}},
}


def _tiny_mixes(root: Path) -> dict:
    """The cells' mix at a tiny size: short reads, many windows, pile-ups
    past 127 and 255, and the tiny configurations' N runs of up to 1,000 bp
    spanned by reads; and a two-type mix made from it."""
    hifi = json.loads((root / "gcibench/traffic/hifi39x.json").read_text())
    hifi["read_types"][0].update(coverage=10, windows_per_Gbp=2e4, pileups_per_Gbp=1e4,
                                 pileup_bp=[2000, 5000], pileup_depth=[150, 300])
    hifi["read_types"][0]["length"].update(mean=3000, sd=800)
    dual = json.loads(json.dumps(hifi))
    dual["read_types"][0].update(coverage=11)
    dual["read_types"].append(
        {**dual["read_types"][0], "kind": "ont", "coverage": 26,
         "length": {"shape": "lognormal", "mean": 4000, "sd": 2500, "min": 1000}})
    return {"tinyhifi": hifi, "tinydual": dual}


TINY_CELLS = {"tiny1.hifi": ("tiny1", "tinyhifi"), "tiny2.dual": ("tiny2", "tinydual")}
# readers that no cell of BENCHMARK.json lists yet (the resident path's, kept
# for the MH63 cell), listed for the tiny cells
UNLISTED = {
    "end_to_end": [{"name": "assess_p95_s", "unit": "s", "better": "lower", "bound": 0.25,
                    "source": "host_clock"}],
    "per_layer": [{"name": n, "unit": "ms", "better": "lower", "source": "program_span",
                   "layer": n.split(".")[0], "moves": "assess_Gbp_per_s"}
                  for n in ("fused.build_ms", "checkpoint.runs_ms")],
}


def make_tree(dest: Path) -> Path:
    """A copy of BENCHMARK.json and gcibench/ with the tiny cells added."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "gcibench", dest / "gcibench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for name, cfg in TINY_CONFIGS.items():
        (dest / f"gcibench/configs/{name}.json").write_text(json.dumps({"name": name, **cfg}))
        bench["configs"].append({"name": name, "source": "a test", "reduced": [], "why": "a test",
                                 "file": f"gcibench/configs/{name}.json"})
    for name, mix in _tiny_mixes(ROOT).items():
        (dest / f"gcibench/traffic/{name}.json").write_text(json.dumps(mix))
    for cell, (config, mix) in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": config, "traffic": mix,
                                   "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(TINY_CELLS)
    for key, metrics in UNLISTED.items():
        bench[key] += [{**m, "workloads": list(TINY_CELLS)} for m in metrics]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture
def tree(tmp_path):
    return make_tree(tmp_path)


@pytest.fixture
def streamed(monkeypatch):
    """Send every genome down the streamed path, in chunks of 50,000 slots."""
    from gci_tpu_torch.depth import accum, streamed as streamed_mod

    monkeypatch.setattr(accum, "stream_slot_limit", lambda device: 0)
    monkeypatch.setattr(streamed_mod, "CHUNK_SLOTS", 50_000)
