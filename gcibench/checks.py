"""The comparison that decides ``correct``: the program's outputs against the reference's.

Every number is a count of differences, and every limit is 0: the depth
is an integer count and the outputs are text, so an exact comparison is
the only one (GCI.py's outputs are compared byte for byte upstream too).

* ``runs_off``: run boundaries, each with its depth, found on one side
  only, over every checkpoint's runs (each read type's depth, and the
  two-type maximum), per chromosome;
* ``bed_rows_off``: issue-BED rows found on one side only, over every BED;
* ``gci_lines_off``: lines of the ``.gci`` found on one side only.
"""
from __future__ import annotations

from collections import Counter

import numpy as np

LIMITS = {"runs_off": 0, "bed_rows_off": 0, "gci_lines_off": 0}


def _pairs_off(b1, v1, b2, v2) -> int:
    if np.array_equal(b1, b2) and np.array_equal(v1, v2):
        return 0
    rows = np.concatenate([np.stack([b1, v1], 1), np.stack([b2, v2], 1)]).astype(np.int64)
    _, counts = np.unique(rows, axis=0, return_counts=True)
    return int((counts == 1).sum())


def _lines_off(got: str, want: str) -> int:
    a, z = Counter(got.splitlines()), Counter(want.splitlines())
    return sum(((a - z) + (z - a)).values())


def compare(got: dict, want: dict) -> dict:
    """Counts of differences between one assessment's outputs as the program
    wrote them (``got``: ``runs`` of ``(boundaries, values)`` per depth and
    chromosome, ``beds`` and ``gci`` as text) and the reference's."""
    runs = 0
    for key in want["runs"].keys() | got["runs"].keys():
        g, w = got["runs"].get(key, {}), want["runs"].get(key, {})
        for name in g.keys() | w.keys():
            empty = (np.empty(0, np.int64), np.empty(0, np.int64))
            runs += _pairs_off(*g.get(name, empty), *w.get(name, empty))
    beds = sum(_lines_off(got["beds"].get(k, ""), want["beds"].get(k, ""))
               for k in want["beds"].keys() | got["beds"].keys())
    return {"runs_off": runs, "bed_rows_off": beds,
            "gci_lines_off": _lines_off(got["gci"], want["gci"])}


def add(total: dict, one: dict) -> dict:
    return {k: total.get(k, 0) + one[k] for k in one}
