"""BED interval file readers/writers (reference formats).

* issue/gaps BED: ``target\\tstart\\tend`` rows in dict order
  (GCI.py:40-43, 414-417).
* regions BED reader: GCI.py:902-910 (three tab fields, grouped per target in
  file order).
"""
from __future__ import annotations


def read_bed_dict(path: str) -> dict[str, list[tuple[int, int]]]:
    """Read a 3-column BED into {target: [(start, end), ...]} (GCI.py:902-910)."""
    out: dict[str, list[tuple[int, int]]] = {}
    with open(path, "r") as f:
        for line in f:
            target, start, end = line.strip().split("\t")
            out.setdefault(target, []).append((int(start), int(end)))
    return out


def write_bed_dict(path: str, intervals: dict[str, list[tuple[int, int]]]) -> None:
    """Write {target: [(start, end), ...]} as BED rows (GCI.py:414-417)."""
    with open(path, "w") as f:
        for target, segments in intervals.items():
            for start, end in segments:
                f.write(f"{target}\t{start}\t{end}\n")
