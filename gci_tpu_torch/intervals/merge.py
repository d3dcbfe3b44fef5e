"""Interval distance-merge and complement (host-side; interval lists are tiny).

Behavioral contracts:

* ``distance_merge`` — reference GCI.py:483-519 ``merge_merged_depth_bed``:
  adjacent intervals closer than ``length * dist_percent`` are merged.  The
  scan is seeded with the degenerate interval ``(start, start)`` so a leading
  issue near the chromosome start merges into the edge, and the tail gap to
  ``end`` is absorbed when within distance.  The seed interval itself is
  emitted when nothing merges into it (observable in outputs).

* ``complement_intervals`` — reference GCI.py:422-462
  ``complement_merged_depth``: lengths of the gaps between intervals within
  ``[start, end]``; strictly positive gaps only; when the interval list is
  empty the single length ``end - start`` is returned.
"""
from __future__ import annotations


def distance_merge(
    intervals: list[tuple[int, int]],
    length: int,
    dist_percent: float = 0.005,
    flank_len: int = 15,
    start: int | None = None,
    end: int | None = None,
) -> list[tuple[int, int]]:
    """Merge adjacent intervals separated by <= length*dist_percent.

    GCI.py:483-519.  ``start``/``end`` override the default
    ``[flank_len, length - flank_len]`` window (used for regions).
    """
    if start is None or end is None:
        start = flank_len
        end = length - flank_len
    dist = length * dist_percent
    out: list[tuple[int, int]] = []
    cur = (start, start)
    for seg in intervals:
        if (seg[0] - cur[1]) <= dist:
            cur = (cur[0], seg[1])
        else:
            out.append(cur)
            cur = seg
    if (end - cur[1]) <= dist:
        cur = (cur[0], end)
    out.append(cur)
    return out


def distance_merge_dict(
    intervals_dict: dict[str, list[tuple[int, int]]],
    targets_length: dict[str, int],
    dist_percent: float = 0.005,
    flank_len: int = 15,
    start: int | None = None,
    end: int | None = None,
) -> dict[str, list[tuple[int, int]]]:
    return {
        target: distance_merge(
            intervals_dict[target], length, dist_percent, flank_len, start, end
        )
        for target, length in targets_length.items()
    }


def complement_intervals(
    intervals: list[tuple[int, int]],
    length: int,
    flank_len: int = 15,
    start: int | None = None,
    end: int | None = None,
) -> list[int]:
    """Lengths of the complement of ``intervals`` within [start, end].

    GCI.py:422-462.  Only strictly positive gaps are kept; an empty interval
    list yields ``[end - start]``.
    """
    if start is None or end is None:
        start = flank_len
        end = length - flank_len
    out: list[int] = []
    n = len(intervals)
    if n == 0:
        out.append(end - start)
        return out
    last = start
    for i, seg in enumerate(intervals):
        if seg[0] > last:
            out.append(seg[0] - last)
        if i != n - 1:
            last = seg[1]
        else:
            if end > seg[1]:
                out.append(end - seg[1])
    return out


def complement_dict(
    intervals_dict: dict[str, list[tuple[int, int]]],
    targets_length: dict[str, int],
    flank_len: int = 15,
    start: int | None = None,
    end: int | None = None,
) -> dict[str, list[int]]:
    return {
        target: complement_intervals(
            intervals_dict[target], length, flank_len, start, end
        )
        for target, length in targets_length.items()
    }
