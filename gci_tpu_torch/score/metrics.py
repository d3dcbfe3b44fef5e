"""Continuity scoring primitives.

* ``compute_n50`` — reference GCI.py:465-480: sort descending, first length
  whose cumulative sum reaches half the total; 0 for an empty list.
* ``gci_score`` — reference GCI.py:601-604:
  ``100 * log2(obs_n50/exp_n50 + 1) / log2(obs_ctgs/exp_ctgs + 1)`` rounded to
  4 decimals; the integer 0 when ``obs_ctgs == 0`` (notably the reference
  emits ``0`` not ``0.0`` in that case, which matters for byte-parity).
"""
from __future__ import annotations

from math import log2


def compute_n50(lengths) -> int:
    """N50 of a list of lengths (GCI.py:465-480). Empty input -> 0."""
    lengths = sorted(lengths, reverse=True)
    if not lengths:
        return 0
    total = sum(lengths)
    half = total / 2
    cum = 0
    for length in lengths:
        cum += length
        if cum >= half:
            return length
    return 0


def gci_score(exp_n50: int, obs_n50: int, exp_num_ctg: int, obs_num_ctg: int):
    """GCI continuity score (GCI.py:601-604), with reference rounding/typing."""
    if obs_num_ctg == 0:
        return 0
    return round(100 * log2(obs_n50 / exp_n50 + 1) / log2(obs_num_ctg / exp_num_ctg + 1), 4)
