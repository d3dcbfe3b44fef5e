"""The port's event-space collapse (``gci_tpu_torch.depth.eventspace.
DepthEvents.collapse``) against ``gci_tpu``'s per-base collapse.

``DepthEvents.from_array(a).collapse(lo, hi, flank, start_pos)`` must equal
``collapse_depth_runs(a, lo, hi, flank, start_pos)`` (GCI.py:356-390, every
edge quirk included) on hand-made edge cases, each its own test case, and on
random depths.  The run arrays are read-only: the collapse may not write them,
since on the device backends they are views of the chunks' run form.
"""
import numpy as np
import pytest

from gci_tpu.intervals import collapse_depth_runs
from gci_tpu_torch.depth.eventspace import DepthEvents

L = 400


def _with(base, *runs):
    """A depth of ``L`` slots at ``base``, with ``(start, stop, value)`` runs."""
    a = np.full(L, base, np.int64)
    for s, e, v in runs:
        a[s:e] = v
    return a


# name -> (depth, leftmost, rightmost)
CASES = {
    "zero_at_slot_0": (_with(7, (0, 40, 0)), -1, 0),
    "zero_inside_left_flank": (_with(7, (2, 9, 0)), -1, 0),
    "zero_ending_at_flank": (_with(7, (5, 30, 0)), -1, 0),
    "zero_ending_before_flank": (_with(7, (0, 22, 0)), -1, 0),
    "zero_crossing_flank": (_with(7, (10, 60, 0)), -1, 0),
    "open_at_last_scanned_slot": (_with(7, (300, L, 0)), -1, 0),
    "open_ending_at_right_flank": (_with(7, (300, L - 15, 0)), -1, 0),
    "wholly_inside_right_flank": (_with(7, (L - 12, L - 3, 0)), -1, 0),
    "right_flank_and_last_slot": (_with(7, (L - 12, L, 0)), -1, 0),
    "adjacent_values_in_range": (
        _with(9, (100, 110, 3), (110, 130, 4), (130, 131, 0), (131, 170, 5), (200, 240, 2)),
        -1, 5),
    "adjacent_across_both_flanks": (_with(9, (0, 50, 1), (50, 350, 2), (350, L, 3)), -1, 5),
    "float_rightmost": (_with(6, (50, 80, 2), (80, 90, 3), (120, 160, 1)), -1, 2.5),
    "float_band": (_with(6, (50, 80, 2), (80, 90, 3), (120, 160, 0)), 0.5, 3.2),
    "no_candidates": (_with(5, (100, 200, 8)), -1, 0),
    "empty_band": (_with(5, (100, 200, 0)), 2, 1),
    "dense_every_run_in_range": (np.arange(L, dtype=np.int64) % 7, -1, 100),
    "alternating_in_and_out": (np.arange(L, dtype=np.int64) % 2, -1, 0),
    "single_slot_runs": (_with(4, (20, 21, 0), (40, 41, 0), (41, 42, 1), (L - 16, L - 15, 0)), -1, 0),
    "all_zero": (np.zeros(L, np.int64), -1, 0),
}


def _check(a, lo, hi, flank, start_pos):
    ev = DepthEvents.from_array(a)
    ev.boundaries.setflags(write=False)
    ev.values.setflags(write=False)
    got = ev.collapse(lo, hi, flank, start_pos)
    assert got == collapse_depth_runs(a, lo, hi, flank, start_pos)
    return got


@pytest.mark.parametrize("start_pos", [0, 1234])
@pytest.mark.parametrize("flank", [0, 15])
@pytest.mark.parametrize("name", list(CASES))
def test_collapse_edge_cases(name, flank, start_pos):
    a, lo, hi = CASES[name]
    _check(a, lo, hi, flank, start_pos)


@pytest.mark.parametrize("length", [0, 1, 20, 29, 30, 31])
def test_collapse_short_targets(length):
    """``L <= 2 * flank`` yields nothing; just past it, one scanned slot."""
    a = np.zeros(length, np.int64)
    got = _check(a, -1, 0, 15, 0)
    assert (got == []) == (length <= 30)


@pytest.mark.parametrize("seed", range(24))
def test_collapse_random_depths(seed):
    """Random piecewise depths over short and long targets, at zero, low and
    float bands, with and without flanks and an offset."""
    rng = np.random.default_rng(seed)
    for _ in range(8):
        n = int(rng.integers(1, 600))
        cuts = np.sort(rng.choice(np.arange(1, n + 1), int(rng.integers(0, 30))))
        a = np.repeat(rng.integers(0, 6, cuts.shape[0] + 1),
                      np.diff(np.concatenate([[0], cuts, [n]])))
        for lo, hi in ((-1, 0), (-1, 2), (0, 3), (-1, 1.5), (0.5, 4.7), (-1, 10)):
            for flank in (0, 3, 15):
                _check(a, lo, hi, flank, int(rng.integers(0, 5000)))
