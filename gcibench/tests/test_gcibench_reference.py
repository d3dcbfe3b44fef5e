"""The plain reference against a per-base transcription of GCI.py and against
the port, on tiny layouts on the CPU (the port runs its kernels' plain
versions there), on both depth paths and with one and two read types."""
import numpy as np
import pytest
import torch

from conftest import ROOT, TINY_CELLS, TINY_CONFIGS, _tiny_mixes
from gcibench import checks, control, traffic
from gcibench.engine import Assessor
from gcibench.harness import _plain
from gcibench.reference import gci_ref
from gcibench.spans import Spans


def _per_base_depth(s, e, L):
    d = np.zeros(L, np.int64)
    for a, z in zip(s.tolist(), e.tolist()):
        d[a:z] += 1
    return d


def _runs_of(d):
    b = np.flatnonzero(np.concatenate([[True], d[1:] != d[:-1]]))
    return b, d[b]


def _gci_scan(depth, flank, lo, hi):
    """GCI.py:356-390 as a per-base loop over the scanned slice."""
    out, start, L = [], None, depth.shape[0]
    n = L - 2 * flank
    for i in range(n):
        x = depth[flank + i]
        if lo < x <= hi:
            if start is None:
                start = i
            if i == n - 1:
                out.append((start + flank, i + flank + 1))
        elif start is not None:
            if i > flank:
                out.append((start + flank, i + flank))
            start = None
    return out


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_depth_mask_max_and_issues_match_a_per_base_transcription(seed):
    rng = np.random.default_rng(seed)
    L, flank = 3000, 15
    s = rng.integers(-40, L, 60)
    e = s + rng.integers(0, 400, 60)
    cs, ce = gci_ref.slice_bounds(s, e, flank, L)
    # Python's own slice clamping is the definition
    for a, z, x, y in zip(s.tolist(), e.tolist(), cs.tolist(), ce.tolist()):
        assert range(L)[a + flank:z - flank + 1] == range(x, max(x, y))
    depth = _per_base_depth(cs, ce, L)
    b, v = gci_ref.depth_runs(cs, ce, L)
    np.testing.assert_array_equal(np.repeat(v, np.diff(np.append(b, L))), depth)
    np.testing.assert_array_equal(b, _runs_of(depth)[0])
    np.testing.assert_array_equal(v, _runs_of(depth)[1])

    gaps = [(100, 250), (240, 300), (L - 20, L), (0, 5)]
    masked = depth.copy()
    for a, z in gaps:
        masked[a:z] = 0
    mb, mv = gci_ref.mask_runs(b, v, L, gaps)
    np.testing.assert_array_equal(mb, _runs_of(masked)[0])
    np.testing.assert_array_equal(mv, _runs_of(masked)[1])

    s2 = rng.integers(0, L, 40)
    cs2, ce2 = gci_ref.slice_bounds(s2, s2 + rng.integers(0, 300, 40), flank, L)
    other = _per_base_depth(cs2, ce2, L)
    xb, xv = gci_ref.max_runs(mb, mv, *gci_ref.depth_runs(cs2, ce2, L))
    np.testing.assert_array_equal(xb, _runs_of(np.maximum(masked, other))[0])
    np.testing.assert_array_equal(xv, _runs_of(np.maximum(masked, other))[1])

    for thr in (0, 1, 3):
        starts, ends = gci_ref.issue_intervals(mb, mv, L, flank, thr)
        assert list(zip(starts.tolist(), ends.tolist())) == _gci_scan(masked, flank, -1, thr)


def test_scores_follow_gci_py():
    # N50: the first length, longest first, whose running sum reaches half
    assert gci_ref.n50([5, 3, 2]) == 5 and gci_ref.n50([4, 4, 1, 1]) == 4
    assert gci_ref.n50([]) == 0 and gci_ref.n50([3, 3, 3, 3]) == 3
    assert gci_ref.gci_score(100, 50, 1, 0) == 0
    assert gci_ref.gci_score(1000, 1000, 1, 1) == 100.0
    # issues far apart stay apart; close ones merge; the tail is absorbed
    L, flank = 100_000, 15
    starts, ends = np.array([10_000, 10_300, 60_000]), np.array([10_100, 10_400, 99_900])
    assert gci_ref.contig_count(starts, ends, L, flank, 0.005) == 2
    assert gci_ref.contig_count(starts[:0], ends[:0], L, flank, 0.005) == 1
    np.testing.assert_array_equal(gci_ref.complement_lengths(starts, ends, flank, L - flank),
                                  [10_000 - flank, 200, 60_000 - 10_400, L - flank - 99_900])


def _reads(name, seed):
    cfg = TINY_CONFIGS[name]
    mix = _tiny_mixes(ROOT)["tinyhifi" if name == "tiny1" else "tinydual"]
    return cfg, mix, traffic.make_read_sets(cfg["chromosomes"], cfg["gaps"], mix, seed)


def _engine_against_reference(tmp_path, name, seed):
    cfg, mix, sets = _reads(name, seed)
    eng = Assessor(cfg["chromosomes"], cfg["gaps"], mix, str(tmp_path), torch.device("cpu"),
                   Spans())
    total = {}
    for read_set in sets[:2]:
        got = _plain(eng.assess(read_set))
        want = gci_ref.assess(cfg["chromosomes"], cfg["gaps"], read_set, mix["flank"],
                              mix["threshold"], mix["dist_percent"])
        assert got["runs"].keys() == want["runs"].keys()
        total = checks.add(total, checks.compare(got, want))
        assert want["beds"]["hifi"].count("\n") > 0
    return eng, total


@pytest.mark.parametrize("name", ["tiny1", "tiny2"])
@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_port_resident_path_equals_reference(tmp_path, name, seed):
    eng, total = _engine_against_reference(tmp_path, name, seed)
    assert eng.resident
    assert total == {k: 0 for k in checks.LIMITS}


@pytest.mark.parametrize("name", ["tiny1", "tiny2"])
@pytest.mark.parametrize("seed", [6, 2**33 + 1])
def test_port_streamed_path_equals_reference(tmp_path, streamed, name, seed):
    eng, total = _engine_against_reference(tmp_path, name, seed)
    assert not eng.resident
    assert total == {k: 0 for k in checks.LIMITS}


@pytest.mark.parametrize("cell", list(TINY_CELLS))
@pytest.mark.parametrize("seed", [7, 8, 2**31 + 7])
def test_control_fails(tree, cell, seed):
    """The reference at 2-bp resolution in the program's place fails."""
    numbers = control.control_numbers(tree, cell, seed)
    assert numbers["runs_off"] > 0 and numbers["bed_rows_off"] > 0


def test_read_sets_depend_on_the_seed_alone():
    cfg, mix, a = _reads("tiny2", 2**31 + 3)
    _, _, b = _reads("tiny2", 2**31 + 3)
    _, _, c = _reads("tiny2", 2**31 + 4)
    flat = lambda sets: [x for one in sets for kind in one for x in kind[1:]]
    assert all(np.array_equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not all(np.array_equal(x, y) for x, y in zip(flat(a), flat(c)))
    for kind in a[0]:
        tid, start, end = kind[1:]
        lengths = np.asarray(list(cfg["chromosomes"].values()))
        assert tid.dtype == np.int32 and (start >= 0).all() and (end <= lengths[tid]).all()
