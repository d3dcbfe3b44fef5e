"""Plain NumPy reference of one GCI assessment, computed per chromosome.

The semantics are GCI.py's (yeeus/GCI), written out again here from its
documented behaviour and sharing no code with the program under test:

* depth: every curated alignment adds 1 over the Python slice
  ``depth[start + flank : end - flank + 1]`` of its chromosome (GCI.py:302-306),
  with Python's slice clamping (a negative bound counts from the end, then
  both clamp to ``[0, L]``);
* the N-gap mask zeroes the depth over each gap interval (GCI.py:315-329);
* the two-type merge is the per-base maximum (GCI.py:332-353);
* issue intervals: over the scanned slice ``depth[flank : L - flank]``, the
  maximal runs with ``-1 < depth <= threshold``; a run still open at the
  last scanned base ends at ``L - flank``, a run that closes at scanned
  index ``e`` is kept only where ``e > flank`` (GCI.py:356-390), written as
  ``chrom\\tstart\\tend`` rows (GCI.py:393-419);
* scores: the complement of the issues within ``[flank, L - flank]``, its
  N50, the contigs left after merging issues closer than
  ``L * dist_percent`` (seeded at the window's start, the tail absorbed when
  close), and ``100 * log2(n50 / L + 1) / log2(contigs + 1)`` rounded to 4
  places, with a genome row over all chromosomes (GCI.py:422-657).

A depth is kept as its runs: ``(boundaries, values)`` with
``boundaries[0] == 0``, ascending, each value holding up to the next
boundary (or the chromosome's end), and no two neighbouring values equal.
No per-base array is made, so a 3.1 Gbp genome fits on the host.
"""
from __future__ import annotations

from math import log2

import numpy as np

# the .gci's name of each read type's block
SCORE_LABELS = {"hifi": "HiFi", "ont": "Nano"}
SEPARATOR = "-" * 136 + "\n\n\n"
GCI_HEADER = ("Chromosome\tTheoretical maximum N50\tCurated N50\t"
              "Theoretical minimum contigs number\tCurated contigs number\tGCI score\n")


def slice_bounds(start: np.ndarray, end: np.ndarray, flank: int, length: int):
    """Half-open ``[s, e)`` of ``a[start + flank : end - flank + 1]`` over a
    sequence of ``length`` bases, as Python clamps a slice."""
    s = np.asarray(start, np.int64) + flank
    e = np.asarray(end, np.int64) - flank + 1
    s = np.clip(np.where(s < 0, s + length, s), 0, length)
    e = np.clip(np.where(e < 0, e + length, e), 0, length)
    return s, e


def canonical(b: np.ndarray, v: np.ndarray):
    """Drop each boundary whose value equals the one before it."""
    if v.shape[0] <= 1:
        return b, v
    keep = np.empty(v.shape[0], bool)
    keep[0] = True
    np.not_equal(v[1:], v[:-1], out=keep[1:])
    return b[keep], v[keep]


def depth_runs(s: np.ndarray, e: np.ndarray, length: int):
    """Runs of the count of half-open intervals ``[s, e)`` over
    ``[0, length)``; empty intervals count nowhere."""
    live = e > s
    pos = np.concatenate([np.zeros(1, np.int64), s[live], e[live]])
    step = np.concatenate([np.zeros(1, np.int8), np.ones(int(live.sum()), np.int8),
                           np.full(int(live.sum()), -1, np.int8)])
    order = np.argsort(pos)
    pos = pos[order]
    count = np.cumsum(step[order], dtype=np.int64)
    # the count after the last event at each position holds up to the next
    last = np.append(pos[1:] != pos[:-1], True)
    b, v = pos[last], count[last]
    keep = b < length
    return canonical(b[keep], v[keep])


def value_at(b: np.ndarray, v: np.ndarray, pos: np.ndarray) -> np.ndarray:
    return v[np.searchsorted(b, pos, side="right") - 1]


def mask_runs(b, v, length: int, gaps):
    """Zero the depth over each ``(start, end)`` gap, clamped to the chromosome."""
    if not gaps:
        return b, v
    g = np.asarray(gaps, np.int64).reshape(-1, 2)
    gs = np.clip(g[:, 0], 0, length)
    ge = np.clip(g[:, 1], 0, length)
    live = ge > gs
    gs, ge = gs[live], ge[live]
    if gs.shape[0] == 0:
        return b, v
    pos = np.unique(np.concatenate([b, gs, ge[ge < length]]))
    vals = value_at(b, v, pos)
    # a position lies in a gap when more gaps have opened than closed at it
    opened = np.searchsorted(np.sort(gs), pos, side="right")
    closed = np.searchsorted(np.sort(ge), pos, side="right")
    vals = np.where(opened > closed, 0, vals)
    return canonical(pos, vals)


def max_runs(b1, v1, b2, v2):
    """The per-base maximum of two depths' runs (both begin at 0)."""
    pos = np.concatenate([b1, b2])
    first = np.concatenate([np.ones(b1.shape[0], np.int64), np.zeros(b2.shape[0], np.int64)])
    order = np.argsort(pos, kind="stable")
    pos, first = pos[order], first[order]
    # at each position, the index of the last run of each side begun by then
    i1 = np.cumsum(first) - 1
    i2 = np.cumsum(1 - first) - 1
    last = np.append(pos[1:] != pos[:-1], True)
    return canonical(pos[last], np.maximum(v1[i1[last]], v2[i2[last]]))


def coarsen_runs(b, v, length: int, bin_bp: int):
    """The depth sampled once every ``bin_bp`` bases and held over the bin:
    the control's loss of base resolution."""
    pos = np.unique(-(-b // bin_bp) * bin_bp)
    pos = pos[pos < length]
    return canonical(pos, value_at(b, v, pos))


def issue_intervals(b, v, length: int, flank: int, threshold: int):
    """GCI.py's issue intervals of a depth at ``threshold`` as (starts, ends)."""
    n_scan = length - 2 * flank
    empty = np.empty(0, np.int64)
    if n_scan <= 0:
        return empty, empty
    # runs cut to the scanned slice, in slice coordinates
    nxt = np.append(b[1:], length)
    lo = np.maximum(b, flank) - flank
    hi = np.minimum(nxt, length - flank) - flank
    sel = hi > lo
    lo, hi, low = lo[sel], hi[sel], (v[sel] > -1) & (v[sel] <= threshold)
    if not low.any():
        return empty, empty
    # merge neighbouring low runs: a low run starts where the previous is not low
    prev_low = np.concatenate([[False], low[:-1]])
    next_low = np.concatenate([low[1:], [False]])
    starts = lo[low & ~prev_low]
    ends = hi[low & ~next_low]
    open_end = ends >= n_scan
    keep = open_end | (ends > flank)
    starts, ends = starts[keep] + flank, np.where(open_end[keep], n_scan, ends[keep]) + flank
    return starts.astype(np.int64), ends.astype(np.int64)


def complement_lengths(starts, ends, lo: int, hi: int) -> np.ndarray:
    """Positive lengths between sorted disjoint intervals inside ``[lo, hi]``."""
    left = np.concatenate([[lo], ends]).astype(np.int64)
    right = np.concatenate([starts, [hi]]).astype(np.int64)
    d = right - left
    return d[d > 0]


def n50(lengths) -> int:
    x = np.sort(np.asarray(lengths, np.int64))[::-1]
    if x.shape[0] == 0:
        return 0
    reached = 2 * np.cumsum(x) >= int(x.sum())
    return int(x[int(np.argmax(reached))])


def contig_count(starts, ends, length: int, flank: int, dist_percent: float) -> int:
    """Contigs left once issues closer than ``length * dist_percent`` merge."""
    lo, hi = flank, length - flank
    dist = length * dist_percent
    if starts.shape[0] == 0:
        return int(complement_lengths(starts, ends, lo, hi).shape[0])
    prev_end = np.concatenate([[lo], ends[:-1]])
    # a new merged block begins where an issue lies farther than dist from
    # the one before it; the first block is seeded at (lo, lo)
    new = (starts - prev_end) > dist
    blk_s = np.concatenate([[lo], starts[new]])
    last = np.concatenate([np.flatnonzero(new) - 1, [starts.shape[0] - 1]])
    blk_e = np.where(last >= 0, ends[np.clip(last, 0, None)], lo)
    if hi - blk_e[-1] <= dist:
        blk_e[-1] = hi
    return int(complement_lengths(blk_s, blk_e, lo, hi).shape[0])


def gci_score(exp_n50: int, obs_n50: int, exp_ctg: int, obs_ctg: int):
    if obs_ctg == 0:
        return 0
    return round(100 * log2(obs_n50 / exp_n50 + 1) / log2(obs_ctg / exp_ctg + 1), 4)


def bed_text(names, issues) -> str:
    rows = []
    for name in names:
        s, e = issues[name]
        rows.extend(f"{name}\t{a}\t{z}\n" for a, z in zip(s.tolist(), e.tolist()))
    return "".join(rows)


def gci_text(lengths: dict, issues_by_type: list, labels: list, flank: int,
             dist_percent: float) -> str:
    names = list(lengths)
    exp_n50 = {n: lengths[n] for n in names}
    exp_n50["Genome"] = n50(list(lengths.values()))
    exp_ctg = {n: 1 for n in names}
    exp_ctg["Genome"] = len(names)
    out = []
    for label, issues in zip(labels, issues_by_type):
        comp = {n: complement_lengths(*issues[n], flank, lengths[n] - flank) for n in names}
        obs_n50 = {n: n50(comp[n]) for n in names}
        obs_n50["Genome"] = n50(np.concatenate([comp[n] for n in names]))
        obs_ctg = {n: contig_count(*issues[n], lengths[n], flank, dist_percent)
                   for n in names}
        obs_ctg["Genome"] = sum(obs_ctg[n] for n in names)
        out.append(f"{label}:\n{GCI_HEADER}")
        for n in names + ["Genome"]:
            score = gci_score(exp_n50[n], obs_n50[n], exp_ctg[n], obs_ctg[n])
            out.append(f"{n}\t{exp_n50[n]}\t{obs_n50[n]}\t{exp_ctg[n]}\t{obs_ctg[n]}\t{score}\n")
        out.append(SEPARATOR)
    return "".join(out)


def assess(lengths: dict, gaps: dict, read_types: list, flank: int, threshold: int,
           dist_percent: float = 0.005, bin_bp: int = 1) -> dict:
    """Every output of one assessment.

    ``read_types``: ``[(kind, tid, start, end), ...]``, one or two read
    types (kind ``hifi`` or ``ont``; HiFi first), ``tid`` indexing
    ``lengths`` in its order.  Returns ``runs``
    (``{depth label: {chrom: (b, v)}}``: each read type's depth before the
    gap mask, as its checkpoint holds it, and ``two_type``, the maximum of
    the masked depths, for two types), ``beds`` (``{depth label: text}``)
    and ``gci`` (text).  ``bin_bp`` > 1 is the control: depth sampled once
    every ``bin_bp`` bases.
    """
    names = list(lengths)
    runs, masked = {}, {}
    for label, tid, start, end in read_types:
        # chromosome indices fit int16, whose stable sort is a radix sort
        tid = np.asarray(tid).astype(np.int16)
        order = np.argsort(tid, kind="stable")
        cut = np.searchsorted(tid[order], np.arange(len(names) + 1))
        runs[label], masked[label] = {}, {}
        for k, name in enumerate(names):
            rows = order[cut[k]:cut[k + 1]]
            L = int(lengths[name])
            s, e = slice_bounds(start[rows], end[rows], flank, L)
            bv = depth_runs(s, e, L)
            if bin_bp > 1:
                bv = coarsen_runs(*bv, L, bin_bp)
            runs[label][name] = bv
            masked[label][name] = mask_runs(*bv, L, gaps.get(name))
    labels = [t[0] for t in read_types]
    if len(labels) == 2:
        a, z = labels
        runs["two_type"] = {n: max_runs(*masked[a][n], *masked[z][n]) for n in names}
        masked["two_type"] = {n: mask_runs(*runs["two_type"][n], int(lengths[n]), gaps.get(n))
                              for n in names}
    issues = {lab: {n: issue_intervals(*masked[lab][n], int(lengths[n]), flank, threshold)
                    for n in names} for lab in masked}
    beds = {lab: bed_text(names, issues[lab]) for lab in issues}
    score_labels = [SCORE_LABELS[k] for k in labels] + (["HiFi + Nano"] if len(labels) == 2 else [])
    gci = gci_text({n: int(lengths[n]) for n in names}, [issues[lab] for lab in issues],
                   score_labels, flank, dist_percent)
    return {"runs": runs, "beds": beds, "gci": gci}
