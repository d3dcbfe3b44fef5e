"""The one traffic generator: curated read sets from a mix's parameters and a seed.

A mix (``traffic/<name>.json``) names its read types, HiFi before ONT, and
for each its depth of coverage, its length distribution, its planted
zero-coverage windows and its pile-ups.  Per read type the generator draws,
from the seed, what every read set of a run shares (the assembly's own
features):

* issue windows: ``windows_per_Gbp`` per Gbp of the genome, lengths uniform
  in ``window_bp``, starts uniform in their chromosome;
* pile-ups, as over a collapsed repeat: ``pileups_per_Gbp`` per Gbp (at
  least one), lengths uniform in ``pileup_bp``, starts uniform, and extra
  depths spread evenly from the first to the last of ``pileup_depth``, so
  that the highest always comes;

and per read set:

* ``round(coverage * genome_bp / mean)`` alignments: the chromosome in
  proportion to its length, the length from the distribution (``normal``:
  mean and sd; ``lognormal``: of that mean and sd), the start uniform so
  that every base is covered alike, clipped at the chromosome's ends;
* over each pile-up of extra depth ``d`` and length ``P``,
  ``round(d * (P + mean) / mean)`` more alignments, starts uniform so that
  the depth inside rises by ``d``, clipped to the pile-up.

An alignment that overlaps a window, or an N run of the configuration
longer than the mix's ``spanned_gap_bp``, is cut back to end at it, or to
start after it, as an aligner's clipped alignments would; one inside it is
dropped.  Alignments run through shorter N runs, as long reads do, so that
the gap mask has depth to zero there.

A read set is what curation hands the depth stage: ``(target_id int32,
start int64, end int64)`` in chromosome coordinates, in no order.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

# set-up's threads: numpy releases the GIL in its large array operations
THREADS = 4


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), *stream]))


def read_count(kind: dict, genome_bp: int) -> int:
    return int(round(kind["coverage"] * genome_bp / kind["length"]["mean"]))


def _lengths(rng, dist: dict, n: int) -> np.ndarray:
    mean, sd = float(dist["mean"]), float(dist["sd"])
    if dist["shape"] == "normal":
        x = rng.normal(mean, sd, n)
    elif dist["shape"] == "lognormal":
        sigma2 = np.log1p((sd / mean) ** 2)
        x = rng.lognormal(np.log(mean) - sigma2 / 2, np.sqrt(sigma2), n)
    else:
        raise ValueError(f"unknown length shape {dist['shape']!r}")
    return np.maximum(x, dist["min"]).astype(np.int64)


def _stretches(rng, lengths: np.ndarray, n: int, size_range):
    """``n`` stretches of lengths uniform in ``size_range``: (tid, start, size)."""
    genome = int(lengths.sum())
    lo, hi = size_range
    tid = np.searchsorted(np.cumsum(lengths), rng.random(n) * genome, side="right")
    size = np.minimum(rng.integers(lo, hi + 1, n), lengths[tid])
    start = (rng.random(n) * (lengths[tid] - size + 1)).astype(np.int64)
    return tid, start, size


def _features(rng, lengths: np.ndarray, offsets: np.ndarray, kind: dict, gaps_global):
    """The windows, merged with the N runs that cut reads, as sorted disjoint
    global (starts, ends); the pile-ups as (tid, start, size, extra depth)."""
    genome = int(lengths.sum())
    n = int(round(kind["windows_per_Gbp"] * genome / 1e9))
    tid, start, size = _stretches(rng, lengths, n, kind["window_bp"])
    ws = np.concatenate([offsets[tid] + start, gaps_global[0]])
    we = np.concatenate([offsets[tid] + start + size, gaps_global[1]])
    n_pile = max(1, int(round(kind["pileups_per_Gbp"] * genome / 1e9)))
    piles = _stretches(rng, lengths, n_pile, kind["pileup_bp"])
    depth = np.rint(np.linspace(*kind["pileup_depth"], n_pile) if n_pile > 1
                    else [kind["pileup_depth"][-1]]).astype(np.int64)
    return _disjoint(ws, we), (*piles, depth)


def _disjoint(ws, we):
    """Sorted disjoint (starts, ends) covering the union of the intervals."""
    order = np.argsort(ws, kind="stable")
    ws, we = ws[order], we[order]
    if ws.shape[0] == 0:
        return ws, we
    reach = np.maximum.accumulate(we)
    new = np.concatenate([[True], ws[1:] > reach[:-1]])
    last = np.concatenate([np.flatnonzero(new)[1:] - 1, [ws.shape[0] - 1]])
    return ws[new], reach[last]


def _clip(gs, ge, ws, we):
    """Cut each global [gs, ge) out of the windows; returns the kept rows' bounds."""
    if ws.shape[0] == 0:
        return gs, ge, ge > gs
    j = np.minimum(np.searchsorted(we, gs, side="right"), ws.shape[0] - 1)
    hit = (we[j] > gs) & (ws[j] < ge)
    before = hit & (gs < ws[j])
    ge = np.where(before, ws[j], ge)
    inside = hit & ~before
    gs = np.where(inside, we[j], gs)
    # a read that started inside a window may reach the next one
    k = np.minimum(j + 1, ws.shape[0] - 1)
    ge = np.where(inside & (k > j) & (ws[k] < ge), ws[k], ge)
    return gs, ge, ge > gs


def _read_set(seed: int, r: int, t: int, kind: dict, L, offsets, cum, features):
    rng = _rng(seed, 1 + r, t)
    windows, (p_tid, p_start, p_size, p_depth) = features
    genome = int(L.sum())
    n = read_count(kind, genome)
    tid = np.searchsorted(cum, rng.random(n) * genome, side="right").astype(np.int32)
    size = _lengths(rng, kind["length"], n)
    raw = (rng.random(n) * (L[tid] + size)).astype(np.int64) - size
    start = np.maximum(raw, 0)
    end = np.minimum(raw + size, L[tid])
    # the pile-ups' alignments, clipped to their pile-up
    mean = kind["length"]["mean"]
    counts = np.rint(p_depth * (p_size + mean) / mean).astype(np.int64)
    pile = np.repeat(np.arange(p_tid.shape[0]), counts)
    p_len = _lengths(rng, kind["length"], pile.shape[0])
    p_raw = p_start[pile] + (rng.random(pile.shape[0]) * (p_size[pile] + p_len)).astype(np.int64) - p_len
    tid = np.concatenate([tid, p_tid[pile].astype(np.int32)])
    start = np.concatenate([start, np.maximum(p_raw, p_start[pile])])
    end = np.concatenate([end, np.minimum(p_raw + p_len, p_start[pile] + p_size[pile])])
    gs, ge, keep = _clip(offsets[tid] + start, offsets[tid] + end, *windows)
    tid = tid[keep]
    base = offsets[tid]
    return kind["kind"], tid, gs[keep] - base, ge[keep] - base


def make_read_sets(lengths: dict, gaps: dict, mix: dict, seed: int) -> list:
    """``[[(kind, tid, start, end) for each read type] for each read set]``.

    Each read set and type draws from its own stream of the seed, so the
    ``THREADS`` that make them in parallel cannot change what they make."""
    names = list(lengths)
    L = np.asarray([lengths[n] for n in names], np.int64)
    offsets = np.concatenate([[0], np.cumsum(L + 1)[:-1]])
    index = {n: k for k, n in enumerate(names)}
    g = [(offsets[index[t]] + s, offsets[index[t]] + e)
         for t, segs in gaps.items() for s, e in segs if e - s > mix["spanned_gap_bp"]]
    gaps_global = (np.asarray([a for a, _ in g], np.int64), np.asarray([z for _, z in g], np.int64))
    cum = np.cumsum(L)
    kinds = mix["read_types"]
    features = [_features(_rng(seed, 0, t), L, offsets, kind, gaps_global)
                for t, kind in enumerate(kinds)]
    jobs = [(r, t) for r in range(mix["read_sets"]) for t in range(len(kinds))]
    with ThreadPoolExecutor(max_workers=THREADS) as pool:
        futures = {job: pool.submit(_read_set, seed, *job, kinds[job[1]], L, offsets, cum,
                                    features[job[1]]) for job in jobs}
        made = {job: f.result() for job, f in futures.items()}
    return [[made[(r, t)] for t in range(len(kinds))] for r in range(mix["read_sets"])]
