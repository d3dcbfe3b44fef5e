"""PAF primary-target election — fully vectorized (segment-sort + segmented
reductions; no per-read Python loop).

Behavioral contract (reference GCI.py:213-254): alignments that pass the
mapq/identity mask are grouped per (query, target); for each query the
primary target maximizes ``average_identity * align_rate`` where

* align_rate = (union length of merged query-coordinate blocks) / query_length
  with query_length taken from the group's *first-inserted* alignment;
* average_identity = plain insertion-order ``sum/len`` of per-block
  identities (sequential float64 summation order preserved for bit parity —
  via the native ``seg_sum_f64``, since numpy's pairwise summation differs
  in the last ULP);
* ties break toward the lexicographically *larger* target name
  (``sorted(..., key=(score, name), reverse=True)[0]``);
* the elected extent is the longest merged target-coordinate block (first
  one, in ascending-start order, on ties).

The accumulator is cumulative across PAF files: after file *i* the election
re-runs for every query seen in files 0..i (GCI.py:215, 241) — a documented
reference quirk that cross-file curation observes, reproduced here.

All reductions are O(n log n) sorts + O(n) segmented sweeps: interval
union-merge is a per-group running max (segmented cummax via a rank-offset
trick), block extraction is boundary detection, and the per-query argmax is
one lexsort keyed by (query, score, target-rank).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gci_tpu_torch.io.paf import PafData


@dataclass
class ElectedTargets:
    """Election result as columns, ordered by query first appearance."""

    name_keys: np.ndarray  # (m, 2) uint64 query-name keys
    tid: np.ndarray  # (m,) int32 into target_names
    target_names: list[str]
    start: np.ndarray  # (m,) int64 elected extent lo
    end: np.ndarray  # (m,) int64 elected extent hi
    qlen: np.ndarray  # (m,) int64 primary group's first-inserted qlen


def _seg_sum_sequential(values: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Left-to-right segmented float64 sums (bit-equal to Python ``sum``)."""
    try:
        from gci_tpu_torch.native import seg_sum_f64_native

        return seg_sum_f64_native(values, starts)
    except (ImportError, OSError):
        bounds = np.append(starts, values.shape[0])
        out = np.empty(starts.shape[0], dtype=np.float64)
        for k in range(starts.shape[0]):
            acc = 0.0
            for v in values[bounds[k] : bounds[k + 1]].tolist():
                acc += v
            out[k] = acc
        return out


def _segmented_union(g_rank: np.ndarray, s: np.ndarray, e: np.ndarray):
    """Union-merge intervals per group (touching merge, GCI.py:83-93).

    ``g_rank`` is a dense group id.  Returns
    (per-group union length, block lo, block hi, block group, per-group
    first-block index) with blocks in ascending-lo order within each group.
    """
    n = g_rank.shape[0]
    # sort by (group, start): end-order within equal starts doesn't change
    # the union result.  One composite int64 argsort beats a 2-key lexsort
    # ~4x; fall back to lexsort only if the composite would overflow.
    smax = np.int64(int(s.max()) + 1) if n else np.int64(1)
    gmax_v = int(g_rank.max()) + 1 if n else 1
    if int(s.min() if n else 0) >= 0 and gmax_v * int(smax) < (1 << 62):
        order = np.argsort(g_rank * smax + s, kind="stable")
    else:
        order = np.lexsort((s, g_rank))
    gs, ss, es = g_rank[order], s[order], e[order]
    seg_start = np.empty(n, dtype=bool)
    seg_start[0] = True
    seg_start[1:] = gs[1:] != gs[:-1]
    # segmented inclusive running max of interval ends: offset each group
    # into its own disjoint value range so one global cummax never leaks
    # across the boundary
    big = np.int64(int(es.max()) + 1) if n else np.int64(1)
    cmax = np.maximum.accumulate(gs.astype(np.int64) * big + es) - gs * big
    prev = np.empty(n, dtype=np.int64)
    prev[0] = 0
    prev[1:] = cmax[:-1]
    new_block = seg_start | (ss > prev)
    blk_rows = np.flatnonzero(new_block)
    blk_lo = ss[blk_rows]
    blk_end_rows = np.append(blk_rows[1:] - 1, n - 1)
    blk_hi = cmax[blk_end_rows]
    blk_g = gs[blk_rows]
    nb = blk_rows.shape[0]
    gstart = np.empty(nb, dtype=bool)
    gstart[0] = True
    gstart[1:] = blk_g[1:] != blk_g[:-1]
    gstarts = np.flatnonzero(gstart)
    union_len = np.add.reduceat(blk_hi - blk_lo, gstarts)
    return union_len, blk_lo, blk_hi, blk_g, gstarts


def _elect_concat(
    name_keys: np.ndarray,
    tid: np.ndarray,
    qlen: np.ndarray,
    qs: np.ndarray,
    qe: np.ndarray,
    ts: np.ndarray,
    te: np.ndarray,
    identity: np.ndarray,
    target_names: list[str],
) -> ElectedTargets:
    """One election over candidate rows (insertion order = row order)."""
    n = name_keys.shape[0]
    if n == 0:
        return ElectedTargets(
            name_keys=np.empty((0, 2), dtype=np.uint64),
            tid=np.empty(0, dtype=np.int32),
            target_names=target_names,
            start=np.empty(0, dtype=np.int64),
            end=np.empty(0, dtype=np.int64),
            qlen=np.empty(0, dtype=np.int64),
        )
    nt = len(target_names)
    # lexicographic rank of each target name (tie-break comparator)
    target_rank = np.empty(nt, dtype=np.int64)
    target_rank[
        sorted(range(nt), key=lambda k: target_names[k])
    ] = np.arange(nt)

    # query ids in first-appearance order (the reference dict's iteration
    # order, which downstream curation inherits).  Grouping runs on the two
    # uint64 hash halves via lexsort — ~4x faster than np.unique's memcmp
    # sort over the structured 128-bit view.
    ka = np.ascontiguousarray(name_keys[:, 0])
    kb = np.ascontiguousarray(name_keys[:, 1])
    korder = np.argsort(ka, kind="stable")
    sa, sb = ka[korder], kb[korder]
    # ka is a 64-bit hash: distinct queries collide in ka with probability
    # ~n^2/2^64.  If it ever happens the cheap single-key sort cannot group
    # by (ka, kb) — detect and redo with the exact 2-key lexsort.
    if bool(np.any((sa[1:] == sa[:-1]) & (sb[1:] != sb[:-1]))):
        korder = np.lexsort((kb, ka))
        sa, sb = ka[korder], kb[korder]
    knew = np.empty(n, dtype=bool)
    knew[0] = True
    knew[1:] = (sa[1:] != sa[:-1]) | (sb[1:] != sb[:-1])
    kruns = np.flatnonzero(knew)
    # lexsort is stable, so each run's first row holds the smallest original
    # index == the query's first appearance
    first_idx = korder[kruns]
    qinv_sorted = np.cumsum(knew) - 1
    qinv = np.empty(n, dtype=np.int64)
    qinv[korder] = qinv_sorted
    app = np.argsort(first_idx, kind="stable")
    app_rank = np.empty(app.shape[0], dtype=np.int64)
    app_rank[app] = np.arange(app.shape[0])
    qid = app_rank[qinv]
    nq = app.shape[0]

    # (query, target) group ids, dense-ranked with insertion order kept
    g = qid * np.int64(nt) + tid
    order = np.argsort(g, kind="stable")
    gs = g[order]
    seg_start = np.empty(n, dtype=bool)
    seg_start[0] = True
    seg_start[1:] = gs[1:] != gs[:-1]
    starts = np.flatnonzero(seg_start)
    g_rank_sorted = np.cumsum(seg_start) - 1
    g_rank = np.empty(n, dtype=np.int64)
    g_rank[order] = g_rank_sorted

    first_rows = order[starts]
    grp_qid = qid[first_rows]
    grp_tid = tid[first_rows]
    grp_qlen = qlen[first_rows]  # first-inserted alignment's qlen
    counts = np.diff(np.append(starts, n))
    ident_sum = _seg_sum_sequential(identity[order], starts)
    avg_identity = ident_sum / counts

    # query-coordinate union -> align rate; target-coordinate union ->
    # longest-block extent (first on ties)
    mapped, _, _, _, _ = _segmented_union(g_rank, qs, qe)
    align_rate = mapped / grp_qlen
    score = avg_identity * align_rate

    _, blo, bhi, bg, bstarts = _segmented_union(g_rank, ts, te)
    blen = bhi - blo
    gmax = np.maximum.reduceat(blen, bstarts)
    nb = blen.shape[0]
    cand = np.where(blen == gmax[bg], np.arange(nb, dtype=np.int64), nb)
    best_blk = np.minimum.reduceat(cand, bstarts)
    ext_lo = blo[best_blk]
    ext_hi = bhi[best_blk]

    # per-query argmax of (score, target name), largest wins
    el = np.lexsort((target_rank[grp_tid], score, grp_qid))
    eq = grp_qid[el]
    is_last = np.empty(el.shape[0], dtype=bool)
    is_last[-1] = True
    is_last[:-1] = eq[1:] != eq[:-1]
    win = el[is_last]  # ascending qid == first-appearance order

    assert win.shape[0] == nq
    return ElectedTargets(
        name_keys=name_keys[first_idx[app]],
        tid=grp_tid[win].astype(np.int32),
        target_names=target_names,
        start=ext_lo[win],
        end=ext_hi[win],
        qlen=grp_qlen[win],
    )


def elect_primary_targets(
    paf_files_data: list[tuple[PafData, np.ndarray]],
) -> list[ElectedTargets]:
    """Run the cumulative election: one ``ElectedTargets`` per PAF file.

    ``paf_files_data`` is [(PafData, pass_mask), ...] in CLI file order.
    Entry *i* of the result covers every query seen in files 0..i
    (reference cumulative-synteny quirk, GCI.py:215-254).  Per-file target
    tables are unioned; rows are concatenated in file order so the
    first-inserted semantics span files.
    """
    union_names: list[str] = []
    union_lookup: dict[str, int] = {}
    keys_parts: list[np.ndarray] = []
    tid_parts: list[np.ndarray] = []
    col_parts: dict[str, list[np.ndarray]] = {
        k: [] for k in ("qlen", "qs", "qe", "ts", "te", "ident")
    }
    out: list[ElectedTargets] = []
    for paf, mask in paf_files_data:
        idx = np.flatnonzero(mask)
        remap = np.empty(max(len(paf.target_names), 1), dtype=np.int32)
        for k, t in enumerate(paf.target_names):
            u = union_lookup.get(t)
            if u is None:
                u = len(union_names)
                union_lookup[t] = u
                union_names.append(t)
            remap[k] = u
        keys_parts.append(np.ascontiguousarray(paf.name_keys[idx]))
        tid_parts.append(remap[paf.tid[idx]])
        col_parts["qlen"].append(paf.qlen[idx])
        col_parts["qs"].append(paf.qstart[idx])
        col_parts["qe"].append(paf.qend[idx])
        col_parts["ts"].append(paf.tstart[idx])
        col_parts["te"].append(paf.tend[idx])
        with np.errstate(divide="ignore", invalid="ignore"):
            col_parts["ident"].append(
                paf.nmatch[idx].astype(np.float64)
                / paf.alnlen[idx].astype(np.float64)
            )
        out.append(
            _elect_concat(
                np.concatenate(keys_parts, axis=0),
                np.concatenate(tid_parts),
                np.concatenate(col_parts["qlen"]),
                np.concatenate(col_parts["qs"]),
                np.concatenate(col_parts["qe"]),
                np.concatenate(col_parts["ts"]),
                np.concatenate(col_parts["te"]),
                np.concatenate(col_parts["ident"]),
                list(union_names),
            )
        )
    return out
