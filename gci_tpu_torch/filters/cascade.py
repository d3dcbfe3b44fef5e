"""Vectorized read-level filter masks.

Replaces the reference's per-record Python conditionals with elementwise
numpy/JAX boolean algebra over packed record columns.

Behavioral contracts:
* BAM mask — GCI.py:156,165: mapped ∧ ¬secondary ∧ ¬supplementary ∧
  mapq ≥ map_qual ∧ S/(M+=+X+I+S) ≤ clip_percent ∧
  (M+=+X−mm)/(M+=+X+I+D) ≥ iden_percent with mm = NM−(I+D).
  All divisions are IEEE float64, identical to the reference's Python floats.
* PAF mask — GCI.py:231-232: mapq ≥ map_qual ∧ nmatch/alnlen ≥ iden_percent.
* last-wins dedup — GCI.py:166: ``dict[query_name] = record`` keyed by read
  name; a sequential whole-file scan in coordinate order reproduces the
  reference's (target, window, position) traversal order, so keeping the
  *last* surviving record per name is equivalent.
"""
from __future__ import annotations

import numpy as np

from gci_tpu_torch.io.bam import FLAG_SECONDARY, FLAG_SUPPLEMENTARY, FLAG_UNMAPPED
from gci_tpu_torch.io.names import keys_view


def bam_filter_mask(
    columns: dict[str, np.ndarray],
    map_qual: int = 30,
    clip_percent: float = 0.1,
    iden_percent: float = 0.9,
) -> np.ndarray:
    flag = columns["flag"]
    m = columns["m"].astype(np.float64)
    i = columns["i"].astype(np.float64)
    d = columns["d"].astype(np.float64)
    s = columns["s"].astype(np.float64)
    eq = columns["eq"].astype(np.float64)
    x = columns["x"].astype(np.float64)
    nm = columns["nm"].astype(np.float64)
    base = (
        (flag & (FLAG_UNMAPPED | FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0
    ) & (columns["mapq"] >= map_qual)
    mex = m + eq + x
    mm = nm - (i + d)
    with np.errstate(divide="ignore", invalid="ignore"):
        clip_ok = s / (mex + i + s) <= clip_percent
        iden_ok = (mex - mm) / (mex + i + d) >= iden_percent
    return base & clip_ok & iden_ok


def paf_filter_mask(
    mapq: np.ndarray,
    nmatch: np.ndarray,
    alnlen: np.ndarray,
    map_qual: int = 30,
    iden_percent: float = 0.9,
) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        identity = nmatch.astype(np.float64) / alnlen.astype(np.float64)
    return (mapq >= map_qual) & (identity >= iden_percent)


def dedup_last_wins(name_keys: np.ndarray, kept: np.ndarray) -> np.ndarray:
    """Indices of the last surviving record per read name.

    ``name_keys`` is (n, 2) uint64; ``kept`` a boolean mask.  Returns int64
    indices into the original arrays (one per unique surviving name), in
    the order of the names' keys as pairs of uint64 words: the order of
    ``gci_tpu``'s ``np.unique`` of the structured keys, found here by a
    stable sort on the two words, which keeps each name's records in file
    order.
    """
    idx = np.flatnonzero(kept)
    if idx.size == 0:
        return idx
    a, b = name_keys[idx, 0], name_keys[idx, 1]
    order = np.lexsort((b, a))
    a, b = a[order], b[order]
    last = np.append((a[1:] != a[:-1]) | (b[1:] != b[:-1]), True)
    return idx[order[last]]


def high_qual_keys(
    name_keys: np.ndarray, kept: np.ndarray, mapq: np.ndarray, mq_cutoff: int
) -> np.ndarray:
    """Unique name keys of surviving records with mapq >= mq_cutoff.

    GCI.py:167-168 / 238-239: membership is evaluated *after* the full filter
    for BAM, and after the mapq/identity filter for PAF.
    """
    sel = kept & (mapq >= mq_cutoff)
    if not sel.any():
        return np.empty(0, dtype=[("a", np.uint64), ("b", np.uint64)])
    return np.unique(keys_view(name_keys[sel]))
