"""Cross-file curation: join read survivors across alignment files.

Behavioral contract (reference GCI.py:272-299): with files ordered
[PAF elections..., BAM survivor dicts...],

* ``comm`` = queries present in every file; ``final`` = high-qual ∪ comm;
* state starts as file[0] restricted to ``final``;
* each later file folds in sequentially; per query (independent of
  iteration order within a file):
    - in state, same target: overlap = min(ends) − max(starts); drop when
      overlap/query_length_of_current_file < ovlp_percent, else intersect
      the intervals;
    - in state, different target: drop;
    - not in state but high-qual: adopt the current file's extent.

Each per-file fold is a vectorized hash join on the 128-bit name key — no
per-read Python.  Queries absent from the incoming file are untouched, and a
query dropped by an earlier file can be re-adopted by a later one, exactly as
the reference dict fold behaves.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gci_tpu_torch.io.names import keys_view


@dataclass
class CurationInput:
    """One alignment file's surviving reads, as packed columns.

    ``target_id`` indexes a shared target-name table; ``qlen`` is the
    denominator of the overlap test (current file's query length).
    """

    name_keys: np.ndarray  # (n, 2) uint64, unique per file
    target_id: np.ndarray  # int32
    start: np.ndarray  # int64
    end: np.ndarray  # int64
    qlen: np.ndarray  # int64


@dataclass
class CuratedReads:
    target_id: np.ndarray
    start: np.ndarray
    end: np.ndarray
    keys: np.ndarray | None = None  # sorted void16 name keys (aligned rows)


def _membership(sorted_keys: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Boolean: is each of ``keys`` present in ``sorted_keys`` (both void16)."""
    if sorted_keys.size == 0:
        return np.zeros(keys.shape[0], dtype=bool)
    pos = np.searchsorted(sorted_keys, keys)
    pos_c = np.minimum(pos, sorted_keys.shape[0] - 1)
    return sorted_keys[pos_c] == keys


def curate_files(
    files: list[CurationInput],
    high_qual: np.ndarray,  # sorted void16 keys
    ovlp_percent: float = 0.9,
) -> CuratedReads:
    """Fold the files into the final curated read set (GCI.py:272-299)."""
    if len(files) == 1:
        f = files[0]
        kv = keys_view(f.name_keys)
        order = np.argsort(kv)
        return CuratedReads(
            f.target_id[order], f.start[order], f.end[order], kv[order]
        )

    views = [keys_view(f.name_keys) for f in files]
    # comm = intersection of all files' key sets
    comm = np.unique(views[0])
    for v in views[1:]:
        comm = comm[_membership(np.unique(v), comm)]
    # final = high_qual | comm  (state admission for file[0])
    f0 = files[0]
    admit = _membership(comm, views[0]) | _membership(high_qual, views[0])

    state_keys = views[0][admit]
    state_target = f0.target_id[admit].astype(np.int64)
    state_start = f0.start[admit].astype(np.int64)
    state_end = f0.end[admit].astype(np.int64)
    order = np.argsort(state_keys)
    state_keys = state_keys[order]
    state_target = state_target[order]
    state_start = state_start[order]
    state_end = state_end[order]

    for f, v in zip(files[1:], views[1:]):
        pos = np.searchsorted(state_keys, v)
        pos_c = np.minimum(pos, max(state_keys.shape[0] - 1, 0))
        matched = (
            state_keys[pos_c] == v if state_keys.size else np.zeros(v.shape[0], bool)
        )
        m_idx = np.flatnonzero(matched)
        s_idx = pos[m_idx]
        same_t = state_target[s_idx] == f.target_id[m_idx]
        lo = np.maximum(state_start[s_idx], f.start[m_idx])
        hi = np.minimum(state_end[s_idx], f.end[m_idx])
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = (hi - lo).astype(np.float64) / f.qlen[m_idx].astype(np.float64)
        keep_match = same_t & (frac >= ovlp_percent)
        # removals: matched but failing
        remove = np.zeros(state_keys.shape[0], dtype=bool)
        remove[s_idx[~keep_match]] = True
        # updates: intersect intervals for the keepers
        state_start[s_idx[keep_match]] = lo[keep_match]
        state_end[s_idx[keep_match]] = hi[keep_match]
        # additions: unmatched high-qual queries adopt this file's extent
        add_sel = (~matched) & _membership(high_qual, v)
        keep_state = ~remove
        new_keys = np.concatenate([state_keys[keep_state], v[add_sel]])
        new_target = np.concatenate(
            [state_target[keep_state], f.target_id[add_sel].astype(np.int64)]
        )
        new_start = np.concatenate(
            [state_start[keep_state], f.start[add_sel].astype(np.int64)]
        )
        new_end = np.concatenate(
            [state_end[keep_state], f.end[add_sel].astype(np.int64)]
        )
        order = np.argsort(new_keys)
        state_keys = new_keys[order]
        state_target = new_target[order]
        state_start = new_start[order]
        state_end = new_end[order]

    return CuratedReads(state_target, state_start, state_end, state_keys)
