"""Vectorized 128-bit read-name keys.

Read names are joined across files (BAM vs PAF vs BAM) by a 128-bit key made
of two independent 64-bit hashes, computed identically here (numpy, for PAF /
fallback paths) and in gci_native.cpp (C++, for the BAM packer).  With two
independent 64-bit hashes the collision probability for even 10^9 reads is
~1e-20, so the key is a faithful stand-in for the name in join semantics.
"""
from __future__ import annotations

import numpy as np

_FNV_OFFSET = np.uint64(1469598103934665603)
_FNV_PRIME = np.uint64(1099511628211)
_H2_SEED = np.uint64(0x9E3779B97F4A7C15)
_H2_LENMUL = np.uint64(0xFF51AFD7ED558CCD)
_H2_PRIME = np.uint64(0xC2B2AE3D27D4EB4F)
_H2_FINAL = np.uint64(0xFF51AFD7ED558CCD)


def _padded_matrix(names: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    lens = np.array([len(n) for n in names], dtype=np.int64)
    blob = np.frombuffer(b"".join(names), dtype=np.uint8)
    offs = np.concatenate(([0], np.cumsum(lens)))[:-1]
    max_len = int(lens.max()) if lens.size else 0
    idx = offs[:, None] + np.arange(max_len)[None, :]
    np.clip(idx, 0, max(blob.shape[0] - 1, 0), out=idx)
    mat = blob[idx] if blob.size else np.zeros((len(names), max_len), np.uint8)
    return mat, lens


def hash_names(names: list[bytes]) -> np.ndarray:
    """(n, 2) uint64 keys matching gci_native's fnv1a64 / hash2_64."""
    n = len(names)
    out = np.zeros((n, 2), dtype=np.uint64)
    if n == 0:
        return out
    mat, lens = _padded_matrix(names)
    with np.errstate(over="ignore"):
        h1 = np.full(n, _FNV_OFFSET)
        h2 = _H2_SEED ^ (lens.astype(np.uint64) * _H2_LENMUL)
        for j in range(mat.shape[1]):
            live = j < lens
            b = mat[:, j].astype(np.uint64)
            h1 = np.where(live, (h1 ^ b) * _FNV_PRIME, h1)
            t = (h2 ^ b) * _H2_PRIME
            t ^= t >> np.uint64(29)
            h2 = np.where(live, t, h2)
        h2 = h2 * _H2_FINAL
        h2 ^= h2 >> np.uint64(33)
    out[:, 0] = h1
    out[:, 1] = h2
    return out


def key128(h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
    """Stack two u64 hash columns into the canonical (n, 2) key array."""
    return np.stack([h1.astype(np.uint64), h2.astype(np.uint64)], axis=1)


def keys_view(keys: np.ndarray) -> np.ndarray:
    """View an (n, 2) uint64 key array as a 1-D void16 array for sort/join."""
    k = np.ascontiguousarray(keys)
    return k.view([("a", np.uint64), ("b", np.uint64)]).reshape(-1)
