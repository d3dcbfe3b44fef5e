"""The port's scan kernels (gci_tpu_torch.depth.scan) against the JAX ones.

The plain PyTorch versions are held, exactly, against the Pallas kernels in
interpret mode and against their XLA twins, on the same numpy inputs.  The
CUDA kernels themselves are held against the plain versions by the tests
marked ``cuda`` (run on a card; they skip elsewhere) and by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gci_tpu.depth.pallas_scan import (
    DEF_ROWS,
    LANES,
    depth_scan as jax_depth_scan,
    fused_depth_scan_packed as jax_packed,
    fused_depth_scan_packed_xla,
)
from gci_tpu_torch import kernels
from gci_tpu_torch.depth.scan import (
    depth_scan,
    depth_scan_torch,
    fused_depth_scan_packed,
    fused_depth_scan_packed_torch,
)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_disjoint_events(rng, total, n):
    """(starts, stops) of sorted DISJOINT intervals (the packed word's
    precondition: event prefix sums stay in {0, 1})."""
    cuts = np.sort(rng.choice(total, size=2 * n, replace=False))
    return cuts[0::2], cuts[1::2]


def _random_word(rng, total, n_reads=500, max_len=300):
    word = np.zeros(total, np.int32)
    idx = rng.integers(0, total, n_reads)
    np.add.at(word, idx, 1 << 2)
    np.add.at(word, np.minimum(idx + rng.integers(1, max_len, n_reads), total - 1),
              -(1 << 2))
    gs, ge = _random_disjoint_events(rng, total, 12)
    np.add.at(word, gs, 2)
    np.add.at(word, ge, -2)
    vs, ve = _random_disjoint_events(rng, total, 8)
    np.add.at(word, vs, 1)
    np.add.at(word, ve, -1)
    return word


def _assert_packed_equal(word, lo, hi, rows=8):
    got = fused_depth_scan_packed_torch(_t(word), lo, hi)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int8
    for want in (
        jax_packed(word, lo, hi, rows=rows, interpret=True),
        fused_depth_scan_packed_xla(word, lo, hi),
    ):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# K2: depth_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_chunks", [1, 3])
@pytest.mark.parametrize("magnitude", [2, 2**23])
def test_depth_scan_torch_matches_jax(rng, n_chunks, magnitude):
    """±2^23 deltas: the int32 running sum wraps mod 2^32 exactly as
    jnp.cumsum and the Pallas scan do (torch.cumsum must not widen)."""
    rows = 8
    total = n_chunks * rows * LANES
    delta = rng.integers(-magnitude, magnitude, size=total).astype(np.int32)
    got = depth_scan_torch(_t(delta))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.cumsum(delta)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_depth_scan(delta, rows=rows, interpret=True))
    )


def test_depth_scan_wrapper_runs_plain_on_cpu(rng):
    delta = rng.integers(-5, 6, size=1000).astype(np.int32)
    before = dict(kernels.LAUNCHES)
    np.testing.assert_array_equal(
        depth_scan(_t(delta)).numpy(), np.cumsum(delta).astype(np.int32)
    )
    assert kernels.LAUNCHES == before  # no kernel launch on the CPU


def test_wrappers_refuse_devices_without_kernels():
    x = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        depth_scan(x)
    with pytest.raises(ValueError):
        fused_depth_scan_packed(x, -1, 0)


# ---------------------------------------------------------------------------
# K1: fused_depth_scan_packed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_chunks", [1, 2, 3])
@pytest.mark.parametrize("hi", [0, 1, 2])
def test_packed_torch_matches_jax(rng, n_chunks, hi):
    total = n_chunks * 8 * LANES
    _assert_packed_equal(_random_word(rng, total), -1, hi)


def test_packed_torch_gap_at_position_zero(rng):
    """A gap from slot 0: the first slot's predecessor is outside every
    interval and its change bit is forced."""
    total = 2 * 8 * LANES
    word = np.zeros(total, np.int32)
    idx = rng.integers(0, total, 300)
    np.add.at(word, idx, 1 << 2)
    np.add.at(word, np.minimum(idx + rng.integers(1, 300, 300), total - 1), -(1 << 2))
    for s, e in ((0, 37), (500, 800), (1500, 1501)):
        word[s] += 2
        word[e] -= 2
    word[0] += 1  # scan-window valid from 0 as well
    word[total - 3] -= 1
    for hi in (0, 1):
        _assert_packed_equal(word, -1, hi)
    _, flags = fused_depth_scan_packed_torch(_t(word), -1, 0)
    assert flags[0] & 4 and flags[0] & 8


def test_packed_torch_runs_cross_chunk_border(rng):
    """Depth runs, a gap and an issue interval spanning the Pallas kernel's
    2048*128 chunk border (the TPU grid's carry hand-off)."""
    chunk = DEF_ROWS * LANES
    total = 2 * chunk
    word = np.zeros(total, np.int32)
    word[0] += 1  # valid everywhere
    word[chunk - 700] += 4 * 3  # depth 3 across the border
    word[chunk + 900] -= 4 * 3
    word[chunk - 50] += 2  # gap across the border: masked depth 0
    word[chunk + 60] -= 2
    word[chunk - 2] += 4  # a read ending right after the border
    word[chunk + 1] -= 4
    for hi in (0, 3):
        _assert_packed_equal(word, -1, hi, rows=DEF_ROWS)


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain versions (on a card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 2047, 2048, 2049, 1_000_003])
def test_cuda_kernels_match_plain(rng, cuda_device, n):
    delta = _t(rng.integers(-(2**23), 2**23, size=n).astype(np.int32)).to(cuda_device)
    np.testing.assert_array_equal(
        depth_scan(delta).cpu().numpy(), depth_scan_torch(delta).cpu().numpy()
    )
    word = _t(_random_word(rng, max(n, 64))[:n]).to(cuda_device)
    for hi in (0, 1):
        got = fused_depth_scan_packed(word, -1, hi)
        want = fused_depth_scan_packed_torch(word, -1, hi)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
