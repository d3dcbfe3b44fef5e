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
    fused_depth_scan as jax_edges,
    fused_depth_scan_flags as jax_flags,
    fused_depth_scan_flags_xla,
    fused_depth_scan_masked as jax_masked,
    fused_depth_scan_masked_xla,
    fused_depth_scan_packed as jax_packed,
    fused_depth_scan_packed_xla,
)
from gci_tpu_torch import kernels
from gci_tpu_torch.depth.scan import (
    depth_scan,
    depth_scan_torch,
    fused_depth_scan,
    fused_depth_scan_flags,
    fused_depth_scan_flags_torch,
    fused_depth_scan_masked,
    fused_depth_scan_masked_torch,
    fused_depth_scan_packed,
    fused_depth_scan_packed_torch,
    fused_depth_scan_torch,
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


@pytest.mark.parametrize("n_chunks", [1, 3])
@pytest.mark.parametrize("kind", ["bitmap", "bytes"])
def test_depth_scan_torch_int8_matches_jax(rng, n_chunks, kind):
    """The int8 form: a bool bitmap viewed as int8 (the compaction's input)
    and full-range bytes, sign-extended, against the Pallas scan and
    jnp.cumsum of the same slots widened to int32."""
    rows = 8
    total = n_chunks * rows * LANES
    if kind == "bitmap":
        x = _t(rng.random(total) < 0.3).view(torch.int8)
    else:
        x = _t(rng.integers(-128, 128, size=total).astype(np.int8))
    wide = x.numpy().astype(np.int32)
    for got in (depth_scan_torch(x), depth_scan(x)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.cumsum(wide)))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_depth_scan(wide, rows=rows, interpret=True))
        )


@pytest.mark.parametrize("bad", ["bool", "int16", "int64", "2-D"])
def test_depth_scan_refuses_other_inputs_on_cpu(bad):
    """The CPU takes what the card takes: int32 or int8, one axis."""
    x = {
        "bool": torch.zeros(64, dtype=torch.bool),
        "int16": torch.zeros(64, dtype=torch.int16),
        "int64": torch.zeros(64, dtype=torch.int64),
        "2-D": torch.zeros((8, 8), dtype=torch.int32),
    }[bad]
    with pytest.raises(ValueError):
        depth_scan(x)


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
    b = torch.zeros(8, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        fused_depth_scan_flags(x, b, -1, 0)
    with pytest.raises(ValueError):
        fused_depth_scan_masked(x, b, b, -1, 0)
    with pytest.raises(ValueError):
        fused_depth_scan(x, b, -1, 0)


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
# K3 fused_depth_scan_flags, K5 fused_depth_scan_masked, K4 fused_depth_scan
# ---------------------------------------------------------------------------

# delta kinds: read starts and ends, and +-2^23 and 2^22..2^23 values whose
# int32 running sum wraps mod 2^32 (the plain versions must not widen); the
# large kinds get an issue range wide enough to hold about half the slots
DELTA_KINDS = ("reads", "mixed", "positive")


def _random_delta(rng, total, kind):
    if kind == "reads":
        delta = np.zeros(total, np.int32)
        idx = rng.integers(0, total, 500)
        np.add.at(delta, idx, 1)
        np.add.at(delta, np.minimum(idx + rng.integers(1, 300, 500), total - 1), -1)
        return delta, (-1, int(rng.integers(0, 3)))
    lo = -(2**23) if kind == "mixed" else 2**22
    return rng.integers(lo, 2**23, size=total).astype(np.int32), (-(2**30), 2**30)


def _truth_bytes(rng, total, p):
    """int8 stream true with probability p, as 1, 2, -1, 127 or -128 (the
    unpacked kernels test != 0, not bit 0)."""
    on = rng.random(total) < p
    return np.where(on, rng.choice([1, 2, -1, 127, -128], total), 0).astype(np.int8)


def _numpy_scan(delta, gap, valid, lo, hi):
    """The numpy oracle of test_fused_backend.py and test_pallas_scan.py:
    (raw, rise, fall, change) as bools beside the int32 raw depth."""
    raw = np.cumsum(delta).astype(np.int32)
    masked = np.where(gap != 0, 0, raw)
    m = (masked > lo) & (masked <= hi) & (valid != 0)
    prev = np.concatenate(([False], m[:-1]))
    change = np.concatenate(([True], raw[1:] != raw[:-1]))
    return raw, m & ~prev, ~m & prev, change


def _assert_flags_equal(delta, flags, lo, hi, rows=8):
    got = fused_depth_scan_flags_torch(_t(delta), _t(flags), lo, hi)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int8
    for want in (
        jax_flags(delta, flags, lo, hi, rows=rows, interpret=True),
        fused_depth_scan_flags_xla(delta, flags, lo, hi),
    ):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def _assert_masked_equal(delta, gap, valid, lo, hi, rows=8):
    got = fused_depth_scan_masked_torch(_t(delta), _t(gap), _t(valid), lo, hi)
    assert got[0].dtype == torch.int32
    assert all(g.dtype == torch.int8 for g in got[1:])
    oracle = _numpy_scan(delta, gap, valid, lo, hi)
    for want in (
        jax_masked(delta, gap, valid, lo, hi, rows=rows, interpret=True),
        fused_depth_scan_masked_xla(delta, gap, valid, lo, hi),
        oracle,
    ):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))


def _assert_edges_equal(delta, valid, lo, hi, rows=8):
    got = fused_depth_scan_torch(_t(delta), _t(valid), lo, hi)
    assert got[0].dtype == torch.int32
    assert got[1].dtype == torch.int8 and got[2].dtype == torch.int8
    raw, rise, fall, _ = _numpy_scan(delta, np.zeros_like(valid), valid, lo, hi)
    for want in (jax_edges(delta, valid, lo, hi, rows=rows, interpret=True),
                 (raw, rise, fall)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))


@pytest.mark.parametrize("n_chunks", [1, 2, 3])
@pytest.mark.parametrize("kind", DELTA_KINDS)
def test_flags_torch_matches_jax(rng, n_chunks, kind):
    """Flag bytes are random int8: bit0 is the gap, bit1 the window, and
    every other bit must be ignored."""
    total = n_chunks * 8 * LANES
    delta, (lo, hi) = _random_delta(rng, total, kind)
    flags = rng.integers(-128, 128, size=total).astype(np.int8)
    _assert_flags_equal(delta, flags, lo, hi)
    # sparse gaps inside a mostly valid window, as a genome has them
    flags = ((rng.random(total) < 0.1) + (rng.random(total) < 0.9) * 2).astype(np.int8)
    _assert_flags_equal(delta, flags, lo, hi)


@pytest.mark.parametrize("n_chunks", [1, 2, 3])
@pytest.mark.parametrize("kind", DELTA_KINDS)
def test_masked_torch_matches_jax(rng, n_chunks, kind):
    total = n_chunks * 8 * LANES
    delta, (lo, hi) = _random_delta(rng, total, kind)
    gap = _truth_bytes(rng, total, 0.15)
    valid = _truth_bytes(rng, total, 0.8)
    _assert_masked_equal(delta, gap, valid, lo, hi)


@pytest.mark.parametrize("n_chunks", [1, 2, 3])
@pytest.mark.parametrize("kind", DELTA_KINDS)
def test_edges_torch_matches_jax(rng, n_chunks, kind):
    total = n_chunks * 8 * LANES
    delta, (lo, hi) = _random_delta(rng, total, kind)
    _assert_edges_equal(delta, _truth_bytes(rng, total, 0.8), lo, hi)


def _border_case(rng):
    """Two 2048*128 chunks of the Pallas kernels with depth, gap and window
    runs across the border, a gap from position 0, and the window open at
    0 (so position 0's predecessor must read as outside)."""
    chunk = DEF_ROWS * LANES
    total = 2 * chunk
    delta = np.zeros(total, np.int32)
    delta[chunk - 700] += 3  # depth 3 across the border
    delta[chunk + 900] -= 3
    delta[chunk - 2] += 1  # a read ending right after the border
    delta[chunk + 1] -= 1
    idx = rng.integers(0, total - 400, 200)
    np.add.at(delta, idx, 1)
    np.add.at(delta, idx + rng.integers(1, 400, 200), -1)
    gap = np.zeros(total, np.int8)
    gap[:37] = 1
    gap[chunk - 50 : chunk + 60] = 1  # masked depth 0 across the border
    valid = np.zeros(total, np.int8)
    valid[: total - 3] = 1
    valid[chunk - 1 : chunk + 2] = 0  # a window break at the border
    return delta, gap, valid


@pytest.mark.parametrize("kernel", ["flags", "masked", "edges"])
@pytest.mark.parametrize("hi", [0, 3])
def test_flag_kernels_cross_chunk_border(rng, kernel, hi):
    delta, gap, valid = _border_case(rng)
    if kernel == "flags":
        _assert_flags_equal(delta, gap + valid * 2, -1, hi, rows=DEF_ROWS)
        _, out = fused_depth_scan_flags_torch(_t(delta), _t(gap + valid * 2), -1, hi)
        assert out[0] & 4 and (hi < 0 or out[0] & 1)  # gap at 0: masked 0 is in
    elif kernel == "masked":
        _assert_masked_equal(delta, gap * -1, valid * 2, -1, hi, rows=DEF_ROWS)
    else:
        _assert_edges_equal(delta, valid * -1, -1, hi, rows=DEF_ROWS)


def test_flag_kernels_agree(rng):
    """The three unpacked kernels and the packed one decode to the same
    streams on matching inputs (test_pallas_scan.py:143-168, 211-244): K5's
    streams are K3's bits 0-2, K3's flags are K1's flags & 7 on the packed
    word of the same reads and intervals, and K4 is K5 without gaps."""
    total = 3 * 8 * LANES
    delta, _ = _random_delta(rng, total, "reads")
    gs, ge = _random_disjoint_events(rng, total, 10)
    vs, ve = _random_disjoint_events(rng, total, 6)
    gd = np.zeros(total, np.int32)
    np.add.at(gd, gs, 1)
    np.add.at(gd, ge, -1)
    vd = np.zeros(total, np.int32)
    np.add.at(vd, vs, 1)
    np.add.at(vd, ve, -1)
    gap = (np.cumsum(gd) > 0).astype(np.int8)
    valid = (np.cumsum(vd) > 0).astype(np.int8)
    word = (delta << 2) + gd * 2 + vd
    for hi in (0, 1):
        d3, o3 = fused_depth_scan_flags(_t(delta), _t(gap + valid * 2), -1, hi)
        d1, o1 = fused_depth_scan_packed(_t(word), -1, hi)
        d5, r5, f5, c5 = fused_depth_scan_masked(_t(delta), _t(gap), _t(valid), -1, hi)
        assert torch.equal(d3, d1) and torch.equal(d3, d5)
        assert torch.equal(o3, o1 & 7)
        assert torch.equal(r5, o3 & 1)
        assert torch.equal(f5, (o3 >> 1) & 1)
        assert torch.equal(c5, (o3 >> 2) & 1)
        d4, r4, f4 = fused_depth_scan(_t(delta), _t(valid), -1, hi)
        _, r0, f0, _ = fused_depth_scan_masked(_t(delta), torch.zeros(total, dtype=torch.int8),
                                               _t(valid), -1, hi)
        assert torch.equal(d4, d3) and torch.equal(r4, r0) and torch.equal(f4, f0)


def _bad_streams():
    i32 = torch.zeros(64, dtype=torch.int32)
    i8 = torch.zeros(64, dtype=torch.int8)
    return {
        "int32 flags": (i32, i32),
        "bool flags": (i32, torch.zeros(64, dtype=torch.bool)),
        "short flags": (i32, i8[:63]),
        "2-D flags": (i32, i8.reshape(8, 8)),
        "strided flags": (i32, torch.zeros(128, dtype=torch.int8)[::2]),
        "int64 delta": (i32.long(), i8),
        "cpu tensors": (i32, i8),
        # inputs depth_scan's launcher refuses by itself (and the others by
        # their delta)
        "bool delta": (torch.zeros(64, dtype=torch.bool), i8),
        "int16 delta": (torch.zeros(64, dtype=torch.int16), i8),
        "2-D delta": (i32.reshape(8, 8), i8),
        "2-D int8 delta": (i8.reshape(8, 8), i8),
        "strided delta": (torch.zeros(128, dtype=torch.int32)[::2], i8),
        "cpu int8 delta": (i8, i8),
    }


@pytest.mark.parametrize("case", sorted(_bad_streams()))
@pytest.mark.parametrize("launcher", ["flags", "masked", "edges", "depth_scan"])
def test_launchers_refuse_bad_streams(case, launcher):
    """The launchers check every stream before anything builds: dtype,
    shape, length, contiguity, then the device (a CPU tensor here).
    depth_scan's launcher takes the delta alone."""
    delta, b = _bad_streams()[case]
    call = {
        "flags": lambda: kernels.launch_flags_scan(delta, b, -1, 0),
        "masked": lambda: kernels.launch_masked_scan(delta, b, b, -1, 0),
        "edges": lambda: kernels.launch_edges_scan(delta, b, -1, 0),
        "depth_scan": lambda: kernels.launch_depth_scan(delta),
    }[launcher]
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError):
        call()
    assert kernels.LAUNCHES == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 2047, 2048, 2049, 1_000_003])
def test_cuda_flag_kernels_match_plain(rng, cuda_device, n):
    """K3, K4 and K5 against their plain versions, at lengths with a ragged
    tail, on +-2^23 deltas and on read deltas, with truth bytes other than 1."""
    m = max(n, 64)
    for kind in ("mixed", "reads"):
        delta, (lo, hi) = _random_delta(rng, m, kind)
        delta = _t(delta[:n]).to(cuda_device)
        flags = _t(rng.integers(-128, 128, size=n).astype(np.int8)).to(cuda_device)
        gap = _t(_truth_bytes(rng, n, 0.15)).to(cuda_device)
        valid = _t(_truth_bytes(rng, n, 0.8)).to(cuda_device)
        for got, want in (
            (fused_depth_scan_flags(delta, flags, lo, hi),
             fused_depth_scan_flags_torch(delta, flags, lo, hi)),
            (fused_depth_scan_masked(delta, gap, valid, lo, hi),
             fused_depth_scan_masked_torch(delta, gap, valid, lo, hi)),
            (fused_depth_scan(delta, valid, lo, hi),
             fused_depth_scan_torch(delta, valid, lo, hi)),
        ):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.cuda
def test_cuda_launchers_refuse_misaligned_streams(cuda_device):
    delta = torch.zeros(4096, dtype=torch.int32, device=cuda_device)
    b = torch.zeros(4097, dtype=torch.int8, device=cuda_device)[1:]
    with pytest.raises(ValueError, match="aligned"):
        fused_depth_scan_flags(delta, b, -1, 0)
    with pytest.raises(ValueError, match="aligned"):
        fused_depth_scan(delta, b, -1, 0)
    with pytest.raises(ValueError, match="aligned"):
        fused_depth_scan_masked(delta[1:], b[:-1], b[:-1], -1, 0)


# lengths around 4096 slots, around a warp's 2048 and the look-back scan's
# tile of 8192 (gci_depth_scan_tile_slots), and 5,000,011 slots: 611 tiles,
# more than the card holds resident at once, so blocks really wait on tiles
# that are still running
SCAN_TILE = 8192
SCAN_LENGTHS = [1, 15, 4095, 4096, 4097, 3 * 4096 + 1, 2047, 2049,
                SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1, 3 * SCAN_TILE + 1, 5_000_011]


def _scan_input(rng, n, form):
    if form == "int32":
        return _t(rng.integers(-(2**23), 2**23, size=n).astype(np.int32))
    if form == "bitmap":
        return _t(rng.random(n) < 0.3).view(torch.int8)
    return _t(rng.integers(-128, 128, size=n).astype(np.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("n", SCAN_LENGTHS)
@pytest.mark.parametrize("form", ["int32", "bitmap", "bytes"])
def test_cuda_depth_scan_forms_match_plain(rng, cuda_device, n, form):
    """Both forms of the look-back scan, one launch each, against the plain
    version: int32 deltas, and int8 as a bool bitmap and as full-range bytes."""
    x = _scan_input(rng, n, form).to(cuda_device)
    name = "depth_scan" if form == "int32" else "depth_scan_int8"
    before = kernels.LAUNCHES[name]
    got = depth_scan(x)
    assert kernels.LAUNCHES[name] == before + 1
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), depth_scan_torch(x).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["int32", "bytes"])
def test_cuda_depth_scan_repeats_equal(rng, cuda_device, form):
    """Ten launches on one input give one answer: a look-back ordering fault
    would show only in some of them."""
    x = _scan_input(rng, 5_000_011, form).to(cuda_device)
    want = depth_scan_torch(x)
    for _ in range(10):
        assert torch.equal(depth_scan(x), want)


@pytest.mark.cuda
def test_cuda_depth_scan_tile_is_the_tested_one(cuda_device):
    assert kernels.load().gci_depth_scan_tile_slots() == SCAN_TILE


@pytest.mark.cuda
def test_cuda_depth_scan_refuses_misaligned_int8(cuda_device):
    x = torch.zeros(4097, dtype=torch.int8, device=cuda_device)[1:]
    with pytest.raises(ValueError, match="aligned"):
        depth_scan(x)
