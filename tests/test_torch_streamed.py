"""The port's streamed depth (gci_tpu_torch.depth.streamed) against gci_tpu's.

The same seeded reads go through ``gci_tpu.depth.streamed`` (its jnp scan,
and its Pallas scan kernel in interpret mode at ``pallas_rows=8``, 1024-slot
tiles), the port's streamed path on the CPU (the scan kernels' plain
versions) and the numpy depth oracle; every array must be equal.  The
``cuda``-marked cases hold the streamed path on the card against its CPU
run.
"""
import numpy as np
import pytest
import torch

from gci_tpu.depth import streamed as jax_streamed
from gci_tpu.depth.accum import GenomeLayout as JaxGenomeLayout
from gci_tpu.depth.eventspace import events_dict_from_reads as jax_events_dict
from gci_tpu_torch import kernels
from gci_tpu_torch.depth import accum, streamed
from gci_tpu_torch.depth.accum import (
    GenomeLayout,
    accumulate_depth,
    accumulate_depth_numpy,
    depth_dict_from_flat,
)
from gci_tpu_torch.intervals.collapse import collapse_depth_runs

TARGETS = {"a": 9000, "b": 7000, "c": 150}
CPU = torch.device("cpu")
INT32_MAX = 2**31 - 1


def _random_reads(rng, n, targets=TARGETS):
    names = list(targets)
    lens = np.array([targets[t] for t in names])
    tid = rng.integers(0, len(names), n)
    start = (rng.random(n) * np.maximum(lens[tid] - 30, 1)).astype(np.int64)
    end = start + (rng.random(n) * 4000).astype(np.int64) + 5
    return tid.astype(np.int64), start, end


def _jax_kwargs(kernel):
    return dict(chunk_slots=1024, kernel=kernel,
                pallas_rows=8 if kernel == "pallas" else None)


def _assert_events_equal(got, want, names):
    """Event lists equal as arrays (boundaries, values, length) and per base."""
    assert list(got) == list(names)
    for t in names:
        g, w = got[t], want[t]
        np.testing.assert_array_equal(g.boundaries, w.boundaries, err_msg=t)
        np.testing.assert_array_equal(g.values, w.values, err_msg=t)
        assert g.length == w.length, t
        np.testing.assert_array_equal(g.materialize(), w.materialize(), err_msg=t)


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
def test_flat_depth_matches_jax_and_oracle(rng, kernel):
    layout = GenomeLayout.from_targets(TARGETS)  # 16,153 slots, 16 chunks
    tid, start, end = _random_reads(rng, 300)
    want = accumulate_depth_numpy(layout, tid, start, end, 15)
    jax_got = jax_streamed.accumulate_depth_streamed(
        JaxGenomeLayout.from_targets(TARGETS), tid, start, end, 15, **_jax_kwargs(kernel)
    )
    got = streamed.accumulate_depth_streamed(layout, tid, start, end, 15, 1024, device=CPU)
    np.testing.assert_array_equal(jax_got, want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
def test_events_match_jax_and_oracle(rng, kernel):
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _random_reads(rng, 500)
    got = streamed.events_from_reads_streamed(layout, tid, start, end, 15, 1024,
                                              device=CPU)
    jax_got = jax_streamed.events_from_reads_streamed(
        JaxGenomeLayout.from_targets(TARGETS), tid, start, end, 15, **_jax_kwargs(kernel)
    )
    _assert_events_equal(got, jax_got, TARGETS)
    _assert_events_equal(got, jax_events_dict(JaxGenomeLayout.from_targets(TARGETS),
                                              tid, start, end, 15), TARGETS)
    flat = accumulate_depth_numpy(layout, tid, start, end, 15)
    for t, arr in depth_dict_from_flat(layout, flat).items():
        np.testing.assert_array_equal(got[t].materialize(), arr, err_msg=t)


# reads over {"x": 6000, "y": 50} (clamped to slots [915, 2086), [965, 1000),
# [1915, 2986), [5015, 5985) and y's [15, 35)): at 1000-slot chunks a read
# stops on the border 1000, the depth-2 run crosses the border 2000, the
# depth-0 run crosses 3000, 4000 and 5000, and chunks 3 and 4 hold no event
BORDER_TARGETS = {"x": 6000, "y": 50}
BORDER_READS = (np.array([0, 0, 0, 0, 1], np.int64),
                np.array([900, 950, 1900, 5000, 0], np.int64),
                np.array([2100, 1014, 3000, 5999, 49], np.int64))


@pytest.mark.parametrize("chunk_slots", [1, 2, 999, 1000, 1001, 4096, 10**6])
def test_runs_cross_chunk_borders_and_empty_chunks(chunk_slots):
    """The event lists equal the oracle's, so a run across a border makes
    no boundary and a chunk with no event adds none."""
    targets = BORDER_TARGETS
    layout = GenomeLayout.from_targets(targets)
    tid, start, end = BORDER_READS
    want = jax_events_dict(JaxGenomeLayout.from_targets(targets), tid, start, end, 15)
    got = streamed.events_from_reads_streamed(layout, tid, start, end, 15,
                                              chunk_slots, device=CPU)
    _assert_events_equal(got, want, targets)
    flat = streamed.accumulate_depth_streamed(layout, tid, start, end, 15,
                                              chunk_slots, device=CPU)
    np.testing.assert_array_equal(flat, accumulate_depth_numpy(layout, tid, start, end, 15))


def test_chunks_without_events_are_planned():
    """The plan of the reads above at 1000-slot chunks: chunks 3 and 4 hold
    no event, and the carries are the depths before 1000, 2000 and 3000."""
    layout = GenomeLayout.from_targets(BORDER_TARGETS)
    gs, ge = streamed._sorted_events(layout, *BORDER_READS, 15)
    n, bounds, gs_lo, gs_hi, ge_lo, ge_hi = streamed._chunk_plan(
        layout.total_slots, gs, ge, 1000)
    assert n == 7 and bounds[-1] == layout.total_slots == 6052
    empty = [c for c in range(n) if gs_lo[c] == gs_hi[c] and ge_lo[c] == ge_hi[c]]
    assert empty == [3, 4]
    assert list((gs_lo - ge_lo)[1:4]) == [2, 2, 0]


def test_bed_parity_after_gap_masking(rng):
    """Event-space flow from streamed chunks: gap mask, then the issue
    intervals, equal the numpy oracle's and gci_tpu's streamed events'."""
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _random_reads(rng, 120)  # sparse: zero-depth issues
    ev = streamed.events_from_reads_streamed(layout, tid, start, end, 15, 2000,
                                             device=CPU)
    jax_ev = jax_streamed.events_from_reads_streamed(
        JaxGenomeLayout.from_targets(TARGETS), tid, start, end, 15,
        chunk_slots=2000, kernel="jnp")
    gaps = {"a": [(100, 300)], "b": [(6900, 7000)]}
    want_arrays = depth_dict_from_flat(layout, accumulate_depth_numpy(layout, tid, start, end, 15))
    for t in TARGETS:
        arr = want_arrays[t].copy()
        for s, e in gaps.get(t, []):
            arr[s:e] = 0
        want = collapse_depth_runs(arr, -1, 0, 15)
        assert ev[t].mask_intervals(gaps.get(t, [])).collapse(-1, 0, 15) == want, t
        assert jax_ev[t].mask_intervals(gaps.get(t, [])).collapse(-1, 0, 15) == want, t


@pytest.mark.parametrize("limit", [10_000, 10**9])
def test_accumulate_depth_switches_at_the_limit(rng, monkeypatch, limit):
    """accumulate_depth on a device streams past accum.stream_slot_limit and
    scans resident below it; both equal the oracle."""
    calls = []
    real = streamed.accumulate_depth_streamed

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, 4000, **kwargs)

    monkeypatch.setattr(accum, "stream_slot_limit", lambda device: limit)
    monkeypatch.setattr(streamed, "accumulate_depth_streamed", spy)
    layout = GenomeLayout.from_targets(TARGETS)  # 16,153 slots
    tid, start, end = _random_reads(rng, 200)
    got = accumulate_depth(layout, tid, start, end, 15, backend="device", device="cpu")
    assert len(calls) == (1 if limit < layout.total_slots else 0)
    np.testing.assert_array_equal(got, accumulate_depth_numpy(layout, tid, start, end, 15))


def test_stream_slot_limit_on_the_cpu_is_the_int32_bound():
    assert accum.stream_slot_limit(CPU) == INT32_MAX


def test_accumulate_depth_needs_a_card_or_numpy(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _random_reads(rng, 20)
    with pytest.raises(RuntimeError, match="is_available"):
        accumulate_depth(layout, tid, start, end, 15)
    np.testing.assert_array_equal(
        accumulate_depth(layout, tid, start, end, 15, backend="numpy"),
        accumulate_depth_numpy(layout, tid, start, end, 15))


def test_chunk_plan_above_int32_keeps_int64_positions(rng):
    """A 3.1G-slot layout (24 targets, as a human T2T assembly): every
    chunk-local index fits int32, every global position is int64 and comes
    back exactly from chunk start plus local index."""
    targets = {f"chr{i}": 129_166_666 for i in range(24)}
    layout = GenomeLayout.from_targets(targets)
    total = layout.total_slots
    assert total > INT32_MAX
    n = 20_000
    tid = rng.integers(0, 24, n)
    start = (rng.random(n) * 129_000_000).astype(np.int64)
    end = start + rng.integers(40, 60_000, n)
    gs, ge = streamed._sorted_events(layout, tid, start, end, 15)
    assert gs.dtype == ge.dtype == np.int64 and gs.max() > INT32_MAX
    for chunk in (streamed.CHUNK_SLOTS, INT32_MAX):
        n_chunks, bounds, gs_lo, gs_hi, ge_lo, ge_hi = streamed._chunk_plan(
            total, gs, ge, chunk)
        assert bounds.dtype == np.int64 and bounds[0] == 0 and bounds[-1] == total
        assert n_chunks == -(-total // chunk)
        back_s, back_e = [], []
        for c in range(n_chunks):
            a = bounds[c]
            for ev, lo, hi, back in ((gs, gs_lo, gs_hi, back_s), (ge, ge_lo, ge_hi, back_e)):
                local = ev[lo[c]:hi[c]] - a
                assert local.size == 0 or (local.min() >= 0 and local.max() < bounds[c + 1] - a)
                assert local.size == 0 or local.max() <= INT32_MAX
                back.append(local.astype(np.int32).astype(np.int64) + a)
            # the carry is the exact depth at a - 1
            assert gs_lo[c] - ge_lo[c] == np.sum(gs < a) - np.sum(ge < a)
        np.testing.assert_array_equal(np.concatenate(back_s), gs)
        np.testing.assert_array_equal(np.concatenate(back_e), ge)


@pytest.mark.parametrize("chunk", [0, -5, INT32_MAX + 1])
def test_chunk_plan_refuses_chunks_past_int32(chunk):
    with pytest.raises(ValueError, match="chunk"):
        streamed._chunk_plan(100, np.zeros(0, np.int64), np.zeros(0, np.int64), chunk)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_slots", [1000, 4096, 8192, 50_000])
def test_streamed_on_cuda_matches_cpu(rng, cuda_device, chunk_slots):
    """Events and flat depth on the card equal the CPU run; each chunk runs
    the int32 scan (its depth) once and the run form of the compaction (its
    boundaries) once."""
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _random_reads(rng, 400)
    want = streamed.events_from_reads_streamed(layout, tid, start, end, 15,
                                               chunk_slots, device=CPU)
    kernels.reset_launch_counts()
    got = streamed.events_from_reads_streamed(layout, tid, start, end, 15,
                                              chunk_slots, device=cuda_device)
    torch.cuda.synchronize()
    n_chunks = -(-layout.total_slots // chunk_slots)
    assert kernels.LAUNCHES["depth_scan"] == n_chunks
    assert kernels.LAUNCHES["compact_runs"] == n_chunks
    assert kernels.LAUNCHES["depth_scan_int8"] == 0
    assert kernels.LAUNCHES["fused_depth_scan_packed"] == 0
    _assert_events_equal(got, want, TARGETS)
    np.testing.assert_array_equal(
        streamed.accumulate_depth_streamed(layout, tid, start, end, 15, chunk_slots,
                                           device=cuda_device),
        accumulate_depth_numpy(layout, tid, start, end, 15))


@pytest.mark.cuda
def test_accumulate_depth_on_cuda_matches_oracle(rng, cuda_device, monkeypatch):
    layout = GenomeLayout.from_targets(TARGETS)
    tid, start, end = _random_reads(rng, 400)
    want = accumulate_depth_numpy(layout, tid, start, end, 15)
    np.testing.assert_array_equal(accumulate_depth(layout, tid, start, end, 15), want)
    monkeypatch.setattr(accum, "stream_slot_limit", lambda device: 1000)
    np.testing.assert_array_equal(accumulate_depth(layout, tid, start, end, 15), want)
