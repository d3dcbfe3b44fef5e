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
from gci_tpu.depth.base import events_from_change_indices
from gci_tpu.depth.eventspace import events_dict_from_reads as jax_events_dict
from gci_tpu.depth.overlap import DeltaAccumulator as JaxDeltaAccumulator
from gci_tpu.filters.cascade import dedup_last_wins as jax_dedup
from gci_tpu.io.names import hash_names as jax_hash_names
from gci_tpu.io.names import keys_view as jax_keys_view
from gci_tpu_torch import kernels, native
from gci_tpu_torch.depth import accum, overlap, streamed
from gci_tpu_torch.depth.device import scatter_events_into
from gci_tpu_torch.depth.eventspace import DepthEvents
from gci_tpu_torch.depth.accum import (
    GenomeLayout,
    accumulate_depth,
    accumulate_depth_numpy,
    clamp_read_intervals,
    depth_dict_from_flat,
)
from gci_tpu_torch.filters.cascade import dedup_last_wins
from gci_tpu_torch.intervals.collapse import collapse_depth_runs
from gci_tpu_torch.io.names import hash_names, keys_view
from gci_tpu_torch.utils.metrics import get_metrics

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
    """The partition of the reads above at 1000-slot chunks: chunks 3 and 4
    hold no event, and the carries are the depths before 1000, 2000 and
    3000."""
    layout = GenomeLayout.from_targets(BORDER_TARGETS)
    bounds, _, _, s_at, e_at = streamed._sorted_events(layout, *BORDER_READS, 15, 1000)
    n = bounds.shape[0] - 1
    assert n == 7 and bounds[-1] == layout.total_slots == 6052
    empty = [c for c in range(n) if s_at[c] == s_at[c + 1] and e_at[c] == e_at[c + 1]]
    assert empty == [3, 4]
    assert list((s_at - e_at)[1:4]) == [2, 2, 0]


def _global_events(layout, tid, start, end, flank):
    """Sorted int64 global start and stop slots of the live reads."""
    s, e = clamp_read_intervals(layout, tid, start, end, flank)
    live = e > s
    base = layout.offsets[tid][live]
    return np.sort(base + s[live]), np.sort(base + e[live])


@pytest.fixture
def counters(monkeypatch):
    """The port's registry, on and empty; its counters after the test's
    calls are ``counters()``."""
    m = get_metrics()
    m.reset()
    monkeypatch.setattr(m, "enabled", True)
    yield m.counter_totals
    m.reset()


def _assert_partition(layout, tid, start, end, flank, chunk, counters, path="native"):
    """``_sorted_events`` took ``path`` and equals the numpy twin array for
    array; each chunk's events, shifted to it, are the live reads' global
    slots, and each carry is the depth before the chunk."""
    got = streamed._sorted_events(layout, tid, start, end, flank, chunk)
    bounds, starts, stops, s_at, e_at = got
    n_chunks = bounds.shape[0] - 1
    assert n_chunks == -(-layout.total_slots // chunk)
    assert bounds.dtype == s_at.dtype == e_at.dtype == np.int64
    assert starts.dtype == stops.dtype == np.int32
    want = streamed._partition_numpy(layout, tid, start, end, flank, chunk, n_chunks)
    for g, w, what in zip(got[1:], want, ("starts", "stops", "s_at", "e_at")):
        assert g.dtype == w.dtype, what
        np.testing.assert_array_equal(g, w, err_msg=what)
    gs, ge = _global_events(layout, tid, start, end, flank)
    assert counters() == {f"streamed.events_{path}": 2 * gs.shape[0]}
    for slots, at, want_slots in ((starts, s_at, gs), (stops, e_at, ge)):
        assert at[0] == 0 and at[-1] == slots.shape[0] == want_slots.shape[0]
        back = [slots[at[c]:at[c + 1]].astype(np.int64) + bounds[c] for c in range(n_chunks)]
        for c, x in enumerate(back):
            assert x.size == 0 or (x.min() >= bounds[c] and x.max() < bounds[c + 1])
        np.testing.assert_array_equal(np.sort(np.concatenate(back)), want_slots)
    carries = np.searchsorted(gs, bounds[:-1]) - np.searchsorted(ge, bounds[:-1])
    np.testing.assert_array_equal(s_at[:-1] - e_at[:-1], carries)
    return got


PARTITION_TARGETS = {"a": 9000, "z": 0, "b": 7000, "c": 150}


def _partition_reads(rng, n=3000, targets=PARTITION_TARGETS):
    """Reads over every target, the zero-length one too: starts before 0
    and past the end, ends before the starts (dead reads), ends that wrap
    negative (below ``flank - 1``) and ends below ``-L``."""
    lens = np.array(list(targets.values()))
    tid = rng.integers(0, len(lens), n)
    start = (rng.random(n) * (lens[tid] + 60)).astype(np.int64) - 30
    end = start + rng.integers(-200, 4000, n)
    end[:40] = -rng.integers(1, 12_000, 40)
    return tid, start, end


@pytest.mark.parametrize("tid_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("flank", [0, 15])
@pytest.mark.parametrize("chunk", [7, 1000, 4096, streamed.CHUNK_SLOTS, INT32_MAX])
def test_partition_native_equals_numpy_twin(chunk, flank, tid_dtype, counters):
    """The host library's clamp and counting sort by chunk equals the numpy
    twin, array for array, on reads that wrap, die, or fall on an empty
    target; ``target_id`` is read as int32 or int64."""
    rng = np.random.default_rng([chunk, flank])
    layout = GenomeLayout.from_targets(PARTITION_TARGETS)
    tid, start, end = _partition_reads(rng)
    s, e = clamp_read_intervals(layout, tid, start, end, flank)
    assert (e <= s).sum() > 100 and ((end - flank + 1) < 0).sum() >= 40
    _assert_partition(layout, tid.astype(tid_dtype), start, end, flank, chunk, counters)


@pytest.mark.parametrize("chunk", [7, streamed.CHUNK_SLOTS])
def test_partition_of_no_reads(chunk, counters):
    layout = GenomeLayout.from_targets(PARTITION_TARGETS)
    none = np.zeros(0, np.int64)
    _, starts, stops, s_at, e_at = _assert_partition(layout, none, none, none, 15, chunk,
                                                     counters)
    assert starts.shape == stops.shape == (0,) and not s_at.any() and not e_at.any()


def test_partition_refuses_target_ids_outside_the_layout(monkeypatch):
    """A target id past the layout raises IndexError, in C++ and in numpy."""
    layout = GenomeLayout.from_targets(PARTITION_TARGETS)
    tid, start, end = np.array([0, 4]), np.array([10, 10]), np.array([500, 500])
    with pytest.raises(IndexError):
        streamed._sorted_events(layout, tid, start, end, 15, 1000)
    monkeypatch.setattr(native, "get_lib", _no_host_library)
    with pytest.raises(IndexError):
        streamed._sorted_events(layout, tid, start, end, 15, 1000)


def _no_host_library():
    raise native.HostCodecError("the host codec did not build")


@pytest.mark.parametrize("chunk", [7, 4096])
def test_partition_falls_back_to_numpy_without_the_host_library(rng, monkeypatch, chunk,
                                                                counters):
    """Where the host library does not load, the numpy twin partitions (its
    counter shows it) and the streamed depth's events are the same."""
    layout = GenomeLayout.from_targets(PARTITION_TARGETS)
    tid, start, end = _partition_reads(rng)
    want = streamed.events_from_reads_streamed(layout, tid, start, end, 15, chunk, device=CPU)
    assert "streamed.events_native" in counters()
    get_metrics().reset()
    monkeypatch.setattr(native, "get_lib", _no_host_library)
    _assert_partition(layout, tid, start, end, 15, chunk, counters, path="numpy")
    get_metrics().reset()
    got = streamed.events_from_reads_streamed(layout, tid, start, end, 15, chunk, device=CPU)
    assert "streamed.events_numpy" in counters()
    assert "streamed.events_native" not in counters()
    _assert_events_equal(got, want, PARTITION_TARGETS)


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


def test_chunk_plan_above_int32_keeps_int64_positions(rng, counters):
    """A 3.1G-slot layout (24 targets, as a human T2T assembly): every
    chunk-local index fits int32, every global position is int64 and comes
    back exactly from chunk start plus local index; the host library's
    partition equals the numpy twin's there too."""
    targets = {f"chr{i}": 129_166_666 for i in range(24)}
    layout = GenomeLayout.from_targets(targets)
    total = layout.total_slots
    assert total > INT32_MAX
    n = 20_000
    tid = rng.integers(0, 24, n)
    start = (rng.random(n) * 129_000_000).astype(np.int64)
    end = start + rng.integers(40, 60_000, n)
    gs, ge = _global_events(layout, tid, start, end, 15)
    assert gs.dtype == ge.dtype == np.int64 and gs.max() > INT32_MAX
    for chunk in (streamed.CHUNK_SLOTS, INT32_MAX):
        get_metrics().reset()
        bounds, starts, stops, s_at, e_at = _assert_partition(
            layout, tid, start, end, 15, chunk, counters)
        n_chunks = bounds.shape[0] - 1
        assert bounds.dtype == np.int64 and bounds[0] == 0 and bounds[-1] == total
        assert n_chunks == -(-total // chunk)
        back_s, back_e = [], []
        for c in range(n_chunks):
            a = bounds[c]
            for ev, at, back in ((starts, s_at, back_s), (stops, e_at, back_e)):
                local = ev[at[c]:at[c + 1]]
                assert local.size == 0 or (local.min() >= 0 and local.max() < bounds[c + 1] - a)
                assert local.size == 0 or local.max() <= INT32_MAX
                back.append(local.astype(np.int64) + a)
            # the carry is the exact depth at a - 1
            assert s_at[c] - e_at[c] == np.sum(gs < a) - np.sum(ge < a)
        np.testing.assert_array_equal(np.sort(np.concatenate(back_s)), gs)
        np.testing.assert_array_equal(np.sort(np.concatenate(back_e)), ge)


@pytest.mark.parametrize("chunk", [0, -5, INT32_MAX + 1])
def test_chunk_plan_refuses_chunks_past_int32(chunk):
    none = np.zeros(0, np.int64)
    with pytest.raises(ValueError, match="chunk"):
        streamed._sorted_events(GenomeLayout.from_targets({"a": 99}), none, none, none, 15,
                                chunk)


# ---------------------------------------------------------------------------
# the read-out of a resident delta: events_from_delta2d_streamed
# ---------------------------------------------------------------------------

LAST_WINS_TARGETS = {"c1": 5000, "c2": 3000}


def _last_wins_reads(seed, n=600):
    """``tests/test_streamed.py``'s last-wins case: 600 reads of 250 names,
    so names are replaced across chunks, some twice."""
    rng = np.random.default_rng(seed)
    names = [f"r{int(rng.integers(0, 250))}".encode() for _ in range(n)]
    tid = rng.integers(0, 2, n).astype(np.int32)
    L = np.array([5000, 3000])[tid]
    start = (L * rng.random(n) * 0.8).astype(np.int64)
    end = np.minimum(start + rng.integers(30, 900, n), L)
    return names, tid, start, end


def _accumulate(acc, keys, dedup, kview, tid, start, end, n_chunks=7):
    """Feed ``acc`` the reads in ``n_chunks`` chunks of file order, each
    deduped within the chunk."""
    bounds = np.linspace(0, tid.shape[0], n_chunks + 1).astype(int)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        surv = dedup(keys[lo:hi], np.ones(hi - lo, bool)) + lo
        acc.add_chunk(kview(keys[surv]), tid[surv], start[surv], end[surv])
    return acc


def _batch_events(layout, names, tid, start, end):
    surv = dedup_last_wins(hash_names(names), np.ones(len(names), bool))
    return jax_events_dict(layout, tid[surv], start[surv], end[surv], 15)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delta_readout_matches_jax_and_batch_survivors(seed):
    """The 7-chunk last-wins case: the port's and gci_tpu's accumulators
    on the same chunks, each read out by its own
    ``events_from_delta2d_streamed`` in 4096-slot chunks; both equal the
    batch survivors' events, and no compaction launches twice."""
    names, tid, start, end = _last_wins_reads(seed)
    layout = GenomeLayout.from_targets(LAST_WINS_TARGETS)
    jlayout = JaxGenomeLayout.from_targets(LAST_WINS_TARGETS)
    want = _batch_events(jlayout, names, tid, start, end)
    cs = jax_streamed.resident_chunk_slots(layout.total_slots, chunk_slots=4096)
    assert cs == streamed.resident_chunk_slots(layout.total_slots, 4096) == 4096
    jacc = _accumulate(JaxDeltaAccumulator(jlayout, 15, cs), jax_hash_names(names),
                       jax_dedup, jax_keys_view, tid, start, end)
    ref = jax_streamed.events_from_delta2d_streamed(jlayout, jacc.delta2d, chunk_slots=4096)
    acc = _accumulate(overlap.DeltaAccumulator(layout, 15, device=CPU), hash_names(names),
                      dedup_last_wins, keys_view, tid, start, end)
    assert acc.rows_retracted > 0
    kernels.reset_launch_counts()
    got = streamed.events_from_delta2d_streamed(layout, acc.take_delta(), 4096, rows=acc.rows)
    assert kernels.RELAUNCHES["compact_runs"] == 0
    _assert_events_equal(ref, want, LAST_WINS_TARGETS)
    _assert_events_equal(got, want, LAST_WINS_TARGETS)


# BORDER_READS at 15-slot flanks: slots [915, 2086), [965, 1000), [1915,
# 2986) and [5015, 5985) of the first target, [6016, 6036) of the second
@pytest.mark.parametrize("chunk_slots", [
    997,    # borders inside runs (997, 1994, 2991 and on)
    1000,   # a border exactly on a read's end (1000), one inside two runs (2000)
    2086,   # a border exactly on another read's end
    6052,   # one chunk: the whole genome
    10**6,  # one chunk, asked larger than the genome
    7,      # 865 chunks, the last one short
])
def test_delta_readout_chunk_borders(chunk_slots):
    """The read-out of the reads' delta in chunks whose borders fall inside
    runs, on read ends, or nowhere; ``total_slots`` (6052) is a multiple of
    none of the chunks shorter than the genome.  Equal to the oracle's
    events, with no relaunch."""
    layout = GenomeLayout.from_targets(BORDER_TARGETS)
    tid, start, end = BORDER_READS
    gs, ge = _global_events(layout, tid, start, end, 15)
    assert {1000, 2086} <= set(ge.tolist())
    delta = torch.zeros(layout.total_slots, dtype=torch.int32)
    scatter_events_into(delta, [(gs, 1), (ge, -1)])
    want = jax_events_dict(JaxGenomeLayout.from_targets(BORDER_TARGETS), tid, start, end, 15)
    kernels.reset_launch_counts()
    got = streamed.events_from_delta2d_streamed(layout, delta, chunk_slots,
                                                rows=2 * gs.shape[0])
    assert kernels.RELAUNCHES["compact_runs"] == 0
    _assert_events_equal(got, want, BORDER_TARGETS)


@pytest.mark.parametrize("total,chunk", [
    (1, 1), (5, 1), (6052, 1000), (6052, 6052), (6052, 10**9), (2**28 + 5, 2**28),
    (3_100_000_024, 2**28), (100, 0),
])
def test_resident_chunk_slots_matches_jax(total, chunk):
    """The reference's branch off the TPU: the chunk, never more than the
    genome, at least 1."""
    assert streamed.resident_chunk_slots(total, chunk) == \
        jax_streamed.resident_chunk_slots(total, chunk_slots=chunk, kernel="jnp")


def test_resident_chunk_slots_defaults_to_chunk_slots(monkeypatch):
    assert streamed.resident_chunk_slots(3_100_000_024) == streamed.CHUNK_SLOTS == 2**28
    assert streamed.resident_chunk_slots(1000) == 1000
    monkeypatch.setattr(streamed, "CHUNK_SLOTS", 64)
    assert streamed.resident_chunk_slots(1000) == 64


def test_delta_readout_checks_the_delta_and_consumes_it():
    """The delta must be int32 of exactly ``total_slots``; the read-out
    adds each chunk's carry at its slot 0 in place."""
    layout = GenomeLayout.from_targets({"t": 99})  # 100 slots
    for bad in (torch.zeros(101, dtype=torch.int32), torch.zeros(100, dtype=torch.int64),
                torch.zeros((4, 25), dtype=torch.int32)):
        with pytest.raises(ValueError, match="int32 delta of 100 slots"):
            streamed.events_from_delta2d_streamed(layout, bad)
    delta = torch.zeros(100, dtype=torch.int32)
    delta[10], delta[70] = 1, -1
    ev = streamed.events_from_delta2d_streamed(layout, delta, 25)
    np.testing.assert_array_equal(ev["t"].materialize(),
                                  np.r_[np.zeros(10), np.ones(60), np.zeros(29)])
    assert delta[25].item() == delta[50].item() == 1 and delta[75].item() == 0


# ---------------------------------------------------------------------------
# events_from_runs: each target a slice of the chunks' runs
# ---------------------------------------------------------------------------

def _events_by_gather(layout, runs):
    """The construction ``events_from_runs`` replaced: every target's
    boundaries, its start forced, gathered genome-wide by binary search into
    the runs, then merged by ``_dedup`` (gci_tpu's
    ``events_from_change_indices``)."""
    runs = [r for r in runs if r[0].shape[0]]
    idx = np.concatenate([r[0] for r in runs]) if runs else np.zeros(1, np.int64)
    vals = np.concatenate([r[1] for r in runs]) if runs else np.zeros(1, np.int64)

    def gather(query):
        return vals[np.clip(np.searchsorted(idx, query, side="right") - 1, 0, None)]

    return events_from_change_indices(layout, idx, gather)


def _assert_runs_invariant(runs):
    """What ``events_from_runs`` relies on: int64 slots strictly increasing
    from slot 0, and adjacent depths different."""
    runs = [r for r in runs if r[0].shape[0]]
    idx = np.concatenate([r[0] for r in runs])
    vals = np.concatenate([r[1] for r in runs])
    assert idx.dtype == vals.dtype == np.int64
    assert idx[0] == 0 and np.all(np.diff(idx) > 0)
    assert np.all(vals[1:] != vals[:-1])


def _runs_layout(seed, chunk_slots):
    """1-5 targets; the second starts on a chunk border, the rest random,
    zero-length and one-slot targets among them; reads over every target,
    at flank 0 (some read starting on its target's first slot) or 15."""
    rng = np.random.default_rng([seed, chunk_slots])
    lens = [chunk_slots - 1] + [int(rng.choice([0, 1, rng.integers(2, 1500)]))
                                for _ in range(rng.integers(0, 5))]
    targets = {f"t{k}": L for k, L in enumerate(lens)}
    flank = int(rng.choice([0, 15]))
    n = 300
    L = np.array(lens)
    tid = rng.integers(0, len(lens), n)
    start = (rng.random(n) * np.maximum(L[tid] - 5, 1)).astype(np.int64)
    start[:len(lens)] = 0  # a read at every target's first slot
    tid[:len(lens)] = np.arange(len(lens))
    end = start + rng.integers(1, 900, n)
    return targets, flank, tid.astype(np.int64), start, end


def _run_caller(caller, layout, flank, tid, start, end, chunk_slots):
    if caller == "reads":
        return streamed.events_from_reads_streamed(layout, tid, start, end, flank,
                                                   chunk_slots, device=CPU)
    if caller == "delta":
        gs, ge = _global_events(layout, tid, start, end, flank)
        delta = torch.zeros(layout.total_slots, dtype=torch.int32)
        scatter_events_into(delta, [(gs, 1), (ge, -1)])
        return streamed.events_from_delta2d_streamed(layout, delta, chunk_slots,
                                                     rows=2 * gs.shape[0])
    # the sweep: distinct names in global start order, 3 BAM chunks
    order = np.argsort(layout.offsets[tid] + start, kind="stable")
    tid, start, end = tid[order], start[order], end[order]
    keys = hash_names([f"r{k}".encode() for k in range(tid.shape[0])])
    acc = overlap.SweepAccumulator(layout, flank, chunk_slots, device=CPU)
    for lo, hi in ((0, 100), (100, 200), (200, tid.shape[0])):
        acc.add_chunk(keys_view(keys[lo:hi]), tid[lo:hi], start[lo:hi], end[lo:hi])
    return acc.finish()


@pytest.fixture
def runs_spy(monkeypatch):
    """The runs each call of ``events_from_runs`` got (``overlap`` holds its
    own reference to it)."""
    seen = []
    real = streamed.events_from_runs

    def spy(layout, runs):
        runs = list(runs)
        seen.append(runs)
        return real(layout, runs)

    monkeypatch.setattr(streamed, "events_from_runs", spy)
    monkeypatch.setattr(overlap, "events_from_runs", spy)
    return seen


@pytest.mark.parametrize("caller", ["reads", "delta", "sweep"])
@pytest.mark.parametrize("chunk_slots", [1, 2, 7, 1000, 2**20])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_events_from_runs_slices_the_runs(runs_spy, seed, chunk_slots, caller):
    """Through each caller: the runs it hands over keep the invariant, and
    the events equal, array by array, those of the genome-wide gather, and
    the numpy depth oracle's canonical runs per target (a zero-length
    target holds the depth at its slot)."""
    targets, flank, tid, start, end = _runs_layout(seed, chunk_slots)
    layout = GenomeLayout.from_targets(targets)
    assert layout.offsets[1] == chunk_slots  # the second target starts on a border
    got = _run_caller(caller, layout, flank, tid, start, end, chunk_slots)
    (runs,) = runs_spy
    _assert_runs_invariant(runs)
    want = _events_by_gather(layout, runs)
    flat = accumulate_depth_numpy(layout, tid, start, end, flank)
    assert list(got) == list(targets)
    for k, t in enumerate(targets):
        g, w = got[t], want[t]
        for a, b in ((g.boundaries, w.boundaries), (g.values, w.values)):
            assert a.dtype == b.dtype == np.int64, t
            np.testing.assert_array_equal(a, b, err_msg=t)
        assert g.length == w.length == targets[t], t
        o, L = int(layout.offsets[k]), targets[t]
        assert g.values[0] == flat[o], t
        if L:
            canon = DepthEvents.from_array(flat[o:o + L])
            np.testing.assert_array_equal(g.boundaries, canon.boundaries, err_msg=t)
            np.testing.assert_array_equal(g.values, canon.values, err_msg=t)


def test_events_from_runs_on_hand_made_runs():
    """Runs that keep the invariant but no reads could make, split over
    chunks with an empty one among them: target a starts on a boundary, z
    (zero-length) on one too and takes the run that starts there, b (one
    slot) inside a run, c inside one and past the last boundary."""
    layout = GenomeLayout.from_targets({"a": 3, "z": 0, "b": 1, "c": 4})  # 0, 4, 5, 7
    runs = [(np.array([0, 2], np.int64), np.array([1, 2], np.int64)),
            (np.empty(0, np.int64), np.empty(0, np.int64)),
            (np.array([4, 6, 8], np.int64), np.array([3, 4, 5], np.int64))]
    got = streamed.events_from_runs(layout, runs)
    want = _events_by_gather(layout, runs)
    expect = {"a": ([0, 2], [1, 2], 3), "z": ([0], [3], 0), "b": ([0], [3], 1),
              "c": ([0, 1], [4, 5], 4)}
    assert list(got) == list(expect)
    for t, (b, v, L) in expect.items():
        for ev in (got[t], want[t]):
            assert ev.boundaries.tolist() == b and ev.values.tolist() == v, t
            assert ev.length == L, t


def test_sweep_merges_runs_a_fixup_made_equal(runs_spy):
    """A retraction behind the sweep's frontier shifts finalized runs into
    their neighbours' depth: read b, [515, 1986) after its flanks, is
    retracted once chunks 0 and 1 are final, which leaves the runs at 515
    and 1986 equal to those before them.  ``finish`` merges them before
    ``events_from_runs``; the events equal the gather over the unmerged
    runs and the survivors' oracle."""
    targets = {"c": 39_999}
    layout = GenomeLayout.from_targets(targets)
    rows = [[("a", 100, 1000), ("b", 500, 2000)], [("x", 9000, 9800)], [("b", 9500, 10000)]]
    acc = overlap.SweepAccumulator(layout, 15, 4096, device=CPU)
    for batch in rows:
        keys = hash_names([r[0].encode() for r in batch])
        acc.add_chunk(keys_view(keys), np.zeros(len(batch), np.int32),
                      np.array([r[1] for r in batch], np.int64),
                      np.array([r[2] for r in batch], np.int64))
    assert acc.frontier == 2 and acc.rows_retracted == 1
    idx, vals = acc._chunk_events[0]
    assert idx.tolist() == [0, 115, 515, 986, 1986] and vals.tolist() == [0, 1, 1, 0, 0]
    got = acc.finish()
    unmerged = [acc._chunk_events[c] for c in sorted(acc._chunk_events)]
    (runs,) = runs_spy
    _assert_runs_invariant(runs)
    want = _events_by_gather(layout, unmerged)
    np.testing.assert_array_equal(got["c"].boundaries, want["c"].boundaries)
    np.testing.assert_array_equal(got["c"].values, want["c"].values)
    flat = accumulate_depth_numpy(layout, np.zeros(3, np.int64),
                                  np.array([100, 9000, 9500]), np.array([1000, 9800, 10000]), 15)
    np.testing.assert_array_equal(got["c"].materialize(), flat[:39_999])


@pytest.mark.parametrize("backend", ["resident", "sharded", "streamed"])
def test_no_consumer_writes_the_shared_run_arrays(rng, monkeypatch, tmp_path, backend):
    """Each backend's events may be views of the run arrays that
    ``events_from_boundaries`` got.  Gap masking, the two-type max, the
    issue BED, the checkpoint and the report (its regions read the
    events) leave those arrays as they were."""
    from gci_tpu_torch.depth import fused, sharded
    from gci_tpu_torch.io.depth_file import write_depth_gz
    from gci_tpu_torch.io.fasta import mask_gaps_in_depths
    from gci_tpu_torch.parallel.mesh import make_mesh
    from gci_tpu_torch.reports.writers import emit_issue_bed
    from gci_tpu_torch.score.report import compute_continuity_report

    module = {"resident": fused, "sharded": sharded, "streamed": streamed}[backend]
    seen = []
    real = module.events_from_boundaries

    def spy(layout, idx, vals):
        seen.append((idx, vals, idx.copy(), vals.copy()))
        return real(layout, idx, vals)

    monkeypatch.setattr(module, "events_from_boundaries", spy)
    layout = GenomeLayout.from_targets(TARGETS)

    def events(tid, start, end):
        if backend == "resident":
            return fused.DeviceDepth.from_reads(layout, tid, start, end, 15,
                                                device=CPU).to_events()
        if backend == "sharded":
            mesh = make_mesh(8, dp=2, devices=[CPU] * 8)
            return sharded.ShardedDepth.from_reads(mesh, layout, tid, start, end,
                                                   15).to_events()
        return streamed.events_from_reads_streamed(layout, tid, start, end, 15, 1024,
                                                   device=CPU)

    hifi, nano = events(*_random_reads(rng, 300)), events(*_random_reads(rng, 200))
    assert len(seen) == 2
    for ev, (_, vals, _, _) in zip((hifi, nano), seen):
        assert any(np.shares_memory(e.values, vals) for e in ev.values())
    gaps = {"a": [(0, 40), (500, 900)], "c": [(10, 20)]}
    merged = {t: e.maximum(nano[t]) for t, e in mask_gaps_in_depths(dict(hifi), gaps).items()}
    types = {"HiFi": hifi, "Nano": nano, "HiFi + Nano": merged}
    beds = []
    for k, (name, d) in enumerate(types.items()):
        beds.append(emit_issue_bed(d, f"t{k}", 0, 15, str(tmp_path), True, name))
        write_depth_gz(str(tmp_path / f"t{k}.depth.gz"), d)
    compute_continuity_report(dict(TARGETS), "t", str(tmp_path), True, beds, list(types),
                              regions_bed={"a": [(100, 8000)], "b": [(0, 7000)]},
                              depths_list=list(types.values()))
    for idx, vals, idx0, vals0 in seen:
        np.testing.assert_array_equal(idx, idx0)
        np.testing.assert_array_equal(vals, vals0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_slots", [1001, 4096, 1_500_007])
def test_delta_readout_on_cuda_matches_cpu(cuda_device, chunk_slots):
    """The read-out of one accumulated delta on the card equals the CPU's:
    a genome of 3,000,003 slots, chunk borders inside runs (1001 slots:
    every border but the first at an unaligned address, so the chunk is
    copied for the scan), one chunk past 2^20 slots; per chunk one K2 and
    one run-form compaction, and no relaunch."""
    targets = {"c1": 2_000_000, "c2": 1_000_001}
    layout = GenomeLayout.from_targets(targets)
    rng = np.random.default_rng(11)
    n = 6000
    names = [f"r{int(rng.integers(0, 4000))}".encode() for _ in range(n)]
    tid = rng.integers(0, 2, n).astype(np.int32)
    L = np.array(list(targets.values()))[tid]
    start = (L * rng.random(n) * 0.98).astype(np.int64)
    end = np.minimum(start + rng.integers(30, 40_000, n), L)
    keys = hash_names(names)

    def run(dev):
        acc = _accumulate(overlap.DeltaAccumulator(layout, 15, device=dev), keys,
                          dedup_last_wins, keys_view, tid, start, end)
        return streamed.events_from_delta2d_streamed(layout, acc.take_delta(), chunk_slots,
                                                     rows=acc.rows)

    want = run(CPU)
    kernels.reset_launch_counts()
    got = run(cuda_device)
    torch.cuda.synchronize()
    n_chunks = -(-layout.total_slots // chunk_slots)
    assert kernels.LAUNCHES["depth_scan"] == n_chunks
    assert kernels.LAUNCHES["compact_runs"] == n_chunks
    assert kernels.RELAUNCHES["compact_runs"] == 0
    _assert_events_equal(got, want, targets)
    _assert_events_equal(got, _batch_events(JaxGenomeLayout.from_targets(targets), names,
                                            tid, start, end), targets)
