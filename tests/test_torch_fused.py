"""The port's DeviceDepth (gci_tpu_torch.depth.fused) against gci_tpu's.

Both sides get the same numpy reads and gaps; the port runs on the CPU
(its kernels' plain versions), the reference on JAX's CPU backend.  Every
comparison is exact: depths, events and interval dicts are integers.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gci_tpu.depth.accum import (
    GenomeLayout,
    accumulate_depth_numpy,
    clamp_read_intervals,
    depth_dict_from_flat,
)
from gci_tpu.depth.fused import DeviceDepth as JaxDeviceDepth
from gci_tpu.intervals.collapse import collapse_depth_runs
from gci_tpu_torch.depth import device as tdevice
from gci_tpu_torch.depth.fused import DeviceDepth, compact_indices

CPU = torch.device("cpu")


def _reads(rng, layout, n, max_start, span=(40, 900)):
    tid = rng.integers(0, len(layout.names), n).astype(np.int32)
    start = rng.integers(0, max_start, n).astype(np.int64)
    end = start + rng.integers(span[0], span[1], n)
    return tid, start, end


def _assert_events_equal(a, b):
    assert a.keys() == b.keys()
    for t in a:
        np.testing.assert_array_equal(a[t].materialize(), b[t].materialize())


def _assert_dicts_equal(a, b):
    assert a.keys() == b.keys()
    for t in a:
        np.testing.assert_array_equal(a[t], b[t])


CASES = {
    # name: (targets, n_reads, max_start, gaps)
    "gaps": ({"a": 5000, "b": 3000}, 400, 2500,
             {"a": [(100, 220), (4000, 4100)], "b": [(0, 64)]}),
    "no_gaps": ({"a": 6000, "b": 2000}, 350, 1500, None),
    "zero_reads": ({"a": 3000, "b": 1000}, 0, 1, {"a": [(10, 50)]}),
    # a target shorter than 2*flank has an empty scan window
    "short_target": ({"a": 4000, "tiny": 20, "b": 2500}, 300, 19,
                     {"b": [(2400, 2500)]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("threshold", [0, 2])
def test_device_depth_matches_jax(rng, case, threshold):
    targets, n, max_start, gaps = CASES[case]
    layout = GenomeLayout.from_targets(targets)
    tid, start, end = _reads(rng, layout, n, max_start)
    flank = 15
    ref = JaxDeviceDepth.from_reads(layout, tid, start, end, flank, gaps=gaps,
                                    issue_range=(-1, threshold))
    got = DeviceDepth.from_reads(layout, tid, start, end, flank, gaps=gaps,
                                 issue_range=(-1, threshold), device=CPU)
    _assert_dicts_equal(got.materialize_dict(), ref.materialize_dict())
    _assert_dicts_equal(
        got.materialize_dict(),
        depth_dict_from_flat(layout, accumulate_depth_numpy(layout, tid, start, end, flank)),
    )
    _assert_events_equal(got.to_events(), ref.to_events())
    # unmasked collapse at the run threshold and at another one
    for hi in (threshold, threshold + 1):
        assert got.collapse_dict(-1, hi, flank) == ref.collapse_dict(-1, hi, flank)

    gm, rm = got.mask_gaps(gaps), ref.mask_gaps(gaps)
    _assert_dicts_equal(gm.materialize_dict(), rm.materialize_dict())
    _assert_events_equal(gm.to_events(), rm.to_events())
    for hi in (threshold, threshold + 1):
        assert gm.collapse_dict(-1, hi, flank) == rm.collapse_dict(-1, hi, flank)

    # two-type max against a second read set, then the merged value's views
    tid2, start2, end2 = _reads(rng, layout, n // 2, max_start)
    got2 = DeviceDepth.from_reads(layout, tid2, start2, end2, flank, gaps=gaps,
                                  issue_range=(-1, threshold), device=CPU)
    ref2 = JaxDeviceDepth.from_reads(layout, tid2, start2, end2, flank, gaps=gaps,
                                     issue_range=(-1, threshold))
    gx = gm.maximum(got2.mask_gaps(gaps)).mask_gaps(gaps)
    rx = rm.maximum(ref2.mask_gaps(gaps)).mask_gaps(gaps)
    _assert_dicts_equal(gx.materialize_dict(), rx.materialize_dict())
    _assert_events_equal(gx.to_events(), rx.to_events())
    assert gx.collapse_dict(-1, threshold, flank) == rx.collapse_dict(-1, threshold, flank)


def test_from_delta_matches_from_reads(rng):
    """The accumulated-delta entry builds the identical value as from_reads."""
    layout = GenomeLayout.from_targets({"a": 6000, "b": 2000})
    tid, start, end = _reads(rng, layout, 350, 1500, span=(40, 400))
    gaps = {"a": [(500, 700)]}
    dd1 = DeviceDepth.from_reads(layout, tid, start, end, 15, gaps=gaps, device=CPU)
    gs, ge, live = tdevice.pack_read_deltas(layout, tid, start, end, 15)
    delta = np.zeros(layout.total_slots, np.int32)
    np.add.at(delta, gs, live)
    np.add.at(delta, ge, -live)
    dd2 = DeviceDepth.from_delta(layout, torch.from_numpy(delta), 15, gaps=gaps)
    _assert_dicts_equal(dd1.materialize_dict(), dd2.materialize_dict())
    m1, m2 = dd1.mask_gaps(gaps), dd2.mask_gaps(gaps)
    assert m1.collapse_dict(-1, 0, 15) == m2.collapse_dict(-1, 0, 15)
    _assert_events_equal(dd1.to_events(), dd2.to_events())


@pytest.mark.parametrize("masked", [False, True])
def test_from_state_round_trips_jax_arrays(rng, masked):
    """A value built from a JAX DeviceDepth's arrays answers like it."""
    layout = GenomeLayout.from_targets({"a": 5000, "b": 3000})
    tid, start, end = _reads(rng, layout, 300, 2500)
    gaps = {"a": [(100, 220)], "b": [(0, 64)]}
    ref = JaxDeviceDepth.from_reads(layout, tid, start, end, 15, gaps=gaps)
    if masked:
        ref = ref.mask_gaps(gaps)
    got = DeviceDepth.from_state(
        layout, np.asarray(ref.array),
        None if ref.gap_marks is None else np.asarray(ref.gap_marks),
        ref.gap_bit, device=CPU, gaps_src=gaps,
    )
    _assert_dicts_equal(got.materialize_dict(), ref.materialize_dict())
    _assert_events_equal(got.to_events(), ref.to_events())
    for hi in (0, 1):
        assert got.collapse_dict(-1, hi, 15) == ref.collapse_dict(-1, hi, 15)
    _assert_events_equal(got.mask_gaps(gaps).to_events(), ref.mask_gaps(gaps).to_events())


def test_from_state_rejects_nonzero_padding():
    layout = GenomeLayout.from_targets({"a": 100})
    arr = np.zeros(layout.total_slots + 8, np.int32)
    arr[-1] = 3
    with pytest.raises(ValueError):
        DeviceDepth.from_state(layout, arr, device=CPU)


def test_overlapping_gaps_are_refused(rng):
    layout = GenomeLayout.from_targets({"a": 1000})
    tid, start, end = _reads(rng, layout, 10, 500)
    with pytest.raises(ValueError):
        DeviceDepth.from_reads(layout, tid, start, end, 15,
                               gaps={"a": [(100, 300), (200, 400)]}, device=CPU)


# ---------------------------------------------------------------------------
# the flags scan beyond the packed word's depth bound
# ---------------------------------------------------------------------------

def _lower_limits(monkeypatch, limit=0):
    """Force both packages' constructors onto the flags scan (limit 0 takes
    it even with no reads)."""
    import gci_tpu.depth.fused as jax_fused
    import gci_tpu_torch.depth.fused as fused

    monkeypatch.setattr(fused, "PACKED_DEPTH_LIMIT", limit)
    monkeypatch.setattr(jax_fused, "PACKED_DEPTH_LIMIT", limit)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("threshold", [0, 2])
def test_fallback_flags_path_matches_packed_and_jax(rng, monkeypatch, case, threshold):
    """from_reads at the lowered limit against the packed path and against
    gci_tpu's forced fallback (test_fused_backend.py:235-261)."""
    targets, n, max_start, gaps = CASES[case]
    layout = GenomeLayout.from_targets(targets)
    tid, start, end = _reads(rng, layout, n, max_start)
    kw = dict(gaps=gaps, issue_range=(-1, threshold))
    packed = DeviceDepth.from_reads(layout, tid, start, end, 15, device=CPU, **kw)
    _lower_limits(monkeypatch)
    got = DeviceDepth.from_reads(layout, tid, start, end, 15, device=CPU, **kw)
    ref = JaxDeviceDepth.from_reads(layout, tid, start, end, 15, **kw)
    assert got.gap_bit == ref.gap_bit == 1
    assert (got.gap_marks is None) == (ref.gap_marks is None) == (gaps is None)
    if case == "gaps":
        assert packed.gap_bit == 8
    for other in (packed, ref):
        _assert_dicts_equal(got.materialize_dict(), other.materialize_dict())
        _assert_events_equal(got.to_events(), other.to_events())
        for hi in (threshold, threshold + 1):
            assert got.collapse_dict(-1, hi, 15) == other.collapse_dict(-1, hi, 15)
        gm, om = got.mask_gaps(gaps), other.mask_gaps(gaps)
        _assert_dicts_equal(gm.materialize_dict(), om.materialize_dict())
        _assert_events_equal(gm.to_events(), om.to_events())
        for hi in (threshold, threshold + 1):
            assert gm.collapse_dict(-1, hi, 15) == om.collapse_dict(-1, hi, 15)


def test_fallback_takes_the_flags_kernel(rng, monkeypatch):
    """At the limit from_reads runs the flags scan and not the packed one,
    and counts reads, not depth: limit - 1 reads stay packed."""
    import gci_tpu_torch.depth.fused as fused

    calls = []
    for name in ("fused_depth_scan_flags", "fused_depth_scan_packed"):
        real = getattr(fused, name)
        monkeypatch.setattr(fused, name, lambda *a, _n=name, _f=real: (calls.append(_n), _f(*a))[1])
    layout = GenomeLayout.from_targets({"a": 3000})
    tid, start, end = _reads(rng, layout, 20, 2000)
    monkeypatch.setattr(fused, "PACKED_DEPTH_LIMIT", 20)
    DeviceDepth.from_reads(layout, tid, start, end, 15, device=CPU)
    monkeypatch.setattr(fused, "PACKED_DEPTH_LIMIT", 21)
    DeviceDepth.from_reads(layout, tid, start, end, 15, device=CPU)
    assert calls == ["fused_depth_scan_flags", "fused_depth_scan_packed"]


def _delta_of(layout, tid, start, end):
    gs, ge, live = tdevice.pack_read_deltas(layout, tid, start, end, 15)
    delta = np.zeros(layout.total_slots, np.int32)
    np.add.at(delta, gs, live)
    np.add.at(delta, ge, -live)
    return delta


@pytest.mark.parametrize("at_limit", [True, False])
def test_from_delta_guard_matches_from_reads(rng, monkeypatch, at_limit):
    """from_delta takes the flags scan once the sum of its positive deltas
    reaches the limit, and builds the same value as from_reads on the packed
    path and as gci_tpu's from_delta (test_fused_backend.py:264-294)."""
    import gci_tpu_torch.depth.fused as fused

    layout = GenomeLayout.from_targets({"a": 6000, "b": 2000})
    tid, start, end = _reads(rng, layout, 350, 1500, span=(40, 400))
    gaps = {"a": [(500, 700)]}
    packed = DeviceDepth.from_reads(layout, tid, start, end, 15, gaps=gaps, device=CPU)
    delta = _delta_of(layout, tid, start, end)
    jax_pad = JaxDeviceDepth.pad_total_for(layout.total_slots) - delta.shape[0]
    ref = JaxDeviceDepth.from_delta(layout, jnp.asarray(np.pad(delta, (0, jax_pad))), 15,
                                    gaps=gaps)
    bound = int(np.clip(delta, 0, None).sum())
    monkeypatch.setattr(fused, "PACKED_DEPTH_LIMIT", bound if at_limit else bound + 1)
    got = DeviceDepth.from_delta(layout, torch.from_numpy(delta), 15, gaps=gaps)
    assert got.gap_bit == (1 if at_limit else 8)
    for other in (packed, ref):
        _assert_dicts_equal(got.materialize_dict(), other.materialize_dict())
        assert got.mask_gaps(gaps).collapse_dict(-1, 0, 15) == (
            other.mask_gaps(gaps).collapse_dict(-1, 0, 15)
        )
        _assert_events_equal(got.to_events(), other.to_events())
        _assert_events_equal(got.mask_gaps(gaps).to_events(), other.mask_gaps(gaps).to_events())


def test_from_delta_guard_stops_the_packed_word_wrapping():
    """A depth past the limit (2^30 + 3 over 50 slots) wraps the packed
    word: scanned unguarded it reads back as depth 3.  The guarded
    from_delta takes the flags scan and keeps the depth exact."""
    from gci_tpu_torch.depth.fused import PACKED_DEPTH_LIMIT
    from gci_tpu_torch.depth.scan import fused_depth_scan_packed_torch

    layout = GenomeLayout.from_targets({"a": 200})
    deep = (1 << 30) + 3
    assert deep >= PACKED_DEPTH_LIMIT
    delta = np.zeros(layout.total_slots, np.int32)
    delta[40], delta[90] = deep, -deep
    delta[60], delta[150] = 2, -2
    want = np.cumsum(delta).astype(np.int32)[:200]  # target "a", not its end slot
    unguarded, _ = fused_depth_scan_packed_torch(torch.from_numpy(delta) * 4, -1, 0)
    assert unguarded[40].item() == 3 and want[40] == deep
    gaps = {"a": [(80, 120)]}
    got = DeviceDepth.from_delta(layout, torch.from_numpy(delta), 15, gaps=gaps)
    assert got.gap_bit == 1
    np.testing.assert_array_equal(got.materialize_dict()["a"], want)
    np.testing.assert_array_equal(got.to_events()["a"].materialize(), want)
    masked = want.copy()
    masked[80:120] = 0
    np.testing.assert_array_equal(got.mask_gaps(gaps).materialize_dict()["a"], masked)
    assert got.mask_gaps(gaps).collapse_dict(-1, 2, 15)["a"] == collapse_depth_runs(
        masked, -1, 2, 15
    )


# ---------------------------------------------------------------------------
# depth_and_edges_fused (the single-chip fused entry of device.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hi", [0, 2])
def test_depth_and_edges_fused_matches_jax(rng, monkeypatch, hi):
    """gci_tpu's entry runs its Pallas kernel in interpret mode here, on
    8-row chunks (the axis padded to 1024 slots)."""
    import functools

    from gci_tpu.depth import device as jdevice
    from gci_tpu.depth import pallas_scan

    monkeypatch.setattr(pallas_scan, "fused_depth_scan", functools.partial(
        pallas_scan.fused_depth_scan, rows=8, interpret=True))
    layout = GenomeLayout.from_targets({"a": 5000, "t": 20, "b": 2900})
    total = layout.total_slots + (-layout.total_slots) % 1024
    tid, start, end = _reads(rng, layout, 300, 2500)
    gs, ge, live = tdevice.pack_read_deltas(layout, tid, start, end, 15, pad_to=320)
    valid = tdevice.build_scan_valid(layout, 15, pad_to=total).astype(np.int8)
    got = tdevice.depth_and_edges_fused(gs, ge, live, valid, -1, hi, total, device=CPU)
    want = jdevice.depth_and_edges_fused(
        jnp.asarray(gs), jnp.asarray(ge), jnp.asarray(live), jnp.asarray(valid), -1, hi, total
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        got[0][: layout.total_slots].numpy(),
        accumulate_depth_numpy(layout, tid, start, end, 15),
    )


def test_depth_and_edges_fused_refuses_out_of_range_reads(rng):
    """gci_tpu drops such indices silently; the port raises."""
    layout = GenomeLayout.from_targets({"a": 3000})
    tid, start, end = _reads(rng, layout, 30, 2000)
    gs, ge, live = tdevice.pack_read_deltas(layout, tid, start, end, 15)
    valid = np.ones(layout.total_slots, np.int8)
    with pytest.raises(IndexError):
        tdevice.depth_and_edges_fused(gs, ge, live, valid[:-1000], -1, 0,
                                      layout.total_slots - 1000, device=CPU)


def test_compact_indices_matches_jax(rng):
    from gci_tpu.depth.fused import compact_indices as jax_compact

    bitmap = (rng.random(5000) < 0.01).astype(np.int8)
    got = compact_indices(torch.from_numpy(bitmap))
    np.testing.assert_array_equal(got, jax_compact(jnp.asarray(bitmap)))
    np.testing.assert_array_equal(got, np.flatnonzero(bitmap))
    assert compact_indices(torch.zeros(64, dtype=torch.int8)).shape == (0,)


def _bitmap(rng, kind, dtype, n=5000):
    """A bitmap set nowhere, everywhere, only at slot 0, only at the last
    slot, or at random; int8 bitmaps hold truth bytes other than 1."""
    on = np.zeros(n, bool)
    if kind == "all":
        on[:] = True
    elif kind == "first":
        on[0] = True
    elif kind == "last":
        on[-1] = True
    elif kind == "random":
        on = rng.random(n) < 0.01
    if dtype == "bool":
        return on
    return np.where(on, rng.choice([1, 2, -1, -128], n), 0).astype(np.int8)


@pytest.mark.parametrize("kind", ["empty", "all", "first", "last", "random"])
@pytest.mark.parametrize("dtype", ["bool", "int8"])
def test_compact_indices_edge_bitmaps_match_jax(rng, kind, dtype):
    from gci_tpu.depth.fused import compact_indices as jax_compact

    bitmap = _bitmap(rng, kind, dtype)
    got = compact_indices(torch.from_numpy(bitmap))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jax_compact(jnp.asarray(bitmap)))
    np.testing.assert_array_equal(got, np.flatnonzero(bitmap))


def test_host_helpers_match_jax_module(rng):
    """The copied host helpers equal gci_tpu.depth.device's."""
    from gci_tpu.depth import device as jdevice

    layout = GenomeLayout.from_targets({"a": 3000, "t": 20, "b": 900})
    tid, start, end = _reads(rng, layout, 200, 800)
    for got, want in zip(
        tdevice.pack_read_deltas(layout, tid, start, end, 15, pad_to=256),
        jdevice.pack_read_deltas(layout, tid, start, end, 15, pad_to=256),
    ):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tdevice.build_scan_valid(layout, 15), jdevice.build_scan_valid(layout, 15)
    )
    rise = np.sort(rng.choice(layout.total_slots, 40, replace=False))
    fall = np.sort(rng.choice(layout.total_slots, 40, replace=False))
    for sp in (0, 7):
        assert tdevice.edge_indices_to_intervals(layout, rise, fall, 15, sp) == (
            jdevice.edge_indices_to_intervals(layout, rise, fall, 15, sp)
        )


# ---------------------------------------------------------------------------
# the run form the read-out gets
# ---------------------------------------------------------------------------

# a one-slot, a zero-length and a short target among long ones; the gaps
# start on a target's first slot and end on another's last
RUN_FORM_TARGETS = {"a": 5000, "one": 1, "z": 0, "b": 3000, "tiny": 20}
RUN_FORM_GAPS = {"a": [(0, 120), (4000, 4100)], "b": [(2900, 3000)], "tiny": [(5, 9)]}


def _run_form_reads(rng, layout):
    """Reads over every target, one on every other target's first slot."""
    tid, start, end = _reads(rng, layout, 400, 2500)
    firsts = np.arange(0, len(layout.names), 2)
    tid[:firsts.shape[0]], start[:firsts.shape[0]] = firsts, 0
    start = np.minimum(start, layout.lengths[tid])
    return tid, start, np.maximum(end, start + 1)


@pytest.mark.parametrize("case", ["packed", "flags", "masked", "maximum", "from_state"])
def test_resident_runs_keep_the_invariant(rng, monkeypatch, case):
    """What ``events_from_boundaries`` gets from each source of the run
    form (the scans' change bit on the packed and flags paths, the run-form
    compaction of masked, merged and ``from_state`` values) is int64,
    strictly increasing from slot 0 with neighbouring depths different, and
    the events equal gci_tpu's array by array (flank 0: a read may start
    on a target's first slot)."""
    import gci_tpu_torch.depth.fused as fused

    seen = []
    real = fused.events_from_boundaries
    monkeypatch.setattr(fused, "events_from_boundaries",
                        lambda layout, idx, vals: (seen.append((idx, vals)),
                                                   real(layout, idx, vals))[1])
    layout = GenomeLayout.from_targets(RUN_FORM_TARGETS)
    tid, start, end = _run_form_reads(rng, layout)
    if case == "flags":
        _lower_limits(monkeypatch)
    kw = dict(gaps=RUN_FORM_GAPS, issue_range=(-1, 1))
    got = DeviceDepth.from_reads(layout, tid, start, end, 0, device=CPU, **kw)
    ref = JaxDeviceDepth.from_reads(layout, tid, start, end, 0, **kw)
    if case == "masked":
        got, ref = got.mask_gaps(RUN_FORM_GAPS), ref.mask_gaps(RUN_FORM_GAPS)
    elif case == "maximum":
        tid2, start2, end2 = _run_form_reads(rng, layout)
        got = got.maximum(DeviceDepth.from_reads(layout, tid2, start2, end2, 0,
                                                 device=CPU, **kw))
        ref = ref.maximum(JaxDeviceDepth.from_reads(layout, tid2, start2, end2, 0, **kw))
    elif case == "from_state":
        got = DeviceDepth.from_state(layout, np.asarray(ref.array), device=CPU)
    events = got.to_events()
    ((idx, vals),) = seen
    assert idx.dtype == vals.dtype == np.int64
    assert idx[0] == 0 and np.all(np.diff(idx) > 0)
    assert np.all(vals[1:] != vals[:-1])
    want = ref.to_events()
    assert list(events) == list(want) == list(RUN_FORM_TARGETS)
    for t in want:
        np.testing.assert_array_equal(events[t].boundaries, want[t].boundaries, err_msg=t)
        np.testing.assert_array_equal(events[t].values, want[t].values, err_msg=t)
        assert events[t].length == want[t].length, t


def _wrapping_reads(rng, layout, n, max_start):
    """Reads that start before 0, end past their target or end below 0
    (the reference slice's wrap)."""
    tid, start, end = _reads(rng, layout, n, max_start)
    start = start - rng.integers(0, 3000, n)
    return tid, start, start + rng.integers(-2000, 7000, n)


@pytest.mark.parametrize("pad_to", [None, 10, 1000])
@pytest.mark.parametrize("case", ["wrapping", "int64_ids", "zero_reads"])
def test_pack_read_deltas_clamps_wrapping_reads(rng, case, pad_to):
    """``pack_read_deltas`` equals the whole read set's clamp plus its
    target's offset, as int32 and zero-padded, and ``gci_tpu``'s."""
    from gci_tpu.depth import device as jdevice

    layout = GenomeLayout.from_targets({"a": 5000, "tiny": 20, "b": 3000})
    n = 0 if case == "zero_reads" else 300
    tid, start, end = _wrapping_reads(rng, layout, n, 2500)
    if case == "int64_ids":
        tid = tid.astype(np.int64)
    s, e = clamp_read_intervals(layout, tid, start, end, 15)
    base = layout.offsets[tid]
    pad = max(0, (pad_to or 0) - n)
    want = [np.concatenate([x.astype(np.int32), np.zeros(pad, np.int32)])
            for x in (base + s, base + e, e > s)]
    got = tdevice.pack_read_deltas(layout, tid, start, end, 15, pad_to=pad_to)
    ref = jdevice.pack_read_deltas(layout, tid, start, end, 15, pad_to=pad_to)
    for g, w, r in zip(got, want, ref):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.asarray(r))


@pytest.mark.cuda
def test_held_outputs_share_no_buffer_on_cuda(rng):
    """Two values built on the card one after the other, both held: each
    one's run form and events equal the CPU's, and no array of the first
    shares memory with the second's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cuda = torch.device("cuda", torch.cuda.current_device())
    targets, n, max_start, _ = CASES["no_gaps"]
    layout = GenomeLayout.from_targets(targets)
    sets = [_reads(rng, layout, n, max_start) for _ in range(2)]
    held = [DeviceDepth.from_reads(layout, *reads, 15, device=cuda) for reads in sets]
    events = [d.to_events() for d in held]
    for d, ev, reads in zip(held, events, sets):
        want = DeviceDepth.from_reads(layout, *reads, 15, device=CPU)
        for a, b in zip(d._runs, want._runs):
            np.testing.assert_array_equal(a, b)
        _assert_events_equal(ev, want.to_events())
    first = list(held[0]._runs) + [a for e in events[0].values() for a in (e.boundaries, e.values)]
    second = list(held[1]._runs) + [a for e in events[1].values() for a in (e.boundaries, e.values)]
    assert not any(np.shares_memory(a, b) for a in first for b in second)


@pytest.mark.cuda
def test_device_depth_on_cuda_matches_cpu(rng):
    """The same value built on the card (kernels) and on the CPU (plain)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cuda = torch.device("cuda", torch.cuda.current_device())
    targets, n, max_start, gaps = CASES["gaps"]
    layout = GenomeLayout.from_targets(targets)
    tid, start, end = _reads(rng, layout, n, max_start)
    got = DeviceDepth.from_reads(layout, tid, start, end, 15, gaps=gaps,
                                 issue_range=(-1, 1), device=cuda)
    want = DeviceDepth.from_reads(layout, tid, start, end, 15, gaps=gaps,
                                  issue_range=(-1, 1), device=CPU)
    assert got.array.device.type == "cuda"
    _assert_dicts_equal(got.materialize_dict(), want.materialize_dict())
    _assert_events_equal(got.to_events(), want.to_events())
    gm, wm = got.mask_gaps(gaps), want.mask_gaps(gaps)
    for hi in (1, 2):
        assert gm.collapse_dict(-1, hi, 15) == wm.collapse_dict(-1, hi, 15)
    _assert_events_equal(gm.maximum(gm).to_events(), wm.maximum(wm).to_events())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097, 5_000_011])
@pytest.mark.parametrize("kind", ["empty", "all", "first", "last", "random"])
def test_compact_on_cuda_matches_nonzero(rng, n, kind):
    """The compaction on the card (the flag form of the compaction kernel
    on the bool bitmap) against torch.nonzero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from gci_tpu_torch.depth.scan import compact_flags

    cuda = torch.device("cuda", torch.cuda.current_device())
    bits = torch.from_numpy(_bitmap(rng, kind, "bool", n)).to(cuda)
    (got,) = compact_flags(bits.view(torch.int8), (1,))
    assert torch.equal(got, torch.nonzero(bits).squeeze(1))


@pytest.mark.cuda
def test_fallback_on_cuda_matches_cpu(rng, monkeypatch):
    """The flags-scan construction on the card (K3, K2) against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cuda = torch.device("cuda", torch.cuda.current_device())
    _lower_limits(monkeypatch)
    targets, n, max_start, gaps = CASES["gaps"]
    layout = GenomeLayout.from_targets(targets)
    tid, start, end = _reads(rng, layout, n, max_start)
    got = DeviceDepth.from_reads(layout, tid, start, end, 15, gaps=gaps,
                                 issue_range=(-1, 1), device=cuda)
    want = DeviceDepth.from_reads(layout, tid, start, end, 15, gaps=gaps,
                                  issue_range=(-1, 1), device=CPU)
    assert got.gap_bit == want.gap_bit == 1
    _assert_dicts_equal(got.materialize_dict(), want.materialize_dict())
    _assert_events_equal(got.to_events(), want.to_events())
    gm, wm = got.mask_gaps(gaps), want.mask_gaps(gaps)
    for hi in (1, 2):
        assert gm.collapse_dict(-1, hi, 15) == wm.collapse_dict(-1, hi, 15)
    delta = torch.from_numpy(_delta_of(layout, tid, start, end))
    got = DeviceDepth.from_delta(layout, delta.to(cuda), 15, gaps=gaps)
    want = DeviceDepth.from_delta(layout, delta, 15, gaps=gaps)
    assert got.gap_bit == want.gap_bit == 1
    _assert_events_equal(got.to_events(), want.to_events())
