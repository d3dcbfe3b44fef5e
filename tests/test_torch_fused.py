"""The port's DeviceDepth (gci_tpu_torch.depth.fused) against gci_tpu's.

Both sides get the same numpy reads and gaps; the port runs on the CPU
(its kernels' plain versions), the reference on JAX's CPU backend.  Every
comparison is exact: depths, events and interval dicts are integers.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gci_tpu.depth.accum import GenomeLayout, accumulate_depth_numpy, depth_dict_from_flat
from gci_tpu.depth.fused import DeviceDepth as JaxDeviceDepth
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
    delta = np.zeros(DeviceDepth.pad_total_for(layout.total_slots), np.int32)
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


def test_packed_depth_limit_is_not_ported(monkeypatch, rng):
    import gci_tpu_torch.depth.fused as fused

    layout = GenomeLayout.from_targets({"a": 1000})
    tid, start, end = _reads(rng, layout, 10, 500)
    monkeypatch.setattr(fused, "PACKED_DEPTH_LIMIT", 5)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        DeviceDepth.from_reads(layout, tid, start, end, 15, device=CPU)


def test_compact_indices_matches_jax(rng):
    from gci_tpu.depth.fused import compact_indices as jax_compact

    bitmap = (rng.random(5000) < 0.01).astype(np.int8)
    got = compact_indices(torch.from_numpy(bitmap))
    np.testing.assert_array_equal(got, jax_compact(jnp.asarray(bitmap)))
    np.testing.assert_array_equal(got, np.flatnonzero(bitmap))
    assert compact_indices(torch.zeros(64, dtype=torch.int8)).shape == (0,)


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
