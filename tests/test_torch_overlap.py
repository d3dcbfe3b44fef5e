"""The port's pack<->scatter overlap (gci_tpu_torch.depth.overlap) against
gci_tpu's.

The same seeded numpy inputs go through ``gci_tpu.depth.overlap`` (on JAX's
CPU backend) and the port's copy on the CPU (its kernels' plain versions);
every comparison is exact: integer arrays equal, checkpoints byte-equal
after inflating.  ``feed_bam`` packs real BAMs into either accumulator and
is held against ``gci_tpu``'s own overlap run of ``run_filter``.  The
``cuda``-marked case holds both accumulators on the card against their CPU
runs.
"""
import gzip

import numpy as np
import pytest
import torch

from gci_tpu.depth import overlap as jax_overlap
from gci_tpu.depth.accum import GenomeLayout as JaxGenomeLayout
from gci_tpu.depth.eventspace import events_dict_from_reads as jax_events_dict
from gci_tpu.depth.fused import DeviceDepth as JaxDeviceDepth
from gci_tpu.filters.cascade import dedup_last_wins as jax_dedup
from gci_tpu.io.names import hash_names as jax_hash_names
from gci_tpu.io.names import keys_view as jax_keys_view
from gci_tpu.pipeline import run_filter as jax_run_filter
from gci_tpu_torch import kernels
from gci_tpu_torch.depth import fused, overlap, streamed
from gci_tpu_torch.depth.accum import GenomeLayout, accumulate_depth_numpy
from gci_tpu_torch.depth.device import scatter_events_into
from gci_tpu_torch.depth.fused import DeviceDepth
from gci_tpu_torch.filters.cascade import dedup_last_wins
from gci_tpu_torch.io.bam import BamStream
from gci_tpu_torch.io.bam_writer import build_record, write_bam
from gci_tpu_torch.io.depth_file import write_depth_gz
from gci_tpu_torch.io.names import hash_names, keys_view

CPU = torch.device("cpu")
FLANK = 15


def _assert_events_equal(got, want):
    """Event lists equal as arrays (boundaries, values, length) and per base."""
    assert list(got) == list(want)
    for t in want:
        g, w = got[t], want[t]
        np.testing.assert_array_equal(g.boundaries, w.boundaries, err_msg=t)
        np.testing.assert_array_equal(g.values, w.values, err_msg=t)
        assert g.length == w.length, t
        np.testing.assert_array_equal(g.materialize(), w.materialize(), err_msg=t)


def _feed(accs, keys_pair, tid, start, end, bounds):
    """Feed each (accumulator, package) the chunks ``[bounds[k], bounds[k+1])``
    in file order, each deduped within the chunk by its own package; yields
    after each chunk."""
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        for acc, (keys, dedup, kview) in zip(accs, keys_pair):
            surv = dedup(keys[lo:hi], np.ones(hi - lo, bool)) + lo
            acc.add_chunk(kview(keys[surv]), tid[surv], start[surv], end[surv])
        yield


def _both_keys(names):
    return ((hash_names(names), dedup_last_wins, keys_view),
            (jax_hash_names(names), jax_dedup, jax_keys_view))


def _batch_survivors(names, tid, start, end):
    keys = hash_names(names)
    surv = dedup_last_wins(keys, np.ones(len(names), bool))
    return tid[surv], start[surv], end[surv]


# ---------------------------------------------------------------------------
# host parts: LastWinsFold and _adjust_range
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_last_wins_fold_matches_jax(seed):
    """The retract rows of every chunk equal gci_tpu's, on random chunk
    sequences with names repeated within and across chunks."""
    rng = np.random.default_rng(seed)
    n = 700
    names = [f"q{int(rng.integers(0, 200))}".encode() for _ in range(n)]
    tid = rng.integers(0, 3, n).astype(np.int32)
    start = rng.integers(0, 10_000, n).astype(np.int64)
    end = start + rng.integers(1, 500, n)
    bounds = np.unique(np.concatenate([[0, n], rng.integers(0, n, 9)]))
    folds = (overlap.LastWinsFold(), jax_overlap.LastWinsFold())
    n_retracted = 0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        out = []
        for fold, (keys, dedup, kview) in zip(folds, _both_keys(names)):
            surv = dedup(keys[lo:hi], np.ones(hi - lo, bool)) + lo
            out.append(fold.fold(kview(keys[surv]), tid[surv], start[surv], end[surv]))
        for g, w in zip(*out, strict=True):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        n_retracted += out[0][0].shape[0]
    assert n_retracted > 0


@pytest.mark.parametrize("seed", [4, 5, 6, 7])
def test_adjust_range_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        idx = np.unique(rng.integers(0, 1000, int(rng.integers(0, 30)))).astype(np.int64)
        vals = rng.integers(0, 9, idx.shape[0]).astype(np.int64)
        a = int(rng.integers(0, 1000))
        b = int(rng.integers(a + 1, 1001))
        if rng.random() < 0.3 and idx.shape[0]:
            a = int(rng.choice(idx))  # a range starting on a boundary
        args = (a, max(b, a + 1), int(rng.choice([-1, 1])), bool(rng.random() < 0.5),
                int(rng.integers(0, 9)), bool(rng.random() < 0.5), int(rng.integers(0, 9)))
        got = overlap._adjust_range(idx, vals, *args)
        want = jax_overlap._adjust_range(idx, vals, *args)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# DeltaAccumulator and from_delta
# ---------------------------------------------------------------------------

def _duplicate_reads(rng, lens, n=600, pool=250):
    """Reads of the reference's case (tests/test_streamed.py:179-222): names
    drawn from a pool, so many are replaced across chunks, some twice."""
    names = [f"r{int(rng.integers(0, pool))}".encode() for _ in range(n)]
    L = np.asarray(list(lens.values()))
    tid = rng.integers(0, len(lens), n).astype(np.int32)
    start = (L[tid] * rng.random(n) * 0.8).astype(np.int64)
    end = np.minimum(start + rng.integers(30, 900, n), L[tid])
    return names, tid, start, end


@pytest.mark.parametrize("n_chunks", [2, 7, 20])
def test_delta_accumulator_matches_jax_and_oracle(rng, n_chunks):
    """Chunks in file order: the port's resident delta of total_slots
    equals gci_tpu's (one row, trimmed to total_slots) slot for slot, and
    its prefix sum is the depth of the batch survivors."""
    lens = {"c1": 5000, "c2": 3000}
    layout, jlayout = GenomeLayout.from_targets(lens), JaxGenomeLayout.from_targets(lens)
    total = layout.total_slots
    names, tid, start, end = _duplicate_reads(rng, lens)
    acc = overlap.DeltaAccumulator(layout, FLANK, device=CPU)
    jacc = jax_overlap.DeltaAccumulator(jlayout, FLANK, JaxDeviceDepth.pad_total_for(total))
    assert acc.delta.shape == (total,)
    for _ in _feed((acc, jacc), _both_keys(names), tid, start, end,
                   np.linspace(0, len(names), n_chunks + 1).astype(int)):
        pass
    assert acc.chunks_added == n_chunks and acc.rows_retracted > 0
    got = acc.take_delta().numpy()
    assert acc.delta is None
    np.testing.assert_array_equal(got, np.asarray(jacc.delta_flat())[:total])
    np.testing.assert_array_equal(
        np.cumsum(got), accumulate_depth_numpy(layout, *_batch_survivors(
            names, tid, start, end), FLANK))


def test_scatter_events_into_adds_in_place_and_checks_the_range():
    buf = torch.zeros(10, dtype=torch.int32)
    out = scatter_events_into(buf, [(np.array([1, 3, 3]), 2), (np.array([9]), np.array([-5]))])
    assert out is buf
    assert buf.tolist() == [0, 2, 0, 4, 0, 0, 0, 0, 0, -5]
    for bad in ([10], [-1]):
        with pytest.raises(IndexError):
            scatter_events_into(buf, [(np.array(bad), 1)])
    assert buf.tolist() == [0, 2, 0, 4, 0, 0, 0, 0, 0, -5]


@pytest.mark.parametrize("branch", ["packed", "flags"])
def test_from_delta_on_the_accumulated_delta_matches_from_reads(rng, monkeypatch, branch):
    """from_delta on the accumulator's delta builds the value from_reads
    builds on the batch survivors (and gci_tpu's from_delta on its own
    accumulated delta), on the packed branch and on the flags branch."""
    lens = {"c1": 5000, "c2": 3000}
    layout, jlayout = GenomeLayout.from_targets(lens), JaxGenomeLayout.from_targets(lens)
    gaps = {"c1": [(400, 650)], "c2": [(0, 64)]}
    names, tid, start, end = _duplicate_reads(rng, lens)
    acc = overlap.DeltaAccumulator(layout, FLANK, device=CPU)
    jacc = jax_overlap.DeltaAccumulator(jlayout, FLANK, JaxDeviceDepth.pad_total_for(
        layout.total_slots))
    for _ in _feed((acc, jacc), _both_keys(names), tid, start, end,
                   np.linspace(0, len(names), 6).astype(int)):
        pass
    ref = JaxDeviceDepth.from_delta(jlayout, jacc.delta_flat(), FLANK, gaps=gaps,
                                    issue_range=(-1, 1))
    if branch == "flags":
        monkeypatch.setattr(fused, "PACKED_DEPTH_LIMIT", 1)
    want = DeviceDepth.from_reads(layout, *_batch_survivors(names, tid, start, end), FLANK,
                                  gaps=gaps, issue_range=(-1, 1), device=CPU)
    got = DeviceDepth.from_delta(layout, acc.take_delta(), FLANK, gaps=gaps,
                                 issue_range=(-1, 1))
    assert acc.delta is None
    assert got.gap_bit == want.gap_bit == (8 if branch == "packed" else 1)
    for other in (want, ref):
        for g, w in zip(got.materialize_dict().values(),
                        other.materialize_dict().values(), strict=True):
            np.testing.assert_array_equal(g, w)
        _assert_events_equal(got.to_events(), other.to_events())
        gm, om = got.mask_gaps(gaps), other.mask_gaps(gaps)
        for hi in (1, 2):
            assert gm.collapse_dict(-1, hi, FLANK) == om.collapse_dict(-1, hi, FLANK)
        _assert_events_equal(gm.to_events(), om.to_events())


def test_from_delta_builds_the_word_in_the_delta():
    """On the packed branch the event word is built in the delta itself:
    no genome-sized array besides it exists before the scan."""
    layout = GenomeLayout.from_targets({"a": 100})
    delta = torch.zeros(layout.total_slots, dtype=torch.int32)
    delta[20], delta[60] = 1, -1
    DeviceDepth.from_delta(layout, delta, FLANK)
    # delta * 4 plus the scan-window events at 15 (+1) and 85 (-1)
    want = torch.zeros(layout.total_slots, dtype=torch.int32)
    want[20], want[60], want[15], want[85] = 4, -4, 1, -1
    assert torch.equal(delta, want)


# ---------------------------------------------------------------------------
# SweepAccumulator: the reference's three cases (tests/test_streamed.py:261-395)
# ---------------------------------------------------------------------------

def _sweep_pair(lens, chunk_slots):
    layout, jlayout = GenomeLayout.from_targets(lens), JaxGenomeLayout.from_targets(lens)
    return (overlap.SweepAccumulator(layout, FLANK, chunk_slots, device=CPU),
            jax_overlap.SweepAccumulator(jlayout, FLANK, chunk_slots=chunk_slots), jlayout)


def test_sweep_retro_retraction_matches_jax(rng):
    """Sorted reads with names re-used from much earlier records, so
    retractions reach back into finalized chunks (the event-space fixup)."""
    lens = {"c1": 60000, "c2": 40000}
    n = 900
    tid = np.sort(rng.integers(0, 2, n)).astype(np.int32)
    L = np.array([60000, 40000])[tid]
    start = np.sort((L * rng.random(n) * 0.9).astype(np.int64))
    order = np.lexsort((start, tid))
    tid, start = tid[order], start[order]
    L = np.array([60000, 40000])[tid]
    end = np.minimum(start + rng.integers(40, 3000, n), L)
    names = []
    for k in range(n):
        if k > 50 and rng.random() < 0.08:
            names.append(f"r{int(rng.integers(0, max(k - 50, 1)))}".encode())
        else:
            names.append(f"r{k}".encode())
    acc, jacc, jlayout = _sweep_pair(lens, 8192)
    for _ in _feed((acc, jacc), _both_keys(names), tid, start, end,
                   np.linspace(0, n, 10).astype(int)):
        assert acc.frontier == jacc.frontier
    assert acc.frontier > 0, "sweep never finalized a chunk during pack"
    assert acc.rows_retracted > 0
    got, ref = acc.finish(), jacc.finish()
    _assert_events_equal(got, ref)
    _assert_events_equal(got, jax_events_dict(
        jlayout, *_batch_survivors(names, tid, start, end), FLANK))


def test_sweep_unsorted_input_matches_jax(rng):
    """Unsorted reads stop early finalization; the result still matches."""
    lens = {"c1": 30000}
    n = 400
    tid = np.zeros(n, np.int32)
    start = rng.integers(0, 29000, n).astype(np.int64)
    end = np.minimum(start + rng.integers(40, 2000, n), 30000)
    names = [f"r{int(rng.integers(0, 150))}".encode() for _ in range(n)]
    acc, jacc, jlayout = _sweep_pair(lens, 4096)
    for _ in _feed((acc, jacc), _both_keys(names), tid, start, end,
                   np.linspace(0, n, 6).astype(int)):
        assert acc.frontier == jacc.frontier
    assert acc._unsorted and jacc._unsorted
    got, ref = acc.finish(), jacc.finish()
    _assert_events_equal(got, ref)
    _assert_events_equal(got, jax_events_dict(
        jlayout, *_batch_survivors(names, tid, start, end), FLANK))


def test_sweep_retro_add_after_finalization_matches_jax():
    """An add behind the finalization frontier (unsorted input found late)
    applies the +1 event-space fixup."""
    lens = {"c": 40000}
    batches = [
        (np.sort(np.linspace(0, 8000, 40).astype(np.int64)), "a"),
        (np.sort(np.linspace(30000, 36000, 40).astype(np.int64)), "b"),
        (np.array([100, 36500], np.int64), "z"),  # 100 is behind the frontier
    ]
    acc, jacc, jlayout = _sweep_pair(lens, 4096)
    all_s, all_names = [], []
    for si, (s, pfx) in enumerate(batches):
        names = [f"{pfx}{k}".encode() for k in range(s.shape[0])]
        tid = np.zeros(s.shape[0], np.int32)
        for _ in _feed((acc, jacc), _both_keys(names), tid, s, np.minimum(s + 800, 40000),
                       [0, s.shape[0]]):
            assert acc.frontier == jacc.frontier
        if si == 1:
            assert acc.frontier > 0
        all_s.append(s)
        all_names += names
    got, ref = acc.finish(), jacc.finish()
    _assert_events_equal(got, ref)
    s = np.concatenate(all_s)
    _assert_events_equal(got, jax_events_dict(jlayout, *_batch_survivors(
        all_names, np.zeros(s.shape[0], np.int32), s, np.minimum(s + 800, 40000)), FLANK))


def test_sweep_chunk_buffers_have_the_chunks_length():
    """Only the last chunk is short: its buffer is ``total - a`` slots."""
    layout = GenomeLayout.from_targets({"c": 9999})  # 10,000 slots
    acc = overlap.SweepAccumulator(layout, FLANK, 4096, device=CPU)
    assert acc.n_chunks == 3
    assert [acc._chunk_buf(c).shape[0] for c in range(3)] == [4096, 4096, 1808]


def test_sweep_chunk_slots_default_and_range(monkeypatch):
    """Chunks of streamed.CHUNK_SLOTS unless given, read when the sweep is
    made; never more than the genome, with no tile alignment."""
    layout = GenomeLayout.from_targets({"c": 16_152})  # 16,153 slots
    assert overlap.SweepAccumulator(layout, FLANK, 1000, device=CPU).chunk_slots == 1000
    assert overlap.SweepAccumulator(layout, FLANK, 10**6, device=CPU).chunk_slots == 16_153
    monkeypatch.setattr(streamed, "CHUNK_SLOTS", 1024)
    acc = overlap.SweepAccumulator(layout, FLANK, device=CPU)
    assert (acc.chunk_slots, acc.n_chunks) == (1024, 16)
    for bad in (0, 2**31):
        with pytest.raises(ValueError, match="chunk"):
            overlap.SweepAccumulator(layout, FLANK, bad, device=CPU)


# ---------------------------------------------------------------------------
# feed_bam: real BAMs, against gci_tpu's overlap run of run_filter
# ---------------------------------------------------------------------------

REFS = ["cA", "cB", "cC"]
LENS = [30000, 20000, 4096]
BAM_CHUNK = 8 * 1024  # inflated bytes per BAM chunk: many chunks per BAM


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    # imported here: where another package named ``tests`` is installed, a
    # module-level import would stop the cuda-marked case's collection
    from tests.fixtures import make_bam, random_reads

    rng = np.random.default_rng(0x0E7)
    d = tmp_path_factory.mktemp("overlap_inputs")
    paths = {k: str(d / f"{k}.bam") for k in ("hifi", "nano", "unsorted")}
    # names drawn from a pool of n: about a third repeat, across BAM chunks
    make_bam(paths["hifi"], REFS, LENS, random_reads(rng, REFS, LENS, 800, name_prefix="h"))
    make_bam(paths["nano"], REFS, LENS, random_reads(rng, REFS, LENS, 600, name_prefix="n"))
    # in file order, not coordinate-sorted (make_bam always sorts)
    ids = {r: k for k, r in enumerate(REFS)}
    recs = [build_record(rd["name"], ids[rd["ref"]], rd["pos"], rd["mapq"], rd["cigar"],
                         flag=rd["flag"], nm=rd["nm"])
            for rd in random_reads(rng, REFS, LENS, 800, name_prefix="u")]
    write_bam(paths["unsorted"], REFS, LENS, recs, level=1)
    return paths


def _inflated(path):
    with gzip.open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("bam", ["hifi", "nano", "unsorted"])
@pytest.mark.parametrize("mode", ["device", "streamed"])
def test_feed_bam_matches_jax_overlap_run(inputs, tmp_path, monkeypatch, mode, bam):
    """feed_bam packs the BAM in 8 KiB chunks into the resident delta (then
    from_delta) or the sweep (4096-slot chunks); the checkpoint equals the
    one gci_tpu's run_filter writes through its own overlap on the same
    BAM chunks."""
    # gci_tpu's run_filter reads its BAM chunk, its sweep's chunk and its
    # overlap gate from the environment
    monkeypatch.setenv("GCI_BAM_CHUNK_BYTES", str(BAM_CHUNK))
    monkeypatch.setenv("GCI_STREAM_CHUNK_SLOTS", "4096")
    monkeypatch.delenv("GCI_NO_OVERLAP", raising=False)
    jax_run_filter([], [inputs[bam]], "J", directory=str(tmp_path), depth_backend=mode)
    layout = GenomeLayout.from_targets(dict(zip(REFS, LENS)))
    if mode == "device":
        acc = overlap.DeltaAccumulator(layout, FLANK, device=CPU)
    else:
        acc = overlap.SweepAccumulator(layout, FLANK, 4096, device=CPU)
    n_chunks = overlap.feed_bam(acc, inputs[bam], threads=1, chunk_bytes=BAM_CHUNK)
    assert n_chunks > 1 and acc.chunks_added > 1 and acc.rows_retracted > 0
    if mode == "device":
        depths = DeviceDepth.from_delta(layout, acc.take_delta(), FLANK)
    else:
        # a sorted BAM finalizes chunks during pack; an unsorted one stops
        # doing so at its first chunk that starts behind an earlier one
        assert acc._unsorted == (bam == "unsorted")
        assert acc.frontier > 0 or bam == "unsorted"
        depths = acc.finish()
    write_depth_gz(str(tmp_path / "P.depth.gz"), depths)
    assert _inflated(str(tmp_path / "P.depth.gz")) == _inflated(str(tmp_path / "J.depth.gz"))


def test_feed_bam_needs_the_headers_targets(inputs):
    layout = GenomeLayout.from_targets({"cA": 30000, "cB": 20000})
    acc = overlap.DeltaAccumulator(layout, FLANK, device=CPU)
    with pytest.raises(ValueError, match="header"):
        overlap.feed_bam(acc, inputs["hifi"], threads=1)
    assert acc.chunks_added == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("sweep_chunk", [8192, 1001])
def test_accumulators_on_cuda_match_cpu(rng, cuda_device, sweep_chunk):
    """Both accumulators on the card against the same on the CPU: the
    resident delta slot for slot and its from_delta depth, and the sweep's
    events, with every sweep chunk scanned by the kernels (K2 and K2 int8
    once each) and K1 once for from_delta."""
    lens = {"c1": 60000, "c2": 40000}
    layout = GenomeLayout.from_targets(lens)
    names, tid, start, end = _duplicate_reads(rng, lens, n=900, pool=400)
    order = np.lexsort((start, tid))
    names = [names[k] for k in order]
    tid, start, end = tid[order], start[order], end[order]
    keys = hash_names(names)
    bounds = np.linspace(0, len(names), 9).astype(int)

    def run(dev):
        d = overlap.DeltaAccumulator(layout, FLANK, device=dev)
        s = overlap.SweepAccumulator(layout, FLANK, sweep_chunk, device=dev)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            surv = dedup_last_wins(keys[lo:hi], np.ones(hi - lo, bool)) + lo
            for acc in (d, s):
                acc.add_chunk(keys_view(keys[surv]), tid[surv], start[surv], end[surv])
        delta = d.delta.cpu().clone()
        return delta, DeviceDepth.from_delta(layout, d.take_delta(), FLANK).to_events(), s

    want_delta, want_ev, want_sweep = run(CPU)
    kernels.reset_launch_counts()
    got_delta, got_ev, got_sweep = run(cuda_device)
    assert got_sweep.frontier == want_sweep.frontier > 0
    got_s, want_s = got_sweep.finish(), want_sweep.finish()
    torch.cuda.synchronize()
    n = -(-layout.total_slots // sweep_chunk)
    assert kernels.LAUNCHES["fused_depth_scan_packed"] == 1
    assert kernels.LAUNCHES["depth_scan"] == n
    assert kernels.LAUNCHES["depth_scan_int8"] >= n
    assert torch.equal(got_delta, want_delta)
    _assert_events_equal(got_ev, want_ev)
    _assert_events_equal(got_s, want_s)
    flat = accumulate_depth_numpy(layout, *_batch_survivors(names, tid, start, end), FLANK)
    for k, t in enumerate(layout.names):
        o = int(layout.offsets[k])
        np.testing.assert_array_equal(got_s[t].materialize(), flat[o : o + lens[t]])
        np.testing.assert_array_equal(got_ev[t].materialize(), flat[o : o + lens[t]])
