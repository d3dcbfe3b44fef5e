"""The port's stream compaction (``gci_tpu_torch.depth.scan.compact_flags``
and ``compact_runs``) against ``gci_tpu``'s compaction.

On the CPU the port runs the plain versions; ``gci_tpu`` compacts with a
prefix sum and ``searchsorted`` to power-of-two sizes (``compact_indices``,
``_batched_flags_readback``, ``_batched_edge_readback`` on JAX's CPU
backend, ``make_sharded_compact_gather_fn`` on the 8-device CPU mesh).  Both
get the same seeded numpy inputs; every comparison is exact.  The
capacity every device caller gives the compaction is held against its
counts on each path.  The ``cuda``-marked cases hold each kernel form
against its plain form across tile borders, at, past and without a
capacity, and skip without a card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gci_tpu.depth import device as jax_device
from gci_tpu.depth import fused as jax_fused
from gci_tpu.depth.accum import GenomeLayout
from gci_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gci_tpu_torch import kernels
from gci_tpu_torch.depth import device, fused, streamed
from gci_tpu_torch.depth.scan import (
    CAPACITY_FLOOR_BYTES,
    capacity_for,
    compact_flags,
    compact_flags_torch,
    compact_runs,
    compact_runs_torch,
)
from gci_tpu_torch.parallel.mesh import make_mesh
from gci_tpu_torch.pipeline import run_gci

# the kernel's tiles: 16,384 slots (flag form) and 8,192 (run form); N is a
# multiple of neither, nor of a warp's span or a column.  The bitmaps range
# from no set slot in a tile ("sparse") to every slot set ("all"), "mixed"
# both in one call.
FLAG_TILE, RUN_TILE = 16_384, 8_192
N = 2 * FLAG_TILE + 4_097 + 5
KINDS = ["empty", "all", "single", "ends", "sparse", "random", "dense", "mixed"]
CPU = torch.device("cpu")


def _on(rng, kind: str, n: int = N) -> np.ndarray:
    """A bool bitmap set nowhere, everywhere, at one slot, at slots 0 and
    n - 1, at 0.2%, 1% or half of the slots, or at 0.2% with a stretch of
    half."""
    on = np.zeros(n, bool)
    if kind in ("sparse", "mixed"):
        on = rng.random(n) < 0.002
    if kind == "mixed":
        a = n // 4
        on[a : a + 50_000] = rng.random(on[a : a + 50_000].shape[0]) < 0.5
    elif kind == "all":
        on[:] = True
    elif kind == "single":
        on[n // 3] = True
    elif kind == "ends":
        on[0] = on[-1] = True
    elif kind == "random":
        on = rng.random(n) < 0.01
    elif kind == "dense":
        on = rng.random(n) < 0.5
    return on


def _truth_bytes(rng, on: np.ndarray) -> np.ndarray:
    """int8 bytes, nonzero where ``on``, many with bit 7 set."""
    return np.where(on, rng.choice([1, 2, 64, -1, -128, -77], on.shape[0]), 0).astype(np.int8)


def _runs(rng, n: int = N, mean_run: int = 40, dense_from: int | None = None) -> np.ndarray:
    """int32 depth in runs of random lengths and values; from slot
    ``dense_from`` on, 50,000 slots of runs of length 2 on average."""
    p = np.full(n, 1 / mean_run)
    if dense_from is not None:
        p[dense_from : dense_from + 50_000] = 0.5
    starts = np.flatnonzero(rng.random(n) < p)
    vals = rng.integers(0, 12, starts.shape[0] + 1).astype(np.int32)
    return vals[np.searchsorted(starts, np.arange(n), side="right")]


def _layout(n: int) -> GenomeLayout:
    """Two targets over exactly n slots."""
    return GenomeLayout.from_targets({"a": n // 3, "b": n - n // 3 - 2})


# ---------------------------------------------------------------------------
# flag form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["bool", "int8"])
def test_compact_indices_matches_jax(rng, kind, dtype):
    on = _on(rng, kind)
    bitmap = on if dtype == "bool" else _truth_bytes(rng, on)
    got = fused.compact_indices(torch.from_numpy(bitmap))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jax_fused.compact_indices(jnp.asarray(bitmap)))
    np.testing.assert_array_equal(got, np.flatnonzero(on))


@pytest.mark.parametrize("kind", KINDS)
def test_flag_form_matches_jax_flags_readback(rng, kind):
    """The three-mask readback of a flag byte (bit2 the case's bitmap, bits
    0-1 random, bits 3-7 noise) and its gather, against gci_tpu's."""
    on = _on(rng, kind)
    noise = rng.integers(0, 256, N).astype(np.uint8) & 0b11111000
    bits = ((rng.random(N) < 0.02) | ((rng.random(N) < 0.3) << 1) | (on << 2))
    flags = (noise | bits.astype(np.uint8)).view(np.int8)
    depth = _runs(rng)
    layout = _layout(N)
    got = fused._batched_flags_readback(torch.from_numpy(depth), torch.from_numpy(flags),
                                        (1, 2, 4), 2)
    want = jax_fused._batched_flags_readback(jnp.asarray(depth), layout,
                                             jnp.asarray(flags), (1, 2, 4), 2)
    for g, w in zip(got[0], want[0], strict=True):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][2], np.flatnonzero(on))
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("masks", [(1,), (0x80,), (0xFF,), (3, 0x40), (1, 2, 4),
                                   (0x80, 0x7F, 0xFF)])
def test_flag_form_masks_match_numpy(rng, masks):
    """Any 1-3 masks of 1-255, bit 7 included: the indices where any of the
    mask's bits is set."""
    x = rng.integers(-128, 128, N).astype(np.int8)
    x[rng.random(N) < 0.7] = 0
    got = compact_flags(torch.from_numpy(x), masks)
    assert len(got) == len(masks)
    for g, m in zip(got, masks):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.flatnonzero(x.view(np.uint8) & m))


@pytest.mark.parametrize("n", [0, 1, 2])
def test_flag_form_tiny_inputs(n):
    x = torch.tensor([1, -128][:n], dtype=torch.int8)
    got = compact_flags(x, (1, 0x80))
    assert [g.tolist() for g in got] == [[0][:n], [1][: max(n - 1, 0)]]


# ---------------------------------------------------------------------------
# run form
# ---------------------------------------------------------------------------

RUN_SHAPES = ["runs", "sparse", "mixed", "dense", "constant", "alternating"]


def _depth(rng, shape: str, n: int = N) -> np.ndarray:
    return {
        "runs": lambda: _runs(rng, n),
        "sparse": lambda: _runs(rng, n, 400),
        "mixed": lambda: _runs(rng, n, 400, dense_from=n // 4),
        "dense": lambda: rng.integers(0, 3, n).astype(np.int32),
        "constant": lambda: np.full(n, 5, np.int32),
        "alternating": lambda: (np.arange(n) % 2).astype(np.int32),
    }[shape]()


@pytest.mark.parametrize("shape", RUN_SHAPES)
def test_run_form_matches_jax_edge_readback(rng, shape):
    """The run boundaries of a depth (slot 0 forced) with each run's depth,
    against gci_tpu's readback of the change bitmap."""
    depth = _depth(rng, shape)
    layout = _layout(N)
    change = np.concatenate([[True], depth[1:] != depth[:-1]]).astype(np.int8)
    want = jax_fused._batched_edge_readback(jnp.asarray(depth), layout,
                                            (jnp.asarray(change),), 0)
    idx, vals = fused._runs_readback(torch.from_numpy(depth))
    np.testing.assert_array_equal(idx, want[0][0])
    np.testing.assert_array_equal(vals, want[1])
    assert idx.dtype == vals.dtype == np.int64


@pytest.mark.parametrize("carry", ["equal", "different", "none"])
@pytest.mark.parametrize("shape", ["runs", "constant"])
def test_run_form_carry_matches_jax(rng, carry, shape):
    """Slot 0 against a carry equal to and different from depth[0] (no
    boundary, a boundary), or forced without one."""
    depth = _runs(rng) if shape == "runs" else np.full(N, 3, np.int32)
    c = {"equal": int(depth[0]), "different": int(depth[0]) + 7, "none": None}[carry]
    prev0 = depth[0] - 1 if c is None else c
    change = depth != np.concatenate([[prev0], depth[:-1]])
    idx, vals = compact_runs(torch.from_numpy(depth), c)
    assert idx.dtype == torch.int64 and vals.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(),
                                  jax_fused.compact_indices(jnp.asarray(change.astype(np.int8))))
    np.testing.assert_array_equal(vals.numpy(), depth[idx.numpy()])
    assert (0 in idx.tolist()) == (carry != "equal")


@pytest.mark.parametrize("n", [0, 1, 2])
def test_run_form_tiny_inputs(n):
    depth = torch.tensor([4, 4][:n], dtype=torch.int32)
    idx, vals = compact_runs(depth, 9)
    assert idx.tolist() == [0][:n] and vals.tolist() == [4][:n]
    idx, vals = compact_runs(depth, 4)
    assert idx.tolist() == [] and vals.tolist() == []


def test_chunk_runs_cross_borders(rng):
    """streamed.chunk_runs over chunks of one depth, each seeded with the
    depth before it, equals the run form of the whole."""
    depth = _runs(rng)
    want_idx, want_vals = compact_runs(torch.from_numpy(depth))
    idx, vals = [], []
    bounds = [0, 1, RUN_TILE + 3, 3 * RUN_TILE, N]
    for a, b in zip(bounds[:-1], bounds[1:]):
        i, v = streamed.chunk_runs(torch.from_numpy(depth[a:b]), a,
                                   int(depth[a - 1]) if a else 0)
        idx.append(i)
        vals.append(v)
    np.testing.assert_array_equal(np.concatenate(idx), want_idx.numpy())
    np.testing.assert_array_equal(np.concatenate(vals), want_vals.numpy())


# ---------------------------------------------------------------------------
# the sharded programs on the 8-device mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,gp", [(1, 8), (2, 4), (8, 1)])
def test_sharded_forms_match_jax_on_8_devices(rng, dp, gp):
    """Both forms per gp shard against gci_tpu's count program and
    compact-gather program: an empty shard, a full one, one set slot at a
    shard's slot 0 and one at its last slot; run borders where the left
    shard's last depth equals and differs from the next shard's first."""
    shard = 3 * RUN_TILE + 11
    pad_total = gp * shard
    on = rng.random(pad_total) < 0.03
    on[0] = on[-1] = True
    if gp > 1:
        on[shard : 2 * shard] = False
        on[(gp - 1) * shard :] = True
    flags = _truth_bytes(rng, on)
    depth = _runs(rng, pad_total)
    for g in range(1, gp):
        # an equal carry at odd borders, a different one at even borders
        depth[g * shard] = depth[g * shard - 1] + (0 if g % 2 else 1)
    offsets = np.sort(rng.choice(pad_total, 9, replace=False)).astype(np.int64)
    o_shard = offsets // shard
    k_off = int(np.bincount(o_shard, minlength=gp).max())
    loff = np.full((gp, k_off), -1, np.int32)
    for g in range(gp):
        own = offsets[o_shard == g] % shard
        loff[g, : own.shape[0]] = own

    jmesh = jax_make_mesh(dp * gp, dp=dp)
    pmesh = make_mesh(dp * gp, dp=dp, devices=[CPU] * (dp * gp))
    jdepth = jnp.asarray(depth)
    with jmesh:
        change = jax_device.make_sharded_change_fn(jmesh, pad_total)(jdepth)
        want = {}
        for key, bitmap in (("flags", jnp.asarray(flags)), ("runs", change)):
            (counts,) = jax_device.make_sharded_count_fn(jmesh, 1)(bitmap)
            counts = np.asarray(counts)
            size = max(1, 1 << (int(counts.max()) - 1).bit_length())
            idx, vals, ovals = (np.asarray(x) for x in jax_device.make_sharded_compact_gather_fn(
                jmesh, size, k_off)(bitmap, jdepth, jnp.asarray(loff)))
            want[key] = (counts, idx, vals, ovals)

    def shards(a):
        return {g: torch.from_numpy(a[g * shard:(g + 1) * shard].copy())
                for g in pmesh.local_gp()}

    got_flags = device.sharded_compact_gather(shards(flags), (0xFF,))
    got_runs = device.sharded_runs(pmesh, shards(depth))
    assert sorted(got_flags) == sorted(got_runs) == list(range(gp))
    for g in range(gp):
        counts, idx, _, _ = want["flags"]
        assert got_flags[g][0].shape[0] == counts[g]
        np.testing.assert_array_equal(got_flags[g][0], idx[g][idx[g] >= 0])
        counts, idx, vals, _ = want["runs"]
        r_idx, r_vals = got_runs[g]
        keep = idx[g] >= 0
        assert r_idx.shape[0] == counts[g]
        np.testing.assert_array_equal(r_idx, idx[g][keep])
        np.testing.assert_array_equal(r_vals, vals[g][keep])
        if g:
            assert (0 in r_idx.tolist()) == (g % 2 == 0)


# ---------------------------------------------------------------------------
# the entries' contract on the CPU
# ---------------------------------------------------------------------------

def test_entries_run_plain_on_cpu(rng):
    """On the CPU the entries are their plain versions and launch nothing."""
    x = _truth_bytes(rng, _on(rng, "random"))
    depth = _runs(rng)
    before = dict(kernels.LAUNCHES)
    got = compact_flags(torch.from_numpy(x), (1, 2))
    runs = compact_runs(torch.from_numpy(depth), 3)
    assert kernels.LAUNCHES == before
    for g, w in zip(got, compact_flags_torch(torch.from_numpy(x), (1, 2)), strict=True):
        assert torch.equal(g, w)
    for g, w in zip(runs, compact_runs_torch(torch.from_numpy(depth), 3), strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("call", [
    lambda: compact_flags(torch.zeros(8, dtype=torch.int32), (1,)),
    lambda: compact_flags(torch.zeros((2, 4), dtype=torch.int8), (1,)),
    lambda: compact_flags(torch.zeros(8, dtype=torch.int8), ()),
    lambda: compact_flags(torch.zeros(8, dtype=torch.int8), (1, 2, 4, 8)),
    lambda: compact_flags(torch.zeros(8, dtype=torch.int8), (0,)),
    lambda: compact_flags(torch.zeros(8, dtype=torch.int8), (256,)),
    lambda: compact_runs(torch.zeros(8, dtype=torch.int64)),
    lambda: compact_runs(torch.zeros((2, 4), dtype=torch.int32)),
])
def test_entries_refuse_other_inputs(call):
    with pytest.raises(ValueError):
        call()


def test_entries_refuse_devices_without_kernels():
    x = torch.zeros(8, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        compact_flags(x, (1,))
    with pytest.raises(ValueError):
        compact_runs(torch.zeros(8, dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# capacities
# ---------------------------------------------------------------------------

def _flags_call(x, capacity):
    return compact_flags(x, (1, 0x80), capacity)


def _runs_call(x, capacity):
    return compact_runs(x.to(torch.int32), 3, capacity)


@pytest.mark.parametrize("capacity", [-1, 2.5, "8", True])
@pytest.mark.parametrize("call", [_flags_call, _runs_call])
def test_entries_refuse_bad_capacities(call, capacity):
    with pytest.raises(ValueError):
        call(torch.zeros(8, dtype=torch.int8), capacity)


@pytest.mark.parametrize("form", ["flags", "runs"])
def test_cpu_route_counts_an_overflow(rng, form):
    """On the CPU a capacity below a count is counted in RELAUNCHES as the
    card's second launch is, one at or above it or none is not; the result
    is the plain one either way."""
    if form == "flags":
        x = torch.from_numpy(_truth_bytes(rng, _on(rng, "random")))
        call, plain = (lambda c: compact_flags(x, (1, 0x80), c),
                       lambda: compact_flags_torch(x, (1, 0x80)))
        name, top = "compact_flags", max(w.shape[0] for w in plain())
    else:
        x = torch.from_numpy(_runs(rng))
        call, plain = lambda c: compact_runs(x, 3, c), lambda: compact_runs_torch(x, 3)
        name, top = "compact_runs", plain()[0].shape[0]
    for capacity, relaunched in ((top, 0), (top + 5, 0), (None, 0), (top - 1, 1), (0, 1)):
        before = kernels.RELAUNCHES[name]
        got = call(capacity)
        assert kernels.RELAUNCHES[name] - before == relaunched, capacity
        assert all(torch.equal(g, w) for g, w in zip(got, plain(), strict=True))


# a small dual-type run with N gaps and regions, for every device path
BOUND_REFS, BOUND_LENS = ["chrA", "chrB", "chrC"], [30_000, 20_000, 4_096]


@pytest.fixture(scope="module")
def bound_inputs(tmp_path_factory):
    from tests.fixtures import make_bam, make_fasta, random_reads

    rng = np.random.default_rng(0xB0D)
    d = tmp_path_factory.mktemp("bounds")
    seqs = []
    for name, length in zip(BOUND_REFS, BOUND_LENS):
        seq = "".join(rng.choice(list("ACGT"), size=length))
        if name == "chrA":
            seq = seq[:12_000] + "N" * 400 + seq[12_400:]
        seqs.append((name, seq))
    paths = {"ref": str(d / "ref.fa"), "hifi": str(d / "hifi.bam"), "nano": str(d / "nano.bam"),
             "regions": str(d / "regions.bed")}
    make_fasta(paths["ref"], seqs)
    make_bam(paths["hifi"], BOUND_REFS, BOUND_LENS,
             random_reads(rng, BOUND_REFS, BOUND_LENS, 900, name_prefix="h"))
    make_bam(paths["nano"], BOUND_REFS, BOUND_LENS,
             random_reads(rng, BOUND_REFS, BOUND_LENS, 700, name_prefix="n"))
    with open(paths["regions"], "w") as f:
        f.write("chrA\t1000\t15000\nchrB\t0\t20000\n")
    return paths


def _overlap_run(paths, acc_kind):
    """Both BAMs through ``feed_bam`` (8 KiB chunks) into an accumulator,
    then the value and the host view a run writes."""
    from gci_tpu_torch.depth import overlap
    from gci_tpu_torch.io.fasta import scan_fasta

    layout = fused.GenomeLayout.from_targets(dict(zip(BOUND_REFS, BOUND_LENS)))
    gaps = scan_fasta(paths["ref"])[1]
    for bam in (paths["hifi"], paths["nano"]):
        if acc_kind == "delta":
            acc = overlap.DeltaAccumulator(layout, 15, device=CPU)
            overlap.feed_bam(acc, bam, threads=1, chunk_bytes=8 << 10)
            dd = fused.DeviceDepth.from_delta(layout, acc.take_delta(), 15, gaps=gaps,
                                              issue_range=(-1, 1), rows=acc.rows)
            dd.to_events()
            masked = dd.mask_gaps(gaps)
            masked.collapse_dict(-1, 1, 15)
            masked.maximum(dd).to_events()
        else:
            acc = overlap.SweepAccumulator(layout, 15, 7_001, device=CPU)
            overlap.feed_bam(acc, bam, threads=1, chunk_bytes=8 << 10)
            acc.finish()


@pytest.mark.parametrize("path", ["packed", "flags", "streamed", "sharded",
                                  "overlap_delta", "overlap_sweep"])
def test_device_callers_bounds_hold(bound_inputs, tmp_path, monkeypatch, path):
    """Every compaction a device path makes gets a capacity from its caller,
    and every count is within it: RELAUNCHES stays 0 on the CPU route, which
    counts a count past its capacity as the card's relaunch."""
    capacities = []
    check = kernels.check_capacity
    monkeypatch.setattr(kernels, "check_capacity",
                        lambda c: (capacities.append(c), check(c))[1])
    if path == "flags":
        monkeypatch.setattr(fused, "PACKED_DEPTH_LIMIT", 1)
    if path == "streamed":
        monkeypatch.setattr(streamed, "CHUNK_SLOTS", 7_001)
    kernels.reset_launch_counts()
    if path.startswith("overlap"):
        _overlap_run(bound_inputs, path.partition("_")[2])
    else:
        run_gci(hifi=[bound_inputs["hifi"]], nano=[bound_inputs["nano"]],
                reference=bound_inputs["ref"], regions=bound_inputs["regions"],
                directory=str(tmp_path), prefix="B", threshold=1, torch_device="cpu",
                depth_backend="sharded" if path == "sharded" else
                "streamed" if path == "streamed" else "device",
                mesh="2,4" if path == "sharded" else None)
    assert capacities and None not in capacities
    assert kernels.RELAUNCHES == {"compact_flags": 0, "compact_runs": 0}


MH63_SLOTS, T2T_SLOTS = 395_765_512, 3_100_000_024
FLAGS_PATH_ROWS = 2 * (1 << 29) + 1  # the scatter rows of 2^29 reads, plus one


@pytest.mark.parametrize("n, bound, streams, values, want", [
    (MH63_SLOTS, 400_001, 3, False, 400_001),  # the smoke's packed path
    (MH63_SLOTS, 400_001, 1, True, 400_001),
    (MH63_SLOTS, FLAGS_PATH_ROWS, 3, False, None),  # the flags path
    (T2T_SLOTS, FLAGS_PATH_ROWS, 3, False, None),
    (T2T_SLOTS, FLAGS_PATH_ROWS, 2, False, None),
    (T2T_SLOTS, 16_000_001, 3, False, 16_000_001),  # 8M reads: 0.124 B/slot
    (T2T_SLOTS, 24_000_001, 3, False, None),  # 12M reads: 0.186 B/slot
    (1 << 28, 2_000_001, 1, True, 2_000_001),  # a streamed chunk, under 64 MiB
    (1 << 28, 6_000_001, 1, True, None),
    (1_000, 5_000, 3, False, 5_000),  # past the slots, under the floor
    (MH63_SLOTS, None, 3, False, None),
])
def test_capacity_for_limits_the_buffers(n, bound, streams, values, want):
    """A bound becomes the capacity while the buffers it sizes stay within
    an eighth of a byte a slot or 64 MiB, else the kernel counts first."""
    assert capacity_for(bound, n, streams, values) == want
    if want is not None:
        size = min(want, n) * (8 * streams + 4 * values)
        assert size <= max(n / 8, CAPACITY_FLOOR_BYTES)


def test_flags_path_bound_of_many_reads_counts_first(bound_inputs, monkeypatch):
    """With the scatter rows of 2^29 reads (the least the flags path
    takes), the flags path's compaction counts first instead of sizing its
    buffers by that bound, and the value is the one the small bound gives.
    The genome is small, so the 64 MiB floor is set to 0: the limit is then
    an eighth of a byte a slot, as on a genome of 2^29 slots and more."""
    from gci_tpu_torch.io.fasta import scan_fasta

    layout = fused.GenomeLayout.from_targets(dict(zip(BOUND_REFS, BOUND_LENS)))
    gaps = scan_fasta(bound_inputs["ref"])[1]
    rng = np.random.default_rng(0xF1A6)
    tid = rng.integers(0, len(BOUND_REFS), 800).astype(np.int32)
    start = rng.integers(0, 3_000, 800).astype(np.int64)
    end = start + rng.integers(40, 900, 800)
    monkeypatch.setattr(fused, "PACKED_DEPTH_LIMIT", 1)

    def run():
        dd = fused.DeviceDepth.from_reads(layout, tid, start, end, 15, gaps=gaps,
                                          issue_range=(-1, 1), device=CPU)
        masked = dd.mask_gaps(gaps)
        return dd, masked.collapse_dict(-1, 1, 15), masked.maximum(dd).to_events()

    want = run()
    rows = fused._event_rows
    monkeypatch.setattr(fused, "_event_rows",
                        lambda layout, n_reads, *a: rows(layout, n_reads, *a)
                        + (FLAGS_PATH_ROWS - 1 if n_reads else 0))
    monkeypatch.setattr("gci_tpu_torch.depth.scan.CAPACITY_FLOOR_BYTES", 0)
    capacities = []
    check = kernels.check_capacity
    monkeypatch.setattr(kernels, "check_capacity",
                        lambda c: (capacities.append(c), check(c))[1])
    got = run()
    assert got[0].gap_bit == 1
    assert capacities and capacities[0] is None
    assert got[1] == want[1]
    for t in want[2]:
        np.testing.assert_array_equal(got[2][t].materialize(), want[2][t].materialize())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the compaction kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


# across a column, a warp's span and a tile of each form, and many tiles
CUDA_SIZES = [1, 127, 129, 511, 513, 1_025, 4_097, RUN_TILE + 1, FLAG_TILE - 1,
              FLAG_TILE + 1, N, 3_000_017]


@pytest.mark.cuda
@pytest.mark.parametrize("n", CUDA_SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_flag_form_matches_plain(rng, cuda_device, n, kind):
    x = torch.from_numpy(_truth_bytes(rng, _on(rng, kind, n)))
    x[torch.from_numpy(rng.random(n) < 0.1)] |= 2
    for masks in ((0xFF,), (1, 0x80), (2, 0x40, 0xFF)):
        want = compact_flags_torch(x, masks)
        before = kernels.LAUNCHES["compact_flags"]
        got = compact_flags(x.to(cuda_device), masks, max(w.shape[0] for w in want))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["compact_flags"] == before + 1
        for g, w in zip(got, want, strict=True):
            assert g.device.type == "cuda" and g.dtype == torch.int64
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", CUDA_SIZES)
@pytest.mark.parametrize("shape", ["runs", "sparse", "mixed", "dense", "constant",
                                   "alternating"])
def test_cuda_run_form_matches_plain(rng, cuda_device, n, shape):
    depth = _depth(rng, shape, n)
    x = torch.from_numpy(depth)
    for carry in (None, int(depth[0]), int(depth[0]) - 1):
        want = compact_runs_torch(x, carry)
        before = kernels.LAUNCHES["compact_runs"]
        got = compact_runs(x.to(cuda_device), carry, want[0].shape[0])
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["compact_runs"] == before + 1
        for g, w in zip(got, want, strict=True):
            assert g.device.type == "cuda" and g.dtype == w.dtype
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_cuda_repeated_launches_equal(rng, cuda_device):
    x = torch.from_numpy(_truth_bytes(rng, _on(rng, "random", 5_000_011))).to(cuda_device)
    depth = torch.from_numpy(_runs(rng, 5_000_011)).to(cuda_device)
    want_f = compact_flags(x, (1, 2, 4))
    want_r = compact_runs(depth, 0)
    for _ in range(10):
        assert all(torch.equal(g, w) for g, w in zip(compact_flags(x, (1, 2, 4)), want_f))
        assert all(torch.equal(g, w) for g, w in zip(compact_runs(depth, 0), want_r))


@pytest.mark.cuda
def test_cuda_empty_input_launches_nothing(cuda_device):
    before = dict(kernels.LAUNCHES)
    (f,) = compact_flags(torch.zeros(0, dtype=torch.int8, device=cuda_device), (1,))
    idx, vals = compact_runs(torch.zeros(0, dtype=torch.int32, device=cuda_device))
    assert kernels.LAUNCHES == before
    assert f.shape == idx.shape == vals.shape == (0,)


@pytest.mark.cuda
def test_cuda_compaction_refuses_misaligned_streams(cuda_device):
    x = torch.zeros(4_096, dtype=torch.int8, device=cuda_device)
    depth = torch.zeros(4_096, dtype=torch.int32, device=cuda_device)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError):
        compact_flags(x[1:], (1,))
    with pytest.raises(ValueError):
        compact_runs(depth[1:])
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4_097, FLAG_TILE - 1, N])
@pytest.mark.parametrize("kind", ["single", "random", "all"])
def test_cuda_capacity_at_past_and_without(rng, cuda_device, n, kind):
    """A count exactly at capacity takes one launch; one past it, a launch
    whose stores stop at the capacity and one exact relaunch; no capacity, a
    counting launch and the exact one.  Every result equals the plain one."""
    x = torch.from_numpy(_truth_bytes(rng, _on(rng, kind, n)))
    depth = torch.from_numpy(_depth(rng, "dense" if kind == "all" else "runs", n))
    for name, call, want in (
        ("compact_flags", lambda c: compact_flags(x.to(cuda_device), (1, 0xFF), c),
         compact_flags_torch(x, (1, 0xFF))),
        ("compact_runs", lambda c: compact_runs(depth.to(cuda_device), None, c),
         compact_runs_torch(depth, None)),
    ):
        top = max(w.shape[0] for w in (want if name == "compact_flags" else want[:1]))
        # with nothing set, the launch without a capacity is the only one
        cases = [(top, 1, 0), (top - 1, 2, 1), (None, 2, 1)] if top else [(0, 1, 0),
                                                                         (None, 1, 0)]
        for capacity, launches, relaunches in cases:
            before, again = kernels.LAUNCHES[name], kernels.RELAUNCHES[name]
            got = call(capacity)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES[name] - before == launches, (name, capacity)
            assert kernels.RELAUNCHES[name] - again == relaunches, (name, capacity)
            for g, w in zip(got, want, strict=True):
                assert torch.equal(g.cpu(), w), (name, capacity)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [513, FLAG_TILE + 1, N])
def test_cuda_three_masks_one_stream_empty(rng, cuda_device, n):
    """Masks (1, 0x10, 4) of bytes that never hold bit 4: the middle
    predicate has no set slot, the others many."""
    x = torch.from_numpy(_truth_bytes(rng, _on(rng, "dense", n)) & ~np.int8(0x10))
    want = compact_flags_torch(x, (1, 0x10, 4))
    assert want[1].shape[0] == 0 and want[0].shape[0] > 0
    got = compact_flags(x.to(cuda_device), (1, 0x10, 4), max(w.shape[0] for w in want))
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_cuda_compaction_refuses_bad_capacities(cuda_device):
    x = torch.zeros(4_096, dtype=torch.int8, device=cuda_device)
    before = dict(kernels.LAUNCHES)
    for capacity in (-1, 2.5, True):
        with pytest.raises(ValueError):
            compact_flags(x, (1,), capacity)
        with pytest.raises(ValueError):
            compact_runs(x.to(torch.int32), None, capacity)
    assert kernels.LAUNCHES == before
