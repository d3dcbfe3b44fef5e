"""The port's sharded (dp, gp) backend against gci_tpu's, exactly.

gci_tpu runs on the 8-device JAX CPU mesh of ``tests/conftest.py``; the port
on meshes of 8 positions on ``cpu`` (the one CPU device at every position,
``parallel.mesh.make_mesh(devices=...)``).  The same inputs, made from a
seed, go through ``pack_read_deltas_sharded``, the sharded programs
(``make_sharded_*_fn`` against ``depth.device.sharded_*``) on meshes (1,8),
(8,1), (2,4) and (4,2), the ``ShardedDepth`` operations and whole
``run_gci`` runs; every array must be equal and every file byte-equal (the
tolerance is exact).  The ``cuda``-marked cases hold positions on
``cuda:0`` against positions on ``cpu`` (the smoke run's phase 9 runs whole
sharded runs on the card).
"""
import contextlib
import gzip
import io
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gci_tpu import cli as jax_cli
from gci_tpu.depth import device as jax_device
from gci_tpu.depth.sharded import ShardedDepth as JaxShardedDepth
from gci_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gci_tpu.pipeline import run_gci as jax_run_gci
from gci_tpu_torch import cli, pipeline
from gci_tpu_torch.depth import device
from gci_tpu_torch.depth.accum import GenomeLayout
from gci_tpu_torch.depth.sharded import (
    ShardedDepth,
    _gp_shards,
    parse_mesh_spec,
    resolve_mesh,
)
from gci_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple
from gci_tpu_torch.pipeline import run_gci

MESHES = [(1, 8), (8, 1), (2, 4), (4, 2)]
CPU = torch.device("cpu")
TARGETS = {"t1": 9_000, "t2": 25, "t3": 6_001, "t4": 3_333}  # 18,363 slots
REFS = ["chrA", "chrB", "chrC"]
LENS = [30000, 20000, 4096]


def port_mesh(dp, gp, dev=CPU):
    return make_mesh(dp * gp, dp=dp, devices=[dev] * (dp * gp))


def joined(shards: dict) -> np.ndarray:
    return torch.cat([shards[g].cpu() for g in sorted(shards)]).numpy()


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(0x5A4D)
    layout = GenomeLayout.from_targets(TARGETS)
    n = 301  # not a multiple of any dp
    tid = rng.integers(0, len(TARGETS), n).astype(np.int32)
    start = (rng.random(n) * layout.lengths[tid]).astype(np.int64)
    end = start + rng.integers(1, 4_000, n)
    return layout, tid, start, end


# ---------------------------------------------------------------------------
# packing and the sharded programs
# ---------------------------------------------------------------------------

def test_pack_sharded_past_int32():
    """Exact (shard, offset) int32 pairs from int64 bases at 6.2G slots."""
    rng = np.random.default_rng(0x5A31)
    layout = GenomeLayout.from_targets({f"chr{i}": 310_000_000 for i in range(20)})
    assert layout.total_slots > 2**31
    n = 5000
    tid = rng.integers(0, 20, n).astype(np.int64)
    start = (rng.random(n) * 309_000_000).astype(np.int64)
    end = start + (rng.random(n) * 30_000).astype(np.int64) + 40
    shard = 97_000_000
    got = device.pack_read_deltas_sharded(layout, tid, start, end, 15, shard)
    want = jax_device.pack_read_deltas_sharded(layout, tid, start, end, 15, shard)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert int(got[0].max()) * shard > 2**31


def _depth_pair(reads, dp, gp):
    """(jax mesh, port mesh, pad_total, jax depth, port depth shards)."""
    layout, tid, start, end = reads
    jmesh, pmesh = jax_make_mesh(dp * gp, dp=dp), port_mesh(dp, gp)
    pad_total = ShardedDepth._pad_total(pmesh, layout.total_slots)
    shard = pad_total // gp
    n = tid.shape[0]
    packed = jax_device.pack_read_deltas_sharded(layout, tid, start, end, 15, shard,
                                                 pad_to=n + (-n % dp))
    with jmesh:
        want = jax_device.make_sharded_depth_fn(jmesh, pad_total)(
            *(jnp.asarray(a) for a in packed))
    got = device.sharded_depth(
        pmesh, pad_total, device.pack_read_deltas_sharded(layout, tid, start, end, 15, shard),
        n)
    return jmesh, pmesh, pad_total, want, got


@pytest.mark.parametrize("dp,gp", MESHES)
def test_depth_program_matches_jax(reads, dp, gp):
    _, pmesh, pad_total, want, got = _depth_pair(reads, dp, gp)
    assert sorted(got) == list(range(gp))
    assert all(x.dtype == torch.int32 and x.shape[0] == pad_total // gp for x in got.values())
    np.testing.assert_array_equal(joined(got), np.asarray(want))


@pytest.mark.parametrize("dp,gp", MESHES)
def test_interval_program_matches_jax(reads, dp, gp):
    jmesh, pmesh, pad_total, want_depth, got_depth = _depth_pair(reads, dp, gp)
    rng = np.random.default_rng(dp * 10 + gp)
    valid = (rng.random(pad_total) < 0.9).astype(np.int32)
    valid_sh = _gp_shards(pmesh, valid > 0)
    for lo, hi in ((-1, 0), (-1, 2), (1, 3)):
        with jmesh:
            w_rise, w_fall = jax_device.make_sharded_interval_fn(jmesh, pad_total)(
                want_depth, jnp.asarray(valid), jnp.asarray([lo], jnp.int32),
                jnp.asarray([hi], jnp.int32))
        rise, fall = device.sharded_interval_edges(pmesh, got_depth, valid_sh, lo, hi)
        np.testing.assert_array_equal(joined(rise), np.asarray(w_rise))
        np.testing.assert_array_equal(joined(fall), np.asarray(w_fall))


@pytest.mark.parametrize("dp,gp", MESHES)
def test_change_program_matches_jax(reads, dp, gp):
    jmesh, pmesh, pad_total, want_depth, got_depth = _depth_pair(reads, dp, gp)
    with jmesh:
        want = jax_device.make_sharded_change_fn(jmesh, pad_total)(want_depth)
    got = device.sharded_change(pmesh, got_depth)
    np.testing.assert_array_equal(joined(got).astype(np.int8), np.asarray(want))


@pytest.mark.parametrize("dp,gp", MESHES)
def test_compaction_program_matches_jax(reads, dp, gp):
    """Exact per-shard counts from the compaction's own prefix, against the
    reference's count program and its power-of-two compaction."""
    jmesh, pmesh, pad_total, want_depth, got_depth = _depth_pair(reads, dp, gp)
    shard = pad_total // gp
    rng = np.random.default_rng(0xC0 + dp)
    bitmap = (rng.random(pad_total) < 0.05).astype(np.int8)
    bitmap[shard - 1 :: shard] = 1  # the last slot of every shard
    if gp > 1:
        bitmap[shard : 2 * shard] = 0  # one empty shard
    offsets = np.sort(rng.choice(pad_total, 7, replace=False)).astype(np.int64)
    with jmesh:
        (counts,) = jax_device.make_sharded_count_fn(jmesh, 1)(jnp.asarray(bitmap))
        counts = np.asarray(counts)
        size = max(1, 1 << (int(counts.max()) - 1).bit_length())
        o_shard = offsets // shard
        k_off = int(np.bincount(o_shard, minlength=gp).max())
        loff = np.full((gp, k_off), -1, np.int32)
        for g in range(gp):
            own = offsets[o_shard == g] % shard
            loff[g, : own.shape[0]] = own
        w_idx, w_vals, w_ovals = (np.asarray(x) for x in jax_device.make_sharded_compact_gather_fn(
            jmesh, size, k_off)(jnp.asarray(bitmap), want_depth, jnp.asarray(loff)))
    bits = _gp_shards(pmesh, bitmap != 0)
    loffs = {g: offsets[o_shard == g] % shard for g in range(gp)}
    got = device.sharded_compact_gather(pmesh, bits, got_depth, loffs)
    assert sorted(got) == list(range(gp))
    for g in range(gp):
        idx, vals, ovals = got[g]
        keep = w_idx[g] >= 0
        assert idx.shape[0] == counts[g]
        np.testing.assert_array_equal(idx, w_idx[g][keep])
        np.testing.assert_array_equal(vals, w_vals[g][keep])
        np.testing.assert_array_equal(ovals, w_ovals[g][: loffs[g].shape[0]])
    idx_only = device.sharded_compact_gather(pmesh, bits)
    for g in range(gp):
        np.testing.assert_array_equal(idx_only[g][0], got[g][0])
        assert idx_only[g][1].shape == idx_only[g][2].shape == (0,)


# ---------------------------------------------------------------------------
# ShardedDepth
# ---------------------------------------------------------------------------

GAPS = {"t1": [(100, 900), (5000, 5001)], "t3": [(0, 64)], "t4": [(3300, 3333)]}


@pytest.fixture(scope="module")
def depth_pair(reads):
    """(jax, port) ShardedDepth of two read sets on mesh (2, 4)."""
    layout, tid, start, end = reads
    jmesh, pmesh = jax_make_mesh(8, dp=2), port_mesh(2, 4)
    half = tid.shape[0] // 2
    out = []
    for sl in (slice(None), slice(half)):
        j = JaxShardedDepth.from_reads(jmesh, layout, tid[sl], start[sl], end[sl], 15)
        p = ShardedDepth.from_reads(pmesh, layout, tid[sl], start[sl], end[sl], 15)
        out.append((j, p))
    return out


def _same_depth(j, p):
    got, want = p.materialize_dict(), j.materialize_dict()
    assert list(got) == list(want)
    for t in want:
        np.testing.assert_array_equal(got[t], want[t])


def _same_events(j, p):
    got, want = p.to_events(), j.to_events()
    assert list(got) == list(want)
    for t in want:
        np.testing.assert_array_equal(got[t].boundaries, want[t].boundaries)
        np.testing.assert_array_equal(got[t].values, want[t].values)
        assert got[t].length == want[t].length


@pytest.mark.parametrize("op", ["from_reads", "mask_gaps", "maximum", "collapse_dict",
                                "to_events"])
def test_sharded_depth_ops_match_jax(depth_pair, op):
    (j, p), (j2, p2) = depth_pair
    if op == "from_reads":
        _same_depth(j, p)
        _same_depth(j2, p2)
    elif op == "mask_gaps":
        _same_depth(j.mask_gaps(GAPS), p.mask_gaps(GAPS))
        assert p.mask_gaps({}) is p
    elif op == "maximum":
        _same_depth(j.maximum(j2), p.maximum(p2))
    elif op == "collapse_dict":
        for args in ((-1, 0, 15, 0), (-1, 2, 15, 0), (0, 3, 7, 100)):
            assert p.collapse_dict(*args) == j.collapse_dict(*args), args
            jm, pm = j.mask_gaps(GAPS), p.mask_gaps(GAPS)
            assert pm.collapse_dict(*args) == jm.collapse_dict(*args), args
    else:
        _same_events(j, p)
        _same_events(j.mask_gaps(GAPS).maximum(j2), p.mask_gaps(GAPS).maximum(p2))


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    # imported here: the card's machine has run this module's cuda cases
    # where tests.fixtures did not import at a module's top level
    from tests.fixtures import make_bam, make_fasta, make_paf, random_reads

    rng = np.random.default_rng(0x5AD7)
    d = tmp_path_factory.mktemp("sharded_inputs")
    ref = str(d / "ref.fa")
    recs = []
    for r, L in zip(REFS, LENS):
        seq = "".join(rng.choice(list("ACGT"), size=L))
        for gr, (s, e) in (("chrA", (12000, 12400)), ("chrC", (0, 64))):
            if r == gr:
                seq = seq[:s] + "N" * (e - s) + seq[e:]
        recs.append((r, seq))
    make_fasta(ref, recs)
    hifi, nano = str(d / "hifi.bam"), str(d / "nano.bam")
    make_bam(hifi, REFS, LENS, random_reads(rng, REFS, LENS, 900, name_prefix="h"))
    make_bam(nano, REFS, LENS, random_reads(rng, REFS, LENS, 700, name_prefix="n"))
    regions = str(d / "regions.bed")
    with open(regions, "w") as f:
        f.write("chrA\t1000\t15000\nchrB\t0\t20000\n")
    rows = []
    for k in range(300):
        ri = int(rng.integers(0, len(REFS)))
        L = LENS[ri]
        s = int(rng.integers(0, L - 100))
        e = int(s + rng.integers(50, min(L - s, 5000)))
        rows.append((f"h{k}", int((e - s) * rng.uniform(1.0, 1.3)), 0, e - s, "+", REFS[ri],
                     L, s, e, int((e - s) * rng.uniform(0.85, 1.0)), e - s,
                     int(rng.choice([0, 30, 60]))))
    paf = str(d / "hifi.paf")
    make_paf(paf, rows)
    return dict(ref=ref, hifi=hifi, nano=nano, regions=regions, paf=paf)


def _contents(root: str) -> dict[str, bytes]:
    """Every file under root by relative path; .gz files inflated."""
    found = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            opener = gzip.open if name.endswith(".gz") else open
            with opener(p, "rb") as f:
                found[os.path.relpath(p, root)] = f.read()
    return found


def _run_in(work: str, call) -> tuple[dict, str]:
    """``call()`` in an empty ``work`` (plot titles hold its path); the files
    it wrote and its stdout."""
    shutil.rmtree(work, ignore_errors=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        call()
    return _contents(work), buf.getvalue()


# the four cases of tests/test_sharded_pipeline.py: run_gci's arguments from
# the inputs, and the number of files the run writes beside images/
CASES = {
    "single_type": (lambda i: dict(hifi=[i["hifi"]], prefix="S"), 4),
    "dual_type_regions": (lambda i: dict(hifi=[i["hifi"]], nano=[i["nano"]], prefix="D",
                                         regions=i["regions"], threshold=1), 9),
    "paf_curation": (lambda i: dict(hifi=[i["hifi"], i["paf"]], prefix="P"), 4),
    "plot": (lambda i: dict(hifi=[i["hifi"]], prefix="V", plot=True, window_size=500), 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_gci_sharded_matches_jax(inputs, tmp_path, case):
    """run_gci(sharded, mesh 2,4) of both packages in one directory: the same
    files, byte for byte, and the same narration; the port's events run
    writes the same files."""
    args, n_files = CASES[case]
    work = str(tmp_path / "w")
    common = dict(reference=inputs["ref"], directory=work, **args(inputs))
    want, want_out = _run_in(work, lambda: jax_run_gci(depth_backend="sharded", mesh="2,4",
                                                       **common))
    got, got_out = _run_in(work, lambda: run_gci(depth_backend="sharded", mesh="2,4",
                                                 torch_device="cpu", **common))
    events, _ = _run_in(work, lambda: run_gci(depth_backend="events", **common))
    assert sorted(got) == sorted(want) == sorted(events)
    assert len([n for n in want if "/" not in n]) == n_files
    for name in want:
        assert got[name] == want[name], name
        assert events[name] == want[name], name
    assert got_out == want_out
    if case == "plot":
        assert any(n.startswith("images/") and n.endswith(".png") for n in want)


def test_cli_echo_with_mesh_matches_jax(inputs, tmp_path, capsys, monkeypatch):
    """``--mesh 2,4`` (which implies sharded): the port's ``Used
    arguments:`` line is gci_tpu.cli's, and so are the outputs; the port's
    run is put on the CPU (without that it needs a card)."""
    real = pipeline.resolve_backend
    monkeypatch.setattr(pipeline, "resolve_backend",
                        lambda backend, dev=None: real(backend, "cpu"))
    out = str(tmp_path / "out")
    argv = ["-r", inputs["ref"], "--hifi", inputs["hifi"], "--nano", inputs["nano"],
            "-R", inputs["regions"], "-d", out, "-o", "E", "-f", "--mesh", "2,4"]
    echoes, files = [], []
    for main in (jax_cli.main, cli.main):
        main(argv)
        echoes.append([l for l in capsys.readouterr().out.splitlines()
                       if l.startswith("Used arguments:")])
        files.append(_contents(out))
        shutil.rmtree(out)
    assert len(echoes[0]) == 1 and echoes[1] == echoes[0]
    assert "'mesh': '2,4'" in echoes[0][0] and "'depth_backend': 'sharded'" in echoes[0][0]
    assert files[1] == files[0] and len(files[0]) == 9


def test_sharded_needs_a_card_unless_the_cpu_is_named(inputs, tmp_path, monkeypatch):
    """--mesh or --device sharded without CUDA exits with an error before
    writing anything; run_gci raises; a mesh of CPU positions is refused
    for a run on CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    for extra in (["--mesh", "1,1"], ["--device", "sharded"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(["-r", inputs["ref"], "--hifi", inputs["hifi"], "-d", out, *extra])
        assert exc.value.code not in (0, None)
        assert not os.path.exists(out)
    with pytest.raises(RuntimeError, match="is_available"):
        run_gci(hifi=[inputs["hifi"]], reference=inputs["ref"], directory=out,
                depth_backend="sharded", mesh="1,1")
    with pytest.raises(ValueError, match="mesh positions on cpu"):
        resolve_mesh(port_mesh(1, 2), torch.device("cuda", 0))


def test_mesh_layout_and_specs():
    """Positions fill the mesh process-major and row-major; gp is favoured;
    too few positions or a spec that does not divide raise ValueError, a
    bad spec exits with gci_tpu's message."""
    m = make_mesh(8, devices=[CPU] * 8)
    assert m.shape == {"dp": 1, "gp": 8} == dict(jax_make_mesh(8).shape)
    for n in (1, 2, 3, 4, 6, 8):
        assert make_mesh(n, devices=[CPU] * 8).shape == dict(jax_make_mesh(n).shape)
    assert parse_mesh_spec("2,4", devices=[CPU] * 8).shape == {"dp": 2, "gp": 4}
    assert parse_mesh_spec("auto", devices=[CPU] * 6).shape == {"dp": 1, "gp": 6}
    assert resolve_mesh("4,2", CPU).shape == {"dp": 4, "gp": 2}
    assert resolve_mesh(None, CPU).shape == {"dp": 1, "gp": 1}
    m = port_mesh(2, 4)
    assert resolve_mesh(m, CPU) is m
    assert (m.processes == 0).all() and m.local_gp() == [0, 1, 2, 3]
    assert [d for d, _ in m.local_positions(3)] == [0, 1]
    with pytest.raises(ValueError, match="needs more than"):
        make_mesh(8, dp=2, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="do not form a mesh"):
        make_mesh(6, dp=4, devices=[CPU] * 8)
    with pytest.raises(SystemExit, match="Invalid mesh spec"):
        parse_mesh_spec("2x4", devices=[CPU] * 8)
    np.testing.assert_array_equal(pad_to_multiple(np.arange(5), 4, fill=-1),
                                  [0, 1, 2, 3, 4, -1, -1, -1])


def test_profile_trace_writes_a_trace(inputs, tmp_path):
    """--profile-trace DIR: a torch.profiler Chrome trace of the run lands in
    DIR (CPU activity here; the card's run adds CUDA activity)."""
    import json

    from gci_tpu_torch.utils.metrics import trace_path

    trace = str(tmp_path / "trace")
    cli.main(["-r", inputs["ref"], "--hifi", inputs["hifi"], "-d", str(tmp_path / "out"),
              "--device", "events", "--profile-trace", trace])
    with open(trace_path(trace, 0)) as f:
        events = json.load(f)["traceEvents"]
    assert events


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda0():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dp,gp", MESHES)
def test_sharded_depth_on_cuda_matches_cpu(reads, cuda0, dp, gp):
    """Positions on cuda:0 against positions on cpu: depth, gap masking,
    two-type max, issue intervals and run boundaries all equal."""
    from gci_tpu_torch import kernels

    layout, tid, start, end = reads
    half = tid.shape[0] // 2
    out = []
    kernels.reset_launch_counts()
    for dev in (cuda0, CPU):
        mesh = port_mesh(dp, gp, dev)
        a = ShardedDepth.from_reads(mesh, layout, tid, start, end, 15).mask_gaps(GAPS)
        b = ShardedDepth.from_reads(mesh, layout, tid[:half], start[:half], end[:half], 15)
        m = a.maximum(b)
        out.append((m.materialize_dict(), m.to_events(), m.collapse_dict(-1, 1, 15),
                    a.collapse_dict(-1, 0, 15)))
        if dev == cuda0:
            # per shard: two read sets, the gaps, two scan windows; two
            # collapses of two edge bitmaps, one change bitmap
            assert kernels.LAUNCHES["depth_scan"] == 5 * gp
            assert kernels.LAUNCHES["depth_scan_int8"] == 5 * gp
    (d1, e1, c1, a1), (d2, e2, c2, a2) = out
    for t in d2:
        np.testing.assert_array_equal(d1[t], d2[t])
        np.testing.assert_array_equal(e1[t].boundaries, e2[t].boundaries)
        np.testing.assert_array_equal(e1[t].values, e2[t].values)
    assert c1 == c2 and a1 == a2
