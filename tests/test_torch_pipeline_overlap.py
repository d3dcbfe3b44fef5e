"""The pack<->scatter overlap on the port's CLI path against gci_tpu's.

``gci_tpu_torch.pipeline.run_filter`` folds each BAM chunk into an overlap
accumulator for a read type of one BAM and no PAF, in one process, on the
``device`` or ``streamed`` backend, exactly where ``gci_tpu``'s does on the
CPU (on a CUDA device only with ``GCI_FORCE_OVERLAP``).  Here the gate
(``_make_overlap_accumulator``) is held against ``gci_tpu``'s,
``run_filter`` and the dual-type CLI against ``gci_tpu``'s overlap runs on
the same BAM chunks (8 KiB of inflated BAM, sweep chunks of 4096 slots),
byte for byte, with and without ``GCI_NO_OVERLAP``; the last-wins fold at
hundreds of BAM chunks against ``gci_tpu``'s, with its pocket count; and an
error inside the overlap must end the run.  The port runs on the CPU (its
kernels' plain versions), ``gci_tpu`` on JAX's CPU backend.
"""
import gzip
import math
import os

import numpy as np
import pytest
import torch

from gci_tpu import cli as jax_cli
from gci_tpu import pipeline as jax_pipeline
from gci_tpu.depth import overlap as jax_overlap
from gci_tpu.depth.accum import GenomeLayout as JaxGenomeLayout
from gci_tpu.filters.cascade import dedup_last_wins as jax_dedup
from gci_tpu.io.names import hash_names as jax_hash_names
from gci_tpu.io.names import keys_view as jax_keys_view
from gci_tpu_torch import cli, pipeline
from gci_tpu_torch.depth import overlap
from gci_tpu_torch.depth.accum import GenomeLayout
from gci_tpu_torch.filters.cascade import dedup_last_wins
from gci_tpu_torch.io.bam_writer import build_record, write_bam
from gci_tpu_torch.io.fasta import scan_fasta
from gci_tpu_torch.io.names import hash_names, keys_view

CPU = torch.device("cpu")
FLANK = 15
REFS = ["cA", "cB", "cC"]
LENS = [30000, 20000, 4096]
BAM_CHUNK = 8 * 1024  # inflated bytes per BAM chunk: many chunks per BAM
SWEEP_CHUNK = 4096  # slots per genome chunk of the sweep
OUTPUTS = [
    "P_hifi.depth.gz", "P_nano.depth.gz", "P_two_type.depth.gz",
    "P_hifi.0.depth.bed", "P_nano.0.depth.bed", "P_two_type.0.depth.bed",
    "P.gci", "P.regions.gci", "P.gaps.bed",
]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The three-target genome with two N runs, a regions BED, and per read
    type a coordinate-sorted BAM and one in file order (names drawn from a
    pool of the read count: about a third repeat, across BAM chunks)."""
    # imported here: where another package named ``tests`` is installed, a
    # module-level import would stop the cuda-marked cases' collection
    from tests.fixtures import make_bam, make_fasta, random_reads

    rng = np.random.default_rng(0x0E12)
    d = tmp_path_factory.mktemp("pipeline_overlap_inputs")
    seqs = []
    for r, L in zip(REFS, LENS):
        seq = "".join(rng.choice(list("ACGT"), size=L))
        if r == "cA":
            seq = seq[:9000] + "N" * 300 + seq[9300:]
        if r == "cC":
            seq = "N" * 64 + seq[64:]
        seqs.append((r, seq))
    paths = {"ref": str(d / "ref.fa"), "regions": str(d / "regions.bed")}
    make_fasta(paths["ref"], seqs)
    with open(paths["regions"], "w") as f:
        f.write("cA\t1000\t15000\ncB\t0\t20000\n")
    ids = {r: k for k, r in enumerate(REFS)}
    for typ, n in (("hifi", 800), ("nano", 600)):
        paths[f"sorted_{typ}"] = str(d / f"sorted_{typ}.bam")
        make_bam(paths[f"sorted_{typ}"], REFS, LENS,
                 random_reads(rng, REFS, LENS, n, name_prefix=typ[0]))
        # in file order, not coordinate-sorted (make_bam always sorts)
        paths[f"unsorted_{typ}"] = str(d / f"unsorted_{typ}.bam")
        recs = [build_record(rd["name"], ids[rd["ref"]], rd["pos"], rd["mapq"], rd["cigar"],
                             flag=rd["flag"], nm=rd["nm"])
                for rd in random_reads(rng, REFS, LENS, n, name_prefix="u" + typ[0])]
        write_bam(paths[f"unsorted_{typ}"], REFS, LENS, recs, level=1)
    return paths


@pytest.fixture
def chunked(monkeypatch):
    """Both packages read BAM chunks of BAM_CHUNK bytes and sweep genome
    chunks of SWEEP_CHUNK slots; neither has the overlap turned off or
    forced."""
    monkeypatch.setenv("GCI_BAM_CHUNK_BYTES", str(BAM_CHUNK))
    monkeypatch.setenv("GCI_STREAM_CHUNK_SLOTS", str(SWEEP_CHUNK))
    monkeypatch.delenv("GCI_NO_OVERLAP", raising=False)
    monkeypatch.delenv("GCI_FORCE_OVERLAP", raising=False)


def _spy_accumulators(monkeypatch) -> list:
    """Each accumulator the port's gate returns (None where it turns the
    overlap off), in call order."""
    made = []
    real = pipeline._make_overlap_accumulator
    monkeypatch.setattr(pipeline, "_make_overlap_accumulator",
                        lambda *a, **k: (made.append(real(*a, **k)), made[-1])[1])
    return made


def _inflated(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def _same(p1, p2) -> bool:
    if p1.endswith(".gz"):
        return _inflated(p1) == _inflated(p2)
    with open(p1, "rb") as a, open(p2, "rb") as b:
        return a.read() == b.read()


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

GATE_CASES = {
    # case: (backend, PAF files, BAM files, multihost, environment)
    "device": ("device", [], ["x.bam"], False, {}),
    "streamed": ("streamed", [], ["x.bam"], False, {}),
    "paf": ("device", ["x.paf"], ["x.bam"], False, {}),
    "two_bams": ("device", [], ["x.bam", "y.bam"], False, {}),
    "multihost": ("streamed", [], ["x.bam"], True, {}),
    "events": ("events", [], ["x.bam"], False, {}),
    "numpy": ("numpy", [], ["x.bam"], False, {}),
    "sharded": ("sharded", [], ["x.bam"], False, {}),
    "no_overlap": ("device", [], ["x.bam"], False, {"GCI_NO_OVERLAP": "1"}),
    "no_overlap_streamed": ("streamed", [], ["x.bam"], False, {"GCI_NO_OVERLAP": "1"}),
    "force_overlap": ("device", [], ["x.bam"], False, {"GCI_FORCE_OVERLAP": "1"}),
    "force_overlap_streamed": ("streamed", [], ["x.bam"], False,
                               {"GCI_FORCE_OVERLAP": "1", "GCI_STREAM_CHUNK_SLOTS": "1000"}),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_matches_jax(monkeypatch, case):
    """The port's gate gives None exactly where gci_tpu's does, and
    otherwise the same kind of accumulator: a resident delta of the
    genome's slots for ``device``, a sweep over chunks of
    GCI_STREAM_CHUNK_SLOTS slots (streamed.CHUNK_SLOTS unless set) for
    ``streamed``."""
    from gci_tpu_torch.depth import streamed

    backend, pafs, bams, multihost, env = GATE_CASES[case]
    for name in ("GCI_NO_OVERLAP", "GCI_FORCE_OVERLAP", "GCI_STREAM_CHUNK_SLOTS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    lens = dict(zip(REFS, LENS))
    layout = GenomeLayout.from_targets(lens)
    got = pipeline._make_overlap_accumulator(backend, pafs, bams, multihost, layout, FLANK,
                                             CPU)
    want = jax_pipeline._make_overlap_accumulator(
        backend, pafs, bams, multihost, JaxGenomeLayout.from_targets(lens), FLANK)
    assert (got is None) == (want is None)
    assert (got is None) == (case not in ("device", "streamed", "force_overlap",
                                          "force_overlap_streamed"))
    if want is None:
        return
    if isinstance(want, jax_overlap.DeltaAccumulator):
        assert isinstance(got, overlap.DeltaAccumulator)
        assert got.delta.shape == (layout.total_slots,) and got.delta.device == CPU
    else:
        assert isinstance(want, jax_overlap.SweepAccumulator)
        assert isinstance(got, overlap.SweepAccumulator) and got.device == CPU
        chunk = int(env.get("GCI_STREAM_CHUNK_SLOTS", streamed.CHUNK_SLOTS))
        assert got.chunk_slots == min(chunk, layout.total_slots)
    assert got.chunks_added == 0


@pytest.mark.parametrize("backend", ["device", "streamed"])
@pytest.mark.parametrize("env", [{}, {"GCI_NO_OVERLAP": "1"},
                                 {"GCI_NO_OVERLAP": "1", "GCI_FORCE_OVERLAP": "1"}])
def test_gate_is_off_on_a_cuda_device_unless_forced(monkeypatch, backend, env):
    """On a CUDA device the overlap is off by default (it was slower on the
    H100), and GCI_NO_OVERLAP wins over GCI_FORCE_OVERLAP; the gate decides
    before it allocates anything, so this runs without a card."""
    for name in ("GCI_NO_OVERLAP", "GCI_FORCE_OVERLAP"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    layout = GenomeLayout.from_targets(dict(zip(REFS, LENS)))
    assert pipeline._make_overlap_accumulator(
        backend, [], ["x.bam"], False, layout, FLANK, torch.device("cuda", 0)) is None


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["device", "streamed"])
def test_gate_forced_on_a_cuda_device(monkeypatch, backend):
    """GCI_FORCE_OVERLAP turns the overlap on on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.delenv("GCI_NO_OVERLAP", raising=False)
    monkeypatch.setenv("GCI_FORCE_OVERLAP", "1")
    dev = torch.device("cuda", torch.cuda.current_device())
    layout = GenomeLayout.from_targets(dict(zip(REFS, LENS)))
    acc = pipeline._make_overlap_accumulator(backend, [], ["x.bam"], False, layout, FLANK, dev)
    kind = overlap.DeltaAccumulator if backend == "device" else overlap.SweepAccumulator
    assert isinstance(acc, kind)
    assert (acc.delta.device if backend == "device" else acc.device) == dev


# ---------------------------------------------------------------------------
# run_filter and the dual-type CLI against gci_tpu's overlap runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bam", ["sorted_hifi", "unsorted_hifi", "sorted_nano"])
@pytest.mark.parametrize("backend", ["device", "streamed"])
def test_run_filter_overlap_matches_jax(inputs, tmp_path, monkeypatch, chunked, backend, bam):
    """run_filter of one BAM and no PAF folds its BAM chunks into the
    backend's accumulator (many chunks, records retracted) and writes the
    checkpoint gci_tpu's run_filter writes through its own overlap, and
    the one gci_tpu's events backend writes."""
    made = _spy_accumulators(monkeypatch)
    d = str(tmp_path)
    gaps = scan_fasta(inputs["ref"])[1]
    jax_pipeline.run_filter([], [inputs[bam]], "J", directory=d, depth_backend=backend,
                            gaps=gaps, threshold=1)
    jax_pipeline.run_filter([], [inputs[bam]], "E", directory=d, depth_backend="events")
    pipeline.run_filter([], [inputs[bam]], "P", directory=d, depth_backend=backend,
                        torch_device="cpu", gaps=gaps, threshold=1)
    (acc,) = made
    kind = overlap.DeltaAccumulator if backend == "device" else overlap.SweepAccumulator
    assert isinstance(acc, kind)
    assert acc.chunks_added > 1 and acc.rows_retracted > 0
    if backend == "streamed":
        assert acc.chunk_slots == SWEEP_CHUNK
        assert acc._unsorted == bam.startswith("unsorted")
        assert acc.frontier == acc.n_chunks
    for other in ("J", "E"):
        assert _inflated(f"{d}/P.depth.gz") == _inflated(f"{d}/{other}.depth.gz"), other


def _cli_argv(inputs, pair: str, out: str, backend: str) -> list[str]:
    return ["-r", inputs["ref"], "--hifi", inputs[f"{pair}_hifi"],
            "--nano", inputs[f"{pair}_nano"], "-R", inputs["regions"], "-d", out,
            "-o", "P", "-t", "2", "-f", "--device", backend]


def _port_cli_on_cpu(monkeypatch, argv):
    real = pipeline.resolve_backend
    monkeypatch.setattr(pipeline, "resolve_backend",
                        lambda backend, device=None: real(backend, "cpu"))
    cli.main(argv)


@pytest.mark.parametrize("overlap_on", [True, False], ids=["overlap", "no_overlap"])
@pytest.mark.parametrize("pair", ["sorted", "unsorted"])
@pytest.mark.parametrize("backend", ["device", "streamed"])
def test_dual_type_cli_matches_jax(inputs, tmp_path, monkeypatch, chunked, backend, pair,
                                   overlap_on):
    """The dual-type CLI on the same argv in both packages: all nine
    outputs byte-equal (checkpoints inflated), through the overlap for both
    read types or, under GCI_NO_OVERLAP, through neither; and equal to
    gci_tpu's events run."""
    if not overlap_on:
        monkeypatch.setenv("GCI_NO_OVERLAP", "1")
    made = _spy_accumulators(monkeypatch)
    dirs = {k: str(tmp_path / k) for k in ("jax", "port", "events")}
    jax_cli.main(_cli_argv(inputs, pair, dirs["jax"], backend))
    jax_cli.main(_cli_argv(inputs, pair, dirs["events"], "events"))
    _port_cli_on_cpu(monkeypatch, _cli_argv(inputs, pair, dirs["port"], backend))
    assert len(made) == 2  # HiFi and ONT
    if overlap_on:
        assert all(acc is not None and acc.chunks_added > 1 for acc in made)
        assert sum(acc.rows_retracted for acc in made) > 0
    else:
        assert made == [None, None]
    for name in OUTPUTS:
        for other in ("jax", "events"):
            assert _same(os.path.join(dirs["port"], name),
                         os.path.join(dirs[other], name)), (name, other)


# ---------------------------------------------------------------------------
# the fold at many chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_chunks", [(11, 320), (12, 517)])
def test_fold_at_many_chunks_matches_jax(seed, n_chunks):
    """Hundreds of chunks, names re-used from near and far chunks: every
    chunk's retracted rows equal gci_tpu's, in order, and the port's pocket
    count never passes ceil(log2 chunks) + 2 (gci_tpu keeps one a chunk)."""
    rng = np.random.default_rng(seed)
    n = 40 * n_chunks
    names = [f"q{int(rng.integers(0, n // 3))}".encode() for _ in range(n)]
    tid = rng.integers(0, 3, n).astype(np.int32)
    start = rng.integers(0, 50_000, n).astype(np.int64)
    end = start + rng.integers(1, 900, n)
    bounds = np.linspace(0, n, n_chunks + 1).astype(int)
    bounds[1:-1] += rng.integers(-15, 16, n_chunks - 1)  # chunks of 25-70 rows
    fold, jfold = overlap.LastWinsFold(), jax_overlap.LastWinsFold()
    keys, jkeys = hash_names(names), jax_hash_names(names)
    n_retracted, most = 0, 0
    for c, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]), start=1):
        surv = dedup_last_wins(keys[lo:hi], np.ones(hi - lo, bool)) + lo
        jsurv = jax_dedup(jkeys[lo:hi], np.ones(hi - lo, bool)) + lo
        got = fold.fold(keys_view(keys[surv]), tid[surv], start[surv], end[surv])
        want = jfold.fold(jax_keys_view(jkeys[jsurv]), tid[jsurv], start[jsurv], end[jsurv])
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        n_retracted += got[0].shape[0]
        assert len(fold._pockets) <= math.ceil(math.log2(c)) + 2, c
        most = max(most, len(fold._pockets))
    assert len(jfold._pockets) == n_chunks
    assert n_retracted > n // 4
    assert most <= math.ceil(math.log2(n_chunks)) + 2


def _colliding_names(rng, pool: int) -> np.ndarray:
    """(pool, 2) uint64 keys of distinct names, a third of which share their
    first word with another name (a 64-bit collision); words above 2^63
    too, so that a signed comparison would show."""
    names = rng.integers(0, 2**63, (pool, 2), dtype=np.int64).astype(np.uint64)
    names[rng.random(pool) < 0.5] |= np.uint64(1 << 63)
    share = rng.random(pool) < 1 / 3
    names[share, 0] = names[rng.integers(0, pool, int(share.sum())), 0]
    return np.unique(names, axis=0)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_dedup_last_wins_matches_jax(seed):
    """The port's dedup (a stable sort on the two words) gives gci_tpu's
    indices (np.unique of the structured keys), in the same order, on keys
    whose first words collide and under random masks."""
    rng = np.random.default_rng(seed)
    for n, pool in ((1, 1), (50, 5), (3000, 700), (20_000, 20_000)):
        names = _colliding_names(rng, pool)
        keys = names[rng.integers(0, names.shape[0], n)]
        for kept in (np.ones(n, bool), rng.random(n) < 0.6, np.zeros(n, bool)):
            got, want = dedup_last_wins(keys, kept), jax_dedup(keys, kept)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [31, 32])
def test_fold_with_colliding_first_words_matches_jax(seed):
    """Keys whose first words collide (searched as runs of their own), in
    chunks handed over unsorted as well as in the dedup's order: every
    chunk's retracted rows equal gci_tpu's, in order."""
    rng = np.random.default_rng(seed)
    fold, jfold = overlap.LastWinsFold(), jax_overlap.LastWinsFold()
    names = _colliding_names(rng, 400)
    n_retracted = 0
    for c in range(80):
        n = int(rng.integers(1, 120))
        keys = names[rng.integers(0, names.shape[0], n)]
        surv = dedup_last_wins(keys, np.ones(n, bool))
        if c % 2:
            surv = rng.permutation(surv)
        tid = rng.integers(0, 3, surv.shape[0]).astype(np.int32)
        start = rng.integers(0, 9000, surv.shape[0]).astype(np.int64)
        end = start + 100
        got = fold.fold(keys_view(keys[surv]), tid, start, end)
        want = jfold.fold(jax_keys_view(keys[surv]), tid, start, end)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)
        n_retracted += got[0].shape[0]
    assert n_retracted > 1000
    assert (np.unique(names[:, 0]).shape[0] < names.shape[0]
            and np.any(names[:, 0] >= np.uint64(1 << 63)))


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["device", "streamed"])
def test_an_error_in_the_overlap_ends_the_run(inputs, tmp_path, monkeypatch, chunked, backend):
    """An accumulator that raises makes run_filter raise, after the first
    chunk, with no checkpoint written: there is no fallback to the depth
    of the curated reads."""
    kind = overlap.DeltaAccumulator if backend == "device" else overlap.SweepAccumulator
    calls = []

    def fail(self, *args):
        calls.append(1)
        raise RuntimeError("the card is gone")

    monkeypatch.setattr(kind, "add_chunk", fail)
    with pytest.raises(RuntimeError, match="the card is gone"):
        pipeline.run_filter([], [inputs["sorted_hifi"]], "P", directory=str(tmp_path),
                            depth_backend=backend, torch_device="cpu")
    assert calls == [1]
    assert not os.path.exists(tmp_path / "P.depth.gz")
