"""The port's side-car tools and the modules they reach, against gci_tpu's.

Every case of ``tests/test_tools.py`` and ``tests/test_plotter_v2.py`` runs
here as a comparison: the same inputs, made from a seeded numpy RNG, go
through the ``gci_tpu`` tool and through its ``gci_tpu_torch`` counterpart,
one after the other in the same directory (paths appear in plot titles),
and every file written must be byte-equal (``.gz`` after inflating), as
must what each tool prints.  Functions that return arrays must return equal
arrays.  The checkpoint readers are held against each other on files of
every layout a reader meets, and ``score_only`` must reproduce a dual-type
run's reports from its three checkpoints, in each package.
"""
import contextlib
import gzip
import io
import os
import shutil
import struct
import zlib

import numpy as np
import pytest

import gci_tpu.io.bai as jax_bai
import gci_tpu.io.depth_file as jax_depth_file
import gci_tpu.tools.convert_depth as jax_convert_depth
import gci_tpu.tools.filter_bam as jax_filter_bam
import gci_tpu.tools.plot_only as jax_plot_only
import gci_tpu.tools.plotter_v2 as jax_plotter_v2_cli
import gci_tpu.tools.score_only as jax_score_only
import gci_tpu.viz.plotter_v2 as jax_plotter_v2
from gci_tpu.pipeline import run_gci as jax_run_gci

import gci_tpu_torch.io.bai as bai
import gci_tpu_torch.io.depth_file as depth_file
import gci_tpu_torch.tools.convert_depth as convert_depth
import gci_tpu_torch.tools.filter_bam as filter_bam
import gci_tpu_torch.tools.plot_only as plot_only
import gci_tpu_torch.tools.plotter_v2 as plotter_v2_cli
import gci_tpu_torch.tools.score_only as score_only
import gci_tpu_torch.viz.plotter_v2 as plotter_v2
from gci_tpu_torch.io.bam import read_bam
from gci_tpu_torch.pipeline import run_gci
from tests.fixtures import make_bam, make_fasta, make_paf, random_reads

REFS = ["chrA", "chrB"]
LENS = [30000, 20000]

# (gci_tpu module, gci_tpu_torch module) pairs
SCORE = (jax_score_only, score_only)
PLOT = (jax_plot_only, plot_only)
CONVERT = (jax_convert_depth, convert_depth)
FILTER = (jax_filter_bam, filter_bam)
PLOTTER_CLI = (jax_plotter_v2_cli, plotter_v2_cli)
PLOTTER = (jax_plotter_v2, plotter_v2)
DEPTH_FILE = (jax_depth_file, depth_file)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A reference with an N run, HiFi and ONT BAMs, a PAF, a regions BED,
    and gci_tpu's single-type run on the HiFi BAM (prefix X)."""
    rng = np.random.default_rng(0x7001)
    d = tmp_path_factory.mktemp("tools_inputs")
    ref = str(d / "ref.fa")
    recs = []
    for r, L in zip(REFS, LENS):
        seq = "".join(rng.choice(list("ACGT"), size=L))
        if r == "chrA":
            seq = seq[:7000] + "N" * 300 + seq[7300:]
        recs.append((r, seq))
    make_fasta(ref, recs)
    bam = str(d / "hifi.bam")
    make_bam(bam, REFS, LENS, random_reads(rng, REFS, LENS, 600, name_prefix="h"))
    nano = str(d / "nano.bam")
    make_bam(nano, REFS, LENS, random_reads(rng, REFS, LENS, 400, name_prefix="n"))
    rows = []
    for k in range(200):
        ri = int(rng.integers(0, len(REFS)))
        L = LENS[ri]
        s = int(rng.integers(0, L - 100))
        e = int(s + rng.integers(50, min(L - s, 5000)))
        rows.append((f"h{k}", int((e - s) * rng.uniform(1.0, 1.3)), 0, e - s, "+",
                     REFS[ri], L, s, e, int((e - s) * rng.uniform(0.85, 1.0)), e - s,
                     int(rng.choice([0, 30, 60]))))
    paf = str(d / "hifi.paf")
    make_paf(paf, rows)
    regions = str(d / "regions.bed")
    with open(regions, "w") as f:
        f.write("chrA\t1000\t9000\nchrB\t0\t5000\n")
    out = str(d / "out")
    jax_run_gci(hifi=[bam], reference=ref, directory=out, prefix="X",
                depth_backend="events")
    return dict(ref=ref, bam=bam, nano=nano, paf=paf, regions=regions, out=out)


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


def _run_both(work: str, pair, call):
    """``call(module)`` for the gci_tpu module, then for the port's, each in
    an empty ``work``; returns (files, stdout) of each run, gci_tpu's first."""
    results = []
    for mod in pair:
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            call(mod)
        results.append((_contents(work), buf.getvalue()))
    return results


def _assert_same(results, expect=()):
    (want, want_out), (got, got_out) = results
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert got_out == want_out
    for name in expect:
        assert name in want, name
    return want


# ---------------------------------------------------------------------------
# tests/test_tools.py, as comparisons
# ---------------------------------------------------------------------------

def test_score_resume_matches(dataset, tmp_path):
    work = str(tmp_path / "w")
    files = _assert_same(_run_both(work, SCORE, lambda m: m.run_score(
        hifi=f'{dataset["out"]}/X.depth.gz', reference=dataset["ref"],
        directory=work, prefix="X")), ["X.gci", "X.0.depth.bed", "X.gaps.bed"])
    with open(f'{dataset["out"]}/X.gci', "rb") as f:
        assert files["X.gci"] == f.read()


def test_score_bed_mode(dataset, tmp_path):
    work = str(tmp_path / "w")
    files = _assert_same(_run_both(work, SCORE, lambda m: m.run_score(
        hifi=f'{dataset["out"]}/X.0.depth.bed', reference=dataset["ref"],
        directory=work, prefix="X", bed_input=True)), ["X.gci"])
    with open(f'{dataset["out"]}/X.gci', "rb") as f:
        assert files["X.gci"] == f.read()


@pytest.mark.parametrize("mode", ["genome", "regions"])
def test_plot_only_tool(dataset, tmp_path, mode):
    work = str(tmp_path / "w")
    kw = dict(reference=dataset["ref"], hifi=f'{dataset["out"]}/X.depth.gz',
              directory=work, prefix="P", window_size=1000)
    if mode == "regions":
        regions = str(tmp_path / "regions.bed")
        with open(regions, "w") as f:
            f.write("chrA\t100\t5000\n")
        kw.update(regions=regions, depth_mean="12.5")
        expect = ["P.chrA:100-5000.png"]
    else:
        expect = [f"P.{t}.png" for t in REFS]
    files = _assert_same(_run_both(work, PLOT, lambda m: m.run_plot(**kw)), expect)
    if mode == "regions":
        assert "P.chrA.png" not in files


def test_convert_depth(tmp_path):
    rng = np.random.default_rng(0x7002)
    src = str(tmp_path / "samtools.depth")
    want = {"c1": rng.integers(0, 90, 3000), "c2": np.array([0, 7]),
            "c3": rng.integers(0, 12000, 500)}
    with open(src, "w") as f:
        for chrom, vals in want.items():
            for i, v in enumerate(vals):
                f.write(f"{chrom}\t{i + 1}\t{v}\n")
    work = str(tmp_path / "w")
    files = _assert_same(_run_both(work, CONVERT, lambda m: m.convert(
        src, f"{work}/conv")), ["conv.depth.gz"])
    assert len(files) == 1
    depths, _ = depth_file.read_depth_gz(f"{work}/conv.depth.gz")
    assert list(depths) == list(want)
    for t, v in want.items():
        np.testing.assert_array_equal(depths[t], v)


def _bai_record_names(bam_path: str) -> list[bytes]:
    """The read name at every chunk start of the BAI: each virtual offset
    decoded into its BGZF block and record (which may run on into the next
    block)."""
    with open(bam_path + ".bai", "rb") as f:
        index = f.read()
    assert index[:4] == b"BAI\x01"
    with open(bam_path, "rb") as f:
        blob = f.read()

    def inflate(coff):
        xlen = blob[coff + 10] | (blob[coff + 11] << 8)
        (bsize,) = struct.unpack_from("<H", blob, coff + 16)
        end = coff + bsize + 1
        return zlib.decompress(blob[coff + 12 + xlen : end - 8], -15), end

    (n_ref,) = struct.unpack_from("<i", index, 4)
    off = 8
    names = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", index, off)
        off += 4
        for _ in range(n_bin):
            _bin, n_chunk = struct.unpack_from("<Ii", index, off)
            off += 8
            for _ in range(n_chunk):
                vo_s, _vo_e = struct.unpack_from("<QQ", index, off)
                off += 16
                coff, uoff = vo_s >> 16, vo_s & 0xFFFF
                payload, nxt = inflate(coff)
                if nxt < len(blob):
                    payload += inflate(nxt)[0]
                rec = payload[uoff:]
                names.append(rec[36 : 36 + rec[12] - 1])
        (n_intv,) = struct.unpack_from("<i", index, off)
        off += 4 + 8 * n_intv
    return names


def test_filter_bam_export(tmp_path):
    bam = str(tmp_path / "in.bam")
    reads = [
        dict(name="keep1", ref="chrA", pos=100, mapq=60, cigar="500M", nm=5),
        dict(name="keep2", ref="chrB", pos=50, mapq=60, cigar="300M", nm=0),
        dict(name="lowmq", ref="chrA", pos=900, mapq=10, cigar="500M", nm=5),
        dict(name="clipped", ref="chrA", pos=2000, mapq=60, cigar="300S500M", nm=5),
        dict(name="badiden", ref="chrA", pos=3000, mapq=60, cigar="500M", nm=200),
    ]
    make_bam(bam, REFS, LENS, reads)
    work = str(tmp_path / "w")
    outs = []
    _assert_same(_run_both(work, FILTER, lambda m: outs.append(m.run_filter_bam(
        [bam], directory=work, prefix=["flt"], force=True))), ["flt.bam", "flt.bam.bai"])
    assert outs[0] == outs[1] == [f"{work}/flt.bam"]
    assert sorted(read_bam(outs[1][0]).names) == [b"keep1", b"keep2"]
    assert set(_bai_record_names(outs[1][0])) == {b"keep1", b"keep2"}


@pytest.mark.parametrize("case", ["bam", "bam_paf", "two_bams"])
def test_filter_bam_cascade(dataset, tmp_path, case):
    """The cascade on fixture reads: one BAM, a BAM with a PAF (election
    and the high-quality set across files), and two BAMs with a prefix
    each; the BAMs and BAIs byte-equal, every BAI offset a record."""
    files = {"bam": [dataset["bam"]], "bam_paf": [dataset["bam"], dataset["paf"]],
             "two_bams": [dataset["bam"], dataset["nano"]]}[case]
    prefix = ["h", "n"] if case == "two_bams" else "bamsnap"
    work = str(tmp_path / "w")
    outs = []
    _assert_same(_run_both(work, FILTER, lambda m: outs.append(m.run_filter_bam(
        files, directory=work, prefix=prefix, threads=2, force=True))))
    assert outs[0] == outs[1]
    for out in outs[1]:
        names = _bai_record_names(out)
        assert names, out
        assert set(names) <= set(read_bam(out).names)


def test_filter_bam_snapshot(dataset, tmp_path):
    rng = np.random.default_rng(0x7003)
    ref = str(tmp_path / "ref.fa")
    make_fasta(ref, [(r, "".join(rng.choice(list("ACGT"), size=L)))
                     for r, L in zip(REFS, LENS)])
    bam = str(tmp_path / "in.bam")
    make_bam(bam, REFS, LENS, random_reads(rng, REFS, LENS, 100))
    work = str(tmp_path / "w")
    _assert_same(_run_both(work, FILTER, lambda m: m.run_filter_bam(
        [bam], directory=work, prefix=["flt", "snap"], force=True,
        plot=True, reference=ref, region="chrA:100-2000")), ["snap.png", "flt.bam"])


def test_score_dual_and_two_type_branches(dataset, tmp_path):
    """hifi + nano + two_type resume from checkpoints the port wrote."""
    depths, _ = depth_file.read_depth_gz(f'{dataset["out"]}/X.depth.gz')
    nano = {t: np.maximum(v - 1, 0) for t, v in depths.items()}
    two = {t: np.maximum(depths[t], nano[t]) for t in depths}
    np_path, tt_path = str(tmp_path / "n.depth.gz"), str(tmp_path / "t.depth.gz")
    depth_file.write_depth_gz(np_path, nano)
    depth_file.write_depth_gz(tt_path, two)
    work = str(tmp_path / "w")
    files = _assert_same(_run_both(work, SCORE, lambda m: m.run_score(
        hifi=f'{dataset["out"]}/X.depth.gz', nano=np_path, two_type=tt_path,
        reference=dataset["ref"], directory=work, prefix="X", force=True)),
        ["X.gci", "X.0.depth.bed"])
    text = files["X.gci"].decode()
    assert text.startswith("HiFi:\n")
    assert "\nNano:\n" in text and "\nHiFi + Nano:\n" in text
    assert text.count("Genome\t") == 3


def test_score_regions(dataset, tmp_path):
    work = str(tmp_path / "w")
    files = _assert_same(_run_both(work, SCORE, lambda m: m.run_score(
        hifi=f'{dataset["out"]}/X.depth.gz', reference=dataset["ref"],
        directory=work, prefix="XR", regions=dataset["regions"])), ["XR.regions.gci"])
    text = files["XR.regions.gci"].decode()
    assert text.startswith("Chromosome\tStart\tEnd\tHiFi\n")
    assert "All_regions\t*\t*\t" in text
    assert len([l for l in text.splitlines() if l.startswith("chr")]) == 2


@pytest.mark.parametrize("case", ["bed_with_regions", "missing_file", "no_depth"])
def test_score_main_refusals(dataset, tmp_path, case):
    """main's argument checks exit with gci_tpu's message."""
    argv = ["-r", dataset["ref"], "-d", str(tmp_path)] + {
        "bed_with_regions": ["--hifi", f'{dataset["out"]}/X.0.depth.bed', "--bed",
                             "-R", dataset["regions"]],
        "missing_file": ["--nano", str(tmp_path / "missing.depth.gz")],
        "no_depth": [],
    }[case]
    codes = []
    for mod in SCORE:
        with pytest.raises(SystemExit) as exc:
            mod.main(argv)
        codes.append(exc.value.code)
    assert codes[0] == codes[1] and codes[0].startswith("ERROR!!!")


# ---------------------------------------------------------------------------
# dual-type runs rescored from their three checkpoints, in each package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("package", ["gci_tpu", "gci_tpu_torch"])
def test_score_reproduces_dual_type_run(dataset, tmp_path, package):
    run = str(tmp_path / "run")
    kw = dict(hifi=[dataset["bam"]], nano=[dataset["nano"]], reference=dataset["ref"],
              regions=dataset["regions"], directory=run, prefix="D")
    if package == "gci_tpu":
        jax_run_gci(depth_backend="events", **kw)
        mod = jax_score_only
    else:
        run_gci(depth_backend="device", torch_device="cpu", **kw)
        mod = score_only
    work = str(tmp_path / "score")
    with contextlib.redirect_stdout(io.StringIO()):
        mod.main(["-r", dataset["ref"], "--hifi", f"{run}/D_hifi.depth.gz",
                  "--nano", f"{run}/D_nano.depth.gz", "--two-type",
                  f"{run}/D_two_type.depth.gz", "-R", dataset["regions"],
                  "-d", work, "-o", "D", "-f"])
    got, want = _contents(work), _contents(run)
    for name in ("D.gci", "D.regions.gci", "D.gaps.bed"):
        assert got[name] == want[name], name
    # the last type scored writes the shared issue BED name
    assert got["D.0.depth.bed"] == want["D_two_type.0.depth.bed"]


# ---------------------------------------------------------------------------
# tests/test_plotter_v2.py, as comparisons
# ---------------------------------------------------------------------------

def _same_arrays(a, b):
    assert type(a) is type(b)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_arrays(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_arrays(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_windowed_stats_segments():
    d = np.array([0, 5, 5, 5, 5, 0, 3, 3, 3, 0, 0, 9], dtype=np.int64)
    got = plotter_v2.windowed_stats(d, window_size=2)
    _same_arrays(got, jax_plotter_v2.windowed_stats(d, window_size=2))
    np.testing.assert_array_equal(got[1], [1, 3, 6, 8, 11])
    rng = np.random.default_rng(0x7004)
    d = rng.integers(0, 4, 5000) * (rng.random(5000) < 0.9)
    _same_arrays(plotter_v2.windowed_stats(d, 37), jax_plotter_v2.windowed_stats(d, 37))


def test_region_masks():
    rng = np.random.default_rng(0x7005)
    for d in (np.array([0, 0, 2, 3, 10, 0, 1], np.int64), rng.integers(0, 9, 4000),
              np.zeros(0, np.int64)):
        got = plotter_v2.depth_region_masks(d, min_safe_depth=5)
        assert got == jax_plotter_v2.depth_region_masks(d, min_safe_depth=5)


def test_parse_fai(tmp_path):
    p = tmp_path / "x.fai"
    p.write_text("chr1\t1000\t6\t60\t61\nchr2\t500\t1100\t60\t61\nbad\n")
    assert plotter_v2.parse_fai(str(p)) == jax_plotter_v2.parse_fai(str(p)) == {
        "chr1": 1000, "chr2": 500}


@pytest.mark.parametrize("tracks", ["both", "hifi", "ont"])
def test_plot_sequence_v2(tmp_path, tracks):
    rng = np.random.default_rng(0x7006)
    hifi = rng.integers(0, 40, size=5000).astype(np.int64)
    ont = rng.integers(0, 30, size=5000).astype(np.int64)
    hifi[100:300] = 0
    ont[4000:4100] = 2
    if tracks == "hifi":
        ont = np.zeros(0, np.int64)
    elif tracks == "ont":
        hifi = np.zeros(0, np.int64)
    work = str(tmp_path / "w")
    outs = []
    _assert_same(_run_both(work, PLOTTER, lambda m: outs.append(m.plot_sequence_v2(
        "chrT", hifi, ont, window_size=200, output_dir=work, output_format="png",
        regions=[(10, 4990)] if tracks == "ont" else None, dpi=100))))
    assert outs[0] == outs[1] and os.path.getsize(outs[1]) > 10000
    if tracks == "both":
        with pytest.raises(ValueError, match="length mismatch"):
            plotter_v2.plot_sequence_v2("chrT", hifi, ont[:100], output_dir=work)


def test_plotter_v2_cli(tmp_path):
    rng = np.random.default_rng(0x7007)
    depths = {"c1": rng.integers(0, 30, size=3000).astype(np.int64),
              "c2": rng.integers(0, 9, size=1200).astype(np.int64)}
    dp, do = str(tmp_path / "h.depth.gz"), str(tmp_path / "o.depth.gz")
    depth_file.write_depth_gz(dp, depths)
    depth_file.write_depth_gz(do, {t: v // 2 for t, v in depths.items()})
    fai = str(tmp_path / "r.fai")
    with open(fai, "w") as f:
        f.write("c1\t3000\t4\t60\t61\nc2\t1200\t3100\t60\t61\n")
    regions = str(tmp_path / "r.bed")
    with open(regions, "w") as f:
        f.write("c2\t100\t900\nc1\t200\t2500\n")
    work = str(tmp_path / "w")

    def run(m):
        m.main(["-r", fai, "--hifi", dp, "-o", work, "-f", "png", "-w", "100"])
        m.main(["-r", fai, "--hifi", dp, "--nano", do, "-o", work, "-f", "png",
                "-w", "100", "--region", "c1:500-1500"])
        m.main(["-r", fai, "--nano", do, "-o", work, "-f", "png", "--regions", regions])

    _assert_same(_run_both(work, PLOTTER_CLI, run),
                 ["c1.png", "c2.png", "c1_500-1500.png", "c2_100-900.png"])


def test_cap_depth_u16():
    for d in (np.array([0, 5, 65535, 70000, 123456], np.int64),
              np.array([3, -1, 7], np.int64)):
        got = plotter_v2.cap_depth_u16(d)
        _same_arrays(got, jax_plotter_v2.cap_depth_u16(d))
        assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, [3, 7])


def test_synchronized_reader_early_exit(tmp_path):
    rng = np.random.default_rng(0x7008)
    h = {t: rng.integers(0, 70000, size=2000).astype(np.int64) for t in "abcd"}
    o = {t: rng.integers(0, 50, size=2000).astype(np.int64) for t in "abcd"}
    ph, po = str(tmp_path / "h.depth.gz"), str(tmp_path / "o.depth.gz")
    depth_file.write_depth_gz(ph, h)
    depth_file.write_depth_gz(po, o)
    for kw in (dict(target_sequences={"a", "b"}), dict(regions={"c": [(0, 5)]}), {}):
        seen = []
        for mod in PLOTTER:
            seen.append(list(mod.SynchronizedDepthReader(ph, po, **kw).read_sequences()))
        _same_arrays(seen[1], seen[0])
    assert [s for s, _, _ in seen[1]] == list("abcd")
    single = [list(m.SynchronizedDepthReader(hifi_file=ph).read_sequences())
              for m in PLOTTER]
    _same_arrays(single[1], single[0])


def test_merge_consecutive_windows_anchor_semantics():
    pos = np.array([0, 10, 20, 30, 40])
    dep = np.array([1.00, 1.06, 1.12, 1.18, 2.0])
    got = plotter_v2.merge_consecutive_windows(pos, dep)
    assert got == jax_plotter_v2.merge_consecutive_windows(pos, dep)
    assert got == ([(0, 10), (20, 30), (40, 40)], [1.00, 1.12, 2.0])
    assert plotter_v2.merge_consecutive_windows(np.array([]), np.array([])) == ([], [])


# ---------------------------------------------------------------------------
# checkpoint readers on every layout a reader meets
# ---------------------------------------------------------------------------

def _reference_text(depths) -> bytes:
    return b"".join(b">" + t.encode() + b"\n" + b"".join(b"%d\n" % v for v in a)
                    for t, a in depths.items())


def _checkpoint(tmp_path, layout: str) -> str:
    """A .depth.gz in one layout: the port's BGZF writer, one plain gzip
    member of the reference's text, several gzip members concatenated, a
    last line without its newline, and an empty target between others."""
    rng = np.random.default_rng(0x7009)
    depths = {"a": rng.integers(0, 80000, 5000), "b": np.zeros(0, np.int64),
              "c": rng.integers(0, 9, 3001), "d": np.repeat([0, 4, 4, 1], 700)}
    path = str(tmp_path / f"{layout}.depth.gz")
    if layout == "bgzf":
        depth_file.write_depth_gz(path, depths)
        return path
    text = _reference_text(depths)
    if layout == "plain_gzip":
        blob = gzip.compress(text, 6)
    elif layout == "members":
        cuts = [0, 1000, 17777, len(text) // 2, len(text)]
        blob = b"".join(gzip.compress(text[a:b], 6) for a, b in zip(cuts, cuts[1:]))
    elif layout == "no_newline":
        blob = gzip.compress(text[:-1])
    elif layout == "empty_last":
        blob = gzip.compress(text + b">e\n")
    with open(path, "wb") as f:
        f.write(blob)
    return path


LAYOUTS = ["bgzf", "plain_gzip", "members", "no_newline", "empty_last"]


@pytest.fixture(params=["native", "numpy"])
def codec(request, monkeypatch):
    """The readers through the native decoder, or through their numpy
    fallback (the native entry points raising OSError, as where the host
    codec does not build)."""
    if request.param == "numpy":
        import gci_tpu.native as jax_native
        import gci_tpu_torch.native as native

        def unavailable(*args, **kwargs):
            raise OSError("host codec unavailable")

        for mod in (jax_native, native):
            for name in ("decode_depth_file_native", "decode_depth_runs_native"):
                monkeypatch.setattr(mod, name, unavailable)
    return request.param


@pytest.mark.parametrize("layout", LAYOUTS)
def test_read_depth_gz(tmp_path, layout, codec):
    path = _checkpoint(tmp_path, layout)
    _same_arrays(depth_file.read_depth_gz(path), jax_depth_file.read_depth_gz(path))
    with gzip.open(path, "rb") as f:
        text = f.read()
    _same_arrays(depth_file.decode_depth_text(text), jax_depth_file.decode_depth_text(text))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_read_depth_gz_events(tmp_path, layout, codec):
    path = _checkpoint(tmp_path, layout)
    got, got_len = depth_file.read_depth_gz_events(path)
    want, want_len = jax_depth_file.read_depth_gz_events(path)
    assert got_len == want_len and list(got) == list(want)
    for t in want:
        _same_arrays((got[t].boundaries, got[t].values, got[t].length),
                     (want[t].boundaries, want[t].values, want[t].length))
        np.testing.assert_array_equal(got[t].materialize(), want[t].materialize())


@pytest.mark.parametrize("chunk_bytes", [7, 777, 1 << 25])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_iter_depth_targets(tmp_path, layout, chunk_bytes):
    """Cuts mid-line and mid-target at the small chunk sizes."""
    path = _checkpoint(tmp_path, layout)
    got = list(depth_file.iter_depth_targets(path, chunk_bytes=chunk_bytes))
    _same_arrays(got, list(jax_depth_file.iter_depth_targets(path, chunk_bytes=chunk_bytes)))
    want, _ = depth_file.read_depth_gz(path)
    _same_arrays(dict(got), want)


def test_depth_readers_refuse_a_headerless_file(tmp_path):
    for mod in DEPTH_FILE:
        with pytest.raises(ValueError, match="no '>' target header"):
            mod.decode_depth_text(b"1\n2\n")


def test_write_bai(tmp_path):
    """The BAI of a multi-block BGZF payload, reads across the 16 kb
    linear windows and two targets, byte-equal."""
    from gci_tpu_torch.io.bam_writer import bgzf_compress

    rng = np.random.default_rng(0x700A)
    n = 4000
    ref_ids = np.sort(rng.integers(0, 3, n)).astype(np.int64)
    ref_ids[ref_ids == 1] = 2  # target 1 holds no read
    starts = rng.integers(0, 2_000_000, n).astype(np.int64)
    ends = starts + rng.integers(0, 60_000, n)
    sizes = rng.integers(40, 400, n)
    payload_end = 1000 + np.cumsum(sizes)
    payload_off = payload_end - sizes
    blob = bgzf_compress(bytes(int(payload_end[-1])), 6, 2)
    paths = []
    for mod in (jax_bai, bai):
        paths.append(str(tmp_path / f"{mod.__name__}.bai"))
        mod.write_bai(paths[-1], 3, ref_ids, starts, ends, payload_off, payload_end, blob)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    _same_arrays(bai.bgzf_block_offsets(blob), jax_bai.bgzf_block_offsets(blob))
    for beg, end in ((0, 1), (16383, 16385), (5, 1 << 17), (1 << 20, 1 << 27), (0, 1 << 29)):
        assert bai.reg2bin(beg, end) == jax_bai.reg2bin(beg, end)
