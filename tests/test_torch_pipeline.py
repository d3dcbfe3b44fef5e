"""The port's run_gci and CLI against gci_tpu's, byte for byte.

The same fixture files go through ``gci_tpu.pipeline.run_gci`` and
``gci_tpu_torch.pipeline.run_gci``; every output must be identical
(``.depth.gz`` after inflating, the rest as files).  The port's device
backend runs on the CPU here, through its kernels' plain versions.
"""
import gzip
import os

import numpy as np
import pytest
import torch

from gci_tpu.pipeline import run_gci as jax_run_gci
from gci_tpu_torch import cli
from gci_tpu_torch.pipeline import run_gci
from tests.fixtures import make_bam, make_fasta, make_paf, random_reads

REFS = ["chrA", "chrB", "chrC"]
LENS = [30000, 20000, 4096]


def _make_ref(path, rng, gap_at=None):
    recs = []
    for r, L in zip(REFS, LENS):
        seq = "".join(rng.choice(list("ACGT"), size=L))
        if gap_at and r in gap_at:
            s, e = gap_at[r]
            seq = seq[:s] + "N" * (e - s) + seq[e:]
        recs.append((r, seq))
    make_fasta(path, recs)


def _diff_outputs(d1, d2, names):
    for name in names:
        p1, p2 = os.path.join(d1, name), os.path.join(d2, name)
        if name.endswith(".gz"):
            with gzip.open(p1, "rb") as a, gzip.open(p2, "rb") as b:
                assert a.read() == b.read(), name
        else:
            with open(p1, "rb") as a, open(p2, "rb") as b:
                assert a.read() == b.read(), name


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(0x70C)
    d = tmp_path_factory.mktemp("torch_inputs")
    ref = str(d / "ref.fa")
    _make_ref(ref, rng, gap_at={"chrA": (12000, 12400), "chrC": (0, 64)})
    hifi_bam = str(d / "hifi.bam")
    nano_bam = str(d / "nano.bam")
    make_bam(hifi_bam, REFS, LENS, random_reads(rng, REFS, LENS, 900, name_prefix="h"))
    make_bam(nano_bam, REFS, LENS, random_reads(rng, REFS, LENS, 700, name_prefix="n"))
    regions = str(d / "regions.bed")
    with open(regions, "w") as f:
        f.write("chrA\t1000\t15000\nchrB\t0\t20000\n")
    rows = []
    for k in range(300):
        ri = int(rng.integers(0, len(REFS)))
        L = LENS[ri]
        s = int(rng.integers(0, L - 100))
        e = int(s + rng.integers(50, min(L - s, 5000)))
        qlen = int((e - s) * rng.uniform(1.0, 1.3))
        nm = int((e - s) * rng.uniform(0.85, 1.0))
        rows.append((f"h{k}", qlen, 0, e - s, "+", REFS[ri], L, s, e, nm, e - s,
                     int(rng.choice([0, 30, 60]))))
    paf = str(d / "hifi.paf")
    make_paf(paf, rows)
    return dict(ref=ref, hifi=hifi_bam, nano=nano_bam, regions=regions, paf=paf)


@pytest.mark.parametrize("backend", ["device", "events", "numpy"])
def test_single_type_with_gaps_matches_jax(inputs, tmp_path, backend):
    d_ref, d_got = str(tmp_path / "ref"), str(tmp_path / "got")
    kw = dict(hifi=[inputs["hifi"]], reference=inputs["ref"], prefix="F")
    jax_run_gci(directory=d_ref, depth_backend="device", **kw)
    run_gci(directory=d_got, depth_backend=backend, torch_device="cpu", **kw)
    _diff_outputs(d_ref, d_got, ["F.depth.gz", "F.0.depth.bed", "F.gci", "F.gaps.bed"])


def test_dual_type_regions_threshold_matches_jax(inputs, tmp_path):
    d_ref, d_got = str(tmp_path / "ref"), str(tmp_path / "got")
    kw = dict(hifi=[inputs["hifi"]], nano=[inputs["nano"]], reference=inputs["ref"],
              prefix="F", regions=inputs["regions"], threshold=1)
    jax_run_gci(directory=d_ref, depth_backend="device", **kw)
    run_gci(directory=d_got, depth_backend="device", torch_device="cpu", **kw)
    _diff_outputs(
        d_ref, d_got,
        ["F_hifi.depth.gz", "F_nano.depth.gz", "F_two_type.depth.gz",
         "F_hifi.1.depth.bed", "F_nano.1.depth.bed", "F_two_type.1.depth.bed",
         "F.gci", "F.regions.gci", "F.gaps.bed"],
    )


def test_flags_fallback_dual_type_matches_jax(inputs, tmp_path, monkeypatch):
    """Both packages forced past the packed word's depth bound: every read
    set takes the flags scan, and the outputs stay byte-identical."""
    import gci_tpu.depth.fused as jax_fused
    import gci_tpu_torch.depth.fused as fused

    monkeypatch.setattr(jax_fused, "PACKED_DEPTH_LIMIT", 1)
    monkeypatch.setattr(fused, "PACKED_DEPTH_LIMIT", 1)
    scans = []
    real = fused.fused_depth_scan_flags
    monkeypatch.setattr(fused, "fused_depth_scan_flags",
                        lambda *a: (scans.append(1), real(*a))[1])
    d_ref, d_got = str(tmp_path / "ref"), str(tmp_path / "got")
    kw = dict(hifi=[inputs["hifi"]], nano=[inputs["nano"]], reference=inputs["ref"],
              prefix="F", regions=inputs["regions"], threshold=1)
    jax_run_gci(directory=d_ref, depth_backend="device", **kw)
    run_gci(directory=d_got, depth_backend="device", torch_device="cpu", **kw)
    assert len(scans) == 2  # HiFi and ONT
    _diff_outputs(
        d_ref, d_got,
        ["F_hifi.depth.gz", "F_nano.depth.gz", "F_two_type.depth.gz",
         "F_hifi.1.depth.bed", "F_nano.1.depth.bed", "F_two_type.1.depth.bed",
         "F.gci", "F.regions.gci", "F.gaps.bed"],
    )


def test_chrs_with_bam_and_paf_matches_jax(inputs, tmp_path):
    d_ref, d_got = str(tmp_path / "ref"), str(tmp_path / "got")
    kw = dict(hifi=[inputs["hifi"], inputs["paf"]], reference=inputs["ref"],
              prefix="C", chrs="chrA,chrC")
    jax_run_gci(directory=d_ref, depth_backend="device", **kw)
    run_gci(directory=d_got, depth_backend="device", torch_device="cpu", **kw)
    _diff_outputs(d_ref, d_got, ["C.depth.gz", "C.0.depth.bed", "C.gci", "C.gaps.bed"])


def test_existing_output_needs_force(inputs, tmp_path):
    kw = dict(hifi=[inputs["hifi"]], reference=inputs["ref"], prefix="F",
              directory=str(tmp_path), depth_backend="events")
    run_gci(**kw)
    with pytest.raises(SystemExit, match="exists"):
        run_gci(**kw)
    run_gci(force=True, **kw)


@pytest.mark.parametrize("backend", ["sharded", "streamed"])
def test_unported_backends_raise(inputs, tmp_path, backend):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        run_gci(hifi=[inputs["hifi"]], reference=inputs["ref"],
                directory=str(tmp_path), depth_backend=backend)


def test_genome_above_single_device_limit_raises(inputs, tmp_path, monkeypatch):
    import gci_tpu_torch.pipeline as pipeline

    monkeypatch.setattr(pipeline, "SINGLE_DEVICE_SLOT_LIMIT", 1000)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        run_gci(hifi=[inputs["hifi"]], reference=inputs["ref"],
                directory=str(tmp_path), depth_backend="device", torch_device="cpu")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_device_without_cuda_exits(inputs, tmp_path, monkeypatch, capsys):
    """--device device never runs on the CPU: with no CUDA it exits."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    with pytest.raises(SystemExit) as exc:
        cli.main(["-r", inputs["ref"], "--hifi", inputs["hifi"], "-d", out,
                  "--device", "device"])
    assert exc.value.code not in (0, None)
    assert "torch.cuda.is_available() is false" in str(exc.value.code)
    assert not os.path.exists(out)


@pytest.mark.parametrize("flags", [
    ["--device", "sharded"], ["--device", "streamed"], ["--mesh", "1,1"],
    ["--coordinator", "localhost:1234"], ["--num-processes", "2"],
    ["--process-id", "0"], ["--profile-trace", "trace_dir"],
])
def test_cli_unported_flags_exit(inputs, tmp_path, flags):
    with pytest.raises(SystemExit) as exc:
        cli.main(["-r", inputs["ref"], "--hifi", inputs["hifi"],
                  "-d", str(tmp_path / "out"), *flags])
    assert "not yet ported" in str(exc.value.code)


def test_cli_events_matches_jax(inputs, tmp_path, capsys):
    d_ref, d_got = str(tmp_path / "ref"), str(tmp_path / "got")
    jax_run_gci(hifi=[inputs["hifi"]], nano=[inputs["nano"]], reference=inputs["ref"],
                directory=d_ref, prefix="E", depth_backend="events")
    cli.main(["-r", inputs["ref"], "--hifi", inputs["hifi"], "--nano", inputs["nano"],
              "-d", d_got, "-o", "E", "--device", "events", "--profile"])
    stdout = capsys.readouterr().out
    assert "GCI finished!!!" in stdout and "=== stage metrics ===" in stdout
    assert '"stage": "HiFi:depth_accumulate"' in stdout
    _diff_outputs(
        d_ref, d_got,
        ["E_hifi.depth.gz", "E_nano.depth.gz", "E_two_type.depth.gz",
         "E_hifi.0.depth.bed", "E_nano.0.depth.bed", "E_two_type.0.depth.bed",
         "E.gci", "E.gaps.bed"],
    )


def test_auto_backend(monkeypatch):
    from gci_tpu_torch.depth import resolve_auto_backend

    monkeypatch.delenv("GCI_AUTO_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_auto_backend() == "events"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_auto_backend() == "device"
    monkeypatch.setenv("GCI_AUTO_BACKEND", "numpy")
    assert resolve_auto_backend() == "numpy"
    monkeypatch.setenv("GCI_AUTO_BACKEND", "sharded")
    with pytest.raises(ValueError):
        resolve_auto_backend()


def test_resolve_device():
    from gci_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_single_process_identity():
    from gci_tpu_torch.parallel.distributed import is_primary_host, process_count

    assert process_count() == 1 and is_primary_host() is True
