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


@pytest.mark.parametrize("backend", ["device", "streamed", "events", "numpy"])
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


@pytest.mark.parametrize("backend", ["sharded"])
def test_unported_backends_raise(inputs, tmp_path, monkeypatch, backend):
    """A backend the port does not have raises; the sharded one, ported
    since, runs on the card and raises without one instead of running on
    the CPU."""
    with pytest.raises(NotImplementedError, match="not yet ported"):
        run_gci(hifi=[inputs["hifi"]], reference=inputs["ref"],
                directory=str(tmp_path), depth_backend="tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        run_gci(hifi=[inputs["hifi"]], reference=inputs["ref"],
                directory=str(tmp_path), depth_backend=backend)
    assert os.listdir(tmp_path) == []


def _spy_streamed(monkeypatch):
    """Record each call of the streamed path (pipeline imports it per call)."""
    import gci_tpu_torch.depth.streamed as streamed

    calls = []
    real = streamed.events_from_reads_streamed
    monkeypatch.setattr(streamed, "events_from_reads_streamed",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    return calls


def test_dual_type_streamed_many_chunks_matches_jax_events(inputs, tmp_path, monkeypatch):
    """--device streamed with 4096-slot chunks (runs cross chunk borders)
    against gci_tpu's events backend, every output byte for byte."""
    import gci_tpu_torch.depth.streamed as streamed

    monkeypatch.setattr(streamed, "CHUNK_SLOTS", 4096)
    monkeypatch.setenv("GCI_NO_OVERLAP", "1")  # the streamed path, not the sweep
    calls = _spy_streamed(monkeypatch)
    d_ref, d_got = str(tmp_path / "ref"), str(tmp_path / "got")
    kw = dict(hifi=[inputs["hifi"]], nano=[inputs["nano"]], reference=inputs["ref"],
              prefix="F", regions=inputs["regions"], threshold=1)
    jax_run_gci(directory=d_ref, depth_backend="events", **kw)
    run_gci(directory=d_got, depth_backend="streamed", torch_device="cpu", **kw)
    assert len(calls) == 2  # HiFi and ONT
    _diff_outputs(
        d_ref, d_got,
        ["F_hifi.depth.gz", "F_nano.depth.gz", "F_two_type.depth.gz",
         "F_hifi.1.depth.bed", "F_nano.1.depth.bed", "F_two_type.1.depth.bed",
         "F.gci", "F.regions.gci", "F.gaps.bed"],
    )


@pytest.mark.parametrize("limit", [1000, 10**9])
def test_device_switches_to_streamed_past_the_limit(inputs, tmp_path, monkeypatch, limit):
    """--device device streams a genome past accum.stream_slot_limit (both
    read types, decided once per run) and stays resident below it; either
    way the outputs equal gci_tpu's events run."""
    import gci_tpu_torch.depth.accum as accum

    monkeypatch.setattr(accum, "stream_slot_limit", lambda device: limit)
    monkeypatch.setenv("GCI_NO_OVERLAP", "1")  # the streamed path, not the sweep
    calls = _spy_streamed(monkeypatch)
    d_ref, d_got = str(tmp_path / "ref"), str(tmp_path / "got")
    kw = dict(hifi=[inputs["hifi"]], nano=[inputs["nano"]], reference=inputs["ref"],
              prefix="F", regions=inputs["regions"])
    jax_run_gci(directory=d_ref, depth_backend="events", **kw)
    run_gci(directory=d_got, depth_backend="device", torch_device="cpu", **kw)
    assert len(calls) == (2 if limit < sum(LENS) else 0)
    _diff_outputs(
        d_ref, d_got,
        ["F_hifi.depth.gz", "F_nano.depth.gz", "F_two_type.depth.gz",
         "F_hifi.0.depth.bed", "F_nano.0.depth.bed", "F_two_type.0.depth.bed",
         "F.gci", "F.regions.gci", "F.gaps.bed"],
    )


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


@pytest.mark.parametrize("backend", ["streamed", "auto"])
def test_cli_gpu_backends_without_cuda_exit(inputs, tmp_path, monkeypatch, backend):
    """--device streamed and auto run on the card: with no CUDA they exit
    with an error and write nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("GCI_AUTO_BACKEND", raising=False)
    out = str(tmp_path / "out")
    with pytest.raises(SystemExit) as exc:
        cli.main(["-r", inputs["ref"], "--hifi", inputs["hifi"], "-d", out,
                  "--device", backend])
    assert exc.value.code not in (0, None)
    assert "torch.cuda.is_available() is false" in str(exc.value.code)
    assert not os.path.exists(out)


@pytest.mark.parametrize("flags", [
    ["--device", "sharded"], ["--mesh", "1,1"],
    ["--coordinator", "127.0.0.1:{port}", "--num-processes", "1", "--process-id", "0"],
    ["--num-processes", "1"], ["--process-id", "0"], ["--profile-trace", "trace_dir"],
])
def test_cli_unported_flags_exit(inputs, tmp_path, capsys, monkeypatch, flags):
    """The flags that exited as "not yet ported" before the multi-GPU slice
    now run: the sharded backend (put on the CPU here, where it otherwise
    exits for want of a card), the multi-host flags (a one-process gloo
    group, or none), and the profiler trace; each run writes the events
    run's files and echoes the multi-host flags as gci_tpu.cli does (not at
    all)."""
    import socket

    from gci_tpu_torch import pipeline
    from gci_tpu_torch.parallel.distributed import process_count
    from gci_tpu_torch.utils.metrics import trace_path

    real = pipeline.resolve_backend
    monkeypatch.setattr(pipeline, "resolve_backend",
                        lambda backend, dev=None: real(backend, "cpu"))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    flags = [f.format(port=port) for f in flags]
    flags = [str(tmp_path / f) if f == "trace_dir" else f for f in flags]
    d_ev, d_got = str(tmp_path / "ev"), str(tmp_path / "got")
    base = ["-r", inputs["ref"], "--hifi", inputs["hifi"], "-o", "U"]
    if "--device" not in flags and "--mesh" not in flags:
        base += ["--device", "events"]
    cli.main([*base, "-d", d_got, *flags])
    echo = [l for l in capsys.readouterr().out.splitlines() if l.startswith("Used arguments:")]
    assert len(echo) == 1 and "not yet ported" not in echo[0]
    assert "process" not in echo[0] and "coordinator" not in echo[0]
    assert process_count() == 1  # the group, if any, is gone
    run_gci(hifi=[inputs["hifi"]], reference=inputs["ref"], directory=d_ev, prefix="U",
            depth_backend="events")
    _diff_outputs(d_ev, d_got, ["U.depth.gz", "U.0.depth.bed", "U.gci", "U.gaps.bed"])
    if "--profile-trace" in flags:
        assert os.path.getsize(trace_path(flags[-1], 0)) > 0


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


@pytest.mark.parametrize("extra", [
    [], ["-R", "regions", "-ts", "1", "--profile"], ["--chrs", "chrA,chrC", "-t", "2"],
])
def test_cli_echo_matches_jax(inputs, tmp_path, capsys, extra):
    """The ``Used arguments:`` line of the port's CLI is gci_tpu.cli's, on
    the same argv in the same directory, and so are the outputs."""
    from gci_tpu.cli import main as jax_main

    out = str(tmp_path / "out")
    argv = ["-r", inputs["ref"], "--hifi", inputs["hifi"], "--nano", inputs["nano"],
            "-d", out, "-o", "E", "-f", "--device", "events"]
    argv += [inputs["regions"] if a == "regions" else a for a in extra]
    echoes, files = [], []
    for main in (jax_main, cli.main):
        main(argv)
        echoes.append([l for l in capsys.readouterr().out.splitlines()
                       if l.startswith("Used arguments:")])
        files.append(sorted(os.listdir(out)))
        os.rename(out, f"{out}_{len(files)}")
    assert len(echoes[0]) == 1 and echoes[1] == echoes[0]
    assert "'mesh': None" in echoes[0][0] and "'profile_trace': None" in echoes[0][0]
    assert files[1] == files[0]
    _diff_outputs(f"{out}_1", f"{out}_2", files[0])


def test_auto_backend(inputs, tmp_path, monkeypatch):
    """auto is device, with or without a card: without one it raises, and
    the CLI's default run exits non-zero with no output directory."""
    from gci_tpu_torch.depth import resolve_auto_backend
    from gci_tpu_torch.pipeline import resolve_backend

    monkeypatch.delenv("GCI_AUTO_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_auto_backend() == "device"
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_backend("auto")
    out = str(tmp_path / "out")
    with pytest.raises(SystemExit) as exc:
        cli.main(["-r", inputs["ref"], "--hifi", inputs["hifi"], "-d", out])
    assert exc.value.code not in (0, None)
    assert not os.path.exists(out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_auto_backend() == "device"
    monkeypatch.setenv("GCI_AUTO_BACKEND", "numpy")
    assert resolve_auto_backend() == "numpy"
    monkeypatch.setenv("GCI_AUTO_BACKEND", "streamed")
    assert resolve_auto_backend() == "streamed"
    monkeypatch.setenv("GCI_AUTO_BACKEND", "sharded")
    assert resolve_auto_backend() == "sharded"
    monkeypatch.setenv("GCI_AUTO_BACKEND", "tpu")
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
