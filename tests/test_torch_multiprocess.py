"""The port's multi-process runtime on the CPU: N gloo processes.

Each case starts N real processes of the port, joined by a
``torch.distributed`` gloo group over ``tcp://127.0.0.1``, each owning its
own positions on ``cpu`` — the CPU stand-in for N hosts.  The processes run
the port's CLI with ``--mesh`` and the three multi-host flags; each child
forces the run onto the CPU (``pipeline.resolve_backend`` with
``torch_device="cpu"``), since the sharded backend otherwise needs a card.
Every process packs only its byte range of each BAM and its line range of
each PAF, the dp sum crosses processes, and process 0 alone writes files,
which must be byte-identical to a single-process ``gci_tpu`` run.

Each child gets the repository on ``PYTHONPATH`` and runs in it; each case
waits at most ``TIMEOUT`` seconds for its children and kills every one of
them if any check fails, so a hang cannot outlast the case.
"""
import gzip
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from gci_tpu.io.depth_file import write_depth_gz as jax_write_depth_gz
from gci_tpu.pipeline import run_gci as jax_run_gci
from tests.fixtures import make_bam, make_fasta, make_paf, random_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFS = ["chrA", "chrB"]
LENS = [24000, 16000]
TIMEOUT = 120  # seconds a case waits for its children

CLI_BOOT = textwrap.dedent("""
    import sys
    from gci_tpu_torch import cli, pipeline
    real = pipeline.resolve_backend
    pipeline.resolve_backend = lambda backend, device=None: real(backend, "cpu")
    cli.main(sys.argv[1:])
""")

WRITER_BOOT = textwrap.dedent("""
    import sys
    import numpy as np
    from gci_tpu_torch.io.depth_file import write_depth_gz
    from gci_tpu_torch.parallel.distributed import init_multihost, shutdown_multihost
    port, n, pid, path, data = sys.argv[1:]
    init_multihost(f"127.0.0.1:{port}", int(n), int(pid), backend="gloo")
    try:
        with np.load(data) as z:
            write_depth_gz(path, {k: z[k] for k in z.files})
    finally:
        shutdown_multihost()
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_children(argvs) -> list[tuple[int, str]]:
    """Start one child per argv at once; (return code, output) of each.
    Every child is killed if any of them outlasts ``TIMEOUT``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", *argv], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for argv in argvs]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _cli_processes(n: int, mesh: str, args: list[str]) -> list[tuple[int, str]]:
    port = _free_port()
    return _run_children([
        [CLI_BOOT, *args, "--mesh", mesh, "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(n), "--process-id", str(pid)]
        for pid in range(n)
    ])


def _stage_items(out: str, kind: str) -> list[int]:
    return [json.loads(line)["items"] for line in out.splitlines()
            if line.startswith("{") and kind in line]


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def _diff(d1, d2, names):
    for name in names:
        assert _read(os.path.join(d1, name)) == _read(os.path.join(d2, name)), name


def _reference(path, rng, gap=None):
    recs = []
    for r, L in zip(REFS, LENS):
        seq = "".join(rng.choice(list("ACGT"), size=L))
        if gap and r == gap[0]:
            seq = seq[: gap[1]] + "N" * (gap[2] - gap[1]) + seq[gap[2]:]
        recs.append((r, seq))
    make_fasta(path, recs)


def test_two_process_dual_type_with_paf_matches_jax(tmp_path):
    """Mesh 2,4 over 2 processes (one dp row each): HiFi BAM + PAF
    curation and an ONT BAM; all nine outputs byte-identical to a
    single-process gci_tpu run, and the processes' BAM and PAF shards
    partition the records."""
    rng = np.random.default_rng(0x7D159)
    ref = str(tmp_path / "ref.fa")
    _reference(ref, rng, gap=("chrB", 2000, 2150))
    lens = dict(zip(REFS, LENS))
    hifi_reads = random_reads(rng, REFS, LENS, 600, name_prefix="h")
    hifi_bam, nano_bam = str(tmp_path / "hifi.bam"), str(tmp_path / "nano.bam")
    make_bam(hifi_bam, REFS, LENS, hifi_reads)
    make_bam(nano_bam, REFS, LENS, random_reads(rng, REFS, LENS, 500, name_prefix="n"))
    rows = []
    for rd in hifi_reads[:400]:
        L = lens[rd["ref"]]
        ts = min(rd.get("pos", 0), L - 1)
        rows.append((rd["name"], 1000, 0, 900, "+", rd["ref"], L, ts, min(ts + 900, L),
                     int(rng.integers(780, 900)), 900, int(rng.choice([20, 40, 60]))))
    paf = str(tmp_path / "hifi.paf")
    make_paf(paf, rows)
    regions = str(tmp_path / "regions.bed")
    with open(regions, "w") as f:
        f.write("chrA\t500\t20000\nchrB\t100\t9000\n")

    d_ref, d_mp = str(tmp_path / "jax"), str(tmp_path / "multi")
    jax_run_gci(hifi=[hifi_bam, paf], nano=[nano_bam], reference=ref, directory=d_ref,
                prefix="M", regions=regions, depth_backend="events")
    results = _cli_processes(2, "2,4", [
        "-r", ref, "--hifi", hifi_bam, paf, "--nano", nano_bam, "-d", d_mp, "-o", "M",
        "-R", regions, "--profile",
    ])
    for rc, out in results:
        assert rc == 0, out[-4000:]
    _diff(d_ref, d_mp, [
        "M_hifi.depth.gz", "M_nano.depth.gz", "M_two_type.depth.gz",
        "M_hifi.0.depth.bed", "M_nano.0.depth.bed", "M_two_type.0.depth.bed",
        "M.gci", "M.regions.gci", "M.gaps.bed",
    ])
    parsed = [_stage_items(out, "paf_parse") for _, out in results]
    assert all(len(p) == 1 for p in parsed), parsed
    assert sum(p[0] for p in parsed) == len(rows) and all(0 < p[0] < len(rows) for p in parsed)
    packed = [_stage_items(out, "bam_pack:" + hifi_bam) for _, out in results]
    assert sum(p[0] for p in packed) == 600 and all(0 < p[0] < 600 for p in packed), packed


def test_two_process_overwrite_block_exits_everywhere(tmp_path):
    """An existing output without --force: the primary's decision is
    broadcast and both processes exit (a primary-only exit would leave the
    other one waiting in its next collective)."""
    rng = np.random.default_rng(0x7D158)
    ref = str(tmp_path / "ref.fa")
    _reference(ref, rng)
    bam = str(tmp_path / "hifi.bam")
    make_bam(bam, REFS, LENS, random_reads(rng, REFS, LENS, 120, name_prefix="h"))
    d_mp = str(tmp_path / "multi")
    os.makedirs(d_mp)
    with open(os.path.join(d_mp, "M.depth.gz"), "wb") as f:
        f.write(b"preexisting")
    for rc, out in _cli_processes(2, "2,4", ["-r", ref, "--hifi", bam, "-d", d_mp, "-o", "M"]):
        assert rc != 0
        assert "exists" in out and "--force" in out, out[-2000:]
    with open(os.path.join(d_mp, "M.depth.gz"), "rb") as f:
        assert f.read() == b"preexisting"


def test_two_process_distributed_depth_writer_byte_identical(tmp_path):
    """write_depth_gz on 2 processes (each compresses a disjoint BGZF block
    range, the primary concatenates) writes exactly the single writer's
    file: the raw compressed bytes, of the port's and of gci_tpu's writer."""
    rng = np.random.default_rng(0x7D15C)
    depths = {
        "long": np.repeat(rng.integers(0, 4, 40), rng.integers(1, 200_000, 40)),
        "dense": rng.integers(0, 9, 300_000),
        "void": np.zeros(0, np.int64),
        "big": np.repeat(rng.integers(10_000, 99_999, 50), rng.integers(1, 5_000, 50)),
    }
    data = str(tmp_path / "depths.npz")
    np.savez(data, **{k: v.astype(np.int64) for k, v in depths.items()})
    single, multi = str(tmp_path / "single.depth.gz"), str(tmp_path / "multi.depth.gz")
    jax_write_depth_gz(single, depths)
    port = _free_port()
    for rc, out in _run_children([[WRITER_BOOT, str(port), "2", str(pid), multi, data]
                                  for pid in range(2)]):
        assert rc == 0, out[-3000:]
    with open(single, "rb") as a, open(multi, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("mesh", ["4,2", "2,4"])
def test_four_process_uneven_shards(tmp_path, mesh):
    """4 processes x 2 positions: an odd record count (901) and a
    header-heavy BAM (120 references), so every byte-range border falls
    mid-record; byte parity with single-process gci_tpu, and the
    processes' packed records sum to 901.  With mesh 4,2 each process owns
    a dp row; with 2,4 two processes share each dp row, so each gp column
    is summed over dp in a group of two of the four processes."""
    rng = np.random.default_rng(0x7D15E)
    refs = [f"ctg{i:03d}" for i in range(120)]
    lens = [4000] * len(refs)
    ref = str(tmp_path / "ref.fa")
    make_fasta(ref, [(r, "".join(rng.choice(list("ACGT"), size=L)))
                     for r, L in zip(refs, lens)])
    bam = str(tmp_path / "hifi.bam")
    make_bam(bam, refs, lens, random_reads(rng, refs, lens, 901, name_prefix="h"))
    d_ref, d_mp = str(tmp_path / "jax"), str(tmp_path / "multi")
    jax_run_gci(hifi=[bam], reference=ref, directory=d_ref, prefix="M",
                depth_backend="events")
    results = _cli_processes(4, mesh, ["-r", ref, "--hifi", bam, "-d", d_mp, "-o", "M",
                                        "--profile"])
    for rc, out in results:
        assert rc == 0, out[-4000:]
    _diff(d_ref, d_mp, ["M.depth.gz", "M.0.depth.bed", "M.gci"])
    packed = [_stage_items(out, "bam_pack") for _, out in results]
    assert all(len(p) == 1 for p in packed), packed
    assert sum(p[0] for p in packed) == 901, packed
