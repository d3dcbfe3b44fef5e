"""The port's C++ host codec loads with or without libdeflate.

Where libdeflate is missing, ``gci_tpu_torch.native`` builds
``gci_tpu_torch/csrc/gci_native.cpp`` against the zlib-backed libdeflate
API shim.  The subprocess below simulates that machine (the libdeflate
build fails as it does without libdeflate.h, or its library does not load)
and runs the pipeline; its outputs must inflate to the same bytes as this
process's, which use the libdeflate build.
"""
import gzip
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from gci_tpu_torch.native import ensure_host_codec
from gci_tpu_torch.pipeline import run_gci
from tests.fixtures import make_bam, make_fasta, random_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import subprocess, sys
    from pathlib import Path
    import gci_tpu_torch.native as native

    build_dir, ref, hifi, out, failure = sys.argv[1:]
    Path(build_dir).mkdir(parents=True)
    native.BUILD_DIR = Path(build_dir)
    if failure == "build":
        compile_ = native._compile

        def no_libdeflate(build, path):
            if build == "libdeflate":
                raise subprocess.CalledProcessError(
                    1, ["g++"], stderr=b"fatal error: libdeflate.h: No such file or directory")
            compile_(build, path)

        native._compile = no_libdeflate
    else:  # a library that exists but does not load (built elsewhere)
        native._library_path("libdeflate").write_bytes(b"not a shared library")
    assert native.ensure_host_codec() == "zlib shim"
    assert Path(native.get_lib()._name).parent == Path(build_dir)

    from gci_tpu_torch.pipeline import run_gci
    run_gci(hifi=[hifi], reference=ref, directory=out, prefix="Z",
            depth_backend="device", torch_device="cpu")
    print("SHIM_OK")
""")


def _inflate(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def test_host_codec_loads_with_libdeflate():
    assert ensure_host_codec() == "libdeflate"


@pytest.mark.parametrize("failure", ["build", "load"])
def test_zlib_shim_codec_gives_identical_outputs(tmp_path, failure):
    rng = np.random.default_rng(0x5A1)
    refs, lens = ["s1", "s2"], [15000, 6000]
    seqs = [(r, "".join(rng.choice(list("ACGT"), size=L))) for r, L in zip(refs, lens)]
    seqs[0] = (refs[0], seqs[0][1][:4000] + "N" * 300 + seqs[0][1][4300:])
    ref = str(tmp_path / "ref.fa")
    make_fasta(ref, seqs)
    hifi = str(tmp_path / "h.bam")
    make_bam(hifi, refs, lens, random_reads(rng, refs, lens, 400, name_prefix="h"))
    out_shim, out_lib = str(tmp_path / "shim"), str(tmp_path / "lib")

    r = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path / "build"), ref, hifi, out_shim,
         failure],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "SHIM_OK" in r.stdout
    run_gci(hifi=[hifi], reference=ref, directory=out_lib, prefix="Z",
            depth_backend="device", torch_device="cpu")
    assert _inflate(os.path.join(out_shim, "Z.depth.gz")) == _inflate(
        os.path.join(out_lib, "Z.depth.gz"))
    for name in ("Z.0.depth.bed", "Z.gci", "Z.gaps.bed"):
        with open(os.path.join(out_shim, name), "rb") as a, \
                open(os.path.join(out_lib, name), "rb") as b:
            assert a.read() == b.read(), name


def test_no_build_raises_host_codec_error(tmp_path, monkeypatch):
    """When neither build works, the error carries each build's message."""
    import subprocess

    import gci_tpu_torch.native as native

    def fails(build, path):
        raise subprocess.CalledProcessError(1, ["g++"], stderr=f"no {build}".encode())

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_compile", fails)
    with pytest.raises(native.HostCodecError, match="libdeflate: no libdeflate") as exc:
        native.ensure_host_codec()
    assert "zlib shim: no zlib shim" in str(exc.value)
