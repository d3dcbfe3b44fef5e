"""The port's remaining public helpers against gci_tpu's, on the CPU.

``depth.device``'s single-device helpers (``depth_single``,
``interval_edges`` + ``edges_to_intervals``, ``two_type_max``) on the oracle
cases of ``tests/test_device.py``, ``io.depth_file.encode_depth_text``,
``filters.device.bam_filter_mask_device`` and the re-exports of the
subpackages.  The same seeded numpy inputs go through both packages (JAX on
the CPU), and every result must be equal.  The ``cuda``-marked case holds
``depth_single`` on the card against its CPU result.
"""
import importlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gci_tpu.depth import device as jax_device
from gci_tpu.depth.accum import GenomeLayout as JaxGenomeLayout
from gci_tpu.filters import device as jax_filters_device
from gci_tpu.io.depth_file import encode_depth_text as jax_encode_depth_text
from gci_tpu_torch import kernels
from gci_tpu_torch.depth import device
from gci_tpu_torch.depth.accum import GenomeLayout, accumulate_depth_numpy, depth_dict_from_flat
from gci_tpu_torch.filters import cascade
from gci_tpu_torch.filters.device import FLAG_EXCLUDE, bam_filter_mask_device
from gci_tpu_torch.intervals import collapse_depth_dict
from gci_tpu_torch.io.depth_file import encode_depth_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGETS = {"c1": 5000, "c2": 3001, "c3": 57}  # c3 shorter than 2 * flank
CPU = torch.device("cpu")
FLANK = 15


def _random_reads(rng, n):
    """Reads of ``tests/test_device.py``'s oracle cases."""
    names = list(TARGETS)
    tid = rng.integers(0, len(names), size=n)
    lens = np.array([TARGETS[t] for t in names])
    start = (rng.random(n) * np.maximum(lens[tid] - 30, 1)).astype(np.int64)
    end = start + rng.integers(5, 4000, size=n)
    end = np.minimum(end, lens[tid])
    return tid.astype(np.int64), start, end


def _packed(layout, n, seed):
    """``pack_read_deltas`` of seeded reads, padded with 20 rows whose
    ``live`` is 0; at least one real row is dead too (a read of c3, whose
    clamped interval is empty)."""
    tid, start, end = _random_reads(np.random.default_rng(seed), n)
    gs, ge, live = device.pack_read_deltas(layout, tid, start, end, FLANK, pad_to=n + 20)
    assert (live[:n] == 0).any() and (live[n:] == 0).all()
    return (tid, start, end), (gs, ge, live)


# ---------------------------------------------------------------------------
# depth.device: depth_single, interval_edges, edges_to_intervals, two_type_max
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_depth_single_matches_jax_and_oracle(seed):
    layout = GenomeLayout.from_targets(TARGETS)
    reads, (gs, ge, live) = _packed(layout, 700, seed)
    want = accumulate_depth_numpy(layout, *reads, FLANK)
    ref = np.asarray(jax_device.depth_single(gs, ge, live, layout.total_slots))
    got = device.depth_single(gs, ge, live, layout.total_slots, device=CPU)
    assert got.dtype == torch.int32 and got.device == CPU
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), want)


def test_depth_single_scatters_only_live_rows_and_checks_the_range():
    """A dead row may hold any index (the reference drops out-of-range
    ones); a live row outside the axis raises IndexError."""
    gs = np.array([2, 50, 3], np.int32)
    ge = np.array([6, 99, 5], np.int32)
    live = np.array([1, 0, 1], np.int32)
    got = device.depth_single(gs, ge, live, 10, device=CPU)
    want = np.asarray(jax_device.depth_single(gs, ge, live, 10))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [0, 0, 1, 2, 2, 1, 0, 0, 0, 0])
    with pytest.raises(IndexError, match="outside"):
        device.depth_single(gs, ge, np.ones(3, np.int32), 10, device=CPU)


def test_depth_single_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros(1, np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        device.depth_single(z, z, z, 4)


@pytest.mark.parametrize("seed,bounds", [(0, (-1, 0)), (1, (-1, 0)), (2, (0, 3)), (3, (2, 6))])
def test_interval_edges_and_edges_to_intervals_match_jax(seed, bounds):
    """The mask and its edges equal gci_tpu's bitmaps, and the intervals
    from them equal gci_tpu's and ``collapse_depth_dict`` of the depth."""
    lo, hi = bounds
    layout = GenomeLayout.from_targets(TARGETS)
    jlayout = JaxGenomeLayout.from_targets(TARGETS)
    tid, start, end = _random_reads(np.random.default_rng(seed), 300)
    flat = accumulate_depth_numpy(layout, tid, start, end, FLANK)
    valid = device.build_scan_valid(layout, FLANK)
    ref = [np.asarray(a) for a in jax_device.interval_edges(flat, valid, lo, hi)]
    got = device.interval_edges(torch.from_numpy(flat), torch.from_numpy(valid), lo, hi)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), r)
    m, rise, fall = got
    ref_iv = jax_device.edges_to_intervals(jlayout, ref[1], ref[2], ref[0], FLANK)
    got_iv = device.edges_to_intervals(layout, rise, fall, m, FLANK)
    assert got_iv == ref_iv
    assert got_iv == collapse_depth_dict(depth_dict_from_flat(layout, flat), lo, hi, FLANK, 0)
    # host bitmaps, as gci_tpu takes them, give the same
    assert device.edges_to_intervals(layout, ref[1], ref[2], None, FLANK) == ref_iv


def test_edges_to_intervals_with_start_pos_and_a_run_open_at_the_end():
    """A run still open at a target's last scanned slot, and ``start_pos``."""
    layout = GenomeLayout.from_targets({"t": 100})
    jlayout = JaxGenomeLayout.from_targets({"t": 100})
    depth = np.zeros(layout.total_slots, np.int32)
    depth[40:60] = 5
    valid = device.build_scan_valid(layout, FLANK)
    ref = [np.asarray(a) for a in jax_device.interval_edges(depth, valid, -1, 0)]
    _, rise, fall = device.interval_edges(torch.from_numpy(depth), torch.from_numpy(valid),
                                          -1, 0)
    for start_pos in (0, 1):
        assert device.edges_to_intervals(layout, rise, fall, None, FLANK, start_pos) == \
            jax_device.edges_to_intervals(jlayout, ref[1], ref[2], None, FLANK, start_pos)


@pytest.mark.parametrize("seed", [0, 1])
def test_two_type_max_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-50, 50, size=1000).astype(np.int32)
    b = rng.integers(-50, 50, size=1000).astype(np.int32)
    got = device.two_type_max(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_device.two_type_max(a, b)))
    np.testing.assert_array_equal(got.numpy(), np.maximum(a, b))


# ---------------------------------------------------------------------------
# io.depth_file.encode_depth_text
# ---------------------------------------------------------------------------

def test_encode_depth_text_is_the_reference_layout():
    depths = {"t1": np.array([0, 12, 345])}
    assert encode_depth_text(depths) == jax_encode_depth_text(depths) == b">t1\n0\n12\n345\n"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_depth_text_matches_jax(seed):
    rng = np.random.default_rng(seed)
    depths = {
        "chrA": rng.integers(0, 10**9, size=1000),
        "empty": np.zeros(0, np.int64),
        "chrB": rng.integers(0, 100, size=333).astype(np.int32),
        "powers": np.array([0, 9, 10, 99, 100, 2**31 - 1, 10**12]),
    }
    assert encode_depth_text(depths) == jax_encode_depth_text(depths)
    with pytest.raises(ValueError, match="negative"):
        encode_depth_text({"t": np.array([1, -1])})


# ---------------------------------------------------------------------------
# filters.device.bam_filter_mask_device
# ---------------------------------------------------------------------------

COLUMNS = ("flag", "mapq", "m", "i", "d", "s", "eq", "x", "nm")


def _tie_rows() -> dict[str, np.ndarray]:
    """Rows on and beside each float32 threshold of ``clip_ok`` and
    ``iden_ok`` at the default percents: for every total T in 1..2000, a
    clip of T//10 - 1, T//10 and T//10 + 1 bases beside T - clip matched
    bases, and T matched bases with ceil(0.1 T) - 1 .. ceil(0.1 T) + 1
    mismatches; plus an empty alignment (every count 0), which the float64
    host mask rejects (0/0) and the products accept."""
    rows = []
    for t in range(1, 2001):
        for s in (t // 10 - 1, t // 10, t // 10 + 1):
            if 0 <= s <= t:
                rows.append((0, 60, t - s, 0, 0, s, 0, 0, 0))
        for k in (-(-t // 10) - 1, -(-t // 10), -(-t // 10) + 1):
            if 0 <= k <= t:
                rows.append((0, 60, t, 0, 0, 0, 0, 0, k))
    rows.append((0, 60, 0, 0, 0, 0, 0, 0, 0))
    arr = np.asarray(rows, np.int64)
    return {c: arr[:, k].astype(np.int32) for k, c in enumerate(COLUMNS)}


def _random_columns(rng, n) -> dict[str, np.ndarray]:
    cols = {
        "flag": rng.choice([0, 4, 16, 256, 272, 2048, 2064], size=n),
        "mapq": rng.integers(0, 61, size=n),
        "m": rng.integers(0, 30_000, size=n),
        "i": rng.integers(0, 500, size=n),
        "d": rng.integers(0, 500, size=n),
        "s": rng.integers(0, 5_000, size=n),
        "eq": rng.integers(0, 30_000, size=n) * (rng.random(n) < 0.3),
        "x": rng.integers(0, 2_000, size=n) * (rng.random(n) < 0.3),
    }
    cols["nm"] = cols["i"] + cols["d"] + rng.integers(0, 3_000, size=n)
    return {c: np.asarray(v).astype(np.int32) for c, v in cols.items()}


@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("percents", [(30, 0.1, 0.9), (0, 0.05, 0.95)])
def test_bam_filter_mask_device_matches_jax(case, percents):
    """Array-equal to gci_tpu's float32 mask under JAX on the CPU, ties
    included: both multiply the same float32 operands in the same order."""
    map_qual, clip, iden = percents
    cols = _random_columns(np.random.default_rng(7), 20_000) if case == "random" else _tie_rows()
    args = [cols[c] for c in COLUMNS]
    ref = np.asarray(jax_filters_device.bam_filter_mask_device(
        *args, map_qual=map_qual, clip_percent=clip, iden_percent=iden))
    got = bam_filter_mask_device(*(torch.from_numpy(a) for a in args), map_qual=map_qual,
                                 clip_percent=clip, iden_percent=iden)
    assert got.dtype == torch.bool and got.device == CPU
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < int(got.sum()) < got.shape[0]


def test_bam_filter_mask_device_differs_from_the_host_mask_only_where_float64_does():
    """Beside the float64 host mask: the empty alignment is the one row of
    the tie set that the host mask (0/0 is NaN) and the device mask decide
    otherwise at the default percents; FLAG_EXCLUDE is the reference's."""
    assert FLAG_EXCLUDE == jax_filters_device.FLAG_EXCLUDE == 4 | 256 | 2048
    cols = _tie_rows()
    dev = bam_filter_mask_device(*(torch.from_numpy(cols[c]) for c in COLUMNS)).numpy()
    host = cascade.bam_filter_mask(cols)
    assert np.flatnonzero(dev != host).tolist() == [dev.shape[0] - 1]


# ---------------------------------------------------------------------------
# the subpackages' exports
# ---------------------------------------------------------------------------

EXPORTS = {
    "io": ("fasta", "depth_file", "bed"),
    "score": ("metrics",),
    "utils": ("metrics",),
    "parallel": ("mesh",),
}


@pytest.mark.parametrize("pkg", sorted(EXPORTS))
def test_subpackage_exports_match_jax(pkg):
    """Each name of ``__all__`` is the submodule's own object, and the names
    are gci_tpu's."""
    port = importlib.import_module(f"gci_tpu_torch.{pkg}")
    ref = importlib.import_module(f"gci_tpu.{pkg}")
    assert set(port.__all__) == set(ref.__all__)
    subs = [importlib.import_module(f"gci_tpu_torch.{pkg}.{m}") for m in EXPORTS[pkg]]
    for name in port.__all__:
        owners = [s for s in subs if getattr(s, name, None) is getattr(port, name)]
        assert owners, f"gci_tpu_torch.{pkg}.{name} is no submodule's object"


def test_subpackages_import_without_jax_cuda_or_the_codec():
    """``import`` of the package and of the subpackages with exports loads
    neither JAX, gci_tpu nor triton, builds or loads no native library, and
    needs no CUDA."""
    script = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "gci_tpu", "triton"):
            sys.modules[name] = None
        import gci_tpu_torch, gci_tpu_torch.io, gci_tpu_torch.parallel
        import gci_tpu_torch.score, gci_tpu_torch.utils, gci_tpu_torch.filters.device
        from gci_tpu_torch import kernels, native
        assert native._lib is None and kernels._lib is None
        print("ok")
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_helpers_on_cuda_match_cpu(cuda_device):
    """``depth_single`` (K2 once), the edges and their intervals (the flag
    form of the compaction, counting first) and ``two_type_max`` on the
    card against the CPU; a genome past 2^20 slots."""
    targets = {"c1": 700_000, "c2": 500_001, "c3": 57}
    layout = GenomeLayout.from_targets(targets)
    rng = np.random.default_rng(5)
    n = 4000
    tid = rng.integers(0, 3, n)
    lens = np.array(list(targets.values()))[tid]
    start = (rng.random(n) * np.maximum(lens - 30, 1)).astype(np.int64)
    end = np.minimum(start + rng.integers(5, 40_000, n), lens)
    gs, ge, live = device.pack_read_deltas(layout, tid, start, end, FLANK)
    valid = device.build_scan_valid(layout, FLANK)
    want = device.depth_single(gs, ge, live, layout.total_slots, device=CPU)
    kernels.reset_launch_counts()
    got = device.depth_single(gs, ge, live, layout.total_slots, device=cuda_device)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["depth_scan"] == 1
    assert torch.equal(got.cpu(), want)
    m, rise, fall = device.interval_edges(got, torch.from_numpy(valid).to(cuda_device), 2, 9)
    kernels.reset_launch_counts()
    iv = device.edges_to_intervals(layout, rise, fall, m, FLANK)
    assert kernels.LAUNCHES["compact_flags"] >= 1
    w = device.interval_edges(want, torch.from_numpy(valid), 2, 9)
    assert iv == device.edges_to_intervals(layout, w[1], w[2], w[0], FLANK)
    other = torch.roll(got, 1000)
    assert torch.equal(device.two_type_max(got, other).cpu(),
                       torch.maximum(want, other.cpu()))
