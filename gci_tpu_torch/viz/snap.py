"""Native alignment snapshots (counterpart of ``gci_tpu.viz.snap``, copied).

Replacement for the reference's shelled-out `bamsnap`
(utility/filter_bam.py:215-256, invoked with ``-draw coordinates bamplot
base -bamplot coverage read -read_color_by strand -ref <fasta>``).

For each region, a reference-sequence track (per-base colors, letter glyphs
when zoomed in — bamsnap's ``base`` draw) above one panel per BAM (original
and filtered interleaved, like the reference's -bam ordering): a coverage
track plus read segments colored by strand (forward #2ca25f / reverse
#3C5488) with red per-base mismatch ticks (bamsnap marks bases differing
from the reference; computed here by walking each drawn read's CIGAR over
its SEQ bytes against the reference slice).

Inputs stream in bounded memory: each BAM is read once via the chunked
native stream, keeping only the records (columns + raw bytes) that overlap
a requested region.
"""
from __future__ import annotations

import os
import sys

import numpy as np

_BASE_COLORS = {
    65: "#2ca25f",  # A green
    67: "#4575b4",  # C blue
    71: "#fdae61",  # G orange
    84: "#d73027",  # T red
    78: "#bdbdbd",  # N grey
}
# BAM 4-bit code -> ASCII base ("=ACMGRSVTWYHKDBN")
_NIB = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)


def _parse_region(region: str) -> tuple[str, int | None, int | None]:
    if ":" not in region:
        return region, None, None
    chrom, rng = region.rsplit(":", 1)
    if "-" in rng:
        s, e = rng.split("-")
        return chrom, int(s), int(e)
    p = int(rng)
    return chrom, max(p - 500, 0), p + 500


def _ref_slices(reference: str | None, wanted: set[str]) -> dict[str, np.ndarray]:
    """Uppercase sequence byte arrays for the requested targets."""
    if reference is None:
        return {}
    from gci_tpu_torch.io.fasta import _compact_sequence, _iter_records, _read_bytes

    out = {}
    data = _read_bytes(reference)
    for rid, raw in _iter_records(data):
        if rid in wanted:
            seq = _compact_sequence(raw).copy()
            low = (seq >= 97) & (seq <= 122)
            seq[low] -= 32
            out[rid] = seq
    return out


def _collect_region_reads(path: str, regions, max_per_region: int = 4096):
    """One bounded-memory streaming pass: per region, the (pos, ref_end,
    flag, raw_record) of every overlapping mapped read.

    At most ``max_per_region`` (4096) reads are kept per region, the first
    in file order, so a deeper region draws a truncated pileup.  This is a
    quirk of ``gci_tpu.viz.snap``, kept so that the PNG bytes are its own.
    """
    from gci_tpu_torch.io.bam import BamStream

    st = BamStream(path, threads=2, keep_names=False, keep_raw=True)
    refs, lens = st.references, st.lengths
    rid_of = {r: i for i, r in enumerate(refs)}
    spans = []
    for chrom, s, e in regions:
        rid = rid_of.get(chrom, -1)
        L = lens[rid] if rid >= 0 else 0
        spans.append((rid, 0 if s is None else s, L if e is None else min(e, L)))
    hits: list[list[tuple[int, int, int, bytes]]] = [[] for _ in regions]
    with st:
        for ch in st:
            c = ch.columns
            body, ro = ch.body, ch.record_offsets
            for k, (rid, s, e) in enumerate(spans):
                if rid < 0 or len(hits[k]) >= max_per_region:
                    continue
                sel = np.flatnonzero(
                    (c["ref_id"] == rid)
                    & ((c["flag"] & 4) == 0)
                    & (c["pos"] < e)
                    & (c["ref_end"] > s)
                )
                for i in sel.tolist():
                    if len(hits[k]) >= max_per_region:
                        break
                    off = int(ro[i])
                    ln = int.from_bytes(body[off : off + 4], "little")
                    hits[k].append(
                        (
                            int(c["pos"][i]), int(c["ref_end"][i]),
                            int(c["flag"][i]),
                            body[off + 4 : off + 4 + ln],
                        )
                    )
    return refs, lens, hits


def _mismatch_xs(rec: bytes, ref_seq: np.ndarray) -> np.ndarray:
    """Reference positions where the read's SEQ differs from the reference
    (M/X ops compared base-by-base; '=' trusted; I/S skip query, D/N skip
    reference — the same positions bamsnap paints)."""
    l_read_name = rec[8]
    n_cigar = int.from_bytes(rec[12:14], "little")
    l_seq = int.from_bytes(rec[16:20], "little")
    pos = int.from_bytes(rec[4:8], "little", signed=True)
    if n_cigar == 0 or l_seq == 0:
        return np.empty(0, np.int64)
    cig_off = 32 + l_read_name
    ops = np.frombuffer(rec[cig_off : cig_off + 4 * n_cigar], dtype="<u4")
    nib = np.frombuffer(
        rec[cig_off + 4 * n_cigar : cig_off + 4 * n_cigar + (l_seq + 1) // 2],
        dtype=np.uint8,
    )
    codes = np.empty(2 * nib.shape[0], np.uint8)
    codes[0::2] = nib >> 4
    codes[1::2] = nib & 0xF
    q = _NIB[codes[:l_seq]]
    xs: list[np.ndarray] = []
    qi, ri = 0, pos
    for v in ops.tolist():
        op, ln = v & 0xF, v >> 4
        if op in (0, 8):  # M, X: compare
            if ri + ln <= ref_seq.shape[0]:
                mism = np.flatnonzero(q[qi : qi + ln] != ref_seq[ri : ri + ln])
                if mism.shape[0]:
                    xs.append(mism + ri)
            qi += ln
            ri += ln
        elif op == 7:  # =: match by definition
            qi += ln
            ri += ln
        elif op in (1, 4):  # I, S: query only
            qi += ln
        elif op in (2, 3):  # D, N: reference only
            ri += ln
        # H, P consume neither
    if not xs:
        return np.empty(0, np.int64)
    return np.concatenate(xs)


def snapshot_regions(
    original_bams: list[str],
    filtered_bams: list[str],
    reference: str | None,
    regions: list[str],
    directory: str = ".",
    prefix: str = "bamsnap",
    force: bool = False,
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    files = []
    for orig, filt in zip(original_bams, filtered_bams):
        files.append(orig)
        files.append(filt)

    multi = len(regions) > 1
    if multi:
        outdir = f"{directory}/{prefix}"
        os.makedirs(outdir, exist_ok=True)
    else:
        out = f"{directory}/{prefix}.png"
        if os.path.exists(out) and not force:
            print(
                f'ERROR!!! The file "{out}" exists\nPlease using "-f" or '
                '"--force" to rewrite',
                file=sys.stderr,
            )
            raise SystemExit

    parsed = [_parse_region(r) for r in regions]
    ref_seqs = _ref_slices(reference, {chrom for chrom, _, _ in parsed})
    per_file = [_collect_region_reads(f, parsed) for f in files]

    for rk, (region, (chrom, start, end)) in enumerate(zip(regions, parsed)):
        have_ref = chrom in ref_seqs
        n_rows = len(files) + (1 if have_ref else 0)
        ratios = ([0.35] if have_ref else []) + [2.2] * len(files)
        fig, axes = plt.subplots(
            n_rows, 1,
            figsize=(16, 0.4 * have_ref + 2.2 * len(files)),
            sharex=True, squeeze=False,
            gridspec_kw={"height_ratios": ratios},
        )
        row0 = 0
        s_glob, e_glob = None, None
        if have_ref:
            row0 = 1
        for k, (path, (refs, lens, hits)) in enumerate(zip(files, per_file)):
            ax = axes[row0 + k][0]
            try:
                rid = refs.index(chrom)
            except ValueError:
                ax.set_title(f"{path} (no {chrom})", fontsize=8)
                continue
            L = lens[rid]
            s = 0 if start is None else start
            e = L if end is None else min(end, L)
            s_glob, e_glob = s, e
            rseq = ref_seqs.get(chrom)
            # bamsnap-style pileup layout: reads sorted by start, each
            # packed greedily into the first row whose last read ends
            # before it (real alignment rows, not a modulo wrap)
            reads = sorted(hits[rk], key=lambda t: t[0])
            cov = np.zeros(e - s + 1, dtype=np.int32)
            segs, colors = [], []
            tick_segs = []
            row_ends: list[int] = []
            max_rows = 80
            overflow = 0
            for pos, ref_end, flag, raw in reads:
                a, b = max(pos, s), min(ref_end, e)
                if b <= a:
                    continue
                cov[a - s : b - s] += 1
                row = next(
                    (r for r, re_ in enumerate(row_ends) if re_ < a), None
                )
                if row is None:
                    if len(row_ends) >= max_rows:
                        overflow += 1
                        continue
                    row = len(row_ends)
                    row_ends.append(b)
                else:
                    row_ends[row] = b
                y = -1 - row
                segs.append([(a, y), (b, y)])
                colors.append("#3C5488" if flag & 16 else "#2ca25f")
                if rseq is not None:
                    for x in _mismatch_xs(raw, rseq).tolist():
                        if s <= x < e:
                            tick_segs.append([(x, y - 0.38), (x, y + 0.38)])
            ax.fill_between(np.arange(s, e + 1), cov, step="mid", color="#bdbdbd")
            if segs:
                ax.add_collection(LineCollection(segs, colors=colors, lw=1.2))
                ax.set_ylim(
                    -min(len(row_ends), max_rows) - 2, max(cov.max() + 2, 5)
                )
            if tick_segs:
                ax.add_collection(
                    LineCollection(tick_segs, colors="#d73027", lw=0.9)
                )
            if overflow:
                ax.text(
                    0.99, 0.02, f"+{overflow} reads not drawn",
                    transform=ax.transAxes, ha="right", fontsize=6,
                    color="#666666",
                )
            ax.set_title(f'"{path}"', fontsize=8, loc="left")
            ax.set_xlim(s, e)
        if have_ref and s_glob is not None:
            axr = axes[0][0]
            rseq = ref_seqs[chrom]
            s, e = s_glob, e_glob
            span = e - s
            if span <= 20000:
                # per-base color band (bamsnap's base track)
                cols = [
                    _BASE_COLORS.get(int(b), "#999999")
                    for b in rseq[s:e]
                ]
                axr.bar(
                    np.arange(s, e) + 0.5, np.ones(span), width=1.0,
                    color=cols, edgecolor="none",
                )
                if span <= 150:
                    for x in range(s, e):
                        axr.text(
                            x + 0.5, 0.5, chr(rseq[x]), ha="center",
                            va="center", fontsize=6, color="white",
                            family="monospace",
                        )
            else:
                axr.text(
                    0.5, 0.5, f"reference {chrom} (zoom in for bases)",
                    transform=axr.transAxes, ha="center", va="center",
                    fontsize=7, color="#666666",
                )
            axr.set_ylim(0, 1)
            axr.set_yticks([])
            axr.set_title("reference", fontsize=8, loc="left")
        axes[-1][0].set_xlabel(f"{chrom} position (bp)")
        plt.tight_layout()
        if multi:
            plt.savefig(f"{outdir}/{chrom}_{start}_{end}.png", dpi=150)
        else:
            plt.savefig(f"{directory}/{prefix}.png", dpi=150)
        plt.close()
