"""Filtered-BAM export tool (counterpart of ``gci_tpu.tools.filter_bam``,
copied; reference: utility/filter_bam.py).

Runs the read-level filter cascade and writes the surviving alignments to new
coordinate-sorted, BAI-indexed BAM files — natively (no samtools/pysam):
two bounded-memory streaming passes over each input (packed columns for the
cascade, then raw record bytes for the survivors), an in-memory sort of the
surviving records only, and a BAI from gci_tpu_torch.io.bai.

Behavioral notes vs the main pipeline, faithfully reproduced:
* this tool uses the *older* filter formulas without =/X cigar ops:
  clip = S/(M+I+S), identity = (M-mm)/(M+I+D) (filter_bam.py:159);
* survivors are re-fetched per input BAM: the exported record is the FIRST
  record in coordinate order whose name matches and that overlaps the
  curated extent on its target, re-checking only mapped/primary/
  non-supplementary/mapq (filter_bam.py:196-204);
* the reference shells out to `bamsnap` for ``-p``; here the visualization
  is a native matplotlib coverage/read track of original vs filtered BAMs.
"""
from __future__ import annotations

import argparse
import os
import struct
import sys

import numpy as np

from gci_tpu_torch.filters import CurationInput, curate_files, dedup_last_wins
from gci_tpu_torch.filters.cascade import high_qual_keys
from gci_tpu_torch.io.bam import BamStream, FLAG_SECONDARY, FLAG_SUPPLEMENTARY, FLAG_UNMAPPED
from gci_tpu_torch.io.bam_writer import bgzf_compress, build_header, sort_record_blobs
from gci_tpu_torch.io.names import keys_view
from gci_tpu_torch.io.paf import read_paf
from gci_tpu_torch.filters.election import elect_primary_targets
from gci_tpu_torch.filters.cascade import paf_filter_mask


def legacy_bam_filter_mask(columns, map_qual, clip_percent, iden_percent):
    """Older formula without =/X (filter_bam.py:152-159)."""
    flag = columns["flag"]
    m = columns["m"].astype(np.float64)
    i = columns["i"].astype(np.float64)
    d = columns["d"].astype(np.float64)
    s = columns["s"].astype(np.float64)
    nm = columns["nm"].astype(np.float64)
    base = (
        (flag & (FLAG_UNMAPPED | FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0
    ) & (columns["mapq"] >= map_qual)
    mm = nm - (i + d)
    with np.errstate(divide="ignore", invalid="ignore"):
        clip_ok = s / (m + i + s) <= clip_percent
        iden_ok = (m - mm) / (m + i + d) >= iden_percent
    return base & clip_ok & iden_ok


def run_filter_bam(
    files,
    directory=".",
    prefix="bamsnap",
    map_qual=30,
    mq_cutoff=50,
    iden_percent=0.9,
    ovlp_percent=0.9,
    clip_percent=0.1,
    plot=False,
    reference=None,
    region=None,
    regions_file=None,
    force=False,
    threads=4,
):
    if directory.endswith("/"):
        directory = directory.split("/")[0]
    if os.path.exists(directory):
        if not os.access(directory, os.R_OK):
            sys.exit(f'ERROR!!! The path "{directory}" is unable to read')
        if not os.access(directory, os.W_OK):
            sys.exit(f'ERROR!!! The path "{directory}" is unable to write')
    else:
        os.makedirs(directory)

    bam_files = [f for f in files if f.endswith(".bam")]
    paf_files = [f for f in files if not f.endswith(".bam")]

    if isinstance(prefix, str):
        prefix = [prefix]
    if plot:
        out_prefixes = None if len(prefix) == 1 else prefix[:-1]
        snap_prefix = prefix[-1]
    else:
        out_prefixes = None if len(prefix) == 1 and prefix[0] == "bamsnap" else prefix
        snap_prefix = None

    # output names (filter_bam.py:87-99)
    output_names = []
    for k, f in enumerate(bam_files):
        if out_prefixes is None:
            base = ".".join(os.path.basename(f).split(".")[:-1])
            name = f"{directory}/{base}.filter.bam"
        else:
            name = f"{directory}/{out_prefixes[k]}.bam"
        if os.path.exists(name) and not force:
            print(
                f'ERROR!!! The file "{name}" exists\nPlease using "-f" or '
                '"--force" to rewrite',
                file=sys.stderr,
            )
            raise SystemExit
        output_names.append(name)

    # pass 1: stream packed columns per file (bounded memory; the raw
    # record bytes are re-streamed in pass 2 for the survivors only)
    bam_meta = []  # (references, lengths, header_text) per file
    with BamStream(bam_files[0], threads=threads) as st0:
        targets = dict(zip(st0.references, st0.lengths))
    target_ids = {t: i for i, t in enumerate(targets)}

    hq_parts = []
    inputs = []
    if paf_files:
        pafs = [read_paf(p, threads=threads) for p in paf_files]
        masked = []
        for paf in pafs:
            # NB filter_bam.py:104-131 has no target-membership restriction
            mask = paf_filter_mask(paf.mapq, paf.nmatch, paf.alnlen, map_qual, iden_percent)
            masked.append((paf, mask))
            hq_parts.append(high_qual_keys(paf.name_keys, mask, paf.mapq, mq_cutoff))
        for elected in elect_primary_targets(masked):
            # election ran over the PAFs' own target universe; restrict the
            # winners to the BAM's target table afterwards (the reference
            # order: filter_bam.py:104-131 elects first, filters later)
            t2g = np.array(
                [target_ids.get(t, -1) for t in elected.target_names]
                or [-1],
                dtype=np.int32,
            )
            gtid = t2g[elected.tid]
            keep = gtid >= 0
            inputs.append(
                CurationInput(
                    elected.name_keys[keep],
                    gtid[keep],
                    elected.start[keep],
                    elected.end[keep],
                    elected.qlen[keep],
                )
            )
    for f in bam_files:
        cand = []
        with BamStream(f, threads=threads) as stream:
            bam_meta.append(
                (stream.references, stream.lengths, stream.header_text)
            )
            # map this bam's ref ids onto file 0's table (names join)
            l2g = np.full(len(stream.references) + 1, -1, dtype=np.int32)
            for j, name in enumerate(stream.references):
                if name in target_ids:
                    l2g[j] = target_ids[name]
            for chunk in stream:
                rid = chunk.columns["ref_id"]
                gtid = np.where(
                    (rid >= 0) & (rid < len(stream.references)),
                    l2g[np.clip(rid, 0, None)], -1,
                )
                mask = (gtid >= 0) & legacy_bam_filter_mask(
                    chunk.columns, map_qual, clip_percent, iden_percent
                )
                hq_parts.append(
                    high_qual_keys(
                        chunk.name_keys, mask, chunk.columns["mapq"], mq_cutoff
                    )
                )
                idx = np.flatnonzero(mask)
                if idx.size:
                    cand.append((
                        chunk.name_keys[idx],
                        gtid[idx].astype(np.int32),
                        chunk.columns["pos"][idx].astype(np.int64),
                        chunk.columns["ref_end"][idx].astype(np.int64),
                        chunk.columns["qlen"][idx].astype(np.int64),
                    ))
        if cand:
            keys = np.concatenate([c[0] for c in cand])
            tid = np.concatenate([c[1] for c in cand])
            ps = np.concatenate([c[2] for c in cand])
            pe = np.concatenate([c[3] for c in cand])
            ql = np.concatenate([c[4] for c in cand])
        else:
            keys = np.empty((0, 2), dtype=np.uint64)
            tid = np.empty(0, dtype=np.int32)
            ps = pe = ql = np.empty(0, dtype=np.int64)
        surv = dedup_last_wins(keys, np.ones(keys.shape[0], dtype=bool))
        inputs.append(
            CurationInput(keys[surv], tid[surv], ps[surv], pe[surv], ql[surv])
        )
    non_empty = [p for p in hq_parts if p.size]
    hq = (
        np.unique(np.concatenate(non_empty))
        if non_empty
        else np.empty(0, dtype=[("a", np.uint64), ("b", np.uint64)])
    )
    curated = curate_files(inputs, hq, ovlp_percent)

    # re-fetch survivors per bam and export (filter_bam.py:196-210):
    # second streaming pass with raw record bytes, keeping only survivors
    for k, f in enumerate(bam_files):
        refs, lens, header_text = bam_meta[k]
        l2g = np.full(len(refs) + 1, -1, dtype=np.int32)
        for j, name in enumerate(refs):
            if name in target_ids:
                l2g[j] = target_ids[name]
        blobs = _select_survivors_streamed(f, threads, refs, l2g, curated, map_qual)
        blobs = sort_record_blobs(blobs)
        _write_indexed_bam(output_names[k], refs, lens, header_text, blobs, threads)

    if plot and (region is not None or regions_file is not None):
        from gci_tpu_torch.viz.snap import snapshot_regions

        regions = []
        if region is not None:
            regions.append(region)
        if regions_file is not None:
            with open(regions_file) as f:
                for line in f:
                    t, s, e = line.strip().split("\t")[:3]
                    regions.append(f"{t}:{s}-{e}")
        snapshot_regions(
            bam_files, output_names, reference, regions, directory,
            snap_prefix, force,
        )
    return output_names


def _select_survivors_streamed(path, threads, refs, l2g, curated, map_qual):
    """First coordinate-ordered record per curated query overlapping its
    extent — streamed with raw record bytes, O(chunk + survivors) memory."""
    state_keys = curated.keys
    if state_keys is None or state_keys.size == 0:
        return []
    first: dict[int, bytes] = {}
    with BamStream(path, threads=threads, keep_raw=True) as stream:
        for chunk in stream:
            rid = chunk.columns["ref_id"]
            gtid = np.where(
                (rid >= 0) & (rid < len(refs)), l2g[np.clip(rid, 0, None)], -1
            )
            flag = chunk.columns["flag"]
            basic = (
                (flag & (FLAG_UNMAPPED | FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0
            ) & (chunk.columns["mapq"] >= map_qual)
            v = keys_view(chunk.name_keys)
            pos = np.searchsorted(state_keys, v)
            pos_c = np.minimum(pos, max(state_keys.shape[0] - 1, 0))
            matched = state_keys[pos_c] == v
            tid = curated.target_id[pos_c]
            s = curated.start[pos_c]
            e = curated.end[pos_c]
            cand = (
                matched
                & basic
                & (gtid == tid)
                & (chunk.columns["pos"].astype(np.int64) < e)
                & (chunk.columns["ref_end"].astype(np.int64) > s)
            )
            idx = np.flatnonzero(cand)
            if idx.size == 0:
                continue
            body = chunk.body
            offs = chunk.record_offsets
            for i in idx.tolist():
                slot = int(pos[i])
                if slot not in first:
                    o = int(offs[i])
                    (size,) = struct.unpack_from("<I", body, o)
                    first[slot] = body[o : o + 4 + size]
    # dict insertion order == file (= coordinate) order of first occurrence
    return list(first.values())


def _write_indexed_bam(path, references, lengths, header_text, blobs, threads):
    from gci_tpu_torch.io.bai import write_bai

    header = build_header(references, lengths, header_text or None)
    payload_offsets = []
    payload_end_offsets = []
    ref_ids = []
    starts = []
    ends = []
    off = len(header)
    for b in blobs:
        ref_id, pos0 = struct.unpack_from("<ii", b, 4)
        n_cigar = struct.unpack_from("<H", b, 16)[0]
        l_read_name = b[12]
        cig = struct.unpack_from(f"<{n_cigar}I", b, 4 + 32 + l_read_name)
        rspan = sum(c >> 4 for c in cig if (c & 0xF) in (0, 2, 3, 7, 8))
        ref_ids.append(ref_id)
        starts.append(pos0)
        ends.append(pos0 + max(rspan, 1))
        payload_offsets.append(off)
        off += len(b)
        payload_end_offsets.append(off)
    payload = header + b"".join(blobs)
    blob = bgzf_compress(payload, 6, threads)
    with open(path, "wb") as f:
        f.write(blob)
    write_bai(
        path + ".bai",
        len(references),
        np.array(ref_ids, dtype=np.int64),
        np.array(starts, dtype=np.int64),
        np.array(ends, dtype=np.int64),
        np.array(payload_offsets, dtype=np.int64),
        np.array(payload_end_offsets, dtype=np.int64),
        blob,
    )


def build_parser():
    parser = argparse.ArgumentParser(
        prog=sys.argv[0], add_help=False,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        description="Run the GCI filter cascade and export the surviving "
        "alignments as sorted+indexed BAM files",
        epilog="Examples:\ngci-filter-bam bam1 paf1 ...",
    )
    g = parser.add_argument_group("Input/Output")
    g.add_argument("files", nargs="+", metavar="ALIGNMENT-FILE",
                   help="Long reads alignment files (at least one bam file)")
    g.add_argument("-d", dest="directory", metavar="PATH", default=".",
                   help="The directory of output files [.]")
    g.add_argument("-o", "--output", nargs="*", dest="prefix", metavar="STR", default="bamsnap",
                   help="Prefix of output files; one prefix per bam file in order; with -p the "
                   "last one names the snapshot outputs [[$input.filter] / [bamsnap]]")
    g.add_argument("-t", "--threads", metavar="INT", type=int, default=4,
                   help="Number of host packer threads [4]")
    fo = parser.add_argument_group("Filter Options")
    fo.add_argument("-mq", "--map-qual", metavar="INT", type=int, default=30,
                    help="Minium mapping quality for alignments [30]")
    fo.add_argument("--mq-cutoff", metavar="INT", type=int, default=50,
                    help="The cutoff of mapping quality for keeping the alignment [50]")
    fo.add_argument("-ip", "--iden-percent", metavar="FLOAT", type=float, default=0.9,
                    help="Minimum identity (num_match_res/len_aln) of the reads [0.9]")
    fo.add_argument("-op", "--ovlp-percent", metavar="FLOAT", type=float, default=0.9,
                    help="Minimum overlapping percentage of the reads if inputting more than one alignment files [0.9]")
    fo.add_argument("-cp", "--clip-percent", metavar="FLOAT", type=float, default=0.1,
                    help="Maximum clipped percentage of the reads [0.1]")
    po = parser.add_argument_group("Plot Options")
    po.add_argument("-p", "--plot", action="store_const", const=True, default=False,
                    help="Visualize the filtered bam files (native coverage/read tracks)")
    po.add_argument("-ref", "--reference", metavar="FILE", help="The reference file")
    po.add_argument("-r", "--region", metavar="STR", help="The region to plot in chr:start-end format")
    po.add_argument("-R", "--regions-file", metavar="FILE", help="Bed file contains the regions to plot")
    oo = parser.add_argument_group("Other Options")
    oo.add_argument("-f", "--force", action="store_const", const=True, default=False,
                    help="Force rewriting of existing files")
    oo.add_argument("-h", "--help", action="help", help="Show this help message and exit")
    return parser


def main(argv=None):
    parser = build_parser()
    args = vars(parser.parse_args(argv))
    print(f"Used arguments:{args}")
    bam_num = sum(1 for f in args["files"] if f.endswith(".bam"))
    for f in args["files"]:
        if not (os.path.exists(f) and os.access(f, os.R_OK)):
            print(f'ERROR!!! "{f}" is not an available file', file=sys.stderr)
            raise SystemExit
    if bam_num == 0:
        print(
            "ERROR!!! Please input at least one bam file\nPlease read the help "
            'message using "-h" or "--help"',
            file=sys.stderr,
        )
        raise SystemExit
    if args["map_qual"] > args["mq_cutoff"]:
        print(
            f'WARNING!!! The minium mapping quality is {args["map_qual"]} and higher '
            f'than the cutoff {args["mq_cutoff"]}, which means that wouldn\'t filter '
            'any reads\nPlease read the help message using "-h" or "--help"'
        )
    prefix = args["prefix"]
    if not isinstance(prefix, str):
        if len(prefix) == 0:
            print(
                "ERROR!!! Please input at least one prefix\nPlease read the help "
                'message using "-h" or "--help"',
                file=sys.stderr,
            )
            raise SystemExit
        if not args["plot"] and len(prefix) != bam_num:
            print(
                "ERROR!!! The number of prefixes and bam files is inconsistent\n"
                'Please read the help message using "-h" or "--help"',
                file=sys.stderr,
            )
            raise SystemExit
        if args["plot"] and len(prefix) not in (1, bam_num + 1):
            print(
                f"ERROR!!! Expect {bam_num + 1} prefixes but provide {len(prefix)}\n"
                'Please read the help message using "-h" or "--help"',
                file=sys.stderr,
            )
            raise SystemExit
    if args["plot"]:
        if args["reference"] is None:
            print(
                "ERROR!!! Please input the reference file\nPlease read the help "
                'message using "-h" or "--help"',
                file=sys.stderr,
            )
            raise SystemExit
        if args["region"] is None and args["regions_file"] is None:
            print(
                "ERROR!!! Please provide the genomic positions (or in bed format)\n"
                'Please read the help message using "-h" or "--help"',
                file=sys.stderr,
            )
            raise SystemExit
    run_filter_bam(**args)


if __name__ == "__main__":
    main()
