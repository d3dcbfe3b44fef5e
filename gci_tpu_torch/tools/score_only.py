"""Score-only resume tool (counterpart of ``gci_tpu.tools.score_only``,
copied; reference: utility/GCI_score.py).

Recomputes the ``.gci`` report from existing ``.depth.gz`` checkpoints
(hifi / nano / two-type, any combination — 7-way branch,
GCI_score.py:560-573) or directly from issue BEDs via ``--bed``
(GCI_score.py:485-534; incompatible with ``--regions``).  Unlike the main
pipeline, targets_length comes from the reference FASTA record lengths
(GCI_score.py:461-463), even under ``--chrs``.
"""
from __future__ import annotations

import argparse
import os
import sys

from gci_tpu_torch.io.bed import read_bed_dict
from gci_tpu_torch.io.depth_file import read_depth_gz_events
from gci_tpu_torch.io.fasta import mask_gaps_in_depths, scan_fasta
from gci_tpu_torch.reports import emit_gaps_bed, emit_issue_bed
from gci_tpu_torch.score.report import compute_continuity_report

_TYPE_LOG = {"hifi": "HiFi", "nano": "ONT", "two_type": "two_types"}
_TYPE_LABEL = {"hifi": "HiFi", "nano": "Nano", "two_type": "HiFi + Nano"}


def _load_depth(path: str, kind: str, ref_refs, gaps, prefix, threshold, flank_len,
                directory, force):
    print(f"Parsing {_TYPE_LOG[kind]} depth file ...")
    # event-space load: O(runs) memory/time, exact per-base semantics
    depths, targets_length = read_depth_gz_events(path)
    print(f"Parsing {_TYPE_LOG[kind]} depth file ... done!!!\n\n")
    for t in targets_length:
        if t not in ref_refs:
            sys.exit(
                f"ERROR!!! The targets in {kind} depth file are inconsistent with the "
                f"reference file\nPlease check both {kind} depth file and the reference"
            )
    depths = mask_gaps_in_depths(depths, gaps)
    bed = emit_issue_bed(
        depths, prefix, threshold, flank_len, directory, force, _TYPE_LOG[kind]
    )
    return depths, targets_length, bed


def _load_bed(path: str, kind: str, ref_refs):
    bed = {t: [] for t in ref_refs}
    with open(path) as f:
        for line in f:
            target, start, end = line.strip().split("\t")
            if target not in bed:
                sys.exit(
                    f"ERROR!!! The targets in {kind} bed file are inconsistent with the "
                    f"reference file\nPlease check both {kind} bed file and the reference"
                )
            bed[target].append((int(start), int(end)))
    return bed


def run_score(
    hifi=None, nano=None, two_type=None, directory=".", prefix="GCI",
    flank_len=15, threshold=0, force=False, dist_percent=0.005,
    reference=None, regions=None, chrs=None, bed_input=False,
) -> None:
    chrs_list = chrs.strip().split(",") if chrs is not None else []
    regions_bed = {}
    if regions is not None:
        if os.path.exists(regions) and os.access(regions, os.R_OK):
            regions_bed = read_bed_dict(regions)
        else:
            sys.exit(f'ERROR!!! "{regions}" is not an available file')

    if directory.endswith("/"):
        directory = "/".join(directory.split("/")[:-1])
    if os.path.exists(directory):
        if not os.access(directory, os.R_OK):
            sys.exit(f'ERROR!!! The path "{directory}" is unable to read')
        if not os.access(directory, os.W_OK):
            sys.exit(f'ERROR!!! The path "{directory}" is unable to write')
    else:
        os.makedirs(directory)
    if prefix.endswith("/"):
        sys.exit(f'ERROR!!! The prefix "{prefix}" is not allowed')

    ref_refs, _ref_gaps = scan_fasta(reference)
    for i in chrs_list:
        if i not in ref_refs:
            sys.exit(f'ERROR!!! Chromosome "{i}" provided by `--chrs` is not in the reference')
    for i in regions_bed:
        if i not in ref_refs:
            sys.exit(f'ERROR!!! Chromosome "{i}" provided by `--regions` is not in the reference')
    if chrs_list and regions_bed and not all(i in chrs_list for i in regions_bed):
        sys.exit(
            "ERROR!!! Chromosomes in the regions bed file are inconsistent with the "
            'provided list of chromosomes\nPlease read the help message use "-h" or "--help"'
        )

    print("Finding gaps ...")
    gaps = _ref_gaps
    gaps_path = emit_gaps_bed(gaps, prefix, directory, force)
    if gaps_path is not None:
        print(f"Finding gaps done!!! The gaps are in {gaps_path}\n\n")
    else:
        print("Finding gaps done!!! Awesome! No gaps were found!\n\n")

    inputs = {"hifi": hifi, "nano": nano, "two_type": two_type}
    depths_by_kind: dict[str, dict | None] = {}
    beds_by_kind: dict[str, dict] = {}
    lengths_by_kind: dict[str, dict] = {}
    for kind, path in inputs.items():
        if path is None:
            continue
        if not bed_input:
            depths, tl, bed = _load_depth(
                path, kind, ref_refs, gaps, prefix, threshold, flank_len,
                directory, force,
            )
            depths_by_kind[kind] = depths
            lengths_by_kind[kind] = tl
            beds_by_kind[kind] = bed
        else:
            beds_by_kind[kind] = _load_bed(path, kind, ref_refs)
            depths_by_kind[kind] = None

    if not bed_input:
        kinds = list(lengths_by_kind)
        for a in range(len(kinds)):
            for b in range(a + 1, len(kinds)):
                ka, kb = kinds[a], kinds[b]
                if set(lengths_by_kind[ka]) != set(lengths_by_kind[kb]):
                    sys.exit(
                        f"ERROR!!! The targets in {ka} and {kb} alignment files are "
                        "inconsistent\nPlease check the reference used in mapping "
                        "both hifi and ont reads"
                    )
                for t, ln in lengths_by_kind[ka].items():
                    if ln != lengths_by_kind[kb][t]:
                        sys.exit(
                            f'ERROR!!! The element "{t}:{ln}" in {ka} depth file is '
                            f"inconsistent with that in {kb} depth file which is "
                            f'"{t}:{lengths_by_kind[kb][t]}"\nPlease check both depth files'
                        )

    present = [k for k in ("hifi", "nano", "two_type") if inputs[k] is not None]
    compute_continuity_report(
        ref_refs, prefix, directory, force,
        [beds_by_kind[k] for k in present],
        [_TYPE_LABEL[k] for k in present],
        flank_len, dist_percent, regions_bed,
        [depths_by_kind[k] for k in present],
        threshold, chrs_list,
    )
    print("GCI finished!!!\nBye!!!")


def build_parser():
    parser = argparse.ArgumentParser(
        prog=sys.argv[0], add_help=False,
        formatter_class=argparse.RawTextHelpFormatter,
        description="Compute the GCI score from existing depth/bed checkpoints "
        "without re-reading alignments",
        epilog="Examples:\ngci-score -r ref.fa --hifi hifi.depth.gz --nano nano.depth.gz",
    )
    g = parser.add_argument_group("Input/Output")
    g.add_argument("-r", "--reference", metavar="FILE", help="The reference file")
    g.add_argument("--hifi", metavar="FILE", help="The gzipped whole-genome depth file generated by the hifi alignment file")
    g.add_argument("--nano", metavar="FILE", help="The gzipped whole-genome depth file generated by the ont alignment file")
    g.add_argument("--two-type", metavar="FILE", help="The gzipped whole-genome depth file generated by combining hifi and ont (recommended)")
    g.add_argument("--bed", dest="bed_input", action="store_const", const=True, default=False,
                   help="Providing bed files generated by the main pipeline instead of depth files\n(whole genome only; can't be used along with `--regions`)")
    g.add_argument("--chrs", metavar="", help="A list of chromosomes separated by comma")
    g.add_argument("-R", "--regions", metavar="FILE", help="Bed file containing regions")
    g.add_argument("-ts", "--threshold", metavar="INT", type=int, default=0,
                   help="The threshold of depth to be reported as issues [0]")
    g.add_argument("-dp", "--dist-percent", metavar="FLOAT", type=float, default=0.005,
                   help="The distance between the candidate gap intervals for combining in chromosome units [0.005]")
    g.add_argument("-fl", "--flank-len", metavar="INT", type=int, default=15,
                   help="The flanking length of the clipped bases [15]")
    g.add_argument("-d", dest="directory", metavar="PATH", default=".",
                   help="The directory of output files [.]")
    g.add_argument("-o", "--output", dest="prefix", metavar="STR", default="GCI",
                   help="Prefix of output files [GCI]")
    o = parser.add_argument_group("Other Options")
    o.add_argument("-f", "--force", action="store_const", const=True, default=False,
                   help="Force rewriting of existing files [False]")
    o.add_argument("-h", "--help", action="help", help="Show this help message and exit")
    return parser


def main(argv=None):
    parser = build_parser()
    args = vars(parser.parse_args(argv))
    if len(sys.argv) == 1 and argv is None:
        parser.print_help()
        sys.exit()
    if args["hifi"] is None and args["nano"] is None and args["two_type"] is None:
        sys.exit(
            "ERROR!!! Please input at least one depth file\n"
            'Please read the help message using "-h" or "--help"'
        )
    for key in ("hifi", "nano", "two_type"):
        if args[key] is not None and not (
            os.path.exists(args[key]) and os.access(args[key], os.R_OK)
        ):
            sys.exit(f'ERROR!!! "{args[key]}" is not an available file')
    if args["reference"] is None:
        sys.exit(
            "ERROR!!! Please input the reference file\n"
            'Please read the help message use "-h" or "--help"'
        )
    if not (os.path.exists(args["reference"]) and os.access(args["reference"], os.R_OK)):
        sys.exit(f'ERROR!!! "{args["reference"]}" is not an available file')
    if args["bed_input"] and args["regions"] is not None:
        sys.exit(
            "ERROR!!! Option `--bed` can't be used along with `--regions`\n"
            'Please read the help message use "-h" or "--help"'
        )
    print(f"Used arguments:{args}")
    run_score(**args)


if __name__ == "__main__":
    main()
