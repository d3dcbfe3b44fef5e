"""Plot-only tool (counterpart of ``gci_tpu.tools.plot_only``, copied;
reference: utility/plot_depth.py).

Plots whole-genome or region depth straight from ``.depth.gz`` checkpoints.
Region mode plots *only* the regions (plot_depth.py:381-405, unlike the main
pipeline which plots both).  ``-dmean`` injects externally computed mean depths
for region-sliced checkpoints (plot_depth.py:450-452); when omitted, means
are computed from the provided depth files (graceful divergence from the
reference, which requires the flag).
"""
from __future__ import annotations

import argparse
import os
import sys

from gci_tpu_torch.io.bed import read_bed_dict
from gci_tpu_torch.io.depth_file import read_depth_gz_events
from gci_tpu_torch.io.fasta import mask_gaps_in_depths, scan_fasta
from gci_tpu_torch.reports import emit_gaps_bed


def run_plot(
    reference=None, hifi=None, nano=None, directory=".", prefix="GCI",
    depth_min=0.1, depth_max=4.0, window_size=50000, image_type="png",
    force=False, regions=None, dist_percent=0.005, threshold=0, depth_mean=None,
) -> None:
    from gci_tpu_torch.viz.plot import plot_depth_files

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
    image_type = image_type.lower()

    print("Finding gaps ...")
    ref_lengths, gaps = scan_fasta(reference)
    gaps_path = emit_gaps_bed(gaps, prefix, directory, force)
    if gaps_path is not None:
        print(f"Finding gaps done!!! The gaps are in {gaps_path}\n\n")
    else:
        print("Finding gaps done!!! Awesome! No gaps were found!\n\n")

    ref_refs = list(ref_lengths.keys())
    loaded = {}
    lengths = {}
    for kind, path, label in (("hifi", hifi, "hifi"), ("nano", nano, "ont")):
        if path is None:
            continue
        print(f"Parsing {label} depth file ...")
        # run-space decode: O(runs) host memory, windows/shading computed
        # from the events directly (no per-base genome arrays)
        depths, tl = read_depth_gz_events(path)
        print(f"Parsing {label} depth file ... done!!!\n\n")
        for t in tl:
            if t not in ref_refs:
                sys.exit(
                    f"ERROR!!! The targets in {label} depth file are inconsistent "
                    f"with the reference file\nPlease check both {label} depth file "
                    "and the reference"
                )
        loaded[kind] = mask_gaps_in_depths(depths, gaps)
        lengths[kind] = tl

    if depth_mean is not None:
        depth_mean = [float(i) for i in depth_mean.split(",")]
        if len(depth_mean) != len(loaded):
            sys.exit(
                "ERROR!!! The number of mean depths is not equal to that of depth "
                "files\nPlease check the input mean depths"
            )

    regions_bed = {}
    if regions is not None:
        if os.path.exists(regions) and os.access(regions, os.R_OK):
            regions_bed = read_bed_dict(regions)
        else:
            sys.exit(f'ERROR!!! "{regions}" is not an available file')
    for i in regions_bed:
        if i not in ref_refs:
            sys.exit(f'ERROR!!! Chromosome "{i}" provided by `--regions` is not in the reference')

    if "hifi" in loaded and "nano" in loaded:
        if set(lengths["hifi"]) != set(lengths["nano"]):
            sys.exit(
                "ERROR!!! The targets in hifi and nano alignment files are "
                "inconsistent\nPlease check the reference used in mapping both "
                "hifi and ont reads"
            )
        for t, ln in lengths["hifi"].items():
            if ln != lengths["nano"][t]:
                sys.exit(
                    f'ERROR!!! The element "{t}:{ln}" in hifi is inconsistent with '
                    f'that in ont depth file which is "{t}:{lengths["nano"][t]}"'
                    "\nPlease check both depth files"
                )

    depths_list = [loaded[k] for k in ("hifi", "nano") if k in loaded]
    tl = lengths["hifi"] if "hifi" in lengths else lengths["nano"]
    # region mode plots regions only (plot_depth.py:381-405)
    if regions_bed:
        plot_depth_files(
            depths_list, depth_min, depth_max, window_size, image_type,
            directory, prefix, force, tl, dist_percent, regions_bed,
            threshold, depth_mean, regions_only=True, images_subdir=False,
        )
    else:
        plot_depth_files(
            depths_list, depth_min, depth_max, window_size, image_type,
            directory, prefix, force, tl, dist_percent, {}, threshold,
            depth_mean, images_subdir=False,
        )


def build_parser():
    parser = argparse.ArgumentParser(
        prog=sys.argv[0], add_help=False,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        description="Plot filtered depth from existing depth checkpoints",
        epilog="Examples:\ngci-plot -r ref.fa --hifi hifi.depth.gz --nano nano.depth.gz",
    )
    g = parser.add_argument_group("Input/Output")
    g.add_argument("-r", "--reference", metavar="FILE", help="The reference file")
    g.add_argument("--hifi", metavar="FILE", help="The gzipped whole-genome depth file generated by the hifi alignment file")
    g.add_argument("--nano", metavar="FILE", help="The gzipped whole-genome depth file generated by the ont alignment file")
    g.add_argument("-d", dest="directory", metavar="PATH", default=".", help="The directory of output files [.]")
    g.add_argument("-o", "--output", dest="prefix", metavar="STR", default="GCI", help="Prefix of output files [GCI]")
    p = parser.add_argument_group("Plot Options")
    p.add_argument("-R", "--regions", metavar="FILE", help="Bed file containing regions to plot")
    p.add_argument("-dmean", "--depth-mean", metavar="STR", help="Comma delimited mean depth. Needed when only regions plotted having depth")
    p.add_argument("-ts", "--threshold", metavar="INT", type=int, default=0, help="The threshold of depth used in the main pipeline [0]")
    p.add_argument("-dmin", "--depth-min", metavar="FLOAT", type=float, default=0.1, help="Minimum depth in folds of mean coverage for plotting [0.1]")
    p.add_argument("-dmax", "--depth-max", metavar="FLOAT", type=float, default=4.0, help="Maximum depth in folds of mean coverage for plotting [4.0]")
    p.add_argument("-ws", "--window-size", metavar="INT", type=int, default=50000, help="The window size when plotting [50000]")
    p.add_argument("-it", "--image-type", metavar="STR", default="png", help="The format of the output images: png or pdf [png]")
    o = parser.add_argument_group("Other Options")
    o.add_argument("-f", "--force", action="store_const", const=True, default=False, help="Force rewriting of existing files [False]")
    o.add_argument("-h", "--help", action="help", help="Show this help message and exit")
    return parser


def main(argv=None):
    parser = build_parser()
    args = vars(parser.parse_args(argv))
    if len(sys.argv) == 1 and argv is None:
        parser.print_help()
        sys.exit()
    if args["hifi"] is None and args["nano"] is None:
        sys.exit(
            "ERROR!!! Please input at least one depth file\n"
            'Please read the help message using "-h" or "--help"'
        )
    for key in ("hifi", "nano"):
        if args[key] is not None and not (
            os.path.exists(args[key]) and os.access(args[key], os.R_OK)
        ):
            sys.exit(f'ERROR!!! "{args[key]}" is not an available file')
    if args["reference"] is None:
        sys.exit(
            "ERROR!!! Please input the reference file\n"
            'Please read the help message using "-h" or "--help"'
        )
    if not (os.path.exists(args["reference"]) and os.access(args["reference"], os.R_OK)):
        sys.exit(f'ERROR!!! "{args["reference"]}" is not an available file')
    print(f"Used arguments:{args}")
    run_plot(**args)


if __name__ == "__main__":
    main()
