"""V2 plotter CLI (counterpart of ``gci_tpu.tools.plotter_v2``, copied;
reference: utility/depth_plotter_v2.py main, lines 802-969).

Takes a ``.fai`` index (not the FASTA), HiFi/ONT depth checkpoints, optional
region restriction; emits one bar-style figure per sequence/region.
"""
from __future__ import annotations

import argparse
import os

from gci_tpu_torch.io.bed import read_bed_dict
from gci_tpu_torch.viz.plotter_v2 import (
    SynchronizedDepthReader,
    parse_fai,
    plot_sequence_v2,
)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Depth data visualization tool - Enhanced version",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("-r", "--fai", required=True, help="Reference genome fai index file")
    parser.add_argument("--hifi", help="HiFi depth file (supports .gz compression)")
    parser.add_argument("--nano", help="ONT depth file (supports .gz compression)")
    parser.add_argument("--regions", help="BED format region file")
    parser.add_argument("--region", help="Single region, format: chr:start-end")
    parser.add_argument("-o", "--output_dir", default="images", help="Output directory (default: images)")
    parser.add_argument("-f", "--output-format", choices=["png", "pdf", "svg"], default="pdf",
                        help="Output format (default: pdf)")
    parser.add_argument("-w", "--window-size", type=int, default=1000,
                        help="Sliding window size (default: 1000)")
    parser.add_argument("--max-depth-ratio", type=float, default=3.0,
                        help="Maximum depth ratio (relative to average depth, default: 3.0)")
    parser.add_argument("--min-safe-depth", type=int, default=5,
                        help="Minimum safe depth threshold; regions below are marked with "
                        "blue background (default: 5)")
    args = parser.parse_args(argv)

    if not args.hifi and not args.nano:
        print("Error: Must provide at least one depth file (--hifi or --nano)")
        return

    os.makedirs(args.output_dir, exist_ok=True)

    print("Parsing fai file...")
    fai_lengths = parse_fai(args.fai)
    print(f"Found {len(fai_lengths)} reference sequences")

    regions_to_use = None
    if args.region:
        try:
            seq_id, rng = args.region.split(":")
            start, end = map(int, rng.split("-"))
            regions_to_use = {seq_id: [(start, end)]}
            print(f"Will plot single specified region: {args.region}")
        except Exception:
            print(f"Error: Invalid region format {args.region}")
            return
    elif args.regions:
        print(f"Parsing BED region file: {args.regions}")
        regions_to_use = read_bed_dict(args.regions)
        for chrom in regions_to_use:
            regions_to_use[chrom].sort()
        total = sum(len(v) for v in regions_to_use.values())
        print(f"Found {total} regions, involving {len(regions_to_use)} sequences")

    if regions_to_use:
        target_sequences = set(regions_to_use)
        print(f"Will process specified regions of {len(target_sequences)} sequences")
    else:
        target_sequences = set(fai_lengths)
        print(f"Will process all {len(target_sequences)} reference sequences")

    # streaming co-read: one sequence resident at a time, early exit once all
    # target sequences are plotted (depth_plotter_v2.py:690-799 semantics;
    # region plots on huge checkpoints peak at O(one sequence) memory)
    reader = SynchronizedDepthReader(
        hifi_file=args.hifi, ont_file=args.nano,
        target_sequences=target_sequences, regions=regions_to_use,
    )
    print("Starting sequential processing...")
    successful = failed = 0
    for seq_id, hifi, ont in reader.read_sequences():
        print(f"Processing sequence: {seq_id}")
        seq_length = max(len(hifi), len(ont))
        if seq_length == 0:
            print(f"Warning: No depth data for sequence {seq_id}")
            failed += 1
            continue
        if regions_to_use and seq_id in regions_to_use:
            sequence_regions = regions_to_use[seq_id]
        else:
            sequence_regions = [(0, seq_length - 1)]
        for region_start, region_end in sequence_regions:
            region_start = max(0, region_start)
            region_end = min(seq_length - 1, region_end)
            if region_start > region_end:
                print(f"Warning: Invalid region [{region_start}, {region_end}] for sequence {seq_id}")
                continue
            result = plot_sequence_v2(
                seq_id,
                hifi[region_start : region_end + 1] if len(hifi) else hifi,
                ont[region_start : region_end + 1] if len(ont) else ont,
                window_size=args.window_size,
                regions=[(region_start, region_end)] if regions_to_use else None,
                output_dir=args.output_dir,
                output_format=args.output_format,
                min_safe_depth=args.min_safe_depth,
                max_depth_ratio=args.max_depth_ratio,
            )
            if result:
                successful += 1
                print(f"  Generated: {result}")
            else:
                failed += 1

    print("\nProcessing completed!")
    print(f"Successful: {successful}, Failed: {failed}")


if __name__ == "__main__":
    main()
