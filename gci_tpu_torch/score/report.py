"""Continuity report (counterpart of ``gci_tpu.score.report``).

``compute_continuity_report`` and the region sub-report, copied from the
JAX package, so ``.gci`` and ``.regions.gci`` are the reference writer's
bytes (GCI.py:522-657); on a multi-process run every process checks the
paths (the primary's decision is broadcast) and only process 0 writes.
"""
from __future__ import annotations

import sys

import numpy as np

from gci_tpu_torch.depth.eventspace import DepthEvents
from gci_tpu_torch.intervals import (
    collapse_depth_runs,
    complement_dict,
    distance_merge_dict,
)
from gci_tpu_torch.parallel.distributed import is_primary_host
from gci_tpu_torch.score.metrics import compute_n50, gci_score
from gci_tpu_torch.utils.files import require_writable
from gci_tpu_torch.utils.metrics import span

_SEPARATOR = "-" * 136 + "\n\n\n"


def compute_continuity_report(
    targets_length: dict[str, int],
    prefix: str = "GCI",
    directory: str = ".",
    force: bool = False,
    merged_depths_bed_list: list[dict[str, list[tuple[int, int]]]] = (),
    type_list: list[str] = (),
    flank_len: int = 15,
    dist_percent: float = 0.005,
    regions_bed: dict[str, list[tuple[int, int]]] | None = None,
    depths_list: list[dict[str, np.ndarray]] = (),
    threshold: int = 0,
    chrs_list: list[str] = (),
) -> None:
    """Score each read-type's issue intervals and write the .gci report(s)
    (GCI.py:522-657: file contents, stdout narration, overwrite checks); span
    ``score.report``."""
    with span("score.report"):
        regions_bed = regions_bed or {}
        gci_path = f"{directory}/{prefix}.gci"
        require_writable(gci_path, force)
        if len(regions_bed) > 0:
            regions_path = f"{directory}/{prefix}.regions.gci"
            require_writable(regions_path, force)
        if not is_primary_host():
            return  # scoring is host math over interval lists; one process writes
        with open(gci_path, "w"):
            pass
        if len(regions_bed) > 0:
            with open(regions_path, "w") as f:
                f.write("Chromosome\tStart\tEnd\t" + "\t".join(type_list) + "\n")

        print("Computing Theoretical minimum N50 and contigs number ...")
        whole_label = "Genome" if len(chrs_list) == 0 else "All_chromosomes"
        exp_n50_dict = dict(targets_length)
        exp_num_ctg_dict = {target: 1 for target in targets_length}
        exp_lengths = list(targets_length.values())
        exp_n50_dict[whole_label] = compute_n50(exp_lengths)
        exp_num_ctg_dict[whole_label] = len(exp_lengths)
        print("Computing Theoretical minimum N50 and contigs number done!!!")

        for i, merged_depths_bed in enumerate(merged_depths_bed_list):
            print(f"Computing Curated N50 and contigs number for {type_list[i]} ...")
            obs_lengths_dict = complement_dict(merged_depths_bed, targets_length, flank_len)
            obs_n50_dict = {t: compute_n50(v) for t, v in obs_lengths_dict.items()}
            obs_n50_dict[whole_label] = compute_n50(
                [item for value in obs_lengths_dict.values() for item in value]
            )

            merged = distance_merge_dict(
                merged_depths_bed, targets_length, dist_percent, flank_len
            )
            merged_complement = complement_dict(merged, targets_length, flank_len)
            obs_num_ctg_dict = {t: len(v) for t, v in merged_complement.items()}
            obs_num_ctg_dict[whole_label] = sum(
                len(v) for v in merged_complement.values()
            )
            print(f"Computing Curated N50 and contigs number for {type_list[i]} done!!!")

            print(f"Writing results to {gci_path} ...")
            with open(gci_path, "a") as f:
                f.write(f"{type_list[i]}:\n")
                f.write(
                    "Chromosome\tTheoretical maximum N50\tCurated N50\t"
                    "Theoretical minimum contigs number\tCurated contigs number\tGCI score\n"
                )
                for target in exp_n50_dict:
                    gci = gci_score(
                        exp_n50_dict[target],
                        obs_n50_dict[target],
                        exp_num_ctg_dict[target],
                        obs_num_ctg_dict[target],
                    )
                    f.write(
                        f"{target}\t{exp_n50_dict[target]}\t{obs_n50_dict[target]}\t"
                        f"{exp_num_ctg_dict[target]}\t{obs_num_ctg_dict[target]}\t{gci}\n"
                    )
                f.write(_SEPARATOR)
            print(f"Writing results to {gci_path} done!!!\n\n")

        if len(regions_bed) > 0:
            _regions_report(
                regions_path, regions_bed, depths_list, threshold, dist_percent,
            )


def _one_region_scores(
    depths_list, target, start, end, threshold, dist_percent
):
    """Per-type (gci, complement_lengths, contig_count) for one region.

    The per-region score treats the region as ONE expected contig of length
    end-start; the observed side is the complement of the zero-depth
    intervals, with the contig count taken after distance-merging
    (GCI.py:624-648).
    """
    span = end - start
    out = []
    for depthss in depths_list:
        d = depthss[target]
        if isinstance(d, DepthEvents):
            issues = d.slice(start, end).collapse(-1, threshold, 0, start)
        else:
            issues = collapse_depth_runs(d[start:end], -1, threshold, 0, start)
        comp_lengths = _complement_one(issues, start, end)
        merged = _distance_merge_one(issues, span, dist_percent, start, end)
        n_contigs = len(_complement_one(merged, start, end))
        out.append(
            (gci_score(span, compute_n50(comp_lengths), 1, n_contigs),
             comp_lengths, n_contigs)
        )
    return out


def _regions_report(
    regions_path: str,
    regions_bed: dict[str, list[tuple[int, int]]],
    depths_list: list[dict[str, np.ndarray]],
    threshold: int,
    dist_percent: float,
) -> None:
    """Per-region GCI sub-report (GCI.py:610-657): one row per region, then
    an All_regions summary pooling every VALID region's complements (rows
    for zero/negative-span regions still print, but don't pool)."""
    print("Computing GCI scores for regions ...")
    n_types = len(depths_list)
    valid_spans: list[int] = []
    pooled_lengths: list[list[int]] = [[] for _ in range(n_types)]
    pooled_contigs = [0] * n_types
    for target, segments in regions_bed.items():
        for start, end in segments:
            valid = end - start > 0
            if valid:
                valid_spans.append(end - start)
            else:
                print(
                    f'Warning!!! The region "{target}:{start}-{end}" is not available',
                    file=sys.stderr,
                )
            per_type = _one_region_scores(
                depths_list, target, start, end, threshold, dist_percent
            )
            if valid:
                for i, (_, comp_lengths, n_contigs) in enumerate(per_type):
                    pooled_lengths[i] += comp_lengths
                    pooled_contigs[i] += n_contigs
            with open(regions_path, "a") as f:
                f.write(
                    f"{target}\t{start}\t{end}\t"
                    + "\t".join(str(row[0]) for row in per_type)
                    + "\n"
                )
    summary = []
    for i in range(n_types):
        if pooled_contigs[i] == 0:
            summary.append(0)
        else:
            summary.append(
                gci_score(
                    compute_n50(valid_spans),
                    compute_n50(pooled_lengths[i]),
                    len(valid_spans),
                    pooled_contigs[i],
                )
            )
    with open(regions_path, "a") as f:
        f.write(_SEPARATOR)
        f.write("All_regions\t*\t*\t" + "\t".join(map(str, summary)) + "\n")
    print("Computing GCI scores for regions done!!!\n\n")


def _complement_one(intervals, start, end):
    from gci_tpu_torch.intervals import complement_intervals

    return complement_intervals(intervals, 0, 0, start, end)


def _distance_merge_one(intervals, length, dist_percent, start, end):
    from gci_tpu_torch.intervals import distance_merge

    return distance_merge(intervals, length, dist_percent, 0, start, end)
