"""Continuity report (counterpart of ``gci_tpu.score.report``).

``compute_continuity_report`` for a single-process run; the region
sub-report, the score formula and the interval math are reused by import,
so ``.gci`` and ``.regions.gci`` are the reference writer's bytes.
"""
from __future__ import annotations

import numpy as np

from gci_tpu.intervals import complement_dict, distance_merge_dict
from gci_tpu.score.metrics import compute_n50, gci_score
from gci_tpu.score.report import _SEPARATOR, _regions_report
from gci_tpu_torch.parallel.distributed import is_primary_host
from gci_tpu_torch.utils.files import require_writable


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
    (GCI.py:522-657: file contents, stdout narration, overwrite checks)."""
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
