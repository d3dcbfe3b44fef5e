"""V2 depth plotter (counterpart of ``gci_tpu.viz.plotter_v2``, copied).

Functional equivalent of utility/depth_plotter_v2.py.

Bar-style windowed depth plots driven by a ``.fai`` index instead of the
FASTA itself: per-sequence (or per-region) figures with

* windowed means computed inside zero-delimited segments (window restarts at
  each nonzero segment; partial windows kept — depth_plotter_v2.py:326-363),
* zero-depth (#FAD7DD) and low-depth (< min-safe-depth, #B7DBEA) background
  bands (depth_plotter_v2.py:382-414),
* mirror layout when both HiFi and ONT are given (HiFi up, ONT down),
  y-range ±avg_depth·max_depth_ratio, position axis auto-scaled to
  bp/kbp/Mbp, legends, png/pdf/svg output.

Everything is vectorized (the reference walks per-base Python loops).  Unlike
the reference, ``--max-depth-ratio`` and ``--min-safe-depth`` are actually
honored (the reference parses but drops them, depth_plotter_v2.py:948-952).
"""
from __future__ import annotations

import os

import numpy as np


def cap_depth_u16(depths: np.ndarray) -> np.ndarray:
    """Reference DepthParser ``array('H')`` semantics (depth_plotter_v2.py:43-140).

    Values above 65535 cap at 65535; negative values are dropped (the
    reference silently skips them); storage is uint16 — 2 bytes/base, the
    same memory footprint as the reference's typed array.
    """
    depths = np.asarray(depths)
    if depths.size and depths.min() < 0:
        depths = depths[depths >= 0]
    return np.minimum(depths, 65535).astype(np.uint16)


class SynchronizedDepthReader:
    """Streaming co-iterator over two depth checkpoints
    (depth_plotter_v2.py:690-799).

    Yields ``(seq_id, hifi_depths, ont_depths)`` one sequence at a time with
    O(one sequence) memory, stopping (and closing both files) as soon as
    every requested target has been produced — region plots on huge
    checkpoints never load whole genomes.
    """

    def __init__(self, hifi_file: str | None = None, ont_file: str | None = None,
                 target_sequences: set | None = None, regions: dict | None = None):
        self.hifi_file = hifi_file
        self.ont_file = ont_file
        self.target_sequences = set(target_sequences or ())
        self.regions = regions
        self.processed_sequences: set[str] = set()

    def _should_process_sequence(self, seq_id: str) -> bool:
        if self.target_sequences and seq_id not in self.target_sequences:
            return False
        if self.regions and seq_id not in self.regions:
            return False
        return True

    def read_sequences(self):
        from gci_tpu_torch.io.depth_file import iter_depth_targets

        it_h = iter_depth_targets(self.hifi_file) if self.hifi_file else None
        it_o = iter_depth_targets(self.ont_file) if self.ont_file else None
        empty = np.empty(0, np.int64)
        try:
            while True:
                if self.target_sequences and len(self.processed_sequences) >= len(
                    self.target_sequences
                ):
                    break
                rec_h = next(it_h, None) if it_h is not None else None
                rec_o = next(it_o, None) if it_o is not None else None
                if rec_h is None and rec_o is None:
                    break
                if (
                    (rec_h is None) != (rec_o is None)
                    and it_h is not None
                    and it_o is not None
                    and not getattr(self, "_warned_desync", False)
                ):
                    # one file exhausted while the other still has sequences
                    # — likely a truncated checkpoint; keep plotting what
                    # exists (reference behavior) but say so, once
                    import sys

                    self._warned_desync = True
                    short = self.hifi_file if rec_h is None else self.ont_file
                    print(
                        f"WARNING!!! '{short}' ended before its partner — "
                        "remaining sequences plot with one empty track",
                        file=sys.stderr,
                    )
                if rec_h is not None and rec_o is not None and rec_h[0] != rec_o[0]:
                    raise ValueError(
                        f"depth files are not sequence-synchronized: "
                        f"{rec_h[0]!r} vs {rec_o[0]!r}"
                    )
                seq_id = rec_h[0] if rec_h is not None else rec_o[0]
                if not self._should_process_sequence(seq_id):
                    continue
                self.processed_sequences.add(seq_id)
                yield (
                    seq_id,
                    cap_depth_u16(rec_h[1]) if rec_h is not None else empty,
                    cap_depth_u16(rec_o[1]) if rec_o is not None else empty,
                )
        finally:
            # dropping the generators closes the underlying files (early exit)
            if it_h is not None:
                it_h.close()
            if it_o is not None:
                it_o.close()


def parse_fai(path: str) -> dict[str, int]:
    """Sequence id -> length from a .fai index (depth_plotter_v2.py:142-160)."""
    out: dict[str, int] = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                out[parts[0]] = int(parts[1])
    return out


def _mask_to_regions(mask: np.ndarray) -> list[tuple[int, int]]:
    """Maximal True runs as inclusive (start, end) pairs."""
    if mask.size == 0:
        return []
    m = mask.astype(np.int8)
    d = np.diff(m)
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if m[0]:
        starts = np.concatenate(([0], starts))
    if m[-1]:
        ends = np.concatenate((ends, [m.shape[0]]))
    return [(int(s), int(e) - 1) for s, e in zip(starts, ends)]


def windowed_stats(
    depths: np.ndarray, window_size: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(means, starts, ends) of windows inside nonzero segments (vectorized).

    Windows tile each maximal nonzero segment from its start; the last
    window of a segment may be partial (depth_plotter_v2.py:326-363).
    """
    depths = np.asarray(depths)
    if depths.size == 0:
        return np.array([]), np.array([]), np.array([])
    cs = np.concatenate(([0], np.cumsum(depths, dtype=np.int64)))
    segs = _mask_to_regions(depths != 0)
    means, starts, ends = [], [], []
    for a, b_incl in segs:
        b = b_incl + 1
        n = b - a
        w_starts = np.arange(a, b, window_size)
        w_ends = np.minimum(w_starts + window_size, b)
        sums = cs[w_ends] - cs[w_starts]
        means.append(sums / (w_ends - w_starts))
        starts.append(w_starts)
        ends.append(w_ends - 1)
    if not means:
        return np.array([]), np.array([]), np.array([])
    return np.concatenate(means), np.concatenate(starts), np.concatenate(ends)


def merge_consecutive_windows(
    positions: np.ndarray, depths: np.ndarray
) -> tuple[list[tuple[int, int]], list[float]]:
    """Merge runs of windows whose depth stays within 0.1 of the RUN-START
    value (depth_plotter_v2.py:236-266).

    Library-surface parity only: the reference defines this method but its
    drawing path never calls it (depth_plotter_v2.py:605 draws one bar per
    window from the raw windowed stats, as `plot_sequence_v2` here does) —
    see PARITY.md.  The anchor semantics are the reference's: each window
    compares against the run's FIRST depth, so slow drift only breaks a
    run once it accumulates past 0.1.
    """
    positions = np.asarray(positions)
    depths = np.asarray(depths)
    if depths.size == 0:
        return [], []
    regions: list[tuple[int, int]] = []
    vals: list[float] = []
    cur_start = positions[0]
    cur_depth = depths[0]
    cur_end = positions[0]
    for i in range(1, depths.shape[0]):
        if abs(depths[i] - cur_depth) < 0.1:
            cur_end = positions[i]
        else:
            regions.append((cur_start, cur_end))
            vals.append(float(cur_depth))
            cur_start = cur_end = positions[i]
            cur_depth = depths[i]
    regions.append((cur_start, cur_end))
    vals.append(float(cur_depth))
    return regions, vals


def depth_region_masks(depths: np.ndarray, min_safe_depth: int) -> dict:
    """zero / low region lists (depth_plotter_v2.py:382-397)."""
    if depths.size == 0:
        return {"zero": [], "low": []}
    return {
        "zero": _mask_to_regions(depths == 0),
        "low": _mask_to_regions((depths > 0) & (depths < min_safe_depth)),
    }


def _fmt_pos(x, pos):
    if x >= 1_000_000:
        return f"{x/1_000_000:.1f}M"
    if x >= 1000:
        return f"{x/1000:.1f}k"
    return f"{int(x)}"


def _unit_label(max_position: int) -> str:
    if max_position >= 1_000_000:
        return "Position (Mbp)"
    if max_position >= 1000:
        return "Position (kbp)"
    return "Position (bp)"


def plot_sequence_v2(
    seq_id: str,
    hifi_depths: np.ndarray,
    ont_depths: np.ndarray,
    window_size: int = 1000,
    regions: list[tuple[int, int]] | None = None,
    output_dir: str = ".",
    output_format: str = "pdf",
    min_safe_depth: int = 5,
    max_depth_ratio: float = 3.0,
    hifi_color: str = "#2ca25f",
    ont_color: str = "#3C5488",
    dpi: int = 300,
) -> str | None:
    """One bar-style figure (depth_plotter_v2.py:470-687)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.ticker import FuncFormatter

    hifi = np.asarray(hifi_depths) if hifi_depths is not None else np.array([])
    ont = np.asarray(ont_depths) if ont_depths is not None else np.array([])
    has_hifi, has_ont = hifi.size > 0, ont.size > 0
    if not has_hifi and not has_ont:
        print(f"Error: No depth data for sequence {seq_id}")
        return None
    if has_hifi and has_ont and hifi.size != ont.size:
        raise ValueError(
            f"Error: HiFi and ONT data length mismatch for sequence {seq_id}. "
            f"HiFi length: {hifi.size}, ONT length: {ont.size}. "
            "Both datasets must have the same length."
        )
    seq_length = max(hifi.size, ont.size)
    plot_mode = "both" if (has_hifi and has_ont) else ("hifi_only" if has_hifi else "ont_only")

    fig, ax = plt.subplots(figsize=(15, 4), dpi=dpi)

    nz = []
    if has_hifi:
        nz.append(hifi[hifi > 0])
    if has_ont:
        nz.append(ont[ont > 0])
    nzc = np.concatenate(nz) if nz else np.array([1.0])
    avg_depth = float(np.mean(nzc)) if nzc.size else 1.0
    max_y = avg_depth * max_depth_ratio
    if plot_mode == "both":
        ax.set_ylim(-max_y, max_y)
        ax.axhline(y=0, color="black", linestyle="-", linewidth=0.5, alpha=0.7)
        ax.yaxis.set_major_formatter(FuncFormatter(lambda x, pos: str(abs(int(x)))))
    else:
        ax.set_ylim(0, max_y)

    def draw(depths, color, positive):
        means, starts, ends = windowed_stats(depths, window_size)
        masks = depth_region_masks(depths, min_safe_depth)
        for rtype, col in (("zero", "#FAD7DD"), ("low", "#B7DBEA")):
            for s, e in masks[rtype]:
                if positive:
                    ax.axvspan(s, e, ymin=0.5, ymax=0.95, color=col, alpha=0.8)
                else:
                    ax.axvspan(s, e, ymin=0.05, ymax=0.5, color=col, alpha=0.8)
        if means.size:
            centers = (starts + ends) / 2
            widths = ends - starts + 1
            vals = means if positive else -means
            ax.bar(centers, vals, width=widths, color=color, alpha=0.8, edgecolor="none")
            avg = np.mean(means)
            ax.axhline(
                y=avg if positive else -avg, color=color, linestyle="--",
                alpha=0.8, linewidth=1,
            )

    if plot_mode == "both":
        draw(hifi, hifi_color, True)
        draw(ont, ont_color, False)
    elif plot_mode == "hifi_only":
        draw(hifi, hifi_color, True)
    else:
        draw(ont, ont_color, True)

    ax.set_title(f"Depth Coverage for {seq_id}", fontsize=14, fontweight="bold")
    ax.xaxis.set_major_formatter(FuncFormatter(_fmt_pos))
    ax.set_xlabel(_unit_label(seq_length), fontsize=12)
    ax.set_xlim(0, seq_length)
    ax.set_ylabel("Depth", fontsize=12)
    ax.grid(True, alpha=0.2)

    handles = []
    if has_hifi:
        handles.append(plt.Rectangle((0, 0), 1, 1, facecolor=hifi_color, alpha=0.8, label="HiFi"))
    if has_ont:
        handles.append(plt.Rectangle((0, 0), 1, 1, facecolor=ont_color, alpha=0.8, label="ONT"))
    handles.append(plt.Rectangle((0, 0), 1, 1, facecolor="#FAD7DD", alpha=1.0, label="Zero Depth"))
    handles.append(plt.Rectangle((0, 0), 1, 1, facecolor="#B7DBEA", alpha=0.8, label="Low Depth"))
    ax.legend(
        handles=handles, loc="upper center", bbox_to_anchor=(0.5, 0.98),
        ncol=len(handles), frameon=True, fancybox=False, shadow=False,
    )

    if regions:
        filename = f"{seq_id}_{regions[0][0]}-{regions[0][1]}.{output_format}"
    else:
        filename = f"{seq_id}.{output_format}"
    out = os.path.join(output_dir, filename)
    fig.savefig(out, dpi=dpi, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    return out
