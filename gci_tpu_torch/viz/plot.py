"""Whole-genome / region depth plots (mirror layout, shading, legends).

Behavioral contract: reference GCI.py:660-894 (``sliding_window_average_depth``,
``pre_plot_base``, ``plot_base``, ``plot_depth``): HiFi stacked upward in
green (#2ca25f), Nano downward in blue (#3C5488), low-depth spans shaded
#B7DBEA, zero/threshold spans #FAD7DD, dash-dot mean line, 200 dpi outputs
named ``images/{prefix}.{target}[...].{png|pdf}``.

The window averaging walks the reference's stateful semantics (windows reset
at zero-depth bases, partial windows flushed, means clamped to max_depth) but
is computed vectorized from prefix sums over zero-delimited segments instead
of a per-base Python loop.
"""
from __future__ import annotations

import os
import sys

import numpy as np


def sliding_window_average(
    depths,
    window_size: int = 50000,
    max_depth: float | None = None,
    start: int = 0,
    target: str | None = None,
) -> tuple[list[float], np.ndarray]:
    """(positions_mb, averaged_depths) with reference semantics (GCI.py:660-705).

    Accepts a per-base array or a :class:`DepthEvents`; the event-space form
    computes the identical points from run boundaries alone (O(runs +
    windows + zero bases)), so plotting after ``streamed``/``sharded`` runs
    never materializes a per-base genome array.
    """
    from gci_tpu_torch.depth.eventspace import DepthEvents

    if isinstance(depths, DepthEvents):
        return _sliding_window_average_events(
            depths, window_size, max_depth, start, target
        )
    depths = np.asarray(depths)
    n = depths.shape[0]
    if n < window_size:
        print(
            f"Warning!!! The length ({n}) of plotting region "
            f"({target}:{start}-{start + n}) is less than the window size "
            f"({window_size}), and therefore the window size will be 1 bp",
            file=sys.stderr,
        )
        window_size = 1
    if n == 0:
        return [], np.array([])

    nz = depths != 0
    cs = np.concatenate(([0], np.cumsum(depths, dtype=np.int64)))

    # zero-depth events: one (pos, 0) per zero base
    zero_idx = np.flatnonzero(~nz)

    # nonzero segments
    m = nz.astype(np.int8)
    d = np.diff(m)
    seg_starts = np.flatnonzero(d == 1) + 1
    seg_ends = np.flatnonzero(d == -1) + 1
    if m[0]:
        seg_starts = np.concatenate(([0], seg_starts))
    if m[-1]:
        seg_ends = np.concatenate((seg_ends, [n]))

    events_pos: list[np.ndarray] = [zero_idx.astype(np.float64)]
    events_val: list[np.ndarray] = [np.zeros(zero_idx.shape[0])]
    # order tiebreak: at a flush, the partial-window point (pos i-1) precedes
    # the zero point (pos i); positions are distinct so a stable sort on
    # position reproduces emission order.
    for a, b in zip(seg_starts.tolist(), seg_ends.tolist()):
        seg_len = b - a
        q = seg_len // window_size
        if q:
            ends = a + (np.arange(1, q + 1) * window_size) - 1
            sums = cs[ends + 1] - cs[ends + 1 - window_size]
            vals = sums / window_size
            events_pos.append(ends.astype(np.float64))
            events_val.append(vals)
        rem = seg_len - q * window_size
        if rem:
            s = cs[b] - cs[b - rem]
            events_pos.append(np.array([b - 1], dtype=np.float64))
            events_val.append(np.array([s / rem]))

    pos = np.concatenate(events_pos)
    val = np.concatenate(events_val)
    order = np.argsort(pos, kind="stable")
    pos = pos[order]
    val = val[order]
    if max_depth is not None:
        val = np.minimum(val, max_depth)
    return ((pos + start) / 1e6).tolist(), val


def _sliding_window_average_events(
    ev,
    window_size: int,
    max_depth: float | None,
    start: int,
    target: str | None,
) -> tuple[list[float], np.ndarray]:
    """Event-space twin of :func:`sliding_window_average` (bit-identical).

    Window sums come from the exact integral of the piecewise-constant
    depth (int64 arithmetic, same values as the per-base cumsum); zero
    bases and segment boundaries come from the run list.
    """
    n = ev.length
    if n < window_size:
        print(
            f"Warning!!! The length ({n}) of plotting region "
            f"({target}:{start}-{start + n}) is less than the window size "
            f"({window_size}), and therefore the window size will be 1 bp",
            file=sys.stderr,
        )
        window_size = 1
    if n == 0:
        return [], np.array([])

    vals_r, counts_r = ev.run_lengths()
    b = ev.boundaries
    ends_r = b + counts_r
    cumw = np.concatenate(([0], np.cumsum(vals_r * counts_r)))

    def integral(x: np.ndarray) -> np.ndarray:
        """S(x) = sum(depth[0:x]) for x in [0, n], exact int64."""
        r = np.searchsorted(b, x, side="right") - 1
        return cumw[r] + (x - b[r]) * vals_r[r]

    zmask = vals_r == 0
    zlens = counts_r[zmask]
    if zlens.size:
        offs = np.arange(int(zlens.sum()), dtype=np.int64) - np.repeat(
            np.concatenate(([0], np.cumsum(zlens[:-1]))), zlens
        )
        zero_idx = np.repeat(b[zmask], zlens) + offs
    else:
        zero_idx = np.empty(0, dtype=np.int64)

    events_pos: list[np.ndarray] = [zero_idx.astype(np.float64)]
    events_val: list[np.ndarray] = [np.zeros(zero_idx.shape[0])]

    # maximal nonzero segments = groups of consecutive nonzero runs
    nzmask = ~zmask
    if nzmask.any():
        seg_first = np.flatnonzero(nzmask & np.concatenate(([True], zmask[:-1])))
        seg_last = np.flatnonzero(nzmask & np.concatenate((zmask[1:], [True])))
        a_seg = b[seg_first]
        b_seg = ends_r[seg_last]
        seg_len = b_seg - a_seg
        q = seg_len // window_size
        total_w = int(q.sum())
        if total_w:
            rep_a = np.repeat(a_seg, q)
            k = (
                np.arange(total_w, dtype=np.int64)
                - np.repeat(np.concatenate(([0], np.cumsum(q[:-1]))), q)
                + 1
            )
            w_ends = rep_a + k * window_size - 1
            sums = integral(w_ends + 1) - integral(w_ends + 1 - window_size)
            events_pos.append(w_ends.astype(np.float64))
            events_val.append(sums / window_size)
        rem = seg_len - q * window_size
        rmask = rem > 0
        if rmask.any():
            r_end = b_seg[rmask]
            r_sum = integral(r_end) - integral(r_end - rem[rmask])
            events_pos.append((r_end - 1).astype(np.float64))
            events_val.append(r_sum / rem[rmask])

    pos = np.concatenate(events_pos)
    val = np.concatenate(events_val)
    order = np.argsort(pos, kind="stable")
    pos = pos[order]
    val = val[order]
    if max_depth is not None:
        val = np.minimum(val, max_depth)
    return ((pos + start) / 1e6).tolist(), val


def pre_plot(
    depths_list: list[dict[str, np.ndarray]],
    max_depths: list[float],
    window_size: int = 50000,
    start: int = 0,
):
    """Averaged series + y-axis layout (GCI.py:708-739)."""
    averaged_dicts: list[dict] = [{} for _ in depths_list]
    max_avg: list[list[float]] = [[] for _ in depths_list]
    for target in depths_list[0]:
        for i, depthss in enumerate(depths_list):
            positions, vals = sliding_window_average(
                depthss[target], window_size, max_depths[i], start, target
            )
            averaged_dicts[i][target] = (positions, vals)
            max_avg[i].append(vals.max() if vals.size else 0.0)
    y_max = max(max_avg[0]) + 10
    y_min = 0 if len(depths_list) == 1 else max(max_avg[1]) + 10
    y_frac = y_min / (y_max + y_min)
    return averaged_dicts, y_frac, y_min, y_max


# mirror-plot visual identity (GCI.py:742-834: the rendered figures must be
# pixel-identical to the reference's, so these constants — colors, widths,
# zorders, legend geometry — are its contract, pinned by the snapshot test)
_TYPE_COLORS = ("#2ca25f", "#3C5488")  # HiFi up, Nano down
_TYPE_SIGNS = (1, -1)
_LOW_COLOR, _ZERO_COLOR = "#B7DBEA", "#FAD7DD"
_MEAN_LINE = dict(color="r", ls="-.", dash_capstyle="butt", lw=1)


def _issue_bands(depths, mean_depth, threshold, depth_min, dist_percent,
                 start, end):
    """(low_bed, zero_bed) issue bands for one read type, distance-merged.

    Band definitions follow the shading rules: ``low`` is depth in
    (threshold, depth_min*mean], ``zero`` is depth in (-1, threshold].
    """
    from gci_tpu_torch.depth.eventspace import DepthEvents
    from gci_tpu_torch.intervals import collapse_depth_runs, distance_merge

    def collapse(lo, hi):
        if isinstance(depths, DepthEvents):
            bed = depths.collapse(lo, hi, 0, start)
        else:
            bed = collapse_depth_runs(depths, lo, hi, 0, start)
        if not bed:
            return []
        return distance_merge(bed, end - start, dist_percent, start, start, end)

    return (
        collapse(threshold, mean_depth * depth_min),
        collapse(-1, threshold),
    )


def _band_legend_handles(mlines, saw_low, saw_zero, depth_min):
    handles = []
    if saw_low:
        handles.append(mlines.Line2D(
            [], [], color=_LOW_COLOR,
            label="The region with the depth in the range of "
                  f"(0, {depth_min}*mean_depth]",
        ))
    if saw_zero:
        handles.append(mlines.Line2D(
            [], [], color=_ZERO_COLOR, label="The region of zero depth",
        ))
    handles.append(
        mlines.Line2D([], [], label="Mean Coverage", **_MEAN_LINE)
    )
    return handles


def plot_target(
    depths_list,
    target,
    averaged_dicts,
    mean_depths,
    y_frac,
    start,
    depth_min,
    dist_percent,
    y_min,
    y_max,
    image_type,
    directory,
    prefix,
    end,
    regions_flag,
    threshold,
    save_dir=None,
):
    """One mirror figure (GCI.py:742-834). ``save_dir`` defaults to
    {directory}/images (main driver layout); the plot-only tool saves into
    {directory} itself (plot_depth.py:341,388)."""
    if save_dir is None:
        save_dir = f"{directory}/images"
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.lines as mlines
    import matplotlib.pyplot as plt
    from matplotlib.ticker import AutoMinorLocator

    dual = len(depths_list) > 1
    fig, ax = plt.subplots(figsize=(20, 8 if dual else 4))
    if dual:
        ax.axhline(0, color="black")
        type_handles = [
            mlines.Line2D([], [], color=c, label=lbl, lw=0.8)
            for c, lbl in zip(_TYPE_COLORS, ("HiFi", "Nano"))
        ]
        plt.gca().add_artist(
            plt.legend(handles=type_handles, loc="upper left")
        )

    saw_low = saw_zero = False
    for i, depthss in enumerate(depths_list):
        # each type shades its own half of the mirror
        half = (y_frac, 1) if i == 0 else (0, y_frac)
        low_bed, zero_bed = _issue_bands(
            depthss[target], mean_depths[i], threshold, depth_min,
            dist_percent, start, end,
        )
        for bed, color in ((low_bed, _LOW_COLOR), (zero_bed, _ZERO_COLOR)):
            for lo_pos, hi_pos in bed:
                ax.axvspan(lo_pos / 1e6, hi_pos / 1e6, *half, facecolor=color)
        saw_low |= bool(low_bed)
        saw_zero |= bool(zero_bed)
        positions, vals = averaged_dicts[i][target]
        ax.stackplot(
            positions, _TYPE_SIGNS[i] * vals, lw=0.8,
            color=_TYPE_COLORS[i], zorder=4,
        )
        ax.axhline(_TYPE_SIGNS[i] * mean_depths[i], zorder=5, **_MEAN_LINE)

    ax.set_ylim(bottom=-y_min, top=y_max)
    ax.xaxis.set_minor_locator(AutoMinorLocator())
    ax.yaxis.set_minor_locator(AutoMinorLocator())

    handles = _band_legend_handles(mlines, saw_low, saw_zero, depth_min)
    plt.gca().add_artist(plt.legend(
        handles=handles, loc="lower center", bbox_to_anchor=(0.5, 1),
        ncols=len(handles),
    ))

    plt.xlabel("Genomic Position (Mb)", fontsize=14)
    plt.ylabel("Depth", fontsize=14)
    plt.xticks(fontsize=12)
    plt.yticks(fontsize=12)
    if regions_flag:
        title = f"Filtered depth across the region:{target}:{start}-{end}"
        fname = f"{prefix}.{target}:{start}-{end}.{image_type}"
    else:
        title = f"Filtered depth across the whole genome:{target}"
        fname = f"{prefix}.{target}.{image_type}"
    plt.title(title, fontsize=18, pad=30)
    plt.tight_layout()
    plt.savefig(f"{save_dir}/{fname}", dpi=200)
    plt.close()


def plot_depth_files(
    depths_list,
    depth_min=0.1,
    depth_max=4.0,
    window_size=50000,
    image_type="png",
    directory=".",
    prefix="GCI",
    force=False,
    targets_length=None,
    dist_percent=0.005,
    regions_bed=None,
    threshold=0,
    depth_mean=None,
    regions_only=False,
    images_subdir=True,
):
    """Driver (GCI.py:837-894); ``depth_mean`` injects external means
    (utility/plot_depth.py:369-377 ``-dmean`` semantics); ``regions_only``
    reproduces the plot-only tool's region mode (plot_depth.py:381-405)."""
    regions_bed = regions_bed or {}
    if image_type not in ("pdf", "png"):
        sys.exit("ERROR!!! The format of output images only supports pdf and png")
    save_dir = f"{directory}/images" if images_subdir else directory

    from gci_tpu_torch.depth.eventspace import DepthEvents

    if depth_mean is not None:
        mean_depths = depth_mean
    else:
        # mean over the concatenated genome (GCI.py:862-868).  np.mean's
        # float64 pairwise sum of int depths is exact below 2^53, so the
        # event-space total/length quotient is bit-identical to it.
        mean_depths = []
        for depthss in depths_list:
            total = 0
            n_bases = 0
            for v in depthss.values():
                if isinstance(v, DepthEvents):
                    total += v.total()
                    n_bases += v.length
                else:
                    a = np.asarray(v)
                    total += int(a.sum(dtype=np.int64))
                    n_bases += a.shape[0]
            mean_depths.append(
                np.float64(total) / n_bases if n_bases else np.float64(np.nan)
            )
    max_depths = [m * depth_max for m in mean_depths]

    if not regions_only:
        for target in depths_list[0]:
            out = f"{save_dir}/{prefix}.{target}.{image_type}"
            if os.path.exists(out) and not force:
                sys.exit(
                    f'ERROR!!! The file "{out}" exists\nPlease use "-f" or "--force" to rewrite'
                )
        print("Plotting whole genome depth ...")
        averaged_dicts, y_frac, y_min, y_max = pre_plot(
            depths_list, max_depths, window_size, 0
        )
        for target in depths_list[0]:
            plot_target(
                depths_list, target, averaged_dicts, mean_depths, y_frac, 0,
                depth_min, dist_percent, y_min, y_max, image_type, directory,
                prefix, targets_length[target], False, threshold, save_dir,
            )
        print("Plotting whole genome depth done!!!\n\n")

    if regions_bed:
        print("Plotting depth for regions ...")
        for target, segments in regions_bed.items():
            for segment in segments:
                start, end = segment
                out = f"{save_dir}/{prefix}.{target}:{start}-{end}.{image_type}"
                if os.path.exists(out) and not force:
                    sys.exit(
                        f'ERROR!!! The file "{out}" exists\nPlease use "-f" or '
                        '"--force" to rewrite'
                    )
                regions_depths_list = [
                    {
                        target: (
                            depthss[target].slice(start, end)
                            if isinstance(depthss[target], DepthEvents)
                            else depthss[target][start:end]
                        )
                    }
                    for depthss in depths_list
                ]
                averaged_dicts, y_frac, y_min, y_max = pre_plot(
                    regions_depths_list, max_depths, window_size, start
                )
                plot_target(
                    regions_depths_list, target, averaged_dicts, mean_depths,
                    y_frac, start, depth_min, dist_percent, y_min, y_max,
                    image_type, directory, prefix, end, True, threshold, save_dir,
                )
        print("Plotting depth for regions done!!!\n\n")
