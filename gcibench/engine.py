"""One assessment: an assembly's curated read sets through the port's own entries.

This is the system under test, called as ``gci_tpu_torch.pipeline`` calls
it after curation (``run_filter`` with ``--device device``, then
``_run_gci_inner``), less the checkpoint files' BGZF encoding:

1. per read type, the depth: ``accum.stream_slot_limit`` picks the path;
   resident: ``DeviceDepth.from_reads`` (host pack, one scatter, K1, the
   flag compaction), then ``to_events``, the checkpoint's runs; streamed:
   ``events_from_reads_streamed``, which hands back runs;
2. the N-gap mask, ``mask_gaps_in_depths``;
3. with two read types, the merge ``merge_two_type_depths`` makes
   (``maximum`` of the resident values, or ``DepthEvents.maximum`` per
   chromosome), its runs, and its mask;
4. ``emit_issue_bed`` per depth, then ``compute_continuity_report``, into
   one directory, overwritten by each assessment.

Every call into a layer sits in a span of the benchmark's own
(``spans.Spans``): ``fused.build``, ``checkpoint.runs``, ``streamed.build``,
``mask.gaps``, ``merge.max``, ``reports.issue_bed``, ``score.report``; the
per-layer metrics read them.
"""
from __future__ import annotations

from gci_tpu_torch.depth import accum
from gci_tpu_torch.depth.base import ResidentDepth
from gci_tpu_torch.depth.fused import DeviceDepth
from gci_tpu_torch.depth.streamed import events_from_reads_streamed
from gci_tpu_torch.io.fasta import mask_gaps_in_depths
from gci_tpu_torch.reports import emit_issue_bed
from gci_tpu_torch.score.report import compute_continuity_report

PREFIX = "GCI"
# each read type's name in the files (``run_gci``'s prefixes) and in the .gci
FILE_SUFFIX = {"hifi": "_hifi", "ont": "_nano"}
SCORE_LABEL = {"hifi": "HiFi", "ont": "Nano"}
BED_LABEL = {"hifi": "HiFi", "ont": "ONT"}


class Assessor:
    """Holds what every assessment of one cell shares: the layout, the gaps,
    the path, the output directory and the device."""

    def __init__(self, lengths: dict, gaps: dict, mix: dict, directory: str, device, spans):
        self.layout = accum.GenomeLayout.from_targets(lengths)
        self.lengths = dict(lengths)
        self.gaps = {t: [tuple(g) for g in segs] for t, segs in gaps.items()}
        self.flank = int(mix["flank"])
        self.threshold = int(mix["threshold"])
        self.dist_percent = float(mix["dist_percent"])
        self.directory = directory
        self.device = device
        self.spans = spans
        self.resident = self.layout.total_slots <= accum.stream_slot_limit(device)

    def _depth(self, tid, start, end):
        """(the depth value, its checkpoint runs) of one read type."""
        span = self.spans.span
        if self.resident:
            with span("fused.build"):
                d = DeviceDepth.from_reads(
                    self.layout, tid, start, end, self.flank, gaps=self.gaps,
                    issue_range=(-1, self.threshold), device=self.device)
            with span("checkpoint.runs"):
                return d, d.to_events()
        with span("streamed.build"):
            d = events_from_reads_streamed(self.layout, tid, start, end, self.flank,
                                           device=self.device)
        # the mask below replaces entries of the dict, not the runs in it
        return d, dict(d)

    def assess(self, read_set) -> dict:
        """Every output of one assessment of ``read_set`` (``[(kind, tid,
        start, end), ...]``, HiFi first): ``runs`` (``{kind or "two_type":
        {chrom: DepthEvents}}``, the checkpoints' contents) and ``beds``
        (``{kind or "two_type": path}``) and ``gci`` (path)."""
        span = self.spans.span
        runs, masked = {}, {}
        for kind, tid, start, end in read_set:
            d, runs[kind] = self._depth(tid, start, end)
            with span("mask.gaps"):
                masked[kind] = mask_gaps_in_depths(d, self.gaps)
        labels = [k for k, *_ in read_set]
        files = {k: PREFIX + (FILE_SUFFIX[k] if len(labels) == 2 else "") for k in labels}
        bed_labels = [BED_LABEL[k] for k in labels]
        if len(labels) == 2:
            hifi, ont = (masked[k] for k in labels)
            with span("merge.max"):
                if isinstance(hifi, ResidentDepth):
                    merged = hifi.maximum(ont)
                else:
                    merged = {t: d.maximum(ont[t]) for t, d in hifi.items()}
            if isinstance(merged, ResidentDepth):
                with span("checkpoint.runs"):
                    runs["two_type"] = merged.to_events()
            else:
                runs["two_type"] = dict(merged)
            with span("mask.gaps"):
                masked["two_type"] = mask_gaps_in_depths(merged, self.gaps)
            files["two_type"] = PREFIX + "_two_type"
            bed_labels.append("two_types")
        beds, intervals = {}, []
        with span("reports.issue_bed"):
            for key, label in zip(masked, bed_labels):
                intervals.append(emit_issue_bed(
                    masked[key], files[key], self.threshold, self.flank, self.directory,
                    True, label))
                beds[key] = f"{self.directory}/{files[key]}.{self.threshold}.depth.bed"
        score_labels = [SCORE_LABEL[k] for k in labels]
        if len(labels) == 2:
            score_labels.append("HiFi + Nano")
        with span("score.report"):
            compute_continuity_report(
                self.lengths, PREFIX, self.directory, True, intervals, score_labels,
                self.flank, self.dist_percent, {}, list(masked.values()), self.threshold, [])
        return {"runs": runs, "beds": beds, "gci": f"{self.directory}/{PREFIX}.gci"}
