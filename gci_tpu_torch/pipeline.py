"""End-to-end pipeline of the port (counterpart of ``gci_tpu.pipeline``).

``run_filter`` — reference GCI.py:172-312 ``filter()``: ingest + filter +
                 curate + depth-accumulate one read-type's alignment files,
                 write the ``.depth.gz`` checkpoint.
``run_gci``    — reference GCI.py:897-1028 ``GCI()``: the whole run (gap
                 scan, per-type filter, gap masking, two-type merge, issue
                 BEDs, scoring, optional plots).

Ingestion, filtering, curation and scoring are the port's copies of
``gci_tpu``'s host code.  Depth backends: ``device`` (``DeviceDepth``
resident on a torch device: the GPU in production, the CPU in tests; past
``accum.stream_slot_limit`` it takes the streamed path), ``streamed``
(chunked scans on the device, O(runs) event space on the host),
``sharded`` (``ShardedDepth`` on a (dp, gp) mesh of positions), ``events``
(O(reads) event space, host) and ``numpy`` (host oracle).

On a multi-process run (``parallel.distributed.init_multihost``) every
process runs the whole pipeline: each parses only its byte range of every
shared BAM and its line range of every PAF, the packed survivors are
reconciled by a host all-gather before curation, and only process 0
writes files.

A read type of one BAM and no PAF, in one process, on the ``device`` or
``streamed`` backend, can overlap its pack with the device scatter, as
``gci_tpu``'s does (``_make_overlap_accumulator``, ``depth/overlap.py``):
each BAM chunk's last-wins survivors fold into an accumulator on the device
while the native producer inflates the next chunk, and the depth comes
from that accumulator.  On a CUDA device it is off unless
``GCI_FORCE_OVERLAP`` is set (it was slower on the H100); ``GCI_NO_OVERLAP``
turns it off everywhere.  Every other read type's depth comes from its
curated reads, after the whole BAM is packed.  An error in the overlap is
the run's error: there is no fallback to the other path.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from gci_tpu_torch.depth import (
    PORTED_BACKENDS,
    GenomeLayout,
    accum,
    accumulate_depth,
    depth_dict_from_flat,
    resolve_auto_backend,
)
from gci_tpu_torch.depth.base import ResidentDepth
from gci_tpu_torch.depth.eventspace import DepthEvents, events_dict_from_reads
from gci_tpu_torch.device import resolve_device
from gci_tpu_torch.filters import (
    CurationInput,
    bam_filter_mask,
    curate_files,
    dedup_last_wins,
    elect_primary_targets,
    paf_filter_mask,
)
from gci_tpu_torch.filters.cascade import high_qual_keys
from gci_tpu_torch.io.fasta import mask_gaps_in_depths, scan_fasta
from gci_tpu_torch.io.paf import read_paf
from gci_tpu_torch.io.depth_file import write_depth_gz
from gci_tpu_torch.io.names import keys_view
from gci_tpu_torch.parallel.distributed import (
    allgather_concat,
    input_comp_range,
    is_primary_host,
    process_count,
    process_index,
)
from gci_tpu_torch.reports import emit_gaps_bed, emit_issue_bed
from gci_tpu_torch.score.report import compute_continuity_report
from gci_tpu_torch.utils.files import require_writable
from gci_tpu_torch.utils.metrics import get_metrics, maybe_trace, stage


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to gci_tpu_torch")


def resolve_backend(depth_backend: str, torch_device=None):
    """(backend, torch.device or None) for a run; ``auto`` is ``device``.
    The device, streamed and sharded backends default to CUDA and raise
    when there is none."""
    if depth_backend == "auto":
        depth_backend = resolve_auto_backend()
    if depth_backend not in PORTED_BACKENDS:
        raise _not_ported(f"the {depth_backend!r} depth backend")
    if depth_backend not in ("device", "streamed", "sharded"):
        return depth_backend, None
    return depth_backend, resolve_device("cuda" if torch_device is None else torch_device)


def _make_overlap_accumulator(depth_backend, paf_files, bam_files, multihost, layout,
                              flank_len, torch_device):
    """Pack<->scatter overlap accumulator on ``torch_device``, where the
    semantics allow it (counterpart of ``gci_tpu.pipeline``'s); None runs
    the depth of the curated reads instead.

    Only the single-BAM no-PAF single-process shape qualifies: curation is
    an identity fold there, so the last-wins dedup can fold chunk by chunk
    and each chunk's deltas scatter asynchronously during pack (reference
    analogue: the GCI.py:146-169 window streaming).  Multi-file or PAF runs
    need the whole cross-file curation before any depth math.  The
    ``device`` backend (a genome within the switch point: ``run_filter``
    has switched larger ones to ``streamed``) accumulates a resident delta
    for ``DeviceDepth.from_delta``; ``streamed`` a coordinate sweep over
    chunks of ``GCI_STREAM_CHUNK_SLOTS`` slots (``streamed.CHUNK_SLOTS``
    unless set).

    ``GCI_NO_OVERLAP`` turns it off.  By default it is also off on a CUDA
    device, and ``GCI_FORCE_OVERLAP`` turns it on there (``gci_tpu``'s
    default gate, skipped by the same variable, turns it off behind a
    high-latency link to a TPU).  On the card an ``index_add_`` is queued
    in microseconds, but the overlap's host work per BAM chunk (a last-wins
    dedup, the fold, the event rows) cost more than the depth stage it
    hides (0.01-0.05 s a read type): at the default 64 MiB BAM chunk the
    dual-type CLI took 0.09-0.43 s longer with it at MH63 size (medians of
    three turns, both branches of ``from_delta``, four chip runs) and
    0.02-0.42 s longer at 3.1 Gbp (NVIDIA H100 80GB HBM3, 700.00 W;
    ``chip_smoke.py`` phase 11, PERF.md §6).
    """
    if paf_files or len(bam_files) != 1 or multihost:
        return None
    if depth_backend not in ("device", "streamed"):
        return None
    if os.environ.get("GCI_NO_OVERLAP"):
        return None
    if torch_device.type == "cuda" and not os.environ.get("GCI_FORCE_OVERLAP"):
        return None
    from gci_tpu_torch.depth import streamed
    from gci_tpu_torch.depth.overlap import DeltaAccumulator, SweepAccumulator

    if depth_backend == "device":
        return DeltaAccumulator(layout, flank_len, device=torch_device)
    # only the genome chunks near the read frontier hold device buffers;
    # each chunk the sorted reads have passed is scanned while the producer
    # inflates the next BAM chunk
    return SweepAccumulator(
        layout, flank_len,
        chunk_slots=int(os.environ.get("GCI_STREAM_CHUNK_SLOTS", streamed.CHUNK_SLOTS)),
        device=torch_device,
    )


def run_filter(
    paf_files: list[str],
    bam_files: list[str],
    prefix: str = "GCI",
    map_qual: int = 30,
    mq_cutoff: int = 50,
    iden_percent: float = 0.9,
    clip_percent: float = 0.1,
    ovlp_percent: float = 0.9,
    flank_len: int = 15,
    directory: str = ".",
    force: bool = False,
    log_reads_type: str = "",
    chrs_list: list[str] = (),
    threads: int = 4,
    depth_backend: str = "auto",
    torch_device=None,
    gaps=None,
    threshold: int = 0,
    slot_limit: int | None = None,
    mesh=None,
):
    """Filter alignments of one read type into depth (GCI.py:172-312).

    ``gaps``/``threshold`` feed the device backend so its one kernel pass
    can pre-extract the run's issue edges; other backends ignore them (gap
    masking stays a separate pipeline stage, as in the reference).  The
    device backend streams a genome of more than ``slot_limit`` slots
    (default: ``accum.stream_slot_limit`` of its device).  ``mesh`` (a
    ``Mesh`` or a spec) is the sharded backend's.
    """
    require_writable(f"{directory}/{prefix}.depth.gz", force)
    print(f"Filtering {log_reads_type} alignment files ...")
    depth_backend, torch_device = resolve_backend(depth_backend, torch_device)

    from gci_tpu_torch.io.bam import BamStream

    # multi-process: each process inflates and parses only its compressed
    # byte range of every shared BAM; the packed survivors are reconciled
    # below by a host all-gather
    multihost = process_count() > 1

    chunk_bytes = int(os.environ.get("GCI_BAM_CHUNK_BYTES", 64 << 20))

    def open_stream(path: str) -> BamStream:
        return BamStream(path, threads=threads, keep_names=False,
                         comp_range=input_comp_range(path) if multihost else None,
                         chunk_bytes=chunk_bytes)

    # only the first stream opens up-front (it provides the target table);
    # the rest open lazily in the per-file loop
    stream0 = open_stream(bam_files[0])
    if chrs_list:
        targets_length = {
            r: l
            for r, l in zip(stream0.references, stream0.lengths)
            if r in chrs_list
        }
    else:
        targets_length = stream0.targets_length()
    target_ids = {name: k for k, name in enumerate(targets_length)}
    layout = GenomeLayout.from_targets(targets_length)
    if depth_backend == "device":
        if slot_limit is None:
            slot_limit = accum.stream_slot_limit(torch_device)
        if layout.total_slots > slot_limit:
            depth_backend = "streamed"

    hq_parts: list[np.ndarray] = []
    curation_inputs: list[CurationInput] = []

    # --- PAF branch (GCI.py:213-254): cumulative election across files.
    # Multi-process: each process tokenizes only its line range of every
    # shared PAF, and the masked candidate columns reconcile by all-gather
    # in process order, which is file row order
    if paf_files:
        from gci_tpu_torch.io.paf import PafData

        global_target_names = list(targets_length)
        paf_masked = []
        for path in paf_files:
            with stage(f"{log_reads_type}:paf_parse:{path}") as paf_stage:
                shard = (process_index(), process_count()) if multihost else None
                paf = read_paf(path, threads=threads, shard=shard)
                paf_stage.items = paf.n_records
                paf_stage.unit = "rows"
                # map this file's target table onto the pipeline's; unknown
                # targets drop here (reference target-membership check)
                t2g = np.array(
                    [target_ids.get(t, -1) for t in paf.target_names] or [-1],
                    dtype=np.int32,
                )
                gtid = t2g[paf.tid]
                mask = (gtid >= 0) & paf_filter_mask(
                    paf.mapq, paf.nmatch, paf.alnlen, map_qual, iden_percent
                )
                idx = np.flatnonzero(mask)
                cols = [
                    np.ascontiguousarray(paf.name_keys[idx]),
                    gtid[idx].astype(np.int32),
                    paf.qlen[idx], paf.qstart[idx], paf.qend[idx],
                    paf.tstart[idx], paf.tend[idx],
                    paf.nmatch[idx], paf.alnlen[idx], paf.mapq[idx],
                ]
                if multihost:
                    cols = allgather_concat(cols)
                keys, gtid_m, qlen, qs, qe, ts, te, nmatch, alnlen, mapq = cols
                cand = PafData(
                    _names=None, name_keys=keys, tid=gtid_m,
                    target_names=global_target_names,
                    qlen=qlen, qstart=qs, qend=qe, tstart=ts, tend=te,
                    nmatch=nmatch, alnlen=alnlen, mapq=mapq,
                )
                paf_masked.append((cand, np.ones(keys.shape[0], dtype=bool)))
                hq_parts.append(
                    high_qual_keys(
                        keys, np.ones(keys.shape[0], dtype=bool), mapq, mq_cutoff,
                    )
                )
        with stage(f"{log_reads_type}:paf_election"):
            for elected in elect_primary_targets(paf_masked):
                curation_inputs.append(
                    CurationInput(
                        name_keys=elected.name_keys,
                        target_id=elected.tid,
                        start=elected.start,
                        end=elected.end,
                        qlen=elected.qlen,
                    )
                )

    # --- BAM branch (GCI.py:257-270): streamed scan, vectorized cascade;
    # each chunk is filtered and compacted while the native producer
    # inflates the next, and the last-wins dedup runs over the concatenated
    # per-chunk survivors (file order, GCI.py:166).  On the overlap's shape
    # each chunk's last-wins survivors also fold into the accumulator on the
    # card (retracting the records they replace) while the producer inflates
    # the next chunk
    acc = _make_overlap_accumulator(depth_backend, paf_files, bam_files, multihost,
                                    layout, flank_len, torch_device)
    empty_hq = np.empty(0, dtype=[("a", np.uint64), ("b", np.uint64)])
    for file_no, path in enumerate(bam_files):
        stream = stream0 if file_no == 0 else open_stream(path)
        hq_file_parts: list[np.ndarray] = []
        with stage(f"{log_reads_type}:bam_pack:{path}") as pack_stage, stream:
            # map this file's ref ids onto the (possibly chrs-restricted) table
            local_to_global = np.full(
                len(stream.references) + 1, -1, dtype=np.int32
            )
            for k, name in enumerate(stream.references):
                if name in target_ids:
                    local_to_global[k] = target_ids[name]
            cand_parts: list[tuple[np.ndarray, ...]] = []
            n_packed = 0
            for chunk in stream:
                n_packed += chunk.n_records
                ref_id = chunk.columns["ref_id"]
                valid_ref = (ref_id >= 0) & (ref_id < len(stream.references))
                gtid = np.where(
                    valid_ref, local_to_global[np.clip(ref_id, 0, None)], -1
                )
                mask = (gtid >= 0) & bam_filter_mask(
                    chunk.columns, map_qual, clip_percent, iden_percent
                )
                hq_file_parts.append(
                    high_qual_keys(
                        chunk.name_keys, mask, chunk.columns["mapq"], mq_cutoff
                    )
                )
                if acc is not None:
                    surv = dedup_last_wins(chunk.name_keys, mask)
                    if surv.size:
                        acc.add_chunk(
                            keys_view(chunk.name_keys[surv]),
                            gtid[surv].astype(np.int32),
                            chunk.columns["pos"][surv].astype(np.int64),
                            chunk.columns["ref_end"][surv].astype(np.int64),
                        )
                # the candidate rows are collected on the overlap path too:
                # they back the curation bookkeeping and the stage's items
                idx = np.flatnonzero(mask)
                if idx.size:
                    cand_parts.append((
                        chunk.name_keys[idx],
                        gtid[idx].astype(np.int32),
                        chunk.columns["pos"][idx].astype(np.int64),
                        chunk.columns["ref_end"][idx].astype(np.int64),
                        chunk.columns["qlen"][idx].astype(np.int64),
                    ))
            pack_stage.items = n_packed
            pack_stage.unit = "records"
        if cand_parts:
            keys, tid, start, end, qlen = (
                np.concatenate([p[j] for p in cand_parts]) for j in range(5)
            )
        else:
            keys = np.empty((0, 2), dtype=np.uint64)
            tid = np.empty(0, dtype=np.int32)
            start = end = qlen = np.empty(0, dtype=np.int64)
        nonempty_hq = [p for p in hq_file_parts if p.size]
        hq_file = np.unique(np.concatenate(nonempty_hq)) if nonempty_hq else empty_hq
        if multihost:
            # reconcile the process shards: process order is file order, so
            # the gathered concatenation is the whole file's record order
            # and the last-wins dedup below stays exact (GCI.py:166)
            keys, tid, start, end, qlen = allgather_concat(
                [keys, tid, start, end, qlen]
            )
            (hq_gathered,) = allgather_concat(
                [np.ascontiguousarray(hq_file).view(np.uint64).reshape(-1, 2)]
            )
            hq_file = np.unique(keys_view(hq_gathered)) if hq_gathered.size else empty_hq
        hq_parts.append(hq_file)
        survivors = dedup_last_wins(keys, np.ones(keys.shape[0], dtype=bool))
        curation_inputs.append(
            CurationInput(
                name_keys=keys[survivors],
                target_id=tid[survivors],
                start=start[survivors],
                end=end[survivors],
                qlen=qlen[survivors],
            )
        )

    non_empty = [p for p in hq_parts if p.size]
    high_qual = np.unique(np.concatenate(non_empty)) if non_empty else empty_hq

    with stage(f"{log_reads_type}:curation"):
        curated = curate_files(curation_inputs, high_qual, ovlp_percent)

    with stage(
        f"{log_reads_type}:depth_accumulate",
        items=int(curated.start.shape[0]), unit="reads",
    ):
        if acc is not None:
            # the delta accumulated during pack; the sweep has scanned most
            # of its genome chunks already
            from gci_tpu_torch.depth.overlap import DeltaAccumulator

            if isinstance(acc, DeltaAccumulator):
                from gci_tpu_torch.depth.fused import DeviceDepth

                depths = DeviceDepth.from_delta(
                    layout, acc.take_delta(), flank_len, gaps=gaps,
                    issue_range=(-1, threshold), rows=acc.rows,
                )
            else:
                depths = acc.finish()
        elif depth_backend == "events":
            depths = events_dict_from_reads(
                layout, curated.target_id, curated.start, curated.end, flank_len
            )
        elif depth_backend == "streamed":
            # chunked scans on the device; O(runs) event space on the host
            from gci_tpu_torch.depth.streamed import events_from_reads_streamed

            depths = events_from_reads_streamed(
                layout, curated.target_id, curated.start, curated.end,
                flank_len, device=torch_device,
            )
        elif depth_backend == "device":
            # one scatter of the packed event word + ONE fused scan kernel
            # (depth, gap-masked issue edges, checkpoint run boundaries); the
            # depth stays device-resident for the run
            from gci_tpu_torch.depth.fused import DeviceDepth

            depths = DeviceDepth.from_reads(
                layout, curated.target_id, curated.start, curated.end,
                flank_len, gaps=gaps, issue_range=(-1, threshold),
                device=torch_device,
            )
        elif depth_backend == "sharded":
            # genome axis gp-sharded on the mesh, reads scattered over dp;
            # the depth stays on the devices through gap masking, two-type
            # max and interval extraction
            from gci_tpu_torch.depth.sharded import ShardedDepth, resolve_mesh

            depths = ShardedDepth.from_reads(
                resolve_mesh(mesh, torch_device), layout, curated.target_id,
                curated.start, curated.end, flank_len,
            )
        else:
            flat = accumulate_depth(
                layout, curated.target_id, curated.start, curated.end,
                flank_len, backend="numpy",
            )
            depths = depth_dict_from_flat(layout, flat)

    print(f"Filtering {log_reads_type} alignment files done!!!")
    print(f'Writing depths into "{directory}/{prefix}.depth.gz" ...')
    if isinstance(depths, ResidentDepth):
        # device->host run-boundary readback under its own stage (cached on
        # the object; the writer reuses it)
        with stage(f"{log_reads_type}:checkpoint_readback"):
            depths.to_events()
    with stage(f"{log_reads_type}:write_depth_gz"):
        write_depth_gz(f"{directory}/{prefix}.depth.gz", depths)
    print("Writing depths done!!!\n\n")
    return depths, targets_length


def merge_two_type_depths(
    hifi_depths,
    nano_depths,
    prefix: str = "GCI_two_type",
    directory: str = ".",
    force: bool = False,
):
    """Per-base max of the two read types (GCI.py:332-353) + checkpoint."""
    print("Merging HiFi and ONT depth file ...")
    require_writable(f"{directory}/{prefix}.depth.gz", force)
    if isinstance(hifi_depths, ResidentDepth):
        merged = hifi_depths.maximum(nano_depths)
    else:
        merged = {
            t: d.maximum(nano_depths[t]) if isinstance(d, DepthEvents)
            else np.maximum(d, nano_depths[t])
            for t, d in hifi_depths.items()
        }
    write_depth_gz(f"{directory}/{prefix}.depth.gz", merged)
    print("Merging HiFi and ONT depth file done!!!\n\n")
    return merged


def run_gci(
    hifi: list[str] | None = None,
    nano: list[str] | None = None,
    directory: str = ".",
    prefix: str = "GCI",
    map_qual: int = 30,
    mq_cutoff: int = 50,
    iden_percent: float = 0.9,
    ovlp_percent: float = 0.9,
    clip_percent: float = 0.1,
    flank_len: int = 15,
    threshold: int = 0,
    plot: bool = False,
    depth_min: float = 0.1,
    depth_max: float = 4.0,
    window_size: int = 50000,
    image_type: str = "png",
    force: bool = False,
    dist_percent: float = 0.005,
    reference: str | None = None,
    regions: str | None = None,
    chrs: str | None = None,
    threads: int = 4,
    depth_backend: str = "auto",
    torch_device: str | torch.device | None = None,
    profile: bool = False,
    mesh=None,
    profile_trace: str | None = None,
) -> None:
    """Whole run with the semantics of the reference's ``GCI()`` (GCI.py:897-1028).

    ``torch_device`` is where the ``device``, ``streamed`` and ``sharded``
    backends run (default: the current CUDA device; ``"cpu"`` runs the
    kernels' plain versions).  ``mesh`` is the sharded backend's: a
    ``parallel.mesh.Mesh`` or a spec (``"dp,gp"``, ``"auto"``; see
    ``depth.sharded.resolve_mesh``); one mesh serves the whole run.
    ``profile_trace`` is a directory for a ``torch.profiler`` trace.
    """
    from gci_tpu_torch.native import ensure_host_codec

    depth_backend, torch_device = resolve_backend(depth_backend, torch_device)
    if depth_backend == "sharded":
        from gci_tpu_torch.depth.sharded import resolve_mesh

        mesh = resolve_mesh(mesh, torch_device)
    ensure_host_codec()
    with maybe_trace(profile_trace, cuda=torch_device is not None
                     and torch_device.type == "cuda"):
        _run_gci_inner(
            hifi, nano, directory, prefix, map_qual, mq_cutoff, iden_percent,
            ovlp_percent, clip_percent, flank_len, threshold, plot, depth_min,
            depth_max, window_size, image_type, force, dist_percent, reference,
            regions, chrs, threads, depth_backend, torch_device, mesh,
        )
    if profile:
        print("\n=== stage metrics ===")
        print(get_metrics().report())


def _host_view(depths):
    """Event-space host view of a depth mapping (regions re-collapse, plots):
    device-resident depths convert lazily (one O(runs) boundary transfer)."""
    return depths.to_events() if isinstance(depths, ResidentDepth) else depths


def _run_gci_inner(
    hifi, nano, directory, prefix, map_qual, mq_cutoff, iden_percent,
    ovlp_percent, clip_percent, flank_len, threshold, plot, depth_min,
    depth_max, window_size, image_type, force, dist_percent, reference,
    regions, chrs, threads, depth_backend, torch_device, mesh=None,
) -> None:
    from gci_tpu_torch.io.bam import read_bam_header
    from gci_tpu_torch.io.bed import read_bed_dict

    chrs_list = chrs.strip().split(",") if chrs is not None else []

    regions_bed: dict[str, list[tuple[int, int]]] = {}
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
        os.makedirs(directory, exist_ok=True)  # multi-process: processes race here

    if prefix.endswith("/"):
        sys.exit(f'ERROR!!! The prefix "{prefix}" is not allowed')

    if plot:
        img_dir = f"{directory}/images"
        if os.path.exists(img_dir):
            if not os.access(img_dir, os.R_OK):
                sys.exit(f'ERROR!!! The path "{img_dir}" is unable to read')
            if not os.access(img_dir, os.W_OK):
                sys.exit(f'ERROR!!! The path "{img_dir}" is unable to write')
        else:
            os.makedirs(img_dir, exist_ok=True)
        image_type = image_type.lower()

    # ONE pass over the reference: record ids (consistency checks,
    # GCI.py:939-941) AND the N-gap scan (GCI.py:983-988) together
    with stage("fasta_scan"):
        ref_lengths, gaps = scan_fasta(reference)
    ref_refs = list(ref_lengths.keys())
    for i in chrs_list:
        if i not in ref_refs:
            sys.exit(f'ERROR!!! Chromosome "{i}" provided by `--chrs` is not in the reference')
    for i in regions_bed:
        if i not in ref_refs:
            sys.exit(f'ERROR!!! Chromosome "{i}" provided by `--regions` is not in the reference')
    if chrs_list and regions_bed:
        if not all(i in chrs_list for i in regions_bed):
            sys.exit(
                "ERROR!!! Chromosomes in the regions bed file are inconsistent with "
                'the provided list of chromosomes\nPlease read the help message use "-h" or "--help"'
            )

    def split_files(files):
        bams = [f for f in files if f.endswith(".bam")]
        pafs = [f for f in files if not f.endswith(".bam")]
        return bams, pafs

    hifi_bam: list[str] = []
    hifi_paf: list[str] = []
    nano_bam: list[str] = []
    nano_paf: list[str] = []
    hifi_refs_lengths: dict[str, int] = {}
    nano_refs_lengths: dict[str, int] = {}
    if hifi is not None:
        hifi_bam, hifi_paf = split_files(hifi)
        for f in hifi_bam:
            refs, lens = read_bam_header(f)
            hifi_refs_lengths = dict(zip(refs, lens))
        if set(hifi_refs_lengths) != set(ref_refs):
            sys.exit(
                "ERROR!!! The targets in hifi alignment files are inconsistent with "
                "the reference file\nPlease check both hifi alignment files and the reference"
            )
    if nano is not None:
        nano_bam, nano_paf = split_files(nano)
        for f in nano_bam:
            refs, lens = read_bam_header(f)
            nano_refs_lengths = dict(zip(refs, lens))
        if set(nano_refs_lengths) != set(ref_refs):
            sys.exit(
                "ERROR!!! The targets in ont alignment files are inconsistent with "
                "the reference file\nPlease check both ont alignment files and the reference"
            )

    print("Finding gaps ...")
    gaps_path = emit_gaps_bed(gaps, prefix, directory, force)
    if gaps_path is not None:
        print(f"Finding gaps done!!! The gaps are in {gaps_path}\n\n")
    else:
        print("Finding gaps done!!! Awesome! No gaps were found!\n\n")

    common = dict(
        map_qual=map_qual,
        mq_cutoff=mq_cutoff,
        iden_percent=iden_percent,
        clip_percent=clip_percent,
        ovlp_percent=ovlp_percent,
        flank_len=flank_len,
        directory=directory,
        force=force,
        chrs_list=chrs_list,
        threads=threads,
        depth_backend=depth_backend,
        torch_device=torch_device,
        mesh=mesh,
        gaps=gaps,
        threshold=threshold,
        # one switch point for the whole run, so both read types take the
        # same path whatever the first one leaves on the card
        slot_limit=(accum.stream_slot_limit(torch_device)
                    if depth_backend == "device" else None),
    )

    if nano is None or hifi is None:
        files_bam = hifi_bam if nano is None else nano_bam
        files_paf = hifi_paf if nano is None else nano_paf
        rt = "HiFi" if nano is None else "ONT"
        type_label = "HiFi" if nano is None else "Nano"
        depths, targets_length = run_filter(
            files_paf, files_bam, prefix, log_reads_type=rt, **common
        )
        depths = mask_gaps_in_depths(depths, gaps)
        merged_bed = emit_issue_bed(
            depths, prefix, threshold, flank_len, directory, force, rt
        )
        compute_continuity_report(
            targets_length, prefix, directory, force, [merged_bed], [type_label],
            flank_len, dist_percent, regions_bed,
            [_host_view(depths) if regions_bed else depths], threshold, chrs_list,
        )
        host_plot_depths = [depths]
    else:
        if set(hifi_refs_lengths) != set(nano_refs_lengths):
            sys.exit(
                "ERROR!!! The targets in hifi and nano alignment files are "
                "inconsistent\nPlease check the reference used in mapping both hifi and ont reads"
            )
        for target, length in hifi_refs_lengths.items():
            if length != nano_refs_lengths[target]:
                sys.exit(
                    f'ERROR!!! The element "{target}:{length}" in hifi alignment files are '
                    f'inconsistent with that in ont alignment files which is '
                    f'"{target}:{nano_refs_lengths[target]}"\nPlease check the reference used '
                    "in mapping both hifi and ont reads"
                )
        hifi_depths, targets_length = run_filter(
            hifi_paf, hifi_bam, prefix + "_hifi", log_reads_type="HiFi", **common
        )
        hifi_depths = mask_gaps_in_depths(hifi_depths, gaps)
        nano_depths, targets_length = run_filter(
            nano_paf, nano_bam, prefix + "_nano", log_reads_type="ONT", **common
        )
        nano_depths = mask_gaps_in_depths(nano_depths, gaps)
        two_type = merge_two_type_depths(
            hifi_depths, nano_depths, prefix + "_two_type", directory, force
        )
        two_type = mask_gaps_in_depths(two_type, gaps)

        hifi_bed = emit_issue_bed(
            hifi_depths, prefix + "_hifi", threshold, flank_len, directory, force, "HiFi"
        )
        nano_bed = emit_issue_bed(
            nano_depths, prefix + "_nano", threshold, flank_len, directory, force, "ONT"
        )
        two_bed = emit_issue_bed(
            two_type, prefix + "_two_type", threshold, flank_len, directory, force, "two_types"
        )
        depths_for_report = (
            [_host_view(hifi_depths), _host_view(nano_depths), _host_view(two_type)]
            if regions_bed
            else [hifi_depths, nano_depths, two_type]
        )
        compute_continuity_report(
            targets_length, prefix, directory, force,
            [hifi_bed, nano_bed, two_bed], ["HiFi", "Nano", "HiFi + Nano"],
            flank_len, dist_percent, regions_bed,
            depths_for_report, threshold, chrs_list,
        )
        host_plot_depths = [hifi_depths, nano_depths]
    if plot:
        from gci_tpu_torch.viz.plot import plot_depth_files

        # host views first: a sharded readback is a collective every
        # process joins; only the primary renders files
        host_depths = [_host_view(d) for d in host_plot_depths]
        if is_primary_host():
            plot_depth_files(
                host_depths, depth_min, depth_max, window_size, image_type,
                directory, prefix, force, targets_length, dist_percent,
                regions_bed, threshold,
            )

    print("GCI finished!!!\nBye!!!")
