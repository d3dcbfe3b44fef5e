"""Sharded whole-pipeline depth: one read type's genome axis held on a
(dp, gp) mesh end to end (counterpart of ``gci_tpu.depth.sharded``).

The multi-GPU path (``depth_backend="sharded"``, ``gci-torch --mesh dp,gp``):
reads are packed once on the host and scattered data-parallel over ``dp``;
the per-base genome axis lives gp-sharded on the devices through depth
accumulation (GCI.py:302-306), gap masking (GCI.py:315-329), the two-type
max (GCI.py:332-353) and issue-interval extraction (GCI.py:356-390).  Only
interval edges and run boundaries (O(runs)) come back to the host; the
per-base axis never does.  The programs and the collectives that stitch
the shards are ``gci_tpu_torch.depth.device``'s.

The reference's global-array helpers map so: ``_to_global`` (each process
feeds only its dp rows) is the row range each position takes in
``device.sharded_depth``; ``_gp_global`` is ``_gp_shards``;
``_replicated_global`` has no counterpart, since host values (the issue
range) go to each shard's device with the call that uses them;
``_host_all`` is ``_host_all``.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from gci_tpu_torch.depth.accum import GenomeLayout, depth_dict_from_flat
from gci_tpu_torch.depth.base import (
    ResidentDepth,
    events_from_boundaries,
    gap_interval_events,
)
from gci_tpu_torch.depth.device import (
    edge_indices_to_intervals,
    pack_read_deltas_sharded,
    sharded_compact_gather,
    sharded_depth,
    sharded_interval_edges,
    sharded_runs,
)
from gci_tpu_torch.depth.fused import _event_rows, _valid_intervals
from gci_tpu_torch.parallel import distributed
from gci_tpu_torch.parallel.mesh import Mesh, make_mesh


def _global_indices(mesh: Mesh, pad_total: int, res: dict, k: int) -> np.ndarray:
    """The k-th array of every shard's record, shard-local indices made
    global, in genome order."""
    shard = pad_total // mesh.shape["gp"]
    return np.concatenate([res[g][k] + g * shard for g in range(mesh.shape["gp"])])


def _interval_marks(mesh: Mesh, pad_total: int, starts: np.ndarray,
                    stops: np.ndarray) -> dict[int, torch.Tensor]:
    """int32 count of the [start, stop) intervals over each slot, per shard,
    built by the depth step from O(intervals) events (a host-built per-base
    mask would be an O(genome) upload)."""
    shard = pad_total // mesh.shape["gp"]
    packed = (
        (starts // shard).astype(np.int32),
        (starts % shard).astype(np.int32),
        (stops // shard).astype(np.int32),
        (stops % shard).astype(np.int32),
        np.ones(starts.shape[0], np.int32),
    )
    return sharded_depth(mesh, pad_total, packed, starts.shape[0])


def _gp_shards(mesh: Mesh, a: np.ndarray) -> dict[int, torch.Tensor]:
    """This process's gp shards of an identical full host array, each on
    its shard's device."""
    shard = a.shape[0] // mesh.shape["gp"]
    return {g: torch.as_tensor(a[g * shard:(g + 1) * shard], device=mesh.shard_device(g))
            for g in mesh.local_gp()}


def _host_all(mesh: Mesh, shards: dict) -> np.ndarray:
    """The whole genome axis on the host of every process (tests/oracles)."""
    rows = [np.concatenate([[g], x.cpu().numpy().astype(np.int64)])
            for g, x in shards.items()]
    rows = np.stack(rows) if rows else np.empty((0, 0), np.int64)
    if distributed.process_count() > 1:
        (rows,) = distributed.allgather_concat([rows])
    first = {}
    for r in rows:
        first.setdefault(int(r[0]), r[1:])
    return np.concatenate([first[g] for g in range(mesh.shape["gp"])]).astype(np.int32)


def _spec_size(spec) -> int | None:
    """Positions a mesh spec asks for (None for 'auto' or a bad spec)."""
    try:
        return int(np.prod([int(p) for p in str(spec).split(",")]))
    except ValueError:
        return None


def parse_mesh_spec(spec: str | None = None, n_devices: int | None = None,
                    devices=None) -> Mesh:
    """'dp,gp' | 'n' | 'auto' | None -> a (dp, gp) Mesh over ``devices``
    (this process's positions; default: its CUDA devices)."""
    if spec in (None, "", "auto"):
        return make_mesh(n_devices, devices=devices)
    try:
        parts = [int(p) for p in str(spec).split(",")]
        if len(parts) == 1:
            return make_mesh(parts[0], devices=devices)
        dp, gp = parts
    except ValueError:
        sys.exit(
            f'ERROR!!! Invalid mesh spec "{spec}"\n'
            "Expected 'dp,gp' (e.g. --mesh 2,4) or 'auto'"
        )
    return make_mesh(dp * gp, dp=dp, devices=devices)


def resolve_mesh(mesh, device: torch.device) -> Mesh:
    """The run's one Mesh from a Mesh or a spec, for a run on ``device``.

    On CUDA a spec's positions are this process's CUDA devices, each once,
    and a spec larger than they are raises ValueError.  On the CPU (which
    only a caller that names it gets) every position is the one CPU device,
    as many as the spec asks for, split evenly over the processes ('auto':
    one per process).  A Mesh is taken as it is, but its positions must be
    of ``device``'s type.
    """
    if isinstance(mesh, Mesh):
        if mesh.local_device_type() not in (None, device.type):
            raise ValueError(f"mesh positions on {mesh.local_device_type()}, "
                             f"the run on {device.type}")
        return mesh
    devices = None
    if device.type != "cuda":
        per = -(-(_spec_size(mesh) or distributed.process_count())
                // distributed.process_count())
        devices = [device] * per
    return parse_mesh_spec(mesh, devices=devices)


class ShardedDepth(ResidentDepth):
    """One read type's whole-genome depth, gp-sharded on a mesh.

    Drop-in value for the pipeline's depth dictionaries: gap masking,
    two-type max, interval collapse and checkpoint serialization all
    dispatch on this type and stay on the devices.  ``shards`` maps each gp
    index this process holds to its int32 depth shard.
    """

    def __init__(self, mesh: Mesh, layout: GenomeLayout, shards: dict[int, torch.Tensor],
                 pad_total: int, change_bound: int | None = None):
        self._valid_cache: dict[int, dict] = {}
        self.mesh = mesh
        self.layout = layout
        self.shards = shards
        self.pad_total = pad_total
        # at most this many run boundaries in any one shard (its slot 0
        # included), the capacity of the shards' compactions; None where
        # not known
        self.change_bound = change_bound
        self._events = None  # lazy host event-space view

    # ------------------------------------------------------------ construct
    @staticmethod
    def _pad_total(mesh: Mesh, total: int) -> int:
        """The genome axis padded to a multiple of gp (the reference's CPU
        form; its TPU size buckets have no use here)."""
        return total + ((-total) % mesh.shape["gp"])

    @classmethod
    def from_reads(
        cls,
        mesh: Mesh,
        layout: GenomeLayout,
        target_id: np.ndarray,
        start: np.ndarray,
        end: np.ndarray,
        flank_len: int,
    ) -> "ShardedDepth":
        """Depth of the reads; each process packs only the rows of its dp
        rows (``distributed.owned_dp_rows``)."""
        dp = mesh.shape["dp"]
        pad_total = cls._pad_total(mesh, layout.total_slots)
        shard = pad_total // mesh.shape["gp"]
        n = target_id.shape[0]
        lo, hi = distributed.owned_dp_rows(mesh, n + ((-n) % dp))
        sl = slice(lo, min(hi, n))
        packed = pack_read_deltas_sharded(
            layout, target_id[sl], start[sl], end[sl], flank_len, shard
        )
        # a shard's boundaries fall on its slot 0 or where one of the n
        # reads, on any process, starts or stops
        return cls(mesh, layout, sharded_depth(mesh, pad_total, packed, n, first_row=lo),
                   pad_total, 2 * n + 1)

    # ------------------------------------------------------------------ ops
    def mask_gaps(self, gaps: dict[str, list[tuple[int, int]]]) -> "ShardedDepth":
        """Zero depth over N-gap intervals, on the devices (GCI.py:315-329)."""
        gs, ge = gap_interval_events(self.layout, gaps)
        if gs.shape[0] == 0:
            return self
        marks = _interval_marks(self.mesh, self.pad_total, gs, ge)
        bound = self.change_bound
        return ShardedDepth(
            self.mesh, self.layout,
            {g: torch.where(marks.pop(g) > 0, 0, x) for g, x in self.shards.items()},
            self.pad_total, None if bound is None else bound + 2 * gs.shape[0],
        )

    def maximum(self, other: "ShardedDepth") -> "ShardedDepth":
        """Per-base two-type max, on the devices (GCI.py:332-353)."""
        if self.pad_total != other.pad_total:
            raise ValueError("two-type max of depths over different layouts")
        bound = (None if self.change_bound is None or other.change_bound is None
                 else self.change_bound + other.change_bound)
        return ShardedDepth(
            self.mesh, self.layout,
            {g: torch.maximum(x, other.shards[g]) for g, x in self.shards.items()},
            self.pad_total, bound,
        )

    def _valid_marks(self, flank_len: int) -> dict[int, torch.Tensor]:
        """Bool scan-window indicator per shard, built on the devices from
        O(targets) interval events by the depth step."""
        cached = self._valid_cache.get(flank_len)
        if cached is not None:
            return cached
        vs, ve = (np.asarray(v, np.int64) for v in _valid_intervals(self.layout, flank_len))
        marks = _interval_marks(self.mesh, self.pad_total, vs, ve)
        self._valid_cache[flank_len] = {g: marks.pop(g) > 0 for g in list(marks)}
        return self._valid_cache[flank_len]

    def collapse_dict(
        self,
        leftmost: float = -1,
        rightmost: float = 0,
        flank_len: int = 15,
        start_pos: int = 0,
    ) -> dict[str, list[tuple[int, int]]]:
        """Issue intervals from the sharded edges (GCI.py:356-390): each
        shard compacts its own edge bitmaps, the host reads O(edges)."""
        rise, fall = sharded_interval_edges(
            self.mesh, self.shards, self._valid_marks(flank_len), int(leftmost),
            int(rightmost),
        )
        # one edge byte per shard (bit0 rise, bit1 fall): one compaction
        edges = {g: rise.pop(g).view(torch.int8) + fall.pop(g).view(torch.int8) * 2
                 for g in list(rise)}
        # an edge falls on a run boundary or on a scan-window border
        bound = self.change_bound
        if bound is not None:
            bound += _event_rows(self.layout, 0, None, flank_len)
        res = sharded_compact_gather(edges, (1, 2), bound)
        del edges
        rise_idx = _global_indices(self.mesh, self.pad_total, res, 0)
        fall_idx = _global_indices(self.mesh, self.pad_total, res, 1)
        return edge_indices_to_intervals(
            self.layout, rise_idx, fall_idx, flank_len, start_pos
        )

    # ------------------------------------------------------------ host view
    def to_events(self):
        """O(runs) host view: {target: DepthEvents}.

        Run boundaries compacted per shard by the run form of the
        compaction kernel, with the depth of each run, in one readback per
        shard; each shard's carry is its left neighbour's last value, so
        the shards' runs together are the genome's run form.  Used for the
        checkpoint writer, the regions report and plotting.
        """
        if self._events is not None:
            return self._events
        res = sharded_runs(self.mesh, self.shards, self.change_bound)
        idx = _global_indices(self.mesh, self.pad_total, res, 0)
        vals = np.concatenate([res[g][1] for g in range(self.mesh.shape["gp"])])
        self._events = events_from_boundaries(self.layout, idx, vals)
        return self._events

    def materialize_dict(self) -> dict[str, np.ndarray]:
        """Per-target per-base arrays (tests/oracles only — O(genome) host)."""
        flat = _host_all(self.mesh, self.shards)[: self.layout.total_slots]
        return depth_dict_from_flat(self.layout, flat)
