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
range, the target offsets) go to each shard's device with the call that
uses them; ``_host_all`` is ``_host_all``.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from gci_tpu_torch.depth.accum import GenomeLayout, depth_dict_from_flat
from gci_tpu_torch.depth.base import (
    ResidentDepth,
    events_from_change_indices,
    gap_interval_events,
)
from gci_tpu_torch.depth.device import (
    edge_indices_to_intervals,
    pack_read_deltas_sharded,
    sharded_change,
    sharded_compact_gather,
    sharded_depth,
    sharded_interval_edges,
)
from gci_tpu_torch.depth.fused import _valid_intervals
from gci_tpu_torch.parallel import distributed
from gci_tpu_torch.parallel.mesh import Mesh, make_mesh


def _shard_compact(mesh: Mesh, bitmaps: dict, values: dict | None, pad_total: int,
                   offsets: np.ndarray):
    """Host assembly of the per-shard compaction: (global sorted int64
    indices, values at them, values at the global ``offsets``); the values
    are empty when ``values`` is None."""
    gp = mesh.shape["gp"]
    shard = pad_total // gp
    o_shard = offsets // shard
    loff = None if values is None else {g: offsets[o_shard == g] % shard for g in range(gp)}
    res = sharded_compact_gather(mesh, bitmaps, values, loff)
    idx = np.concatenate([res[g][0] + g * shard for g in range(gp)])
    vals = np.concatenate([res[g][1] for g in range(gp)])
    offset_vals = np.empty(offsets.shape[0], np.int64)
    for g in range(gp):
        offset_vals[o_shard == g] = res[g][2]
    return idx, vals, offset_vals


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
                 pad_total: int):
        self._valid_cache: dict[int, dict] = {}
        self.mesh = mesh
        self.layout = layout
        self.shards = shards
        self.pad_total = pad_total
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
        return cls(mesh, layout, sharded_depth(mesh, pad_total, packed, n, first_row=lo),
                   pad_total)

    # ------------------------------------------------------------------ ops
    def mask_gaps(self, gaps: dict[str, list[tuple[int, int]]]) -> "ShardedDepth":
        """Zero depth over N-gap intervals, on the devices (GCI.py:315-329)."""
        gs, ge = gap_interval_events(self.layout, gaps)
        if gs.shape[0] == 0:
            return self
        marks = _interval_marks(self.mesh, self.pad_total, gs, ge)
        return ShardedDepth(
            self.mesh, self.layout,
            {g: torch.where(marks.pop(g) > 0, 0, x) for g, x in self.shards.items()},
            self.pad_total,
        )

    def maximum(self, other: "ShardedDepth") -> "ShardedDepth":
        """Per-base two-type max, on the devices (GCI.py:332-353)."""
        if self.pad_total != other.pad_total:
            raise ValueError("two-type max of depths over different layouts")
        return ShardedDepth(
            self.mesh, self.layout,
            {g: torch.maximum(x, other.shards[g]) for g, x in self.shards.items()},
            self.pad_total,
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
        no_off = np.empty(0, np.int64)
        rise_idx = _shard_compact(self.mesh, rise, None, self.pad_total, no_off)[0]
        del rise
        fall_idx = _shard_compact(self.mesh, fall, None, self.pad_total, no_off)[0]
        del fall
        return edge_indices_to_intervals(
            self.layout, rise_idx, fall_idx, flank_len, start_pos
        )

    # ------------------------------------------------------------ host view
    def to_events(self):
        """O(runs) host view: {target: DepthEvents}.

        Run boundaries from the sharded change bitmaps, compacted per shard
        with the depth at each boundary and at every target start, in one
        readback per shard.  Used for the checkpoint writer, the regions
        report and plotting.
        """
        if self._events is not None:
            return self._events
        change = sharded_change(self.mesh, self.shards)
        offsets = np.asarray(self.layout.offsets[:-1], np.int64)
        idx, vals, offset_vals = _shard_compact(
            self.mesh, change, self.shards, self.pad_total, offsets
        )
        del change
        pos = np.concatenate([idx, offsets])
        allv = np.concatenate([vals, offset_vals])
        order = np.argsort(pos, kind="stable")
        pos, allv = pos[order], allv[order]

        def gather(all_idx: np.ndarray) -> np.ndarray:
            return allv[np.searchsorted(pos, all_idx)]

        self._events = events_from_change_indices(self.layout, idx, gather)
        return self._events

    def materialize_dict(self) -> dict[str, np.ndarray]:
        """Per-target per-base arrays (tests/oracles only — O(genome) host)."""
        flat = _host_all(self.mesh, self.shards)[: self.layout.total_slots]
        return depth_dict_from_flat(self.layout, flat)
