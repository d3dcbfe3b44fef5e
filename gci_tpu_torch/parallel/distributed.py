"""Multi-process runtime (counterpart of ``gci_tpu.parallel.distributed``).

Each process packs a disjoint shard of the alignment data (reads are
embarrassingly parallel), the mesh positions accumulate partial depth
deltas, and a sum over ``dp`` merges them: only that sum crosses processes
when ``dp`` spans them.  The process group is ``torch.distributed``'s:
``init_multihost`` starts it over ``tcp://HOST:PORT`` (NCCL for a mesh on
CUDA, gloo on the CPU), and host arrays always travel through a gloo group,
whatever the device backend is.  Without it every run is one process, and
that process writes the outputs.

Shard assignment and record-range splitting are pure; the collectives are
thin wrappers over ``torch.distributed``.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

# how long a process waits for its peers at start-up and in a host
# collective before it fails: a dead peer must not hang a run for torch's
# 30-minute default
INIT_TIMEOUT = datetime.timedelta(minutes=5)

_host_group = None  # the gloo group of host arrays, set up with the process group


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout: datetime.timedelta = INIT_TIMEOUT,
) -> None:
    """Start the process group (no-op on single-process runs).

    ``coordinator_address`` is ``HOST:PORT`` of process 0 (``tcp://``
    rendezvous).  With no arguments and ``MASTER_ADDR`` set, the group
    starts from the environment (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), the counterpart of
    ``jax.distributed.initialize`` reading its cluster environment.
    ``backend`` defaults to NCCL where CUDA is available, else gloo.
    """
    if num_processes in (None, 1) and coordinator_address is None and (
        "MASTER_ADDR" not in os.environ
    ):
        return
    global _host_group
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_method = (f"tcp://{coordinator_address}" if coordinator_address is not None
                   else "env://")
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=init_method, timeout=timeout, **kwargs)
    _host_group = (dist.group.WORLD if backend == "gloo"
                   else dist.new_group(backend="gloo", timeout=timeout))


def shutdown_multihost() -> None:
    """Destroy the process group, if one was started (every process calls it)."""
    global _host_group
    if _active():
        dist.destroy_process_group()
    _host_group = None


def host_group():
    """The gloo group that carries host arrays (created on first use when the
    process group was started by someone other than ``init_multihost``)."""
    global _host_group
    if _host_group is None:
        _host_group = (dist.group.WORLD if dist.get_backend() == "gloo"
                       else dist.new_group(backend="gloo"))
    return _host_group


@dataclass(frozen=True)
class HostShard:
    """This process's slice of the input work."""

    process_index: int
    process_count: int

    def files(self, paths: list[str]) -> list[str]:
        """Round-robin file assignment (whole files stay on one host)."""
        return [p for i, p in enumerate(paths) if i % self.process_count == self.process_index]

    def record_range(self, n_records: int) -> tuple[int, int]:
        """Contiguous [start, stop) record range for one shared file."""
        per = -(-n_records // self.process_count)
        start = min(self.process_index * per, n_records)
        return start, min(start + per, n_records)


def process_count() -> int:
    return dist.get_world_size() if _active() else 1


def process_index() -> int:
    return dist.get_rank() if _active() else 0


def current_host_shard() -> HostShard:
    return HostShard(process_index(), process_count())


def owned_dp_rows(mesh, n_rows: int) -> tuple[int, int]:
    """Contiguous [lo, hi) range of a dp-split row axis owned by this process.

    This is the per-host input shard: each process packs only the read
    records whose dp rows hold one of its own positions; the dp sum that
    merges the partial depth deltas is then the only cross-process traffic.
    ``n_rows`` must be a multiple of the mesh's dp size.
    """
    dp = mesh.shape["dp"]
    chunk = n_rows // dp
    me = process_index()
    owned = sorted({int(d) for d, _ in zip(*np.nonzero(mesh.processes == me))})
    if not owned:
        return (0, 0)
    if owned != list(range(owned[0], owned[-1] + 1)):
        raise ValueError("dp rows owned by one process must be contiguous")
    return owned[0] * chunk, (owned[-1] + 1) * chunk


def input_comp_range(path: str) -> tuple[int, int]:
    """This process's compressed byte range of a shared BAM file.

    The file's compressed bytes are cut into ``process_count`` equal ranges;
    ``BamStream(comp_range=...)`` turns a range into exactly the records
    whose first byte lies in a BGZF block starting inside it, so the ranges
    partition the record stream with no overlap or loss and each process
    inflates and parses only ~1/H of the file.
    """
    fsize = os.path.getsize(path)
    h, H = process_index(), process_count()
    lo = fsize * h // H
    hi = fsize * (h + 1) // H if h < H - 1 else fsize
    return lo, hi


def allgather_concat(arrays: list) -> list[np.ndarray]:
    """Concatenate per-process row arrays across processes in process order.

    Host-side variable-length allgather (pad to the global max, gather,
    trim) of raw bytes, so every dtype travels exactly: the name keys are
    pairs of uint64, which torch's collectives do not carry.  Used to
    reconcile each process's packed-record shard into the file-ordered
    global list before name-keyed dedup and curation.  Every process must
    call it with the same number of arrays, each with the same row count.
    """
    group = host_group()
    P = process_count()
    n_local = int(arrays[0].shape[0])
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(P)]
    dist.all_gather(lens, torch.tensor([n_local], dtype=torch.int64), group=group)
    lens = [int(x) for x in lens]
    m = max(lens)
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        trailing = a.shape[1:]
        row_bytes = a.dtype.itemsize * int(np.prod(trailing, dtype=np.int64))
        if m == 0 or row_bytes == 0:
            out.append(a[:0])
            continue
        b = np.zeros((m, row_bytes), dtype=np.uint8)
        b[:n_local] = a.view(np.uint8).reshape(n_local, row_bytes)
        parts = [torch.empty((m, row_bytes), dtype=torch.uint8) for _ in range(P)]
        dist.all_gather(parts, torch.from_numpy(b), group=group)
        cat = np.concatenate([p.numpy()[:n] for p, n in zip(parts, lens)])
        out.append(np.ascontiguousarray(cat).view(a.dtype).reshape((-1,) + trailing))
    return out


def broadcast_flag(flag: bool) -> bool:
    """Process 0's ``flag`` on every process."""
    t = torch.tensor([int(flag)], dtype=torch.uint8)
    dist.broadcast(t, src=0, group=host_group())
    return bool(t.item())


def is_primary_host() -> bool:
    """True on the process that owns file writes (process 0).

    On a multi-process run every process executes the full pipeline (the
    collectives need all of them), but exactly one writes the output files;
    the reference's single-writer file semantics (GCI.py:99-143 etc.) are
    kept.  Always True single-process.
    """
    return process_index() == 0
