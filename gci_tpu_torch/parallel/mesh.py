"""Mesh of (dp, gp) positions (counterpart of ``gci_tpu.parallel.mesh``).

The engine's parallel axes, as in ``gci_tpu``:

* ``dp`` — data parallelism over the *reads* axis: each position scatters
  its read shard's depth deltas; the partials merge with a sum over dp.
* ``gp`` — genome-coordinate parallelism: the concatenated per-base axis is
  cut into gp shards, each scanned on its own and stitched at the borders.

A position is a torch device and the process that owns it.  Positions are
laid out process-major, then row-major over (dp, gp), as ``jax.devices()``
orders them: with 2 processes of 4 positions and mesh 2,4, process 0 owns
dp row 0.  A device may stand at several positions (the CPU tests put 8 on
``cpu``, the card's smoke run 4 on ``cuda:0``); that exercises the sharded
programs and their launches on each shard, not several cards.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed

from gci_tpu_torch.parallel import distributed

_DEVICE_TYPES = ("cpu", "cuda")


class Mesh:
    """(dp, gp) grid of positions: ``devices`` (object array of
    ``torch.device``) and ``processes`` (int array of owning process)."""

    def __init__(self, devices: np.ndarray, processes: np.ndarray):
        self.devices = devices
        self.processes = processes
        self._me = distributed.process_index()
        self._groups = self._dp_groups() if distributed.process_count() > 1 else {}

    @property
    def shape(self) -> dict[str, int]:
        dp, gp = self.devices.shape
        return {"dp": dp, "gp": gp}

    def local_positions(self, g: int) -> list[tuple[int, torch.device]]:
        """(dp row, device) of this process's positions in gp column g."""
        return [(d, self.devices[d, g]) for d in range(self.shape["dp"])
                if self.processes[d, g] == self._me]

    def local_gp(self) -> list[int]:
        """The gp shards this process holds (one copy each, on the device of
        its first position in that column)."""
        return [g for g in range(self.shape["gp"]) if self.local_positions(g)]

    def shard_device(self, g: int) -> torch.device:
        return self.local_positions(g)[0][1]

    def local_device_type(self) -> str | None:
        types = {self.devices[d, g].type
                 for d, g in zip(*np.nonzero(self.processes == self._me))}
        if len(types) > 1:
            raise ValueError(f"this process's mesh positions mix device types {sorted(types)}")
        return types.pop() if types else None

    def dp_group(self, g: int):
        """Process group of the dp sum of gp shard g, or None where this
        process is its only holder (no collective needed)."""
        return self._groups.get(g)

    def _dp_groups(self) -> dict:
        """Groups of the processes holding each gp column.  Every process
        creates every group in the same order (``new_group`` is collective);
        a column held by all processes uses the whole group, one held by a
        single process needs none."""
        world = distributed.process_count()
        cpu = self.devices.flat[0].type == "cpu"
        made: dict[tuple[int, ...], object] = {}
        out = {}
        for g in range(self.shape["gp"]):
            members = tuple(sorted({int(p) for p in self.processes[:, g]}))
            if len(members) == 1:
                continue
            if members not in made:
                if len(members) == world:
                    made[members] = (distributed.host_group() if cpu
                                     else torch.distributed.group.WORLD)
                else:
                    made[members] = torch.distributed.new_group(
                        list(members), backend="gloo" if cpu else None)
            if self._me in members:
                out[g] = made[members]
        return out


def cuda_devices() -> list[torch.device]:
    """Each CUDA device of this process, once."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _global_positions(local: list[torch.device]) -> list[tuple[torch.device, int]]:
    """Every process's positions, process-major: (device, process)."""
    if distributed.process_count() == 1:
        return [(dev, 0) for dev in local]
    codes = np.asarray(
        [(distributed.process_index(), _DEVICE_TYPES.index(dev.type),
          -1 if dev.index is None else dev.index) for dev in local],
        dtype=np.int64,
    ).reshape(-1, 3)
    (codes,) = distributed.allgather_concat([codes])
    return [(torch.device(_DEVICE_TYPES[t]) if i < 0 else torch.device(_DEVICE_TYPES[t], i),
             int(p)) for p, t, i in codes]


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              devices: list[torch.device] | None = None) -> Mesh:
    """Build a (dp, gp) mesh over the first ``n_devices`` positions.

    ``devices`` are this process's positions (default: its CUDA devices,
    each once); a device may repeat.  On a multi-process run every process
    calls this together.  With ``dp`` unset, genome-axis parallelism is
    favoured and dp absorbs the rest (``gci_tpu.parallel.mesh.make_mesh``).
    Raises ValueError when the positions cannot fill the mesh.
    """
    local = cuda_devices() if devices is None else [torch.device(d) for d in devices]
    positions = _global_positions(local)
    if not positions:
        raise ValueError("no device positions (this process has no CUDA device)")
    n = n_devices or len(positions)
    if n > len(positions):
        raise ValueError(f"a mesh of {n} positions needs more than the "
                         f"{len(positions)} available")
    if dp is None:
        gp = 1
        for cand in range(int(np.sqrt(n)), 0, -1):
            if n % cand == 0:
                gp = max(gp, n // cand)
        dp = n // gp
    else:
        gp = n // dp
    if dp * gp != n:
        raise ValueError(f"{n} positions do not form a mesh with dp={dp}")
    devs = np.empty(n, dtype=object)
    devs[:] = [dev for dev, _ in positions[:n]]
    procs = np.asarray([p for _, p in positions[:n]], dtype=np.int64)
    return Mesh(devs.reshape(dp, gp), procs.reshape(dp, gp))


def pad_to_multiple(x: np.ndarray, multiple: int, fill=0) -> np.ndarray:
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad = np.full((rem,) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)
