"""The device mesh: a (repl, shard) grid of torch devices in one process.

Counterpart of vectorsearch_rbac_tpu/parallel/mesh.py. The reference's
`Mesh` + `shard_map` is single-controller: one process drives every
device of a host. The port keeps that shape: a `Mesh` is a grid of
`torch.device`s, corpus rows shard over its `shard` axis, query batches
split over its `repl` axis, and `shard_map_compat` calls a function once
per cell on that cell's device. Processes come in only across hosts, over
torch.distributed (parallel/multihost.py), as the reference's only come in
with jax.distributed.

`make_mesh` defaults to the visible CUDA devices and raises when more are
asked for than exist. Several logical shards on one device
(`devices=["cuda:0"] * 4`, or `["cpu"] * 8` in the CPU tests) come only
from an explicit `devices=`: a mesh never doubles up on its own. Shards
that share a device share its stream, so their work runs one after
another there; nothing of the mesh syncs with the host between them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

SHARD_AXIS = "shard"   # corpus rows
REPL_AXIS = "repl"     # query batches, for throughput


class Mesh:
    """A (repl, shard) grid of devices; `shape` names the axes' sizes as
    the reference's mesh.shape does."""

    def __init__(self, grid: Sequence[Sequence]):
        rows = [[torch.device(d) for d in row] for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of "
                             "devices")
        self.devices: List[List[torch.device]] = rows
        self.shape = {REPL_AXIS: len(rows), SHARD_AXIS: len(rows[0])}

    def distinct_devices(self) -> List[torch.device]:
        """Each device of the grid once, in grid order."""
        out: List[torch.device] = []
        for row in self.devices:
            for d in row:
                if d not in out:
                    out.append(d)
        return out

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, {self.devices})"


def make_mesh(n_devices: Optional[int] = None, n_replicas: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (repl, shard) mesh over the first n_devices of `devices` (the
    visible CUDA devices when None), replica-major. Raises ValueError when
    more devices are asked for than there are, or when n_replicas does not
    divide them."""
    devs = ([torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            if devices is None else [torch.device(d) for d in devices])
    n = n_devices or len(devs)
    if n > len(devs) or n < 1:
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if n % n_replicas:
        raise ValueError("n_devices must divide by n_replicas")
    per = n // n_replicas
    return Mesh([devs[r * per:(r + 1) * per] for r in range(n_replicas)])


def shard_map_compat(fn: Callable, mesh: Mesh) -> Callable:
    """The port's shard_map: g(*args) calls fn(r, s, device, *args) for
    every (repl r, shard s) cell in grid order and returns the [r][s] grid
    of results. fn enqueues its work on `device` and returns without
    reading back, so the cells' work queues without a host sync between
    them."""
    def run(*args):
        return [[fn(r, s, dev, *args) for s, dev in enumerate(row)]
                for r, row in enumerate(mesh.devices)]
    return run
