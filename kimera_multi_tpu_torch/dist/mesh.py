"""Robot groups over torch.distributed (the JAX package's dist/mesh.py).

The JAX package maps robots onto a (robots, shard) device mesh and lets
`shard_map` collectives run over its axes. Here a `RobotGroup` is a
torch.distributed process group whose ranks each own a contiguous block
of the fleet's robots: rank k owns robots [k R / W, (k + 1) R / W) for R
robots and W ranks. (The pod tier's group, dist/dcn.py's `FabricGroup`,
keeps the same interface over the TCP fabric, with the pods' r % P
layout.) Every collective of the distributed back-end goes
through it (`all_gather`, `all_reduce`), also on a group of one rank, and
it counts the bytes each collective delivers to this rank (the
reference's mTotalBytesReceived), with the per-op accounting of the JAX
package's `measured_round_comm_bytes`.

`robot_group(n_robots, device)` takes the default process group when one
is initialised. Otherwise it makes one, which `close()` destroys again:
from the environment under a launcher such as `torchrun` (one rank a
card, or gloo ranks on the CPU), else a one-rank group inside the
process. NCCL for a CUDA device, gloo for the CPU.
"""

from __future__ import annotations

import os
import warnings

import torch
import torch.distributed as dist


class RobotGroup:
    """A process group and the robots this rank owns: by default the
    contiguous block [k R / W, (k + 1) R / W) of rank k, or `owned` (in
    increasing order) for another layout."""

    def __init__(self, rank: int, world: int, n_robots: int, device,
                 pg=None, owns_pg: bool = False, owned=None):
        if owned is None:
            if n_robots % world:
                raise ValueError(f"{world} ranks do not divide {n_robots} "
                                 "robots")
            per = n_robots // world
            owned = range(rank * per, (rank + 1) * per)
        self.rank, self.world, self.n_robots = rank, world, n_robots
        self.device = torch.device(device)
        self.owned = list(owned)
        self.pg = pg
        self._owns_pg = owns_pg
        self.received = 0.0  # bytes delivered to this rank by collectives

    def _count(self, nbytes: float) -> None:
        self.received += nbytes

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` concatenated along axis 0 in rank order (the
        JAX package's tiled `all_gather`): with one part a robot on axis
        0, the fleet's parts in robot order. Counts (W - 1) / W of the
        output's bytes as received."""
        t = t.contiguous()
        out = torch.empty((self.world * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        with warnings.catch_warnings():
            # deprecated in favour of all_gather_single since torch 2.12,
            # which older releases lack
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, t, group=self.pg)
        self._count(out.numel() * out.element_size()
                    * (self.world - 1) / self.world)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's `t` (the JAX package's `psum`), as a new
        tensor. Counts 2 (W - 1) / W of its bytes as received (ring)."""
        out = t.clone().contiguous()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.pg)
        self._count(2 * out.numel() * out.element_size()
                    * (self.world - 1) / self.world)
        return out

    def close(self) -> None:
        """Destroy the process group if this object created it."""
        if self._owns_pg and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_pg = False

    def __enter__(self) -> "RobotGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def robot_group(n_robots: int, device) -> RobotGroup:
    """The robot group of this process, on `device` (cuda:LOCAL_RANK for a
    CUDA device without an index). Over the default process group when
    one is initialised; else over one made here, which the group's
    `close()` destroys: from the environment (`init_method="env://"`)
    when a launcher such as torchrun has set WORLD_SIZE, or one rank in
    this process. NCCL on a CUDA device, gloo on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", torch.cuda.current_device())))
    if dist.is_initialized():
        return RobotGroup(dist.get_rank(), dist.get_world_size(), n_robots,
                          device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method="env://",
                                device_id=device if cuda else None)
    else:
        dist.init_process_group("nccl" if cuda else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1,
                                device_id=device if cuda else None)
    return RobotGroup(dist.get_rank(), dist.get_world_size(), n_robots,
                      device, owns_pg=True)
