"""The port's counterpart of ``shard_map`` and the ``lax`` collectives its
bodies use (``psum``, ``all_gather``, ``psum_scatter``, ``axis_index``), in
the role of `orientdb_tpu/parallel/shard_compat.py`: a mesh is a shard
group, and every sharded tensor has a leading axis over the shards this
process holds.

- `LocalShards`: all S shards in one process on one device (the card, or
  the CPU). A per-shard kernel launches once over every shard, and the
  merge a collective does in the reference is the kernels' shared output,
  since every merge of the mesh is exact: disjoint rows at each shard's
  global offset (the expansion), 1s into one bitmap (the hops, the BFS),
  integer atomics into one vector (the weight passes). The collectives
  below are identities.
- `ProcessShards`: one shard a rank of a ``torch.distributed`` process
  group (NCCL on cards, gloo on the CPU). The same kernels run at one
  local shard into a zeroed private buffer, and the collectives merge:
  ``all_reduce`` (SUM) for the expansion's shifted rows, the int8 bitmap
  contributions and the weights, ``all_gather_into_tensor`` for the [S]
  totals, ``reduce_scatter_tensor`` for the BFS.

Neither catches a collective's failure or carries on without one.
"""

from __future__ import annotations

import numpy as np
import torch


class LocalShards:
    """Every shard of an S-shard mesh in this process, on ``device``;
    ``replicas`` splits a BFS's queries into blocks."""

    #: whether the shards' results merge through collectives (else the
    #: kernels' shared output is the merge, and plans capture)
    collective = False

    def __init__(self, n_shards: int, replicas: int, device: torch.device) -> None:
        if n_shards < 1 or replicas < 1:
            raise ValueError("a mesh needs at least one shard and one replica")
        self.n_shards = int(n_shards)
        self.replicas = int(replicas)
        self.device = device
        #: the first shard held here, and how many
        self.s0 = 0
        self.n_local = self.n_shards

    def __repr__(self) -> str:
        return f"LocalShards(shards={self.n_shards}, replicas={self.replicas}, device={self.device})"

    def local_rows(self, host: np.ndarray) -> np.ndarray:
        """The rows of a host [S, ...] array held here."""
        return host[self.s0 : self.s0 + self.n_local]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[n_local * k] → [S * k]: every shard's values."""
        return t

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the shards, in place."""
        return t

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """[S, ...] contributions → the [n_local, ...] sum of the rows held."""
        return t


class ProcessShards(LocalShards):
    """One shard a rank of ``group`` (a ``torch.distributed`` group, the
    default one when None); the rank's device is ``device``. Its plans
    replay without capture."""

    collective = True

    def __init__(self, group, replicas: int, device: torch.device) -> None:
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        super().__init__(dist.get_world_size(group), replicas, device)
        self.s0 = dist.get_rank(group)
        self.n_local = 1

    def __repr__(self) -> str:
        return (
            f"ProcessShards(shards={self.n_shards}, rank={self.s0}, "
            f"replicas={self.replicas}, device={self.device})"
        )

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape[0] * self.n_shards, dtype=t.dtype, device=t.device)
        self._dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        return out

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        self._dist.all_reduce(t, op=self._dist.ReduceOp.SUM, group=self.group)
        return t

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty((1,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        self._dist.reduce_scatter_tensor(
            out, t.contiguous(), op=self._dist.ReduceOp.SUM, group=self.group
        )
        return out
