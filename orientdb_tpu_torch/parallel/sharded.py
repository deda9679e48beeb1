"""Port of `orientdb_tpu/parallel/sharded.py`: the mesh constructor, the
host assembly of a sharded result, the row-sharded out-CSR and the row-
sharded multi-source BFS.

A mesh of S shards holds vertex rows ``[s·R, (s+1)·R)`` on shard s (R =
``ceil(V / S)``). The BFS state is vertex-sharded as in the reference:
shard s carries its ``[Q, R]`` slice of the frontier and of the visited
set, laid out ``[S_l, Q, R]`` over the shards held here. A hop is K24
`rowshard_hop` (each lit row's edges set their targets' bits in a
``[S, Q, R]`` contribution), merged by the group's reduce-scatter (an
identity in one process, where the contribution is the merged frontier
already), then K12 `frontier_advance` (``nxt &= ~visited; visited |=
nxt``, with the live count). The loop ends at ``max_depth`` hops or when no
shard has a live frontier; the live count is read on the host once a hop
(this function is not captured). ``replicas`` splits the queries into
blocks, each its own BFS.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.parallel.collectives import LocalShards, ProcessShards
from orientdb_tpu_torch.parallel.mesh_graph import merge_bits, shard_rows


def make_mesh(n_shards: int, replicas: int = 1, device=None, group=None) -> LocalShards:
    """A mesh of ``n_shards`` shards (the reference's ``(replicas,
    shards)`` mesh and `provision_devices`' role). Without ``group`` every
    shard lives in this process on ``device`` (`LocalShards`; None means the
    card, through `resolve_device`); with a ``torch.distributed`` group each
    rank holds one shard (`ProcessShards`) and ``n_shards`` must equal the
    group's size."""
    from orientdb_tpu_torch.models.database import resolve_device

    dev = resolve_device(device)
    if group is None:
        return LocalShards(n_shards, replicas, dev)
    mesh = ProcessShards(group, replicas, dev)
    if mesh.n_shards != n_shards:
        raise ValueError(f"a {n_shards}-shard mesh over a group of {mesh.n_shards} ranks")
    return mesh


def fetch_sharded(mesh: LocalShards, t: torch.Tensor) -> np.ndarray:
    """Host assembly of a sharded [S_l, ...] result: every shard's rows
    gathered (a collective on a process group), as one [S, ...] array."""
    if mesh.collective:
        flat = mesh.all_gather(t.reshape(-1))
        t = flat.view((mesh.n_shards,) + tuple(t.shape[1:]))
    return t.cpu().numpy()


class ShardedCSR:
    """One edge class's out-CSR, row-sharded by vertex range: locally
    rebased ``indptr`` [S_l, R+1] and ``dst`` [S_l, e_max] (-1 padded) on
    the mesh's device, the rows of the shards held here."""

    def __init__(self, mesh: LocalShards, indptr: np.ndarray, dst: np.ndarray):
        self.mesh = mesh
        S = mesh.n_shards
        V = int(indptr.shape[0]) - 1
        rows = max(1, math.ceil(V / S))
        self.num_vertices = V
        self.rows_per_shard = rows
        self.padded_vertices = rows * S
        ind_l, _bases, slices = shard_rows(np.asarray(indptr), S, rows)
        e_max = max(max(b - a for a, b in slices), 1)
        dst_l = np.full((S, e_max), -1, np.int32)
        for s, (a, b) in enumerate(slices):
            dst_l[s, : b - a] = dst[a:b]
        self.host_indptr, self.host_dst = ind_l, dst_l
        self.indptr = _put(mesh, ind_l)
        self.dst = _put(mesh, dst_l)

    @classmethod
    def from_snapshot(cls, snap, mesh: LocalShards, edge_class: str) -> "ShardedCSR":
        csr = snap.edge_classes[edge_class]
        return cls(mesh, csr.indptr_out, csr.dst)


def _put(mesh: LocalShards, host: np.ndarray) -> torch.Tensor:
    """The rows of a host [S, ...] array held here, on the mesh's device."""
    return torch.from_numpy(np.ascontiguousarray(mesh.local_rows(host))).to(mesh.device)


def bfs_reachability(scsr: ShardedCSR, roots: np.ndarray, max_depth: int) -> np.ndarray:
    """Multi-source BFS closure: roots [Q, V] bool → visited [Q, V] bool,
    the roots included at depth 0 (``max_depth`` 0 returns them); the loop
    ends early once no shard has a live frontier."""
    mesh = scsr.mesh
    S, R = mesh.n_shards, scsr.rows_per_shard
    Q = roots.shape[0]
    reps = mesh.replicas
    qb = max(1, math.ceil(Q / reps))
    fr = np.zeros((qb * reps, scsr.padded_vertices), bool)
    fr[:Q, : roots.shape[1]] = roots
    out = np.zeros((qb * reps, scsr.padded_vertices), bool)
    for rep in range(reps):
        block = fr[rep * qb : (rep + 1) * qb]
        # [Q, S·R] → [S, Q, R]: each shard's slice of every query's row
        sliced = np.ascontiguousarray(block.reshape(qb, S, R).transpose(1, 0, 2))
        visited = _put(mesh, sliced)
        out[rep * qb : (rep + 1) * qb] = _bfs_block(scsr, visited, max_depth)
    return out[:Q, : scsr.num_vertices]


def _bfs_block(scsr: ShardedCSR, visited: torch.Tensor, max_depth: int) -> np.ndarray:
    mesh = scsr.mesh
    S_l, Q, R = visited.shape
    frontier = visited.clone()
    live = int(mesh.all_reduce_(K.mask_count(frontier.view(-1)).view(1))[0])
    depth = 0
    while depth < max_depth and live > 0:
        contrib = K.rowshard_hop(scsr.indptr, scsr.dst, frontier, mesh.n_shards)
        if mesh.collective:
            contrib = merge_bits(mesh, contrib, scatter=True)
        frontier = contrib
        n = K.frontier_advance(frontier.view(S_l * Q, R), visited.view(S_l * Q, R))
        live = int(mesh.all_reduce_(n.view(1))[0])
        depth += 1
    host = fetch_sharded(mesh, visited)  # [S, Q, R]
    return host.transpose(1, 0, 2).reshape(Q, mesh.n_shards * R)
