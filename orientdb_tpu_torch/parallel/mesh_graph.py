"""Port of `orientdb_tpu/parallel/mesh_graph.py`: the sharded adjacency of
a snapshot attached with a mesh, and the engine's mesh kernels.

The layout is the reference's, array for array and byte for byte
(`MeshGraph.build`), under the same keys of the device graph's ``arrays``:

- ``sh:rowspan`` [S, 2]: shard s owns vertex rows ``[s·R, (s+1)·R)``;
- ``sh:<class>:out:{indptr,nbr,ebase}``: the out-CSR row-sharded, indptr
  rows rebased ([S, R+1]), neighbours -1 padded to the largest shard's
  edges ([S, emax]), each shard's first global edge ([S, 1]);
- ``sh:<class>:in:{indptr,nbr,ebase,eid}``: the in-CSR alike, with the
  out-order edge id of each in-CSR slot;
- ``sh:<class>:el:{src,dst,eid}``: the flat edge list in equal slices of W
  = ``ceil(E / S)`` edges ([S, W], -1 tails), read by `edge_endpoint`.

A device holds the rows of the shards its process holds (all S with
`LocalShards`, one with `ProcessShards`). The kernels: `expand_totals`
(K2's range form), `expand_gather` (K22 `shard_gather`),
`sharded_bitmap_hop` (K10's eid form, a push over the row-sharded CSR) and
`sharded_weight_pass` (K23, a segmented sum over it), each merged as the
group merges
(`parallel/collectives`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.parallel.collectives import LocalShards

I32 = torch.int32


def shard_rows(indptr: np.ndarray, n_shards: int, rows: int):
    """A global CSR's rows split into per-shard locally rebased indptr rows
    ``[S, R+1]`` (a shard past V repeats its last value, or 0), with each
    shard's first edge and edge range in the global order."""
    V = indptr.shape[0] - 1
    ind_l = np.zeros((n_shards, rows + 1), np.int64)
    bases = np.zeros(n_shards, np.int32)
    slices = []
    for s in range(n_shards):
        r0 = min(s * rows, V)
        r1 = min(r0 + rows, V)
        seg = indptr[r0 : r1 + 1].astype(np.int64) - int(indptr[r0])
        ind_l[s, : seg.shape[0]] = seg
        if seg.shape[0] < rows + 1:
            ind_l[s, seg.shape[0] :] = seg[-1] if seg.shape[0] else 0
        bases[s] = int(indptr[r0])
        slices.append((int(indptr[r0]), int(indptr[r1])))
    return ind_l.astype(np.int32), bases, slices


class ShardedEdgeArrays:
    """Host metadata for one edge class's sharded adjacency (the arrays
    live in the device graph's ``arrays``)."""

    __slots__ = ("class_name", "prefix", "e_slice", "out_emax", "in_emax")

    def __init__(self, class_name: str, prefix: str):
        self.class_name = class_name
        self.prefix = prefix
        self.e_slice = 0  # edge-list slice width per shard
        self.out_emax = 0  # max local out-CSR edges across shards
        self.in_emax = 0


class MeshGraph:
    """The sharding context of a device graph."""

    def __init__(self, mesh: LocalShards) -> None:
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        self.rows_per_shard = 0
        self.edge: Dict[str, ShardedEdgeArrays] = {}

    def build(self, dg, snap) -> None:
        """Put the sharded adjacency of every edge class of ``snap`` into
        ``dg.arrays``."""
        S = self.n_shards
        V = dg.num_vertices
        R = self.rows_per_shard = max(1, math.ceil(max(V, 1) / S))
        spans = np.stack(
            [np.arange(S, dtype=np.int32) * R, (np.arange(S, dtype=np.int32) + 1) * R], axis=1
        )
        self._put(dg, "sh:rowspan", spans)
        for name, csr in snap.edge_classes.items():
            sea = ShardedEdgeArrays(name, f"sh:{name}")
            self.edge[name] = sea
            self._put_csr(dg, sea, "out", csr.indptr_out, csr.dst, eid_map=None)
            self._put_csr(dg, sea, "in", csr.indptr_in, csr.src, eid_map=csr.edge_id_in)
            self._put_edge_list(dg, sea, csr)

    def _put(self, dg, key: str, host: np.ndarray) -> None:
        dg._put(key, np.ascontiguousarray(self.mesh.local_rows(host)))

    def _put_csr(self, dg, sea, tag, indptr, nbrs, eid_map) -> None:
        S = self.n_shards
        ind_l, bases, slices = shard_rows(indptr, S, self.rows_per_shard)
        emax = max(1, max((b - a) for a, b in slices))
        nbr_l = np.full((S, emax), -1, np.int32)
        eid_l = np.full((S, emax), -1, np.int32) if eid_map is not None else None
        for s, (a, b) in enumerate(slices):
            nbr_l[s, : b - a] = nbrs[a:b]
            if eid_l is not None:
                eid_l[s, : b - a] = eid_map[a:b]
        p = sea.prefix
        self._put(dg, f"{p}:{tag}:indptr", ind_l)
        self._put(dg, f"{p}:{tag}:nbr", nbr_l)
        self._put(dg, f"{p}:{tag}:ebase", bases[:, None])
        if eid_l is not None:
            self._put(dg, f"{p}:{tag}:eid", eid_l)
        if tag == "out":
            sea.out_emax = emax
        else:
            sea.in_emax = emax

    def _put_edge_list(self, dg, sea, csr) -> None:
        """Equal edge-range slices for the edge-parallel kernels."""
        S = self.n_shards
        E = csr.num_edges
        W = sea.e_slice = max(1, math.ceil(max(E, 1) / S))
        src_l = np.full((S, W), -1, np.int32)
        dst_l = np.full((S, W), -1, np.int32)
        eid_l = np.full((S, W), -1, np.int32)
        edge_src = csr.edge_src
        for s in range(S):
            a, b = min(s * W, E), min((s + 1) * W, E)
            src_l[s, : b - a] = edge_src[a:b]
            dst_l[s, : b - a] = csr.dst[a:b]
            eid_l[s, : b - a] = np.arange(a, b, dtype=np.int32)
        p = sea.prefix
        self._put(dg, f"{p}:el:src", src_l)
        self._put(dg, f"{p}:el:dst", dst_l)
        self._put(dg, f"{p}:el:eid", eid_l)


def _merge_dtype(mesh: LocalShards):
    """Element type of a process group's 0/1 bitmap contributions: int8
    sums stay exact up to 127 shards."""
    return torch.int8 if mesh.n_shards <= 127 else I32


def merge_bits(mesh: LocalShards, contrib: torch.Tensor, scatter: bool = False) -> torch.Tensor:
    """A process group's OR of bool contributions: their sum in
    `_merge_dtype`, then > 0; with ``scatter`` the [S, ...] contributions
    reduce-scatter to this rank's [1, ...] rows."""
    dt = _merge_dtype(mesh)
    part = contrib.view(dt) if dt == torch.int8 else contrib.to(dt)
    return (mesh.reduce_scatter(part) if scatter else mesh.all_reduce_(part)) > 0


def expand_totals(mesh: LocalShards, ind_sh, span_sh, srcs) -> torch.Tensor:
    """Per-shard expansion totals, int32 [S]: each shard sums the out-
    degrees of the sources inside its ``sh:rowspan`` range (K2's range
    form), gathered over the group."""
    _counts, tots = K.degree_counts_range(ind_sh, span_sh, srcs)
    return mesh.all_gather(tots)


def expand_gather(
    mesh: LocalShards, ind_sh, nbr_sh, extra_sh, span_sh, srcs, cap: int, cap_total: int,
    is_out: bool,
):
    """The sharded CSR expansion (K22): every shard expands its owned
    sources into at most ``cap`` rows, front-packed at its global offset in
    the ``[cap_total]`` segment (shard-major order, -1 padding). ``extra_sh``
    is ``:out:ebase`` (edge id = local position + base) or ``:in:eid``.
    Returns (row, eid, nbr) int32 [cap_total]."""
    counts, tots = K.degree_counts_range(ind_sh, span_sh, srcs)
    tots_all = mesh.all_gather(tots)
    offsets = K.exclusive_cumsum(counts.view(-1))
    process = mesh.collective
    row, eid, nbr = K.shard_gather(
        ind_sh, nbr_sh, extra_sh, span_sh, srcs, offsets, tots_all, mesh.s0, cap, cap_total,
        is_out, plus_one=process,
    )
    if process:
        merged = mesh.all_reduce_(torch.stack([row, eid, nbr])) - 1
        row, eid, nbr = merged[0], merged[1], merged[2]
    return row, eid, nbr


def sharded_bitmap_hop(
    mesh: LocalShards, ind_sh, nbr_sh, extra_sh, is_out: bool, emask, frontier, gate=None,
    alive=None, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One frontier hop over the row-sharded CSR of a direction (K10's eid
    form): each shard held walks the rows of its active vertices
    (``ind_sh`` / ``nbr_sh`` the ``:out:`` or ``:in:`` indptr and
    neighbours, ``extra_sh`` ``:out:ebase`` or ``:in:eid``), and the shards'
    activations OR into one ``[C, vb]`` bitmap (``out`` when given).
    ``emask`` (bool [E] in out order, or None) is read through the edge
    ids; ``gate`` and ``alive`` as for `bitmap_hop`. The reference walks
    the edge-list slices instead; both reach the same bits."""
    hop = lambda o: K.bitmap_hop_shard(  # noqa: E731
        ind_sh, nbr_sh, extra_sh, is_out, mesh.s0, emask, frontier, gate, alive, o
    )
    if not mesh.collective:
        return hop(out)
    merged = merge_bits(mesh, hop(None))
    if out is None:
        return merged
    out |= merged
    return out


def sharded_weight_pass(
    mesh: LocalShards, ind_sh, nbr_sh, extra_sh, is_out: bool, emask, ok, w,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One COUNT-pushdown weight pass over the row-sharded CSR of a
    direction (K23): ``new_w[v] += Σ emask(e)·ok(u)·w[u]`` over the edges
    of each held row v (``ind_sh`` / ``nbr_sh`` the ``:out:`` or ``:in:``
    indptr and neighbours, ``extra_sh`` ``:out:ebase`` or ``:in:eid``: an
    out pass sums at the source and weighs the target, an in pass the
    reverse), added into ``out`` (a new zero vector of ``w``'s dtype when
    None; ``w`` None weighs 1 and ``ok`` None keeps every vertex, with
    ``out`` given). The reference sums over the edge-list slices instead;
    both reach the same sums. On a process group each rank sums its own
    rows, and the parts merge by an all-reduce."""
    if out is None:
        out = torch.zeros_like(w)
    pass_ = lambda o: K.shard_weight_pass(  # noqa: E731
        ind_sh, nbr_sh, extra_sh, is_out, mesh.s0, emask, ok, w, o
    )
    if not mesh.collective:
        return pass_(out)
    out += mesh.all_reduce_(pass_(torch.zeros_like(out)))
    return out


def edge_endpoint(mesh: LocalShards, el_sh, eid) -> torch.Tensor:
    """An endpoint by global edge id from a sharded edge-list array
    (``el:src`` or ``el:dst``, [S_l, W]): the slices are equal edge ranges,
    so shard s's row holds edges ``[s·W, (s+1)·W)`` and the [S, W] array
    read flat is indexed by the edge id. On a process group each rank reads
    the ids in its range and the ranks' values merge (shifted by one, 0
    elsewhere); ``eid`` -1 reads -1."""
    if not mesh.collective:
        return K.take_pad(el_sh.view(-1), eid, -1)
    W = el_sh.shape[1]
    local = eid - mesh.s0 * W
    mine = (eid >= 0) & (local >= 0) & (local < W)
    part = torch.where(mine, K.take_pad(el_sh.view(-1), torch.where(mine, local, -1), -1) + 1, 0)
    return mesh.all_reduce_(part.to(I32)) - 1
