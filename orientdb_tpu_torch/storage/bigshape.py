"""Port of `orientdb_tpu/storage/bigshape.py`: the array-native Person–knows
snapshot (the SF100-shape bench graph) and its exact numpy references.

The same seed gives byte-identical arrays in both packages: the random
draws happen in the reference's order, and the CSR assembly is the
reference's. The returned database holds the schema only, so queries run
on the compiled path; parity comes from `numpy_1hop_count` /
`numpy_2hop_count` (exact int64 over the same arrays).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from orientdb_tpu_torch.models.database import Database
from orientdb_tpu_torch.storage.snapshot import (
    EdgeClassCSR,
    GraphSnapshot,
    PropertyColumn,
)


def _csr_from_degrees(
    name: str, degrees: np.ndarray, dst: np.ndarray
) -> EdgeClassCSR:
    """Both-direction CSR from per-vertex out-degrees and the dst array in
    out-CSR order: indptr from cumsum, stable in-direction sort, edge ids
    into out order."""
    V = degrees.shape[0]
    csr = EdgeClassCSR(name)
    csr.indptr_out = np.concatenate([[0], np.cumsum(degrees)]).astype(
        np.int32
    )
    csr.dst = dst.astype(np.int32)
    edge_src = np.repeat(np.arange(V, dtype=np.int32), degrees)
    order_in = np.argsort(dst, kind="stable")
    csr.src = edge_src[order_in].astype(np.int32)
    csr.edge_id_in = order_in.astype(np.int32)
    counts_in = np.bincount(dst, minlength=V)
    csr.indptr_in = np.concatenate([[0], np.cumsum(counts_in)]).astype(
        np.int32
    )
    return csr


def build_person_knows(
    n_persons: int,
    avg_knows: int = 10,
    seed: int = 0,
    supernodes: int = 0,
    supernode_degree: int = 0,
    name: str = "bigshape",
    device=None,
) -> Tuple[Database, GraphSnapshot]:
    """A Person–knows graph as (schema-only Database, attached snapshot).

    Properties: ``uid`` (dense id) and ``age`` (18–79) on Person.
    ``supernodes`` plants that many vertices of out-degree
    ``supernode_degree`` on top of the Poisson base. ``device`` is the
    database's (the card unless the caller asks for the CPU)."""
    rng = np.random.default_rng(seed)
    db = Database(name, device=device)
    db.schema.create_vertex_class("Person")
    db.schema.create_edge_class("knows")

    V = int(n_persons)
    degrees = rng.poisson(avg_knows, V).astype(np.int64)
    if supernodes > 0:
        hubs = np.linspace(0, V - 1, supernodes, dtype=np.int64)
        degrees[hubs] = supernode_degree
    E = int(degrees.sum())
    dst = rng.integers(0, V, E, dtype=np.int64)
    csr = _csr_from_degrees("knows", degrees, dst)

    snap = GraphSnapshot()
    snap.num_vertices = V
    all_classes = sorted(db.schema.classes(), key=lambda c: c.name)
    snap.class_names = [c.name for c in all_classes]
    snap.class_id_of = {c.name.lower(): i for i, c in enumerate(all_classes)}
    snap.v_class = np.full(V, snap.class_id_of["person"], np.int32)
    for c in all_classes:
        closure = [
            snap.class_id_of[s.name.lower()]
            for s in c.subclasses(include_self=True)
        ]
        snap.class_closure[c.name.lower()] = np.array(sorted(closure), np.int32)
    for c in all_classes:
        if c.is_vertex_type and not c.abstract:
            snap.class_vertex_range[c.name.lower()] = (
                (0, V) if c.name == "Person" else (0, 0)
            )
    ones = np.ones(V, bool)
    snap.v_columns = {
        "uid": PropertyColumn(
            "uid", "int", np.arange(V, dtype=np.int32), ones
        ),
        "age": PropertyColumn(
            "age", "int", rng.integers(18, 80, V, dtype=np.int32), ones
        ),
    }
    snap.edge_classes["knows"] = csr
    for c in all_classes:
        if c.is_edge_type:
            snap.edge_closure[c.name.lower()] = sorted(
                s.name
                for s in c.subclasses(include_self=True)
                if s.name in snap.edge_classes
            )
    db.attach_snapshot(snap)
    return db, snap


def _seg_sum(vals: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    tot = np.concatenate([[0], np.cumsum(vals, dtype=np.int64)])
    return tot[indptr[1:].astype(np.int64)] - tot[indptr[:-1].astype(np.int64)]


def numpy_1hop_count(snap: GraphSnapshot, src_mask, dst_mask) -> int:
    """count of (p, f) pairs with src_mask[p] and dst_mask[f]."""
    csr = snap.edge_classes["knows"]
    w1 = _seg_sum(dst_mask[csr.dst].astype(np.int64), csr.indptr_out)
    return int((w1 * src_mask.astype(np.int64)).sum())


def numpy_2hop_count(snap: GraphSnapshot, src_mask, mid_mask, dst_mask) -> int:
    """count of (p, f, g) paths with the three masks applied."""
    csr = snap.edge_classes["knows"]
    w2 = _seg_sum(dst_mask[csr.dst].astype(np.int64), csr.indptr_out)
    w1 = _seg_sum((mid_mask[csr.dst] * w2[csr.dst]).astype(np.int64), csr.indptr_out)
    return int((w1 * src_mask.astype(np.int64)).sum())
