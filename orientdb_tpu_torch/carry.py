"""Carry a snapshot's arrays across into the port: build a port `Database`
and `GraphSnapshot` from plain numpy arrays.

This is the port's counterpart of loading a model's weights: whoever holds
a graph in the reference's columnar layout (the reference package's own
snapshot, a file, a generator) hands its arrays over, and the port never
reads the other side's objects.

``schema_spec`` is a list of classes in creation order (superclasses
before subclasses), each ``{"name", "superclasses", "abstract"}``; a class
is a vertex or an edge class by descending from ``V`` or ``E``, which every
schema has. ``arrays`` holds:

- ``num_vertices``, ``v_class``, ``class_names``, ``class_id_of``,
  ``class_closure``, ``class_vertex_range``, ``edge_closure``;
- ``v_cluster`` / ``v_position`` (optional): each vertex's RID, from which
  the snapshot's ``rid_to_idx`` lookup is built (cluster -1 where a vertex
  has none; all -1 when absent);
- ``v_columns``: property name → ``{"kind", "values", "present",
  "dictionary"}``, and ``v_non_columnar`` (optional): the property names
  seen without a columnar encoding, which predicates must refuse;
- ``edge_classes``: class name → ``{"indptr_out", "dst", "indptr_in",
  "src", "edge_id_in"}``, and optionally ``"columns"`` (edge property name
  → a column as in ``v_columns``, indexed by edge id in out-CSR order),
  ``"non_columnar"`` (the edge property names without a columnar
  encoding) and ``"e_cluster"`` / ``"e_position"`` (each edge's RID by
  edge id, cluster -1 where it has none).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from orientdb_tpu_torch.models.database import Database
from orientdb_tpu_torch.storage.snapshot import (
    EdgeClassCSR,
    GraphSnapshot,
    PropertyColumn,
)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _columns(cols: Dict) -> Dict[str, PropertyColumn]:
    out = {}
    for pname, col in cols.items():
        dictionary = col.get("dictionary")
        out[pname] = PropertyColumn(
            pname,
            col["kind"],
            np.ascontiguousarray(col["values"]),
            np.ascontiguousarray(col["present"], dtype=bool),
            list(dictionary) if dictionary is not None else None,
        )
    return out


def snapshot_from_arrays(
    schema_spec: List[Dict], arrays: Dict, name: str = "carried", device=None
) -> Tuple[Database, GraphSnapshot]:
    db = Database(name, device=device)
    for c in schema_spec:
        if c["name"] in ("V", "E"):
            continue
        db.schema.create_class(
            c["name"],
            superclasses=tuple(c.get("superclasses", ())),
            abstract=bool(c.get("abstract", False)),
        )
    snap = snapshot_of_arrays(arrays)
    db.attach_snapshot(snap)
    return db, snap


def snapshot_of_arrays(arrays: Dict) -> GraphSnapshot:
    """The `GraphSnapshot` of ``arrays`` (the layout above), attached to
    nothing: the build `snapshot_from_arrays` and the delta maintainer's
    compaction (`storage/deltas.SnapshotMaintainer.compact`) share."""
    snap = GraphSnapshot()
    snap.num_vertices = int(arrays["num_vertices"])
    snap.v_class = _i32(arrays["v_class"])
    none = np.full(snap.num_vertices, -1, np.int32)
    snap.v_cluster = _i32(arrays.get("v_cluster", none))
    snap.v_position = _i32(arrays.get("v_position", none))
    snap.class_names = list(arrays["class_names"])
    snap.class_id_of = dict(arrays["class_id_of"])
    snap.class_closure = {k: _i32(v) for k, v in arrays["class_closure"].items()}
    snap.class_vertex_range = {
        k: (int(lo), int(hi)) for k, (lo, hi) in arrays["class_vertex_range"].items()
    }
    snap.edge_closure = {k: list(v) for k, v in arrays["edge_closure"].items()}
    snap.v_columns = _columns(arrays["v_columns"])
    snap.v_non_columnar = set(arrays.get("v_non_columnar", ()))
    for cname, e in arrays["edge_classes"].items():
        csr = EdgeClassCSR(cname)
        for key in ("indptr_out", "dst", "indptr_in", "src", "edge_id_in"):
            setattr(csr, key, _i32(e[key]))
        csr.edge_columns = _columns(e.get("columns", {}))
        csr.non_columnar = set(e.get("non_columnar", ()))
        if "e_cluster" in e:
            csr.e_cluster = _i32(e["e_cluster"])
            csr.e_position = _i32(e["e_position"])
        snap.edge_classes[cname] = csr
    return snap
