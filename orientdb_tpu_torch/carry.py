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
- ``v_columns``: property name → ``{"kind", "values", "present",
  "dictionary"}``, and ``v_non_columnar`` (optional): the property names
  seen without a columnar encoding, which predicates must refuse;
- ``edge_classes``: class name → ``{"indptr_out", "dst", "indptr_in",
  "src", "edge_id_in"}``.
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
    snap = GraphSnapshot()
    snap.num_vertices = int(arrays["num_vertices"])
    snap.v_class = _i32(arrays["v_class"])
    snap.class_names = list(arrays["class_names"])
    snap.class_id_of = dict(arrays["class_id_of"])
    snap.class_closure = {k: _i32(v) for k, v in arrays["class_closure"].items()}
    snap.class_vertex_range = {
        k: (int(lo), int(hi)) for k, (lo, hi) in arrays["class_vertex_range"].items()
    }
    snap.edge_closure = {k: list(v) for k, v in arrays["edge_closure"].items()}
    for pname, col in arrays["v_columns"].items():
        dictionary = col.get("dictionary")
        snap.v_columns[pname] = PropertyColumn(
            pname,
            col["kind"],
            np.ascontiguousarray(col["values"]),
            np.ascontiguousarray(col["present"], dtype=bool),
            list(dictionary) if dictionary is not None else None,
        )
    snap.v_non_columnar = set(arrays.get("v_non_columnar", ()))
    for cname, e in arrays["edge_classes"].items():
        csr = EdgeClassCSR(cname)
        for key in ("indptr_out", "dst", "indptr_in", "src", "edge_id_in"):
            setattr(csr, key, _i32(e[key]))
        snap.edge_classes[cname] = csr
    db.attach_snapshot(snap)
    return db, snap
