"""Port of `orientdb_tpu/storage/snapshot.py`: the columnar snapshot as
host numpy containers.

The layout is the reference's: a dense int32 vertex universe, per-edge-class
CSR in both directions (with the in-CSR's edge ids into out order), global
vertex property columns with presence masks (strings dictionary-coded with a
sorted dictionary), and the class-id column with its polymorphic closure
table. The device copy lives in `ops/device_graph.py`, cached per snapshot
by that module; the snapshot itself holds no device state. Building a
snapshot from host records waits for the record store: snapshots come from
`storage/bigshape.py` or from `carry.snapshot_from_arrays`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class PropertyColumn:
    """One global vertex property column."""

    __slots__ = ("name", "kind", "values", "present", "dictionary", "_dict_arr")

    def __init__(self, name: str, kind: str, values, present, dictionary=None):
        self.name = name
        self.kind = kind  # 'int' | 'float' | 'bool' | 'str'
        self.values = values  # np.ndarray
        self.present = present  # np.ndarray bool
        self.dictionary: Optional[List[str]] = dictionary  # sorted, for 'str'
        self._dict_arr = None

    def dict_array(self) -> np.ndarray:
        """The dictionary as an object ndarray, built once (row marshalling
        decodes string codes per query)."""
        if self._dict_arr is None:
            self._dict_arr = np.asarray(
                self.dictionary if self.dictionary else [""], object
            )
        return self._dict_arr


class EdgeClassCSR:
    """CSR adjacency for one concrete edge class, both directions.

    out:  indptr_out[V+1], dst[E]      (CSR order == edge dense order)
    in:   indptr_in[V+1], src[E], edge_id_in[E] (edge ids into out order)
    """

    __slots__ = ("class_name", "indptr_out", "dst", "indptr_in", "src", "edge_id_in")

    def __init__(self, class_name: str):
        self.class_name = class_name
        self.indptr_out: np.ndarray = np.zeros(1, np.int32)
        self.dst: np.ndarray = np.zeros(0, np.int32)
        self.indptr_in: np.ndarray = np.zeros(1, np.int32)
        self.src: np.ndarray = np.zeros(0, np.int32)
        self.edge_id_in: np.ndarray = np.zeros(0, np.int32)

    @property
    def num_edges(self) -> int:
        return int(self.dst.shape[0])


class GraphSnapshot:
    """The immutable columnar snapshot (host numpy form)."""

    def __init__(self) -> None:
        self.num_vertices: int = 0
        self.class_names: List[str] = []  # class_id → name
        self.class_id_of: Dict[str, int] = {}  # class name (lower) → id
        self.v_class: np.ndarray = np.zeros(0, np.int32)
        #: class name (lower) → sorted int32 ids of its polymorphic closure
        self.class_closure: Dict[str, np.ndarray] = {}
        #: CONCRETE vertex class (lower) → (start, end) contiguous range
        self.class_vertex_range: Dict[str, tuple] = {}
        self.v_columns: Dict[str, PropertyColumn] = {}
        #: property names seen but without a columnar encoding
        self.v_non_columnar: set = set()
        self.edge_classes: Dict[str, EdgeClassCSR] = {}
        #: edge class name (lower) → concrete edge class names
        self.edge_closure: Dict[str, List[str]] = {}

    def vertex_hull(self, name: str) -> tuple:
        """(start, end) dense-index hull of a class's polymorphic closure.
        The hull may include foreign-class vertices, so callers keep their
        class masks."""
        lo, hi = None, None
        for cid in self.class_closure.get(name.lower(), ()):
            rng = self.class_vertex_range.get(self.class_names[cid].lower())
            if rng is None or rng[1] <= rng[0]:
                continue
            lo = rng[0] if lo is None else min(lo, rng[0])
            hi = rng[1] if hi is None else max(hi, rng[1])
        if lo is None:
            return (0, 0)
        return (lo, hi)

    def vertex_class_ids(self, class_name: str) -> np.ndarray:
        return self.class_closure.get(class_name.lower(), np.zeros(0, np.int32))

    def concrete_edge_classes(self, class_name: Optional[str]) -> List[str]:
        if class_name is None:
            out: List[str] = []
            for names in self.edge_closure.values():
                for n in names:
                    if n not in out:
                        out.append(n)
            return sorted(out)
        return self.edge_closure.get(class_name.lower(), [])

    def class_mask(self, class_name: str) -> np.ndarray:
        """Boolean mask over the vertex universe for a polymorphic class."""
        return np.isin(self.v_class, self.vertex_class_ids(class_name))
