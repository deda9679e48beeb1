"""Port of `orientdb_tpu/storage/snapshot.py`: the columnar snapshot as
host numpy containers.

The layout is the reference's: a dense int32 vertex universe, per-edge-class
CSR in both directions (with the in-CSR's edge ids into out order) and its
edge property columns by edge id, global vertex property columns with
presence masks (strings dictionary-coded with a
sorted dictionary), the class-id column with its polymorphic closure
table, and each vertex's RID as the parallel ``v_cluster`` / ``v_position``
arrays (edges' RIDs likewise, where the source had them). The device copy
lives in `ops/device_graph.py`, cached per snapshot by that module; the
snapshot itself holds no device state. Building a snapshot from host
records waits for the record store: snapshots come from
`storage/bigshape.py` or from `carry.snapshot_from_arrays`. A snapshot
padded for delta maintenance (`storage/deltas.pad_for_deltas`) carries its
overlay in ``_overlay``, a tiered one (`storage/tiering`) its tier manager
in ``_tier``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from orientdb_tpu_torch.models.rid import RID

#: sentinel for "property missing" in numeric columns (presence is in the
#: mask; the sentinel only keeps padded values well-defined)
MISSING_INT = np.int32(-(2**31) + 1)
MISSING_FLOAT = np.float32(np.nan)


def _as_rid(rid) -> RID:
    return RID(int(rid[0]), int(rid[1]))


class RidIndex:
    """RID → dense index, built from parallel int32 cluster / position
    arrays (entries with cluster < 0 have no RID): the reference's
    ``rid_to_idx`` dict without a Python object per record. The keys are
    ``cluster << 32 | position``, sorted once (stably, so that a repeated
    RID maps to its last index, as the dict comprehension does); inserts
    and deletes after the build live in a side table."""

    def __init__(self, cluster: np.ndarray, position: np.ndarray) -> None:
        c = np.asarray(cluster, np.int64)
        ok = np.flatnonzero(c >= 0)
        keys = (c[ok] << 32) | (np.asarray(position, np.int64)[ok] & 0xFFFFFFFF)
        order = np.argsort(keys, kind="stable")
        self._keys = keys[order]
        self._idx = ok[order]
        self._added: Dict[RID, int] = {}
        self._removed: set = set()

    def _base(self, rid: RID) -> Optional[int]:
        if rid.cluster < 0:
            return None
        key = (rid.cluster << 32) | (rid.position & 0xFFFFFFFF)
        j = int(np.searchsorted(self._keys, key, side="right")) - 1
        if j < 0 or int(self._keys[j]) != key:
            return None
        return int(self._idx[j])

    def get(self, rid, default=None):
        rid = _as_rid(rid)
        if rid in self._added:
            return self._added[rid]
        if rid in self._removed:
            return default
        i = self._base(rid)
        return default if i is None else i

    def __contains__(self, rid) -> bool:
        return self.get(rid) is not None

    def __setitem__(self, rid, idx: int) -> None:
        rid = _as_rid(rid)
        self._added[rid] = int(idx)
        self._removed.discard(rid)

    def pop(self, rid, default=None):
        rid = _as_rid(rid)
        i = self.get(rid)
        if i is None:
            return default
        self._added.pop(rid, None)
        if self._base(rid) is not None:
            self._removed.add(rid)
        return i

    def items(self):
        """Every live (RID, index) pair: the base entries, then the side
        table's."""
        for k, i in zip(self._keys.tolist(), self._idx.tolist()):
            rid = RID(k >> 32, k & 0xFFFFFFFF)
            if rid not in self._removed and rid not in self._added and self._base(rid) == i:
                yield rid, i
        yield from self._added.items()


class PropertyColumn:
    """One global property column: a vertex property over the vertex
    universe, or an edge property over one edge class's edge ids."""

    __slots__ = (
        "name", "kind", "values", "present", "dictionary", "dict_unsorted",
        "_lookup", "_dict_arr",
    )

    def __init__(self, name: str, kind: str, values, present, dictionary=None):
        self.name = name
        self.kind = kind  # 'int' | 'float' | 'bool' | 'str'
        self.values = values  # np.ndarray
        self.present = present  # np.ndarray bool
        self.dictionary: Optional[List[str]] = dictionary  # sorted, for 'str'
        #: True once the delta maintainer APPENDED a string (codes no longer
        #: sorted): equality stays exact, ordered compares refuse to compile
        self.dict_unsorted = False
        self._lookup: Optional[Dict[str, int]] = None
        self._dict_arr = None

    @property
    def dict_lookup(self) -> Optional[Dict[str, int]]:
        """String → code of a dictionary column, built on first use."""
        if self._lookup is None and self.dictionary is not None:
            self._lookup = {s: i for i, s in enumerate(self.dictionary)}
        return self._lookup

    def dict_array(self) -> np.ndarray:
        """The dictionary as an object ndarray, built once (row marshalling
        decodes string codes per query)."""
        if self._dict_arr is None:
            self._dict_arr = np.asarray(
                self.dictionary if self.dictionary else [""], object
            )
        return self._dict_arr

    def objects_at(self, idx: np.ndarray) -> np.ndarray:
        """The values at ``idx`` as Python objects (an object ndarray):
        strings from the dictionary, None where absent or ``idx`` < 0."""
        ci = np.clip(idx, 0, max(len(self.values) - 1, 0))
        vals = self.values[ci]
        pres = self.present[ci] & (idx >= 0)
        if self.kind == "str":
            d = self.dict_array()
            o = d[np.clip(vals, 0, len(d) - 1)]
        elif self.kind == "bool":
            o = (vals != 0).astype(object)
        elif self.kind == "float":
            o = vals.astype(float).astype(object)
        else:
            o = vals.astype(object)
        o[~pres] = None
        return o


class EdgeClassCSR:
    """CSR adjacency for one concrete edge class, both directions.

    out:  indptr_out[V+1], dst[E]      (CSR order == edge dense order)
    in:   indptr_in[V+1], src[E], edge_id_in[E] (edge ids into out order)
    edge_src[E]: each edge's source in out order, derived from indptr_out
    on first use (the bitmap hops, edge endpoints of ``.outV()``)
    edge_columns: property name → PropertyColumn indexed by edge id (out
    order); non_columnar: edge property names seen without a columnar
    encoding, which predicates and projections refuse
    e_cluster / e_position[E]: each edge's RID (cluster -1: none), or None
    when the source had no edge RIDs
    live[E]: liveness when the snapshot carries delta slabs
    (`storage/deltas.pad_for_deltas`); None on classic snapshots
    """

    __slots__ = (
        "class_name", "indptr_out", "dst", "indptr_in", "src", "edge_id_in",
        "edge_columns", "non_columnar", "e_cluster", "e_position", "live",
        "_edge_src",
    )

    def __init__(self, class_name: str):
        self.class_name = class_name
        self.indptr_out: np.ndarray = np.zeros(1, np.int32)
        self.dst: np.ndarray = np.zeros(0, np.int32)
        self.indptr_in: np.ndarray = np.zeros(1, np.int32)
        self.src: np.ndarray = np.zeros(0, np.int32)
        self.edge_id_in: np.ndarray = np.zeros(0, np.int32)
        self.edge_columns: Dict[str, PropertyColumn] = {}
        self.non_columnar: set = set()
        self.e_cluster: Optional[np.ndarray] = None
        self.e_position: Optional[np.ndarray] = None
        self.live: Optional[np.ndarray] = None
        self._edge_src: Optional[np.ndarray] = None

    @property
    def num_edges(self) -> int:
        return int(self.dst.shape[0])

    @property
    def edge_src(self) -> np.ndarray:
        """Per-edge source vertex in out-CSR order (computed once)."""
        if self._edge_src is None:
            self._edge_src = np.repeat(
                np.arange(self.indptr_out.shape[0] - 1, dtype=np.int32),
                np.diff(self.indptr_out),
            )
        return self._edge_src


class GraphSnapshot:
    """The immutable columnar snapshot (host numpy form)."""

    def __init__(self) -> None:
        self.num_vertices: int = 0
        # dense index → RID (parallel int32 arrays; cluster -1: no RID)
        self.v_cluster: np.ndarray = np.zeros(0, np.int32)
        self.v_position: np.ndarray = np.zeros(0, np.int32)
        self._rid_index: Optional[RidIndex] = None
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
        #: delta overlay (`storage/deltas.SnapshotOverlay`) once padded
        self._overlay = None
        #: hot/cold tier manager (`storage/tiering.TierManager`) once
        #: admitted under ``config.tier_hbm_cap_bytes``
        self._tier = None
        #: the mesh (`parallel/collectives`) the snapshot is attached with
        self._mesh = None

    @property
    def rid_to_idx(self) -> RidIndex:
        """RID → dense index, built from ``v_cluster`` / ``v_position`` on
        first use (the reference's dict of the same name)."""
        if self._rid_index is None:
            self._rid_index = RidIndex(self.v_cluster, self.v_position)
        return self._rid_index

    def rid_of(self, idx: int) -> RID:
        """The RID of vertex ``idx``."""
        return RID(int(self.v_cluster[idx]), int(self.v_position[idx]))

    def idx_of(self, rid) -> Optional[int]:
        """The vertex index of ``rid``, or None when it is no snapshot
        vertex."""
        return self.rid_to_idx.get(rid)

    def rids_of(self, ids: np.ndarray) -> tuple:
        """The RIDs of the vertices ``ids`` (each >= 0) as parallel int32
        ``(cluster, position)`` arrays: the marshal's vectorised `rid_of`."""
        ids = np.asarray(ids, np.int64)
        return self.v_cluster[ids], self.v_position[ids]

    def slab_vertex_range(self) -> tuple:
        """(start, end) of the vertex append slab; ``(0, 0)`` on classic
        snapshots. Root scans of armed snapshots cover it beside the class
        hull."""
        ov = self._overlay
        if ov is None:
            return (0, 0)
        return (ov.base_vertices, ov.cap_vertices)

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
