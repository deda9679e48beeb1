"""Port of `orientdb_tpu/ops/device_graph.py`: the snapshot's arrays on the
device, as torch tensors.

Adjacency (both CSR directions and the in-CSR's edge ids) and the class-id
column upload when the graph is built; vertex and edge property columns
and each edge class's per-edge sources (the bitmap hops' edge list, the
``.outV()`` endpoints) register lazily and
reach the device the first time a query reads them (`_put_lazy` /
`ensure_key`), so arrays no query touches cost no device memory. Every upload belongs to a recording run: inside
`DeviceGraph.sealed()` (a replay, captured or not) a lazy upload raises
instead, since a pageable host→device copy cannot be captured. The device
graph is cached per snapshot in this module's own weak map (rebuilt when
another device asks), so it is freed with its snapshot; the snapshot itself
holds no device state.

A tiered snapshot (`storage/tiering`) uploads only the indptrs of a paged
edge class; `TierManager.install` adds the block indexes and the page pools
(``t:{class}:{direction}:*``), which loads and evictions write in place.

A snapshot attached with a mesh (`models/database.Database.attach_snapshot`)
uploads no flat adjacency: every mesh path reads the sharded layout that
`parallel/mesh_graph.MeshGraph` puts under ``sh:*`` keys, the rows of the
shards this process holds. A mesh refuses a delta overlay and a tier.

A snapshot padded for delta maintenance (`storage/deltas`) also uploads
each edge class's ``live`` mask and its slab bucket tables
(``bk:{class}:out`` / ``bk:{class}:in``); `DeviceGraph.apply_patches`
writes a write batch's patches into the resident tensors in place (K16
`scatter_set`), so every captured replay sees them through the pointers it
holds.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Dict, Set

import numpy as np
import torch

from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.storage.snapshot import GraphSnapshot, PropertyColumn


class DeviceColumn:
    """A property column proxy: values + presence mask in ``graph.arrays``.
    The (sorted) dictionary of a string column stays on the host, where
    string predicates are evaluated into code tables; it is the host
    column's own list, so strings a write batch appends show here too."""

    __slots__ = ("name", "kind", "dictionary", "host", "_g", "_kv", "_kp")

    def __init__(self, col: PropertyColumn, g: "DeviceGraph", prefix: str):
        self.name = col.name
        self.kind = col.kind
        self.dictionary = col.dictionary
        #: the host column (its ``dict_unsorted`` flag and ``dict_lookup``)
        self.host = col
        self._g = g
        self._kv = g._put_lazy(f"{prefix}:v", col.values)
        self._kp = g._put_lazy(f"{prefix}:p", col.present)

    @property
    def values(self) -> torch.Tensor:
        self._g.ensure_key(self._kv)
        return self._g.arrays[self._kv]

    @property
    def present(self) -> torch.Tensor:
        self._g.ensure_key(self._kp)
        return self._g.arrays[self._kp]


class DeviceEdgeClass:
    """One edge class's CSR adjacency (both directions) on the device, its
    edge list in out order (``edge_src`` beside ``dst``), and its edge
    property columns (``columns``, indexed by edge id in out order, under
    the class's key prefix). A class paged by the tier plane (``paged``)
    uploads only its indptrs: its edges live in the tier's page pools, and
    reading ``dst``, ``src``, ``edge_id_in`` or ``edge_src`` raises. A
    class of a meshed snapshot (``sharded``) uploads no adjacency at all."""

    __slots__ = (
        "class_name", "num_edges", "columns", "non_columnar", "paged", "sharded", "_g", "_p",
        "_k_edge_src",
    )

    def __init__(self, csr, g: "DeviceGraph", paged: bool = False, sharded: bool = False) -> None:
        self.class_name = csr.class_name
        self._g = g
        self.paged = paged
        self.sharded = sharded
        p = self._p = f"e:{csr.class_name}"
        self._k_edge_src = f"{p}:edge_src"
        if not sharded:
            g._put(f"{p}:indptr_out", csr.indptr_out)
            g._put(f"{p}:indptr_in", csr.indptr_in)
        if not (paged or sharded):
            g._put(f"{p}:dst", csr.dst)
            g._put(f"{p}:src", csr.src)
            g._put(f"{p}:edge_id_in", csr.edge_id_in)
            # derived on the host and uploaded on first read: only variable-
            # depth and NOT arms walk the flat edge list, and ``.outV()``
            # reads an edge's source
            g._put_lazy(self._k_edge_src, lambda csr=csr: csr.edge_src)
        if csr.live is not None:
            # delta-slab liveness: spare slots and tombstones read False
            g._put(f"{p}:live", csr.live)
        self.columns: Dict[str, DeviceColumn] = {
            n: DeviceColumn(c, g, f"{p}:c:{n}") for n, c in csr.edge_columns.items()
        }
        self.non_columnar: Set[str] = set(csr.non_columnar)
        self.num_edges = int(csr.dst.shape[0])

    def _resident(self, name: str) -> torch.Tensor:
        if self.sharded:
            raise KeyError(f"{self.class_name}.{name}: a meshed snapshot keeps only the sharded layout")
        return self._g.arrays[f"{self._p}:{name}"]

    @property
    def indptr_out(self) -> torch.Tensor:
        return self._resident("indptr_out")

    @property
    def live(self) -> torch.Tensor:
        return self._g.arrays[f"{self._p}:live"]

    def _flat(self, name: str) -> torch.Tensor:
        if self.sharded:
            return self._resident(name)
        if self.paged:
            raise KeyError(f"{self.class_name}.{name} is paged by the tier plane, not on the device")
        return self._g.arrays[f"{self._p}:{name}"]

    @property
    def dst(self) -> torch.Tensor:
        return self._flat("dst")

    @property
    def edge_src(self) -> torch.Tensor:
        if not (self.paged or self.sharded):
            self._g.ensure_key(self._k_edge_src)
        return self._flat("edge_src")

    @property
    def indptr_in(self) -> torch.Tensor:
        return self._resident("indptr_in")

    @property
    def src(self) -> torch.Tensor:
        return self._flat("src")

    @property
    def edge_id_in(self) -> torch.Tensor:
        return self._flat("edge_id_in")


class DeviceGraph:
    """The snapshot's arrays on ``device`` plus host metadata for planning
    and marshalling."""

    def __init__(self, snap: GraphSnapshot, device: torch.device) -> None:
        # no reference to the snapshot itself: it is this graph's key in the
        # weak cache below, and a value holding its key would never be freed
        self._class_closure = snap.class_closure
        self.num_classes = len(snap.class_names)
        self.device = device
        self.num_vertices = snap.num_vertices
        self.arrays: Dict[str, torch.Tensor] = {}
        self._pending: Dict[str, np.ndarray] = {}
        self._pending_lock = threading.Lock()
        self._armed = snap._overlay is not None
        #: the sharding context (`parallel/mesh_graph.MeshGraph`) of a meshed
        #: snapshot, else None
        self.mesh_graph = None
        mesh = getattr(snap, "_mesh", None)
        if mesh is not None:
            if snap._overlay is not None:
                raise ValueError(
                    "delta-maintained snapshots are single-device; compact before attaching a mesh"
                )
            if snap._tier is not None:
                raise ValueError(
                    "tiered snapshots are single-device; drop the mesh or raise tier_hbm_cap_bytes"
                )
            if mesh.device != device:
                raise ValueError(f"the mesh lives on {mesh.device}, the graph on {device}")
            from orientdb_tpu_torch.parallel.mesh_graph import MeshGraph

            self.mesh_graph = MeshGraph(mesh)
        self._put("v_class", snap.v_class)
        self.columns: Dict[str, DeviceColumn] = {
            n: DeviceColumn(c, self, f"v:{n}") for n, c in snap.v_columns.items()
        }
        self.non_columnar: Set[str] = set(snap.v_non_columnar)
        tier = snap._tier
        self.edges: Dict[str, DeviceEdgeClass] = {
            n: DeviceEdgeClass(
                c, self, tier is not None and tier.pages_dir(n, "out"), mesh is not None
            )
            for n, c in snap.edge_classes.items()
        }
        if self.mesh_graph is not None:
            self.mesh_graph.build(self, snap)
        if tier is not None:
            # the block indexes, the page pools and their hot seed
            tier.install(self)
        ov = snap._overlay
        for cname, tables in (ov.bk.items() if ov is not None else ()):
            # the slab's bucket tables, patch-maintained like the live mask
            self._put(f"bk:{cname}:out", tables["out"])
            self._put(f"bk:{cname}:in", tables["in"])
        self._class_tables: Dict[str, torch.Tensor] = {}
        self._sealed = False

    def _put(self, key: str, arr: np.ndarray) -> str:
        # an armed snapshot's host arrays are patched apart from the device
        # ones (`apply_patches`), so on the CPU they get a copy too
        t = torch.from_numpy(np.ascontiguousarray(arr))
        self.arrays[key] = t.to(self.device, copy=self._armed)
        return key

    def _put_lazy(self, key: str, arr) -> str:
        """Register a host array (or a function making it) for upload on
        first read (`ensure_key`)."""
        self._pending[key] = arr
        return key

    def ensure_key(self, key: str) -> None:
        """Upload a lazily registered array if it is not on the device yet.
        Raises inside `sealed()`: a replay reads only what its recording
        uploaded."""
        if key in self._pending:
            if self._sealed:
                raise RuntimeError(
                    f"array {key!r} would upload during a replay; every "
                    "upload belongs to the recording run"
                )
            with self._pending_lock:
                arr = self._pending.pop(key, None)
                if arr is not None:
                    self._put(key, arr() if callable(arr) else arr)

    @property
    def v_class(self) -> torch.Tensor:
        return self.arrays["v_class"]

    def apply_patches(self, patches: Dict[str, tuple]) -> int:
        """Scatter one phase of a write batch into the resident tensors:
        ``{key: (indices, values)}``, one K16 `scatter_set` launch per key,
        in place, on the current stream (the maintainer runs the phases on
        the replay stream). Each segment is padded to a power of two by
        repeating its last pair, as the reference pads it. Keys still
        pending a lazy upload are skipped: their host arrays are already
        patched, so the upload carries the delta. Returns the host→device
        bytes shipped."""
        nbytes = 0
        with self._pending_lock:
            for key, (idx, vals) in patches.items():
                cur = self.arrays.get(key)
                if cur is None:
                    continue
                ia = np.asarray(idx, np.int32)
                va = np.asarray(vals).astype(_NP_DTYPE[cur.dtype])
                if ia.size and (ia.min() < 0 or ia.max() >= cur.shape[0]):
                    raise IndexError(f"patch of {key!r} outside [0, {cur.shape[0]})")
                cap = 1 << max(0, int(ia.shape[0] - 1).bit_length())
                if cap > ia.shape[0]:
                    ia = np.concatenate([ia, np.full(cap - ia.shape[0], ia[-1], ia.dtype)])
                    va = np.concatenate([va, np.full(cap - va.shape[0], va[-1], va.dtype)])
                K.scatter_set(cur, _upload(ia, self.device), _upload(va, self.device))
                nbytes += int(ia.nbytes) + int(va.nbytes)
        return nbytes

    def memory_report(self) -> Dict[str, object]:
        """Device bytes by category, and the bytes of columns still on the
        host because no query has read them."""
        cats = {"adjacency": 0, "tier": 0, "vertex_columns": 0, "edge_columns": 0, "other": 0}
        for key, arr in self.arrays.items():
            if key.startswith("t:"):
                cat = "tier"  # page pools and block indexes (storage/tiering)
            elif key == "v_class" or key.startswith("v:"):
                cat = "vertex_columns"
            elif key.startswith("e:") and ":c:" in key:
                cat = "edge_columns"
            elif key.startswith("e:") or key.startswith("sh:"):
                cat = "adjacency"
            else:
                cat = "other"
            cats[cat] += arr.numel() * arr.element_size()
        return {
            "per_device": cats,
            "total_bytes": sum(cats.values()),
            "pruned_bytes": sum(
                int(getattr(a, "nbytes", 0)) for a in self._pending.values()
            ),
            "pruned_arrays": len(self._pending),
        }

    @contextlib.contextmanager
    def sealed(self):
        """Refuse lazy uploads for the duration (a replay)."""
        prev, self._sealed = self._sealed, True
        try:
            yield self
        finally:
            self._sealed = prev

    def any_class_table(self) -> torch.Tensor:
        """bool [num_classes] of all True: as a class term, ``v_class >= 0``
        (the liveness of a delta-maintained vertex universe, whose spare
        and deleted rows carry class -1)."""
        table = self._class_tables.get(None)
        if table is None:
            host = np.ones(max(self.num_classes, 1), bool)
            table = self._class_tables[None] = torch.from_numpy(host).to(self.device)
        return table

    def class_table(self, class_name: str) -> torch.Tensor:
        """bool [num_classes] membership table of a class's polymorphic
        closure, uploaded once: a class mask is then one `take_pad`
        through it (the reference's ``jnp.isin`` over the closure ids)."""
        key = class_name.lower()
        table = self._class_tables.get(key)
        if table is None:
            host = np.zeros(max(self.num_classes, 1), bool)
            host[self._class_closure.get(key, np.zeros(0, np.int32))] = True
            table = self._class_tables[key] = torch.from_numpy(host).to(self.device)
        return table


_NP_DTYPE = {torch.int32: np.int32, torch.float32: np.float32, torch.bool: np.bool_}


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A patch segment on ``device``: from pinned memory, asynchronously on
    the current stream, on a card."""
    t = torch.from_numpy(host)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


_CACHE: "weakref.WeakKeyDictionary[GraphSnapshot, DeviceGraph]" = (
    weakref.WeakKeyDictionary()
)
_CACHE_LOCK = threading.Lock()


def cached_device_graph(snap: GraphSnapshot):
    """The snapshot's device graph if one was built, else None."""
    with _CACHE_LOCK:
        return _CACHE.get(snap)


def release_device_graph(snap: GraphSnapshot) -> None:
    """Drop the snapshot's device graph and free its tensors (a snapshot
    replaced by its compaction, `storage/deltas`): the caller has drained
    every replay that reads them."""
    with _CACHE_LOCK:
        dg = _CACHE.pop(snap, None)
    if dg is not None:
        dg.arrays.clear()
        dg._pending.clear()
        dg._class_tables.clear()


def device_graph(snap: GraphSnapshot, device: torch.device) -> DeviceGraph:
    """Build (or fetch the cached) device form of a snapshot on ``device``."""
    with _CACHE_LOCK:
        dg = _CACHE.get(snap)
        if dg is None or dg.device != device:
            dg = _CACHE[snap] = DeviceGraph(snap, device)
    return dg
