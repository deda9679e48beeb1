"""Port of `orientdb_tpu/ops/device_graph.py`: the snapshot's arrays on the
device, as torch tensors.

Adjacency (both CSR directions and the in-CSR's edge ids) and the class-id
column upload when the graph is built; property columns register lazily
and reach the device the first time a predicate or a marshalled projection
reads them (`_put_lazy` / `ensure_key`), so columns no query touches cost
no device memory. The device graph is cached per snapshot in this module's
own weak map (rebuilt when another device asks), so it is freed with its
snapshot; the snapshot itself holds no device state.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Set

import numpy as np
import torch

from orientdb_tpu_torch.storage.snapshot import GraphSnapshot, PropertyColumn


class DeviceColumn:
    """A property column proxy: values + presence mask in ``graph.arrays``.
    The (sorted) dictionary of a string column stays on the host, where
    string predicates are evaluated into code tables."""

    __slots__ = ("name", "kind", "dictionary", "_g", "_kv", "_kp")

    def __init__(self, col: PropertyColumn, g: "DeviceGraph", prefix: str):
        self.name = col.name
        self.kind = col.kind
        self.dictionary = col.dictionary
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
    """One edge class's CSR adjacency (both directions) on the device."""

    __slots__ = ("class_name", "num_edges", "_g", "_p")

    def __init__(self, csr, g: "DeviceGraph") -> None:
        self.class_name = csr.class_name
        self._g = g
        p = self._p = f"e:{csr.class_name}"
        g._put(f"{p}:indptr_out", csr.indptr_out)
        g._put(f"{p}:indptr_in", csr.indptr_in)
        g._put(f"{p}:dst", csr.dst)
        g._put(f"{p}:src", csr.src)
        g._put(f"{p}:edge_id_in", csr.edge_id_in)
        self.num_edges = int(csr.dst.shape[0])

    @property
    def indptr_out(self) -> torch.Tensor:
        return self._g.arrays[f"{self._p}:indptr_out"]

    @property
    def dst(self) -> torch.Tensor:
        return self._g.arrays[f"{self._p}:dst"]

    @property
    def indptr_in(self) -> torch.Tensor:
        return self._g.arrays[f"{self._p}:indptr_in"]

    @property
    def src(self) -> torch.Tensor:
        return self._g.arrays[f"{self._p}:src"]

    @property
    def edge_id_in(self) -> torch.Tensor:
        return self._g.arrays[f"{self._p}:edge_id_in"]


class DeviceGraph:
    """The snapshot's arrays on ``device`` plus host metadata for planning
    and marshalling."""

    def __init__(self, snap: GraphSnapshot, device: torch.device) -> None:
        # no reference to the snapshot itself: it is this graph's key in the
        # weak cache below, and a value holding its key would never be freed
        self._class_closure = snap.class_closure
        self.device = device
        self.num_vertices = snap.num_vertices
        self.arrays: Dict[str, torch.Tensor] = {}
        self._pending: Dict[str, np.ndarray] = {}
        self._pending_lock = threading.Lock()
        self._put("v_class", snap.v_class)
        self.columns: Dict[str, DeviceColumn] = {
            n: DeviceColumn(c, self, f"v:{n}") for n, c in snap.v_columns.items()
        }
        self.non_columnar: Set[str] = set(snap.v_non_columnar)
        self.edges: Dict[str, DeviceEdgeClass] = {
            n: DeviceEdgeClass(c, self) for n, c in snap.edge_classes.items()
        }
        self._class_ids: Dict[str, torch.Tensor] = {}

    def _put(self, key: str, arr: np.ndarray) -> str:
        self.arrays[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        return key

    def _put_lazy(self, key: str, arr: np.ndarray) -> str:
        """Register a host array for upload on first read (`ensure_key`)."""
        self._pending[key] = arr
        return key

    def ensure_key(self, key: str) -> None:
        """Upload a lazily registered array if it is not on the device yet."""
        if key in self._pending:
            with self._pending_lock:
                arr = self._pending.pop(key, None)
                if arr is not None:
                    self._put(key, arr)

    @property
    def v_class(self) -> torch.Tensor:
        return self.arrays["v_class"]

    def memory_report(self) -> Dict[str, object]:
        """Device bytes by category, and the bytes of columns still on the
        host because no query has read them."""
        cats = {"adjacency": 0, "vertex_columns": 0, "other": 0}
        for key, arr in self.arrays.items():
            if key == "v_class" or key.startswith("v:"):
                cat = "vertex_columns"
            elif key.startswith("e:"):
                cat = "adjacency"
            else:
                cat = "other"
            cats[cat] += arr.numel() * arr.element_size()
        return {
            "per_device": cats,
            "total_bytes": sum(cats.values()),
            "pruned_bytes": sum(int(a.nbytes) for a in self._pending.values()),
            "pruned_arrays": len(self._pending),
        }

    def class_ids(self, class_name: str) -> torch.Tensor:
        key = class_name.lower()
        ids = self._class_ids.get(key)
        if ids is None:
            closure = self._class_closure.get(key, np.zeros(0, np.int32))
            ids = self._class_ids[key] = torch.from_numpy(
                np.ascontiguousarray(closure)
            ).to(self.device)
        return ids


_CACHE: "weakref.WeakKeyDictionary[GraphSnapshot, DeviceGraph]" = (
    weakref.WeakKeyDictionary()
)
_CACHE_LOCK = threading.Lock()


def device_graph(snap: GraphSnapshot, device: torch.device) -> DeviceGraph:
    """Build (or fetch the cached) device form of a snapshot on ``device``."""
    with _CACHE_LOCK:
        dg = _CACHE.get(snap)
        if dg is None or dg.device != device:
            dg = _CACHE[snap] = DeviceGraph(snap, device)
    return dg
