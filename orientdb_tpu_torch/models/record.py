"""Port of `orientdb_tpu/models/record.py`, the read side of a vertex
record: `VertexRecord`, a read-only view of one snapshot vertex.

The port keeps no host records; a vertex's record is what its snapshot
holds: its RID (``v_cluster`` / ``v_position``), its class (``v_class``)
and its columnar properties, of which an absent one leaves its key out, as
the reference's records do. Two differences from the reference's
``Document.to_dict``: there is no ``@version`` (the snapshot holds no
versions), and a float property is the snapshot's float32 value. A
snapshot with non-columnar vertex properties cannot give whole records:
the engine refuses record rows there.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from orientdb_tpu_torch.models.rid import RID


class VertexRecord:
    """The record of vertex ``idx`` of ``snap`` ([E] OVertexDocument, read
    only). Equal records are the same vertex of the same snapshot."""

    __slots__ = ("snap", "idx")

    def __init__(self, snap, idx: int) -> None:
        self.snap = snap
        self.idx = int(idx)

    @property
    def rid(self) -> RID:
        return self.snap.rid_of(self.idx)

    @property
    def class_name(self) -> str:
        return self.snap.class_names[int(self.snap.v_class[self.idx])]

    def get(self, name: str, default=None):
        if name == "@rid":
            return self.rid
        if name == "@class":
            return self.class_name
        col = self.snap.v_columns.get(name)
        if col is None or not col.present[self.idx]:
            return default
        return col.objects_at(np.asarray([self.idx]))[0]

    def __getitem__(self, name: str):
        return self.get(name)

    def field_names(self) -> List[str]:
        return [n for n, c in self.snap.v_columns.items() if c.present[self.idx]]

    def fields(self) -> Dict[str, object]:
        return {n: self.get(n) for n in self.field_names()}

    def to_dict(self, include_meta: bool = True) -> Dict[str, object]:
        out = self.fields()
        if include_meta:
            out["@rid"] = str(self.rid)
            out["@class"] = self.class_name
        return out

    def __eq__(self, other) -> bool:
        return isinstance(other, VertexRecord) and other.snap is self.snap and other.idx == self.idx

    def __hash__(self) -> int:
        return hash((id(self.snap), self.idx))

    def __repr__(self) -> str:
        return f"VertexRecord({self.class_name}{self.rid} {self.fields()})"
