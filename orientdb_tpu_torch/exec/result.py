"""Port of `orientdb_tpu/exec/result.py`: result rows, the columnar row
sequences and the result set, plus `canonical_rows`, the parity definition
shared with the reference.

A row is a projection (named values) or an element: the record of one
snapshot vertex (`models/record.VertexRecord`). `ColumnarRows` keeps
projection rows as decoded columns, `RecordRows` keeps element rows as
vertex ids and decodes the snapshot's columns only when the rows are read.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from orientdb_tpu_torch.models.record import VertexRecord
from orientdb_tpu_torch.models.rid import RID


def canonical_rows(rows: Iterable[Dict[str, object]]) -> List[Tuple]:
    """Order-insensitive canonical form of a list of plain-dict rows (the
    ``to_dicts()`` shape): each row becomes a sorted item tuple, the rows
    sort as a multiset (a repr key where mixed types defeat ordering)."""
    items = [tuple(sorted(r.items())) for r in rows]
    try:
        return sorted(items)
    except TypeError:
        return sorted(items, key=repr)


class Result:
    """One row: a record (``element``) or a projection map ([E]
    OResultInternal)."""

    __slots__ = ("_element", "_props")

    def __init__(
        self, element: Optional[VertexRecord] = None, props: Optional[Dict[str, object]] = None
    ) -> None:
        self._element = element
        self._props: Dict[str, object] = props or {}

    @property
    def is_element(self) -> bool:
        return self._element is not None and not self._props

    @property
    def element(self) -> Optional[VertexRecord]:
        return self._element

    @property
    def rid(self) -> Optional[RID]:
        return self._element.rid if self._element is not None else None

    def get_property(self, name: str, default=None):
        if name in self._props:
            return self._props[name]
        if self._element is not None:
            return self._element.get(name, default)
        return default

    def property_names(self) -> List[str]:
        if self._props:
            return list(self._props.keys())
        if self._element is not None:
            return self._element.field_names()
        return []

    def __getitem__(self, name: str):
        return self.get_property(name)

    def to_dict(self) -> Dict[str, object]:
        """Plain-python row: a record's dict, or the projections with record
        and RID values rendered as their RID string."""
        if self.is_element:
            return self._element.to_dict()
        return {k: _plain(v) for k, v in self._props.items()}

    def __repr__(self) -> str:
        if self.is_element:
            return f"Result({self._element!r})"
        return f"Result({self._props!r})"


def _plain(v):
    if isinstance(v, (VertexRecord, RID)):
        return str(v.rid if isinstance(v, VertexRecord) else v)
    if isinstance(v, Result):
        return v.to_dict()
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


def rid_strings(cluster: np.ndarray, position: np.ndarray) -> List[str]:
    """``"#c:p"`` for each (cluster, position) pair."""
    return [f"#{c}:{p}" for c, p in zip(cluster.tolist(), position.tolist())]


class ColumnarRows:
    """Projection rows kept as decoded object columns; `Result` objects are
    built only if a caller iterates, and `to_dicts()` reads the columns."""

    __slots__ = ("names", "cols", "n")

    def __init__(self, names: List[str], cols: List, n: int) -> None:
        self.names = names
        self.cols = cols
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __iter__(self) -> Iterator[Result]:
        if not self.cols:
            for _ in range(self.n):
                yield Result(props={})
            return
        for row in zip(*self.cols):
            yield Result(props=dict(zip(self.names, row)))

    def to_dicts(self) -> List[Dict[str, object]]:
        if not self.cols:
            return [{} for _ in range(self.n)]
        return [dict(zip(self.names, row)) for row in zip(*self.cols)]


class RecordRows:
    """Element rows kept as the vertex ids of their records: `len()` costs
    nothing, iteration builds a `Result` per record, and `to_dicts()`
    decodes the snapshot's columns column by column (absent values leave
    their key out, as a record's dict does)."""

    __slots__ = ("snap", "ids")

    def __init__(self, snap, ids: np.ndarray) -> None:
        self.snap = snap
        self.ids = np.asarray(ids, np.int64)

    def __len__(self) -> int:
        return int(self.ids.shape[0])

    def __iter__(self) -> Iterator[Result]:
        for i in self.ids.tolist():
            yield Result(element=VertexRecord(self.snap, i))

    def to_dicts(self) -> List[Dict[str, object]]:
        snap, ids = self.snap, self.ids
        names = np.asarray(snap.class_names, object)[snap.v_class[ids]].tolist()
        out = [{"@rid": r, "@class": c} for r, c in zip(rid_strings(*snap.rids_of(ids)), names)]
        for name, col in snap.v_columns.items():
            vals = col.objects_at(ids)
            pres = col.present[ids]
            if pres.all():
                for d, v in zip(out, vals.tolist()):
                    d[name] = v
            else:
                for i in np.flatnonzero(pres).tolist():
                    out[i][name] = vals[i]
        return out


class ResultSet:
    """Forward-only row stream ([E] OResultSet)."""

    def __init__(self, rows: Iterable[Result]) -> None:
        self._rows = rows
        self._it: Optional[Iterator[Result]] = None
        self._peeked: Optional[Result] = None
        self._exhausted = False

    def has_next(self) -> bool:
        if self._peeked is not None:
            return True
        if self._exhausted:
            return False
        if self._it is None:
            self._it = iter(self._rows)
        try:
            self._peeked = next(self._it)
            return True
        except StopIteration:
            self._exhausted = True
            return False

    def next(self) -> Result:
        if not self.has_next():
            raise StopIteration
        row, self._peeked = self._peeked, None
        return row

    def __iter__(self) -> Iterator[Result]:
        while self.has_next():
            yield self.next()

    def to_list(self) -> List[Result]:
        return list(self)

    def to_dicts(self) -> List[Dict[str, object]]:
        # untouched columnar rows skip Result materialization entirely
        if (
            self._it is None
            and not self._exhausted
            and isinstance(self._rows, (ColumnarRows, RecordRows))
        ):
            self._exhausted = True
            return self._rows.to_dicts()
        return [r.to_dict() for r in self]
