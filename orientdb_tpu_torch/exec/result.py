"""Port of `orientdb_tpu/exec/result.py`: projection rows, the columnar row
sequence and the result set, plus `canonical_rows`, the parity definition
shared with the reference.

A port row is always a projection: without host records there are no
element rows.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple


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
    """One projection row ([E] OResultInternal)."""

    __slots__ = ("_props",)

    def __init__(self, props: Optional[Dict[str, object]] = None) -> None:
        self._props: Dict[str, object] = props or {}

    def get_property(self, name: str, default=None):
        return self._props.get(name, default)

    def property_names(self) -> List[str]:
        return list(self._props.keys())

    def __getitem__(self, name: str):
        return self.get_property(name)

    def to_dict(self) -> Dict[str, object]:
        return dict(self._props)

    def __repr__(self) -> str:
        return f"Result({self._props!r})"


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
            and isinstance(self._rows, ColumnarRows)
        ):
            self._exhausted = True
            return self._rows.to_dicts()
        return [r.to_dict() for r in self]
