"""Port of `orientdb_tpu/models/schema.py`, trimmed to what the compiled
MATCH path reads: classes, their superclass hierarchy, abstract flags and
cluster ids.

Cluster ids are allocated in the reference's order (cluster 0 reserved,
``V`` and ``E`` bootstrapped first), so a class created in the same order
gets the same cluster id in both packages. Properties, DDL observers and
class renames wait for the record store.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set


class SchemaClass:
    """A schema class ([E] OClassImpl). Created through :class:`Schema`."""

    def __init__(self, schema: "Schema", name: str, cluster_ids: Sequence[int]) -> None:
        self._schema = schema
        self.name = name
        self.cluster_ids: List[int] = list(cluster_ids)
        self.superclass_names: List[str] = []
        self.abstract = False

    @property
    def superclasses(self) -> List["SchemaClass"]:
        return [self._schema.get_class(n) for n in self.superclass_names]

    def add_superclass(self, name: str) -> None:
        sup = self._schema.get_class(name)
        if sup is None:
            raise ValueError(f"superclass '{name}' does not exist")
        if self.name in sup.all_superclass_names() | {sup.name}:
            raise ValueError(f"inheritance cycle: {self.name} <-> {name}")
        if name not in self.superclass_names:
            self.superclass_names.append(name)

    def all_superclass_names(self) -> Set[str]:
        out: Set[str] = set()
        stack = list(self.superclass_names)
        while stack:
            n = stack.pop()
            if n in out:
                continue
            out.add(n)
            sup = self._schema.get_class(n)
            if sup is not None:
                stack.extend(sup.superclass_names)
        return out

    def is_subclass_of(self, name: str) -> bool:
        return name == self.name or name in self.all_superclass_names()

    def subclasses(self, include_self: bool = True) -> List["SchemaClass"]:
        """All classes at or below this one (polymorphic scan set)."""
        return [
            c
            for c in self._schema.classes()
            if c.is_subclass_of(self.name) and (include_self or c.name != self.name)
        ]

    @property
    def is_vertex_type(self) -> bool:
        return self.is_subclass_of("V")

    @property
    def is_edge_type(self) -> bool:
        return self.is_subclass_of("E")

    def __repr__(self) -> str:
        sup = f" extends {','.join(self.superclass_names)}" if self.superclass_names else ""
        return f"SchemaClass({self.name}{sup})"


class Schema:
    """Class registry + cluster-id allocation ([E] OSchemaShared)."""

    FIRST_USER_CLUSTER = 1

    def __init__(self) -> None:
        self._classes: Dict[str, SchemaClass] = {}
        self._next_cluster = Schema.FIRST_USER_CLUSTER
        self.create_class("V")
        self.create_class("E")

    def create_class(
        self,
        name: str,
        superclasses: Iterable[str] = (),
        abstract: bool = False,
        clusters: int = 1,
    ) -> SchemaClass:
        if self.get_class(name) is not None:
            raise ValueError(f"class '{name}' already exists")
        cls = SchemaClass(self, name, [])
        cls.abstract = abstract
        for sup in superclasses:
            cls.add_superclass(sup)
        ids = [] if abstract else [self._allocate_cluster() for _ in range(clusters)]
        cls.cluster_ids = list(ids)
        self._classes[name.lower()] = cls
        return cls

    def create_vertex_class(self, name: str, **kw) -> SchemaClass:
        return self.create_class(name, superclasses=("V",), **kw)

    def create_edge_class(self, name: str, **kw) -> SchemaClass:
        return self.create_class(name, superclasses=("E",), **kw)

    def get_class(self, name: str) -> Optional[SchemaClass]:
        return self._classes.get(name.lower())

    def get_class_or_raise(self, name: str) -> SchemaClass:
        c = self.get_class(name)
        if c is None:
            raise ValueError(f"class '{name}' not found in schema")
        return c

    def classes(self) -> List[SchemaClass]:
        return list(self._classes.values())

    def _allocate_cluster(self) -> int:
        cid = self._next_cluster
        self._next_cluster += 1
        return cid
