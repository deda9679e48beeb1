"""Port of `orientdb_tpu/models/database.py`, trimmed to what the compiled
MATCH path reads: the schema, the attached snapshot, class counts for the
planner's estimates, ``query`` and the device the database runs on.

Records, transactions and the write-ahead log are not ported: a port
database is a schema over an attached columnar snapshot, which is what the
reference's array-native builders (`storage/bigshape.py`) produce as well.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from orientdb_tpu_torch.models.schema import Schema


def resolve_device(device=None) -> torch.device:
    """The device a database runs on: the CUDA card unless the caller asks
    for the CPU. Raises when CUDA is wanted and absent: nothing carries on
    quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class Database:
    """A schema plus an attached snapshot, answering MATCH on ``device``."""

    def __init__(self, name: str = "db", device=None) -> None:
        self.name = name
        self.device = resolve_device(device)
        self.schema = Schema()
        self._snapshot = None

    def attach_snapshot(self, snapshot) -> None:
        self._snapshot = snapshot

    def current_snapshot(self):
        return self._snapshot

    def count_class(self, class_name: str) -> int:
        """Polymorphic member count of a class, read off the attached
        snapshot: the reference counts live records, which equal the
        snapshot's members whenever the snapshot is fresh."""
        snap = self._snapshot
        if snap is None:
            return 0
        cls = self.schema.get_class_or_raise(class_name)
        if cls.is_edge_type:
            return sum(
                snap.edge_classes[c].num_edges
                for c in snap.concrete_edge_classes(cls.name)
            )
        total = 0
        for cid in snap.class_closure.get(cls.name.lower(), ()):
            lo, hi = snap.class_vertex_range.get(
                snap.class_names[cid].lower(), (0, 0)
            )
            total += max(hi - lo, 0)
        return total

    def query(self, sql: str, params: Optional[Dict[str, object]] = None):
        """Run a MATCH statement on the compiled path
        ([E] ODatabaseSession.query)."""
        from orientdb_tpu_torch.exec.engine import execute_query

        return execute_query(self, sql, params)
