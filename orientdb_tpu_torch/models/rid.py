"""Port of `orientdb_tpu/models/rid.py`: record identity.

Every record is addressed ``#<clusterId>:<clusterPosition>``. In the
snapshot, RIDs map to dense vertex indices through the ``v_cluster`` /
``v_position`` arrays (`storage/snapshot.RidIndex`); this class is the
host-side identity only. A NamedTuple, so a RID compares and hashes as its
``(cluster, position)`` pair.
"""

from __future__ import annotations

from typing import NamedTuple


class RID(NamedTuple):
    cluster: int
    position: int

    def __str__(self) -> str:
        return f"#{self.cluster}:{self.position}"

    def __repr__(self) -> str:
        return f"RID({self.cluster}, {self.position})"

    @classmethod
    def parse(cls, text: str) -> "RID":
        t = text.strip()
        if not t.startswith("#"):
            raise ValueError(f"not a RID: {text!r}")
        c, _, p = t[1:].partition(":")
        return cls(int(c), int(p))
