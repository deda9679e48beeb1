"""Edge-class targets in the port (`orientdb_tpu_torch`) against the
reference's oracle, on the CPU.

A compiled root scans the vertex hull of its classes. An edge class (or
``E``) has none, so a root over one would answer 0 or no rows where the
reference's oracle reads edge records: the port refuses such a statement
with `Uncompilable`, on one device and on a 3-shard mesh, and through
`query_batch` too. A non-root node with an edge-class filter admits no
vertex in the oracle either, so it still compiles and equals the oracle.
The graph is the reference's ``generate_demodb`` (300 profiles, 4 friends,
seed 11), carried into the port with `carry.snapshot_from_arrays`.
"""

import pytest

from orientdb_tpu.storage.ingest import generate_demodb
from orientdb_tpu.storage.snapshot import attach_fresh_snapshot
from orientdb_tpu_torch.ops.predicates import Uncompilable
from orientdb_tpu_torch.parallel.sharded import make_mesh
from tests.test_torch_traverse import carry

#: statements whose root (or SELECT / TRAVERSE target) is an edge class
EDGE_ROOTS = [
    "SELECT count(*) FROM HasFriend",
    "SELECT count(*) FROM Likes WHERE weight > 5",
    "MATCH {class: HasFriend, as: e} RETURN count(*)",
    "SELECT FROM HasFriend LIMIT 3",
    "SELECT FROM E LIMIT 2",
    "MATCH {class: Profiles, as: p, where: (uid < 3)}, {class: Likes, as: l} RETURN count(*)",
    "TRAVERSE out('HasFriend') FROM HasFriend STRATEGY BREADTH_FIRST",
    "TRAVERSE out('HasFriend') FROM (SELECT FROM HasFriend) STRATEGY BREADTH_FIRST",
]

#: statements whose edge-class filter sits on a non-root node; in the last
#: two the edge class (Likes, 150 edges) has the smaller estimate than the
#: vertex side (300 profiles), so the root goes to the vertex side
NON_ROOT = [
    "MATCH {class: Profiles, as: p}-HasFriend->{class: HasFriend, as: x} RETURN count(*) AS n",
    "MATCH {class: Profiles, as: p, where: (uid < 20)}-HasFriend->{as: f, class: Likes} RETURN p.uid AS p",
    "MATCH {class: Profiles, as: p}-HasFriend->{class: Likes, as: x} RETURN count(*) AS n",
    "MATCH {class: Likes, as: x}<-HasFriend-{class: Profiles, as: p} RETURN p.uid AS p",
]


@pytest.fixture(scope="module")
def demo():
    """The reference database, and its port twins: one device and a
    3-shard CPU mesh, by shard count."""
    jdb = generate_demodb(n_profiles=300, avg_friends=4, seed=11)
    jsnap = attach_fresh_snapshot(jdb)
    db1, _ = carry(jdb, jsnap)
    db3, snap3 = carry(jdb, jsnap)
    db3.attach_snapshot(snap3, mesh=make_mesh(3, device="cpu"))
    return jdb, {1: db1, 3: db3}


def _empty(rows) -> bool:
    return not rows or all(v in (0, None) for r in rows for v in r.values() if not isinstance(v, str))


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("sql", EDGE_ROOTS)
def test_edge_class_root_is_refused(demo, sql, shards):
    jdb, dbs = demo
    db = dbs[shards]
    oracle = jdb.query(sql, engine="oracle").to_dicts()
    assert not _empty(oracle), f"the oracle answers {oracle} for {sql}"
    with pytest.raises(Uncompilable):
        db.query(sql).to_dicts()
    with pytest.raises(Uncompilable):
        [rs.to_dicts() for rs in db.query_batch([sql, sql])]


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("sql", NON_ROOT)
def test_non_root_edge_class_filter_equals_oracle(demo, sql, shards):
    jdb, dbs = demo
    want = jdb.query(sql, engine="oracle").to_dicts()
    for _ in range(2):  # the recording, then the replay
        assert dbs[shards].query(sql).to_dicts() == want
