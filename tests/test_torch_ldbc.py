"""The port's edge bindings, edge-property WHERE and OPTIONAL arms on the
social graph of `tests/conftest.py`, and the LDBC SNB interactive short
reads IS1–IS7 (`orientdb_tpu/workloads/ldbc.py`) on the seeded SNB graph of
`tests/test_ldbc_is.py`, against the reference package on the CPU.

Both graphs are carried across from reference snapshots with their edge
property columns. Each query runs through the port twice (the recording
and the replay) and must give the rows of both reference engines, in
order where the query has ORDER BY (`tests/test_torch_edges.py`'s
`_same_as_reference`).
"""

import pytest
import torch

from orientdb_tpu.storage.ingest import generate_ldbc_snb
from orientdb_tpu.storage.snapshot import attach_fresh_snapshot
from orientdb_tpu.workloads.ldbc import IS_QUERIES
from test_ldbc_is import MESSAGE_IDS, PERSON_IDS
from test_torch_edges import _carry, _same_as_reference

# tests/test_tpu_match.py's edge, OPTIONAL and .out() cases on the social
# graph, and edge aliases and edge WHERE over its Likes.weight column
SOCIAL = [
    "MATCH {class:Profiles, as:p}-Likes->{as:d, where:(age > 35)} RETURN p.name AS p, d.name AS d",
    "MATCH {class:Profiles, as:p}.out('Likes'){as:d} RETURN p.name AS p, d.name AS d",
    "MATCH {class:Profiles, as:p}-Likes->{as:d} RETURN p.name AS p, d.name AS d",
    "MATCH {class:Profiles, as:p}-Likes->{as:l, optional:true} RETURN p.name AS p, l.name AS l",
    "MATCH {class:Profiles, as:p}-Likes{as:k, where:(weight > 2)}->{as:d} "
    "RETURN p.name AS p, d.name AS d, k.weight AS w",
    "MATCH {class:Profiles, as:p}.outE('Likes'){as:e} RETURN p.name AS p, e.weight AS w",
    "MATCH {class:Profiles, as:p}.inE('HasFriend'){as:e}.outV(){as:f} RETURN p.name AS p, f.name AS f",
    "MATCH {class:Profiles, as:p}-HasFriend->{as:f}, "
    "{as:f}-Likes{as:k, optional:true}->{as:x} RETURN p.name AS p, f.name AS f, x.name AS x, "
    "k IS NULL AS none, NOT (k IS NULL) AND x IS NOT NULL AS both",
    "MATCH {class:Profiles, as:p}-HasFriend->{as:f, where:(age > p.age)} RETURN p.name AS p, f.name AS f",
    "MATCH {class:Profiles, as:p}-HasFriend->{as:f, optional:true, maxDepth:1, where:(age > 36)} "
    "RETURN p.name AS p, f.name AS f",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads, and the suite runs
    in parallel workers: keep torch to one thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_social_edge_and_optional_shapes(social_db):
    attach_fresh_snapshot(social_db)
    db, _snap = _carry(social_db)
    for sql in SOCIAL:
        assert len(_same_as_reference(db, social_db, sql)) > 0, sql


@pytest.fixture(scope="module")
def snb():
    jdb = generate_ldbc_snb(n_persons=80, seed=13)
    attach_fresh_snapshot(jdb)
    db, _snap = _carry(jdb)
    return jdb, db


@pytest.mark.parametrize("name", sorted(IS_QUERIES))
def test_ldbc_short_reads_equal_reference(snb, name):
    jdb, db = snb
    sql = IS_QUERIES[name]
    key = "personId" if ":personId" in sql else "messageId"
    any_rows = False
    for v in PERSON_IDS if key == "personId" else MESSAGE_IDS:
        any_rows = bool(_same_as_reference(db, jdb, sql, {key: v})) or any_rows
    assert any_rows, f"{name}: no parameter produced rows"


def test_is7_knows_flag_is_a_left_join(snb):
    """Every direct reply appears, and the flag is a bool."""
    jdb, db = snb
    base = (
        "MATCH {class:Message, as:m, where:(id = :messageId)}"
        "<-replyOf-{as:c} RETURN c.id AS commentId"
    )
    flags = set()
    for mid in MESSAGE_IDS:
        replies = {r["commentId"] for r in db.query(base, {"messageId": mid}).to_dicts()}
        rows = db.query(IS_QUERIES["IS7"], {"messageId": mid}).to_dicts()
        assert {r["commentId"] for r in rows} == replies
        for r in rows:
            assert isinstance(r["replyAuthorKnowsOriginalMessageAuthor"], bool)
            flags.add(r["replyAuthorKnowsOriginalMessageAuthor"])
    assert flags, "no replies at these messages"
