"""Record rows, rid filters and compiled SELECT in the port
(`orientdb_tpu_torch`) against the reference package, on the CPU.

The graphs are the reference's (`generate_demodb`, the `social_db`
fixture), carried into the port with their RIDs. Record dicts must equal the
reference's without ``@version`` (the port's snapshot holds no versions);
rows compare in order where the statement orders them, as multisets
otherwise. Covered: the snapshot's RID lookups, the SELECT shapes of the
reference's SELECT suite (the compiled ones equal, the others refused with
their reason), whole-record SELECT as element rows and its parameter-generic
replay, rid filters and the record RETURNs of MATCH (``p``, ``p.@rid``,
``p.@class``, ``$matches``, ``$elements``), the five parity-gated statements
of the reference's bench, and the lazy `RecordRows`.
"""

import numpy as np
import pytest
import torch

from orientdb_tpu.storage.ingest import generate_demodb
from orientdb_tpu.storage.snapshot import attach_fresh_snapshot
from orientdb_tpu_torch.exec import tpu_engine as TE
from orientdb_tpu_torch.exec.result import RecordRows, canonical_rows
from orientdb_tpu_torch.models.rid import RID
from orientdb_tpu_torch.ops.predicates import Uncompilable
from orientdb_tpu_torch.sql.parser import parse
from tests.test_select_compile import PARITY_QUERIES
from tests.test_torch_traverse import carry, records

#: the reference's SELECT suite shapes the port refuses, with the reason
REFUSED_SELECTS = {
    "SELECT max(age) AS m, min(age) AS mi, count(*) AS c FROM Profiles WHERE uid < 100": "aggregate",
    "SELECT age, count(*) AS c FROM Profiles WHERE uid < 200 GROUP BY age ORDER BY c DESC, age ASC LIMIT 3": "GROUP BY",
}

# the reference bench's five parity-gated statements (bench.py:1272-1298)
BENCH = [
    "MATCH {class:Profiles, as:p, where:(age > 40)}-HasFriend->{as:f}"
    "-HasFriend->{as:g, where:(age < 30)} RETURN count(*) AS n",
    "MATCH {class:Profiles, as:p, where:(age > 40)}-HasFriend->{as:f, where:(age < 30)} "
    "RETURN p.uid AS p, f.uid AS f",
    "MATCH {class:Profiles, as:p, where:(uid < 200)}"
    "-HasFriend->{as:f, while:($depth < 3), where:(age < 30)} RETURN count(*) AS n",
    "TRAVERSE out('HasFriend') FROM (SELECT FROM Profiles WHERE uid < 50) "
    "WHILE $depth < 2 STRATEGY BREADTH_FIRST",
    "SELECT count(*) AS n FROM Profiles WHERE age > 35 AND age < 55",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def demodb():
    jdb = generate_demodb(n_profiles=400, avg_friends=5, seed=11)
    jsnap = attach_fresh_snapshot(jdb)
    db, snap = carry(jdb, jsnap)
    return jdb, db, snap


@pytest.fixture
def social(social_db):
    jsnap = attach_fresh_snapshot(social_db)
    db, snap = carry(social_db, jsnap)
    return social_db, db, snap


def ref(jdb, sql, params=None):
    return records(jdb.query(sql, params or {}, engine="tpu", strict=True).to_dicts())


def assert_rows(got, want, ordered):
    if ordered:
        assert got == want
    else:
        assert canonical_rows(got) == canonical_rows(want)


def test_snapshot_rids_equal_reference(demodb):
    jdb, db, snap = demodb
    jsnap = jdb.current_snapshot()
    ids = np.array([0, 5, 17, snap.num_vertices - 1])
    c, p = snap.rids_of(ids)
    for k, i in enumerate(ids.tolist()):
        jr = jsnap.rid_of(i)
        assert snap.rid_of(i) == RID(jr.cluster, jr.position) == RID(int(c[k]), int(p[k]))
        assert snap.idx_of(snap.rid_of(i)) == jsnap.idx_of(jr) == i
    assert snap.idx_of(RID(int(c[0]), 10_000)) is None


@pytest.mark.parametrize("sql", PARITY_QUERIES)
def test_select_suite(demodb, sql):
    jdb, db, snap = demodb
    if sql in REFUSED_SELECTS:
        with pytest.raises(Uncompilable, match=REFUSED_SELECTS[sql]):
            db.query(sql)
        return
    want = ref(jdb, sql)
    for _ in range(2):  # the recording, then the replay
        assert_rows(db.query(sql).to_dicts(), want, "ORDER BY" in sql)


def test_whole_record_rows_are_elements(demodb):
    jdb, db, snap = demodb
    rows = db.query("SELECT FROM Profiles WHERE uid = 7").to_list()
    assert len(rows) == 1 and rows[0].is_element
    assert rows[0].element["uid"] == 7 and rows[0].rid == snap.rid_of(7)
    assert rows[0].to_dict() == ref(jdb, "SELECT FROM Profiles WHERE uid = 7")[0]


def test_select_is_parameter_generic(demodb):
    jdb, db, snap = demodb
    sql = "SELECT FROM Profiles WHERE uid < :k"
    for k in (60, 25, 60):
        rs = db.query(sql, {"k": k})
        assert isinstance(rs._rows, RecordRows)
        assert_rows(rs.to_dicts(), ref(jdb, sql, {"k": k}), False)
    (variants,) = [v for key, v in TE._plan_cache(snap).items() if key[0] == parse(sql)]
    (plan,) = variants.plans
    assert plan.replays == 2


@pytest.mark.parametrize(
    "sql,reason",
    [
        ("SELECT out('HasFriend') FROM Profiles", "graph function"),
        ("SELECT * FROM Profiles", r"SELECT \*"),
        ("SELECT FROM #3:1", "polymorphic class"),
        ("SELECT name FROM Profiles LET $a = 1", "LET"),
    ],
    ids=["graph_function", "star", "rid_target", "let"],
)
def test_select_refusals_are_remembered(demodb, sql, reason):
    jdb, db, snap = demodb
    for _ in range(2):
        with pytest.raises(Uncompilable, match=reason):
            db.query(sql)
    assert isinstance(TE._TRANSLATE_CACHE[parse(sql)], str)


MATCH_RECORDS = [
    "MATCH {class:Profiles, as:p}-HasFriend->{as:f} RETURN p, f",
    "MATCH {class:Profiles, as:p}-HasFriend->{as:f} RETURN $matches",
    "MATCH {class:Profiles, as:p}-HasFriend->{as:f} RETURN $elements",
    "MATCH {class:Profiles, as:p}-Likes->{as:l, optional:true} RETURN $matches",
    "MATCH {class:Profiles, as:p, where:(name = 'alice')}-HasFriend->{as:f} "
    "RETURN p.@rid AS r, f.@class AS c, f.name AS n",
    "MATCH {class:Profiles, as:p}-HasFriend->{as:f} RETURN DISTINCT f ORDER BY f DESC LIMIT 3",
    "MATCH {class:Profiles, as:p}-HasFriend->{as:f} RETURN p.@rid AS r, f ORDER BY r, f SKIP 1",
]


@pytest.mark.parametrize("sql", MATCH_RECORDS)
def test_match_record_returns(social, sql):
    jdb, db, snap = social
    want = ref(jdb, sql)
    assert len(want) > 0
    for _ in range(2):
        assert_rows(db.query(sql).to_dicts(), want, "ORDER BY" in sql)


@pytest.mark.parametrize("who", ["alice", "eve", "missing"])
def test_rid_filter(social, who):
    jdb, db, snap = social
    rid = "#3:999" if who == "missing" else jdb._test_vertices[who].rid
    for sql in (
        f"MATCH {{rid:{rid}, as:p}}-HasFriend->{{as:f}} RETURN f.name AS f",
        f"MATCH {{class:Profiles, rid:{rid}, as:p}}-HasFriend->{{as:f}} RETURN p, f, f.@class",
        f"MATCH {{class:Profiles, as:p}}-HasFriend->{{rid:{rid}, as:f}} RETURN count(*) AS n",
    ):
        want = ref(jdb, sql)
        for _ in range(2):
            assert_rows(db.query(sql).to_dicts(), want, False)


@pytest.mark.parametrize(
    "sql",
    [
        "MATCH {class:Profiles, as:p}.outE('Likes'){as:e} RETURN e",
        "MATCH {class:Profiles, as:p}.outE('Likes'){as:e} RETURN $elements",
        "MATCH {class:Profiles, as:p}-Likes{as:e}->{as:q} RETURN e.@rid",
        "MATCH {class:Profiles, as:p}-HasFriend->{as:f} RETURN $paths",
        "MATCH {class:Profiles, as:p}-HasFriend->{as:f} RETURN p.@version",
    ],
    ids=["edge_record", "edge_elements", "edge_rid", "paths", "version"],
)
def test_record_refusals(social, sql):
    jdb, db, snap = social
    with pytest.raises(Uncompilable):
        db.query(sql)


def test_elements_need_columnar_properties(social):
    jdb, db, snap = social
    snap.v_non_columnar = {"blob"}
    with pytest.raises(Uncompilable, match="non-columnar"):
        db.query("MATCH {class:Profiles, as:p}-HasFriend->{as:f} RETURN $elements")
    # a RID needs no record
    assert len(db.query("MATCH {class:Profiles, as:p}-HasFriend->{as:f} RETURN p").to_dicts()) == 6


@pytest.mark.parametrize("sql", BENCH, ids=["count_2hop", "rows_1hop", "while", "traverse", "select_count"])
def test_bench_gated_statements(demodb, sql):
    jdb, db, snap = demodb
    want = ref(jdb, sql)
    oracle = records(jdb.query(sql, engine="oracle").to_dicts())
    assert canonical_rows(want) == canonical_rows(oracle)
    for _ in range(2):
        got = db.query(sql).to_dicts()
        assert canonical_rows(got) == canonical_rows(want)
    if sql.startswith("TRAVERSE"):
        assert got == want  # in order


def test_record_rows_are_lazy_and_columnar(demodb):
    jdb, db, snap = demodb
    rs = db.query("SELECT FROM Profiles WHERE age > 30")
    rows = rs._rows
    assert isinstance(rows, RecordRows) and len(rows) > 100
    dicts = rows.to_dicts()
    assert dicts == [r.to_dict() for r in rows]
    assert rs.to_dicts() == dicts
    assert RecordRows(snap, rows.ids[:7]).to_dicts() == dicts[:7]
    # an absent property leaves its key out
    col = snap.v_columns["surname"]
    col.present[int(rows.ids[0])] = False
    try:
        assert "surname" not in RecordRows(snap, rows.ids[:1]).to_dicts()[0]
        assert "surname" not in next(iter(rows)).to_dict()
    finally:
        col.present[int(rows.ids[0])] = True
