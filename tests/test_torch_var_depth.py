"""The port's variable-depth MATCH arms (``while:`` / ``maxDepth:`` /
``depthAlias:``, rows and COUNT) and NOT arms against the reference
package's ``engine="tpu", strict=True`` on the same graphs, on the CPU.

Rows are compared under `canonical_rows`, counts exactly; the chip
queries V1–V3 of `chip_smoke.py` (at small ``k``) are also held against
the numpy breadth-first walk of `storage/bigshape.py`. The graphs are
small: Person–knows from the array-native builder (with and without
supernodes) and the parameter-generic demodb carried across from a
reference snapshot. Replays (second and later calls) run the replay-mode
solve, at other parameter values too, and a value past the recorded
buffers re-records a second variant."""

import dataclasses

import numpy as np
import pytest
import torch

from orientdb_tpu.exec.result import canonical_rows as j_canonical_rows
from orientdb_tpu.ops.predicates import Uncompilable as JUncompilable
from orientdb_tpu.storage.bigshape import build_person_knows as j_build_person_knows
from orientdb_tpu.storage.ingest import generate_demodb
from orientdb_tpu.storage.snapshot import build_snapshot
from orientdb_tpu_torch.carry import snapshot_from_arrays
from orientdb_tpu_torch.exec import tpu_engine as TE
from orientdb_tpu_torch.exec.result import canonical_rows
from orientdb_tpu_torch.ops.device_graph import device_graph
from orientdb_tpu_torch.ops.predicates import Uncompilable
from orientdb_tpu_torch.sql.parser import parse
from orientdb_tpu_torch.storage.bigshape import (
    build_person_knows,
    numpy_2hop_count,
    numpy_has_out_neighbour,
    numpy_var_depth_rows,
)
from orientdb_tpu_torch.utils.config import config

# chip_smoke.py's queries
V1 = (
    "MATCH {class:Person, as:p, where:(uid < 200)}"
    "-knows->{as:f, while:($depth < 3), where:(age < 30)} RETURN count(*) AS n"
)
V2 = (
    "MATCH {class:Person, as:p, where:(uid < :k)}"
    "-knows-{as:f, maxDepth:2, depthAlias:d} RETURN p.uid AS p, f.uid AS f, d AS d"
)
V3 = (
    "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f}, "
    "NOT {as:f}-knows->{where:(age > 70)} RETURN p.uid AS p, f.uid AS f"
)
# an endpoint arm: reads each bound edge's source
OUTV = (
    "MATCH {class:Person, as:p, where:(uid < :k)}.outE('knows'){as:e}, "
    "{as:e}.outV(){as:s} RETURN p.uid AS p, s.uid AS s"
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads, and the suite runs
    in parallel workers: keep torch to one thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[0, 50], ids=["poisson", "supernodes"])
def person_knows(request):
    skew = request.param
    kw = dict(avg_knows=8, seed=3, supernodes=skew, supernode_degree=2_000 if skew else 0)
    jdb, _jsnap = j_build_person_knows(20_000, **kw)
    db, snap = build_person_knows(20_000, device="cpu", **kw)
    return jdb, db, snap


@pytest.fixture(scope="module")
def poisson():
    """The Poisson Person–knows graph alone, for the NOT and close-arm
    shapes (their bitmap chains are the slowest plain versions here)."""
    kw = dict(avg_knows=8, seed=3)
    jdb, _jsnap = j_build_person_knows(20_000, **kw)
    db, snap = build_person_knows(20_000, device="cpu", **kw)
    return jdb, db, snap


def _carry(jdb):
    """The reference database's snapshot arrays, carried into the port."""
    jsnap = jdb.current_snapshot()
    spec = [
        {"name": c.name, "superclasses": list(c.superclass_names), "abstract": c.abstract}
        for c in jdb.schema.classes()
    ]
    arrays = {
        "num_vertices": jsnap.num_vertices,
        "v_class": jsnap.v_class,
        "class_names": jsnap.class_names,
        "class_id_of": jsnap.class_id_of,
        "class_closure": jsnap.class_closure,
        "class_vertex_range": jsnap.class_vertex_range,
        "edge_closure": jsnap.edge_closure,
        "v_columns": {
            n: {"kind": c.kind, "values": c.values, "present": c.present, "dictionary": c.dictionary}
            for n, c in jsnap.v_columns.items()
        },
        "v_non_columnar": sorted(jsnap.v_non_columnar),
        "edge_classes": {
            n: {k: getattr(c, k) for k in ("indptr_out", "dst", "indptr_in", "src", "edge_id_in")}
            for n, c in jsnap.edge_classes.items()
        },
    }
    return snapshot_from_arrays(spec, arrays, device="cpu")


@pytest.fixture(scope="module")
def demodb():
    """tests/test_param_generic.py's graph: 400 profiles, ~6 friends each."""
    jdb = generate_demodb(n_profiles=400, avg_friends=6, seed=5)
    jdb.attach_snapshot(build_snapshot(jdb))
    db, snap = _carry(jdb)
    return jdb, db, snap


def _same(db, jdb, sql, params=None, calls: int = 1):
    """The port's rows (each of ``calls`` calls: a record, then replays)
    equal the reference's; returns the reference's rows."""
    want = jdb.query(sql, params, engine="tpu", strict=True).to_dicts()
    for call in range(calls):
        got = db.query(sql, params).to_dicts()
        if "ORDER BY" in sql:
            assert got == want, (sql, params, call)
        else:
            assert canonical_rows(got) == j_canonical_rows(want), (sql, params, call)
    return want


def _variants(snap, sql):
    stmt = parse(sql)
    cfg = dataclasses.astuple(config)
    found = [v for k, v in TE._plan_cache(snap).items() if k[0] == stmt and k[2] == cfg]
    assert len(found) == 1, f"{len(found)} cache entries for {sql}"
    return found[0]


# ---------------------------------------------------------------------------
# demodb: tests/test_tpu_match.py's variable-depth shapes
# ---------------------------------------------------------------------------

# tests/test_tpu_match.py:73-83, rooted at a profile of the carried graph
DEMO_VAR_DEPTH = [
    "MATCH {class:Profiles, as:p, where:(uid = 3)}-HasFriend->{as:f, while:($depth < 2)} RETURN f.name AS f",
    "MATCH {class:Profiles, as:p, where:(uid = 3)}-HasFriend->{as:f, maxDepth:2} RETURN f.name AS f",
    "MATCH {class:Profiles, as:p, where:(uid = 3)}-HasFriend->{as:f, while:($depth < 3), where:(age < 36)} "
    "RETURN f.name AS f",
    "MATCH {class:Profiles, as:p, where:(uid = 3)}-HasFriend->{as:f, maxDepth:3, depthAlias:d} "
    "RETURN f.name AS f, d AS d",
    "MATCH {class:Profiles, as:p, where:(uid = 3)}<-HasFriend-{as:f, maxDepth:2} RETURN f.name AS f",
    "MATCH {class:Profiles, as:p, where:(uid = 3)}-HasFriend-{as:f, while:($depth < 2)} RETURN f.name AS f",
    "MATCH {class:Profiles, as:p, where:(uid = 3)}-HasFriend->{as:f, while:($depth < 4 AND age < 39)} "
    "RETURN f.name AS f",
    "MATCH {class:Profiles, as:p}-HasFriend->{as:f, maxDepth:2} RETURN count(*) AS n",
    # a depth alias under the DISTINCT / ORDER BY / LIMIT tail
    "MATCH {class:Profiles, as:p, where:(uid < 6)}-HasFriend->{as:f, maxDepth:3, depthAlias:d} "
    "RETURN p.uid AS p, f.uid AS f, d AS d ORDER BY d DESC, p, f LIMIT 40",
    # every edge class, both directions
    "MATCH {class:Profiles, as:p, where:(uid < 3)}--{as:f, maxDepth:2, depthAlias:d} "
    "RETURN p.uid AS p, f.uid AS f, d AS d",
]


@pytest.mark.parametrize("sql", DEMO_VAR_DEPTH)
def test_demodb_var_depth_equals_reference(demodb, sql):
    jdb, db, snap = demodb
    want = _same(db, jdb, sql, calls=2)
    assert len(want) > 0


# tests/test_count_pushdown.py:146-205 (TestVarDepthCountPushdown)
VD_COUNT = (
    "MATCH {class:Profiles, as:p, where:(uid < :k)}"
    "-HasFriend->{as:f, while:($depth < 3), where:(age < 30)} RETURN count(*) AS n"
)


def test_var_depth_count_parity_across_parameters(demodb):
    jdb, db, snap = demodb
    for k in (0, 1, 3, 5, 40):
        _same(db, jdb, VD_COUNT, {"k": k})
    # one recorded plan (k=0 records an empty table; k=1 overflows it)
    # serves the later values or re-records; every answer was checked
    assert len(_variants(snap, VD_COUNT).plans) >= 1


def test_var_depth_count_engaged_and_shapes_excluded(demodb):
    jdb, db, snap = demodb

    def solver(sql):
        return TE.TpuMatchSolver(db, parse(sql), {})

    eligible = solver(
        "MATCH {class:Profiles, as:p}-HasFriend->{as:f, while:($depth < 2)} RETURN count(*) AS n"
    )
    assert eligible._var_count_step() is not None and eligible._count_pushdown_steps() == []
    rows = solver("MATCH {class:Profiles, as:p}-HasFriend->{as:f, while:($depth < 2)} RETURN f.name AS n")
    assert rows._var_count_step() is None
    shared = solver(
        "MATCH {class:Profiles, as:p}-HasFriend->{as:f, while:($depth < 2)}, "
        "{as:f}-Likes->{as:x} RETURN count(*) AS n"
    )
    assert shared._var_count_step() is None


@pytest.mark.parametrize(
    "sql",
    [
        "MATCH {class:Profiles, as:p, where:(uid = 0)}-HasFriend->{as:f, while:(true)} RETURN count(*) AS n",
        "MATCH {class:Profiles, as:p}-HasFriend->{as:f, maxDepth:2} RETURN count(*) AS n",
    ],
    ids=["unbounded_while", "max_depth"],
)
def test_var_depth_count_shapes(demodb, sql):
    jdb, db, snap = demodb
    assert _same(db, jdb, sql, calls=2)[0]["n"] > 0


def test_param_generic_var_depth_node_mask(demodb):
    """tests/test_param_generic.py:44: a parameter inside the var-depth
    arm's node mask; one recording, then replays at other values (or a
    re-record where a value overflows the recorded buffers)."""
    jdb, db, snap = demodb
    sql = (
        "MATCH {class:Profiles, as:p, where:(uid < :c)}"
        "-HasFriend->{as:f, while:($depth < 2), where:(age < :d)} RETURN p.uid AS p, f.uid AS f"
    )
    params = [
        {"c": 25, "d": 40},
        {"c": 3, "d": 25},
        {"c": 120, "d": 79},
        {"c": 60, "d": 55},
        {"c": 25, "d": 40},
    ]
    for p in params:
        _same(db, jdb, sql, p)
    v = _variants(snap, sql)
    assert sum(plan.replays for plan in v.plans) >= 2


# ---------------------------------------------------------------------------
# Person–knows: the chip queries, NOT arms, close arms, the pushdown stops
# ---------------------------------------------------------------------------


def _rows(got, names):
    arr = np.array([tuple(r[n] for n in names) for r in got], np.int64).reshape(-1, len(names))
    return arr[np.lexsort(arr.T[::-1])]


def test_v1_var_depth_count(person_knows):
    jdb, db, snap = person_knows
    age = snap.v_columns["age"].values
    want = numpy_var_depth_rows(snap, range(200), "out", age < 30, while_depth=3)
    assert db.query(V1).to_dicts() == [{"n": int(want.shape[0])}]
    _same(db, jdb, V1, calls=2)


def test_v2_rows_with_depth_alias_replay_and_rerecord(person_knows):
    jdb, db, snap = person_knows
    V = snap.num_vertices
    for call, k in enumerate((16, 8, 16, 64)):
        got = db.query(V2, {"k": k}).to_dicts()
        want = numpy_var_depth_rows(snap, range(k), "both", np.ones(V, bool), max_depth=2)
        assert np.array_equal(_rows(got, ("p", "f", "d")), want), (call, k)
        _same(db, jdb, V2, {"k": k})
    v = _variants(snap, V2)
    # two calls a value: every call at k=16 and k=8 after the first
    # replayed the k=16 recording (5 replays); k=64 overflowed its root
    # buckets (a 6th replay, discarded), recorded a second variant, and
    # its second call replayed that one
    assert len(v.plans) == 2
    assert v.plans[1].replays == 6 and v.plans[0].replays == 1
    assert v.plans[1].d_names == ["d"] and v.plans[1].ncols == 3


def test_v3_not_arm(poisson):
    jdb, db, snap = poisson
    csr = snap.edge_classes["knows"]
    age = snap.v_columns["age"].values
    drop = numpy_has_out_neighbour(snap, age > 70)
    for k in (16, 8, 16):
        p = np.repeat(np.arange(k), np.diff(csr.indptr_out[: k + 1]))
        f = csr.dst[: csr.indptr_out[k]].astype(np.int64)
        want = np.stack([p, f], 1)[~drop[f]]
        want = want[np.lexsort(want.T[::-1])]
        got = db.query(V3, {"k": k}).to_dicts()
        assert np.array_equal(_rows(got, ("p", "f")), want), k
        _same(db, jdb, V3, {"k": k})
    assert _variants(snap, V3).plans[0].replays == 5  # every call after the first


# tests/test_tpu_fuzz.py:64-67, onto knows (the port has no edge WHERE)
NOT_ARMS = [
    "MATCH {class:Person, as:a, where:(uid < 30)}-knows->{as:b}, NOT {as:b}-knows->{as:a} "
    "RETURN a.uid AS a, b.uid AS b",
    "MATCH {class:Person, as:a, where:(uid < 60)}, NOT {as:a}-knows->{where:(age > 60)} RETURN a.uid AS a",
    "MATCH {class:Person, as:a, where:(uid < 40)}, NOT {as:a}-knows->{}-knows->{where:(age > 78)} "
    "RETURN a.uid AS a",
    "MATCH {class:Person, as:a, where:(uid < 100)}, NOT {as:a}-knows->{where:(age > 75)} RETURN count(*) AS n",
    # two NOT arms, one of them walking in
    "MATCH {class:Person, as:a, where:(uid < 30)}-knows->{as:b}, NOT {as:a}<-knows-{where:(age < 20)}, "
    "NOT {as:b}-knows->{as:a} RETURN a.uid AS a, b.uid AS b",
]


@pytest.mark.parametrize("sql", NOT_ARMS)
def test_not_arms_equal_reference(poisson, sql):
    jdb, db, snap = poisson
    want = _same(db, jdb, sql, calls=2)
    assert len(want) > 0


NOT_COUNT = (
    "MATCH {class:Person, as:a, where:(uid < 100)}-knows->{as:b}, "
    "NOT {as:b}-knows->{where:(age > 70)} RETURN count(*) AS n"
)


def test_not_arm_disables_the_count_pushdown(poisson):
    """A COUNT over a hop with a NOT arm: the anti-join needs the rows, so
    the hop must not collapse into a weight pass."""
    jdb, db, snap = poisson
    s = TE.TpuMatchSolver(db, parse(NOT_COUNT), {})
    assert s._count_pushdown_steps() == [] and s._var_count_step() is None
    csr = snap.edge_classes["knows"]
    drop = numpy_has_out_neighbour(snap, snap.v_columns["age"].values > 70)
    want = int((~drop[csr.dst[: csr.indptr_out[100]]]).sum())
    assert 0 < want < csr.indptr_out[100]
    assert db.query(NOT_COUNT).to_dicts() == [{"n": want}]
    _same(db, jdb, NOT_COUNT, calls=2)


@pytest.mark.parametrize(
    "sql",
    [
        "MATCH {class:Person, as:p, where:(uid < 6)}-knows->{as:f}"
        "-knows-{as:p, while:($depth < 3)} RETURN p.uid AS p, f.uid AS f",
        "MATCH {class:Person, as:p, where:(uid < 6)}-knows->{as:f}"
        "-knows-{as:p, maxDepth:3, depthAlias:d} RETURN p.uid AS p, f.uid AS f, d AS d",
        "MATCH {class:Person, as:p, where:(uid < 6)}-knows->{as:f}"
        "-knows->{as:p, while:($depth < 3)} RETURN count(*) AS n",
    ],
    ids=["close_rows", "close_depth_alias", "close_count"],
)
def test_close_var_depth_arm(poisson, sql):
    """A cyclic arm whose target is already bound: only the bound vertex
    may be emitted."""
    jdb, db, snap = poisson
    want = _same(db, jdb, sql, calls=2)
    assert len(want) > 0


WHILE_THEN_HOP = (
    "MATCH {class:Person, as:p, where:(uid < 20)}-knows->{as:f, while:($depth < 2)}"
    "-knows->{as:g, where:(age < 30)} RETURN count(*) AS n"
)


def test_count_pushdown_stops_at_the_while_arm(person_knows):
    """A COUNT whose WHILE arm is followed by a fixed hop: the pushdown
    takes the fixed hop only; taken as a fixed hop too, the WHILE arm
    would give a wrong count."""
    jdb, db, snap = person_knows
    V = snap.num_vertices
    age = snap.v_columns["age"].values
    walk = numpy_var_depth_rows(snap, range(20), "out", np.ones(V, bool), while_depth=2)
    csr = snap.edge_classes["knows"]
    young = np.concatenate([[0], np.cumsum((age[csr.dst] < 30).astype(np.int64))])
    deg_young = np.diff(young[csr.indptr_out.astype(np.int64)])
    want = int(deg_young[walk[:, 1]].sum())
    assert want != numpy_2hop_count(snap, np.arange(V) < 20, np.ones(V, bool), age < 30)
    assert db.query(WHILE_THEN_HOP).to_dicts() == [{"n": want}]
    _same(db, jdb, WHILE_THEN_HOP, calls=2)
    s = TE.TpuMatchSolver(db, parse(WHILE_THEN_HOP), {})
    suffix = s._count_pushdown_steps()
    assert [st.edge.to_alias for st in suffix] == ["g"]


def test_edge_src_uploads_on_the_first_bitmap_hop():
    """Bitmap hops walk the CSR (K10's CSR form), so a variable-depth
    recording leaves the per-edge sources on the host; they reach the
    device with the first read that needs them (an ``.outV()`` endpoint
    arm), not before, and a replay that would upload them raises."""
    db, snap = build_person_knows(800, avg_knows=4, seed=4, device="cpu")
    dg = device_graph(snap, db.device)
    key = "e:knows:edge_src"
    db.query("MATCH {class:Person, as:p, where:(age > 40)}-knows->{as:f} RETURN count(*) AS n")
    assert key not in dg.arrays and key in dg._pending
    db.query(V2, {"k": 5}).to_dicts()
    assert key not in dg.arrays and key in dg._pending
    rows = db.query(OUTV, {"k": 5}).to_dicts()
    assert rows and key in dg.arrays
    assert np.array_equal(dg.arrays[key].numpy(), snap.edge_classes["knows"].edge_src)
    dg._pending[key] = lambda: snap.edge_classes["knows"].edge_src
    del dg.arrays[key]
    with pytest.raises(RuntimeError, match="upload during a replay"):
        db.query(OUTV, {"k": 5})
    dg.ensure_key(key)
    assert canonical_rows(db.query(OUTV, {"k": 5}).to_dicts()) == canonical_rows(rows)


@pytest.mark.parametrize(
    "sql",
    [
        "MATCH {class:Profiles, as:p}-HasFriend->{as:f, while:($depth < 3), pathAlias:pa} RETURN count(*) AS n",
        "MATCH {class:Profiles, as:p}-HasFriend->{as:f}, "
        "NOT {as:p}-HasFriend->{as:g, while:($depth < 2)} RETURN count(*) AS n",
        "MATCH {class:Profiles, as:p}-HasFriend->{as:f, while:($depth < p.age)} RETURN count(*) AS n",
    ],
    ids=["path_alias", "var_depth_not_arm", "while_references_binding"],
)
def test_refused_by_both_packages(demodb, sql):
    jdb, db, snap = demodb
    with pytest.raises(Uncompilable):
        db.query(sql)
    with pytest.raises(JUncompilable):
        jdb.query(sql, engine="tpu", strict=True)
