"""TRAVERSE in the port (`orientdb_tpu_torch`, `TpuTraverseSolver` and
`_CompiledTraverse`) against the reference package, on the CPU.

Graphs come from the reference: the `social_db` fixture and
`generate_demodb`, snapshotted there and carried into the port with
`carry.snapshot_from_arrays` (RIDs included). Every statement of the
reference's TRAVERSE suite (`tests/test_tpu_traverse.py`), plus subquery,
RID, RID-list and missing-RID targets, must give the reference's
``engine="tpu"`` rows in order (record dicts without ``@version``, which the
port's snapshot does not hold) and the reference oracle's records as a set
by ``@rid``; the first call records, the second replays the cached plan.
Then the refusals, a batch's shared dispatch, delta maintenance (a batch
makes the plan re-record) against the reference's maintainer, tiering
against the reference's tier plane, and the plain versions of the three
kernel forms this path adds (K12's gate, K15's ID, K3's offset) against
numpy.
"""

import numpy as np
import pytest
import torch

from orientdb_tpu.storage.ingest import generate_demodb
from orientdb_tpu.storage.snapshot import attach_fresh_snapshot
from orientdb_tpu_torch.carry import snapshot_from_arrays
from orientdb_tpu_torch.exec import tpu_engine as TE
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.ops.predicates import Predicate, Uncompilable, id_term
from orientdb_tpu_torch.sql.parser import parse
from tests.test_torch_match import _carry_arrays
from tests.test_tpu_traverse import TRAVERSALS

EXTRA = [
    "TRAVERSE out('HasFriend') FROM (SELECT FROM Profiles WHERE name = 'alice') "
    "STRATEGY BREADTH_FIRST",
    "TRAVERSE out('HasFriend') FROM (SELECT FROM Profiles WHERE uid < 3) "
    "WHILE $depth < 3 AND age > 25 STRATEGY BREADTH_FIRST",
    "TRAVERSE both('HasFriend') FROM {rid} MAXDEPTH 2 STRATEGY BREADTH_FIRST",
    "TRAVERSE out('HasFriend') FROM [{rid2}, {rid}, {rid2}] STRATEGY BREADTH_FIRST",
    "TRAVERSE out('HasFriend') FROM [{missing}, {rid}] STRATEGY BREADTH_FIRST",
    "TRAVERSE out('HasFriend') FROM {missing}",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry(jdb, jsnap):
    """The reference snapshot's arrays, RIDs included, as a port database."""
    spec, arrays = _carry_arrays(jdb, jsnap)
    arrays["v_cluster"] = jsnap.v_cluster
    arrays["v_position"] = jsnap.v_position
    return snapshot_from_arrays(spec, arrays, device="cpu")


def records(rows):
    """Record dicts without the reference's ``@version``."""
    return [{k: v for k, v in r.items() if k != "@version"} for r in rows]


def assert_traverse_parity(jdb, db, sql, calls=2):
    want = records(jdb.query(sql, engine="tpu", strict=True).to_dicts())
    oracle = sorted(r["@rid"] for r in jdb.query(sql, engine="oracle").to_dicts())
    for _ in range(calls):  # the recording, then the replay
        got = db.query(sql).to_dicts()
        assert got == want, sql
        assert sorted(r["@rid"] for r in got) == oracle, sql
    return want


@pytest.fixture
def social(social_db):
    jsnap = attach_fresh_snapshot(social_db)
    db, snap = carry(social_db, jsnap)
    return social_db, db, snap


@pytest.fixture(scope="module")
def demodb():
    jdb = generate_demodb(n_profiles=120, avg_friends=4, seed=3)
    jsnap = attach_fresh_snapshot(jdb)
    db, snap = carry(jdb, jsnap)
    return jdb, db, snap


def _fill(sql, snap):
    c = int(snap.v_cluster[0])
    return sql.format(rid=f"#{c}:0", rid2=f"#{c}:3", missing=f"#{c}:4000")


@pytest.mark.parametrize("sql", TRAVERSALS + EXTRA)
def test_social_traversals_equal_reference(social, sql):
    jdb, db, snap = social
    assert_traverse_parity(jdb, db, _fill(sql, snap))


@pytest.mark.parametrize("sql", TRAVERSALS + EXTRA)
def test_demodb_traversals_equal_reference(demodb, sql):
    jdb, db, snap = demodb
    want = assert_traverse_parity(jdb, db, _fill(sql, snap))
    if "missing" not in sql and "alice" not in sql:  # demodb has no alice
        assert len(want) > 0


def test_while_gate_admits_at_depth_plus_one(social):
    """TRAVERSE's WHILE gate rejects a reached vertex at ``$depth + 1``: it is
    neither emitted nor visited. A var-depth MATCH arm gates the vertices it
    expands instead, so it emits bob (age 25) where TRAVERSE does not."""
    jdb, db, snap = social
    sql = (
        "TRAVERSE out('HasFriend') FROM (SELECT FROM Profiles WHERE name = 'alice') "
        "WHILE $depth < 3 AND age > 25 STRATEGY BREADTH_FIRST"
    )
    got = assert_traverse_parity(jdb, db, sql)
    assert [r["name"] for r in got] == ["alice", "carol", "dave"]
    match = (
        "MATCH {class:Profiles, as:p, where:(name = 'alice')}"
        "-HasFriend->{as:f, while:($depth < 3 AND age > 25)} RETURN f.name AS f"
    )
    assert "bob" in {r["f"] for r in db.query(match).to_dicts()}


def test_replay_uses_the_cached_plan(demodb):
    jdb, db, snap = demodb
    sql = "TRAVERSE out('HasFriend') FROM (SELECT FROM Profiles WHERE uid < 7) WHILE $depth < 2 STRATEGY BREADTH_FIRST"
    first = db.query(sql).to_dicts()
    (variants,) = [v for k, v in TE._plan_cache(snap).items() if k[0] == parse(sql)]
    (plan,) = variants.plans
    assert isinstance(plan, TE._CompiledTraverse) and plan.replays == 0
    assert plan.solver.levels[0] == 7 and sum(plan.solver.levels) == len(first)
    for n in (1, 2):
        assert db.query(sql).to_dicts() == first
        assert plan.replays == n and len(variants.plans) == 1


def test_parameters_join_the_plan_key(demodb):
    jdb, db, snap = demodb
    sql = "TRAVERSE out('HasFriend') FROM (SELECT FROM Profiles WHERE uid < :k) MAXDEPTH 1 STRATEGY BREADTH_FIRST"
    for k in (3, 9, 3):
        want = records(jdb.query(sql, {"k": k}, engine="tpu", strict=True).to_dicts())
        assert db.query(sql, {"k": k}).to_dicts() == want
    keys = [k for k in TE._plan_cache(snap) if k[0] == parse(sql)]
    assert len(keys) == 2


def test_batch_items_share_one_dispatch(demodb):
    jdb, db, snap = demodb
    sql = TRAVERSALS[7]
    want = records(jdb.query(sql, engine="tpu", strict=True).to_dicts())
    db.query(sql)  # records
    (variants,) = [v for k, v in TE._plan_cache(snap).items() if k[0] == parse(sql)]
    plan = variants.plans[0]
    before = plan.replays
    out = db.query_batch([sql] * 6 + ["SELECT count(*) AS n FROM Profiles"])
    assert [rs.to_dicts() for rs in out[:6]] == [want] * 6
    assert out[6].to_dicts() == [{"n": 120}]
    assert plan.replays == before + 1


@pytest.mark.parametrize("n", [TE._GROUP_MIN - 1, TE._GROUP_MIN, 2 * TE._GROUP_MIN])
def test_batch_at_the_group_threshold(demodb, n):
    """Identical TRAVERSE items below the group threshold replay one by one;
    from it on they share one dispatch, and no lane group is built."""
    jdb, db, snap = demodb
    sql = "TRAVERSE in('HasFriend') FROM (SELECT FROM Profiles WHERE uid < 5) MAXDEPTH 2 STRATEGY BREADTH_FIRST"
    want = records(jdb.query(sql, engine="tpu", strict=True).to_dicts())
    db.query(sql)  # records
    plan = _plans(snap, sql)[0]
    before = plan.replays
    assert [rs.to_dicts() for rs in db.query_batch([sql] * n)] == [want] * n
    assert plan.replays == before + (1 if n >= TE._GROUP_MIN else n)
    assert plan.group_replays == 0 and not plan.groups


@pytest.mark.parametrize(
    "sql",
    [
        "TRAVERSE out('HasFriend') FROM Profiles LIMIT 2",
        "TRAVERSE out('HasFriend') FROM Profiles MAXDEPTH 1",
        "TRAVERSE out('HasFriend') FROM Profiles WHILE $depth < 2",
        "TRAVERSE * FROM Profiles",
        "TRAVERSE outE('HasFriend') FROM Profiles",
        "TRAVERSE out('HasFriend') FROM HasFriend STRATEGY BREADTH_FIRST",
        "TRAVERSE out('HasFriend') FROM INDEX:Profiles.uid",
    ],
    ids=["limit", "dfs_maxdepth", "dfs_while", "star", "oute", "edge_class", "index"],
)
def test_refusals(social, sql):
    jdb, db, snap = social
    with pytest.raises(Uncompilable):
        db.query(sql)


def test_edge_rid_root_is_refused(social):
    jdb, db, snap = social
    e = jdb.query("SELECT FROM HasFriend LIMIT 1", engine="oracle").to_list()[0].rid
    with pytest.raises(Uncompilable, match="not a snapshot vertex"):
        db.query(f"TRAVERSE out('HasFriend') FROM {e} STRATEGY BREADTH_FIRST")


def test_non_columnar_snapshot_refuses_records(social):
    jdb, db, snap = social
    snap.v_non_columnar = {"blob"}
    with pytest.raises(Uncompilable, match="non-columnar"):
        db.query(TRAVERSALS[0])


# ---------------------------------------------------------------------------
# deltas and tiering
# ---------------------------------------------------------------------------


def test_deltas_rerecord_traverse(monkeypatch):
    from tests.test_torch_deltas import Pair, build_db

    jdb, vs = build_db()
    pair = Pair(monkeypatch, jdb, sv=64, se=64)
    sqls = [
        "TRAVERSE out('Knows') FROM Person STRATEGY BREADTH_FIRST",
        "TRAVERSE both('Knows'), out('Likes') FROM (SELECT FROM Person WHERE age < 23) "
        "WHILE $depth < 4 AND age > 21 STRATEGY BREADTH_FIRST",
    ]
    for sql in sqls:
        assert_traverse_parity(jdb, pair.tdb, sql)
    plans = {sql: _plans(pair.tsnap, sql)[0] for sql in sqls}
    w = jdb.new_vertex("Person", name="w", age=22)
    jdb.new_edge("Knows", vs[3], w)
    jdb.new_edge("Knows", w, vs[0])
    vs[6].set("age", 21)
    jdb.save(vs[6])
    jdb.delete(vs[8])
    assert pair.sync()
    for sql in sqls:
        assert_traverse_parity(jdb, pair.tdb, sql)
        # the first call after the batch re-recorded: a fresh plan, then
        # replays of it
        new = _plans(pair.tsnap, sql)[0]
        assert new is not plans[sql] and new.replays == 1


def _plans(snap, sql):
    (variants,) = [v for k, v in TE._plan_cache(snap).items() if k[0] == parse(sql)]
    return variants.plans


def test_tiered_traverse_equals_reference(monkeypatch):
    from tests.test_torch_tiering import _attach_both

    jdb, jsnap, db, snap = _attach_both(monkeypatch)
    try:
        db, snap = carry(jdb, jsnap)
        assert snap._tier is not None
        for sql in (
            "TRAVERSE out('HasFriend') FROM (SELECT FROM Profiles WHERE uid < 4) "
            "MAXDEPTH 3 STRATEGY BREADTH_FIRST",
            "TRAVERSE in('HasFriend') FROM (SELECT FROM Profiles WHERE uid < 2) "
            "WHILE $depth < 3 AND age > 22 STRATEGY BREADTH_FIRST",
        ):
            # a dispatch's footprint prefetch may grow the pool, which sends
            # the plan captured before back to a re-record: the third call
            # replays the newest variant
            want = assert_traverse_parity(jdb, db, sql, calls=3)
            plan = _plans(snap, sql)[0]
            assert not plan.batchable() and plan.tier_footprint and plan.replays >= 1
            # a batch on the group threshold replays its items one by one
            before = plan.replays
            out = db.query_batch([sql] * TE._GROUP_MIN)
            assert [rs.to_dicts() for rs in out] == [want] * TE._GROUP_MIN
            assert plan.replays == before + TE._GROUP_MIN and not plan.groups
        assert snap._tier.stats()["prefetch_misses"] > 0
    finally:
        jdb.detach_snapshot()


# ---------------------------------------------------------------------------
# the kernel forms of this path, plain versions against numpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gate_kind", ["random", "empty", "all", "none"])
def test_gated_frontier_advance_equals_numpy(gate_kind):
    rng = np.random.default_rng(4)
    C, vb = 3, 1 << 10
    nxt = rng.random((C, vb)) < 0.3
    vis = rng.random((C, vb)) < 0.4
    gate = {"random": rng.random(vb) < 0.5, "empty": np.zeros(vb, bool), "all": np.ones(vb, bool), "none": None}[gate_kind]
    want_n = nxt & ~vis & (gate[None, :] if gate is not None else True)
    want_v = vis | want_n
    n_t, v_t = torch.from_numpy(nxt.copy()), torch.from_numpy(vis.copy())
    g_t = None if gate is None else torch.from_numpy(gate)
    count = K.frontier_advance(n_t, v_t, g_t)
    assert np.array_equal(n_t.numpy(), want_n) and np.array_equal(v_t.numpy(), want_v)
    assert count.dtype == torch.int32 and int(count) == int(want_n.sum())


@pytest.mark.parametrize("gate_kind", ["random", "empty", "all"])
@pytest.mark.parametrize("bound", [False, True], ids=["open", "close"])
def test_gated_frontier_advance_with_emission_count_equals_numpy(gate_kind, bound):
    """K12's gate beside its folded emission count: the count is taken over
    the admitted frontier (after the gate), restricted to ``bound[c]``."""
    rng = np.random.default_rng(5)
    C, vb = 3, 1 << 10
    nxt = rng.random((C, vb)) < 0.3
    vis = rng.random((C, vb)) < 0.4
    node = rng.random(vb) < 0.5
    gate = {"random": rng.random(vb) < 0.5, "empty": np.zeros(vb, bool), "all": np.ones(vb, bool)}[gate_kind]
    b = np.array([-2, 0, vb - 1], np.int32) if bound else None
    want_n = nxt & ~vis & gate[None, :]
    emit = want_n & node[None, :]
    if bound:
        emit &= np.arange(vb)[None, :] == b[:, None]
    n_t, v_t = torch.from_numpy(nxt.copy()), torch.from_numpy(vis.copy())
    alive, emitted = K.frontier_advance(
        n_t, v_t, torch.from_numpy(gate), torch.from_numpy(node), None if b is None else torch.from_numpy(b)
    )
    assert np.array_equal(n_t.numpy(), want_n) and np.array_equal(v_t.numpy(), vis | want_n)
    assert int(alive) == int(want_n.sum()) and int(emitted) == int(emit.sum())


def test_traverse_level_steps_take_no_emission_count(demodb, monkeypatch):
    """TRAVERSE's level steps call K12 without ``node``: its rows come from
    the admitted frontier itself, not from an emission count."""
    jdb, db, snap = demodb
    nodes = []

    def spy(*a, _f=K.frontier_advance, **kw):
        nodes.append(kw.get("node", a[3] if len(a) > 3 else None))
        return _f(*a, **kw)

    monkeypatch.setattr(K, "frontier_advance", spy)
    sql = "TRAVERSE out('HasFriend') FROM (SELECT FROM Profiles WHERE uid < 5) WHILE $depth < 3 STRATEGY BREADTH_FIRST"
    assert_traverse_parity(jdb, db, sql)
    assert nodes and all(n is None for n in nodes)


def test_predicate_id_instruction_equals_numpy():
    ids = torch.tensor([-1, 0, 5, 7, 5, -2, 1000], dtype=torch.int32)
    for want in (5, 0, -2, 1000):
        pred = Predicate([id_term(want)], torch.device("cpu"))
        got = pred(ids).numpy()
        assert np.array_equal(got, (ids.numpy() == want) & (ids.numpy() >= 0))
        ident = pred.identity(16, 9, base=-3).numpy()
        slot = np.arange(16) - 3
        slot = np.where(np.arange(16) < 9, slot, -1)
        assert np.array_equal(ident, (slot == want) & (slot >= 0))


@pytest.mark.parametrize("n", [0, 1, 37, 1000])
def test_compact_offset_form_equals_numpy(n):
    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.4
    kept = np.flatnonzero(mask).astype(np.int32)
    buf = np.full(len(kept) + 9, -7, np.int32)
    t = torch.from_numpy(buf.copy())
    view = K.compact_indices(torch.from_numpy(mask), len(kept), out=t, offset=5)
    want = buf.copy()
    want[5 : 5 + len(kept)] = kept
    assert np.array_equal(t.numpy(), want) and np.array_equal(view.numpy(), kept)
    # a level larger than its slot keeps its first indices; past the count
    # nothing is written; at the buffer's end nothing is written at all
    t = torch.from_numpy(buf.copy())
    K.compact_indices(torch.from_numpy(mask), len(kept) + 3, out=t, offset=6)
    want = buf.copy()
    want[6 : 6 + len(kept)] = kept
    assert np.array_equal(t.numpy(), want)
    t = torch.from_numpy(buf.copy())
    K.compact_indices(torch.from_numpy(mask), 0, out=t, offset=len(buf))
    assert np.array_equal(t.numpy(), buf)
    with pytest.raises(ValueError):
        K.compact_indices(torch.from_numpy(mask), 2, out=t, offset=len(buf) - 1)
