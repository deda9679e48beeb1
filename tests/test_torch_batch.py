"""The port's batch path (`db.query_batch`, `orientdb_tpu_torch.exec.tpu_engine
.execute_batch`) against the reference's ``query_batch(engine="tpu",
strict=True)`` and against the port's own single ``db.query``, on the CPU.

The reference is called twice with ``drain_warmups()`` between, so that
its second call serves through its vmapped group executable; the port's
group replay runs its lane loop uncaptured on the CPU (the captured
group's plain version), and its rows groups elect their page through the
plain version of K14 (`group_page`). Port counters show which path each
batch took: ``plan.group_replays`` (one per chunk of a group),
``plan.replays`` (one per single replay) and the calls of `K.group_page`.
Rows compare under `canonical_rows`, exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientdb_tpu.exec import tpu_engine as JTE
from orientdb_tpu.exec.result import canonical_rows as j_canonical_rows
from orientdb_tpu.storage.bigshape import build_person_knows as j_build_person_knows
from orientdb_tpu.storage.ingest import generate_demodb
from orientdb_tpu.storage.snapshot import build_snapshot
from orientdb_tpu_torch.exec import tpu_engine as TE
from orientdb_tpu_torch.exec.result import canonical_rows
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.ops.predicates import Uncompilable
from orientdb_tpu_torch.sql.parser import parse
from orientdb_tpu_torch.storage.bigshape import (
    build_person_knows,
    build_snb_shape,
    numpy_config5_count,
    numpy_config5_counts,
    numpy_out_edge_rows,
    numpy_probe_rows,
)
from orientdb_tpu_torch.utils.config import config
from test_torch_edges import _carry

COUNT_A = (
    "MATCH {class:Person, as:p, where:(age > :a)}"
    "-knows->{as:f, where:(age < 30)} RETURN count(*) AS n"
)
Q1 = (
    "MATCH {class:Person, as:p, where:(age > 40)}"
    "-knows->{as:f, where:(age < 30)} RETURN count(*) AS n"
)
Q3 = (
    "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f}"
    "-knows->{as:g, where:(age < 30)} "
    "RETURN p.uid AS p, f.uid AS f, g.uid AS g"
)
ROWS_1HOP = (
    "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f} "
    "RETURN p.uid AS p, f.uid AS f"
)
ROWS_SHARED = (
    "MATCH {class:Person, as:p, where:(uid < 1000)}-knows->{as:f} "
    "RETURN p.uid AS p, f.uid AS f"
)
ROWS_LIMIT = (
    "MATCH {class:Person, as:p, where:(age > :a)}-knows->{as:f} "
    "RETURN p.uid AS p, f.uid AS f LIMIT 5"
)
PG_ROWS = (
    "MATCH {class:Profiles, as:p, where:(age > :a)}-HasFriend->{as:f} "
    "RETURN p.uid AS p, f.uid AS f"
)
PG_COUNT = (
    "MATCH {class:Profiles, as:p, where:(age + :b > 50)}-HasFriend->{as:f} "
    "RETURN count(*) AS n"
)
E1 = (
    "MATCH {class:Person, as:p, where:(age > 40)}"
    ".outE('knows'){where:(creationDate > :d)}"
    ".inV(){as:f, where:(age < 30)}, "
    "{class:Message, as:m}-hasCreator->{as:f} "
    "RETURN count(*) AS n"
)
E2 = (
    "MATCH {class:Person, as:p, where:(uid < :n)}"
    ".outE('knows'){as:e, where:(creationDate > :d)}.inV(){as:f, where:(age < 30)} "
    "RETURN p.uid AS p, f.uid AS f, e.creationDate AS cd"
)
E5 = (
    "MATCH {class:Person, as:p, where:(uid < :n)}-knows->{as:f, where:(age < p.age)}, "
    "{as:f}-knows{as:kn, optional:true, where:(creationDate > :d)}-{as:p} "
    "RETURN p.uid AS p, f.uid AS f, kn IS NOT NULL AS probe"
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads, and the suite runs
    in parallel workers: keep torch to one thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def person_knows():
    kw = dict(avg_knows=8, seed=3)
    jdb, _ = j_build_person_knows(20_000, **kw)
    db, snap = build_person_knows(20_000, device="cpu", **kw)
    return jdb, db, snap


@pytest.fixture(scope="module")
def demodb():
    jdb = generate_demodb(n_profiles=400, avg_friends=6, seed=5)
    jdb.attach_snapshot(build_snapshot(jdb))
    db, snap = _carry(jdb)
    return jdb, db, snap


@pytest.fixture(scope="module")
def snb():
    return build_snb_shape(2_000, device="cpu")


def _reference(jdb, sqls, plist):
    """The reference's batch, served by its group executable: the first
    call records and starts the group compiles, the second replays."""
    jdb.query_batch(sqls, params_list=plist, engine="tpu", strict=True)
    JTE.drain_warmups()
    return [j_canonical_rows(rs.to_dicts()) for rs in jdb.query_batch(sqls, params_list=plist, engine="tpu", strict=True)]


def _port(db, sqls, plist):
    return [canonical_rows(rs.to_dicts()) for rs in db.query_batch(sqls, plist)]


def _singles(db, sqls, plist):
    return [canonical_rows(db.query(s, p).to_dicts()) for s, p in zip(sqls, plist)]


def _plan(snap, sql, params):
    """The plan that serves ``params`` under the current configuration."""
    stmt = parse(sql)
    cfg = dataclasses.astuple(config)
    found = [v for k, v in TE._plan_cache(snap).items() if k[0] == stmt and k[2] == cfg]
    assert len(found) == 1, f"{len(found)} cache entries for {sql}"
    return found[0].pick(params)


@pytest.fixture
def page_calls(monkeypatch):
    """The (B, n, fits16) of every `K.group_page` call."""
    calls = []
    real = K.group_page

    def spy(stack, B, n, fits16):
        calls.append((int(stack.shape[0]), int(stack.shape[1]), B, n, bool(fits16)))
        return real(stack, B, n, fits16)

    monkeypatch.setattr(K, "group_page", spy)
    return calls


# ---------------------------------------------------------------------------
# group, shared, chunked and per-lane paths against the reference
# ---------------------------------------------------------------------------


def test_count_group_varied_params(person_knows):
    jdb, db, snap = person_knows
    plist = [{"a": 20 + 4 * i} for i in range(12)]
    sqls = [COUNT_A] * 12
    want = _reference(jdb, sqls, plist)
    assert _port(db, sqls, plist) == want  # records item 0, groups the other 11
    plan = _plan(snap, COUNT_A, plist[0])
    replays, groups = plan.replays, plan.group_replays
    assert _port(db, sqls, plist) == want
    assert plan.group_replays == groups + 1 and plan.replays == replays
    assert sorted(plan.groups) == [16]  # 11 lanes, then 12: the bucket 16
    assert _singles(db, sqls, plist) == want
    # every lane its own answer: the counts differ across the parameters
    assert len({tuple(map(tuple, w)) for w in want}) == len(plist)


def test_rows_group_elects_one_page(person_knows, page_calls):
    jdb, db, snap = person_knows
    plist = [{"k": 300 - 12 * i} for i in range(8)]
    sqls = [Q3] * 8
    want = _reference(jdb, sqls, plist)
    db.query(Q3, plist[0])  # record at the largest k: every lane fits the plan
    plan = _plan(snap, Q3, plist[0])
    assert plan.batchable() and plan._rows_grouped() and not plan.direct_fetch
    groups = plan.group_replays
    assert _port(db, sqls, plist) == want
    assert plan.group_replays == groups + 1
    ((Bb, W, B, n, fits16),) = page_calls
    assert (Bb, B, W) == (8, 8, plan.width) and fits16  # 20,000 uids fit int16
    assert n == plan._page_round(W, max(len(w) for w in want)) < W
    assert _singles(db, sqls, plist) == want


def test_small_batch_stays_per_lane(person_knows):
    jdb, db, snap = person_knows
    plist = [{"a": 30 + i} for i in range(TE._GROUP_MIN - 1)]
    sqls = [COUNT_A] * len(plist)
    want = _reference(jdb, sqls, plist)
    db.query(COUNT_A, plist[0])
    plan = _plan(snap, COUNT_A, plist[0])
    replays, groups = plan.replays, plan.group_replays
    assert _port(db, sqls, plist) == want
    assert plan.replays == replays + len(plist) and plan.group_replays == groups


@pytest.mark.parametrize("sql", [Q1, ROWS_SHARED], ids=["count", "rows"])
def test_no_param_items_share_one_replay(person_knows, sql, page_calls):
    jdb, db, snap = person_knows
    sqls = [sql] * 8
    want = _reference(jdb, sqls, None)
    db.query(sql)
    plan = _plan(snap, sql, {})
    replays, groups = plan.replays, plan.group_replays
    assert _port(db, sqls, None) == want
    assert plan.replays == replays + 1 and plan.group_replays == groups
    assert not plan.direct_fetch and not page_calls  # a shared replay elects from its own ladder


def test_chunks_under_the_lane_cap(person_knows, monkeypatch):
    jdb, db, snap = person_knows
    E = snap.edge_classes["knows"].dst.shape[0]
    monkeypatch.setattr(config, "group_hbm_budget_bytes", 2 * 4 * E)  # cap 2 lanes
    plist = [{"a": 25 + 3 * i} for i in range(7)]
    sqls = [COUNT_A] * 7
    want = _reference(jdb, sqls, plist)
    db.query(COUNT_A, plist[0])  # a new configuration records anew
    plan = _plan(snap, COUNT_A, plist[0])
    assert plan._group_lane_cap() == 2
    groups = plan.group_replays
    assert _port(db, sqls, plist) == want
    assert plan.group_replays == groups + 4 and sorted(plan.groups) == [2]


def test_rows_plan_over_the_lane_budget_stays_per_lane(demodb, monkeypatch, page_calls):
    jdb, db, snap = demodb
    monkeypatch.setattr(config, "result_direct_bytes", 16)
    monkeypatch.setattr(config, "result_group_lane_bytes", 16)
    plist = [{"a": 20 + i} for i in range(8)]
    sqls = [PG_ROWS] * 8
    want = _reference(jdb, sqls, plist)
    db.query(PG_ROWS, plist[0])
    plan = _plan(snap, PG_ROWS, plist[0])
    assert not plan.batchable() and not plan.direct_fetch
    replays, groups = plan.replays, plan.group_replays
    assert _port(db, sqls, plist) == want
    assert plan.replays == replays + 8 and plan.group_replays == groups and not page_calls


def test_rows_group_over_the_lane_cap_stays_per_lane(person_knows, monkeypatch):
    jdb, db, snap = person_knows
    E = snap.edge_classes["knows"].dst.shape[0]
    monkeypatch.setattr(config, "group_hbm_budget_bytes", 4 * 4 * E)  # cap 4 lanes
    plist = [{"k": 300 - 20 * i} for i in range(5)]  # bucket 8 > cap
    sqls = [Q3] * 5
    want = _reference(jdb, sqls, plist)
    db.query(Q3, plist[0])
    plan = _plan(snap, Q3, plist[0])
    replays, groups = plan.replays, plan.group_replays
    assert _port(db, sqls, plist) == want
    assert plan.replays == replays + 5 and plan.group_replays == groups


def test_rows_group_limit_cuts_the_page(person_knows, page_calls):
    jdb, db, snap = person_knows
    plist = [{"a": 40 + (i % 4) * 10} for i in range(8)]
    sqls = [ROWS_LIMIT] * 8
    want = _reference(jdb, sqls, plist)
    db.query(ROWS_LIMIT, plist[0])
    got = db.query_batch(sqls, plist)
    for rs, p, w in zip(got, plist, want):
        rows = rs.to_dicts()
        assert len(rows) == 5 and canonical_rows(rows) == w
        assert rows == db.query(ROWS_LIMIT, p).to_dicts()  # expansion order kept
    plan = _plan(snap, ROWS_LIMIT, plist[0])
    assert plan.batchable() and not plan.direct_fetch
    ((_Bb, W, _B, n, _f16),) = page_calls
    assert n == TE._GROUP_PAGE_ROUND < W


def test_one_overflowing_lane_rerecords(person_knows):
    jdb, db, snap = person_knows
    plist = [{"k": 300 - 15 * i} for i in range(7)] + [{"k": 2_000}]
    sqls = [Q3] * 8
    want = _reference(jdb, sqls, plist)
    TE._plan_cache(snap).clear()
    db.query(Q3, plist[0])
    variants = TE._plan_cache(snap)[TE._cache_key(parse(Q3), plist[0])]
    first = variants.plans[0]
    groups = first.group_replays
    assert _port(db, sqls, plist) == want
    assert first.group_replays == groups + 1 and first.lane_axis  # the group ran on the lane axis
    assert len(variants.plans) == 2 and variants.plans[1] is first  # the k=2000 lane recorded
    assert variants.pick(plist[-1]) is variants.plans[0]
    assert all(variants.pick(p) is first for p in plist[:-1])  # the others kept their rows


def test_mixed_batch_keeps_order(person_knows):
    jdb, db, snap = person_knows
    sqls = [Q1, Q3, COUNT_A, ROWS_1HOP, Q3, COUNT_A, Q1, ROWS_1HOP, COUNT_A, COUNT_A]
    plist = [None, {"k": 200}, {"a": 50}, {"k": 40}, {"k": 120}, {"a": 35}, None, {"k": 8}, {"a": 60}, {"a": 22}]
    want = _reference(jdb, sqls, plist)
    for _ in range(2):
        assert _port(db, sqls, plist) == want
    assert _singles(db, sqls, plist) == want


def test_demodb_groups_equal_reference(demodb):
    jdb, db, snap = demodb
    for sql, key, vals in ((PG_ROWS, "a", (30, 70, 19, 45, 25, 60)), (PG_COUNT, "b", (5, -10, 30, 0, 12, 7))):
        plist = [{key: v} for v in vals]
        want = _reference(jdb, [sql] * 6, plist)
        for _ in range(2):
            assert _port(db, [sql] * 6, plist) == want
        assert _singles(db, [sql] * 6, plist) == want


def test_empty_batch_and_wrong_params_length(person_knows):
    _jdb, db, _snap = person_knows
    assert db.query_batch([]) == []
    with pytest.raises(ValueError):
        db.query_batch([Q1], params_list=[{}, {}])


def test_uncompilable_item_raises(person_knows):
    jdb, db, _snap = person_knows
    for bad in (
        "MATCH {class:Person, as:p}-knows->{as:f, pathAlias:x} RETURN p.uid AS p",
        "SELECT out('knows') FROM Person",
    ):
        with pytest.raises(Uncompilable):
            db.query_batch([Q1, bad])
        with pytest.raises(JTE.Uncompilable):
            jdb.query_batch([Q1, bad], engine="tpu", strict=True)


# ---------------------------------------------------------------------------
# the SNB-shape graph against numpy
# ---------------------------------------------------------------------------


def test_snb_groups_equal_numpy(snb):
    db, snap = snb
    ds = [12_000 + (i * 211) % 8_000 for i in range(8)]
    db.query(E1, {"d": min(ds)})
    got = [rs.to_dicts() for rs in db.query_batch([E1] * 8, [{"d": d} for d in ds])]
    assert got == [[{"n": n}] for n in numpy_config5_counts(snap, ds)]
    assert _plan(snap, E1, {"d": ds[0]}).group_replays == 1
    young = snap.v_columns["age"].values < 30
    for sql, plist, ref in (
        (E2, [{"n": 2_000 - 100 * i, "d": 10_000 + 50 * i} for i in range(8)],
         lambda p: numpy_out_edge_rows(snap, p["n"], p["d"], young)),
        (E5, [{"n": 1_000 - 60 * i, "d": 15_000} for i in range(6)],
         lambda p: numpy_probe_rows(snap, p["n"], p["d"])),
    ):
        db.query(sql, plist[0])
        plan = _plan(snap, sql, plist[0])
        assert plan._rows_grouped() and plan.batchable()
        groups = plan.group_replays
        names = ("p", "f", "cd") if sql == E2 else ("p", "f", "probe")
        for rs, p in zip(db.query_batch([sql] * len(plist), plist), plist):
            rows = rs.to_dicts()
            arr = np.array([[int(r[c]) for c in names] for r in rows], np.int64).reshape(-1, 3)
            np.testing.assert_array_equal(arr[np.lexsort(arr.T[::-1])], ref(p))
        assert plan.group_replays == groups + 1


# ---------------------------------------------------------------------------
# K14's plain version and the numpy reference of the E1 counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Bb,W,C", [(1, 1, 1), (4, 8, 3), (8, 4096, 2), (16, 2048, 5), (1, 333, 3), (3, 7, 5)])
def test_plain_group_page_equals_reference_page_fn(Bb, W, C):
    rng = np.random.default_rng(Bb * W + C)
    stack = rng.integers(-40_000, 40_000, (Bb, W, C), dtype=np.int32)
    ref_stack = jnp.asarray(stack.transpose(0, 2, 1))  # the reference's [Bb, C, W]
    for B in sorted({1, max(Bb // 2, 1), Bb}):
        for n in sorted({1, max(W // 3, 1), W}):
            for fits16 in (False, True):
                want = np.asarray(JTE._CompiledPlan._page_fn(B, n, fits16)(ref_stack)).transpose(0, 2, 1)
                got = K.group_page(torch.from_numpy(stack), B, n, fits16)
                assert got.dtype == (torch.int16 if fits16 else torch.int32)
                assert got.is_contiguous() and tuple(got.shape) == (B, n, C)
                np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        K.group_page(torch.from_numpy(stack), Bb + 1, 1, False)
    with pytest.raises(ValueError):
        K.group_page(torch.from_numpy(stack.astype(np.int64)), 1, 1, False)


def test_page_round_equals_reference():
    for W in (8, 2048, 4096, 131_072):
        for need in (0, 1, 2047, 2048, 2049, 5000, W, W + 1):
            assert TE._CompiledPlan._page_round(W, need) == JTE._CompiledPlan._page_round(W, need)


def test_numpy_config5_counts_equal_single_counts(snb):
    _db, snap = snb
    ds = [-1, 9_999, 12_000, 12_211, 15_000, 19_998, 19_999, 30_000]
    assert numpy_config5_counts(snap, ds) == [numpy_config5_count(snap, d) for d in ds]
