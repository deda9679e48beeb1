"""The port's plan cache and replay (`orientdb_tpu_torch.exec.tpu_engine`
`_CompiledPlan`) against the reference package's, on the CPU.

The first call of a statement records; every later call replays the
recorded plan. On the CPU a replay runs the replay-mode solve without
capture (the captured replay's plain version): recorded sizes, the device
overflow flag, the front-pack (K6), the meta row (K7) and the int16 pages
(K8). Every value compared here is int32, int16 or bool, so every
comparison is exact. The graphs are small: Person–knows from the
array-native generator `build_person_knows` (with and without
supernodes) and demodb carried across from a reference snapshot with
`carry.snapshot_from_arrays`.
"""

import dataclasses
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientdb_tpu.exec.result import canonical_rows as j_canonical_rows
from orientdb_tpu.exec.tpu_engine import _CompiledPlan as JPlan
from orientdb_tpu.ops import csr as JK
from orientdb_tpu.sql.parser import parse as j_parse
from orientdb_tpu.storage.bigshape import build_person_knows as j_build_person_knows
from orientdb_tpu.storage.ingest import generate_demodb
from orientdb_tpu.storage.snapshot import build_snapshot
from orientdb_tpu_torch.carry import snapshot_from_arrays
from orientdb_tpu_torch.exec import tpu_engine as TE
from orientdb_tpu_torch.exec.result import canonical_rows
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.ops.device_graph import device_graph
from orientdb_tpu_torch.sql.parser import parse
from orientdb_tpu_torch.storage.bigshape import (
    build_person_knows,
    numpy_1hop_count,
    numpy_2hop_count,
)
from orientdb_tpu_torch.utils.config import config

Q1 = (
    "MATCH {class:Person, as:p, where:(age > 40)}"
    "-knows->{as:f, where:(age < 30)} RETURN count(*) AS n"
)
Q2 = (
    "MATCH {class:Person, as:p, where:(age > 40)}-knows->{as:f}"
    "-knows->{as:g, where:(age < 30)} RETURN count(*) AS n"
)
Q3 = (
    "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f}"
    "-knows->{as:g, where:(age < 30)} "
    "RETURN p.uid AS p, f.uid AS f, g.uid AS g"
)
Q_ROWS_1HOP = (
    "MATCH {class:Person, as:p, where:(age > 40 AND uid < :k)}"
    "-knows->{as:f, where:(age < 30)} "
    "RETURN p.uid AS p, f.uid AS f, f.age AS age"
)
DEMO_COUNT = (
    "MATCH {class:Profiles, as:p, where:(age > 40)}"
    "-HasFriend->{as:f}"
    "-HasFriend->{as:g, where:(age < 30)} "
    "RETURN count(*) AS n"
)
DEMO_ROWS = (
    "MATCH {class:Profiles, as:p, where:(age > 40)}"
    "-HasFriend->{as:f, where:(age < 30)} "
    "RETURN p.uid AS p, f.uid AS f"
)
# tests/test_param_generic.py's compiled-slice queries and parameter sets
PG_QUERIES = [
    "MATCH {class:Profiles, as:p, where:(age > :a)}-HasFriend->{as:f} "
    "RETURN p.uid AS p, f.uid AS f",
    "MATCH {class:Profiles, as:p, where:(age + :b > 50)}-HasFriend->{as:f} "
    "RETURN count(*) AS n",
]
PG_PARAMS = [
    {"a": 30, "b": 5, "c": 25, "d": 40},
    {"a": 70, "b": -10, "c": 3, "d": 25},
    {"a": 19, "b": 30, "c": 120, "d": 79},
    {"a": 45, "b": 0, "c": 60, "d": 55},
]


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
    jdb, jsnap = j_build_person_knows(20_000, **kw)
    db, snap = build_person_knows(20_000, device="cpu", **kw)
    return jdb, jsnap, db, snap


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


def _demodb(**kw):
    jdb = generate_demodb(**kw)
    jdb.attach_snapshot(build_snapshot(jdb))
    db, snap = _carry(jdb)
    return jdb, db, snap


@pytest.fixture(scope="module")
def demodb():
    return _demodb(n_profiles=300, avg_friends=1, seed=1)


@pytest.fixture(scope="module")
def pg_db():
    """tests/test_param_generic.py's graph."""
    return _demodb(n_profiles=400, avg_friends=6, seed=5)


def _variants(snap, sql):
    """The statement's cache entry under the current configuration."""
    stmt = parse(sql)
    cfg = dataclasses.astuple(config)
    found = [v for k, v in TE._plan_cache(snap).items() if k[0] == stmt and k[2] == cfg]
    assert len(found) == 1, f"{len(found)} cache entries for {sql}"
    return found[0]


def _j_plan(jsnap, sql, params=None):
    """The reference's plan that serves ``params``."""
    stmt = j_parse(sql)
    found = [v for k, v in getattr(jsnap, "_plan_cache", {}).items() if k[0] == stmt]
    assert len(found) == 1
    return found[0].pick(params or {})


def _numpy_q3(snap, k):
    csr = snap.edge_classes["knows"]
    age = snap.v_columns["age"].values
    out = []
    for p in range(k):
        for f in csr.dst[csr.indptr_out[p] : csr.indptr_out[p + 1]]:
            for g in csr.dst[csr.indptr_out[f] : csr.indptr_out[f + 1]]:
                if age[g] < 30:
                    out.append((p, int(f), int(g)))
    return sorted(out)


# ---------------------------------------------------------------------------
# second and third calls against the reference's replays and numpy
# ---------------------------------------------------------------------------


def test_count_replays_equal_reference_and_numpy(person_knows):
    jdb, jsnap, db, snap = person_knows
    age = snap.v_columns["age"].values
    want = {
        Q1: numpy_1hop_count(snap, age > 40, age < 30),
        Q2: numpy_2hop_count(snap, age > 40, np.ones(age.shape[0], bool), age < 30),
    }
    for sql, n in want.items():
        for call in range(3):
            assert db.query(sql).to_dicts() == [{"n": n}], (sql, call)
            assert jdb.query(sql, engine="tpu", strict=True).to_dicts() == [{"n": n}]
        v = _variants(snap, sql)
        assert len(v.plans) == 1 and v.plans[0].replays == 2
        assert v.plans[0].count_name == "n" and v.plans[0].width == 0


def test_q3_replays_across_values_equal_reference_and_numpy(person_knows):
    jdb, jsnap, db, snap = person_knows
    for call, k in enumerate((60, 60, 25, 60)):
        got = db.query(Q3, {"k": k}).to_dicts()
        want = jdb.query(Q3, {"k": k}, engine="tpu", strict=True).to_dicts()
        assert canonical_rows(got) == j_canonical_rows(want), (call, k)
        assert sorted((r["p"], r["f"], r["g"]) for r in got) == _numpy_q3(snap, k)
    plans = _variants(snap, Q3).plans
    assert len(plans) == 1 and plans[0].replays == 3
    assert plans[0].width == _j_plan(jsnap, Q3, {"k": 60}).width


def test_demodb_headline_pair_replays(demodb):
    jdb, db, snap = demodb
    for sql in (DEMO_COUNT, DEMO_ROWS):
        first = None
        for _ in range(3):
            got = db.query(sql).to_dicts()
            want = jdb.query(sql, engine="tpu", strict=True).to_dicts()
            assert len(want) > 0
            assert canonical_rows(got) == j_canonical_rows(want)
            first = first or got
            assert canonical_rows(got) == canonical_rows(first)
        assert _variants(snap, sql).plans[0].replays == 2


def test_direct_fetch_replay(person_knows):
    jdb, jsnap, db, snap = person_knows
    for k in (300, 300, 150):
        got = db.query(Q_ROWS_1HOP, {"k": k}).to_dicts()
        want = jdb.query(Q_ROWS_1HOP, {"k": k}, engine="tpu", strict=True).to_dicts()
        assert canonical_rows(got) == j_canonical_rows(want)
    plan = _variants(snap, Q_ROWS_1HOP).plans[0]
    assert plan.direct_fetch and _j_plan(jsnap, Q_ROWS_1HOP).direct_fetch
    assert plan.replays == 2
    # the fused buffer: W·C data values then [count, overflow, fits16]
    meta, data = plan.fetch(plan.dispatch({"k": 150}))
    assert data.shape == (plan.width, plan.ncols) and meta[0] == len(want)
    assert meta[1] == 0 and meta[2] == 1


def test_limit_cuts_the_fetch(person_knows):
    jdb, jsnap, db, snap = person_knows
    sql = Q_ROWS_1HOP + " SKIP 2 LIMIT 7"
    for k in (4_000, 4_000, 3_000):
        got = db.query(sql, {"k": k}).to_dicts()
        want = jdb.query(sql, {"k": k}, engine="tpu", strict=True).to_dicts()
        assert len(got) == 7 and canonical_rows(got) == j_canonical_rows(want)
    plan = _variants(snap, sql).plans[0]
    assert plan.fetch_limit == 9 and plan.fetch_rows_needed(500) == 9
    meta, data = plan.fetch(plan.dispatch({"k": 3_000}))
    assert plan._table_from(data, plan.fetch_rows_needed(int(meta[0]))).count == 9


# ---------------------------------------------------------------------------
# parameter-generic plans (tests/test_param_generic.py:61,69,81)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qi", range(len(PG_QUERIES)))
def test_parity_across_param_values(pg_db, qi):
    jdb, db, snap = pg_db
    q = PG_QUERIES[qi]
    for ps in PG_PARAMS:
        o = jdb.query(q, params=ps, engine="oracle").to_dicts()
        t = jdb.query(q, params=ps, engine="tpu", strict=True).to_dicts()
        got = db.query(q, params=ps).to_dicts()
        assert canonical_rows(got) == j_canonical_rows(o) == j_canonical_rows(t), ps


def test_one_plan_serves_many_values(pg_db):
    jdb, db, snap = pg_db
    q = PG_QUERIES[0]
    db.query(q, params=PG_PARAMS[0])
    before = len(TE._plan_cache(snap))
    plan = _variants(snap, q).plans[0]
    replays = plan.replays
    # a smaller result set replays the same plan (no new cache entry)
    got = db.query(q, params=PG_PARAMS[1]).to_dicts()
    assert len(TE._plan_cache(snap)) == before
    assert _variants(snap, q).plans == [plan] and plan.replays == replays + 1
    o = jdb.query(q, params=PG_PARAMS[1], engine="oracle").to_dicts()
    assert canonical_rows(got) == j_canonical_rows(o)


def test_overflow_rerecords_not_truncates(pg_db):
    jdb, db, snap = pg_db
    q = (
        "MATCH {class:Profiles, as:p, where:(uid < :lim)}-HasFriend->{as:f} "
        "RETURN p.uid AS p, f.uid AS f"
    )
    small = db.query(q, params={"lim": 2}).to_dicts()
    assert canonical_rows(small) == j_canonical_rows(
        jdb.query(q, params={"lim": 2}, engine="oracle").to_dicts()
    )
    first = _variants(snap, q).plans[0]
    # the small plan's replay raises its overflow flag at lim=400
    meta, _ = first.fetch(first.dispatch({"lim": 400}))
    assert meta[1] == 1
    big_o = jdb.query(q, params={"lim": 400}, engine="oracle").to_dicts()
    big_t = db.query(q, params={"lim": 400}).to_dicts()
    assert canonical_rows(big_t) == j_canonical_rows(big_o)
    assert len(big_t) > len(small) * 10
    v = _variants(snap, q)
    assert len(v.plans) == 2 and v.plans[1] is first
    # each value keeps being served by the variant that fits it
    assert canonical_rows(db.query(q, params={"lim": 2}).to_dicts()) == canonical_rows(small)
    assert canonical_rows(db.query(q, params={"lim": 400}).to_dicts()) == canonical_rows(big_t)
    assert len(_variants(snap, q).plans) == 2


def test_plan_cache_param_type_distinct(demodb):
    """1 vs True hash equal but compile differently — no stale plan
    (tests/test_tpu_match.py:190)."""
    jdb, db, snap = demodb
    sql = (
        "MATCH {class:Profiles, as:p, where:(age > :minage)}-HasFriend->{as:f} "
        "RETURN p.uid AS p"
    )
    for _ in range(2):
        r_int = db.query(sql, {"minage": 1}).to_dicts()
        r_bool = db.query(sql, {"minage": True}).to_dicts()
    assert canonical_rows(r_bool) == j_canonical_rows(
        jdb.query(sql, {"minage": True}, engine="oracle").to_dicts()
    )
    assert canonical_rows(r_int) == j_canonical_rows(
        jdb.query(sql, {"minage": 1}, engine="oracle").to_dicts()
    )
    stmt = parse(sql)
    assert len([k for k in TE._plan_cache(snap) if k[0] == stmt]) == 2


def test_page_budget_fallback(person_knows, monkeypatch):
    """A squeezed ladder budget emits only the full pages, with the same
    rows (tests/test_batch.py:239)."""
    jdb, jsnap, db, snap = person_knows
    want = j_canonical_rows(jdb.query(Q3, {"k": 500}, engine="tpu", strict=True).to_dicts())
    monkeypatch.setattr(config, "result_page_budget_bytes", 1)
    for _ in range(2):
        assert canonical_rows(db.query(Q3, {"k": 500}).to_dicts()) == want
    plans = [
        p for v in TE._plan_cache(snap).values() for p in v.plans if p.page_budget_bytes == 1
    ]
    assert len(plans) == 1 and not plans[0].direct_fetch and plans[0].replays == 1
    out = plans[0]._replay()
    assert len(out["pages32"]) == len(out["pages16"]) == 1
    assert out["pages32"][0].shape == (plans[0].width, 3)


# ---------------------------------------------------------------------------
# K6–K8 plain versions against the reference's replay functions
# ---------------------------------------------------------------------------


def _both_cores(jdb, jsnap, db, snap, sql, params):
    """The reference plan's and the port plan's replay outputs for the same
    parameters (each plan recorded, then replayed once)."""
    for _ in range(2):
        db.query(sql, params)
        jdb.query(sql, params, engine="tpu", strict=True)
    jplan = _j_plan(jsnap, sql, params)
    plan = _variants(snap, sql).pick(params)
    args, dyn = jplan._arg_subset(), jplan._dyn_args(params)
    plan._upload(plan._dyn_args(params))
    return jplan, plan, args, dyn


def test_front_pack_meta_and_pages_equal_reference_replay(person_knows):
    jdb, jsnap, db, snap = person_knows
    params = {"k": 500}
    jplan, plan, args, dyn = _both_cores(jdb, jsnap, db, snap, Q3, params)
    assert plan.v_names == jplan.v_names and not plan.direct_fetch
    j_count, j_over, j_data = jplan._replay_core(args, dyn)
    count, over, data = plan._replay_core()
    assert int(count) == int(j_count) > 0 and int(over) == int(j_over) == 0
    assert np.array_equal(data.numpy(), np.asarray(j_data).T)
    assert int(K.plain_replay_meta(data, count, over)[2]) == int(
        JPlan._fits16_flag(j_data, j_count, j_data.shape[1])
    )
    j_meta, j_pages32, j_pages16 = jplan._replay(args, dyn)
    out = plan._replay()
    assert np.array_equal(out["meta"].numpy(), np.asarray(j_meta))
    assert len(out["pages32"]) == len(j_pages32) == len(j_pages16) > 1
    for mine, ref in zip(out["pages32"] + out["pages16"], j_pages32 + j_pages16):
        ref = np.asarray(ref)
        assert mine.numpy().dtype == ref.dtype
        assert np.array_equal(mine.numpy(), ref.T)


def test_direct_buffer_equals_reference_replay(person_knows):
    jdb, jsnap, db, snap = person_knows
    params = {"k": 200}
    jplan, plan, args, dyn = _both_cores(jdb, jsnap, db, snap, Q_ROWS_1HOP, params)
    assert plan.direct_fetch and jplan.direct_fetch
    ref = np.asarray(jplan._replay(args, dyn))  # [C+1, W]: data rows + meta row
    flat = plan._replay()["direct"].numpy()
    W, C = plan.width, plan.ncols
    assert ref.shape == (C + 1, W)
    assert np.array_equal(flat[: W * C].reshape(W, C), ref[:-1].T)
    assert np.array_equal(flat[W * C : W * C + 2], ref[-1][:2])


@pytest.mark.parametrize("w,c,live", [(8, 1, 0), (1024, 3, 700), (4096, 2, 4096), (513, 5, 1)])
def test_kernel_plain_versions_equal_reference_functions(w, c, live):
    rng = np.random.default_rng(w + c)
    cols = [rng.integers(-1, 40_000, w, dtype=np.int32) for _ in range(c)]
    valid = np.zeros(w, np.int32)
    valid[rng.choice(w, live, replace=False)] = 1
    # K6: compact_indices + stacked take_pad
    perm = JK.compact_indices(jnp.asarray(valid).astype(bool), w)
    j_data = np.asarray(jnp.stack([JK.take_pad(jnp.asarray(x), perm, jnp.int32(-1)) for x in cols]))
    data = K.plain_front_pack(torch.from_numpy(valid), [torch.from_numpy(x) for x in cols])
    assert np.array_equal(data.numpy(), j_data.T)
    # K7: the meta row's fits16 flag, at live counts inside and outside
    # the int16 range of the packed values
    for n in (0, min(live, 3), live):
        count = torch.tensor(n, dtype=torch.int32)
        over = torch.tensor(n % 2, dtype=torch.int32)
        meta = K.plain_replay_meta(data, count, over)
        flag = JPlan._fits16_flag(jnp.asarray(j_data), jnp.int32(n), w)
        assert meta.tolist() == [n, n % 2, int(flag)]
    # K8: the int16 pages' narrowing, wrapping values outside int16
    wide = rng.integers(-(2**31), 2**31 - 1, w * c, dtype=np.int64).astype(np.int32)
    assert np.array_equal(
        K.plain_narrow_i16(torch.from_numpy(wide)).numpy(),
        np.asarray(jnp.asarray(wide).astype(jnp.int16)),
    )


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize(
    "call",
    [
        lambda: K.front_pack(_i32(8), []),
        lambda: K.front_pack(_i32(8), [_i32(7)]),
        lambda: K.front_pack(_i32(8), [_i32(8).to(torch.int64)]),
        lambda: K.front_pack(_i32(8), [_i32(8)], out=_i32(8, 2)),
        lambda: K.replay_meta(_i32(8), _i32(), _i32()),
        lambda: K.replay_meta(_i32(8, 2), _i32(1), _i32()),
        lambda: K.replay_meta(_i32(8, 2), _i32(), _i32(), out=_i32(2)),
        lambda: K.narrow_i16(torch.zeros(8, dtype=torch.int64)),
        lambda: K.narrow_i16(_i32(8, 2).t()),
    ],
    ids=["no_cols", "length", "dtype", "out_shape", "meta_1d", "meta_count", "meta_out", "narrow_dtype", "narrow_strided"],
)
def test_result_stage_wrappers_refuse_bad_inputs(call):
    with pytest.raises((TypeError, ValueError)):
        call()


# ---------------------------------------------------------------------------
# what a replay must not do
# ---------------------------------------------------------------------------

_HOST_READS = ("item", "__int__", "__float__", "__bool__", "__index__", "cpu", "tolist")


def test_cpu_replay_reads_no_host_value(monkeypatch):
    """Between dispatch and fetch a replay reads no device value on the
    host: every size comes from the recording, the overflow check stays a
    device flag, and the parameters are read on the device."""
    db, snap = build_person_knows(3_000, avg_knows=6, seed=7, device="cpu")
    queries = [
        (Q1, None),
        (Q2, None),
        (Q3, {"k": 40}),
        (Q_ROWS_1HOP, {"k": 300}),
        # the bitmap BFS: variable-depth COUNT and rows, the NOT anti-join
        (
            "MATCH {class:Person, as:p, where:(uid < 200)}"
            "-knows->{as:f, while:($depth < 3), where:(age < 30)} RETURN count(*) AS n",
            None,
        ),
        (
            "MATCH {class:Person, as:p, where:(uid < :k)}"
            "-knows-{as:f, maxDepth:2, depthAlias:d} RETURN p.uid AS p, f.uid AS f, d AS d",
            {"k": 16},
        ),
        (
            "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f}, "
            "NOT {as:f}-knows->{where:(age > 70)} RETURN p.uid AS p, f.uid AS f",
            {"k": 16},
        ),
    ]
    first = {sql: db.query(sql, params).to_dicts() for sql, params in queries}
    active = [False]
    for name in _HOST_READS:
        orig = getattr(torch.Tensor, name)

        def guard(self, *a, _orig=orig, _name=name, **kw):
            if active[0]:
                raise AssertionError(f"Tensor.{_name} during a replay")
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, guard)
    orig_dispatch = TE._CompiledPlan.dispatch

    def dispatch(self, params=None):
        active[0] = True
        try:
            return orig_dispatch(self, params)
        finally:
            active[0] = False

    monkeypatch.setattr(TE._CompiledPlan, "dispatch", dispatch)
    for sql, params in queries:
        assert canonical_rows(db.query(sql, params).to_dicts()) == canonical_rows(first[sql])
        assert _variants(snap, sql).plans[0].replays == 1
    # the guard does fire on a host read inside a dispatch
    active[0] = True
    try:
        with pytest.raises(AssertionError, match="during a replay"):
            bool(torch.zeros(()))
    finally:
        active[0] = False


def test_upload_during_a_replay_raises():
    """Every lazy column upload belongs to the recording run: a replay that
    would upload raises instead (under capture it would be a pageable
    host→device copy)."""
    db, snap = build_person_knows(500, device="cpu")
    sql = "MATCH {class:Person, as:p, where:(age > 40)}-knows->{as:f} RETURN p.uid AS p"
    rows = db.query(sql).to_dicts()
    dg = device_graph(snap, db.device)
    key = "v:age:v"
    assert key in dg.arrays
    # pretend the column was never uploaded
    dg._pending[key] = snap.v_columns["age"].values
    del dg.arrays[key]
    with pytest.raises(RuntimeError, match="upload during a replay"):
        db.query(sql)
    dg.ensure_key(key)  # outside a replay the upload goes ahead
    assert canonical_rows(db.query(sql).to_dicts()) == canonical_rows(rows)


def test_overflow_twin_runs_only_while_recording(monkeypatch):
    db, snap = build_person_knows(2_000, avg_knows=5, seed=2, device="cpu")
    dtypes = []
    orig = TE.TpuMatchSolver._pushdown_weights

    def weights(self, steps, dtype):
        dtypes.append(dtype)
        return orig(self, steps, dtype)

    monkeypatch.setattr(TE.TpuMatchSolver, "_pushdown_weights", weights)
    first = db.query(Q2).to_dicts()
    assert dtypes == [torch.int32, torch.float32]
    dtypes.clear()
    assert db.query(Q2).to_dicts() == first
    assert dtypes == [torch.int32]


def test_code_table_uploads_once_per_compiled_predicate(demodb, monkeypatch):
    jdb, db, snap = demodb
    sql = (
        "MATCH {class:Profiles, as:p, where:(name LIKE 's%' AND surname MATCHES '[a-m].*')}"
        "-HasFriend->{as:f} RETURN p.uid AS p, f.uid AS f"
    )
    uploads = []
    real = torch.from_numpy

    def from_numpy(a):
        uploads.append(a.dtype)
        return real(a)

    monkeypatch.setattr(torch, "from_numpy", from_numpy)
    solver = TE.TpuMatchSolver(db, parse(sql), {})
    # the two code tables (and the class table, once per graph)
    assert uploads.count(np.dtype(bool)) >= 2
    idx = torch.arange(snap.num_vertices, dtype=torch.int32)
    first = solver._node_masks["p"](idx)  # uploads the lazily read columns
    n = len(uploads)
    for _ in range(3):
        assert torch.equal(solver._node_masks["p"](idx), first)
    assert len(uploads) == n
    monkeypatch.setattr(torch, "from_numpy", real)
    for _ in range(2):
        got = db.query(sql).to_dicts()
        want = jdb.query(sql, engine="tpu", strict=True).to_dicts()
        assert canonical_rows(got) == j_canonical_rows(want)


def _cached_plan_refs():
    db, snap = build_person_knows(500, device="cpu")
    for _ in range(2):
        db.query(Q3, {"k": 50}).to_dicts()
    plan = _variants(snap, Q3).plans[0]
    assert plan.replays == 1
    return [weakref.ref(snap), weakref.ref(plan), weakref.ref(plan.solver.dg)]


def test_plan_cache_is_freed_with_its_snapshot():
    refs = _cached_plan_refs()
    gc.collect()  # the snapshot's cycle (snapshot → cache → plan → solver)
    gc.collect()  # the device graph, held by the weak map until the first pass
    assert [r() is None for r in refs] == [True, True, True]
