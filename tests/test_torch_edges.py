"""The port's edge bindings, edge-property WHERE, OPTIONAL arms and
binding-referencing WHERE against the reference package, on the CPU.

Each query runs through the port twice, the recording call and the
replay, and must give the reference's rows under `canonical_rows` (the
exact list where the query has ORDER BY), against both of the reference's
engines (``engine="tpu", strict=True`` and ``engine="oracle"``), on the
randomized graphs of `tests/test_tpu_fuzz.py` carried across from
reference snapshots with their edge property columns
(`tests/test_torch_ldbc.py` does the same on the social graph and the LDBC
short reads). The chip queries E1–E5 of `chip_smoke.py` run on a small
SNB-shape graph against the exact numpy enumerations of
`storage/bigshape.py`, and their replays must read no device value on the
host. The left-join count `rows_with_matches` (plain version) is held
against the reference's on seeded inputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from orientdb_tpu.exec.result import canonical_rows as j_canonical_rows
from orientdb_tpu.ops import csr as JK
from orientdb_tpu.storage.bigshape import build_snb_shape as j_build_snb_shape
from orientdb_tpu_torch.carry import snapshot_from_arrays
from orientdb_tpu_torch.exec import tpu_engine as TE
from orientdb_tpu_torch.exec.result import canonical_rows
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.sql.parser import parse
from orientdb_tpu_torch.storage.bigshape import (
    build_snb_shape,
    numpy_config5_count,
    numpy_incident_rows,
    numpy_optional_rows,
    numpy_out_edge_rows,
    numpy_probe_rows,
    numpy_undirected_rows,
)
from orientdb_tpu_torch.utils.config import config
from test_torch_match import _carry_arrays
from test_tpu_fuzz import TEMPLATES, random_db

# chip_smoke.py's E1–E5
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
E2_BOTH = (
    "MATCH {class:Person, as:p, where:(uid < :n)}.bothE('knows'){as:e}, "
    "{as:e}.bothV(){as:v} RETURN p.uid AS p, v.uid AS v"
)
E3 = (
    "MATCH {class:Person, as:p, where:(uid < :n)}-knows{as:kn}-{as:f} "
    "RETURN p.uid AS p, f.uid AS f, kn.creationDate AS cd ORDER BY cd DESC, f ASC"
)
E4 = (
    "MATCH {class:Person, as:p, where:(uid < :n)}"
    "-knows->{as:f, optional:true, where:(age > 75)} RETURN p.uid AS p, f.uid AS f"
)
E5 = (
    "MATCH {class:Person, as:p, where:(uid < :n)}-knows->{as:f, where:(age < p.age)}, "
    "{as:f}-knows{as:kn, optional:true, where:(creationDate > :d)}-{as:p} "
    "RETURN p.uid AS p, f.uid AS f, kn IS NOT NULL AS probe"
)

# tests/test_tpu_fuzz.py's templates from the OPTIONAL arm on: OPTIONAL,
# binding references, NOT arms (with an edge WHERE), method-form arms
FUZZ = TEMPLATES[TEMPLATES.index(next(t for t in TEMPLATES if "optional:true" in t)) :]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads, and the suite runs
    in parallel workers: keep torch to one thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(jdb):
    """The reference database's snapshot arrays, edge columns included,
    carried into the port."""
    return snapshot_from_arrays(*_carry_arrays(jdb, jdb.current_snapshot()), device="cpu")


def _same_as_reference(db, jdb, sql, params=None):
    """The port's recording and replay equal both reference engines."""
    want = jdb.query(sql, params, engine="tpu", strict=True).to_dicts()
    oracle = jdb.query(sql, params, engine="oracle").to_dicts()
    ordered = "ORDER BY" in sql
    if ordered:
        assert want == oracle, (sql, params)
    else:
        assert j_canonical_rows(want) == j_canonical_rows(oracle), (sql, params)
    for call in ("record", "replay"):
        got = db.query(sql, params).to_dicts()
        if ordered:
            assert got == want, (sql, params, call)
        else:
            assert canonical_rows(got) == j_canonical_rows(want), (sql, params, call)
    return want


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fuzz_templates_equal_reference(seed):
    jdb = random_db(seed)
    db, _snap = _carry(jdb)
    assert any("outE" in t for t in FUZZ) and any("a.age" in t for t in FUZZ)
    for sql in FUZZ:
        _same_as_reference(db, jdb, sql)


@pytest.mark.parametrize("num_segments", [1, 7, 1024])
@pytest.mark.parametrize("w", [0, 1, 255, 257])
def test_rows_with_matches_plain_equals_reference(num_segments, w):
    rng = np.random.default_rng(1000 * w + num_segments)
    cases = [
        (rng.integers(-1, num_segments + 3, w), rng.random(w) < 0.6),  # ids past the end too
        (np.full(w, -1), np.ones(w, bool)),  # all padding
        (rng.integers(0, num_segments, w), np.zeros(w, bool)),  # all masked
        (np.sort(rng.integers(0, min(num_segments, 3), w)), np.ones(w, bool)),  # duplicate rows
    ]
    for rows, mask in cases:
        rows = rows.astype(np.int32)
        want = np.asarray(JK.rows_with_matches(rows, mask, num_segments=num_segments))
        r, m = torch.from_numpy(rows), torch.from_numpy(mask)
        got = K.plain_rows_with_matches(r, m, num_segments)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        assert torch.equal(K.rows_with_matches(r, m, num_segments), got)
        acc = torch.ones(num_segments, dtype=torch.int32)
        assert torch.equal(K.rows_with_matches(r, m, num_segments, out=acc), got + 1)


# ---------------------------------------------------------------------------
# E1–E5 on a small SNB-shape graph
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def snb_shape():
    return build_snb_shape(2_000, msgs_per_person=2, avg_knows=10, seed=7, device="cpu")


def _variants(snap, sql):
    stmt = parse(sql)
    cfg = dataclasses.astuple(config)
    found = [v for k, v in TE._plan_cache(snap).items() if k[0] == stmt and k[2] == cfg]
    assert len(found) == 1, f"{len(found)} cache entries for {sql}"
    return found[0]


def _rows(rows, names):
    got = np.array(
        [tuple(-1 if r[k] is None else int(r[k]) for k in names) for r in rows], np.int64
    ).reshape(-1, len(names))
    return got[np.lexsort(got.T[::-1])]


def _e_checks(snap):
    """(query, [parameters: recording value, then replayed values], check)."""
    age = snap.v_columns["age"].values
    young, old = age < 30, age > 75

    def rows_equal(want_fn, names):
        return lambda rows, p: np.array_equal(_rows(rows, names), want_fn(p))

    def e3(rows, p):
        want = numpy_undirected_rows(snap, p["n"])
        got = np.array([(r["p"], r["f"], r["cd"]) for r in rows], np.int64).reshape(-1, 3)
        # ORDER BY cd DESC, f ASC: the keys in order, the rows as a multiset
        return np.array_equal(got[:, 1:], want[:, 1:]) and np.array_equal(
            got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])]
        )

    def e5(rows, p):
        assert all(isinstance(r["probe"], bool) for r in rows)
        assert {r["probe"] for r in rows} == {True, False}
        return np.array_equal(_rows(rows, ("p", "f", "probe")), numpy_probe_rows(snap, p["n"], p["d"]))

    return [
        (E1, [{"d": 12_000}, {"d": 15_000}, {"d": 18_500}],
         lambda rows, p: rows == [{"n": numpy_config5_count(snap, p["d"])}]),
        (E2, [{"n": 200, "d": 15_000}, {"n": 100, "d": 15_000}],
         rows_equal(lambda p: numpy_out_edge_rows(snap, p["n"], p["d"], young), ("p", "f", "cd"))),
        (E2_BOTH, [{"n": 64}, {"n": 32}],
         rows_equal(lambda p: numpy_incident_rows(snap, p["n"]), ("p", "v"))),
        (E3, [{"n": 256}, {"n": 128}], e3),
        (E4, [{"n": 2_000}, {"n": 1_000}],
         rows_equal(lambda p: numpy_optional_rows(snap, p["n"], old), ("p", "f"))),
        (E5, [{"n": 2_000, "d": 15_000}, {"n": 1_000, "d": 15_000}], e5),
    ]


def test_snb_shape_arrays_byte_identical(snb_shape):
    db, snap = snb_shape
    _jdb, jsnap = j_build_snb_shape(2_000, msgs_per_person=2, avg_knows=10, seed=7)
    assert snap.v_class.tobytes() == jsnap.v_class.tobytes()
    for name in ("uid", "age", "length"):
        for part in ("values", "present"):
            a = getattr(snap.v_columns[name], part)
            assert a.tobytes() == getattr(jsnap.v_columns[name], part).tobytes(), name
    for cname in ("knows", "hasCreator"):
        a, b = snap.edge_classes[cname], jsnap.edge_classes[cname]
        for key in ("indptr_out", "dst", "indptr_in", "src", "edge_id_in"):
            assert getattr(a, key).tobytes() == getattr(b, key).tobytes(), (cname, key)
        assert sorted(a.edge_columns) == sorted(b.edge_columns)
    cd, jcd = (s.edge_classes["knows"].edge_columns["creationDate"] for s in (snap, jsnap))
    assert cd.values.tobytes() == jcd.values.tobytes()
    assert snap.class_vertex_range == jsnap.class_vertex_range


def test_e_queries_equal_numpy_on_record_and_replay(snb_shape):
    db, snap = snb_shape
    for sql, params, check in _e_checks(snap):
        for p in [params[0]] + params:  # record, then replay every value
            assert check(db.query(sql, p).to_dicts(), p), (sql, p)
        v = _variants(snap, sql)
        assert len(v.plans) == 1 and v.plans[0].replays == len(params), sql


def test_config5_count_pushdown_suffix_equals_reference(snb_shape):
    """Both packages collapse the same suffix of the E1 plan (the
    hasCreator arm) into weight passes."""
    from orientdb_tpu.exec.tpu_engine import TpuMatchSolver as JSolver
    from orientdb_tpu.sql.parser import parse as jparse

    db, snap = snb_shape
    jdb, _jsnap = j_build_snb_shape(2_000, msgs_per_person=2, avg_knows=10, seed=7)
    mine = TE.TpuMatchSolver(db, parse(E1), {"d": 15_000})
    ref = JSolver(jdb, jparse(E1), {"d": 15_000})
    assert [s.describe() for s in mine.plan] == [s.describe() for s in ref.plan]
    got = [s.describe() for s in mine._count_pushdown_steps()]
    assert got == [s.describe() for s in ref._count_pushdown_steps()]
    # `.outE('knows'){where:…}.inV(){as:f}` is one arm with an edge WHERE:
    # the weight passes take it (its edge mask) and the hasCreator arm
    assert got == ["EXPAND p->f", "EXPAND m<-f"]


_HOST_READS = ("item", "__int__", "__float__", "__bool__", "__index__", "cpu", "tolist")


def test_e_replays_read_no_host_value(monkeypatch):
    """Between dispatch and fetch a replay of E1–E5 reads no device value
    on the host: the OPTIONAL arms' unmatched compactions too keep their
    recorded sizes and flag an overflow on the device."""
    db, snap = build_snb_shape(600, msgs_per_person=2, avg_knows=6, seed=3, device="cpu")
    checks = _e_checks(snap)
    first = {sql: db.query(sql, params[0]).to_dicts() for sql, params, _c in checks}
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
    for sql, params, _check in checks:
        got = db.query(sql, params[0]).to_dicts()
        if "ORDER BY" in sql:
            assert got == first[sql]
        else:
            assert canonical_rows(got) == canonical_rows(first[sql])
        assert _variants(snap, sql).plans[0].replays == 1
