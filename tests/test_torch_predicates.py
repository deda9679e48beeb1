"""The port's predicate programs (`orientdb_tpu_torch/ops/predicates.py`,
run by `K.plain_predicate_eval` on the CPU) against the reference package's
`compile_predicate` masks, and ``distance()`` MATCH queries against the
reference's ``engine="tpu"``.

Two carried snapshots: demodb (strings, classes) and a small spatial graph
of Places (lat/lng, int, float, bool and string columns with absent values,
int32 extremes, zero and negative divisors, the dateline and a near-pole
vertex) with a ``near`` edge class. Masks are evaluated over ids made with
numpy from a seed, with -1 padding and past-end indices, and must be equal;
values of arithmetic nodes must be equal where present. distance() masks
may differ only on the boundary band: slots whose float64 distance lies
within 0.01 km + 1e-5·r of r (float32 sin/cos/asin differ in their last
bits between libraries); rows must equal the reference's under
`canonical_rows`.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientdb_tpu import Database as JDatabase
from orientdb_tpu import PropertyType
from orientdb_tpu.exec.result import canonical_rows as j_canonical_rows
from orientdb_tpu.ops import predicates as JP
from orientdb_tpu.ops.device_graph import device_graph as j_device_graph
from orientdb_tpu.sql.parser import parse as j_parse
from orientdb_tpu.storage.ingest import generate_demodb
from orientdb_tpu.storage.snapshot import attach_fresh_snapshot, build_snapshot
from orientdb_tpu_torch.carry import snapshot_from_arrays
from orientdb_tpu_torch.exec import tpu_engine as TE
from orientdb_tpu_torch.exec.result import canonical_rows
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.ops import predicates as P
from orientdb_tpu_torch.ops.device_graph import device_graph
from orientdb_tpu_torch.sql.parser import parse
from orientdb_tpu_torch.storage.bigshape import numpy_distance_km
from test_torch_match import _carry_arrays

CPU = torch.device("cpu")
INT_MIN, INT_MAX = -(2**31), 2**31 - 1
N_IDS = 1200


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Side:
    """One carried snapshot seen by both packages: the reference database
    and device graph, the port's, and ids / binding rows from a seed."""

    def __init__(self, jdb):
        jsnap = jdb.current_snapshot()
        self.jdb, self.jsnap = jdb, jsnap
        self.jdg = j_device_graph(jsnap)
        self.db, self.snap = snapshot_from_arrays(*_carry_arrays(jdb, jsnap), device="cpu")
        self.dg = device_graph(self.snap, CPU)
        V = jsnap.num_vertices
        rng = np.random.default_rng(6)
        ids = rng.integers(-2, V + 4, N_IDS).astype(np.int32)
        ids[::9] = -1
        self.ids = ids
        self.rows = rng.integers(-1, V + 2, N_IDS).astype(np.int32)
        self.V = V

    def scopes(self, binding: bool):
        extra = dict(binding_columns=self.jdg.columns, visible_aliases={"p"}) if binding else {}
        js = JP.ColumnScope(self.jdg.columns, self.jdg.non_columnar, **extra)
        extra = dict(binding_columns=self.dg.columns, visible_aliases={"p"}) if binding else {}
        ps = P.ColumnScope(self.dg.columns, self.dg.non_columnar, device=CPU, **extra)
        return js, ps

    def envs(self, depth):
        jenv, penv = {}, {}
        if depth is not None:
            jenv["depth"] = penv["depth"] = depth
        jenv["bindings"] = {"p": jnp.asarray(self.rows)}
        penv["bindings"] = {"p": torch.from_numpy(self.rows)}
        return jenv, penv

    def masks(self, where, params=None, depth=None, binding=False):
        """(reference mask, port mask) of ``where`` over the ids; the port's
        program without the padding term, so padding reads are compared."""
        params = params or {}
        js, ps = self.scopes(binding)
        jfn = JP.compile_predicate(
            j_parse(f"SELECT FROM V WHERE {where}").where, js, JP.ParamBox(params),
            allow_depth=depth is not None,
        )
        box = P.ParamBox(params)
        term = P.compile_where(
            parse(f"SELECT FROM V WHERE {where}").where, ps, box, allow_depth=depth is not None
        )
        pred = P.Predicate([term], CPU, box)
        jenv, penv = self.envs(depth)
        jm = np.asarray(jfn(jnp.asarray(self.ids), jenv))
        pm = pred(torch.from_numpy(self.ids), penv).numpy()
        return jm, pm, pred


@pytest.fixture(scope="module")
def demo():
    jdb = generate_demodb(n_profiles=300, avg_friends=1, seed=1)
    jdb.attach_snapshot(build_snapshot(jdb))
    return Side(jdb)


@pytest.fixture(scope="module")
def geo():
    jdb = JDatabase("geo")
    place = jdb.schema.create_vertex_class("Place")
    place.create_property("lat", PropertyType.DOUBLE)
    place.create_property("lng", PropertyType.DOUBLE)
    jdb.schema.create_edge_class("near")
    rng = random.Random(7)  # the lat/lng draws of tests/test_spatial.py
    extra = np.random.default_rng(17)
    words = ["", "alpha", "beta", "bx", "delta", "m1", "omega", "zeta"]
    vs = []
    for i in range(400):
        props = dict(name=f"pl{i}", lat=rng.uniform(-85, 85), lng=rng.uniform(-180, 180), uid=i)
        if extra.random() < 0.9:
            props["n"] = int(extra.integers(-50, 50))
        if extra.random() < 0.9:
            props["m"] = int(extra.integers(-4, 5))
        if extra.random() < 0.9:
            # the reference's snapshot build keeps -2**31 and -2**31 + 1 out of int columns
            props["big"] = int(extra.choice([INT_MIN + 2, INT_MAX, 2**30 + 7, -(2**30) - 3, 5]))
        if extra.random() < 0.9:
            props["score"] = float(np.float32(extra.standard_normal() * 10))
        if extra.random() < 0.9:
            props["ratio"] = float(extra.integers(-3, 4)) * 0.5
        if extra.random() < 0.9:
            props["flag"] = bool(extra.integers(0, 2))
        if extra.random() < 0.9:
            props["tag"] = str(extra.choice(words))
        vs.append(jdb.new_vertex("Place", **props))
    # antimeridian + pole-adjacent edge cases, and a Place without lng
    vs.append(jdb.new_vertex("Place", name="dateline_w", lat=10.0, lng=179.9, uid=400))
    vs.append(jdb.new_vertex("Place", name="dateline_e", lat=10.0, lng=-179.9, uid=401))
    vs.append(jdb.new_vertex("Place", name="near_pole", lat=89.5, lng=42.0, uid=402))
    vs.append(jdb.new_vertex("Place", name="no_lng", lat=12.0, uid=403))
    for i, v in enumerate(vs):
        for j in extra.integers(0, len(vs), 3):
            jdb.new_edge("near", v, vs[int(j)], w=int(extra.integers(0, 100)))
    attach_fresh_snapshot(jdb)
    return Side(jdb)


def test_spatial_snapshot_columns(geo):
    kinds = {n: c.kind for n, c in geo.snap.v_columns.items()}
    assert kinds["lat"] == kinds["lng"] == kinds["score"] == "float"
    assert kinds["n"] == kinds["big"] == "int" and kinds["flag"] == "bool" and kinds["tag"] == "str"
    assert not geo.snap.v_columns["lng"].present.all()
    assert set(geo.snap.v_columns["big"].values.tolist()) >= {INT_MIN + 2, INT_MAX}


GEO_WHERES = [
    # int, float and mixed compares, bool vs int, incomparables
    "n > 3", "n <= m", "n = m", "n != 5", "score < 2.5", "score >= ratio", "n < score",
    "score = 3", "flag = 1", "flag = true", "flag < 1", "n != 'x'", "tag = 5", "'x' != n",
    # string rank, code tables, truthiness, same-dictionary codes
    "tag >= 'm'", "tag < 'bx'", "tag <= 'bx'", "tag > 'beta'", "tag = 'omega'", "tag = 'nope'",
    "tag != 'nope'", "tag != 'alpha'", "'m' < tag", "tag LIKE 'b%'", "tag MATCHES '[a-d].*'",
    "tag CONTAINSTEXT 'ta'", "tag", "tag = tag", "tag < tag", "name LIKE 'pl1%'",
    # IN, mixed lists included
    "n IN [20, 'x', 30.5, -7, 3]", "score IN [1, 2.5]", "tag IN ['beta', 'zeta', 3]", "n IN []",
    # arithmetic with negatives, zero divisors, wraps
    "n + m > 0", "n - m * 3 < 7", "n % m = 1", "n % m < 0", "n / m > 0.5", "score / ratio > 1.5",
    "score % ratio > 0.5", "score % -1.5 < -0.5", "-n > 3", "-big < 0", "-big = big",
    "big + big > 0", "big * 3 < 0", "big - 1 > big", "score * 2.5 - n > 1", "n * 1.5 > score",
    # nulls, boolean structure, BETWEEN, truthiness
    "score IS NULL", "tag IS NOT NULL", "missing IS NULL", "missing IS NOT NULL", "missing = 3",
    "missing != 3", "NOT (score > 1 AND (flag OR tag IS NULL))", "NOT missing > 3",
    "n BETWEEN -3 AND 7", "score BETWEEN -1.5 AND 2", "flag", "n", "score", "true", "false",
    "(n > 0 OR score < 0) AND NOT (flag AND m = 0) OR tag LIKE 'a%'",
    # distance() operands that compile to null or constants
    "distance(lat, lng, 10, missing) < 100", "distance(1, 2, 3, 4) < 400",
]


@pytest.mark.parametrize("where", GEO_WHERES)
def test_masks_equal_reference(geo, where):
    jm, pm, _ = geo.masks(where)
    assert jm.dtype == pm.dtype == np.bool_
    assert np.array_equal(jm, pm), where


@pytest.mark.parametrize(
    "where,params,depth",
    [
        ("n < :k AND score > :x", {"k": 7, "x": -2.5}, None),
        ("flag = :b OR n = :k", {"b": True, "k": -3}, None),
        ("n + :k > :x", {"k": INT_MAX, "x": 0.5}, None),
        ("$depth < m", {}, 2),
        ("$depth = 0 OR n > $depth * 10", {}, 0),
        ("$depth + n < :k", {"k": 4}, 3),
    ],
)
def test_params_and_depth_equal_reference(geo, where, params, depth):
    jm, pm, pred = geo.masks(where, params, depth)
    assert np.array_equal(jm, pm), where
    assert pred.uses_params == bool(params)


@pytest.mark.parametrize(
    "where",
    ["n < p.n", "score > p.score AND tag = p.tag", "p.flag", "p.missing IS NULL", "n + p.m > p.big"],
)
def test_binding_references_equal_reference(geo, where):
    jm, pm, _ = geo.masks(where, binding=True)
    assert np.array_equal(jm, pm), where


@pytest.mark.parametrize(
    "expr",
    ["n + m", "n - m * 3", "n % m", "n / m", "-n", "-big", "big + big", "big * 3", "big - n",
     "score * 2.5 - n", "score % ratio", "score / m", "-score", "n % -1", "big % -1", "$depth * n",
     "-(-big - 1)", "(-big - 1) % -1", "(big + big) % 7"],
)
def test_arithmetic_values_equal_reference(geo, expr):
    """A value node's (value, present) pair, exactly where present."""
    js, ps = geo.scopes(False)
    jv, jp = JP.Compiler(js, {}, allow_depth=True)._value(j_parse(f"SELECT FROM V WHERE {expr}").where).emit(
        jnp.asarray(geo.ids), {"depth": 3}
    )
    val = P.Compiler(ps, {}, allow_depth=True)._value(parse(f"SELECT FROM V WHERE {expr}").where)
    prog = P._Program(val.node, CPU)
    pv, pp = K.plain_predicate_eval(prog.prog, prog.buffers({}, [], N_IDS), torch.from_numpy(geo.ids),
                                    depth=3, values=True)
    jp = np.asarray(jp)
    assert np.array_equal(jp, pp.numpy())
    want = np.asarray(jv)
    got = pv.numpy().view(np.float32) if want.dtype == np.float32 else pv.numpy()
    assert np.array_equal(got[jp], want[jp], equal_nan=True), expr


@pytest.mark.parametrize(
    "where",
    ["name LIKE 'a%'", "surname >= 'm'", "name MATCHES 'alice1.*'", "surname CONTAINSTEXT 'an'",
     "name", "surname = surname", "surname IN ['smith', 'chen', 7]", "NOT (surname < 'k')",
     "age % 7 = 3 AND uid * 2 > 100"],
)
def test_demodb_strings_equal_reference(demo, where):
    jm, pm, _ = demo.masks(where)
    assert np.array_equal(jm, pm), where
    assert 0 < pm.sum() < N_IDS


@pytest.mark.parametrize("cls", ["Profiles", "V", "HasFriend"])
def test_class_lookup(demo, cls):
    """The class-closure term against the snapshot's class mask through
    take_pad's padding rules."""
    pred = P.Predicate([P.class_term(demo.dg.v_class, demo.dg.class_table(cls))], CPU)
    got = pred(torch.from_numpy(demo.ids)).numpy()
    cm = demo.snap.class_mask(cls)
    want = np.where(demo.ids >= 0, cm[np.clip(demo.ids, 0, demo.V - 1)], False)
    assert np.array_equal(got, want)
    ident = pred.identity(512, demo.V).numpy()
    assert np.array_equal(ident[: demo.V], cm) and not ident[demo.V :].any()


def test_long_and_wide_predicates(demo):
    """A 200-term predicate and a 1,000-item IN list compile and agree;
    forced splits (a stack of 4, 8 buffers) give the same mask."""
    terms = " AND ".join(f"(age > {i % 40} OR uid < {i})" for i in range(100))
    terms += " OR " + " OR ".join(f"surname = 'x{i}'" for i in range(100))
    jm, pm, pred = demo.masks(terms)
    assert np.array_equal(jm, pm) and len(pred.programs) == 1
    items = ", ".join(str(i) for i in range(0, 2000, 2))
    jm2, pm2, pred2 = demo.masks(f"uid IN [{items}]")
    assert np.array_equal(jm2, pm2) and 0 < pm2.sum()
    assert len(pred2.programs[0].prog.rows) > 3000
    _, ps = demo.scopes(False)
    term = P.compile_where(parse(f"SELECT FROM V WHERE {terms}").where, ps, {})
    split = P.Predicate([term], CPU, max_stack=3)
    assert len(split.programs) > 1
    assert np.array_equal(split(torch.from_numpy(demo.ids)).numpy(), pm)


@pytest.mark.parametrize("max_stack,max_bufs", [(4, 8), (5, 6), (16, 10)])
def test_split_launches_equal_reference(geo, max_stack, max_bufs):
    """A predicate over more columns than a launch's buffer table holds,
    and deeper than its stack: chunks and subtrees run as earlier launches
    read back through TMP, and the mask stays the reference's."""
    where = (
        "(n > 0 AND m > 0 AND big > 0 OR score > 0 AND ratio > 0) AND (flag OR tag IS NOT NULL) "
        "AND (lat > 0 OR lng > 0 OR p.n > n) AND NOT (p.score < score AND p.tag = tag) "
        "AND ((n + m) * (big - n) > (score - ratio) * (lat + lng) OR uid % 3 = 0)"
    )
    jm, pm, _ = geo.masks(where, binding=True)
    assert np.array_equal(jm, pm) and 0 < pm.sum()
    _, ps = geo.scopes(True)
    term = P.compile_where(parse(f"SELECT FROM V WHERE {where}").where, ps, {})
    split = P.Predicate([term], CPU, max_stack=max_stack, max_bufs=max_bufs)
    assert len(split.programs) > 1
    _, penv = geo.envs(None)
    assert np.array_equal(split(torch.from_numpy(geo.ids), penv).numpy(), pm)


@pytest.mark.parametrize(
    "expr",
    ["distance(lat, lng, 'x', 1) < 3", "distance(lat, lng, flag, 1) < 3", "distance(lat, lng, 1) < 3",
     "distance(lat, lng, 1, 2, 'furlong') < 3", "distance(lat, lng, 1, 2, tag) < 3", "tag + 1 > 2"],
)
def test_refusals_match_reference(geo, expr):
    js, ps = geo.scopes(False)
    with pytest.raises(JP.Uncompilable):
        JP.compile_predicate(j_parse(f"SELECT FROM V WHERE {expr}").where, js, {})
    with pytest.raises(P.Uncompilable):
        P.compile_predicate(parse(f"SELECT FROM V WHERE {expr}").where, ps, {})


def _band(d, r):
    return np.abs(d - r) <= 0.01 + 1e-5 * r


@pytest.mark.parametrize(
    "where,other,scale,r",
    [
        ("distance(lat, lng, 48.0, 2.0) < 2500", (48.0, 2.0), 1.0, 2500),
        ("distance(lat, lng, 10.0, 179.9) < 500", (10.0, 179.9), 1.0, 500),
        ("distance(lat, lng, 0.0, 0.0, 'mi') < 1200", (0.0, 0.0), 0.621371192, 1200),
        ("distance(lat, lng, -20.5, 130.25) <= 1500", (-20.5, 130.25), 1.0, 1500),
        ("distance(lat, lng, p.lat, p.lng) < 4000", "bind", 1.0, 4000),
        ("distance(p.lat, p.lng, lat, lng, 'miles') >= 3000", "bind", 0.621371192, 3000),
    ],
)
def test_distance_masks_equal_reference_outside_band(geo, where, other, scale, r):
    jm, pm, _ = geo.masks(where, binding=True)
    cols = geo.snap.v_columns
    lat, lng = cols["lat"], cols["lng"]
    at = np.clip(geo.ids, 0, geo.V - 1)
    if other == "bind":
        rr = np.clip(geo.rows, 0, geo.V - 1)
        d = numpy_distance_km(lat.values[at], lng.values[at], lat.values[rr], lng.values[rr])
        live = lat.present[at] & lng.present[at] & lat.present[rr] & lng.present[rr]
        live &= (geo.ids >= 0) & (geo.rows >= 0)
    else:
        d = numpy_distance_km(lat.values[at], lng.values[at], *other)
        live = lat.present[at] & lng.present[at] & (geo.ids >= 0)
    band = _band(d, r / scale)  # in km
    d = d * scale
    inside = (d <= r) if "<=" in where else (d >= r) if ">=" in where else (d < r)
    want = live & inside
    assert not ((jm != pm) & ~band).any()
    assert not ((pm != want) & ~band).any()
    assert 0 < pm.sum() < live.sum()


SPATIAL = "MATCH {class:Place, as:p, where:(distance(lat, lng, 48.0, 2.0) < :r)} RETURN p.name AS name"


def _same_rows(geo, sql, params):
    got = geo.db.query(sql, params).to_dicts()
    want = geo.jdb.query(sql, params=params, engine="tpu", strict=True).to_dicts()
    assert canonical_rows(got) == j_canonical_rows(want), (sql, params)
    return got


def test_match_distance_records_then_replays(geo):
    """tests/test_spatial.py's MATCH predicate: the first radius records,
    the others replay the same plan through the parameter row."""
    counts = [len(_same_rows(geo, SPATIAL, {"r": r})) for r in (8000, 300, 2500)]
    assert counts[1] < counts[2] < counts[0]
    (variants,) = [v for k, v in TE._plan_cache(geo.snap).items() if k[0] == parse(SPATIAL)]
    assert len(variants.plans) == 1 and variants.plans[0].replays == 2
    assert len(_same_rows(geo, SPATIAL, {"r": 2500.5})) == counts[2]


@pytest.mark.parametrize(
    "sql,params",
    [
        ("MATCH {class:Place, as:p, where:(distance(lat, lng, 0.0, 0.0, 'mi') < :r)} "
         "RETURN p.uid AS u", {"r": 1200}),
        ("MATCH {class:Place, as:p, where:(distance(lat, lng, 10.0, 179.9) < 500)} RETURN p.name AS n", {}),
        ("MATCH {class:Place, as:p, where:(distance(lat, lng, 89.0, -100.0) < 400)} "
         "RETURN p.name AS n", {}),
        ("MATCH {class:Place, as:p, where:(distance(lat, lng, :x, :y) < :r)} RETURN count(*) AS n",
         {"x": -20.5, "y": 130.25, "r": 1500.0}),
        ("MATCH {class:Place, as:p, where:(distance(lat, lng, 10, missing) < 100 OR uid < 3)} "
         "RETURN p.uid AS u", {}),
        ("MATCH {class:Place, as:p, where:(uid < 60)}-near->{as:f, where:(distance(lat, lng, p.lat, "
         "p.lng) < :r)} RETURN p.uid AS p, f.uid AS f", {"r": 5000}),
        ("MATCH {class:Place, as:p, where:(uid < 120)}-near->{as:f, where:(distance(lat, lng, p.lat, "
         "p.lng, 'mi') < :r)} RETURN count(*) AS n", {"r": 3000.0}),
        ("MATCH {class:Place, as:p, where:(uid < 40)}-near{as:e, where:(w < 50)}->{as:f, where:"
         "(distance(p.lat, p.lng, lat, lng) > 2000)} RETURN p.uid AS p, f.uid AS f, e.w AS w", {}),
    ],
    ids=["miles", "dateline", "near_pole", "count_params", "missing", "friends", "friends_count", "edge_where"],
)
def test_match_distance_shapes_equal_reference(geo, sql, params):
    rows = _same_rows(geo, sql, params)
    assert rows
    if params:
        _same_rows(geo, sql, params)  # the replay
