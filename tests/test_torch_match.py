"""The port's compiled MATCH path (`orientdb_tpu_torch`) against the
reference package on the same graphs, on the CPU.

Counts must be equal to the reference's ``engine="tpu"`` and to the exact
numpy references; row-returning queries must give the same multiset of
rows under `canonical_rows`. The graphs are small: Person–knows from the
array-native builder (with and without supernodes) and the demodb graph
carried across from a reference snapshot with `carry.snapshot_from_arrays`.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from orientdb_tpu.exec.result import canonical_rows as j_canonical_rows
from orientdb_tpu.storage.bigshape import build_person_knows as j_build_person_knows
from orientdb_tpu.storage.ingest import generate_demodb
from orientdb_tpu.storage.snapshot import build_snapshot
from orientdb_tpu_torch import Database
from orientdb_tpu_torch.carry import snapshot_from_arrays
from orientdb_tpu_torch.exec.result import canonical_rows
from orientdb_tpu_torch.ops.predicates import Uncompilable
from orientdb_tpu_torch.storage.bigshape import (
    build_person_knows,
    numpy_1hop_count,
    numpy_2hop_count,
)

REPO = Path(__file__).resolve().parent.parent

Q1 = (
    "MATCH {class:Person, as:p, where:(age > 40)}"
    "-knows->{as:f, where:(age < 30)} "
    "RETURN count(*) AS n"
)
Q2 = (
    "MATCH {class:Person, as:p, where:(age > 40)}"
    "-knows->{as:f}"
    "-knows->{as:g, where:(age < 30)} "
    "RETURN count(*) AS n"
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
# the bench headline pair (bench.py:1272, :1279)
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
    kw = dict(
        avg_knows=8, seed=3, supernodes=skew, supernode_degree=2_000 if skew else 0
    )
    jdb, jsnap = j_build_person_knows(20_000, **kw)
    db, snap = build_person_knows(20_000, device="cpu", **kw)
    return jdb, jsnap, db, snap


def test_bigshape_arrays_byte_identical(person_knows):
    jdb, jsnap, db, snap = person_knows
    assert snap.num_vertices == jsnap.num_vertices
    assert snap.v_class.tobytes() == jsnap.v_class.tobytes()
    for name in ("uid", "age"):
        assert snap.v_columns[name].values.tobytes() == jsnap.v_columns[name].values.tobytes()
        assert snap.v_columns[name].present.tobytes() == jsnap.v_columns[name].present.tobytes()
    a, b = snap.edge_classes["knows"], jsnap.edge_classes["knows"]
    for key in ("indptr_out", "dst", "indptr_in", "src", "edge_id_in"):
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), key
    assert snap.class_names == jsnap.class_names
    assert snap.class_vertex_range == jsnap.class_vertex_range


def test_counts_equal_reference_and_numpy(person_knows):
    jdb, jsnap, db, snap = person_knows
    age = snap.v_columns["age"].values
    want1 = numpy_1hop_count(snap, age > 40, age < 30)
    want2 = numpy_2hop_count(snap, age > 40, np.ones(age.shape[0], bool), age < 30)
    assert db.query(Q1).to_dicts() == [{"n": want1}]
    assert db.query(Q2).to_dicts() == [{"n": want2}]
    assert jdb.query(Q1, engine="tpu", strict=True).to_dicts() == [{"n": want1}]
    assert jdb.query(Q2, engine="tpu", strict=True).to_dicts() == [{"n": want2}]


@pytest.mark.parametrize("sql,k", [(Q3, 60), (Q_ROWS_1HOP, 4_000)], ids=["q3", "rows_1hop"])
def test_rows_equal_reference(person_knows, sql, k):
    jdb, jsnap, db, snap = person_knows
    got = db.query(sql, {"k": k}).to_dicts()
    want = jdb.query(sql, {"k": k}, engine="tpu", strict=True).to_dicts()
    assert len(got) > 0
    assert canonical_rows(got) == j_canonical_rows(want)


def test_q3_rows_equal_numpy(person_knows):
    jdb, jsnap, db, snap = person_knows
    k = 60
    csr = snap.edge_classes["knows"]
    age = snap.v_columns["age"].values
    want = []
    for p in range(k):
        for f in csr.dst[csr.indptr_out[p] : csr.indptr_out[p + 1]]:
            for g in csr.dst[csr.indptr_out[f] : csr.indptr_out[f + 1]]:
                if age[g] < 30:
                    want.append((p, int(f), int(g)))
    got = [(r["p"], r["f"], r["g"]) for r in db.query(Q3, {"k": k}).to_dicts()]
    assert sorted(got) == sorted(want)


def test_chunked_expansion_equals_single_chunk(person_knows, monkeypatch):
    jdb, jsnap, db, snap = person_knows
    whole = canonical_rows(db.query(Q3, {"k": 200}).to_dicts())
    from orientdb_tpu_torch.utils.config import config

    monkeypatch.setattr(config, "max_expansion_cap", 512)
    assert canonical_rows(db.query(Q3, {"k": 200}).to_dicts()) == whole


def test_ordered_limited_rows(person_knows):
    jdb, jsnap, db, snap = person_knows
    sql = Q_ROWS_1HOP + " ORDER BY p DESC, f SKIP 3 LIMIT 25"
    got = db.query(sql, {"k": 4_000}).to_dicts()
    want = jdb.query(sql, {"k": 4_000}, engine="tpu", strict=True).to_dicts()
    assert got == want


# ---------------------------------------------------------------------------
# demodb, carried across from a reference snapshot
# ---------------------------------------------------------------------------


def _carry_arrays(jdb, jsnap):
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
            n: {
                "kind": c.kind,
                "values": c.values,
                "present": c.present,
                "dictionary": c.dictionary,
            }
            for n, c in jsnap.v_columns.items()
        },
        "v_non_columnar": sorted(jsnap.v_non_columnar),
        "edge_classes": {
            n: {
                k: getattr(c, k)
                for k in ("indptr_out", "dst", "indptr_in", "src", "edge_id_in")
            }
            for n, c in jsnap.edge_classes.items()
        },
    }
    return spec, arrays


@pytest.fixture(scope="module")
def demodb():
    jdb = generate_demodb(n_profiles=300, avg_friends=1, seed=1)
    jsnap = build_snapshot(jdb)
    jdb.attach_snapshot(jsnap)
    db, snap = snapshot_from_arrays(*_carry_arrays(jdb, jsnap), device="cpu")
    return jdb, db, snap


def test_demodb_headline_pair(demodb):
    jdb, db, snap = demodb
    jsnap = jdb.current_snapshot()
    for cls in ("V", "Profiles"):
        assert np.array_equal(snap.class_mask(cls), jsnap.class_mask(cls))
    assert snap.vertex_hull("Profiles") == jsnap.vertex_hull("Profiles")
    # E < vb here, so the weight pass evaluates the node mask per edge
    assert snap.edge_classes["HasFriend"].num_edges < 512 <= 2 * snap.num_vertices
    want = jdb.query(DEMO_COUNT, engine="tpu", strict=True).to_dicts()
    assert db.query(DEMO_COUNT).to_dicts() == want
    assert want[0]["n"] > 0
    got = db.query(DEMO_ROWS).to_dicts()
    want = jdb.query(DEMO_ROWS, engine="tpu", strict=True).to_dicts()
    assert len(want) > 0
    assert canonical_rows(got) == j_canonical_rows(want)


@pytest.mark.parametrize(
    "where",
    [
        "name LIKE 's%'",
        "name >= 'm' AND surname != 'smith'",
        "age IN [20, 30, 41] OR age BETWEEN 50 AND 55",
        "NOT (age < 30) AND surname IS NOT NULL",
        "age * 2 - 10 > 60",
        "age % 7 = 3",
    ],
)
def test_demodb_predicates(demodb, where):
    jdb, db, snap = demodb
    sql = (
        f"MATCH {{class:Profiles, as:p, where:({where})}}-HasFriend->{{as:f}} "
        "RETURN p.uid AS p, f.uid AS f, p.name AS name"
    )
    got = db.query(sql).to_dicts()
    want = jdb.query(sql, engine="tpu", strict=True).to_dicts()
    assert 0 < len(want) < snap.edge_classes["HasFriend"].num_edges
    assert canonical_rows(got) == j_canonical_rows(want)


@pytest.mark.parametrize(
    "sql",
    [
        # both directions, and every edge class
        "MATCH {class:Profiles, as:p, where:(uid < 40)}-HasFriend-{as:f} "
        "RETURN p.uid AS p, f.uid AS f",
        "MATCH {class:Profiles, as:p, where:(uid < 40)}--{as:f} "
        "RETURN p.uid AS p, f.uid AS f",
        # a reversed step (the root is the arrow's target)
        "MATCH {as:f, where:(age < 30)}-HasFriend->{class:Profiles, as:p, where:(uid < 60)} "
        "RETURN p.uid AS p, f.uid AS f",
        # a cartesian product of two roots
        "MATCH {class:Profiles, as:a, where:(uid < 5)}, "
        "{class:Profiles, as:b, where:(uid < 4)} RETURN a.uid AS a, b.uid AS b",
        # a cycle closing on a bound alias
        "MATCH {class:Profiles, as:p, where:(uid < 100)}-HasFriend-{as:f}"
        "-HasFriend-{as:p} RETURN p.uid AS p, f.uid AS f",
        "MATCH {class:Profiles, as:p}-HasFriend-{as:f}-HasFriend-{as:g}-HasFriend-{as:p} "
        "RETURN count(*) AS n",
        # COUNT pushdown over both directions and over reversed steps
        "MATCH {class:Profiles, as:p, where:(age > 40)}-HasFriend-{as:f}"
        "-HasFriend-{as:g} RETURN count(*) AS n",
        "MATCH {as:g, where:(age < 30)}<-HasFriend-{as:f}<-HasFriend-"
        "{class:Profiles, as:p, where:(uid < 100)} RETURN count(*) AS n",
        # the DISTINCT / ORDER BY / SKIP / LIMIT tail
        "MATCH {class:Profiles, as:p, where:(uid < 100)}-HasFriend->{as:f} "
        "RETURN DISTINCT f.age AS a ORDER BY a DESC SKIP 1 LIMIT 7",
    ],
)
def test_demodb_shapes(demodb, sql):
    jdb, db, snap = demodb
    got = db.query(sql).to_dicts()
    want = jdb.query(sql, engine="tpu", strict=True).to_dicts()
    assert len(want) > 0
    if "ORDER BY" in sql:
        assert got == want
    else:
        assert canonical_rows(got) == j_canonical_rows(want)


# ---------------------------------------------------------------------------
# refusals and independence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "sql",
    [
        "MATCH {class:Profiles, as:p}-HasFriend->{as:f, while:($depth < 3)} RETURN count(*) AS n",
        "MATCH {class:Profiles, as:p}-HasFriend->{as:f}, NOT {as:p}-Likes->{as:f} RETURN count(*) AS n",
        "MATCH {class:Profiles, as:p}-HasFriend->{as:f, optional:true} RETURN p.uid AS p",
        "MATCH {class:Profiles, as:p}.outE('HasFriend'){as:e} RETURN count(*) AS n",
        "TRAVERSE out('HasFriend') FROM (SELECT FROM Profiles WHERE uid = 1)",
        "MATCH {class:Profiles, as:p}-HasFriend->{as:f} RETURN p",
    ],
    ids=["while", "not", "optional", "edge_binding", "traverse", "record_return"],
)
def test_shapes_outside_the_slice_raise(demodb, sql):
    jdb, db, snap = demodb
    with pytest.raises(Uncompilable):
        db.query(sql)


def test_database_defaults_to_cuda():
    if torch.cuda.is_available():
        assert Database("x").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Database("x")


def test_device_graph_is_freed_with_its_snapshot():
    import gc
    import weakref

    from orientdb_tpu_torch.ops import device_graph as D

    db, snap = build_person_knows(500, device="cpu")
    assert db.query(Q1).to_dicts()[0]["n"] > 0
    assert snap in D._CACHE
    ref = weakref.ref(snap)
    del db, snap
    gc.collect()
    assert ref() is None


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "orientdb_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "orientdb_tpu"), f"{path}: imports {mod}"
