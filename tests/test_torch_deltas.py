"""Delta maintenance of the port (`orientdb_tpu_torch/storage/deltas.py`)
against the reference package, on the CPU.

Writes go through the reference database; its maintainer's event batches
(`SnapshotMaintainer._apply_batch`) and patch phases
(`DeviceGraph.apply_patches`) are recorded by wrapping them here, and the
same events are applied to the port with `apply_batch`. After every batch
the port's patch phases must equal the reference's (keys, indices and
values, byte for byte), every host array must be equal, and the listed
queries must give the rows of both reference engines. The port's snapshot
is carried across before the reference's arming (a separate build of the
same records, copied) and padded by the port itself; the padded arrays are
held equal too. Then the plain versions of the delta kernels (K16–K18)
against the reference's functions at random shapes."""

import copy
import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientdb_tpu.exec import tpu_engine as J_TE
from orientdb_tpu.models.database import Database as JDatabase
from orientdb_tpu.ops import device_graph as J_DG
from orientdb_tpu.storage import deltas as J_D
from orientdb_tpu.storage.ingest import generate_demodb
from orientdb_tpu.storage.snapshot import build_snapshot
from orientdb_tpu_torch.carry import snapshot_from_arrays
from orientdb_tpu_torch.exec import tpu_engine as TE
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.ops import device_graph as T_DG
from orientdb_tpu_torch.ops.predicates import Uncompilable
from orientdb_tpu_torch.sql.parser import parse
from orientdb_tpu_torch.storage.deltas import arm_delta_maintenance
from tests.test_snapshot_deltas import COUNT_Q, ROWS_Q, VAR_Q

CLASSLESS_Q = "MATCH {as:p, where:(age > 25)}-Knows->{as:q} RETURN p.name AS p, q.name AS q"
EDGE_Q = (
    "MATCH {class:Person, as:p}-Knows{as:k, where:(since > 3)}->{as:q} "
    "RETURN p.name AS p, q.name AS q, k.since AS s"
)
EDGE_VAR_Q = (
    "MATCH {class:Person, as:p, where:(age < 24)}"
    "-Knows{where:(since > 1)}->{as:f, while:($depth < 3)} RETURN count(*) AS n"
)
OPT_Q = (
    "MATCH {class:Person, as:p, where:(age < 28)}-Likes->{as:q, optional:true} "
    "RETURN p.name AS p, q.name AS q"
)
NOT_Q = (
    "MATCH {class:Person, as:p}-Knows->{as:q}, NOT {as:q}-Likes->{} "
    "RETURN p.name AS p, q.name AS q"
)
BATCH_Q = "MATCH {class:Person, as:p, where:(age > :a)}-Knows->{as:q} RETURN p.name AS p, q.name AS q"
BATCH_PARAMS = [{"a": 19 + i} for i in range(5)]
QUERIES = [ROWS_Q, COUNT_Q, VAR_Q, CLASSLESS_Q, EDGE_Q, EDGE_VAR_Q, OPT_Q, NOT_Q]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def canon(rows):
    return sorted(str(sorted(r.items())) for r in rows)


def build_db(n=12):
    """`tests/test_snapshot_deltas.build_db` with a ``since`` column on the
    Knows edges (the edge WHERE cells)."""
    db = JDatabase("deltas")
    vs = [db.new_vertex("Person", name=f"p{i}", age=20 + i) for i in range(n)]
    for i in range(n - 1):
        db.new_edge("Knows", vs[i], vs[i + 1], since=i % 7)
    for i in range(0, n - 2, 3):
        db.new_edge("Likes", vs[i], vs[i + 2])
    return db, vs


def _col(c):
    return {"kind": c.kind, "values": c.values, "present": c.present, "dictionary": c.dictionary}


def _rid_arrays(rids):
    c = np.array([r.cluster if r is not None else -1 for r in rids], np.int32)
    p = np.array([r.position if r is not None else -1 for r in rids], np.int32)
    return c, p


def carry_arrays(jdb, jsnap):
    spec = [
        {"name": c.name, "superclasses": list(c.superclass_names), "abstract": c.abstract}
        for c in jdb.schema.classes()
    ]
    edges = {}
    for n, c in jsnap.edge_classes.items():
        ec, ep = _rid_arrays(c.edge_rids)
        edges[n] = {
            **{k: getattr(c, k) for k in ("indptr_out", "dst", "indptr_in", "src", "edge_id_in")},
            "columns": {cn: _col(col) for cn, col in c.edge_columns.items()},
            "non_columnar": sorted(c.non_columnar),
            "e_cluster": ec,
            "e_position": ep,
        }
    arrays = {
        "num_vertices": jsnap.num_vertices,
        "v_class": jsnap.v_class,
        "v_cluster": jsnap.v_cluster,
        "v_position": jsnap.v_position,
        "class_names": jsnap.class_names,
        "class_id_of": jsnap.class_id_of,
        "class_closure": jsnap.class_closure,
        "class_vertex_range": jsnap.class_vertex_range,
        "edge_closure": jsnap.edge_closure,
        "v_columns": {n: _col(c) for n, c in jsnap.v_columns.items()},
        "v_non_columnar": sorted(jsnap.v_non_columnar),
        "edge_classes": edges,
    }
    return spec, copy.deepcopy(arrays)


class Pair:
    """A reference database armed for deltas and its port twin, with the
    reference's event batches and both packages' patch phases recorded."""

    def __init__(self, monkeypatch, jdb, sv, se):
        self.jdb = jdb
        self.monkeypatch = monkeypatch
        self.ref_batches, self.ref_phases, self.port_phases = [], [], []
        orig_batch = J_D.SnapshotMaintainer._apply_batch
        orig_jp = J_DG.DeviceGraph.apply_patches
        orig_tp = T_DG.DeviceGraph.apply_patches

        def rec_batch(m, events):
            self.ref_batches.append([copy.deepcopy(e) for e in events])
            return orig_batch(m, events)

        def rec_j(dg, patches):
            self.ref_phases.append(_phase(patches))
            return orig_jp(dg, patches)

        def rec_t(dg, patches):
            self.port_phases.append(_phase(patches))
            return orig_tp(dg, patches)

        monkeypatch.setattr(J_D.SnapshotMaintainer, "_apply_batch", rec_batch)
        monkeypatch.setattr(J_DG.DeviceGraph, "apply_patches", rec_j)
        monkeypatch.setattr(T_DG.DeviceGraph, "apply_patches", rec_t)
        # the port carries a separate build of the same records, before the
        # reference arms (its maintainer patches its own arrays in place)
        self.tdb, _snap = snapshot_from_arrays(
            *carry_arrays(jdb, build_snapshot(jdb)), device="cpu"
        )
        self.jm = J_D.arm_delta_maintenance(jdb, spare_vertices=sv, spare_edges=se)
        self.tm = arm_delta_maintenance(self.tdb, sv, se)
        self.check_host()

    @property
    def jsnap(self):
        return self.jdb._snapshot

    @property
    def tsnap(self):
        return self.tdb.current_snapshot()

    def sync(self):
        """Catch the reference up, replay its batches into the port, and
        hold phases and host arrays equal. Returns the port's results."""
        n = len(self.ref_batches)
        self.ref_phases.clear()
        self.port_phases.clear()
        self.jm.catch_up()
        ok = True
        for events in self.ref_batches[n:]:
            ok = self.tm.apply_batch(copy.deepcopy(events)) and ok
        assert len(self.ref_batches) > n, "no batch was applied"
        assert self.port_phases == self.ref_phases
        return ok

    def check_host(self):
        j, t = self.jsnap, self.tsnap
        assert t.num_vertices == j.num_vertices
        for key in ("v_class", "v_cluster", "v_position"):
            _same(getattr(t, key), getattr(j, key), key)
        for name, col in j.v_columns.items():
            _same(t.v_columns[name].values, col.values, name)
            _same(t.v_columns[name].present, col.present, name)
            assert t.v_columns[name].dictionary == col.dictionary
        for cname, jc in j.edge_classes.items():
            tc = t.edge_classes[cname]
            for key in ("indptr_out", "dst", "indptr_in", "src", "edge_id_in", "live"):
                _same(getattr(tc, key), getattr(jc, key), f"{cname}.{key}")
            _same(tc.edge_src, jc.edge_src_np(), f"{cname}.edge_src")
            ec, ep = _rid_arrays(jc.edge_rids)
            _same(tc.e_cluster, ec, f"{cname} edge rids")
            _same(tc.e_position, ep, f"{cname} edge rids")
            for name, col in jc.edge_columns.items():
                _same(tc.edge_columns[name].values, col.values, f"{cname}.{name}")
                _same(tc.edge_columns[name].present, col.present, f"{cname}.{name}")
        jo, to = j._overlay, t._overlay
        assert (to.bk_nb, to.bk_bk, to.next_v_slot, to.dead_vertices) == (
            jo.bk_nb, jo.bk_bk, jo.next_v_slot, jo.dead_vertices
        )
        assert (to.topology_dirty, to.bucket_overflow) == (jo.topology_dirty, jo.bucket_overflow)
        for cname, tabs in jo.bk.items():
            for key, arr in tabs.items():
                _same(to.bk[cname][key], arr, f"bk {cname} {key}")
        assert {tuple(r): i for r, i in t.rid_to_idx.items()} == {
            tuple(r): i for r, i in j.rid_to_idx.items()
        }
        # the port's resident tensors equal its host arrays
        dg = T_DG.cached_device_graph(t)
        if dg is not None:
            _same(dg.v_class.numpy(), t.v_class, "device v_class")
            for cname, dec in dg.edges.items():
                tc = t.edge_classes[cname]
                for key in ("dst", "src", "live"):
                    _same(getattr(dec, key).numpy(), getattr(tc, key), f"device {cname}.{key}")
                _same(dec.edge_src.numpy(), tc.edge_src, f"device {cname}.edge_src")
                for d in ("out", "in"):
                    _same(dg.arrays[f"bk:{cname}:{d}"].numpy(), to.bk[cname][d], f"device bk {d}")

    def check_compacted(self):
        """After a compaction on both sides: the port's fresh snapshot holds
        the reference's rebuilt one's vertex rows, RIDs and class ranges
        exactly, its columns value for value where present (dictionaries may
        differ: the port keeps its own), every live edge with its endpoints,
        RID and columns as a multiset (so each vertex's neighbour lists are
        equal as multisets), and the same fresh overlay geometry."""
        j, t = self.jsnap, self.tsnap
        assert t.num_vertices == j.num_vertices
        for key in ("v_class", "v_cluster", "v_position"):
            _same(getattr(t, key), getattr(j, key), key)
        assert t.class_vertex_range == {k: tuple(v) for k, v in j.class_vertex_range.items()}
        live = np.flatnonzero(j.v_class >= 0)
        for name, col in j.v_columns.items():
            _same_objects(t.v_columns[name], col, live, name)
        for cname, jc in j.edge_classes.items():
            tc = t.edge_classes[cname]
            assert _edge_multiset(tc, tc.edge_src, tc.e_cluster, tc.e_position) == _edge_multiset(
                jc, jc.edge_src_np(), *_rid_arrays(jc.edge_rids)
            ), cname
        jo, to = j._overlay, t._overlay
        assert (to.base_vertices, to.cap_vertices, to.next_v_slot, to.dead_vertices, to.bk_nb) == (
            jo.base_vertices, jo.cap_vertices, jo.next_v_slot, jo.dead_vertices, jo.bk_nb
        )
        assert {c: (s.base, s.cap, s.next_slot) for c, s in to.edge_slabs.items()} == {
            c: (s.base, s.cap, s.next_slot) for c, s in jo.edge_slabs.items()
        }
        assert to.poisoned is None and not to.topology_dirty and not to.bucket_overflow
        assert {tuple(r): i for r, i in t.rid_to_idx.items()} == {
            tuple(r): i for r, i in j.rid_to_idx.items()
        }

    def check_queries(self, queries=QUERIES):
        for q in queries:
            o = canon(self.jdb.query(q, engine="oracle").to_dicts())
            j = canon(self.jdb.query(q, engine="tpu", strict=True).to_dicts())
            for _ in range(2):  # a recording, then a replay of its plan
                t = canon(self.tdb.query(q).to_dicts())
                assert t == o == j, q
        for _ in range(2):  # the first batch records, the second groups
            got = self.tdb.query_batch([BATCH_Q] * len(BATCH_PARAMS), BATCH_PARAMS)
            for p, rs in zip(BATCH_PARAMS, got):
                assert canon(rs.to_dicts()) == canon(self.jdb.query(BATCH_Q, p, engine="oracle").to_dicts())


def _phase(patches):
    out = {}
    for key, (idx, vals) in patches.items():
        v = np.asarray(vals)
        out[key] = (np.asarray(idx, np.int32).tobytes(), v.dtype.str, v.tobytes())
    return out


def _same_objects(tcol, jcol, idx, what):
    """Two columns' values at ``idx`` as Python objects (None where absent)."""
    assert tcol.kind == jcol.kind, what
    pres = np.asarray(jcol.present, bool)[idx]
    _same(tcol.present[idx], pres, f"{what} presence")
    got = tcol.objects_at(np.asarray(idx, np.int64))
    d = jcol.dict_array() if jcol.kind == "str" else None
    for g, i, p in zip(got, idx, pres):
        want = jcol.values[i] if d is None else d[jcol.values[i]]
        assert not p or g == (bool(want) if jcol.kind == "bool" else want), what


def _edge_multiset(csr, edge_src, e_cluster, e_position):
    """The live edges of one class as a sorted list of (source, target,
    RID, column values): each vertex's out- and in-neighbour lists as
    multisets."""
    slots = np.flatnonzero(np.asarray(csr.live, bool))
    cols = sorted(csr.edge_columns)
    vals = {
        n: csr.edge_columns[n].objects_at(slots.astype(np.int64))
        if hasattr(csr.edge_columns[n], "objects_at")
        else [csr.edge_columns[n].decode(csr.edge_columns[n].values[k], csr.edge_columns[n].present[k])
              for k in slots]
        for n in cols
    }
    return sorted(
        (int(edge_src[k]), int(csr.dst[k]), int(e_cluster[k]), int(e_position[k]),
         *(repr(vals[n][i]) for n in cols))
        for i, k in enumerate(slots)
    )


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def _plan(tsnap, sql):
    (variants,) = [v for k, v in TE._plan_cache(tsnap).items() if k[0] == parse(sql)]
    return variants


@pytest.fixture
def pair(monkeypatch):
    jdb, vs = build_db()
    p = Pair(monkeypatch, jdb, sv=64, se=64)
    p.vs = vs
    p.check_queries()
    return p


def test_insert_update_delete(pair):
    vs, jdb = pair.vs, pair.jdb
    w = jdb.new_vertex("Person", name="w", age=30)
    jdb.new_edge("Knows", vs[3], w, since=5)
    jdb.new_edge("Likes", w, vs[0])
    assert pair.sync()
    pair.check_host()
    assert pair.tsnap._overlay.topology_dirty
    pair.check_queries()
    vs[2].set("age", 99)
    jdb.save(vs[2])
    vs[8].set("age", 5)
    jdb.save(vs[8])
    assert pair.sync()
    pair.check_host()
    pair.check_queries()
    jdb.delete(vs[5])  # cascades to its Knows and Likes edges
    jdb.delete(w)  # a slab vertex with slab edges
    assert pair.sync()
    pair.check_host()
    assert pair.tsnap._overlay.dead_vertices == 2
    pair.check_queries()


HOP_QUERIES = [
    "MATCH {class:Person, as:p, where:(age < 23)}-Knows-{as:f, while:($depth < 4)} "
    "RETURN p.name AS p, f.name AS f",
    "MATCH {class:Person, as:p, where:(age > 27)}<-Knows-{as:f, maxDepth:3, depthAlias:d} "
    "RETURN p.name AS p, f.name AS f, d AS d",
    "MATCH {class:Person, as:p, where:(age < 25)}-Knows->{as:f, while:($depth < 5)} RETURN count(*) AS n",
]
TRAV_QUERIES = [
    "TRAVERSE out('Knows') FROM (SELECT FROM Person WHERE age < 23) WHILE $depth < 4 STRATEGY BREADTH_FIRST",
    "TRAVERSE both('Knows') FROM (SELECT FROM Person WHERE age > 29) WHILE $depth < 3 STRATEGY BREADTH_FIRST",
]


def _records(rows):
    return [{k: v for k, v in r.items() if k != "@version"} for r in rows]


def _check_hops(pair):
    """The bitmap-hop queries: variable-depth MATCH rows and counts (out,
    in and both) equal to both reference engines, TRAVERSE rows in order
    to the reference's ``engine="tpu"``. Returns the port's answers."""
    got = []
    for q in HOP_QUERIES:
        o = canon(pair.jdb.query(q, engine="oracle").to_dicts())
        j = canon(pair.jdb.query(q, engine="tpu", strict=True).to_dicts())
        for _ in range(2):  # a recording, then a replay of its plan
            t = canon(pair.tdb.query(q).to_dicts())
            assert t == o == j, q
        got.append(t)
    for q in TRAV_QUERIES:
        o = _records(pair.jdb.query(q, engine="oracle").to_dicts())
        j = _records(pair.jdb.query(q, engine="tpu", strict=True).to_dicts())
        for _ in range(2):
            t = _records(pair.tdb.query(q).to_dicts())
            # a level's records ascend by vertex on both engines "tpu"; the
            # oracle keeps discovery order within a level
            assert t == j and canon(t) == canon(o), q
        got.append(t)
    return got


def test_bitmap_hops_read_the_slab(pair):
    """Variable-depth MATCH and TRAVERSE over a delta-armed snapshot: after
    appended edges (slab slots, which no CSR row holds: each hop also walks
    the slab), tombstones of base and slab edges, and a vertex delete. The
    appended edges open paths the base CSR lacks, so a hop that missed the
    slab would give other answers."""
    vs, jdb = pair.vs, pair.jdb
    before = _check_hops(pair)
    w = jdb.new_vertex("Person", name="w", age=21)
    jdb.new_edge("Knows", vs[11], w, since=2)
    jdb.new_edge("Knows", w, vs[0], since=4)
    slab_edge = jdb.new_edge("Knows", vs[9], vs[1], since=6)
    jdb.new_edge("Knows", vs[2], vs[10], since=1)
    assert pair.sync()
    pair.check_host()
    assert pair.tsnap._overlay.topology_dirty
    appended = _check_hops(pair)
    assert appended != before
    jdb.delete(slab_edge)  # a slab tombstone
    jdb.delete(vs[6])  # a vertex delete: its base Knows edges become tombstones
    assert pair.sync()
    pair.check_host()
    assert pair.tsnap.edge_classes["Knows"].live.sum() < len(pair.tsnap.edge_classes["Knows"].live)
    assert _check_hops(pair) != appended


def test_create_then_delete_in_one_batch(pair):
    vs, jdb = pair.vs, pair.jdb
    x = jdb.new_vertex("Person", name="x", age=40)
    e = jdb.new_edge("Knows", vs[1], x, since=6)
    jdb.new_edge("Knows", x, vs[4], since=6)
    jdb.delete(e)
    jdb.delete(x)
    assert pair.sync()
    pair.check_host()
    assert not pair.tsnap.edge_classes["Knows"].live[pair.tsnap._overlay.edge_slabs["Knows"].base :].any()
    pair.check_queries()


def test_dictionary_append(pair):
    jdb, tdb = pair.jdb, pair.tdb
    gen = pair.tsnap._overlay.plan_gen
    jdb.new_vertex("Person", name="zzz", age=33)
    assert pair.sync()
    pair.check_host()
    ov = pair.tsnap._overlay
    assert ov.plan_gen > gen and pair.tsnap.v_columns["name"].dict_unsorted
    eq = "MATCH {class:Person, as:p, where:(name = 'zzz')} RETURN p.age AS a"
    assert tdb.query(eq).to_dicts() == [{"a": 33}]
    assert canon(tdb.query(eq).to_dicts()) == canon(jdb.query(eq, engine="oracle").to_dicts())
    with pytest.raises(Uncompilable, match="delta-appended"):
        tdb.query("MATCH {class:Person, as:p, where:(name < 'bbb')} RETURN p.age AS a")
    pair.check_queries()


def test_bucket_overflow_switches_to_the_scan(pair, monkeypatch):
    jdb, vs = pair.jdb, pair.vs
    calls = {"slab_scan": 0, "slab_probe": 0}
    for name in calls:
        def counted(*a, _f=getattr(K, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)

        monkeypatch.setattr(K, name, counted)
    ov = pair.tsnap._overlay
    # nine edges out of one vertex fill its out bucket (BK = 8)
    for i in range(9):
        jdb.new_edge("Knows", vs[0], vs[(i % 11) + 1], since=i)
    gen = ov.plan_gen
    assert pair.sync()
    pair.check_host()
    assert ov.bucket_overflow == {"Knows"} and ov.plan_gen > gen
    pair.check_queries()
    # Knows scans its window now; Likes keeps probing its buckets
    assert calls["slab_scan"] > 0 and calls["slab_probe"] > 0
    variants = _plan(pair.tsnap, ROWS_Q)
    assert len(variants.plans) == 1 and variants.plans[0].solver.delta_gen == ov.plan_gen


def _answers_like_reference(pair, queries):
    for q in queries:
        o = canon(pair.jdb.query(q, engine="oracle").to_dicts())
        j = canon(pair.jdb.query(q, engine="tpu", strict=True).to_dicts())
        for _ in range(2):  # a recording on the fresh snapshot, then a replay
            assert canon(pair.tdb.query(q).to_dicts()) == o == j, q


def test_full_slab_poisons(monkeypatch):
    """A full edge slab poisons the overlay mid-batch. The reference then
    compacts (rebuilds from its records); the port folds its host arrays
    into a clean snapshot, applies the rest of the batch and folds again,
    and answers like the reference. A plan recorded on the old snapshot
    re-records on the new one."""
    jdb, vs = build_db()
    pair = Pair(monkeypatch, jdb, sv=4, se=3)
    pair.check_queries()
    old = pair.tsnap
    for i in range(4):
        jdb.new_edge("Knows", vs[i], vs[i + 4], since=1)
    assert pair.sync()
    assert "edge slab full" in old._overlay.poisoned
    assert pair.jm.compactions == 1 and pair.tm.compactions >= 1
    assert "edge slab full" in pair.tm.last_compact_reason
    assert pair.tsnap is not old and T_DG.cached_device_graph(old) is None
    stats = pair.tm.stats()
    assert stats["compactions"] == pair.tm.compactions and stats["dead_fraction"] == 0.0
    pair.check_compacted()
    _answers_like_reference(pair, [COUNT_Q, ROWS_Q])
    pair.check_queries()
    # the fresh overlay takes the next writes in place
    jdb.new_edge("Knows", vs[9], vs[2], since=4)
    assert pair.sync()
    pair.check_host()
    pair.check_queries()


def test_poisoned_overlay_raises_until_compacted(monkeypatch):
    """A caller that patches around `apply_batch` and poisons the overlay
    gets `Uncompilable` from every compiled query until it compacts."""
    jdb, _vs = build_db()
    pair = Pair(monkeypatch, jdb, sv=8, se=8)
    pair.check_queries()
    pair.tsnap._overlay.poison("edge slab full for 'Knows'")
    for q in (COUNT_Q, ROWS_Q):
        with pytest.raises(Uncompilable, match="edge slab full"):
            pair.tdb.query(q)
    pair.tm.compact("poisoned: edge slab full for 'Knows'")
    assert pair.tsnap._overlay.poisoned is None
    _answers_like_reference(pair, [COUNT_Q, ROWS_Q])


def test_edge_to_deleted_vertex_compacts(monkeypatch):
    """The case that showed the gap: on demodb(100, 3, seed=3) armed with
    16 spare vertices, a profile is deleted and then a HasFriend edge is
    written to it. Both sides poison ("endpoint not in snapshot"), compact
    to one row fewer, drop the dangling edge, and answer alike."""
    jdb = generate_demodb(n_profiles=100, avg_friends=3, seed=3)
    pair = Pair(monkeypatch, jdb, sv=16, se=64)
    one_hop = "MATCH {class:Profiles, as:p}-HasFriend->{as:f} RETURN count(*) AS n"
    rows = "MATCH {class:Profiles, as:p, where:(age > 50)}-HasFriend->{as:f} RETURN p.uid AS p, f.uid AS f"
    _answers_like_reference(pair, [one_hop, rows])
    rows_before = pair.tsnap._overlay.base_vertices
    profs = list(jdb.browse_class("Profiles"))
    victim = profs[7]
    jdb.delete(victim)
    jdb.new_edge("HasFriend", profs[3], victim)
    assert pair.sync()
    assert pair.jm.compactions == 1 and pair.tm.compactions == 1
    assert "endpoint not in snapshot" in pair.tm.last_compact_reason
    assert pair.tsnap._overlay.base_vertices == rows_before - 1 == pair.jsnap._overlay.base_vertices
    pair.check_compacted()
    _answers_like_reference(pair, [one_hop, rows])


def test_dead_fraction_compacts(monkeypatch):
    """Tombstones past ``delta_compact_ratio`` of a class's used slots
    compact both sides; the maintainer's stats say why."""
    jdb, _vs = build_db()
    pair = Pair(monkeypatch, jdb, sv=64, se=64)
    pair.check_queries()
    knows = list(jdb.browse_class("Knows"))
    for e in knows[:9]:  # 9 of 11: a dead fraction of 0.82
        jdb.delete(e)
    assert pair.sync()
    assert pair.jm.compactions == 1 and pair.tm.compactions == 1
    assert pair.tm.last_compact_reason == pair.jm.last_compact_reason
    assert pair.tm.stats()["dead_fraction"] == 0.0
    pair.check_compacted()
    pair.check_queries()


def test_overflowed_class_clears_on_compaction(monkeypatch):
    """Nine edges out of one vertex overflow its Knows bucket, and fill the
    slab to the compaction ratio: after the compaction the class has no
    overflow, its dirty hops probe buckets again (no edge-list hop), and
    every answer equals the reference's."""
    jdb, vs = build_db()
    pair = Pair(monkeypatch, jdb, sv=64, se=12)
    pair.check_queries()
    for i in range(9):
        jdb.new_edge("Knows", vs[0], vs[(i % 11) + 1], since=i)
    old = pair.tsnap._overlay
    assert pair.sync()
    assert old.bucket_overflow == {"Knows"}
    assert pair.jm.compactions == 1 and pair.tm.compactions == 1
    pair.check_compacted()
    pair.check_queries()
    jdb.new_edge("Knows", vs[0], vs[5], since=2)  # a dirty hop again
    assert pair.sync()
    pair.check_host()
    calls = {"bitmap_hop": 0, "bitmap_hop_probe": 0}
    orig_hop, orig_csr = K.bitmap_hop, K.bitmap_hop_csr

    def hop(*a, **kw):
        calls["bitmap_hop"] += 1
        return orig_hop(*a, **kw)

    def csr(*a, **kw):
        bound = inspect.signature(orig_csr).bind(*a, **kw)
        calls["bitmap_hop_probe"] += bound.arguments.get("probe") is not None
        return orig_csr(*a, **kw)

    pair.monkeypatch.setattr(K, "bitmap_hop", hop)
    pair.monkeypatch.setattr(K, "bitmap_hop_csr", csr)
    assert not pair.tsnap._overlay.bucket_overflow
    _answers_like_reference(pair, [VAR_Q])
    assert calls["bitmap_hop_probe"] > 0 and calls["bitmap_hop"] == 0


def test_data_only_batch_replays_the_cached_plan(pair):
    jdb, vs, tdb = pair.jdb, pair.vs, pair.tdb
    variants = _plan(pair.tsnap, ROWS_Q)
    (plan,) = variants.plans
    gen, replays = pair.tsnap._overlay.plan_gen, plan.replays
    for i in (1, 4, 7):
        vs[i].set("age", 60 + i)
        jdb.save(vs[i])
    assert pair.sync()
    pair.check_host()
    assert pair.tsnap._overlay.plan_gen == gen
    t = canon(tdb.query(ROWS_Q).to_dicts())
    assert t == canon(jdb.query(ROWS_Q, engine="oracle").to_dicts())
    assert _plan(pair.tsnap, ROWS_Q) is variants and variants.plans == [plan]
    assert plan.replays == replays + 1


def test_demodb_writes(monkeypatch):
    jdb = generate_demodb(n_profiles=300, avg_friends=1, seed=1)
    pair = Pair(monkeypatch, jdb, sv=128, se=256)
    count = (
        "MATCH {class:Profiles, as:p, where:(age > 40)}-HasFriend->{as:f}"
        "-HasFriend->{as:g, where:(age < 30)} RETURN count(*) AS n"
    )
    rows = (
        "MATCH {class:Profiles, as:p, where:(age > 40)}-HasFriend->{as:f, where:(age < 30)} "
        "RETURN p.uid AS p, f.uid AS f"
    )
    var = (
        "MATCH {class:Profiles, as:p, where:(age > 70)}"
        "-HasFriend->{as:f, while:($depth < 3)} RETURN count(*) AS n"
    )
    qs = [count, rows, var]
    for q in qs:
        want = canon(jdb.query(q, engine="oracle").to_dicts())
        assert canon(jdb.query(q, engine="tpu", strict=True).to_dicts()) == want
        assert canon(pair.tdb.query(q).to_dicts()) == want
    profs = list(jdb.browse_class("Profiles"))
    rng = np.random.default_rng(7)
    for i in range(20):
        v = jdb.new_vertex("Profiles", uid=10_000 + i, age=int(rng.integers(18, 80)), name=f"new{i}")
        for j in rng.integers(0, len(profs), 3):
            jdb.new_edge("HasFriend", v, profs[int(j)])
            jdb.new_edge("HasFriend", profs[int(j)], v)
    for v in profs[:10]:
        v.set("age", 45)
        jdb.save(v)
    for v in profs[10:14]:
        jdb.delete(v)
    assert pair.sync()
    pair.check_host()
    for q in qs:
        want = canon(jdb.query(q, engine="oracle").to_dicts())
        assert canon(jdb.query(q, engine="tpu", strict=True).to_dicts()) == want
        for _ in range(2):
            assert canon(pair.tdb.query(q).to_dicts()) == want, q


@pytest.mark.parametrize("shape", ["person_knows", "snb"])
def test_bigshape_rids_equal_reference(shape):
    """The array builders set each vertex's RID as the reference's do, and
    the port's lookup maps it back to the vertex."""
    from orientdb_tpu.storage import bigshape as J_B
    from orientdb_tpu_torch.storage import bigshape as T_B

    build = "build_person_knows" if shape == "person_knows" else "build_snb_shape"
    _jdb, jsnap = getattr(J_B, build)(500, seed=4)
    _tdb, tsnap = getattr(T_B, build)(500, seed=4, device="cpu")
    _same(tsnap.v_cluster, jsnap.v_cluster, "v_cluster")
    _same(tsnap.v_position, jsnap.v_position, "v_position")
    got = dict(tsnap.rid_to_idx.items())
    assert len(got) == tsnap.num_vertices
    assert all(got[(int(c), int(p))] == i for i, (c, p) in enumerate(zip(jsnap.v_cluster, jsnap.v_position)))


# ---------------------------------------------------------------------------
# K16–K18: the plain versions against the reference's functions
# ---------------------------------------------------------------------------


class _Sched:
    def observe(self, v, free=False, min_capacity=0):
        return int(v)


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.bool_])
@pytest.mark.parametrize("n,s", [(1, 1), (64, 9), (5000, 1024)])
def test_plain_scatter_set_equals_at_set(dtype, n, s):
    rng = np.random.default_rng(n + s)
    arr = (rng.random(n) * 100).astype(dtype)
    idx = rng.permutation(n)[: min(s, n)].astype(np.int32)
    vals = (rng.random(idx.shape[0]) * 100).astype(dtype)
    # the reference's pow2 padding repeats the last pair
    cap = 1 << max(0, int(idx.shape[0] - 1).bit_length())
    idx = np.concatenate([idx, np.full(cap - idx.shape[0], idx[-1], np.int32)])
    vals = np.concatenate([vals, np.full(cap - vals.shape[0], vals[-1], dtype)])
    want = np.asarray(jnp.asarray(arr).at[jnp.asarray(idx)].set(jnp.asarray(vals)))
    got = torch.from_numpy(arr.copy())
    K.scatter_set(got, torch.from_numpy(idx), torch.from_numpy(vals))
    _same(got.numpy(), want, "scatter_set")


def _slab(rng, v, base, used, cap, nb, bk, dead_frac):
    """A padded edge list whose slab holds ``used`` edges with bucket
    tables as `bucket_add` builds them (overflowing buckets stop taking
    entries), a fraction of them tombstoned."""
    src = np.full(cap, -1, np.int32)
    dst = np.full(cap, -1, np.int32)
    live = np.zeros(cap, bool)
    src[:base] = rng.integers(0, v, base)
    dst[:base] = rng.integers(0, v, base)
    live[:base] = True
    src[base : base + used] = rng.integers(0, v, used)
    dst[base : base + used] = rng.integers(0, v, used)
    live[base : base + used] = rng.random(used) >= dead_frac
    tabs = {d: np.full(nb * bk, -1, np.int32) for d in ("out", "in")}
    for d, key in (("out", src), ("in", dst)):
        fill = np.zeros(nb, np.int32)
        for rel in range(used):
            b = int(key[base + rel]) & (nb - 1)
            if fill[b] < bk:
                tabs[d][b * bk + fill[b]] = rel
                fill[b] += 1
    return src, dst, live, tabs


def _stub(src, dst, live, tabs, base, nb, bk, floor, bucketed):
    arrays = {
        "e:K:edge_src": jnp.asarray(src),
        "e:K:dst": jnp.asarray(dst),
        "e:K:live": jnp.asarray(live),
        "bk:K:out": jnp.asarray(tabs["out"]),
        "bk:K:in": jnp.asarray(tabs["in"]),
    }
    ov = types.SimpleNamespace(
        edge_base=lambda c: base, bk={"K": tabs} if bucketed else {}, bucket_overflow=set(),
        bk_nb=nb, bk_bk=bk,
    )
    solver = types.SimpleNamespace(
        overlay=ov, dg=types.SimpleNamespace(arrays=arrays), sched=_Sched(), _slab_floor=floor
    )
    dec = types.SimpleNamespace(class_name="K", num_edges=src.shape[0])
    return solver, dec


@pytest.mark.parametrize("d", ["out", "in"])
@pytest.mark.parametrize("v,base,used,r,seed", [(50, 100, 40, 16, 1), (300, 500, 700, 64, 2), (20, 10, 1, 8, 3)])
def test_plain_slab_kernels_equal_reference(d, v, base, used, r, seed):
    rng = np.random.default_rng(seed)
    nb, bk, floor = 256, 8, 8
    cap = base + 1024
    src, dst, live, tabs = _slab(rng, v, base, used, cap, nb, bk, dead_frac=0.2)
    srcs = rng.integers(0, v, r).astype(np.int32)
    srcs[::5] = -1  # padding rows
    own, nbr = (src, dst) if d == "out" else (dst, src)
    t = {k: torch.from_numpy(a) for k, a in (("own", own), ("nbr", nbr), ("live", live), ("srcs", srcs))}

    def size_for(total):
        return max(TE._cap_of(max(int(total), 1)), floor)

    # K18 against _expand_slab_bucketed
    solver, dec = _stub(src, dst, live, tabs, base, nb, bk, floor, True)
    want = J_TE.TpuMatchSolver._expand_slab_bucketed(solver, dec, d, jnp.asarray(srcs), base)
    got = K.slab_probe(
        torch.from_numpy(tabs[d]), t["own"], t["nbr"], t["live"], t["srcs"], base, nb, bk, size_for
    )
    for g, w in zip(got[:3], want[:3]):
        _same(g.numpy(), np.asarray(w), "slab_probe")
    assert int(got[3]) == want[3]
    # K17 against _expand_slab (the window scan)
    solver, dec = _stub(src, dst, live, tabs, base, nb, bk, floor, False)
    want = J_TE.TpuMatchSolver._expand_slab(solver, dec, d, jnp.asarray(srcs))
    W = min(cap - base, max(TE._cap_of(max(int((src[base:] >= 0).sum()), 1)), floor))
    w = slice(base, base + W)
    got = K.slab_scan(
        t["own"][w].contiguous(), t["nbr"][w].contiguous(), t["live"][w].contiguous(), t["srcs"],
        base, size_for,
    )
    for g, ww in zip(got[:3], want[:3]):
        _same(g.numpy(), np.asarray(ww), "slab_scan")
    assert int(got[3]) == want[3]


@pytest.mark.parametrize("d", ["out", "in"])
@pytest.mark.parametrize("kind", ["hot", "repeated", "hot_repeated"])
def test_plain_slab_scan_equals_reference_under_skew(d, kind):
    """K17's window scan against the reference's `_expand_slab` on skewed
    windows: one source owning most of the slab (the overflowed person whose
    overflow is why the class scans at all), one source on many rows, and
    both at once; a capacity below the total cuts in row-major order."""
    rng = np.random.default_rng(len(kind))
    v, base, used, r = 400, 300, 3_000, 96
    nb, bk, floor = 256, 8, 8
    cap = base + 4_096
    src, dst, live, tabs = _slab(rng, v, base, used, cap, nb, bk, dead_frac=0.2)
    own = src if d == "out" else dst
    hot = 7
    if kind != "repeated":
        idx = base + rng.choice(used, 2_000, replace=False)
        own[idx] = hot
        live[idx[::2]] = True
    srcs = rng.integers(0, v, r).astype(np.int32)
    srcs[::5] = -1
    srcs[[1, r // 2]] = hot
    if kind != "hot":
        srcs[rng.random(r) < 0.5] = hot
    nbr = dst if d == "out" else src
    solver, dec = _stub(src, dst, live, tabs, base, nb, bk, floor, False)
    want = J_TE.TpuMatchSolver._expand_slab(solver, dec, d, jnp.asarray(srcs))
    W = min(cap - base, max(TE._cap_of(max(int((src[base:] >= 0).sum()), 1)), floor))
    win = [torch.from_numpy(x[base : base + W].copy()) for x in (own, nbr, live)]
    total = int(want[3])
    assert total > (100 if kind == "repeated" else 2_000)
    got = K.slab_scan(*win, torch.from_numpy(srcs), base, lambda t: max(TE._cap_of(max(int(t), 1)), floor))
    for g, ww in zip(got[:3], want[:3]):
        _same(g.numpy(), np.asarray(ww), "slab_scan")
    assert int(got[3]) == total
    cut = K.slab_scan(*win, torch.from_numpy(srcs), base, lambda t: total // 3)
    for g, ww in zip(cut[:3], want[:3]):
        _same(g.numpy(), np.asarray(ww)[: total // 3], "slab_scan cut")
