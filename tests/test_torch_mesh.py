"""The port's mesh (`orientdb_tpu_torch/parallel/`) against the reference's
(`orientdb_tpu/parallel/mesh_graph.py`, `orientdb_tpu/parallel/sharded.py`),
on the CPU.

The reference's mesh runs on the 8 virtual CPU devices that
`tests/conftest.py` provisions. Its shard_map kernels fail to trace under the
installed JAX's ``check_vma`` typing (a ``lax.cond`` whose branches differ
in varying manual axes), not with a wrong result; the ``ref_mesh`` fixture
therefore wraps ``shard_map`` with ``check_vma=False`` in the reference's
two mesh modules only, through ``monkeypatch``, and deletes on teardown the
kernels it built from their caches, so that no reference test later in the
same process reuses one built without the check.

The file holds (a) the port's sharded layout equal to the reference's byte
for byte, (b) the five mesh functions equal to the reference's on the same
sharded inputs (ints and bools exactly, expand_gather's order and padding
included; the float32 weight twin to rtol 1e-6), (c) MATCH statements on
2-, 4- and 8-shard meshes, recorded and replayed, equal to the reference's
single-device engine and oracle (the config-5 COUNT to numpy), (d) the
row-sharded BFS equal to a host BFS and the reference's, and (e) the
refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientdb_tpu.exec.result import canonical_rows as j_canonical_rows
from orientdb_tpu.ops.device_graph import device_graph as j_device_graph
from orientdb_tpu.parallel import mesh_graph as JMG
from orientdb_tpu.parallel import sharded as JSH
from orientdb_tpu.storage.bigshape import build_snb_shape as j_build_snb_shape
from orientdb_tpu.storage.ingest import generate_demodb
from orientdb_tpu.storage.snapshot import attach_fresh_snapshot
from orientdb_tpu_torch.carry import snapshot_from_arrays
from orientdb_tpu_torch.exec import tpu_engine as TE
from orientdb_tpu_torch.exec.result import canonical_rows
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.ops.device_graph import device_graph
from orientdb_tpu_torch.parallel import mesh_graph as MG
from orientdb_tpu_torch.parallel.sharded import ShardedCSR, bfs_reachability, make_mesh
from orientdb_tpu_torch.sql.parser import parse
from orientdb_tpu_torch.storage.bigshape import build_snb_shape, numpy_config5_count
from orientdb_tpu_torch.storage.deltas import arm_delta_maintenance
from orientdb_tpu_torch.utils.config import config
from test_sharded import host_bfs
from test_torch_match import _carry_arrays

SHARDS = [2, 4, 8]

#: tests/test_sharded_match.py's statements (every one compiles in the
#: port), then tests/test_sharded.py's sweep rows (its sweep COUNT is the
#: third statement)
STATEMENTS = [
    "MATCH {class:Profiles, as:p}-HasFriend->{as:f} RETURN p.uid AS p, f.uid AS f",
    "MATCH {class:Profiles, as:p, where:(age > 40)}-HasFriend->"
    "{as:f, where:(age < 30)} RETURN p.uid AS p, f.uid AS f",
    "MATCH {class:Profiles, as:p, where:(age > 40)}-HasFriend->{as:f}"
    "-HasFriend->{as:g, where:(age < 30)} RETURN count(*) AS n",
    "MATCH {class:Profiles, as:p, where:(uid < 40)}<-HasFriend-{as:f} "
    "RETURN p.uid AS p, f.uid AS f",
    "MATCH {class:Profiles, as:p, where:(uid < 15)}-HasFriend-{as:f} "
    "RETURN p.uid AS p, f.uid AS f",
    "MATCH {class:Profiles, as:p, where:(uid < 10)}-HasFriend->"
    "{as:f, while:($depth < 3)} RETURN p.uid AS p, f.uid AS f",
    "MATCH {class:Profiles, as:p}-{class:Likes, where:(weight > 3)}->{as:t} "
    "RETURN p.uid AS p, t.uid AS t",
    "MATCH {class:Profiles, as:p, where:(uid < 12)}-Likes->"
    "{as:t, optional:true} RETURN p.uid AS p, t.uid AS t",
    "MATCH {class:Profiles, as:p, where:(uid < 30)}.outE('Likes')"
    "{as:e, where:(weight > 2)} RETURN p.uid AS p, e.weight AS w",
    "MATCH {class:Profiles, as:p, where:(uid < 30)}.outE('Likes'){as:e}"
    ".inV(){as:t} RETURN p.uid AS p, t.uid AS t, e.weight AS w",
    "MATCH {class:Profiles, as:p, where:(uid < 12)}.bothE('HasFriend')"
    "{as:e}.bothV(){as:t} RETURN p.uid AS p, t.uid AS t",
    "MATCH {class:Profiles, as:p, where:(uid < 40)}-HasFriend->{as:f} "
    "RETURN p.uid AS p, f.uid AS f",
]
CONFIG5 = (
    "MATCH {class:Person, as:p, where:(age > 40)}"
    ".outE('knows'){where:(creationDate > :d)}"
    ".inV(){as:f, where:(age < 30)}, "
    "{class:Message, as:m}-hasCreator->{as:f} "
    "RETURN count(*) AS n"
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ref_mesh(monkeypatch):
    """The reference's mesh kernels with ``shard_map(check_vma=False)``;
    the kernels built meanwhile leave the caches on teardown."""
    orig = JMG.shard_map

    def no_vma(f, **kw):
        kw["check_vma"] = False
        return orig(f, **kw)

    kernels, steps = set(JMG._MESH_KERNEL_CACHE), set(JSH._BFS_STEP_CACHE)
    monkeypatch.setattr(JMG, "shard_map", no_vma)
    monkeypatch.setattr(JSH, "shard_map", no_vma)
    yield
    for k in set(JMG._MESH_KERNEL_CACHE) - kernels:
        del JMG._MESH_KERNEL_CACHE[k]
    for k in set(JSH._BFS_STEP_CACHE) - steps:
        del JSH._BFS_STEP_CACHE[k]


def _jmesh(n_devices: int, replicas: int = 1):
    """The reference's mesh over ``n_devices`` of conftest's 8 virtual CPU
    devices. The CPU backend starts first: the reference's
    `provision_devices` would otherwise set the device count to the first
    mesh's size for the rest of the process."""
    import jax

    jax.devices()
    return JSH.make_mesh(n_devices, replicas=replicas)


_MESHED = {}


def _meshed(S: int, n_profiles: int = 300):
    """The reference's demodb (300 profiles, 4 friends, seed 3) attached
    with an S-shard mesh and its device graph, and the port's carried twin
    attached with an S-shard CPU mesh and its device graph."""
    key = (S, n_profiles)
    if key not in _MESHED:
        jdb = generate_demodb(n_profiles=n_profiles, avg_friends=4, seed=3)
        jsnap = attach_fresh_snapshot(jdb, mesh=_jmesh(S))
        jdg = j_device_graph(jsnap)
        db, snap = snapshot_from_arrays(*_carry_arrays(jdb, jsnap), device="cpu")
        mesh = make_mesh(S, device="cpu")
        db.attach_snapshot(snap, mesh=mesh)
        _MESHED[key] = (jsnap, jdg, snap, device_graph(snap, db.device), mesh)
    return _MESHED[key]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# -- (a) the layout ------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_mesh_layout_equals_reference(S):
    jsnap, jdg, snap, dg, _mesh = _meshed(S)
    want = sorted(k for k in jdg._arrays if k.startswith("sh:"))
    assert want == sorted(k for k in dg.arrays if k.startswith("sh:"))
    assert len(want) == 1 + 10 * len(jsnap.edge_classes)
    for key in want:
        a, b = np.asarray(jdg._arrays[key]), dg.arrays[key].numpy()
        assert (a.dtype, a.shape) == (b.dtype, b.shape), key
        assert a.tobytes() == b.tobytes(), key
    # no flat adjacency beside the sharded one
    assert not any(k.startswith("e:") and ":c:" not in k for k in dg.arrays)
    assert dg.mesh_graph.rows_per_shard == -(-snap.num_vertices // S)
    for name, sea in dg.mesh_graph.edge.items():
        ref = jdg.mesh_graph.edge[name]
        assert (sea.e_slice, sea.out_emax, sea.in_emax) == (ref.e_slice, ref.out_emax, ref.in_emax)


# -- (b) the five functions ----------------------------------------------------


def _pair(S, key, n_profiles: int = 300):
    _jsnap, jdg, _snap, dg, _mesh = _meshed(S, n_profiles)
    return jdg._arrays[key], dg.arrays[key]


@pytest.mark.parametrize("S", SHARDS)
def test_expand_totals_and_gather_equal_reference(ref_mesh, S):
    jsnap, jdg, _snap, _dg, mesh = _meshed(S)
    rng = np.random.default_rng(S)
    V = jsnap.num_vertices
    span = _pair(S, "sh:rowspan")
    for n in (1, 37, 400):
        srcs = rng.integers(-1, V, n).astype(np.int32)
        if n == 37:
            srcs[:] = rng.integers(0, min(V, 20), n)  # one shard's rows only
        for d, extra in (("out", "ebase"), ("in", "eid")):
            ind = _pair(S, f"sh:HasFriend:{d}:indptr")
            nbr = _pair(S, f"sh:HasFriend:{d}:nbr")
            ex = _pair(S, f"sh:HasFriend:{d}:{extra}")
            j_tots = np.asarray(JMG.expand_totals(jdg.mesh_graph.mesh, ind[0], span[0], jnp.asarray(srcs)))
            tots = MG.expand_totals(mesh, ind[1], span[1], _t(srcs))
            assert tots.dtype == torch.int32 and np.array_equal(tots.numpy(), j_tots)
            full = (K.bucket(max(int(j_tots.max()), 1)), K.bucket(max(int(j_tots.sum()), 1)))
            short = (max(int(j_tots.max()) // 2, 1), max(int(j_tots.sum()) // 3, 1))
            for cap, cap_total in (full, short):
                want = JMG.expand_gather(
                    jdg.mesh_graph.mesh, ind[0], nbr[0], ex[0], span[0], jnp.asarray(srcs),
                    cap, cap_total, is_out=(d == "out"),
                )
                got = MG.expand_gather(mesh, ind[1], nbr[1], ex[1], span[1], _t(srcs), cap, cap_total, d == "out")
                for g, w in zip(got, want):
                    assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize(
    "S,n_profiles",
    # R = 300, 150, 100, 75, 38: every R but the first leaves a 128-vertex
    # group across a shard boundary; 5 profiles on 4 shards (R = 2) leave
    # the last shard past V
    [(1, 300), (2, 300), (3, 300), (4, 300), (8, 300), (4, 5)],
    ids=["1", "2", "3", "4", "8", "4-past-V"],
)
def test_sharded_bitmap_hop_equals_reference(ref_mesh, S, n_profiles):
    """K10's eid form (a push over the row-sharded CSR of each direction)
    equals the reference's hop over the edge-list slices, exactly: with and
    without an edge mask, a WHILE gate (the reference's frontier & gate),
    ``alive`` 0, and each shard walked alone at its ``s0`` as a rank of a
    process group holds it, the ranks' bitmaps ORed."""
    jsnap, jdg, _snap, _dg, mesh = _meshed(S, n_profiles)
    rng = np.random.default_rng(10 + S + n_profiles)
    E = jsnap.edge_classes["HasFriend"].num_edges
    vb = K.bucket(jsnap.num_vertices)
    src, dst, eid = (_pair(S, f"sh:HasFriend:el:{k}", n_profiles) for k in ("src", "dst", "eid"))
    csr = {
        d: tuple(_pair(S, f"sh:HasFriend:{d}:{k}", n_profiles)[1] for k in ("indptr", "nbr", x)) + (d == "out",)
        for d, x in (("out", "ebase"), ("in", "eid"))
    }
    assert mesh.n_shards * (csr["out"][0].shape[1] - 1) >= jsnap.num_vertices
    emask = rng.random(E) < 0.7
    gate = rng.random(vb) < 0.6
    zero = torch.tensor(0, dtype=torch.int32)
    for C, density in ((1, 0.02), (5, 0.1), (3, 0.0), (2, 1.0)):
        fr = rng.random((C, vb)) < density
        for d, (a, e) in (("out", (src, dst)), ("in", (dst, src))):
            sh = csr[d]
            for m in (emask, None):
                jm = jnp.ones(E, bool) if m is None else jnp.asarray(m)  # no mask reads every edge
                tm = None if m is None else _t(m)
                want = np.asarray(JMG.sharded_bitmap_hop(jdg.mesh_graph.mesh, a[0], e[0], eid[0], jm, jnp.asarray(fr)))
                got = MG.sharded_bitmap_hop(mesh, *sh, tm, _t(fr))
                assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
                assert np.array_equal(K.plain_bitmap_hop_eid(a[1], e[1], eid[1], tm, _t(fr)).numpy(), want)
                want_g = np.asarray(
                    JMG.sharded_bitmap_hop(jdg.mesh_graph.mesh, a[0], e[0], eid[0], jm, jnp.asarray(fr & gate))
                )
                got_g = MG.sharded_bitmap_hop(mesh, *sh, tm, _t(fr), _t(gate))
                assert np.array_equal(got_g.numpy(), want_g)
                assert not MG.sharded_bitmap_hop(mesh, *sh, tm, _t(fr), _t(gate), zero).any()
                ranks = torch.zeros_like(got_g)
                for s0 in range(S):
                    one = tuple(t[s0 : s0 + 1] for t in sh[:3])
                    K.bitmap_hop_shard(*one, sh[3], s0, tm, _t(fr), _t(gate), out=ranks)
                assert np.array_equal(ranks.numpy(), want_g)


def _csr_of(S, d: str, n_profiles: int = 300):
    """The port's row-sharded CSR of HasFriend's direction ``d`` (indptr,
    nbr, ``:out:ebase`` or ``:in:eid``)."""
    extra = "ebase" if d == "out" else "eid"
    return tuple(_pair(S, f"sh:HasFriend:{d}:{k}", n_profiles)[1] for k in ("indptr", "nbr", extra))


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_weight_pass_equals_reference(ref_mesh, S):
    """K23 through `sharded_weight_pass` (its row-sharded CSR walk) against
    the reference's pass over the edge-list slices: out and in, int32 and
    float32 weights, and the vertex mask folded into the weights (``ok``
    None)."""
    jsnap, jdg, _snap, _dg, mesh = _meshed(S)
    rng = np.random.default_rng(20 + S)
    E = jsnap.edge_classes["HasFriend"].num_edges
    vb = K.bucket(jsnap.num_vertices)
    src, dst, eid = (_pair(S, f"sh:HasFriend:el:{k}") for k in ("src", "dst", "eid"))
    emask = rng.random(E) < 0.6
    ok = rng.random(vb) < 0.7
    w_i = rng.integers(0, 1000, vb).astype(np.int32)
    w_f = (rng.random(vb) * 7.5).astype(np.float32)
    for d, (seg, emit) in (("out", (src, dst)), ("in", (dst, src))):
        sh = _csr_of(S, d) + (d == "out",)
        want = JMG.sharded_weight_pass(
            jdg.mesh_graph.mesh, seg[0], emit[0], eid[0], jnp.asarray(emask), jnp.asarray(ok), jnp.asarray(w_i)
        )
        got = MG.sharded_weight_pass(mesh, *sh, _t(emask), _t(ok), _t(w_i))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))
        folded = torch.where(_t(ok), _t(w_i), 0)
        got = MG.sharded_weight_pass(mesh, *sh, _t(emask), None, folded)
        assert np.array_equal(got.numpy(), np.asarray(want))
        want = JMG.sharded_weight_pass(
            jdg.mesh_graph.mesh, seg[0], emit[0], eid[0], jnp.asarray(emask), jnp.asarray(ok), jnp.asarray(w_f)
        )
        got = MG.sharded_weight_pass(mesh, *sh, _t(emask), _t(ok), _t(w_f))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("S", [2, 3, 4])
def test_plain_shard_weight_pass_csr_equals_reference(ref_mesh, S):
    """K23's plain CSR walk (`plain_shard_weight_pass_csr`) and the slices'
    plain walk (`plain_shard_weight_pass`) against the reference's
    `sharded_weight_pass` on an S-shard mesh: out and in, with and without
    an edge mask, ``w`` None (ones), int32 or float32, every held shard at
    once and one shard at a time at its ``s0`` (a rank's part)."""
    jsnap, jdg, _snap, _dg, _mesh = _meshed(S)
    rng = np.random.default_rng(30 + S)
    E = jsnap.edge_classes["HasFriend"].num_edges
    vb = K.bucket(jsnap.num_vertices)
    src, dst, eid = (_pair(S, f"sh:HasFriend:el:{k}") for k in ("src", "dst", "eid"))
    ok = rng.random(vb) < 0.7
    weights = {
        "none": (None, np.ones(vb, np.int32)),
        "i32": (rng.integers(0, 1000, vb).astype(np.int32),) * 2,
        "f32": ((rng.random(vb) * 7.5).astype(np.float32),) * 2,
    }
    for d, (seg, emit) in (("out", (src, dst)), ("in", (dst, src))):
        sh = _csr_of(S, d)
        for m in (None, rng.random(E) < 0.6):
            jm = np.ones(E, bool) if m is None else m
            tm = None if m is None else _t(m)
            for tag, (w, jw) in weights.items():
                want = np.asarray(JMG.sharded_weight_pass(
                    jdg.mesh_graph.mesh, seg[0], emit[0], eid[0], jnp.asarray(jm), jnp.asarray(ok), jnp.asarray(jw)
                ))
                tw = None if w is None else _t(w)
                zeros = lambda: torch.zeros(vb, dtype=torch.float32 if tag == "f32" else torch.int32)  # noqa: E731
                got = K.plain_shard_weight_pass_csr(*sh, d == "out", 0, tm, _t(ok), tw, zeros())
                slices = K.plain_shard_weight_pass(seg[1], emit[1], eid[1], tm, _t(ok), tw, zeros())
                ranks = zeros()
                for s0 in range(S):
                    one = tuple(t[s0 : s0 + 1] for t in sh)
                    K.plain_shard_weight_pass_csr(*one, d == "out", s0, tm, _t(ok), tw, ranks)
                for g in (got, slices, ranks):
                    if tag == "f32":
                        np.testing.assert_allclose(g.numpy(), want, rtol=1e-6)
                    else:
                        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), want), (d, tag)


# -- (c) statements, recorded and replayed --------------------------------------


@pytest.fixture(scope="module")
def statement_dbs():
    """demodb (300 profiles, 4 friends, seed 7): the reference's answers
    (single-device engine and oracle) per statement, and the port's twins
    attached with a 2-, 4- and 8-shard CPU mesh."""
    jdb = generate_demodb(n_profiles=300, avg_friends=4, seed=7)
    jsnap = attach_fresh_snapshot(jdb)
    want = {}
    for sql in STATEMENTS:
        single = j_canonical_rows(jdb.query(sql, engine="tpu", strict=True).to_dicts())
        assert single == j_canonical_rows(jdb.query(sql, engine="oracle").to_dicts()), sql
        want[sql] = single
    ports = {}
    for S in SHARDS:
        db, snap = snapshot_from_arrays(*_carry_arrays(jdb, jsnap), device="cpu")
        db.attach_snapshot(snap, mesh=make_mesh(S, device="cpu"))
        ports[S] = (db, snap)
    return want, ports


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("i", range(len(STATEMENTS)))
def test_mesh_statement_equals_reference(statement_dbs, S, i):
    want, ports = statement_dbs
    db, snap = ports[S]
    sql = STATEMENTS[i]
    for _ in range(3):  # the recording, then two replays
        assert canonical_rows(db.query(sql).to_dicts()) == want[sql]
    (plan,) = TE._plan_cache(snap)[TE._cache_key(parse(sql), {})].plans
    assert plan.replays == 2 and plan.solver.dg.mesh_graph.n_shards == S
    assert not plan.batchable()


@pytest.mark.parametrize("S", SHARDS)
def test_mesh_config5_count_equals_reference(S):
    db, snap = build_snb_shape(400, msgs_per_person=1, avg_knows=4, seed=7, device="cpu")
    db.attach_snapshot(snap, mesh=make_mesh(S, device="cpu"))
    jdb, _jsnap = j_build_snb_shape(400, msgs_per_person=1, avg_knows=4, seed=7)
    for d in (12_000, 17_000, 12_000):
        want = jdb.query(CONFIG5, params={"d": d}, engine="tpu", strict=True).to_dicts()
        assert want == [{"n": numpy_config5_count(snap, d)}]
        assert db.query(CONFIG5, {"d": d}).to_dicts() == want


# -- (d) the row-sharded BFS ---------------------------------------------------


@pytest.fixture(scope="module")
def bfs_graph():
    jdb = generate_demodb(n_profiles=300, avg_friends=4, seed=3)
    jsnap = attach_fresh_snapshot(jdb)
    return jsnap, jsnap.edge_classes["HasFriend"]


def _roots(V: int, kind: str):
    roots = np.zeros((5, V), bool)
    if kind == "random":
        rng = np.random.default_rng(0)
        for q in range(5):
            roots[q, rng.choice(V, size=3, replace=False)] = True
    elif kind == "one_shard":
        roots[0, 0] = roots[1, 1] = roots[2, 2] = True
    return roots


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("max_depth", [0, 1, 4, 50])
def test_bfs_equals_host_and_reference(ref_mesh, bfs_graph, replicas, max_depth):
    jsnap, csr = bfs_graph
    roots = _roots(jsnap.num_vertices, "random")
    got = bfs_reachability(
        ShardedCSR.from_snapshot(jsnap, make_mesh(4, replicas, device="cpu"), "HasFriend"), roots, max_depth
    )
    assert got.dtype == bool and got.shape == roots.shape
    assert (got == host_bfs(csr.indptr_out, csr.dst, roots, max_depth)).all()
    ref = JSH.bfs_reachability(
        JSH.ShardedCSR.from_snapshot(jsnap, _jmesh(4 * replicas, replicas), "HasFriend"),
        roots,
        max_depth,
    )
    assert (got == ref).all()


@pytest.mark.parametrize("kind", ["empty", "one_shard"])
def test_bfs_edge_roots_equal_host_and_reference(ref_mesh, bfs_graph, kind):
    jsnap, csr = bfs_graph
    roots = _roots(jsnap.num_vertices, kind)
    got = bfs_reachability(ShardedCSR.from_snapshot(jsnap, make_mesh(8, device="cpu"), "HasFriend"), roots, 3)
    assert (got == host_bfs(csr.indptr_out, csr.dst, roots, 3)).all()
    ref = JSH.bfs_reachability(JSH.ShardedCSR.from_snapshot(jsnap, _jmesh(8), "HasFriend"), roots, 3)
    assert (got == ref).all()
    assert got.any() == (kind != "empty")


@pytest.mark.parametrize("S", [3, 7])
def test_bfs_ragged_shards_equal_host_and_reference(ref_mesh, bfs_graph, S):
    """Shards whose row count is a multiple neither of the card's 16-byte
    frontier loads nor of its 512-row runs (R = 100 and 43 here), and 33
    queries (one past a 32-query word), against the host BFS and the
    reference."""
    jsnap, csr = bfs_graph
    V = jsnap.num_vertices
    scsr = ShardedCSR.from_snapshot(jsnap, make_mesh(S, device="cpu"), "HasFriend")
    assert scsr.rows_per_shard % 16 != 0
    rng = np.random.default_rng(S)
    roots = np.zeros((33, V), bool)
    roots[np.arange(33), rng.integers(0, V, 33)] = True
    roots[32, scsr.rows_per_shard - 1] = roots[32, V - 1] = True  # a shard's last row, the last vertex
    got = bfs_reachability(scsr, roots, 3)
    assert (got == host_bfs(csr.indptr_out, csr.dst, roots, 3)).all()
    ref = JSH.bfs_reachability(JSH.ShardedCSR.from_snapshot(jsnap, _jmesh(S), "HasFriend"), roots, 3)
    assert (got == ref).all()


# -- (e) refusals --------------------------------------------------------------


def _port_demodb():
    jdb = generate_demodb(n_profiles=60, avg_friends=3, seed=5)
    jsnap = attach_fresh_snapshot(jdb)
    return snapshot_from_arrays(*_carry_arrays(jdb, jsnap), device="cpu")


def test_mesh_refuses_delta_overlay():
    db, snap = _port_demodb()
    arm_delta_maintenance(db, spare_vertices=16, spare_edges=64)
    db.attach_snapshot(snap, mesh=make_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="delta-maintained snapshots are single-device"):
        db.query(STATEMENTS[0])


def test_mesh_refuses_tier_cap(monkeypatch):
    db, snap = _port_demodb()
    monkeypatch.setattr(config, "tier_hbm_cap_bytes", 64)
    with pytest.raises(ValueError, match="tiered snapshots are single-device"):
        db.attach_snapshot(snap, mesh=make_mesh(2, device="cpu"))


def test_mesh_refuses_late_attach_and_other_device():
    db, snap = _port_demodb()
    db.query(STATEMENTS[0])  # the device graph is built, without a mesh
    with pytest.raises(ValueError, match="before the snapshot's first device upload"):
        db.attach_snapshot(snap, mesh=make_mesh(2, device="cpu"))
    mesh = make_mesh(2, device="cpu")
    mesh.device = torch.device("meta")
    with pytest.raises(ValueError, match="the mesh lives on"):
        db.attach_snapshot(snap, mesh=mesh)
