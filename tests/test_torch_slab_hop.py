"""The slab's part of a dirty hop, folded into K10's push as a bucket probe
(`ops.csr.bitmap_hop_csr` with a `SlabIndex`), against the reference's hop
over the whole edge list with the ``live`` mask (`orientdb_tpu.ops.csr.
bitmap_hop`, as `orientdb_tpu/exec/tpu_engine.py` runs it on a delta-armed
snapshot), on the CPU.

The armed edge classes are built with numpy (`test_torch_push_hops.
armed_graph`): a padded base CSR with tombstones, slab edges indexed in
bucket tables as the maintainer fills them (collisions at NB = 256 over
thousands of vertices, one bucket filled to BK, a slab vertex of base
degree 0), slab tombstones. Then the engine: variable-depth and TRAVERSE
statements after writes equal the reference's ``engine="tpu"``, each dirty
hop one probe launch until a bucket overflows, and the edge-list form only
for the overflowed class after its plans re-record.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientdb_tpu.ops import csr as J
from orientdb_tpu_torch.ops import csr as K
from test_torch_deltas import Pair, _plan, _records, build_db, canon
from test_torch_push_hops import _t, armed_graph, probe_hop_args


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_hop(g, d: str, mask, fr, gate=None) -> np.ndarray:
    """The reference's hop over every edge slot of the class (base and
    slab), ``mask`` carrying ``live``; a gate folds in as its frontier &
    gate."""
    a, em = (g["edge_src"], g["dst"]) if d == "out" else (g["dst"], g["edge_src"])
    f = fr if gate is None else fr & gate[None, :]
    return np.asarray(J.bitmap_hop(jnp.asarray(a), jnp.asarray(em), jnp.asarray(mask), jnp.asarray(f)))


#: (base vertices, slab vertices, avg degree, slab slots, slab edges, NB)
ARMED_CASES = [
    (5_000, 64, 3.0, 2_048, 1_500, 256),  # V ≫ NB: ~20 vertices a bucket
    (300, 16, 2.0, 512, 400, 256),
    (40, 8, 1.5, 64, 40, 256),
]


@pytest.mark.parametrize("d", ["out", "in"])
@pytest.mark.parametrize("v,slab_v,avg,spare,used,nb", ARMED_CASES)
def test_probe_hop_equals_reference(d, v, slab_v, avg, spare, used, nb):
    """The push with the probe (the wrapper's CPU path, and its two plain
    halves) equals the reference's edge-list hop over base and slab with
    ``live``, and with an edge WHERE ANDed in; with and without a gate, C
    1, 3 and 33 (rows past 32), ``alive`` 0 and ``out`` accumulation. The
    slab's own bits are not all in the CSR's: the probe is what reaches
    them."""
    rng = np.random.default_rng(v + used + (d == "in"))
    g = armed_graph(rng, v, slab_v, avg, spare, used, nb)
    hot = v  # the first slab vertex: base degree 0, its out bucket full
    n_slab = int((g[f"tab_{d}"] >= 0).sum())
    assert (g["tab_out"].reshape(nb, -1)[hot & (nb - 1)] >= 0).all()
    assert g["indptr_out"][hot + 1] == g["indptr_out"][hot]
    assert (~g["live"][g["base"] : g["base"] + n_slab]).any() and (~g["live"][: g["base"]]).any()
    vb = K.bucket(g["v"])
    where = rng.random(g["live"].shape[0]) < 0.7
    zero = torch.tensor(0, dtype=torch.int32)
    slab_only = 0
    for m in (g["live"], g["live"] & where):
        csr, probe, em = probe_hop_args(g, d, m)
        for c in (1, 3, 33):
            fr = rng.random((c, vb)) < 0.02
            fr[:, hot] = True
            gate = rng.random(vb) < 0.8
            gate[hot] = True
            for gt in (None, gate):
                tg = None if gt is None else _t(gt)
                want = _ref_hop(g, d, m, fr, gt)
                got = K.bitmap_hop_csr(*csr, em, _t(fr), tg, probe=probe)
                assert np.array_equal(got.numpy(), want), (c, gt is None)
                base = K.plain_bitmap_hop_csr(*csr, em, _t(fr), tg)
                slab = K.plain_bucket_hop(probe, em, _t(fr), tg)
                assert torch.equal(base | slab, got)
                slab_only += int((slab & ~base).sum())
            acc = torch.zeros((c, vb), dtype=torch.bool)
            acc[:, -1] = True
            K.bitmap_hop_csr(*csr, em, _t(fr), None, None, acc, probe)
            assert np.array_equal(acc.numpy(), _ref_hop(g, d, m, fr) | (np.arange(vb) == vb - 1)[None, :])
            assert not K.bitmap_hop_csr(*csr, em, _t(fr), None, zero, probe=probe).any()
    assert slab_only > 0


def test_probe_reads_only_matching_live_entries():
    """A bucket shared by several vertices: only the entries whose owning
    endpoint is the probed vertex count, a tombstoned one does not, an
    entry past the edge count is skipped, and a vertex past the CSR's rows
    is never probed."""
    nb, bk, base = 4, 4, 2
    own = torch.tensor([0, 1, 1, 5, 9, 5, -1, -1], dtype=torch.int32)  # slots 0-1 base, 2-5 slab
    nbr = torch.tensor([3, 2, 7, 6, 4, 0, -1, -1], dtype=torch.int32)
    live = torch.tensor([1, 1, 1, 1, 1, 0, 0, 0], dtype=torch.bool)
    tab = torch.full((nb * bk,), -1, dtype=torch.int32)
    # bucket 1 (vertices 1, 5, 9, ...): slots 3 (5 -> 6), 4 (9 -> 4), 5
    # (5 -> 0, dead) and 11 (past the 8 slots)
    tab[1 * bk : 1 * bk + 4] = torch.tensor([1, 2, 3, 9], dtype=torch.int32)
    tab[0] = 0  # bucket 0 (vertices 0, 4, 8, ...): slot 2, owned by vertex 1
    probe = K.SlabIndex(tab, own, nbr, live, base, nb, bk)
    fr = torch.zeros((2, 16), dtype=torch.bool)
    fr[0, 5] = True
    fr[1, 9] = True
    fr[1, 8] = True
    got = K.plain_bucket_hop(probe, None, fr)
    want = torch.zeros_like(fr)
    want[0, 6] = True  # slot 3 (5 -> 6); slot 5 (5 -> 0) is dead
    want[1, 4] = True  # slot 4 (9 -> 4)
    assert torch.equal(got, want)
    assert not K.plain_bucket_hop(probe, None, fr, hi=5).any()
    empty = torch.zeros(3, dtype=torch.int32)
    indptr = torch.zeros(11, dtype=torch.int32)
    assert torch.equal(K.bitmap_hop_csr(indptr, empty, None, None, fr, probe=probe), want)
    with pytest.raises(ValueError, match="power of two"):
        K.bitmap_hop_csr(indptr, empty, None, None, fr, probe=probe._replace(nb=3))


# ---------------------------------------------------------------------------
# the engine: one probe launch a dirty hop, the edge-list form after an
# overflow
# ---------------------------------------------------------------------------

V1_Q = (
    "MATCH {class:Person, as:p, where:(age < 25)}"
    "-Knows->{as:f, while:($depth < 3), where:(age < 30)} RETURN count(*) AS n"
)
TR1_Q = "TRAVERSE out('Knows') FROM (SELECT FROM Person WHERE age < 23) WHILE $depth < 2 STRATEGY BREADTH_FIRST"
BOTH_Q = "MATCH {class:Person, as:p, where:(age < 22)}-Knows-{as:f, maxDepth:3, depthAlias:d} RETURN p.name AS p, f.name AS f, d AS d"
# a Knows expansion with a NOT arm that hops over Likes
NOT_Q = "MATCH {class:Person, as:p}-Knows->{as:q}, NOT {as:q}-Likes->{} RETURN p.name AS p, q.name AS q"


def _spy(monkeypatch):
    """Counts of the edge-list hop, the push with a probe and the push
    without one."""
    calls = {"edge_list": 0, "probe": 0, "csr": 0}
    hop, push = K.bitmap_hop, K.bitmap_hop_csr

    def spy_hop(*a, **kw):
        calls["edge_list"] += 1
        return hop(*a, **kw)

    def spy_push(*a, **kw):
        calls["probe" if (a[8] if len(a) > 8 else kw.get("probe")) is not None else "csr"] += 1
        return push(*a, **kw)

    monkeypatch.setattr(K, "bitmap_hop", spy_hop)
    monkeypatch.setattr(K, "bitmap_hop_csr", spy_push)
    return calls


def _check(pair, queries):
    for q in queries:
        trav = q.startswith("TRAVERSE")
        want = pair.jdb.query(q, engine="tpu", strict=True).to_dicts()
        for _ in range(2):  # a recording, then a replay of its plan
            got = pair.tdb.query(q).to_dicts()
            if trav:
                assert _records(got) == _records(want), q
            else:
                assert canon(got) == canon(want), q


def test_dirty_hops_probe_until_a_bucket_overflows(monkeypatch):
    """After writes (a slab vertex with slab edges, base-to-base slab
    edges, a slab and a base tombstone), V1- and TR1-shaped statements and
    a both-direction depth-alias one equal the reference's ``engine="tpu"``,
    each dirty hop one push with the probe and no edge-list launch. Nine
    edges out of one vertex then overflow its bucket: the plans re-record,
    the Knows hops run the edge-list form over the window and stay equal,
    and the Likes hops (no overflow) keep probing."""
    jdb, vs = build_db()
    pair = Pair(monkeypatch, jdb, sv=64, se=64)
    calls = _spy(monkeypatch)
    queries = [V1_Q, TR1_Q, BOTH_Q]
    _check(pair, queries)
    assert calls["probe"] == 0 and calls["edge_list"] == 0 and calls["csr"] > 0  # clean topology
    w = jdb.new_vertex("Person", name="w", age=21)
    jdb.new_edge("Knows", vs[1], w, since=2)
    jdb.new_edge("Knows", w, vs[7], since=4)
    gone = jdb.new_edge("Knows", vs[0], vs[9], since=6)
    jdb.new_edge("Knows", vs[2], vs[10], since=1)
    jdb.new_edge("Likes", vs[3], w)
    assert pair.sync()
    jdb.delete(gone)
    jdb.delete(vs[6])
    assert pair.sync()
    ov = pair.tsnap._overlay
    assert ov.topology_dirty and not ov.bucket_overflow
    # the push walks indptr's rows: every padded vertex, slab ones included
    for csr in pair.tsnap.edge_classes.values():
        assert csr.indptr_out.shape[0] == csr.indptr_in.shape[0] == pair.tsnap.num_vertices + 1
    for k in calls:
        calls[k] = 0
    _check(pair, queries + [NOT_Q])
    assert calls["probe"] > 0 and calls["edge_list"] == 0 and calls["csr"] == 0
    before = _plan(pair.tsnap, V1_Q).plans[0]
    gen = ov.plan_gen
    for i, t in enumerate((1, 2, 3, 5, 7, 8, 9, 10, 11)):  # BK = 8: vs[4]'s out bucket overflows
        jdb.new_edge("Knows", vs[4], vs[t], since=i)
    assert pair.sync()
    assert ov.bucket_overflow == {"Knows"} and ov.plan_gen > gen
    for k in calls:
        calls[k] = 0
    _check(pair, queries)
    assert calls["edge_list"] > 0 and calls["probe"] == 0
    after = _plan(pair.tsnap, V1_Q).plans[0]
    assert after is not before and after.solver.delta_gen == ov.plan_gen
    for k in calls:
        calls[k] = 0
    _check(pair, [NOT_Q])
    assert calls["probe"] > 0 and calls["edge_list"] == 0
