"""The port's bitmap-BFS primitives (`orientdb_tpu_torch.ops.csr` K9–K12)
against the reference's functions on the same numpy-seeded inputs, on the
CPU, where each wrapper runs its plain PyTorch version.

Reference functions: `orientdb_tpu.ops.csr.rows_to_bitmap` and
`bitmap_hop` (also against K10's CSR form, `bitmap_hop_csr`, given the edge
list its CSR expands to), `orientdb_tpu.exec.tpu_engine._var_emit_mask` (with the
popcount and per-row any its callers take), and the level step of
`_expand_var_depth` (``nxt & ~visited``, ``visited | nxt``,
`csr.mask_count`). Every value is bool or int32, so every comparison is
exact. The kernels themselves run only on a card
(`tests/test_torch_kernels.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientdb_tpu.exec.tpu_engine import _var_emit_mask as j_var_emit_mask
from orientdb_tpu.ops import csr as J
from orientdb_tpu_torch.ops import csr as T


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy (JAX arrays are read-only)


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _bitmap(rng, c: int, vb: int, density: float) -> np.ndarray:
    return rng.random((c, vb)) < density


def _edges(rng, vb: int, e: int, dup_targets: bool = False):
    """An edge list over vb vertices, in out-CSR order (sources ascending);
    with ``dup_targets`` most edges share a few targets."""
    src = np.sort(rng.integers(0, vb, e)).astype(np.int32)
    hi = 3 if dup_targets else vb
    dst = rng.integers(0, hi, e).astype(np.int32)
    return src, dst


@pytest.mark.parametrize("c,vb", [(1, 8), (8, 64), (5, 100), (32, 256)])
def test_rows_to_bitmap(c, vb):
    rng = np.random.default_rng(c * 31 + vb)
    rows = rng.integers(-2, vb + 3, c).astype(np.int32)  # -1/-2 rows and ids past vb
    rows[0] = -1
    want = _np(J.rows_to_bitmap(jnp.asarray(rows), vb))
    got = T.rows_to_bitmap(_t(rows), vb)
    assert got.dtype == torch.bool and got.shape == (c, vb)
    assert np.array_equal(got.numpy(), want)


def test_rows_to_bitmap_all_padding():
    rows = np.full(8, -1, np.int32)
    assert not T.rows_to_bitmap(_t(rows), 64).any()
    assert T.rows_to_bitmap(_t(rows[:0]), 64).shape == (0, 64)


def _j_hop(act, emit, mask, frontier):
    return _np(J.bitmap_hop(jnp.asarray(act), jnp.asarray(emit), jnp.asarray(mask), jnp.asarray(frontier)))


@pytest.mark.parametrize("direction", ["out", "in", "both"])
@pytest.mark.parametrize("masked", [False, True], ids=["all_edges", "masked"])
@pytest.mark.parametrize("dup", [False, True], ids=["spread", "dup_targets"])
def test_bitmap_hop(direction, masked, dup):
    rng = np.random.default_rng(7 + masked + 2 * dup)
    c, vb, e = 6, 128, 900
    src, dst = _edges(rng, vb, e, dup_targets=dup)
    mask = rng.random(e) < 0.6 if masked else np.ones(e, bool)
    frontier = _bitmap(rng, c, vb, 0.05)
    frontier[2] = False  # an empty row
    dirs = {"out": [(src, dst)], "in": [(dst, src)], "both": [(src, dst), (dst, src)]}[direction]
    want = np.zeros((c, vb), bool)
    for a, m in dirs:
        want |= _j_hop(a, m, mask, frontier)
    out = None
    for a, m in dirs:
        out = T.bitmap_hop(_t(a), _t(m), _t(mask) if masked else None, _t(frontier), out=out)
    assert np.array_equal(out.numpy(), want)
    # the plain version alone equals the reference too
    a, m = dirs[0]
    assert np.array_equal(
        T.plain_bitmap_hop(_t(a), _t(m), _t(mask), _t(frontier)).numpy(), _j_hop(a, m, mask, frontier)
    )


def test_bitmap_hop_duplicate_targets_mixed_activity():
    """Three edges into one target, only the middle one active: a scatter
    that stores each edge's activity would end on False."""
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([5, 5, 5], np.int32)
    frontier = np.zeros((2, 8), bool)
    frontier[0, 1] = True
    frontier[1, 0] = frontier[1, 2] = True
    want = _j_hop(src, dst, np.ones(3, bool), frontier)
    got = T.bitmap_hop(_t(src), _t(dst), None, _t(frontier)).numpy()
    assert np.array_equal(got, want) and got[0, 5] and got[1, 5]
    mask = np.array([True, False, True])
    got = T.bitmap_hop(_t(src), _t(dst), _t(mask), _t(frontier)).numpy()
    assert np.array_equal(got, _j_hop(src, dst, mask, frontier)) and not got[0, 5] and got[1, 5]


def test_bitmap_hop_empty_edge_list_and_padding_rows():
    vb = 64
    rows = np.array([-1, 4, -1, 63], np.int32)
    frontier = _np(J.rows_to_bitmap(jnp.asarray(rows), vb))
    empty = np.zeros(0, np.int32)
    want = _j_hop(empty, empty, np.zeros(0, bool), frontier)
    got = T.bitmap_hop(_t(empty), _t(empty), None, T.rows_to_bitmap(_t(rows), vb))
    assert np.array_equal(got.numpy(), want) and not want.any()
    # out-of-range endpoints clip as the reference's jnp.clip does
    src = np.array([-3, 4, 63, 70], np.int32)
    dst = np.array([1, 99, -5, 2], np.int32)
    got = T.bitmap_hop(_t(src), _t(dst), None, _t(frontier))
    assert np.array_equal(got.numpy(), _j_hop(src, dst, np.ones(4, bool), frontier))
    # rows of -1 reach nothing
    assert not got[0].any() and not got[2].any()


def test_bitmap_hop_gate_and_alive():
    """The WHILE gate folds into the hop as ``frontier & gate``; ``alive``
    (the frontier's popcount) changes nothing unless it is 0, which only
    an empty frontier has."""
    rng = np.random.default_rng(11)
    c, vb, e = 4, 96, 500
    src, dst = _edges(rng, vb, e)
    frontier = _bitmap(rng, c, vb, 0.1)
    gate = rng.random(vb) < 0.5
    ones = np.ones(e, bool)
    want = _j_hop(src, dst, ones, frontier & gate[None, :])
    alive = torch.tensor(int(frontier.sum()), dtype=torch.int32)
    got = T.bitmap_hop(_t(src), _t(dst), None, _t(frontier), gate=_t(gate), alive=alive)
    assert np.array_equal(got.numpy(), want)
    zero = np.zeros((c, vb), bool)
    got = T.bitmap_hop(_t(src), _t(dst), None, _t(zero), alive=torch.zeros((), dtype=torch.int32))
    assert not got.any()
    # accumulating into an existing bitmap ORs
    base = _bitmap(rng, c, vb, 0.02)
    out = T.bitmap_hop(_t(src), _t(dst), None, _t(frontier), out=_t(base.copy()))
    assert np.array_equal(out.numpy(), base | _j_hop(src, dst, ones, frontier))


def _graph(rng, v: int, avg: float, hub: int = 0):
    """A CSR over v vertices in both directions: out rows (``indptr_out``,
    ``dst``), in rows (``indptr_in``, ``src``, ``edge_id_in``), and the
    out-order edge list (``edge_src``, ``dst``) the reference hops over.
    About a fifth of the rows are empty; with ``hub`` vertex v // 2 has
    that many out edges."""
    deg = rng.poisson(avg, v)
    deg[rng.random(v) < 0.2] = 0
    if hub:
        deg[v // 2] = hub
    indptr_out = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    edge_src = np.repeat(np.arange(v, dtype=np.int32), deg)
    dst = rng.integers(0, v, edge_src.shape[0]).astype(np.int32)
    order_in = np.argsort(dst, kind="stable").astype(np.int32)
    indptr_in = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=v))]).astype(np.int32)
    return {
        "indptr_out": indptr_out, "dst": dst, "edge_src": edge_src,
        "indptr_in": indptr_in, "src": edge_src[order_in], "edge_id_in": order_in,
    }


def _csr_args(g, direction):
    """(indptr, nbr, eid) of a hop, and the reference's (act, emit)."""
    if direction == "out":
        return (g["indptr_out"], g["dst"], None), (g["edge_src"], g["dst"])
    return (g["indptr_in"], g["src"], g["edge_id_in"]), (g["dst"], g["edge_src"])


def _hop_csr(fn, csr, mask, frontier, gate=None, alive=None, out=None):
    ip, nbr, eid = csr
    return fn(_t(ip), _t(nbr), None if eid is None else _t(eid), None if mask is None else _t(mask),
              _t(frontier), None if gate is None else _t(gate), alive, *([] if out is None else [out]))


@pytest.mark.parametrize("c", [1, 8, 33])
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("masked", [False, True], ids=["all_edges", "masked"])
@pytest.mark.parametrize("direction", ["out", "in"])
def test_bitmap_hop_csr_equals_reference(direction, masked, gated, c):
    """K10's CSR form and its plain version against the reference's hop over
    the out-order edge list the same CSR expands to; an in hop reads its
    mask through ``edge_id_in``. The frontier is wider than the vertex
    count (vb > V), with bits set past V."""
    rng = np.random.default_rng(3 + 2 * masked + 4 * gated + c + (direction == "in"))
    v, vb = 150, 256
    g = _graph(rng, v, 4.0)
    csr, (act, emit) = _csr_args(g, direction)
    e = g["dst"].shape[0]
    mask = rng.random(e) < 0.6 if masked else None
    frontier = _bitmap(rng, c, vb, 0.05)
    gate = rng.random(vb) < 0.5 if gated else None
    fr_ref = frontier if gate is None else frontier & gate[None, :]
    want = _j_hop(act, emit, np.ones(e, bool) if mask is None else mask, fr_ref)
    for fn in (T.plain_bitmap_hop_csr, T.bitmap_hop_csr):
        got = _hop_csr(fn, csr, mask, frontier, gate)
        assert got.dtype == torch.bool and got.shape == (c, vb)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("direction", ["out", "in"])
def test_bitmap_hop_csr_tombstones_mask_before_clip(direction):
    """Tombstoned slots carry a -1 neighbour (``dst`` in out order, ``src``
    at the in position) and ``live`` False: the mask kills them before the
    clip could alias vertex 0, as in the reference's edge list."""
    rng = np.random.default_rng(21 + (direction == "in"))
    v, vb = 120, 128
    g = _graph(rng, v, 5.0)
    e = g["dst"].shape[0]
    live = np.ones(e, bool)
    dead = rng.choice(e, e // 5, replace=False)
    live[dead] = False
    in_pos = np.empty(e, np.int64)
    in_pos[g["edge_id_in"]] = np.arange(e)
    g["dst"] = g["dst"].copy()
    g["dst"][dead] = -1
    g["src"] = g["src"].copy()
    g["src"][in_pos[dead]] = -1
    csr, (act, emit) = _csr_args(g, direction)
    frontier = _bitmap(rng, 8, vb, 0.3)
    frontier[:, 0] = False  # vertex 0 is reached only through a live edge
    want = _j_hop(act, emit, live, frontier)
    where = live & (rng.random(e) < 0.7)
    for fn in (T.plain_bitmap_hop_csr, T.bitmap_hop_csr):
        assert np.array_equal(_hop_csr(fn, csr, live, frontier).numpy(), want)
        assert np.array_equal(_hop_csr(fn, csr, where, frontier).numpy(), _j_hop(act, emit, where, frontier))


def test_bitmap_hop_csr_alive_out_and_hub():
    """``alive`` 0 reaches nothing; ``out`` ORs (both directions into one
    bitmap, as a ``both`` arm does); a hub row and empty rows."""
    rng = np.random.default_rng(33)
    v, vb = 300, 300
    g = _graph(rng, v, 3.0, hub=900)
    e = g["dst"].shape[0]
    ones = np.ones(e, bool)
    frontier = _bitmap(rng, 8, vb, 0.02)
    frontier[3, v // 2] = True  # the hub is active in row 3
    alive = torch.tensor(int(frontier.sum()), dtype=torch.int32)
    out_csr, out_el = _csr_args(g, "out")
    in_csr, in_el = _csr_args(g, "in")
    want = _j_hop(*out_el, ones, frontier) | _j_hop(*in_el, ones, frontier)
    got = _hop_csr(T.bitmap_hop_csr, out_csr, None, frontier, alive=alive)
    got = _hop_csr(T.bitmap_hop_csr, in_csr, None, frontier, alive=alive, out=got)
    assert np.array_equal(got.numpy(), want) and got[3].sum() >= 100
    base = _bitmap(rng, 8, vb, 0.05)
    acc = _hop_csr(T.bitmap_hop_csr, out_csr, None, frontier, out=_t(base.copy()))
    assert np.array_equal(acc.numpy(), base | _j_hop(*out_el, ones, frontier))
    zero = torch.zeros((), dtype=torch.int32)
    for fn in (T.plain_bitmap_hop_csr, T.bitmap_hop_csr):
        assert not _hop_csr(fn, out_csr, None, np.zeros((8, vb), bool), alive=zero).any()
    # every row empty, and a CSR of no vertices
    empty = np.zeros(v + 1, np.int32), np.zeros(0, np.int32), None
    assert not _hop_csr(T.bitmap_hop_csr, empty, None, frontier).any()
    none = np.zeros(1, np.int32), np.zeros(0, np.int32), None
    assert not _hop_csr(T.bitmap_hop_csr, none, None, frontier).any()


@pytest.mark.parametrize("bound", [False, True], ids=["open", "close"])
@pytest.mark.parametrize("c,vb", [(1, 16), (8, 64), (7, 40)])
def test_bitmap_emit_equals_var_emit_mask(bound, c, vb):
    rng = np.random.default_rng(c + vb + bound)
    reached = _bitmap(rng, c, vb, 0.3)
    node = rng.random(vb) < 0.5
    b = None
    if bound:
        b = rng.integers(-2, vb, c).astype(np.int32)
        b[0] = -2  # padding rows bind -2 and match nothing
        # most bound endpoints reached and admitted
        for i in range(1, c, 2):
            reached[i, b[i]] = node[b[i]] = True
    want = _np(j_var_emit_mask(jnp.asarray(reached), jnp.asarray(node), None if b is None else jnp.asarray(b), vb))
    emit, any_row, count = T.bitmap_emit(
        _t(reached), _t(node), None if b is None else _t(b), emit=True, any_row=True, count=True
    )
    assert np.array_equal(emit.numpy(), want)
    assert np.array_equal(any_row.numpy(), want.any(axis=1))
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(_np(jnp.sum(jnp.asarray(want), dtype=jnp.int32)))
    # each output alone
    assert T.bitmap_emit(_t(reached), _t(node), None if b is None else _t(b), emit=False)[0] is None
    only_count = T.bitmap_emit(
        _t(reached), _t(node), None if b is None else _t(b), emit=False, count=True
    )
    assert only_count[0] is None and only_count[1] is None and int(only_count[2]) == int(want.sum())


def _advance_case(c, vb, fill, node, bound):
    tag = "-".join([str(c), str(vb), fill] + (["node"] if node else []) + (["bound"] if bound else []))
    return pytest.param(c, vb, fill, node, bound, id=tag)


#: the level step alone, with the folded emission count (``node``), and
#: restricted to a close arm's bound column (``bound``); the first three
#: are the step alone at random densities
ADVANCE_CASES = [
    pytest.param(1, 8, "random", False, False, id="1-8"),
    pytest.param(8, 64, "random", False, False, id="8-64"),
    pytest.param(3, 50, "random", False, False, id="3-50"),
] + [
    _advance_case(c, vb, fill, node, bound)
    for c, vb in ((1, 8), (4, 50), (8, 64))
    for fill in ("random", "zero", "one")
    for node, bound in ((False, False), (True, False), (True, True))
    if (fill, node) != ("random", False)
]


@pytest.mark.parametrize("c,vb,fill,node,bound", ADVANCE_CASES)
def test_frontier_advance_equals_level_step(c, vb, fill, node, bound):
    """K12 against the reference's level step and, with ``node``, against
    ``jnp.sum(_var_emit_mask(nxt, node, bound), dtype=int32)`` over the new
    frontier (the COUNT path's emission, which K12 folds in)."""
    rng = np.random.default_rng(c * vb + 7 * node + 3 * bound)
    nxt = {"random": _bitmap(rng, c, vb, 0.4), "zero": np.zeros((c, vb), bool), "one": np.ones((c, vb), bool)}[fill]
    visited = _bitmap(rng, c, vb, 0.5)
    node_v = rng.random(vb) < 0.5 if node else None
    b = None
    if bound:
        # -2 padding rows, and bound endpoints at the first and last column
        b = rng.integers(0, vb, c).astype(np.int32)
        b[0] = vb - 1 if c == 1 else -2
        if c > 2:
            b[1], b[2] = 0, vb - 1
        for i in range(c):
            if b[i] >= 0 and fill != "zero":
                nxt[i, b[i]], visited[i, b[i]], node_v[b[i]] = True, False, True
    jn = jnp.asarray(nxt) & ~jnp.asarray(visited)
    jv = jnp.asarray(visited) | jn
    jcount = int(_np(J.mask_count(jn.reshape(-1))))
    tn, tv = _t(nxt.copy()), _t(visited.copy())
    got = T.frontier_advance(tn, tv, None, _t(node_v) if node else None, _t(b) if bound else None)
    assert np.array_equal(tn.numpy(), _np(jn)) and np.array_equal(tv.numpy(), _np(jv))
    count = got[0] if node else got
    assert count.dtype == torch.int32 and count.dim() == 0 and int(count) == jcount
    if node:
        emit = j_var_emit_mask(jn, jnp.asarray(node_v), jnp.asarray(b) if bound else None, vb)
        want = int(_np(jnp.sum(emit, dtype=jnp.int32)))
        assert got[1].dtype == torch.int32 and got[1].dim() == 0 and int(got[1]) == want
        if bound and fill != "zero":
            assert want == int((b >= 0).sum())  # every bound endpoint emits once
    # a second step from the same bitmaps finds nothing new
    again = T.frontier_advance(tn, tv, None, _t(node_v) if node else None, _t(b) if bound else None)
    assert all(int(x) == 0 for x in (again if node else (again,))) and not tn.any()


def _person_knows_with_records(n: int, avg: int, seed: int):
    """A Person–knows graph with records in the reference (so its oracle
    engine runs), snapshotted there and carried into the port."""
    from orientdb_tpu import Database
    from orientdb_tpu.storage.snapshot import attach_fresh_snapshot
    from orientdb_tpu_torch.carry import snapshot_from_arrays
    from tests.test_torch_match import _carry_arrays

    rng = np.random.default_rng(seed)
    jdb = Database("pk_records")
    jdb.schema.create_vertex_class("Person")
    jdb.schema.create_edge_class("knows")
    vs = [jdb.new_vertex("Person", uid=i, age=int(a)) for i, a in enumerate(rng.integers(18, 80, n))]
    for s, d in zip(rng.integers(0, n, n * avg), rng.integers(0, n, n * avg)):
        jdb.new_edge("knows", vs[s], vs[d])
    jsnap = attach_fresh_snapshot(jdb)
    db, _snap = snapshot_from_arrays(*_carry_arrays(jdb, jsnap), device="cpu")
    return jdb, db


#: variable-depth COUNTs: V1's shape (a WHILE gate and a node mask), a
#: maxDepth arm over both directions, and roots spread over several chunks
VAR_COUNTS = [
    "MATCH {class:Person, as:p, where:(uid < 20)}-knows->{as:f, while:($depth < 3), where:(age < 30)} "
    "RETURN count(*) AS n",
    "MATCH {class:Person, as:p, where:(uid < 5)}-knows-{as:f, maxDepth:2} RETURN count(*) AS n",
    "MATCH {class:Person, as:p, where:(age > 70)}-knows->{as:f, while:($depth < 4)} RETURN count(*) AS n",
]


def test_var_depth_count_folds_the_emission_into_the_level_step(monkeypatch):
    """The variable-depth COUNT makes one K12 call a level, with the node
    mask (its emission count comes from that pass), and K11 only for the
    roots' bitmap at depth 0: one a chunk, as many as K9's. On the CPU the
    wrappers run their plain versions, so the calls are counted at the
    wrappers (on a card each call is one launch, `LAUNCHES`). The counts
    equal the reference's ``engine="tpu"`` and oracle counts, recorded and
    replayed."""
    jdb, db = _person_knows_with_records(300, 4, seed=13)
    calls = {"rows_to_bitmap": 0, "bitmap_hop_csr": 0, "bitmap_emit": 0, "frontier_advance": 0, "folded": 0}
    for name in ("rows_to_bitmap", "bitmap_hop_csr", "bitmap_emit", "frontier_advance"):
        def counted(*a, _f=getattr(T, name), _n=name, **kw):
            calls[_n] += 1
            if _n == "frontier_advance" and kw.get("node") is not None:
                calls["folded"] += 1
            return _f(*a, **kw)

        monkeypatch.setattr(T, name, counted)
    for sql in VAR_COUNTS:
        want = jdb.query(sql, engine="tpu", strict=True).to_dicts()
        assert jdb.query(sql, engine="oracle").to_dicts() == want
        assert want[0]["n"] > 0
        for _ in range(2):  # the recording, then a replay
            for k in calls:
                calls[k] = 0
            assert db.query(sql).to_dicts() == want
            assert calls["frontier_advance"] > 0 and calls["folded"] == calls["frontier_advance"]
            hops_a_level = 2 if "-knows-{" in sql else 1
            assert calls["bitmap_hop_csr"] == hops_a_level * calls["frontier_advance"]
            assert calls["bitmap_emit"] == calls["rows_to_bitmap"] > 0


def _bad_calls():
    b2 = torch.zeros((2, 8), dtype=torch.bool)
    i = torch.zeros(4, dtype=torch.int32)
    return {
        "rows_dtype": lambda: T.rows_to_bitmap(i.long(), 8),
        "rows_2d": lambda: T.rows_to_bitmap(i.view(2, 2), 8),
        "hop_1d_frontier": lambda: T.bitmap_hop(i, i, None, b2.view(-1)),
        "hop_lengths": lambda: T.bitmap_hop(i, i[:3], None, b2),
        "hop_gate_width": lambda: T.bitmap_hop(i, i, None, b2, gate=torch.zeros(7, dtype=torch.bool)),
        "hop_alive_dtype": lambda: T.bitmap_hop(i, i, None, b2, alive=torch.zeros((), dtype=torch.int64)),
        "hop_noncontiguous": lambda: T.bitmap_hop(i, i, None, torch.zeros((8, 2), dtype=torch.bool).t()),
        "csr_rows_past_vb": lambda: T.bitmap_hop_csr(torch.zeros(10, dtype=torch.int32), i, None, None, b2),
        "csr_eid_length": lambda: T.bitmap_hop_csr(i[:3], i, i[:2], None, b2),
        "csr_mask_length": lambda: T.bitmap_hop_csr(i[:3], i, None, torch.zeros(3, dtype=torch.bool), b2),
        "csr_indptr_dtype": lambda: T.bitmap_hop_csr(i[:3].long(), i, None, None, b2),
        "emit_node_width": lambda: T.bitmap_emit(b2, torch.zeros(9, dtype=torch.bool)),
        "emit_bound_rows": lambda: T.bitmap_emit(b2, torch.zeros(8, dtype=torch.bool), i),
        "emit_dtype": lambda: T.bitmap_emit(b2.to(torch.uint8), torch.zeros(8, dtype=torch.bool)),
        "advance_shapes": lambda: T.frontier_advance(b2, torch.zeros((2, 4), dtype=torch.bool)),
        "advance_node_width": lambda: T.frontier_advance(b2, b2.clone(), node=torch.zeros(9, dtype=torch.bool)),
        "advance_bound_without_node": lambda: T.frontier_advance(b2, b2.clone(), bound=i[:2]),
        "advance_bound_rows": lambda: T.frontier_advance(b2, b2.clone(), node=torch.zeros(8, dtype=torch.bool), bound=i),
        "advance_bound_dtype": lambda: T.frontier_advance(
            b2, b2.clone(), node=torch.zeros(8, dtype=torch.bool), bound=i[:2].long()
        ),
    }


@pytest.mark.parametrize("name", sorted(_bad_calls()))
def test_bitmap_wrappers_refuse_bad_inputs(name):
    with pytest.raises((TypeError, ValueError)):
        _bad_calls()[name]()
