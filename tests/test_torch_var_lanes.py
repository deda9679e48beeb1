"""The lane axis of variable-depth and NOT groups: the lane forms of K10
(`bitmap_hop_csr_lanes`), K11 (`bitmap_emit_lanes`) and K12
(`frontier_advance_lanes`) over ``[B, C, vb]`` bitmap stacks, the port of
the reference's ``jax.vmap`` of its bitmap BFS inside a group replay
(`orientdb_tpu/exec/tpu_engine.py:3436-3437` over `csr.bitmap_hop`,
`_var_emit_mask` and the level step), on the CPU, where each wrapper runs
its plain version.

The plain lane forms must equal ``jax.vmap`` of the reference's functions
over ``[B, C, vb]`` bitmaps exactly (every value is bool or int32), and the
single forms lane by lane. Then groups of variable-depth and NOT plans
through ``db.query_batch`` on `build_person_knows(20_000, seed=3)`: each
takes the lane axis (``plan.lane_axis``), runs the lane forms, and every
lane equals the port's single query and the reference's ``engine="tpu"``;
a lane whose walk is deeper than the recorded levels re-runs alone. The
kernels themselves run only on a card (`tests/test_torch_kernels.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientdb_tpu.exec.tpu_engine import _var_emit_mask as j_var_emit_mask
from orientdb_tpu.ops import csr as J
from orientdb_tpu_torch.exec import tpu_engine as TE
from orientdb_tpu_torch.exec.result import canonical_rows
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.ops.device_graph import device_graph
from orientdb_tpu_torch.sql.parser import parse
from test_torch_lanes import _LaneSpy, _group, _plans, person_knows  # noqa: F401

I32 = torch.int32
LANES = [8, 16]
C = 4  # frontier rows a lane


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return np.asarray(x)


@pytest.fixture(scope="module")
def knows(person_knows):
    """The knows CSR of the 20,000-person graph (both walks) and the
    out-order edge list the reference hops over, as numpy."""
    _jdb, db, snap = person_knows
    dec = device_graph(snap, db.device).edges["knows"]
    g = {k: getattr(dec, k).numpy() for k in ("indptr_out", "dst", "indptr_in", "src", "edge_id_in", "edge_src")}
    g["vb"] = K.bucket(snap.num_vertices)
    g["age"] = snap.v_columns["age"].values
    return g


def _frontier(rng, B: int, vb: int, v: int) -> np.ndarray:
    """[B, C, vb] frontier rows of a few vertices each; lane 0 is empty."""
    fr = np.zeros((B, C, vb), bool)
    for b in range(1, B):
        for r in range(C):
            fr[b, r, rng.integers(0, v, 1 + r)] = True
    return fr


def _vec(rng, B: int, vb: int, kind: str, p: float):
    """None, a shared [vb] or a lane-stacked [B, vb] bool vector."""
    if kind == "none":
        return None
    if kind == "shared":
        return rng.random(vb) < p
    return rng.random((B, vb)) < p


def _lane(x, b):
    return None if x is None else (x if x.ndim == 1 else x[b])


@pytest.mark.parametrize("B", LANES)
@pytest.mark.parametrize("gate", ["none", "shared", "lanes"])
@pytest.mark.parametrize("walk", ["out", "in"])
def test_bitmap_hop_csr_lanes_equal_vmap(knows, walk, gate, B):
    """K10's lane form over the ``[B, C, vb]`` stack (an out walk, and an in
    walk reading an edge mask through ``edge_id_in``), with no WHILE gate,
    one the lanes share, or one a lane: equals ``jax.vmap`` of the
    reference's `bitmap_hop` over the gated ``[B, C, vb]`` frontier on the
    out-order edge list, and the single form lane by lane; the empty lane
    (alive 0) reaches nothing, and ``out`` ORs."""
    g, vb = knows, knows["vb"]
    rng = np.random.default_rng(B * 7 + len(gate) + (walk == "in"))
    v = g["indptr_out"].shape[0] - 1
    fr = _frontier(rng, B, vb, v)
    gv = _vec(rng, B, vb, gate, 0.6)
    e = g["dst"].shape[0]
    mask = rng.random(e) < 0.7 if walk == "in" else None
    if walk == "out":
        csr, act, emit = (g["indptr_out"], g["dst"], None), g["edge_src"], g["dst"]
    else:
        csr, act, emit = (g["indptr_in"], g["src"], g["edge_id_in"]), g["dst"], g["edge_src"]
    fr_ref = fr if gv is None else fr & (gv[None, None, :] if gv.ndim == 1 else gv[:, None, :])
    m_ref = np.ones(e, bool) if mask is None else mask
    want = _np(jax.vmap(lambda f: J.bitmap_hop(jnp.asarray(act), jnp.asarray(emit), jnp.asarray(m_ref), f))(
        jnp.asarray(fr_ref)
    ))
    ip, nbr, eid = (None if a is None else _t(a) for a in csr)
    stack = _t(fr)
    alive = _t(fr.reshape(B, -1).sum(1).astype(np.int32))
    gate_t = None if gv is None else _t(gv)
    m_t = None if mask is None else _t(mask)
    got = K.bitmap_hop_csr(ip, nbr, eid, m_t, stack, gate_t, alive)
    plain = K.plain_bitmap_hop_csr_lanes(ip, nbr, eid, m_t, stack, gate_t, alive)
    assert got.dtype == torch.bool and got.shape == (B, C, vb)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(plain, got)
    for b in range(B):
        one = K.bitmap_hop_csr(ip, nbr, eid, m_t, stack[b], None if gv is None else _t(_lane(gv, b)), alive[b])
        assert torch.equal(got[b], one), b
    assert not got[0].any() and got[1:].any()
    base = _t(rng.random((B, C, vb)) < 0.001)
    acc = K.bitmap_hop_csr_lanes(ip, nbr, eid, m_t, stack, gate_t, alive, out=base.clone())
    assert torch.equal(acc, base | got)


@pytest.mark.parametrize("B", LANES)
@pytest.mark.parametrize("node", ["shared", "lanes"])
@pytest.mark.parametrize("bound", [False, True], ids=["open", "close"])
def test_bitmap_emit_lanes_equal_vmap(knows, bound, node, B):
    """K11's lane form: the emission bitmap equals ``jax.vmap`` of the
    reference's `_var_emit_mask` (a node mask shared or a lane's, a close
    arm's bound column a row), the per-row any its ``any(axis=1)`` and the
    count each lane's int32 sum; and each lane equals the single form."""
    vb = knows["vb"]
    rng = np.random.default_rng(B + 3 * bound + len(node))
    reached = rng.random((B, C, vb)) < 0.002
    reached[0] = False  # an empty lane
    nd = _vec(rng, B, vb, node, 0.5)
    bd = None
    if bound:
        bd = rng.integers(-2, vb, (B, C)).astype(np.int32)
        for b in range(1, B, 2):  # reached and admitted bound endpoints
            for r in range(C):
                reached[b, r, bd[b, r] % vb] = True
                bd[b, r] %= vb
                if nd.ndim == 1:
                    nd[bd[b, r]] = True
                else:
                    nd[b, bd[b, r]] = True
    node_axis = None if nd.ndim == 1 else 0
    if bd is None:
        want = _np(jax.vmap(lambda r, n: j_var_emit_mask(r, n, None, vb), in_axes=(0, node_axis))(
            jnp.asarray(reached), jnp.asarray(nd)))
    else:
        want = _np(jax.vmap(lambda r, n, x: j_var_emit_mask(r, n, x, vb), in_axes=(0, node_axis, 0))(
            jnp.asarray(reached), jnp.asarray(nd), jnp.asarray(bd)))
    stack = _t(reached)
    bd_t = None if bd is None else _t(bd)
    emit, any_row, count = K.bitmap_emit_lanes(stack, _t(nd), bd_t, emit=True, any_row=True, count=True)
    np.testing.assert_array_equal(emit.numpy(), want)
    np.testing.assert_array_equal(any_row.numpy(), want.any(axis=2))
    assert count.dtype == I32 and count.shape == (B,)
    np.testing.assert_array_equal(count.numpy(), _np(jnp.sum(jnp.asarray(want), axis=(1, 2), dtype=jnp.int32)))
    assert int(count[0]) == 0 and int(count.sum()) > 0
    for b in range(B):
        one = K.bitmap_emit(stack[b], _t(_lane(nd, b)), None if bd is None else bd_t[b],
                            emit=True, any_row=True, count=True)
        assert torch.equal(emit[b], one[0]) and torch.equal(any_row[b], one[1]) and int(count[b]) == int(one[2])
    only = K.bitmap_emit(stack, _t(nd), bd_t, emit=False, count=True)
    assert only[0] is None and only[1] is None and torch.equal(only[2], count)


@pytest.mark.parametrize("B", LANES)
@pytest.mark.parametrize("fold", ["step", "shared_node", "lane_node_bound", "lane_gate"])
def test_frontier_advance_lanes_equal_vmap(knows, fold, B):
    """K12's lane form, in place on the ``[B, C, vb]`` stacks: the new
    frontier and visited set equal ``jax.vmap`` of the reference's level
    step (``nxt & ~visited``, ``visited | nxt``), the alive count each
    lane's `mask_count`, the folded emission count each lane's sum of
    `_var_emit_mask` (a shared or a lane's node mask, a bound column), and
    TRAVERSE's gate (a lane's row) admits first; each lane equals the single
    form, and the empty lane counts 0."""
    vb = knows["vb"]
    rng = np.random.default_rng(B * 5 + len(fold))
    nxt = rng.random((B, C, vb)) < 0.003
    vis = rng.random((B, C, vb)) < 0.002
    nxt[0] = False
    gate = rng.random((B, vb)) < 0.5 if fold == "lane_gate" else None
    nd = {"step": None, "shared_node": rng.random(vb) < 0.5, "lane_node_bound": rng.random((B, vb)) < 0.5,
          "lane_gate": None}[fold]
    bd = rng.integers(-2, vb, (B, C)).astype(np.int32) if fold == "lane_node_bound" else None

    def step(n, v, g):
        n = n & ~v
        if g is not None:
            n = n & g[None, :]
        return n, v | n, J.mask_count(n.reshape(-1))

    new, seen, alive_ref = (_np(x) for x in jax.vmap(step, in_axes=(0, 0, None if gate is None else 0))(
        jnp.asarray(nxt), jnp.asarray(vis), None if gate is None else jnp.asarray(gate)))
    n_t, v_t = _t(nxt), _t(vis)
    n0, v0 = n_t.clone(), v_t.clone()
    got = K.frontier_advance(n_t, v_t, None if gate is None else _t(gate), None if nd is None else _t(nd),
                             None if bd is None else _t(bd))
    np.testing.assert_array_equal(n_t.numpy(), new)
    np.testing.assert_array_equal(v_t.numpy(), seen)
    alive = got if nd is None else got[0]
    assert alive.dtype == I32 and alive.shape == (B,) and int(alive[0]) == 0
    np.testing.assert_array_equal(alive.numpy(), alive_ref)
    if nd is not None:
        axes = (0, None if nd.ndim == 1 else 0) + ((0,) if bd is not None else ())
        ops = (jnp.asarray(new), jnp.asarray(nd)) + ((jnp.asarray(bd),) if bd is not None else ())
        emitted = _np(jax.vmap(lambda r, n, *x: jnp.sum(j_var_emit_mask(r, n, x[0] if x else None, vb), dtype=jnp.int32),
                               in_axes=axes)(*ops))
        np.testing.assert_array_equal(got[1].numpy(), emitted)
    for b in range(B):
        n1, v1 = n0[b].clone(), v0[b].clone()
        one = K.frontier_advance(n1, v1, None if gate is None else _t(gate[b]), None if nd is None else _t(_lane(nd, b)),
                                 None if bd is None else _t(bd[b]))
        assert torch.equal(n1, n_t[b]) and torch.equal(v1, v_t[b])
        one = one if nd is not None else (one,)
        got_b = got if nd is not None else (got,)
        assert all(int(x[b]) == int(y) for x, y in zip(got_b, one))


def test_lane_forms_refuse_mismatched_lanes(knows):
    """The lane forms check their lane operands: a stack that is not [B,
    C, vb], an alive, a gate, a node or a bound of another lane count or
    dtype, and the slab probe with a lane form."""
    vb = knows["vb"]
    ip, nbr = _t(knows["indptr_out"]), _t(knows["dst"])
    fr = torch.zeros((3, C, vb), dtype=torch.bool)
    with pytest.raises(TypeError):
        K.bitmap_hop_csr_lanes(ip, nbr, None, None, fr, None, torch.zeros(5, dtype=I32))
    with pytest.raises(ValueError):
        K.bitmap_hop_csr_lanes(ip, nbr, None, None, fr, torch.zeros((2, vb), dtype=torch.bool), torch.zeros(3, dtype=I32))
    with pytest.raises(TypeError):
        K.bitmap_hop_csr_lanes(ip, nbr, None, None, fr, None, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        K.bitmap_hop_csr_lanes(ip, nbr, None, None, fr.view(3 * C, vb))
    probe = K.SlabIndex(*(torch.zeros(1, dtype=I32) for _ in range(3)), torch.zeros(1, dtype=torch.bool), 0, 1, 1)
    with pytest.raises(ValueError):
        K.bitmap_hop_csr(ip, nbr, None, None, fr, probe=probe)
    with pytest.raises(ValueError):
        K.bitmap_emit_lanes(fr, torch.zeros((4, vb), dtype=torch.bool))
    with pytest.raises(ValueError):
        K.bitmap_emit(fr, torch.zeros(vb, dtype=torch.bool), torch.zeros(3 * C, dtype=I32))
    with pytest.raises(ValueError):
        K.frontier_advance_lanes(fr, fr[:2].clone())
    with pytest.raises(ValueError):
        K.frontier_advance(fr, fr.clone(), node=torch.zeros(vb, dtype=torch.bool), bound=torch.zeros((2, C), dtype=I32))


# ---------------------------------------------------------------------------
# groups through db.query_batch
# ---------------------------------------------------------------------------

ROOT = "MATCH {class:Person, as:p, where:(uid < :k)}"
V2 = ROOT + "-knows-{as:f, maxDepth:2, depthAlias:d} RETURN p.uid AS p, f.uid AS f, d AS d"
V3 = ROOT + "-knows->{as:f}, NOT {as:f}-knows->{where:(age > 70)} RETURN p.uid AS p, f.uid AS f"
VAR_Q = ROOT + "-knows->{as:f, while:($depth < 2)} RETURN count(*) AS n"
WHILE_D = ROOT + "-knows->{as:f, while:($depth < :d)} RETURN p.uid AS p, f.uid AS f"
TARGET_A = ROOT + "-knows->{as:f, maxDepth:2, where:(age < :a)} RETURN p.uid AS p, f.uid AS f"
OPTIONAL = ROOT + "-knows->{as:f, optional:true, while:($depth < 2), where:(age > 85)} RETURN p.uid AS p, f.uid AS f"
CLOSING = ROOT + "-knows->{as:f}, {as:f}-knows->{as:p, while:($depth < 3)} RETURN p.uid AS p, f.uid AS f"
NOT_A = ROOT + "-knows->{as:f}, NOT {as:f}-knows->{where:(age > :a)} RETURN count(*) AS n"

#: name → (statement, parameters of 8 lanes, the lane that finds no root)
GROUPS = {
    "v2": (V2, [{"k": 0 if i == 3 else 16 - i} for i in range(8)], 3),
    "v3_not": (V3, [{"k": 0 if i == 6 else 16 - i} for i in range(8)], 6),
    "var_count": (VAR_Q, [{"k": 0 if i == 2 else 30 - 2 * i} for i in range(8)], 2),
    "while_param": (WHILE_D, [{"k": 0 if i == 5 else 12 - i, "d": 3 - i % 3} for i in range(8)], 5),
    "target_param": (TARGET_A, [{"k": 0 if i == 1 else 14 - i, "a": 60 - 5 * i} for i in range(8)], 1),
    "optional": (OPTIONAL, [{"k": 0 if i == 4 else 16 - i} for i in range(8)], 4),
    "closing": (CLOSING, [{"k": 0 if i == 7 else 8 - i % 4} for i in range(8)], 7),
    "not_param_count": (NOT_A, [{"k": 0 if i == 0 else 12 - i, "a": 80 - 4 * i} for i in range(8)], 0),
}
#: lane-form calls a group replay makes at least: (K10, K11, K12)
BITMAP_FORMS = ("bitmap_hop_csr_lanes", "bitmap_emit_lanes", "frontier_advance_lanes")


@pytest.mark.parametrize("name", list(GROUPS))
def test_var_and_not_groups_run_on_the_lane_axis(monkeypatch, person_knows, name):
    """Groups of variable-depth and NOT plans: V2's shape (both directions,
    a depth alias), V3's NOT anti-join, `VAR_Q`'s variable-depth COUNT, a
    WHILE that reads ``:d``, a target WHERE that reads ``:a``, an OPTIONAL
    variable-depth arm, a closing one, and a COUNT whose NOT arm reads
    ``:a``: each takes the lane axis, every lane equals the reference's
    ``engine="tpu"`` and the port's single query, one lane finds no root,
    and one group replay runs the bitmap BFS through the lane forms (the
    level steps of a rows plan through K12's, the COUNT's folded into
    K12's, a NOT arm's hop through K10's and its last step through K11's)
    after K15's lane form for the root."""
    jdb, db, snap = person_knows
    sql, plist, empty = GROUPS[name]
    want = [jdb.query(sql, p, engine="tpu", strict=True).to_dicts() for p in plist]
    none = ([], [{"n": 0}])
    assert want[empty] in none and sum(w not in none for w in want) >= 5
    calls = _group(monkeypatch, db, snap, sql, plist, want)
    assert calls["predicate_eval_lanes"] >= 1
    not_arm = name.startswith(("v3", "not"))
    assert calls["bitmap_hop_csr_lanes"] >= (1 if not_arm else 2)
    assert calls["bitmap_emit_lanes"] >= 1
    assert calls["frontier_advance_lanes"] == 0 if not_arm else calls["frontier_advance_lanes"] >= 2
    if name in ("while_param", "target_param", "not_param_count"):
        # the WHILE gate, the target mask, the NOT arm's mask: [B, vb] rows
        assert calls["predicate_eval_lanes"] >= 2


def test_plans_the_lane_axis_refuses_say_so(monkeypatch):
    """A variable-depth arm whose edge WHERE reads a parameter (a [B, E]
    edge mask, which K10's lane form does not take) keeps the group lane
    after lane, said through ``plan.lane_axis``, and every lane still
    equals the reference's ``engine="tpu"`` (on a record-backed graph whose
    knows edges carry ``creationDate``)."""
    from test_torch_lanes import _e_record_graph

    jdb, db, snap = _e_record_graph()
    sql = ROOT + "-knows{where:(creationDate > :d)}->{as:f, maxDepth:2} RETURN p.uid AS p, f.uid AS f"
    plist = [{"k": 40 - 3 * i, "d": 1_000 * i} for i in range(8)]
    want = [jdb.query(sql, p, engine="tpu", strict=True).to_dicts() for p in plist]
    assert all(want) and len(want[0]) != len(want[1])
    calls = _group(monkeypatch, db, snap, sql, plist, want, lane_axis=False)
    assert not any(calls[n] for n in BITMAP_FORMS)


def test_lane_deeper_than_the_recorded_pad_reruns_alone(monkeypatch, person_knows):
    """``while:($depth < :d)`` recorded at d = 1 (its level loop: one live
    hop and the pad's empty levels), then a batch of 8 whose lane 5 walks d
    = 6: the group runs on the lane axis, the post-loop observe raises only
    lane 5's overflow (each lane's alive count is its own), lane 5 re-records
    alone into a second variant, and every lane equals the reference."""
    jdb, db, snap = person_knows
    sql = WHILE_D
    plist = [{"k": 12 - (i % 3), "d": 6 if i == 5 else 1} for i in range(8)]
    want = [jdb.query(sql, p, engine="tpu", strict=True).to_dicts() for p in plist]
    assert len(want[5]) > 3 * len(want[4])
    TE._plan_cache(snap).clear()
    db.query(sql, plist[0]).to_dicts()
    (first,) = _plans(snap, sql)
    spy = _LaneSpy(monkeypatch)
    got = [rs.to_dicts() for rs in db.query_batch([sql] * 8, plist)]
    monkeypatch.undo()
    for i, rows in enumerate(got):
        assert canonical_rows(rows) == canonical_rows(want[i]), i
    assert first.lane_axis and first.group_replays == 1
    assert spy.calls["frontier_advance_lanes"] >= 1 and spy.calls["bitmap_hop_csr_lanes"] >= 1
    (v,) = [v for k, v in TE._plan_cache(snap).items() if k[0] == parse(sql)]
    assert len(v.plans) == 2 and v.plans[1] is first and v.pick(plist[5]) is v.plans[0]
    assert all(v.pick(p) is first for i, p in enumerate(plist) if i != 5)
    TE._plan_cache(snap).clear()


def test_chip_smoke_bitmap_lane_checks_run_on_the_cpu(person_knows):
    """The card run's checks of the bitmap lane forms, on the CPU where both
    sides are plain versions: one eager run of BV2's and BV3's group bodies
    (V2 × 8 and V3 × 8) records the lane forms' calls on copies of the
    bitmaps they write, each equal to its plain version and, lane by lane,
    to the single form's call on the lane's rows, with a bound, and K11's
    and K12's yardstick counting each lane's bitmap. K10's bound charges a
    zeroed output whole and an ORed-into one only the 1s the hop stores,
    and a dead lane (alive 0) only its share of the zeroed output."""
    import chip_smoke

    _jdb, db, snap = person_knows
    for sql, forms in ((chip_smoke.V2, chip_smoke.BITMAP_LANE_FORMS),
                       (chip_smoke.V3, ("bitmap_hop_csr_lanes", "bitmap_emit_lanes"))):
        plist = [{"k": k} for k in range(9, 17)]
        for _ in range(2):
            db.query_batch([sql] * 8, plist)
        (plan,) = [p for p in _plans(snap, sql) if p.group_replays and p.lane_axis]
        stack = torch.from_numpy(np.stack([plan._dyn_args(p) for p in plist]))
        calls = chip_smoke.lane_calls(torch, K, plan, stack, forms=forms)
        assert {name for name, _a, _kw in calls} == set(forms)
        assert all(n <= chip_smoke.BITMAP_LANE_CALLS for n in
                   (sum(c[0] == f for c in calls) for f in forms))
        for name, a, kw in calls:
            got = chip_smoke._lane_run(K, name, a, kw)
            assert chip_smoke._lane_equal(torch, got, chip_smoke._lane_plain(K, name, a, kw)), name
            for b in range(8):
                assert chip_smoke._lane_equal(
                    torch, chip_smoke._lane_of(got, b), chip_smoke._lane_single(K, name, a, kw, b)
                ), (name, b)
            nbytes, ops, _sectors = chip_smoke._lane_bound(torch, name, a, kw)
            assert nbytes >= a[0].numel() and ops == 0
            lib = chip_smoke._lane_library(torch, name, a)
            if name != "bitmap_hop_csr_lanes":
                assert torch.equal(lib(), a[0].view(8, -1).sum(1))
                continue
            fr, alive = a[4], a[6]
            vb = fr.shape[-1]
            if a[3] is None and a[5] is None:  # no edge mask, no gate: counts, not bits
                assert torch.equal(lib().t() > 0, K.plain_bitmap_hop_csr_lanes(*a[:5]).view(-1, vb))
            ones = int(K.plain_bitmap_hop_csr_lanes(*a[:7]).sum())
            zeroed = chip_smoke._lane_bound(torch, name, a[:7], kw)[0]
            ored = chip_smoke._lane_bound(torch, name, (*a[:7], torch.zeros_like(fr)), kw)[0]
            assert ones > 0 and zeroed - fr.numel() == ored - ones
            if alive is not None:
                dead = torch.zeros_like(alive)
                assert chip_smoke._lane_bound(torch, name, (*a[:6], dead), kw)[0] == fr.numel()
                assert chip_smoke._lane_bound(torch, name, (*a[:6], dead, torch.zeros_like(fr)), kw)[0] == 0
        total = [0.0]
        chip_smoke.lane_calls(torch, K, plan, stack, at_call=lambda n, a, kw: total.__setitem__(
            0, total[0] + chip_smoke._lane_bound(torch, n, a, kw)[0]))
        assert total[0] > 0
    # the group bound's pass over a group with an OPTIONAL arm's left join
    # (K13's lane form, which adds into its counts: its first three arguments)
    sql = "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f, optional:true, where:(age > 75)} RETURN p.uid AS p, f.uid AS f"
    plist = [{"k": 40 - i} for i in range(8)]
    for _ in range(2):
        db.query_batch([sql] * 8, plist)
    (plan,) = [p for p in _plans(snap, sql) if p.group_replays and p.lane_axis]
    stack = torch.from_numpy(np.stack([plan._dyn_args(p) for p in plist]))
    seen = []
    chip_smoke.lane_calls(torch, K, plan, stack, at_call=lambda n, a, kw: seen.append(
        (n, chip_smoke._lane_bound(torch, n, a, kw)[0])))
    assert any(n == "rows_with_matches_lanes" and b > 0 for n, b in seen)
