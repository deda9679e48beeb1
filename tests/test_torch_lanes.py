"""The lane axis of a count group: the lane forms of K15 (`predicate_eval`
with a ``[B, P]`` parameter stack), K5a (`weight_gather` with lane-stacked
masks or weights), K4 (`indptr_segment_sum` over ``[B, E]`` values) and K5b
(`mask_count` of ``[B, n]`` masks), and the group replays that run on them
(`TpuMatchSolver.lane_route`, the port of the reference's ``jax.vmap`` of
its replay at `orientdb_tpu/exec/tpu_engine.py:3436-3437`), on the CPU;
then a rows group's lane forms, and past the root K15's stacked form
(`predicate_eval` over lane-stacked ids) and K13's lane form
(`rows_with_matches` of ``[B, W]`` rows) with the E2-, E4-, E5- and
E2b-shaped groups that run on them.

On the CPU each wrapper runs its plain version. A lane form's result must
equal its lanes computed one by one: by the single-lane wrapper, and by the
reference's function (its weight chain, `indptr_segment_sum`,
`mask_count`) a lane, exactly for int32 and bool and bit for bit for
float32 (each lane's arithmetic is the single lane's, in its order). The
kernels themselves run only on a card (`tests/test_torch_kernels.py`).
Then count groups through ``db.query_batch``: every lane equals the port's
single query and the reference's ``engine="tpu"`` (and on a graph with
records its ``engine="oracle"``), and the plans that should take the lane
axis do, while a rows group stays lane after lane."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientdb_tpu.models.database import Database as JDatabase
from orientdb_tpu.ops import csr as J
from orientdb_tpu.storage.bigshape import build_person_knows as j_build_person_knows
from orientdb_tpu.storage.bigshape import build_snb_shape as j_build_snb_shape
from orientdb_tpu.storage.snapshot import attach_fresh_snapshot
from orientdb_tpu_torch.carry import snapshot_from_arrays
from orientdb_tpu_torch.exec import tpu_engine as TE
from orientdb_tpu_torch.exec.result import canonical_rows
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.ops.predicates import ColumnScope, ParamBox, compile_predicate
from orientdb_tpu_torch.sql.parser import Parser, parse
from orientdb_tpu_torch.storage.bigshape import (
    build_person_knows,
    build_snb_shape,
    numpy_config5_count,
    numpy_incident_rows,
    numpy_optional_rows,
    numpy_out_edge_rows,
    numpy_probe_rows,
)
from test_torch_match import _carry_arrays
from test_torch_weight_gather import _jax_chain, _operands, _same_bits, _t

I32 = torch.int32
F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stacked(rows, dtype):
    return _t(np.stack(rows).astype(dtype))


# ---------------------------------------------------------------------------
# the lane forms against their lanes one by one
# ---------------------------------------------------------------------------

LANES = [1, 3, 16]


@pytest.mark.parametrize("B", LANES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["i32", "f32"])
@pytest.mark.parametrize("walk", ["out", "in"])
@pytest.mark.parametrize("stacked", ["ok", "node_ok", "emask", "w", "all"])
def test_weight_gather_lanes_equal_each_lane(stacked, walk, dtype, B):
    """Each of ``ok``, ``node_ok``, ``emask`` and ``w`` lane-stacked in turn
    (and all of them), the others shared, on an out walk and an in walk
    (the edge mask through eid): lane b equals the single-lane wrapper and
    the reference's chain on lane b's operands. Lane 0 keeps nothing (an
    empty lane); the last lane repeats the one before it (a padded lane)."""
    rng = np.random.default_rng(zlib.crc32(f"{stacked} {walk} {np.dtype(dtype).name} {B}".encode()))
    vb, e = 64, 700
    emit, ok, emask, eid, w = _operands(rng, vb, e, dtype)
    node_ok = rng.random(e) < 0.5
    shared = dict(ok=ok, node_ok=node_ok, emask=emask, w=w)
    lanes = []
    for b in range(B):
        _e, ok_b, em_b, _i, w_b = _operands(rng, vb, e, dtype)
        lane = dict(ok=ok_b, node_ok=rng.random(e) < 0.5, emask=em_b, w=w_b)
        if b == 0:
            lane = {k: np.zeros_like(v) for k, v in lane.items()}
        if b == B - 1 and B > 1:
            lane = lanes[-1]
        lanes.append(lane)
    names = ("ok", "node_ok", "emask", "w") if stacked == "all" else (stacked,)
    # E >= vb reads ok through emit; node_ok stands for it where E < vb
    use_ok = stacked != "node_ok"
    kw, per_lane = {}, [{} for _ in range(B)]
    for k in ("ok", "node_ok", "emask", "w"):
        if (k == "ok" and not use_ok) or (k == "node_ok" and use_ok and stacked != "all"):
            continue
        if k in names:
            kw[k] = _stacked([lane[k] for lane in lanes], shared[k].dtype)
            for b in range(B):
                per_lane[b][k] = lanes[b][k]
        else:
            kw[k] = _t(shared[k])
            for b in range(B):
                per_lane[b][k] = shared[k]
    if walk == "in":
        kw["eid"] = _t(eid)
    tdtype = I32 if dtype == np.int32 else F32
    got = K.weight_gather(_t(emit), tdtype, **kw)
    assert got.shape == (B, e)
    plain = K.plain_weight_gather_lanes(_t(emit), tdtype, **kw)
    for b in range(B):
        one = {k: _t(v) for k, v in per_lane[b].items()}
        if walk == "in":
            one["eid"] = _t(eid)
        single = K.weight_gather(_t(emit), tdtype, **one)
        assert torch.equal(got[b].view(I32), single.view(I32))
        assert torch.equal(plain[b].view(I32), single.view(I32))
        ref = dict(per_lane[b], eid=eid if walk == "in" else None)
        _same_bits(got[b], _jax_chain(emit, dtype, **ref))
    if B > 1:
        assert torch.equal(got[-1], got[-2])
    if stacked == "all":
        assert not got[0].any()


@pytest.mark.parametrize("B", LANES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["i32", "f32"])
def test_folded_weights_lanes_equal_each_lane(dtype, B):
    """The fold (no emit: ``ok ? w : 0`` over [vb]) with a lane-stacked
    mask and shared weights, then with both lane-stacked."""
    rng = np.random.default_rng(B * 7 + (dtype == np.int32))
    vb = 256
    _e, ok, _m, _i, w = _operands(rng, vb, 8, dtype)
    oks = [rng.random(vb) < 0.4 for _ in range(B)]
    ws = [_operands(rng, vb, 8, dtype)[4] for _ in range(B)]
    tdtype = I32 if dtype == np.int32 else F32
    for wk in (_t(w), _stacked(ws, dtype)):
        got = K.weight_gather(None, tdtype, ok=_stacked(oks, bool), w=wk)
        for b in range(B):
            wb = w if wk.dim() == 1 else ws[b]
            _same_bits(got[b], _jax_chain(np.arange(vb, dtype=np.int32), dtype, ok=oks[b], w=wb))


def _zipf_indptr(rng, v: int):
    deg = np.minimum(rng.zipf(1.5, v), 500)
    deg[rng.random(v) < 0.3] = 0  # runs of empty segments
    return np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)


@pytest.mark.parametrize("B", LANES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["i32", "f32"])
@pytest.mark.parametrize("v", [1, 300, 6000])
def test_segment_sum_lanes_equal_each_lane(v, dtype, B):
    """B lanes of values over one Zipf-degree indptr (empty segments, long
    ones), out cut short and padded: lane b equals the single-lane wrapper
    (bit for bit); int32 equals the reference's `indptr_segment_sum`
    exactly, float32 the float64 segment sums to rtol 1e-6 (the port's
    plain version rounds a float64 scan once; the reference's float32 scan
    and difference loses up to 1e-3 relative at these sizes, so it is no
    yardstick for float32). A lane of zeros sums to zeros."""
    rng = np.random.default_rng(v * 31 + B)
    indptr = _zipf_indptr(rng, v)
    ne = int(indptr[-1])
    if dtype == np.int32:
        vals = [rng.integers(-(2**30), 2**30, ne, dtype=np.int32) for _ in range(B)]
    else:
        vals = [(rng.random(ne) * 100).astype(np.float32) for _ in range(B)]
    vals[0][:] = 0
    for out_size in (v, max(v - 7, 0), v + 40):
        got = K.indptr_segment_sum(_stacked(vals, dtype), _t(indptr), out_size)
        assert got.shape == (B, out_size)
        for b in range(B):
            single = K.indptr_segment_sum(_t(vals[b]), _t(indptr), out_size)
            assert torch.equal(got[b].view(I32), single.view(I32))
            if dtype == np.int32:
                want = J.indptr_segment_sum(jnp.asarray(vals[b]), jnp.asarray(indptr), out_size)
                assert np.array_equal(got[b].numpy(), np.asarray(want))
            else:
                tot = np.concatenate([[0.0], np.cumsum(vals[b].astype(np.float64))])
                nseg = min(v, out_size)
                want = np.zeros(out_size)
                want[:nseg] = tot[indptr[1 : nseg + 1]] - tot[indptr[:nseg]]
                np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-6, atol=1e-9)
        assert not got[0].any()


@pytest.mark.parametrize("B", LANES + [0])
@pytest.mark.parametrize("n", [0, 5, 16_400])
def test_mask_count_lanes_equal_each_lane(n, B):
    """[B, n] masks (an all-False lane, an all-True lane) counted a lane:
    the single-lane wrapper and the reference's `mask_count`."""
    rng = np.random.default_rng(n + B)
    rows = [rng.random(n) < 0.3 for _ in range(B)]
    if B:
        rows[0][:] = False
        rows[-1][:] = True
    mask = _stacked(rows, bool) if B else torch.zeros((0, n), dtype=torch.bool)
    got = K.mask_count(mask)
    assert got.dtype == I32 and got.shape == (B,)
    for b in range(B):
        assert int(got[b]) == int(K.mask_count(_t(rows[b]))) == int(J.mask_count(jnp.asarray(rows[b])))


# ---------------------------------------------------------------------------
# the rows group's lane forms against the reference under jax.vmap
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _rows_csr(rng, v: int = 300, avg: float = 4.0):
    deg = rng.poisson(avg, v).astype(np.int64)
    deg[-7:] = 0  # a zero-degree tail
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nbrs = rng.integers(0, v, int(deg.sum()), dtype=np.int32)
    return indptr, nbrs


def _lane_rows(rng, B: int, k: int, v: int):
    """B lanes of k sources: lane 0 empty (all -1), lane 1 every vertex's
    hub run (its total past the caps below), the last lane repeating the
    one before it (a padding lane)."""
    rows = [rng.integers(-1, v, k, dtype=np.int32) for _ in range(B)]
    rows[0][:] = -1
    if B > 2:
        rows[1] = np.resize(np.arange(v - 20, v, dtype=np.int32), k)
        rows[1][: k // 2] = rng.integers(0, v, k // 2, dtype=np.int32)
    if B > 1:
        rows[-1] = rows[-2].copy()
    return np.stack(rows)


@pytest.mark.parametrize("B", LANES)
@pytest.mark.parametrize("n", [0, 7, 5_000, 16_400])
def test_compact_and_scan_lanes_equal_vmap(n, B):
    """K3's lane form over a [B, n] mask (an empty lane, a full lane whose
    count passes every cap but the last, a padding lane) equals
    ``jax.vmap`` of the reference's `compact_indices` and each lane through
    the single wrapper, exactly, -1 padding included; K1's lane form the
    vmapped `value_cumsum`."""
    rng = np.random.default_rng(n * 3 + B)
    rows = [rng.random(n) < 0.3 for _ in range(B)]
    rows[0][:] = False
    if B > 2:
        rows[1][:] = True
    if B > 1:
        rows[-1] = rows[-2].copy()
    m = np.stack(rows) if n else np.zeros((B, 0), bool)
    for cap in sorted({8, K.bucket(max(n // 4, 1)), K.bucket(max(n, 1))}):
        got = K.compact_indices(_t(m), cap)
        assert got.dtype == I32 and got.shape == (B, cap)
        want = _np(jax.vmap(lambda x, c=cap: J.compact_indices(x, c))(jnp.asarray(m)))
        np.testing.assert_array_equal(got.numpy(), want)
        for b in range(B):
            assert torch.equal(got[b], K.compact_indices(_t(m[b]), cap))
    if n:
        vals = m.astype(np.int32)
        got = K.value_cumsum(_t(vals))
        np.testing.assert_array_equal(got.numpy(), _np(jax.vmap(J.value_cumsum)(jnp.asarray(vals))))


@pytest.mark.parametrize("B", LANES)
@pytest.mark.parametrize("k", [1, 64, 3_000])
@pytest.mark.parametrize("walk", ["out", "in"])
def test_expand_lanes_equal_vmap(walk, k, B):
    """K2's lane form (offsets, totals) equals ``jax.vmap`` of the
    reference's `degree_counts` → `exclusive_cumsum` and sum, and K2b's
    ``jax.vmap`` of its `gather_expand` (an in walk's edge position through
    `take_pad` of ``edge_id_in``), into a bucket over every lane, one that
    fits the largest lane exactly and one that a lane's total exceeds:
    exactly, padding included, and each lane equals the single wrapper."""
    rng = np.random.default_rng(k + 7 * B + (walk == "in"))
    v = 300
    indptr, nbrs = _rows_csr(rng, v)
    emap = rng.permutation(nbrs.shape[0]).astype(np.int32)
    srcs = _lane_rows(rng, B, k, v)
    counts = jax.vmap(J.degree_counts, in_axes=(None, 0))(jnp.asarray(indptr), jnp.asarray(srcs))
    want_off = _np(jax.vmap(J.exclusive_cumsum)(counts))
    want_tot = _np(jnp.sum(counts, axis=1, dtype=jnp.int32))
    offsets, total = K.expand_offsets(_t(indptr), _t(srcs))
    assert offsets.shape == (B, k) and total.shape == (B,)
    np.testing.assert_array_equal(offsets.numpy(), want_off)
    np.testing.assert_array_equal(total.numpy(), want_tot)
    most = int(want_tot.max())
    if B > 2 and k > 8:
        assert most > 8  # lane 1's total passes the smallest bucket
    edge_map = _t(emap) if walk == "in" else None
    for size in sorted({8, max(most, 1), K.bucket(max(most, 1)) * 2}):
        got = K.gather_expand(_t(indptr), _t(nbrs), _t(srcs), offsets, total, size, edge_map)
        ref = jax.vmap(
            lambda s, o, t, c=size: J.gather_expand(jnp.asarray(indptr), jnp.asarray(nbrs), s, o, t, c)
        )(jnp.asarray(srcs), jnp.asarray(want_off), jnp.asarray(want_tot))
        ref = [_np(r) for r in ref]
        if walk == "in":
            ref[1] = _np(jax.vmap(J.take_pad, in_axes=(None, 0, None))(jnp.asarray(emap), jnp.asarray(ref[1]), -1))
        for g, w in zip(got, ref):
            assert g.shape == (B, size)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"size={size}")
        for b in range(B):
            one = K.gather_expand(_t(indptr), _t(nbrs), _t(srcs[b]), offsets[b], total[b], size, edge_map)
            for g, w in zip(got, one):
                assert torch.equal(g[b], w)


@pytest.mark.parametrize("B", LANES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.bool_], ids=["i32", "f32", "b8"])
def test_take_pad_lanes_equal_vmap(dtype, B):
    """`take_pad` of lane-local [B, m] rows (-1 padding, past-the-end
    indices) from a lane-stacked [B, n] table (K5's lane stride) and from a
    shared table (the flattened index) equals ``jax.vmap`` of the
    reference's `take_pad`, exactly."""
    rng = np.random.default_rng(B + 5)
    n, m = 50, 37
    if dtype == np.int32:
        vals, fill = rng.integers(-(2**20), 2**20, (B, n), dtype=np.int32), -1
    elif dtype == np.float32:
        vals, fill = rng.random((B, n), dtype=np.float32), 0.0
    else:
        vals, fill = rng.random((B, n)) < 0.5, False
    idx = rng.integers(-2, n + 3, (B, m), dtype=np.int32)
    idx[0] = -1  # an empty lane
    got = K.take_pad(_t(vals), _t(idx), fill)
    want = _np(jax.vmap(J.take_pad, in_axes=(0, 0, None))(jnp.asarray(vals), jnp.asarray(idx), fill))
    assert got.shape == (B, m)
    np.testing.assert_array_equal(got.numpy(), want)
    shared = K.take_pad(_t(vals[0]), _t(idx), fill)
    want = _np(jax.vmap(J.take_pad, in_axes=(None, 0, None))(jnp.asarray(vals[0]), jnp.asarray(idx), fill))
    np.testing.assert_array_equal(shared.numpy(), want)


@pytest.mark.parametrize("B", LANES)
@pytest.mark.parametrize("direct", [False, True])
def test_front_pack_and_meta_lanes_equal_reference(direct, B):
    """K6's and K7's lane forms equal the reference's front-pack of
    `_CompiledPlan._replay_core` (``compact_indices`` of the valid mask,
    then ``take_pad`` of each column) and its `_fits16_flag` with the meta
    row, one lane at a time: an empty lane, a full lane, a lane with a
    value past int16 among its live rows and one past it only in a dead
    slot, a padding lane; into a [B, W, C] stack and into a direct-fetch
    stack's rows."""
    from orientdb_tpu.exec.tpu_engine import _CompiledPlan as JPlan

    rng = np.random.default_rng(B * 11 + direct)
    W, C = 64, 3
    valid = (rng.random((B, W)) < 0.4).astype(np.int32)
    cols = [rng.integers(-30_000, 30_000, (B, W), dtype=np.int32) for _ in range(C)]
    valid[0] = 0
    if B > 2:
        valid[1] = 1
        j = int(np.flatnonzero(valid[2])[0]) if valid[2].any() else 0
        valid[2, j] = 1
        cols[1][2, j] = 40_000
    if B > 3:
        valid[3, 0] = 0
        cols[0][3, 0] = -50_000  # past int16 in a dead slot only
    if B > 1:
        valid[-1] = valid[-2]
        for c in cols:
            c[-1] = c[-2]
    count = valid.sum(axis=1).astype(np.int32)
    flag = rng.integers(0, 2, B).astype(np.int32)
    if direct:
        buf = torch.full((B, W * C + 3), 7, dtype=I32)
        data = K.front_pack(_t(valid), [_t(c) for c in cols], out=buf[:, : W * C].view(B, W, C))
        meta = K.replay_meta(data, _t(count), _t(flag), out=buf[:, W * C :])
    else:
        data = K.front_pack(_t(valid), [_t(c) for c in cols])
        meta = K.replay_meta(data, _t(count), _t(flag))
    assert data.shape == (B, W, C) and meta.shape == (B, 3)
    for b in range(B):
        perm = J.compact_indices(jnp.asarray(valid[b] != 0), W)
        ref = jnp.stack([J.take_pad(jnp.asarray(c[b]), perm, -1) for c in cols])
        np.testing.assert_array_equal(data[b].numpy(), _np(ref).T)
        fits = int(JPlan._fits16_flag(ref, jnp.int32(count[b]), W))
        assert meta[b].tolist() == [int(count[b]), int(flag[b]), fits]
        one = K.front_pack(_t(valid[b]), [_t(c[b]) for c in cols])
        assert torch.equal(data[b], one) and torch.equal(meta[b], K.replay_meta(one, torch.tensor(count[b]), torch.tensor(flag[b])))
    if B > 3:
        assert meta[2, 2] == 0 and meta[3, 2] == 1


def _person_columns(n: int, seed: int):
    """A small vertex universe's device columns (CPU): age with absent
    cells, float lat / lng, and the scope predicates compile against."""
    db, snap = build_person_knows(n, seed=seed, geo=True, device="cpu")
    dg = TE.device_graph(snap, db.device)
    return db, snap, dg


WHERES = [
    ("age > :a AND age < :b", lambda b: {"a": 20 + 3 * b, "b": 60 - b}),
    ("distance(lat, lng, :x, :y) < :r", lambda b: {"x": 48.0, "y": 2.0, "r": 200.0 + 900.0 * b}),
    ("uid < :k OR age = :a", lambda b: {"k": 10 * b, "a": 30 + b}),
]


@pytest.mark.parametrize("B", LANES)
@pytest.mark.parametrize("mode", ["identity", "ids"])
@pytest.mark.parametrize("where", range(len(WHERES)))
def test_predicate_eval_lanes_equal_each_row(where, mode, B):
    """One compiled WHERE over the slots against a [B, P] parameter stack:
    row b equals the program run on parameter row b alone (the single-lane
    wrapper), in identity mode (slots past n_valid padding) and over an id
    array with -1 and repeated ids. Lane 0's parameters match nothing (an
    empty lane: the range is empty or r = 0), the last lane repeats the
    one before it (a padded lane)."""
    text, values = WHERES[where]
    _db, snap, dg = _person_columns(3_000, seed=where)
    params = [values(b) for b in range(B)]
    if where == 0:
        params[0] = {"a": 50, "b": 40}
    elif where == 1:
        params[0] = dict(params[0], r=0.0)
    else:
        params[0] = {"k": 0, "a": -5}
    if B > 1:
        params[-1] = params[-2]
    box = ParamBox(params[0])
    scope = ColumnScope(dg.columns, dg.non_columnar, device=dg.device)
    pred = compile_predicate(Parser(text).parse_expression(), scope, box)
    assert pred.uses_params and pred.lane_ok
    stack = torch.from_numpy(np.stack([TE.pack_params(p, box.used) for p in params]))
    rng = np.random.default_rng(where)
    ids = _t(rng.integers(-1, snap.num_vertices, 5_000, dtype=np.int32))

    def run(row):
        box.set_row(row)
        try:
            if mode == "ids":
                return pred(ids)
            return pred.identity(4_096, snap.num_vertices - 100)
        finally:
            box.reset()

    got = run(stack)
    assert got.dtype == torch.bool and got.shape[0] == B
    for b in range(B):
        assert torch.equal(got[b], run(stack[b]))
    assert not got[0].any()
    if B > 1:
        assert torch.equal(got[-1], got[-2])


STACKED = {
    "where": ("age > :a AND age < :b", {}),
    "binding": ("age < p.age + :a OR uid = :b", {}),
    "split": ("(age > :a OR uid < 7) AND (age < :b OR uid > 2900) AND lat > 10.0 AND lng < 25.0 "
              "AND age < p.age + 40", dict(max_stack=3, max_bufs=4)),
}


@pytest.mark.parametrize("B", LANES)
@pytest.mark.parametrize("mode", ["identity", "ids"])
@pytest.mark.parametrize("program", list(STACKED))
def test_predicate_eval_stacked_equals_each_lane(program, mode, B):
    """K15's stacked form: a WHERE that reads parameters over lane-stacked
    ids (each lane its own, -1 and past-end entries) or each lane's identity
    slots, with lane-stacked binding rows, split into launches whose [B, n]
    values the next reads: every launch's lane b equals the single-lane
    plain version on lane b's ids, binding rows, earlier values and
    parameter row, exactly; over ids the `Predicate` (the engine's path)
    gives the last launch's mask. Lane 0's ids are all padding (an empty
    lane), the last lane repeats the one before it."""
    text, kw = STACKED[program]
    _db, snap, dg = _person_columns(3_000, seed=B)
    V = snap.num_vertices
    params = [{"a": 20 + 3 * b, "b": 60 - b} for b in range(B)]
    box = ParamBox(params[0])
    scope = ColumnScope(
        dg.columns, dg.non_columnar, device=dg.device, binding_columns=dg.columns, visible_aliases={"p"}
    )
    from orientdb_tpu_torch.ops.predicates import Predicate, compile_where

    pred = Predicate([compile_where(Parser(text).parse_expression(), scope, box)], dg.device, box,
                     uses_bindings=scope.uses_bindings, **kw)
    assert pred.uses_params and (len(pred.programs) > 1) == (program == "split")
    rng = np.random.default_rng(B * 3 + (mode == "ids"))
    n = 2_000
    ids = rng.integers(-1, V + 3, (B, n), dtype=np.int32)
    rows = rng.integers(-1, V + 2, (B, n), dtype=np.int32)
    ids[0] = -1
    if B > 1:
        ids[-1], rows[-1], params[-1] = ids[-2], rows[-2], params[-2]
    stack = torch.from_numpy(np.stack([TE.pack_params(p, box.used) for p in params]))
    env = {"bindings": {"p": _t(rows)}}
    a = (_t(ids), n, n, 0) if mode == "ids" else (None, n, V - 100, 7)
    tmps, singles = [], [[] for _ in range(B)]
    for prog in pred.programs:
        got = K.predicate_eval_stacked(prog.prog, prog.buffers(env, tmps, n), *a, 0, stack, values=True)
        assert got[1].shape == (B, n) and got[1].dtype == torch.bool
        for b in range(B):
            a_b = (_t(ids[b]), n, n, 0) if mode == "ids" else a
            bufs = prog.buffers({"bindings": {"p": _t(rows[b])}}, singles[b], n)
            one = K.plain_predicate_eval(prog.prog, bufs, *a_b, 0, stack[b], values=True)
            assert torch.equal(got[0][b], one[0]) and torch.equal(got[1][b], one[1]), b
            singles[b].append(one)
        tmps.append(got)
    if mode == "ids":
        box.set_row(stack)
        try:
            mask = pred(_t(ids), env)
        finally:
            box.reset()
        assert torch.equal(mask, tmps[-1][1])
        assert not mask[0].any() and (B == 1 or mask[1:].any())


def test_shared_binding_mask_runs_once_flattened(monkeypatch):
    """A binding-reading mask that reads no parameter, over lane-stacked
    ids with lane-stacked binding rows: one single-form launch over the
    flattened [B·n] ids and rows, equal to each lane's own launch; a split
    program too (its values stay flattened from launch to launch)."""
    _db, snap, dg = _person_columns(3_000, seed=5)
    scope = ColumnScope(
        dg.columns, dg.non_columnar, device=dg.device, binding_columns=dg.columns, visible_aliases={"p"}
    )
    from orientdb_tpu_torch.ops.predicates import Predicate, compile_where

    text = "age < p.age AND (uid > 5 OR lat > p.lat) AND lng < 25.0"
    rng = np.random.default_rng(5)
    ids = _t(rng.integers(-1, snap.num_vertices, (4, 900), dtype=np.int32))
    rows = _t(rng.integers(-1, snap.num_vertices, (4, 900), dtype=np.int32))
    for kw in ({}, dict(max_stack=3, max_bufs=4)):
        pred = Predicate([compile_where(Parser(text).parse_expression(), scope, {})], dg.device,
                         uses_bindings=True, **kw)
        seen = []
        monkeypatch.setattr(K, "predicate_eval_stacked", lambda *a, **k: seen.append(a))
        got = pred(ids, {"bindings": {"p": rows}})
        monkeypatch.undo()
        assert not seen and got.shape == (4, 900)
        for b in range(4):
            assert torch.equal(got[b], pred(ids[b], {"bindings": {"p": rows[b]}}))


@pytest.mark.parametrize("B", LANES + [0])
@pytest.mark.parametrize("out", [False, True], ids=["fresh", "out"])
def test_rows_with_matches_lanes_equal_reference(out, B):
    """K13's lane form over lane-local [B, W] rows (ascending as an
    expansion emits them, -1 padding, ids past the end, an all-padding
    lane, a lane repeating the one before it): lane b equals the
    reference's `rows_with_matches` and the single-lane wrapper, exactly;
    with ``out`` the counts add into each lane's row."""
    rng = np.random.default_rng(B * 5 + out)
    W, nseg = 700, 97
    rows = np.sort(rng.integers(-1, nseg + 3, (B, W)), axis=1).astype(np.int32)
    mask = rng.random((B, W)) < 0.6
    if B:
        rows[0] = -1
    if B > 1:
        rows[-1], mask[-1] = rows[-2], mask[-2]
    acc = torch.from_numpy(rng.integers(0, 5, (B, nseg), dtype=np.int32)) if out else None
    start = acc.clone() if out else torch.zeros((B, nseg), dtype=I32)
    got = K.rows_with_matches(_t(rows), _t(mask), nseg, out=acc)
    assert got.shape == (B, nseg) and got.dtype == I32
    if out:
        assert got is acc
    for b in range(B):
        want = np.asarray(J.rows_with_matches(rows[b], mask[b], num_segments=nseg))
        np.testing.assert_array_equal((got[b] - start[b]).numpy(), want)
        assert torch.equal(got[b] - start[b], K.rows_with_matches(_t(rows[b]), _t(mask[b]), nseg))
    if B:
        assert torch.equal(got[0], start[0])


def test_lane_forms_refuse_what_their_kernels_do_not_take():
    """Each wrapper checks its shapes: lanes that disagree, a stacked
    operand of the wrong width, values from a lane-form mask program, and
    a parameter stack over the kernel's lanes."""
    ok = torch.zeros((3, 64), dtype=torch.bool)
    w = torch.zeros((4, 64), dtype=I32)
    emit = torch.zeros(10, dtype=I32)
    with pytest.raises(ValueError, match="lanes"):
        K.weight_gather(emit, I32, ok=ok, w=w)
    with pytest.raises(ValueError, match="node_ok"):
        K.weight_gather(emit, I32, node_ok=torch.zeros((3, 9), dtype=torch.bool))
    with pytest.raises(TypeError):
        K.indptr_segment_sum(torch.zeros((2, 5), dtype=torch.int64), torch.zeros(3, dtype=I32), 2)
    prog = K.PredProgram([(K.PredOp.PARAM, 0, 0, 0), (K.PredOp.TRUTHY, 0, 0, 0)], "cpu")
    with pytest.raises(ValueError, match="masks only"):
        K.predicate_eval(prog, [], None, 4, params=torch.zeros((2, 1), dtype=I32), values=True)
    with pytest.raises(ValueError, match="stack"):
        K.predicate_eval(prog, [], None, 4, params=torch.zeros((K.PRED_LANES + 1, 1), dtype=I32))


# ---------------------------------------------------------------------------
# count groups on the lane axis
# ---------------------------------------------------------------------------


def _plans(snap, sql):
    return [p for k, v in TE._plan_cache(snap).items() if k[0] == parse(sql) for p in v.plans]


class _LaneSpy:
    """Counts the lane forms' calls (their wrappers, which on the CPU run
    the plain versions): a count group's, a rows group's, the bitmap BFS's
    (K10, K11, K12), and `take_pad`'s lane stride (``take_pad_lanes``: a
    call with a lane-stacked table)."""

    NAMES = (
        "predicate_eval_lanes", "weight_gather_lanes", "indptr_segment_sum_lanes", "mask_count_lanes",
        "value_cumsum_lanes", "compact_indices_lanes", "expand_offsets_lanes", "gather_expand_lanes",
        "front_pack_lanes", "replay_meta_lanes", "predicate_eval_stacked", "rows_with_matches_lanes",
        "bitmap_hop_csr_lanes", "bitmap_emit_lanes", "frontier_advance_lanes",
    )

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(self.NAMES + ("take_pad_lanes",), 0)
        for name in self.NAMES:
            def spy(*a, _f=getattr(K, name), _n=name, **kw):
                self.calls[_n] += 1
                return _f(*a, **kw)

            monkeypatch.setattr(K, name, spy)

        def take(values, idx, fill, _f=K.take_pad):
            self.calls["take_pad_lanes"] += values.dim() == 2
            return _f(values, idx, fill)

        monkeypatch.setattr(K, "take_pad", take)


def _group(monkeypatch, db, snap, sql, plist, want, lane_axis=True):
    """``db.query_batch`` of ``sql`` over ``plist`` (16 items): the first
    batch records the statement, the second runs the group. Every lane
    equals ``want[i]`` and the port's single query; the plan takes the lane
    axis (or not); returns the lane forms' calls in the group batch, a
    group replay's (the items may split over recorded variants, a group
    each)."""
    single = [db.query(sql, p).to_dicts() for p in plist]
    for i, rows in enumerate(single):
        assert canonical_rows(rows) == canonical_rows(want[i]), (sql, plist[i])
    db.query_batch([sql] * len(plist), plist)
    before = {id(p): p.group_replays for p in _plans(snap, sql)}
    spy = _LaneSpy(monkeypatch)
    got = [rs.to_dicts() for rs in db.query_batch([sql] * len(plist), plist)]
    monkeypatch.undo()
    assert got == single, sql
    grouped = [p for p in _plans(snap, sql) if p.group_replays]
    assert grouped and all(p.lane_axis is lane_axis for p in grouped), sql
    replays = sum(p.group_replays - before.get(id(p), 0) for p in grouped)
    assert replays > 0, sql
    return {k: n / replays for k, n in spy.calls.items()}


Q2P = (
    "MATCH {class:Person, as:p, where:(age > :a)}-knows->{as:f}"
    "-knows->{as:g, where:(age < :b)} RETURN count(*) AS n"
)
Q3 = (
    "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f}"
    "-knows->{as:g, where:(age < 30)} RETURN p.uid AS p, f.uid AS f, g.uid AS g"
)
VAR_Q = "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f, while:($depth < 2)} RETURN count(*) AS n"
E2 = (
    "MATCH {class:Person, as:p, where:(uid < :n)}"
    ".outE('knows'){as:e, where:(creationDate > :d)}.inV(){as:f, where:(age < 30)} "
    "RETURN p.uid AS p, f.uid AS f, e.creationDate AS cd"
)


@pytest.fixture(scope="module")
def person_knows():
    jdb, _ = j_build_person_knows(20_000, seed=3)
    db, snap = build_person_knows(20_000, seed=3, device="cpu")
    return jdb, db, snap


@pytest.fixture(scope="module")
def snb():
    return build_snb_shape(2_000, device="cpu")


def test_two_hop_count_group_runs_on_the_lane_axis(monkeypatch, person_knows):
    """The parametric two-hop COUNT: a lane-varying root and a lane-varying
    last hop. One group replay of 16 lanes counts the root mask into the
    pushdown's weights (no compaction), and every lane equals the
    reference's ``engine="tpu"``; lane 0 finds no root (an empty lane)."""
    jdb, db, snap = person_knows
    plist = [{"a": 80 if i == 0 else 30 + 2 * i, "b": 20 + 2 * i} for i in range(16)]
    want = [jdb.query(Q2P, p, engine="tpu", strict=True).to_dicts() for p in plist]
    assert want[0] == [{"n": 0}]
    calls = _group(monkeypatch, db, snap, Q2P, plist, want)
    # two masks (p, g) a group: one lane-form launch each; the two walks,
    # the fold of p and the total in K5a's and K4's lane forms
    assert calls["predicate_eval_lanes"] == 2 and calls["mask_count_lanes"] == 0
    assert calls["weight_gather_lanes"] >= 3 and calls["indptr_segment_sum_lanes"] >= 3


def test_rows_group_runs_on_the_lane_axis(monkeypatch, person_knows):
    """A rows group of BQ3's shape (Q3 × 16: a lane-varying root, two hops
    and a shared node mask) takes the lane axis: one group replay runs the
    root's K15 lane launch, K3's lane form for the roots and each hop's
    survivors, K2's and K2b's for each hop, K6's and K7's for the pages; and
    every lane equals the reference's ``engine="tpu"``; lane 5 finds no
    root (an empty lane), the last lane repeats the one before it."""
    jdb, db, snap = person_knows
    plist = [{"k": 0 if i == 5 else 260 - 10 * i} for i in range(15)] + [{"k": 120}]
    want = [jdb.query(Q3, p, engine="tpu", strict=True).to_dicts() for p in plist]
    assert want[5] == [] and want[-1] == want[-2]
    calls = _group(monkeypatch, db, snap, Q3, plist, want)
    assert calls["predicate_eval_lanes"] == 1 and calls["weight_gather_lanes"] == 0
    assert calls["compact_indices_lanes"] == 3 and calls["expand_offsets_lanes"] == 2
    assert calls["gather_expand_lanes"] == 2 and calls["mask_count_lanes"] == 3
    assert calls["front_pack_lanes"] == 1 and calls["replay_meta_lanes"] == 1
    assert calls["take_pad_lanes"] > 0


def test_var_depth_count_group_stays_lane_after_lane(monkeypatch, person_knows):
    """A COUNT whose lane-varying root is expanded by a variable-depth arm
    (the name is older than the route: the group no longer stays lane after
    lane) runs on the lane axis: the root through K15's and K3's lane forms,
    its bitmap BFS through K10's, K11's (the depth-0 count) and K12's (each
    level's alive and folded emission counts, [B]); every lane equals the
    reference."""
    jdb, db, snap = person_knows
    plist = [{"k": 5 + i} for i in range(16)]
    want = [jdb.query(VAR_Q, p, engine="tpu", strict=True).to_dicts() for p in plist]
    calls = _group(monkeypatch, db, snap, VAR_Q, plist, want)
    assert calls["predicate_eval_lanes"] == 1 and calls["compact_indices_lanes"] == 1
    assert calls["bitmap_hop_csr_lanes"] >= 2 and calls["frontier_advance_lanes"] >= 2
    assert calls["bitmap_emit_lanes"] >= 1 and calls["weight_gather_lanes"] == 0


def test_e2_shaped_group_runs_on_the_lane_axis(monkeypatch, snb):
    """The E2-shaped rows group (a lane-varying edge WHERE on a bare
    ``.outE()`` arm past the root, then an endpoint arm) with ``n`` and
    ``d`` varying by lane takes the lane axis: the root's K15 lane launch,
    the edge WHERE through K15's stacked form over the [B, cap] edge ids,
    the shared node mask once over the flattened ids; every lane equals
    numpy, lane 4 finds no root."""
    db, snap = snb
    young = snap.v_columns["age"].values < 30
    plist = [{"n": 0 if i == 4 else 2_000 - 100 * i, "d": 10_000 + 500 * i} for i in range(16)]
    want = [
        [{"p": int(a), "f": int(b), "cd": int(c)} for a, b, c in numpy_out_edge_rows(snap, p["n"], p["d"], young)]
        for p in plist
    ]
    assert want[4] == [] and all(want[i] for i in range(16) if i != 4)
    calls = _group(monkeypatch, db, snap, E2, plist, want)
    assert calls["predicate_eval_lanes"] == 1 and calls["predicate_eval_stacked"] == 1
    assert calls["expand_offsets_lanes"] == 1 and calls["gather_expand_lanes"] == 1
    assert calls["front_pack_lanes"] == 1 and calls["rows_with_matches_lanes"] == 0


def test_e2_shaped_group_equals_both_engines_on_a_carried_graph(monkeypatch):
    """The E2-shaped rows group (a lane-varying edge WHERE past the root)
    on a record-backed graph of E2's schema carried into the port: it runs
    on the lane axis, and every lane equals the reference's
    ``engine="oracle"`` and its ``engine="tpu"`` (which on an array-built
    snapshot, `build_snb_shape`'s, cannot bind the edge alias: it has no
    edge records); lane 4 finds no root."""
    jdb, db, snap = _e_record_graph()
    plist = [{"n": 0 if i == 4 else 300 - 15 * i, "d": 8_000 + 500 * i} for i in range(16)]
    want = [jdb.query(E2, p, engine="oracle").to_dicts() for p in plist]
    for p, rows in zip(plist, want):
        assert canonical_rows(jdb.query(E2, p, engine="tpu", strict=True).to_dicts()) == canonical_rows(rows), p
    assert want[4] == [] and all(want[i] for i in range(16) if i != 4)
    calls = _group(monkeypatch, db, snap, E2, plist, want)
    assert calls["predicate_eval_stacked"] == 1 and calls["predicate_eval_lanes"] == 1


def _e_record_graph():
    """A record-backed graph of E2's and E5's schema (Person uid, age;
    knows creationDate), carried into the port."""
    from test_torch_edges import _carry

    rng = np.random.default_rng(7)
    jdb = JDatabase("e2")
    jdb.schema.create_vertex_class("Person")
    jdb.schema.create_edge_class("knows")
    vs = [jdb.new_vertex("Person", uid=i, age=int(rng.integers(10, 70))) for i in range(300)]
    for s, d, cd in zip(rng.integers(0, 300, 1_800), rng.integers(0, 300, 1_800), rng.integers(0, 20_000, 1_800)):
        jdb.new_edge("knows", vs[int(s)], vs[int(d)], creationDate=int(cd))
    attach_fresh_snapshot(jdb)
    db, snap = _carry(jdb)
    return jdb, db, snap


E4 = (
    "MATCH {class:Person, as:p, where:(uid < :n)}"
    "-knows->{as:f, optional:true, where:(age > 75)} RETURN p.uid AS p, f.uid AS f"
)
E5 = (
    "MATCH {class:Person, as:p, where:(uid < :n)}-knows->{as:f, where:(age < p.age)}, "
    "{as:f}-knows{as:kn, optional:true, where:(creationDate > :d)}-{as:p} "
    "RETURN p.uid AS p, f.uid AS f, kn IS NOT NULL AS probe"
)
E2_BOTH = (
    "MATCH {class:Person, as:p, where:(uid < :n)}.bothE('knows'){as:e}, "
    "{as:e}.bothV(){as:v} RETURN p.uid AS p, v.uid AS v"
)


def _dicts(rows, names):
    """numpy rows as result dicts (-1 → None, a probe column as bool)."""
    out = []
    for r in rows:
        d = {k: (None if int(v) < 0 else int(v)) for k, v in zip(names, r)}
        if "probe" in d:
            d["probe"] = bool(d["probe"])
        out.append(d)
    return out


def test_e5_shaped_group_runs_on_the_lane_axis(monkeypatch, snb):
    """The E5-shaped rows group (IS7: an arm whose node mask reads the
    binding ``p.age``, then an OPTIONAL closing arm whose edge WHERE reads
    ``:d``) with ``n`` and ``d`` varying by lane takes the lane axis: the
    binding mask once over the flattened ids and binding rows, the closing
    arm's edge WHERE and ``p``'s mask through K15's stacked form, its left
    join through K13's lane form (both directions); every lane equals
    numpy, lane 2 finds no root."""
    db, snap = snb
    plist = [{"n": 0 if i == 2 else 400 - 40 * i, "d": 11_000 + 900 * i} for i in range(8)]
    want = [_dicts(numpy_probe_rows(snap, p["n"], p["d"]), ("p", "f", "probe")) for p in plist]
    assert want[2] == [] and all(want[i] for i in range(8) if i != 2)
    calls = _group(monkeypatch, db, snap, E5, plist, want)
    assert calls["predicate_eval_lanes"] == 1 and calls["predicate_eval_stacked"] >= 2
    assert calls["rows_with_matches_lanes"] == 2 and calls["compact_indices_lanes"] >= 4


def test_e5_shaped_group_equals_the_oracle_on_a_carried_graph(monkeypatch):
    """The E5-shaped group on the record-backed graph: on the lane axis,
    every lane equals the reference's ``engine="oracle"``."""
    jdb, db, snap = _e_record_graph()
    plist = [{"n": 0 if i == 1 else 300 - 30 * i, "d": 6_000 + 1_500 * i} for i in range(8)]
    want = [jdb.query(E5, p, engine="oracle").to_dicts() for p in plist]
    assert want[1] == [] and all(want[i] for i in range(8) if i != 1)
    calls = _group(monkeypatch, db, snap, E5, plist, want)
    assert calls["rows_with_matches_lanes"] == 2 and calls["predicate_eval_stacked"] >= 2


def test_e4_shaped_optional_group_runs_on_the_lane_axis(monkeypatch, snb):
    """The E4-shaped OPTIONAL group (a left join whose node mask the lanes
    share) takes the lane axis: K13's lane form counts each lane's matches,
    and each lane's unmatched rows come back with a null ``f``; every lane
    equals numpy, lane 5 finds no root."""
    db, snap = snb
    old = snap.v_columns["age"].values > 75
    plist = [{"n": 0 if i == 5 else 1_000 - 60 * i} for i in range(16)]
    want = [_dicts(numpy_optional_rows(snap, p["n"], old), ("p", "f")) for p in plist]
    assert want[5] == [] and any(r["f"] is None for r in want[0])
    calls = _group(monkeypatch, db, snap, E4, plist, want)
    assert calls["rows_with_matches_lanes"] == 1 and calls["predicate_eval_stacked"] == 0
    assert calls["compact_indices_lanes"] == 3


def test_e2b_shaped_group_runs_on_the_lane_axis(monkeypatch, snb):
    """The E2b-shaped group (``.bothE()`` binding the edge, then
    ``.bothV()`` to both its endpoints) takes the lane axis: K2's and K2b's
    lane forms for each direction, the endpoints through the shared edge
    lists' flattened gather; every lane equals numpy, lane 0 finds no
    root."""
    db, snap = snb
    plist = [{"n": 0 if i == 0 else 70 - 4 * i} for i in range(16)]
    want = [_dicts(numpy_incident_rows(snap, p["n"]), ("p", "v")) for p in plist]
    assert want[0] == []
    calls = _group(monkeypatch, db, snap, E2_BOTH, plist, want)
    assert calls["expand_offsets_lanes"] == 2 and calls["gather_expand_lanes"] == 2
    assert calls["predicate_eval_stacked"] == 0 and calls["predicate_eval_lanes"] == 1


@pytest.mark.parametrize("recorded", [19_900, 19_999], ids=["few", "none"])
def test_lane_overflowing_past_the_root_reruns_alone(monkeypatch, snb, recorded):
    """E2 recorded where its edge WHERE keeps few edges (or none: the
    compaction's capacity is then 0), then a batch of 16 whose lane 9 keeps
    every edge: the group runs on the lane axis, lane 9's meta row flags
    only its own overflow and it re-records alone, lane 3 (no root) gives
    no rows, and every lane equals numpy."""
    db, snap = snb
    young = snap.v_columns["age"].values < 30
    plist = [{"n": 0 if i == 3 else 600, "d": 10_000 if i == 9 else recorded} for i in range(16)]
    want = [numpy_out_edge_rows(snap, p["n"], p["d"], young) for p in plist]
    assert want[3].shape[0] == 0 and want[9].shape[0] > 4 * max(want[0].shape[0], 8)
    TE._plan_cache(snap).clear()  # E2 records anew, at plist[0]
    db.query(E2, plist[0]).to_dicts()
    (first,) = _plans(snap, E2)
    spy = _LaneSpy(monkeypatch)
    got = [rs.to_dicts() for rs in db.query_batch([E2] * 16, plist)]
    monkeypatch.undo()
    for i, rows in enumerate(got):
        assert canonical_rows(rows) == canonical_rows(
            [{"p": int(a), "f": int(b), "cd": int(c)} for a, b, c in want[i]]
        ), i
    assert first.lane_axis and first.group_replays == 1
    assert spy.calls["predicate_eval_stacked"] >= 1
    variants = [v for k, v in TE._plan_cache(snap).items() if k[0] == parse(E2)]
    (v,) = variants
    assert len(v.plans) == 2 and v.plans[1] is first and v.pick(plist[9]) is v.plans[0]
    assert all(v.pick(p) is first for i, p in enumerate(plist) if i != 9)
    TE._plan_cache(snap).clear()


@pytest.mark.parametrize("shape", ["not", "cartesian"])
def test_not_and_cartesian_rows_groups_stay_lane_after_lane(monkeypatch, person_knows, shape):
    """A second (cartesian) root keeps the rows group lane after lane; a NOT
    arm no longer does (the name is older than its route): its anti-join
    runs on the lane axis, the arm's hop through K10's lane form and its
    last step through K11's, the survivors through K3's. Every lane equals
    the reference's ``engine="tpu"`` (the cartesian lanes keep the recorded
    cardinalities, which its pairing stride needs: ``:z`` varies and ``:k``
    does not)."""
    jdb, db, snap = person_knows
    if shape == "not":
        sql = ("MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f}, "
               "NOT {as:f}-knows->{where:(age > 70)} RETURN p.uid AS p, f.uid AS f")
        plist = [{"k": 4 + i} for i in range(16)]
    else:
        sql = ("MATCH {class:Person, as:p, where:(uid < :k AND uid > :z)}, {class:Person, as:q, where:(uid < 3)} "
               "RETURN p.uid AS p, q.uid AS q")
        plist = [{"k": 6, "z": -1 - i} for i in range(16)]
    want = [jdb.query(sql, p, engine="tpu", strict=True).to_dicts() for p in plist]
    calls = _group(monkeypatch, db, snap, sql, plist, want, lane_axis=shape == "not")
    if shape == "cartesian":
        assert not any(calls.values())
        return
    assert calls["bitmap_hop_csr_lanes"] >= 1 and calls["bitmap_emit_lanes"] >= 1
    assert calls["frontier_advance_lanes"] == 0 and calls["compact_indices_lanes"] >= 3


DIRECT = "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f} RETURN p.uid AS p, f.uid AS f"
DIRECT_IN = "MATCH {class:Person, as:p, where:(uid < :k)}<-knows-{as:f} RETURN p.uid AS p, f.uid AS f"
LIMIT = "MATCH {class:Person, as:p, where:(age > :a)}-knows->{as:f} RETURN p.uid AS p, f.uid AS f LIMIT 5"


@pytest.mark.parametrize("sql", [DIRECT, DIRECT_IN, LIMIT], ids=["direct", "in_walk", "limit"])
def test_direct_fetch_and_limit_groups_run_on_the_lane_axis(monkeypatch, person_knows, sql):
    """A direct-fetch one-hop group (the lanes' pages and meta rows written
    straight into the ``[Bb, W·C + 3]`` stack), its in walk (K2b's lane
    form through ``edge_id_in``) and a LIMIT group take the lane axis, and
    every lane equals the reference's ``engine="tpu"``; lane 3 finds no
    root."""
    jdb, db, snap = person_knows
    if sql == LIMIT:
        plist = [{"a": 90 if i == 3 else 40 + 2 * i} for i in range(16)]
    else:
        plist = [{"k": 0 if i == 3 else 40 - 2 * i} for i in range(16)]
    want = [jdb.query(sql, p, engine="tpu", strict=True).to_dicts() for p in plist]
    assert want[3] == []
    calls = _group(monkeypatch, db, snap, sql, plist, want)
    assert calls["predicate_eval_lanes"] == 1 and calls["gather_expand_lanes"] == 1
    assert calls["compact_indices_lanes"] == 2 and calls["replay_meta_lanes"] == 1
    plans = [p for p in _plans(snap, sql) if p.group_replays]
    assert all(p.direct_fetch is (sql != LIMIT) for p in plans)


def test_demodb_rows_group_equals_both_engines(monkeypatch):
    """The reference's own rows-group case (`tests/test_group_dispatch.py`'s
    ``ROWS_SQL`` × 12 on demodb) on the lane axis: every lane equals the
    reference's ``engine="tpu"`` and its ``engine="oracle"``."""
    from orientdb_tpu.storage.ingest import generate_demodb
    from orientdb_tpu.storage.snapshot import build_snapshot
    from test_torch_edges import _carry

    jdb = generate_demodb(n_profiles=400, avg_friends=6, seed=5)
    jdb.attach_snapshot(build_snapshot(jdb))
    db, snap = _carry(jdb)
    sql = "MATCH {class:Profiles, as:p, where:(age > :a)}-HasFriend->{as:f} RETURN p.uid AS p, f.uid AS f"
    plist = [{"a": 20 + (i % 7) * 5} for i in range(12)]
    plist[0] = {"a": 20}  # recorded first: the widest lane
    want = []
    for p in plist:
        o = jdb.query(sql, p, engine="oracle").to_dicts()
        assert canonical_rows(jdb.query(sql, p, engine="tpu", strict=True).to_dicts()) == canonical_rows(o)
        want.append(o)
    calls = _group(monkeypatch, db, snap, sql, plist, want)
    assert calls["predicate_eval_lanes"] == 1 and calls["gather_expand_lanes"] == 1


E1 = (
    "MATCH {class:Person, as:p, where:(age > 40)}"
    ".outE('knows'){where:(creationDate > :d)}"
    ".inV(){as:f, where:(age < 30)}, "
    "{class:Message, as:m}-hasCreator->{as:f} "
    "RETURN count(*) AS n"
)


def test_config5_count_group_runs_on_the_lane_axis(monkeypatch):
    """E1 (the config-5 COUNT) with 16 values of :d, BE1's: only the edge
    mask varies by lane. One K15 lane launch for the edge mask, and every
    lane equals the reference's ``engine="tpu"`` and the numpy count."""
    jdb, _ = j_build_snb_shape(2_000, msgs_per_person=2, avg_knows=10, seed=7)
    db, snap = build_snb_shape(2_000, msgs_per_person=2, avg_knows=10, seed=7, device="cpu")
    plist = [{"d": 12_000 + (211 * i) % 8_000} for i in range(16)]
    plist[3] = {"d": 10**9}  # an empty lane: no edge passes
    want = [jdb.query(E1, p, engine="tpu", strict=True).to_dicts() for p in plist]
    for p, w in zip(plist, want):
        assert w == [{"n": numpy_config5_count(snap, p["d"])}]
    assert want[3] == [{"n": 0}]
    calls = _group(monkeypatch, db, snap, E1, plist, want)
    assert calls["predicate_eval_lanes"] == 1 and calls["mask_count_lanes"] == 0
    assert calls["indptr_segment_sum_lanes"] >= 2


def _geo_record_db(n: int, seed: int):
    """A record graph with E1's, G1's and the two-hop COUNT's shapes:
    Person (age with absent cells, lat, lng), Message, Knows (since) and
    HasCreator (Message → Person)."""
    rng = np.random.default_rng(seed)
    db = JDatabase(f"lanes{seed}")
    db.schema.create_vertex_class("Person")
    db.schema.create_vertex_class("Message")
    db.schema.create_edge_class("Knows")
    db.schema.create_edge_class("HasCreator")
    people = []
    for i in range(n):
        fields = {"uid": i, "lat": float(rng.uniform(35, 60)), "lng": float(rng.uniform(-10, 30))}
        if rng.random() > 0.1:
            fields["age"] = int(rng.integers(15, 80))
        people.append(db.new_vertex("Person", **fields))
    for _ in range(n * 4):
        s, d = int(rng.integers(0, n)), int(rng.integers(0, n))
        db.new_edge("Knows", people[s], people[d], since=int(rng.integers(0, 20)))
    for i in range(n):
        m = db.new_vertex("Message", uid=i)
        db.new_edge("HasCreator", m, people[int(rng.integers(0, n))])
    attach_fresh_snapshot(db)
    return db


RECORD_GROUPS = [
    (
        "MATCH {class:Person, as:p, where:(age > 40)}.outE('Knows'){where:(since > :d)}"
        ".inV(){as:f, where:(age < 30)}, {class:Message, as:m}-HasCreator->{as:f} RETURN count(*) AS n",
        lambda i: {"d": 40 if i == 0 else i},
    ),
    (
        "MATCH {class:Person, as:p, where:(distance(lat, lng, :x, :y) < :r)} RETURN count(*) AS n",
        lambda i: {"x": 48.0 + 0.25 * i, "y": 2.0, "r": 0.0 if i == 0 else 100.0 + 97.0 * i},
    ),
    (Q2P.replace("knows", "Knows"), lambda i: {"a": 90 if i == 0 else 30 + 2 * i, "b": 20 + 3 * i}),
]


@pytest.mark.parametrize("g", range(len(RECORD_GROUPS)), ids=["E1", "G1", "two_hop"])
def test_record_graph_count_groups_equal_both_engines(monkeypatch, g):
    """The three count groups on a graph with records: every lane equals
    the port's single query, the reference's ``engine="tpu"`` and its
    ``engine="oracle"`` (G1's radii stay clear of the float32 boundary
    band by construction: the test checks it)."""
    jdb = _geo_record_db(400, seed=g)
    db, snap = snapshot_from_arrays(*_carry_arrays(jdb, jdb.current_snapshot()), device="cpu")
    sql, params = RECORD_GROUPS[g]
    plist = [params(i) for i in range(16)]
    if g == 1:
        lat = np.radians(snap.v_columns["lat"].values.astype(np.float64))
        lng = np.radians(snap.v_columns["lng"].values.astype(np.float64))
        for p in plist:
            x, y = np.radians(p["x"]), np.radians(p["y"])
            h = np.sin((lat - x) / 2) ** 2 + np.cos(x) * np.cos(lat) * np.sin((lng - y) / 2) ** 2
            d = 12742.0 * np.arcsin(np.sqrt(h))
            assert not (np.abs(d - p["r"]) < 0.01 + 1e-5 * p["r"]).any(), p
    want = []
    for p in plist:
        o = jdb.query(sql, p, engine="oracle").to_dicts()
        assert canonical_rows(jdb.query(sql, p, engine="tpu", strict=True).to_dicts()) == canonical_rows(o)
        want.append(o)
    assert want[0] == [{"n": 0}]
    calls = _group(monkeypatch, db, snap, sql, plist, want)
    assert calls["predicate_eval_lanes"] >= 1
    if g == 1:  # a lane-varying root that is only counted
        assert calls["mask_count_lanes"] == 1 and calls["weight_gather_lanes"] == 0


def test_chip_smoke_lane_checks_run_on_the_cpu(person_knows):
    """The card run's lane checks, on the CPU where both sides are plain
    versions: K15's lane programs compile and equal their rows, and one
    eager run of the two-hop group body records its lane forms' calls,
    each equal to its single-lane calls lane by lane, with a bound."""
    import chip_smoke

    band, checked = chip_smoke.check_predicate_lanes(np, torch, K, 2_000, 3, device="cpu")
    assert checked == 2 * len(chip_smoke.K15_LANE_WHERES) and band >= 0
    _jdb, db, snap = person_knows
    plist = [{"a": 30 + 2 * i, "b": 20 + 2 * i} for i in range(16)]
    for _ in range(2):
        db.query_batch([Q2P] * 16, plist)
    (plan,) = [p for p in _plans(snap, Q2P) if p.group_replays]
    stack = torch.from_numpy(np.stack([plan._dyn_args(p) for p in plist]))
    calls = chip_smoke.lane_calls(torch, K, plan, stack)
    assert {name for name, _a, _kw in calls} == {"predicate_eval_lanes", "weight_gather_lanes", "indptr_segment_sum_lanes"}
    for name, a, kw in calls:
        got = getattr(K, name)(*a, **kw)
        for b in range(16):
            assert torch.equal(got[b], chip_smoke._lane_single(K, name, a, kw, b))
        nbytes, ops, sectors = chip_smoke._lane_bound(torch, name, a, kw)
        assert nbytes > 0 and ops == 0 and sectors >= 0


def test_chip_smoke_rows_lane_checks_run_on_the_cpu(person_knows):
    """The card run's rows-group lane checks, on the CPU where both sides
    are plain versions: one eager run of BQ3's group body records the rows
    lane forms' calls (K1's lane form runs inside K6's only on a card),
    each equal to its plain version and to its single-lane calls lane by
    lane, with a bound."""
    import chip_smoke

    _jdb, db, snap = person_knows
    plist = [{"k": 300 - 12 * i} for i in range(16)]
    for _ in range(2):
        db.query_batch([Q3] * 16, plist)
    (plan,) = [p for p in _plans(snap, Q3) if p.group_replays and p.lane_axis]
    stack = torch.from_numpy(np.stack([plan._dyn_args(p) for p in plist]))
    calls = [c for c in chip_smoke.lane_calls(torch, K, plan, stack) if c[0] in chip_smoke.ROWS_LANE_FORMS]
    assert {name for name, _a, _kw in calls} == set(chip_smoke.ROWS_LANE_FORMS) - {"value_cumsum_lanes"}
    for name, a, kw in calls:
        got = getattr(K, name)(*a, **kw)
        want = chip_smoke._lane_plain(K, name, a, kw)
        assert chip_smoke._lane_equal(torch, got, want), name
        for b in range(16):
            assert chip_smoke._lane_equal(torch, chip_smoke._lane_of(got, b), chip_smoke._lane_single(K, name, a, kw, b)), name
        nbytes, ops, sectors = chip_smoke._lane_bound(torch, name, a, kw)
        assert nbytes > 0 and ops == 0 and sectors >= 0
    vals = torch.from_numpy(np.random.default_rng(1).integers(0, 2, (16, 4096), dtype=np.int32))
    (name, a, kw) = ("value_cumsum_lanes", (vals,), {})
    got = K.value_cumsum_lanes(vals)
    assert chip_smoke._lane_equal(torch, got, chip_smoke._lane_plain(K, name, a, kw))
    assert all(torch.equal(got[b], chip_smoke._lane_single(K, name, a, kw, b)) for b in range(16))


def test_chip_smoke_arm_lane_checks_run_on_the_cpu(snb):
    """The card run's checks of K15's stacked form and K13's lane form, on
    the CPU where both sides are plain versions: the synthetic stacked
    programs (a split one among them) equal the single form lane by lane,
    and one eager run of BE5's group body (E5 × 8) records both forms'
    calls, each equal to its plain version and to its single-lane calls
    lane by lane, with a bound and (K13) the library's ``scatter_add_``."""
    import chip_smoke

    band, checked = chip_smoke.check_predicate_stacked(np, torch, K, 2_000, 3, device="cpu")
    assert checked > 2 * len(chip_smoke.K15_LANE_WHERES) and band >= 0
    db, snap = snb
    sql = chip_smoke.E5
    plist = [{"n": 300 + 40 * i, "d": 15_000} for i in range(8)]
    for _ in range(2):
        db.query_batch([sql] * 8, plist)
    (plan,) = [p for p in _plans(snap, sql) if p.group_replays and p.lane_axis]
    stack = torch.from_numpy(np.stack([plan._dyn_args(p) for p in plist]))
    calls = [c for c in chip_smoke.lane_calls(torch, K, plan, stack) if c[0] in chip_smoke.ARM_LANE_FORMS]
    assert {name for name, _a, _kw in calls} == set(chip_smoke.ARM_LANE_FORMS)
    for name, a, kw in calls:
        got = getattr(K, name)(*a, **kw)
        assert chip_smoke._lane_equal(torch, got, chip_smoke._lane_plain(K, name, a, kw)), name
        for b in range(8):
            assert chip_smoke._lane_equal(
                torch, chip_smoke._lane_of(got, b), chip_smoke._lane_single(K, name, a, kw, b)
            ), name
        nbytes, ops, _sectors = chip_smoke._lane_bound(torch, name, a, kw)
        assert nbytes > 0 and ops == 0
        lib = chip_smoke._lane_library(torch, name, a)
        if name == "rows_with_matches_lanes":
            assert torch.equal(lib(), got)
        else:
            assert lib is None
