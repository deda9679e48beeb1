"""The COUNT pushdown's fused weight gather (`ops.csr.weight_gather`, the
port's form of the reference's weight-pass chain at
`orientdb_tpu/exec/tpu_engine.py:1600-1606`) against that chain in JAX, and
the COUNT statements that run it against both reference engines, on the
CPU.

On the CPU the wrapper runs its plain version. Its values must equal the
reference's ``em & take_pad(ok_vec, emit, False)``, ``.astype(dtype)``,
``* take_pad(w, emit, dtype(0))`` exactly: int32 equal, float32 equal bit
for bit (the product is 1·w or 0). The kernel itself runs only on a card
(`tests/test_torch_kernels.py`)."""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orientdb_tpu.ops import csr as J
from orientdb_tpu.storage.bigshape import build_person_knows as j_build_person_knows
from orientdb_tpu.storage.bigshape import build_snb_shape as j_build_snb_shape
from orientdb_tpu_torch.carry import snapshot_from_arrays
from orientdb_tpu_torch.exec import tpu_engine as TE
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.storage.bigshape import (
    build_person_knows,
    build_snb_shape,
    numpy_1hop_count,
    numpy_2hop_count,
    numpy_config5_count,
)
from test_torch_match import _carry_arrays
from test_tpu_fuzz import random_db


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads, and the suite runs
    in parallel workers: keep torch to one thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _operands(rng, vb: int, e: int, dtype):
    """A seeded weight pass: endpoints with padding (-1) and past-the-end
    ids, a [vb] vertex mask, the same mask at each endpoint, an edge mask,
    a permutation of edge ids with -1 and past-the-end entries (the in
    walk's edge_id_in), and weights."""
    emit = rng.integers(-1, vb + 3, e, dtype=np.int32)
    ok = rng.random(vb) < 0.4
    emask = rng.random(e) < 0.7
    eid = rng.permutation(e).astype(np.int32)
    eid[rng.random(e) < 0.05] = -1
    eid[rng.random(e) < 0.02] = e + 5
    if dtype == np.int32:
        w = rng.integers(0, 2**20, vb, dtype=np.int32)
    else:
        w = (rng.random(vb) * 1000).astype(np.float32)
    return emit, ok, emask, eid, w


def _jax_chain(emit, dtype, ok=None, node_ok=None, emask=None, eid=None, w=None):
    """The reference's chain: the mask factors ANDed, cast, times the
    gathered weight (`tpu_engine.py:1600-1606`, the in walk's mask read
    through the reference's take_pad)."""
    emit = jnp.asarray(emit)
    keep = None
    factors = []
    if ok is not None:
        factors.append(J.take_pad(jnp.asarray(ok), emit, False))
    if node_ok is not None:
        factors.append(jnp.asarray(node_ok))
    if emask is not None:
        em = jnp.asarray(emask)
        factors.append(em if eid is None else J.take_pad(em, jnp.asarray(eid), False))
    for f in factors:
        keep = f if keep is None else keep & f
    vals = jnp.ones(emit.shape, dtype) if keep is None else keep.astype(dtype)
    if w is not None:
        vals = vals * J.take_pad(jnp.asarray(w), emit, dtype(0))
    return np.asarray(vals)


def _same_bits(got: torch.Tensor, want: np.ndarray):
    assert got.numpy().dtype == want.dtype
    assert got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["i32", "f32"])
@pytest.mark.parametrize("weights", [False, True], ids=["w_absent", "w"])
@pytest.mark.parametrize("masked", [False, True], ids=["em_absent", "em"])
@pytest.mark.parametrize("walk", ["out", "in"])
@pytest.mark.parametrize("form", ["ok_vec", "node_ok"], ids=["E_ge_vb", "E_lt_vb"])
def test_weight_gather_equals_reference_chain(form, walk, masked, weights, dtype):
    rng = np.random.default_rng(zlib.crc32(f"{form} {walk} {masked} {weights} {np.dtype(dtype).name}".encode()))
    vb, e = (64, 700) if form == "ok_vec" else (512, 300)
    emit, ok, emask, eid, w = _operands(rng, vb, e, dtype)
    node_ok = rng.random(e) < 0.5  # a node mask evaluated at the endpoints
    kw = dict(
        ok=ok if form == "ok_vec" else None,
        node_ok=node_ok if form == "node_ok" else None,
        emask=emask if masked else None,
        eid=eid if masked and walk == "in" else None,
        w=w if weights else None,
    )
    want = _jax_chain(emit, dtype, **kw)
    tdtype = torch.int32 if dtype == np.int32 else torch.float32
    targs = {k: None if v is None else _t(v) for k, v in kw.items()}
    _same_bits(K.weight_gather(_t(emit), tdtype, **targs), want)
    _same_bits(K.plain_weight_gather(_t(emit), tdtype, **targs), want)


@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["i32", "f32"])
@pytest.mark.parametrize("v", [1, 8, 3000])
def test_two_chained_weight_steps_equal_reference(v, dtype):
    """Two hops of the weight chain on one CSR, as the engine runs them:
    the last hop's values (the vertex mask alone) summed per source by the
    segment sum, then the first hop's (an edge mask and those weights),
    against the reference's take_pad / & / astype / * and
    indptr_segment_sum."""
    rng = np.random.default_rng(v)
    deg = rng.poisson(3.0, v)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    dst = rng.integers(0, v, int(deg.sum()), dtype=np.int32)
    vb = int(K.bucket(v))
    ok = np.zeros(vb, bool)
    ok[:v] = rng.random(v) < 0.5
    emask = rng.random(dst.shape[0]) < 0.6
    tdtype = torch.int32 if dtype == np.int32 else torch.float32
    w = K.indptr_segment_sum(K.weight_gather(_t(dst), tdtype, ok=_t(ok)), _t(indptr), vb)
    jw = J.indptr_segment_sum(jnp.asarray(_jax_chain(dst, dtype, ok=ok)), jnp.asarray(indptr), vb)
    _same_bits(w, np.asarray(jw))
    got = K.weight_gather(_t(dst), tdtype, ok=_t(ok), emask=_t(emask), w=w)
    _same_bits(got, _jax_chain(dst, dtype, ok=ok, emask=emask, w=np.asarray(jw)))


@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["i32", "f32"])
@pytest.mark.parametrize("walk", ["out", "in"])
def test_folded_weights_equal_reference_chain(walk, dtype):
    """The engine's other form of a step with a [vb] vertex mask and
    weights: the mask folded into the weights first (``emit=None``, ``ok ?
    w : 0`` over [vb]), then one gather an edge with the edge mask alone,
    against the reference's chain on the same operands (-1 and past-the-end
    endpoints included)."""
    rng = np.random.default_rng(zlib.crc32(f"fold {walk} {np.dtype(dtype).name}".encode()))
    vb, e = 64, 700
    emit, ok, emask, eid, w = _operands(rng, vb, e, dtype)
    w[rng.random(vb) < 0.2] = 0  # zero weights, as a vertex with no match past it has
    tdtype = torch.int32 if dtype == np.int32 else torch.float32
    folded = K.weight_gather(None, tdtype, ok=_t(ok), w=_t(w))
    _same_bits(folded, _jax_chain(np.arange(vb, dtype=np.int32), dtype, ok=ok, w=w))
    in_walk = walk == "in"
    got = K.weight_gather(_t(emit), tdtype, emask=_t(emask), eid=_t(eid) if in_walk else None, w=folded)
    _same_bits(got, _jax_chain(emit, dtype, ok=ok, emask=emask, eid=eid if in_walk else None, w=w))


def test_weight_gather_edge_cases():
    i32 = torch.int32
    emit = torch.tensor([-1, 0, 2, 9], dtype=i32)
    # an empty vertex mask and empty weights read their fills
    assert torch.equal(K.weight_gather(emit, i32, ok=torch.zeros(0, dtype=torch.bool)), torch.zeros(4, dtype=i32))
    assert torch.equal(K.weight_gather(emit, i32, w=torch.zeros(0, dtype=i32)), torch.zeros(4, dtype=i32))
    # no mask and no weights: every edge counts once
    assert torch.equal(K.weight_gather(emit, i32), torch.ones(4, dtype=i32))
    assert K.weight_gather(emit[:0], torch.float32).shape == (0,)
    with pytest.raises(ValueError):
        K.weight_gather(None, i32, ok=torch.ones(4, dtype=torch.bool))  # nothing to fold into
    with pytest.raises(ValueError):
        K.weight_gather(emit, i32, eid=emit)  # eid without emask
    with pytest.raises(ValueError):
        K.weight_gather(emit, i32, emask=torch.ones(3, dtype=torch.bool))  # a direct mask of another length
    with pytest.raises(TypeError):
        K.weight_gather(emit, i32, w=torch.ones(4, dtype=torch.float32))
    with pytest.raises(TypeError):
        K.weight_gather(emit, torch.int64)


@pytest.mark.parametrize("n,offset", [(0, 0), (1, 1), (257, 3), (4096, 15)])
def test_take_pad_of_unaligned_index(n, offset):
    """An index slice that starts ``offset`` elements into its buffer (a
    chunk of rows) gathers as the reference does, into a fresh output."""
    rng = np.random.default_rng(n + offset)
    vals = _t(rng.integers(-100, 100, 50, dtype=np.int32))
    buf = _t(rng.integers(-2, 53, n + offset, dtype=np.int32))
    idx = buf[offset:]
    got = K.take_pad(vals, idx, -1)
    assert got.shape == idx.shape and got.dtype == vals.dtype
    want = np.asarray(J.take_pad(jnp.asarray(vals.numpy()), jnp.asarray(idx.numpy()), -1))
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the COUNT statements whose pushdown runs the fused gather
# ---------------------------------------------------------------------------

Q1 = "MATCH {class:Person, as:p, where:(age > 40)}-knows->{as:f, where:(age < 30)} RETURN count(*) AS n"
Q2 = (
    "MATCH {class:Person, as:p, where:(age > 40)}-knows->{as:f}"
    "-knows->{as:g, where:(age < 30)} RETURN count(*) AS n"
)
Q_IN = "MATCH {class:Person, as:p, where:(age > 40)}<-knows-{as:f, where:(age < 30)} RETURN count(*) AS n"
E1 = (
    "MATCH {class:Person, as:p, where:(age > 40)}"
    ".outE('knows'){where:(creationDate > :d)}"
    ".inV(){as:f, where:(age < 30)}, "
    "{class:Message, as:m}-hasCreator->{as:f} "
    "RETURN count(*) AS n"
)
E_IN = (
    "MATCH {class:Person, as:p, where:(age > 40)}"
    ".inE('knows'){where:(creationDate > :d)}"
    ".outV(){as:f, where:(age < 30)} RETURN count(*) AS n"
)


class _Spy:
    """Counts the weight step's fused gathers (a walk's, and the folds of a
    vertex mask into the weights) and the bool take_pads made while a
    statement runs."""

    def __init__(self, monkeypatch):
        self.fused = self.folds = self.bool_takes = 0
        fused, take = K.weight_gather, K.take_pad

        def weight_gather(emit, *a, **kw):
            if emit is None:
                self.folds += 1
            else:
                self.fused += 1
            return fused(emit, *a, **kw)

        def take_pad(values, *a, **kw):
            self.bool_takes += values.dtype == torch.bool
            return take(values, *a, **kw)

        monkeypatch.setattr(K, "weight_gather", weight_gather)
        monkeypatch.setattr(K, "take_pad", take_pad)


def _runs_fused(monkeypatch, db, sql, params, want, walks: int, folds: int = 0):
    """The port's recording and replay give ``want``; the recording runs
    the int32 chain and its float32 twin, the replay the int32 chain: one
    fused gather a walk (a hop's edge class and direction) and one fold of
    a [vb] vertex mask into the weights a step that has a walk to gather
    them, each, and no bool take_pad."""
    spy = _Spy(monkeypatch)
    for call in ("record", "replay"):
        assert db.query(sql, params).to_dicts() == want, (sql, params, call)
    monkeypatch.undo()
    assert (spy.fused, spy.folds) == (3 * walks, 3 * folds), (sql, spy.fused, spy.folds)
    assert spy.bool_takes == 0, sql


@pytest.mark.parametrize("avg", [1, 8], ids=["E_lt_vb", "E_ge_vb"])
def test_person_knows_counts_run_the_fused_gather(monkeypatch, avg):
    """Q1, Q2 and an in walk on array-native Person–knows graphs (no
    records, so the oracle cannot run there): the reference's
    ``engine="tpu"`` and the exact numpy counts."""
    jdb, _ = j_build_person_knows(3_000, avg_knows=avg, seed=11)
    db, snap = build_person_knows(3_000, avg_knows=avg, seed=11, device="cpu")
    E = snap.edge_classes["knows"].num_edges
    assert (E >= K.bucket(snap.num_vertices)) == (avg == 8)
    age = snap.v_columns["age"].values
    numpy = {
        Q1: numpy_1hop_count(snap, age > 40, age < 30),
        Q2: numpy_2hop_count(snap, age > 40, np.ones(age.shape[0], bool), age < 30),
    }
    # Q2's first step carries weights; it folds them where the step reads
    # the [vb] vertex mask (E >= vb)
    for sql, walks, folds in ((Q1, 1, 0), (Q2, 2, int(avg == 8)), (Q_IN, 1, 0)):
        want = jdb.query(sql, engine="tpu", strict=True).to_dicts()
        if sql in numpy:
            assert want == [{"n": numpy[sql]}]
        _runs_fused(monkeypatch, db, sql, None, want, walks, folds)


@pytest.fixture(scope="module")
def snb_pair():
    jdb, _ = j_build_snb_shape(1_000, msgs_per_person=2, avg_knows=10, seed=7)
    db, snap = build_snb_shape(1_000, msgs_per_person=2, avg_knows=10, seed=7, device="cpu")
    return db, snap, jdb


@pytest.mark.parametrize("d", [12_000, 18_500])
def test_snb_counts_run_the_fused_gather(monkeypatch, snb_pair, d):
    """E1 and its in walk on the SNB shape: the reference's ``engine="tpu"``
    and (E1) the exact numpy count."""
    db, snap, jdb = snb_pair
    # E1's knows step carries hasCreator's weights to a [vb] vertex mask
    for sql, walks, folds in ((E1, 2, 1), (E_IN, 1, 0)):
        TE._plan_cache(snap).clear()
        want = jdb.query(sql, {"d": d}, engine="tpu", strict=True).to_dicts()
        if sql == E1:
            assert want == [{"n": numpy_config5_count(snap, d)}]
        _runs_fused(monkeypatch, db, sql, {"d": d}, want, walks, folds)


#: the same shapes on a graph with records, where the oracle runs too:
#: Q1, Q2, E1 (an edge WHERE and a second pattern), an in walk with an
#: edge WHERE (the mask read through edge_id_in), both directions, and the
#: weights of a later hop through both; each with its walks and its folds
#: (every class here has E >= vb: one a step that carries weights to a walk
#: that reads no edge mask through edge ids)
RECORD_COUNTS = [
    ("MATCH {class:Person, as:a, where:(age > 40)}-Knows->{as:b, where:(age < 50)} RETURN count(*) AS n", 1, 0),
    ("MATCH {class:Person, as:a, where:(age > 40)}-Knows->{as:b}-Knows->{as:c, where:(age < 30)} RETURN count(*) AS n", 2, 1),
    (
        "MATCH {class:Person, as:a, where:(age > 40)}.outE('Follows'){where:(w > 1)}.inV(){as:b, where:(age < 50)}, "
        "{class:Person, as:c}-Knows->{as:b} RETURN count(*) AS n",
        2,
        1,
    ),
    ("MATCH {class:Person, as:a, where:(age > 30)}.inE('Follows'){where:(w > 1)}.outV(){as:b} RETURN count(*) AS n", 1, 0),
    ("MATCH {class:Person, as:a, where:(age < 60)}-Follows{where:(w < 4)}-{as:b, where:(age > 20)} RETURN count(*) AS n", 2, 0),
    (
        "MATCH {class:Person, as:a, where:(age > 40)}.inE('Follows'){where:(w > 1)}.outV(){as:b}"
        "-Knows->{as:c, where:(age < 30)} RETURN count(*) AS n",
        2,
        0,
    ),
    (
        "MATCH {class:Person, as:a, where:(age > 40)}-Follows{where:(w < 4)}-{as:b}"
        "-Knows->{as:c, where:(age < 30)} RETURN count(*) AS n",
        3,
        1,
    ),
]


@pytest.mark.parametrize("n", [40, 600])
def test_record_graph_counts_equal_both_engines(monkeypatch, n):
    """The fuzz suite's record graphs (two to four edges a vertex: the [vb]
    vertex-mask form; the other form runs on the sparse Person–knows
    graph above)."""
    jdb = random_db(5, n)
    db, snap = snapshot_from_arrays(*_carry_arrays(jdb, jdb.current_snapshot()), device="cpu")
    vb = K.bucket(snap.num_vertices)
    assert all(e.num_edges >= vb for e in snap.edge_classes.values() if e.num_edges)
    for sql, walks, folds in RECORD_COUNTS:
        want = jdb.query(sql, engine="tpu", strict=True).to_dicts()
        assert jdb.query(sql, engine="oracle").to_dicts() == want, sql
        _runs_fused(monkeypatch, db, sql, None, want, walks, folds)
