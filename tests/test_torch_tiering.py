"""Tiered snapshots in the port (`orientdb_tpu_torch/storage/tiering.py`)
against the reference's tier plane (`orientdb_tpu/storage/tiering.py`), on
the CPU.

The fixture mirrors `tests/test_tiering.py`'s: demodb with 200 profiles,
``avg_friends=6``, ``seed=3``, blocks of 32 edges and the cap at half the
flat adjacency, attached tiered in both packages (the graph carried into the
port with `carry.snapshot_from_arrays`). The file holds the partition layout
equal to the reference's, the plain versions of K19–K21 equal to the
reference's jitted `paged_hop` / `paged_hop_miss` / `paged_expand` on the
same pools exactly, the tiered queries equal to both reference engines
(recorded and replayed), the residency accounting, and the refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientdb_tpu.exec.result import canonical_rows as j_canonical_rows
from orientdb_tpu.ops.device_graph import device_graph as j_device_graph
from orientdb_tpu.storage import tiering as jt
from orientdb_tpu.storage.ingest import generate_demodb
from orientdb_tpu.storage.snapshot import attach_fresh_snapshot
from orientdb_tpu.utils.config import config as jconfig
from orientdb_tpu_torch.carry import snapshot_from_arrays
from orientdb_tpu_torch.exec import tpu_engine as TE
from orientdb_tpu_torch.exec.result import canonical_rows
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.ops.device_graph import device_graph
from orientdb_tpu_torch.ops.predicates import Uncompilable
from orientdb_tpu_torch.storage import tiering
from orientdb_tpu_torch.storage.deltas import arm_delta_maintenance, pad_for_deltas
from orientdb_tpu_torch.utils.config import config
from test_torch_match import _carry_arrays
from test_torch_push_hops import EXPAND_CASES, expand_sources, paged_pool

COUNT_2HOP = (
    "MATCH {class:Profiles, as:p, where:(uid = :u)}"
    "-HasFriend->{as:f}-HasFriend->{as:g} RETURN count(*) AS n"
)
ROWS_1HOP = (
    "MATCH {class:Profiles, as:p, where:(uid = :u)}"
    "-HasFriend->{as:f, where:(age < 40)} RETURN f.uid AS fu"
)
VAR_DEPTH = (
    "MATCH {class:Profiles, as:p, where:(uid = :u)}"
    "-HasFriend->{as:f, while:($depth < 3), where:(age < 30)} "
    "RETURN count(*) AS n"
)
NOT_ARM = (
    "MATCH {class:Profiles, as:p, where:(uid = :u)}-HasFriend->{as:f}, "
    "NOT {as:f}-HasFriend->{where:(age > 50)} RETURN f.uid AS fu"
)
REVERSE_ROWS = (
    "MATCH {class:Profiles, as:p, where:(uid = :u)}<-HasFriend-{as:f} "
    "RETURN p.uid AS pu, f.uid AS fu"
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _attach_both(monkeypatch):
    """The reference's demodb attached tiered, and its arrays carried into a
    tiered port snapshot under the same cap."""
    monkeypatch.setattr(jconfig, "view_min_calls", 1 << 30)
    monkeypatch.setattr(jconfig, "tier_block_edges", 32)
    monkeypatch.setattr(config, "tier_block_edges", 32)
    jdb = generate_demodb(n_profiles=200, avg_friends=6, seed=3)
    jsnap = attach_fresh_snapshot(jdb)
    adj = jt.adjacency_bytes(jsnap)
    jdb.detach_snapshot()
    cap = max(1, adj // 2)
    monkeypatch.setattr(jconfig, "tier_hbm_cap_bytes", cap)
    monkeypatch.setattr(config, "tier_hbm_cap_bytes", cap)
    jsnap = attach_fresh_snapshot(jdb)
    assert jsnap._tier is not None
    db, snap = snapshot_from_arrays(*_carry_arrays(jdb, jsnap), device="cpu")
    assert snap._tier is not None and tiering.adjacency_bytes(snap) == adj
    return jdb, jsnap, db, snap


@pytest.fixture
def tiered(monkeypatch):
    jdb, jsnap, db, snap = _attach_both(monkeypatch)
    yield jdb, jsnap, db, snap
    jdb.detach_snapshot()


def _rows(db, sql, params):
    return canonical_rows(db.query(sql, params).to_dicts())


def _ref_rows(jdb, sql, params, engine):
    kw = {"strict": True} if engine == "tpu" else {}
    return j_canonical_rows(jdb.query(sql, params=params, engine=engine, **kw).to_dicts())


def _counts(tier):
    st = tier.stats()
    return st["prefetch_hits"], st["prefetch_misses"], st["evictions"]


# ---------------------------------------------------------------------------
# 1. layout
# ---------------------------------------------------------------------------


def test_partition_layout_equals_reference(tiered):
    jdb, jsnap, db, snap = tiered
    j_device_graph(jsnap)
    device_graph(snap, db.device)
    jtier, tier = jsnap._tier, snap._tier
    assert set(tier.parts) == set(jtier.parts)
    assert len(tier.parts) == 4  # HasFriend and Likes, both directions
    for key, jp in jtier.parts.items():
        p = tier.parts[key]
        assert (p.V, p.E, p.W, p.Wp, p.B, p.P) == (jp.V, jp.E, jp.W, jp.Wp, jp.B, jp.P), key
        for name in ("block_of_v", "edge_start", "prio", "page_of", "block_of_page"):
            assert np.array_equal(getattr(p, name), getattr(jp, name)), (key, name)
        assert sorted(p.free_pages) == sorted(jp.free_pages)
        for name in ("own", "nbr", "eid"):
            assert np.array_equal(p.host[name], jp.host[name]), (key, name)
    # the pools the port uploaded equal the reference's, page for page
    jarr, arr = jtier._dg.arrays, tier._dg.arrays
    for cname, d in tier.parts:
        for name, key in tiering._keys(cname, d).items():
            assert np.array_equal(arr[key].numpy(), np.asarray(jarr[key])), key
    assert tier.stats()["pool_bytes"] == jtier.stats()["pool_bytes"]
    assert tier.hot_bytes() == jtier.hot_bytes()


# ---------------------------------------------------------------------------
# 2. the paged kernels' plain versions against the reference's functions
# ---------------------------------------------------------------------------


def _ref_arrays(jsnap):
    """The reference device graph's arrays as numpy, after faulting a few
    blocks in so the pools hold resident, free and evicted pages."""
    jtier = jsnap._tier
    j_device_graph(jsnap)
    for key, part in jtier.parts.items():
        for b in range(0, part.B, 5):
            jtier.ensure_vertices(part.cname, part.d, np.nonzero(part.block_of_v == b)[0][:1])
    return {k: np.asarray(v) for k, v in jtier._dg.arrays.items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


@pytest.mark.parametrize("d", ["out", "in"])
def test_paged_kernels_equal_reference(tiered, d):
    jdb, jsnap, db, snap = tiered
    arrays = _ref_arrays(jsnap)
    part = jsnap._tier.parts[("HasFriend", d)]
    keys = tiering._keys("HasFriend", d)
    V, E = part.V, part.E
    vb = K.bucket(V)
    rng = np.random.default_rng(7)
    assert (arrays[keys["pageof"]] < 0).any(), "cold blocks expected at cap/2"
    # an evicted page as `TierManager._evict` leaves it: its owner row -1
    # and its block's pageof -1, its nbr/eid rows stale, while vertex 0 (the
    # clip target of a -1 endpoint) is in every frontier row
    ev = dict(arrays)
    own = ev[keys["own"]].copy()
    stale = int(np.nonzero((own >= 0).any(axis=1))[0][0])
    own[stale] = -1
    ev[keys["own"]] = own
    pageof = ev[keys["pageof"]].copy()
    assert (pageof == stale).sum() == 1
    pageof[pageof == stale] = -1
    ev[keys["pageof"]] = pageof
    # an eid row with -1 eids under live owners
    neg = dict(arrays)
    eid = neg[keys["eid"]].copy()
    eid[(arrays[keys["own"]] >= 0) & (rng.random(eid.shape) < 0.3)] = -1
    neg[keys["eid"]] = eid
    emask = rng.random(E) < 0.6
    for arr in (arrays, ev, neg):
        for C in (1, 3):
            fr = rng.random((C, vb)) < 0.2
            fr[:, 0] = True
            gate = rng.random(vb) < 0.7
            push = [_t(arr[k]) for k in (f"e:HasFriend:indptr_{d}", keys["blockv"], keys["pageof"], keys["estart"], keys["nbr"], keys["eid"])]
            for m in (None, emask):
                want = np.asarray(jt.paged_hop(_j(arr), "HasFriend", d, None if m is None else jnp.asarray(m), jnp.asarray(fr)))
                got = K.plain_paged_hop(
                    _t(arr[keys["own"]]), _t(arr[keys["nbr"]]), _t(arr[keys["eid"]]),
                    None if m is None else _t(m), _t(fr),
                )
                assert np.array_equal(got.numpy(), want)
                # K19's push (the wrapper's CPU path) reaches the same bits
                got = K.paged_hop_csr(*push, None if m is None else _t(m), _t(fr))
                assert np.array_equal(got.numpy(), want)
                # the gate folds in as the reference's frontier & gate
                want_g = np.asarray(jt.paged_hop(_j(arr), "HasFriend", d, None if m is None else jnp.asarray(m), jnp.asarray(fr & gate)))
                got_g = K.plain_paged_hop(
                    _t(arr[keys["own"]]), _t(arr[keys["nbr"]]), _t(arr[keys["eid"]]),
                    None if m is None else _t(m), _t(fr), _t(gate),
                )
                assert np.array_equal(got_g.numpy(), want_g)
                got_g = K.paged_hop_csr(*push, None if m is None else _t(m), _t(fr), _t(gate))
                assert np.array_equal(got_g.numpy(), want_g)
                zero = torch.tensor(0, dtype=torch.int32)
                assert not K.paged_hop_csr(*push, None if m is None else _t(m), _t(fr), alive=zero).any()
            ip = arr[f"e:HasFriend:indptr_{d}"]
            for g in (None, gate):
                f_eff = fr if g is None else fr & g
                want = bool(jt.paged_hop_miss(_j(arr), "HasFriend", d, jnp.asarray(f_eff)))
                got = K.plain_paged_hop_miss(
                    _t(fr), _t(arr[keys["blockv"]]), _t(arr[keys["pageof"]]), _t(ip),
                    None if g is None else _t(g),
                )
                assert bool(got) == want
        # an empty frontier never flags; a frontier over everything does
        for fill, flag in ((False, False), (True, True)):
            fr = np.full((2, vb), fill)
            got = K.plain_paged_hop_miss(_t(fr), _t(arr[keys["blockv"]]), _t(arr[keys["pageof"]]), _t(arr[f"e:HasFriend:indptr_{d}"]))
            assert bool(got) == flag
        # the gather: padding sources, resident and cold blocks
        ip = arr[f"e:HasFriend:indptr_{d}"]
        for R in (1, 7, 64):
            srcs = rng.integers(-1, V, R).astype(np.int32)
            counts = np.where(srcs >= 0, ip[np.clip(srcs, 0, V - 1) + 1] - ip[np.clip(srcs, 0, V - 1)], 0)
            offsets = (np.cumsum(counts) - counts).astype(np.int32)
            total = int(counts.sum())
            out_size = K.bucket(max(total, 1))
            want = jt.paged_expand(
                _j(arr), "HasFriend", d, jnp.asarray(srcs), jnp.asarray(offsets), jnp.int32(total), out_size, part.Wp
            )
            got = K.plain_paged_expand(
                _t(ip), _t(srcs), _t(offsets), torch.tensor(total, dtype=torch.int32), out_size,
                _t(arr[keys["blockv"]]), _t(arr[keys["pageof"]]), _t(arr[keys["estart"]]),
                _t(arr[keys["nbr"]]), None if d == "out" else _t(arr[keys["eid"]]), d == "out",
            )
            for g, w in zip(got[:3], want[:3]):
                assert np.array_equal(g.numpy(), np.asarray(w))
            assert bool(got[3]) == bool(want[3])


@pytest.mark.parametrize("d", ["out", "in"])
def test_paged_push_flag_equals_reference(tiered, d):
    """K20 folded into K19: the push's cold-miss flag (`paged_hop_csr`'s
    ``miss`` on the CPU, `plain_paged_hop_csr`) equals the reference's
    jitted `paged_hop_miss` on the tiering fixture's pools, with every block
    evicted and with an empty pool (no page at all), with and without a
    WHILE gate (the reference's frontier & gate), and is never set by an
    empty frontier or ``alive`` 0."""
    jdb, jsnap, db, snap = tiered
    arrays = _ref_arrays(jsnap)
    keys = tiering._keys("HasFriend", d)
    vb = K.bucket(jsnap._tier.parts[("HasFriend", d)].V)
    rng = np.random.default_rng(11)
    evicted = dict(arrays)
    evicted[keys["pageof"]] = np.full_like(arrays[keys["pageof"]], -1)
    evicted[keys["own"]] = np.full_like(arrays[keys["own"]], -1)
    empty = dict(evicted)
    for n in ("own", "nbr", "eid"):
        empty[keys[n]] = arrays[keys[n]][:0]
    zero = torch.tensor(0, dtype=torch.int32)
    flagged = []
    for arr in (arrays, evicted, empty):
        push = [_t(arr[k]) for k in (f"e:HasFriend:indptr_{d}", keys["blockv"], keys["pageof"], keys["estart"], keys["nbr"], keys["eid"])]
        bv = arr[keys["blockv"]]
        hot = np.zeros(vb, bool)  # vertices whose block is resident: no miss
        hot[: bv.shape[0]] = (bv >= 0) & (arr[keys["pageof"]][np.clip(bv, 0, None)] >= 0)
        for C, fr in ((1, rng.random((1, vb)) < 0.2), (3, rng.random((3, vb)) < 0.2), (2, (rng.random((2, vb)) < 0.5) & hot)):
            gate = rng.random(vb) < 0.7
            for g in (None, gate):
                f_eff = fr if g is None else fr & g
                want = bool(jt.paged_hop_miss(_j(arr), "HasFriend", d, jnp.asarray(f_eff)))
                tg = None if g is None else _t(g)
                miss = torch.zeros((), dtype=torch.bool)
                K.paged_hop_csr(*push, None, _t(fr), tg, miss=miss)
                assert bool(miss) == want
                plain = torch.zeros((), dtype=torch.bool)
                K.plain_paged_hop_csr(*push, None, _t(fr), tg, miss=plain)
                assert bool(plain) == want
                flagged.append(want)
                for f, a in ((np.zeros_like(fr), None), (fr, zero)):
                    miss = torch.zeros((), dtype=torch.bool)
                    K.paged_hop_csr(*push, None, _t(f), tg, a, miss=miss)
                    assert not bool(miss)
    assert any(flagged) and not all(flagged)


def _pool_arrays(d, indptr, part, pools, pageof):
    """A synthetic partition's arrays under the tier plane's keys."""
    k = tiering._keys("c", d)
    arrays = {f"e:c:indptr_{d}": indptr, k["blockv"]: part.block_of_v, k["pageof"]: pageof,
              k["estart"]: part.edge_start}
    arrays.update({k[n]: pools[n] for n in ("own", "nbr", "eid")})
    return arrays


@pytest.mark.parametrize("d", ["out", "in"])
@pytest.mark.parametrize("v,avg,block_edges,pages,hub,empty", EXPAND_CASES)
def test_paged_expand_equals_reference_under_skew(d, v, avg, block_edges, pages, hub, empty):
    """K21's plain version and its wrapper's CPU path equal the reference's
    jitted `paged_expand` on skewed partitions: a row longer than the
    gather's 2,048-item tile, zero-degree, -1 and repeated sources, cold
    blocks and an evicted page, every page evicted, an empty pool, and an
    output shorter than the total. With ``flag`` the cold miss is ORed into
    the caller's byte, which is returned as the flag and never cleared."""
    rng = np.random.default_rng(v + hub + (d == "in"))
    indptr, part, pools, pageof = paged_pool(rng, v, avg, block_edges, pages, hub, empty)
    no_pool = {n: np.zeros((0, part.Wp), np.int32) for n in pools}
    evicted = np.full_like(pageof, -1)
    flags = []
    # the reference cannot take from an empty pool: with every page evicted
    # no slot reads it, so the evicted pool's answer is the empty one's
    for pl, pg, ref_pl in ((pools, pageof, pools), (pools, evicted, pools), (no_pool, evicted, pools)):
        arrays = _pool_arrays(d, indptr, part, pl, pg)
        ref = _j(_pool_arrays(d, indptr, part, ref_pl, pg))
        k = tiering._keys("c", d)
        hot = np.nonzero(pg[part.block_of_v] >= 0)[0]
        for width, among in ((1, None), (64, None), (700, None), (40, hot if hot.size else None)):
            srcs, offsets, total = expand_sources(rng, indptr, width, among)
            for out_size in {K.bucket(max(total, 1)), max(8, K.bucket(max(total, 1)) // 4)}:
                want = jt.paged_expand(
                    ref, "c", d, jnp.asarray(srcs), jnp.asarray(offsets), jnp.int32(total), out_size, part.Wp
                )
                args = (
                    _t(indptr), _t(srcs), _t(offsets), torch.tensor(total, dtype=torch.int32), out_size,
                    _t(arrays[k["blockv"]]), _t(arrays[k["pageof"]]), _t(arrays[k["estart"]]),
                    _t(arrays[k["nbr"]]), None if d == "out" else _t(arrays[k["eid"]]), d == "out",
                )
                for got in (K.plain_paged_expand(*args), K.paged_expand(*args)):
                    for g, w in zip(got[:3], want[:3]):
                        assert np.array_equal(g.numpy(), np.asarray(w))
                    assert bool(got[3]) == bool(want[3])
                flag = torch.zeros((), dtype=torch.bool)
                got = K.paged_expand(*args, flag=flag)
                assert got[3] is flag and bool(flag) == bool(want[3])
                stay = torch.ones((), dtype=torch.bool)
                assert bool(K.paged_expand(*args, flag=stay)[3])
                flags.append(bool(want[3]))
    assert any(flags) and not all(flags)


def test_replay_expansion_shares_the_miss_byte(tiered, monkeypatch):
    """A replay's paged expansion passes the schedule's one miss byte to
    K21 (no flag of its own, no OR into the overflow), a recording passes
    none; the rows stay equal to the reference's."""
    jdb, jsnap, db, snap = tiered
    seen, notes = [], []
    expand, miss_flag = tiering.paged_expand, TE.SizeSchedule.miss_flag

    def spy_expand(*a, **kw):
        seen.append(a[7] if len(a) > 7 else kw.get("flag"))
        return expand(*a, **kw)

    def spy_miss(sched, device):
        out = miss_flag(sched, device)
        notes.append(("miss", out))
        return out

    monkeypatch.setattr(tiering, "paged_expand", spy_expand)
    monkeypatch.setattr(TE.SizeSchedule, "miss_flag", spy_miss)
    monkeypatch.setattr(TE.SizeSchedule, "note_flag", lambda s, f: notes.append(("note", f)))
    p = {"u": 5}
    want = _ref_rows(jdb, ROWS_1HOP, p, "oracle")
    assert _rows(db, ROWS_1HOP, p) == want  # records
    assert seen == [None] and not notes
    assert _rows(db, ROWS_1HOP, p) == want  # replays
    (variants,) = TE._plan_cache(snap).values()
    assert variants.plans[0].replays == 1
    assert len(seen) == 2 and seen[1] is not None
    assert [n for n, _ in notes] == ["miss"] and notes[0][1] is seen[1]


def test_paged_wrappers_take_the_plain_path_on_the_cpu(tiered):
    """The wrappers on CPU tensors equal their plain versions, and ``out``
    accumulates like K10's."""
    jdb, jsnap, db, snap = tiered
    dg = device_graph(snap, db.device)
    part = snap._tier.parts[("HasFriend", "out")]
    vb = K.bucket(part.V)
    fr = torch.zeros((2, vb), dtype=torch.bool)
    fr[0, :50] = True
    fr[1, 0] = True
    a = dg.arrays
    k = tiering._keys("HasFriend", "out")
    got = tiering.paged_hop(a, "HasFriend", "out", None, fr)
    push = (a["e:HasFriend:indptr_out"], a[k["blockv"]], a[k["pageof"]], a[k["estart"]], a[k["nbr"]], a[k["eid"]])
    want = K.plain_paged_hop_csr(*push, None, fr)
    assert torch.equal(got, want)
    # on the manager's pool the push equals the reference's slot walk
    assert torch.equal(got, K.plain_paged_hop(a[k["own"]], a[k["nbr"]], a[k["eid"]], None, fr))
    acc = torch.zeros_like(fr)
    acc[:, -1] = True
    tiering.paged_hop(a, "HasFriend", "out", None, fr, out=acc)
    assert torch.equal(acc, want | (torch.arange(vb) == vb - 1)[None, :])
    assert not bool(tiering.paged_hop_miss(a, "HasFriend", "out", fr, alive=torch.tensor(0, dtype=torch.int32)))


# ---------------------------------------------------------------------------
# 3. queries: equal to both reference engines, recorded and replayed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "sql", [COUNT_2HOP, ROWS_1HOP, VAR_DEPTH, NOT_ARM, REVERSE_ROWS],
    ids=["count_2hop", "rows_1hop", "var_depth", "not_arm", "reverse_rows"],
)
def test_tiered_queries_equal_both_engines(tiered, sql):
    jdb, jsnap, db, snap = tiered
    for u in (0, 57, 131, 199, 57, 0):
        p = {"u": u}
        want = _ref_rows(jdb, sql, p, "oracle")
        assert _ref_rows(jdb, sql, p, "tpu") == want
        assert _rows(db, sql, p) == want, u
    (variants,) = TE._plan_cache(snap).values()
    assert sum(plan.replays for plan in variants.plans) > 0
    st = snap._tier.stats()
    assert st["partitions"] == 4 and st["prefetch_misses"] > 0


# ---------------------------------------------------------------------------
# 4. residency
# ---------------------------------------------------------------------------


def test_miss_then_hit_counts_equal_reference(tiered):
    """The same query sequence and faults give the reference's hits,
    misses and evictions (no pool grows at a dispatch here; see
    `test_pool_growth_recaptures` for the one place the counts part)."""
    jdb, jsnap, db, snap = tiered
    jtier, tier = jsnap._tier, snap._tier
    for sql, u in ((COUNT_2HOP, 9), (COUNT_2HOP, 9), (ROWS_1HOP, 3), (ROWS_1HOP, 3), (COUNT_2HOP, 57)):
        db.query(sql, {"u": u}).to_dicts()
        jdb.query(sql, params={"u": u}, engine="tpu", strict=True).to_dicts()
        assert _counts(tier) == _counts(jtier), (sql, u)
    assert tier.generation == 0
    part, jpart = tier.parts[("HasFriend", "out")], jtier.parts[("HasFriend", "out")]
    cold = np.nonzero(part.page_of < 0)[0]
    assert cold.size and np.array_equal(part.page_of, jpart.page_of)
    v = np.nonzero(part.block_of_v == int(cold[0]))[0][:1]
    h0, m0, _ = _counts(tier)
    for t in (tier, jtier):
        t.ensure_vertices("HasFriend", "out", v)
    h1, m1, _ = _counts(tier)
    assert (h1, m1) == (h0, m0 + 1) and _counts(tier) == _counts(jtier)
    for t in (tier, jtier):
        t.ensure_vertices("HasFriend", "out", v)
    assert _counts(tier) == (h1 + 1, m1, _counts(tier)[2]) and _counts(tier) == _counts(jtier)
    # the page the miss loaded holds the block's values on the "device"
    k = tiering._keys("HasFriend", "out")
    b = int(cold[0])
    p = int(part.page_of[b])
    for name in ("own", "nbr", "eid"):
        assert np.array_equal(tier._dg.arrays[k[name]][p].numpy(), part.block_values(name, b))
    assert np.array_equal(tier._dg.arrays[k["pageof"]].numpy(), part.page_of)


def test_replay_hits_resident_footprint(tiered):
    jdb, jsnap, db, snap = tiered
    p = {"u": 42}
    db.query(COUNT_2HOP, p).to_dicts()
    hits0 = snap._tier.stats()["prefetch_hits"]
    loaded0 = snap._tier.stats()["loaded_bytes"]
    assert _rows(db, COUNT_2HOP, p) == _ref_rows(jdb, COUNT_2HOP, p, "oracle")
    (variants,) = TE._plan_cache(snap).values()
    assert variants.plans[0].replays == 1
    st = snap._tier.stats()
    assert st["prefetch_hits"] > hits0 and st["loaded_bytes"] == loaded0
    # the replay's pins were released
    assert all(not part.pins for part in snap._tier.parts.values())


def test_pinned_footprint_survives_churn(tiered):
    """A dispatch's pinned footprint is evicted last: churning every other
    block of the partition through the pool evicts around it, and the
    pinned page keeps its block's values."""
    jdb, jsnap, db, snap = tiered
    p0 = {"u": 3}
    baseline = _ref_rows(jdb, COUNT_2HOP, p0, "oracle")
    assert _rows(db, COUNT_2HOP, p0) == baseline
    tier = snap._tier
    part = max(tier.parts.values(), key=lambda p: p.B)
    resident = np.nonzero(part.page_of >= 0)[0]
    b = int(resident[0])
    fp = frozenset({((part.cname, part.d), b)})
    tier.prepare_dispatch(fp)
    ev0 = tier.stats()["evictions"]
    try:
        for blk in range(part.B):
            v = np.nonzero(part.block_of_v == blk)[0][:1]
            tier.ensure_vertices(part.cname, part.d, v)
    finally:
        tier.release_footprint(fp)
    assert tier.stats()["evictions"] > ev0
    assert part.page_of[b] >= 0 and not part.pins
    k = tiering._keys(part.cname, part.d)
    page = int(part.page_of[b])
    for name in ("own", "nbr", "eid"):
        assert np.array_equal(tier._dg.arrays[k[name]][page].numpy(), part.block_values(name, b))
    assert _rows(db, COUNT_2HOP, p0) == baseline


def test_cold_miss_replay_rerecords(tiered):
    """A replay whose root's block lies outside its footprint raises the
    cold-miss flag in its meta row (the sizes fit: the flag is the tier's),
    and the front door re-records it into a second variant with the right
    rows; once the block is resident the same replay is clean."""
    jdb, jsnap, db, snap = tiered
    tier = snap._tier
    part = tier.parts[("HasFriend", "out")]
    ip = snap.edge_classes["HasFriend"].indptr_out
    deg = np.diff(ip)
    u0 = 0
    assert _rows(db, ROWS_1HOP, {"u": u0}) == _ref_rows(jdb, ROWS_1HOP, {"u": u0}, "oracle")
    (variants,) = TE._plan_cache(snap).values()
    plan = variants.plans[0]
    fp_blocks = {b for (_k, b) in plan.tier_footprint}
    cap = TE._cap_of(int(deg[u0]))
    u1 = next(
        u for u in range(part.V)
        if part.page_of[part.block_of_v[u]] < 0 and 0 < deg[u] <= cap and part.block_of_v[u] not in fp_blocks
    )
    handle = plan.dispatch({"u": u1})
    meta, _data = plan.fetch(handle)
    assert int(meta[1]) == 1, "the off-footprint replay must flag"
    assert any(p.pins for p in tier.parts.values())
    plan.release(handle)
    assert all(not p.pins for p in tier.parts.values())
    want = _ref_rows(jdb, ROWS_1HOP, {"u": u1}, "oracle")
    assert _rows(db, ROWS_1HOP, {"u": u1}) == want
    assert len(variants.plans) == 2
    # resident now: the first plan's replay at u1 is clean and right
    handle = plan.dispatch({"u": u1})
    meta, data = plan.fetch(handle)
    assert int(meta[1]) == 0
    assert canonical_rows(plan.materialize(meta, data, {"u": u1}).to_dicts()) == want
    plan.release(handle)
    assert all(not p.pins for p in tier.parts.values())


def test_pool_growth_recaptures(tiered):
    """A request larger than the pool grows it into new tensors and bumps
    the generation; a plan recorded before re-records at its next dispatch
    (one more recording than the reference, whose functional pools need
    none), with the rows still equal."""
    jdb, jsnap, db, snap = tiered
    tier = snap._tier
    p = {"u": 5}
    want = _ref_rows(jdb, COUNT_2HOP, p, "oracle")
    assert _rows(db, COUNT_2HOP, p) == want
    (variants,) = TE._plan_cache(snap).values()
    plan = variants.plans[0]
    gen0 = tier.generation
    assert plan.tier_gen == gen0
    part = tier.parts[("HasFriend", "out")]
    P0 = part.P
    old = tier._dg.arrays[tiering._keys("HasFriend", "out")["nbr"]]
    tier.ensure_vertices("HasFriend", "out", np.arange(part.V))  # every block at once
    assert tier.generation == gen0 + 1 and part.P == part.B > P0
    assert tier._dg.arrays[tiering._keys("HasFriend", "out")["nbr"]] is not old
    with pytest.raises(TE.ScheduleOverflow):
        plan.dispatch(p)
    assert _rows(db, COUNT_2HOP, p) == want
    assert len(variants.plans) == 2 and variants.plans[0].tier_gen == tier.generation
    assert _rows(db, COUNT_2HOP, {"u": 77}) == _ref_rows(jdb, COUNT_2HOP, {"u": 77}, "oracle")
    assert variants.plans[0].replays >= 1


# ---------------------------------------------------------------------------
# 5. refusals
# ---------------------------------------------------------------------------


def test_tier_and_deltas_refuse_each_other(tiered, monkeypatch):
    jdb, jsnap, db, snap = tiered
    with pytest.raises(ValueError, match="tiered"):
        arm_delta_maintenance(db)
    # an armed snapshot refuses admission
    monkeypatch.setattr(config, "tier_hbm_cap_bytes", 0)
    db2, snap2 = snapshot_from_arrays(*_carry_arrays(jdb, jsnap), device="cpu")
    assert snap2._tier is None
    pad_for_deltas(snap2)
    monkeypatch.setattr(config, "tier_hbm_cap_bytes", 1)
    with pytest.raises(ValueError, match="delta"):
        db2.attach_snapshot(snap2)
    assert snap2._tier is None


def test_method_form_arms_refuse(tiered):
    jdb, jsnap, db, snap = tiered
    for sql in (
        "MATCH {class:Profiles, as:p, where:(uid = :u)}.outE('HasFriend'){as:e} RETURN count(*) AS n",
        "MATCH {class:Profiles, as:p, where:(uid = :u)}.out('HasFriend').outE('HasFriend'){as:e}"
        ".inV(){as:g} RETURN g.uid AS g",
    ):
        with pytest.raises(Uncompilable, match="tiered"):
            db.query(sql, {"u": 1})


def test_count_pushdown_off_on_a_tiered_snapshot(tiered, monkeypatch):
    jdb, jsnap, db, snap = tiered
    from orientdb_tpu_torch.sql.parser import parse

    stmt = parse(COUNT_2HOP)
    assert TE.TpuMatchSolver(db, stmt, {"u": 1})._count_pushdown_steps() == []
    monkeypatch.setattr(config, "tier_hbm_cap_bytes", 0)
    db2, _snap2 = snapshot_from_arrays(*_carry_arrays(jdb, jsnap), device="cpu")
    assert len(TE.TpuMatchSolver(db2, stmt, {"u": 1})._count_pushdown_steps()) == 2


def test_tiered_plans_are_not_batchable_but_batches_are_right(tiered):
    jdb, jsnap, db, snap = tiered
    us = [0, 57, 131, 199, 3, 57]
    for sql in (ROWS_1HOP, COUNT_2HOP):
        db.query(sql, {"u": us[0]}).to_dicts()
        for _ in range(2):
            got = db.query_batch([sql] * len(us), [{"u": u} for u in us])
            for u, rs in zip(us, got):
                assert canonical_rows(rs.to_dicts()) == _ref_rows(jdb, sql, {"u": u}, "oracle"), (sql, u)
    for variants in TE._plan_cache(snap).values():
        for plan in variants.plans:
            assert not plan.batchable() and plan.group_replays == 0
    assert all(not p.pins for p in snap._tier.parts.values())


def test_batch_items_rerun_when_a_prefetch_grows_the_pool(tiered):
    """A batch item whose footprint prefetch grows a pool leaves every
    plan captured before it stale: those items (its own included) re-run
    through their variants after the batch, and every row is right."""
    jdb, jsnap, db, snap = tiered
    tier = snap._tier
    items = [(VAR_DEPTH, {"u": 5}), (ROWS_1HOP, {"u": 0}), (ROWS_1HOP, {"u": 57})]
    for sql, p in items:
        db.query(sql, p).to_dicts()
    gen = tier.generation
    from orientdb_tpu_torch.sql.parser import parse

    (vd,) = [v for k, v in TE._plan_cache(snap).items() if k[0] == parse(VAR_DEPTH)]
    plan = vd.plans[0]
    part = tier.parts[("HasFriend", "out")]
    fp = [b for (key, b) in plan.tier_footprint if key == ("HasFriend", "out")]
    assert len(fp) > part.P, "the footprint must outgrow the pool"
    got = db.query_batch([sql for sql, _ in items], [p for _, p in items])
    assert tier.generation > gen
    for (sql, p), rs in zip(items, got):
        assert canonical_rows(rs.to_dicts()) == _ref_rows(jdb, sql, p, "oracle")
    assert all(not p.pins for p in tier.parts.values())


def test_flat_arrays_of_a_paged_class_never_upload(tiered):
    jdb, jsnap, db, snap = tiered
    db.query(VAR_DEPTH, {"u": 1}).to_dicts()
    dg = device_graph(snap, db.device)
    for cname in ("HasFriend", "Likes"):
        for key in ("dst", "src", "edge_id_in", "edge_src"):
            assert f"e:{cname}:{key}" not in dg.arrays and f"e:{cname}:{key}" not in dg._pending
        dec = dg.edges[cname]
        assert dec.paged
        for name in ("dst", "src", "edge_id_in", "edge_src"):
            with pytest.raises(KeyError, match="paged"):
                getattr(dec, name)
        assert f"e:{cname}:indptr_out" in dg.arrays and f"e:{cname}:indptr_in" in dg.arrays
    rep = dg.memory_report()
    assert rep["per_device"]["tier"] > 0
    # adjacency is the indptrs alone (the E class has no edges)
    assert rep["per_device"]["adjacency"] == sum(
        4 * (c.indptr_out.shape[0] + c.indptr_in.shape[0]) for c in snap.edge_classes.values()
    )
