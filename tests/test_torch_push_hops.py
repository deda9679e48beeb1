"""The push walks of K10's eid form (`ops.csr.bitmap_hop_shard`, over the
mesh's row-sharded CSR) and of K19 (`ops.csr.paged_hop_csr`, over a paged
partition's resident indptr and page indirection) against the slot walks
they replace (`plain_bitmap_hop_eid` over the edge-list slices,
`plain_paged_hop` over the flattened pool), on the CPU, exactly.

The push's plain versions emulate the kernels' walk: the active rows, each
row's slot base and degree, its slots, their edge ids. The cases are
skewed: a hub row, runs of empty rows, shards whose 128-vertex groups
straddle a boundary, shards past V, cold blocks, an evicted page that keeps
its stale nbr / eid rows, and -1 edge ids under live owners. The helpers
here also build the card tests' inputs (`tests/test_torch_kernels.py`), so
the file imports neither JAX nor the reference package.
"""

import math

import numpy as np
import pytest
import torch

from orientdb_tpu_torch.ops import csr as K


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def skewed_csr(rng, v: int, avg: float, hub: int = 0, empty_run=None):
    """A CSR of ``v`` rows with Poisson(avg) degrees, a hub row of ``hub``
    edges at row v // 3 and the empty rows ``empty_run`` (a slice), random
    neighbours."""
    deg = rng.poisson(avg, v).astype(np.int64)
    if empty_run is not None:
        deg[empty_run] = 0
    if hub and v:
        deg[v // 3] = hub
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nbrs = rng.integers(0, max(v, 1), int(deg.sum()), dtype=np.int32)
    return indptr, nbrs


def shard_layout(indptr: np.ndarray, nbrs: np.ndarray, n_shards: int):
    """One edge class's mesh arrays as `parallel.mesh_graph.MeshGraph`
    lays them out: per direction ``(indptr [S, R+1], nbr [S, emax], extra,
    is_out)`` with ``extra`` the out shards' first edge ids [S, 1] or the
    in CSR's out-order ids [S, emax], and the edge-list slices ``(src, dst,
    eid)`` [S, W]. Returns (csr by direction, slices, R)."""
    from orientdb_tpu_torch.parallel.mesh_graph import shard_rows

    V, E = indptr.shape[0] - 1, nbrs.shape[0]
    R = max(1, math.ceil(max(V, 1) / n_shards))
    edge_src = np.repeat(np.arange(V, dtype=np.int32), np.diff(indptr))
    order = np.argsort(nbrs, kind="stable").astype(np.int32)
    indptr_in = np.concatenate([[0], np.cumsum(np.bincount(nbrs, minlength=V))]).astype(np.int32)
    csr = {}
    for d, ip, nb, emap in (("out", indptr, nbrs, None), ("in", indptr_in, edge_src[order], order)):
        ind_l, bases, slices = shard_rows(ip, n_shards, R)
        emax = max(1, max(b - a for a, b in slices))
        nbr_l = np.full((n_shards, emax), -1, np.int32)
        eid_l = np.full((n_shards, emax), -1, np.int32)
        for s, (a, b) in enumerate(slices):
            nbr_l[s, : b - a] = nb[a:b]
            if emap is not None:
                eid_l[s, : b - a] = emap[a:b]
        extra = bases[:, None] if emap is None else eid_l
        csr[d] = (_t(ind_l), _t(nbr_l), _t(extra), d == "out")
    W = max(1, math.ceil(max(E, 1) / n_shards))
    el = [np.full((n_shards, W), -1, np.int32) for _ in range(3)]
    for s in range(n_shards):
        a, b = min(s * W, E), min((s + 1) * W, E)
        el[0][s, : b - a] = edge_src[a:b]
        el[1][s, : b - a] = nbrs[a:b]
        el[2][s, : b - a] = np.arange(a, b, dtype=np.int32)
    return csr, tuple(_t(x) for x in el), R


def paged_pool(rng, v: int, avg: float, block_edges: int, pages: int, hub: int = 0, empty_run=None):
    """A skewed CSR cut into a tier partition's blocks (`storage/tiering`)
    and a pool of ``pages`` pages: random resident blocks at random pages,
    free pages, and one page evicted as `TierManager._evict` leaves it (a -1
    owner row, its nbr / eid rows stale, no block's pageof on it). -1 edge
    ids sit under a tenth of the live owners. Returns (indptr, partition,
    pools, pageof) as numpy arrays."""
    from orientdb_tpu_torch.storage import tiering
    from orientdb_tpu_torch.utils.config import config

    indptr, nbrs = skewed_csr(rng, v, avg, hub, empty_run)
    E = nbrs.shape[0]
    host = {
        "own": np.repeat(np.arange(v, dtype=np.int32), np.diff(indptr)),
        "nbr": nbrs,
        "eid": rng.permutation(E).astype(np.int32),
    }
    saved = config.tier_block_edges
    config.tier_block_edges = block_edges
    try:
        part = tiering._Partition("c", "in", indptr, host)
    finally:
        config.tier_block_edges = saved
    pools = {n: np.full((pages, part.Wp), -1, np.int32) for n in ("own", "nbr", "eid")}
    pageof = np.full(part.B, -1, np.int32)
    blocks = rng.permutation(part.B)[: max(pages - 1, 0)]
    slots = rng.permutation(pages)
    for p, b in zip(slots, blocks):
        for n in pools:
            pools[n][p] = part.block_values(n, int(b))
        pageof[b] = p
    if pages > len(blocks):  # the evicted page
        p = slots[len(blocks)]
        b = int(rng.integers(0, part.B))
        for n in ("nbr", "eid"):
            pools[n][p] = part.block_values(n, b)
    live = pools["own"] >= 0
    pools["eid"][live & (rng.random(live.shape) < 0.1)] = -1
    return indptr, part, pools, pageof


def paged_args(indptr, part, pools, pageof, device="cpu"):
    """`paged_hop_csr`'s six arrays (indptr, blockv, pageof, estart, nbr,
    eid) and the slot walk's three pool rows (own, nbr, eid), on ``device``."""
    push = tuple(
        _t(a).to(device)
        for a in (indptr, part.block_of_v, pageof, part.edge_start, pools["nbr"], pools["eid"])
    )
    slot = tuple(_t(pools[n]).to(device) for n in ("own", "nbr", "eid"))
    return push, slot


def frontiers(rng, c: int, vb: int, device="cpu"):
    """A sparse frontier with vertex 0 (the clip target of a -1 endpoint)
    in every row, an empty one and a dense one."""
    fr = rng.random((c, vb)) < 0.05
    fr[:, 0] = True
    return [_t(fr).to(device), torch.zeros((c, vb), dtype=torch.bool, device=device),
            torch.ones((c, vb), dtype=torch.bool, device=device)]


#: (S, V, avg degree, hub edges, empty rows): R = ceil(V / S) = 1,000 / 334 /
#: 250 / 3; the last three leave 128-vertex groups across shard boundaries,
#: and (4, 9) the last shard (rows 9..11) past V
SHARD_CASES = [
    (1, 1_000, 4.0, 600, slice(100, 400)),
    (3, 1_000, 4.0, 600, slice(300, 700)),
    (4, 1_000, 2.0, 2_000, slice(0, 250)),
    (4, 9, 1.5, 0, slice(2, 4)),
]


@pytest.mark.parametrize("S,v,avg,hub,empty", SHARD_CASES)
def test_shard_push_equals_slot_walk(S, v, avg, hub, empty):
    """K10's eid form: the push over the row-sharded CSR equals the slot
    walk over the edge-list slices (both directions, with and without an
    edge mask and a gate, ``alive`` 0, C up to 40), on all shards at once
    and shard by shard at each rank's ``s0``."""
    rng = np.random.default_rng(S * 1000 + v)
    indptr, nbrs = skewed_csr(rng, v, avg, hub, empty)
    csr, el, R = shard_layout(indptr, nbrs, S)
    vb = K.bucket(v)
    if S == 4 and v == 9:
        assert 3 * R >= v  # the last shard holds no vertex
    emask = _t(rng.random(nbrs.shape[0]) < 0.7)
    gate = _t(rng.random(vb) < 0.8)
    zero = torch.tensor(0, dtype=torch.int32)
    for c in (1, 3, 40):
        for fr in frontiers(rng, c, vb):
            for d, (a, e) in (("out", (el[0], el[1])), ("in", (el[1], el[0]))):
                sh = csr[d]
                for m in (None, emask):
                    for g in (None, gate):
                        want = K.plain_bitmap_hop_eid(a, e, el[2], m, fr, g)
                        got = K.bitmap_hop_shard(*sh[:3], sh[3], 0, m, fr, g)
                        assert torch.equal(got, want), (c, d, m is None, g is None)
                        ranks = torch.zeros_like(want)
                        for s0 in range(S):
                            one = tuple(t[s0 : s0 + 1] for t in sh[:3])
                            K.bitmap_hop_shard(*one, sh[3], s0, m, fr, g, out=ranks)
                        assert torch.equal(ranks, want)
                assert not K.bitmap_hop_shard(*sh[:3], sh[3], 0, emask, fr, gate, zero).any()


#: (V, avg degree, block edges, pages, hub edges, empty rows)
PAGED_CASES = [
    (60, 3.0, 16, 3, 0, None),
    (60, 3.0, 16, 0, 0, None),
    (2_000, 5.0, 64, 12, 900, slice(500, 900)),
    (3_000, 2.0, 128, 20, 0, slice(0, 1_000)),
]


@pytest.mark.parametrize("v,avg,block_edges,pages,hub,empty", PAGED_CASES)
def test_paged_push_equals_slot_walk(v, avg, block_edges, pages, hub, empty):
    """K19: the push over the resident indptr and the page indirection
    equals the slot walk over the flattened pool (cold blocks, free pages,
    an evicted page with stale rows, -1 edge ids under live owners, a hub
    block, empty rows; an edge mask, a gate, ``alive`` 0, C up to 40), and
    so does the wrapper's ``out`` accumulation."""
    rng = np.random.default_rng(v + pages + hub)
    indptr, part, pools, pageof = paged_pool(rng, v, avg, block_edges, pages, hub, empty)
    push, slot = paged_args(indptr, part, pools, pageof)
    vb = K.bucket(v)
    emask = _t(rng.random(part.E) < 0.7)
    gate = _t(rng.random(vb) < 0.8)
    zero = torch.tensor(0, dtype=torch.int32)
    for c in (1, 2, 40):
        for fr in frontiers(rng, c, vb):
            for m in (None, emask):
                for g in (None, gate):
                    want = K.plain_paged_hop(*slot, m, fr, g)
                    assert torch.equal(K.plain_paged_hop_csr(*push, m, fr, g), want)
                    acc = torch.zeros_like(fr)
                    acc[:, -1] = True
                    K.paged_hop_csr(*push, m, fr, g, out=acc)
                    assert torch.equal(acc, want | (torch.arange(vb) == vb - 1)[None, :])
            assert not K.paged_hop_csr(*push, emask, fr, gate, zero).any()


#: (S, V, avg degree, hub edges, empty rows) for K23: SHARD_CASES, and one
#: vertex holding 100,000 edges (rows across many of the kernel's 5,120-item
#: tiles, and a shard whose edges are nearly all one row's)
WEIGHT_CASES = SHARD_CASES + [(3, 2_000, 3.0, 100_000, slice(1_000, 1_500))]


@pytest.mark.parametrize("S,v,avg,hub,empty", WEIGHT_CASES)
def test_shard_weight_pass_equals_slot_walk(S, v, avg, hub, empty):
    """K23: the segmented sum over the row-sharded CSR (the wrapper's CPU
    path, `plain_shard_weight_pass_csr`) equals the reference's walk over
    the edge-list slices (`plain_shard_weight_pass`): out and in, with and
    without an edge mask and a vertex mask, ``w`` None, int32 or float32
    (to rtol 1e-6), on all shards at once and shard by shard at each rank's
    ``s0``."""
    rng = np.random.default_rng(S * 100 + v + hub)
    indptr, nbrs = skewed_csr(rng, v, avg, hub, empty)
    csr, el, R = shard_layout(indptr, nbrs, S)
    vb = K.bucket(v)
    emask = _t(rng.random(nbrs.shape[0]) < 0.7)
    ok = _t(rng.random(vb) < 0.6)
    w_i = _t(rng.integers(-50, 1000, vb).astype(np.int32))
    w_f = _t((rng.random(vb) * 3.0).astype(np.float32))
    for d, (seg, emit) in (("out", (el[0], el[1])), ("in", (el[1], el[0]))):
        sh = csr[d]
        for m in (None, emask):
            for o in (None, ok):
                for w in (None, w_i, w_f):
                    dt = torch.float32 if w is w_f else torch.int32
                    want = K.plain_shard_weight_pass(seg, emit, el[2], m, o, w, torch.zeros(vb, dtype=dt))
                    got = K.shard_weight_pass(*sh[:3], sh[3], 0, m, o, w, torch.zeros(vb, dtype=dt))
                    ranks = torch.zeros(vb, dtype=dt)
                    for s0 in range(S):
                        one = tuple(t[s0 : s0 + 1] for t in sh[:3])
                        K.shard_weight_pass(*one, sh[3], s0, m, o, w, ranks)
                    for g in (got, ranks):
                        if dt == torch.int32:
                            assert torch.equal(g, want), (d, m is None, o is None, w is None)
                        else:
                            torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6 * float(want.abs().max() + 1))
    # out accumulates: a pass adds into what is there
    acc = torch.full((vb,), 7, dtype=torch.int32)
    K.shard_weight_pass(*csr["out"][:3], True, 0, emask, ok, w_i, acc)
    want = K.plain_shard_weight_pass(el[0], el[1], el[2], emask, ok, w_i, torch.zeros(vb, dtype=torch.int32)) + 7
    assert torch.equal(acc, want)


def _evicted(pageof):
    return np.full_like(pageof, -1)


@pytest.mark.parametrize("v,avg,block_edges,pages,hub,empty", PAGED_CASES)
def test_paged_push_flag_equals_miss(v, avg, block_edges, pages, hub, empty):
    """K20 folded into K19: the push's cold-miss flag (the wrapper's CPU
    path with ``miss``) equals `plain_paged_hop_miss` on the pool as kept,
    with every page evicted and with an empty pool (no slot); with a gate,
    ``alive`` 0, an empty frontier and C up to 40. The flag is only ever
    set: a True ``miss`` stays True, and the hop's bits do not change."""
    rng = np.random.default_rng(3 * v + pages + hub)
    indptr, part, pools, pageof = paged_pool(rng, v, avg, block_edges, pages, hub, empty)
    vb = K.bucket(v)
    gate = _t(rng.random(vb) < 0.8)
    zero = torch.tensor(0, dtype=torch.int32)
    no_pool = {n: np.zeros((0, part.Wp), np.int32) for n in pools}
    for tag, pl, pg in (("kept", pools, pageof), ("evicted", pools, _evicted(pageof)), ("empty", no_pool, _evicted(pageof))):
        push, _slot = paged_args(indptr, part, pl, pg)
        ip, bv, pgt = push[0], push[1], push[2]
        for c in (1, 40):
            for fr in frontiers(rng, c, vb):
                for g in (None, gate):
                    for a in (None, zero):
                        want = K.plain_paged_hop_miss(fr, bv, pgt, ip, g, a)
                        miss = torch.zeros((), dtype=torch.bool)
                        hop = K.paged_hop_csr(*push, None, fr, g, a, miss=miss)
                        assert bool(miss) == bool(want), (tag, c, g is None, a is None)
                        assert torch.equal(hop, K.paged_hop_csr(*push, None, fr, g, a))
                        stay = torch.ones((), dtype=torch.bool)
                        K.paged_hop_csr(*push, None, fr, g, a, miss=stay)
                        assert bool(stay)
        if tag != "kept" and part.E:
            fr = frontiers(rng, 2, vb)[2]  # every vertex active
            assert bool(K.plain_paged_hop_miss(fr, bv, pgt, ip))
