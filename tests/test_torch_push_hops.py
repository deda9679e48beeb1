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
here also build the card tests' inputs (`tests/test_torch_kernels.py`, and
`armed_graph`, the delta slab of `tests/test_torch_slab_hop.py`), so the
file imports neither JAX nor the reference package.
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


def armed_graph(rng, v_base: int, slab_v: int, avg: float, spare: int, used: int, nb: int, bk: int = 8,
                dead: float = 0.1, full_bucket: bool = True):
    """One edge class of a delta-maintained snapshot as `storage/deltas`
    leaves it, in numpy: a base CSR over ``v_base`` vertices (Poisson(avg)
    out-degrees), padded to ``v_base + slab_v`` vertices and ``spare`` slab
    slots; ``used`` slab edges between any of the padded vertices, indexed
    in the out and in bucket tables (``nb`` buckets of ``bk``) as
    `SnapshotOverlay.bucket_add` fills them, an edge that would overflow a
    bucket drawn again; with ``full_bucket`` the first slab vertex (base
    degree 0) first fills its out bucket to exactly ``bk`` entries. A
    fraction ``dead`` of the base and of the slab edges is tombstoned as the
    maintainer does it (``live`` False; a base edge's ``dst`` and in-CSR
    ``src`` -1; bucket entries stay). Returns a dict of the arrays
    (``indptr_out``, ``dst``, ``edge_src``, ``indptr_in``, ``src``,
    ``edge_id_in``, ``live``, ``tab_out``, ``tab_in``) and ``base``,
    ``nb``, ``bk``, ``v``."""
    v_cap = v_base + slab_v
    deg = rng.poisson(avg, v_base).astype(np.int64)
    e_base = int(deg.sum())
    cap = e_base + spare
    edge_src = np.full(cap, -1, np.int32)
    dst = np.full(cap, -1, np.int32)
    live = np.zeros(cap, bool)
    edge_src[:e_base] = np.repeat(np.arange(v_base, dtype=np.int32), deg)
    dst[:e_base] = rng.integers(0, max(v_base, 1), e_base)
    live[:e_base] = True
    indptr_out = np.full(v_cap + 1, e_base, np.int32)
    indptr_out[: v_base + 1] = np.concatenate([[0], np.cumsum(deg)])
    order = np.argsort(dst[:e_base], kind="stable")
    indptr_in = np.concatenate([[0], np.cumsum(np.bincount(dst[:e_base], minlength=v_cap))]).astype(np.int32)
    src = np.full(cap, -1, np.int32)
    src[:e_base] = edge_src[order]
    edge_id_in = np.full(cap, -1, np.int32)
    edge_id_in[:e_base] = order
    tabs = {d: np.full(nb * bk, -1, np.int32) for d in ("out", "in")}
    fill = {d: np.zeros(nb, np.int32) for d in ("out", "in")}
    n = 0

    def add(s: int, d_: int) -> bool:
        nonlocal n
        bo, bi = s & (nb - 1), d_ & (nb - 1)
        if n >= min(used, spare) or fill["out"][bo] >= bk or fill["in"][bi] >= bk:
            return False
        pos = e_base + n
        edge_src[pos], dst[pos], live[pos] = s, d_, True
        for d, b in (("out", bo), ("in", bi)):
            tabs[d][b * bk + fill[d][b]] = n
            fill[d][b] += 1
        n += 1
        return True

    if full_bucket and slab_v:
        hot = v_base
        while fill["out"][hot & (nb - 1)] < bk and n < min(used, spare):
            add(hot, int(rng.integers(0, v_cap)))
    tries = 0
    while n < min(used, spare) and tries < 50 * max(used, 1):
        add(int(rng.integers(0, v_cap)), int(rng.integers(0, v_cap)))
        tries += 1
    slab = np.arange(e_base, e_base + n)
    live[slab[rng.random(n) < dead]] = False
    in_pos = np.empty(e_base, np.int64)
    in_pos[order] = np.arange(e_base)
    gone = np.nonzero(rng.random(e_base) < dead)[0]
    live[gone] = False
    dst[gone] = -1
    src[in_pos[gone]] = -1
    return {
        "indptr_out": indptr_out, "dst": dst, "edge_src": edge_src, "indptr_in": indptr_in, "src": src,
        "edge_id_in": edge_id_in, "live": live, "tab_out": tabs["out"], "tab_in": tabs["in"],
        "base": e_base, "nb": nb, "bk": bk, "v": v_cap,
    }


def probe_hop_args(g, d: str, emask, device="cpu"):
    """`bitmap_hop_csr`'s CSR arrays of direction ``d`` and its `SlabIndex`
    over `armed_graph`'s arrays, on ``device``."""
    t = {k: _t(a).to(device) for k, a in g.items() if isinstance(a, np.ndarray)}
    if d == "out":
        csr = (t["indptr_out"], t["dst"], None)
        own, nbr = t["edge_src"], t["dst"]
    else:
        csr = (t["indptr_in"], t["src"], t["edge_id_in"])
        own, nbr = t["dst"], t["edge_src"]
    probe = K.SlabIndex(t[f"tab_{d}"], own, nbr, t["live"], g["base"], g["nb"], g["bk"])
    return csr, probe, None if emask is None else _t(emask).to(device)


def expand_sources(rng, indptr: np.ndarray, width: int, among=None):
    """K21's sources over ``indptr``: random vertices and -1 padding, the
    largest row repeated at every seventh slot and zero-degree rows (or,
    with ``among``, vertices drawn from it alone); with their exclusive
    offsets and total, as numpy."""
    v = indptr.shape[0] - 1
    deg = np.diff(indptr)
    if among is not None:
        srcs = rng.choice(among, width).astype(np.int32)
    else:
        srcs = rng.integers(-1, max(v, 1), width).astype(np.int32)
    if v and among is None:
        srcs[::7] = int(np.argmax(deg))
        zero = np.nonzero(deg == 0)[0]
        if zero.size:
            srcs[3::11] = zero[np.arange(srcs[3::11].shape[0]) % zero.size]
    counts = np.where(srcs >= 0, deg[np.clip(srcs, 0, max(v - 1, 0))] if v else 0, 0)
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    return srcs, offsets, int(counts.sum())


#: K21's partitions (V, avg degree, block edges, pages, hub edges, empty
#: rows): a 5,000-edge row spans three of the gather's 2,048-item tiles
EXPAND_CASES = [
    (60, 3.0, 16, 3, 0, None),
    (2_000, 5.0, 64, 12, 5_000, slice(500, 900)),
    (3_000, 2.0, 128, 20, 0, slice(0, 1_000)),
]
