"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on a CUDA card. The kernels have no CPU mode, so these tests are
marked ``cuda`` and skip where there is no card. The file imports neither
JAX nor the reference package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

int32 and bool results must be exactly equal, padding slots included;
float32 results are held to rtol 1e-5 of the largest magnitude, because the
kernels add in another order than the plain version."""

import numpy as np
import pytest
import torch

from orientdb_tpu_torch.ops import csr as T
from test_torch_push_hops import (
    EXPAND_CASES, PAGED_CASES, SHARD_CASES, WEIGHT_CASES, armed_graph, expand_sources, frontiers, paged_args,
    paged_pool, probe_hop_args, shard_layout, skewed_csr,
)

F32_RTOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _csr(rng, v: int, avg: float, tail_zero: int = 0):
    deg = rng.poisson(avg, v).astype(np.int64)
    if tail_zero:
        deg[-tail_zero:] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nbrs = rng.integers(0, max(v, 1), int(deg.sum()), dtype=np.int32)
    return indptr, nbrs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 511, 513, 1_000_003, 2_100_001])
def test_kernels_equal_plain_on_card(card, n):
    rng = np.random.default_rng(n + 9)
    v_i = _t(rng.integers(0, 2**20, n, dtype=np.int32)).to(card)
    v_f = _t(rng.random(n, dtype=np.float32)).to(card)
    mask = _t(rng.random(n) < 0.3).to(card)
    for exclusive in (False, True):
        assert torch.equal(T._scan(v_i, exclusive), T.plain_cumsum(v_i, exclusive))
        torch.testing.assert_close(
            T._scan(v_f, exclusive), T.plain_cumsum(v_f, exclusive), rtol=F32_RTOL, atol=F32_RTOL * max(n, 1)
        )
    for out_size in (8, T.bucket(max(n, 1))):
        assert torch.equal(
            T.compact_indices(mask, out_size), T.plain_compact_indices(mask, out_size)
        )
    assert int(T.mask_count(mask)) == int(T.plain_mask_count(mask))
    indptr, nbrs = _csr(rng, 1000, 5.0, tail_zero=3)
    indptr, nbrs = _t(indptr).to(card), _t(nbrs).to(card)
    srcs = _t(rng.integers(-1, 1000, n, dtype=np.int32)).to(card)
    counts = T.degree_counts(indptr, srcs)
    assert torch.equal(counts, T.plain_degree_counts(indptr, srcs))
    offsets = T.exclusive_cumsum(counts)
    total = T.value_sum(counts)
    out_size = T.bucket(max(int(total), 1))
    for g, w in zip(
        T.gather_expand(indptr, nbrs, srcs, offsets, total, out_size),
        T.plain_gather_expand(indptr, nbrs, srcs, offsets, total, out_size),
    ):
        assert torch.equal(g, w)
    idx = _t(rng.integers(-2, max(n, 1) + 3, max(n, 5), dtype=np.int32)).to(card)
    for vals, fill in ((v_i, -1), (v_f, 0.0), (mask, False)):
        assert torch.equal(T.take_pad(vals, idx, fill), T.plain_take_pad(vals, idx, fill))
    seg_ip = _t(np.linspace(0, n, 101).astype(np.int32)).to(card)
    assert torch.equal(
        T.indptr_segment_sum(v_i, seg_ip, 128), T.plain_indptr_segment_sum(v_i, seg_ip, 128)
    )
    torch.testing.assert_close(
        T.indptr_segment_sum(v_f, seg_ip, 128),
        T.plain_indptr_segment_sum(v_f, seg_ip, 128),
        rtol=F32_RTOL,
        atol=F32_RTOL * max(n, 1),
    )
    torch.cuda.synchronize()


#: K2's and K2b's source kinds (`expand_case`): a hub row over several of
#: K2b's tiles, a run of zero-degree rows and one of -1 sources, each longer
#: than a tile, every source padding (total 0), an empty edge list (E = 0),
#: and a hub among -1 sources interleaved
EXPAND_KINDS = ["hub", "zero_run", "padding_run", "all_padding", "no_edges", "mixed"]


def expand_case(kind: str, width: int, seed: int):
    """(indptr, neighbors, edge_map, srcs) as int32 numpy arrays: a CSR over
    6,000 vertices with Zipf(1.6) degrees up to 400, one hub of 9,000 edges
    (~4.4 of K2b's 2,048-item tiles) and 3,000 zero-degree vertices in a
    row (none at all for ``no_edges``), an edge map that permutes the edge
    ids (an in walk's ``edge_id_in``), and ``width`` sources of ``kind``."""
    rng = np.random.default_rng(seed)
    v = 6_000
    deg = np.minimum(rng.zipf(1.6, v), 400)
    deg[77] = 9_000
    deg[2_000:5_000] = 0
    if kind == "no_edges":
        deg[:] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    e = int(indptr[-1])
    nbrs = rng.integers(0, v, e, dtype=np.int32)
    emap = rng.permutation(e).astype(np.int32)
    srcs = rng.integers(0, v, width, dtype=np.int32)
    mid = width // 3
    if kind == "hub":
        srcs[mid] = 77
        srcs[-1] = 77
    elif kind == "zero_run":
        run = min(3_000, width - mid)
        srcs[mid : mid + run] = np.arange(2_000, 2_000 + run, dtype=np.int32)
    elif kind == "padding_run":
        srcs[mid : mid + 2_500] = -1
    elif kind == "all_padding":
        srcs[:] = -1
    elif kind == "mixed":
        srcs[rng.random(width) < 0.3] = -1
        srcs[mid] = 77
    return indptr, nbrs, emap, srcs


def expand_sizes(total: int):
    """out_size == total, far past it, and below it (a replay that
    outgrew its recorded bucket: every slot live)."""
    sizes = [4 * T.bucket(max(total, 1)), max(total // 3, 1)]
    return ([total] if total > 0 else []) + sizes


#: K2's sources a look-back tile and K2b's merged items (row offsets and
#: slots) a block: `csrc/csr_kernels.cu`'s kDegTile and kExpandTile
EXPAND_TILE = 2048
#: K2/K2b widths: one source, around the tiles, several tiles
EXPAND_WIDTHS = [1, EXPAND_TILE - 1, EXPAND_TILE + 1, 3 * EXPAND_TILE + 5]


@pytest.mark.cuda
@pytest.mark.parametrize("width", EXPAND_WIDTHS)
@pytest.mark.parametrize("kind", EXPAND_KINDS)
def test_expand_kernels_equal_plain_on_card(card, kind, width):
    """K2's degree scan (offsets and total, sources 16-byte aligned and
    not) and K2b's merge-path gather (with and without the edge map, out
    sizes equal to, far past and below the total, outputs always fresh)
    against their plain versions, exactly."""
    indptr, nbrs, emap, srcs = (_t(a).to(card) for a in expand_case(kind, width, width + 61))
    offsets, total = T.expand_offsets(indptr, srcs)
    p_off, p_total = T.plain_expand_offsets(indptr, srcs)
    assert torch.equal(offsets, p_off) and torch.equal(total, p_total)
    if width > 1:
        shifted = srcs[1:]
        for g, w in zip(T.expand_offsets(indptr, shifted), T.plain_expand_offsets(indptr, shifted)):
            assert torch.equal(g, w)
    for out_size in expand_sizes(int(total)):
        for emap_arg in (None, emap):
            got = T.gather_expand(indptr, nbrs, srcs, offsets, total, out_size, emap_arg)
            want = T.plain_gather_expand(indptr, nbrs, srcs, offsets, total, out_size, emap_arg)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (out_size, emap_arg is not None)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_captured_expansion_replays_equal_plain_on_card(card):
    """One captured degree scan + gather, replayed on other sources of the
    same width (the look-back state emptied by its memset node each time),
    into poisoned outputs: each replay equals the plain versions."""
    cases = [expand_case(kind, 5_000, 7) for kind in ("hub", "mixed", "zero_run")]
    indptr, nbrs, emap = (_t(a).to(card) for a in cases[0][:3])
    inputs = [_t(c[3]).to(card) for c in cases]
    static = inputs[0].clone()
    out_size = 1 << 16
    run = lambda: T.gather_expand(indptr, nbrs, static, *T.expand_offsets(indptr, static), out_size, emap)  # noqa: E731
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for i in range(30):
        src = inputs[i % len(inputs)]
        static.copy_(src)
        for o in outs:
            o.fill_(-7)
        graph.replay()
        off, tot = T.plain_expand_offsets(indptr, src)
        for g, w in zip(outs, T.plain_gather_expand(indptr, nbrs, src, off, tot, out_size, emap)):
            assert torch.equal(g, w), i
    torch.cuda.synchronize()


#: lengths around K1's and K3's tiles, and one of 4,097 tiles of the larger:
#: a look-back that walks back past many predecessors
TILE_LENGTHS = sorted(
    {0, 1, 4097 * max(T._TILE, T._COMPACT_TILE) + 5}
    | {n for t in (T._TILE, T._COMPACT_TILE) for n in (t - 1, t, t + 1, 2 * t + 1)}
)


@pytest.mark.cuda
@pytest.mark.parametrize("n", TILE_LENGTHS)
def test_scan_forms_equal_plain_on_card(card, n):
    """K1's one-pass forms (inclusive, exclusive, with the device total,
    the total alone, a bool mask's ranks) and K3's one-pass compaction
    (fill and offset forms, with truncation) against their plain versions
    at the tile's edges: int32 and indices exactly, float32 to rtol 1e-5."""
    rng = np.random.default_rng(n + 21)
    v_i = _t(rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)).to(card)
    v_f = _t(rng.random(n, dtype=np.float32)).to(card)
    mask = _t(rng.random(n) < 0.3).to(card)
    for exclusive in (False, True):
        assert torch.equal(T._scan(v_i, exclusive), T.plain_cumsum(v_i, exclusive))
        torch.testing.assert_close(
            T._scan(v_f, exclusive), T.plain_cumsum(v_f, exclusive), rtol=F32_RTOL, atol=F32_RTOL * max(n, 1)
        )
    offsets, total = T.exclusive_cumsum_total(v_i)
    assert torch.equal(offsets, T.plain_cumsum(v_i, True))
    want = T.plain_cumsum(v_i)[-1] if n else torch.zeros((), dtype=torch.int32, device=card)
    assert total.shape == () and int(total) == int(want)
    assert int(T.value_sum(v_i)) == int(want)
    want_f = float(v_f.double().sum())
    assert abs(float(T.value_sum(v_f)) - want_f) <= F32_RTOL * max(want_f, 1.0)
    assert torch.equal(T.mask_cumsum(mask), T.plain_cumsum(mask.to(torch.int32)))
    kept = int(mask.sum())
    for out_size in (8, max(kept // 2, 1), T.bucket(max(kept, 1)), n + 3):
        assert torch.equal(T.compact_indices(mask, out_size), T.plain_compact_indices(mask, out_size))
        a = torch.full((out_size + 11,), -1, dtype=torch.int32, device=card)
        b = a.clone()
        got = T.compact_indices(mask, out_size, out=a, offset=11)
        assert torch.equal(got, T.plain_compact_indices(mask, out_size, out=b, offset=11))
        assert torch.equal(a, b)
    if n > 1:  # unaligned starts: the scalar path of the 16-byte loads
        assert torch.equal(T._scan(v_i[1:], False), T.plain_cumsum(v_i[1:]))
        assert torch.equal(T.compact_indices(mask[1:], n), T.plain_compact_indices(mask[1:], n))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_captured_scan_replays_equal_plain(card):
    """1,000 replays of one captured K1 launch on the same look-back state:
    each replay scans another input into a poisoned output and must equal
    the plain version, so state left over from the replay before shows."""
    n = 1_000_003
    rng = np.random.default_rng(5)
    inputs = [_t(rng.integers(0, 2**20, n, dtype=np.int32)).to(card) for _ in range(2)]
    wants = [T.plain_cumsum(v) for v in inputs]
    static = inputs[0].clone()
    T.value_cumsum(static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = T.value_cumsum(static)
    for i in range(1000):
        static.copy_(inputs[i % 2])
        out.fill_(-7)
        graph.replay()
        assert torch.equal(out, wants[i % 2]), i
    torch.cuda.synchronize()


#: K4's degree shapes, (kind, segments): Poisson(10) as in A; Zipf with a
#: hub over several of the kernel's 5,120-item tiles; every segment empty;
#: runs of empty segments around long ones; one segment of 100,000 values
#: (20 tiles) between two short ones; a CSR slice whose indptr starts past 0
SEGMENT_CASES = [
    ("poisson", 200_000), ("poisson", 1), ("zipf", 50_000), ("empty", 10_000), ("runs", 30_000),
    ("long", 3), ("slice", 20_000),
]


def _segment_indptr(rng, kind: str, v: int) -> np.ndarray:
    if kind == "zipf":
        deg = np.minimum(rng.zipf(1.6, v), 50_000)
        deg[v // 2] = 30_000
    elif kind == "empty":
        deg = np.zeros(v, np.int64)
    elif kind == "runs":
        deg = np.zeros(v, np.int64)
        deg[rng.choice(v, v // 50, replace=False)] = rng.integers(1, 9_000, v // 50)
    elif kind == "long":
        deg = np.array([5, 100_000, 7])
    else:
        deg = rng.poisson(10, v + v // 3)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    return indptr[v // 3 :] if kind == "slice" else indptr


def _segment_inputs(card, kind, v, seed):
    rng = np.random.default_rng(seed)
    indptr = _segment_indptr(rng, kind, v)
    ne = int(indptr[-1])
    vals_i = _t(rng.integers(-(2**31), 2**31 - 1, ne, dtype=np.int32)).to(card)  # sums wrap
    vals_f = _t(rng.random(ne, dtype=np.float32)).to(card)
    return _t(indptr).to(card), vals_i, vals_f


def _same_f32(got, want):
    """rtol 1e-6 of the largest magnitude: the kernel adds in tile order,
    the plain version rounds a float64 difference once."""
    scale = float(want.abs().max()) if want.numel() else 1.0
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * max(scale, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [False, True], ids=["padded", "cut"])
@pytest.mark.parametrize("kind,v", SEGMENT_CASES)
def test_segment_sum_equals_plain_on_card(card, kind, v, cut):
    """K4 (merge path) against its plain version: int32 exactly (wrapping
    sums), float32 to rtol 1e-6 and bit for bit equal from call to call,
    with ``out_size`` above ``nseg`` (zero padding) and below it (cut)."""
    indptr, vals_i, vals_f = _segment_inputs(card, kind, v, v + 31)
    nseg = indptr.shape[0] - 1
    out_size = max(nseg // 2, 1) if cut else T.bucket(max(nseg, 1)) + 3
    got = T.indptr_segment_sum(vals_i, indptr, out_size)
    assert torch.equal(got, T.plain_indptr_segment_sum(vals_i, indptr, out_size))
    first = T.indptr_segment_sum(vals_f, indptr, out_size)
    again = T.indptr_segment_sum(vals_f, indptr, out_size)
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    _same_f32(first, T.plain_indptr_segment_sum(vals_f, indptr, out_size))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_captured_segment_sum_equals_eager_on_card(card):
    """One captured K4 call (three launches) replayed on other values in
    place: int32 and float32 bit for bit equal to eager calls."""
    indptr, vals_i, vals_f = _segment_inputs(card, "zipf", 50_000, 3)
    _, other_i, other_f = _segment_inputs(card, "zipf", 50_000, 3)
    other_i, other_f = other_i.roll(7), other_f.roll(7)
    out_size = T.bucket(indptr.shape[0])
    for vals, other in ((vals_i, other_i), (vals_f, other_f)):
        static = vals.clone()
        T.indptr_segment_sum(static, indptr, out_size)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = T.indptr_segment_sum(static, indptr, out_size)
        for src in (other, vals, other):
            static.copy_(src)
            out.fill_(-7)
            graph.replay()
            want = T.indptr_segment_sum(src, indptr, out_size)
            assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [0, 20])
def test_queries_on_card_equal_cpu(card, skew):
    """The whole slice on the card (kernels) against the same queries on
    the CPU (plain versions), on a graph where E < vb and one where E ≥ vb."""
    from orientdb_tpu_torch.storage.bigshape import build_person_knows

    queries = [
        ("MATCH {class:Person, as:p, where:(age > 40)}-knows->{as:f, where:(age < 30)} "
         "RETURN count(*) AS n", None),
        ("MATCH {class:Person, as:p, where:(age > 40)}-knows->{as:f}"
         "-knows->{as:g, where:(age < 30)} RETURN count(*) AS n", None),
        ("MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f}"
         "-knows->{as:g, where:(age < 30)} RETURN p.uid AS p, f.uid AS f, g.uid AS g",
         {"k": 300}),
        ("MATCH {class:Person, as:p, where:(uid < :k)}<-knows-{as:f, where:(age % 3 = 1)} "
         "RETURN p.uid AS p, f.uid AS f ORDER BY f DESC, p LIMIT 50", {"k": 300}),
    ]
    for avg in (0.5, 6):  # E < vb, and E >= vb (the [vb] mask precompute)
        kw = dict(avg_knows=avg, seed=11, supernodes=skew, supernode_degree=500 if skew else 0)
        gpu, _ = build_person_knows(5_000, device=card, **kw)
        cpu, _ = build_person_knows(5_000, device="cpu", **kw)
        for sql, params in queries:
            got = gpu.query(sql, params).to_dicts()
            want = cpu.query(sql, params).to_dicts()
            key = lambda r: tuple(sorted(r.items()))  # noqa: E731
            if "ORDER BY" in sql:
                assert got == want
            else:
                assert sorted(got, key=key) == sorted(want, key=key)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("w,c", [(8, 1), (257, 3), (131_072, 3), (1_024, 17)])
def test_result_stage_kernels_equal_plain_on_card(card, w, c):
    """K6 front_pack, K7 replay_meta and K8 narrow_i16 against their plain
    versions (exactly: every value is int32 or int16)."""
    rng = np.random.default_rng(w + c)
    valid = _t((rng.random(w) < 0.4).astype(np.int32)).to(card)
    cols = [_t(rng.integers(-1, 50_000, w, dtype=np.int32)).to(card) for _ in range(c)]
    data = T.front_pack(valid, cols)
    assert torch.equal(data, T.plain_front_pack(valid, cols))
    small = T.front_pack(valid, [col % 1_000 for col in cols])
    for d in (data, small):
        for n in (0, 1, int(valid.sum()), w + 5):
            count = torch.tensor(n, dtype=torch.int32, device=card)
            over = torch.tensor(n % 2, dtype=torch.int32, device=card)
            assert torch.equal(
                T.replay_meta(d, count, over), T.plain_replay_meta(d, count, over)
            )
    wide = _t(rng.integers(-(2**31), 2**31 - 1, w * c, dtype=np.int64).astype(np.int32)).to(card)
    assert torch.equal(T.narrow_i16(wide), T.plain_narrow_i16(wide))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_captured_replays_equal_cpu(card):
    """Record, capture and replay on the card against the same calls on
    the CPU (whose replays run uncaptured), across parameter values that
    replay under capacity and that overflow into a second variant."""
    from orientdb_tpu_torch.exec import tpu_engine as TE
    from orientdb_tpu_torch.storage.bigshape import build_person_knows

    queries = [
        ("MATCH {class:Person, as:p, where:(age > 40)}-knows->{as:f}"
         "-knows->{as:g, where:(age < 30)} RETURN count(*) AS n", [None] * 3),
        ("MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f}"
         "-knows->{as:g, where:(age < 30)} RETURN p.uid AS p, f.uid AS f, g.uid AS g",
         [{"k": 300}, {"k": 300}, {"k": 120}, {"k": 2_000}, {"k": 300}]),
        ("MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f} "
         "RETURN p.uid AS p, f.uid AS f", [{"k": 40}, {"k": 40}, {"k": 10}]),
    ]
    kw = dict(avg_knows=6, seed=11)
    gpu, gsnap = build_person_knows(5_000, device=card, **kw)
    cpu, _ = build_person_knows(5_000, device="cpu", **kw)
    key = lambda r: tuple(sorted(r.items()))  # noqa: E731
    for sql, param_list in queries:
        for params in param_list:
            got = gpu.query(sql, params).to_dicts()
            want = cpu.query(sql, params).to_dicts()
            assert sorted(got, key=key) == sorted(want, key=key)
    plans = [p for v in TE._plan_cache(gsnap).values() for p in v.plans]
    assert all(p.graph is not None for p in plans)
    assert sum(p.replays for p in plans) >= 5
    assert any(p.direct_fetch for p in plans)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("c,vb,e", [(1, 8, 0), (8, 64, 700), (5, 40, 300), (8, 1 << 16, 200_000), (256, 1 << 12, 30_000)])
def test_bitmap_kernels_equal_plain_on_card(card, c, vb, e):
    """K9 rows_to_bitmap, K10 bitmap_hop, K11 bitmap_emit and K12
    frontier_advance against their plain versions, exactly (bool and
    int32): padding and out-of-range ids, both directions, an edge mask,
    a gate, duplicate targets, an empty frontier, a bound row vector, and
    vb not a multiple of 16 (the one-byte paths)."""
    rng = np.random.default_rng(c + vb + e)
    rows = _t(rng.integers(-2, vb + 2, c, dtype=np.int32)).to(card)
    assert torch.equal(T.rows_to_bitmap(rows, vb), T.plain_rows_to_bitmap(rows, vb))
    src = _t(np.sort(rng.integers(-1, vb + 1, e)).astype(np.int32)).to(card)
    dst = _t(rng.integers(0, max(vb // 8, 1), e, dtype=np.int32)).to(card)  # duplicate targets
    emask = _t(rng.random(e) < 0.6).to(card)
    gate = _t(rng.random(vb) < 0.5).to(card)
    fr = _t(rng.random((c, vb)) < 0.05).to(card)
    alive = T.mask_count(fr.view(-1))
    for act, emit in ((src, dst), (dst, src)):
        for m, g in ((None, None), (emask, None), (None, gate), (emask, gate)):
            got = T.bitmap_hop(act, emit, m, fr, gate=g, alive=alive)
            assert torch.equal(got, T.plain_bitmap_hop(act, emit, m, fr, g, alive))
    both = T.bitmap_hop(src, dst, None, fr)
    T.bitmap_hop(dst, src, None, fr, out=both)
    assert torch.equal(both, T.plain_bitmap_hop(src, dst, None, fr) | T.plain_bitmap_hop(dst, src, None, fr))
    zero = torch.zeros_like(fr)
    assert not T.bitmap_hop(src, dst, None, zero, alive=T.mask_count(zero.view(-1))).any()
    node = _t(rng.random(vb) < 0.5).to(card)
    bound = _t(rng.integers(-2, vb, c, dtype=np.int32)).to(card)
    reached = fr | both
    for b in (None, bound):
        for flags in ((True, True, True), (False, False, True), (True, False, False), (False, True, False)):
            got = T.bitmap_emit(reached, node, b, *flags)
            want = T.plain_bitmap_emit(reached, node, b, *flags)
            for x, y in zip(got, want):
                assert (x is None and y is None) or torch.equal(x, y)
    n1, v1, n2, v2 = both.clone(), fr.clone(), both.clone(), fr.clone()
    assert torch.equal(T.frontier_advance(n1, v1), T.plain_frontier_advance(n2, v2))
    assert torch.equal(n1, n2) and torch.equal(v1, v2)
    torch.cuda.synchronize()


def _level(rng, c: int, vb: int, kind: str) -> np.ndarray:
    """A level's bitmap: V1-like sparse rows (a few reached vertices a row),
    a single set byte at the first or the last slot of each row, every byte
    set, or a random third."""
    if kind == "sparse":
        nxt = np.zeros((c, vb), bool)
        for r in range(c):
            nxt[r, rng.integers(0, vb, 9)] = True
        return nxt
    if kind == "ends":
        nxt = np.zeros((c, vb), bool)
        nxt[0::2, 0] = True
        nxt[1::2, vb - 1] = True
        return nxt
    if kind == "dense":
        return np.ones((c, vb), bool)
    return rng.random((c, vb)) < 0.3


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` one byte off 16-byte alignment (the
    kernels' one-byte path)."""
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
    v = buf[1 : 1 + t.numel()].view(t.shape)
    v.copy_(t)
    return v


def _bound_for(rng, nxt: np.ndarray) -> np.ndarray:
    """A close arm's bound column a row: -2 padding, the first and the
    last column, past the row, and reached slots."""
    c, vb = nxt.shape
    b = rng.integers(0, vb, c).astype(np.int32)
    for r in range(c):
        hit = np.flatnonzero(nxt[r])
        b[r] = (-2, 0, vb - 1, vb + 1, hit[0] if hit.size else 3)[r % 5]
    return b


LEVEL_CASES = [
    (c, vb, kind)
    for c, vb in ((1, 1 << 16), (8, 1 << 16), (33, 1 << 12), (8, 1_002), (33, 40))
    for kind in ("sparse", "ends", "dense", "random")
] + [(8, 1 << 23, "sparse"), (8, 1 << 23, "ends")]  # V1's row width


@pytest.mark.cuda
@pytest.mark.parametrize("c,vb,kind", LEVEL_CASES)
def test_level_step_kernels_equal_plain_on_card(card, c, vb, kind):
    """K12 frontier_advance (alone, gated, with the folded emission count,
    with a bound) and K11 bitmap_emit (each output, open and close) against
    their plain versions, exactly, on V1-like sparse levels, single bytes at
    a row's ends, every group set and a random third; 16-byte aligned and
    one byte off (the one-byte path), and rows not a multiple of 16."""
    rng = np.random.default_rng(c * 7 + vb + len(kind))
    nxt_np = _level(rng, c, vb, kind)
    vis_np = rng.random((c, vb)) < (0.5 if kind == "random" else 0.001)
    nxt, vis = _t(nxt_np).to(card), _t(vis_np).to(card)
    gate = _t(rng.random(vb) < 0.5).to(card)
    node = _t(rng.random(vb) < 0.5).to(card)
    bound = _t(_bound_for(rng, nxt_np & ~vis_np)).to(card)
    for view in (lambda t: t.clone(), _misaligned):
        for g in (None, gate):
            for nd, b in ((None, None), (node, None), (node, bound)):
                a = [view(nxt), view(vis)]
                w = [nxt.clone(), vis.clone()]
                args = (g if g is None else view(g), nd if nd is None else view(nd), b)
                got = T.frontier_advance(a[0], a[1], *args)
                want = T.plain_frontier_advance(w[0], w[1], g, nd, b)
                assert torch.equal(a[0], w[0]) and torch.equal(a[1], w[1])
                for x, y in zip(got if nd is not None else (got,), want if nd is not None else (want,)):
                    assert torch.equal(x, y)
        reached = view(nxt)
        for b in (None, bound):
            for flags in ((True, True, True), (False, False, True), (True, False, False), (False, True, False),
                          (False, True, True)):
                got = T.bitmap_emit(reached, view(node), b, *flags)
                want = T.plain_bitmap_emit(nxt, node, b, *flags)
                for x, y in zip(got, want):
                    assert (x is None and y is None) or torch.equal(x, y)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("c,vb", [(8, 1 << 16), (33, 1_002)])
def test_captured_level_steps_equal_eager_on_card(card, c, vb):
    """K12 with its folded count and K11's count-only and close-arm forms
    captured once in a CUDA graph, replayed over several levels copied into
    the captured buffers: each replay equals the same calls made eagerly."""
    rng = np.random.default_rng(c + vb)
    node = _t(rng.random(vb) < 0.5).to(card)
    nxt_s = torch.zeros((c, vb), dtype=torch.bool, device=card)
    vis_s = torch.zeros_like(nxt_s)
    bound_s = torch.zeros(c, dtype=torch.int32, device=card)
    T.frontier_advance(nxt_s, vis_s, node=node)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        alive, emitted = T.frontier_advance(nxt_s, vis_s, node=node, bound=None)
        _e, _a, close_n = T.bitmap_emit(nxt_s, node, bound_s, emit=False, any_row=False, count=True)
        _e, any_row, open_n = T.bitmap_emit(nxt_s, node, None, emit=False, any_row=True, count=True)
    for kind in ("sparse", "ends", "dense", "random", "sparse"):
        nxt_np = _level(rng, c, vb, kind)
        vis_np = rng.random((c, vb)) < 0.01
        b = _t(_bound_for(rng, nxt_np & ~vis_np)).to(card)
        nxt_s.copy_(_t(nxt_np).to(card))
        vis_s.copy_(_t(vis_np).to(card))
        bound_s.copy_(b)
        graph.replay()
        n, v = _t(nxt_np).to(card), _t(vis_np).to(card)
        want = T.frontier_advance(n, v, node=node)
        assert torch.equal(nxt_s, n) and torch.equal(vis_s, v)
        assert torch.equal(alive, want[0]) and torch.equal(emitted, want[1])
        assert torch.equal(close_n, T.bitmap_emit(n, node, b, emit=False, count=True)[2])
        e_any = T.bitmap_emit(n, node, None, emit=False, any_row=True, count=True)
        assert torch.equal(any_row, e_any[1]) and torch.equal(open_n, e_any[2])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "c,v,vb,avg", [(1, 1_000, 1_024, 5.0), (8, 5_000, 8_192, 8.0), (33, 3_000, 4_096, 6.0),
                   (8, 999, 1_002, 4.0), (8, 200_000, 1 << 18, 10.0)],
)
def test_bitmap_hop_csr_equals_plain_on_card(card, c, v, vb, avg):
    """K10's CSR form against its plain version, exactly: out hops and in
    hops (the mask read through ``eid``), masked and gated, ``alive`` 0,
    ORed into ``out``, a hub row and empty rows, tombstoned slots (-1
    neighbours, mask False), sparse, dense and empty frontiers, C = 1, 8
    and 33, vb > V, and vb not a multiple of 4 (the one-byte loads)."""
    rng = np.random.default_rng(c + v + vb)
    deg = rng.poisson(avg, v)
    deg[rng.random(v) < 0.2] = 0
    deg[v // 3] = 20 * int(avg) * 64  # a hub
    indptr_out = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    edge_src = np.repeat(np.arange(v, dtype=np.int32), deg)
    e = edge_src.shape[0]
    dst = rng.integers(0, v, e).astype(np.int32)
    order_in = np.argsort(dst, kind="stable").astype(np.int32)
    indptr_in = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=v))]).astype(np.int32)
    src_in = edge_src[order_in]
    live = rng.random(e) > 0.05
    in_pos = np.empty(e, np.int64)
    in_pos[order_in] = np.arange(e)
    dst[~live] = -1
    src_in[in_pos[~live]] = -1
    hops = {
        "out": tuple(_t(a).to(card) for a in (indptr_out, dst)) + (None,),
        "in": tuple(_t(a).to(card) for a in (indptr_in, src_in, order_in)),
    }
    live_d = _t(live).to(card)
    where = live_d & _t(rng.random(e) < 0.7).to(card)
    gate = _t(rng.random(vb) < 0.5).to(card)
    frontiers = [_t(rng.random((c, vb)) < p).to(card) for p in (0.0005, 0.05)]
    frontiers.append(torch.ones((c, vb), dtype=torch.bool, device=card))
    for fr in frontiers:
        alive = T.mask_count(fr.view(-1))
        for ip, nbr, eid in hops.values():
            for m, g in ((live_d, None), (where, None), (live_d, gate), (where, gate)):
                got = T.bitmap_hop_csr(ip, nbr, eid, m, fr, gate=g, alive=alive)
                assert torch.equal(got, T.plain_bitmap_hop_csr(ip, nbr, eid, m, fr, g, alive))
        both = T.bitmap_hop_csr(*hops["out"], live_d, fr)
        T.bitmap_hop_csr(*hops["in"], live_d, fr, out=both)
        want = T.plain_bitmap_hop_csr(*hops["out"], live_d, fr) | T.plain_bitmap_hop_csr(*hops["in"], live_d, fr)
        assert torch.equal(both, want)
    zero = torch.zeros((c, vb), dtype=torch.bool, device=card)
    assert not T.bitmap_hop_csr(*hops["out"], live_d, frontiers[1], alive=T.mask_count(zero.view(-1))).any()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_var_depth_and_not_on_card_equal_cpu(card):
    """Variable-depth (rows and COUNT) and NOT queries on the card, recorded
    and replayed from captured graphs, against the CPU."""
    from orientdb_tpu_torch.storage.bigshape import build_person_knows

    queries = [
        ("MATCH {class:Person, as:p, where:(uid < 60)}-knows->{as:f, while:($depth < 3), "
         "where:(age < 30)} RETURN count(*) AS n", [None] * 3),
        ("MATCH {class:Person, as:p, where:(uid < :k)}-knows-{as:f, maxDepth:2, depthAlias:d} "
         "RETURN p.uid AS p, f.uid AS f, d AS d", [{"k": 16}, {"k": 16}, {"k": 8}, {"k": 64}]),
        ("MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f}, "
         "NOT {as:f}-knows->{where:(age > 70)} RETURN p.uid AS p, f.uid AS f",
         [{"k": 16}, {"k": 16}, {"k": 8}]),
        ("MATCH {class:Person, as:p, where:(uid < 6)}-knows->{as:f}"
         "-knows-{as:p, while:($depth < 3 AND age < 70)} RETURN p.uid AS p, f.uid AS f", [None] * 2),
    ]
    kw = dict(avg_knows=6, seed=11)
    gpu, _ = build_person_knows(5_000, device=card, **kw)
    cpu, _ = build_person_knows(5_000, device="cpu", **kw)
    key = lambda r: tuple(sorted(r.items()))  # noqa: E731
    for sql, param_list in queries:
        for params in param_list:
            got = gpu.query(sql, params).to_dicts()
            want = cpu.query(sql, params).to_dicts()
            assert sorted(got, key=key) == sorted(want, key=key)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("w,n", [(0, 1), (1, 7), (255, 1024), (257, 7), (1 << 20, 50_000), ((1 << 22) + 3, 1)])
def test_rows_with_matches_equals_plain_on_card(card, w, n):
    """The OPTIONAL arm's left-join count: ascending rows as an expansion
    emits them, shuffled rows, ids past the end, padding and the
    accumulating form, exactly."""
    rng = np.random.default_rng(w + n)
    asc = np.sort(rng.integers(-1, n + 2, w)).astype(np.int32)
    for rows in (asc, rng.permutation(asc), np.full(w, -1, np.int32)):
        r = _t(rows).to(card)
        m = _t(rng.random(w) < 0.5).to(card)
        want = T.plain_rows_with_matches(r, m, n)
        assert torch.equal(T.rows_with_matches(r, m, n), want)
        acc = torch.full((n,), 3, dtype=torch.int32, device=card)
        assert torch.equal(T.rows_with_matches(r, m, n, out=acc), want + 3)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_edge_and_optional_shapes_on_card_equal_cpu(card):
    """Edge bindings, edge WHERE, OPTIONAL arms and binding references on
    the SNB-shape graph, recorded and replayed from captured graphs on the
    card, against the CPU."""
    from orientdb_tpu_torch.storage.bigshape import build_snb_shape

    queries = [
        ("MATCH {class:Person, as:p, where:(age > 40)}.outE('knows'){where:(creationDate > :d)}"
         ".inV(){as:f, where:(age < 30)}, {class:Message, as:m}-hasCreator->{as:f} "
         "RETURN count(*) AS n", [{"d": 12_000}, {"d": 15_000}, {"d": 18_500}]),
        ("MATCH {class:Person, as:p, where:(uid < :n)}.bothE('knows'){as:e}, "
         "{as:e}.bothV(){as:v} RETURN p.uid AS p, v.uid AS v", [{"n": 64}, {"n": 64}, {"n": 32}]),
        ("MATCH {class:Person, as:p, where:(uid < :n)}-knows{as:kn}-{as:f} "
         "RETURN p.uid AS p, f.uid AS f, kn.creationDate AS cd", [{"n": 256}, {"n": 256}, {"n": 128}]),
        ("MATCH {class:Person, as:p, where:(uid < :n)}-knows->{as:f, optional:true, "
         "where:(age > 75)} RETURN p.uid AS p, f.uid AS f", [{"n": 2_000}, {"n": 2_000}, {"n": 1_000}]),
        ("MATCH {class:Person, as:p, where:(uid < :n)}-knows->{as:f, where:(age < p.age)}, "
         "{as:f}-knows{as:kn, optional:true, where:(creationDate > :d)}-{as:p} "
         "RETURN p.uid AS p, f.uid AS f, kn IS NOT NULL AS probe",
         [{"n": 2_000, "d": 15_000}, {"n": 2_000, "d": 15_000}, {"n": 1_000, "d": 15_000}]),
    ]
    kw = dict(msgs_per_person=2, avg_knows=10, seed=7)
    gpu, _ = build_snb_shape(3_000, device=card, **kw)
    cpu, _ = build_snb_shape(3_000, device="cpu", **kw)
    key = lambda r: tuple(sorted((k, repr(v)) for k, v in r.items()))  # noqa: E731
    for sql, param_list in queries:
        for params in param_list:
            got = gpu.query(sql, params).to_dicts()
            want = cpu.query(sql, params).to_dicts()
            assert sorted(got, key=key) == sorted(want, key=key)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bb,w,c,b,n",
    [(16, 131_072, 3, 16, 8_192), (16, 131_072, 3, 11, 131_072), (8, 4_096, 4, 3, 2_048),
     (4, 1_024, 3, 4, 5), (2, 8, 1, 1, 7), (1, 1, 2, 1, 1), (4, 64, 3, 0, 0),
     (5, 333, 3, 5, 301), (1, 1_000, 3, 1, 999), (3, 7, 5, 2, 7), (16, 131_071, 3, 16, 131_071),
     (4, 333, 3, 4, 300), (6, 1_001, 3, 5, 777), (16, 131_071, 3, 16, 38_912)],
)
def test_group_page_equals_plain_on_card(card, bb, w, c, b, n):
    """K14 group_page against its plain version, exactly, in int32 and
    int16: B < Bb, n = W, n·C not a multiple of 4 or 8, C = 1, one row,
    an empty page, B = 1, and lane strides W·C that break the source's
    16-byte alignment (each lane then starts at its own offset), where
    the output's alignment shifts alike (n = W) or differently (4-byte
    source loads)."""
    rng = np.random.default_rng(bb * w + c + b + n)
    stack = _t(rng.integers(-(2**31), 2**31 - 1, (bb, w, c), dtype=np.int64).astype(np.int32)).to(card)
    for fits16 in (False, True):
        got = T.group_page(stack, b, n, fits16)
        want = T.plain_group_page(stack, b, n, fits16)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_captured_group_replays_equal_cpu(card):
    """A batch's group replays captured on the card (count, rows and
    direct-fetch groups, every lane's parameters different, one lane
    overflowing into a new variant, a shared no-parameter replay and a
    mixed batch) against the same batches on the CPU, whose lanes run
    uncaptured."""
    from orientdb_tpu_torch.exec import tpu_engine as TE
    from orientdb_tpu_torch.storage.bigshape import build_person_knows

    count = ("MATCH {class:Person, as:p, where:(age > :a)}-knows->{as:f, where:(age < 30)} "
             "RETURN count(*) AS n")
    rows = ("MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f}"
            "-knows->{as:g, where:(age < 30)} RETURN p.uid AS p, f.uid AS f, g.uid AS g")
    small = "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f} RETURN p.uid AS p, f.uid AS f"
    shared = "MATCH {class:Person, as:p, where:(age > 40)}-knows->{as:f} RETURN count(*) AS n"
    batches = [
        ([count] * 12, [{"a": 20 + 4 * i} for i in range(12)]),
        ([rows] * 8, [{"k": 400 - 20 * i} for i in range(8)]),
        ([rows] * 8, [{"k": 400 - 20 * i} for i in range(7)] + [{"k": 3_000}]),
        ([small] * 6, [{"k": 10 + 5 * i} for i in range(6)]),
        ([shared] * 5, None),
        ([count, rows, small, shared, rows], [{"a": 50}, {"k": 250}, {"k": 12}, None, {"k": 100}]),
    ]
    kw = dict(avg_knows=6, seed=11)
    gpu, gsnap = build_person_knows(5_000, device=card, **kw)
    cpu, _ = build_person_knows(5_000, device="cpu", **kw)
    gpu.query(rows, {"k": 400})
    cpu.query(rows, {"k": 400})
    key = lambda r: tuple(sorted(r.items()))  # noqa: E731
    for sqls, plist in batches:
        for _ in range(2):
            got = [sorted(rs.to_dicts(), key=key) for rs in gpu.query_batch(sqls, plist)]
            want = [sorted(rs.to_dicts(), key=key) for rs in cpu.query_batch(sqls, plist)]
            assert got == want
    plans = [p for v in TE._plan_cache(gsnap).values() for p in v.plans]
    groups = [g for p in plans for g in p.groups.values()]
    assert groups and all(g.graph is not None and g.nodes > 0 for g in groups)
    assert any(p.direct_fetch and p.group_replays for p in plans)
    assert any(p._rows_grouped() and p.group_replays for p in plans)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 257, 70_001])
def test_predicate_eval_equals_plain_on_card(card, n):
    """K15 against its plain version on every instruction family of
    `chip_smoke.K15_WHERES` (ids with padding and past-end entries, and
    identity mode; distance() masks outside the boundary band), the class
    lookup, and split launches against one launch."""
    import chip_smoke

    band, checked, length = chip_smoke.check_predicate_kernel(np, torch, T, n, seed=n)
    torch.cuda.synchronize()
    assert checked >= 2 * len(chip_smoke.K15_WHERES) and length > 40


@pytest.mark.cuda
def test_predicate_eval_long_program_on_card(card):
    """A program past the kernel's shared-memory copy (a 1,000-item IN
    list: ~4,000 instructions, read from device memory) and an empty slot
    range, against the plain version."""
    import chip_smoke
    from orientdb_tpu_torch.ops.device_graph import DeviceGraph
    from orientdb_tpu_torch.ops.predicates import ColumnScope, Predicate, compile_where
    from orientdb_tpu_torch.sql.parser import parse

    snap = chip_smoke.k15_snapshot(np, 50_000, 3)
    dg = DeviceGraph(snap, card)
    scope = ColumnScope(dg.columns, dg.non_columnar, device=card)
    items = ", ".join(str(v) for v in range(-500, 500))
    pred = Predicate([compile_where(parse(f"SELECT FROM V WHERE i IN [{items}]").where, scope, {})], card)
    (prog,) = pred.programs
    assert len(prog.prog.rows) * 16 > 48 * 1024
    bufs = prog.buffers({}, [], 50_000)
    ids = torch.from_numpy(np.random.default_rng(4).integers(-1, 50_003, 50_000).astype(np.int32)).to(card)
    got = T.predicate_eval(prog.prog, bufs, ids, values=True)
    want = T.plain_predicate_eval(prog.prog, bufs, ids, values=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) > 0
    assert T.predicate_eval(prog.prog, bufs, ids[:0]).shape == (0,)


def _k15_scope(card, n: int, seed: int):
    import chip_smoke
    from orientdb_tpu_torch.ops.device_graph import DeviceGraph
    from orientdb_tpu_torch.ops.predicates import ColumnScope

    snap = chip_smoke.k15_snapshot(np, n, seed)
    dg = DeviceGraph(snap, card)
    return dg, ColumnScope(dg.columns, dg.non_columnar, device=card)


def _k15_where(scope, where: str, box=None):
    from orientdb_tpu_torch.ops.predicates import compile_where
    from orientdb_tpu_torch.sql.parser import parse

    return compile_where(parse(f"SELECT FROM V WHERE {where}").where, scope, box if box is not None else {})


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ids", "identity"])
@pytest.mark.parametrize("first", ["rejects_all", "rejects_none", "id_before_class"])
def test_predicate_guards_equal_plain_on_card(card, first, mode):
    """Guarded programs (the padding test, a head conjunct, the class
    lookup, a WHERE): a head that rejects every slot (a rid no vertex has),
    none (a true constant), or all but one (an ID compare, which the
    compiler puts before the class lookup), against the plain version."""
    from orientdb_tpu_torch.ops.predicates import Predicate, _mask, class_term, id_term, valid_term

    n = 70_001
    dg, scope = _k15_scope(card, n, 7)
    head = {"rejects_all": id_term(-2), "rejects_none": _mask(True), "id_before_class": id_term(123)}[first]
    terms = [valid_term(), head, class_term(dg.v_class, dg.class_table("A")),
             _k15_where(scope, "i > 3 AND f < 2.5 OR s LIKE 'a%'")]
    pred = Predicate(terms, card)
    (prog,) = pred.programs
    rows = [r[0] for r in prog.prog.rows]
    head_op = T.PredOp.MASK if first == "rejects_none" else T.PredOp.ID
    assert rows[-1] == T.PredOp.GUARD and rows.index(head_op) < rows.index(T.PredOp.CLASS)
    ids = _t(np.random.default_rng(8).integers(-1, n + 3, n).astype(np.int32)).to(card)
    if mode == "ids":
        got, want = pred(ids), T.plain_predicate_eval(prog.prog, prog.buffers({}, [], n), ids)
    else:
        got = pred.identity(n, n - 1000, 5)
        want = T.plain_predicate_eval(prog.prog, prog.buffers({}, [], n), None, n, n - 1000, 5)
    assert torch.equal(got, want)
    admitted = int(got.sum())
    slot_ids = ids if mode == "ids" else T._slot_ids(None, n, n - 1000, 5, card)
    if first == "rejects_all":
        assert admitted == 0
    elif first == "rejects_none":
        assert admitted > 0
    else:
        assert admitted <= int((slot_ids == 123).sum())
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ids", "identity"])
def test_predicate_split_launches_equal_one_launch_on_card(card, mode):
    """The long WHERE of `chip_smoke.K15_WHERES` with the padding test: split
    into unguarded launches (stack 4, 8 buffers; values read back through
    TMP) and a guarded last one, each launch against the plain version on
    the same inputs, and the mask against the one-launch program."""
    import chip_smoke
    from orientdb_tpu_torch.ops.predicates import ParamBox, Predicate, valid_term

    n = 70_001
    dg, scope = _k15_scope(card, n, 9)
    box = ParamBox(chip_smoke.K15_PARAMS)
    where = chip_smoke.K15_WHERES[-1]
    whole = Predicate([valid_term(), _k15_where(scope, where, box)], card, box)
    split = Predicate([valid_term(), _k15_where(scope, where, box)], card, box, max_stack=4, max_bufs=8)
    assert len(whole.programs) == 1 and len(split.programs) > 1
    assert T.PredOp.GUARD not in [r[0] for p in split.programs[:-1] for r in p.prog.rows]
    ids = _t(np.random.default_rng(10).integers(-1, n + 3, n).astype(np.int32)).to(card)
    a = (ids, n, n, 0) if mode == "ids" else (None, n, n - 999, 3)
    row = box.row(card)
    tmps = []
    for prog in split.programs:
        bufs = prog.buffers({}, tmps, n)
        got = T.predicate_eval(prog.prog, bufs, *a, 0, row, values=True)
        want = T.plain_predicate_eval(prog.prog, bufs, *a, 0, row, values=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        tmps.append(got)
    one = whole(ids) if mode == "ids" else whole.identity(n, n - 999, 3)
    assert torch.equal(tmps[-1][1], one) and int(one.sum()) > 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_captured_predicate_eval_equals_eager_on_card(card):
    """A guarded mask with parameters captured once and replayed after the
    parameter row and a column change in place, against eager calls."""
    from orientdb_tpu_torch.ops.predicates import ParamBox, Predicate, pack_params, valid_term

    n = 70_001
    dg, scope = _k15_scope(card, n, 11)
    box = ParamBox({"k": 17, "x": 48.0})
    pred = Predicate([valid_term(), _k15_where(scope, "i < :k AND f > :x AND s >= 'm'", box)], card, box)
    row = torch.from_numpy(pack_params({"k": 17, "x": 48.0}, box.used)).to(card)
    box.set_row(row)
    pred.identity(n, n - 7)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pred.identity(n, n - 7)
    col = dg.columns["i"].values
    for k, x, bump in ((17, 48.0, 0), (-200, -30.5, 3), (500, 0.0, -5)):
        row.copy_(torch.from_numpy(pack_params({"k": k, "x": x}, box.used)))
        col.add_(bump)
        out.fill_(True)
        graph.replay()
        assert torch.equal(out, pred.identity(n, n - 7))
    box.reset()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_distance_queries_on_card_equal_cpu(card):
    """distance() MATCH shapes (a COUNT recorded then replayed at other
    radii, miles rows) on the card against the CPU on the same graph: they
    may differ only on slots of the boundary band (float64 distance within
    0.01 km + 1e-5·r of r), whose count bounds the difference."""
    import chip_smoke
    from orientdb_tpu_torch.storage.bigshape import build_person_knows, numpy_distance_km

    kw = dict(avg_knows=6, seed=21, geo=True)
    gpu, snap = build_person_knows(20_000, device=card, **kw)
    cpu, _ = build_person_knows(20_000, device="cpu", **kw)
    lat, lng = (snap.v_columns[c] for c in ("lat", "lng"))
    d = numpy_distance_km(lat.values, lng.values, 48.0, 2.0)
    live = lat.present & lng.present
    count = ("MATCH {class:Person, as:p, where:(distance(lat, lng, :x, :y) < :r)} "
             "RETURN count(*) AS n")
    rows = ("MATCH {class:Person, as:p, where:(distance(lat, lng, 48.0, 2.0, 'mi') < :r)} "
            "RETURN p.uid AS uid")
    for r in (8000.0, 300.0, 2500.0):
        band = int((chip_smoke.distance_band(np, d, r) & live).sum())
        got = gpu.query(count, {"x": 48.0, "y": 2.0, "r": r}).to_dicts()[0]["n"]
        want = cpu.query(count, {"x": 48.0, "y": 2.0, "r": r}).to_dicts()[0]["n"]
        assert abs(got - want) <= band
    for r in (2000, 1200):
        band = set(np.flatnonzero(chip_smoke.distance_band(np, d, r / 0.621371192) & live).tolist())
        got = {x["uid"] for x in gpu.query(rows, {"r": r}).to_dicts()}
        want = {x["uid"] for x in cpu.query(rows, {"r": r}).to_dicts()}
        assert (got ^ want) <= band and got
    torch.cuda.synchronize()


def _slab_arrays(rng, v, base, used, cap, nb, bk, dead_frac):
    """A padded edge list whose slab holds ``used`` edges, a fraction of
    them tombstoned, with bucket tables as the maintainer builds them (a
    full bucket takes no more entries)."""
    src = np.full(cap, -1, np.int32)
    dst = np.full(cap, -1, np.int32)
    live = np.zeros(cap, bool)
    src[: base + used] = rng.integers(0, v, base + used)
    dst[: base + used] = rng.integers(0, v, base + used)
    live[: base + used] = rng.random(base + used) >= dead_frac
    tabs = {}
    for d, key in (("out", src), ("in", dst)):
        tab, fill = np.full(nb * bk, -1, np.int32), np.zeros(nb, np.int64)
        for rel in range(used):
            b = int(key[base + rel]) & (nb - 1)
            if fill[b] < bk:
                tab[b * bk + fill[b]] = rel
                fill[b] += 1
        tabs[d] = tab
    return src, dst, live, tabs


@pytest.mark.cuda
@pytest.mark.parametrize("r,base,used,cap_out", [(1, 0, 1, 8), (300, 1_000, 700, 8), (4_096, 50_000, 20_000, 0)])
def test_delta_kernels_equal_plain_on_card(card, r, base, used, cap_out):
    """K16 `scatter_set` (int32, float32, bool), K18 `slab_probe` and K17
    `slab_scan` against their plain versions, with -1 sources, tombstones,
    both directions, and capacities that hold the total or cut it."""
    rng = np.random.default_rng(r + used)
    v, nb, bk = 5_000, 256, 8
    cap = base + used + 64
    src, dst, live, tabs = _slab_arrays(rng, v, base, used, cap, nb, bk, 0.2)
    for dtype in (np.int32, np.float32, np.bool_):
        arr = _t((rng.random(cap) * 100).astype(dtype)).to(card)
        idx = rng.permutation(cap)[: min(cap, 3 * r)].astype(np.int32)
        vals = _t((rng.random(idx.shape[0]) * 100).astype(dtype)).to(card)
        a, b = arr.clone(), arr.clone()
        T.scatter_set(a, _t(idx).to(card), vals)
        T.plain_scatter_set(b, _t(idx).to(card), vals)
        assert torch.equal(a, b)
    srcs = rng.integers(0, v, r).astype(np.int32)
    srcs[::3] = -1
    g = {k: _t(x).to(card) for k, x in (("src", src), ("dst", dst), ("live", live), ("srcs", srcs))}
    size = (lambda t: max(T.bucket(int(t)), 8)) if cap_out == 0 else (lambda t: cap_out)
    for d in ("out", "in"):
        own, nbr = (g["src"], g["dst"]) if d == "out" else (g["dst"], g["src"])
        tab = _t(tabs[d]).to(card)
        got = T.slab_probe(tab, own, nbr, g["live"], g["srcs"], base, nb, bk, size)
        want = T.plain_slab_probe(tab, own, nbr, g["live"], g["srcs"], base, nb, bk, size)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        w = slice(base, cap)
        win = (own[w].contiguous(), nbr[w].contiguous(), g["live"][w].contiguous())
        got = T.slab_scan(*win, g["srcs"], base, size)
        want = T.plain_slab_scan(*win, g["srcs"], base, size)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_delta_batches_on_card_equal_cpu(card):
    """Write batches applied in place on the card against the same batches
    on the CPU: after a DATA-only batch a cached plan replays the SAME
    captured graph on the same tensors (same ``data_ptr``); a first
    topology batch re-records once; a bucket overflow switches to the
    window scan; every result equals the CPU twin's."""
    import chip_smoke
    from orientdb_tpu_torch.exec import tpu_engine as TE
    from orientdb_tpu_torch.ops.device_graph import cached_device_graph
    from orientdb_tpu_torch.storage.bigshape import build_person_knows
    from orientdb_tpu_torch.storage.deltas import arm_delta_maintenance

    kw = dict(avg_knows=6, seed=23)
    twins = [build_person_knows(4_000, device=dev, **kw) for dev in (card, "cpu")]
    ms = [arm_delta_maintenance(db, 256, 4_096) for db, _ in twins]
    qs = [(chip_smoke.D1, {"k": 1_000}), (chip_smoke.Q3, {"k": 300}), (chip_smoke.V1, {}),
          (chip_smoke.Q_DIRECT, {"k": 50})]

    def same_results():
        for sql, p in qs:
            got, want = (sorted(map(str, db.query(sql, p).to_dicts())) for db, _ in twins)
            assert got == want, sql

    def plans():
        return {sql: chip_smoke._only_plan(TE, twins[0][1], sql).plans for sql, _ in qs}

    def apply(batch):
        for m in ms:
            assert m.apply_batch([dict(e) for e in batch])

    same_results()
    same_results()
    writer = chip_smoke.DeltaWriter(np, twins[0][0], twins[0][1], seed=3)
    w1 = writer.w1(64, 512)
    apply(w1)
    ov = twins[0][1]._overlay
    assert ov.plan_gen == 1
    same_results()
    same_results()
    before = plans()
    graphs = {sql: (p[0].graph, p[0].replays) for sql, p in before.items()}
    dg = cached_device_graph(twins[0][1])
    ptrs = {k: a.data_ptr() for k, a in dg.arrays.items()}
    apply(writer.w2(500))
    assert ov.plan_gen == 1
    same_results()
    after = plans()
    for sql, (graph, replays) in graphs.items():
        assert after[sql] == before[sql] and after[sql][0].graph is graph
        assert graph is not None and after[sql][0].replays == replays + 1
    apply(writer.w3(40, 32, 300))
    same_results()
    assert {k: a.data_ptr() for k, a in dg.arrays.items()} == ptrs
    apply(writer.w4(5, 12))
    assert ov.bucket_overflow == {"knows"} and ov.plan_gen == 2
    same_results()
    same_results()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "v,avg,block_edges,pages,c",
    [
        (60, 3.0, 16, 3, 1), (60, 3.0, 16, 0, 2), (5_000, 6.0, 256, 20, 8), (100_000, 8.0, 4_096, 60, 8),
        (5_000, 6.0, 256, 20, 40),
    ],
)
def test_paged_kernels_equal_plain_on_card(card, v, avg, block_edges, pages, c):
    """K19 paged_hop_csr (the push), K20 paged_hop_miss and K21
    paged_expand against their plain versions, exactly, and K19 against
    the slot walk it replaces: resident, free and evicted pages with vertex
    0 in every frontier row, an edge mask with -1 edge ids, a WHILE gate,
    an empty frontier, padding sources and cold blocks, both directions of
    K21, and an empty pool."""
    rng = np.random.default_rng(v + pages)
    indptr, part, pools, pageof = paged_pool(rng, v, avg, block_edges, pages)
    push, slot = paged_args(indptr, part, pools, pageof, card)
    vb = T.bucket(v)
    d = {n: _t(a).to(card) for n, a in pools.items()}
    ip, pg = _t(indptr).to(card), _t(pageof).to(card)
    bv, es = _t(part.block_of_v).to(card), _t(part.edge_start).to(card)
    fr = rng.random((c, vb)) < 0.05
    fr[:, 0] = True
    fr_t = _t(fr).to(card)
    emask = _t(rng.random(part.E) < 0.7).to(card)
    gate = _t(rng.random(vb) < 0.8).to(card)
    for m in (None, emask):
        for g in (None, gate):
            got = T.paged_hop_csr(*push, m, fr_t, g)
            assert torch.equal(got, T.plain_paged_hop_csr(*push, m, fr_t, g))
            assert torch.equal(got, T.plain_paged_hop(*slot, m, fr_t, g))
            acc = torch.zeros_like(fr_t)
            acc[:, -1] = True
            T.paged_hop_csr(*push, m, fr_t, g, out=acc)
            assert torch.equal(acc, got | (torch.arange(vb, device=card) == vb - 1)[None, :])
            want = T.plain_paged_hop_miss(fr_t, bv, pg, ip, g)
            assert bool(T.paged_hop_miss(fr_t, bv, pg, ip, g)) == bool(want)
    zero = torch.zeros((), dtype=torch.int32, device=card)
    empty = torch.zeros_like(fr_t)
    assert not bool(T.paged_hop_miss(empty, bv, pg, ip))
    assert not bool(T.paged_hop_miss(fr_t, bv, pg, ip, alive=zero))
    assert not T.paged_hop_csr(*push, None, fr_t, alive=zero).any()
    for R in (1, 255, 4_097):
        srcs = rng.integers(-1, v, R).astype(np.int32)
        s_t = _t(srcs).to(card)
        counts = T.degree_counts(ip, s_t)
        offsets = T.exclusive_cumsum(counts)
        total = T.value_sum(counts)
        out_size = T.bucket(max(int(total), 1))
        for out_dir in (True, False):
            got = T.paged_expand(ip, s_t, offsets, total, out_size, bv, pg, es, d["nbr"], d["eid"], out_dir)
            want = T.plain_paged_expand(ip, s_t, offsets, total, out_size, bv, pg, es, d["nbr"], d["eid"], out_dir)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_tiered_queries_on_card_equal_cpu(card, monkeypatch):
    """A tiered snapshot (the cap at half its adjacency) on the card against
    its CPU twin: 1-hop COUNT, in-direction rows, variable depth and a NOT
    arm, recorded, replayed off and on their footprints, then after a 2-hop
    whose frontier grows the pool (every plan re-records); the residency
    counters move alike on both."""
    from orientdb_tpu_torch.exec import tpu_engine as TE
    from orientdb_tpu_torch.storage import tiering
    from orientdb_tpu_torch.storage.bigshape import build_person_knows
    from orientdb_tpu_torch.utils.config import config

    monkeypatch.setattr(config, "tier_block_edges", 1_024)
    twins = [build_person_knows(20_000, avg_knows=6, seed=13, device=dev) for dev in (card, "cpu")]
    adj = tiering.adjacency_bytes(twins[0][1])
    monkeypatch.setattr(config, "tier_hbm_cap_bytes", adj // 2)
    for db, snap in twins:
        db.attach_snapshot(snap)
        assert snap._tier is not None
    qs = [
        ("MATCH {class:Person, as:p, where:(uid = :u)}-knows->{as:f, where:(age < 30)} "
         "RETURN count(*) AS n", "u"),
        ("MATCH {class:Person, as:p, where:(uid < :u)}<-knows-{as:f} RETURN p.uid AS pu, f.uid AS fu", "u"),
        ("MATCH {class:Person, as:p, where:(uid = :u)}-knows->{as:f, while:($depth < 2)} "
         "RETURN count(*) AS n", "u"),
        ("MATCH {class:Person, as:p, where:(uid = :u)}-knows->{as:f}, "
         "NOT {as:f}-knows->{where:(age > 60)} RETURN f.uid AS fu", "u"),
    ]

    def run(us):
        for sql, name in qs:
            for u in us:
                got, want = (sorted(map(str, db.query(sql, {name: u}).to_dicts())) for db, _ in twins)
                assert got == want, (sql, u)

    run([3, 3, 9_001, 3, 17_777, 9_001])
    counts = [
        {k: s._tier.stats()[k] for k in ("prefetch_hits", "prefetch_misses", "evictions")} for _, s in twins
    ]
    assert counts[0] == counts[1] and counts[0]["evictions"] > 0
    grow = "MATCH {class:Person, as:p, where:(uid < 500)}-knows->{as:f}-knows->{as:g} RETURN count(*) AS n"
    got, want = (db.query(grow).to_dicts() for db, _ in twins)
    assert got == want
    tier = twins[0][1]._tier
    assert tier.generation > 0
    run([3, 9_001])
    plans = [p for v in TE._plan_cache(twins[0][1]).values() for p in v.plans]
    assert all(p.graph is not None for p in plans)
    assert any(p.tier_gen == tier.generation and p.replays > 0 for p in plans)
    assert all(not p.pins for p in tier.parts.values())
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("c,vb", [(1, 16), (1, 1 << 20), (3, 40), (8, 1 << 12)])
def test_traverse_kernel_forms_equal_plain_on_card(card, c, vb):
    """The three kernel forms TRAVERSE adds, against their plain versions:
    K12 with its admission gate (random, empty and all-true gates, and
    without one; a row length off the 16-byte path), K15's ID instruction
    (against -2, a live id and the last slot; ids and identity mode) and
    K3's offset form (a level inside the buffer, a slot past its count, the
    buffer's end)."""
    from orientdb_tpu_torch.ops.predicates import Predicate, id_term

    rng = np.random.default_rng(c * vb)
    for gate in (rng.random(vb) < 0.5, np.zeros(vb, bool), np.ones(vb, bool), None):
        nxt, vis = rng.random((c, vb)) < 0.3, rng.random((c, vb)) < 0.3
        a = [_t(nxt.copy()).to(card), _t(vis.copy()).to(card)]
        b = [_t(nxt.copy()).to(card), _t(vis.copy()).to(card)]
        g = None if gate is None else _t(gate).to(card)
        got, want = T.frontier_advance(a[0], a[1], g), T.plain_frontier_advance(b[0], b[1], g)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and torch.equal(got, want)
    ids = rng.integers(-2, vb + 2, c * vb, dtype=np.int32)
    cpu = torch.device("cpu")
    for want_id in (-2, max(int(ids[0]), 0), vb - 1):
        on, off = Predicate([id_term(want_id)], card), Predicate([id_term(want_id)], cpu)
        assert torch.equal(on(_t(ids).to(card)).cpu(), off(_t(ids)))
        assert torch.equal(on.identity(c * vb, vb - 3, 2).cpu(), off.identity(c * vb, vb - 3, 2))
    mask = rng.random(c * vb) < 0.2
    n = int(mask.sum())
    base = np.full(n + 20, -7, np.int32)
    for size, offset in ((n, 13), (n + 7, 13), (0, n + 20)):
        on, off = _t(base.copy()).to(card), _t(base.copy())
        T.compact_indices(_t(mask).to(card), size, out=on, offset=offset)
        T.plain_compact_indices(_t(mask), size, out=off, offset=offset)
        assert torch.equal(on.cpu(), off)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_traverse_and_records_on_card_equal_cpu(card):
    """TRAVERSE (recorded, then captured replays, and a batch's shared
    dispatch), whole-record SELECT, a rid filter and the record RETURNs on
    the card against the same calls on the CPU."""
    from orientdb_tpu_torch.exec import tpu_engine as TE
    from orientdb_tpu_torch.sql.parser import parse
    from orientdb_tpu_torch.storage.bigshape import build_person_knows

    kw = dict(avg_knows=6, seed=11)
    gpu, gsnap = build_person_knows(5_000, device=card, **kw)
    cpu, _ = build_person_knows(5_000, device="cpu", **kw)
    c = gpu.schema.get_class("Person").cluster_ids[0]
    trav = "TRAVERSE out('knows') FROM (SELECT FROM Person WHERE uid < 20) WHILE $depth < 2 STRATEGY BREADTH_FIRST"
    queries = [
        (trav, None),
        ("TRAVERSE both('knows') FROM (SELECT FROM Person WHERE uid < 5) MAXDEPTH 2 STRATEGY BREADTH_FIRST", None),
        ("TRAVERSE out('knows') FROM (SELECT FROM Person WHERE uid < 30) WHILE $depth < 4 AND age > 30 "
         "STRATEGY BREADTH_FIRST", None),
        (f"TRAVERSE out('knows') FROM #{c}:0", None),
        ("SELECT FROM Person WHERE uid < :k", {"k": 300}),
        ("SELECT FROM Person WHERE uid < :k", {"k": 100}),
        ("SELECT count(*) AS n FROM Person WHERE age > 35 AND age < 55", None),
        (f"MATCH {{class:Person, rid:#{c}:5, as:p}}-knows->{{as:f}} RETURN p, f, f.@class", None),
        (f"MATCH {{class:Person, rid:#{c}:5, as:p}}-knows->{{as:f}} RETURN $elements", None),
    ]
    for sql, params in queries:
        for _ in range(3):
            assert gpu.query(sql, params).to_dicts() == cpu.query(sql, params).to_dicts()
    want = cpu.query(trav).to_dicts()
    (variants,) = [v for k, v in TE._plan_cache(gsnap).items() if k[0] == parse(trav)]
    plan = variants.plans[0]
    before = plan.replays
    assert [rs.to_dicts() for rs in gpu.query_batch([trav] * 8)] == [want] * 8
    assert plan.replays == before + 1
    plans = [p for v in TE._plan_cache(gsnap).values() for p in v.plans]
    assert all(p.graph is not None for p in plans)
    assert any(isinstance(p, TE._CompiledTraverse) and p.launches.get("frontier_advance") for p in plans)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("S,v,avg,hub,empty", SHARD_CASES)
def test_shard_push_equals_plain_on_card(card, S, v, avg, hub, empty):
    """K10's eid form on the skewed mesh layouts of
    `tests/test_torch_push_hops.py` (a hub row, empty runs, groups across
    shard boundaries, a shard past V), at C = 1, 3 and 40, sparse, empty
    and dense frontiers, with and without mask and gate: equal to its plain
    push and to the slot walk over the edge-list slices, exactly; each
    rank's shard alone ORs to the same bitmap; ``alive`` 0 writes nothing;
    a captured launch replays equal."""
    rng = np.random.default_rng(S * 1000 + v)
    indptr, nbrs = skewed_csr(rng, v, avg, hub, empty)
    csr, el, _R = shard_layout(indptr, nbrs, S)
    csr = {d: tuple(t.to(card) for t in x[:3]) + (x[3],) for d, x in csr.items()}
    el = tuple(t.to(card) for t in el)
    vb = T.bucket(v)
    emask = _t(rng.random(nbrs.shape[0]) < 0.7).to(card)
    gate = _t(rng.random(vb) < 0.8).to(card)
    zero = torch.zeros((), dtype=torch.int32, device=card)
    for c in (1, 3, 40):
        for fr in frontiers(rng, c, vb, card):
            for d, (a, e) in (("out", (el[0], el[1])), ("in", (el[1], el[0]))):
                sh = csr[d]
                for m in (None, emask):
                    for g in (None, gate):
                        got = T.bitmap_hop_shard(*sh[:3], sh[3], 0, m, fr, g)
                        assert torch.equal(got, T.plain_bitmap_hop_shard(*sh[:3], sh[3], 0, m, fr, g))
                        assert torch.equal(got, T.plain_bitmap_hop_eid(a, e, el[2], m, fr, g))
                        ranks = torch.zeros_like(got)
                        for s0 in range(S):
                            T.bitmap_hop_shard(*(t[s0 : s0 + 1] for t in sh[:3]), sh[3], s0, m, fr, g, out=ranks)
                        assert torch.equal(ranks, got)
                assert not T.bitmap_hop_shard(*sh[:3], sh[3], 0, emask, fr, gate, zero).any()
    sh, fr = csr["in"], frontiers(rng, 40, vb, card)[0]
    outs = {}
    fn = lambda: outs.__setitem__("hop", T.bitmap_hop_shard(*sh[:3], sh[3], 0, emask, fr, gate))  # noqa: E731
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    outs["hop"].fill_(True)
    graph.replay()
    assert torch.equal(outs["hop"], T.plain_bitmap_hop_shard(*sh[:3], sh[3], 0, emask, fr, gate))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("v,avg,block_edges,pages,hub,empty", PAGED_CASES)
def test_paged_push_equals_plain_on_card(card, v, avg, block_edges, pages, hub, empty):
    """K19's push on the skewed pools of `tests/test_torch_push_hops.py`
    (cold blocks, free pages, an evicted page with stale rows, -1 edge ids
    under live owners, a hub block, empty rows), at C = 1, 2 and 40,
    sparse, empty and dense frontiers, with and without mask and gate:
    equal to its plain push and to the slot walk over the pool, exactly;
    ``alive`` 0 writes nothing."""
    rng = np.random.default_rng(v + pages + hub)
    indptr, part, pools, pageof = paged_pool(rng, v, avg, block_edges, pages, hub, empty)
    push, slot = paged_args(indptr, part, pools, pageof, card)
    vb = T.bucket(v)
    emask = _t(rng.random(part.E) < 0.7).to(card)
    gate = _t(rng.random(vb) < 0.8).to(card)
    zero = torch.zeros((), dtype=torch.int32, device=card)
    for c in (1, 2, 40):
        for fr in frontiers(rng, c, vb, card):
            for m in (None, emask):
                for g in (None, gate):
                    got = T.paged_hop_csr(*push, m, fr, g)
                    assert torch.equal(got, T.plain_paged_hop_csr(*push, m, fr, g))
                    assert torch.equal(got, T.plain_paged_hop(*slot, m, fr, g))
            assert not T.paged_hop_csr(*push, emask, fr, gate, zero).any()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("S,v,avg,hub,empty", WEIGHT_CASES)
def test_shard_weight_pass_equals_plain_on_card(card, S, v, avg, hub, empty):
    """K23's merge path on skewed row-sharded layouts (a hub of up to
    100,000 edges across many tiles, runs of empty rows, shards past V)
    against its plain CSR walk and the slices' walk: int32 exactly (out and
    in, with and without an edge mask, a vertex mask and weights, all
    shards and one rank's shard at a time), float32 to rtol 1e-5 and bit
    for bit between two calls, and in a captured graph."""
    rng = np.random.default_rng(S * 100 + v + hub)
    indptr, nbrs = skewed_csr(rng, v, avg, hub, empty)
    csr, el, R = shard_layout(indptr, nbrs, S)
    csr = {d: tuple(t.to(card) for t in c[:3]) + (c[3],) for d, c in csr.items()}
    el = tuple(t.to(card) for t in el)
    vb = T.bucket(v)
    emask = _t(rng.random(nbrs.shape[0]) < 0.7).to(card)
    ok = _t(rng.random(vb) < 0.6).to(card)
    w_i = _t(rng.integers(-50, 1000, vb).astype(np.int32)).to(card)
    w_f = _t((rng.random(vb) * 3.0).astype(np.float32)).to(card)
    i32 = lambda: torch.zeros(vb, dtype=torch.int32, device=card)  # noqa: E731
    for d, (seg, emit) in (("out", (el[0], el[1])), ("in", (el[1], el[0]))):
        sh = csr[d]
        for m in (None, emask):
            for o in (None, ok):
                for w in (None, w_i):
                    got = T.shard_weight_pass(*sh, 0, m, o, w, i32())
                    assert torch.equal(got, T.plain_shard_weight_pass_csr(*sh, 0, m, o, w, i32()))
                    assert torch.equal(got, T.plain_shard_weight_pass(seg, emit, el[2], m, o, w, i32()))
                    ranks = i32()
                    for s0 in range(S):
                        T.shard_weight_pass(*(t[s0 : s0 + 1] for t in sh[:3]), sh[3], s0, m, o, w, ranks)
                    assert torch.equal(ranks, got)
            got = T.shard_weight_pass(*sh, 0, m, ok, w_f, torch.zeros(vb, device=card))
            want = T.plain_shard_weight_pass(seg, emit, el[2], m, ok, w_f, torch.zeros(vb, device=card))
            torch.testing.assert_close(got, want, rtol=F32_RTOL, atol=F32_RTOL * float(want.abs().max() + 1))
            again = T.shard_weight_pass(*sh, 0, m, ok, w_f, torch.zeros(vb, device=card))
            assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    out = i32()
    T.shard_weight_pass(*csr["in"], 0, emask, ok, w_i, out)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.zero_()
        T.shard_weight_pass(*csr["in"], 0, emask, ok, w_i, out)
    out.fill_(-1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, T.plain_shard_weight_pass(el[1], el[0], el[2], emask, ok, w_i, i32()))


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [0.0, 0.2, 0.5, 1.0])
def test_shard_weight_pass_sampled_fold_on_card(card, keep):
    """K23 with weights over 16 MiB (vb = 2^23 int32), where a device-side
    sample of the vertex mask decides whether to fold it into the weights:
    masks keeping none, a fifth, half and all of the vertices give the
    plain sums exactly, out and in, with a direct edge mask on the out
    pass."""
    rng = np.random.default_rng(int(keep * 10) + 1)
    v = 4_200_000
    indptr, nbrs = skewed_csr(rng, v, 1.0, 5_000)
    csr, el, _R = shard_layout(indptr, nbrs, 2)
    csr = {d: tuple(t.to(card) for t in c[:3]) + (c[3],) for d, c in csr.items()}
    el = tuple(t.to(card) for t in el)
    vb = T.bucket(v)
    assert vb * 4 > T.L2_FAST_BYTES
    ok = _t(rng.random(vb) < keep).to(card)
    w = _t(rng.integers(-5, 40, vb).astype(np.int32)).to(card)
    emask = _t(rng.random(nbrs.shape[0]) < 0.7).to(card)
    i32 = lambda: torch.zeros(vb, dtype=torch.int32, device=card)  # noqa: E731
    for d, (seg, emit), m in (("out", (el[0], el[1]), emask), ("out", (el[0], el[1]), None), ("in", (el[1], el[0]), None)):
        got = T.shard_weight_pass(*csr[d], 0, m, ok, w, i32())
        assert torch.equal(got, T.plain_shard_weight_pass(seg, emit, el[2], m, ok, w, i32()))


@pytest.mark.cuda
@pytest.mark.parametrize("v,avg,block_edges,pages,hub,empty", PAGED_CASES)
def test_paged_push_flag_equals_plain_on_card(card, v, avg, block_edges, pages, hub, empty):
    """K19 with K20 folded in: the push's cold-miss flag equals
    `plain_paged_hop_miss` (and the standalone K20) on the pool as kept,
    every page evicted and an empty pool, with a gate, ``alive`` 0 and an
    empty frontier; the flag is only ever set; the hop's bits are the same
    with and without it; and in a captured graph the replayed flag follows
    the frontier."""
    rng = np.random.default_rng(3 * v + pages + hub)
    indptr, part, pools, pageof = paged_pool(rng, v, avg, block_edges, pages, hub, empty)
    vb = T.bucket(v)
    gate = _t(rng.random(vb) < 0.8).to(card)
    zero = torch.zeros((), dtype=torch.int32, device=card)
    no_pool = {n: np.zeros((0, part.Wp), np.int32) for n in pools}
    for pl, pg in ((pools, pageof), (pools, np.full_like(pageof, -1)), (no_pool, np.full_like(pageof, -1))):
        push, _slot = paged_args(indptr, part, pl, pg, card)
        ip, bv, pgt = push[0], push[1], push[2]
        for c in (1, 40):
            for fr in frontiers(rng, c, vb, card):
                for g in (None, gate):
                    for a in (None, zero):
                        want = T.plain_paged_hop_miss(fr, bv, pgt, ip, g, a)
                        miss = torch.zeros((), dtype=torch.bool, device=card)
                        hop = T.paged_hop_csr(*push, None, fr, g, a, miss=miss)
                        assert bool(miss) == bool(want) == bool(T.paged_hop_miss(fr, bv, pgt, ip, g, a))
                        assert torch.equal(hop, T.paged_hop_csr(*push, None, fr, g, a))
                        stay = torch.ones((), dtype=torch.bool, device=card)
                        T.paged_hop_csr(*push, None, fr, g, a, miss=stay)
                        assert bool(stay)
    push, _slot = paged_args(indptr, part, pools, pageof, card)
    fr = torch.zeros((2, vb), dtype=torch.bool, device=card)
    miss = torch.zeros((), dtype=torch.bool, device=card)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        miss.zero_()
        T.paged_hop_csr(*push, None, fr, miss=miss)
    for f in frontiers(rng, 2, vb, card):
        fr.copy_(f)
        graph.replay()
        torch.cuda.synchronize()
        assert bool(miss) == bool(T.plain_paged_hop_miss(f, push[1], push[2], push[0]))


def _sharded_inputs(rng, S: int, v: int, avg: float):
    """A random graph's mesh layout (`MeshGraph.build` through a CPU device
    graph), its sources with padding and unowned ids, and its edge count."""
    from orientdb_tpu_torch.ops.device_graph import device_graph
    from orientdb_tpu_torch.parallel.sharded import make_mesh
    from orientdb_tpu_torch.storage.bigshape import build_person_knows

    db, snap = build_person_knows(v, avg_knows=avg, seed=int(rng.integers(1 << 20)), device="cpu")
    db.attach_snapshot(snap, mesh=make_mesh(S, device="cpu"))
    dg = device_graph(snap, db.device)
    return dg, snap.edge_classes["knows"].num_edges


@pytest.mark.cuda
@pytest.mark.parametrize("S,v,avg", [(1, 50, 2.0), (4, 1_000, 0.3), (4, 5_000, 6.0), (8, 3, 1.0), (3, 100_003, 8.0)])
def test_mesh_kernels_equal_plain_on_card(card, S, v, avg):
    """K2's range form, K22 shard_gather (both directions, a cap below a
    shard's total, the process form), K10's eid form, K23 (int32 exactly,
    float32 to rtol 1e-5, with and without weights and mask) and K24 against
    their plain versions, on the same sharded inputs; K10's eid form (the
    push over the row-sharded CSR, also one rank's shard at s0 = 1) and K23
    (its segmented sum over that CSR, also one rank's shard) also against
    the slot walks over the edge-list slices."""
    rng = np.random.default_rng(v + S)
    dg, E = _sharded_inputs(rng, S, v, avg)
    A = {k: a.to(card) for k, a in dg.arrays.items() if k.startswith("sh:")}
    span = A["sh:rowspan"]
    vb = T.bucket(v)
    for n in (0, 1, 257, 3_000):
        srcs = _t(rng.integers(-1, v, n).astype(np.int32)).to(card)
        counts, tots = T.degree_counts_range(A["sh:knows:out:indptr"], span, srcs)
        pc, pt = T.plain_degree_counts_range(A["sh:knows:out:indptr"], span, srcs)
        assert torch.equal(counts, pc) and torch.equal(tots, pt)
        for d, extra in (("out", "sh:knows:out:ebase"), ("in", "sh:knows:in:eid")):
            ind, nbr, ex = A[f"sh:knows:{d}:indptr"], A[f"sh:knows:{d}:nbr"], A[extra]
            c_d, t_d = T.degree_counts_range(ind, span, srcs)
            off_d = T.exclusive_cumsum(c_d.view(-1))
            mx = int(t_d.max()) if S else 0
            for cap, cap_total in ((T.bucket(max(mx, 1)), T.bucket(max(int(t_d.sum()), 1))), (max(mx // 2, 1), 64)):
                for plus_one in (False, True):
                    args = (ind, nbr, ex, span, srcs, off_d, t_d, 0, cap, cap_total, d == "out", plus_one)
                    got = T.shard_gather(*args)
                    want = T.plain_shard_gather(*args)
                    for a, b in zip(got, want):
                        assert torch.equal(a, b)
            if S > 1:  # one rank's shard of a process group
                one = (ind[1:2], nbr[1:2], ex[1:2], span[1:2], srcs)
                c1, _t1 = T.degree_counts_range(ind[1:2], span[1:2], srcs)
                o1 = T.exclusive_cumsum(c1.view(-1))
                args = one + (o1, t_d, 1, T.bucket(max(mx, 1)), T.bucket(max(int(t_d.sum()), 1)), d == "out", True)
                for a, b in zip(T.shard_gather(*args), T.plain_shard_gather(*args)):
                    assert torch.equal(a, b)
    el = [A[f"sh:knows:el:{k}"] for k in ("src", "dst", "eid")]
    emask = _t(rng.random(E) < 0.7).to(card)
    fr = rng.random((3, vb)) < 0.05
    fr[:, 0] = True
    fr_t = _t(fr).to(card)
    gate = _t(rng.random(vb) < 0.8).to(card)
    for (a, e), (d, extra) in (((el[0], el[1]), ("out", "ebase")), ((el[1], el[0]), ("in", "eid"))):
        sh = tuple(A[f"sh:knows:{d}:{k}"] for k in ("indptr", "nbr", extra))
        for m in (None, emask):
            for g in (None, gate):
                got = T.bitmap_hop_shard(*sh, d == "out", 0, m, fr_t, g)
                assert torch.equal(got, T.plain_bitmap_hop_shard(*sh, d == "out", 0, m, fr_t, g))
                assert torch.equal(got, T.plain_bitmap_hop_eid(a, e, el[2], m, fr_t, g))
                if S > 1:  # one rank's shard of a process group
                    one = tuple(t[1:2] for t in sh)
                    got = T.bitmap_hop_shard(*one, d == "out", 1, m, fr_t, g)
                    assert torch.equal(got, T.plain_bitmap_hop_shard(*one, d == "out", 1, m, fr_t, g))
        ok = _t(rng.random(vb) < 0.6).to(card)
        w_i = _t(rng.integers(0, 50, vb).astype(np.int32)).to(card)
        w_f = w_i.float() * 0.37
        for m in (None, emask):
            for w in (None, w_i):
                got = T.shard_weight_pass(*sh, d == "out", 0, m, ok, w, torch.ones(vb, dtype=torch.int32, device=card))
                want = T.plain_shard_weight_pass(a, e, el[2], m, ok, w, torch.ones(vb, dtype=torch.int32, device=card))
                assert torch.equal(got, want)
                assert torch.equal(got, T.plain_shard_weight_pass_csr(
                    *sh, d == "out", 0, m, ok, w, torch.ones(vb, dtype=torch.int32, device=card)))
                if S > 1:  # one rank's shard of a process group
                    one = tuple(t[1:2] for t in sh)
                    got = T.shard_weight_pass(*one, d == "out", 1, m, ok, w, torch.zeros(vb, dtype=torch.int32, device=card))
                    assert torch.equal(got, T.plain_shard_weight_pass_csr(
                        *one, d == "out", 1, m, ok, w, torch.zeros(vb, dtype=torch.int32, device=card)))
            got = T.shard_weight_pass(*sh, d == "out", 0, m, ok, w_f, torch.zeros(vb, device=card))
            want = T.plain_shard_weight_pass(a, e, el[2], m, ok, w_f, torch.zeros(vb, device=card))
            torch.testing.assert_close(got, want, rtol=F32_RTOL, atol=F32_RTOL * float(want.abs().max() + 1))
    R = int(A["sh:knows:out:indptr"].shape[1] - 1)
    for q in (1, 5, 40):
        f = _t(rng.random((S, q, R)) < 0.02).to(card)
        got = T.rowshard_hop(A["sh:knows:out:indptr"], A["sh:knows:out:nbr"], f, S)
        assert torch.equal(got, T.plain_rowshard_hop(A["sh:knows:out:indptr"], A["sh:knows:out:nbr"], f, S))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_mesh_queries_on_card_equal_cpu(card):
    """A 4-shard mesh on the card (captured replays) against the same mesh on
    the CPU and the single-device port: rows both ways, a 2-hop COUNT (the
    weight passes), variable depth, a NOT arm, an endpoint step, TRAVERSE
    and the row-sharded BFS."""
    from orientdb_tpu_torch.exec import tpu_engine as TE
    from orientdb_tpu_torch.parallel.sharded import ShardedCSR, bfs_reachability, make_mesh
    from orientdb_tpu_torch.storage.bigshape import build_person_knows

    twins = []
    for dev in (card, "cpu"):
        db, snap = build_person_knows(20_000, avg_knows=6, seed=13, device=dev)
        db.attach_snapshot(snap, mesh=make_mesh(4, device=dev))
        twins.append((db, snap))
    single, _ = build_person_knows(20_000, avg_knows=6, seed=13, device=card)
    qs = [
        ("MATCH {class:Person, as:p, where:(uid < :u)}-knows->{as:f} RETURN p.uid AS p, f.uid AS f", {"u": 300}),
        ("MATCH {class:Person, as:p, where:(uid < :u)}<-knows-{as:f} RETURN p.uid AS p, f.uid AS f", {"u": 300}),
        ("MATCH {class:Person, as:p, where:(age > 40)}-knows->{as:f}-knows->{as:g, where:(age < 30)} "
         "RETURN count(*) AS n", {}),
        ("MATCH {class:Person, as:p, where:(uid < 50)}-knows->{as:f, while:($depth < 3), where:(age < 30)} "
         "RETURN count(*) AS n", {}),
        ("MATCH {class:Person, as:p, where:(uid < :u)}-knows->{as:f}, NOT {as:f}-knows->{where:(age > 60)} "
         "RETURN p.uid AS p, f.uid AS f", {"u": 40}),
        ("MATCH {class:Person, as:p, where:(uid < :u)}.outE('knows'){as:e}.inV(){as:f} "
         "RETURN p.uid AS p, f.uid AS f", {"u": 40}),
        ("TRAVERSE out('knows') FROM (SELECT FROM Person WHERE uid < 20) WHILE $depth < 2 STRATEGY BREADTH_FIRST", {}),
    ]
    key = lambda r: tuple(sorted(map(str, r.items())))  # noqa: E731
    for sql, params in qs:
        for _ in range(3):
            got = sorted(twins[0][0].query(sql, params).to_dicts(), key=key)
            assert got == sorted(twins[1][0].query(sql, params).to_dicts(), key=key), sql
            assert got == sorted(single.query(sql, params).to_dicts(), key=key), sql
    plans = [p for v in TE._plan_cache(twins[0][1]).values() for p in v.plans]
    # every statement's plan captured and replayed (TRAVERSE's SELECT
    # subquery records only)
    assert all(p.graph is not None for p in plans)
    assert sum(p.replays > 0 for p in plans) == len(qs)
    roots = np.zeros((5, 20_000), bool)
    roots[np.arange(5), [0, 7, 19_999, 4_000, 12_345]] = True
    for reps in (1, 2):
        got = [
            bfs_reachability(ShardedCSR.from_snapshot(s, make_mesh(4, reps, device=db.device), "knows"), roots, 4)
            for db, s in twins
        ]
        assert (got[0] == got[1]).all() and got[0].sum() > 5
    torch.cuda.synchronize()


#: K5's lengths: one element, around the 16-byte vectors and a warp's run
#: (256 int32 / 512 bytes), a 16 KiB tile, and past K5b's one-block limit
K5_LENGTHS = [1, 15, 16, 17, 255, 257, 4_099, 16_384, 16_385, 1_000_003]


@pytest.mark.cuda
@pytest.mark.parametrize("n", K5_LENGTHS)
def test_take_pad_equals_plain_on_card(card, n):
    """K5a in all three dtypes, exactly, with -1 and past-the-end indices,
    index slices at offsets 0–3, and an empty table."""
    rng = np.random.default_rng(n + 101)
    idx_all = _t(rng.integers(-2, 5_003, n + 16, dtype=np.int32)).to(card)
    tables = (
        (_t(rng.integers(-(2**31), 2**31 - 1, 5_000, dtype=np.int32)).to(card), -1),
        (_t(rng.standard_normal(5_000).astype(np.float32)).to(card), 0.5),
        (_t(rng.random(5_000) < 0.5).to(card), True),
    )
    for vals, fill in tables:
        for io in range(4):
            idx = idx_all[io : io + n]
            assert torch.equal(T.take_pad(vals, idx, fill), T.plain_take_pad(vals, idx, fill))
        assert torch.equal(T.take_pad(vals[:0], idx_all, fill), T.plain_take_pad(vals[:0], idx_all, fill))
    torch.cuda.synchronize()


def _weight_operands(card, rng, vb: int, e: int, dtype):
    emit = _t(rng.integers(-1, vb + 3, e, dtype=np.int32)).to(card)
    eid = rng.permutation(e).astype(np.int32)
    eid[rng.random(e) < 0.05] = -1
    eid[rng.random(e) < 0.02] = e + 5
    w = rng.integers(0, 2**20, vb, dtype=np.int32) if dtype == torch.int32 else (rng.random(vb) * 1e4).astype(np.float32)
    return (
        emit,
        _t(rng.random(vb) < 0.4).to(card),  # ok: a [vb] vertex mask
        _t(rng.random(e) < 0.5).to(card),  # node_ok: a node mask at the endpoints
        _t(rng.random(e) < 0.7).to(card),  # emask
        _t(eid).to(card),
        _t(w).to(card),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32], ids=["i32", "f32"])
@pytest.mark.parametrize("walk", ["out", "in"])
@pytest.mark.parametrize("form", ["ok_vec", "node_ok"])
@pytest.mark.parametrize("vb,e", [(64, 1), (64, 700), (1 << 16, 1_000_003)])
def test_weight_gather_equals_plain_on_card(card, vb, e, form, walk, dtype):
    """The fused weight gather against its plain version (the parent's
    take_pad / & / .to / * chain), with and without the edge mask and the
    weights, on whole arrays and on slices one element off (the scalar
    form): int32 equal, float32 equal bit for bit (the weights finite and
    non-negative, as the pushdown's are)."""
    rng = np.random.default_rng(vb + e)
    emit, ok, node_ok, emask, eid, w = _weight_operands(card, rng, vb, e + 1, dtype)
    for off in (0, 1):
        sl = slice(off, off + e)
        for masked in (False, True):
            for weighted in (False, True):
                kw = dict(
                    ok=ok if form == "ok_vec" else None,
                    node_ok=node_ok[sl] if form == "node_ok" else None,
                    emask=(emask if walk == "in" else emask[sl]) if masked else None,
                    eid=eid[sl] if masked and walk == "in" else None,
                    w=w if weighted else None,
                )
                got = T.weight_gather(emit[sl], dtype, **kw)
                want = T.plain_weight_gather(emit[sl], dtype, **kw)
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (off, masked, weighted)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32], ids=["i32", "f32"])
@pytest.mark.parametrize("vb", [1, 64, 4_099, 1 << 20])
def test_folded_weights_equal_plain_on_card(card, vb, dtype):
    """The fold of a vertex mask into the weights (``emit=None``) against
    its plain version on whole and one-off tables, then an in walk's gather
    of the folded weights (a fifth of them 0) against the unfolded chain,
    bit for bit."""
    rng = np.random.default_rng(vb + 9)
    e = 3 * vb + 5
    emit, ok, _node_ok, emask, eid, w = _weight_operands(card, rng, vb + 1, e, dtype)
    w[torch.from_numpy(rng.random(vb + 1) < 0.2).to(card)] = 0
    for off in (0, 1):
        okv, wv = ok[off : off + vb], w[off : off + vb]
        folded = T.weight_gather(None, dtype, ok=okv, w=wv)
        want = T.plain_weight_gather(None, dtype, ok=okv, w=wv)
        assert torch.equal(folded.view(torch.int32), want.view(torch.int32)), off
        got = T.weight_gather(emit, dtype, emask=emask, eid=eid, w=folded)
        chain = T.plain_weight_gather(emit, dtype, ok=okv, emask=emask, eid=eid, w=wv)
        assert torch.equal(got.view(torch.int32), chain.view(torch.int32)), off
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0] + K5_LENGTHS + [(1 << 23) + 5])
def test_mask_count_equals_plain_on_card(card, n):
    """K5b at every offset 0–15 of its start (one block up to 16 KiB, a
    one-wave grid past it), dense and sparse, and any non-zero byte
    counting once, exactly and the same on every call."""
    rng = np.random.default_rng(n + 3)
    for density in (0.3, 1.0):
        mask = _t(rng.random(n + 16) < density).to(card)
        for off in range(16):
            m = mask[off : off + n]
            got = T.mask_count(m)
            assert got.dtype == torch.int32 and got.shape == ()
            assert int(got) == int(T.plain_mask_count(m)) == int(T.mask_count(m))
    raw = rng.integers(0, 256, n + 16, dtype=np.uint8)
    bytes_ = _t(raw).to(card).view(torch.bool)
    assert int(T.mask_count(bytes_[3 : 3 + n])) == int(np.count_nonzero(raw[3 : 3 + n]))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_captured_k5_equals_eager_on_card(card):
    """take_pad, the fused weight gather (unfolded, and after a fold of the
    vertex mask into the weights) and mask_count (small and large) captured
    once and replayed on other inputs in place equal eager calls."""
    rng = np.random.default_rng(77)
    vb, e = 1 << 16, 300_001
    emit, ok, _node_ok, emask, eid, w = _weight_operands(card, rng, vb, e, torch.int32)
    small = _t(rng.random(4_000) < 0.5).to(card)
    large = _t(rng.random(1 << 20) < 0.5).to(card)
    static_emit, static_small, static_large = emit.clone(), small.clone(), large.clone()

    def run():
        return (
            T.take_pad(w, static_emit, -1),
            T.weight_gather(static_emit, torch.int32, ok=ok, emask=emask, eid=eid, w=w),
            T.weight_gather(static_emit, torch.int32, emask=emask, eid=eid,
                            w=T.weight_gather(None, torch.int32, ok=ok, w=w)),
            T.mask_count(static_small),
            T.mask_count(static_large),
        )

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for k in range(3):
        static_emit.copy_(emit.roll(k * 7))
        static_small.copy_(small.roll(k * 5))
        static_large.copy_(large.roll(k * 11))
        if k == 2:
            static_small.zero_()
        for o in outs:
            o.fill_(-7)
        graph.replay()
        for got, want in zip(outs, run()):
            assert torch.equal(got, want)
    torch.cuda.synchronize()


def _slab_window(rng, kind: str):
    """A used slab window and its rows' sources: random endpoints (some
    -1) with a fifth of the slots tombstoned, -1 rows among the sources,
    and per kind: W and R off the sort's 2,048-slot tile ("ragged"), one
    source on many rows ("repeated"), one source owning 4,096 window slots
    ("hot"), keys that move every radix digit ("wide"), an empty window."""
    w, r, v = {"random": (5_000, 300, 2_000), "ragged": (2_049 * 3 + 5, 2_051, 700),
               "repeated": (3_000, 640, 400), "hot": (12_000, 257, 3_000),
               "wide": (6_000, 500, 1 << 31), "empty": (0, 100, 50)}[kind]
    if kind == "wide":  # endpoints spread over every radix digit, sources drawn from them
        a = rng.integers(0, v - 1, w, dtype=np.int64).astype(np.int32)
    else:
        a = rng.integers(-1, v, w).astype(np.int32)
    e = rng.integers(0, 1 << 20, w).astype(np.int32)
    live = rng.random(w) >= 0.2
    pool = a[a >= 0] if kind == "wide" and w else np.arange(v, dtype=np.int32)
    srcs = rng.choice(pool, r).astype(np.int32)
    srcs[::7] = -1
    if kind == "repeated":
        srcs[rng.random(r) < 0.6] = 11
    if kind == "hot":
        a[rng.choice(w, 4_096, replace=False)] = 5
        live[a == 5] = True
        srcs[[0, 1, r // 2, r - 1]] = 5
    return a, e, live, srcs


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ragged", "repeated", "hot", "wide", "empty"])
def test_slab_scan_window_join_equals_plain_on_card(card, kind):
    """K17, the window join, against `plain_slab_scan` (the reference's [R, W]
    mask): row-major order, -1 padding, tombstones and -1 sources matching
    nothing, under skew, with a capacity that holds the total and one that
    cuts it; then captured at a fixed W and capacity and replayed over other
    liveness and sources onto poisoned outputs."""
    rng = np.random.default_rng(len(kind) * 101)
    a, e, live, srcs = _slab_window(rng, kind)
    g = [_t(x).to(card) for x in (a, e, live, srcs)]
    base = 70_000
    want_total = int(T.plain_slab_scan(*g, base, lambda t: 8)[3])
    for cap in (max(T.bucket(want_total), 8), max(want_total // 3, 1)):
        got = T.slab_scan(*g, base, lambda t, cap=cap: cap)
        want = T.plain_slab_scan(*g, base, lambda t, cap=cap: cap)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert int(got[3]) == want_total
    live2 = _t(rng.random(a.shape[0]) >= 0.5).to(card)
    srcs2 = g[3].roll(3)
    static_live, static_srcs = g[2].clone(), g[3].clone()
    cap = max(T.bucket(want_total), 8)
    run = lambda: T.slab_scan(g[0], g[1], static_live, static_srcs, base, lambda t: cap)  # noqa: E731
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for lv, s in ((live2, srcs2), (g[2], g[3])):
        static_live.copy_(lv)
        static_srcs.copy_(s)
        for o in outs:
            o.fill_(-7)
        graph.replay()
        for x, y in zip(outs, T.plain_slab_scan(g[0], g[1], lv, s, base, lambda t: cap)):
            assert torch.equal(x, y)
    torch.cuda.synchronize()


def _rowshard_case(rng, S: int, R: int, avg: float):
    """A row-sharded out-CSR of S shards of R rows (rebased indptr, -1
    padded dst with dead tails past indptr[R]), targets in [-1, S R + 3]
    (-1 edges dead, the few past S R - 1 clipped)."""
    ind, dst = [], []
    for _ in range(S):
        deg = rng.poisson(avg, R)
        ip = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
        d = rng.integers(-1, S * R + 4, int(ip[-1])).astype(np.int32)
        ind.append(ip)
        dst.append(d)
    emax = max(max(d.shape[0] for d in dst) + 5, 1)
    dst_sh = np.full((S, emax), -1, np.int32)
    for s, d in enumerate(dst):
        dst_sh[s, : d.shape[0]] = d
        dst_sh[s, d.shape[0] :] = rng.integers(0, S * R, emax - d.shape[0])  # dead: past indptr[R]
    return np.stack(ind), dst_sh


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 4, 33])
@pytest.mark.parametrize("R", [1, 15, 17, 129, 512, 1_040])
def test_rowshard_hop_equals_plain_on_card(card, R, Q):
    """K24, the coalesced push, against `plain_rowshard_hop` (the reference's
    searchsorted walk): rows that are and are not multiples of the 16-byte
    loads, a run crossing a shard's end, Q over a 32-query word, -1 and
    past-indptr[R] edges, clipped targets; sparse, empty and dense
    frontiers, into a fresh and a reused output."""
    rng = np.random.default_rng(R * 7 + Q)
    S = 3
    ind, dst = (_t(x).to(card) for x in _rowshard_case(rng, S, R, 3.0))
    sparse = rng.random((S, Q, R)) < 0.05
    sparse[1, Q - 1, R - 1] = True
    for fr in (sparse, np.zeros((S, Q, R), bool), np.ones((S, Q, R), bool)):
        f = _t(fr).to(card)
        want = T.plain_rowshard_hop(ind, dst, f, S)
        assert torch.equal(T.rowshard_hop(ind, dst, f, S), want)
        out = torch.ones((S, Q, R), dtype=torch.bool, device=card)
        assert torch.equal(T.rowshard_hop(ind, dst, f, S, out=out), want)
        for s in range(S):  # one rank's shard of a process group
            one = T.rowshard_hop(ind[s : s + 1], dst[s : s + 1], f[s : s + 1], S)
            assert torch.equal(one, T.plain_rowshard_hop(ind[s : s + 1], dst[s : s + 1], f[s : s + 1], S))
    torch.cuda.synchronize()


#: (base vertices, slab vertices, avg degree, slab slots, slab edges, NB):
#: `tests/test_torch_slab_hop.py`'s, and one with 2^18 buckets over 200,000
#: vertices and 60,000 slab edges
PROBE_CASES = [
    (5_000, 64, 3.0, 2_048, 1_500, 256),
    (40, 8, 1.5, 64, 40, 256),
    (200_000, 4_096, 8.0, 131_072, 60_000, 1 << 18),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d", ["out", "in"])
@pytest.mark.parametrize("v,slab_v,avg,spare,used,nb", PROBE_CASES)
def test_probe_hop_equals_plain_on_card(card, d, v, slab_v, avg, spare, used, nb):
    """K10's push with the slab probe (`bitmap_hop_probe`) against its
    plain version (the CSR push's ORed with `plain_bucket_hop`), exactly:
    collisions, a bucket filled to BK, a slab vertex of base degree 0, base
    and slab tombstones, an edge WHERE, a gate, C 1, 3 and 33, sparse,
    empty and dense frontiers, ``alive`` 0, ``out`` accumulation, and in a
    captured graph replayed over other frontiers and a patched table."""
    rng = np.random.default_rng(v + used + (d == "in"))
    g = armed_graph(rng, v, slab_v, avg, spare, used, nb)
    vb = T.bucket(g["v"])
    where = rng.random(g["live"].shape[0]) < 0.7
    zero = torch.zeros((), dtype=torch.int32, device=card)
    for m in (g["live"], g["live"] & where):
        csr, probe, em = probe_hop_args(g, d, m, card)
        for c in (1, 3, 33):
            gate = _t(rng.random(vb) < 0.8).to(card)
            for fr in frontiers(rng, c, vb, card):
                fr[:, v] = True  # the slab vertex whose out bucket is full
                for gt in (None, gate):
                    got = T.bitmap_hop_csr(*csr, em, fr, gt, probe=probe)
                    want = T.plain_bitmap_hop_csr(*csr, em, fr, gt) | T.plain_bucket_hop(probe, em, fr, gt)
                    assert torch.equal(got, want), (c, gt is None)
                acc = torch.zeros_like(fr)
                acc[:, -1] = True
                T.bitmap_hop_csr(*csr, em, fr, gate, None, acc, probe)
                want = T.plain_bitmap_hop_csr(*csr, em, fr, gate) | T.plain_bucket_hop(probe, em, fr, gate)
                assert torch.equal(acc, want | (torch.arange(vb, device=card) == vb - 1)[None, :])
                assert not T.bitmap_hop_csr(*csr, em, fr, gate, zero, probe=probe).any()
    csr, probe, em = probe_hop_args(g, d, g["live"], card)
    fr = frontiers(rng, 8, vb, card)[0]
    static = fr.clone()
    alive = torch.zeros((), dtype=torch.int32, device=card)
    run = lambda: T.bitmap_hop_csr(*csr, em, static, None, alive, probe=probe)  # noqa: E731
    alive.fill_(1)
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    tab = probe.tab
    for i in range(3):
        f = frontiers(rng, 8, vb, card)[0] if i else fr
        if i == 2:  # an entry patched in place, as K16 does: the replay reads it
            free = torch.nonzero(tab < 0).view(-1)[:1]
            tab[free] = 0
        static.copy_(f)
        out.fill_(True)
        graph.replay()
        assert torch.equal(out, T.plain_bitmap_hop_csr(*csr, em, f, None, alive) | T.plain_bucket_hop(probe, em, f))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("d", ["out", "in"])
@pytest.mark.parametrize(
    "v,avg,block_edges,pages,hub,empty", EXPAND_CASES + [(100_000, 8.0, 4_096, 60, 50_000, slice(0, 20_000))]
)
def test_paged_expand_equals_plain_on_card(card, d, v, avg, block_edges, pages, hub, empty):
    """K21, K2b's merge path over the page indirection, against its plain
    version, exactly: a hub row across many 2,048-item tiles, zero-degree,
    -1 and repeated sources, resident, free and evicted pages, every page
    evicted, an empty pool, an output shorter than the total; the caller's
    flag byte only set, never cleared."""
    rng = np.random.default_rng(v + hub + (d == "in"))
    indptr, part, pools, pageof = paged_pool(rng, v, avg, block_edges, pages, hub, empty)
    ip, bv, es = (_t(a).to(card) for a in (indptr, part.block_of_v, part.edge_start))
    no_pool = {n: np.zeros((0, part.Wp), np.int32) for n in pools}
    evicted = np.full_like(pageof, -1)
    for pl, pgn in ((pools, pageof), (pools, evicted), (no_pool, evicted)):
        pg = _t(pgn).to(card)
        nbr, eid = (_t(pl[n]).to(card) for n in ("nbr", "eid"))
        hot = np.nonzero(pgn[part.block_of_v] >= 0)[0]
        for width, among in ((1, None), (255, None), (4_097, None), (64, hot if hot.size else None)):
            srcs, offsets, total = expand_sources(rng, indptr, width, among)
            s_t, o_t = _t(srcs).to(card), _t(offsets).to(card)
            tot = torch.tensor(total, dtype=torch.int32, device=card)
            for out_size in {T.bucket(max(total, 1)), max(8, T.bucket(max(total, 1)) // 4)}:
                args = (ip, s_t, o_t, tot, out_size, bv, pg, es, nbr, None if d == "out" else eid, d == "out")
                want = T.plain_paged_expand(*args)
                got = T.paged_expand(*args)
                for a, b in zip(got, want):
                    assert torch.equal(a, b)
                flag = torch.ones((), dtype=torch.bool, device=card)
                assert bool(T.paged_expand(*args, flag=flag)[3])
                flag.zero_()
                got = T.paged_expand(*args, flag=flag)
                assert got[3] is flag and bool(flag) == bool(want[3])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_captured_paged_reads_share_one_miss_byte_on_card(card):
    """A tiered replay's reads in one captured graph: the miss byte zeroed
    once, K19's push and K21's gather storing into it; replayed over
    sources inside and outside the resident blocks, the byte equals the OR
    of the plain versions' flags and the outputs equal theirs."""
    rng = np.random.default_rng(21)
    indptr, part, pools, pageof = paged_pool(rng, 20_000, 6.0, 1_024, 12, 3_000)
    push, _slot = paged_args(indptr, part, pools, pageof, card)
    ip, bv, pg, es = push[:4]
    vb = T.bucket(20_000)
    hot = np.nonzero(pageof[part.block_of_v] >= 0)[0]
    cases = [expand_sources(rng, indptr, 512, hot), expand_sources(rng, indptr, 512)]
    width = max(c[0].shape[0] for c in cases)
    s_t = torch.full((width,), -1, dtype=torch.int32, device=card)
    o_t = torch.zeros(width, dtype=torch.int32, device=card)
    tot = torch.zeros((), dtype=torch.int32, device=card)
    out_size = T.bucket(max(c[2] for c in cases))
    fr = torch.zeros((2, vb), dtype=torch.bool, device=card)
    fr_cases = [torch.zeros_like(fr), torch.zeros_like(fr)]
    fr_cases[0][:, hot[:20]] = True
    fr_cases[1][:, rng.integers(0, 20_000, 40)] = True

    def run():
        miss = torch.zeros((), dtype=torch.bool, device=card)
        hop = T.paged_hop_csr(*push, None, fr, None, None, None, miss)
        row, eid, nbr, _ = T.paged_expand(ip, s_t, o_t, tot, out_size, bv, pg, es, push[4], push[5], False, miss)
        return hop, row, eid, nbr, miss

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for (srcs, offsets, total), f in zip(cases, fr_cases):
        s_t.copy_(_t(srcs).to(card))
        o_t.copy_(_t(offsets).to(card))
        tot.fill_(total)
        fr.copy_(f)
        for o in outs[:4]:
            o.fill_(-7 if o.dtype == torch.int32 else True)
        outs[4].fill_(True)
        graph.replay()
        hop_miss = torch.zeros((), dtype=torch.bool, device=card)
        want_hop = T.plain_paged_hop_csr(*push, None, f, miss=hop_miss)
        want = T.plain_paged_expand(ip, s_t, o_t, tot, out_size, bv, pg, es, push[4], push[5], False)
        assert torch.equal(outs[0], want_hop)
        for a, b in zip(outs[1:4], want[:3]):
            assert torch.equal(a, b)
        assert bool(outs[4]) == bool(hop_miss | want[3])
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the lane forms (a count group's lane axis): K15, K5a, K4 and K5b
# ---------------------------------------------------------------------------


def _lane_stack(rows, card):
    return _t(np.stack(rows)).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 16, 64])
@pytest.mark.parametrize("walk", ["out", "in", "fold"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["i32", "f32"])
def test_weight_gather_lanes_equal_plain_on_card(card, dtype, walk, B):
    """K5a's lane form against its plain version and, lane by lane,
    against the single-lane kernel, bit for bit: each of ok, node_ok,
    emask and w lane-stacked in turn and all together, the rest shared, on
    an out walk (direct edge mask), an in walk (the mask through eid, -1
    and past-end ids) and the fold (no emit); an edge count off 16 bytes,
    a lane of zeros."""
    rng = np.random.default_rng(B * 13 + len(walk))
    vb, e = 8192, 300_001
    tdtype = torch.int32 if dtype == np.int32 else torch.float32

    def weights(n):
        return rng.integers(0, 2**20, n, dtype=np.int32) if dtype == np.int32 else (rng.random(n) * 100).astype(np.float32)

    emit = _t(rng.integers(-1, vb + 3, e, dtype=np.int32)).to(card)
    eid_np = rng.permutation(e).astype(np.int32)
    eid_np[rng.random(e) < 0.05] = -1
    eid_np[rng.random(e) < 0.02] = e + 5
    eid = _t(eid_np).to(card)
    m = vb if walk == "fold" else e
    shared = {
        "ok": _t(rng.random(vb) < 0.4).to(card),
        "node_ok": _t(rng.random(m) < 0.5).to(card),
        "emask": _t(rng.random(e) < 0.7).to(card),
        "w": _t(weights(vb)).to(card),
    }
    lanes = {
        "ok": _lane_stack([rng.random(vb) < 0.4 for _ in range(B)], card),
        "node_ok": _lane_stack([rng.random(m) < 0.5 for _ in range(B)], card),
        "emask": _lane_stack([rng.random(e) < 0.7 for _ in range(B)], card),
        "w": _lane_stack([weights(vb) for _ in range(B)], card),
    }
    for t in lanes.values():
        t[0].zero_()
    names = ("ok", "w") if walk == "fold" else ("ok", "node_ok", "emask", "w")
    for stacked in [(n,) for n in names] + [names]:
        kw = {n: (lanes[n] if n in stacked else shared[n]) for n in names}
        if walk == "fold":
            args = (None, tdtype)
        else:
            args = (emit, tdtype)
            if walk == "in":
                kw["eid"] = eid
        got = T.weight_gather(*args, **kw)
        assert got.shape == (B, m)
        want = T.plain_weight_gather_lanes(*args, **kw)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), stacked
        for b in range(B):
            one = {k: (v[b] if v.dim() == 2 else v) for k, v in kw.items()}
            assert torch.equal(got[b].view(torch.int32), T.weight_gather(*args, **one).view(torch.int32))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("kind,v", SEGMENT_CASES)
def test_segment_sum_lanes_equal_plain_on_card(card, kind, v, B):
    """K4's lane form: int32 exactly against its plain version (wrapping
    sums), float32 bit for bit against the single-lane kernel lane by lane
    (and to rtol 1e-6 against the plain version), padded and cut, and
    equal from call to call; a lane of zeros."""
    rng = np.random.default_rng(v + B)
    indptr = _t(_segment_indptr(rng, kind, v)).to(card)
    ne = int(indptr[-1])
    vals_i = _lane_stack([rng.integers(-(2**31), 2**31 - 1, ne, dtype=np.int32) for _ in range(B)], card)
    vals_f = _lane_stack([rng.random(ne, dtype=np.float32) for _ in range(B)], card)
    vals_i[0].zero_()
    nseg = indptr.shape[0] - 1
    for out_size in (T.bucket(max(nseg, 1)) + 3, max(nseg // 2, 1)):
        got = T.indptr_segment_sum(vals_i, indptr, out_size)
        assert torch.equal(got, T.plain_indptr_segment_sum_lanes(vals_i, indptr, out_size))
        assert not got[0].any()
        first = T.indptr_segment_sum(vals_f, indptr, out_size)
        again = T.indptr_segment_sum(vals_f, indptr, out_size)
        assert torch.equal(first.view(torch.int32), again.view(torch.int32))
        for b in range(B):
            one = T.indptr_segment_sum(vals_f[b], indptr, out_size)
            assert torch.equal(first[b].view(torch.int32), one.view(torch.int32))
            _same_f32(first[b], T.plain_indptr_segment_sum(vals_f[b], indptr, out_size))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 16, 64])
@pytest.mark.parametrize("n", [0, 5, 16_384, 16_385, 1_000_003])
def test_mask_count_lanes_equal_plain_on_card(card, n, B):
    """K5b's lane form: [B, n] masks (rows off 16 bytes where n is odd, an
    all-False and an all-True lane, one block a row up to 16 KiB, else the
    one-wave grid) against its plain version and the single-lane kernel."""
    rng = np.random.default_rng(n + B)
    mask = _lane_stack([rng.random(n) < 0.3 for _ in range(B)], card)
    mask[0].zero_()
    mask[-1].fill_(True)
    got = T.mask_count(mask)
    assert got.dtype == torch.int32 and torch.equal(got, T.plain_mask_count_lanes(mask))
    for b in range(B):
        assert int(got[b]) == int(T.mask_count(mask[b]))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 5, 64])
@pytest.mark.parametrize("n", [1, 257, 70_001])
def test_predicate_eval_lanes_equal_plain_on_card(card, n, lanes):
    """K15's lane form on `chip_smoke.K15_LANE_WHERES` (ids and identity
    mode, binding rows): row b equals the single-lane kernel exactly, and
    the plain version outside distance()'s boundary band."""
    import chip_smoke

    _band, checked = chip_smoke.check_predicate_lanes(np, torch, T, n, lanes, seed=n)
    torch.cuda.synchronize()
    assert checked == 2 * len(chip_smoke.K15_LANE_WHERES)


@pytest.mark.cuda
def test_captured_lane_groups_equal_cpu(card):
    """Count groups on the lane axis captured on the card (a lane-varying
    root counted by K5b's lane form, and the two-hop COUNT through the lane
    forms of K15, K5a and K4) against the same batches on the CPU."""
    from orientdb_tpu_torch.exec import tpu_engine as TE
    from orientdb_tpu_torch.storage.bigshape import build_person_knows

    two_hop = ("MATCH {class:Person, as:p, where:(age > :a)}-knows->{as:f}"
               "-knows->{as:g, where:(age < :b)} RETURN count(*) AS n")
    geo = "MATCH {class:Person, as:p, where:(distance(lat, lng, :x, :y) < :r)} RETURN count(*) AS n"
    batches = [
        ([two_hop] * 16, [{"a": 30 + 2 * i, "b": 20 + 2 * i} for i in range(16)]),
        ([geo] * 16, [{"x": 48.0, "y": 2.0, "r": 8000.0 - 400.0 * i} for i in range(16)]),
    ]
    kw = dict(avg_knows=6, seed=11, geo=True)
    gpu, gsnap = build_person_knows(5_000, device=card, **kw)
    cpu, _ = build_person_knows(5_000, device="cpu", **kw)
    for sqls, plist in batches:
        gpu.query(sqls[0], plist[0])
        cpu.query(sqls[0], plist[0])
        for _ in range(2):
            got = [rs.to_dicts() for rs in gpu.query_batch(sqls, plist)]
            want = [rs.to_dicts() for rs in cpu.query_batch(sqls, plist)]
            assert got == want
    plans = [p for v in TE._plan_cache(gsnap).values() for p in v.plans if p.group_replays]
    assert plans and all(p.lane_axis for p in plans)
    assert all(g.graph is not None and g.nodes > 0 for p in plans for g in p.groups.values())
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the lane forms of a rows group: K1, K3, K2, K2b, K5's lane stride, K6, K7
# ---------------------------------------------------------------------------


def _rows_lane_operands(rng, B: int, k: int, v: int = 3_000):
    """B lanes of k sources over one Poisson CSR (lane 0 empty, the last
    lane repeating the one before it: a padding lane), and an edge map."""
    indptr, nbrs = _csr(rng, v, 6.0, tail_zero=5)
    rows = [rng.integers(-1, v, k, dtype=np.int32) for _ in range(B)]
    rows[0][:] = -1
    if B > 1:
        rows[-1] = rows[-2].copy()
    emap = rng.permutation(nbrs.shape[0]).astype(np.int32)
    return indptr, nbrs, np.stack(rows), emap


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 16, 64])
@pytest.mark.parametrize("n", [0, 1, 4_097, 16_384, 16_385, 1_000_003])
def test_scan_and_compact_lanes_equal_plain_on_card(card, n, B):
    """K1's and K3's lane forms: [B, n] values and masks (rows off 16 bytes
    where n is odd; an all-False lane, an all-True lane, a padding lane),
    compacted into a cap under, at and over a lane's count, against their
    plain versions and, lane by lane, the single-lane wrappers (the same
    kernel at one lane: a check of the lane offsets only)."""
    rng = np.random.default_rng(n * 7 + B)
    vals = _lane_stack([rng.integers(0, 2, n, dtype=np.int32) for _ in range(B)], card)
    got = T.value_cumsum(vals)
    assert torch.equal(got, T.plain_value_cumsum_lanes(vals))
    for b in range(B):
        assert torch.equal(got[b], T.value_cumsum(vals[b].contiguous()))
    rows = [rng.random(n) < 0.3 for _ in range(B)]
    if B > 1:
        rows[0][:] = False
        rows[1][:] = True
        rows[-1] = rows[-2]
    mask = _lane_stack(rows, card)
    for cap in (8, T.bucket(max(n // 3, 1)), T.bucket(max(n, 1))):
        got = T.compact_indices(mask, cap)
        assert got.shape == (B, cap) and torch.equal(got, T.plain_compact_indices_lanes(mask, cap))
        for b in range(B):
            assert torch.equal(got[b], T.compact_indices(mask[b].contiguous(), cap))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 16, 64])
@pytest.mark.parametrize("k", [1, 2_047, 2_048, 20_001, 65_536])
@pytest.mark.parametrize("walk", ["out", "in"])
def test_expand_lanes_equal_plain_on_card(card, walk, k, B):
    """K2's and K2b's lane forms: B lanes of k sources (-1 padding, an
    empty lane, a padding lane) sized and gathered, into a bucket that
    holds the largest lane and into one that cuts it (a lane over its cap
    fills its row and writes nothing past it), with and without an in
    walk's edge map, against their plain versions and, lane by lane, the
    single-lane wrappers (the same kernel at one lane: a check of the lane
    offsets only)."""
    rng = np.random.default_rng(k + 13 * B)
    indptr, nbrs, srcs, emap = _rows_lane_operands(rng, B, k)
    indptr, nbrs, srcs = _t(indptr).to(card), _t(nbrs).to(card), _t(srcs).to(card)
    emap = _t(emap).to(card) if walk == "in" else None
    offsets, total = T.expand_offsets(indptr, srcs)
    p_off, p_tot = T.plain_expand_offsets_lanes(indptr, srcs)
    assert torch.equal(offsets, p_off) and torch.equal(total, p_tot)
    for b in range(B):
        o1, t1 = T.expand_offsets(indptr, srcs[b].contiguous())
        assert torch.equal(offsets[b], o1) and int(total[b]) == int(t1)
    most = int(total.max())
    for size in (T.bucket(max(most, 1)), max(4, T.bucket(max(most, 1)) // 4)):
        got = T.gather_expand(indptr, nbrs, srcs, offsets, total, size, emap)
        want = T.plain_gather_expand_lanes(indptr, nbrs, srcs, offsets, total, size, emap)
        for g, w in zip(got, want):
            assert g.shape == (B, size) and torch.equal(g, w)
        for b in range(B):
            one = T.gather_expand(indptr, nbrs, srcs[b].contiguous(), offsets[b].contiguous(), total[b], size, emap)
            for g, w in zip(got, one):
                assert torch.equal(g[b], w)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 16, 64])
@pytest.mark.parametrize("m", [1, 5, 4_096, 131_075])
@pytest.mark.parametrize("dtype", ["i32", "f32", "b8"])
def test_take_pad_lane_stride_equals_plain_on_card(card, dtype, m, B):
    """K5's lane stride: [B, m] lane-local rows (-1 padding, indices past a
    lane's end, an m that is not a multiple of 4 so the 16-byte path's
    units straddle lanes) read from a [B, n] table, and from a shared table
    through the flattened index, against the plain versions and the
    single-lane kernel lane by lane."""
    rng = np.random.default_rng(m + B)
    n = 1_000
    if dtype == "i32":
        vals, fill = _t(rng.integers(-(2**31), 2**31 - 1, (B, n), dtype=np.int64).astype(np.int32)), -1
    elif dtype == "f32":
        vals, fill = _t(rng.random((B, n), dtype=np.float32)), 0.0
    else:
        vals, fill = _t(rng.random((B, n)) < 0.5), False
    vals = vals.to(card)
    idx = _t(rng.integers(-2, n + 3, (B, m), dtype=np.int32)).to(card)
    got = T.take_pad(vals, idx, fill)
    assert got.shape == (B, m) and torch.equal(got, T.plain_take_pad_lanes(vals, idx, fill))
    shared = T.take_pad(vals[0].contiguous(), idx, fill)
    assert torch.equal(shared, T.plain_take_pad(vals[0], idx.view(-1), fill).view(B, m))
    for b in range(B):
        assert torch.equal(got[b], T.take_pad(vals[b].contiguous(), idx[b].contiguous(), fill))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 16, 64])
@pytest.mark.parametrize("w", [1, 1_024, 131_072])
@pytest.mark.parametrize("c", [1, 3, 17])
@pytest.mark.parametrize("direct", [False, True])
def test_front_pack_and_meta_lanes_equal_plain_on_card(card, direct, c, w, B):
    """K6's and K7's lane forms: B lanes of [w] valid masks and c columns
    (an empty lane, a full lane, values past int16 in one lane only, more
    columns than one launch moves) packed into a [B, w, c] stack, or into
    a direct-fetch stack's rows (lanes at a stride of w·c + 3 with the meta
    row behind each), against their plain versions and, lane by lane, the
    single-lane wrappers (the same kernel at one lane: a check of the lane
    offsets only)."""
    rng = np.random.default_rng(w + c + B + direct)
    valid = [(rng.random(w) < 0.4).astype(np.int32) for _ in range(B)]
    valid[0][:] = 0
    if B > 1:
        valid[1][:] = 1
    cols = [rng.integers(-30_000, 30_000, (B, w), dtype=np.int32) for _ in range(c)]
    if B > 2:
        cols[0][2, w // 2] = 40_000
    valid_d = _lane_stack(valid, card)
    cols_d = [_t(x).to(card) for x in cols]
    count = valid_d.sum(dim=1, dtype=torch.int32)
    flag = _t(rng.integers(0, 2, B, dtype=np.int32)).to(card)
    if direct:
        buf = torch.full((B, w * c + 3), 7, dtype=torch.int32, device=card)
        data = T.front_pack(valid_d, cols_d, out=buf[:, : w * c].view(B, w, c))
        meta = T.replay_meta(data, count, flag, out=buf[:, w * c :])
    else:
        data = T.front_pack(valid_d, cols_d)
        meta = T.replay_meta(data, count, flag)
    want = T.plain_front_pack_lanes(valid_d, cols_d)
    assert torch.equal(data, want)
    assert torch.equal(meta, T.plain_replay_meta_lanes(want, count, flag))
    for b in range(B):
        one = T.front_pack(valid_d[b].contiguous(), [x[b].contiguous() for x in cols_d])
        assert torch.equal(data[b], one)
        assert torch.equal(meta[b], T.replay_meta(one, count[b], flag[b]))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_captured_rows_lane_groups_equal_cpu(card):
    """Rows groups on the lane axis captured on the card (BQ3's two-hop
    rows, a direct-fetch one-hop and its in walk, a LIMIT group, one lane
    overflowing into a new variant) against the same batches on the CPU,
    and each group's captured launches through the rows lane forms."""
    from orientdb_tpu_torch.exec import tpu_engine as TE
    from orientdb_tpu_torch.storage.bigshape import build_person_knows

    rows = ("MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f}"
            "-knows->{as:g, where:(age < 30)} RETURN p.uid AS p, f.uid AS f, g.uid AS g")
    small = "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f} RETURN p.uid AS p, f.uid AS f"
    walk_in = "MATCH {class:Person, as:p, where:(uid < :k)}<-knows-{as:f} RETURN p.uid AS p, f.uid AS f"
    limit = ("MATCH {class:Person, as:p, where:(age > :a)}-knows->{as:f} "
             "RETURN p.uid AS p, f.uid AS f LIMIT 5")
    batches = [
        ([rows] * 16, [{"k": 400 - 20 * i} for i in range(16)]),
        ([rows] * 16, [{"k": 400 - 20 * i} for i in range(15)] + [{"k": 3_000}]),
        ([small] * 8, [{"k": 10 + 5 * i} for i in range(8)]),
        ([walk_in] * 8, [{"k": 10 + 5 * i} for i in range(8)]),
        ([limit] * 8, [{"a": 40 + 5 * i} for i in range(8)]),
    ]
    kw = dict(avg_knows=6, seed=11)
    gpu, gsnap = build_person_knows(5_000, device=card, **kw)
    cpu, _ = build_person_knows(5_000, device="cpu", **kw)
    key = lambda r: tuple(sorted(r.items()))  # noqa: E731
    for sqls, plist in batches:
        gpu.query(sqls[0], plist[0])
        cpu.query(sqls[0], plist[0])
        for _ in range(2):
            got = [sorted(rs.to_dicts(), key=key) for rs in gpu.query_batch(sqls, plist)]
            want = [sorted(rs.to_dicts(), key=key) for rs in cpu.query_batch(sqls, plist)]
            assert got == want
    plans = [p for v in TE._plan_cache(gsnap).values() for p in v.plans if p.group_replays]
    assert plans and all(p.lane_axis for p in plans)
    assert any(p.direct_fetch for p in plans) and any(p._rows_grouped() for p in plans)
    for p in plans:
        for g in p.groups.values():
            assert g.graph is not None and g.nodes > 0
            assert g.launches.get("compact_indices_lanes", 0) > 0
            assert g.launches.get("front_pack_lanes", 0) > 0 and g.launches.get("replay_meta_lanes", 0) == 1
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# past the root: K15's stacked form and K13's lane form
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 5, 64])
@pytest.mark.parametrize("n", [1, 257, 70_001])
def test_predicate_eval_stacked_equals_plain_on_card(card, n, lanes):
    """K15's stacked form on `chip_smoke.K15_LANE_WHERES` and the split
    `K15_STACKED_LONG` (lane-stacked ids, identity slots, lane-stacked
    binding rows and split values): every launch's lane b equals the single
    kernel exactly, and the plain version outside distance()'s band."""
    import chip_smoke

    _band, checked = chip_smoke.check_predicate_stacked(np, torch, T, n, lanes, seed=n)
    torch.cuda.synchronize()
    assert checked > 2 * len(chip_smoke.K15_LANE_WHERES)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 16, 64])
@pytest.mark.parametrize("w,n", [(0, 1), (1, 7), (255, 1024), (257, 7), (1 << 18, 50_000)])
def test_rows_with_matches_lanes_equal_plain_on_card(card, w, n, B):
    """K13's lane form: ascending lane-local rows as an expansion emits them,
    shuffled rows, ids past the end, an all-padding lane and the
    accumulating form, against its plain version and, lane by lane, the
    single kernel, exactly."""
    rng = np.random.default_rng(w + n + B)
    asc = np.sort(rng.integers(-1, n + 2, (B, w)), axis=1).astype(np.int32)
    asc[0] = -1
    for rows in (asc, rng.permuted(asc, axis=1)):
        r = _t(rows).to(card)
        m = _t(rng.random((B, w)) < 0.5).to(card)
        want = T.plain_rows_with_matches_lanes(r, m, n)
        got = T.rows_with_matches(r, m, n)
        assert got.shape == (B, n) and torch.equal(got, want)
        for b in range(B):
            assert torch.equal(got[b], T.rows_with_matches(r[b].contiguous(), m[b].contiguous(), n))
        acc = torch.full((B, n), 3, dtype=torch.int32, device=card)
        assert torch.equal(T.rows_with_matches(r, m, n, out=acc), want + 3)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_captured_stacked_forms_equal_eager_on_card(card):
    """K15's stacked form (a split program with binding rows) and K13's lane
    form captured once, replayed after the ids, binding rows, parameter
    stack and mask change in place, against eager calls."""
    import chip_smoke
    from orientdb_tpu_torch.ops.predicates import ColumnScope, ParamBox, Predicate, pack_params

    B, n = 6, 70_001
    dg, _scope = _k15_scope(card, n, 13)
    scope = ColumnScope(dg.columns, dg.non_columnar, device=card, binding_columns=dg.columns, visible_aliases={"p"})
    params = chip_smoke.k15_lane_params(B)
    box = ParamBox(params[0])
    pred = Predicate([_k15_where(scope, chip_smoke.K15_STACKED_LONG, box)], card, box, uses_bindings=True,
                     max_stack=4, max_bufs=8)
    assert len(pred.programs) > 1
    rng = np.random.default_rng(13)
    ids = _t(rng.integers(-1, n + 3, (B, n)).astype(np.int32)).to(card)
    rows = _t(rng.integers(-1, n + 2, (B, n)).astype(np.int32)).to(card)
    stack = torch.from_numpy(np.stack([pack_params(p, box.used) for p in params])).to(card)
    seg = _t(np.sort(rng.integers(-1, 900, (B, n)), axis=1).astype(np.int32)).to(card)
    env = {"bindings": {"p": rows}}
    box.set_row(stack)
    try:
        pred(ids, env)
        T.rows_with_matches(seg, pred(ids, env), 900)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            mask = pred(ids, env)
            counts = T.rows_with_matches(seg, mask, 900)
        for k in range(3):
            ids.copy_(_t(rng.integers(-1, n + 3, (B, n)).astype(np.int32)))
            rows.copy_(_t(rng.integers(-1, n + 2, (B, n)).astype(np.int32)))
            rows_k = chip_smoke.k15_lane_params(B + k)[k:]
            stack.copy_(torch.from_numpy(np.stack([pack_params(p, box.used) for p in rows_k])))
            graph.replay()
            want = pred(ids, env)
            assert torch.equal(mask, want) and torch.equal(counts, T.plain_rows_with_matches_lanes(seg, want, 900))
    finally:
        box.reset()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_captured_arm_lane_groups_equal_cpu(card):
    """Rows groups past the root on the lane axis captured on the card (E2's
    lane-varying edge WHERE and endpoint arm, E4's OPTIONAL arm, E5's
    binding mask and OPTIONAL closing arm, E2b's ``.bothE()/.bothV()``, and
    an E2 batch whose one lane overflows past the root into a new variant)
    against the same batches on the CPU, and each group's captured launches
    through K15's stacked form and K13's lane form where it has them."""
    import chip_smoke
    from orientdb_tpu_torch.exec import tpu_engine as TE
    from orientdb_tpu_torch.storage.bigshape import build_snb_shape

    batches = [
        ([chip_smoke.E2] * 16, [{"n": 2_000 - 100 * i, "d": 10_000 + 500 * i} for i in range(16)]),
        ([chip_smoke.E2] * 16, [{"n": 600, "d": 10_000 if i == 9 else 19_900} for i in range(16)]),
        ([chip_smoke.E4] * 16, [{"n": 1_000 - 60 * i} for i in range(16)]),
        ([chip_smoke.E5] * 8, [{"n": 400 - 40 * i, "d": 11_000 + 900 * i} for i in range(8)]),
        ([chip_smoke.E2_BOTH] * 16, [{"n": 70 - 4 * i} for i in range(16)]),
    ]
    from orientdb_tpu_torch.exec.result import canonical_rows

    kw = dict(msgs_per_person=2, avg_knows=10, seed=7)
    gpu, gsnap = build_snb_shape(2_000, device=card, **kw)
    cpu, _ = build_snb_shape(2_000, device="cpu", **kw)
    for sqls, plist in batches:
        gpu.query(sqls[0], plist[0])
        cpu.query(sqls[0], plist[0])
        for _ in range(2):
            got = [canonical_rows(rs.to_dicts()) for rs in gpu.query_batch(sqls, plist)]
            want = [canonical_rows(rs.to_dicts()) for rs in cpu.query_batch(sqls, plist)]
            assert got == want
    plans = [p for v in TE._plan_cache(gsnap).values() for p in v.plans if p.group_replays]
    assert plans and all(p.lane_axis for p in plans)
    launched = {}
    for p in plans:
        for g in p.groups.values():
            assert g.graph is not None and g.nodes > 0
            for name, k in g.launches.items():
                launched[name] = launched.get(name, 0) + k
    assert launched.get("predicate_eval_stacked", 0) > 0 and launched.get("rows_with_matches_lanes", 0) > 0
    torch.cuda.synchronize()


BITMAP_LANE_CASES = [(1, 8, 1 << 16), (8, 8, 1 << 16), (16, 3, 4_096), (8, 33, 1_002), (8, 8, 1 << 23)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,c,vb", BITMAP_LANE_CASES)
def test_bitmap_lane_forms_equal_plain_on_card(card, B, c, vb):
    """The lane forms of K10 (`bitmap_hop_csr_lanes`), K11
    (`bitmap_emit_lanes`) and K12 (`frontier_advance_lanes`) over B lanes
    of c rows stacked as [B, c, vb], against their plain versions and, lane
    by lane, against the single forms, exactly: shared and lane-stacked
    gates and node masks, a bound column, an empty lane (alive 0), ORed
    into ``out``, per-lane counts; c = 3 and 33 put lanes across the push's
    32-row batches and vb = 1,002 takes the one-byte paths."""
    rng = np.random.default_rng(B * 31 + c + vb)
    v = min(vb - 2, 200_000)
    indptr, nbrs = _csr(rng, v, 6.0)
    ip, nb = _t(indptr).to(card), _t(nbrs).to(card)
    e = nbrs.shape[0]
    emask = _t(rng.random(e) < 0.7).to(card)
    fr_np = np.zeros((B * c, vb), bool)
    fr_np[np.arange(B * c)[:, None], rng.integers(0, v, (B * c, 3 if vb > 4096 else 40))] = True
    fr_np[:c] = False  # lane 0 is empty
    fr = _t(fr_np.reshape(B, c, vb)).to(card)
    alive = T.mask_count_lanes(fr.view(B, -1))
    gates = [_t(rng.random(vb) < 0.6).to(card), _t(rng.random((B, vb)) < 0.6).to(card)]
    nodes = [_t(rng.random(vb) < 0.5).to(card), _t(rng.random((B, vb)) < 0.5).to(card)]
    lane = lambda t, b: t if t is None or t.dim() == 1 else t[b]  # noqa: E731
    for g in (None, *gates):
        for m in (None, emask):
            got = T.bitmap_hop_csr_lanes(ip, nb, None, m, fr, g, alive)
            assert torch.equal(got, T.plain_bitmap_hop_csr_lanes(ip, nb, None, m, fr, g, alive))
            for b in range(B):
                assert torch.equal(got[b], T.bitmap_hop_csr(ip, nb, None, m, fr[b], lane(g, b), alive[b]))
            assert not got[0].any()
    base = _t(rng.random((B, c, vb)) < 0.01).to(card)
    acc = T.bitmap_hop_csr(ip, nb, None, emask, fr, gates[1], alive, out=base.clone())
    assert torch.equal(acc, base | T.plain_bitmap_hop_csr_lanes(ip, nb, None, emask, fr, gates[1], alive))
    nxt = T.bitmap_hop_csr_lanes(ip, nb, None, None, fr, None, alive)
    bound = _t(_bound_for(rng, nxt.cpu().numpy().reshape(B * c, vb)).reshape(B, c)).to(card)
    for node in nodes:
        for bd in (None, bound):
            for flags in ((True, True, True), (False, False, True), (False, True, False)):
                got = T.bitmap_emit_lanes(nxt, node, bd, *flags)
                want = T.plain_bitmap_emit_lanes(nxt, node, bd, *flags)
                for x, y in zip(got, want):
                    assert (x is None and y is None) or torch.equal(x, y)
                for b in range(B):
                    one = T.bitmap_emit(nxt[b], lane(node, b), None if bd is None else bd[b], *flags)
                    for x, y in zip(got, one):
                        assert (x is None and y is None) or torch.equal(x[b], y)
    for g in (None, *gates):
        for nd, bd in ((None, None), (nodes[0], None), (nodes[1], bound)):
            a, w = [nxt.clone(), fr.clone()], [nxt.clone(), fr.clone()]
            got = T.frontier_advance_lanes(a[0], a[1], g, nd, bd)
            want = T.plain_frontier_advance_lanes(w[0], w[1], g, nd, bd)
            assert torch.equal(a[0], w[0]) and torch.equal(a[1], w[1])
            got, want = (got, want) if nd is not None else ((got,), (want,))
            for x, y in zip(got, want):
                assert x.shape == (B,) and torch.equal(x, y)
            for b in range(B):
                n1, v1 = nxt[b].clone(), fr[b].clone()
                one = T.frontier_advance(n1, v1, lane(g, b), lane(nd, b), None if bd is None else bd[b])
                one = one if nd is not None else (one,)
                assert torch.equal(a[0][b], n1) and torch.equal(a[1][b], v1)
                assert all(int(x[b]) == int(y) for x, y in zip(got, one))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_captured_var_lane_groups_equal_cpu(card):
    """Variable-depth and NOT groups on the lane axis captured on the card
    (V2's both-direction rows with a depth alias, V3's NOT arm, the
    variable-depth COUNT, a WHILE that reads a parameter) against the same
    batches on the CPU, with the lane forms of K10, K11 and K12 among each
    group's captured launches."""
    from orientdb_tpu_torch.exec import tpu_engine as TE
    from orientdb_tpu_torch.exec.result import canonical_rows
    from orientdb_tpu_torch.storage.bigshape import build_person_knows

    root = "MATCH {class:Person, as:p, where:(uid < :k)}"
    batches = [
        (root + "-knows-{as:f, maxDepth:2, depthAlias:d} RETURN p.uid AS p, f.uid AS f, d AS d",
         [{"k": 16 - i} for i in range(8)]),
        (root + "-knows->{as:f}, NOT {as:f}-knows->{where:(age > 70)} RETURN p.uid AS p, f.uid AS f",
         [{"k": 16 - i} for i in range(8)]),
        (root + "-knows->{as:f, while:($depth < 3), where:(age < 30)} RETURN count(*) AS n",
         [{"k": 60 - 5 * i} for i in range(8)]),
        (root + "-knows->{as:f, while:($depth < :d)} RETURN p.uid AS p, f.uid AS f",
         [{"k": 12 - i, "d": 3 - i % 3} for i in range(8)]),
    ]
    kw = dict(avg_knows=6, seed=11)
    gpu, gsnap = build_person_knows(5_000, device=card, **kw)
    cpu, _ = build_person_knows(5_000, device="cpu", **kw)
    for sql, plist in batches:
        gpu.query(sql, plist[0])
        cpu.query(sql, plist[0])
        for _ in range(2):
            got = [canonical_rows(rs.to_dicts()) for rs in gpu.query_batch([sql] * 8, plist)]
            want = [canonical_rows(rs.to_dicts()) for rs in cpu.query_batch([sql] * 8, plist)]
            assert got == want
    plans = [p for v in TE._plan_cache(gsnap).values() for p in v.plans if p.group_replays]
    assert len(plans) >= 4 and all(p.lane_axis for p in plans)
    for p in plans:
        launched = {n for g in p.groups.values() for n in g.launches}
        assert {"bitmap_hop_csr_lanes", "bitmap_emit_lanes"} <= launched or "frontier_advance_lanes" in launched
    torch.cuda.synchronize()
