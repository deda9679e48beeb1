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


def _paged_pool(rng, v: int, avg: float, block_edges: int, pages: int):
    """A random CSR cut into a tier partition's blocks (`storage/tiering`)
    and a pool of ``pages`` pages: random resident blocks at random pages,
    free pages, and one evicted page that keeps its stale nbr/eid rows
    behind a -1 owner row. Returns numpy arrays."""
    from orientdb_tpu_torch.storage import tiering
    from orientdb_tpu_torch.utils.config import config

    indptr, nbrs = _csr(rng, v, avg, tail_zero=3)
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
    # -1 edge ids under live owners (take_pad(emask, -1) reads False)
    live = pools["own"] >= 0
    pools["eid"][live & (rng.random(live.shape) < 0.1)] = -1
    return indptr, part, pools, pageof


@pytest.mark.cuda
@pytest.mark.parametrize(
    "v,avg,block_edges,pages,c",
    [(60, 3.0, 16, 3, 1), (60, 3.0, 16, 0, 2), (5_000, 6.0, 256, 20, 8), (100_000, 8.0, 4_096, 60, 8)],
)
def test_paged_kernels_equal_plain_on_card(card, v, avg, block_edges, pages, c):
    """K19 paged_hop, K20 paged_hop_miss and K21 paged_expand against their
    plain versions, exactly: resident, free and evicted pages with vertex 0
    in every frontier row, an edge mask with -1 edge ids, a WHILE gate, an
    empty frontier, padding sources and cold blocks, both directions of
    K21, and an empty pool."""
    rng = np.random.default_rng(v + pages)
    indptr, part, pools, pageof = _paged_pool(rng, v, avg, block_edges, pages)
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
            got = T.paged_hop(d["own"], d["nbr"], d["eid"], m, fr_t, g)
            assert torch.equal(got, T.plain_paged_hop(d["own"], d["nbr"], d["eid"], m, fr_t, g))
            acc = torch.zeros_like(fr_t)
            acc[:, -1] = True
            T.paged_hop(d["own"], d["nbr"], d["eid"], m, fr_t, g, out=acc)
            assert torch.equal(acc, got | (torch.arange(vb, device=card) == vb - 1)[None, :])
            want = T.plain_paged_hop_miss(fr_t, bv, pg, ip, g)
            assert bool(T.paged_hop_miss(fr_t, bv, pg, ip, g)) == bool(want)
    zero = torch.zeros((), dtype=torch.int32, device=card)
    empty = torch.zeros_like(fr_t)
    assert not bool(T.paged_hop_miss(empty, bv, pg, ip))
    assert not bool(T.paged_hop_miss(fr_t, bv, pg, ip, alive=zero))
    assert not T.paged_hop(d["own"], d["nbr"], d["eid"], None, fr_t, alive=zero).any()
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
    their plain versions, on the same sharded inputs."""
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
    for a, e in ((el[0], el[1]), (el[1], el[0])):
        for m in (None, emask):
            for g in (None, gate):
                got = T.bitmap_hop_eid(a, e, el[2], m, fr_t, g)
                assert torch.equal(got, T.plain_bitmap_hop_eid(a, e, el[2], m, fr_t, g))
        ok = _t(rng.random(vb) < 0.6).to(card)
        w_i = _t(rng.integers(0, 50, vb).astype(np.int32)).to(card)
        w_f = w_i.float() * 0.37
        for m in (None, emask):
            for w in (None, w_i):
                got = T.shard_weight_pass(a, e, el[2], m, ok, w, torch.ones(vb, dtype=torch.int32, device=card))
                want = T.plain_shard_weight_pass(a, e, el[2], m, ok, w, torch.ones(vb, dtype=torch.int32, device=card))
                assert torch.equal(got, want)
            got = T.shard_weight_pass(a, e, el[2], m, ok, w_f, torch.zeros(vb, device=card))
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
