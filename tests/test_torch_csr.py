"""The port's CSR primitives (`orientdb_tpu_torch.ops.csr`) against the
reference's (`orientdb_tpu.ops.csr`) on the same numpy-seeded inputs.

On the CPU each port wrapper runs its plain PyTorch version. int32 and bool
results must be exactly equal, padding slots included. float32 results are
held to rtol 1e-5 of the largest magnitude involved, because the two sides
add in a different order (for segment sums that magnitude is the running
total the reference differences). The kernels themselves run only on a
CUDA card: the tests marked ``cuda`` hold each kernel against its plain
version there and skip elsewhere."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orientdb_tpu.ops import csr as J
from orientdb_tpu_torch.ops import csr as T
from test_torch_kernels import EXPAND_KINDS, EXPAND_WIDTHS, expand_case, expand_sizes

# value_cumsum's blocking switches at these lengths (csr.py:155-159)
LENGTHS = [0, 1, 255, 256, 257, 511, 512, 513, 4096 + 7]
F32_RTOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _csr(rng, v: int, avg: float, tail_zero: int = 0):
    deg = rng.poisson(avg, v).astype(np.int64)
    if tail_zero:
        deg[-tail_zero:] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nbrs = rng.integers(0, max(v, 1), int(deg.sum()), dtype=np.int32)
    return indptr, nbrs


def _assert_f32_close(got, want):
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_RTOL * scale)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads, and the suite runs
    in parallel workers: keep torch to one thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("force_blocked", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_value_cumsum_i32(n, force_blocked):
    v = np.random.default_rng(n).integers(0, 2**20, n, dtype=np.int32)
    want = _np(J.value_cumsum(jnp.asarray(v), force_blocked=force_blocked))
    got = T.value_cumsum(_t(v)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("force_blocked", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_value_cumsum_f32(n, force_blocked):
    v = np.random.default_rng(n + 1).random(n, dtype=np.float32)
    want = _np(J.value_cumsum(jnp.asarray(v), force_blocked=force_blocked))
    got = T.value_cumsum(_t(v)).numpy()
    assert got.dtype == np.float32
    _assert_f32_close(got, want)


@pytest.mark.parametrize("n", LENGTHS)
def test_mask_cumsum_and_exclusive_cumsum(n):
    rng = np.random.default_rng(n + 2)
    m = rng.random(n) < 0.4
    np.testing.assert_array_equal(
        T.mask_cumsum(_t(m)).numpy(), _np(J.mask_cumsum(jnp.asarray(m)))
    )
    v = rng.integers(0, 2**20, n, dtype=np.int32)
    if n:  # the reference's exclusive_cumsum needs one element
        np.testing.assert_array_equal(
            T.exclusive_cumsum(_t(v)).numpy(), _np(J.exclusive_cumsum(jnp.asarray(v)))
        )
    want_sum = np.int32(_np(jnp.sum(jnp.asarray(v))))
    assert int(T.value_sum(_t(v))) == int(want_sum)


# the edges of the kernels' look-back tiles (csr.py `_TILE` for K1,
# `_COMPACT_TILE` for K3), and a length of many tiles
TILE_LENGTHS = sorted(
    {37 * T._COMPACT_TILE + 11}
    | {n for t in (T._TILE, T._COMPACT_TILE) for n in (t - 1, t, t + 1, 2 * t + 1)}
)


@pytest.mark.parametrize("n", TILE_LENGTHS)
def test_scans_at_the_lookback_tile(n):
    """value_cumsum (int32 exactly, float32 to rtol 1e-5), exclusive_cumsum,
    exclusive_cumsum_total, mask_cumsum and value_sum at the blocking of
    the single-pass scan, against the reference."""
    rng = np.random.default_rng(n + 31)
    v = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(T.value_cumsum(_t(v)).numpy(), _np(J.value_cumsum(jnp.asarray(v))))
    want_ex = _np(J.exclusive_cumsum(jnp.asarray(v)))
    np.testing.assert_array_equal(T.exclusive_cumsum(_t(v)).numpy(), want_ex)
    want_sum = int(np.int32(_np(jnp.sum(jnp.asarray(v)))))
    offsets, total = T.exclusive_cumsum_total(_t(v))
    np.testing.assert_array_equal(offsets.numpy(), want_ex)
    assert total.shape == () and int(total) == want_sum
    assert int(T.value_sum(_t(v))) == want_sum
    f = rng.random(n, dtype=np.float32)
    _assert_f32_close(T.value_cumsum(_t(f)).numpy(), _np(J.value_cumsum(jnp.asarray(f))))
    _assert_f32_close(np.asarray(float(T.value_sum(_t(f)))), np.asarray(float(f.astype(np.float64).sum())))
    m = rng.random(n) < 0.4
    np.testing.assert_array_equal(T.mask_cumsum(_t(m)).numpy(), _np(J.mask_cumsum(jnp.asarray(m))))


@pytest.mark.parametrize("n", TILE_LENGTHS)
@pytest.mark.parametrize("density", [0.02, 0.5])
def test_compact_indices_at_the_lookback_tile(n, density):
    """compact_indices in the fill form (with truncation) and the offset
    form at the blocking of the one-pass compaction, against the
    reference."""
    m = np.random.default_rng(n + 32).random(n) < density
    trues = int(m.sum())
    for out_size in sorted({8, max(1, trues // 2), T.bucket(max(trues, 1)), T.bucket(n)}):
        want = _np(J.compact_indices(jnp.asarray(m), out_size))
        np.testing.assert_array_equal(T.compact_indices(_t(m), out_size).numpy(), want)
        buf = torch.full((out_size + 5,), -1, dtype=torch.int32)
        got = T.compact_indices(_t(m), out_size, out=buf, offset=5)
        kept = min(trues, out_size)
        np.testing.assert_array_equal(got.numpy()[:kept], want[:kept])
        assert (buf.numpy()[:5] == -1).all() and (buf.numpy()[5 + kept :] == -1).all()


@pytest.mark.parametrize("n", LENGTHS)
def test_degree_counts_with_padding(n):
    rng = np.random.default_rng(n + 3)
    indptr, _ = _csr(rng, 300, 4.0)
    srcs = rng.integers(-1, 300, n, dtype=np.int32)
    want = _np(J.degree_counts(jnp.asarray(indptr), jnp.asarray(srcs)))
    np.testing.assert_array_equal(T.degree_counts(_t(indptr), _t(srcs)).numpy(), want)
    pad = np.full(n, -1, np.int32)  # all-padding sources count 0
    np.testing.assert_array_equal(
        T.degree_counts(_t(indptr), _t(pad)).numpy(), np.zeros(n, np.int32)
    )


def _expand_both(indptr, nbrs, srcs, out_size):
    counts = _np(J.degree_counts(jnp.asarray(indptr), jnp.asarray(srcs)))
    offsets = _np(J.exclusive_cumsum(jnp.asarray(counts))) if srcs.size else counts
    total = np.int32(counts.sum())
    want = J.gather_expand(
        jnp.asarray(indptr),
        jnp.asarray(nbrs),
        jnp.asarray(srcs),
        jnp.asarray(offsets),
        jnp.asarray(total),
        out_size,
    )
    got = T.gather_expand(
        _t(indptr),
        _t(nbrs),
        _t(srcs),
        T.exclusive_cumsum(T.degree_counts(_t(indptr), _t(srcs))),
        torch.tensor(int(total), dtype=torch.int32),
        out_size,
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), _np(w))
    return int(total)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 511, 513, 4096 + 7])
def test_gather_expand(n):
    rng = np.random.default_rng(n + 4)
    indptr, nbrs = _csr(rng, 500, 3.0)
    srcs = rng.integers(-1, 500, n, dtype=np.int32)
    counts = np.where(srcs >= 0, np.diff(indptr)[np.clip(srcs, 0, None)], 0)
    total = int(counts.sum())
    # exact fit, and padding past the total
    _expand_both(indptr, nbrs, srcs, T.bucket(max(total, 1)))
    _expand_both(indptr, nbrs, srcs, T.bucket(max(total, 1)) * 2)


def test_gather_expand_zero_degree_tail_and_padding():
    rng = np.random.default_rng(5)
    # the last rows have degree 0: their offsets equal the total, which is
    # also out_size, so the reference drops their start marks
    indptr, nbrs = _csr(rng, 64, 3.0, tail_zero=8)
    srcs = np.concatenate([np.arange(40, 64, dtype=np.int32), np.full(3, -1, np.int32)])
    counts = np.where(srcs >= 0, np.diff(indptr)[np.clip(srcs, 0, None)], 0)
    total = int(counts.sum())
    assert total > 0
    _expand_both(indptr, nbrs, srcs, total)
    # all-padding sources: every slot is -1
    pad = np.full(16, -1, np.int32)
    assert _expand_both(indptr, nbrs, pad, 8) == 0
    # an edge list with no neighbors at all
    empty_indptr = np.zeros(65, np.int32)
    _expand_both(empty_indptr, np.zeros(0, np.int32), srcs, 8)


def _reference_sizing(indptr, srcs):
    """The reference's count → exclusive scan → sum."""
    counts = J.degree_counts(jnp.asarray(indptr), jnp.asarray(srcs))
    offsets = _np(J.exclusive_cumsum(counts)) if srcs.size else np.zeros(0, np.int32)
    return offsets, int(np.int32(_np(jnp.sum(counts))))


@pytest.mark.parametrize("width", EXPAND_WIDTHS)
@pytest.mark.parametrize("kind", EXPAND_KINDS)
def test_expand_offsets_and_gather_equal_reference(kind, width):
    """`expand_offsets` against the reference's degree_counts →
    exclusive_cumsum and sum, and `gather_expand` (with and without the
    edge map) against its gather_expand (and, mapped, against take_pad of
    the map at the edge positions), exactly, padding slots included: a hub
    row over several of K2b's tiles, runs of zero-degree rows and of -1
    sources, total 0, E = 0, out_size equal to, far past and below the
    total."""
    indptr, nbrs, emap, srcs = expand_case(kind, width, width + 61)
    want_off, want_total = _reference_sizing(indptr, srcs)
    offsets, total = T.expand_offsets(_t(indptr), _t(srcs))
    assert offsets.dtype == torch.int32 and total.shape == ()
    np.testing.assert_array_equal(offsets.numpy(), want_off)
    assert int(total) == want_total
    args = [jnp.asarray(a) for a in (indptr, nbrs, srcs, want_off)] + [jnp.asarray(np.int32(want_total))]
    for out_size in expand_sizes(want_total):
        want = [_np(w) for w in J.gather_expand(*args, out_size)]
        mapped = _np(J.take_pad(jnp.asarray(emap), jnp.asarray(want[1]), -1))
        for edge_map, want_pos in ((None, want[1]), (_t(emap), mapped)):
            got = T.gather_expand(_t(indptr), _t(nbrs), _t(srcs), offsets, total, out_size, edge_map)
            for g, w in zip(got, (want[0], want_pos, want[2])):
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f"out_size={out_size}")


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("density", [0.02, 0.5])
def test_compact_indices_regimes_and_truncation(n, density):
    m = np.random.default_rng(n + 6).random(n) < density
    trues = int(m.sum())
    # out_size*8 > n takes the reference's nonzero regime; a small out_size
    # its searchsorted regime; out_size < trues truncates
    sizes = {8, T.bucket(max(trues, 1)), T.bucket(max(n, 1)), max(1, trues // 2)}
    for out_size in sorted(sizes):
        want = _np(J.compact_indices(jnp.asarray(m), out_size))
        got = T.compact_indices(_t(m), out_size).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"out_size={out_size}")


@pytest.mark.parametrize("n", LENGTHS)
def test_take_pad_and_mask_count(n):
    rng = np.random.default_rng(n + 7)
    m = max(n, 5)
    idx = rng.integers(-2, n + 3, m, dtype=np.int32)  # padding and past-the-end
    vals_i = rng.integers(-(2**20), 2**20, n, dtype=np.int32)
    vals_f = rng.random(n, dtype=np.float32)
    vals_b = rng.random(n) < 0.5
    for vals, fill in ((vals_i, -1), (vals_f, 0.0), (vals_b, False)):
        want = _np(J.take_pad(jnp.asarray(vals), jnp.asarray(idx), fill))
        got = T.take_pad(_t(vals), _t(idx), fill).numpy()
        assert got.dtype == vals.dtype
        np.testing.assert_array_equal(got, want)
    assert int(T.mask_count(_t(vals_b))) == int(J.mask_count(jnp.asarray(vals_b)))


#: degree shapes beside LENGTHS' uniform ones, (kind, segments): Zipf
#: degrees with a hub over several of the kernel's 5,120-item tiles, every
#: segment empty, runs of empty segments around long ones, and a CSR slice
#: whose indptr starts past 0
SEGMENT_SHAPES = [("zipf", 3000), ("zipf", 40), ("empty", 500), ("runs", 2000), ("slice", 900)]


def _segment_indptr(rng, kind: str, v: int) -> np.ndarray:
    if kind == "zipf":
        deg = np.minimum(rng.zipf(1.6, v), 20_000)
        deg[v // 2] = 9_000
    elif kind == "empty":
        deg = np.zeros(v, np.int64)
    elif kind == "runs":
        deg = np.zeros(v, np.int64)
        deg[rng.choice(v, v // 50, replace=False)] = rng.integers(1, 6_000, v // 50)
    else:
        deg = rng.poisson(10, v + v // 3)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    return indptr[v // 3 :] if kind == "slice" else indptr


@pytest.mark.parametrize(
    "n", LENGTHS + [pytest.param(s, id=f"{s[0]}-{s[1]}") for s in SEGMENT_SHAPES]
)
def test_indptr_segment_sum(n):
    if isinstance(n, tuple):
        rng = np.random.default_rng(n[1] + 17)
        indptr = _segment_indptr(rng, *n)
        v, n = indptr.shape[0] - 1, int(indptr[-1])
    else:
        rng = np.random.default_rng(n + 8)
        v = max(n // 4, 1)
        deg = rng.multinomial(n, np.ones(v) / v)
        indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    vals_i = rng.integers(0, 2**20, n, dtype=np.int32)
    vals_f = rng.random(n, dtype=np.float32)
    for out_size in (T.bucket(v), max(v // 2, 1)):  # padded, and cut
        want = _np(J.indptr_segment_sum(jnp.asarray(vals_i), jnp.asarray(indptr), out_size))
        got = T.indptr_segment_sum(_t(vals_i), _t(indptr), out_size).numpy()
        np.testing.assert_array_equal(got, want)
        want = _np(J.indptr_segment_sum(jnp.asarray(vals_f), jnp.asarray(indptr), out_size))
        got = T.indptr_segment_sum(_t(vals_f), _t(indptr), out_size).numpy()
        # the port rounds each segment sum once; the reference differences a
        # float32 running sum, so its error scales with the running total
        run64 = np.concatenate([[0.0], np.cumsum(vals_f.astype(np.float64))])
        exact = np.zeros(out_size)
        k = min(v, out_size)
        exact[:k] = (run64[indptr[1:]] - run64[indptr[:-1]])[:k]
        np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-6)
        running = float(vals_f.astype(np.float64).sum())
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_RTOL * max(running, 1.0))


def test_wrappers_refuse_bad_inputs():
    with pytest.raises(TypeError):
        T.value_cumsum(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        T.take_pad(torch.zeros(8, dtype=torch.int32)[::2], torch.zeros(2, dtype=torch.int32), 0)
