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
