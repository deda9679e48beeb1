"""The port's forward step (`orientdb_tpu_torch.entry.forward`) against the
graft entry's (`__graft_entry__._forward`: the reference's gather_expand, two
take_pads and ``age > 30``), on the CPU.

The same numpy inputs go to both; all four outputs (row, edge position,
masked neighbour, mask) must be exactly equal, padding slots included. The
graft entry's own example arguments come first, then seeded Person–knows
frontiers with padding sources and out sizes past and below the total."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from orientdb_tpu.ops.csr import bucket
from orientdb_tpu_torch.entry import forward
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.storage.bigshape import build_person_knows

REPO = Path(__file__).resolve().parent.parent


def _graft():
    spec = importlib.util.spec_from_file_location("graft_entry", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a) -> torch.Tensor:
    """A numpy array (0-d included) as a CPU tensor."""
    return torch.from_numpy(np.array(a))


def _same(got, want) -> None:
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def test_forward_equals_the_graft_entrys_on_its_example():
    g = _graft()
    fn, args = g.entry()
    out_size = fn.keywords["out_size"]
    indptr, _dst, srcs, offsets, total = args[:5]
    # the port's degree scan gives the graft entry's sizing
    got_off, got_total = K.expand_offsets(_t(indptr), _t(srcs))
    np.testing.assert_array_equal(got_off.numpy(), offsets)
    assert int(got_total) == int(total)
    want = fn(*args)
    got = forward(*(_t(a) for a in args), out_size=out_size)
    assert int(got[3].sum()) > 0  # the mask keeps some slots
    _same(got, want)


@pytest.mark.parametrize("cut", ["past", "equal", "below"])
def test_forward_equals_the_graft_entrys_on_a_frontier(cut):
    """A Person–knows frontier of 300 sources (a fifth of them padding):
    out_size past the total, equal to it, and below it (every slot live)."""
    g = _graft()
    _db, snap = build_person_knows(3_000, avg_knows=6, seed=13, device="cpu")
    csr = snap.edge_classes["knows"]
    age = snap.v_columns["age"]
    rng = np.random.default_rng(13)
    srcs = rng.integers(0, snap.num_vertices, 300, dtype=np.int32)
    srcs[rng.random(300) < 0.2] = -1
    indptr = np.asarray(csr.indptr_out, np.int32)
    offsets, total = K.expand_offsets(_t(indptr), _t(srcs))
    t = int(total)
    out_size = {"past": bucket(t) * 2, "equal": t, "below": t // 2}[cut]
    args = (indptr, np.asarray(csr.dst, np.int32), srcs, offsets.numpy(), np.int32(t),
            np.asarray(age.values), np.asarray(age.present))
    want = g._forward(*args, out_size=out_size)
    got = forward(*(_t(a) for a in args), out_size=out_size)
    _same(got, want)
