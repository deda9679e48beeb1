"""The engine's one-hop expansion (`exec/tpu_engine._expand_one_dir_chunked`
and `_expand_one_dir`) on the CPU: one `expand_offsets` (K2's degree scan)
and one `gather_expand` (K2b) a class, direction and chunk, no
`degree_counts` and no separate scan; an in walk maps its edge positions
through ``edge_id_in`` inside the gather (no take_pad over the map); a
split into chunks sizes each chunk again. Every statement's rows, recorded
and replayed, equal both reference engines (``engine="tpu"`` and
``engine="oracle"``)."""

import pytest
import torch

from orientdb_tpu_torch.exec import tpu_engine as TE
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.ops.device_graph import device_graph
from orientdb_tpu_torch.utils.config import config
from test_torch_edges import _carry, _same_as_reference
from test_tpu_fuzz import random_db

#: statement → one-hop CSR expansions (class and direction walks) it runs
WALKS = {
    # Q3's shape: two out hops, rows
    "MATCH {class:Person, as:a, where:(age > 40)}-Knows->{as:b}-Knows->{as:c, where:(age < 30)} "
    "RETURN a.uid AS a, b.uid AS b, c.uid AS c": 2,
    # an in walk
    "MATCH {class:Person, as:a, where:(age > 30)}<-Knows-{as:b} RETURN a.uid AS a, b.uid AS b": 1,
    # an in walk that reads the edge (its id through edge_id_in)
    "MATCH {class:Person, as:a}.inE('Follows'){as:e, where:(w > 1)}.outV(){as:b} "
    "RETURN a.uid AS a, e.w AS w, b.uid AS b": 1,
    # both directions: an out and an in walk
    "MATCH {class:Person, as:a, where:(uid < 10)}-Knows-{as:b} RETURN a.uid AS a, b.uid AS b": 2,
    # NOT arms (their anti-join walks the bitmap BFS, not this expansion)
    "MATCH {class:Person, as:a}-Knows->{as:b}, NOT {as:b}-Knows->{as:a} RETURN a.uid AS a, b.uid AS b": 1,
    "MATCH {class:Person, as:a, where:(age < 50)}-Knows->{as:b}, NOT {as:b}-Follows->{where:(age > 70)} "
    "RETURN a.uid AS a, b.uid AS b": 1,
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads, and the suite runs
    in parallel workers: keep torch to one thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graphs():
    jdb = random_db(4, 300)
    db, snap = _carry(jdb)
    return jdb, db, snap


class _Spy:
    """Counts the expansion's wrapper calls while a statement runs, and the
    take_pads whose table is an edge class's ``edge_id_in``."""

    NAMES = ("expand_offsets", "gather_expand", "degree_counts", "exclusive_cumsum_total")

    def __init__(self, monkeypatch, db, snap):
        dg = device_graph(snap, db.device)
        maps = {d.edge_id_in.data_ptr() for d in dg.edges.values() if d.edge_id_in.numel()}
        self.calls = dict.fromkeys(self.NAMES + ("take_pad over edge_id_in",), 0)

        def counted(name, fn):
            def call(*a, **kw):
                self.calls[name] += 1
                return fn(*a, **kw)

            return call

        for name in self.NAMES:
            monkeypatch.setattr(K, name, counted(name, getattr(K, name)))
        take = K.take_pad

        def take_pad(values, *a, **kw):
            self.calls["take_pad over edge_id_in"] += values.data_ptr() in maps
            return take(values, *a, **kw)

        monkeypatch.setattr(K, "take_pad", take_pad)


@pytest.mark.parametrize("sql", list(WALKS), ids=[f"stmt{i}" for i in range(len(WALKS))])
def test_one_scan_and_one_gather_a_walk(monkeypatch, graphs, sql):
    jdb, db, snap = graphs
    TE._plan_cache(snap).clear()
    spy = _Spy(monkeypatch, db, snap)
    db.query(sql).to_dicts()  # records
    monkeypatch.undo()
    walks = WALKS[sql]
    assert spy.calls == {
        "expand_offsets": walks,
        "gather_expand": walks,
        "degree_counts": 0,
        "exclusive_cumsum_total": 0,
        "take_pad over edge_id_in": 0,
    }, sql
    _same_as_reference(db, jdb, sql)


@pytest.mark.parametrize("cap", [64, 256])
def test_chunked_walks_size_each_chunk(monkeypatch, graphs, cap):
    """Past ``max_expansion_cap`` slots the binding table splits: one
    sizing scan for the whole walk, then one scan and one gather a chunk;
    the rows still equal both reference engines."""
    jdb, db, snap = graphs
    sql = "MATCH {class:Person, as:a}<-Knows-{as:b} RETURN a.uid AS a, b.uid AS b"
    monkeypatch.setattr(config, "max_expansion_cap", cap)
    TE._plan_cache(snap).clear()
    spy = _Spy(monkeypatch, db, snap)
    db.query(sql).to_dicts()
    chunks = spy.calls["gather_expand"]
    assert chunks > 1 and spy.calls["expand_offsets"] == chunks + 1, spy.calls
    assert spy.calls["take_pad over edge_id_in"] == 0
    TE._plan_cache(snap).clear()
    _same_as_reference(db, jdb, sql)
