"""The port's mesh over a ``torch.distributed`` process group
(`ProcessShards`): two gloo ranks on the CPU, one shard each, against the
same statements and BFS on a 2-shard `LocalShards` mesh in this process.

The ranks run `orientdb_tpu_torch.parallel.ranks.run_rank` in processes of
their own (spawned, so they import no JAX), meet through a ``file://``
rendezvous under ``tmp_path`` and write their answers there. The test waits
at most 120 s for them, and fails, never skips, when a rank hangs or dies.
"""

import multiprocessing as mp
import pickle
import time

import numpy as np
import pytest
import torch

from orientdb_tpu.storage.ingest import generate_demodb
from orientdb_tpu.storage.snapshot import attach_fresh_snapshot
from orientdb_tpu_torch.carry import snapshot_from_arrays
from orientdb_tpu_torch.exec.result import canonical_rows
from orientdb_tpu_torch.parallel.ranks import run_rank
from orientdb_tpu_torch.parallel.sharded import ShardedCSR, bfs_reachability, make_mesh
from test_torch_match import _carry_arrays

RANK_LIMIT_S = 120
QUERIES = [
    (
        "MATCH {class:Profiles, as:p, where:(age > 40)}-HasFriend->{as:f}"
        "-HasFriend->{as:g, where:(age < 30)} RETURN count(*) AS n",
        {},
    ),
    ("MATCH {class:Profiles, as:p, where:(uid < :u)}-HasFriend-{as:f} RETURN p.uid AS p, f.uid AS f", {"u": 25}),
    (
        "MATCH {class:Profiles, as:p, where:(uid < 10)}-HasFriend->{as:f, while:($depth < 3)} "
        "RETURN p.uid AS p, f.uid AS f",
        {},
    ),
    (
        "MATCH {class:Profiles, as:p, where:(uid < 20)}.outE('HasFriend'){as:e}.inV(){as:f} "
        "RETURN p.uid AS p, f.uid AS f",
        {},
    ),
]


def _spawn_ranks(tmp_path, monkeypatch, job, world: int = 2):
    job_file = tmp_path / "job.pkl"
    with open(job_file, "wb") as f:
        pickle.dump(job, f)
    # A rank's ops are small and its collectives wait on the other rank:
    # with an intra-op pool as wide as the host, the ranks' threads contend
    # with each other and with the other test workers, and a loaded host
    # slowed the pair several-fold. One thread a rank (read by each spawned
    # rank's torch at import).
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(
            target=run_rank,
            args=(r, world, str(tmp_path / "rendezvous"), str(job_file), str(tmp_path), "gloo", "cpu"),
        )
        for r in range(world)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_LIMIT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} still running after {RANK_LIMIT_S} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def test_run_rank_without_a_card_says_how_to_run_on_the_cpu(tmp_path, monkeypatch):
    """A rank runs on a card unless asked for gloo and the CPU; without a
    card it refuses before it joins a group, and says how to ask."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='backend="gloo", device="cpu"'):
        run_rank(0, 1, str(tmp_path / "rendezvous"), str(tmp_path / "job.pkl"), str(tmp_path))


def test_two_gloo_ranks_equal_local_shards(tmp_path, monkeypatch):
    jdb = generate_demodb(n_profiles=200, avg_friends=4, seed=9)
    jsnap = attach_fresh_snapshot(jdb)
    schema, arrays = _carry_arrays(jdb, jsnap)
    V = jsnap.num_vertices
    roots = np.zeros((3, V), bool)
    roots[0, 0] = roots[1, V - 1] = roots[2, 5] = roots[2, V // 2] = True
    job = {"schema": schema, "arrays": arrays, "queries": QUERIES, "calls": 3,
           "bfs": ("HasFriend", roots, 4, 2)}
    ranks = _spawn_ranks(tmp_path, monkeypatch, job)

    db, snap = snapshot_from_arrays(schema, arrays, device="cpu")
    db.attach_snapshot(snap, mesh=make_mesh(2, device="cpu"))
    for k, (sql, params) in enumerate(QUERIES):
        want = canonical_rows(db.query(sql, params).to_dicts())
        assert want, sql
        for r, ans in enumerate(ranks):
            assert ans["queries"][k] == [want] * 3, (r, sql)
    want = bfs_reachability(ShardedCSR.from_snapshot(snap, make_mesh(2, 2, device="cpu"), "HasFriend"), roots, 4)
    for ans in ranks:
        got = np.unpackbits(ans["bfs"])[: want.size].reshape(want.shape).astype(bool)
        assert (got == want).all()


def test_one_gloo_rank_hops_as_local_shards(tmp_path):
    """A one-rank gloo group in this process (`ProcessShards`, rank 0 of 1):
    K10's eid form on its shard, merged through the group's all-reduce,
    equals the one-shard `LocalShards` hop and the slot walk over the
    edge-list slice (both directions, an edge mask, a WHILE gate), and a
    variable-depth statement on the group, recorded then replayed, equals
    it on `LocalShards`."""
    import torch.distributed as dist

    from orientdb_tpu_torch.ops import csr as K
    from orientdb_tpu_torch.ops.device_graph import device_graph
    from orientdb_tpu_torch.parallel import mesh_graph as MG

    jdb = generate_demodb(n_profiles=200, avg_friends=4, seed=9)
    jsnap = attach_fresh_snapshot(jdb)
    schema, arrays = _carry_arrays(jdb, jsnap)
    rng = np.random.default_rng(4)
    vb = 256
    emask = torch.from_numpy(rng.random(jsnap.edge_classes["HasFriend"].num_edges) < 0.7)
    fr = torch.from_numpy(rng.random((3, vb)) < 0.05)
    gate = torch.from_numpy(rng.random(vb) < 0.8)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0, world_size=1)
    try:
        twins = []
        for group in (dist.group.WORLD, None):
            db, snap = snapshot_from_arrays(schema, arrays, device="cpu")
            mesh = make_mesh(1, device="cpu", group=group)
            db.attach_snapshot(snap, mesh=mesh)
            twins.append((db, mesh, device_graph(snap, db.device)))
        assert twins[0][1].collective and not twins[1][1].collective
        assert K.bucket(jsnap.num_vertices) == vb
        el = [twins[1][2].arrays[f"sh:HasFriend:el:{k}"] for k in ("src", "dst", "eid")]
        for d, extra, (a, e) in (("out", "ebase", (el[0], el[1])), ("in", "eid", (el[1], el[0]))):
            for g in (None, gate):
                want = K.plain_bitmap_hop_eid(a, e, el[2], emask, fr, g)
                assert want.any()
                for _db, mesh, dg in twins:
                    sh = [dg.arrays[f"sh:HasFriend:{d}:{k}"] for k in ("indptr", "nbr", extra)]
                    assert torch.equal(MG.sharded_bitmap_hop(mesh, *sh, d == "out", emask, fr, g), want)
        sql, params = QUERIES[2]
        rows = [canonical_rows(db.query(sql, params).to_dicts()) for db, _m, _g in twins for _ in range(2)]
        assert rows[0] and all(r == rows[0] for r in rows)
    finally:
        dist.destroy_process_group()
