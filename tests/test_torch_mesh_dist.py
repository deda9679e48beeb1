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


def _spawn_ranks(tmp_path, job, world: int = 2):
    job_file = tmp_path / "job.pkl"
    with open(job_file, "wb") as f:
        pickle.dump(job, f)
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


def test_two_gloo_ranks_equal_local_shards(tmp_path):
    jdb = generate_demodb(n_profiles=200, avg_friends=4, seed=9)
    jsnap = attach_fresh_snapshot(jdb)
    schema, arrays = _carry_arrays(jdb, jsnap)
    V = jsnap.num_vertices
    roots = np.zeros((3, V), bool)
    roots[0, 0] = roots[1, V - 1] = roots[2, 5] = roots[2, V // 2] = True
    job = {"schema": schema, "arrays": arrays, "queries": QUERIES, "calls": 3,
           "bfs": ("HasFriend", roots, 4, 2)}
    ranks = _spawn_ranks(tmp_path, job)

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
