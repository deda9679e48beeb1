"""One rank of a mesh over a ``torch.distributed`` process group: a job
that a launcher starts once a rank (``torch.multiprocessing`` with the
spawn method, or any other), each rank holding one shard (`ProcessShards`).

`run_rank` joins the group through a ``file://`` rendezvous, carries the
job's graph into a port database (`carry.snapshot_from_arrays`), attaches
it with a mesh over the group, answers the job's statements (each recorded,
then replayed) and its row-sharded BFS, and writes its answers to
``<out_dir>/rank<r>.pkl``. A failed collective or statement ends the rank
with the exception. By default a rank runs on a card over NCCL (rank r on
card r modulo the host's cards); ``backend="gloo", device="cpu"`` runs it on
the CPU, as the CPU tests do.
"""

from __future__ import annotations

import os
import pickle

import torch
import torch.distributed as dist


def run_rank(rank: int, world: int, init_file: str, job_file: str, out_dir: str,
             backend: str = "nccl", device: str = "cuda") -> None:
    """The job of ``job_file`` (a pickled dict: ``schema`` and ``arrays`` as
    `carry.snapshot_from_arrays` takes them, ``queries`` a list of ``(sql,
    params)``, ``calls`` how often each runs, ``bfs`` an optional
    ``(edge class, roots, max_depth, replicas)``) on rank ``rank`` of
    ``world``."""
    import numpy as np

    from orientdb_tpu_torch.carry import snapshot_from_arrays
    from orientdb_tpu_torch.exec.result import canonical_rows
    from orientdb_tpu_torch.parallel.sharded import ShardedCSR, bfs_reachability, make_mesh

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError('run_rank: no CUDA card; pass backend="gloo", device="cpu" to run on the CPU')
        device = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=world)
    try:
        with open(job_file, "rb") as f:
            job = pickle.load(f)
        db, snap = snapshot_from_arrays(job["schema"], job["arrays"], device=device)
        mesh = make_mesh(world, device=device, group=dist.group.WORLD)
        db.attach_snapshot(snap, mesh=mesh)
        answers = {"queries": [], "bfs": None}
        for sql, params in job["queries"]:
            answers["queries"].append(
                [canonical_rows(db.query(sql, params).to_dicts()) for _ in range(job.get("calls", 3))]
            )
        if job.get("bfs") is not None:
            edge_class, roots, max_depth, replicas = job["bfs"]
            scsr = ShardedCSR.from_snapshot(snap, make_mesh(world, replicas, device, dist.group.WORLD), edge_class)
            answers["bfs"] = np.packbits(bfs_reachability(scsr, roots, max_depth))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(answers, f)
        # no rank tears the group down while another still uses it
        dist.barrier()
    finally:
        dist.destroy_process_group()
