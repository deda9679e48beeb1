"""Times batch cells of one tree of the port on one CUDA card, so that one
call can compare two trees on one card: the shared-batch cells BQ1 and BQ2
(64 × Q1 or Q2, one shared replay), the count group BG1 (G1 × 16, r =
300 + 500·i) and the rows group BQ3 (Q3 × 16, k = 1000 + 62·i) on the
Person–knows graph A of ``chip_smoke.py`` (8M persons, ~80M knows, seed
5), and on its SNB-shape graph B (24M vertices, seed 7) the count group
BE1 (E1 × 64, d = 12,000 + (211·i mod 8,000): 4 chunks of 16 lanes) and
the rows groups BE2 (E2 × 16, n = 10,000 + 625·i, d = 15,000: an edge
WHERE on a bare ``.outE()`` arm, then an endpoint arm) and BE5 (E5 × 8,
n = 1,000 + 125·i, d = 15,000: a binding-reading mask and an OPTIONAL
closing arm), with ``chip_smoke.py``'s parameters and numpy checks.

For each cell: the first batch checked against numpy, its launches and the
path its plan took (a group's lane axis, launches a group replay, capture
ms, graph nodes and reserved bytes), the batch's q/s by the reference's
statistic, the sequential q/s, one batch's host split and the device's busy
share with its top kernels (``chip_smoke.run_batch_cell``); then ``--reps``
more readings of the batched q/s (each the q/s of 3 batches), printed sorted
with their median; for a group cell each batched reading alternates with a
reading of the same items as sequential ``db.query`` calls (one pass), and
after each pair one more batch is split into its ``query_batch`` and its
``to_dicts`` host ms; its captured group replay is timed alone (device ms
a replay, CUDA events over 20 replays).

    python3 batch_times.py [--tree DIR] [--reps N] [--cells BQ1,BQ2,BG1,BQ3,BE1,BE2,BE5]

``DIR`` (default: this script's directory) holds the ``orientdb_tpu_torch``
package to time; it is imported before anything else, and the file it was
loaded from is printed, so a call can time two trees in turns (``--tree
A``, ``--tree B``, ``--tree B``, ``--tree A``). The helpers come from this
script's ``chip_smoke.py``. Prints a JSON object of the readings as its
last line; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--cells", default="BQ1,BQ2,BG1,BE1")
    args = ap.parse_args()
    cells = args.cells.split(",")
    tree = os.path.abspath(args.tree)
    # the tree's package first: chip_smoke.py (this script's) imports the
    # package by name, and the first import binds it for the process
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the batch cells run only on one", file=sys.stderr)
        return 1
    from orientdb_tpu_torch.exec import tpu_engine as TE
    from orientdb_tpu_torch.ops import csr as K
    from orientdb_tpu_torch.ops.device_graph import device_graph
    from orientdb_tpu_torch.storage.bigshape import build_person_knows, build_snb_shape

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"tree {tree} (kernels from {K.__file__}): {card}")

    readings = {}

    def timed(name, db, sql, plist, n_items, check, path, warm):
        cell = cs.BatchCell(name, [sql] * n_items, plist, check, path, warm=warm)
        ((plan, _dr, _dg),) = cs.run_batch_cell(torch, K, TE, db, db.current_snapshot(), card, cell)

        def run():
            for rs in db.query_batch(cell.sqls, cell.plist):
                rs.to_dicts()
            torch.cuda.synchronize()

        def seq():
            for s, p in zip(cell.sqls, cell.plist):
                db.query(s, p).to_dicts()
            torch.cuda.synchronize()

        if path != "group":
            qps = sorted(cs._batch_qps(run, n_items, iters=3, reps=1) for _ in range(args.reps))
            readings[name] = qps
            print(f"batch {name}: {args.reps} more readings, q/s batched {[round(q, 1) for q in qps]}, "
                  f"median {statistics.median(qps):.1f} [{card}]")
            return
        def split():
            t0 = time.perf_counter()
            rss = db.query_batch(cell.sqls, cell.plist)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for rs in rss:
                rs.to_dicts()
            return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

        bq, sq, qb, td = [], [], [], []
        for _ in range(args.reps):  # alternated: batched, sequential, one batch's host split
            bq.append(cs._batch_qps(run, n_items, iters=3, reps=1))
            sq.append(cs._batch_qps(seq, n_items, iters=1, reps=1))
            a, b = split()
            qb.append(a)
            td.append(b)
        g = max(plan.groups.items())[1]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            g.graph.replay()
        end.record()
        torch.cuda.synchronize()
        replay_ms = start.elapsed_time(end) / 20
        readings[name] = {
            "batched": sorted(bq), "sequential": sorted(sq), "query_batch ms": sorted(qb),
            "to_dicts ms": sorted(td), "group replay ms": replay_ms,
        }
        print(
            f"batch {name}: lane axis {getattr(plan, 'lane_axis', None)}, launches a group replay "
            f"{sum(g.launches.values())}, {replay_ms:.4f} ms a group replay on the card, "
            f"{g.nodes} graph nodes, capture {g.capture_ms:.1f} ms; {args.reps} "
            f"alternated readings, q/s batched {[round(q, 1) for q in sorted(bq)]} (median "
            f"{statistics.median(bq):.1f}), sequential {[round(q, 1) for q in sorted(sq)]} (median "
            f"{statistics.median(sq):.1f}), x{statistics.median(bq) / statistics.median(sq):.2f}; a batch's "
            f"host split, query_batch {[round(x, 1) for x in sorted(qb)]} ms (median {statistics.median(qb):.1f}), "
            f"to_dicts {[round(x, 1) for x in sorted(td)]} ms (median {statistics.median(td):.1f}) [{card}]"
        )

    if {"BQ1", "BQ2", "BG1", "BQ3"} & set(cells):
        db, snap = build_person_knows(8_000_000, avg_knows=10, seed=5, geo=True)
        device_graph(snap, db.device)
        torch.cuda.synchronize()
        age = snap.v_columns["age"].values
        want = {
            "BQ1": (cs.Q1, cs.numpy_1hop_count(snap, age > 40, age < 30)),
            "BQ2": (cs.Q2, cs.numpy_2hop_count(snap, age > 40, np.ones(snap.num_vertices, bool), age < 30)),
        }
        for name, (sql, n) in want.items():
            if name not in cells:
                continue
            check = lambda i, rows, n=n: cs._require(rows == [{"n": n}], f"count {rows} != numpy {n}")  # noqa: E731
            timed(name, db, sql, None, 64, check, "shared", [(sql, None)])
        if "BG1" in cells:
            gref = cs.GRef(np, snap)
            g1 = [{"x": 48.0, "y": 2.0, "r": 300.0 + 500.0 * i} for i in range(16)]
            timed("BG1", db, cs.G1, g1, 16, lambda i, rows: gref.check("G1", rows, g1[i]), "group",
                  [(cs.G1, cs.G_CELLS["G1"][1])])
        if "BQ3" in cells:
            ks3 = [cs.Q3_K // 2 + cs.Q3_K // 32 * i for i in range(16)]  # 1000 + 62·i
            q3_all = cs.numpy_q3_rows(np, snap, max(ks3))
            check = cs._rows_check(np, "BQ3", lambda i: cs._below(q3_all, ks3[i]), ("p", "f", "g"))
            timed("BQ3", db, cs.Q3, [{"k": k} for k in ks3], 16, check, "group", [(cs.Q3, {"k": max(ks3)})])
        TE._plan_cache(snap).clear()
        del db, snap
        gc.collect()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    if {"BE1", "BE2", "BE5"} & set(cells):
        sdb, ssnap = build_snb_shape(8_000_000, msgs_per_person=2, avg_knows=10, seed=7)
        device_graph(ssnap, sdb.device)
        torch.cuda.synchronize()
    if "BE1" in cells:
        ds = [12_000 + (i * 211) % 8_000 for i in range(64)]
        counts = cs.numpy_config5_counts(ssnap, ds)
        check = lambda i, rows: cs._require(rows == [{"n": counts[i]}], f"BE1 item {i}")  # noqa: E731
        timed("BE1", sdb, cs.E1, [{"d": d} for d in ds], 64, check, "group", [(cs.E1, {"d": min(ds)})])
    if "BE2" in cells:
        ns2 = [10_000 + 625 * i for i in range(16)]
        e2_all = cs.numpy_out_edge_rows(ssnap, max(ns2), 15_000, ssnap.v_columns["age"].values < 30)
        check = cs._rows_check(np, "BE2", lambda i: cs._below(e2_all, ns2[i]), ("p", "f", "cd"))
        timed("BE2", sdb, cs.E2, [{"n": n, "d": 15_000} for n in ns2], 16, check, "group",
              [(cs.E2, {"n": max(ns2), "d": 15_000})])
    if "BE5" in cells:
        ns5 = [1_000 + 125 * i for i in range(8)]
        e5_all = cs.numpy_probe_rows(ssnap, max(ns5), 15_000)
        check = cs._rows_check(np, "BE5", lambda i: cs._below(e5_all, ns5[i]), ("p", "f", "probe"))
        timed("BE5", sdb, cs.E5, [{"n": n, "d": 15_000} for n in ns5], 8, check, "group",
              [(cs.E5, {"n": max(ns5), "d": 15_000})])
    print(json.dumps({"tree": tree, "kernels": K.__file__, "card": card, "q/s batched": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
