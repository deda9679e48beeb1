"""Times the shared-batch cells BQ1 and BQ2 (64 × Q1 or Q2, one shared
replay) of one tree of the port on one CUDA card, on the Person–knows graph
A of ``chip_smoke.py`` (8M persons, ~80M knows, seed 5), so that one call
can compare two trees on one card.

For each cell: the first batch checked against numpy, its launches and the
path its plan took, the batch's q/s by the reference's statistic, the
sequential q/s, one batch's host split and the device's busy share with its
top kernels (``chip_smoke.run_batch_cell``); then ``--reps`` more readings
of the batched q/s (each the q/s of 3 batches), printed sorted with their
median.

    python3 batch_times.py [--tree DIR] [--reps N]

``DIR`` (default: this script's directory) holds the ``orientdb_tpu_torch``
package to time; it is imported before anything else, and the file it was
loaded from is printed, so a call can time two trees in turns (``--tree
A``, ``--tree B``, ``--tree B``, ``--tree A``). The helpers come from this
script's ``chip_smoke.py``. Prints a JSON object of the readings as its
last line; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
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
    from orientdb_tpu_torch.storage.bigshape import build_person_knows

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"tree {tree} (kernels from {K.__file__}): {card}")

    db, snap = build_person_knows(8_000_000, avg_knows=10, seed=5, geo=True)
    device_graph(snap, db.device)
    torch.cuda.synchronize()
    age = snap.v_columns["age"].values
    want = {
        "BQ1": (cs.Q1, cs.numpy_1hop_count(snap, age > 40, age < 30)),
        "BQ2": (cs.Q2, cs.numpy_2hop_count(snap, age > 40, np.ones(snap.num_vertices, bool), age < 30)),
    }
    readings = {}
    for name, (sql, n) in want.items():
        check = lambda i, rows, n=n: cs._require(rows == [{"n": n}], f"count {rows} != numpy {n}")  # noqa: E731
        cell = cs.BatchCell(name, [sql] * 64, None, check, "shared", warm=[(sql, None)])
        cs.run_batch_cell(torch, K, TE, db, snap, card, cell)

        def run(cell=cell):
            for rs in db.query_batch(cell.sqls, cell.plist):
                rs.to_dicts()
            torch.cuda.synchronize()

        qps = sorted(cs._batch_qps(run, 64, iters=3, reps=1) for _ in range(args.reps))
        readings[name] = qps
        print(f"batch {name}: {args.reps} more readings, q/s batched {[round(q, 1) for q in qps]}, "
              f"median {statistics.median(qps):.1f} [{card}]")
    print(json.dumps({"tree": tree, "kernels": K.__file__, "card": card, "q/s batched": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
