"""Times the bitmap BFS's level-step kernels, K12 ``frontier_advance`` and
K11 ``bitmap_emit``, of one tree of the port on one CUDA card, at the
variable-depth COUNT's bitmap shapes ([8, 2^23]: 8 binding rows over the
2^23-vertex bucket of an 8M-person graph) on synthetic levels made from a
seed: V1-like sparse levels (80, 900 and 9,000 reached vertices a row), an
empty one and a dense one, and TRAVERSE's gated [1, 2^23] level.

    python3 level_step_times.py [--tree DIR]

``DIR`` (default: this script's directory) holds the ``orientdb_tpu_torch``
package to time, so one call can time two trees on one card, in turns
(``--tree A``, ``--tree B``, ``--tree B``, ``--tree A``). Every call of an
in-place kernel gets bitmaps no earlier call has changed. Each kernel's
result is checked against its plain version first. Prints one line a case
and a JSON object of the times (ms) as its last line; exits 1 without a
card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

from chip_smoke import _fresh_ms  # this tree's timing of in-place kernels on fresh copies

C, VB = 8, 1 << 23
REACHED = {"level 1": 80, "level 2": 900, "level 3": 9_000}


def _bitmap(torch, gen, c: int, vb: int, per_row: int):
    bm = torch.zeros((c, vb), dtype=torch.bool, device="cuda")
    cols = torch.randint(0, vb, (c, per_row), generator=gen, device="cuda")
    bm.scatter_(1, cols, True)
    return bm


def _same(torch, got, want, what: str) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if g is not None and not torch.equal(g, w):
            raise SystemExit(f"{what}: the kernel differs from its plain version")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the kernels run only on one", file=sys.stderr)
        return 1
    from orientdb_tpu_torch.ops import csr as K

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    folds = "node" in inspect.signature(K.frontier_advance).parameters
    print(f"tree {tree}: {card}; K12 folds the emission count: {folds}")
    gen = torch.Generator(device="cuda").manual_seed(13)
    node = torch.rand(VB, generator=gen, device="cuda") < 0.2  # V1's age < 30 admits ~a fifth
    roots = _bitmap(torch, gen, C, VB, 1)
    levels = {name: _bitmap(torch, gen, C, VB, n) for name, n in REACHED.items()}
    levels["empty level"] = torch.zeros((C, VB), dtype=torch.bool, device="cuda")
    levels["dense level"] = torch.ones((C, VB), dtype=torch.bool, device="cuda")
    visited = roots.clone()
    bound = torch.tensor([-2, 0, VB - 1, 5, 77, -2, 1 << 20, VB - 2], dtype=torch.int32, device="cuda")
    times = {}
    step = lambda n, v: K.frontier_advance(n, v)  # noqa: E731
    for name, nxt in levels.items():
        n1, v1, n2, v2 = nxt.clone(), visited.clone(), nxt.clone(), visited.clone()
        _same(torch, (n1, v1, step(n1, v1)), (n2, v2, K.plain_frontier_advance(n2, v2)), "frontier_advance")
        eager = _fresh_ms(torch, step, (nxt, visited))
        graph = _fresh_ms(torch, step, (nxt, visited), graph=True)
        times[f"K12 {name}"] = [eager, graph]
        print(f"K12 {name}: {eager:.4f} ms eager, {graph:.4f} in a graph")
        if name != "dense level":
            visited = visited | nxt
    lvl2, seen2 = levels["level 2"], roots | levels["level 1"]
    if folds:
        fold = lambda n, v: K.frontier_advance(n, v, node=node)  # noqa: E731
        n1, v1, n2, v2 = lvl2.clone(), seen2.clone(), lvl2.clone(), seen2.clone()
        _same(torch, (n1, v1, *fold(n1, v1)), (n2, v2, *K.plain_frontier_advance(n2, v2, None, node)), "folded")
        times["K12 level 2, folded count"] = [_fresh_ms(torch, fold, (lvl2, seen2)),
                                              _fresh_ms(torch, fold, (lvl2, seen2), graph=True)]
        print(f"K12 level 2 with the folded count: {times['K12 level 2, folded count']}")
    one, one_vis = _bitmap(torch, gen, 1, VB, 1_000), _bitmap(torch, gen, 1, VB, 100)
    gate = torch.rand(VB, generator=gen, device="cuda") < 0.8
    gated = lambda n, v: K.frontier_advance(n, v, gate)  # noqa: E731
    times["K12 gated [1, 2^23]"] = [_fresh_ms(torch, gated, (one, one_vis)),
                                    _fresh_ms(torch, gated, (one, one_vis), graph=True)]
    print(f"K12 gated [1, 2^23]: {times['K12 gated [1, 2^23]']}")
    for name, reached, b, flags in (
        ("count-only, depth 0", roots, None, (False, False, True)),
        ("count-only, level 2", lvl2, None, (False, False, True)),
        ("emit + count, level 2", lvl2, None, (True, False, True)),
        ("any-only, level 2", lvl2, None, (False, True, False)),
        ("close-arm count, level 2", lvl2, bound, (False, False, True)),
    ):
        fn = lambda r, b=b, f=flags: K.bitmap_emit(r, node, b, *f)  # noqa: E731
        _same(torch, fn(reached), K.plain_bitmap_emit(reached, node, b, *flags), "bitmap_emit")
        times[f"K11 {name}"] = [_fresh_ms(torch, fn, (reached,)), _fresh_ms(torch, fn, (reached,), graph=True)]
        print(f"K11 {name}: {times[f'K11 {name}'][0]:.4f} ms eager, {times[f'K11 {name}'][1]:.4f} in a graph")
    print(json.dumps({"tree": tree, "card": card, "folds": folds, "ms [eager, graph]": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
