"""Times kernels of one tree of the port on one CUDA card, on synthetic
inputs made from a seed at the main path's shapes, so that one call can
compare two trees on one card:

- the bitmap BFS's level-step kernels, K12 ``frontier_advance`` and K11
  ``bitmap_emit``, at the variable-depth COUNT's bitmap shapes ([8, 2^23]:
  8 binding rows over the 2^23-vertex bucket of an 8M-person graph):
  V1-like sparse levels (80, 900 and 9,000 reached vertices a row), an
  empty one and a dense one, and TRAVERSE's gated [1, 2^23] level;
- K4 ``indptr_segment_sum`` (int32 and float32) at A's shape (Poisson(10)
  degrees over 8M segments, ~80M values, into 2^23) and E1's (the same
  8M Person segments then 16M empty Message ones, into 2^25);
- K15 ``predicate_eval`` on the masks the main path runs, each compiled by
  the tree's own compiler: Q1's node mask p (the class lookup and ``age >
  40`` over 2^23 slots, 8M valid), M1's (the class lookup and an ID
  compare), G1's (``distance(lat, lng, :x, :y) < :r``), and E1's edge mask
  (``creationDate > :d`` over 80M edge slots);
- K5: ``take_pad`` in its three dtypes at A's weight pass (80M random
  endpoints into 2^23 values), ``mask_count`` at 2^23 bytes and at V1's
  8-byte chunk, and the COUNT pushdown's weight pass at Q1's step (the
  vertex mask alone), Q2's first (mask and weights), an out walk with an
  edge mask and an in walk (the edge mask through a random edge-id
  permutation), the last two steps also with every vertex kept: the
  fused ``weight_gather`` where the tree has it, the mask folded into the
  weights first where the tree folds, and always the five calls the
  earlier tree made (two bool and one int32 ``take_pad``, ``&``, ``.to``,
  ``*``), on the tree's own ``take_pad``;
- K2 and K2b, the one-hop expansion, at Q3's second hop on an A-shaped CSR
  (8M Poisson(10) vertices, 80M random targets; the in walk over the
  matching in-CSR, its edge ids through ``edge_id_in``), at Q3's second hop
  for k = 50,000 (the first chunk, as the engine splits it) and on a Zipf
  frontier (`chip_smoke.zipf_indptr`'s CSR, every vertex a source, a third
  of them -1): K2a ``degree_counts``, K1's sum and its offsets + total of
  the counts, K2b ``gather_expand``, the in walk's ``take_pad`` over
  ``edge_id_in``, and the whole hop as the parent launched it; where the
  tree has them, the degree scan (``expand_offsets``), the gather with the
  edge map inside it and the hop as this tree launches it;
- ``hops``: the mesh hop (K10's eid form) and the tier hop (K19) as the
  tree has them. The mesh hop on an A-shaped graph split four ways (8M
  Poisson(10) vertices, 80M random targets, R = 2,000,000) at [8, 2^23],
  out at MV1's level-1 and level-2 frontiers (10 and 110 random vertices
  a row) and a dense one, and in at level 1: the push over the row-sharded
  CSR (``bitmap_hop_shard``) where the tree has it, else the slot walk
  over the edge-list slices (``bitmap_hop_eid``). K19 over that graph's
  out partition paged as configuration T pages it (blocks of 65,536 edges,
  213 pages of Wp slots resident: the frontier's blocks and the highest
  degrees), at T3's frontier (8 rows of 10 vertices and vertex 0, a 0.9
  WHILE gate) and a dense one: ``paged_hop_csr`` where the tree has it,
  else the slot walk ``paged_hop``. Each beside its bound as the push
  reckons it (the frontier read and the result written, 8 bytes of indptr
  an active vertex, 4 of nbr an active edge; K19 also 12 of blockv,
  pageof and estart and 1 of gate an active vertex).
- ``k17``: K17 ``slab_scan`` at W4's shape (a 2^19-slot window, 147,472
  used slots, 3 % tombstoned, 2,048 rows of which 2,000 random sources,
  the first an overflowed person with 24 slab slots), and with that person
  owning 4,096 slots on 64 rows; beside its byte bound (the sources, the
  window's active endpoints and liveness, the emitted endpoint at each hit
  kept, the output) and its launches a call.
- ``k24``: K24 ``rowshard_hop`` on the A-shaped graph split four ways
  ([4, 4, 2,000,000]): MBFS's first hop (one replica block's 4 roots), its
  second (after one ``frontier_advance``), every query lit on one row, 33
  queries over 330 random rows, and a dense frontier; beside its bound
  (the frontier read and the result written, 8 bytes of indptr a lit row,
  4 of dst a lit edge).
- ``k23``: K23 ``shard_weight_pass`` at MQ2's pass on an A-shaped graph
  split four ways (`chip_smoke.sharded_graph`: 8M Poisson(10) vertices,
  80M random targets, R = 2,000,000; a vertex mask admitting a fifth of
  the vertices, int32 weights), MQ2's second pass (every vertex kept),
  MQ1's form (``w`` None) and in passes without and with an edge mask
  read through ``:in:eid``: through the tree's ``shard_weight_pass`` (the
  row-sharded CSR where the tree walks it, else the edge-list slices as
  the tree's engine calls them); beside the byte bound and the random
  sectors' time.
- ``k20``: K19 ``paged_hop_csr`` over ``hops``' T pool at T3's frontier,
  at T3's frontier plus one vertex in a cold block, and dense: alone, and
  as a tiered replay hop of the tree runs it (where the tree folds the
  cold-miss flag into K19, the push with its flag; else K20
  ``paged_hop_miss``, its memset and the OR into the overflow flag, then
  K19).
- ``slabhop``: the slab's part of a dirty out hop on an A-shaped graph
  armed as phase 8 of ``chip_smoke.py`` leaves it after W3 (8,065,536
  vertices, vb = 2^23; a slab of 1,048,576 slots holding 131,072 edges,
  16,384 of them out of new vertices, indexed in 2^18 buckets of 8; 4,096
  slab and 5,000 base edges tombstoned), at C = 8 (10 random vertices
  and the sources of 64 random live slab edges a row) and dense: the
  tree's dirty hop as its engine runs it (K10's push with the slab probe
  where the tree has it, else the CSR push and the edge-list form over
  the window ORed in), beside the CSR push alone and the bounds. Times
  at the sparse shape (and K21's) also with 50 calls in one graph, which
  spreads the graph's own launch over them.
- ``k21``: K21 ``paged_expand`` over ``hops``' T pool (blocks of 65,536
  edges, 213 pages), at T1c's 1,031 sources and on a skewed frontier
  (4,096 Zipf(1.3) ranks of the vertices by degree, a sixteenth -1), and
  over K2's Zipf-degree CSR paged the same way (every vertex a source, a
  third -1):
  alone, and as a tiered replay runs it (this tree: the gather storing
  into the replay's shared miss byte; a tree without the ``flag``
  argument: the gather with its own zeroed byte and the OR into the
  overflow flag).
- ``k10``: K10's CSR form ``bitmap_hop_csr`` (the variable-depth arm's
  hop) on an A-shaped graph (8M Poisson(10) vertices, 80M random targets)
  at [8, 2^23]: out at V1's level-1 and level-2 frontiers (10 and 110
  random vertices a row), with a 0.8 WHILE gate, in at level 1 (the
  in-CSR, an edge mask read through its edge ids), and dense; then, where
  the tree has them, the lane forms of K10, K11 and K12 over 8 lanes of
  those rows stacked as [8, 8, 2^23] (a lane-stacked gate and node mask)
  beside 8 single launches on the same rows.
- ``singles_ab`` (not in the default set; needs ``--against DIR``): the
  single K11 (five V1 cases), K12 (level 2 with the folded count) and K10
  (level 2, out) at [8, 2^23], ``--tree``'s library and ``DIR``'s loaded
  side by side in one process and called through their C entry points on
  the same inputs, in a graph, the two trees in turns for ``--rounds``
  rounds (default 30): medians, their ratio and the spread of the paired
  ratios; then the SASS of both libraries' bitmap kernels (``cuobjdump``:
  instruction counts and an opcode digest a function; the opcodes into
  ``chiprun_out/singles_ab_sass.json``).
- ``replays`` (not in the default set: it builds A, ~1-2 min of host
  work): MQ1 and MQ2 on A split four ways, T3 (16 roots, the second pass
  timed) and T4 (TR1) on A tiered at half its adjacency bytes, through
  the tree's ``db.query``: replay medians and launches per replay.
- ``dtreplays`` (not in the default set: it builds A, ~3 min of host
  work): V1 on A armed for deltas after chip_smoke's W1–W3, and T1 (64
  roots), T2 (k = 100) and T3 (16 roots) on A tiered, through the tree's
  ``db.query``: replay medians and launches per replay.

    python3 level_step_times.py [--tree DIR] [--only level,k10,k4,k15,k5,k2,hops,k17,k24,k23,k20,slabhop,k21,replays,dtreplays,singles_ab] [--against DIR] [--rounds N]

``DIR`` (default: this script's directory) holds the ``orientdb_tpu_torch``
package to time; it is imported before anything else, and the file it was
loaded from is printed, so a call can time two trees in turns (``--tree
A``, ``--tree B``, ``--tree B``, ``--tree A``). The timing helpers come from
this script's ``chip_smoke.py``. Every call of an in-place kernel gets
bitmaps no earlier call has changed. Each kernel's result is checked
against its plain version first. Prints one line a case and a JSON object
of the times (ms, [eager, in a captured graph]) as its last line; exits 1
without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
C, VB = 8, 1 << 23
REACHED = {"level 1": 80, "level 2": 900, "level 3": 9_000}
PERSONS, MESSAGES, EDGES = 8_000_000, 16_000_000, 80_000_000


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


def level_steps(torch, K, cs, times) -> None:
    """K12 and K11 at V1's bitmap shapes."""
    _fresh_ms = cs._fresh_ms
    folds = "node" in inspect.signature(K.frontier_advance).parameters
    print(f"K12 folds the emission count: {folds}")
    gen = torch.Generator(device="cuda").manual_seed(13)
    node = torch.rand(VB, generator=gen, device="cuda") < 0.2  # V1's age < 30 admits ~a fifth
    roots = _bitmap(torch, gen, C, VB, 1)
    levels = {name: _bitmap(torch, gen, C, VB, n) for name, n in REACHED.items()}
    levels["empty level"] = torch.zeros((C, VB), dtype=torch.bool, device="cuda")
    levels["dense level"] = torch.ones((C, VB), dtype=torch.bool, device="cuda")
    visited = roots.clone()
    bound = torch.tensor([-2, 0, VB - 1, 5, 77, -2, 1 << 20, VB - 2], dtype=torch.int32, device="cuda")
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


def _poisson_indptr(np, torch, rng, empty_after: int):
    """Poisson(10) degrees over 8M segments, then ``empty_after`` empty ones."""
    deg = np.concatenate([rng.poisson(10, PERSONS), np.zeros(empty_after, np.int64)])
    return torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)).cuda()


def segment_sums(np, torch, K, cs, times) -> None:
    """K4 at A's and E1's shapes, int32 and float32, beside its bound."""
    rng = np.random.default_rng(17)
    gen = torch.Generator(device="cuda").manual_seed(17)
    for shape, empty, out_size in (("A", 0, 1 << 23), ("E1", MESSAGES, 1 << 25)):
        indptr = _poisson_indptr(np, torch, rng, empty)
        ne = int(indptr[-1])
        contrib = torch.rand(ne, generator=gen, device="cuda") < 0.2
        nseg = indptr.shape[0] - 1
        bound = (4.0 * ne + 4.0 * (nseg + 1) + 4.0 * out_size) / cs.HBM_BYTES_PER_S * 1e3
        for dtype in (torch.int32, torch.float32):
            vals = contrib.to(dtype)
            got = K.indptr_segment_sum(vals, indptr, out_size)
            want = K.plain_indptr_segment_sum(vals, indptr, out_size)
            if dtype == torch.int32:
                _same(torch, got, want, "indptr_segment_sum")
            elif float((got.double() - want.double()).abs().max()) > 1e-6 * max(float(want.abs().max()), 1.0):
                raise SystemExit("indptr_segment_sum float32 differs from its plain version")
            fn = lambda v=vals: K.indptr_segment_sum(v, indptr, out_size)  # noqa: E731
            key = f"K4 {shape} {str(dtype).split('.')[-1]}"
            times[key] = [cs._time_ms(torch, fn), cs._graph_ms(torch, fn)]
            print(f"{key} ({ne} values, {nseg} segments into {out_size}): {times[key][0]:.4f} ms eager, "
                  f"{times[key][1]:.4f} in a graph; bound {bound:.4f}")
        if shape == "A":
            print(f"K4 A int32 kernels: {profile(torch, cs, lambda: K.indptr_segment_sum(contrib.to(torch.int32), indptr, out_size))}")


def profile(torch, cs, run) -> str:
    """Device ms of each kernel in one profiled call of ``run``."""
    events, _ = cs._profiled(torch, run)
    rows = [e for e in events if cs._device_us(e) > 0]
    name = lambda e: e.key.replace("void (anonymous namespace)::", "")[:48]  # noqa: E731
    return ", ".join(f"{name(e)} {cs._device_us(e) / 1e3:.4f} ms x{e.count}" for e in rows) or "not measured"


def _snapshot(np, n: int, cols):
    """``n`` vertices of one class ("Person") with the columns ``cols``:
    name → (kind, values); about 2 % of each column absent."""
    from orientdb_tpu_torch.storage.snapshot import GraphSnapshot, PropertyColumn

    rng = np.random.default_rng(23)
    snap = GraphSnapshot()
    snap.num_vertices = n
    snap.class_names = ["Person"]
    snap.class_id_of = {"person": 0}
    snap.class_closure = {"person": np.array([0], np.int32)}
    snap.v_class = np.zeros(n, np.int32)
    for name, (kind, vals) in cols.items():
        snap.v_columns[name] = PropertyColumn(name, kind, vals, rng.random(n) >= 0.02, None)
    return snap


def predicate_masks(np, torch, K, cs, times) -> None:
    """K15 on Q1's, M1's, G1's and E1's masks, as each tree compiles them."""
    from orientdb_tpu_torch.ops.device_graph import DeviceGraph
    from orientdb_tpu_torch.ops.predicates import (
        ColumnScope, ParamBox, Predicate, class_term, compile_where, id_term, valid_term,
    )
    from orientdb_tpu_torch.sql.parser import parse

    dev = torch.device("cuda")
    rng = np.random.default_rng(29)
    snap = _snapshot(np, PERSONS, {
        "age": ("int", rng.integers(0, 100, PERSONS, dtype=np.int32)),
        "lat": ("float", rng.uniform(-85, 85, PERSONS).astype(np.float32)),
        "lng": ("float", rng.uniform(-180, 180, PERSONS).astype(np.float32)),
    })
    dg = DeviceGraph(snap, dev)
    edges = _snapshot(np, EDGES, {"creationDate": ("int", rng.integers(0, 20_000, EDGES, dtype=np.int32))})
    eg = DeviceGraph(edges, dev)

    def where(g, text, box):
        scope = ColumnScope(g.columns, g.non_columnar, device=dev)
        return compile_where(parse(f"SELECT FROM V WHERE {text}").where, scope, box)

    person = lambda: class_term(dg.v_class, dg.class_table("Person"))  # noqa: E731
    g1_box = ParamBox({"x": 48.0, "y": 2.0, "r": 2500.0})
    e1_box = ParamBox({"d": 12_000})
    vb = 1 << 23
    cases = (
        # name, predicate, slots, valid slots, bytes a valid slot must move
        ("Q1 mask p", Predicate([valid_term(), person(), where(dg, "age > 40", {})], dev), vb, PERSONS, 9.0),
        ("M1 ID mask", Predicate([valid_term(), person(), id_term(123_457)], dev), vb, PERSONS, 0.0),
        ("G1 mask", Predicate([valid_term(), person(), where(dg, "distance(lat, lng, :x, :y) < :r", g1_box)],
                              dev, g1_box), vb, PERSONS, 14.0),
        ("E1 edge mask", Predicate([valid_term(), where(eg, "creationDate > :d", e1_box)], dev, e1_box),
         EDGES, EDGES, 5.0),
    )
    for name, pred, n, n_valid, per_slot in cases:
        row = None
        if pred.uses_params:  # uploaded once, as a replay's static row
            row = pred.box.row(dev)
            pred.box.set_row(row)
        tmps = []
        for prog in pred.programs:
            bufs = prog.buffers({}, tmps, n)
            last = prog is pred.programs[-1]
            got = K.predicate_eval(prog.prog, bufs, None, n, n_valid, 0, 0, row, values=not last)
            want = K.plain_predicate_eval(prog.prog, bufs, None, n, n_valid, 0, 0, row, values=not last)
            if "distance" not in name:
                _same(torch, got, want, f"predicate_eval ({name})")
            tmps.append(got)
        fn = lambda p=pred, n=n, v=n_valid: p.identity(n, v)  # noqa: E731
        times[f"K15 {name}"] = [cs._time_ms(torch, fn), cs._graph_ms(torch, fn)]
        bound = (per_slot * n_valid + n) / cs.HBM_BYTES_PER_S * 1e3
        rows = sum(len(p.prog.rows) for p in pred.programs)
        print(f"K15 {name} ({rows} instructions, {n} slots): {times[f'K15 {name}'][0]:.4f} ms eager, "
              f"{times[f'K15 {name}'][1]:.4f} in a graph; bound {bound:.4f} (bytes)")


def k5(torch, K, cs, times) -> None:
    """take_pad, mask_count and the weight pass at A's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    i32 = torch.int32
    dst = torch.randint(0, PERSONS, (EDGES,), generator=gen, device="cuda", dtype=i32)
    w = torch.randint(0, 50, (VB,), generator=gen, device="cuda", dtype=i32)
    ok = torch.rand(VB, generator=gen, device="cuda") < 0.3
    for name, vals, fill in (("i32", w, 0), ("f32", w.to(torch.float32), 0.0), ("b8", ok, False)):
        fn = lambda v=vals, f=fill: K.take_pad(v, dst, f)  # noqa: E731
        _same(torch, fn(), K.plain_take_pad(vals, dst, fill), f"take_pad {name}")
        lib = lambda v=vals: torch.index_select(v, 0, dst)  # noqa: E731
        times[f"K5 take_pad {name}"] = [cs._time_ms(torch, fn), cs._graph_ms(torch, fn)]
        times[f"K5 index_select {name}"] = [cs._time_ms(torch, lib), cs._graph_ms(torch, lib)]
        print(f"K5 take_pad {name} ({EDGES} into {VB}): {times[f'K5 take_pad {name}']}, "
              f"index_select {times[f'K5 index_select {name}']}")
    for what, mask in (("2^23", ok), ("V1's chunk", ok[:8].clone())):
        fn = lambda m=mask: K.mask_count(m)  # noqa: E731
        _same(torch, fn(), K.plain_mask_count(mask), "mask_count")
        times[f"K5 mask_count {what}"] = [cs._time_ms(torch, fn), cs._graph_ms(torch, fn)]
        print(f"K5 mask_count {what}: {times[f'K5 mask_count {what}']}")
    src = torch.randint(0, PERSONS, (EDGES,), generator=gen, device="cuda", dtype=i32)
    eid = torch.randperm(EDGES, generator=gen, device="cuda").to(i32)
    emask = torch.rand(EDGES, generator=gen, device="cuda") < 0.7
    every = torch.zeros(VB, dtype=torch.bool, device="cuda")
    every[:PERSONS] = True  # a hop to an unfiltered alias: every vertex kept
    fused = hasattr(K, "weight_gather")
    folds = hasattr(K, "L2_KEEP_BYTES")  # the tree folds a vertex mask into weights
    for what, emit, kw in (
        ("Q1's step", dst, dict(ok=ok)),
        ("Q2's first step", dst, dict(ok=ok, w=w)),
        ("Q2's first step, every vertex kept", dst, dict(ok=every, w=w)),
        ("an out walk with an edge mask", dst, dict(ok=ok, emask=emask, w=w)),
        ("an in walk", src, dict(ok=ok, emask=emask, eid=eid, w=w)),
        ("an in walk, every vertex kept", src, dict(ok=every, emask=emask, eid=eid, w=w)),
    ):
        calls = lambda e=emit, kw=kw: cs.five_call_weights(  # noqa: E731
            K, e, i32, kw["ok"], None, kw.get("emask"), kw.get("eid"), kw.get("w"))
        times[f"K5 weights {what}, five calls"] = [cs._time_ms(torch, calls), cs._graph_ms(torch, calls)]
        line = f"K5 weights {what}: five calls {times[f'K5 weights {what}, five calls']}"
        if fused:
            fn = lambda e=emit, kw=kw: K.weight_gather(e, i32, **kw)  # noqa: E731
            _same(torch, fn(), calls(), f"weight_gather ({what})")
            times[f"K5 weights {what}, fused"] = [cs._time_ms(torch, fn), cs._graph_ms(torch, fn)]
            line += f", fused {times[f'K5 weights {what}, fused']}"
        if folds and "w" in kw:
            # the vertex mask folded into the weights over [vb] first (one
            # pass), then one gather an edge
            rest = {k: v for k, v in kw.items() if k not in ("ok", "w")}
            fold = lambda e=emit, kw=kw, rest=rest: K.weight_gather(  # noqa: E731
                e, i32, w=K.weight_gather(None, i32, ok=kw["ok"], w=kw["w"]), **rest)
            _same(torch, fold(), calls(), f"weight_gather folded ({what})")
            times[f"K5 weights {what}, folded"] = [cs._time_ms(torch, fold), cs._graph_ms(torch, fold)]
            line += f", folded {times[f'K5 weights {what}, folded']}"
        print(line)


def k2(np, torch, K, cs, times) -> None:
    """K2 and K2b at Q3's shapes and on a Zipf frontier (module docstring)."""
    from orientdb_tpu_torch.exec.tpu_engine import _cap_of
    from orientdb_tpu_torch.utils.config import config

    i32 = torch.int32
    rng = np.random.default_rng(19)
    gen = torch.Generator(device="cuda").manual_seed(19)
    indptr = _poisson_indptr(np, torch, rng, 0)
    ne = int(indptr[-1])
    dst = torch.randint(0, PERSONS, (ne,), generator=gen, device="cuda", dtype=i32)
    # the in-CSR: the edges in a stable order of their targets
    order = torch.sort(dst, stable=True).indices
    edge_src = torch.repeat_interleave(torch.arange(PERSONS, dtype=i32, device="cuda"), (indptr[1:] - indptr[:-1]).long())
    src_in = edge_src[order]
    indptr_in = torch.cat([torch.zeros(1, dtype=torch.long, device="cuda"),
                           torch.cumsum(torch.bincount(dst.long(), minlength=PERSONS), 0)]).to(i32)
    eid_in = order.to(i32)
    del order, edge_src

    def frontier(k):
        f = dst[: int(indptr[k])]
        width = _cap_of(f.shape[0])
        return torch.cat([f, torch.full((width - f.shape[0],), -1, dtype=i32, device="cuda")])

    q3, big = frontier(2000), frontier(50_000)
    big_total = int(K.value_sum(K.degree_counts(indptr, big)))
    chunks = max(1, -(-_cap_of(big_total) // max(1, config.max_expansion_cap)))
    chunk = big[: -(-big.shape[0] // chunks)]
    zip_ip, zrng = cs.zipf_indptr(np, torch, "cuda")
    zv, ze = zip_ip.shape[0] - 1, int(zip_ip[-1])
    zip_nbrs = torch.randint(0, zv, (ze,), generator=gen, device="cuda", dtype=i32)
    zip_map = torch.randperm(ze, generator=gen, device="cuda").to(i32)
    zip_srcs = torch.arange(zv, dtype=i32, device="cuda")
    zip_srcs[torch.from_numpy(zrng.random(zv) < 1 / 3).cuda()] = -1
    scans = hasattr(K, "expand_offsets")
    print(f"K2 the tree has the degree scan and the mapped gather: {scans}")
    for shape, ip, nb, s, emap in (
        ("Q3", indptr, dst, q3, None),
        ("Q3 in", indptr_in, src_in, q3, eid_in),
        (f"k=50,000 chunk 1 of {chunks}", indptr, dst, chunk, None),
        (f"k=50,000 chunk 1 of {chunks} in", indptr_in, src_in, chunk, eid_in),
        ("Zipf", zip_ip, zip_nbrs, zip_srcs, zip_map),
    ):
        counts = K.degree_counts(ip, s)
        offsets, total = K.exclusive_cumsum_total(counts)
        size = _cap_of(int(total))
        got = K.gather_expand(ip, nb, s, offsets, total, size)
        _same(torch, got, K.plain_gather_expand(ip, nb, s, offsets, total, size), f"gather_expand ({shape})")
        pos = got[1]
        fns = {
            "K2a degree_counts": lambda ip=ip, s=s: K.degree_counts(ip, s),
            "K1 sum": lambda c=counts: K.value_sum(c),
            "K1 offsets + total": lambda c=counts: K.exclusive_cumsum_total(c),
            "K2b gather_expand": lambda a=(ip, nb, s, offsets, total, size): K.gather_expand(*a),
        }
        if emap is not None:
            fns["K5 take_pad edge_id_in"] = lambda m=emap, p=pos: K.take_pad(m, p, -1)
        fns["hop, the parent's launches"] = lambda a=(K, ip, nb, s, size, emap): cs.earlier_hop(*a)
        if scans:
            _same(torch, K.expand_offsets(ip, s), K.plain_expand_offsets(ip, s), f"expand_offsets ({shape})")
            fns["K2 degree_scan_i32"] = lambda ip=ip, s=s: K.expand_offsets(ip, s)
            if emap is not None:
                a = (ip, nb, s, offsets, total, size, emap)
                _same(torch, K.gather_expand(*a), K.plain_gather_expand(*a), f"gather_expand mapped ({shape})")
                fns["K2b gather_expand mapped"] = lambda a=a: K.gather_expand(*a)
            fns["hop, this tree's launches"] = lambda a=(K, ip, nb, s, size, emap): cs.one_hop(*a)
        live = int((s >= 0).sum())
        b_scan, b_gather = cs.expand_bounds(s.shape[0], live, int(total), size, emap is not None)
        line = []
        for name, fn in fns.items():
            times[f"{name}, {shape}"] = [cs._time_ms(torch, fn), cs._graph_ms(torch, fn)]
            line.append(f"{name} {times[f'{name}, {shape}'][0]:.4f} / {times[f'{name}, {shape}'][1]:.4f}")
        print(f"K2 {shape} ({s.shape[0]} sources, {live} live, {int(total)} slots into {size}), ms eager / in a "
              f"graph: {'; '.join(line)}; bounds: degree scan {b_scan:.4f}, gather {b_gather:.4f}")


def _shard(torch, ip, nbr, extra, s: int, r: int, emax: int):
    """Shard s's rebased indptr row, its -1 padded slots of ``nbr`` (and of
    ``extra``, the in CSR's edge ids) and its first edge."""
    a, b = int(ip[s * r]), int(ip[(s + 1) * r])
    row = ip[s * r : (s + 1) * r + 1] - a
    pad = lambda t: torch.cat([t[a:b], torch.full((emax - (b - a),), -1, dtype=t.dtype, device="cuda")])  # noqa: E731
    return row, pad(nbr), None if extra is None else pad(extra), a


def _a_graph(np, torch, seed: int):
    """An A-shaped CSR on the card (8M Poisson(10) vertices, 80M random
    targets): indptr, dst, the degrees and each edge's source."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    indptr = _poisson_indptr(np, torch, rng, 0)
    ne = int(indptr[-1])
    dst = torch.randint(0, PERSONS, (ne,), generator=gen, device="cuda", dtype=torch.int32)
    deg = (indptr[1:] - indptr[:-1]).long()
    edge_src = torch.repeat_interleave(torch.arange(PERSONS, dtype=torch.int32, device="cuda"), deg)
    return indptr, dst, deg, edge_src, gen


def k10(np, torch, K, cs, times) -> None:
    """K10's CSR form at V1's shapes, and the bitmap lane forms where the
    tree has them (module docstring)."""
    i32, B = torch.int32, 8
    indptr, dst, _deg, edge_src, gen = _a_graph(np, torch, 41)
    order = torch.sort(dst, stable=True).indices
    indptr_in = torch.cat([torch.zeros(1, dtype=torch.long, device="cuda"),
                           torch.cumsum(torch.bincount(dst.long(), minlength=PERSONS), 0)]).to(i32)
    src_in, eid_in = edge_src[order], order.to(i32)
    del order
    emask = torch.rand(dst.shape[0], generator=gen, device="cuda") < 0.7
    gate = torch.rand(VB, generator=gen, device="cuda") < 0.8
    csr = {"out": (indptr, dst, None), "in": (indptr_in, src_in, eid_in)}
    frs = {}
    for name, d, per_row, m, g in (("level 1", "out", 10, None, None), ("level 2", "out", 110, None, None),
                                   ("level 2 gated", "out", 110, None, gate), ("level 1 in", "in", 10, emask, None),
                                   ("dense", "out", 0, None, None)):
        f = torch.ones((C, VB), dtype=torch.bool, device="cuda") if not per_row else _bitmap(torch, gen, C, VB, per_row)
        f[:, PERSONS:] = False
        frs[name] = f
        alive = K.mask_count(f.view(-1))
        fn = lambda d=d, f=f, m=m, g=g, alive=alive: K.bitmap_hop_csr(*csr[d], m, f, g, alive)  # noqa: E731
        if per_row:
            _same(torch, fn(), K.plain_bitmap_hop_csr(*csr[d], m, f, g, alive), f"bitmap_hop_csr ({name})")
        nbytes, n_act, n_edges = cs.csr_hop_bytes(torch, csr[d][0], f, g, m is not None, d == "in")
        key = f"K10 {name}"
        times[key] = [cs._time_ms(torch, fn), cs._graph_ms(torch, fn)]
        print(f"{key} ({n_act} active vertices, {n_edges} edges): {times[key][0]:.4f} ms eager, "
              f"{times[key][1]:.4f} in a graph; bound {nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f}")
    if not hasattr(K, "bitmap_hop_csr_lanes"):
        print("k10: the tree has no bitmap lane forms")
        return
    # 8 lanes of V1's level-2 rows (each lane its own frontier) stacked as
    # [8, 8, 2^23], a gate and a node mask a lane
    fr = torch.stack([_bitmap(torch, gen, C, VB, 110) for _ in range(B)])
    fr[:, :, PERSONS:] = False
    alive = K.mask_count_lanes(fr.view(B, -1))
    gates = torch.rand((B, VB), generator=gen, device="cuda") < 0.8
    node = torch.rand((B, VB), generator=gen, device="cuda") < 0.2
    lanes = lambda: K.bitmap_hop_csr_lanes(*csr["out"], None, fr, gates, alive)  # noqa: E731
    singles = lambda: [K.bitmap_hop_csr(*csr["out"], None, fr[b], gates[b], alive[b]) for b in range(B)]  # noqa: E731
    _same(torch, lanes(), K.plain_bitmap_hop_csr_lanes(*csr["out"], None, fr, gates, alive), "bitmap_hop_csr_lanes")
    times["K10 lanes [64, 2^23]"] = [cs._time_ms(torch, lanes), cs._graph_ms(torch, lanes)]
    times["K10 8 singles [8, 2^23]"] = [cs._time_ms(torch, singles), cs._graph_ms(torch, singles)]
    nxt = lanes()
    emit = lambda r: K.bitmap_emit_lanes(r, node, None, True, False, True)  # noqa: E731
    _same(torch, emit(nxt), K.plain_bitmap_emit_lanes(nxt, node, None, True, False, True), "bitmap_emit_lanes")
    emit1 = lambda r: [K.bitmap_emit(r[b], node[b], None, True, False, True) for b in range(B)]  # noqa: E731
    times["K11 lanes emit + count"] = [cs._time_ms(torch, lambda: emit(nxt)), cs._graph_ms(torch, lambda: emit(nxt))]
    times["K11 8 singles emit + count"] = [cs._time_ms(torch, lambda: emit1(nxt)), cs._graph_ms(torch, lambda: emit1(nxt))]
    step = lambda n, v: K.frontier_advance_lanes(n, v)  # noqa: E731
    step1 = lambda n, v: [K.frontier_advance(n[b], v[b]) for b in range(B)]  # noqa: E731
    n1, v1, n2, v2 = nxt.clone(), fr.clone(), nxt.clone(), fr.clone()
    _same(torch, (n1, v1, step(n1, v1)), (n2, v2, K.plain_frontier_advance_lanes(n2, v2)), "frontier_advance_lanes")
    times["K12 lanes"] = [cs._fresh_ms(torch, step, (nxt, fr), reps=3), cs._fresh_ms(torch, step, (nxt, fr), reps=3, graph=True)]
    times["K12 8 singles"] = [cs._fresh_ms(torch, step1, (nxt, fr), reps=3),
                              cs._fresh_ms(torch, step1, (nxt, fr), reps=3, graph=True)]
    for key in ("K10 lanes [64, 2^23]", "K10 8 singles [8, 2^23]", "K11 lanes emit + count",
                "K11 8 singles emit + count", "K12 lanes", "K12 8 singles"):
        print(f"{key}: {times[key][0]:.4f} ms eager, {times[key][1]:.4f} in a graph")


def _t_pool(torch, K, gen, indptr, dst, deg, edge_src):
    """That graph's out partition paged as configuration T pages it (blocks
    of 65,536 edges, 213 pages resident: T3's footprint and the highest
    degrees), with T3's frontier (8 rows of 10 vertices and vertex 0) and
    its 0.9 WHILE gate. Returns (blockv, pageof, estart, pools, frontier,
    gate, P, Wp, B)."""
    i32, ne, nv = torch.int32, int(indptr[-1]), indptr.shape[0] - 1
    Wb = max(65_536, int(deg.max()))
    Wp = K.bucket(Wb + int(deg.max()), minimum=8)
    q = indptr[:-1].long() // Wb
    _uq, blockv = torch.unique_consecutive(q, return_inverse=True)
    B = int(blockv.max()) + 1
    first_v = torch.searchsorted(blockv, torch.arange(B, device="cuda"))
    estart = torch.cat([indptr[first_v], indptr[-1:]]).to(i32)
    P = min(213, B)
    f = _bitmap(torch, gen, C, VB, 10)
    f[:, nv:] = False
    f[:, 0] = True
    gate = torch.rand(VB, generator=gen, device="cuda") < 0.9
    hot = torch.unique(blockv[(f.any(0) & gate)[:nv]])
    prio = torch.zeros(B, dtype=torch.long, device="cuda").scatter_reduce(0, blockv, deg, "amax")
    prio[hot] = 1 << 40  # T3's footprint is resident when it replays
    resident = torch.argsort(prio, descending=True, stable=True)[:P]
    pageof = torch.full((B,), -1, dtype=torch.long, device="cuda")
    pageof[resident] = torch.arange(P, device="cuda")
    pools = {n: torch.full((P * Wp,), -1, dtype=i32, device="cuda") for n in ("own", "nbr", "eid")}
    eb = blockv[edge_src.long()]
    pg = pageof[eb]
    keep = pg >= 0
    pos = (pg * Wp + torch.arange(ne, device="cuda") - estart[eb].long())[keep]
    for n, vals in (("own", edge_src), ("nbr", dst), ("eid", torch.arange(ne, dtype=i32, device="cuda"))):
        pools[n][pos] = vals[keep]
    pools = {n: t.view(P, Wp) for n, t in pools.items()}
    return blockv.to(i32), pageof.to(i32), estart, pools, f, gate, P, Wp, B


def hops(np, torch, K, cs, times) -> None:
    """The mesh hop and the tier hop (module docstring)."""
    i32, S = torch.int32, 4
    indptr, dst, deg, edge_src, gen = _a_graph(np, torch, 37)
    ne = int(indptr[-1])
    order = torch.sort(dst, stable=True).indices
    indptr_in = torch.cat([torch.zeros(1, dtype=torch.long, device="cuda"),
                           torch.cumsum(torch.bincount(dst.long(), minlength=PERSONS), 0)]).to(i32)
    src_in, eid_in = edge_src[order], order.to(i32)
    del order
    R = PERSONS // S
    push = hasattr(K, "bitmap_hop_shard")
    print(f"hops: the tree has the pushes: {push}")
    if push:
        csr = {}
        for d, ip, nb, ex in (("out", indptr, dst, None), ("in", indptr_in, src_in, eid_in)):
            emax = max(int(ip[(s + 1) * R]) - int(ip[s * R]) for s in range(S))
            parts = [_shard(torch, ip, nb, ex, s, R, emax) for s in range(S)]
            extra = (torch.tensor([[p[3]] for p in parts], dtype=i32, device="cuda") if ex is None
                     else torch.stack([p[2] for p in parts]))
            csr[d] = (torch.stack([p[0] for p in parts]).contiguous(), torch.stack([p[1] for p in parts]), extra, d == "out")
        mesh_hop = lambda d, f: K.bitmap_hop_shard(*csr[d], 0, None, f)  # noqa: E731
    W = -(-ne // S)
    pad = S * W - ne

    def sliced(t):
        return torch.cat([t, torch.full((pad,), -1, dtype=i32, device="cuda")]).view(S, W)

    el = (sliced(edge_src), sliced(dst), sliced(torch.arange(ne, dtype=i32, device="cuda")))
    if not push:
        mesh_hop = lambda d, f: K.bitmap_hop_eid(*((el[0], el[1]) if d == "out" else (el[1], el[0])), el[2], None, f)  # noqa: E731
    bytes_s = cs.HBM_BYTES_PER_S
    ipl, ipl_in = indptr.long(), indptr_in.long()
    for name, d, per_row in (("level 1", "out", 10), ("level 2", "out", 110), ("dense", "out", 0), ("level 1 in", "in", 10)):
        f = torch.ones((C, VB), dtype=torch.bool, device="cuda") if not per_row else _bitmap(torch, gen, C, VB, per_row)
        f[:, PERSONS:] = False
        ip = ipl if d == "out" else ipl_in
        av = f.any(0).nonzero().view(-1)
        act_edges = int((ip[av + 1] - ip[av]).sum())
        a, e = (el[0], el[1]) if d == "out" else (el[1], el[0])
        if per_row:
            want = K.plain_bitmap_hop_eid(a, e, el[2], None, f)
        else:  # every vertex active: every edge's target is reached in every row
            want = torch.zeros((C, VB), dtype=torch.bool, device="cuda")
            want[:, (dst if d == "out" else edge_src).long()] = True
        _same(torch, mesh_hop(d, f), want, f"mesh hop ({name})")
        bound = (2.0 * C * VB + 8.0 * av.shape[0] + 4.0 * act_edges) / bytes_s * 1e3
        fn = lambda d=d, f=f: mesh_hop(d, f)  # noqa: E731
        key = f"mesh hop {name}"
        times[key] = [cs._time_ms(torch, fn), cs._graph_ms(torch, fn)]
        print(f"{key} ({av.shape[0]} active vertices, {act_edges} edges): {times[key][0]:.4f} ms eager, "
              f"{times[key][1]:.4f} in a graph; bound {bound:.4f}")
    del el
    if push:
        del csr
    # K19: the out partition paged as T pages it
    blockv, pageof, estart, pools, f, gate, P, Wp, B = _t_pool(torch, K, gen, indptr, dst, deg, edge_src)
    if hasattr(K, "paged_hop_csr"):
        tier_hop = lambda f, a: K.paged_hop_csr(indptr, blockv, pageof, estart, pools["nbr"], pools["eid"], None, f, gate, a)  # noqa: E731
    else:
        tier_hop = lambda f, a: K.paged_hop(pools["own"], pools["nbr"], pools["eid"], None, f, gate, a)  # noqa: E731
    for name, fr in (("T3's frontier", f), ("dense", torch.ones((C, VB), dtype=torch.bool, device="cuda"))):
        alive = K.mask_count(fr.view(-1))
        if name != "dense":
            want = K.plain_paged_hop(pools["own"], pools["nbr"], pools["eid"], None, fr, gate, alive)
        else:  # every gated owner of a live slot is active in every row
            own, nbr = pools["own"].view(-1), pools["nbr"].view(-1)
            ok = own >= 0
            ok[ok.clone()] = gate[own[ok].long()]
            want = torch.zeros((C, VB), dtype=torch.bool, device="cuda")
            want[:, nbr[ok].long()] = True
        _same(torch, tier_hop(fr, alive), want, f"tier hop ({name})")
        av = (fr.any(0) & gate)[:PERSONS].nonzero().view(-1)
        res = pageof[blockv[av].long()] >= 0
        act_edges = int((ipl[av + 1] - ipl[av])[res].sum())
        bound = ((C + 1.0) * PERSONS + 20.0 * av.shape[0] + 4.0 * act_edges + C * VB) / bytes_s * 1e3
        fn = lambda fr=fr, a=alive: tier_hop(fr, a)  # noqa: E731
        key = f"tier hop {name}"
        times[key] = [cs._time_ms(torch, fn), cs._graph_ms(torch, fn)]
        print(f"{key} ({P} pages of {Wp} slots, B={B}; {av.shape[0]} active vertices, {int(res.sum())} resident, "
              f"{act_edges} edges): {times[key][0]:.4f} ms eager, {times[key][1]:.4f} in a graph; bound {bound:.4f}")


def k17(np, torch, K, cs, times) -> None:
    """K17 at W4's shape (module docstring)."""
    i32, W, R, used = torch.int32, 1 << 19, 2_048, 147_472
    rng = np.random.default_rng(17)
    a = np.full(W, -1, np.int32)
    a[:used] = rng.integers(0, PERSONS + 65_536, used)
    live = np.zeros(W, bool)
    live[:used] = rng.random(used) >= 0.03
    srcs = np.full(R, -1, np.int32)
    srcs[:2_000] = rng.integers(0, PERSONS, 2_000)
    hot = int(srcs[0])
    a[rng.choice(used, 24, replace=False)] = hot  # the overflowed person's slab edges
    e = rng.integers(0, PERSONS, W).astype(np.int32)
    skew = srcs.copy()
    skew[1:65] = hot  # the overflowed person on 64 rows, 4,096 slots of its own
    a_skew = a.copy()
    a_skew[rng.choice(used, 4_096, replace=False)] = hot
    for shape, aa, ss in (("W4", a, srcs), ("W4, 4,096 slots of one source on 64 rows", a_skew, skew)):
        g = [torch.from_numpy(x).cuda() for x in (aa, e, live, ss)]
        total = int(K.plain_slab_scan(*g, 0, lambda t: 8)[3])
        size = max(K.bucket(total), 8)
        fn = lambda g=g, size=size: K.slab_scan(*g, 80_000_000, lambda t: size)  # noqa: E731
        _same(torch, fn(), K.plain_slab_scan(g[0], g[1], g[2], g[3], 80_000_000, lambda t: size), f"slab_scan ({shape})")
        K.reset_launches()
        fn()
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        key = f"K17 slab_scan, {shape}"
        times[key] = [cs._time_ms(torch, fn), cs._graph_ms(torch, fn)]
        nbytes = R * 4.0 + W * 5.0 + min(total, size) * 4.0 + size * 12.0
        print(f"{key} (R={R}, W={W}, {int(live.sum())} live, total {total} into {size}; launches a call "
              f"{launches}): {times[key][0]:.4f} ms eager, {times[key][1]:.4f} in a graph; bound "
              f"{nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f} (bytes; {int((ss >= 0).sum()) * W} compares); "
              f"kernels of one call: {profile(torch, cs, fn)}")


def k24(np, torch, K, cs, times) -> None:
    """K24 at MBFS's shapes (module docstring)."""
    i32, S = torch.int32, 4
    rng = np.random.default_rng(24)
    gen = torch.Generator(device="cuda").manual_seed(24)
    indptr = _poisson_indptr(np, torch, rng, 0)
    ne = int(indptr[-1])
    dst = torch.randint(0, PERSONS, (ne,), generator=gen, device="cuda", dtype=i32)
    R = PERSONS // S
    emax = max(int(indptr[(s + 1) * R]) - int(indptr[s * R]) for s in range(S))
    parts = [_shard(torch, indptr, dst, None, s, R, emax) for s in range(S)]
    ind = torch.stack([p[0] for p in parts]).contiguous()
    dst_sh = torch.stack([p[1] for p in parts]).contiguous()
    del parts
    roots = cs.MBFS_ROOTS[: len(cs.MBFS_ROOTS) // cs.MBFS_REPLICAS]
    Q = len(roots)
    f1 = torch.zeros((S, Q, R), dtype=torch.bool, device="cuda")
    for q, v in enumerate(roots):
        f1[v // R, q, v % R] = True
    f2 = K.rowshard_hop(ind, dst_sh, f1, S)
    K.frontier_advance(f2.view(S * Q, R), f1.clone().view(S * Q, R))
    f33 = torch.zeros((S, 33, R), dtype=torch.bool, device="cuda")
    f33.view(-1)[torch.randint(0, f33.numel(), (330,), generator=gen, device="cuda")] = True
    one = torch.zeros((S, Q, R), dtype=torch.bool, device="cuda")
    one[1, :, 12_345] = True  # every query lit on one row
    dense = torch.ones((S, Q, R), dtype=torch.bool, device="cuda")
    ipl = indptr.long()
    for shape, f in (("MBFS hop 1", f1), ("MBFS hop 2", f2), ("every query on one row", one), ("Q=33", f33),
                     ("dense", dense)):
        if shape != "dense":
            _same(torch, K.rowshard_hop(ind, dst_sh, f, S), K.plain_rowshard_hop(ind, dst_sh, f, S), f"rowshard_hop ({shape})")
        lit = f.any(1).view(-1).nonzero().view(-1)
        lit_edges = int((ipl[lit + 1] - ipl[lit]).sum())
        fn = lambda f=f: K.rowshard_hop(ind, dst_sh, f, S)  # noqa: E731
        key = f"K24 rowshard_hop, {shape}"
        times[key] = [cs._time_ms(torch, fn), cs._graph_ms(torch, fn)]
        bound = (2.0 * f.numel() + 8.0 * lit.shape[0] + 4.0 * lit_edges) / cs.HBM_BYTES_PER_S * 1e3
        print(f"{key} ([{S}, {f.shape[1]}, {R}], {lit.shape[0]} lit rows, {lit_edges} edges): {times[key][0]:.4f} "
              f"ms eager, {times[key][1]:.4f} in a graph; bound {bound:.4f}")


def k23(np, torch, K, cs, times) -> None:
    """K23 at MQ2's pass (module docstring)."""
    S = 4
    gen = torch.Generator(device="cuda").manual_seed(23)
    sh, el, _h, _d = cs.sharded_graph(torch, gen, PERSONS, S, 10.0)
    ok = torch.rand(VB, generator=gen, device="cuda") < 0.2  # MQ2's age < 30 admits ~a fifth
    ok[PERSONS:] = False
    w = torch.randint(0, 40, (VB,), generator=gen, device="cuda", dtype=torch.int32)
    emask = torch.rand(int((el[0] >= 0).sum()), generator=gen, device="cuda") < 0.7
    out = torch.zeros(VB, dtype=torch.int32, device="cuda")
    want = K.plain_shard_weight_pass(el[0], el[1], el[2], None, ok, w, torch.zeros_like(out))
    csr = "indptr_sh" in inspect.signature(K.shard_weight_pass).parameters
    print(f"K23: the tree walks the row-sharded CSR: {csr}")
    every = torch.ones_like(ok)
    every[PERSONS:] = False
    zero = lambda: torch.zeros_like(out)  # noqa: E731
    checks = {
        "MQ2's pass": want,
        "MQ2's second pass (every vertex kept)": K.plain_shard_weight_pass(el[0], el[1], el[2], None, every, w, zero()),
        "MQ1's form (w None)": K.plain_shard_weight_pass(el[0], el[1], el[2], None, ok, None, zero()),
        "in": K.plain_shard_weight_pass(el[1], el[0], el[2], None, ok, w, zero()),
        "in, the edge mask through :in:eid": K.plain_shard_weight_pass(el[1], el[0], el[2], emask, ok, w, zero()),
    }
    if csr:
        def csr_pass(d, o, m=None, wt=w):
            out.zero_()
            return K.shard_weight_pass(*sh[d], 0, m, o, wt, out)

        forms = {
            "MQ2's pass": lambda: csr_pass("out", ok),
            "MQ2's second pass (every vertex kept)": lambda: csr_pass("out", every),
            "MQ1's form (w None)": lambda: csr_pass("out", ok, wt=None),
            "in": lambda: csr_pass("in", ok),
            "in, the edge mask through :in:eid": lambda: csr_pass("in", ok, emask),
        }
    else:
        def slot_pass(d, o, m=None, wt=w):
            out.zero_()
            a, e = (el[0], el[1]) if d == "out" else (el[1], el[0])
            return K.shard_weight_pass(a, e, el[2], m, o, wt, out)

        forms = {
            "MQ2's pass": lambda: slot_pass("out", ok),
            "MQ2's second pass (every vertex kept)": lambda: slot_pass("out", every),
            "MQ1's form (w None)": lambda: slot_pass("out", ok, wt=None),
            "in": lambda: slot_pass("in", ok),
            "in, the edge mask through :in:eid": lambda: slot_pass("in", ok, emask),
        }
    for name, fn in forms.items():
        if name in checks:
            out.zero_()
            _same(torch, fn(), checks[name], f"K23 ({name})")
    edges = int(el[0].ge(0).sum())
    bound = cs.weight_pass_bytes(sh["out"], VB, False) / cs.HBM_BYTES_PER_S * 1e3
    for name, fn in forms.items():
        key = f"K23 {name}"
        times[key] = [cs._time_ms(torch, fn), cs._graph_ms(torch, fn)]
        print(f"{key}: {times[key][0]:.4f} ms eager, {times[key][1]:.4f} in a graph")
    kept = int(ok[el[1].view(-1)[el[1].view(-1) >= 0].long()].sum())
    print(f"K23 at MQ2's pass ({edges} edges over {S} shards of {-(-PERSONS // S)} rows): byte bound {bound:.4f} "
          f"(no fold at this mask); {cs.gather_floor(edges, kept)}")


def k20(np, torch, K, cs, times) -> None:
    """K19 with and without K20's flag (module docstring)."""
    indptr, dst, deg, edge_src, gen = _a_graph(np, torch, 20)
    blockv, pageof, estart, pools, f, gate, P, Wp, B = _t_pool(torch, K, gen, indptr, dst, deg, edge_src)
    del dst, edge_src
    folded = "miss" in inspect.signature(K.paged_hop_csr).parameters
    print(f"K20: the tree folds the cold-miss flag into K19's push: {folded}")
    push = (indptr, blockv, pageof, estart, pools["nbr"], pools["eid"])
    flag = torch.zeros((), dtype=torch.bool, device="cuda")
    over = torch.zeros((), dtype=torch.bool, device="cuda")
    cold = f.clone()
    cold[:, torch.nonzero(pageof[blockv.long()] < 0).view(-1)[:1]] = True  # one active vertex in a cold block
    for name, fr in (("T3's frontier", f), ("T3's frontier and a cold vertex", cold),
                     ("dense", torch.ones((C, VB), dtype=torch.bool, device="cuda"))):
        alive = K.mask_count(fr.view(-1))
        want = K.plain_paged_hop_miss(fr, blockv, pageof, indptr, gate, alive)
        forms = {"K19": lambda fr=fr, a=alive: K.paged_hop_csr(*push, None, fr, gate, a)}
        if folded:
            def with_flag(fr=fr, a=alive):
                return K.paged_hop_csr(*push, None, fr, gate, a, miss=flag)

            flag.zero_()
            with_flag()
            if bool(flag) != bool(want):
                raise SystemExit(f"K19's flag ({name}) differs from plain_paged_hop_miss")
            forms["K19 with the flag"] = with_flag
        else:
            def with_flag(fr=fr, a=alive):
                # a tiered hop as this tree replays it: K20 (its memset
                # inside), the OR into the overflow, then K19
                torch.logical_or(over, K.paged_hop_miss(fr, blockv, pageof, indptr, gate, a), out=over)
                return K.paged_hop_csr(*push, None, fr, gate, a)

            if bool(K.paged_hop_miss(fr, blockv, pageof, indptr, gate, alive)) != bool(want):
                raise SystemExit(f"K20 ({name}) differs from plain_paged_hop_miss")
            forms["K19 with K20 and the OR"] = with_flag
        for form, fn in forms.items():
            key = f"{form}, {name}"
            times[key] = [cs._time_ms(torch, fn), cs._graph_ms(torch, fn)]
            print(f"{key} (flag {bool(want)}): {times[key][0]:.4f} ms eager, {times[key][1]:.4f} in a graph")


def _armed_a(np, torch, K, seed: int):
    """An A-shaped out-CSR armed as phase 8 leaves it after W3 (module
    docstring): the padded indptr and dst, edge_src and live over every
    edge slot, the out bucket table, the slab's base, and the generator."""
    i32 = torch.int32
    indptr, dst, deg, edge_src, gen = _a_graph(np, torch, seed)
    del deg
    ne, vcap, spare, nb, bk = int(indptr[-1]), PERSONS + 65_536, 1 << 20, 1 << 18, 8
    new, extra = 16_384, 98_304
    cap = ne + spare
    pad = lambda t: torch.cat([t, torch.full((spare,), -1, dtype=i32, device="cuda")])  # noqa: E731
    edge_src, dst = pad(edge_src), pad(dst)
    indptr = torch.cat([indptr, indptr[-1:].expand(vcap - PERSONS)]).contiguous()
    fresh = torch.arange(PERSONS, PERSONS + new, dtype=i32, device="cuda")
    rnd = lambda n: torch.randint(0, PERSONS, (n,), generator=gen, device="cuda", dtype=i32)  # noqa: E731
    s_src = torch.cat([fresh, rnd(new), rnd(extra)])
    s_dst = torch.cat([rnd(new), fresh, rnd(extra)])
    used = s_src.shape[0]
    edge_src[ne : ne + used], dst[ne : ne + used] = s_src, s_dst
    live = torch.zeros(cap, dtype=torch.bool, device="cuda")
    live[: ne + used] = True
    # the out table as bucket_add fills it: slab slots in order, a bucket's
    # entries in slot order (no bucket reaches 8 at this load)
    key = (s_src & (nb - 1)).long()
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    first = torch.searchsorted(sk, sk)
    rank = torch.arange(used, device="cuda") - first
    if int(rank.max()) >= bk:
        raise SystemExit("slabhop: a bucket overflowed the synthetic slab")
    tab = torch.full((nb * bk,), -1, dtype=i32, device="cuda")
    tab[sk * bk + rank] = order.to(i32)
    # W3: 4,096 slab edges and 5,000 base edges tombstoned
    dead_slab = ne + torch.randperm(used, generator=gen, device="cuda")[:4_096]
    dead_base = torch.randperm(ne, generator=gen, device="cuda")[:5_000]
    live[dead_slab] = False
    live[dead_base] = False
    dst[dead_base] = -1
    return indptr, dst, edge_src, live, tab, ne, nb, bk, gen


def slabhop(np, torch, K, cs, times) -> None:
    """The slab's part of a dirty hop (module docstring)."""
    indptr, dst, edge_src, live, tab, base, nb, bk, gen = _armed_a(np, torch, K, 20)
    win = slice(base, edge_src.shape[0])
    a, e, m = edge_src[win], dst[win], live[win]
    probe = hasattr(K, "SlabIndex")
    print(f"slabhop: the tree folds the slab into K10's push as a bucket probe: {probe}")
    live_slab = torch.nonzero(m).view(-1)
    sparse = torch.zeros((C, VB), dtype=torch.bool, device="cuda")
    for r in range(C):
        sparse[r, torch.randint(0, PERSONS, (10,), generator=gen, device="cuda")] = True
        sparse[r, a[live_slab[torch.randint(0, live_slab.numel(), (64,), generator=gen, device="cuda")]].long()] = True
    dense = torch.ones((C, VB), dtype=torch.bool, device="cuda")
    csr = (indptr, dst, None)
    if probe:
        index = K.SlabIndex(tab, edge_src, dst, live, base, nb, bk)
        hop = lambda f, al: K.bitmap_hop_csr(*csr, live, f, None, al, probe=index)  # noqa: E731
    else:
        hop = lambda f, al: K.bitmap_hop(a, e, m, f, None, al, K.bitmap_hop_csr(*csr, live, f, None, al))  # noqa: E731
    for name, f in (("C=8 sparse", sparse), ("dense", dense)):
        alive = K.mask_count(f.view(-1))
        if name == "dense":  # every vertex active: every live edge's target is reached in every row
            want = torch.zeros((C, VB), dtype=torch.bool, device="cuda")
            want[:, dst[live].long()] = True
        else:
            want = K.plain_bitmap_hop_csr(*csr, live, f, None, alive) | K.plain_bitmap_hop(a, e, m, f, None, alive)
        _same(torch, hop(f, alive), want, f"slab hop ({name})")
        b_csr, n_act, n_edges = cs.csr_hop_bytes(torch, indptr, f, None, True, False)
        line = f"slab hop {name} ({n_act} active vertices, {n_edges} CSR edges"
        if probe:
            b_probe, _pa, n_fill, n_kept = cs.probe_bytes(torch, index, f, live)
            line += f", {n_fill} filled entries probed, {n_kept} kept; bound {(b_csr + b_probe) / cs.HBM_BYTES_PER_S * 1e3:.4f}"
        line += f"; the CSR push alone's bound {b_csr / cs.HBM_BYTES_PER_S * 1e3:.4f})"
        for form, fn in (("the tree's dirty hop", lambda f=f, al=alive: hop(f, al)),
                         ("the CSR push alone", lambda f=f, al=alive: K.bitmap_hop_csr(*csr, live, f, None, al))):
            key = f"slab hop {name}: {form}"
            times[key] = [cs._time_ms(torch, fn), cs._graph_ms(torch, fn)]
            line += f"; {form} {times[key][0]:.4f} ms eager, {times[key][1]:.4f} in a graph"
            if name != "dense":
                times[key].append(_graph_ms_many(torch, fn))
                line += f", {times[key][2]:.4f} a call in a graph of 50"
        print(line)


def _graph_ms_many(torch, fn, n: int = 50, reps: int = 5) -> float:
    """Mean milliseconds a call of ``fn`` with ``n`` calls captured in one
    CUDA graph, replayed ``reps`` times: a call's device time with the
    graph's own launch spread over the n calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def k21(np, torch, K, cs, times) -> None:
    """K21 at T1c's sources, on a skewed frontier and over a Zipf-degree
    partition (module docstring)."""
    i32 = torch.int32
    indptr, dst, deg, edge_src, gen = _a_graph(np, torch, 21)
    blockv, pageof, estart, pools, _f, _gate, P, Wp, B = _t_pool(torch, K, gen, indptr, dst, deg, edge_src)
    del dst, edge_src
    flagged = "flag" in inspect.signature(K.paged_expand).parameters
    print(f"k21: the tree takes the replay's shared miss byte: {flagged}")
    t1c = torch.tensor([(i * 65_537) % PERSONS for i in range(1_024)] + [-1] * 7, dtype=i32, device="cuda")
    zr = torch.from_numpy(np.random.default_rng(21).zipf(1.3, 4_096) - 1).clamp(max=PERSONS - 1).cuda()
    zipf = torch.argsort(deg, descending=True, stable=True)[zr].to(i32)
    zipf[::16] = -1
    shared = torch.zeros((), dtype=torch.bool, device="cuda")
    over = torch.zeros((), dtype=torch.bool, device="cuda")
    part = (indptr, blockv, pageof, estart, pools, P, Wp, B)
    cases = [("T1c's sources", part, t1c), ("Zipf frontier", part, zipf)]
    # the Zipf-degree CSR of K2's Zipf case (one vertex of 150,000 edges),
    # paged the same way; every vertex a source, a third of them -1
    z_ip, zrng = cs.zipf_indptr(np, torch, "cuda")
    zv, ze = z_ip.shape[0] - 1, int(z_ip[-1])
    z_deg = (z_ip[1:] - z_ip[:-1]).long()
    z_dst = torch.randint(0, zv, (ze,), generator=gen, device="cuda", dtype=i32)
    z_src = torch.repeat_interleave(torch.arange(zv, dtype=i32, device="cuda"), z_deg)
    zb, zp, zs, zpools, _f, _g, zP, zWp, zB = _t_pool(torch, K, gen, z_ip, z_dst, z_deg, z_src)
    del z_dst, z_src
    z_srcs = torch.arange(zv, dtype=i32, device="cuda")
    z_srcs[torch.from_numpy(zrng.random(zv) < 1 / 3).cuda()] = -1
    cases.append(("Zipf-degree partition", (z_ip, zb, zp, zs, zpools, zP, zWp, zB), z_srcs))
    for name, (indptr, blockv, pageof, estart, pools, P, Wp, B), srcs in cases:
        counts = K.degree_counts(indptr, srcs)
        offsets, total = K.exclusive_cumsum_total(counts)
        size = K.bucket(max(int(total), 1))
        args = (indptr, srcs, offsets, total, size, blockv, pageof, estart, pools["nbr"], pools["eid"], True)
        _same(torch, K.paged_expand(*args), K.plain_paged_expand(*args), f"paged_expand ({name})")
        if flagged:
            replay = lambda a=args: K.paged_expand(*a, flag=shared)  # noqa: E731
        else:
            def replay(a=args):
                out = K.paged_expand(*a)
                torch.logical_or(over, out[3], out=over)  # SizeSchedule.note_flag's OR
                return out
        nbytes = srcs.shape[0] * 24.0 + 4.0 + min(int(total), size) * 4.0 + size * 12.0 + 1.0
        line = []
        for form, fn in (("K21", lambda a=args: K.paged_expand(*a)), ("K21 as a replay runs it", replay)):
            key = f"{form}, {name}"
            times[key] = [cs._time_ms(torch, fn), cs._graph_ms(torch, fn), _graph_ms_many(torch, fn)]
            line.append(f"{form} {times[key][0]:.4f} ms eager, {times[key][1]:.4f} in a graph, "
                        f"{times[key][2]:.4f} a call in a graph of 50")
        print(f"k21 {name} ({srcs.shape[0]} sources, total {int(total)} into {size}; {P} pages of {Wp} slots, "
              f"B={B}): {'; '.join(line)}; bound {nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f}")


def dtreplays(np, torch, K, cs, times) -> None:
    """V1 on armed A after W1–W3, and T1–T3 on tiered A (module
    docstring)."""
    import copy
    import gc
    import statistics
    import time

    from orientdb_tpu_torch.exec import tpu_engine as TE
    from orientdb_tpu_torch.storage import tiering
    from orientdb_tpu_torch.storage.bigshape import build_person_knows
    from orientdb_tpu_torch.storage.deltas import arm_delta_maintenance
    from orientdb_tpu_torch.utils.config import config

    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    db, snap = build_person_knows(PERSONS, avg_knows=10, seed=5, geo=True)
    tdb = copy.deepcopy(db)
    print(f"dtreplays: A built in {time.perf_counter() - t0:.1f} s")

    def median_of(name, run, plan_of, reps=7):
        run()
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            out = run()
            sync()
            ts.append((time.perf_counter() - t) * 1e3)
        plan = plan_of()
        times[f"replay {name}"] = [statistics.median(ts), None]
        print(f"replay {name}: median {statistics.median(ts):.3f} ms ({[round(x, 3) for x in ts]}); result "
              f"{out}; launches per replay {sum(plan.launches.values())} {dict(sorted(plan.launches.items()))}")

    m = arm_delta_maintenance(db, cs.D_SPARE_VERTICES, cs.D_SPARE_EDGES)
    writer = cs.DeltaWriter(np, db, snap, seed=8)
    for make in (lambda: writer.w1(cs.W_PERSONS, cs.W_EXTRA_EDGES), lambda: writer.w2(cs.W_UPDATES),
                 lambda: writer.w3(cs.W_DEL_EDGES, cs.W_DEL_PERSONS, cs.Q3_K)):
        cs._require(m.apply_batch(make()), f"a write batch poisoned the overlay: {snap._overlay.poisoned}")
    sync()
    cs._require(not snap._overlay.bucket_overflow, "W1–W3 overflowed a bucket")
    median_of("V1 after W3", lambda: db.query(cs.V1).to_dicts(),
              lambda: max(cs._only_plan(TE, snap, cs.V1).plans, key=lambda p: p.replays))
    TE._plan_cache(snap).clear()
    del db, snap, m, writer
    gc.collect()
    gc.collect()
    sync()
    torch.cuda.empty_cache()
    tsnap = tdb.current_snapshot()
    config.tier_hbm_cap_bytes = tiering.adjacency_bytes(tsnap) // 2
    try:
        tdb.attach_snapshot(tsnap)
        cs._require(tsnap._tier is not None, "A was not admitted to the tier plane")
        for name, sql, plist in (("T1", cs.T1, cs.T1_PARAMS), ("T2", cs.T2, [{"k": cs.T2_K}]),
                                 ("T3", cs.T3, [{"u": u} for u in cs.T3_ROOTS])):
            for p in plist:  # record every variant and fault its footprint in
                tdb.query(sql, p).to_dicts()
            ts, res = [], []
            for p in plist * max(1, 8 // len(plist)):
                t = time.perf_counter()
                res.append(tdb.query(sql, p).to_dicts())
                sync()
                ts.append((time.perf_counter() - t) * 1e3)
            plan = max(cs._only_plan(TE, tsnap, sql).plans, key=lambda q: q.replays)
            times[f"replay {name}"] = [statistics.median(ts), None]
            print(f"replay {name}: median {statistics.median(ts):.3f} ms over {len(ts)} calls; first result "
                  f"{res[0][:2]}; launches per replay {sum(plan.launches.values())} "
                  f"{dict(sorted(plan.launches.items()))}")
    finally:
        config.tier_hbm_cap_bytes = 0


def replays(np, torch, K, cs, times) -> None:
    """MQ1, MQ2 (A split four ways) and T3, T4 (A tiered) replays
    (module docstring)."""
    import copy
    import statistics
    import time

    from orientdb_tpu_torch.exec import tpu_engine as TE
    from orientdb_tpu_torch.parallel.sharded import make_mesh
    from orientdb_tpu_torch.storage import tiering
    from orientdb_tpu_torch.storage.bigshape import build_person_knows
    from orientdb_tpu_torch.utils.config import config

    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    db, snap = build_person_knows(PERSONS, avg_knows=10, seed=5, geo=True)
    tdb = copy.deepcopy(db)
    print(f"replays: A built in {time.perf_counter() - t0:.1f} s")
    V = snap.num_vertices
    age = snap.v_columns["age"].values
    want = {
        "MQ1": cs.numpy_1hop_count(snap, age > 40, age < 30),
        "MQ2": cs.numpy_2hop_count(snap, age > 40, np.ones(V, bool), age < 30),
    }
    mdb, msnap = cs.mesh_twin(db, snap, make_mesh(cs.M_SHARDS))

    def cell(db_, snap_, name, sql, params, check):
        db_.query(sql, params).to_dicts()
        ts = []
        for _ in range(7):
            t = time.perf_counter()
            rows = db_.query(sql, params).to_dicts()
            sync()
            ts.append((time.perf_counter() - t) * 1e3)
            check(rows)
        plan = max(cs._only_plan(TE, snap_, sql).plans, key=lambda p: p.replays)
        times[f"replay {name}"] = [statistics.median(ts), None]
        print(f"replay {name}: median {statistics.median(ts):.3f} ms ({[round(x, 3) for x in ts]}); launches per "
              f"replay {sum(plan.launches.values())} {dict(sorted(plan.launches.items()))}")

    for name, sql in (("MQ1", cs.Q1), ("MQ2", cs.Q2)):
        cell(mdb, msnap, name, sql, None, lambda r, n=name: cs._require(r == [{"n": want[n]}], f"{n}: {r}"))
    TE._plan_cache(msnap).clear()
    del mdb, msnap, db, snap
    import gc

    gc.collect()
    gc.collect()
    sync()
    torch.cuda.empty_cache()
    tsnap = tdb.current_snapshot()
    tref = cs.TRef(np, tsnap)
    config.tier_hbm_cap_bytes = tiering.adjacency_bytes(tsnap) // 2
    try:
        tdb.attach_snapshot(tsnap)
        cs._require(tsnap._tier is not None, "A was not admitted to the tier plane")
        ts = []
        for rep in range(2):
            for u in cs.T3_ROOTS:
                t = time.perf_counter()
                rows = tdb.query(cs.T3, {"u": u}).to_dicts()
                sync()
                if rep:
                    ts.append((time.perf_counter() - t) * 1e3)
                cs._require(rows == [{"n": tref.t3(u)}], f"T3 u={u}: {rows}")
        plan = max(cs._only_plan(TE, tsnap, cs.T3).plans, key=lambda p: p.replays)
        times["replay T3"] = [statistics.median(ts), None]
        print(f"replay T3: median {statistics.median(ts):.3f} ms over {len(cs.T3_ROOTS)} roots "
              f"({[round(x, 3) for x in ts]}); launches per replay {sum(plan.launches.values())} "
              f"{dict(sorted(plan.launches.items()))}")
        ip64 = tref.ip.astype(np.int64)
        ids, _levels = cs.numpy_traverse(
            np, V, np.arange(50), lambda f: cs.csr_neighbours(np, ip64, tref.dst, f), admit=lambda d: d < 2
        )
        check = lambda r: cs._require(  # noqa: E731
            np.array_equal(np.array([int(x["@rid"].split(":")[1]) for x in r], np.int64), ids), "T4 differs")
        cell(tdb, tsnap, "T4", cs.TR1, None, check)
    finally:
        config.tier_hbm_cap_bytes = 0


#: the kernel modules `_tree_library` loaded, kept alive with their libraries
_LIBS: list = []


def _tree_library(tree: str):
    """The kernel library of the package in ``tree``, built from that
    tree's source: its ``ops/_kernels.py`` loaded by file path under a name
    of its own (it imports nothing of its package), so two trees' libraries
    load side by side in one process."""
    path = os.path.join(tree, "orientdb_tpu_torch", "ops", "_kernels.py")
    spec = importlib.util.spec_from_file_location(f"_kernels_of_{len(_LIBS)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _LIBS.append(mod)
    return mod.load(), mod.build()


def _c_call(torch, lib, name: str, *args) -> None:
    """``lib``'s C entry ``name`` on ``args`` and the current stream (read
    at the call, so that a graph capture records it); an entry that takes
    lane arguments before the stream (this tree's) gets one lane and no
    lane-stacked operand."""
    fn = getattr(lib, name)
    extra = len(fn.argtypes) - len(args) - 1
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, *((1,) + (0,) * (extra - 1) if extra > 0 else ()), stream)
    if rc != 0:
        raise SystemExit(f"{name}: CUDA error {rc}")


def _sass(lib_path, keys) -> dict:
    """Name → opcode list of the functions of ``lib_path`` whose mangled
    name holds one of ``keys``, from ``cuobjdump -sass``; {} when the
    toolkit has no cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if any(k in name for k in keys):
            out[name] = [ln.split("*/", 1)[1].strip().split(" ", 1)[0].rstrip(";")
                         for ln in part.splitlines() if re.match(r"\s+/\*[0-9a-f]{4}\*/", ln)]
    return out


def singles_ab(np, torch, K, cs, times, tree: str, against: str, rounds: int) -> None:
    """The single K11 and K12 (and K10's CSR form) at V1's [8, 2^23] level
    shapes, ``tree``'s library and ``against``'s (the parent's) in one
    process: each case captured in a CUDA graph through either library's C
    entry on the same inputs and replayed, the two trees in turns
    (this, parent; then parent, this) for ``rounds`` rounds; prints each
    case's median ms a tree, their ratio and the spread of the paired
    ratios; then the SASS of the bitmap kernels of both libraries
    (instruction counts and whether the opcode sequences are equal)."""
    libs = {"this": _tree_library(tree), "parent": _tree_library(os.path.abspath(against))}
    gen = torch.Generator(device="cuda").manual_seed(13)
    node = torch.rand(VB, generator=gen, device="cuda") < 0.2
    roots = _bitmap(torch, gen, C, VB, 1)
    lvl1 = _bitmap(torch, gen, C, VB, REACHED["level 1"])
    lvl2 = _bitmap(torch, gen, C, VB, REACHED["level 2"])
    seen2 = roots | lvl1
    bound = torch.tensor([-2, 0, VB - 1, 5, 77, -2, 1 << 20, VB - 2], dtype=torch.int32, device="cuda")
    emit_out = torch.empty((C, VB), dtype=torch.bool, device="cuda")
    any_out = torch.empty(C, dtype=torch.bool, device="cuda")
    count = torch.empty((), dtype=torch.int32, device="cuda")
    emitted = torch.empty((), dtype=torch.int32, device="cuda")
    indptr, dst, _deg, _src, _gen = _a_graph(np, torch, 41)
    hop_fr = _bitmap(torch, gen, C, VB, 110)
    hop_fr[:, PERSONS:] = False
    hop_out = torch.empty((C, VB), dtype=torch.bool, device="cuda")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    def emit(reached, b, e, a, c):
        return lambda lib: _c_call(torch, lib, "csr_bitmap_emit", ptr(reached), ptr(node), ptr(b), C, VB, ptr(e),
                                   ptr(a), ptr(c))

    cases = {
        "K11 count-only, depth 0": emit(roots, None, None, None, count),
        "K11 count-only, level 2": emit(lvl2, None, None, None, count),
        "K11 emit + count, level 2": emit(lvl2, None, emit_out, None, count),
        "K11 any-only, level 2": emit(lvl2, None, None, any_out, None),
        "K11 close-arm count, level 2": emit(lvl2, bound, None, None, count),
        "K10 level 2 out": lambda lib: _c_call(
            torch, lib, "csr_bitmap_hop_csr", ptr(indptr), indptr.shape[0] - 1, ptr(dst), None, None, 0, ptr(hop_fr),
            None, C, VB, None, 1, ptr(hop_out)),
    }
    step = lambda lib: (lambda n, v: _c_call(  # noqa: E731
        torch, lib, "csr_frontier_advance", ptr(n), ptr(v), None, ptr(node), None, C * VB, VB, ptr(count),
        ptr(emitted)))
    want = {}
    for which, (lib, _path) in libs.items():  # both libraries agree with the plain versions first
        cases["K11 emit + count, level 2"](lib)
        got = (emit_out.clone(), int(count))
        n, v = lvl2.clone(), seen2.clone()
        step(lib)(n, v)
        torch.cuda.synchronize()
        want[which] = (got, (n, v, int(count), int(emitted)))
    e_ref, _a, c_ref = K.plain_bitmap_emit(lvl2, node, None, True, False, True)
    n_ref, v_ref = lvl2.clone(), seen2.clone()
    a_ref, em_ref = K.plain_frontier_advance(n_ref, v_ref, None, node)
    for which, ((e, c), (n, v, a, em)) in want.items():
        if not (torch.equal(e, e_ref) and c == int(c_ref) and torch.equal(n, n_ref) and torch.equal(v, v_ref)
                and a == int(a_ref) and em == int(em_ref)):
            raise SystemExit(f"singles_ab: {which}'s K11 / K12 differ from the plain versions")
    keys = list(cases) + ["K12 level 2, folded count"]
    ms = {k: {"this": [], "parent": []} for k in keys}
    for r in range(rounds):
        order = ("this", "parent") if r % 2 == 0 else ("parent", "this")
        for key in keys:
            for which in order:
                lib = libs[which][0]
                if key.startswith("K12"):
                    t = cs._fresh_ms(torch, step(lib), (lvl2, seen2), reps=10, graph=True)
                else:
                    t = cs._graph_ms(torch, lambda f=cases[key], lib=lib: f(lib), reps=50)
                ms[key][which].append(t)
    for key in keys:
        this, parent = np.array(ms[key]["this"]), np.array(ms[key]["parent"])
        ratio = this / parent
        lo, hi = np.percentile(ratio, [10, 90])
        times[f"AB {key}"] = [float(np.median(parent)), float(np.median(this))]
        print(f"AB {key}: parent {np.median(parent):.5f} ms, this {np.median(this):.5f} ms in a graph (medians of "
              f"{rounds}); this / parent {np.median(this) / np.median(parent):.4f}, paired ratios median "
              f"{np.median(ratio):.4f}, 10-90 % {lo:.4f}-{hi:.4f}; parent spread {parent.min():.5f}-{parent.max():.5f}")
    # K11's, K12's and K10's CSR push instantiations
    sass = {which: _sass(path, ("bitmap_emit", "frontier_advance_kernel", "CsrRows"))
            for which, (_lib, path) in libs.items()}
    if not sass["this"]:
        print("singles_ab: no cuobjdump, SASS not compared")
        return
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "singles_ab_sass.json"), "w") as out:
        json.dump(sass, out)
    for which, funcs in sass.items():
        for name, ops in sorted(funcs.items()):
            digest = hashlib.sha1(" ".join(ops).encode()).hexdigest()[:12]
            print(f"SASS {which} {name}: {len(ops)} instructions, opcodes {digest}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--only", default="level,k10,k4,k15,k5,k2,hops,k17,k24,k23,k20,slabhop,k21")
    ap.add_argument("--against", help="singles_ab: the parent tree whose library runs beside --tree's")
    ap.add_argument("--rounds", type=int, default=30, help="singles_ab: alternated rounds")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    # the tree's package first: chip_smoke.py (this script's) imports the
    # package by name, and the first import binds it for the process
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the kernels run only on one", file=sys.stderr)
        return 1
    from orientdb_tpu_torch.ops import csr as K

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"tree {tree} (kernels from {K.__file__}): {card}")
    times = {}
    only = set(args.only.split(","))
    if "level" in only:
        level_steps(torch, K, cs, times)
    if "k10" in only:
        k10(np, torch, K, cs, times)
    if "k4" in only:
        segment_sums(np, torch, K, cs, times)
    if "k15" in only:
        predicate_masks(np, torch, K, cs, times)
    if "k5" in only:
        k5(torch, K, cs, times)
    if "k2" in only:
        k2(np, torch, K, cs, times)
    if "hops" in only:
        hops(np, torch, K, cs, times)
    if "k17" in only:
        k17(np, torch, K, cs, times)
    if "k24" in only:
        k24(np, torch, K, cs, times)
    if "k23" in only:
        k23(np, torch, K, cs, times)
    if "k20" in only:
        k20(np, torch, K, cs, times)
    if "slabhop" in only:
        slabhop(np, torch, K, cs, times)
    if "k21" in only:
        k21(np, torch, K, cs, times)
    if "replays" in only:
        replays(np, torch, K, cs, times)
    if "dtreplays" in only:
        dtreplays(np, torch, K, cs, times)
    if "singles_ab" in only:
        if not args.against:
            raise SystemExit("singles_ab needs --against DIR")
        singles_ab(np, torch, K, cs, times, tree, args.against, args.rounds)
    print(json.dumps({"tree": tree, "kernels": K.__file__, "card": card, "ms [eager, graph]": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
