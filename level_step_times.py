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
  edge map inside it and the hop as this tree launches it.

    python3 level_step_times.py [--tree DIR] [--only level,k4,k15,k5,k2]

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
import importlib.util
import inspect
import json
import os
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
    return ", ".join(f"{e.key[:40]} {cs._device_us(e) / 1e3:.4f} ms x{e.count}" for e in rows) or "not measured"


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--only", default="level,k4,k15,k5,k2")
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
    if "k4" in only:
        segment_sums(np, torch, K, cs, times)
    if "k15" in only:
        predicate_masks(np, torch, K, cs, times)
    if "k5" in only:
        k5(torch, K, cs, times)
    if "k2" in only:
        k2(np, torch, K, cs, times)
    print(json.dumps({"tree": tree, "kernels": K.__file__, "card": card, "ms [eager, graph]": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
