#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`orientdb_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

from the root of a checkout. Phases, each of which raises on failure:

1. device — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them;
2. build — compiles `orientdb_tpu_torch/csrc/csr_kernels.cu` with nvcc;
3. kernels — on the SF100-shape Person–knows graph (8M persons, ~80M knows
   edges, seed 5), holds each kernel against its plain PyTorch version at
   the main path's shapes and at edge-case lengths: int32 and bool results
   exactly, float32 results to rtol 1e-6 (the kernels add in another order
   than the plain version); times the kernel, the plain version and, where
   one PyTorch call computes the same function, that call (`library_ms`,
   which the port never calls);
4. slice — zeroes the kernels' launch counts, runs the 1-hop COUNT (Q1),
   the 2-hop COUNT (Q2) and the row-returning 2-hop (Q3) through
   ``db.query``, reads the counts, and fails unless every kernel launched;
   Q1 and Q2 must equal the exact numpy counts and Q3's rows the numpy
   rows; then times each query (median of 5 after the first run), splits
   it into its layers (plan, solve, marshal) and reads the card's busy
   share with torch.profiler.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from orientdb_tpu_torch.storage.bigshape import (  # noqa: E402
    numpy_1hop_count,
    numpy_2hop_count,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
F32_RTOL = 1e-6
SOURCE = "orientdb_tpu_torch/csrc/csr_kernels.cu"
REPLACES = {
    "scan_i32": "orientdb_tpu/ops/csr.py:129",
    "scan_f32": "orientdb_tpu/ops/csr.py:129",
    "degree_counts": "orientdb_tpu/ops/csr.py:39",
    "gather_expand": "orientdb_tpu/ops/csr.py:54",
    "compact_indices": "orientdb_tpu/ops/csr.py:185",
    "segment_sum_i32": "orientdb_tpu/ops/csr.py:227",
    "segment_sum_f32": "orientdb_tpu/ops/csr.py:227",
    "take_pad_i32": "orientdb_tpu/ops/csr.py:211",
    "take_pad_f32": "orientdb_tpu/ops/csr.py:211",
    "take_pad_b8": "orientdb_tpu/ops/csr.py:211",
    "mask_count": "orientdb_tpu/ops/csr.py:222",
}
EDGE_LENGTHS = [0, 1, 255, 256, 257, 511, 513]

Q1 = (
    "MATCH {class:Person, as:p, where:(age > 40)}"
    "-knows->{as:f, where:(age < 30)} RETURN count(*) AS n"
)
Q2 = (
    "MATCH {class:Person, as:p, where:(age > 40)}-knows->{as:f}"
    "-knows->{as:g, where:(age < 30)} RETURN count(*) AS n"
)
Q3 = (
    "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f}"
    "-knows->{as:g, where:(age < 30)} "
    "RETURN p.uid AS p, f.uid AS f, g.uid AS g"
)
Q3_K = 2000


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _time_ms(torch, fn, reps: int = 10) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up,
    between CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _library_ms(torch, name, library):
    """The yardstick call's time, or None where there is none or this
    PyTorch build refuses it for these inputs."""
    if library is None:
        return None
    try:
        return _time_ms(torch, library)
    except (RuntimeError, TypeError, NotImplementedError) as e:
        print(f"library call for {name} refused: {e}")
        return None


class Kernels:
    """Comparisons and timings of each kernel, keyed by kernel name."""

    def __init__(self, torch, K):
        self.torch = torch
        self.K = K
        self.err = {name: 0.0 for name in REPLACES}
        self.rows = {}

    def same(self, name, got, want, exact: bool = True) -> None:
        torch = self.torch
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            _require(g.shape == w.shape and g.dtype == w.dtype, f"{name}: shape/dtype")
            if exact:
                _require(torch.equal(g, w), f"{name}: differs from its plain version")
                continue
            diff = (g.double() - w.double()).abs()
            err = float(diff.max()) if diff.numel() else 0.0
            bound = F32_RTOL * float(w.double().abs().max()) if w.numel() else 0.0
            _require(err <= max(bound, F32_RTOL), f"{name}: |err| {err} > {bound}")
            self.err[name] = max(self.err[name], err)

    def timed(self, name, kernel, plain, library, bound_bytes: float) -> None:
        torch = self.torch
        self.rows[name] = {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "ms": _time_ms(torch, kernel),
            "plain_ms": _time_ms(torch, plain),
            "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": _library_ms(torch, name, library),
        }


def check_kernels(torch, K, dg) -> Kernels:
    from orientdb_tpu_torch.exec.tpu_engine import _cap_of

    ks = Kernels(torch, K)
    dev = dg.device
    dec = dg.edges["knows"]
    V, E = dg.num_vertices, dec.num_edges
    vb = K.bucket(V)
    i32 = torch.int32
    age = dg.columns["age"].values
    dst, indptr = dec.dst, dec.indptr_out
    gen = torch.Generator(device=dev).manual_seed(5)

    # Q2's last-hop contributions over the edge list, and its weights
    contrib = age[dst.long()] < 30
    vals_i = contrib.to(i32)
    vals_f = contrib.to(torch.float32)
    univ = torch.arange(vb, dtype=i32, device=dev)
    ok_vec = torch.cat([age < 30, torch.zeros(vb - V, dtype=torch.bool, device=dev)])
    root_mask = univ < Q3_K
    # Q3's second-hop frontier: the f vertices of p < k, padded as the
    # binding table pads them
    f = dst[: int(indptr[Q3_K])]
    width = _cap_of(f.shape[0])
    srcs = torch.cat([f, torch.full((width - f.shape[0],), -1, dtype=i32, device=dev)])

    # -- K1 scans ------------------------------------------------------------
    for name, vals in (("scan_i32", vals_i), ("scan_f32", vals_f)):
        exact = vals.dtype == i32
        for excl in (False, True):
            ks.same(name, K._scan(vals, excl), K.plain_cumsum(vals, excl), exact)
        for n in EDGE_LENGTHS:
            v = vals[:n].contiguous()
            ks.same(name, K.value_cumsum(v), K.plain_cumsum(v), exact)
        ks.timed(
            name,
            lambda v=vals: K.value_cumsum(v),
            lambda v=vals: K.plain_cumsum(v),
            lambda v=vals: torch.cumsum(v, 0, dtype=v.dtype),
            8.0 * E,
        )

    # -- K3 compaction (both of the reference's regimes) ----------------------
    dense = ok_vec & (univ < V)
    for mask, out_size in (
        (root_mask, _cap_of(Q3_K)),
        (dense, _cap_of(int(dense.sum()))),
        (dense, 1000),  # truncation
    ):
        ks.same(
            "compact_indices",
            K.compact_indices(mask, out_size),
            K.plain_compact_indices(mask, out_size),
        )
    for n in EDGE_LENGTHS:
        m = dense[:n].contiguous()
        for out_size in (8, K.bucket(max(n, 1))):
            ks.same("compact_indices", K.compact_indices(m, out_size), K.plain_compact_indices(m, out_size))
    out_size = _cap_of(Q3_K)
    ks.timed(
        "compact_indices",
        lambda: K.compact_indices(root_mask, out_size),
        lambda: K.plain_compact_indices(root_mask, out_size),
        lambda: torch.nonzero(root_mask),
        vb + 4.0 * out_size,
    )

    # -- K5b popcount ---------------------------------------------------------
    for m in [dense] + [dense[:n].contiguous() for n in EDGE_LENGTHS]:
        ks.same("mask_count", K.mask_count(m), K.plain_mask_count(m))
    ks.timed(
        "mask_count",
        lambda: K.mask_count(dense),
        lambda: K.plain_mask_count(dense),
        lambda: torch.count_nonzero(dense),
        vb + 4.0,
    )

    # -- K2 degree counts + gather_expand on Q3's frontier --------------------
    def expand_both(s):
        counts = K.degree_counts(indptr, s)
        ks.same("degree_counts", counts, K.plain_degree_counts(indptr, s))
        offsets = K.exclusive_cumsum(counts)
        total = K.value_sum(counts)
        size = _cap_of(int(total))
        ks.same(
            "gather_expand",
            K.gather_expand(indptr, dst, s, offsets, total, size),
            K.plain_gather_expand(indptr, dst, s, offsets, total, size),
        )
        return counts, offsets, total, size

    for n in EDGE_LENGTHS:
        expand_both(srcs[:n].contiguous())
        expand_both(torch.full((n,), -1, dtype=i32, device=dev))  # all padding
    counts, offsets, total, size = expand_both(srcs)
    live = int((srcs >= 0).sum())
    ks.timed(
        "degree_counts",
        lambda: K.degree_counts(indptr, srcs),
        lambda: K.plain_degree_counts(indptr, srcs),
        None,
        4.0 * width + 8.0 * live + 4.0 * width,
    )
    ks.timed(
        "gather_expand",
        lambda: K.gather_expand(indptr, dst, srcs, offsets, total, size),
        lambda: K.plain_gather_expand(indptr, dst, srcs, offsets, total, size),
        None,
        12.0 * width + 4.0 * int(total) + 12.0 * size,
    )

    # -- K4 segment sums over the edge list into vb ---------------------------
    for name, vals in (("segment_sum_i32", vals_i), ("segment_sum_f32", vals_f)):
        exact = vals.dtype == i32
        ks.same(name, K.indptr_segment_sum(vals, indptr, vb), K.plain_indptr_segment_sum(vals, indptr, vb), exact)
        for n in EDGE_LENGTHS:
            ip = torch.clamp(indptr[: n + 1], max=n).contiguous() if n else indptr[:1].clone() * 0
            v = vals[:n].contiguous()
            ks.same(name, K.indptr_segment_sum(v, ip, K.bucket(max(n, 1))), K.plain_indptr_segment_sum(v, ip, K.bucket(max(n, 1))), exact)
        ks.timed(
            name,
            lambda v=vals: K.indptr_segment_sum(v, indptr, vb),
            lambda v=vals: K.plain_indptr_segment_sum(v, indptr, vb),
            (lambda v=vals: torch.segment_reduce(v, "sum", offsets=indptr))
            if not exact
            else None,
            4.0 * E + 4.0 * (V + 1) + 4.0 * vb,
        )

    # -- K5a padding-safe gathers: the weight pass's [E]-wide gathers ----------
    w_i = K.indptr_segment_sum(vals_i, indptr, vb)
    w_f = w_i.to(torch.float32)
    idx_rand = torch.randint(-2, vb + 2, (513,), generator=gen, device=dev, dtype=i32)
    for name, vals, fill, elt in (
        ("take_pad_i32", w_i, 0, 4),
        ("take_pad_f32", w_f, 0.0, 4),
        ("take_pad_b8", ok_vec, False, 1),
    ):
        ks.same(name, K.take_pad(vals, dst, fill), K.plain_take_pad(vals, dst, fill))
        for n in EDGE_LENGTHS:
            ix = idx_rand[:n].contiguous()
            ks.same(name, K.take_pad(vals, ix, fill), K.plain_take_pad(vals, ix, fill))
            ks.same(name, K.take_pad(vals[:n].contiguous(), idx_rand, fill), K.plain_take_pad(vals[:n].contiguous(), idx_rand, fill))
        ks.timed(
            name,
            lambda v=vals, fl=fill: K.take_pad(v, dst, fl),
            lambda v=vals, fl=fill: K.plain_take_pad(v, dst, fl),
            None,
            4.0 * E + elt * E + elt * E,
        )
    torch.cuda.synchronize()
    return ks


def numpy_q3_rows(np, snap, k: int):
    """Sorted (p, f, g) rows of Q3 from the host arrays."""
    csr = snap.edge_classes["knows"]
    ip = csr.indptr_out.astype(np.int64)
    dst = csr.dst.astype(np.int64)
    age = snap.v_columns["age"].values
    deg_p = np.diff(ip[: k + 1])
    ps = np.repeat(np.arange(k), deg_p)
    fs = dst[ip[0] : ip[k]]
    deg_f = ip[fs + 1] - ip[fs]
    first = np.repeat(ip[fs] - (np.cumsum(deg_f) - deg_f), deg_f)
    gpos = first + np.arange(int(deg_f.sum()))
    gs = dst[gpos]
    keep = age[gs] < 30
    rows = np.stack([np.repeat(ps, deg_f)[keep], np.repeat(fs, deg_f)[keep], gs[keep]], 1)
    return rows[np.lexsort(rows.T[::-1])]


def run_slice(np, torch, K, db, snap, card: str):
    """Phase 4: the main path through ``db.query``, with the launch counts
    zeroed just before it and read just after. Returns the counts."""
    V = snap.num_vertices
    age = snap.v_columns["age"].values
    want1 = numpy_1hop_count(snap, age > 40, age < 30)
    want2 = numpy_2hop_count(snap, age > 40, np.ones(V, bool), age < 30)
    want3 = numpy_q3_rows(np, snap, Q3_K)
    sync = torch.cuda.synchronize if db.device.type == "cuda" else (lambda: None)
    K.reset_launches()
    r1 = db.query(Q1).to_dicts()
    sync()
    after1 = dict(K.LAUNCHES)
    r2 = db.query(Q2).to_dicts()
    sync()
    after2 = dict(K.LAUNCHES)
    r3 = db.query(Q3, {"k": Q3_K}).to_dicts()
    sync()
    launches = dict(K.LAUNCHES)
    for name, before, after in (
        ("Q1", {}, after1), ("Q2", after1, after2), ("Q3", after2, launches)
    ):
        per = {k: after[k] - before.get(k, 0) for k in after}
        print(f"launches {name}: {sum(per.values())} {per}")
    _require(r1 == [{"n": want1}], f"Q1 {r1} != numpy {want1}")
    _require(r2 == [{"n": want2}], f"Q2 {r2} != numpy {want2}")
    got3 = np.array([(r["p"], r["f"], r["g"]) for r in r3], np.int64).reshape(-1, 3)
    got3 = got3[np.lexsort(got3.T[::-1])]
    _require(
        got3.shape == want3.shape and np.array_equal(got3, want3),
        "Q3 rows differ from numpy",
    )
    if db.device.type == "cuda":
        missing = [n for n, c in launches.items() if c == 0]
        _require(not missing, f"kernels never launched on the main path: {missing}")
    print(f"slice: Q1={want1} Q2={want2} Q3 rows={len(r3)}; launches {launches}")
    for name, sql, params, rows in (
        ("Q1", Q1, None, 1),
        ("Q2", Q2, None, 1),
        ("Q3", Q3, {"k": Q3_K}, len(r3)),
    ):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            db.query(sql, params).to_dicts()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(times)
        print(
            f"query {name}: median {med:.3f} ms over {len(times)} runs "
            f"(runs {[round(t, 3) for t in times]}), {rows / med * 1e3:.1f} rows/s [{card}]"
        )
        print(f"layers {name}: {query_layers(torch, db, sql, params, sync)}")
        if db.device.type == "cuda":
            print(f"device {name}: {device_share(torch, db, sql, params, med)}")
    return launches


def query_layers(torch, db, sql, params, sync) -> str:
    """Median ms of the query's layers over 3 runs: parse + plan + predicate
    compile, the device solve (with its host syncs), and row marshalling."""
    from orientdb_tpu_torch.exec.result import ResultSet
    from orientdb_tpu_torch.exec.tpu_engine import TpuMatchSolver
    from orientdb_tpu_torch.sql.parser import parse

    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        solver = TpuMatchSolver(db, parse(sql), dict(params or {}))
        t1 = time.perf_counter()
        table = solver.solve_table()
        sync()
        t2 = time.perf_counter()
        ResultSet(solver.rows_from_table(table)).to_dicts()
        t3 = time.perf_counter()
        runs.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
    plan, solve, marshal = (statistics.median(r[i] for r in runs) for i in range(3))
    return (
        f"plan {plan:.3f} ms, solve {solve:.3f} ms "
        f"({len(solver.sched.values)} observed sizes), marshal {marshal:.3f} ms"
    )


def device_share(torch, db, sql, params, wall_ms: float) -> str:
    """Kernel time on the card for one profiled run of the query
    (torch.profiler), against that run's own wall time: the device's busy
    share. The profiler slows the run; ``wall_ms`` is the unprofiled
    median, printed beside it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        db.query(sql, params).to_dicts()
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or 0

    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if busy_ms == 0:
        return "kernel time not measured (the profiler saw no device activity)"
    top = sorted(events, key=dev_us, reverse=True)[:6]
    tops = ", ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms x{e.count}" for e in top)
    return (
        f"kernels {busy_ms:.3f} ms in a profiled run of {run_ms:.3f} ms "
        f"(unprofiled median {wall_ms:.3f} ms): busy {busy_ms / run_ms:.1%}, "
        f"idle {1 - busy_ms / run_ms:.1%}; top: {tops}"
    )


def main() -> int:
    import numpy as np
    import torch

    from orientdb_tpu_torch.ops import _kernels
    from orientdb_tpu_torch.ops import csr as K
    from orientdb_tpu_torch.ops.device_graph import device_graph
    from orientdb_tpu_torch.storage.bigshape import build_person_knows

    # 1. device
    _require(torch.cuda.is_available(), "CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _kernels.load()
    print(f"build: {time.perf_counter() - t0:.1f} s")

    # the SF100-shape graph (set-up: host build, then upload)
    t0 = time.perf_counter()
    db, snap = build_person_knows(8_000_000, avg_knows=10, seed=5)
    dg = device_graph(snap, db.device)
    torch.cuda.synchronize()
    print(
        f"graph: V={snap.num_vertices} E={snap.edge_classes['knows'].num_edges}, "
        f"built and uploaded in {time.perf_counter() - t0:.1f} s"
    )

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    ks = check_kernels(torch, K, dg)
    print(f"kernels: all equal their plain versions ({time.perf_counter() - t0:.1f} s)")

    # 4. the slice through the port's front door
    torch.cuda.reset_peak_memory_stats()
    launches = run_slice(np, torch, K, db, snap, card)
    mem = dg.memory_report()
    print(
        f"memory: graph {mem['total_bytes']} bytes on the card "
        f"{mem['per_device']}, host-only columns {mem['pruned_bytes']} bytes; "
        f"peak allocated during the slice {torch.cuda.max_memory_allocated()} bytes"
    )
    for name, row in ks.rows.items():
        row["launches"] = launches[name]
        row["max_abs_err"] = ks.err[name]
        print(
            f"kernel {name}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']}, bound {row['bound_ms']:.4f} ms, "
            f"launches {row['launches']}"
        )
    _require(set(ks.rows) == set(REPLACES), "a kernel was not timed")
    print(json.dumps({"kernels": [ks.rows[n] for n in REPLACES]}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
