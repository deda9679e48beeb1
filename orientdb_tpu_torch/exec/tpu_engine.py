"""Port of `orientdb_tpu/exec/tpu_engine.py`, the compiled MATCH solver on
one device, run eagerly.

As in the reference:
- the pattern compiles to a static plan of steps (root scan, edge
  expansion) whose order replays the reference planner's greedy
  smallest-candidate-first choice (`build_plan`);
- intermediate state is a binding table: one int32 device column per
  alias (dense vertex index, -1 = null / padding) and a per-slot validity
  mask;
- each pattern-edge hop is a batched CSR count → scan → gather
  (`ops/csr.py`, hand-written CUDA kernels on the card) with node WHERE
  clauses applied as columnar masks (`ops/predicates.py`);
- a lone ``RETURN count(*)`` collapses its terminal chain of hops into
  per-vertex weight passes over the edge list (the COUNT pushdown), with a
  float32 twin that refuses int32 overflow;
- rows marshal through the reference's columnar fast path and the
  DISTINCT / ORDER BY / SKIP / LIMIT tail.

Every query runs the way the reference runs its first (recording)
execution: eagerly, observing each frontier size on the host to size the
next buffer (`SizeSchedule`). The reference's jitted replay of a recorded
plan (`_CompiledPlan`) is not ported yet. A MATCH shape outside this slice
raises `Uncompilable` with the reason; nothing falls back to an
interpreter.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from orientdb_tpu_torch.exec.eval import EvalContext, contains_aggregate
from orientdb_tpu_torch.exec.oracle import (
    MatchInterpreter,
    Pattern,
    PatternEdge,
    PatternNode,
    _REVERSE_DIR,
    _expr_uses_bindings,
    _match_proj_name,
    _order_rows,
    _skip_limit,
    expr_name,
    finalize_match_rows,
)
from orientdb_tpu_torch.exec.result import ColumnarRows, Result
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.ops.device_graph import DeviceGraph, device_graph
from orientdb_tpu_torch.ops.predicates import (
    ColumnScope,
    ParamBox,
    Uncompilable,
    compile_predicate,
)
from orientdb_tpu_torch.sql import ast as A
from orientdb_tpu_torch.utils.config import config

I32 = torch.int32


# ---------------------------------------------------------------------------
# binding table
# ---------------------------------------------------------------------------


class Table:
    """Device binding table: padded columns + a host-known valid count."""

    def __init__(self, device: torch.device, count: int = 1, width: int = 0) -> None:
        self.device = device
        #: alias → int32 [width] dense vertex index (-1 null / padding)
        self.cols: Dict[str, torch.Tensor] = {}
        self.count = count  # valid rows; starts at 1 (the empty binding)
        self.width = width  # bucketed column length (0 = no columns yet)
        #: device twin of `count` (0-d int32); None until a step sets it
        self.count_dev: Optional[torch.Tensor] = None
        #: per-slot liveness (int32 1/0); None ≡ arange(width) < count
        self.valid: Optional[torch.Tensor] = None

    @property
    def count_device(self) -> torch.Tensor:
        if self.count_dev is None:
            return torch.tensor(self.count, dtype=I32, device=self.device)
        return self.count_dev

    @property
    def valid_device(self) -> torch.Tensor:
        if self.valid is not None:
            return self.valid
        pos = torch.arange(max(self.width, 1), dtype=I32, device=self.device)
        return (pos < self.count_device).to(I32)

    def empty(self) -> bool:
        return self.count == 0

    def gather(self, rows: torch.Tensor) -> "Table":
        """New table selecting `rows` (padded with -1) from this one."""
        t = Table(self.device, count=self.count, width=int(rows.shape[0]))
        for a, c in self.cols.items():
            t.cols[a] = K.take_pad(c, rows, -1)
        t.valid = K.take_pad(self.valid_device, rows, 0)
        return t


def _concat_tables(parts: List[Table], counts: List[int], device) -> Table:
    """Concatenate gathered part-tables (same column sets). Parts keep their
    full bucketed capacity; liveness flows through the valid mask."""
    total = sum(counts)
    cap = sum(p.width for p in parts)
    out = Table(device, count=total, width=max(cap, K.bucket(0)))
    if not parts:
        out.count = 0
        out.count_dev = torch.zeros((), dtype=I32, device=device)
        return out
    out.count_dev = parts[0].count_device
    for p in parts[1:]:
        out.count_dev = out.count_dev + p.count_device
    for a in parts[0].cols.keys():
        out.cols[a] = _pad_concat([p.cols[a] for p in parts], out.width, device)
    out.valid = _pad_concat([p.valid_device for p in parts], out.width, device, pad=0)
    return out


def _pad_concat(segs: List[torch.Tensor], width: int, device, pad: int = -1) -> torch.Tensor:
    cat = torch.cat(segs) if segs else torch.zeros(0, dtype=I32, device=device)
    n = width - cat.shape[0]
    if n > 0:
        cat = torch.cat([cat, torch.full((n,), pad, dtype=I32, device=device)])
    return cat


# ---------------------------------------------------------------------------
# size schedule
# ---------------------------------------------------------------------------


def _cap_of(n: int) -> int:
    """Buffer capacity for an observed count: bucketed with
    ``config.schedule_headroom`` growth, as the reference sizes it."""
    if n <= 0:
        return K.bucket(0)
    return K.bucket(max(1, int(n * config.schedule_headroom)))


def _observe_compact(sched: "SizeSchedule", mask: torch.Tensor):
    """Shared compaction protocol: surviving-row indices sized via the
    schedule (one blocking sync). Returns (indices, host count, device
    count)."""
    count_dev = K.mask_count(mask)
    count = sched.observe(count_dev)
    return K.compact_indices(mask, _cap_of(count)), count, count_dev


class SizeSchedule:
    """Host observations of device scalars (frontier totals, compact
    counts), in the order the solve takes them.

    PyTorch runs eagerly, so every solve is what the reference calls a
    recording run: each observation is one blocking device→host read that
    sizes the next buffer. The recorded values are what a captured replay
    will need."""

    def __init__(self) -> None:
        self.values: List[int] = []

    def observe(self, dev_scalar: torch.Tensor) -> int:
        v = int(dev_scalar)
        self.values.append(v)
        return v


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


class PlanStep:
    __slots__ = ("kind", "alias", "edge", "reverse", "close")

    def __init__(self, kind, alias=None, edge=None, reverse=False, close=False):
        self.kind = kind  # 'root' | 'expand'
        self.alias = alias
        self.edge: Optional[PatternEdge] = edge
        self.reverse = reverse
        self.close = close

    def describe(self) -> str:
        if self.kind == "root":
            return f"ROOT {self.alias}"
        e = self.edge
        arrow = "<-" if self.reverse else "->"
        return f"{self.kind.upper()} {e.from_alias}{arrow}{e.to_alias}"


def build_plan(pattern: Pattern, interp: MatchInterpreter) -> List[PlanStep]:
    """Static replay of the reference's greedy edge ordering: the bound
    alias set evolves independently of the data, so the order is known
    before any device work."""
    steps: List[PlanStep] = []
    bound: set = set()
    required = [e for e in pattern.edges if not interp._edge_is_optional(e)]
    optionals = [e for e in pattern.edges if interp._edge_is_optional(e)]
    edges = list(required)
    while edges:
        def rank(e: PatternEdge) -> int:
            fb, tb = e.from_alias in bound, e.to_alias in bound
            if fb and tb:
                return 0
            if fb:
                return 1
            if tb:
                return 2
            return 3

        order = sorted(range(len(edges)), key=lambda i: rank(edges[i]))
        i = order[0]
        e = edges.pop(i)
        r = rank(e)
        if r == 3:
            fn, tn = pattern.nodes[e.from_alias], pattern.nodes[e.to_alias]
            root = fn if interp.estimate(fn) <= interp.estimate(tn) else tn
            steps.append(PlanStep("root", alias=root.alias))
            bound.add(root.alias)
            edges.insert(0, e)
            continue
        if r == 0:
            steps.append(PlanStep("expand", edge=e, close=True))
        elif r == 1:
            steps.append(PlanStep("expand", edge=e))
        else:
            steps.append(PlanStep("expand", edge=e, reverse=True))
        bound.add(e.from_alias)
        bound.add(e.to_alias)
    for n in interp.enumerable_isolated(required, optionals):
        if n.alias in bound:
            continue
        steps.append(PlanStep("root", alias=n.alias))
        bound.add(n.alias)
    return steps


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------


class TpuMatchSolver:
    def __init__(self, db, stmt: A.MatchStatement, params: Dict) -> None:
        self.db = db
        self.stmt = stmt
        self.params = params
        self.param_box = ParamBox(params)
        snap = db.current_snapshot()
        if snap is None:
            raise Uncompilable("no snapshot attached")
        self.snap = snap
        self.device = db.device
        self.interp = MatchInterpreter(db, stmt, params)
        self.pattern = self.interp.pattern
        self.not_paths = self.interp.not_paths
        self._check_supported()
        self._check_returns()
        self.plan = build_plan(self.pattern, self.interp)
        self.dg: DeviceGraph = device_graph(snap, db.device)
        self.sched = SizeSchedule()
        self._vertex_scope_cache: Optional[ColumnScope] = None
        # compile every node predicate up front: an unsupported one fails
        # before any device work
        self._node_masks = {
            alias: self._compile_node(node) for alias, node in self.pattern.nodes.items()
        }

    # -- compile-time gating ------------------------------------------------

    def _check_supported(self) -> None:
        """Refuse, with the reason, every MATCH shape this slice does not
        compile."""
        if self.not_paths:
            raise Uncompilable("NOT arms are not compiled in this slice")
        for e in self.pattern.edges:
            item = e.item
            if (item.method or "").lower() in (
                "oute", "ine", "bothe", "outv", "inv", "bothv"
            ):
                raise Uncompilable("edge binding (outE/inE/outV/inV arms)")
            if item.target.while_cond is not None or item.target.max_depth is not None:
                raise Uncompilable("variable-depth arm (WHILE / maxDepth)")
            if item.target.path_alias or item.target.depth_alias:
                raise Uncompilable("pathAlias / depthAlias")
            if item.negated:
                raise Uncompilable("negated path item")
            if self.interp._edge_is_optional(e):
                raise Uncompilable("OPTIONAL arm")
            f = item.edge_filter
            if f is not None and f.alias:
                raise Uncompilable("edge alias binding")
            if f is not None and f.where is not None:
                raise Uncompilable("edge WHERE")
        for node in self.pattern.nodes.values():
            for f in node.filters:
                if f.rid is not None:
                    raise Uncompilable("rid filter")
                if f.where is not None and _expr_uses_bindings(
                    f.where, self.pattern.nodes
                ):
                    raise Uncompilable("WHERE referencing other aliases")

    def _check_returns(self) -> None:
        """The slice marshals a lone count(*) or alias.property columns
        straight from the snapshot; any other RETURN needs host records."""
        stmt = self.stmt
        if stmt.group_by or stmt.unwind:
            raise Uncompilable("GROUP BY / UNWIND")
        if self.count_only_name() is not None:
            return
        for p in stmt.returns:
            e = p.expr
            if contains_aggregate(e):
                raise Uncompilable("aggregate RETURN other than a lone count(*)")
            if not (
                isinstance(e, A.FieldAccess)
                and isinstance(e.base, A.Identifier)
                and e.base.name in self.pattern.nodes
            ):
                raise Uncompilable(
                    "RETURN shape needs host records (only alias.property "
                    "and a lone count(*) are compiled)"
                )
            if e.name in self.snap.v_non_columnar or e.name.startswith("@"):
                raise Uncompilable(f"RETURN of non-columnar property {e.name!r}")

    # -- predicate compilation ---------------------------------------------

    def _vertex_scope(self) -> ColumnScope:
        if self._vertex_scope_cache is None:
            self._vertex_scope_cache = ColumnScope(
                self.dg.columns,
                self.dg.non_columnar,
                reserved=set(self.pattern.nodes.keys()),
            )
        return self._vertex_scope_cache

    def _compile_node(self, node: PatternNode):
        """Node admission mask: fn(idx) -> bool mask over vertex ids
        (class closure ∧ WHERE, padding excluded)."""
        parts = []
        for f in node.filters:
            if f.class_name:
                parts.append(self._class_mask_fn(self.dg.class_ids(f.class_name)))
            if f.where is not None:
                parts.append(
                    compile_predicate(f.where, self._vertex_scope(), self.param_box)
                )

        def mask(idx, parts=parts):
            m = idx >= 0
            for p in parts:
                m = m & p(idx, {})
            return m

        return mask

    def _class_mask_fn(self, ids: torch.Tensor):
        def fn(idx, env, ids=ids):
            if ids.shape[0] == 0:
                return torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
            return torch.isin(K.take_pad(self.dg.v_class, idx, -1), ids)

        return fn

    # -- execution ----------------------------------------------------------

    def _compact(self, mask):
        return _observe_compact(self.sched, mask)

    def _expand_csr(self, indptr, nbrs, srcs):
        counts = K.degree_counts(indptr, srcs)
        offsets = K.exclusive_cumsum(counts)
        total_dev = K.value_sum(counts)
        total = self.sched.observe(total_dev)
        row, _edge_pos, nbr = K.gather_expand(
            indptr, nbrs, srcs, offsets, total_dev, _cap_of(total)
        )
        return row, nbr, total

    def _expand_one_dir_chunked(self, dec, d: str, srcs):
        """Expansion slabs for one (class, direction): usually ONE
        ``(row, nbr, total)``, but when the output would exceed
        config.max_expansion_cap rows, the binding table splits into
        contiguous row ranges expanded separately, so buffers stay bounded
        however large the fan-out."""
        cap = max(1, config.max_expansion_cap)
        indptr = dec.indptr_out if d == "out" else dec.indptr_in
        total = self.sched.observe(K.value_sum(K.degree_counts(indptr, srcs)))
        n_chunks = max(1, -(-_cap_of(total) // cap))
        if n_chunks == 1:
            return [self._expand_one_dir(dec, d, srcs)]
        width = int(srcs.shape[0])
        step = -(-width // n_chunks)
        slabs = []
        for a in range(0, width, step):
            row, nbr, t = self._expand_one_dir(dec, d, srcs[a : a + step])
            row = torch.where(row >= 0, row + a, row)  # local → table rows
            slabs.append((row, nbr, t))
        return slabs

    def _expand_one_dir(self, dec, d: str, srcs):
        """One (edge class, direction) expansion → (row, neighbor, host
        total). Edge ids are not carried: edge WHERE and edge binding are
        not in this slice."""
        if d == "out":
            return self._expand_csr(dec.indptr_out, dec.dst, srcs)
        return self._expand_csr(dec.indptr_in, dec.src, srcs)

    def solve_table(self) -> Table:
        pushdown = self._count_pushdown_steps()
        steps = self.plan[: len(self.plan) - len(pushdown)] if pushdown else self.plan
        table = Table(self.device, count=1, width=0)
        for step in steps:
            if table.empty():
                return table
            if step.kind == "root":
                table = self._root(table, step.alias)
            else:
                table = self._expand(table, step)
        if pushdown and not table.empty():
            return self._apply_count_pushdown(table, pushdown)
        return table

    # -- COUNT(*) aggregate pushdown ----------------------------------------

    def _count_pushdown_steps(self) -> List[PlanStep]:
        """Longest plan suffix of terminal chain expansions a lone COUNT(*)
        can aggregate without materializing binding tables: each terminal
        hop collapses to one O(E) segment-sum pass —
        ``w_k[v] = Σ_{edges v→u} mask(u)·w_{k+1}[u]`` — and the count is
        ``Σ_rows w_1[src]``."""
        if self.count_only_name() is None or self.stmt.group_by:
            return []
        suffix: List[PlanStep] = []
        for step in reversed(self.plan):
            if step.kind != "expand" or step.close:
                break
            e = step.edge
            dst_alias = e.from_alias if step.reverse else e.to_alias
            # dst must be terminal: touched by no other edge than this one
            # and (for non-last suffix members) the src of the next step
            used_elsewhere = False
            for e2 in self.pattern.edges:
                if e2 is e:
                    continue
                in_suffix_head = suffix and e2 is suffix[0].edge
                if dst_alias in (e2.from_alias, e2.to_alias) and not in_suffix_head:
                    used_elsewhere = True
            if used_elsewhere:
                break
            if suffix:
                nxt = suffix[0]
                nxt_src = nxt.edge.to_alias if nxt.reverse else nxt.edge.from_alias
                if nxt_src != dst_alias:
                    break
            suffix.insert(0, step)
        return suffix

    def _apply_count_pushdown(self, table: Table, steps: List[PlanStep]) -> Table:
        first = steps[0]
        src_alias = first.edge.to_alias if first.reverse else first.edge.from_alias
        srcs = table.cols.get(src_alias)
        if srcs is None:
            raise Uncompilable(f"alias {src_alias} not bound before expansion")
        w = self._pushdown_weights(steps, torch.int32)
        total_dev = K.value_sum(K.take_pad(w, srcs, 0))
        # int32 overflow guard: a float32 twin of the whole weight chain
        # detects wraps anywhere in the segment sums — float32 is inexact
        # above 2^24 but its ~1e-7 relative error is far below the mismatch
        # a wrap produces
        wf = self._pushdown_weights(steps, torch.float32)
        approx = float(K.value_sum(K.take_pad(wf, srcs, 0.0)))
        exact = int(total_dev)
        if not (
            0 <= approx < 2**31 * 0.99
            and abs(approx - exact) <= max(1e-3 * approx, 1.0)
        ):
            raise Uncompilable(
                f"COUNT pushdown overflows int32 (≈{approx:.6g} vs {exact})"
            )
        t = Table(self.device, count=self.sched.observe(total_dev), width=0)
        t.count_dev = total_dev
        return t

    def _pushdown_weights(self, steps: List[PlanStep], dtype) -> torch.Tensor:
        V = self.dg.num_vertices
        vb = K.bucket(max(V, 1))
        # vertex universe for [vb]-wide node-mask precomputes, used where
        # the edge list outnumbers the vertices: one bool gather per edge
        # then replaces re-evaluating the predicate's column gathers
        univ = torch.arange(vb, dtype=I32, device=self.device)
        univ = torch.where(univ < V, univ, -1)
        w = None  # None ≡ all-ones (the implicit weight after the last hop)
        for step in reversed(steps):
            w = self._pushdown_weight_step(step, w, univ, vb, dtype)
        return w

    def _pushdown_weight_step(self, step, w, univ, vb, dtype):
        item = step.edge.item
        direction = item.direction
        if step.reverse:
            direction = _REVERSE_DIR[direction]
        dst_alias = step.edge.from_alias if step.reverse else step.edge.to_alias
        node_mask = self._node_masks[dst_alias]
        classes = self._resolve_edge_classes(item)
        ok_vec = (
            node_mask(univ)
            if any(self.dg.edges[c].num_edges >= vb for c in classes)
            else None
        )
        new_w = torch.zeros(vb, dtype=dtype, device=self.device)
        for cname in classes:
            dec = self.dg.edges[cname]
            E = dec.num_edges
            if E == 0:
                continue
            for d in ("out", "in") if direction == "both" else (direction,):
                # both CSR orders are on the device, so either direction
                # sums per vertex with indptr_segment_sum
                if d == "out":
                    emit, ip = dec.dst, dec.indptr_out
                else:
                    emit, ip = dec.src, dec.indptr_in
                if E >= vb:
                    contrib = K.take_pad(ok_vec, emit, False)
                else:
                    contrib = node_mask(emit)
                vals = contrib.to(dtype)
                if w is not None:
                    vals = vals * K.take_pad(w, emit, 0)
                new_w = new_w + K.indptr_segment_sum(vals, ip, vb)
        return new_w

    # -- roots and expansions ----------------------------------------------

    def _root_candidates(self, alias: str):
        """Candidate scan for a root alias, restricted to the dense-index
        hull of its class filters' polymorphic closures (each concrete
        class is one contiguous slab). Admission masks still run in full:
        the hull can contain foreign vertices."""
        node = self.pattern.nodes[alias]
        start, end = 0, self.dg.num_vertices
        for f in node.filters:
            if f.class_name:
                lo, hi = self.snap.vertex_hull(f.class_name)
                start, end = max(start, lo), min(end, hi)
        size = max(end - start, 0)
        idx = start + torch.arange(K.bucket(max(size, 1)), dtype=I32, device=self.device)
        idx = torch.where(idx < end, idx, -1)
        cand, n, n_dev = self._compact(self._node_masks[alias](idx))
        return K.take_pad(idx, cand, -1), n, n_dev

    def _root(self, table: Table, alias: str) -> Table:
        cand, n, n_dev = self._root_candidates(alias)
        if table.width == 0 and not table.cols:
            t = Table(self.device, count=n, width=int(cand.shape[0]))
            t.cols[alias] = cand
            t.count_dev = n_dev
            t.valid = (cand >= 0).to(I32)
            return t
        # cartesian product with the existing table; live rows may sit among
        # bucket padding, and the pairing indexes a contiguous prefix, so
        # compact first
        live = table.valid_device[: table.width].to(torch.bool)
        keep, packed_n, packed_dev = self._compact(live)
        table = table.gather(keep)
        table.count = packed_n
        table.count_dev = packed_dev
        old_n, new_n = table.count, n
        total = old_n * new_n
        width = K.bucket(max(total, 1))
        if new_n == 0:
            rows = torch.full((width,), -1, dtype=I32, device=self.device)
            t = table.gather(rows)
            t.count = 0
            t.count_dev = torch.zeros((), dtype=I32, device=self.device)
            t.cols[alias] = rows
            return t
        pos = torch.arange(width, dtype=I32, device=self.device)
        valid = pos < total
        rows = torch.where(valid, pos // new_n, -1)
        sel = torch.where(valid, pos % new_n, -1)
        t = table.gather(rows)
        t.count = total
        t.count_dev = table.count_device * n_dev
        t.cols[alias] = K.take_pad(cand, sel, -1)
        return t

    def _resolve_edge_classes(self, item: A.MatchPathItem) -> List[str]:
        """Concrete edge classes for a path item, with the edge-filter's
        class restriction applied as a host-side subclass check."""
        names = item.edge_classes or (None,)
        concrete: List[str] = []
        for nm in names:
            concrete.extend(self.snap.concrete_edge_classes(nm))
        f = item.edge_filter
        if f is not None and f.class_name:
            keep = []
            for c in concrete:
                cls = self.db.schema.get_class(c)
                if cls is not None and cls.is_subclass_of(f.class_name):
                    keep.append(c)
            concrete = keep
        return concrete

    def _expand(self, table: Table, step: PlanStep) -> Table:
        """One required (non-optional) arm: expand every live row over the
        arm's edge classes and directions, admit the reached vertices, and
        compact the survivors into a new table."""
        e = step.edge
        item = e.item
        direction = item.direction
        if step.reverse:
            direction = _REVERSE_DIR[direction]
        src_alias = e.to_alias if step.reverse else e.from_alias
        dst_alias = e.from_alias if step.reverse else e.to_alias
        srcs = table.cols.get(src_alias)
        if srcs is None:
            raise Uncompilable(f"alias {src_alias} not bound before expansion")
        node_mask = self._node_masks[dst_alias]
        parts: List[Table] = []
        counts: List[int] = []
        for cname in self._resolve_edge_classes(item):
            dec = self.dg.edges[cname]
            for d in ("out", "in") if direction == "both" else (direction,):
                for row, nbr, total in self._expand_one_dir_chunked(dec, d, srcs):
                    if total == 0:
                        continue
                    mask = (row >= 0) & node_mask(nbr)
                    if step.close:
                        bound = K.take_pad(table.cols[dst_alias], row, -2)
                        mask = mask & (nbr == bound)
                    keep, kn, kn_dev = self._compact(mask)
                    if kn == 0:
                        continue
                    part = table.gather(K.take_pad(row, keep, -1))
                    part.count = kn
                    part.count_dev = kn_dev
                    part.cols[dst_alias] = K.take_pad(nbr, keep, -1)
                    parts.append(part)
                    counts.append(kn)
        if not parts:
            # preserve column structure for downstream steps
            t = table.gather(torch.full((K.bucket(1),), -1, dtype=I32, device=self.device))
            t.count = 0
            t.count_dev = torch.zeros((), dtype=I32, device=self.device)
            t.cols[dst_alias] = torch.full((t.width,), -1, dtype=I32, device=self.device)
            return t
        return _concat_tables(parts, counts, self.device)

    # -- marshalling --------------------------------------------------------

    @staticmethod
    def _live_rows(table: Table):
        """Row selector for marshalling: live rows may sit among bucket
        padding, and the valid mask is authoritative."""
        if table.valid is None:
            return np.arange(table.count)
        return np.flatnonzero(table.valid.cpu().numpy() > 0)

    def count_only_name(self) -> Optional[str]:
        """Projection name when RETURN is a lone COUNT(*) (no grouping)."""
        stmt = self.stmt
        if stmt.group_by or stmt.unwind:
            return None
        r = stmt.returns
        if (
            len(r) == 1
            and isinstance(r[0].expr, A.FunctionCall)
            and r[0].expr.name.lower() == "count"
            and len(r[0].expr.args) == 1
            and isinstance(r[0].expr.args[0], A.Star)
        ):
            return r[0].alias or expr_name(r[0].expr, 0)
        return None

    def finalize_count(self, name: str, count: int) -> List[Result]:
        # aggregate path applies only ORDER/SKIP/LIMIT (no DISTINCT)
        out = [Result(props={name: count})]
        out = _order_rows(out, self.stmt.order_by, self.db, self.params, None)
        return _skip_limit(
            out, self.stmt.skip, self.stmt.limit, EvalContext(self.db, params=self.params)
        )

    def rows_from_table(self, table: Table):
        """Result rows straight from the device columns: a lone count(*) is
        the table's count; ``alias.prop`` projections decode the snapshot's
        host columns at the bound vertex ids (`_check_returns` admitted
        only these shapes)."""
        name = self.count_only_name()
        if name is not None:
            return self.finalize_count(name, table.count)
        stmt = self.stmt
        sel = self._live_rows(table)
        n = int(sel.shape[0])
        names = []
        obj_cols = []
        host_cols: Dict[str, np.ndarray] = {}
        for i, p in enumerate(stmt.returns):
            e = p.expr
            names.append(p.alias or _match_proj_name(e, i))
            alias = e.base.name
            if alias not in host_cols:
                dev_col = table.cols.get(alias)
                host_cols[alias] = (
                    dev_col.cpu().numpy()[sel] if dev_col is not None
                    else np.full(n, -1, np.int32)
                )
            idx = host_cols[alias]
            col = self.snap.v_columns.get(e.name)
            if col is None:
                obj_cols.append(np.full(n, None, object))  # never present
                continue
            ci = np.clip(idx, 0, max(len(col.values) - 1, 0))
            vals = col.values[ci]
            pres = col.present[ci] & (idx >= 0)
            if col.kind == "str":
                d = col.dict_array()
                o = d[np.clip(vals, 0, len(d) - 1)]
            elif col.kind == "bool":
                o = (vals != 0).astype(object)
            elif col.kind == "float":
                o = vals.astype(float).astype(object)
            else:
                o = vals.astype(object)
            o[~pres] = None
            obj_cols.append(o)
        if not (stmt.distinct or stmt.order_by or stmt.skip or stmt.limit):
            return ColumnarRows(names, [c.tolist() for c in obj_cols], n)
        out = [Result(props=dict(zip(names, r))) for r in zip(*obj_cols)]
        return finalize_match_rows(self.db, stmt, out, self.params, None)


def execute(db, stmt: A.MatchStatement, params: Dict):
    """Solve one MATCH statement on the database's device; the rows."""
    solver = TpuMatchSolver(db, stmt, params)
    return solver.rows_from_table(solver.solve_table())
