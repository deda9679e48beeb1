"""Port of `orientdb_tpu/exec/tpu_engine.py`, the compiled MATCH, SELECT and
TRAVERSE solvers on one device: an eager recording run, then captured
replays.

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
- a variable-depth arm (``while:`` / ``maxDepth:`` / ``depthAlias:``) walks
  the graph breadth-first in chunks of binding rows, one ``[rows,
  bucket(V)]`` bool bitmap per chunk and level (the bitmap-BFS kernels
  K9–K12), emitting each vertex at its minimum discovery depth; a NOT arm
  is the same bitmap chain run as an anti-join;
- a lone ``RETURN count(*)`` collapses its terminal chain of hops into
  per-vertex weight passes over the edge list (the COUNT pushdown), or a
  terminal variable-depth arm into per-level popcounts, with a float32
  twin that refuses int32 overflow;
- on a snapshot padded for delta maintenance (`storage/deltas`), each
  expansion also reads the edge class's append slab (K18 `slab_probe`
  through the bucket tables, K17 `slab_scan` once a bucket overflowed),
  tombstoned base slots become padding, bitmap hops mask on the ``live``
  edge mask (and, once the topology is dirty, also walk the slab's slots
  with the edge-list K10) and classless nodes on ``v_class >= 0``; plans
  carry the overlay's generation and re-record when the structure moves;
- on a tiered snapshot (`storage/tiering`), a paged edge class expands
  through K21 `paged_expand` and hops through K19 `paged_hop` over the
  tier's page pools; the recording run faults every touched block in and
  the touched set becomes the plan's footprint, which each dispatch
  prefetches and pins; a replay's cold-miss flags (K21's, K20
  `paged_hop_miss`) join its overflow flag, and a pool that grew into new
  tensors sends the plans captured before it back to a re-record;
- on a snapshot attached with a mesh (`parallel/`), an expansion is the
  shards' K2 range-form totals then K22 `shard_gather` (no chunking), a
  bitmap hop K10's eid form over the edge-list slices, a COUNT weight pass
  K23 `shard_weight_pass`, and an endpoint step reads the sharded edge list;
  a plan over `LocalShards` captures as any other, one over `ProcessShards`
  replays uncaptured (its merges are collectives), and mesh plans replay
  one by one in a batch;
- rows marshal through the reference's columnar fast path and the
  DISTINCT / ORDER BY / SKIP / LIMIT tail; a vertex alias's record
  renders as its RID (``p``, ``p.@rid``), and ``$elements`` and a
  whole-record SELECT return record rows (`exec/result.RecordRows`); a
  rid filter is one more term of the node's predicate program;
- a SELECT over a class compiles as a single-node MATCH
  (`exec/select_compile`, verdicts cached per statement);
- a TRAVERSE (`TpuTraverseSolver`) is a level-wise bitmap BFS over one
  ``[1, vb]`` row from its resolved roots, admitting each level through
  its WHILE gate at ``$depth + 1`` and writing the level's vertex ids at
  their offset in one output buffer; its plan (`_CompiledTraverse`)
  replays as one captured graph with its roots and level counts baked.

The first execution of a statement records: it runs eagerly, observing
each frontier size on the host to size the next buffer (`SizeSchedule`),
and returns its rows. The recorded solve becomes a `_CompiledPlan` in a
per-snapshot plan cache; on a card the plan captures the replay-mode solve
as one CUDA graph (all plans of a device share one memory pool and replay
on one stream under a lock), and every later call, for any value of its
numeric parameters, uploads the parameters and replays that graph: no host
read, a device overflow flag that sends the call back to a re-record, the
live rows front-packed on the card and copied with the meta row into
pinned host memory. On the CPU a replay runs the same replay-mode solve
without capture. A batch (`execute_batch`) dispatches its cached plans
back to back: four or more items of one plan replay as one group graph
that runs the replay lane after lane on a stack of parameter rows, a plan
without numeric parameters replays once for all its items, and after one
wave of meta rows each row-returning item or group ships one page (a
group's cut from its lane stack by the `group_page` kernel). A shape
outside the compiled subset raises `Uncompilable` with the reason; nothing
falls back to an interpreter.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from orientdb_tpu_torch.exec.eval import EvalContext, contains_aggregate, evaluate
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
from orientdb_tpu_torch.exec.result import ColumnarRows, RecordRows, Result, rid_strings
from orientdb_tpu_torch.models.record import VertexRecord
from orientdb_tpu_torch.models.rid import RID
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.ops.device_graph import DeviceGraph, device_graph
from orientdb_tpu_torch.ops.predicates import (
    ColumnScope,
    ParamBox,
    Predicate,
    Uncompilable,
    class_term,
    compile_predicate,
    compile_where,
    id_term,
    live_term,
    pack_params,
    split_params,
    valid_term,
)
from orientdb_tpu_torch.ops.replay_stream import REPLAY_LOCK, on_replay_stream, replay_resources
from orientdb_tpu_torch.parallel import mesh_graph as MG
from orientdb_tpu_torch.sql import ast as A
from orientdb_tpu_torch.storage import tiering
from orientdb_tpu_torch.utils.config import config

I32 = torch.int32
F32 = torch.float32

#: smallest page (rows) of a replay's result ladder; pow2 rounding up from
#: here bounds the distinct page shapes per buffer to log2(W)
_PAGE_MIN = 1024
#: a rows group's compact page covers the lanes' largest live count rounded
#: up to a multiple of this many rows (capped at the full width)
_GROUP_PAGE_ROUND = 2048
#: minimum same-plan items of a batch that replay as one group
_GROUP_MIN = 4
#: slab expansions' buffer floor (delta-maintained snapshots): recordings
#: keep this many output slots even for a near-empty slab, so a filling slab
#: crosses few pow2 buckets (each crossing re-records)
SLAB_FLOOR = 256


# ---------------------------------------------------------------------------
# binding table
# ---------------------------------------------------------------------------


class Table:
    """Device binding table: padded columns + a host-known valid count."""

    def __init__(self, device: torch.device, count: int = 1, width: int = 0) -> None:
        self.device = device
        #: alias → int32 [width] dense vertex index (-1 null / padding)
        self.cols: Dict[str, torch.Tensor] = {}
        #: edge alias → (int32 [width] edge class index into the solver's
        #: `edge_class_list`, int32 [width] edge id in out order); -1 null
        self.edge_cols: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        #: depth alias → int32 [width] discovery depth (-1 null / padding)
        self.depth_cols: Dict[str, torch.Tensor] = {}
        self.count = count  # valid rows; starts at 1 (the empty binding)
        self.width = width  # bucketed column length (0 = no columns yet)
        #: device twin of `count` (0-d int32); None until a step sets it
        self.count_dev: Optional[torch.Tensor] = None
        #: per-slot liveness (int32 1/0); None ≡ arange(width) < count
        self.valid: Optional[torch.Tensor] = None

    @property
    def count_device(self) -> torch.Tensor:
        if self.count_dev is None:
            # a fill, not a host→device copy: capturable
            return torch.full((), self.count, dtype=I32, device=self.device)
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
        for a, (ci, eid) in self.edge_cols.items():
            t.edge_cols[a] = (K.take_pad(ci, rows, -1), K.take_pad(eid, rows, -1))
        for a, c in self.depth_cols.items():
            t.depth_cols[a] = K.take_pad(c, rows, -1)
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
    for a in parts[0].edge_cols.keys():
        out.edge_cols[a] = tuple(
            _pad_concat([p.edge_cols[a][i] for p in parts], out.width, device)
            for i in (0, 1)
        )
    for a in parts[0].depth_cols.keys():
        out.depth_cols[a] = _pad_concat([p.depth_cols[a] for p in parts], out.width, device)
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


def _observe_compact(
    sched: "SizeSchedule",
    mask: torch.Tensor,
    min_capacity: int = 0,
    count_dev: Optional[torch.Tensor] = None,
):
    """Shared compaction protocol: surviving-row indices sized via the
    schedule (one blocking sync on the recording run, free on a replay).
    ``count_dev`` is the mask's popcount when the caller has it already.
    Returns (indices, host count, device count)."""
    if count_dev is None:
        count_dev = K.mask_count(mask)
    count = sched.observe(count_dev, min_capacity=min_capacity)
    return (
        K.compact_indices(mask, max(min_capacity, _cap_of(count))),
        count,
        count_dev,
    )


class SizeSchedule:
    """Host observations of device scalars (frontier totals, compact
    counts), in the order the solve takes them.

    The recording run pays one blocking device→host read per observation
    to learn the buffer sizes. A replay (`start_replay`) reads none: each
    observation returns the recorded value, and every non-free one ORs
    ``live > capacity`` into a device ``overflow`` flag (capacity 0 where
    the recording saw 0 and skipped the work). A raised flag means the
    replay's buffers were too small for its parameters: the result is
    discarded and the caller re-records (buckets grow, so re-records
    converge). Live sizes under capacity flow through the table's device
    valid mask and count."""

    def __init__(self) -> None:
        self.values: List[int] = []
        self.pos = 0
        self.recording = True
        self.overflow: Optional[torch.Tensor] = None  # device bool on a replay

    def observe(self, dev_scalar: torch.Tensor, free: bool = False, min_capacity: int = 0) -> int:
        """``free=True`` marks a value that sizes no buffer and gates no
        control flow (the COUNT pushdown total), exempt from the overflow
        check. ``min_capacity`` is the buffer floor the call site allocates
        even for a recorded zero: replays may fill it without flagging."""
        if self.recording:
            v = int(dev_scalar)
            self.values.append(v)
            return v
        v = self.values[self.pos]
        self.pos += 1
        if not free:
            cap = max(min_capacity, _cap_of(v) if v > 0 else 0)
            flag = dev_scalar > cap
            self.overflow = flag if self.overflow is None else (self.overflow | flag)
        return v

    def note_flag(self, dev_flag: torch.Tensor) -> None:
        """OR a device failure bit computed elsewhere into the overflow flag
        (a tiered replay's cold-miss flag: a replay that wandered onto a
        block outside its footprint is discarded and re-records, which
        faults the block in). No-op while recording, which ensures
        residency eagerly."""
        if self.recording:
            return
        self.overflow = dev_flag if self.overflow is None else (self.overflow | dev_flag)

    def overflow_flag(self, device) -> torch.Tensor:
        if self.overflow is None:
            return torch.zeros((), dtype=torch.bool, device=device)
        return self.overflow

    def start_replay(self) -> None:
        self.recording = False
        self.pos = 0
        self.overflow = None


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


class PlanStep:
    __slots__ = ("kind", "alias", "edge", "reverse", "close")

    def __init__(self, kind, alias=None, edge=None, reverse=False, close=False):
        self.kind = kind  # 'root' | 'expand' | 'optional'
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


def _edge_class_of(node: PatternNode, interp: MatchInterpreter) -> Optional[str]:
    """The edge class (or ``E``) among ``node``'s class filters, if any."""
    for f in node.filters:
        cls = interp.db.schema.get_class(f.class_name) if f.class_name else None
        if cls is not None and cls.is_edge_type:
            return cls.name
    return None


def _root_step(node: PatternNode, interp: MatchInterpreter) -> PlanStep:
    """The root step of ``node``. A root scans the vertex hull of its
    classes, which an edge class (or ``E``) does not have: it would answer
    empty where the reference's oracle reads edge records, so it refuses.
    A SELECT over an edge class is such a root after its rewrite."""
    cls = _edge_class_of(node, interp)
    if cls is not None:
        raise Uncompilable(f"root {node.alias!r} scans edge class {cls!r} (edge records)")
    return PlanStep("root", alias=node.alias)


def build_plan(pattern: Pattern, interp: MatchInterpreter) -> List[PlanStep]:
    """Static replay of the reference's greedy edge ordering: the bound
    alias set evolves independently of the data, so the order is known
    before any device work. Required arms first (an arm's edge-filter
    alias binds with it), then the isolated roots, then the OPTIONAL arms
    in the order the reference's interpreter takes them: the first in
    list order with a bound endpoint, reversed when only its target is
    bound, closing when both are."""
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
            if _edge_class_of(root, interp) is not None:
                # an edge-class endpoint admits no vertex, from either end:
                # the answer is empty from the other side too, which has a
                # hull to scan
                root = tn if root is fn else fn
            steps.append(_root_step(root, interp))
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
        f = e.item.edge_filter
        if f is not None and f.alias:
            bound.add(f.alias)
    for n in interp.enumerable_isolated(required, optionals):
        if n.alias in bound:
            continue
        if n.is_edge_alias:
            raise Uncompilable("unbound edge alias would scan all edges")
        steps.append(_root_step(n, interp))
        bound.add(n.alias)
    opts = list(optionals)
    while opts:
        pick = next(
            (i for i, e in enumerate(opts) if e.from_alias in bound or e.to_alias in bound),
            None,
        )
        if pick is None:
            # fully detached optional arms bind nothing: their aliases
            # marshal as null
            break
        e = opts.pop(pick)
        fb, tb = e.from_alias in bound, e.to_alias in bound
        steps.append(PlanStep("optional", edge=e, reverse=not fb, close=fb and tb))
        bound.add(e.from_alias)
        bound.add(e.to_alias)
    return steps


_EDGE_METHODS = ("oute", "ine", "bothe")
_VERTEX_METHODS = ("outv", "inv", "bothv")


def _alias_expression(e: A.Expression, names: set) -> bool:
    """True when ``e`` is built of null tests, NOT / AND / OR and literals
    over bare alias names: a projection the port evaluates from which
    aliases a row binds, with no record behind them."""
    if isinstance(e, A.Identifier):
        return e.name in names
    if isinstance(e, A.Literal):
        return True
    if isinstance(e, A.IsNull):
        return _alias_expression(e.expr, names)
    if isinstance(e, A.Unary) and e.op == "NOT":
        return _alias_expression(e.expr, names)
    if isinstance(e, A.Binary) and e.op in ("AND", "OR"):
        return _alias_expression(e.left, names) and _alias_expression(e.right, names)
    return False


# ---------------------------------------------------------------------------
# bitmap hops (variable-depth arms and NOT arms)
# ---------------------------------------------------------------------------


def build_bitmap_hops(
    dg: DeviceGraph, items, sched: SizeSchedule, tier=None, touched=None, overlay=None
) -> List:
    """Frontier-hop closures for ``(class, direction, emask)`` items, each
    walking the class's CSR by the endpoint that must be active
    (`K.bitmap_hop_csr`): an out hop reads the rows of ``indptr_out`` and
    emits ``dst``, an in hop the rows of ``indptr_in`` and emits ``src``,
    its mask read through ``edge_id_in``; ``emask`` (bool [E] in out order,
    or None) admits the edges of an edge WHERE. Each closure maps a ``[C,
    vb]`` frontier (with an optional WHILE ``gate``, the frontier's device
    popcount ``alive``, and an ``out`` bitmap to OR into) to the bitmap of
    the vertices reached.

    On a delta-maintained snapshot whose topology is dirty (``overlay``),
    appended edges sit in the slab's out-order slots ``[base, cap)``, which
    no CSR row holds: each hop also runs the edge-list `K.bitmap_hop` over
    that whole slot range (``edge_src`` beside ``dst``, spare and
    tombstoned slots masked by ``live``), ORed into the same bitmap.
    Reading ``edge_src`` uploads it on the recording run.

    A (class, direction) that ``tier`` pages hops over its page pool (K19
    `paged_hop`) instead: while ``sched`` records, the gated frontier's
    blocks are faulted in first (into ``touched``, the plan's footprint);
    on a replay K20 `paged_hop_miss` raises the cold-miss flag into
    ``sched``. Both read the pools from ``dg.arrays`` at the hop, so a
    recording after a pool grew reads the new tensors.

    On a meshed snapshot every hop runs over the class's sharded edge list
    (`mesh_graph.sharded_bitmap_hop`, K10's eid form): an out hop activates
    on ``el:src`` and emits ``el:dst``, the mask read through ``el:eid``."""
    mg = dg.mesh_graph
    hops = []
    for cname, d, emask in items:
        if mg is not None:
            p = mg.edge[cname].prefix
            src_sh, dst_sh, eid_sh = (dg.arrays[f"{p}:el:{k}"] for k in ("src", "dst", "eid"))
            a_sh, e_sh = (src_sh, dst_sh) if d == "out" else (dst_sh, src_sh)
            hops.append(
                lambda fr, gate=None, alive=None, out=None, a=a_sh, em=e_sh, i=eid_sh, m=emask: (
                    MG.sharded_bitmap_hop(mg.mesh, a, em, i, m, fr, gate, alive, out)
                )
            )
            continue
        if tier is not None and tier.pages_dir(cname, d):

            def paged(fr, gate=None, alive=None, out=None, cname=cname, d=d, emask=emask):
                if sched.recording:
                    tier.ensure_frontier(cname, d, fr, touched, gate)
                else:
                    sched.note_flag(tiering.paged_hop_miss(dg.arrays, cname, d, fr, gate, alive))
                return tiering.paged_hop(dg.arrays, cname, d, emask, fr, gate, alive, out)

            hops.append(paged)
            continue
        dec = dg.edges[cname]
        if d == "out":
            csr = (dec.indptr_out, dec.dst, None)
        else:
            csr = (dec.indptr_in, dec.src, dec.edge_id_in)
        slab = None
        if overlay is not None and overlay.topology_dirty:
            # an armed snapshot's emask always carries ``live``
            w = slice(overlay.edge_slabs[cname].base, overlay.edge_slabs[cname].cap)
            a, em = (dec.edge_src, dec.dst) if d == "out" else (dec.dst, dec.edge_src)
            slab = (a[w], em[w], emask[w])

        def flat(fr, gate=None, alive=None, out=None, csr=csr, emask=emask, slab=slab):
            out = K.bitmap_hop_csr(*csr, emask, fr, gate, alive, out)
            if slab is not None:
                K.bitmap_hop(*slab, fr, gate, alive, out)
            return out

        hops.append(flat)
    return hops


def _run_hops(hops, frontier, gate=None, alive=None) -> torch.Tensor:
    """OR of every hop of a level: the first writes a zeroed bitmap, the
    others OR into it (zeros when the arm has no edge class)."""
    out = None
    for hop in hops:
        out = hop(frontier, gate, alive, out)
    return torch.zeros_like(frontier) if out is None else out


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------


def _check_record_rows(snap) -> None:
    """Record rows need every vertex property columnar: a snapshot that saw
    properties without a columnar encoding cannot tell which records carry
    them."""
    if snap.v_non_columnar:
        raise Uncompilable(
            f"record rows on a snapshot with non-columnar properties {sorted(snap.v_non_columnar)}"
        )


class TpuMatchSolver:
    def __init__(
        self, db, stmt: A.MatchStatement, params: Dict, element_alias: Optional[str] = None
    ) -> None:
        self.db = db
        self.stmt = stmt
        self.params = params
        #: a rewritten whole-record SELECT (`select_compile`): the alias
        #: whose records the rows are, after the ORDER / SKIP / LIMIT tail
        self.element_alias = element_alias
        self.param_box = ParamBox(params)
        snap = db.current_snapshot()
        if snap is None:
            raise Uncompilable("no snapshot attached")
        self.snap = snap
        self.device = db.device
        #: delta overlay (storage/deltas) of a maintained snapshot: plans
        #: record its generation and re-record when the structure moves
        self.overlay = snap._overlay
        if self.overlay is not None and self.overlay.poisoned is not None:
            raise Uncompilable(f"delta overlay poisoned: {self.overlay.poisoned}")
        self.delta_gen = self.overlay.plan_gen if self.overlay is not None else 0
        #: hot/cold tier manager (storage/tiering) of a tiered snapshot; the
        #: recording run collects every block it faults into tier_touched,
        #: the plan's footprint
        self.tier = snap._tier
        self.tier_touched: set = set()
        self._slab_floor = SLAB_FLOOR
        self.interp = MatchInterpreter(db, stmt, params)
        self.pattern = self.interp.pattern
        self.not_paths = self.interp.not_paths
        #: edge classes in a fixed order: an edge binding's class index
        self.edge_class_list = sorted(snap.edge_classes.keys())
        self.edge_class_idx = {n: i for i, n in enumerate(self.edge_class_list)}
        self._check_supported()
        self._check_returns()
        self.plan = build_plan(self.pattern, self.interp)
        self.dg: DeviceGraph = device_graph(snap, db.device)
        self.sched = SizeSchedule()
        self._vertex_scope_cache: Optional[ColumnScope] = None
        #: (edge class, WHERE, visible aliases) → its compiled Predicate:
        #: compiled (and uploaded) while recording, reused by the replays
        self._edge_preds: Dict[tuple, Predicate] = {}
        # the vertex aliases bound before each alias's first bind and before
        # each step: what a binding-referencing WHERE there may read (the
        # reference's interpreter checks with the bindings made so far)
        vertex_aliases = {a for a, n in self.pattern.nodes.items() if not n.is_edge_alias}
        self._alias_visible: Dict[str, set] = {}
        self._step_visible: Dict[int, set] = {}
        bound_so_far: set = set()
        for step in self.plan:
            if step.kind == "root":
                self._alias_visible.setdefault(step.alias, set())
                bound_so_far.add(step.alias)
                continue
            e = step.edge
            src = e.to_alias if step.reverse else e.from_alias
            dst = e.from_alias if step.reverse else e.to_alias
            vis = bound_so_far & vertex_aliases
            self._step_visible[id(step)] = vis
            self._alias_visible.setdefault(dst, vis)
            bound_so_far.add(src)
            bound_so_far.add(dst)
            f = e.item.edge_filter
            if f is not None and f.alias:
                bound_so_far.add(f.alias)
        # compile every vertex node predicate up front: an unsupported one
        # fails before any device work (an edge alias's filters are edge
        # WHEREs, compiled per edge class by the edge-binding expansion)
        self._node_masks = {
            alias: self._compile_node(node)
            for alias, node in self.pattern.nodes.items()
            if not node.is_edge_alias
        }
        # WHILE conditions compile with $depth as a per-level scalar
        self._while_fns: Dict[int, Predicate] = {}
        for e in self.pattern.edges:
            w = e.item.target.while_cond
            if w is not None:
                self._while_fns[id(e)] = compile_predicate(
                    w, self._vertex_scope(), self.param_box, allow_depth=True
                )
        # NOT arms: per arm (aliases, admission masks, path items) for the
        # bitmap anti-join; the arm's own filters only, as in the reference
        self._not_compiled = []
        for path in self.not_paths:
            sub = Pattern()
            aliases = [sub.node(path.first).alias]
            for it in path.items:
                aliases.append(sub.node(it.target).alias)
            masks = [self._compile_node(sub.nodes[a]) for a in aliases]
            self._not_compiled.append((aliases, masks, list(path.items)))

    # -- compile-time gating ------------------------------------------------

    def _check_supported(self) -> None:
        """Refuse, with the reason, every MATCH shape this slice does not
        compile: the reference's own rules (NOT arms, variable-depth arms,
        edge-binding and endpoint arms, binding references inside WHILE
        arms, unbound edge aliases, rid filters inside NOT arms). On a
        tiered snapshot the method-form arms, which read the flat edge
        arrays the tier leaves on the host, refuse too."""
        nodes = self.pattern.nodes
        if self.tier is not None:
            for e in self.pattern.edges:
                if (e.item.method or "").lower() in _EDGE_METHODS + _VERTEX_METHODS:
                    raise Uncompilable("method-form arm on a tiered snapshot")
        for path in self.not_paths:
            for flt in [path.first] + [it.target for it in path.items]:
                if flt is None:
                    continue
                if flt.while_cond is not None or flt.max_depth is not None:
                    raise Uncompilable("variable-depth NOT arm")
                if flt.optional or flt.depth_alias or flt.path_alias:
                    raise Uncompilable("optional/depth/path alias in NOT arm")
                if flt.rid is not None:
                    raise Uncompilable("rid filter in NOT arm")
                if flt.where is not None and _expr_uses_bindings(flt.where, nodes):
                    raise Uncompilable("NOT-arm WHERE references bindings")
            for it in path.items:
                if (it.method or "").lower() in _EDGE_METHODS + _VERTEX_METHODS:
                    raise Uncompilable("method form in NOT arm")
                f = it.edge_filter
                if f is not None and f.alias:
                    raise Uncompilable("edge alias in NOT arm")
                if f is not None and f.where is not None and _expr_uses_bindings(f.where, nodes):
                    raise Uncompilable("NOT-arm edge WHERE references bindings")
        for e in self.pattern.edges:
            item = e.item
            m = (item.method or "").lower()
            var_depth = item.target.while_cond is not None or item.target.max_depth is not None
            if m in _EDGE_METHODS and item.edge_filter is None and var_depth:
                raise Uncompilable("variable-depth edge-binding arm")
            if m in _VERTEX_METHODS and var_depth:
                raise Uncompilable("variable-depth endpoint arm")
            if item.target.path_alias:
                raise Uncompilable("pathAlias not compiled (per-path state)")
            if item.negated:
                raise Uncompilable("negated path item")
            if not var_depth:
                continue
            # a variable-depth arm evaluates its masks vertex-wise (no
            # per-row bindings) and binds no discovery edge
            f = item.edge_filter
            if f is not None and f.where is not None and _expr_uses_bindings(f.where, nodes):
                raise Uncompilable("edge WHERE references bindings (WHILE arm)")
            if item.target.where is not None and _expr_uses_bindings(item.target.where, nodes):
                raise Uncompilable("node WHERE references bindings (WHILE arm)")
            if f is not None and f.alias:
                raise Uncompilable("edge alias on a WHILE arrow (discovery-edge binding)")
            w = item.target.while_cond
            if w is not None and _expr_uses_bindings(w, nodes):
                raise Uncompilable("WHILE condition references bindings")
        # an edge alias binds through an arm's edge braces or as the target
        # of a bare edge-binding arm (.outE(){as:e}); no other way
        edge_filter_aliases = {
            e.item.edge_filter.alias
            for e in self.pattern.edges
            if e.item.edge_filter is not None and e.item.edge_filter.alias
        }
        edge_bind_targets = {
            e.to_alias
            for e in self.pattern.edges
            if (e.item.method or "").lower() in _EDGE_METHODS and e.item.edge_filter is None
        }
        for node in nodes.values():
            if (
                node.is_edge_alias
                and node.alias not in edge_filter_aliases
                and node.alias not in edge_bind_targets
            ):
                raise Uncompilable("edge-alias pattern nodes not compiled yet")

    def _check_returns(self) -> None:
        """The slice marshals a lone count(*), ``alias.property`` columns
        of vertex and edge aliases, depth aliases, and expressions whose
        only references are aliases (``kn IS NOT NULL``) straight from the
        snapshot; of a vertex alias also its record (``p``, rendered as its
        RID), ``p.@rid`` and ``p.@class``; and a lone ``$matches`` or
        ``$elements`` over vertex aliases. Record rows (``$elements``, a
        whole-record SELECT) need a columnar snapshot (`_check_record_rows`).
        Any other RETURN, and an edge alias in a record form, needs host
        records."""
        stmt = self.stmt
        if stmt.group_by or stmt.unwind:
            raise Uncompilable("GROUP BY / UNWIND")
        if self.count_only_name() is not None:
            return
        depth_aliases = self._depth_aliases()
        nodes = self.pattern.nodes
        if self.element_alias is not None:
            _check_record_rows(self.snap)
        special = self._special_return()
        if special is not None:
            if special not in ("matches", "elements"):
                raise Uncompilable(f"RETURN ${special} needs host records")
            edges = [a for a in self._named() if nodes[a].is_edge_alias]
            if edges:
                raise Uncompilable(f"RETURN ${special} over edge aliases {edges} (edge records)")
            if special == "elements":
                _check_record_rows(self.snap)
            return
        for p in stmt.returns:
            e = p.expr
            if contains_aggregate(e):
                raise Uncompilable("aggregate RETURN other than a lone count(*)")
            if isinstance(e, A.Identifier) and e.name in depth_aliases:
                continue
            if isinstance(e, A.Identifier) and e.name in nodes:
                if nodes[e.name].is_edge_alias:
                    raise Uncompilable(f"RETURN of edge alias {e.name!r} (edge records)")
                continue
            if isinstance(e, A.FieldAccess) and isinstance(e.base, A.Identifier) and e.base.name in nodes:
                if nodes[e.base.name].is_edge_alias:
                    refused = set().union(
                        *(c.non_columnar for c in self.snap.edge_classes.values())
                    )
                    if e.name.startswith("@"):
                        raise Uncompilable(f"RETURN of edge attribute {e.name!r} (edge records)")
                else:
                    refused = self.snap.v_non_columnar
                    if e.name in ("@rid", "@class"):
                        continue
                if e.name in refused or e.name.startswith("@"):
                    raise Uncompilable(f"RETURN of non-columnar property {e.name!r}")
                continue
            if not isinstance(e, A.Identifier) and _alias_expression(e, set(nodes) | depth_aliases):
                continue
            raise Uncompilable(
                "RETURN shape needs host records (only alias.property, records of "
                "vertex aliases, depth aliases, expressions over aliases and a lone "
                "count(*) are compiled)"
            )

    def _special_return(self) -> Optional[str]:
        """``matches`` / ``elements`` / ... for a lone context-variable
        RETURN, else None."""
        r = self.stmt.returns
        if len(r) == 1 and isinstance(r[0].expr, A.ContextVar):
            return r[0].expr.name.lower()
        return None

    def _named(self) -> List[str]:
        """The pattern's named aliases in pattern order (``$matches`` /
        ``$elements``)."""
        return [n.alias for n in self.pattern.nodes.values() if not n.anonymous]

    def _depth_aliases(self) -> set:
        """Depth aliases of the variable-depth arms (a depth column each)."""
        out = set()
        for e in self.pattern.edges:
            t = e.item.target
            if t.depth_alias and (t.while_cond is not None or t.max_depth is not None):
                out.add(t.depth_alias)
        return out

    # -- predicate compilation ---------------------------------------------

    def _vertex_scope(self) -> ColumnScope:
        if self._vertex_scope_cache is None:
            self._vertex_scope_cache = ColumnScope(
                self.dg.columns,
                self.dg.non_columnar,
                reserved=set(self.pattern.nodes.keys()),
                device=self.dg.device,
            )
        return self._vertex_scope_cache

    def _compile_node(self, node: PatternNode) -> Predicate:
        """Node admission mask over vertex ids: padding excluded, every
        class closure, rid filter and WHERE, ANDed in ONE predicate program. A
        WHERE that reads earlier bindings (``alias.prop``) compiles against
        the aliases visible at the node's first bind; the mask then needs
        ``env["bindings"]`` (``mask.uses_bindings``)."""
        terms = [valid_term()]
        uses_bindings = False
        if self.overlay is not None and not any(f.class_name for f in node.filters):
            # spare and deleted rows of a maintained universe carry class
            # -1: a class filter excludes them, a bare node needs v_class >= 0
            terms.append(class_term(self.dg.v_class, self.dg.any_class_table()))
        for f in node.filters:
            if f.class_name:
                terms.append(class_term(self.dg.v_class, self.dg.class_table(f.class_name)))
            if f.rid is not None:
                # -2 matches nothing (padding is -1)
                want = self.snap.idx_of(RID(f.rid.cluster, f.rid.position))
                terms.append(id_term(-2 if want is None else want))
            if f.where is None:
                continue
            if _expr_uses_bindings(f.where, self.pattern.nodes):
                scope = ColumnScope(
                    self.dg.columns,
                    self.dg.non_columnar,
                    reserved=set(self.pattern.nodes.keys()),
                    device=self.dg.device,
                    binding_columns=self.dg.columns,
                    binding_non_columnar=self.dg.non_columnar,
                    visible_aliases=self._alias_visible.get(node.alias, set()),
                )
                terms.append(compile_where(f.where, scope, self.param_box))
                uses_bindings = uses_bindings or scope.uses_bindings
            else:
                terms.append(compile_where(f.where, self._vertex_scope(), self.param_box))
        return Predicate(terms, self.dg.device, self.param_box, uses_bindings)

    def _edge_where(
        self, concrete: str, where: A.Expression, visible: Optional[set] = None
    ) -> Predicate:
        """Edge-property predicate over edge ids of one edge class, compiled
        once per solver; with ``visible``, ``alias.prop`` of those vertex
        aliases compiles too, and the predicate (``uses_bindings``) then
        needs ``env["bindings"]`` aligned with its slots."""
        key = (concrete, id(where), frozenset(visible or ()))
        pred = self._edge_preds.get(key)
        if pred is not None:
            return pred
        dec = self.dg.edges[concrete]
        scope = ColumnScope(
            dec.columns,
            dec.non_columnar,
            reserved=set(self.pattern.nodes.keys()),
            device=self.dg.device,
            binding_columns=self.dg.columns if visible else None,
            binding_non_columnar=self.dg.non_columnar,
            visible_aliases=visible or set(),
        )
        terms = [valid_term(), compile_where(where, scope, self.param_box)]
        if self.overlay is not None:
            # tombstones and spare slots: the live mask in the same program
            terms.append(live_term(dec.live, dec.dst))
        pred = self._edge_preds[key] = Predicate(
            terms, self.dg.device, self.param_box, scope.uses_bindings
        )
        return pred

    @staticmethod
    def _binding_env(table: Table, row: Optional[torch.Tensor], visible: set) -> Dict:
        """``env`` of a binding-referencing predicate: each visible alias's
        vertex ids per slot, aligned with ``row`` (the table row of each
        expansion slot; None: the table's own rows)."""

        def col(a):
            if a not in table.cols:
                n = row.shape[0] if row is not None else (table.width or 1)
                return torch.full((n,), -1, dtype=I32, device=table.device)
            if row is None:
                return table.cols[a]
            return K.take_pad(table.cols[a], row, -1)

        return {"bindings": {a: col(a) for a in visible}}

    # -- execution ----------------------------------------------------------

    def _compact(self, mask):
        return _observe_compact(self.sched, mask)

    def _expand_csr(self, indptr, nbrs, srcs, offsets, total_dev, edge_map=None):
        """One CSR expansion sized by ``expand_offsets``' (offsets, device
        total); with ``edge_map`` (an in walk's ``edge_id_in``) the edge
        position comes back mapped through it."""
        total = self.sched.observe(total_dev)
        row, edge_pos, nbr = K.gather_expand(
            indptr, nbrs, srcs, offsets, total_dev, _cap_of(total), edge_map
        )
        if self.overlay is not None:
            # a tombstoned base edge keeps its CSR slot with a -1 endpoint:
            # padding, so that it never binds
            dead = nbr < 0
            row = torch.where(dead, -1, row)
            edge_pos = torch.where(dead, -1, edge_pos)
        return row, edge_pos, nbr, total

    def _expand_slab(self, dec, d: str, srcs):
        """The append slab's part of one (class, direction) expansion:
        ``(row, edge id, neighbour, host total)`` of the live slab edges
        whose active endpoint is a row's source, or None when the class has
        no slab. The bucket probe (K18) unless one of the class's buckets
        overflowed; then the scan of the used window (K17), whose width is
        the observed used-slot count. Both outputs are sized by the
        observed total with the slab floor."""
        ov = self.overlay
        cname = dec.class_name
        base, cap = ov.edge_base(cname), dec.num_edges
        if cap <= base:
            return None
        floor = min(cap - base, self._slab_floor)
        seen: List[int] = []

        def size_for(total_dev):
            seen.append(self.sched.observe(total_dev, min_capacity=floor))
            return max(_cap_of(max(seen[0], 1)), floor)

        own, nbr_a = (dec.edge_src, dec.dst) if d == "out" else (dec.dst, dec.edge_src)
        if cname in ov.bk and cname not in ov.bucket_overflow:
            tab = self.dg.arrays[f"bk:{cname}:{d}"]
            row, eid, nbr, _ = K.slab_probe(
                tab, own, nbr_a, dec.live, srcs, base, ov.bk_nb, ov.bk_bk, size_for
            )
            return row, eid, nbr, seen[0]
        # used slots are append-only: edge_src >= 0 marks them after a
        # tombstone too, so the window bound survives deletes
        used = self.sched.observe(
            K.mask_count(dec.edge_src[base:cap] >= 0), min_capacity=floor
        )
        W = min(cap - base, max(_cap_of(max(used, 1)), floor))
        row, eid, nbr, _ = K.slab_scan(
            own[base : base + W], nbr_a[base : base + W], dec.live[base : base + W],
            srcs, base, size_for,
        )
        return row, eid, nbr, seen[0]

    def _expand_one_dir_chunked(self, dec, d: str, srcs):
        """Expansion slabs for one (class, direction): usually ONE
        ``(row, eid, nbr, total)``, but when the output would exceed
        config.max_expansion_cap rows, the binding table splits into
        contiguous row ranges expanded separately, so buffers stay bounded
        however large the fan-out. A meshed snapshot never chunks, as in
        the reference."""
        if self.dg.mesh_graph is not None:
            return [self._expand_one_dir(dec, d, srcs)]
        cap = max(1, config.max_expansion_cap)
        indptr = dec.indptr_out if d == "out" else dec.indptr_in
        offsets, total_dev = K.expand_offsets(indptr, srcs)
        # free: it picks the chunking; the expansion observes the same total
        # again (one chunk), or each chunk its own, to check growth
        total = self.sched.observe(total_dev, free=True)
        n_chunks = max(1, -(-_cap_of(total) // cap))
        if n_chunks == 1:
            return [self._expand_one_dir(dec, d, srcs, (offsets, total_dev))]
        width = int(srcs.shape[0])
        step = -(-width // n_chunks)
        slabs = []
        for a in range(0, width, step):
            row, eid, nbr, t = self._expand_one_dir(dec, d, srcs[a : a + step])
            row = torch.where(row >= 0, row + a, row)  # local → table rows
            slabs.append((row, eid, nbr, t))
        return slabs

    def _expand_paged(self, dec, d: str, srcs, sizing):
        """The expansion of a paged (class, direction): row and edge
        position from the resident indptr's ``sizing`` (`_expand_one_dir`),
        the neighbour and (in) the edge id from the tier's pool through the
        block → page indirection (K21). The recording run faults the
        sources' blocks in first (the plan's footprint); a replay raises
        K21's cold-miss flag into the overflow flag instead."""
        if self.sched.recording:
            self.tier.ensure_vertices(dec.class_name, d, srcs, self.tier_touched)
        offsets, total_dev = sizing
        total = self.sched.observe(total_dev)
        row, eid, nbr, cold = tiering.paged_expand(
            self.dg.arrays, dec.class_name, d, srcs, offsets, total_dev, _cap_of(total)
        )
        self.sched.note_flag(cold)
        return row, eid, nbr, total

    def _expand_sharded(self, dec, d: str, srcs):
        """The expansion of one (class, direction) over the mesh: the
        shards' totals (K2's range form), the largest sizing each shard's
        block and their sum the merged segment (both recorded, so that a
        replay that outgrows either raises the overflow flag), then K22
        places every shard's rows at its global offset. The segment is in
        shard-major order, as the reference's merge leaves it."""
        mg = self.dg.mesh_graph
        arrays = self.dg.arrays
        p = mg.edge[dec.class_name].prefix
        ind_sh = arrays[f"{p}:{d}:indptr"]
        nbr_sh = arrays[f"{p}:{d}:nbr"]
        span = arrays["sh:rowspan"]
        extra = arrays[f"{p}:out:ebase"] if d == "out" else arrays[f"{p}:in:eid"]
        tots = MG.expand_totals(mg.mesh, ind_sh, span, srcs)
        total = self.sched.observe(K.value_sum(tots))
        max_local = self.sched.observe(tots.max())
        row, eid, nbr = MG.expand_gather(
            mg.mesh, ind_sh, nbr_sh, extra, span, srcs,
            _cap_of(max(max_local, 1)), _cap_of(max(total, 1)), d == "out",
        )
        return row, eid, nbr, total

    def _expand_one_dir(self, dec, d: str, srcs, sizing=None):
        """One (edge class, direction) expansion → (row, edge id in out
        order, neighbor, host total): an in-walk maps its CSR position
        through the class's ``edge_id_in`` inside the gather; a paged one
        reads the tier's pool (`_expand_paged`); a meshed one the shards
        (`_expand_sharded`). ``sizing`` is ``expand_offsets(indptr, srcs)``
        when the caller has it already."""
        if self.dg.mesh_graph is not None:
            return self._expand_sharded(dec, d, srcs)
        indptr = dec.indptr_out if d == "out" else dec.indptr_in
        if sizing is None:
            sizing = K.expand_offsets(indptr, srcs)
        if self.tier is not None and self.tier.pages_dir(dec.class_name, d):
            return self._expand_paged(dec, d, srcs, sizing)
        nbrs, edge_map = (dec.dst, None) if d == "out" else (dec.src, dec.edge_id_in)
        row, eid, nbr, total = self._expand_csr(indptr, nbrs, srcs, *sizing, edge_map)
        if self.overlay is not None and self.overlay.topology_dirty:
            # appended edges live outside the base CSR: the slab's slots
            # follow the base slots (padding interleaves; masks key on row)
            slab = self._expand_slab(dec, d, srcs)
            if slab is not None:
                row = torch.cat([row, slab[0]])
                eid = torch.cat([eid, slab[1]])
                nbr = torch.cat([nbr, slab[2]])
                total = total + slab[3]
        return row, eid, nbr, total

    def solve_table(self) -> Table:
        """The plan's steps, then the NOT anti-join, then the COUNT
        pushdown or the variable-depth COUNT (the reference's order)."""
        pushdown = self._count_pushdown_steps()
        var_count = None if pushdown else self._var_count_step()
        if pushdown:
            steps = self.plan[: len(self.plan) - len(pushdown)]
        elif var_count is not None:
            steps = self.plan[:-1]
        else:
            steps = self.plan
        table = Table(self.device, count=1, width=0)
        for step in steps:
            if table.empty():
                # an empty required pipeline: optional arms add no rows
                return table
            if step.kind == "root":
                table = self._root(table, step.alias)
            else:
                table = self._expand(table, step, optional=step.kind == "optional")
        if self._not_compiled and not table.empty():
            table = self._apply_not_paths(table)
        if pushdown and not table.empty():
            return self._apply_count_pushdown(table, pushdown)
        if var_count is not None and not table.empty():
            return self._expand_var_depth(table, var_count, optional=False, count_only=True)
        return table

    # -- COUNT(*) aggregate pushdown ----------------------------------------

    def _count_pushdown_steps(self) -> List[PlanStep]:
        """Longest plan suffix of terminal chain expansions a lone COUNT(*)
        can aggregate without materializing binding tables: each terminal
        hop collapses to one O(E) segment-sum pass —
        ``w_k[v] = Σ_{edges v→u} emask(e)·mask(u)·w_{k+1}[u]`` — and the
        count is ``Σ_rows w_1[src]``. A NOT arm disables it (its anti-join
        needs the rows), and the suffix ends at a variable-depth arm (a
        weight pass is one fixed hop; `_var_count_step` counts such an
        arm), at an arm that binds an edge alias, at an edge-binding or
        endpoint arm, and at a predicate that reads other bindings (a
        weight pass has no rows to read them from)."""
        if self.count_only_name() is None or self.stmt.group_by or self._not_compiled:
            return []
        if self.overlay is not None and self.overlay.topology_dirty:
            # the weight chain sums over the base CSR: slab edges would be
            # missed and tombstones counted; the full solve reads the slab
            return []
        if self.tier is not None:
            # the weight passes read the flat [E] arrays, paged out on a
            # tiered snapshot; the full solve counts through the paged path
            return []
        suffix: List[PlanStep] = []
        for step in reversed(self.plan):
            if step.kind != "expand" or step.close:
                break
            e = step.edge
            item = e.item
            t = item.target
            f = item.edge_filter
            if (
                t.while_cond is not None
                or t.max_depth is not None
                or t.depth_alias
                or (f is not None and f.alias)
            ):
                break
            if (
                f is not None
                and f.where is not None
                and _expr_uses_bindings(f.where, self.pattern.nodes)
            ):
                break
            m = (item.method or "").lower()
            if (m in _EDGE_METHODS and f is None) or m in _VERTEX_METHODS:
                break
            dst_alias = e.from_alias if step.reverse else e.to_alias
            if self._node_masks[dst_alias].uses_bindings:
                break
            # dst must be terminal: touched by no other edge than this one
            # and (for non-last suffix members) the src of the next step
            used_elsewhere = False
            for e2 in self.pattern.edges:
                if e2 is e:
                    continue
                in_suffix_head = suffix and e2 is suffix[0].edge
                if dst_alias in (e2.from_alias, e2.to_alias) and not in_suffix_head:
                    used_elsewhere = True
                f2 = e2.item.edge_filter
                if f2 is not None and f2.alias == dst_alias:
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

    def _var_count_step(self) -> Optional[PlanStep]:
        """The plan's last step when it is a terminal variable-depth arm a
        lone COUNT(*) can count by per-level popcounts
        (`_expand_var_depth(count_only=True)`), the sibling of
        `_count_pushdown_steps`, which stops at such arms."""
        if (
            self.count_only_name() is None
            or self.stmt.group_by
            or self._not_compiled
            or not self.plan
        ):
            return None
        step = self.plan[-1]
        if step.kind != "expand" or step.close:
            return None  # an optional arm adds its unmatched rows too
        e = step.edge
        t = e.item.target
        if t.while_cond is None and t.max_depth is None:
            return None  # a fixed hop: the weight pushdown covers it
        f = e.item.edge_filter
        if f is not None and f.alias:
            return None
        dst_alias = e.from_alias if step.reverse else e.to_alias
        if self._node_masks[dst_alias].uses_bindings:
            return None
        for e2 in self.pattern.edges:
            if e2 is e:
                continue
            if dst_alias in (e2.from_alias, e2.to_alias):
                return None  # dst takes part in another arm: rows needed
            f2 = e2.item.edge_filter
            if f2 is not None and f2.alias == dst_alias:
                return None
        return step

    def _apply_count_pushdown(self, table: Table, steps: List[PlanStep]) -> Table:
        first = steps[0]
        src_alias = first.edge.to_alias if first.reverse else first.edge.from_alias
        srcs = table.cols.get(src_alias)
        if srcs is None:
            raise Uncompilable(f"alias {src_alias} not bound before expansion")
        w = self._pushdown_weights(steps, torch.int32)
        total_dev = K.value_sum(K.take_pad(w, srcs, 0))
        if self.sched.recording:
            # int32 overflow guard: a float32 twin of the whole weight chain
            # detects wraps anywhere in the segment sums — float32 is
            # inexact above 2^24 but its ~1e-7 relative error is far below
            # the mismatch a wrap produces. Record-time only: the snapshot
            # is immutable, so a replay sees the same data.
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
        # free: the count IS the result; it sizes no buffer
        t = Table(self.device, count=self.sched.observe(total_dev, free=True), width=0)
        t.count_dev = total_dev
        return t

    def _vb(self) -> int:
        """The bucketed vertex universe: the domain of per-vertex masks
        (weight passes, bitmap levels), ids past V padding."""
        return K.bucket(max(self.dg.num_vertices, 1))

    def _vertex_vec(self, pred: Predicate, env: Optional[Dict] = None) -> torch.Tensor:
        """A vertex predicate over the whole universe, in identity mode."""
        return pred.identity(self._vb(), self.dg.num_vertices, env=env)

    def _edge_mask(self, cname: str, where) -> Optional[torch.Tensor]:
        """An edge WHERE (no binding references) over every edge of one
        class, bool [E] in out order; None without a WHERE. On a maintained
        snapshot the class's live mask, ANDed into the WHERE's program."""
        if where is None:
            return self.dg.edges[cname].live if self.overlay is not None else None
        return self._edge_where(cname, where).identity(self.dg.edges[cname].num_edges)

    def _pushdown_weights(self, steps: List[PlanStep], dtype) -> torch.Tensor:
        # [vb]-wide node-mask precomputes are used where the edge list
        # outnumbers the vertices: one bool gather per edge then replaces
        # re-evaluating the predicate's column gathers
        vb = self._vb()
        w = None  # None ≡ all-ones (the implicit weight after the last hop)
        for step in reversed(steps):
            w = self._pushdown_weight_step(step, w, vb, dtype)
        return w

    def _pushdown_weight_step(self, step, w, vb, dtype):
        item = step.edge.item
        direction = item.direction
        if step.reverse:
            direction = _REVERSE_DIR[direction]
        dst_alias = step.edge.from_alias if step.reverse else step.edge.to_alias
        node_mask = self._node_masks[dst_alias]
        classes = self._resolve_edge_classes(item)
        mg = self.dg.mesh_graph
        # the mesh's weight passes always read the [vb] node vector
        ok_vec = (
            self._vertex_vec(node_mask)
            if mg is not None or any(self.dg.edges[c].num_edges >= vb for c in classes)
            else None
        )
        f = item.edge_filter
        # a [vb] vertex mask and weights that fit L2 fold into one table
        # (one pass over [vb]), so that a walk gathers once an edge from it;
        # a walk that reads its edge mask through edge ids keeps the mask
        # apart, as its first and cheapest filter (PERF.md §6)
        foldable = (
            mg is None
            and w is not None
            and ok_vec is not None
            and w.numel() * w.element_size() <= K.L2_KEEP_BYTES
        )
        folded_w = None
        # the mesh's passes add into a zeroed vector; a single-device walk's
        # sums are the vector itself, or are added to the walks' before
        new_w = torch.zeros(vb, dtype=dtype, device=self.device) if mg is not None else None
        for cname in classes:
            dec = self.dg.edges[cname]
            E = dec.num_edges
            if E == 0:
                continue
            emask = self._edge_mask(cname, f.where if f is not None else None)
            for d in ("out", "in") if direction == "both" else (direction,):
                if mg is not None:
                    # K23 over the sharded edge list: an out walk sums at
                    # the source and weighs the target, an in walk the
                    # reverse; the mask is read through the slices' eid
                    p = mg.edge[cname].prefix
                    src_sh, dst_sh, eid_sh = (
                        self.dg.arrays[f"{p}:el:{k}"] for k in ("src", "dst", "eid")
                    )
                    seg_sh, emit_sh = (src_sh, dst_sh) if d == "out" else (dst_sh, src_sh)
                    MG.sharded_weight_pass(mg.mesh, seg_sh, emit_sh, eid_sh, emask, ok_vec, w, new_w)
                    continue
                # both CSR orders are on the device, so either direction
                # sums per vertex with indptr_segment_sum; the in walk
                # reads the out-order edge mask through edge_id_in. One
                # fused gather makes each edge's value from the endpoint's
                # [vb] mask (or, where the edges are fewer than vb, the node
                # mask evaluated at the endpoints; neither once folded into
                # the weights), the edge mask and the endpoint's weight
                # after this hop
                if d == "out":
                    emit, ip, eid = dec.dst, dec.indptr_out, None
                else:
                    emit, ip = dec.src, dec.indptr_in
                    eid = None if emask is None else dec.edge_id_in
                if foldable and eid is None:
                    if folded_w is None:
                        folded_w = K.weight_gather(None, dtype, ok=ok_vec, w=w)
                    vals = K.weight_gather(emit, dtype, emask=emask, w=folded_w)
                else:
                    vals = K.weight_gather(
                        emit,
                        dtype,
                        ok=ok_vec if E >= vb else None,
                        node_ok=None if E >= vb else node_mask(emit),
                        emask=emask,
                        eid=eid,
                        w=w,
                    )
                part = K.indptr_segment_sum(vals, ip, vb)
                new_w = part if new_w is None else new_w + part
        return new_w if new_w is not None else torch.zeros(vb, dtype=dtype, device=self.device)

    # -- roots and expansions ----------------------------------------------

    def _root_candidates(self, alias: str):
        """Candidate scan for a root alias, restricted to the dense-index
        hull of its class filters' polymorphic closures (each concrete
        class is one contiguous slab). Admission masks still run in full:
        the hull can contain foreign vertices."""
        node = self.pattern.nodes[alias]
        start, end = 0, self.dg.num_vertices
        has_class = False
        for f in node.filters:
            if f.class_name:
                has_class = True
                lo, hi = self.snap.vertex_hull(f.class_name)
                start, end = max(start, lo), min(end, hi)
        size = max(end - start, 0)
        slo, shi = self.snap.slab_vertex_range() if has_class else (0, 0)
        if shi > slo:
            # inserted vertices land in the append slab, outside every
            # class hull: a second scan segment (a classless hull already
            # ends at the padded universe)
            slab = shi - slo
            pos = torch.arange(K.bucket(max(size + slab, 1)), dtype=I32, device=self.device)
            idx = torch.where(
                pos < size, start + pos, torch.where(pos < size + slab, slo + (pos - size), -1)
            ).to(I32)
            cand, n, n_dev = self._compact(self._node_masks[alias](idx))
            return K.take_pad(idx, cand, -1), n, n_dev
        mask = self._node_masks[alias].identity(K.bucket(max(size, 1)), size, base=start)
        cand, n, n_dev = self._compact(mask)
        return (torch.where(cand >= 0, cand + start, -1) if start else cand), n, n_dev

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
        # the pairing stride is the RECORDED new_n, so a replay is valid only
        # when both cardinalities equal the recording's: flag otherwise
        old_n, new_n = table.count, n
        old_dev = table.count_device
        sched = self.sched
        if not sched.recording:
            flag = (old_dev != old_n) | (n_dev != new_n)
            sched.overflow = flag if sched.overflow is None else (sched.overflow | flag)
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
        t.count_dev = old_dev * n_dev
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

    def edge_classes_read(self) -> set:
        """The concrete edge classes the pattern's arms and NOT arms walk."""
        items = [e.item for e in self.pattern.edges]
        items += [it for path in self.not_paths for it in path.items]
        return {c for it in items for c in self._resolve_edge_classes(it)}

    def _empty_like(self, table: Table, dst_alias: str, edge_alias=None, depth_alias=None) -> Table:
        """A table of no rows with the columns an arm adds, so that later
        steps find the structure they expect."""
        t = table.gather(torch.full((K.bucket(1),), -1, dtype=I32, device=self.device))
        t.count = 0
        t.count_dev = torch.zeros((), dtype=I32, device=self.device)
        null = torch.full((t.width,), -1, dtype=I32, device=self.device)
        if dst_alias is not None:
            t.cols[dst_alias] = null
        if edge_alias is not None:
            t.edge_cols[edge_alias] = (null, null)
        if depth_alias:
            t.depth_cols[depth_alias] = null
        return t

    def _unmatched_part(self, table: Table, matched: torch.Tensor):
        """The left join's other half: the table's live rows with no match
        (``matched`` bool [width]), compacted through the size schedule —
        recorded while recording, a device overflow flag on a replay.
        Returns (part or None, the kept table rows)."""
        valid = table.valid_device[: table.width].to(torch.bool)
        ukeep, un, un_dev = self._compact(valid & ~matched)
        if un == 0:
            return None, ukeep
        part = table.gather(ukeep)
        part.count = un
        part.count_dev = un_dev
        return part, ukeep

    def _expand(self, table: Table, step: PlanStep, optional: bool = False) -> Table:
        """One arm: expand every live row over the arm's edge classes and
        directions, apply the edge WHERE and the reached vertices' mask
        (with the rows' bindings where they read them), and compact the
        survivors into a new table. An OPTIONAL arm also keeps each live
        row with no survivor (`K.rows_with_matches` counts them), with the
        reference's null rules."""
        e = step.edge
        item = e.item
        if item.target.while_cond is not None or item.target.max_depth is not None:
            return self._expand_var_depth(table, step, optional)
        m = (item.method or "").lower()
        if m in _EDGE_METHODS and item.edge_filter is None:
            return self._expand_bind_edge(table, step, optional)
        if m in _VERTEX_METHODS:
            return self._expand_edge_endpoint(table, step, optional, m)
        direction = item.direction
        if step.reverse:
            direction = _REVERSE_DIR[direction]
        src_alias = e.to_alias if step.reverse else e.from_alias
        dst_alias = e.from_alias if step.reverse else e.to_alias
        srcs = table.cols.get(src_alias)
        if srcs is None:
            raise Uncompilable(f"alias {src_alias} not bound before expansion")
        f = item.edge_filter
        edge_alias = f.alias if f is not None and f.alias else None
        visible = self._step_visible.get(id(step), set())
        node_mask = self._node_masks[dst_alias]
        width = table.width or 1
        matched_any = torch.zeros(width, dtype=I32, device=self.device) if optional else None
        parts: List[Table] = []
        counts: List[int] = []
        for cname in self._resolve_edge_classes(item):
            dec = self.dg.edges[cname]
            where_fn = (
                self._edge_where(cname, f.where, visible)
                if f is not None and f.where is not None
                else None
            )
            uses = node_mask.uses_bindings or (where_fn is not None and where_fn.uses_bindings)
            for d in ("out", "in") if direction == "both" else (direction,):
                for row, eid, nbr, total in self._expand_one_dir_chunked(dec, d, srcs):
                    if total == 0:
                        continue
                    env = self._binding_env(table, row, visible) if uses else {}
                    mask = row >= 0
                    if where_fn is not None:
                        mask = mask & where_fn(eid, env)
                    # a close step does not re-run a binding-referencing
                    # mask: the reference checks the alias once, when it
                    # first binds
                    if not (step.close and node_mask.uses_bindings):
                        mask = mask & node_mask(nbr, env)
                    if step.close:
                        bound = K.take_pad(table.cols[dst_alias], row, -2)
                        mask = mask & (nbr == bound)
                    if optional:
                        K.rows_with_matches(row, mask, width, out=matched_any)
                    keep, kn, kn_dev = self._compact(mask)
                    if kn == 0:
                        continue
                    part = table.gather(K.take_pad(row, keep, -1))
                    part.count = kn
                    part.count_dev = kn_dev
                    part.cols[dst_alias] = K.take_pad(nbr, keep, -1)
                    if edge_alias is not None:
                        part.edge_cols[edge_alias] = self._edge_binding(
                            cname, K.take_pad(eid, keep, -1)
                        )
                    parts.append(part)
                    counts.append(kn)
        if optional:
            upart, ukeep = self._unmatched_part(table, matched_any[: table.width] > 0)
            if upart is not None:
                null = torch.full((upart.width,), -1, dtype=I32, device=self.device)
                arm_opt = f is not None and f.optional
                if step.close and arm_opt:
                    pass  # a probe between two bound aliases: both survive
                elif step.close:
                    # the reference keeps a bound endpoint when the source
                    # is null, and nulls it when a bound source found no
                    # match
                    src_g = K.take_pad(srcs, ukeep, -1)
                    upart.cols[dst_alias] = torch.where(src_g < 0, upart.cols[dst_alias], -1)
                else:
                    upart.cols[dst_alias] = null
                if edge_alias is not None:
                    upart.edge_cols[edge_alias] = (null, null)
                parts.append(upart)
                counts.append(upart.count)
        if not parts:
            return self._empty_like(table, dst_alias, edge_alias)
        return _concat_tables(parts, counts, self.device)

    def _edge_binding(self, cname: str, eid: torch.Tensor):
        """The (class index, edge id) columns of edges of one class."""
        return torch.where(eid >= 0, self.edge_class_idx[cname], -1).to(I32), eid

    # -- method-form arms ---------------------------------------------------

    def _expand_bind_edge(self, table: Table, step: PlanStep, optional: bool) -> Table:
        """A bare ``.outE('EC'){as:e}``: the target alias binds the EDGE.
        Expansion slots carry the edge id; the target's class and WHERE
        apply to the edge (an edge class restriction and an edge WHERE)."""
        e = step.edge
        item = e.item
        if step.reverse:
            raise Uncompilable("reverse edge-binding arm")
        src_alias, dst_alias = e.from_alias, e.to_alias
        srcs = table.cols.get(src_alias)
        if srcs is None:
            raise Uncompilable(f"alias {src_alias} not bound before expansion")
        dst_node = self.pattern.nodes[dst_alias]
        tgt_classes = [f.class_name for f in dst_node.filters if f.class_name]
        tgt_wheres = [f.where for f in dst_node.filters if f.where is not None]
        concrete = self._resolve_edge_classes(item)
        for tc in tgt_classes:
            concrete = [
                c
                for c in concrete
                if (cl := self.db.schema.get_class(c)) is not None and cl.is_subclass_of(tc)
            ]
        visible = self._step_visible.get(id(step), set())
        parts: List[Table] = []
        counts: List[int] = []
        width = table.width or 1
        matched_any = torch.zeros(width, dtype=I32, device=self.device) if optional else None
        for cname in concrete:
            dec = self.dg.edges[cname]
            where_fns = [self._edge_where(cname, w, visible) for w in tgt_wheres]
            uses = any(fn.uses_bindings for fn in where_fns)
            ecls = self.edge_class_idx[cname]
            for d in ("out", "in") if item.direction == "both" else (item.direction,):
                row, eid, _nbr, total = self._expand_one_dir(dec, d, srcs)
                if total == 0:
                    continue
                env = self._binding_env(table, row, visible) if uses else {}
                mask = (row >= 0) & (eid >= 0)
                for fn in where_fns:
                    mask = mask & fn(eid, env)
                if step.close:
                    bci, beid = table.edge_cols[dst_alias]
                    mask = (
                        mask
                        & (K.take_pad(bci, row, -2) == ecls)
                        & (K.take_pad(beid, row, -2) == eid)
                    )
                if optional:
                    K.rows_with_matches(row, mask, width, out=matched_any)
                keep, kn, kn_dev = self._compact(mask)
                if kn == 0:
                    continue
                part = table.gather(K.take_pad(row, keep, -1))
                part.count = kn
                part.count_dev = kn_dev
                part.edge_cols[dst_alias] = self._edge_binding(cname, K.take_pad(eid, keep, -1))
                parts.append(part)
                counts.append(kn)
        if optional:
            upart, _ukeep = self._unmatched_part(table, matched_any[:width] > 0)
            if upart is not None:
                if not step.close:
                    null = torch.full((upart.width,), -1, dtype=I32, device=self.device)
                    upart.edge_cols[dst_alias] = (null, null)
                parts.append(upart)
                counts.append(upart.count)
        if not parts:
            return self._empty_like(table, None, dst_alias)
        return _concat_tables(parts, counts, self.device)

    def _expand_edge_endpoint(self, table: Table, step: PlanStep, optional: bool, m: str) -> Table:
        """``.outV()/.inV()/.bothV()`` from a bound edge alias to its
        endpoint vertex: a 1:1 (1:2 for bothV) gather per row through the
        edge columns, ``edge_src`` for the source and ``dst`` for the
        target (on a mesh the sharded edge list's ``el:src`` / ``el:dst``),
        no fan-out."""
        e = step.edge
        if step.reverse:
            raise Uncompilable("reverse endpoint arm")
        src_alias, dst_alias = e.from_alias, e.to_alias
        ecols = table.edge_cols.get(src_alias)
        if ecols is None:
            raise Uncompilable(f"edge alias {src_alias} not bound before endpoint step")
        ci, eid = ecols
        width = table.width or 1
        node_mask = self._node_masks[dst_alias]
        env = {}
        if node_mask.uses_bindings:
            env = self._binding_env(table, None, self._step_visible.get(id(step), set()))
        live = table.valid_device[:width].to(torch.bool)
        parts: List[Table] = []
        counts: List[int] = []
        matched_any = torch.zeros(width, dtype=torch.bool, device=self.device)
        for kind in {"outv": ("src",), "inv": ("dst",), "bothv": ("src", "dst")}[m]:
            cand = torch.full((width,), -1, dtype=I32, device=self.device)
            for k, cname in enumerate(self.edge_class_list):
                dec = self.dg.edges[cname]
                if dec.num_edges == 0:
                    continue
                ids = torch.where(ci == k, eid, -1)
                mg = self.dg.mesh_graph
                if mg is not None:
                    key = f"{mg.edge[cname].prefix}:el:{'src' if kind == 'src' else 'dst'}"
                    g = MG.edge_endpoint(mg.mesh, self.dg.arrays[key], ids)
                else:
                    arr = dec.edge_src if kind == "src" else dec.dst
                    g = K.take_pad(arr, ids, -1)
                cand = torch.where(ci == k, g, cand)
            mask = live & (cand >= 0) & node_mask(cand, env)
            if step.close:
                mask = mask & (cand == table.cols[dst_alias])
            matched_any = matched_any | mask
            keep, kn, kn_dev = self._compact(mask)
            if kn == 0:
                continue
            part = table.gather(keep)
            part.count = kn
            part.count_dev = kn_dev
            part.cols[dst_alias] = K.take_pad(cand, keep, -1)
            parts.append(part)
            counts.append(kn)
        if optional:
            upart, _ukeep = self._unmatched_part(table, matched_any)
            if upart is not None:
                if not step.close:
                    upart.cols[dst_alias] = torch.full((upart.width,), -1, dtype=I32, device=self.device)
                parts.append(upart)
                counts.append(upart.count)
        if not parts:
            return self._empty_like(table, dst_alias)
        return _concat_tables(parts, counts, self.device)

    # -- variable-depth (WHILE / maxDepth) arms -----------------------------

    _VAR_DEPTH_CHUNK = 256

    @staticmethod
    def _var_chunk_rows(width: int, vb: int) -> int:
        """Rows per frontier-bitmap chunk: no wider than the (bucketed)
        binding table, at most 256, and few enough that one ``[rows, vb]``
        bool bitmap stays inside ``config.var_depth_bitmap_budget`` bytes
        (8 rows of 2^23 vertices at 8M persons)."""
        budget_rows = max(1, config.var_depth_bitmap_budget // max(vb, 1))
        return max(1, min(TpuMatchSolver._VAR_DEPTH_CHUNK, width, budget_rows))

    def _chunk_rows(self, valid_dev: torch.Tensor, cs: int, C: int):
        """Table rows ``cs .. cs+C`` of a chunk, -1 where the slot is past
        the table or not live, and their liveness. Chunks run over the
        bucketed width, not the recorded count: on a replay live rows may
        sit in any slot under the recorded capacity."""
        rows = torch.arange(cs, cs + C, dtype=I32, device=self.device)
        in_range = torch.where(rows < valid_dev.shape[0], rows, -1)
        live = K.take_pad(valid_dev, in_range, 0) > 0
        return torch.where(live, rows, -1), live

    def _expand_var_depth(
        self, table: Table, step: PlanStep, optional: bool = False, count_only: bool = False
    ) -> Table:
        """Breadth-wise frontier iteration with per-row visited bitmaps:
        emit the origin at depth 0, then one bitmap hop per level, the
        WHILE condition gating the vertices expanded at the level's
        ``$depth``, stopping at maxDepth or when the frontier is exhausted.
        Depths are minimum discovery depths.

        The recording runs ``config.var_depth_pad_levels`` empty levels past
        exhaustion and keeps a minimum-capacity emission at every level, so
        that a replay whose walk is up to that many levels deeper runs in
        place; the per-level alive observes are free (the loop's trip count
        replays from the schedule), and the observe after the loop raises
        the replay's overflow flag when its frontier is still alive.

        ``optional`` keeps each live row that emitted at no level, with the
        null rules of `_expand`. ``count_only`` is the variable-depth COUNT
        (`_var_count_step`): the sum of each level's emission popcount, no
        rows."""
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
        max_depth = item.target.max_depth
        while_fn = self._while_fns.get(id(e))
        depth_alias = item.target.depth_alias
        vb = self._vb()
        node_vec = self._vertex_vec(self._node_masks[dst_alias])
        dirs = ("out", "in") if direction == "both" else (direction,)
        f = item.edge_filter
        hop_items = []
        for c in self._resolve_edge_classes(item):
            emask = self._edge_mask(c, f.where if f is not None else None)
            hop_items.extend((c, d, emask) for d in dirs)
        hops = build_bitmap_hops(
            self.dg, hop_items, self.sched, self.tier, self.tier_touched, self.overlay
        )
        gates: Dict[int, torch.Tensor] = {}  # depth → WHILE gate, shared by chunks
        parts: List[Table] = []
        counts: List[int] = []
        matched_chunks: List[torch.Tensor] = []
        recording = self.sched.recording
        total_dev = torch.zeros((), dtype=I32, device=self.device)
        totalf_dev = torch.zeros((), dtype=F32, device=self.device)
        width = table.width or 1
        C = self._var_chunk_rows(width, vb)
        valid_dev = table.valid_device
        pad = max(1, config.var_depth_pad_levels)
        for cs in range(0, width, C):
            chunk_rows, _live = self._chunk_rows(valid_dev, cs, C)
            src_chunk = K.take_pad(srcs, chunk_rows, -1)
            bound_chunk = (
                K.take_pad(table.cols[dst_alias], chunk_rows, -2) if step.close else None
            )
            matched = torch.zeros(C, dtype=torch.bool, device=self.device) if optional else None

            def add_count(n):
                nonlocal total_dev, totalf_dev
                total_dev = total_dev + n
                if recording:
                    totalf_dev = totalf_dev + n.to(F32)

            def emit_level(reached, depth):
                nonlocal matched
                if not count_only:
                    hit = self._emit_var_level(
                        table, reached, node_vec, bound_chunk, cs, depth,
                        dst_alias, depth_alias, vb, parts, counts, any_row=optional,
                    )
                    if optional:
                        matched = matched | hit
                    return
                add_count(K.bitmap_emit(reached, node_vec, bound_chunk, emit=False, count=True)[2])

            frontier = K.rows_to_bitmap(src_chunk, vb)
            # the frontier is its own visited set until the first level step
            # updates it in place (after the hop has read the frontier)
            visited = frontier
            alive_dev = K.mask_count(src_chunk >= 0)
            emit_level(frontier, 0)
            depth = 0
            empty_streak = 0
            ended_by_bound = False
            while True:
                if max_depth is not None and depth >= max_depth:
                    ended_by_bound = True
                    break
                gate = None
                if while_fn is not None:
                    gate = gates.get(depth)
                    if gate is None:
                        gate = gates[depth] = self._vertex_vec(while_fn, {"depth": depth})
                nxt = _run_hops(hops, frontier, gate, alive_dev)
                if count_only:  # the level's emission count comes from the same pass
                    alive_dev, n = K.frontier_advance(nxt, visited, node=node_vec, bound=bound_chunk)
                    add_count(n)
                else:
                    alive_dev = K.frontier_advance(nxt, visited)
                alive = self.sched.observe(alive_dev, free=True)
                empty_streak = empty_streak + 1 if alive == 0 else 0
                depth += 1
                if not count_only:
                    emit_level(nxt, depth)
                frontier = nxt
                if empty_streak >= pad:
                    break
                if depth > self.dg.num_vertices:  # no shortest path is longer
                    ended_by_bound = True
                    break
            if not ended_by_bound:
                # ended by exhaustion: the recorded value is 0, so a replay
                # whose frontier is still alive here flags an overflow
                self.sched.observe(alive_dev)
            if optional:
                matched_chunks.append(matched)
        if count_only:
            if recording:
                approx = float(totalf_dev)
                exact = int(total_dev)
                if not (
                    0 <= approx < 2**31 * 0.99
                    and abs(approx - exact) <= max(1e-3 * approx, 1.0)
                ):
                    raise Uncompilable(f"var-depth COUNT overflows int32 (≈{approx:.6g})")
            # free: the count IS the result
            t = Table(self.device, count=self.sched.observe(total_dev, free=True), width=0)
            t.count_dev = total_dev
            return t
        if optional:
            matched_all = torch.cat(matched_chunks)[: table.width]
            upart, ukeep = self._unmatched_part(table, matched_all)
            if upart is not None:
                null = torch.full((upart.width,), -1, dtype=I32, device=self.device)
                if step.close and f is not None and f.optional:
                    pass  # a probe between two bound aliases: both survive
                elif step.close:
                    src_g = K.take_pad(srcs, ukeep, -1)
                    upart.cols[dst_alias] = torch.where(src_g < 0, upart.cols[dst_alias], -1)
                else:
                    upart.cols[dst_alias] = null
                if depth_alias:
                    upart.depth_cols[depth_alias] = null
                parts.append(upart)
                counts.append(upart.count)
        if not parts:
            return self._empty_like(table, dst_alias, depth_alias=depth_alias)
        return _concat_tables(parts, counts, self.device)

    def _emit_var_level(
        self, table, reached, node_vec, bound_chunk, cs, depth, dst_alias,
        depth_alias, vb, parts, counts, any_row: bool = False,
    ):
        """One BFS level's (row, vertex, depth) bindings as a part table.
        A level whose recorded emission is empty still appends a
        minimum-capacity part, so a replay may emit there without an
        overflow. With ``any_row``, returns which chunk rows emitted (an
        OPTIONAL arm's match flags)."""
        emit, hit, n_dev = K.bitmap_emit(
            reached, node_vec, bound_chunk, emit=True, any_row=any_row, count=True
        )
        keep, kn, kn_dev = _observe_compact(
            self.sched, emit.view(-1), min_capacity=K.bucket(0), count_dev=n_dev
        )
        ok = keep >= 0
        rowid = torch.where(ok, cs + keep // vb, -1)
        part = table.gather(rowid)
        part.count = kn
        part.count_dev = kn_dev
        part.cols[dst_alias] = torch.where(ok, keep % vb, -1)
        if depth_alias:
            part.depth_cols[depth_alias] = torch.where(ok, depth, -1).to(I32)
        parts.append(part)
        counts.append(kn)
        return hit

    # -- NOT arms: the bitmap anti-join --------------------------------------

    def _apply_not_paths(self, table: Table) -> Table:
        """Drop the rows for which a NOT arm is satisfiable."""
        for aliases, masks, items in self._not_compiled:
            if table.empty():
                return table
            table = self._apply_not_path(table, aliases, masks, items)
        return table

    def _apply_not_path(self, table: Table, aliases, masks, items) -> Table:
        """One NOT arm as a chunked bitmap chain: the candidates of its first
        position (the one-hot of the bound alias, or its admission mask
        over every vertex), one hop per arm item (over the edges its edge
        WHERE admits) with the target's mask (and binding, where the alias
        is bound) ANDed in; a row with a survivor at the chain's end
        matches the arm and is dropped."""
        width = table.width or 1
        vb = self._vb()
        node_vecs = [self._vertex_vec(m) for m in masks]
        hops_per_item = []
        for it in items:
            dirs = ("out", "in") if it.direction == "both" else (it.direction,)
            f = it.edge_filter
            hop_items = []
            for c in self._resolve_edge_classes(it):
                emask = self._edge_mask(c, f.where if f is not None else None)
                hop_items.extend((c, d, emask) for d in dirs)
            hops_per_item.append(
                build_bitmap_hops(
                    self.dg, hop_items, self.sched, self.tier, self.tier_touched, self.overlay
                )
            )
        valid_dev = table.valid_device
        exists_chunks = []
        C = self._var_chunk_rows(width, vb)
        for cs in range(0, width, C):
            chunk_rows, live = self._chunk_rows(valid_dev, cs, C)
            if aliases[0] in table.cols:
                src = K.take_pad(table.cols[aliases[0]], chunk_rows, -1)
                cur, _, alive = K.bitmap_emit(
                    K.rows_to_bitmap(src, vb), node_vecs[0], emit=True, count=True
                )
            else:
                cur, alive = (node_vecs[0][None, :] & live[:, None]).contiguous(), None
            exists = None if items else cur.any(dim=1)
            for k, hops in enumerate(hops_per_item):
                nxt = _run_hops(hops, cur, None, alive)
                tgt = aliases[k + 1]
                bound = (
                    K.take_pad(table.cols[tgt], chunk_rows, -2) if tgt in table.cols else None
                )
                last = k == len(hops_per_item) - 1
                cur, exists, alive = K.bitmap_emit(
                    nxt, node_vecs[k + 1], bound, emit=not last, any_row=last, count=not last
                )
            exists_chunks.append(exists)
        exists = torch.cat(exists_chunks)[:width]
        keep_mask = valid_dev[:width].to(torch.bool) & ~exists
        keep, kn, kn_dev = self._compact(keep_mask)
        t = table.gather(keep)
        t.count = kn
        t.count_dev = kn_dev
        return t

    # -- marshalling --------------------------------------------------------

    @staticmethod
    def _live_rows(table: Table):
        """Row selector for marshalling: live rows may sit among bucket
        padding, and the valid mask is authoritative."""
        if table.valid is None:
            return np.arange(table.count)
        return np.flatnonzero(_host(table.valid) > 0)

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

    def finalize_count(self, name: str, count: int, params: Optional[Dict] = None) -> List[Result]:
        # aggregate path applies only ORDER/SKIP/LIMIT (no DISTINCT)
        params = self.params if params is None else params
        out = [Result(props={name: count})]
        out = _order_rows(out, self.stmt.order_by, self.db, params, None)
        return _skip_limit(
            out, self.stmt.skip, self.stmt.limit, EvalContext(self.db, params=params)
        )

    def rows_from_table(self, table: Table, params: Optional[Dict] = None):
        """Result rows from the table's columns (device tensors on the
        recording run, host arrays of a replay's fetched page): a lone
        count(*) is the table's count; ``alias.prop`` projections decode
        the snapshot's host columns, of the vertex at a vertex alias's id
        or of the edge at an edge alias's (class index, edge id); a vertex
        alias's record renders as its RID (``p``, ``p.@rid``; ``p.@class``
        its class); depth aliases read their depth column; an expression
        over aliases evaluates per row with each bound alias a non-null
        value and each unbound one null (`_check_returns` admitted only
        these shapes). ``$matches`` is one RID column per named alias,
        ``$elements`` and a whole-record SELECT are record rows
        (`RecordRows`). ``params`` are the call's (a replay serves other
        values than the recording's)."""
        params = self.params if params is None else params
        name = self.count_only_name()
        if name is not None:
            return self.finalize_count(name, table.count, params)
        stmt = self.stmt
        sel = self._live_rows(table)
        n = int(sel.shape[0])
        host: Dict[str, np.ndarray] = {}
        # the DISTINCT / ORDER BY / SKIP / LIMIT tail reads records and RIDs
        # as objects; without it a record renders straight to its RID string
        tail = bool(stmt.distinct or stmt.order_by or stmt.skip or stmt.limit)

        def ids(alias):
            """The alias's ids at the live rows: vertex ids, or (class
            index, edge id) of an edge alias; None where it never binds."""
            if alias not in host:
                if alias in table.cols:
                    host[alias] = _host(table.cols[alias])[sel]
                elif alias in table.edge_cols:
                    ci, eid = table.edge_cols[alias]
                    host[alias] = (_host(ci)[sel], _host(eid)[sel])
                elif alias in table.depth_cols:
                    host[alias] = _host(table.depth_cols[alias])[sel]
                else:
                    host[alias] = None
            return host[alias]

        special = self._special_return()
        if special == "elements" or self.element_alias is not None:
            return self._record_rows(ids, n, tail, params)
        if special == "matches":
            names = self._named()
            obj_cols = [self._record_values(ids(a), n, tail) for a in names]
        else:
            names, obj_cols = [], []
            for i, p in enumerate(stmt.returns):
                names.append(p.alias or _match_proj_name(p.expr, i))
                obj_cols.append(self._projection_values(p.expr, ids, n, tail, params))
        if not tail:
            return ColumnarRows(names, [c.tolist() for c in obj_cols], n)
        out = [Result(props=dict(zip(names, r))) for r in zip(*obj_cols)]
        return finalize_match_rows(self.db, stmt, out, params, None)

    def _projection_values(self, e, ids, n: int, tail: bool, params) -> np.ndarray:
        """One RETURN item's values at the live rows, as an object array."""
        nodes = self.pattern.nodes
        if isinstance(e, A.Identifier) and e.name in nodes:
            return self._record_values(ids(e.name), n, tail)
        if isinstance(e, A.Identifier):  # a depth alias: plain ints
            d = ids(e.name)
            o = d.astype(object)
            o[d < 0] = None
            return o
        if isinstance(e, A.FieldAccess):
            if nodes[e.base.name].is_edge_alias:
                return self._edge_values(ids(e.base.name), e.name, n)
            idx = ids(e.base.name)
            if e.name == "@rid":
                return self._record_values(idx, n, tail, rid_only=True)
            if e.name == "@class":
                out = np.full(n, None, object)
                if idx is not None:
                    ok = idx >= 0
                    out[ok] = np.asarray(self.snap.class_names, object)[self.snap.v_class[idx[ok]]]
                return out
            col = self.snap.v_columns.get(e.name)
            if idx is None or col is None:
                return np.full(n, None, object)  # never present
            return col.objects_at(idx)
        return self._alias_expression_values(e, ids, n, params)

    def _record_values(self, idx, n: int, tail: bool, rid_only: bool = False) -> np.ndarray:
        """A vertex alias's records at the live rows (None where unbound):
        for the tail, `VertexRecord` objects (``rid_only``: `RID` objects),
        else their RID strings, as the reference's rows render them."""
        out = np.full(n, None, object)
        if idx is None:
            return out
        pos = np.flatnonzero(idx >= 0)
        if not tail:
            out[pos] = rid_strings(*self.snap.rids_of(idx[pos]))
            return out
        for j, i in zip(pos.tolist(), idx[pos].tolist()):
            out[j] = self.snap.rid_of(i) if rid_only else VertexRecord(self.snap, i)
        return out

    def _record_rows(self, ids, n: int, tail: bool, params):
        """Element rows: ``$elements`` (each named alias's record, row after
        row) or a whole-record SELECT (the element alias's records, after
        the tail ran over rows binding it)."""
        aliases = [self.element_alias] if self.element_alias is not None else self._named()
        cols = [ids(a) for a in aliases]
        mat = np.stack([c if c is not None else np.full(n, -1, np.int32) for c in cols], 1)
        flat = mat.reshape(-1)
        rec = flat[flat >= 0]
        if not tail:
            return RecordRows(self.snap, rec)
        if self.element_alias is None:
            out = [Result(element=VertexRecord(self.snap, i)) for i in rec.tolist()]
            return finalize_match_rows(self.db, self.stmt, out, params, None)
        a = self.element_alias
        out = [Result(props={a: VertexRecord(self.snap, i)}) for i in cols[0].tolist()]
        out = finalize_match_rows(self.db, self.stmt, out, params, None)
        return [Result(element=r.get_property(a)) for r in out]

    def _edge_values(self, pair, prop: str, n: int) -> np.ndarray:
        """An edge property at each row's bound edge, read from its class's
        edge column (None where unbound or absent)."""
        out = np.full(n, None, object)
        if pair is None:
            return out
        ci, eid = pair
        for k, cname in enumerate(self.edge_class_list):
            col = self.snap.edge_classes[cname].edge_columns.get(prop)
            if col is None:
                continue
            rows = np.flatnonzero((ci == k) & (eid >= 0))
            if rows.size:
                out[rows] = col.objects_at(eid[rows])
        return out

    def _alias_expression_values(self, e, ids, n: int, params) -> np.ndarray:
        """An expression over aliases, row by row: a bound vertex or edge
        alias reads as True, an unbound one as None, a depth alias as its
        depth."""
        refs = sorted(_identifiers(e))
        flags = {}
        for a in refs:
            v = ids(a)
            if v is None:
                flags[a] = np.full(n, None, object)
            elif isinstance(v, tuple):
                flags[a] = np.where(v[1] >= 0, True, None)
            elif a in self.pattern.nodes:
                flags[a] = np.where(v >= 0, True, None)
            else:
                o = v.astype(object)
                o[v < 0] = None
                flags[a] = o
        out = np.empty(n, object)
        if isinstance(e, A.IsNull) and isinstance(e.expr, A.Identifier):
            # the common probe (``kn IS NOT NULL``), without a row loop
            null = np.equal(flags[e.expr.name], None)
            out[:] = (~null if e.negated else null).tolist()
            return out
        for i in range(n):
            ctx = EvalContext(self.db, params=params, variables={a: flags[a][i] for a in refs})
            out[i] = evaluate(ctx, e)
        return out


def _identifiers(e) -> set:
    """The bare names an alias expression (`_alias_expression`) reads."""
    if isinstance(e, A.Identifier):
        return {e.name}
    if isinstance(e, (A.IsNull, A.Unary)):
        return _identifiers(e.expr)
    if isinstance(e, A.Binary):
        return _identifiers(e.left) | _identifiers(e.right)
    return set()


def _host(col) -> np.ndarray:
    """A column as a host array: a device tensor is copied (recording
    runs), a replay's fetched page already is one."""
    if isinstance(col, torch.Tensor):
        return col.cpu().numpy()
    return np.asarray(col)



# ---------------------------------------------------------------------------
# TRAVERSE
# ---------------------------------------------------------------------------


class TpuTraverseSolver:
    """Compiled TRAVERSE: level-wise bitmap BFS over one ``[1, vb]`` row.

    The roots (`oracle.resolve_target_ids`, deduplicated in first-occurrence
    order) are set in a zeroed bitmap by K16 `scatter_set`; each level ORs
    one frontier hop per (edge class, direction) of the fields (K10, or K19
    on a tiered snapshot; the frontier itself is not gated), then admits
    ``nxt &= ~visited & gate(depth + 1); visited |= nxt`` in one K12 launch,
    the WHILE gate a K15 program over the vertex universe at ``$depth + 1``
    (so a vertex it rejects is neither emitted nor visited), and K3 writes
    the level's vertex ids, ascending, at its offset in the one output
    buffer. Depth 0 emits the roots in the caller's order. The walk stops on
    an empty level, at MAXDEPTH, or past |V| levels.

    As in the reference: BREADTH_FIRST admits every record at its minimum
    discovery depth, which is what level-wise BFS computes; DEPTH_FIRST
    compiles only without MAXDEPTH and WHILE (the result is then the
    reachability closure); LIMIT (it slices in traversal order), ``*``,
    ``outE/inE/bothE`` and non-literal edge classes raise `Uncompilable`.

    The recording run reads each level's count on the host; a replay bakes
    them (and the roots), so it is valid only on the snapshot it recorded:
    a delta-maintained snapshot that applied a batch since re-records
    (`_check_traverse_static`), and a replay whose level differs from the
    recording raises its overflow flag."""

    def __init__(self, db, stmt: A.TraverseStatement, params: Dict) -> None:
        self.db = db
        self.stmt = stmt
        self.params = params or {}
        snap = db.current_snapshot()
        if snap is None:
            raise Uncompilable("no snapshot attached")
        self.snap = snap
        self.device = db.device
        self.overlay = snap._overlay
        if self.overlay is not None and self.overlay.poisoned is not None:
            raise Uncompilable(f"delta overlay poisoned: {self.overlay.poisoned}")
        self.delta_gen = self.overlay.plan_gen if self.overlay is not None else 0
        self.delta_data_version = self.overlay.data_version if self.overlay is not None else 0
        self.tier = snap._tier
        self.tier_touched: set = set()
        self.sched = SizeSchedule()
        if stmt.limit is not None:
            raise Uncompilable("TRAVERSE LIMIT slices in traversal order")
        if stmt.strategy == "DEPTH_FIRST" and (
            stmt.max_depth is not None or stmt.while_cond is not None
        ):
            raise Uncompilable("DEPTH_FIRST with MAXDEPTH/WHILE admits at non-minimal depths")
        self.hop_dirs = self._compile_fields(stmt.fields)
        _check_record_rows(snap)
        self.dg: DeviceGraph = device_graph(snap, db.device)
        self.while_fn = None
        if stmt.while_cond is not None:
            scope = ColumnScope(self.dg.columns, self.dg.non_columnar, device=self.dg.device)
            self.while_fn = compile_predicate(stmt.while_cond, scope, self.params, allow_depth=True)
        from orientdb_tpu_torch.exec.oracle import resolve_target_ids

        ids = resolve_target_ids(db, stmt.target, self.params)
        _, first = np.unique(ids, return_index=True)
        self.roots = ids[np.sort(first)].astype(np.int32)
        self._roots_dev = torch.from_numpy(self.roots).to(self.device)
        self._root_bits = torch.ones(self.roots.shape[0], dtype=torch.bool, device=self.device)
        #: host count of each emitted level (depth 0 the roots), as recorded
        self.levels: List[int] = []

    def _compile_fields(self, fields) -> List[Tuple[str, str]]:
        """``out()/in()/both()`` fields with literal edge classes (or none)
        → the (concrete edge class, direction) of each hop."""
        if not fields:
            raise Uncompilable("TRAVERSE * follows edges as records")
        dirs: List[Tuple[str, Optional[str]]] = []
        for f in fields:
            if not isinstance(f, A.FunctionCall):
                raise Uncompilable("TRAVERSE field is not out()/in()/both()")
            name = f.name.lower()
            if name not in ("out", "in", "both"):
                raise Uncompilable(f"TRAVERSE {name}() emits non-vertex records")
            classes: List[Optional[str]] = [] if f.args else [None]
            for a in f.args:
                if not (isinstance(a, A.Literal) and isinstance(a.value, str)):
                    raise Uncompilable("non-literal edge class in TRAVERSE field")
                classes.append(a.value)
            dirs.extend((name, c) for c in classes)
        items = []
        for direction, cls in dirs:
            for cname in self.snap.concrete_edge_classes(cls):
                for d in ("out", "in") if direction == "both" else (direction,):
                    items.append((cname, d))
        return items

    @property
    def vb(self) -> int:
        return K.bucket(max(self.dg.num_vertices, 1))

    def solve(self, out: torch.Tensor) -> int:
        """Write the emitted vertex ids into ``out`` (int32, at least the
        total long; slots past it untouched), level by level, and return
        the host total."""
        V, vb = self.dg.num_vertices, self.vb
        sched = self.sched
        live = self.overlay is not None
        items = [(c, d, self.dg.edges[c].live if live else None) for c, d in self.hop_dirs]
        hops = build_bitmap_hops(self.dg, items, sched, self.tier, self.tier_touched, self.overlay)
        nr = int(self.roots.shape[0])
        frontier = torch.zeros((1, vb), dtype=torch.bool, device=self.device)
        if nr:
            K.scatter_set(frontier.view(-1), self._roots_dev, self._root_bits)
            out[:nr].copy_(self._roots_dev)
        # the frontier is its own visited set until the first level step
        # updates it in place (after the hop has read the frontier)
        visited = frontier
        alive = torch.full((), nr, dtype=I32, device=self.device)
        self.levels = [nr]
        total, depth = nr, 0
        max_depth = self.stmt.max_depth
        while max_depth is None or depth < max_depth:
            nxt = _run_hops(hops, frontier, None, alive)
            gate = None
            if self.while_fn is not None:
                gate = self.while_fn.identity(vb, V, env={"depth": depth + 1})
            alive = K.frontier_advance(nxt, visited, gate)
            kn = sched.observe(alive, free=True)
            if not sched.recording:
                sched.note_flag(alive != kn)
            if kn == 0:
                break
            K.compact_indices(nxt.view(-1), kn, out=out, offset=total)
            total += kn
            depth += 1
            self.levels.append(kn)
            frontier = nxt
            if depth > V:  # no minimum depth exceeds |V|
                break
        return total

    def rows_from(self, ids) -> RecordRows:
        return RecordRows(self.snap, _host(ids))


# ---------------------------------------------------------------------------
# compiled plan: the captured replay
# ---------------------------------------------------------------------------


class ScheduleOverflow(Exception):
    """A parameter-generic replay's live sizes exceeded the recorded
    schedule's capacities; the result was discarded. Caller re-records."""


def _check_delta_gen(solver) -> None:
    """Refuse the dispatch of a plan recorded under an older delta
    structure (a first topology delta, a dictionary append or a bucket
    overflow bumps the generation and clears the plan cache; this guards
    plans picked before the bump): `ScheduleOverflow` sends the caller into
    the re-record path. A poisoned overlay refuses every compiled query."""
    ov = solver.overlay
    if ov is None:
        return
    if ov.poisoned is not None:
        raise Uncompilable(f"delta overlay poisoned: {ov.poisoned}")
    if ov.plan_gen != solver.delta_gen:
        raise ScheduleOverflow(f"delta structure moved (gen {solver.delta_gen} -> {ov.plan_gen})")


def _check_traverse_static(solver) -> None:
    """Refuse the dispatch of a TRAVERSE plan on a delta-maintained snapshot
    that applied a batch since its recording: the replay bakes its roots and
    level counts, so `ScheduleOverflow` sends the caller into a re-record."""
    ov = solver.overlay
    if ov is not None and ov.data_version != solver.delta_data_version:
        raise ScheduleOverflow(
            "traverse recording is stale under delta maintenance "
            f"(data v{solver.delta_data_version} -> v{ov.data_version})"
        )


def _check_tier_gen(plan) -> None:
    """Refuse the dispatch of a tiered plan captured under an older tier
    generation: a pool grew into new tensors since, and the captured graph
    holds the old pointers. `ScheduleOverflow` sends the caller into the
    re-record path, which captures anew."""
    tier = plan.solver.tier
    if tier is not None and tier.generation != plan.tier_gen:
        raise ScheduleOverflow(f"tier pool grew (gen {plan.tier_gen} -> {tier.generation})")


def _to_host(ts: List[torch.Tensor]) -> "_Fetch":
    """Queue copies of ``ts`` into pinned host memory on the current
    stream, and the event that marks them done (the tensors themselves on
    the CPU)."""
    if ts[0].device.type != "cuda":
        return _Fetch(None, ts)
    host = []
    for t in ts:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record()
    return _Fetch(event, host)


class _Fetch:
    """A dispatched replay's results on their way to the host: the host
    tensors (pinned, filled by copies queued behind the replay on a card)
    and the event that marks the copies done (None on the CPU). A batch
    item of a rows plan also keeps its page ladder on the device
    (``pages``: the int32 and the int16 prefix views) until the batch
    elects a page from it after the meta wave."""

    __slots__ = ("event", "host", "pages", "pinned")

    def __init__(self, event, host: List[torch.Tensor], pages=None) -> None:
        self.event = event
        self.host = host
        self.pages = pages
        #: the tier footprint this dispatch pinned, until its plan releases it
        self.pinned = None

    def arrays(self) -> List[np.ndarray]:
        """Wait for the copies; the host arrays."""
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


class _GroupReplay:
    """The group replay of one (plan, lane bucket ``Bb``): the static
    ``[Bb, P]`` int32 parameter stack, the stacked outputs the lanes write
    (on a card allocated once, outside the graph pool, so no other plan's
    replay can overwrite them before the batch reads them; on the CPU the
    last dispatch's) and, on a card, the
    captured graph with its kernel launches, node count, capture time and
    the reserved device memory right after the capture."""

    __slots__ = ("stack", "out", "graph", "launches", "nodes", "capture_ms", "reserved_bytes")

    def __init__(self, stack: torch.Tensor, out: Optional[Dict[str, torch.Tensor]]) -> None:
        self.stack = stack
        self.out = out
        self.graph = None
        self.launches: Dict[str, int] = {}
        self.nodes: Optional[int] = None
        self.capture_ms: Optional[float] = None
        self.reserved_bytes: Optional[int] = None


def _graph_nodes(graph) -> int:
    """Node count of a captured graph kept uninstantiated
    (``CUDAGraph(keep_graph=True)``), read with libcuda's
    ``cuGraphGetNodes``."""
    lib = ctypes.CDLL("libcuda.so.1")
    fn = lib.cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    rc = fn(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return int(n.value)


class _CompiledPlan:
    """A solver whose size schedule is learned: re-executions replay the
    whole solve without a host read.

    Numeric query parameters are inputs of the replay (`ParamBox`), so ONE
    recorded plan serves every parameter value. Because buffer sizes were
    recorded under the recording parameters, the replay returns beside the
    result the true row count and an overflow flag; materialisation reads
    the live prefix, and an overflow raises `ScheduleOverflow` so the front
    door re-records.

    On a card, `capture` runs one eager replay on the replay stream (the
    first launch of every kernel happens outside capture) and captures the
    next into a `torch.cuda.CUDAGraph` sharing the device's memory pool.
    The dynamic parameters live in a static device buffer that `dispatch`
    fills from pinned host memory before ``graph.replay()``; the outputs
    are the graph's static tensors, copied into pinned host buffers behind
    the replay. On the CPU, `dispatch` runs the same replay-mode solve
    directly: the captured replay's plain version.

    A row plan's result is the front-packed int32 [W, C] page (rows
    leading, so every page of the ladder is a prefix view) with a meta row
    ``[count, overflow, fits16]``; a small one (``direct_fetch``) is ONE
    flat buffer: the W·C data values then the meta row."""

    def __init__(
        self,
        solver,
        count: int,
        width: int,
        names: Tuple[List[str], List[str], List[str]] = ([], [], []),
        count_name: Optional[str] = None,
        dyn_spec: Optional[Dict] = None,
    ) -> None:
        self.solver = solver
        #: result columns by alias: vertex, edge (class index then edge id)
        #: and depth aliases
        self.v_names, self.e_names, self.d_names = names
        self.count = count
        self.width = width
        self.count_name = count_name
        self.fetch_limit = self._literal_fetch_limit(solver.stmt)
        #: result columns in the packed data (vertex + 2 per edge + depth)
        self.ncols = len(self.v_names) + 2 * len(self.e_names) + len(self.d_names)
        #: small full buffers ship whole, data and meta in one copy
        self.direct_fetch = (
            self.count_name is None
            and self.ncols > 0
            and self.width >= 2
            and 4 * self.width * self.ncols <= config.result_direct_bytes
        )
        #: page-ladder budget, frozen per plan (retuning applies from the
        #: next recording, never to a captured graph)
        self.page_budget_bytes = int(config.result_page_budget_bytes)
        #: dynamic parameters the compiled predicates actually read
        self.dyn_spec = dict(dyn_spec or {})
        #: lane bucket → group replay (`dispatch_many`)
        self.groups: Dict[int, _GroupReplay] = {}
        #: group replays run: one per chunk of a batch's group
        self.group_replays = 0
        #: static int32 parameter buffer (float32 values by their bits)
        self._params_dev: Optional[torch.Tensor] = None
        self.graph = None  # torch.cuda.CUDAGraph once captured
        self.out: Optional[Dict] = None  # the graph's static outputs
        #: kernel launches of one replay, counted while capturing
        self.launches: Dict[str, int] = {}
        self.replays = 0
        #: host seconds of the last dispatch: parameter upload, replay launch
        self.dispatch_s: Dict[str, float] = {}
        self.capture_ms: Optional[float] = None
        #: torch.cuda.memory_reserved right after the capture
        self.reserved_bytes: Optional[int] = None
        #: tiered snapshots: the blocks the recording faulted in, which every
        #: dispatch prefetches and pins, and the tier generation the plan was
        #: captured under
        self.tier_footprint = frozenset(solver.tier_touched)
        self.tier_gen = solver.tier.generation if solver.tier is not None else 0

    @classmethod
    def of_table(cls, solver: TpuMatchSolver, table: Table) -> "_CompiledPlan":
        """The plan of a recorded MATCH (or rewritten SELECT) solve."""
        names = (sorted(table.cols), sorted(table.edge_cols), sorted(table.depth_cols))
        return cls(
            solver, table.count, table.width, names, solver.count_only_name(), solver.param_box.used
        )

    # -- the replay body -----------------------------------------------------

    def _replay_table(self, params: Optional[torch.Tensor] = None) -> Table:
        """The recorded solve in replay mode: recorded sizes, the device
        overflow flag, the parameters read from an int32 device row (the
        static buffer, or a group lane's row of its stack), and no lazy
        upload."""
        solver = self.solver
        solver.param_box.set_row(self._params_dev if params is None else params)
        try:
            solver.sched.start_replay()
            with solver.dg.sealed():
                table = solver.solve_table()
        finally:
            solver.param_box.reset()
        if solver.sched.pos != len(solver.sched.values):
            raise RuntimeError(
                f"replay observed {solver.sched.pos} sizes, the recording "
                f"{len(solver.sched.values)}"
            )
        return table

    def _replay_core(
        self, out: Optional[torch.Tensor] = None, params: Optional[torch.Tensor] = None
    ):
        """Run the replay-mode solve on ``params`` (default: the static
        buffer) and front-pack the result columns (into ``out`` when given).
        Returns ``(count_dev, overflow, data)``, ``data`` the [W, C] int32
        page (None for count-only or column-less plans)."""
        table = self._replay_table(params)
        overflow = self.solver.sched.overflow_flag(self.solver.device).to(I32)
        count_dev = table.count_device.to(I32)
        if self.count_name is not None or self.width == 0:
            return count_dev, overflow, None
        flat = [table.cols[a] for a in self.v_names]
        for a in self.e_names:
            flat.extend(table.edge_cols[a])
        flat.extend(table.depth_cols[a] for a in self.d_names)
        if not flat:
            return count_dev, overflow, None
        width = flat[0].shape[0]
        data = K.front_pack(table.valid_device[:width].contiguous(), flat, out=out)
        return count_dev, overflow, data

    def _replay(self) -> Dict:
        """The replay's outputs: ``{"meta"}`` for a count plan, ``{"direct"}``
        for a direct-fetch plan, else ``{"meta", "pages32", "pages16"}``."""
        dev = self.solver.device
        if self.direct_fetch:
            W, C = self.width, self.ncols
            buf = torch.empty(W * C + 3, dtype=I32, device=dev)
            count_dev, overflow, data = self._replay_core(out=buf[: W * C].view(W, C))
            if data is not None:
                K.replay_meta(data, count_dev, overflow, out=buf[W * C :])
                return {"direct": buf}
        else:
            count_dev, overflow, data = self._replay_core()
        if data is None:
            # COUNT(*) plan (or column-less table): two scalars suffice
            return {"meta": torch.stack([count_dev, overflow, torch.zeros_like(count_dev)])}
        meta = K.replay_meta(data, count_dev, overflow)
        # the full pages in both widths, and under the budget the pow2
        # ladder of prefix pages that a batch elects from after reading the
        # meta row: with rows leading, every page is a view
        data16 = K.narrow_i16(data)
        W, C = data.shape
        pages32: List[torch.Tensor] = []
        pages16: List[torch.Tensor] = []
        if 12 * W * C <= self.page_budget_bytes:
            p = _PAGE_MIN
            while p < W:
                pages32.append(data[:p])
                pages16.append(data16[:p])
                p *= 2
        pages32.append(data)
        pages16.append(data16)
        return {"meta": meta, "pages32": pages32, "pages16": pages16}

    # -- the group replay (a batch's same-plan items) -------------------------

    def batchable(self) -> bool:
        """Eligible for the group replay: count-only and direct-fetch plans
        (one small output a lane), and row plans whose full int32 page fits
        ``config.result_group_lane_bytes`` (the group keeps one a lane and
        elects ONE compact page for all of them after the meta wave). A
        tiered plan is not: each dispatch prefetches and pins its own
        footprint, so its batch items replay one by one, as the reference
        excludes them; so is a mesh plan, as in the reference."""
        if self.solver.tier is not None or self.solver.dg.mesh_graph is not None:
            return False
        return not self._rows_grouped() or 4 * self.width * self.ncols <= config.result_group_lane_bytes

    def _rows_grouped(self) -> bool:
        """True when a group replays the rows form (meta rows plus the lane
        stack of front-packed pages) rather than one small output a lane."""
        return not (self.count_name is not None or self.width == 0 or self.direct_fetch)

    def _group_lane_cap(self) -> int:
        """Most lanes in one group replay: lanes x 4E must fit
        ``config.group_hbm_budget_bytes``, E the largest edge class the
        plan's arms walk (the reference's formula, sized there by the
        classes its recording touched), floored to a power of two; a plan
        that reads no edges is not capped."""
        dg = self.solver.dg
        E = max(
            (dg.edges[c].num_edges for c in self.solver.edge_classes_read() if c in dg.edges),
            default=0,
        )
        if E <= 0:
            return 1 << 30
        cap = max(1, int(config.group_hbm_budget_bytes) // (4 * E))
        return 1 << (cap.bit_length() - 1)

    @staticmethod
    def _page_round(W: int, need: int) -> int:
        """Rows of a rows group's compact page covering ``need`` live rows:
        rounded up to a multiple of ``_GROUP_PAGE_ROUND``, capped at W."""
        return min(W, -(-max(need, 1) // _GROUP_PAGE_ROUND) * _GROUP_PAGE_ROUND)

    def _group_outputs(self, Bb: int) -> Dict[str, torch.Tensor]:
        """The stacked outputs of ``Bb`` lanes: ``direct`` [Bb, W·C + 3] for a
        direct-fetch plan, else ``meta`` [Bb, 3] rows and, for a rows plan
        with columns, ``data`` [Bb, W, C] (no page ladder a lane: the group
        elects one page for all lanes)."""
        dev = self.solver.device
        W, C = self.width, self.ncols
        if self.direct_fetch:
            return {"direct": torch.empty((Bb, W * C + 3), dtype=I32, device=dev)}
        out = {"meta": torch.empty((Bb, 3), dtype=I32, device=dev)}
        if self._rows_grouped() and C > 0:
            out["data"] = torch.empty((Bb, W, C), dtype=I32, device=dev)
        return out

    def _replay_lanes(self, stack: torch.Tensor, out: Dict[str, torch.Tensor]) -> None:
        """The group replay's body, the port's form of the reference's
        ``jax.vmap(replay)``: lane k runs the replay-mode solve on row k of
        the parameter stack and writes only row k of ``out``. Lanes run one
        after another, each dropping its table before the next starts; the
        solver resets its parameters, schedule cursor and overflow flag for
        each lane, so each lane's meta row carries its own flag."""
        W, C = self.width, self.ncols
        for k in range(stack.shape[0]):
            if "direct" in out:
                row = out["direct"][k]
                count_dev, overflow, data = self._replay_core(
                    out=row[: W * C].view(W, C), params=stack[k]
                )
                K.replay_meta(data, count_dev, overflow, out=row[W * C :])
                continue
            count_dev, overflow, data = self._replay_core(
                out=out["data"][k] if "data" in out else None, params=stack[k]
            )
            if data is None:
                out["meta"][k].copy_(torch.stack([count_dev, overflow, torch.zeros_like(count_dev)]))
            else:
                K.replay_meta(data, count_dev, overflow, out=out["meta"][k])

    def _group_replay(self, Bb: int, first: np.ndarray) -> _GroupReplay:
        """The (cached) group replay of ``Bb`` lanes. On a card its first use
        captures it: one eager run of the lane loop on the replay stream
        (with ``first``, the first chunk's parameters), then the capture
        into the device's shared graph pool. A capture failure raises."""
        g = self.groups.get(Bb)
        if g is not None:
            return g
        dev = self.solver.device
        P = max(len(self.dyn_spec), 1)
        if dev.type != "cuda":
            # the plain version: outputs are made anew by each dispatch
            g = self.groups[Bb] = _GroupReplay(torch.zeros((Bb, P), dtype=I32, device=dev), None)
            return g
        t0 = time.perf_counter()
        pool, stream = replay_resources(dev)
        with REPLAY_LOCK:
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                g = _GroupReplay(torch.zeros((Bb, P), dtype=I32, device=dev), self._group_outputs(Bb))
                g.stack.copy_(torch.from_numpy(first).pin_memory(), non_blocking=True)
                self._replay_lanes(g.stack, g.out)  # warm-up, uncaptured
            stream.synchronize()
            before = dict(K.LAUNCHES)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            try:
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    self._replay_lanes(g.stack, g.out)
            finally:
                recorded = {k: K.LAUNCHES[k] - before[k] for k in before}
                K.LAUNCHES.update(before)
            g.nodes = _graph_nodes(graph)
            graph.instantiate()
        g.graph = graph
        g.launches = {k: n for k, n in recorded.items() if n}
        g.capture_ms = (time.perf_counter() - t0) * 1e3
        g.reserved_bytes = torch.cuda.memory_reserved(dev)
        self.groups[Bb] = g
        return g

    def dispatch_many(self, params_list: List[Dict]) -> Optional["_Group"]:
        """B same-plan replays as ONE group: the lanes padded to the next
        power of two ``Bb`` (capped by `_group_lane_cap`; the padding lanes
        repeat the last lane's parameters), a batch over the cap replaying
        the group in ``ceil(B / Bb)`` chunks. Each chunk is one parameter
        upload from its own pinned buffer, one ``graph.replay()`` and the
        copy of its stacked meta rows (or direct buffers) to pinned host
        memory, queued before the next chunk. A rows group keeps its lane
        stack on the card for the page election. Returns None for a rows
        plan whose bucket exceeds the cap (it stays per-lane, as in the
        reference: its page election takes one stack)."""
        B = len(params_list)
        Bb = 1 << (B - 1).bit_length()
        cap = self._group_lane_cap()
        if Bb > cap and self._rows_grouped():
            return None
        Bb = min(Bb, cap)
        nchunks = -(-B // Bb)
        host = np.stack([self._dyn_args(p) for p in params_list])
        host = np.concatenate([host, np.repeat(host[-1:], nchunks * Bb - B, axis=0)])
        dev = self.solver.device
        with REPLAY_LOCK:
            g = self._group_replay(Bb, host[:Bb])
            if g.graph is None:
                chunks = []
                for c in range(nchunks):
                    g.stack.copy_(torch.from_numpy(host[c * Bb : (c + 1) * Bb]))
                    out = self._group_outputs(Bb)
                    self._replay_lanes(g.stack, out)
                    chunks.append(out)
                key = "direct" if self.direct_fetch else "meta"
                fetch = _Fetch(None, [torch.cat([o[key] for o in chunks])])
                g.out = chunks[-1]
                data_dev = g.out.get("data")
            else:
                _pool, stream = replay_resources(dev)
                stream.wait_stream(torch.cuda.current_stream(dev))
                fetched = g.out["direct" if self.direct_fetch else "meta"]
                with torch.cuda.stream(stream):
                    h = torch.empty((nchunks * Bb, *fetched.shape[1:]), dtype=I32, pin_memory=True)
                    for c in range(nchunks):
                        src = torch.from_numpy(host[c * Bb : (c + 1) * Bb]).pin_memory()
                        g.stack.copy_(src, non_blocking=True)
                        g.graph.replay()
                        h[c * Bb : (c + 1) * Bb].copy_(fetched, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(stream)
                fetch = _Fetch(event, [h])
                data_dev = g.out.get("data")
                for name, n in g.launches.items():
                    K.LAUNCHES[name] += n * nchunks
            self.group_replays += nchunks
        return _Group(self, fetch, data_dev=data_dev)

    # -- capture and dispatch -------------------------------------------------

    def check_fresh(self) -> None:
        """Raise when the plan is stale under delta maintenance
        (`_check_delta_gen`) or tiering (`_check_tier_gen`)."""
        _check_delta_gen(self.solver)
        _check_tier_gen(self)

    def _dyn_args(self, params: Optional[Dict]) -> np.ndarray:
        """The dynamic parameters as one host int32 array (float32 values
        by their bits), in `dyn_spec` order; raises when the plan is stale
        (`check_fresh`)."""
        self.check_fresh()
        return pack_params(params if params is not None else self.solver.params, self.dyn_spec)

    def _upload(self, host: np.ndarray) -> None:
        src = torch.from_numpy(host)
        if self._params_dev.device.type == "cuda":
            # pinned, so the copy is asynchronous (and capturable)
            self._params_dev.copy_(src.pin_memory(), non_blocking=True)
        else:
            self._params_dev.copy_(src)

    def capture(self) -> None:
        """Make the plan replayable: the static parameter buffer, and on a
        card the CUDA graph. A capture failure raises."""
        t0 = time.perf_counter()
        dev = self.solver.device
        if self.solver.tier is not None:
            self.tier_gen = self.solver.tier.generation
        self._params_dev = torch.zeros(max(len(self.dyn_spec), 1), dtype=I32, device=dev)
        if not self._captures():
            self._upload(self._dyn_args(None))
            return
        pool, stream = replay_resources(dev)
        with REPLAY_LOCK:
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self._upload(self._dyn_args(None))
                self._replay()  # warm-up: every kernel's first launch, uncaptured
            stream.synchronize()
            before = dict(K.LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    out = self._replay()
            finally:
                # capturing launches nothing: the launches land on replays
                recorded = {k: K.LAUNCHES[k] - before[k] for k in before}
                K.LAUNCHES.update(before)
        self.graph, self.out = graph, out
        self.launches = {k: n for k, n in recorded.items() if n}
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.reserved_bytes = torch.cuda.memory_reserved(dev)

    def _captures(self) -> bool:
        """Whether the plan replays as a captured graph: on a card, unless
        its mesh merges through a process group's collectives."""
        mg = self.solver.dg.mesh_graph
        return self.solver.device.type == "cuda" and (mg is None or not mg.mesh.collective)

    def _outputs_to_fetch(self, out: Dict, keep_pages: bool) -> List[torch.Tensor]:
        # the lone-query path ships the full int32 page; a batch item ships
        # its meta row first and elects a page of its ladder after it
        if "direct" in out:
            return [out["direct"]]
        if keep_pages or "pages32" not in out:
            return [out["meta"]]
        return [out["meta"], out["pages32"][-1]]

    def _kept_pages(self, out: Dict):
        """The page ladder of a replay's outputs, as (int32, int16) lists of
        prefix views; of private copies of the full pages when the plan is
        captured (a graph's outputs are overwritten by its next replay, and
        may be by other plans' replays in the shared pool)."""
        if "pages32" not in out:
            return None
        full32, full16 = out["pages32"][-1], out["pages16"][-1]
        if self.graph is not None:
            full32, full16 = full32.clone(), full16.clone()
        sizes = [int(p.shape[0]) for p in out["pages32"]]
        return [full32[:n] for n in sizes], [full16[:n] for n in sizes]

    def dispatch(self, params: Optional[Dict] = None, keep_pages: bool = False) -> _Fetch:
        """Upload the parameters and run the replay; the results' copies to
        the host are queued before the replay lock is released. With
        ``keep_pages`` (a batch item) a rows plan ships its meta row only
        and keeps its page ladder on the device (`_Fetch.pages`). A tiered
        plan first prefetches and pins its footprint (`_pin`); the pins
        ride on the returned fetch until `release`."""
        t0 = time.perf_counter()
        host_params = self._dyn_args(params)
        dev = self.solver.device
        if self.graph is None and self._captures():
            raise RuntimeError("dispatch of a plan that was never captured")
        with REPLAY_LOCK:
            pinned = self._pin()
            try:
                if dev.type != "cuda":
                    self._upload(host_params)
                    t1 = time.perf_counter()
                    out = self._replay()
                else:
                    # on the replay stream, where the copies to the host
                    # queue behind it (an uncaptured replay too: a plan
                    # whose mesh merges through a process group)
                    _pool, stream = replay_resources(dev)
                    stream.wait_stream(torch.cuda.current_stream(dev))
                    with torch.cuda.stream(stream):
                        self._upload(host_params)
                        t1 = time.perf_counter()
                        if self.graph is None:
                            out = self._replay()
                        else:
                            self.graph.replay()
                            out = self.out
                with on_replay_stream(dev):
                    fetch = _to_host(self._outputs_to_fetch(out, keep_pages))
                    if keep_pages:
                        fetch.pages = self._kept_pages(out)
            except BaseException:
                if pinned is not None:
                    self.solver.tier.release_footprint(pinned)
                raise
            fetch.pinned = pinned
            for name, n in self.launches.items():
                K.LAUNCHES[name] += n
            self.replays += 1
        self.dispatch_s = {"param_upload": t1 - t0, "replay": time.perf_counter() - t1}
        return fetch

    def _pin(self):
        """A tiered plan's footprint prefetch (loads queued on the replay
        stream ahead of the replay) and pins; the footprint, or None for an
        untiered plan. Raises `ScheduleOverflow`, unpinned, when the
        prefetch grew a pool (the captured graph reads the old tensors)."""
        tier = self.solver.tier
        if tier is None:
            return None
        tier.prepare_dispatch(self.tier_footprint)
        try:
            _check_tier_gen(self)
        except ScheduleOverflow:
            tier.release_footprint(self.tier_footprint)
            raise
        return self.tier_footprint

    def release(self, handle) -> None:
        """Drop the footprint pins a dispatch took, once (a no-op for an
        untiered plan's fetch, a group lane or None)."""
        pinned = getattr(handle, "pinned", None)
        if pinned is not None:
            handle.pinned = None
            self.solver.tier.release_footprint(pinned)

    def fetch(self, fetch: _Fetch) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Wait for the copies, then ``(meta, data)`` as host arrays (``data``
        None for a count plan, or a batch item that kept its pages)."""
        arrs = fetch.arrays()
        if self.direct_fetch:
            flat = arrs[0]
            n = self.width * self.ncols
            return flat[n:], flat[:n].reshape(self.width, self.ncols)
        return arrs[0], (arrs[1] if len(arrs) > 1 else None)

    def materialize(self, meta: np.ndarray, data: Optional[np.ndarray], params: Optional[Dict] = None):
        """Marshal rows from a fetched ``(meta, data)``; only the first
        `fetch_rows_needed(count)` rows of ``data`` are read."""
        count, overflow = int(meta[0]), int(meta[1])
        if overflow:
            raise ScheduleOverflow(str(self.solver.stmt))
        if self.count_name is not None:
            return self.solver.finalize_count(self.count_name, count, params)
        if data is None:
            # column-less non-count table (degenerate): count empty rows
            return self.solver.rows_from_table(Table(torch.device("cpu"), count=count), params)
        return self.solver.rows_from_table(
            self._table_from(data, self.fetch_rows_needed(count)), params
        )

    def rows(self, params: Optional[Dict] = None):
        handle = self.dispatch(params)
        try:
            meta, data = self.fetch(handle)
            return self.materialize(meta, data, params)
        finally:
            self.release(handle)

    def fetch_rows_needed(self, count: int) -> int:
        """How many live rows the host needs to marshal the result:
        `count`, or `skip+limit` when a literal LIMIT can cut the transfer
        (no DISTINCT/UNWIND/ORDER/aggregate: those need every row)."""
        lim = self.fetch_limit
        return count if lim is None else min(count, lim)

    @staticmethod
    def _literal_fetch_limit(stmt) -> Optional[int]:
        """skip+limit as a plain int when LIMIT can cut the TRANSFER:
        row-per-binding results only, and literal SKIP/LIMIT."""
        if not isinstance(stmt, A.MatchStatement):
            return None
        if stmt.distinct or stmt.unwind or stmt.order_by or stmt.group_by:
            return None
        if stmt.limit is None:
            return None
        if any(contains_aggregate(p.expr) for p in stmt.returns):
            return None
        if len(stmt.returns) == 1 and isinstance(stmt.returns[0].expr, A.ContextVar):
            return None

        def lit(e):
            if e is None:
                return 0
            if isinstance(e, A.Literal) and isinstance(e.value, int):
                return e.value
            return None

        limit, skip = lit(stmt.limit), lit(stmt.skip)
        if limit is None or skip is None or limit < 0:
            return None
        return skip + limit

    def _table_from(self, data: np.ndarray, count: int) -> Table:
        """Host table from the fetched [W, C] page: rows were front-packed
        (stable) on the device, so the first `count` rows are the live ones
        in expansion order."""
        n = min(count, data.shape[0])
        t = Table(torch.device("cpu"), count=n, width=n)
        for i, a in enumerate(self.v_names):
            t.cols[a] = data[:n, i]
        for i, a in enumerate(self.e_names):
            j = len(self.v_names) + 2 * i
            t.edge_cols[a] = (data[:n, j], data[:n, j + 1])
        for i, a in enumerate(self.d_names, start=len(self.v_names) + 2 * len(self.e_names)):
            t.depth_cols[a] = data[:n, i]
        return t


class _CompiledTraverse(_CompiledPlan):
    """A recorded TRAVERSE as a replayable plan, with `_CompiledPlan`'s
    dispatch / fetch / materialize surface, so that `execute` and
    `execute_batch` take both.

    The replay is as static as the reference's: the roots and every level's
    count are baked, parameter values join the plan key (`_cache_key`), and
    no parameter row is read. Its output is one direct-fetch buffer: the
    emitted vertex ids (``width`` = bucket(total) slots, -1-filled once per
    replay, each level written at its recorded offset by K3) and the meta
    row ``[total, overflow, 0]``. On a card `capture` records the replay as
    one CUDA graph. Every batch item of the plan is the identical replay, so
    a batch's items share one dispatch (``dyn_spec`` is empty); a tiered
    plan is not batchable (each dispatch prefetches and pins its
    footprint)."""

    def __init__(self, solver: TpuTraverseSolver, count: int) -> None:
        super().__init__(solver, count, K.bucket(max(count, 1)), (["id"], [], []))
        #: the ids ship whole whatever their size: there is no page ladder
        self.direct_fetch = True

    def _replay(self) -> Dict:
        solver = self.solver
        dev, W = solver.device, self.width
        buf = torch.full((W + 3,), -1, dtype=I32, device=dev)
        solver.sched.start_replay()
        with solver.dg.sealed():
            total = solver.solve(buf[:W])
        if solver.sched.pos != len(solver.sched.values):
            raise RuntimeError(
                f"replay observed {solver.sched.pos} sizes, the recording {len(solver.sched.values)}"
            )
        overflow = solver.sched.overflow_flag(dev).to(I32)
        buf[W:].copy_(torch.stack([torch.full((), total, dtype=I32, device=dev), overflow, torch.zeros_like(overflow)]))
        return {"direct": buf}

    def check_fresh(self) -> None:
        super().check_fresh()
        _check_traverse_static(self.solver)

    def batchable(self) -> bool:
        return self.solver.tier is None and self.solver.dg.mesh_graph is None

    def materialize(self, meta: np.ndarray, data: Optional[np.ndarray], params: Optional[Dict] = None):
        if int(meta[1]):
            raise ScheduleOverflow(str(self.solver.stmt))
        return self.solver.rows_from(data[: int(meta[0]), 0])


# ---------------------------------------------------------------------------
# plan cache and front door
# ---------------------------------------------------------------------------


def _params_key(params) -> Optional[Tuple]:
    """Plan-cache key fragment: STATIC parameter values plus the
    names/kinds of dynamic (numeric) ones — dynamic values are replay
    inputs, so plans are shared across them."""
    dyn, static = split_params(params)
    try:
        t = (
            tuple(sorted((str(k), kind) for k, kind in dyn.items())),
            tuple(sorted((str(k), type(v).__name__, v) for k, v in static.items())),
        )
        hash(t)
        return t
    except TypeError:
        return None  # unhashable param values → skip plan cache


def _plan_cache(snap) -> "OrderedDict":
    """The snapshot's plan cache (it dies with the snapshot)."""
    cache = getattr(snap, "_plan_cache", None)
    if cache is None:
        cache = snap._plan_cache = OrderedDict()
    return cache


def _all_values_key(params) -> Optional[Tuple]:
    """Every parameter value in the key (a TRAVERSE plan bakes them)."""
    try:
        t = tuple(sorted((str(k), type(v).__name__, v) for k, v in params.items()))
        hash(t)
        return t
    except TypeError:
        return None


def _cache_key(stmt, params) -> Optional[Tuple]:
    """(statement, parameter key, config): the knobs that size a plan's
    buffers are read while it records, so a plan only ever replays under
    the configuration it was recorded with; retuning records anew. MATCH
    and (rewritten) SELECT plans are parameter-generic; TRAVERSE bakes the
    parameter values."""
    if isinstance(stmt, (A.MatchStatement, A.SelectStatement)):
        pk = _params_key(params)
    elif isinstance(stmt, A.TraverseStatement):
        pk = _all_values_key(params)
    else:
        return None
    if pk is None:
        return None
    try:
        key = (stmt, pk, dataclasses.astuple(config))
        hash(key)
        return key
    except TypeError:  # statement holds an unhashable literal
        return None


#: SELECT → MATCH translation verdicts, keyed by statement (the rewrite is
#: parameter-independent), read by every recording: a positive entry skips
#: re-deriving the rewrite when a statement records again (a re-record, the
#: plan cache off or evicted), a negative one (the `Uncompilable` reason)
#: refuses an ineligible shape, which never reaches the plan cache, at once
_TRANSLATE_CACHE: "OrderedDict" = OrderedDict()
_TRANSLATE_CACHE_MAX = 512


def _translate(stmt):
    """``(statement to solve, element alias)``: a SELECT rewritten to a
    single-node MATCH (`select_compile.rewrite_select`); MATCH and TRAVERSE
    pass through."""
    if not isinstance(stmt, A.SelectStatement):
        return stmt, None
    try:
        hashable = True
        verdict = _TRANSLATE_CACHE.get(stmt)
    except TypeError:  # the statement holds an unhashable literal
        hashable, verdict = False, None
    if verdict is not None:
        _TRANSLATE_CACHE.move_to_end(stmt)
        if isinstance(verdict, str):
            raise Uncompilable(verdict)
        return verdict
    from orientdb_tpu_torch.exec.select_compile import rewrite_select

    try:
        out = rewrite_select(stmt)
    except Uncompilable as e:
        if hashable:
            _translate_remember(stmt, str(e))
        raise
    if hashable:
        _translate_remember(stmt, out)
    return out


def _translate_remember(stmt, verdict) -> None:
    while len(_TRANSLATE_CACHE) >= _TRANSLATE_CACHE_MAX:
        _TRANSLATE_CACHE.popitem(last=False)
    _TRANSLATE_CACHE[stmt] = verdict


def _record(db, stmt, params):
    """Recording first execution: eager solve with blocking size observes.
    Returns (plan, rows); the plan is not captured yet."""
    if isinstance(stmt, A.TraverseStatement):
        tsolver = TpuTraverseSolver(db, stmt, params)
        buf = torch.full((tsolver.vb,), -1, dtype=I32, device=tsolver.device)
        total = tsolver.solve(buf)
        return _CompiledTraverse(tsolver, total), tsolver.rows_from(buf[:total])
    match, element_alias = _translate(stmt)
    solver = TpuMatchSolver(db, match, params, element_alias)
    table = solver.solve_table()
    rows = solver.rows_from_table(table)
    return _CompiledPlan.of_table(solver, table), rows


def _prepare(db, stmt, params):
    """Plan-cache lookup, recording (and executing) on a miss.

    Returns ``(variants, None)`` on a cache hit, or ``(None, rows)`` when
    this call WAS the recording first execution (its plan captured and
    cached when the statement is cacheable)."""
    if not isinstance(stmt, (A.MatchStatement, A.SelectStatement, A.TraverseStatement)):
        raise Uncompilable(f"{type(stmt).__name__} has no compiled form")
    params = params or {}
    snap = db.current_snapshot()
    if snap is None:
        raise Uncompilable("no snapshot attached")
    cache = _plan_cache(snap)
    key = _cache_key(stmt, params)
    if key is not None:
        variants = cache.get(key)
        if variants is not None:
            cache.move_to_end(key)  # LRU: keep hot plans
            return variants, None
    plan, rows = _record(db, stmt, params)
    if key is not None and config.plan_cache_size > 0:
        plan.capture()
        while len(cache) >= config.plan_cache_size:
            cache.popitem(last=False)
        v = PlanVariants(plan)
        v.remember(params, plan)
        cache[key] = v
    return None, rows


class PlanVariants:
    """Schedule variants for one cached statement, with a sticky
    per-parameter routing map: parameter populations whose live sizes
    cluster differently each keep a fitting variant, and repeated
    parameter values dispatch straight to the variant that last served
    them."""

    __slots__ = ("plans", "by_param")

    _STICKY_MAX = 4096

    def __init__(self, first) -> None:
        self.plans = [first]
        self.by_param: Dict = {}

    @staticmethod
    def _pkey(params):
        try:
            t = tuple(sorted((str(k), str(v)) for k, v in (params or {}).items()))
            hash(t)
            return t
        except TypeError:
            return None

    def pick(self, params):
        plan = self.by_param.get(self._pkey(params))
        return plan if plan in self.plans else self.plans[0]

    def remember(self, params, plan) -> None:
        k = self._pkey(params)
        if k is None:
            return
        if len(self.by_param) >= self._STICKY_MAX:
            self.by_param.clear()
        self.by_param[k] = plan

    def add(self, plan) -> None:
        self.plans.insert(0, plan)
        del self.plans[max(1, config.plan_variants) :]
        self.by_param = {k: p for k, p in self.by_param.items() if p in self.plans}


def _run_variants(db, stmt, params, variants: PlanVariants, tried=None):
    """Walk the remaining variants after an overflow; when every one
    overflows, record (and capture) a NEW variant under these
    parameters."""
    for plan in list(variants.plans):
        if plan is tried:
            continue
        try:
            rows = plan.rows(params)
        except ScheduleOverflow:
            continue
        variants.remember(params, plan)
        return rows
    plan, rows = _record(db, stmt, params)
    plan.capture()
    variants.add(plan)
    variants.remember(params, plan)
    return rows


def execute(db, stmt, params: Dict):
    """Solve one MATCH, SELECT or TRAVERSE statement on the database's
    device; the rows. The first call of a statement records; later calls
    replay its plan."""
    params = params or {}
    variants, rows = _prepare(db, stmt, params)
    if variants is None:
        return rows
    plan = variants.pick(params)
    try:
        rows = plan.rows(params)
        variants.remember(params, plan)
    except ScheduleOverflow:
        rows = _run_variants(db, stmt, params, variants, tried=plan)
    return rows


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


class _Group:
    """A dispatched group's results: its stacked meta rows (or direct-fetch
    buffers) on their way to pinned host memory, fetched once and sliced
    per lane. A rows group also holds its ``[Bb, W, C]`` lane stack on the
    device (``data_dev``), or for a shared dispatch of a rows plan that
    replay's page ladder (``shared_pages``): after the meta wave the batch
    elects ONE compact page for all its lanes (``data_np``)."""

    __slots__ = ("plan", "fetch", "data_dev", "shared_pages", "data_np", "_np")

    def __init__(self, plan, fetch: _Fetch, data_dev=None, shared_pages=None) -> None:
        self.plan = plan
        self.fetch = fetch
        self.data_dev = data_dev
        self.shared_pages = shared_pages
        self.data_np: Optional[np.ndarray] = None
        self._np: Optional[np.ndarray] = None

    def arr(self) -> np.ndarray:
        if self._np is None:
            self._np = self.fetch.arrays()[0]
        return self._np


class _Lane:
    """One item of a group: row ``k`` of the group's stacked results, or
    ``k=None`` for a shared dispatch (no dynamic parameter: every lane is
    the same replay)."""

    __slots__ = ("grp", "k")

    def __init__(self, grp: _Group, k: Optional[int]) -> None:
        self.grp = grp
        self.k = k

    def fetched(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """``(meta, data)`` as `_CompiledPlan.materialize` takes them."""
        plan = self.grp.plan
        a = self.grp.arr()
        row = a if self.k is None else a[self.k]
        if plan.direct_fetch:
            n = plan.width * plan.ncols
            return row[n:], row[:n].reshape(plan.width, plan.ncols)
        d = self.grp.data_np
        if d is not None and self.k is not None:
            d = d[self.k]
        return row, d


def _group_dispatch(plan: _CompiledPlan, params_list: List[Dict]):
    """Dispatch B same-plan items as one group: ``(group, lane index per
    item)``, or None when the plan's rows group is over its lane cap (the
    items then dispatch one by one). A plan that reads no dynamic
    parameter replays once for all its items."""
    if not plan.dyn_spec:
        fetch = plan.dispatch({}, keep_pages=True)
        return _Group(plan, fetch, shared_pages=fetch.pages), [None] * len(params_list)
    grp = plan.dispatch_many(params_list)
    if grp is None:
        return None
    return grp, list(range(len(params_list)))


def _dispatch_item(plan: _CompiledPlan, params: Dict) -> Optional[_Fetch]:
    """One batch item's replay, keeping its pages; None when the plan went
    stale under the batch (an earlier item's footprint prefetch grew a tier
    pool): the item then re-runs through its variants after the batch."""
    try:
        return plan.dispatch(params, keep_pages=True)
    except ScheduleOverflow:
        return None


def _dispatch_prepared(prepared, pending: List[Tuple]) -> None:
    """Dispatch every prepared item: runs of one plan of at least
    ``_GROUP_MIN`` batchable items as one group, the rest one replay each.
    Appends ``(i, variants, plan, handle)`` rows to ``pending`` as they
    dispatch, ``handle`` a `_Fetch`, a `_Lane`, or None for an item to
    re-run (`_dispatch_item`)."""
    groups: Dict[int, List[int]] = {}
    for j, (_i, _v, plan, _p) in enumerate(prepared):
        if plan.batchable():
            groups.setdefault(id(plan), []).append(j)
    grouped = {j for idxs in groups.values() if len(idxs) >= _GROUP_MIN for j in idxs}
    for j, (i, variants, plan, params) in enumerate(prepared):
        if j not in grouped:
            pending.append((i, variants, plan, _dispatch_item(plan, params)))
    for idxs in groups.values():
        if len(idxs) < _GROUP_MIN:
            continue
        plan = prepared[idxs[0]][2]
        g = _group_dispatch(plan, [prepared[j][3] for j in idxs])
        if g is None:
            for j in idxs:
                i, variants, _p, params = prepared[j]
                pending.append((i, variants, plan, _dispatch_item(plan, params)))
            continue
        grp, ks = g
        for k, j in zip(ks, idxs):
            i, variants, _p, _params = prepared[j]
            pending.append((i, variants, plan, _Lane(grp, k)))


def _elect_pages(pending):
    """The meta wave and the page elections: each item's meta row as its
    copy lands; a single rows item's page, the smallest of its ladder that
    covers its live rows (int16 when they fit); and a rows group's ONE
    compact page over all its lanes, `K.group_page` of the lane stack (or
    the shared replay's ladder page). The elected pages' copies are queued
    on the replay stream. Returns ``(fetched, page fetch per item, [(group,
    page fetch)])``, ``fetched`` each item's ``(meta, data)`` so far."""
    fetched: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
    pages: List[Optional[_Fetch]] = [None] * len(pending)
    lanes: Dict[int, Tuple[_Group, List[np.ndarray]]] = {}
    for j, (_i, _v, plan, h) in enumerate(pending):
        if h is None:
            fetched.append((None, None))
            continue
        if isinstance(h, _Lane):
            meta, data = h.fetched()
            fetched.append((meta, data))
            if h.grp.data_dev is not None or h.grp.shared_pages is not None:
                lanes.setdefault(id(h.grp), (h.grp, []))[1].append(meta)
            continue
        meta, data = plan.fetch(h)
        fetched.append((meta, data))
        if h.pages is None or int(meta[1]):
            continue  # count plan, direct buffer, or overflow
        ladder = h.pages[1] if int(meta[2]) else h.pages[0]
        need = plan.fetch_rows_needed(int(meta[0]))
        pages[j] = _to_host([next(p for p in ladder if p.shape[0] >= need)])
    grp_pages = []
    for grp, metas in lanes.values():
        plan = grp.plan
        live = [m for m in metas if not int(m[1])]  # overflow lanes re-run later
        if not live:
            continue
        need = max(max(plan.fetch_rows_needed(int(m[0])) for m in live), 1)
        fits16 = all(int(m[2]) for m in live)
        if grp.shared_pages is not None:
            ladder = grp.shared_pages[1 if fits16 else 0]
            page = next(p for p in ladder if p.shape[0] >= need)
        else:
            n = plan._page_round(int(grp.data_dev.shape[1]), need)
            page = K.group_page(grp.data_dev, len(metas), n, fits16)
        grp_pages.append((grp, _to_host([page])))
    return fetched, pages, grp_pages


def _finish_pending(db, items, pending, fetched, pages, grp_pages, out) -> None:
    """Wait for the elected pages and marshal every dispatched item into
    ``out``. Items whose replay overflowed re-run through their variants
    (recording a new one when none fits); identical ``(statement,
    params)`` items share one resolution."""
    for grp, f in grp_pages:
        grp.data_np = f.arrays()[0].astype(np.int32, copy=False)
    overflowed = []
    for j, ((i, variants, plan, h), (meta, data)) in enumerate(zip(pending, fetched)):
        if h is None:
            overflowed.append((i, variants, plan))
            continue
        if isinstance(h, _Lane):
            meta, data = h.fetched()  # the group's elected page has landed now
        elif pages[j] is not None:
            data = pages[j].arrays()[0].astype(np.int32, copy=False)
        params = items[i][1]
        try:
            out[i] = plan.materialize(meta, data, params)
            variants.remember(params, plan)
        except ScheduleOverflow:
            overflowed.append((i, variants, plan))
        finally:
            plan.release(h)  # before any re-run faults blocks in
    resolved: Dict[Tuple, object] = {}
    for i, variants, plan in overflowed:
        stmt, params = items[i]
        pk = PlanVariants._pkey(params)
        rk = (id(variants), pk) if pk is not None else None
        if rk is not None and rk in resolved:
            out[i] = resolved[rk]
            continue
        out[i] = _run_variants(db, stmt, params, variants, tried=plan)
        if rk is not None:
            resolved[rk] = out[i]


def execute_batch(db, items: List[Tuple[A.Statement, Dict]]) -> List:
    """Solve ``[(stmt, params), ...]``; the rows of each, in item order.

    Every item resolves its plan first (a statement's first call records
    and returns its rows directly). Then, holding the replay lock, every
    cached plan dispatches back to back: runs of at least ``_GROUP_MIN``
    items of one batchable plan as one group replay (`_group_dispatch`),
    the others one replay each; the meta wave reads every meta row and the
    page elections queue one page copy per rows item or rows group. The
    host then marshals the rows, and overflowed items re-run."""
    out: List = [None] * len(items)
    prepared = []
    for i, (stmt, params) in enumerate(items):
        variants, rows = _prepare(db, stmt, params)
        if variants is None:
            out[i] = rows
            continue
        plan = variants.pick(params)
        try:
            plan.check_fresh()
        except ScheduleOverflow:
            out[i] = _run_variants(db, stmt, params, variants, tried=plan)
            continue
        prepared.append((i, variants, plan, params))
    if not prepared:
        return out
    pending = []
    try:
        with REPLAY_LOCK:
            # the lock spans the elections: a group's lane stack and the
            # kept ladders stay untouched until their pages are queued
            _dispatch_prepared(prepared, pending)
            with on_replay_stream(db.device):
                fetched, pages, grp_pages = _elect_pages(pending)
        _finish_pending(db, items, pending, fetched, pages, grp_pages, out)
    finally:
        for _i, _v, plan, h in pending:
            plan.release(h)  # tier pins of items that never materialised
    return out
