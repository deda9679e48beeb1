"""Port of `orientdb_tpu/exec/oracle.py`, the host planning and finalising
parts the compiled MATCH path uses: the pattern build (`Pattern`,
`PatternNode`, `PatternEdge`), the planner's estimates and admission rules
(`MatchInterpreter`), the DISTINCT / ORDER BY / SKIP / LIMIT tail over
projection rows (`finalize_match_rows`), and FROM-target resolution to
vertex ids (`resolve_target_ids`, TRAVERSE's roots).

The reference's record-walking interpreter is not ported: the port has no
host records to walk.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from orientdb_tpu_torch.exec.eval import EvalContext, evaluate
from orientdb_tpu_torch.exec.result import RecordRows, Result
from orientdb_tpu_torch.models.record import VertexRecord
from orientdb_tpu_torch.models.rid import RID
from orientdb_tpu_torch.ops.predicates import Uncompilable
from orientdb_tpu_torch.sql import ast as A


def expr_name(expr: A.Expression, index: int) -> str:
    """Deterministic column name for an unaliased projection."""
    if isinstance(expr, A.Identifier):
        return expr.name
    if isinstance(expr, A.FieldAccess):
        return expr.name
    if isinstance(expr, A.FunctionCall):
        return f"{expr.name}"
    if isinstance(expr, A.MethodCall):
        return expr.name
    if isinstance(expr, A.ContextVar):
        return f"${expr.name}"
    return f"_col{index}"


def _match_proj_name(expr: A.Expression, i: int) -> str:
    if isinstance(expr, A.Identifier):
        return expr.name
    if isinstance(expr, A.FieldAccess) and isinstance(expr.base, A.Identifier):
        return f"{expr.base.name}.{expr.name}"
    return expr_name(expr, i)


def _row_ctx(db, row, params, parent_ctx) -> EvalContext:
    return EvalContext(db, current=row, params=params, parent=parent_ctx)


def _skip_limit(rows: List, skip_expr, limit_expr, ctx) -> List:
    skip = int(evaluate(ctx, skip_expr)) if skip_expr is not None else 0
    limit = int(evaluate(ctx, limit_expr)) if limit_expr is not None else None
    if skip:
        rows = rows[skip:]
    if limit is not None and limit >= 0:
        rows = rows[:limit]
    return rows


def _sort_key_fn(vals: List):
    """Total order over heterogeneous projection values: None sorts first,
    then by (type-rank, value)."""

    def rank(v):
        if v is None:
            return (0, 0)
        if isinstance(v, bool):
            return (1, v)
        if isinstance(v, (int, float)):
            return (2, v)
        if isinstance(v, str):
            return (3, v)
        if isinstance(v, (RID, VertexRecord)):
            rid = v.rid if isinstance(v, VertexRecord) else v
            return (4, (rid.cluster, rid.position))
        return (5, repr(v))

    return tuple(rank(v) for v in vals)


def _order_rows(rows: List[Result], order_by, db, params, parent_ctx) -> List[Result]:
    """Sort rows by ORDER BY keys evaluated over each projection row."""
    if not order_by:
        return rows
    keyed = []
    for r in rows:
        ctx = _row_ctx(db, r, params, parent_ctx)
        keyed.append(([evaluate(ctx, item.expr) for item in order_by], r))
    # stable multi-key sort: apply keys right-to-left
    for i in range(len(order_by) - 1, -1, -1):
        keyed.sort(
            key=lambda kv: _sort_key_fn([kv[0][i]]),
            reverse=not order_by[i].ascending,
        )
    return [r for _, r in keyed]


def _canonical(v) -> object:
    """Hashable canonical form for DISTINCT keys."""
    if isinstance(v, VertexRecord):
        return ("rec", str(v.rid))
    if isinstance(v, RID):
        return ("rid", str(v))
    if isinstance(v, Result):
        return (
            "row",
            tuple(sorted((k, _canonical(v.get_property(k))) for k in v.property_names())),
        )
    if isinstance(v, (list, tuple)):
        return ("list", tuple(_canonical(x) for x in v))
    return v


def finalize_match_rows(
    db, stmt: A.MatchStatement, out: List[Result], params, parent_ctx
) -> List[Result]:
    """DISTINCT / ORDER BY / SKIP / LIMIT tail over projection rows."""
    if stmt.distinct:
        seen = set()
        deduped = []
        for r in out:
            key = _canonical(r)
            if key not in seen:
                seen.add(key)
                deduped.append(r)
        out = deduped
    out = _order_rows(out, stmt.order_by, db, params, parent_ctx)
    base_ctx = EvalContext(db, params=params, parent=parent_ctx)
    return _skip_limit(out, stmt.skip, stmt.limit, base_ctx)


# ---------------------------------------------------------------------------
# FROM targets
# ---------------------------------------------------------------------------


def resolve_target_ids(db, target: Optional[A.Target], params) -> np.ndarray:
    """A FROM target's vertex ids without records, in the order the
    reference's `resolve_target_rows` yields their records (TRAVERSE's
    roots): a class target every live member of its closure in index
    order; ``#c:p`` / ``[#c:p, ...]`` each RID through the snapshot's
    lookup, a missing one skipped (the reference's ``db.load`` gives None)
    and an edge's refused; a subquery the vertex ids of its record rows,
    taken straight from its compiled run (projection rows are no records:
    skipped). Any other target raises `Uncompilable`."""
    snap = db.current_snapshot()
    if isinstance(target, A.ClassTarget):
        cls = db.schema.get_class(target.name)
        if cls is None:
            raise Uncompilable(f"class '{target.name}' not found")
        if cls.is_edge_type:
            raise Uncompilable("TRAVERSE root is not a snapshot vertex")
        if target.polymorphic:
            ids = snap.vertex_class_ids(cls.name)
        else:
            ids = [snap.class_id_of.get(cls.name.lower(), -1)]
        return np.flatnonzero(np.isin(snap.v_class, ids)).astype(np.int32)
    if isinstance(target, A.RidTarget):
        out = []
        for r in target.rids:
            i = snap.idx_of(RID(r.cluster, r.position))
            if i is not None:
                out.append(i)
                continue
            owner = next((c for c in db.schema.classes() if r.cluster in c.cluster_ids), None)
            if owner is not None and owner.is_edge_type:
                raise Uncompilable("TRAVERSE root is not a snapshot vertex")
        return np.asarray(out, np.int32)
    if isinstance(target, A.SubQueryTarget):
        from orientdb_tpu_torch.exec import tpu_engine

        rows = tpu_engine.execute(db, target.query, params)
        if isinstance(rows, RecordRows):
            return rows.ids.astype(np.int32)
        return np.asarray([r.element.idx for r in rows if r.is_element], np.int32)
    raise Uncompilable(f"TRAVERSE target {type(target).__name__} is not compiled")


# ---------------------------------------------------------------------------
# MATCH pattern
# ---------------------------------------------------------------------------


class PatternNode:
    """[E] PatternNode: one alias with its merged constraints."""

    __slots__ = ("alias", "filters", "anonymous", "optional", "is_edge_alias")

    def __init__(self, alias: str, anonymous: bool) -> None:
        self.alias = alias
        self.anonymous = anonymous
        self.filters: List[A.MatchFilter] = []
        self.optional = False
        self.is_edge_alias = False


class PatternEdge:
    """[E] PatternEdge: one path item connecting two aliases."""

    __slots__ = ("from_alias", "to_alias", "item", "negated_arm")

    def __init__(self, from_alias: str, to_alias: str, item: A.MatchPathItem, negated: bool):
        self.from_alias = from_alias
        self.to_alias = to_alias
        self.item = item
        self.negated_arm = negated


class Pattern:
    """[E] Pattern: nodes + edges, built from the MATCH AST."""

    def __init__(self) -> None:
        self.nodes: Dict[str, PatternNode] = {}
        self.edges: List[PatternEdge] = []
        self._anon = itertools.count()

    def node(self, flt: Optional[A.MatchFilter]) -> PatternNode:
        alias = flt.alias if flt is not None and flt.alias else None
        anonymous = alias is None
        if alias is None:
            alias = f"$anon{next(self._anon)}"
        n = self.nodes.get(alias)
        if n is None:
            n = self.nodes[alias] = PatternNode(alias, anonymous)
        if flt is not None:
            n.filters.append(flt)
            if flt.optional:
                n.optional = True
        return n


def build_pattern(stmt: A.MatchStatement) -> Tuple[Pattern, List[A.MatchPath]]:
    pattern = Pattern()
    not_paths: List[A.MatchPath] = []
    for path in stmt.paths:
        if path.negated:
            not_paths.append(path)
            continue
        prev = pattern.node(path.first)
        for item in path.items:
            tgt = pattern.node(item.target)
            if item.method and item.method.lower() in ("oute", "ine", "bothe") and (
                item.edge_filter is None
            ):
                # bare .outE(){as:e}: target alias binds the EDGE
                tgt.is_edge_alias = True
            pattern.edges.append(PatternEdge(prev.alias, tgt.alias, item, False))
            if item.edge_filter is not None and item.edge_filter.alias:
                en = pattern.node(A.MatchFilter(alias=item.edge_filter.alias))
                en.is_edge_alias = True
            prev = tgt
    return pattern, not_paths


_REVERSE_DIR = {"out": "in", "in": "out", "both": "both"}


def _expr_uses_bindings(expr, pattern_nodes: Dict[str, "PatternNode"]) -> bool:
    """True if a where-expression references other aliases ($matched,
    $currentMatch, or an alias name used as an identifier)."""
    if isinstance(expr, A.ContextVar):
        return expr.name in ("matched", "currentMatch")
    if isinstance(expr, A.Identifier):
        return expr.name in pattern_nodes
    if isinstance(expr, A.Binary):
        return _expr_uses_bindings(expr.left, pattern_nodes) or _expr_uses_bindings(
            expr.right, pattern_nodes
        )
    if isinstance(expr, A.Unary):
        return _expr_uses_bindings(expr.expr, pattern_nodes)
    if isinstance(expr, A.Between):
        return any(
            _expr_uses_bindings(e, pattern_nodes)
            for e in (expr.expr, expr.low, expr.high)
        )
    if isinstance(expr, (A.IsNull, A.IsDefined)):
        return _expr_uses_bindings(expr.expr, pattern_nodes)
    if isinstance(expr, A.FieldAccess):
        return _expr_uses_bindings(expr.base, pattern_nodes)
    if isinstance(expr, A.IndexAccess):
        return _expr_uses_bindings(expr.base, pattern_nodes) or _expr_uses_bindings(
            expr.index, pattern_nodes
        )
    if isinstance(expr, A.MethodCall):
        return _expr_uses_bindings(expr.base, pattern_nodes) or any(
            _expr_uses_bindings(a, pattern_nodes) for a in expr.args
        )
    if isinstance(expr, A.FunctionCall):
        return any(_expr_uses_bindings(a, pattern_nodes) for a in expr.args)
    if isinstance(expr, A.ListExpr):
        return any(_expr_uses_bindings(a, pattern_nodes) for a in expr.items)
    return False


class MatchInterpreter:
    """The planning half of the reference's [E] MatchEdgeTraverser analog:
    the pattern, candidate-size estimates and the admission rules that the
    compiled plan replays."""

    def __init__(self, db, stmt: A.MatchStatement, params) -> None:
        self.db = db
        self.stmt = stmt
        self.params = params
        self.pattern, self.not_paths = build_pattern(stmt)

    def estimate(self, node: PatternNode) -> int:
        """Candidate-set size estimate for the greedy root choice: class
        count scaled by a WHERE-selectivity prior."""
        for f in node.filters:
            if f.rid is not None:
                return 1
        base = None
        cname = None
        for f in node.filters:
            if f.class_name:
                cls = self.db.schema.get_class(f.class_name)
                if cls is not None:
                    base = self.db.count_class(cls.name)
                    cname = cls.name
                    break
        if base is None:
            base = self.db.count_class("E" if node.is_edge_alias else "V") + 10**6
        sel = 1.0
        for f in node.filters:
            if f.where is not None:
                sel = min(sel, self._where_selectivity(cname, f.where))
        return max(1, int(base * sel))

    def _where_selectivity(self, cname: Optional[str], w) -> float:
        # the reference prices an equality on a unique-indexed field as a
        # point lookup; the port has no indexes, so that case never arises
        if isinstance(w, A.Binary):
            if w.op == "AND":
                return max(
                    1e-6,
                    self._where_selectivity(cname, w.left)
                    * self._where_selectivity(cname, w.right),
                )
            if w.op == "OR":
                return min(
                    1.0,
                    self._where_selectivity(cname, w.left)
                    + self._where_selectivity(cname, w.right),
                )
            if w.op == "=":
                fld = isinstance(w.left, A.Identifier) or isinstance(
                    w.right, A.Identifier
                )
                return 0.01 if fld else 1.0
            if w.op in ("<", "<=", ">", ">="):
                return 0.3
            if w.op == "IN":
                return 0.05
        if isinstance(w, A.Between):
            return 0.2
        return 1.0

    def enumerable_isolated(
        self, required: List[PatternEdge], optionals: List[PatternEdge]
    ) -> List[PatternNode]:
        """Nodes needing up-front candidate enumeration: not touched by any
        REQUIRED edge, excluding optional nodes, filterless nodes, aliases
        bound inside an arm's edge braces, and targets of optional arms —
        the reference's shared admission rule."""
        arm_bound = {
            e.item.edge_filter.alias
            for e in self.pattern.edges
            if e.item.edge_filter is not None and e.item.edge_filter.alias
        }
        opt_targets = {e.to_alias for e in optionals}
        return [
            n
            for n in self.pattern.nodes.values()
            if not any(
                e.from_alias == n.alias or e.to_alias == n.alias for e in required
            )
            and not n.optional
            and n.filters
            and n.alias not in arm_bound
            and n.alias not in opt_targets
        ]

    def _edge_is_optional(self, e: PatternEdge) -> bool:
        return self.pattern.nodes[e.to_alias].optional or self._arm_optional(e)

    @staticmethod
    def _arm_optional(e: PatternEdge) -> bool:
        f = e.item.edge_filter
        return f is not None and f.optional
