"""Port of `orientdb_tpu/exec/select_compile.py`: the SELECT → single-node
MATCH rewrite, the compiled form of SELECT.

A class-target SELECT is a single-node MATCH:

    SELECT <proj> FROM C WHERE <pred> [GROUP/ORDER/SKIP/LIMIT]
      ≡ MATCH {class:C, as:s, where:(<pred>)} RETURN <proj'>

so the statement is translated and runs on the compiled MATCH path. Field
references in projections, ORDER BY and GROUP BY become ``s.field``
accesses; the WHERE moves into the node filter verbatim. `expr_name` is
shared between SELECT and MATCH, so unaliased projection names are the
reference's.

Projection-less ``SELECT FROM C`` returns element rows: the rewrite flags
``element_alias`` so that the solver unwraps the binding into a record row
after ORDER / SKIP / LIMIT ran.

Ineligible statements raise `Uncompilable` with the reason; the MATCH path
then refuses what it does not compile (aggregates other than a lone
``count(*)``, GROUP BY) with its own reason.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from orientdb_tpu_torch.exec.oracle import expr_name
from orientdb_tpu_torch.ops.predicates import Uncompilable
from orientdb_tpu_torch.sql import ast as A

#: the binding alias the rewritten root node carries; double-underscore
#: keeps it clear of user aliases, and it is NOT a `$` context var
ALIAS = "__sel__"

#: top-level functions that implicitly operate on the current record
#: (graph accessors) — their meaning does not survive the rewrite
_GRAPH_FUNCS = frozenset(
    ["out", "in", "both", "oute", "ine", "bothe", "outv", "inv", "expand"]
)


def _rewrite_expr(e: A.Expression) -> A.Expression:
    """Record-relative references become accesses on the bound alias."""
    if isinstance(e, A.Identifier):
        return A.FieldAccess(A.Identifier(ALIAS), e.name)
    if isinstance(e, A.ContextVar):
        raise Uncompilable(f"context var ${e.name} in SELECT")
    if isinstance(e, A.FunctionCall) and e.name.lower() in _GRAPH_FUNCS:
        raise Uncompilable(f"graph function {e.name}() in SELECT")
    if dataclasses.is_dataclass(e) and not isinstance(e, type):
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, A.Expression):
                nv = _rewrite_expr(v)
                if nv is not v:
                    changes[f.name] = nv
            elif isinstance(v, tuple):
                # recurse through NESTED tuples too — map literals hold
                # (key, Expression) pairs a flat scan would miss
                nv = _rewrite_tuple(v)
                if nv != v:
                    changes[f.name] = nv
        if changes:
            return dataclasses.replace(e, **changes)
    return e


def _rewrite_tuple(v: tuple) -> tuple:
    return tuple(
        _rewrite_expr(x)
        if isinstance(x, A.Expression)
        else _rewrite_tuple(x)
        if isinstance(x, tuple)
        else x
        for x in v
    )


def rewrite_select(
    stmt: A.SelectStatement,
) -> Tuple[A.MatchStatement, Optional[str]]:
    """Translate an eligible class-target SELECT; returns the MATCH
    statement and the element alias (set when the SELECT returns whole
    records). Raises Uncompilable for shapes the MATCH engine cannot
    honor with oracle parity."""
    if not isinstance(stmt.target, A.ClassTarget) or not stmt.target.polymorphic:
        raise Uncompilable("SELECT target is not a polymorphic class scan")
    if stmt.lets:
        raise Uncompilable("SELECT LET is not compiled")
    if stmt.unwind:
        raise Uncompilable("SELECT UNWIND is not compiled")

    element_alias: Optional[str] = None
    if not stmt.projections and stmt.group_by:
        # oracle semantics: grouping without projections yields empty
        # rows, not representative records — no MATCH equivalent
        raise Uncompilable("GROUP BY on whole-record SELECT")
    if stmt.projections:
        returns = tuple(
            A.Projection(
                _rewrite_expr(p.expr),
                # pin the oracle's SELECT column name so unaliased
                # projections keep identical keys after the rewrite
                p.alias or expr_name(p.expr, i),
            )
            for i, p in enumerate(stmt.projections)
        )
        if any(isinstance(p.expr, A.Star) for p in stmt.projections):
            raise Uncompilable("SELECT * projection is not compiled")
    else:
        # whole-record SELECT: bind the node and unwrap to element rows
        # after the finalize tail
        if stmt.distinct:
            raise Uncompilable("DISTINCT on whole-record SELECT")
        element_alias = ALIAS
        returns = (A.Projection(A.Identifier(ALIAS), ALIAS),)

    node = A.MatchFilter(
        alias=ALIAS, class_name=stmt.target.name, where=stmt.where
    )
    match = A.MatchStatement(
        paths=(A.MatchPath(first=node, items=()),),
        returns=returns,
        distinct=stmt.distinct,
        group_by=tuple(_rewrite_expr(g) for g in stmt.group_by),
        order_by=tuple(
            dataclasses.replace(
                o, expr=_rewrite_order_expr(o.expr, stmt, element_alias)
            )
            for o in stmt.order_by
        ),
        skip=stmt.skip,
        limit=stmt.limit,
    )
    return match, element_alias


def _rewrite_order_expr(
    e: A.Expression, stmt: A.SelectStatement, element_alias: Optional[str]
):
    """ORDER BY resolution differs by mode. In element mode every field
    rides on the bound record, so expressions rewrite to alias accesses
    like any other. In projection mode the MATCH finalize tail sees only
    the projected row (no record fallback, unlike oracle SELECT's
    ordering), so the expression is kept VERBATIM and every identifier in
    it must name a projected column — anything else is Uncompilable, not
    silently None-sorted."""
    if element_alias is not None:
        return _rewrite_expr(e)
    projected = {p.alias for p in stmt.projections if p.alias} | {
        expr_name(p.expr, i)
        for i, p in enumerate(stmt.projections)
        if p.alias is None
    }
    _check_order_resolvable(e, projected)
    return e


def _check_order_resolvable(e: A.Expression, projected) -> None:
    if isinstance(e, A.Identifier):
        if e.name not in projected:
            raise Uncompilable(f"ORDER BY non-projected field {e.name}")
        return
    if isinstance(e, A.ContextVar):
        raise Uncompilable(f"context var ${e.name} in ORDER BY")
    if isinstance(e, A.FunctionCall) and e.name.lower() in _GRAPH_FUNCS:
        raise Uncompilable(f"graph function {e.name}() in ORDER BY")
    if dataclasses.is_dataclass(e) and not isinstance(e, type):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, A.Expression):
                _check_order_resolvable(v, projected)
            elif isinstance(v, tuple):
                _check_order_tuple(v, projected)


def _check_order_tuple(v: tuple, projected) -> None:
    for x in v:
        if isinstance(x, A.Expression):
            _check_order_resolvable(x, projected)
        elif isinstance(x, tuple):
            _check_order_tuple(x, projected)
