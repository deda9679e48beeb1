"""Port of `orientdb_tpu/exec/eval.py`, the host parts the compiled MATCH
path reaches: `EvalContext`, `like_match`, `contains_aggregate`, and an
`evaluate` over projection rows for the ORDER BY / SKIP / LIMIT tail.

Rows here are projections (`Result` of plain values): there are no host
records, so graph navigation, record attributes and SQL functions and
methods are not evaluated (they raise `EvalError`). Null semantics follow
the reference: any comparison with null is false, arithmetic with null is
null, AND/OR collapse null to false.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from orientdb_tpu_torch.sql import ast as A


class EvalError(Exception):
    pass


class EvalContext:
    """Evaluation scope: current row, query params, $variables."""

    __slots__ = ("db", "current", "params", "variables", "parent")

    def __init__(self, db, current=None, params=None, variables=None, parent=None):
        self.db = db
        self.current = current
        self.params = params or {}
        self.variables: Dict[str, object] = variables or {}
        self.parent: Optional[EvalContext] = parent

    def lookup_var(self, name: str):
        ctx: Optional[EvalContext] = self
        while ctx is not None:
            if name in ctx.variables:
                return ctx.variables[name]
            ctx = ctx.parent
        return None

    def has_var(self, name: str) -> bool:
        ctx: Optional[EvalContext] = self
        while ctx is not None:
            if name in ctx.variables:
                return True
            ctx = ctx.parent
        return False


AGGREGATE_FUNCTIONS = {"count", "sum", "min", "max", "avg"}


def get_prop(obj, name: str):
    """Property access on a projection row or a plain mapping."""
    from orientdb_tpu_torch.exec.result import Result

    if isinstance(obj, Result):
        return obj.get_property(name)
    if isinstance(obj, dict):
        return obj.get(name)
    return None


def as_list(v) -> List[object]:
    if v is None:
        return []
    if isinstance(v, (list, tuple, set)):
        return list(v)
    return [v]


def _numeric(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def compare(a, b) -> Optional[int]:
    """3-way compare; None if incomparable (null or type mismatch)."""
    if a is None or b is None:
        return None
    if isinstance(a, bool) or isinstance(b, bool):
        if isinstance(a, bool) and isinstance(b, bool):
            return (a > b) - (a < b)
        return None
    if _numeric(a) and _numeric(b):
        return (a > b) - (a < b)
    if isinstance(a, str) and isinstance(b, str):
        return (a > b) - (a < b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        for x, y in zip(a, b):
            c = compare(x, y)
            if c is None:
                return None
            if c != 0:
                return c
        return (len(a) > len(b)) - (len(a) < len(b))
    return None


def values_equal(a, b) -> bool:
    if a is None or b is None:
        return False
    c = compare(a, b)
    if c is not None:
        return c == 0
    return a == b


def like_match(value, pattern) -> bool:
    if not isinstance(value, str) or not isinstance(pattern, str):
        return False
    rx = re.escape(pattern).replace("%", ".*").replace("_", ".")
    return re.fullmatch(rx, value, flags=re.DOTALL) is not None


def truthy(v) -> bool:
    if v is None:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, (list, tuple, set)):
        return len(v) > 0
    return bool(v)


def evaluate(ctx: EvalContext, expr: A.Expression):
    if isinstance(expr, A.Literal):
        return expr.value
    if isinstance(expr, A.Parameter):
        if expr.name is not None:
            if expr.name not in ctx.params:
                raise EvalError(f"missing parameter :{expr.name}")
            return ctx.params[expr.name]
        try:
            return ctx.params[expr.index]
        except (KeyError, IndexError):
            raise EvalError(f"missing positional parameter ?{expr.index}")
    if isinstance(expr, A.Identifier):
        if ctx.has_var(expr.name):
            return ctx.lookup_var(expr.name)
        return get_prop(ctx.current, expr.name)
    if isinstance(expr, A.ListExpr):
        return [evaluate(ctx, e) for e in expr.items]
    if isinstance(expr, A.FieldAccess):
        return get_prop(evaluate(ctx, expr.base), expr.name)
    if isinstance(expr, A.Unary):
        v = evaluate(ctx, expr.expr)
        if expr.op == "NOT":
            return not truthy(v)
        if v is None:
            return None
        return -v if expr.op == "-" else +v
    if isinstance(expr, A.Between):
        v = evaluate(ctx, expr.expr)
        c1 = compare(v, evaluate(ctx, expr.low))
        c2 = compare(v, evaluate(ctx, expr.high))
        return c1 is not None and c2 is not None and c1 >= 0 and c2 <= 0
    if isinstance(expr, A.IsNull):
        v = evaluate(ctx, expr.expr)
        return (v is not None) if expr.negated else (v is None)
    if isinstance(expr, A.Binary):
        return eval_binary(ctx, expr)
    raise EvalError(f"cannot evaluate {type(expr).__name__} over projection rows")


def eval_binary(ctx: EvalContext, expr: A.Binary):
    op = expr.op
    if op == "AND":
        return truthy(evaluate(ctx, expr.left)) and truthy(evaluate(ctx, expr.right))
    if op == "OR":
        return truthy(evaluate(ctx, expr.left)) or truthy(evaluate(ctx, expr.right))
    left = evaluate(ctx, expr.left)
    right = evaluate(ctx, expr.right)
    if op == "=":
        return values_equal(left, right)
    if op == "!=":
        if left is None or right is None:
            return False
        return not values_equal(left, right)
    if op in ("<", "<=", ">", ">="):
        c = compare(left, right)
        if c is None:
            return False
        return {"<": c < 0, "<=": c <= 0, ">": c > 0, ">=": c >= 0}[op]
    if op == "LIKE":
        return like_match(left, right)
    if op == "IN":
        return any(values_equal(left, it) for it in as_list(right))
    if op in ("+", "-", "*", "/", "%", "||"):
        if op == "||" or (op == "+" and (isinstance(left, str) or isinstance(right, str))):
            if left is None or right is None:
                return None
            return str(left) + str(right)
        if left is None or right is None:
            return None
        if not (_numeric(left) and _numeric(right)):
            raise EvalError(f"non-numeric operands for {op}: {left!r}, {right!r}")
        if op == "+":
            return left + right
        if op == "-":
            return left - right
        if op == "*":
            return left * right
        if op == "/":
            if right == 0:
                return None
            if isinstance(left, int) and isinstance(right, int):
                return left // right if left % right == 0 else left / right
            return left / right
        return left % right if right != 0 else None
    raise EvalError(f"operator {op} not evaluated over projection rows")


def contains_aggregate(expr: A.Expression) -> bool:
    if isinstance(expr, A.FunctionCall):
        if expr.name in AGGREGATE_FUNCTIONS:
            return True
        return any(contains_aggregate(a) for a in expr.args)
    if isinstance(expr, A.Binary):
        return contains_aggregate(expr.left) or contains_aggregate(expr.right)
    if isinstance(expr, A.Unary):
        return contains_aggregate(expr.expr)
    if isinstance(expr, (A.FieldAccess,)):
        return contains_aggregate(expr.base)
    if isinstance(expr, A.MethodCall):
        return contains_aggregate(expr.base) or any(
            contains_aggregate(a) for a in expr.args
        )
    if isinstance(expr, A.IndexAccess):
        return contains_aggregate(expr.base) or contains_aggregate(expr.index)
    return False
