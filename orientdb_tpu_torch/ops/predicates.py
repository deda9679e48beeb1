"""Port of `orientdb_tpu/ops/predicates.py`: the columnar predicate compiler,
WHERE AST → a function from vertex ids to a torch boolean mask.

The same AST compiles once per query into closures over the device
property columns; applied to a frontier, a closure gathers each referenced
column through the `take_pad` kernel and combines the values with torch
elementwise operations. Semantics follow the reference (and through it
`exec/eval.py`) on the columnar subset:
  - any comparison with null is false (only IS NULL sees nulls);
  - `!=` additionally needs both sides non-null;
  - AND/OR collapse null to false; NOT(null) is true;
  - type-mismatched `=` is false, `<` family is false, while `!=` of two
    non-null incomparable values is true.

String columns are dictionary-coded with a sorted dictionary, so ordered
compares against a literal become int32 compares against the literal's
bisect rank, and LIKE / MATCHES / CONTAINSTEXT are evaluated on the host
over the dictionary into a code-membership table. A WHILE condition
compiles with ``allow_depth``: ``$depth`` is then an int32 scalar read from
``env["depth"]``, the level being expanded. A scope may be an edge class's
property columns (an edge WHERE over edge ids) as well as the vertex
columns; with ``binding_columns`` it also admits ``alias.prop`` references
to earlier bound aliases, read per slot through ``env["bindings"]``. The
haversine ``distance()`` is not ported. Anything outside the subset raises
`Uncompilable`.
"""

from __future__ import annotations

import bisect
import re
from typing import Callable, Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from orientdb_tpu_torch.exec.eval import like_match
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.ops.device_graph import DeviceColumn
from orientdb_tpu_torch.sql import ast as A

I32 = torch.int32
F32 = torch.float32


class Uncompilable(Exception):
    """Statement or expression outside the compiled subset."""


def split_params(params: Dict) -> Tuple[Dict[object, str], Dict[object, object]]:
    """Partition query parameters into numeric ones (read per run from the
    box, kind-tagged) and the rest (baked into the compiled predicates).
    Integers outside int32 stay static and meet `_const_val`'s range gate."""
    dyn: Dict[object, str] = {}
    static: Dict[object, object] = {}
    for k, v in params.items():
        if isinstance(v, bool):
            dyn[k] = "bool"
        elif isinstance(v, int) and -(2**31) < v < 2**31:
            dyn[k] = "int"
        elif isinstance(v, float):
            dyn[k] = "float"
        else:
            static[k] = v
    return dyn, static


class ParamBox:
    """Parameter environment shared by a solver's compiled predicates:
    numeric parameters are read from ``current`` when a mask is evaluated,
    so one compiled set of closures serves any numeric value.

    A recording run reads the concrete values; a replay swaps in 0-d
    tensors (`set_current`) that the replay's dispatch fills on the device,
    so no parameter value is baked into a captured graph."""

    def __init__(self, params: Dict) -> None:
        self.initial = dict(params)
        self.current = dict(params)
        self.dynamic, self.static = split_params(params)
        #: dynamic keys actually referenced by some compiled predicate
        self.used: Dict[object, str] = {}

    def __contains__(self, k) -> bool:
        return k in self.initial

    def set_current(self, values: Dict) -> None:
        self.current = {**self.initial, **values}

    def reset(self) -> None:
        self.current = dict(self.initial)


class ColumnScope:
    """Resolves bare field names for one predicate scope (the vertex
    property columns, or an edge class's).

    With ``binding_columns`` (the vertex columns) the compiler also accepts
    ``alias.prop`` for the aliases in ``visible_aliases``: the value is a
    gather through the alias's per-slot vertex ids, which the caller passes
    at evaluation as ``env["bindings"][alias]`` (int32, aligned with the
    mask's slots); ``uses_bindings`` records that it must."""

    def __init__(
        self,
        columns: Dict[str, DeviceColumn],
        non_columnar: Set[str],
        reserved: Set[str] = frozenset(),
        device: torch.device = torch.device("cpu"),
        binding_columns: Optional[Dict[str, DeviceColumn]] = None,
        binding_non_columnar: Set[str] = frozenset(),
        visible_aliases: Set[str] = frozenset(),
    ) -> None:
        self.columns = columns
        self.non_columnar = non_columnar
        #: names that are MATCH aliases / variables → binding-dependent
        self.reserved = reserved
        #: where the columns live: compile-time tables upload here once
        self.device = device
        self.binding_columns = binding_columns
        self.binding_non_columnar = binding_non_columnar
        self.visible_aliases = visible_aliases
        #: set when a binding reference compiled
        self.uses_bindings = False

    def resolve(self, name: str):
        if name in self.reserved:
            raise Uncompilable(f"identifier {name!r} is a bound alias/variable")
        if name.startswith("@") or name.startswith("$"):
            raise Uncompilable(f"meta field {name!r} not columnar")
        if name in self.columns:
            return self.columns[name]
        if name in self.non_columnar:
            raise Uncompilable(f"property {name!r} has no columnar encoding")
        return None  # never present → null column

    def resolve_binding(self, alias: str, prop: str) -> Optional[DeviceColumn]:
        """The column of ``alias.prop`` for a visible bound alias (None:
        never present); raises Uncompilable when ineligible."""
        if self.binding_columns is None or alias not in self.visible_aliases:
            raise Uncompilable(f"alias {alias!r} not visible to this predicate")
        if prop.startswith("@") or prop.startswith("$"):
            raise Uncompilable(f"meta field {prop!r} not columnar")
        if prop in self.binding_non_columnar:
            raise Uncompilable(f"property {prop!r} has no columnar encoding")
        self.uses_bindings = True
        return self.binding_columns.get(prop)


# A value node: kind + emit(idx, env) -> (values, present). kind one of
# 'int' 'float' 'bool' 'str' 'null' 'strlit'. For 'str', `dictionary` is the
# sorted host dictionary; for 'strlit' it is the literal string.
class _Val:
    __slots__ = ("kind", "emit", "dictionary")

    def __init__(self, kind: str, emit, dictionary=None):
        self.kind = kind
        self.emit = emit
        self.dictionary = dictionary


BoolFn = Callable[[torch.Tensor, dict], torch.Tensor]


def _zeros_bool(idx: torch.Tensor) -> torch.Tensor:
    return torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)


def _full_bool(idx: torch.Tensor, b: bool) -> torch.Tensor:
    return torch.full(idx.shape, b, dtype=torch.bool, device=idx.device)


def _const_val(v) -> _Val:
    if v is None:
        return _Val(
            "null",
            lambda idx, env: (
                torch.zeros(idx.shape, dtype=I32, device=idx.device),
                _zeros_bool(idx),
            ),
        )
    if isinstance(v, bool):
        return _Val("bool", lambda idx, env, v=v: (
            torch.full(idx.shape, int(v), dtype=I32, device=idx.device),
            _full_bool(idx, True)))
    if isinstance(v, int):
        if not (-(2**31) < v < 2**31):
            # float32 demotion would lose precision against the exact
            # integer compare of the reference's evaluator
            raise Uncompilable(f"integer literal {v} outside int32 range")
        return _Val("int", lambda idx, env, v=v: (
            torch.full(idx.shape, v, dtype=I32, device=idx.device),
            _full_bool(idx, True)))
    if isinstance(v, float):
        return _Val("float", lambda idx, env, v=v: (
            torch.full(idx.shape, v, dtype=F32, device=idx.device),
            _full_bool(idx, True)))
    if isinstance(v, str):
        # literal strings stay host-side; comparisons handle them specially
        return _Val("strlit", lambda idx, env: None, dictionary=v)
    raise Uncompilable(f"literal {v!r} not columnar")


def _column_val(col: DeviceColumn) -> _Val:
    def emit(idx, env, col=col):
        # padding slots (idx < 0) read as absent
        return K.take_pad(col.values, idx, 0), K.take_pad(col.present, idx, False)

    return _Val(col.kind, emit, dictionary=col.dictionary)


def _binding_val(alias: str, col: DeviceColumn) -> _Val:
    """``alias.prop``: the property gathered through the per-slot vertex
    ids of ``env["bindings"][alias]`` (-1: unbound, reads absent)."""

    def emit(idx, env, alias=alias, col=col):
        rows = env["bindings"][alias]
        return K.take_pad(col.values, rows, 0), K.take_pad(col.present, rows, False)

    return _Val(col.kind, emit, dictionary=col.dictionary)


_NUMERIC = ("int", "float", "bool")


def _promote(a: _Val, b: _Val) -> str:
    """Numeric promotion for arithmetic/compare: int32 unless any float."""
    return "float" if "float" in (a.kind, b.kind) else "int"


def _as_dtype(vals, present, kind):
    return vals.to(F32 if kind == "float" else I32), present


class Compiler:
    def __init__(self, scope: ColumnScope, params, allow_depth: bool = False):
        self.scope = scope
        self.params = params
        self.allow_depth = allow_depth

    def compile_bool(self, expr: A.Expression) -> BoolFn:
        return self._bool(expr)

    # -- value nodes -------------------------------------------------------

    def _value(self, expr: A.Expression) -> _Val:
        if isinstance(expr, A.Literal):
            return _const_val(expr.value)
        if isinstance(expr, A.Parameter):
            key = expr.name if expr.name is not None else expr.index
            if key not in self.params:
                sig = f":{expr.name}" if expr.name is not None else f"?{expr.index}"
                raise Uncompilable(f"missing parameter {sig}")
            return self._param_val(key)
        if isinstance(expr, A.Identifier):
            col = self.scope.resolve(expr.name)
            if col is None:
                return _const_val(None)
            return _column_val(col)
        if (
            isinstance(expr, A.FieldAccess)
            and isinstance(expr.base, A.Identifier)
            and self.scope.binding_columns is not None
            and expr.base.name in self.scope.visible_aliases
        ):
            col = self.scope.resolve_binding(expr.base.name, expr.name)
            if col is None:
                return _const_val(None)
            return _binding_val(expr.base.name, col)
        if isinstance(expr, A.ContextVar):
            if expr.name == "depth" and self.allow_depth:
                # the level is host-known (it replays from the recorded
                # schedule), so the fill bakes it: no host read
                return _Val(
                    "int",
                    lambda idx, env: (
                        torch.full(idx.shape, env["depth"], dtype=I32, device=idx.device),
                        _full_bool(idx, True),
                    ),
                )
            raise Uncompilable(f"context var ${expr.name} not columnar")
        if isinstance(expr, A.Unary):
            if expr.op in ("-", "+"):
                v = self._value(expr.expr)
                if v.kind not in _NUMERIC:
                    raise Uncompilable("unary minus on non-numeric")
                if expr.op == "+":
                    return v

                def emit(idx, env, v=v):
                    vals, pres = v.emit(idx, env)
                    return -vals, pres

                return _Val("int" if v.kind in ("int", "bool") else "float", emit)
            raise Uncompilable(f"unary {expr.op} is boolean")
        if isinstance(expr, A.Binary) and expr.op in ("+", "-", "*", "/", "%"):
            return self._arith(expr)
        raise Uncompilable(f"expression {type(expr).__name__} not columnar")

    def _param_val(self, key) -> _Val:
        """A parameter reference: numerics read the box's current value when
        the mask is evaluated (a number while recording, a 0-d device tensor
        on a replay); everything else bakes as a constant."""
        box = self.params
        if not isinstance(box, ParamBox) or key not in box.dynamic:
            v = box.initial[key] if isinstance(box, ParamBox) else box[key]
            return _const_val(v)
        kind = box.dynamic[key]
        box.used[key] = kind
        dtype = F32 if kind == "float" else I32

        def emit(idx, env, box=box, key=key, dtype=dtype):
            v = box.current[key]
            if isinstance(v, torch.Tensor):
                # broadcast on the device: torch.full would read the value
                # on the host, and a Python number would be baked into a
                # captured graph
                vals = v.to(dtype).expand(idx.shape)
            else:
                vals = torch.full(idx.shape, v, dtype=dtype, device=idx.device)
            return vals, _full_bool(idx, True)

        return _Val(kind, emit)

    def _arith(self, expr: A.Binary) -> _Val:
        a = self._value(expr.left)
        b = self._value(expr.right)
        if a.kind in ("strlit", "str") or b.kind in ("strlit", "str"):
            raise Uncompilable("string arithmetic not columnar")
        if a.kind == "null" or b.kind == "null":
            return _const_val(None)
        if a.kind not in _NUMERIC or b.kind not in _NUMERIC:
            raise Uncompilable("non-numeric arithmetic")
        op = expr.op
        kind = _promote(a, b)
        if op == "/":
            kind = "float"  # exact-int division equals float division numerically

        def emit(idx, env, a=a, b=b, op=op, kind=kind):
            av, ap = _as_dtype(*a.emit(idx, env), kind)
            bv, bp = _as_dtype(*b.emit(idx, env), kind)
            pres = ap & bp
            if op == "+":
                out = av + bv
            elif op == "-":
                out = av - bv
            elif op == "*":
                out = av * bv
            elif op == "/":
                pres = pres & (bv != 0)
                out = av / torch.where(bv != 0, bv, torch.ones_like(bv))
            else:  # % (floor modulo, the sign of the divisor, as jnp.mod)
                pres = pres & (bv != 0)
                out = torch.remainder(av, torch.where(bv != 0, bv, torch.ones_like(bv)))
            return out, pres

        return _Val(kind, emit)

    # -- boolean nodes -----------------------------------------------------

    def _bool(self, expr: A.Expression) -> BoolFn:
        if isinstance(expr, A.Binary):
            op = expr.op
            if op == "AND":
                l, r = self._bool(expr.left), self._bool(expr.right)
                return lambda idx, env: l(idx, env) & r(idx, env)
            if op == "OR":
                l, r = self._bool(expr.left), self._bool(expr.right)
                return lambda idx, env: l(idx, env) | r(idx, env)
            if op in ("=", "!=", "<", "<=", ">", ">="):
                return self._compare(op, expr.left, expr.right)
            if op in ("LIKE", "MATCHES", "CONTAINSTEXT"):
                return self._string_table_op(op, expr.left, expr.right)
            if op == "IN":
                return self._in(expr.left, expr.right)
            raise Uncompilable(f"operator {op} not columnar")
        if isinstance(expr, A.Unary) and expr.op == "NOT":
            inner = self._bool(expr.expr)
            return lambda idx, env: ~inner(idx, env)
        if isinstance(expr, A.Between):
            ge = self._compare(">=", expr.expr, expr.low)
            le = self._compare("<=", expr.expr, expr.high)
            return lambda idx, env: ge(idx, env) & le(idx, env)
        if isinstance(expr, A.IsNull):
            v = self._value(expr.expr)
            if v.kind == "strlit":
                raise Uncompilable("IS NULL on string literal")
            neg = expr.negated

            def isnull(idx, env, v=v, neg=neg):
                if v.kind == "null":
                    pres = _zeros_bool(idx)
                else:
                    _, pres = v.emit(idx, env)
                return pres if neg else ~pres

            return isnull
        if isinstance(expr, A.Literal) and isinstance(expr.value, bool):
            b = expr.value
            return lambda idx, env: _full_bool(idx, b)
        # truthiness of a bare value (where:(flag))
        return self._truthy(self._value(expr))

    def _truthy(self, v: _Val) -> BoolFn:
        if v.kind == "null":
            return lambda idx, env: _zeros_bool(idx)
        if v.kind == "strlit":
            b = bool(v.dictionary)
            return lambda idx, env: _full_bool(idx, b)
        if v.kind == "str":
            # non-empty string is truthy: host-eval over the dictionary
            table = np.array([bool(s) for s in (v.dictionary or [])], bool)
            return self._code_table_mask(v, table)

        def fn(idx, env, v=v):
            vals, pres = v.emit(idx, env)
            return pres & (vals != 0)

        return fn

    def _code_table_mask(self, v: _Val, table: np.ndarray) -> BoolFn:
        """Membership of each slot's string code in a host-computed table,
        uploaded once here, at compile, onto the scope's device."""
        if table.size == 0:
            return lambda idx, env: _zeros_bool(idx)
        dev = torch.from_numpy(table).to(self.scope.device)

        def fn(idx, env, v=v, dev=dev):
            vals, pres = v.emit(idx, env)
            codes = vals.clamp(0, dev.shape[0] - 1)
            return pres & K.take_pad(dev, codes, False)

        return fn

    def _string_table_op(self, op: str, left: A.Expression, right: A.Expression) -> BoolFn:
        lv = self._value(left)
        rv = self._value(right)
        if rv.kind != "strlit":
            raise Uncompilable(f"{op} needs a literal pattern")
        pat = rv.dictionary
        if lv.kind == "null":
            return lambda idx, env: _zeros_bool(idx)
        if lv.kind == "strlit":
            # literal op literal: host constant (oracle semantics)
            s = lv.dictionary
            if op == "LIKE":
                res = like_match(s, pat)
            elif op == "MATCHES":
                res = re.fullmatch(pat, s) is not None
            else:
                res = pat in s
            return lambda idx, env, res=res: _full_bool(idx, res)
        if lv.kind != "str":
            return lambda idx, env: _zeros_bool(idx)  # non-str LIKE → false
        d = lv.dictionary or []
        if op == "LIKE":
            table = np.array([like_match(s, pat) for s in d], bool)
        elif op == "MATCHES":
            table = np.array([re.fullmatch(pat, s) is not None for s in d], bool)
        else:  # CONTAINSTEXT
            table = np.array([pat in s for s in d], bool)
        return self._code_table_mask(lv, table)

    def _in(self, left: A.Expression, right: A.Expression) -> BoolFn:
        if not isinstance(right, A.ListExpr):
            raise Uncompilable("IN needs a literal list")
        eqs = [self._compare("=", left, item) for item in right.items]
        if not eqs:
            return lambda idx, env: _zeros_bool(idx)

        def fn(idx, env, eqs=eqs):
            m = eqs[0](idx, env)
            for e in eqs[1:]:
                m = m | e(idx, env)
            return m

        return fn

    # -- comparisons -------------------------------------------------------

    def _compare(self, op: str, left: A.Expression, right: A.Expression) -> BoolFn:
        a = self._value(left)
        b = self._value(right)
        # null on either side: every compare false (incl. !=)
        if a.kind == "null" or b.kind == "null":
            return lambda idx, env: _zeros_bool(idx)
        # string literal vs string literal: host constant
        if a.kind == "strlit" and b.kind == "strlit":
            res = _host_cmp(op, a.dictionary, b.dictionary)
            return lambda idx, env, res=res: _full_bool(idx, res)
        # string column vs literal (either side)
        if a.kind == "str" and b.kind == "strlit":
            return self._cmp_str_lit(op, a, b.dictionary)
        if a.kind == "strlit" and b.kind == "str":
            return self._cmp_str_lit(_flip(op), b, a.dictionary)
        # type-mismatch across order classes
        a_num = a.kind in _NUMERIC
        b_num = b.kind in _NUMERIC
        a_str = a.kind == "str"
        b_str = b.kind in ("str", "strlit")
        if (a_num and b_str) or (a_str and b_num) or (a.kind == "strlit" and b_num):
            if op == "!=":
                # non-null incomparables are "not equal" (values_equal fallback)
                def fn(idx, env, a=a, b=b):
                    return _presence(a, idx, env) & _presence(b, idx, env)

                return fn
            return lambda idx, env: _zeros_bool(idx)
        if a_str and b.kind == "str":
            if a.dictionary is not None and a.dictionary is b.dictionary:
                # same sorted dictionary (same column on both sides): code
                # order == lexicographic order, so the codes compare as ints
                a = _Val("int", a.emit)
                b = _Val("int", b.emit)
                a_num = b_num = True
            else:
                raise Uncompilable("string column vs string column compare")
        if not (a_num and b_num):
            raise Uncompilable(f"cannot compare {a.kind} with {b.kind}")
        ordered_ok = True
        if ("bool" in (a.kind, b.kind)) and a.kind != b.kind and op not in ("=", "!="):
            # compare() yields None for bool vs non-bool → ordered ops false
            ordered_ok = False
        kind = _promote(a, b)

        def fn(idx, env, a=a, b=b, op=op, kind=kind, ordered_ok=ordered_ok):
            if op not in ("=", "!=") and not ordered_ok:
                return _zeros_bool(idx)
            av, ap = _as_dtype(*a.emit(idx, env), kind)
            bv, bp = _as_dtype(*b.emit(idx, env), kind)
            if op == "=":
                c = av == bv
            elif op == "!=":
                c = av != bv
            elif op == "<":
                c = av < bv
            elif op == "<=":
                c = av <= bv
            elif op == ">":
                c = av > bv
            else:
                c = av >= bv
            return ap & bp & c

        return fn

    def _cmp_str_lit(self, op: str, col: _Val, lit: str) -> BoolFn:
        d: Sequence[str] = col.dictionary or []
        lo = bisect.bisect_left(d, lit)
        hi = bisect.bisect_right(d, lit)
        exact = lo if (lo < len(d) and d[lo] == lit) else None

        def fn(idx, env, col=col, op=op, exact=exact, lo=lo, hi=hi):
            vals, pres = col.emit(idx, env)
            if op == "=":
                if exact is None:
                    return _zeros_bool(idx)
                return pres & (vals == exact)
            if op == "!=":
                if exact is None:
                    return pres
                return pres & (vals != exact)
            if op == "<":
                return pres & (vals < lo)
            if op == "<=":
                return pres & (vals < hi)
            if op == ">":
                return pres & (vals >= hi)
            return pres & (vals >= lo)  # >=

        return fn


def _presence(v: _Val, idx, env) -> torch.Tensor:
    if v.kind == "strlit":
        return _full_bool(idx, True)
    if v.kind == "null":
        return _zeros_bool(idx)
    _, pres = v.emit(idx, env)
    return pres


def _flip(op: str) -> str:
    return {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}[op]


def _host_cmp(op: str, a: str, b: str) -> bool:
    return {
        "=": a == b,
        "!=": a != b,
        "<": a < b,
        "<=": a <= b,
        ">": a > b,
        ">=": a >= b,
    }[op]


def compile_predicate(
    expr: A.Expression, scope: ColumnScope, params, allow_depth: bool = False
) -> BoolFn:
    """Compile a WHERE AST into `fn(idx_array, env) -> bool mask`;
    ``allow_depth`` admits ``$depth`` (read from ``env["depth"]``).

    Raises Uncompilable outside the columnar subset."""
    return Compiler(scope, params, allow_depth=allow_depth).compile_bool(expr)
