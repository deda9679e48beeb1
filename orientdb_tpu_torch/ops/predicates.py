"""Port of `orientdb_tpu/ops/predicates.py`: the columnar predicate compiler,
WHERE AST → a predicate program that evaluates a boolean mask over slots.

The compiler keeps the reference's decisions node for node
(`Compiler._value` / `_bool` / `_compare` / ...); what a node emits is an
instruction tree instead of a closure. `Predicate` ANDs the terms of one
mask (padding, class closures, WHERE) as guarded conjuncts, cheapest first
(each followed by a GUARD that drops the slots it rejects from every later
read), orders each tree for the smallest value stack (the deeper operand
first), splits off whatever would not fit
the kernel's stack or buffer table into earlier launches, and uploads the
postfix program once, at compile. Calling it runs the whole mask as ONE
`K.predicate_eval` launch (the K15 interpreter on the card, its plain torch
version on the CPU), with the per-call pointers (ids or identity mode,
binding rows, the parameter row, the WHILE level) as launch arguments.

Semantics follow the reference (and through it `exec/eval.py`) on the
columnar subset:
  - any comparison with null is false (only IS NULL sees nulls);
  - `!=` additionally needs both sides non-null;
  - AND/OR collapse null to false; NOT(null) is true;
  - type-mismatched `=` is false, `<` family is false, while `!=` of two
    non-null incomparable values is true.

String columns are dictionary-coded with a sorted dictionary, so ordered
compares against a literal become int32 compares against the literal's
bisect rank (a dictionary a write batch appended to is no longer sorted:
equality and IN then look the literal's code up, and ordered compares
refuse to compile, as the reference's `_dict_sorted` does), and LIKE / MATCHES / CONTAINSTEXT are evaluated on the host
over the dictionary into a code-membership table. A WHILE condition
compiles with ``allow_depth``: ``$depth`` is then the launch's level
(``env["depth"]``). A scope may be an edge class's property columns (an
edge WHERE over edge ids) as well as the vertex columns; with
``binding_columns`` it also admits ``alias.prop`` references to earlier
bound aliases, read per slot through ``env["bindings"]``. ``distance()``
is the reference's float32 haversine. Anything outside the subset raises
`Uncompilable`.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from orientdb_tpu_torch.exec.eval import like_match
from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.ops.csr import PredOp as O
from orientdb_tpu_torch.ops.device_graph import DeviceColumn
from orientdb_tpu_torch.sql import ast as A
from orientdb_tpu_torch.utils.geo import EARTH_RADIUS_KM, MILE_UNITS, MILES_PER_KM

I32 = torch.int32
F32 = torch.float32


class Uncompilable(Exception):
    """Statement or expression outside the compiled subset."""


def split_params(params: Dict) -> Tuple[Dict[object, str], Dict[object, object]]:
    """Partition query parameters into numeric ones (read per run from the
    parameter row, kind-tagged) and the rest (baked into the compiled
    predicates). Integers outside int32 stay static and meet `_const_val`'s
    range gate."""
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


def pack_params(values: Dict, spec: Dict[object, str]) -> np.ndarray:
    """The parameter row of ``spec``'s keys, in its order, as one host
    int32 array (float32 values by their bits)."""
    row = np.zeros(max(len(spec), 1), np.int32)
    for i, (k, kind) in enumerate(spec.items()):
        v = values[k]
        row[i] = np.float32(v).view(np.int32) if kind == "float" else int(v)
    return row


class ParamBox:
    """Parameter environment shared by a solver's compiled predicates: a
    numeric parameter compiles to a slot of ONE int32 device row (its place
    in ``used``), so one compiled set of programs serves any value.

    A recording run reads a row uploaded from the concrete values; a replay
    hands in its own row (`set_row`: the plan's static buffer, or a group
    lane's row of its stack), which the dispatch fills on the device, so no
    parameter value is baked into a captured graph. A group replay on the
    lane axis hands in the whole ``[B, P]`` stack: the box then holds a
    stack (`lanes`), and every program that reads a parameter evaluates
    once a row."""

    def __init__(self, params: Dict) -> None:
        self.initial = dict(params)
        self.dynamic, self.static = split_params(params)
        #: dynamic keys actually referenced by some compiled predicate, in
        #: slot order
        self.used: Dict[object, str] = {}
        self._row: Optional[torch.Tensor] = None
        self._recorded: Optional[torch.Tensor] = None

    def __contains__(self, k) -> bool:
        return k in self.initial

    def slot(self, key) -> int:
        """The row slot of a dynamic parameter (assigned on first use)."""
        if key not in self.used:
            self.used[key] = self.dynamic[key]
        return list(self.used).index(key)

    def set_row(self, row: torch.Tensor) -> None:
        self._row = row

    @property
    def lanes(self) -> Optional[int]:
        """B when the box holds a ``[B, P]`` stack, else None."""
        row = self._row
        return row.shape[0] if row is not None and row.dim() == 2 else None

    def reset(self) -> None:
        self._row = None

    def row(self, device: torch.device) -> torch.Tensor:
        """The row the programs read: a replay's, else the recording's
        values (re-uploaded when a later predicate used another key)."""
        if self._row is not None:
            return self._row
        rec = self._recorded
        if rec is None or rec.device != device or rec.shape[0] != max(len(self.used), 1):
            rec = torch.from_numpy(pack_params(self.initial, self.used)).to(device)
            self._recorded = rec
        return rec


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


# ---------------------------------------------------------------------------
# the instruction tree
# ---------------------------------------------------------------------------

#: ops whose operands a, b, c name buffers (in this order), not immediates
_BUFFER_OPS = (O.COL, O.BCOL, O.TMP, O.TABLE, O.CLASS)


class _Node:
    """One instruction with its operand subtrees. ``srcs`` are the buffers
    it reads, each ``(kind, obj, field)``: ``("col", DeviceColumn,
    "values"|"present")``, ``("bind", alias, None)``, ``("tensor", t,
    None)`` or ``("tmp", k, "v"|"p")``. ``need`` (stack entries) and
    ``bufs`` (buffer keys) are filled by `_measure`."""

    __slots__ = ("op", "imm", "srcs", "kids", "need", "bufs")

    def __init__(self, op: int, imm=(0, 0, 0), srcs=(), kids=()):
        self.op = op
        self.imm = tuple(imm)
        self.srcs = tuple(srcs)
        self.kids = list(kids)
        self.need = 1
        self.bufs: frozenset = frozenset()


def _src_key(src) -> tuple:
    kind, obj, field = src
    return (kind, obj if isinstance(obj, (str, int)) else id(obj), field)


def _const(bits: int, present: bool) -> _Node:
    return _Node(O.CONST, (bits, int(present), 0))


def _mask(b: bool) -> _Node:
    return _Node(O.MASK, (int(bool(b)), 0, 0))


def _nary(op: int, kids: List[_Node]) -> _Node:
    """AND / OR of ``kids``, flattening nested ones of the same op."""
    flat: List[_Node] = []
    for k in kids:
        flat.extend(k.kids if k.op == op else [k])
    return flat[0] if len(flat) == 1 else _Node(op, kids=flat)


def _not(x: _Node) -> _Node:
    return _Node(O.NOT, kids=[x])


def _f32_bits(v: float) -> int:
    return int(np.array([v], np.float64).astype(np.float32).view(np.int32)[0])


# A value: kind + the node pushing its (value, present) pair. kind one of
# 'int' 'float' 'bool' 'str' 'null' 'strlit'. For 'str', `dictionary` is the
# sorted host dictionary; for 'strlit' it is the literal string (no node).
class _Val:
    __slots__ = ("kind", "node", "dictionary", "column")

    def __init__(self, kind: str, node: Optional[_Node], dictionary=None, column=None):
        self.kind = kind
        self.node = node
        self.dictionary = dictionary
        #: the DeviceColumn a 'str' value reads (its dictionary's sortedness)
        self.column = column


def _const_val(v) -> _Val:
    if v is None:
        return _Val("null", _const(0, False))
    if isinstance(v, bool):
        return _Val("bool", _const(int(v), True))
    if isinstance(v, int):
        if not (-(2**31) < v < 2**31):
            # float32 demotion would lose precision against the exact
            # integer compare of the reference's evaluator
            raise Uncompilable(f"integer literal {v} outside int32 range")
        return _Val("int", _const(v, True))
    if isinstance(v, float):
        with np.errstate(over="ignore"):
            return _Val("float", _const(_f32_bits(v), True))
    if isinstance(v, str):
        # literal strings stay host-side; comparisons handle them specially
        return _Val("strlit", None, dictionary=v)
    raise Uncompilable(f"literal {v!r} not columnar")


def _column_val(col: DeviceColumn) -> _Val:
    # padding slots (id < 0) read as absent
    node = _Node(O.COL, srcs=(("col", col, "values"), ("col", col, "present")))
    return _Val(col.kind, node, dictionary=col.dictionary, column=col)


def _binding_val(alias: str, col: DeviceColumn) -> _Val:
    """``alias.prop``: the property gathered through the per-slot vertex
    ids of ``env["bindings"][alias]`` (-1: unbound, reads absent)."""
    node = _Node(
        O.BCOL,
        srcs=(("col", col, "values"), ("col", col, "present"), ("bind", alias, None)),
    )
    return _Val(col.kind, node, dictionary=col.dictionary, column=col)


_NUMERIC = ("int", "float", "bool")


def _promote(a: _Val, b: _Val) -> str:
    """Numeric promotion for arithmetic/compare: int32 unless any float."""
    return "float" if "float" in (a.kind, b.kind) else "int"


def _as_kind(v: _Val, kind: str) -> _Node:
    """``v``'s node converted to ``kind`` (int32 → float32 only)."""
    if kind == "float" and v.kind != "float":
        return _Node(O.I2F, kids=[v.node])
    return v.node


def _kind_code(kind: str) -> int:
    return 1 if kind == "float" else 0


class Compiler:
    def __init__(self, scope: ColumnScope, params, allow_depth: bool = False):
        self.scope = scope
        self.params = params
        self.allow_depth = allow_depth

    def compile_bool(self, expr: A.Expression) -> _Node:
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
                # schedule), so the launch bakes it: no host read
                return _Val("int", _Node(O.DEPTH))
            raise Uncompilable(f"context var ${expr.name} not columnar")
        if isinstance(expr, A.Unary):
            if expr.op in ("-", "+"):
                v = self._value(expr.expr)
                if v.kind not in _NUMERIC:
                    raise Uncompilable("unary minus on non-numeric")
                if expr.op == "+":
                    return v
                kind = "int" if v.kind in ("int", "bool") else "float"
                return _Val(kind, _Node(O.NEG, (0, _kind_code(kind), 0), kids=[v.node]))
            raise Uncompilable(f"unary {expr.op} is boolean")
        if isinstance(expr, A.Binary) and expr.op in ("+", "-", "*", "/", "%"):
            return self._arith(expr)
        if isinstance(expr, A.FunctionCall) and expr.name.lower() == "distance":
            return self._distance(expr)
        raise Uncompilable(f"expression {type(expr).__name__} not columnar")

    def _distance(self, expr: A.FunctionCall) -> _Val:
        """``distance(lat1, lng1, lat2, lng2[, unit])``: the haversine in
        float32 (OrientDB's ``OSQLFunctionDistance``), one ``DIST``
        instruction over four numeric operands; present where all four
        are."""
        if len(expr.args) not in (4, 5):
            raise Uncompilable("distance() takes 4 args (+ optional unit)")
        scale = 1.0
        if len(expr.args) == 5:
            u = expr.args[4]
            if not isinstance(u, A.Literal) or str(u.value).lower() not in (MILE_UNITS | {"km"}):
                raise Uncompilable("distance() unit must be a literal")
            if str(u.value).lower() != "km":
                scale = MILES_PER_KM
        vals = [self._value(a) for a in expr.args[:4]]
        for v in vals:
            if v.kind == "null":
                return _const_val(None)
            # bool is numeric to arithmetic but the evaluator's distance()
            # rejects it (returns null)
            if v.kind not in ("int", "float"):
                raise Uncompilable("non-numeric distance() operand")
        assert EARTH_RADIUS_KM == 6371.0  # the kernel's 2R = 12742
        kids = [_as_kind(v, "float") for v in vals]
        return _Val("float", _Node(O.DIST, (_f32_bits(scale), 0, 0), kids=kids))

    def _param_val(self, key) -> _Val:
        """A parameter reference: numerics read their slot of the parameter
        row when the mask is evaluated; everything else bakes as a
        constant."""
        box = self.params
        if not isinstance(box, ParamBox) or key not in box.dynamic:
            v = box.initial[key] if isinstance(box, ParamBox) else box[key]
            return _const_val(v)
        return _Val(box.dynamic[key], _Node(O.PARAM, (box.slot(key), 0, 0)))

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
        node = _Node(
            O.ARITH,
            (K.ARITH_OPS.index(op), _kind_code(kind), 0),
            kids=[_as_kind(a, kind), _as_kind(b, kind)],
        )
        return _Val(kind, node)

    # -- boolean nodes -----------------------------------------------------

    def _bool(self, expr: A.Expression) -> _Node:
        if isinstance(expr, A.Binary):
            op = expr.op
            if op == "AND":
                return _nary(O.AND, [self._bool(expr.left), self._bool(expr.right)])
            if op == "OR":
                return _nary(O.OR, [self._bool(expr.left), self._bool(expr.right)])
            if op in ("=", "!=", "<", "<=", ">", ">="):
                return self._compare(op, expr.left, expr.right)
            if op in ("LIKE", "MATCHES", "CONTAINSTEXT"):
                return self._string_table_op(op, expr.left, expr.right)
            if op == "IN":
                return self._in(expr.left, expr.right)
            raise Uncompilable(f"operator {op} not columnar")
        if isinstance(expr, A.Unary) and expr.op == "NOT":
            return _not(self._bool(expr.expr))
        if isinstance(expr, A.Between):
            ge = self._compare(">=", expr.expr, expr.low)
            le = self._compare("<=", expr.expr, expr.high)
            return _nary(O.AND, [ge, le])
        if isinstance(expr, A.IsNull):
            v = self._value(expr.expr)
            if v.kind == "strlit":
                raise Uncompilable("IS NULL on string literal")
            return _Node(O.ISNULL, (int(expr.negated), 0, 0), kids=[v.node])
        if isinstance(expr, A.Literal) and isinstance(expr.value, bool):
            return _mask(expr.value)
        # truthiness of a bare value (where:(flag))
        return self._truthy(self._value(expr))

    def _truthy(self, v: _Val) -> _Node:
        if v.kind == "null":
            return _mask(False)
        if v.kind == "strlit":
            return _mask(bool(v.dictionary))
        if v.kind == "str":
            # non-empty string is truthy: host-eval over the dictionary
            table = np.array([bool(s) for s in (v.dictionary or [])], bool)
            return self._code_table_mask(v, table)
        return _Node(O.TRUTHY, (0, _kind_code(v.kind), 0), kids=[v.node])

    def _code_table_mask(self, v: _Val, table: np.ndarray) -> _Node:
        """Membership of each slot's string code in a host-computed table,
        uploaded once here, at compile, onto the scope's device."""
        if table.size == 0:
            return _mask(False)
        dev = torch.from_numpy(table).to(self.scope.device)
        return _Node(O.TABLE, srcs=(("tensor", dev, None),), kids=[v.node])

    def _string_table_op(self, op: str, left: A.Expression, right: A.Expression) -> _Node:
        lv = self._value(left)
        rv = self._value(right)
        if rv.kind != "strlit":
            raise Uncompilable(f"{op} needs a literal pattern")
        pat = rv.dictionary
        if lv.kind == "null":
            return _mask(False)
        if lv.kind == "strlit":
            # literal op literal: host constant (oracle semantics)
            s = lv.dictionary
            if op == "LIKE":
                res = like_match(s, pat)
            elif op == "MATCHES":
                res = re.fullmatch(pat, s) is not None
            else:
                res = pat in s
            return _mask(res)
        if lv.kind != "str":
            return _mask(False)  # non-str LIKE → false
        d = lv.dictionary or []
        if op == "LIKE":
            table = np.array([like_match(s, pat) for s in d], bool)
        elif op == "MATCHES":
            table = np.array([re.fullmatch(pat, s) is not None for s in d], bool)
        else:  # CONTAINSTEXT
            table = np.array([pat in s for s in d], bool)
        return self._code_table_mask(lv, table)

    def _in(self, left: A.Expression, right: A.Expression) -> _Node:
        if not isinstance(right, A.ListExpr):
            raise Uncompilable("IN needs a literal list")
        eqs = [self._compare("=", left, item) for item in right.items]
        if not eqs:
            return _mask(False)
        return _nary(O.OR, eqs)

    # -- comparisons -------------------------------------------------------

    def _compare(self, op: str, left: A.Expression, right: A.Expression) -> _Node:
        a = self._value(left)
        b = self._value(right)
        # null on either side: every compare false (incl. !=)
        if a.kind == "null" or b.kind == "null":
            return _mask(False)
        # string literal vs string literal: host constant
        if a.kind == "strlit" and b.kind == "strlit":
            return _mask(_host_cmp(op, a.dictionary, b.dictionary))
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
                return _nary(O.AND, [_presence(a), _presence(b)])
            return _mask(False)
        if a_str and b.kind == "str":
            if a.dictionary is not None and a.dictionary is b.dictionary:
                if op not in ("=", "!=") and not _dict_sorted(a):
                    raise Uncompilable(
                        "ordered string compare on a delta-appended dictionary"
                    )
                # same sorted dictionary (same column on both sides): code
                # order == lexicographic order, so the codes compare as ints
                a = _Val("int", a.node)
                b = _Val("int", b.node)
                a_num = b_num = True
            else:
                raise Uncompilable("string column vs string column compare")
        if not (a_num and b_num):
            raise Uncompilable(f"cannot compare {a.kind} with {b.kind}")
        if ("bool" in (a.kind, b.kind)) and a.kind != b.kind and op not in ("=", "!="):
            # compare() yields None for bool vs non-bool → ordered ops false
            return _mask(False)
        kind = _promote(a, b)
        return _Node(
            O.CMP,
            (K.CMP_OPS.index(op), _kind_code(kind), 0),
            kids=[_as_kind(a, kind), _as_kind(b, kind)],
        )

    def _cmp_str_lit(self, op: str, col: _Val, lit: str) -> _Node:
        d: Sequence[str] = col.dictionary or []
        if not _dict_sorted(col):
            # a write batch APPENDED strings: codes are no longer ranked, so
            # bisect is wrong; equality looks the code up
            if op not in ("=", "!="):
                raise Uncompilable(
                    "ordered string compare on a delta-appended dictionary"
                )
            code = col.column.host.dict_lookup.get(lit)
            if code is None:
                return _mask(False) if op == "=" else _presence(col)
            return _Node(O.CMP, (K.CMP_OPS.index(op), 0, 0), kids=[col.node, _const(code, True)])
        lo = bisect.bisect_left(d, lit)
        hi = bisect.bisect_right(d, lit)
        exact = lo if (lo < len(d) and d[lo] == lit) else None
        if op in ("=", "!=") and exact is None:
            return _mask(False) if op == "=" else _presence(col)
        # vs the exact code, or vs the literal's bisect rank
        op2, rank = {
            "=": ("=", exact),
            "!=": ("!=", exact),
            "<": ("<", lo),
            "<=": ("<", hi),
            ">": (">=", hi),
            ">=": (">=", lo),
        }[op]
        return _Node(O.CMP, (K.CMP_OPS.index(op2), 0, 0), kids=[col.node, _const(rank, True)])


def _presence(v: _Val) -> _Node:
    if v.kind == "strlit":
        return _mask(True)
    if v.kind == "null":
        return _mask(False)
    return _Node(O.ISNULL, (1, 0, 0), kids=[v.node])


def _dict_sorted(v: _Val) -> bool:
    """True while the column's dictionary codes are in lexicographic order
    (every build sorts; a write batch's append clears it)."""
    return v.column is None or not v.column.host.dict_unsorted


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


# ---------------------------------------------------------------------------
# programs: stack order, splits, upload, evaluation
# ---------------------------------------------------------------------------


def _measure(node: _Node) -> None:
    """``need``: stack entries the subtree uses with the deeper operand
    evaluated first; ``bufs``: the buffers it reads."""
    kids = node.kids
    needs = [k.need for k in kids]
    if not kids:
        node.need = 1
    elif node.op in (O.AND, O.OR):
        s = sorted(needs, reverse=True)
        node.need = max([s[0]] + [x + 1 for x in s[1:]])
    elif node.op == O.GUARD:  # one conjunct on the stack at a time
        node.need = max(needs)
    elif node.op == O.DIST:
        node.need = max(x + i for i, x in enumerate(needs))
    elif len(kids) == 2:
        node.need = needs[0] + 1 if needs[0] == needs[1] else max(needs)
    else:
        node.need = needs[0]
    bufs = {_src_key(s) for s in node.srcs}
    for k in kids:
        bufs |= k.bufs
    node.bufs = frozenset(bufs)


def _tmp(k: int) -> _Node:
    node = _Node(O.TMP, srcs=(("tmp", k, "v"), ("tmp", k, "p")))
    _measure(node)
    return node


def _fit(node: _Node, depth: int, nbufs: int, out: List[_Node]) -> _Node:
    """Make ``node`` fit one launch (stack ≤ ``depth``, buffers ≤
    ``nbufs``): subtrees that do not are moved into ``out`` (launches that
    run first, in order) and read back through a ``TMP`` leaf."""
    node.kids = [_fit(k, depth, nbufs, out) for k in node.kids]
    _measure(node)
    while node.need > depth or len(node.bufs) > nbufs:
        if node.op in (O.AND, O.OR, O.GUARD) and len(node.bufs) > nbufs:
            # chunks of terms whose buffers fit, each its own launch
            groups: List[List[_Node]] = [[]]
            seen: set = set()
            for k in node.kids:
                if groups[-1] and len(seen | k.bufs) > nbufs:
                    groups.append([])
                    seen = set()
                groups[-1].append(k)
                seen |= k.bufs
            kids = []
            for g in groups:
                if len(g) == 1 and g[0].op == O.TMP:
                    kids.append(g[0])
                    continue
                sub = _nary(O.AND if node.op == O.GUARD else node.op, g)
                _measure(sub)
                out.append(_fit(sub, depth, nbufs, out))
                kids.append(_tmp(len(out) - 1))
            node.kids = kids
        else:
            cand = [i for i, k in enumerate(node.kids) if k.op != O.TMP]
            if not cand:
                raise Uncompilable("predicate does not fit the kernel's stack")
            i = max(cand, key=lambda j: (node.kids[j].need, len(node.kids[j].bufs)))
            out.append(node.kids[i])
            node.kids[i] = _tmp(len(out) - 1)
        _measure(node)
    return node


def _slot_bytes(node: _Node) -> int:
    """Bytes a slot reads for the subtree, each buffer once: 4 a value or
    binding row, 1 a presence byte, a tensor's element size (class ids,
    closure and code tables)."""
    sizes: Dict[tuple, int] = {}

    def walk(n: _Node) -> None:
        for src in n.srcs:
            kind, obj, field = src
            if kind == "tensor":
                size = obj.element_size()
            else:
                size = 1 if field in ("present", "p") else 4
            sizes[_src_key(src)] = size
        for k in n.kids:
            walk(k)

    walk(node)
    return sum(sizes.values())


def _guarded_order(kids: List[_Node]) -> List[_Node]:
    """A guarded root's conjuncts, cheapest first: those that read no
    buffer (the padding test, ID and compares of constants, parameters and
    the WHILE level), then by the bytes a slot reads; ties keep their
    order."""
    return sorted(kids, key=_slot_bytes)


def _emit(node: _Node, rows: List[Tuple[int, int, int, int]], index: Dict, srcs: List) -> None:
    """Postfix emission, the deeper operand first; a guarded root's
    conjuncts each followed by GUARD, cheapest first."""
    kids = node.kids
    if node.op == O.GUARD:
        for k in _guarded_order(kids):
            _emit(k, rows, index, srcs)
            rows.append((O.GUARD, 0, 0, 0))
        return
    if node.op in (O.AND, O.OR):
        order = sorted(kids, key=lambda k: -k.need)
        _emit(order[0], rows, index, srcs)
        for k in order[1:]:
            _emit(k, rows, index, srcs)
            rows.append((node.op, 0, 0, 0))
        return
    swapped = len(kids) == 2 and kids[1].need > kids[0].need
    for k in (kids[::-1] if swapped else kids):
        _emit(k, rows, index, srcs)
    a, b, c = node.imm
    if node.op in _BUFFER_OPS:
        slots = []
        for s in node.srcs:
            key = _src_key(s)
            if key not in index:
                index[key] = len(srcs)
                srcs.append(s)
            slots.append(index[key])
        a, b, c = (slots + [0, 0, 0])[:3]
    if node.op in (O.ARITH, O.CMP):
        c = int(swapped)
    rows.append((node.op, a, b, c))


class _Program:
    """One launch: the postfix program on the device and its buffers."""

    def __init__(self, root: _Node, device: torch.device) -> None:
        rows: List[Tuple[int, int, int, int]] = []
        self.srcs: List = []
        _emit(root, rows, {}, self.srcs)
        self.prog = K.PredProgram(rows, device)
        self.uses_params = any(r[0] == O.PARAM for r in rows)

    def buffers(self, env: Dict, tmps: List, n: int) -> List[torch.Tensor]:
        out = []
        for kind, obj, field in self.srcs:
            if kind == "col":
                out.append(getattr(obj, field))
            elif kind == "bind":
                # slot-aligned: [n], or a lane's [B, n] over lane-stacked ids
                rows = env["bindings"][obj]
                if rows.shape[-1] != n:
                    raise ValueError(f"binding rows of {obj!r}: {rows.shape[-1]} for {n} slots")
                out.append(rows)
            elif kind == "tensor":
                out.append(obj)
            else:
                out.append(tmps[obj][0 if field == "v" else 1])
        return out


class Predicate:
    """A compiled mask: the AND of its terms (padding, class closures,
    WHERE), as one predicate program whose root AND is a list of guarded
    conjuncts (a conjunct that rejects a slot stops the kernel's reads for
    it; split launches stay unguarded). ``pred(idx, env)`` evaluates it over
    the ids ``idx``; ``pred.identity(n, n_valid, base, env)`` over slot ids
    ``base + i`` (``i < n_valid``, else padding) without an id array. Both
    are one `K.predicate_eval` launch, plus one for each subtree split off
    because it passed the kernel's stack depth or buffer table. They return
    bool [n], or [B, n] (one row a lane) when the program reads a parameter
    and the box holds a ``[B, P]`` stack (`ParamBox.lanes`): K15's lane
    form, which takes an unsplit program only (`lane_ok`). Over
    lane-stacked ids [B, n] (an arm past the root on the lane axis) a mask
    that reads a parameter takes K15's stacked form, each lane its own ids,
    binding rows [B, n] and parameter row, split programs included; a mask
    the lanes share, binding-reading ones included (their rows are
    slot-aligned like the ids), runs the single form once over the
    flattened [B·n] ids and rows."""

    def __init__(
        self,
        terms: List[_Node],
        device: torch.device,
        box=None,
        uses_bindings: bool = False,
        max_stack: int = K.PRED_STACK,
        max_bufs: int = K.PRED_BUFS,
    ) -> None:
        self.device = device
        self.box = box
        self.uses_bindings = uses_bindings
        root = _nary(O.AND, list(terms))
        if root.op == O.AND:
            root = _Node(O.GUARD, kids=root.kids)
        split: List[_Node] = []
        root = _fit(root, max_stack, max_bufs, split)
        self.programs = [_Program(t, device) for t in split] + [_Program(root, device)]
        self.uses_params = any(p.uses_params for p in self.programs)

    @property
    def lane_ok(self) -> bool:
        """True when a parameter stack evaluates this mask in one lane-form
        launch: one program (no split) that the lane form takes."""
        return len(self.programs) == 1 and self.programs[0].prog.lane_ok

    def __call__(self, idx: torch.Tensor, env: Optional[Dict] = None) -> torch.Tensor:
        if idx.dim() == 2:
            # lane-stacked ids [B, n] (a rows group's arm on the lane axis)
            if self.uses_params and self.box.lanes is not None:
                # K15's stacked form (`K.predicate_eval` on 2-d ids)
                return self._run(idx, idx.shape[1], None, 0, env)
            flat = idx.reshape(-1)
            if env and env.get("bindings"):
                env = dict(env, bindings={a: r.reshape(-1) for a, r in env["bindings"].items()})
            return self._run(flat, flat.shape[0], None, 0, env).view(idx.shape)
        return self._run(idx, idx.shape[0], None, 0, env)

    def identity(
        self, n: int, n_valid: Optional[int] = None, base: int = 0, env: Optional[Dict] = None
    ) -> torch.Tensor:
        return self._run(None, n, n if n_valid is None else n_valid, base, env)

    def _run(self, ids, n, n_valid, base, env) -> torch.Tensor:
        env = env or {}
        depth = int(env.get("depth", 0))
        row = self.box.row(self.device) if self.uses_params else None
        tmps: List = []
        for prog in self.programs:
            out = K.predicate_eval(
                prog.prog, prog.buffers(env, tmps, n), ids, n, n_valid, base, depth, row,
                values=prog is not self.programs[-1],
            )
            tmps.append(out)
        return out


def valid_term() -> _Node:
    """``id >= 0``: padding slots are never admitted."""
    return _Node(O.VALID)


def class_term(v_class: torch.Tensor, table: torch.Tensor) -> _Node:
    """Class-closure membership of each slot's vertex: its class id looked
    up in the closure's bool table (padding reads False)."""
    return _Node(O.CLASS, srcs=(("tensor", v_class, None), ("tensor", table, None)))


def id_term(want: int) -> _Node:
    """``id == want`` (the ID instruction against a constant): a rid filter,
    ``want`` the RID's vertex index, or -2 when the RID is no snapshot
    vertex (it then matches nothing, padding's -1 included)."""
    return _Node(O.CMP, (K.CMP_OPS.index("="), 0, 0), kids=[_Node(O.ID), _const(int(want), True)])


def live_term(live: torch.Tensor, values: torch.Tensor) -> _Node:
    """``live[id]`` of a delta-maintained edge list (bool [E]): the mask read
    as the presence of a column whose values (``values``, any int32 [E] of
    the class) are never used."""
    col = _Node(O.COL, srcs=(("tensor", values, None), ("tensor", live, None)))
    return _Node(O.ISNULL, (1, 0, 0), kids=[col])


def compile_where(
    expr: A.Expression, scope: ColumnScope, params, allow_depth: bool = False
) -> _Node:
    """A WHERE AST as a mask term; raises Uncompilable outside the
    columnar subset."""
    return Compiler(scope, params, allow_depth=allow_depth).compile_bool(expr)


def compile_predicate(
    expr: A.Expression, scope: ColumnScope, params, allow_depth: bool = False
) -> Predicate:
    """Compile a WHERE AST into a `Predicate` (padding excluded);
    ``allow_depth`` admits ``$depth`` (the launch's ``env["depth"]``).

    Raises Uncompilable outside the columnar subset."""
    term = compile_where(expr, scope, params, allow_depth)
    return Predicate(
        [valid_term(), term],
        scope.device,
        box=params if isinstance(params, ParamBox) else None,
        uses_bindings=scope.uses_bindings,
    )
