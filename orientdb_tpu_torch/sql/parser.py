"""Port of `orientdb_tpu/sql/parser.py`: a copy with its imports pointed at
this package, so the port parses exactly what the reference parses.

Recursive-descent SQL parser.

Hand-written replacement for the reference's JavaCC-generated parser ([E]
core/.../sql/parser/OrientSql.jj → OStatement subclasses; SURVEY.md §2 "SQL
parser"). Produces the dataclass AST in `orientdb_tpu/sql/ast.py`.

Grammar coverage (the OrientDB 3.x surface exercised by the BASELINE configs
plus the core CRUD/DDL statements): SELECT, MATCH (arrow + method path
forms, NOT patterns, OPTIONAL, WHILE/maxDepth), TRAVERSE, INSERT, UPDATE,
DELETE (record/vertex/edge), CREATE CLASS/PROPERTY/INDEX/VERTEX/EDGE,
DROP CLASS/PROPERTY/INDEX, ALTER PROPERTY, EXPLAIN/PROFILE, BEGIN/COMMIT/
ROLLBACK, LIVE SELECT.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from orientdb_tpu_torch.sql import ast as A
from orientdb_tpu_torch.sql.lexer import Token, tokenize, LexError


class ParseError(Exception):
    def __init__(self, message: str, token: Optional[Token] = None) -> None:
        if token is not None:
            message = f"{message} (at {token.kind} {token.text!r}, pos {token.pos})"
        super().__init__(message)


# Comparison operators normalized to canonical spelling.
_CMP_OPS = {"=": "=", "==": "=", "!=": "!=", "<>": "!=", "<": "<", "<=": "<=",
            ">": ">", ">=": ">="}

_CMP_KEYWORDS = (
    "LIKE",
    "IN",
    "CONTAINS",
    "CONTAINSANY",
    "CONTAINSALL",
    "CONTAINSKEY",
    "CONTAINSVALUE",
    "CONTAINSTEXT",
    "MATCHES",
    "INSTANCEOF",
)


class Parser:
    def __init__(self, text: str) -> None:
        try:
            self.toks = tokenize(text)
        except LexError as e:
            raise ParseError(str(e)) from e
        self.i = 0
        self._param_counter = 0

    # -- token helpers -----------------------------------------------------

    def peek(self, offset: int = 0) -> Token:
        j = min(self.i + offset, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "EOF":
            self.i += 1
        return t

    def at_op(self, text: str, offset: int = 0) -> bool:
        t = self.peek(offset)
        return t.kind == "OP" and t.text == text

    def at_kw(self, word: str, offset: int = 0) -> bool:
        t = self.peek(offset)
        return t.kind == "IDENT" and t.text.upper() == word.upper()

    def eat_op(self, text: str) -> Token:
        if not self.at_op(text):
            raise ParseError(f"expected '{text}'", self.peek())
        return self.next()

    def eat_kw(self, word: str) -> Token:
        if not self.at_kw(word):
            raise ParseError(f"expected {word}", self.peek())
        return self.next()

    def try_op(self, text: str) -> bool:
        if self.at_op(text):
            self.next()
            return True
        return False

    def try_kw(self, word: str) -> bool:
        if self.at_kw(word):
            self.next()
            return True
        return False

    def eat_ident(self) -> str:
        t = self.peek()
        if t.kind != "IDENT":
            raise ParseError("expected identifier", t)
        self.next()
        return t.value  # type: ignore[return-value]

    def expect_eof(self) -> None:
        if self.peek().kind != "EOF":
            raise ParseError("unexpected trailing input", self.peek())

    # -- entry -------------------------------------------------------------

    def parse_statement(self) -> A.Statement:
        t = self.peek()
        if t.kind != "IDENT":
            raise ParseError("expected a statement keyword", t)
        kw = t.text.upper()
        if kw == "SELECT":
            return self.parse_select()
        if kw == "MATCH":
            return self.parse_match()
        if kw == "TRAVERSE":
            return self.parse_traverse()
        if kw == "INSERT":
            return self.parse_insert()
        if kw == "UPDATE":
            return self.parse_update()
        if kw == "DELETE":
            return self.parse_delete()
        if kw == "CREATE":
            return self.parse_create()
        if kw == "DROP":
            return self.parse_drop()
        if kw == "ALTER":
            return self.parse_alter()
        if kw in ("EXPLAIN", "PROFILE"):
            self.next()
            inner = self.parse_statement()
            return A.ExplainStatement(inner, profile=(kw == "PROFILE"))
        if kw == "BEGIN":
            self.next()
            return A.BeginStatement()
        if kw == "COMMIT":
            self.next()
            retries = None
            if self.try_kw("RETRY"):
                retries = int(self.next().value)  # type: ignore[arg-type]
            return A.CommitStatement(retries)
        if kw == "ROLLBACK":
            self.next()
            return A.RollbackStatement()
        if kw == "LIVE":
            self.next()
            sel = self.parse_select()
            assert isinstance(sel, A.SelectStatement)
            return A.LiveSelectStatement(sel)
        if kw == "TRUNCATE":
            return self.parse_truncate()
        if kw == "MOVE":
            return self.parse_move_vertex()
        if kw == "REBUILD":
            self.next()
            self.eat_kw("INDEX")
            if self.at_op("*"):
                self.next()
                return A.RebuildIndexStatement("*")
            name = self.eat_ident()
            while self.at_op("."):
                self.next()
                name += "." + self.eat_ident()
            return A.RebuildIndexStatement(name)
        if kw in ("GRANT", "REVOKE"):
            self.next()
            permission = self.eat_ident().upper()
            self.eat_kw("ON")
            resource = self.parse_resource_path()
            self.eat_kw("TO" if kw == "GRANT" else "FROM")
            role = self.eat_ident()
            if kw == "GRANT":
                return A.GrantStatement(permission, resource, role)
            return A.RevokeStatement(permission, resource, role)
        if kw == "FIND":
            self.next()
            self.eat_kw("REFERENCES")
            rt = self.next()
            if rt.kind != "RID":
                raise ParseError("expected RID after FIND REFERENCES", rt)
            classes: List[str] = []
            if self.at_op("["):
                self.next()
                classes = self.parse_name_list()
                self.eat_op("]")
            return A.FindReferencesStatement(rt.text, tuple(classes))
        raise ParseError(f"unsupported statement '{t.text}'", t)

    def parse_resource_path(self) -> str:
        """A dotted security resource name (database.class.P, server.*)."""
        parts = [self.eat_ident() if not self.at_op("*") else self._star()]
        while self.at_op("."):
            self.next()
            parts.append(
                self._star() if self.at_op("*") else self.eat_ident()
            )
        return ".".join(parts)

    def _star(self) -> str:
        self.eat_op("*")
        return "*"

    def parse_truncate(self) -> A.Statement:
        self.eat_kw("TRUNCATE")
        if self.try_kw("CLASS"):
            name = self.eat_ident()
            polymorphic = self.try_kw("POLYMORPHIC")
            unsafe = self.try_kw("UNSAFE")
            return A.TruncateClassStatement(name, polymorphic, unsafe)
        if self.try_kw("RECORD"):
            rids = []
            if self.at_op("["):
                self.next()
                while not self.at_op("]"):
                    rt = self.next()
                    if rt.kind != "RID":
                        raise ParseError("expected RID", rt)
                    rids.append(rt.text)
                    if self.at_op(","):
                        self.next()
                self.eat_op("]")
            else:
                rt = self.next()
                if rt.kind != "RID":
                    raise ParseError("expected RID", rt)
                rids.append(rt.text)
            return A.TruncateRecordStatement(tuple(rids))
        raise ParseError("unsupported TRUNCATE", self.peek())

    def parse_move_vertex(self) -> A.Statement:
        self.eat_kw("MOVE")
        self.eat_kw("VERTEX")
        t = self.peek()
        source: object
        if t.kind == "RID":
            self.next()
            source = t.text
        elif self.at_op("("):
            self.next()
            source = self.parse_select()
            self.eat_op(")")
        else:
            raise ParseError("expected RID or (subquery) in MOVE VERTEX", t)
        self.eat_kw("TO")
        self.eat_kw("CLASS")
        self.eat_op(":")
        return A.MoveVertexStatement(source, self.eat_ident())

    # -- SELECT ------------------------------------------------------------

    def parse_select(self) -> A.SelectStatement:
        self.eat_kw("SELECT")
        distinct = False
        if self.at_kw("DISTINCT") and not (
            self.at_op("(", 1)  # legacy distinct(expr) function call
        ):
            self.next()
            distinct = True
        projections: List[A.Projection] = []
        if not (self.at_kw("FROM") or self.peek().kind == "EOF"):
            projections = self.parse_projections()
        target = None
        if self.try_kw("FROM"):
            target = self.parse_target()
        lets: List[A.LetItem] = []
        if self.try_kw("LET"):
            lets = self.parse_lets()
        where = self.parse_expression() if self.try_kw("WHERE") else None
        group_by: Tuple[A.Expression, ...] = ()
        if self.at_kw("GROUP"):
            self.next()
            self.eat_kw("BY")
            group_by = tuple(self.parse_expr_list())
        order_by = self.parse_order_by()
        unwind: Tuple[str, ...] = ()
        if self.try_kw("UNWIND"):
            unwind = tuple(self.parse_name_list())
        skip, limit = self.parse_skip_limit()
        timeout = None
        if self.try_kw("TIMEOUT"):
            timeout = int(self.next().value)  # type: ignore[arg-type]
        return A.SelectStatement(
            projections=tuple(projections),
            target=target,
            where=where,
            group_by=group_by,
            order_by=order_by,
            unwind=unwind,
            skip=skip,
            limit=limit,
            lets=tuple(lets),
            timeout_ms=timeout,
            distinct=distinct,
        )

    def parse_projections(self) -> List[A.Projection]:
        out = []
        while True:
            expr = self.parse_expression()
            alias = None
            if self.try_kw("AS"):
                alias = self.eat_ident()
            out.append(A.Projection(expr, alias))
            if not self.try_op(","):
                break
        return out

    def parse_lets(self) -> List[A.LetItem]:
        out = []
        while True:
            t = self.peek()
            if t.kind == "VAR":
                self.next()
                name = t.value
            else:
                name = self.eat_ident()
            self.eat_op("=")
            if self.at_op("("):
                # could be a subquery or a parenthesized expression
                save = self.i
                self.next()
                if self.peek().kind == "IDENT" and self.peek().text.upper() in (
                    "SELECT",
                    "MATCH",
                    "TRAVERSE",
                ):
                    sub = self.parse_statement()
                    self.eat_op(")")
                    out.append(A.LetItem(name, sub))
                else:
                    self.i = save
                    out.append(A.LetItem(name, self.parse_expression()))
            else:
                out.append(A.LetItem(name, self.parse_expression()))
            if not self.try_op(","):
                break
        return out

    def parse_order_by(self) -> Tuple[A.OrderByItem, ...]:
        if not self.at_kw("ORDER"):
            return ()
        self.next()
        self.eat_kw("BY")
        items = []
        while True:
            expr = self.parse_expression()
            asc = True
            if self.try_kw("DESC"):
                asc = False
            elif self.try_kw("ASC"):
                asc = True
            items.append(A.OrderByItem(expr, asc))
            if not self.try_op(","):
                break
        return tuple(items)

    def parse_skip_limit(self):
        skip = limit = None
        # OrientDB allows SKIP/LIMIT in either order; parse_unary admits the
        # idiomatic `LIMIT -1` (unlimited)
        for _ in range(2):
            if self.try_kw("SKIP"):
                skip = self.parse_unary()
            elif self.try_kw("LIMIT"):
                limit = self.parse_unary()
        return skip, limit

    def parse_expr_list(self) -> List[A.Expression]:
        out = [self.parse_expression()]
        while self.try_op(","):
            out.append(self.parse_expression())
        return out

    def parse_name_list(self) -> List[str]:
        out = [self.eat_ident()]
        while self.try_op(","):
            out.append(self.eat_ident())
        return out

    # -- FROM targets ------------------------------------------------------

    def parse_target(self) -> A.Target:
        t = self.peek()
        if t.kind == "RID":
            self.next()
            return A.RidTarget((A.RIDLiteral(*t.value),))
        if self.at_op("["):
            self.next()
            rids = []
            while not self.at_op("]"):
                rt = self.next()
                if rt.kind != "RID":
                    raise ParseError("expected RID in list target", rt)
                rids.append(A.RIDLiteral(*rt.value))
                self.try_op(",")
            self.eat_op("]")
            return A.RidTarget(tuple(rids))
        if self.at_op("("):
            self.next()
            if self.peek().kind == "IDENT" and self.peek().text.upper() in (
                "SELECT",
                "MATCH",
                "TRAVERSE",
            ):
                sub = self.parse_statement()
                self.eat_op(")")
                return A.SubQueryTarget(sub)
            expr = self.parse_expression()
            self.eat_op(")")
            return A.ExpressionTarget(expr)
        if t.kind == "VAR":
            self.next()
            return A.ExpressionTarget(A.ContextVar(t.value))
        if self.at_op(":"):
            self.next()
            return A.ExpressionTarget(A.Parameter(name=self.eat_ident()))
        if t.kind == "IDENT":
            word = t.text.upper()
            if word == "CLUSTER" and self.at_op(":", 1):
                self.next()
                self.next()
                nt = self.next()
                return A.ClusterTarget(
                    nt.value if nt.kind in ("IDENT", "STRING") else int(nt.value)
                )
            if word == "INDEX" and self.at_op(":", 1):
                self.next()
                self.next()
                # index names may contain dots: Class.field
                name = self.eat_ident()
                while self.at_op(".") :
                    self.next()
                    name += "." + self.eat_ident()
                return A.IndexTarget(name)
            name = self.eat_ident()
            return A.ClassTarget(name)
        raise ParseError("expected query target", t)

    # -- MATCH -------------------------------------------------------------

    def parse_match(self) -> A.MatchStatement:
        self.eat_kw("MATCH")
        paths = [self.parse_match_path()]
        while self.try_op(","):
            paths.append(self.parse_match_path())
        self.eat_kw("RETURN")
        distinct = self.try_kw("DISTINCT")
        returns = self.parse_projections()
        group_by: Tuple[A.Expression, ...] = ()
        if self.at_kw("GROUP"):
            self.next()
            self.eat_kw("BY")
            group_by = tuple(self.parse_expr_list())
        order_by = self.parse_order_by()
        unwind: Tuple[str, ...] = ()
        if self.try_kw("UNWIND"):
            unwind = tuple(self.parse_name_list())
        skip, limit = self.parse_skip_limit()
        return A.MatchStatement(
            paths=tuple(paths),
            returns=tuple(returns),
            distinct=distinct,
            group_by=group_by,
            order_by=order_by,
            unwind=unwind,
            skip=skip,
            limit=limit,
        )

    def parse_match_path(self) -> A.MatchPath:
        negated = self.try_kw("NOT")
        first = self.parse_match_filter()
        items = []
        while True:
            item = self.try_parse_path_item()
            if item is None:
                break
            items.append(item)
        return A.MatchPath(first, tuple(items), negated=negated)

    def try_parse_path_item(self) -> Optional[A.MatchPathItem]:
        # arrow forms:  -EC->{..}   <-EC-{..}   -EC-{..}   -->{..}  <--{..}  --{..}
        # method forms: .out('EC'){..}  .outE('EC'){..}.inV(){..}  etc.
        if self.at_op("-"):
            self.next()
            edge_classes, edge_filter = self.parse_arrow_middle()
            if self.peek().kind == "ARROW":
                self.next()
                direction = "out"
            elif self.at_op("-"):
                self.next()
                direction = "both"
            else:
                raise ParseError("expected '->' or '-' to close match arrow", self.peek())
            target = self.parse_match_filter()
            return A.MatchPathItem(direction, edge_classes, target, edge_filter)
        if self.at_op("<") and self.at_op("-", 1):
            self.next()
            self.next()
            edge_classes, edge_filter = self.parse_arrow_middle()
            self.eat_op("-")
            target = self.parse_match_filter()
            return A.MatchPathItem("in", edge_classes, target, edge_filter)
        if self.at_op("."):
            self.next()
            method = self.eat_ident()
            m = method.lower()
            valid = {"out": "out", "in": "in", "both": "both",
                     "oute": "out", "ine": "in", "bothe": "both"}
            if m not in valid and m not in ("outv", "inv", "bothv"):
                raise ParseError(f"unsupported match method '{method}'", self.peek())
            self.eat_op("(")
            classes = []
            while not self.at_op(")"):
                ct = self.next()
                if ct.kind not in ("STRING", "IDENT"):
                    raise ParseError("expected edge class name", ct)
                classes.append(ct.value)
                self.try_op(",")
            self.eat_op(")")
            mid_filter = None
            if self.at_op("{"):
                mid_filter = self.parse_match_filter()
            if m in ("oute", "ine", "bothe"):
                # edge-step form: .outE('EC'){edge filter}.inV(){vertex filter}
                edge_filter = mid_filter
                if self.at_op("."):
                    self.next()
                    vm = self.eat_ident().lower()
                    if vm not in ("inv", "outv", "bothv"):
                        raise ParseError(f"expected inV()/outV() after {method}()", self.peek())
                    self.eat_op("(")
                    self.eat_op(")")
                    target = (
                        self.parse_match_filter() if self.at_op("{") else A.MatchFilter()
                    )
                else:
                    # bare .outE('EC'){as: e}: the *edge* is the target binding
                    return A.MatchPathItem(
                        valid[m],
                        tuple(classes),
                        mid_filter or A.MatchFilter(),
                        None,
                        method=method,
                    )
                return A.MatchPathItem(
                    valid[m], tuple(classes), target, edge_filter, method=method
                )
            if m in ("outv", "inv", "bothv"):
                # standalone .inV()/.outV() after a bare edge binding: moves
                # from a bound edge alias to its endpoint vertex
                target = mid_filter if mid_filter is not None else A.MatchFilter()
                return A.MatchPathItem(m, (), target, None, method=method)
            target = mid_filter if mid_filter is not None else A.MatchFilter()
            return A.MatchPathItem(valid[m], tuple(classes), target, None, method=method)
        return None

    def parse_arrow_middle(self):
        """Between the dashes of an arrow: optional edge class name and/or
        `{...}` edge filter braces."""
        edge_classes: Tuple[str, ...] = ()
        edge_filter = None
        if self.peek().kind == "IDENT":
            edge_classes = (self.eat_ident(),)
        if self.at_op("{"):
            edge_filter = self.parse_match_filter()
            if edge_filter.class_name and not edge_classes:
                edge_classes = (edge_filter.class_name,)
        return edge_classes, edge_filter

    def parse_match_filter(self) -> A.MatchFilter:
        self.eat_op("{")
        alias = class_name = rid = where = while_cond = None
        max_depth = None
        optional = False
        depth_alias = path_alias = None
        while not self.at_op("}"):
            key = self.eat_ident().lower()
            self.eat_op(":")
            if key == "class":
                t = self.next()
                if t.kind not in ("IDENT", "STRING"):
                    raise ParseError("expected class name", t)
                class_name = t.value
            elif key == "as":
                alias = self.eat_ident()
            elif key == "rid":
                t = self.next()
                if t.kind != "RID":
                    raise ParseError("expected RID", t)
                rid = A.RIDLiteral(*t.value)
            elif key == "where":
                self.eat_op("(")
                where = self.parse_expression()
                self.eat_op(")")
            elif key == "while":
                self.eat_op("(")
                while_cond = self.parse_expression()
                self.eat_op(")")
            elif key == "maxdepth":
                t = self.next()
                if t.kind != "NUMBER":
                    raise ParseError("expected number for maxDepth", t)
                max_depth = int(t.value)
            elif key == "optional":
                t = self.next()
                optional = str(t.value).lower() == "true"
            elif key == "depthalias":
                depth_alias = self.eat_ident()
            elif key == "pathalias":
                path_alias = self.eat_ident()
            else:
                raise ParseError(f"unknown match filter key '{key}'", self.peek())
            self.try_op(",")
        self.eat_op("}")
        return A.MatchFilter(
            alias=alias,
            class_name=class_name,
            rid=rid,
            where=where,
            while_cond=while_cond,
            max_depth=max_depth,
            optional=optional,
            depth_alias=depth_alias,
            path_alias=path_alias,
        )

    # -- TRAVERSE ----------------------------------------------------------

    def parse_traverse(self) -> A.TraverseStatement:
        self.eat_kw("TRAVERSE")
        fields: List[A.Expression] = []
        if not self.at_kw("FROM"):
            fields = self.parse_expr_list()
        self.eat_kw("FROM")
        target = self.parse_target()
        max_depth = None
        while_cond = None
        limit = None
        strategy = "DEPTH_FIRST"
        while True:
            if self.try_kw("MAXDEPTH"):
                max_depth = int(self.next().value)  # type: ignore[arg-type]
            elif self.try_kw("WHILE"):
                while_cond = self.parse_expression()
            elif self.try_kw("LIMIT"):
                limit = self.parse_primary()
            elif self.try_kw("STRATEGY"):
                strategy = self.eat_ident().upper()
                if strategy not in ("DEPTH_FIRST", "BREADTH_FIRST"):
                    raise ParseError(f"unknown strategy {strategy}")
            else:
                break
        return A.TraverseStatement(
            fields=tuple(fields),
            target=target,
            max_depth=max_depth,
            while_cond=while_cond,
            limit=limit,
            strategy=strategy,
        )

    # -- INSERT ------------------------------------------------------------

    def parse_insert(self) -> A.InsertStatement:
        self.eat_kw("INSERT")
        self.eat_kw("INTO")
        cluster = None
        class_name = None
        if self.at_kw("CLUSTER") and self.at_op(":", 1):
            self.next()
            self.next()
            cluster = self.eat_ident()
        else:
            class_name = self.eat_ident()
        set_fields: Tuple[Tuple[str, A.Expression], ...] = ()
        content: Optional[A.Expression] = None
        from_select: Optional[A.Statement] = None
        if self.try_kw("SET"):
            set_fields = tuple(self.parse_set_items())
        elif self.try_kw("CONTENT"):
            content = self.parse_expression()
        elif self.at_op("("):
            self.next()
            names = self.parse_name_list()
            self.eat_op(")")
            self.eat_kw("VALUES")
            rows: List[Tuple[Tuple[str, A.Expression], ...]] = []
            while True:
                self.eat_op("(")
                vals = self.parse_expr_list()
                self.eat_op(")")
                if len(vals) != len(names):
                    raise ParseError("VALUES arity mismatch")
                rows.append(tuple(zip(names, vals)))
                if not self.try_op(","):
                    break
            if len(rows) == 1:
                set_fields = rows[0]
            else:
                # multi-row insert: encode as content list of maps
                content = A.ListExpr(
                    tuple(A.MapExpr(tuple((k, v) for k, v in row)) for row in rows)
                )
        elif self.try_kw("FROM"):
            from_select = self.parse_statement()
        else:
            raise ParseError(
                "expected SET / CONTENT / VALUES / FROM in INSERT", self.peek()
            )
        return_expr: Optional[A.Expression] = None
        if self.try_kw("RETURN"):
            return_expr = self.parse_expression()
        return A.InsertStatement(
            class_name,
            cluster,
            set_fields=set_fields,
            content=content,
            from_select=from_select,
            return_expr=return_expr,
        )

    def parse_set_items(self) -> List[Tuple[str, A.Expression]]:
        out = []
        while True:
            name = self.eat_ident()
            self.eat_op("=")
            out.append((name, self.parse_expression()))
            if not self.try_op(","):
                break
        return out

    # -- UPDATE ------------------------------------------------------------

    def parse_update(self) -> A.UpdateStatement:
        self.eat_kw("UPDATE")
        target = self.parse_target()
        ops: List[A.UpdateOp] = []
        while True:
            if self.try_kw("SET"):
                ops.append(A.UpdateOp("SET", tuple(self.parse_set_items())))
            elif self.try_kw("INCREMENT"):
                ops.append(A.UpdateOp("INCREMENT", tuple(self.parse_set_items())))
            elif self.try_kw("REMOVE"):
                items = []
                while True:
                    name = self.eat_ident()
                    if self.try_op("="):
                        items.append((name, self.parse_expression()))
                    else:
                        items.append((name, A.Literal(None)))
                    if not self.try_op(","):
                        break
                ops.append(A.UpdateOp("REMOVE", tuple(items)))
            elif self.try_kw("CONTENT"):
                ops.append(A.UpdateOp("CONTENT", (("", self.parse_expression()),)))
            elif self.try_kw("MERGE"):
                ops.append(A.UpdateOp("MERGE", (("", self.parse_expression()),)))
            else:
                break
        upsert = self.try_kw("UPSERT")
        return_mode = None
        if self.try_kw("RETURN"):
            return_mode = self.eat_ident().upper()
            if return_mode not in ("COUNT", "BEFORE", "AFTER"):
                raise ParseError(f"unknown UPDATE RETURN mode {return_mode}")
        where = self.parse_expression() if self.try_kw("WHERE") else None
        _, limit = self.parse_skip_limit()
        return A.UpdateStatement(
            target=target,
            ops=tuple(ops),
            upsert=upsert,
            where=where,
            limit=limit,
            return_mode=return_mode,
        )

    # -- DELETE ------------------------------------------------------------

    def parse_delete(self) -> A.DeleteStatement:
        self.eat_kw("DELETE")
        kind = "RECORD"
        edge_from = edge_to = None
        if self.try_kw("VERTEX"):
            kind = "VERTEX"
            target = self.parse_target()
        elif self.try_kw("EDGE"):
            kind = "EDGE"
            target: A.Target = A.ClassTarget("E")
            if self.peek().kind == "IDENT" and not (
                self.at_kw("FROM") or self.at_kw("WHERE") or self.at_kw("LIMIT")
            ):
                target = A.ClassTarget(self.eat_ident())
            elif self.peek().kind == "RID":
                t = self.next()
                target = A.RidTarget((A.RIDLiteral(*t.value),))
            if self.try_kw("FROM"):
                edge_from = self.parse_expression()
                if self.try_kw("TO"):
                    edge_to = self.parse_expression()
        else:
            self.eat_kw("FROM")
            target = self.parse_target()
        where = self.parse_expression() if self.try_kw("WHERE") else None
        _, limit = self.parse_skip_limit()
        return A.DeleteStatement(
            target=target,
            where=where,
            limit=limit,
            kind=kind,
            edge_from=edge_from,
            edge_to=edge_to,
        )

    # -- CREATE / DROP / ALTER --------------------------------------------

    def parse_create(self) -> A.Statement:
        self.eat_kw("CREATE")
        if self.try_kw("CLASS"):
            name = self.eat_ident()
            if_not_exists = False
            if self.try_kw("IF"):
                self.eat_kw("NOT")
                self.eat_kw("EXISTS")
                if_not_exists = True
            sups: List[str] = []
            if self.try_kw("EXTENDS"):
                sups = self.parse_name_list()
            abstract = self.try_kw("ABSTRACT")
            return A.CreateClassStatement(
                name, tuple(sups), abstract=abstract, if_not_exists=if_not_exists
            )
        if self.try_kw("PROPERTY"):
            cls = self.eat_ident()
            self.eat_op(".")
            prop = self.eat_ident()
            if_not_exists = False
            if self.try_kw("IF"):
                self.eat_kw("NOT")
                self.eat_kw("EXISTS")
                if_not_exists = True
            ptype = self.eat_ident().upper()
            linked = None
            if self.peek().kind == "IDENT" and not self.at_kw("UNSAFE"):
                linked = self.eat_ident()
            return A.CreatePropertyStatement(cls, prop, ptype, linked, if_not_exists)
        if self.try_kw("INDEX"):
            name = self.eat_ident()
            cls = None
            fields: Tuple[str, ...] = ()
            if self.at_op("."):
                self.next()
                field = self.eat_ident()
                cls = name
                name = f"{cls}.{field}"
                fields = (field,)
            if self.try_kw("ON"):
                cls = self.eat_ident()
                self.eat_op("(")
                fields = tuple(self.parse_name_list())
                self.eat_op(")")
            itype = self.eat_ident().upper()
            while self.peek().kind == "IDENT" and self.peek().text.upper() in (
                "HASH_INDEX",
                "INDEX",
            ):
                itype += "_" + self.eat_ident().upper()
            # [E] Lucene module's forms: ENGINE LUCENE and METADATA {...}
            engine = None
            metadata = None
            if self.peek().kind == "IDENT" and self.peek().text.upper() == "ENGINE":
                self.next()
                engine = self.eat_ident().upper()
            if self.peek().kind == "IDENT" and self.peek().text.upper() == "METADATA":
                self.next()
                metadata = self.parse_expression()
            return A.CreateIndexStatement(
                name, cls, fields, itype, engine=engine, metadata=metadata
            )
        if self.try_kw("VERTEX"):
            cls = self.eat_ident() if self.peek().kind == "IDENT" and not (
                self.at_kw("SET") or self.at_kw("CONTENT")
            ) else "V"
            if self.try_kw("SET"):
                return A.CreateVertexStatement(cls, tuple(self.parse_set_items()))
            if self.try_kw("CONTENT"):
                return A.CreateVertexStatement(cls, content=self.parse_expression())
            return A.CreateVertexStatement(cls)
        if self.try_kw("EDGE"):
            cls = self.eat_ident()
            self.eat_kw("FROM")
            from_expr = self.parse_from_to_operand()
            self.eat_kw("TO")
            to_expr = self.parse_from_to_operand()
            if self.try_kw("SET"):
                return A.CreateEdgeStatement(
                    cls, from_expr, to_expr, tuple(self.parse_set_items())
                )
            if self.try_kw("CONTENT"):
                return A.CreateEdgeStatement(
                    cls, from_expr, to_expr, content=self.parse_expression()
                )
            return A.CreateEdgeStatement(cls, from_expr, to_expr)
        if self.try_kw("SEQUENCE"):
            name = self.eat_ident()
            seq_type, start, increment, cache = "ORDERED", 0, 1, 20
            while True:
                if self.try_kw("TYPE"):
                    seq_type = self.eat_ident().upper()
                elif self.try_kw("START"):
                    start = self._int_value()
                elif self.try_kw("INCREMENT"):
                    increment = self._int_value()
                elif self.try_kw("CACHE"):
                    cache = self._int_value()
                else:
                    break
            return A.CreateSequenceStatement(name, seq_type, start, increment, cache)
        if self.try_kw("FUNCTION"):
            name = self.eat_ident()
            t = self.next()
            if t.kind != "STRING":
                raise ParseError("expected quoted function body", t)
            body = t.value
            parameters: Tuple[str, ...] = ()
            idempotent = True
            language = "sql"
            while True:
                if self.try_kw("PARAMETERS"):
                    self.eat_op("[")
                    parameters = tuple(self.parse_name_list())
                    self.eat_op("]")
                elif self.try_kw("IDEMPOTENT"):
                    v = self.next()
                    idempotent = str(v.value).lower() == "true"
                elif self.try_kw("LANGUAGE"):
                    language = self.eat_ident().lower()
                else:
                    break
            return A.CreateFunctionStatement(name, body, parameters, idempotent, language)
        if self.try_kw("USER"):
            name = self.eat_ident()
            self.eat_kw("IDENTIFIED")
            self.eat_kw("BY")
            t = self.next()
            if t.kind not in ("STRING", "IDENT"):
                raise ParseError("expected password", t)
            password = str(t.value)
            roles: List[str] = []
            if self.try_kw("ROLE"):
                if self.at_op("["):
                    self.next()
                    roles = self.parse_name_list()
                    self.eat_op("]")
                else:
                    roles = [self.eat_ident()]
            return A.CreateUserStatement(name, password, tuple(roles))
        raise ParseError("unsupported CREATE", self.peek())

    def _int_value(self) -> int:
        neg = self.try_op("-")
        t = self.next()
        if t.kind != "NUMBER":
            raise ParseError("expected number", t)
        v = int(t.value)
        return -v if neg else v

    def parse_from_to_operand(self) -> A.Expression:
        """CREATE EDGE FROM/TO operand: RID, (subquery), list, or param."""
        if self.at_op("("):
            self.next()
            if self.peek().kind == "IDENT" and self.peek().text.upper() in (
                "SELECT",
                "MATCH",
                "TRAVERSE",
            ):
                sub = self.parse_statement()
                self.eat_op(")")
                # wrap subquery as expression via a function marker
                return A.FunctionCall("$subquery", (A.Literal(sub),))
            expr = self.parse_expression()
            self.eat_op(")")
            return expr
        return self.parse_expression()

    def parse_drop(self) -> A.Statement:
        self.eat_kw("DROP")
        if self.try_kw("CLASS"):
            name = self.eat_ident()
            if_exists = False
            if self.try_kw("IF"):
                self.eat_kw("EXISTS")
                if_exists = True
            return A.DropClassStatement(name, if_exists)
        if self.try_kw("PROPERTY"):
            cls = self.eat_ident()
            self.eat_op(".")
            return A.DropPropertyStatement(cls, self.eat_ident())
        if self.try_kw("INDEX"):
            name = self.eat_ident()
            while self.at_op("."):
                self.next()
                name += "." + self.eat_ident()
            return A.DropIndexStatement(name)
        if self.try_kw("SEQUENCE"):
            return A.DropSequenceStatement(self.eat_ident())
        if self.try_kw("FUNCTION"):
            return A.DropFunctionStatement(self.eat_ident())
        if self.try_kw("USER"):
            return A.DropUserStatement(self.eat_ident())
        raise ParseError("unsupported DROP", self.peek())

    def parse_alter(self) -> A.Statement:
        self.eat_kw("ALTER")
        if self.try_kw("SEQUENCE"):
            name = self.eat_ident()
            start = increment = cache = None
            while True:
                if self.try_kw("START"):
                    start = self._int_value()
                elif self.try_kw("INCREMENT"):
                    increment = self._int_value()
                elif self.try_kw("CACHE"):
                    cache = self._int_value()
                else:
                    break
            return A.AlterSequenceStatement(name, start, increment, cache)
        if self.try_kw("CLASS"):
            cls = self.eat_ident()
            attr = self.eat_ident().upper()
            if attr == "SUPERCLASS":
                sign = "+"
                if self.at_op("+") or self.at_op("-"):
                    sign = self.next().text
                return A.AlterClassStatement(
                    cls, attr, (sign, self.eat_ident())
                )
            if attr in ("STRICTMODE", "ABSTRACT"):
                v = self.eat_ident().upper()
                if v not in ("TRUE", "FALSE"):
                    raise ParseError(
                        f"expected TRUE/FALSE for {attr}", self.peek()
                    )
                return A.AlterClassStatement(cls, attr, v == "TRUE")
            if attr == "NAME":
                t = self.next()
                if t.kind not in ("IDENT", "STRING"):
                    raise ParseError("expected new class name", t)
                return A.AlterClassStatement(cls, attr, t.value)
            if attr == "ADDCLUSTER":
                if self.peek().kind == "NUMBER":
                    # the reference accepted numeric cluster ids; here
                    # ids are engine-assigned — reject with the reason
                    # instead of a trailing-token ParseError at EOF
                    raise ParseError(
                        "ADDCLUSTER takes a cluster NAME: cluster ids "
                        "are assigned automatically",
                        self.peek(),
                    )
                name = (
                    self.eat_ident()
                    if self.peek().kind == "IDENT"
                    else None
                )
                return A.AlterClassStatement(cls, attr, name)
            raise ParseError(f"unsupported ALTER CLASS attribute {attr}")
        self.eat_kw("PROPERTY")
        cls = self.eat_ident()
        self.eat_op(".")
        prop = self.eat_ident()
        attr = self.eat_ident().upper()
        value = self.parse_expression()
        return A.AlterPropertyStatement(cls, prop, attr, value)

    # -- expressions (precedence climbing) ---------------------------------

    def parse_expression(self) -> A.Expression:
        return self.parse_or()

    def parse_or(self) -> A.Expression:
        left = self.parse_and()
        while self.at_kw("OR"):
            self.next()
            left = A.Binary("OR", left, self.parse_and())
        return left

    def parse_and(self) -> A.Expression:
        left = self.parse_not()
        while self.at_kw("AND"):
            self.next()
            left = A.Binary("AND", left, self.parse_not())
        return left

    def parse_not(self) -> A.Expression:
        if self.at_kw("NOT"):
            self.next()
            return A.Unary("NOT", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> A.Expression:
        left = self.parse_additive()
        t = self.peek()
        if t.kind == "OP" and t.text in _CMP_OPS:
            self.next()
            return A.Binary(_CMP_OPS[t.text], left, self.parse_additive())
        if t.kind == "IDENT":
            kw = t.text.upper()
            if kw in _CMP_KEYWORDS:
                self.next()
                return A.Binary(kw, left, self.parse_additive())
            if kw == "BETWEEN":
                self.next()
                low = self.parse_additive()
                self.eat_kw("AND")
                high = self.parse_additive()
                return A.Between(left, low, high)
            if kw == "IS":
                self.next()
                negated = self.try_kw("NOT")
                if self.try_kw("NULL"):
                    return A.IsNull(left, negated)
                if self.try_kw("DEFINED"):
                    return A.IsDefined(left, negated)
                raise ParseError("expected NULL or DEFINED after IS", self.peek())
            if kw == "NOT":
                # NOT IN / NOT LIKE / NOT CONTAINS... / NOT BETWEEN
                nxt = self.peek(1)
                if nxt.kind == "IDENT" and nxt.text.upper() in _CMP_KEYWORDS:
                    self.next()
                    op = self.next().text.upper()
                    return A.Unary("NOT", A.Binary(op, left, self.parse_additive()))
                if nxt.kind == "IDENT" and nxt.text.upper() == "BETWEEN":
                    self.next()
                    self.next()
                    low = self.parse_additive()
                    self.eat_kw("AND")
                    high = self.parse_additive()
                    return A.Unary("NOT", A.Between(left, low, high))
        return left

    def parse_additive(self) -> A.Expression:
        left = self.parse_multiplicative()
        while True:
            if self.at_op("+"):
                self.next()
                left = A.Binary("+", left, self.parse_multiplicative())
            elif self.at_op("-"):
                self.next()
                left = A.Binary("-", left, self.parse_multiplicative())
            elif self.at_op("||"):
                self.next()
                left = A.Binary("||", left, self.parse_multiplicative())
            else:
                return left

    def parse_multiplicative(self) -> A.Expression:
        left = self.parse_unary()
        while True:
            if self.at_op("*"):
                self.next()
                left = A.Binary("*", left, self.parse_unary())
            elif self.at_op("/"):
                self.next()
                left = A.Binary("/", left, self.parse_unary())
            elif self.at_op("%"):
                self.next()
                left = A.Binary("%", left, self.parse_unary())
            else:
                return left

    def parse_unary(self) -> A.Expression:
        if self.at_op("-"):
            self.next()
            return A.Unary("-", self.parse_unary())
        if self.at_op("+"):
            self.next()
            return A.Unary("+", self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self) -> A.Expression:
        expr = self.parse_primary()
        while True:
            if self.at_op("."):
                self.next()
                name = self.eat_ident()
                if self.at_op("("):
                    self.next()
                    args = [] if self.at_op(")") else self.parse_expr_list()
                    self.eat_op(")")
                    expr = A.MethodCall(expr, name, tuple(args))
                else:
                    expr = A.FieldAccess(expr, name)
            elif self.at_op("["):
                self.next()
                idx = self.parse_expression()
                self.eat_op("]")
                expr = A.IndexAccess(expr, idx)
            else:
                return expr

    def parse_primary(self) -> A.Expression:
        t = self.peek()
        if t.kind == "NUMBER":
            self.next()
            return A.Literal(t.value)
        if t.kind == "STRING":
            self.next()
            return A.Literal(t.value)
        if t.kind == "RID":
            self.next()
            return A.RIDLiteral(*t.value)
        if t.kind == "VAR":
            self.next()
            return A.ContextVar(t.value)
        if self.at_op("?"):
            self.next()
            p = A.Parameter(index=self._param_counter)
            self._param_counter += 1
            return p
        if self.at_op(":"):
            self.next()
            return A.Parameter(name=self.eat_ident())
        if self.at_op("("):
            self.next()
            if self.peek().kind == "IDENT" and self.peek().text.upper() in (
                "SELECT",
                "MATCH",
                "TRAVERSE",
            ):
                sub = self.parse_statement()
                self.eat_op(")")
                return A.FunctionCall("$subquery", (A.Literal(sub),))
            expr = self.parse_expression()
            self.eat_op(")")
            return expr
        if self.at_op("["):
            self.next()
            items = [] if self.at_op("]") else self.parse_expr_list()
            self.eat_op("]")
            return A.ListExpr(tuple(items))
        if self.at_op("{"):
            self.next()
            pairs = []
            while not self.at_op("}"):
                kt = self.next()
                if kt.kind not in ("IDENT", "STRING"):
                    raise ParseError("expected map key", kt)
                self.eat_op(":")
                pairs.append((kt.value, self.parse_expression()))
                self.try_op(",")
            self.eat_op("}")
            return A.MapExpr(tuple(pairs))
        if self.at_op("*"):
            self.next()
            return A.Star()
        if t.kind == "IDENT":
            word = t.text.upper()
            if word == "TRUE":
                self.next()
                return A.Literal(True)
            if word == "FALSE":
                self.next()
                return A.Literal(False)
            if word == "NULL":
                self.next()
                return A.Literal(None)
            name = self.eat_ident()
            if self.at_op("("):
                self.next()
                if self.try_op("*"):
                    self.eat_op(")")
                    return A.FunctionCall(name.lower(), (A.Star(),))
                args = [] if self.at_op(")") else self.parse_expr_list()
                self.eat_op(")")
                return A.FunctionCall(name.lower(), tuple(args))
            return A.Identifier(name)
        raise ParseError("expected expression", t)


def parse(text: str) -> A.Statement:
    """Parse one SQL statement (analog of [E] OStatementCache.parse)."""
    p = Parser(text)
    stmt = p.parse_statement()
    p.expect_eof()
    return stmt
