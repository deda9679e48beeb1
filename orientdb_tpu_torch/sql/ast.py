"""Port of `orientdb_tpu/sql/ast.py`: a copy with its imports pointed at
this package, so the port parses exactly what the reference parses.

SQL abstract syntax tree.

Analog of OrientDB's parser AST ([E] core/.../sql/parser/ — one class per
JavaCC production: OStatement, OSelectStatement, OMatchStatement,
OTraverseStatement, OWhereClause, OExpression…; SURVEY.md §2 "SQL parser").
The reference generates ~80k LoC from a JavaCC grammar; here the AST is a
compact set of dataclasses produced by a hand-written recursive-descent
parser (`orientdb_tpu/sql/parser.py`) — pure data, consumed by BOTH the
pure-Python oracle interpreter (`exec/oracle.py`) and the TPU MATCH compiler
(`exec/tpu_engine.py`), which is what keeps the two engines parity-testable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


class Expression:
    """Base class ([E] OExpression)."""

    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class Literal(Expression):
    value: object


@dataclasses.dataclass(frozen=True)
class Star(Expression):
    """`*` in projections / count(*)."""


@dataclasses.dataclass(frozen=True)
class Identifier(Expression):
    """A bare name: field, alias, or class, resolved at eval time."""

    name: str


@dataclasses.dataclass(frozen=True)
class Parameter(Expression):
    """Named `:name` or positional `?` query parameter."""

    name: Optional[str] = None
    index: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ContextVar(Expression):
    """`$depth`, `$path`, `$current`, `$parent`, `$matched`, `$matches`…"""

    name: str  # without the leading $


@dataclasses.dataclass(frozen=True)
class RIDLiteral(Expression):
    cluster: int
    position: int


@dataclasses.dataclass(frozen=True)
class ListExpr(Expression):
    items: Tuple[Expression, ...]


@dataclasses.dataclass(frozen=True)
class MapExpr(Expression):
    pairs: Tuple[Tuple[str, Expression], ...]


@dataclasses.dataclass(frozen=True)
class FieldAccess(Expression):
    """`base.name` (document field / result property / map key)."""

    base: Expression
    name: str


@dataclasses.dataclass(frozen=True)
class IndexAccess(Expression):
    """`base[index]`."""

    base: Expression
    index: Expression


@dataclasses.dataclass(frozen=True)
class MethodCall(Expression):
    """`base.name(args…)` — graph methods out()/in()/both()/outE()… and
    item methods size()/toLowerCase()/asString()…"""

    base: Expression
    name: str
    args: Tuple[Expression, ...]


@dataclasses.dataclass(frozen=True)
class FunctionCall(Expression):
    """Top-level `name(args…)`: aggregates and SQL functions."""

    name: str
    args: Tuple[Expression, ...]


@dataclasses.dataclass(frozen=True)
class Unary(Expression):
    op: str  # 'NOT' | '-' | '+'
    expr: Expression


@dataclasses.dataclass(frozen=True)
class Binary(Expression):
    """Binary operator. op is normalized upper-case: AND OR = != < <= > >=
    + - * / % LIKE IN CONTAINS CONTAINSANY CONTAINSALL CONTAINSKEY
    CONTAINSVALUE CONTAINSTEXT MATCHES INSTANCEOF."""

    op: str
    left: Expression
    right: Expression


@dataclasses.dataclass(frozen=True)
class Between(Expression):
    expr: Expression
    low: Expression
    high: Expression


@dataclasses.dataclass(frozen=True)
class IsNull(Expression):
    expr: Expression
    negated: bool  # IS NOT NULL


@dataclasses.dataclass(frozen=True)
class IsDefined(Expression):
    expr: Expression
    negated: bool  # IS NOT DEFINED


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------


class Statement:
    """Base class ([E] OStatement)."""

    __slots__ = ()

    #: idempotent statements may run through Database.query()
    is_idempotent = False


@dataclasses.dataclass(frozen=True)
class Projection:
    expr: Expression
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class OrderByItem:
    expr: Expression
    ascending: bool = True


# -- FROM targets -----------------------------------------------------------


class Target:
    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class ClassTarget(Target):
    name: str
    polymorphic: bool = True  # FROM Class; FROM CLUSTER:x is separate


@dataclasses.dataclass(frozen=True)
class ClusterTarget(Target):
    name_or_id: object  # cluster name (str) or id (int)


@dataclasses.dataclass(frozen=True)
class RidTarget(Target):
    rids: Tuple[RIDLiteral, ...]


@dataclasses.dataclass(frozen=True)
class IndexTarget(Target):
    """FROM INDEX:name — scans index entries as {key, rid} rows."""

    name: str


@dataclasses.dataclass(frozen=True)
class SubQueryTarget(Target):
    query: "Statement"


@dataclasses.dataclass(frozen=True)
class ExpressionTarget(Target):
    """FROM (expression) producing records, e.g. a parameter of RIDs."""

    expr: Expression


# -- SELECT -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LetItem:
    name: str  # without the $
    value: object  # Expression or Statement (subquery)


@dataclasses.dataclass(frozen=True)
class SelectStatement(Statement):
    projections: Tuple[Projection, ...]  # empty => select whole record
    target: Optional[Target]
    where: Optional[Expression] = None
    group_by: Tuple[Expression, ...] = ()
    order_by: Tuple[OrderByItem, ...] = ()
    unwind: Tuple[str, ...] = ()
    skip: Optional[Expression] = None
    limit: Optional[Expression] = None
    lets: Tuple[LetItem, ...] = ()
    timeout_ms: Optional[int] = None
    distinct: bool = False

    is_idempotent = True


# -- MATCH ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MatchFilter:
    """The `{...}` node filter ([E] OMatchFilter): keys class/as/rid/where/
    while/maxDepth/optional/depthAlias/pathAlias."""

    alias: Optional[str] = None
    class_name: Optional[str] = None
    rid: Optional[RIDLiteral] = None
    where: Optional[Expression] = None
    while_cond: Optional[Expression] = None
    max_depth: Optional[int] = None
    optional: bool = False
    depth_alias: Optional[str] = None
    path_alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class MatchPathItem:
    """One arrow ([E] OMatchPathItem / PatternEdge source syntax).

    Either arrow form (`-EdgeClass->`, `<-EC-`, `-EC-`) or method form
    (`.out('EC')`, `.inE('EC')`…). ``edge_filter`` holds `{...}` placed on
    the arrow's edge braces for edge-property predicates; ``target`` is the
    destination node filter.
    """

    direction: str  # 'out' | 'in' | 'both'
    edge_classes: Tuple[str, ...]  # empty = any edge class
    target: MatchFilter
    edge_filter: Optional[MatchFilter] = None
    method: Optional[str] = None  # out/in/both/outE/inE/bothE/outV/inV when method form
    negated: bool = False  # NOT pattern arrow


@dataclasses.dataclass(frozen=True)
class MatchPath:
    """`{first} item item …` — one comma-separated pattern arm."""

    first: MatchFilter
    items: Tuple[MatchPathItem, ...]
    negated: bool = False  # NOT {..}-..->{..} arm


@dataclasses.dataclass(frozen=True)
class MatchStatement(Statement):
    paths: Tuple[MatchPath, ...]
    returns: Tuple[Projection, ...]
    distinct: bool = False
    group_by: Tuple[Expression, ...] = ()
    order_by: Tuple[OrderByItem, ...] = ()
    unwind: Tuple[str, ...] = ()
    skip: Optional[Expression] = None
    limit: Optional[Expression] = None

    is_idempotent = True


# -- TRAVERSE ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraverseStatement(Statement):
    """[E] OTraverseStatement: TRAVERSE <fields> FROM <target>
    [MAXDEPTH n] [WHILE cond] [LIMIT n] [STRATEGY s]."""

    fields: Tuple[Expression, ...]  # projection-ish: out(), in(), *, field names
    target: Optional[Target]
    max_depth: Optional[int] = None
    while_cond: Optional[Expression] = None
    limit: Optional[Expression] = None
    strategy: str = "DEPTH_FIRST"  # or BREADTH_FIRST

    is_idempotent = True


# -- DML --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InsertStatement(Statement):
    class_name: Optional[str]
    cluster: Optional[str] = None
    set_fields: Tuple[Tuple[str, Expression], ...] = ()
    content: Optional[Expression] = None  # MapExpr
    from_select: Optional[Statement] = None
    return_expr: Optional[Expression] = None


@dataclasses.dataclass(frozen=True)
class UpdateOp:
    kind: str  # SET | INCREMENT | REMOVE | PUT | ADD | CONTENT | MERGE
    items: Tuple[Tuple[str, Expression], ...]


@dataclasses.dataclass(frozen=True)
class UpdateStatement(Statement):
    target: Target
    ops: Tuple[UpdateOp, ...]
    upsert: bool = False
    where: Optional[Expression] = None
    limit: Optional[Expression] = None
    return_mode: Optional[str] = None  # COUNT | BEFORE | AFTER


@dataclasses.dataclass(frozen=True)
class DeleteStatement(Statement):
    target: Target
    where: Optional[Expression] = None
    limit: Optional[Expression] = None
    # kind: RECORD (DELETE FROM), VERTEX (DELETE VERTEX), EDGE (DELETE EDGE)
    kind: str = "RECORD"
    edge_from: Optional[Expression] = None  # DELETE EDGE FROM x TO y
    edge_to: Optional[Expression] = None


@dataclasses.dataclass(frozen=True)
class CreateVertexStatement(Statement):
    class_name: str = "V"
    set_fields: Tuple[Tuple[str, Expression], ...] = ()
    content: Optional[Expression] = None


@dataclasses.dataclass(frozen=True)
class CreateEdgeStatement(Statement):
    class_name: str
    from_expr: Expression  # rid / subquery / list
    to_expr: Expression
    set_fields: Tuple[Tuple[str, Expression], ...] = ()
    content: Optional[Expression] = None


# -- DDL --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CreateClassStatement(Statement):
    name: str
    superclasses: Tuple[str, ...] = ()
    abstract: bool = False
    if_not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreatePropertyStatement(Statement):
    class_name: str
    property_name: str
    property_type: str
    linked_class: Optional[str] = None
    if_not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateIndexStatement(Statement):
    name: str
    class_name: Optional[str]
    fields: Tuple[str, ...]
    index_type: str
    #: [E] the Lucene module's CREATE INDEX ... ENGINE LUCENE form
    engine: Optional[str] = None
    #: METADATA {...} literal (e.g. {"analyzer": "english"})
    metadata: Optional["Expression"] = None


@dataclasses.dataclass(frozen=True)
class DropClassStatement(Statement):
    name: str
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class DropPropertyStatement(Statement):
    class_name: str
    property_name: str


@dataclasses.dataclass(frozen=True)
class DropIndexStatement(Statement):
    name: str


@dataclasses.dataclass(frozen=True)
class AlterPropertyStatement(Statement):
    class_name: str
    property_name: str
    attribute: str  # MANDATORY | NOTNULL | READONLY | MIN | MAX
    value: Expression


@dataclasses.dataclass(frozen=True)
class CreateSequenceStatement(Statement):
    """[E] OSequence DDL: CREATE SEQUENCE s TYPE ORDERED START n INCREMENT n."""

    name: str
    seq_type: str = "ORDERED"
    start: int = 0
    increment: int = 1
    cache: int = 20


@dataclasses.dataclass(frozen=True)
class AlterSequenceStatement(Statement):
    name: str
    start: Optional[int] = None
    increment: Optional[int] = None
    cache: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DropSequenceStatement(Statement):
    name: str


@dataclasses.dataclass(frozen=True)
class CreateFunctionStatement(Statement):
    """[E] OFunction DDL: CREATE FUNCTION name "body" PARAMETERS [a,b]."""

    name: str
    body: str
    parameters: Tuple[str, ...] = ()
    idempotent: bool = True
    language: str = "sql"


@dataclasses.dataclass(frozen=True)
class DropFunctionStatement(Statement):
    name: str


@dataclasses.dataclass(frozen=True)
class TruncateClassStatement(Statement):
    """[E] OTruncateClassStatement: TRUNCATE CLASS <name> [POLYMORPHIC]
    [UNSAFE] — delete every record of the class (vertices cascade their
    incident edges unless UNSAFE skips graph consistency)."""

    class_name: str
    polymorphic: bool = False
    unsafe: bool = False


@dataclasses.dataclass(frozen=True)
class TruncateRecordStatement(Statement):
    """[E] OTruncateRecordStatement: TRUNCATE RECORD <rid>[, <rid>…]."""

    rids: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class AlterClassStatement(Statement):
    """[E] OAlterClassStatement: ALTER CLASS <name> <attribute> <value>.
    Supported attributes: NAME (rename), SUPERCLASS (+Name / -Name),
    STRICTMODE, ABSTRACT."""

    class_name: str
    attribute: str
    value: object  # str | bool | ("+"|"-", name)


@dataclasses.dataclass(frozen=True)
class MoveVertexStatement(Statement):
    """[E] OMoveVertexStatement: MOVE VERTEX <rid|(subquery)> TO
    CLASS:<name> — re-home vertices into another class, rewiring every
    incident edge to the new rid."""

    source: object  # rid string or SelectStatement
    target_class: str


@dataclasses.dataclass(frozen=True)
class RebuildIndexStatement(Statement):
    """[E] ORebuildIndexStatement: REBUILD INDEX <name|*> — drop the
    entries and re-index from a full class scan."""

    name: str  # "*" rebuilds every index


@dataclasses.dataclass(frozen=True)
class GrantStatement(Statement):
    """[E] OGrantStatement: GRANT <permission> ON <resource> TO <role>."""

    permission: str
    resource: str
    role: str


@dataclasses.dataclass(frozen=True)
class RevokeStatement(Statement):
    """[E] ORevokeStatement: REVOKE <permission> ON <resource> FROM <role>."""

    permission: str
    resource: str
    role: str


@dataclasses.dataclass(frozen=True)
class CreateUserStatement(Statement):
    """[E] OCreateUserStatement (3.x): CREATE USER u IDENTIFIED BY pw
    [ROLE [r1,r2]]."""

    name: str
    password: str
    roles: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class DropUserStatement(Statement):
    name: str


@dataclasses.dataclass(frozen=True)
class FindReferencesStatement(Statement):
    """[E] OFindReferencesStatement: FIND REFERENCES <rid> [[Class,…]] —
    every record whose link/linklist fields point at the rid."""

    rid: str
    classes: Tuple[str, ...] = ()

    is_idempotent = True


# -- misc -------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExplainStatement(Statement):
    inner: Statement
    profile: bool = False  # PROFILE actually executes and times

    is_idempotent = True


@dataclasses.dataclass(frozen=True)
class BeginStatement(Statement):
    pass


@dataclasses.dataclass(frozen=True)
class CommitStatement(Statement):
    retries: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class RollbackStatement(Statement):
    pass


@dataclasses.dataclass(frozen=True)
class LiveSelectStatement(Statement):
    """LIVE SELECT FROM <class> — push notifications on matching changes
    ([E] OLiveQueryHookV2, SURVEY.md §2 'Live queries / hooks')."""

    inner: SelectStatement

    is_idempotent = True
