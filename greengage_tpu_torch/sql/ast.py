"""SQL abstract syntax — output of the parser, input to the binder.

Covers the analytical core of the reference's PostgreSQL 9.4 grammar
(src/backend/parser/gram.y): SELECT with joins/grouping/ordering, DDL with
Greenplum DISTRIBUTED clauses (exttablecmds/gram.y GP extensions), INSERT,
COPY, EXPLAIN.

The port's copy of greengage_tpu/sql/ast.py, with its imports rewritten to the
port's modules; it imports neither jax nor the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field


# ---- expressions ----------------------------------------------------------

@dataclass
class ANode:
    pass


@dataclass
class Name(ANode):
    parts: tuple[str, ...]        # possibly qualified: (alias, col) or (col,)


@dataclass
class Num(ANode):
    text: str


@dataclass
class Str(ANode):
    value: str


@dataclass
class DateLit(ANode):
    value: str


@dataclass
class IntervalLit(ANode):
    value: str
    unit: str                     # day | month | year


@dataclass
class Null(ANode):
    pass


@dataclass
class Bool(ANode):
    value: bool


@dataclass
class ParamRef(ANode):
    """A literal hoisted out of the statement by sql/paramize.py: the
    binder lowers it to a typed expr.Param read from the statement's
    parameter vector at execution. ``ptype`` is the exact SqlType the
    original literal would have bound to — it stays in the cache key, so
    only same-typed shapes share a plan. ``est_value`` carries the
    hoisted value for ESTIMATION only (selectivity/capacity sizing —
    the custom-plan seeding of a generic plan); it is excluded from repr
    so the cache signature stays value-free."""

    idx: int
    ptype: object                 # types.SqlType
    est_value: object = field(default=None, repr=False, compare=False)


@dataclass
class Star(ANode):
    table: str | None = None      # t.* or *


@dataclass
class Bin(ANode):
    op: str
    left: ANode
    right: ANode


@dataclass
class Unary(ANode):
    op: str                       # - | not
    arg: ANode


@dataclass
class IsNullTest(ANode):
    arg: ANode
    negate: bool


@dataclass
class Between(ANode):
    arg: ANode
    lo: ANode
    hi: ANode
    negate: bool = False


@dataclass
class InExpr(ANode):
    arg: ANode
    values: list[ANode]
    negate: bool = False


@dataclass
class LikeExpr(ANode):
    arg: ANode
    pattern: str
    negate: bool = False


@dataclass
class InSubquery(ANode):
    arg: ANode
    query: "SelectStmt"
    negate: bool = False


@dataclass
class ExistsExpr(ANode):
    query: "SelectStmt"
    negate: bool = False


@dataclass
class ScalarSubquery(ANode):
    query: "SelectStmt"


@dataclass
class CaseExpr(ANode):
    whens: list[tuple[ANode, ANode]]
    else_: ANode | None


@dataclass
class CastExpr(ANode):
    arg: ANode
    type_name: str
    typmod: tuple[int, ...] = ()


@dataclass
class WindowSpec(ANode):
    partition_by: list = field(default_factory=list)
    order_by: list = field(default_factory=list)   # OrderItem
    # ("rows"|"range", (bound kind, n), (bound kind, n)) or None (default
    # frame: RANGE UNBOUNDED PRECEDING .. CURRENT ROW)
    frame: tuple | None = None


@dataclass
class FuncCall(ANode):
    name: str
    args: list[ANode]
    star: bool = False            # count(*)
    distinct: bool = False
    over: "WindowSpec | None" = None
    # ordered-set aggregates: percentile_cont(q) WITHIN GROUP (ORDER BY e)
    within_order: "ANode | None" = None


@dataclass
class ExtractExpr(ANode):
    field: str                    # year | month | day
    arg: ANode


# ---- query structure ------------------------------------------------------

@dataclass
class TableRef(ANode):
    pass


@dataclass
class BaseTable(TableRef):
    name: str
    alias: str | None = None


@dataclass
class SubqueryRef(TableRef):
    query: "SelectStmt"
    alias: str = ""


@dataclass
class JoinRef(TableRef):
    kind: str                     # inner | left | cross
    left: TableRef
    right: TableRef
    on: ANode | None = None


@dataclass
class SelectItem(ANode):
    expr: ANode
    alias: str | None = None


@dataclass
class OrderItem(ANode):
    expr: ANode
    desc: bool = False
    nulls_first: bool | None = None


@dataclass
class UnionStmt(ANode):
    selects: list = field(default_factory=list)   # SelectStmt branches
    all: bool = True
    order_by: list = field(default_factory=list)  # OrderItem over branch-1 names
    limit: int | None = None
    offset: int = 0


@dataclass
class SelectStmt(ANode):
    items: list[SelectItem] = field(default_factory=list)
    from_: list[TableRef] = field(default_factory=list)
    where: ANode | None = None
    group_by: list[ANode] = field(default_factory=list)
    having: ANode | None = None
    order_by: list[OrderItem] = field(default_factory=list)
    limit: int | None = None
    offset: int = 0
    distinct: bool = False
    # GROUP BY ROLLUP/CUBE/GROUPING SETS, normalized by the parser into an
    # explicit list of grouping sets (each a list of key exprs); group_by
    # stays empty when set (gram.y:12457 group_clause extensions)
    grouping_sets: "list[list[ANode]] | None" = None
    # set on desugared grouping-set branches: bind as a grouped select
    # even when this branch's key set is empty (GROUP BY () -> one row)
    forced_group: bool = False


@dataclass
class RecursiveCTE(ANode):
    """WITH RECURSIVE r AS (base UNION [ALL] recursive): split at parse
    time; the session iterates the recursive term against a worktable
    until fixpoint (nodeRecursiveunion.c / WorkTableScan role,
    gram.y:12190)."""

    name: str
    base: ANode                  # branches not referencing ``name``
    rec: ANode                   # branches referencing ``name``
    union_all: bool              # False -> dedupe rows across iterations


@dataclass
class TypedNullOf(ANode):
    """NULL carrying the type (and TEXT dictionary) of another expression —
    the grouping-sets desugar emits these for keys absent from a set so
    UNION branch schemas line up without guessing types."""

    arg: ANode


# ---- DDL / DML / utility --------------------------------------------------

@dataclass
class ColumnDef(ANode):
    name: str
    type_name: str
    typmod: tuple[int, ...] = ()
    not_null: bool = False


@dataclass
class PartitionDef(ANode):
    name: str
    lo: ANode | None = None       # RANGE START literal (inclusive)
    hi: ANode | None = None       # RANGE END literal (exclusive)
    every: ANode | None = None    # RANGE EVERY step (expands to a series)
    values: list = field(default_factory=list)   # LIST literals
    default: bool = False


@dataclass
class CreateTableStmt(ANode):
    name: str
    columns: list[ColumnDef]
    dist_kind: str = "hash"       # hash | random | replicated
    dist_keys: list[str] = field(default_factory=list)
    options: dict = field(default_factory=dict)
    if_not_exists: bool = False
    partition_kind: str | None = None    # range | list
    partition_col: str | None = None
    partition_defs: list[PartitionDef] = field(default_factory=list)


@dataclass
class ResourceGroupStmt(ANode):
    action: str                   # create | drop | alter
    name: str
    options: dict = field(default_factory=dict)


@dataclass
class AlterTableStmt(ANode):
    table: str
    action: str                   # add_partition | drop_partition
    partition: PartitionDef | None = None
    partition_name: str | None = None


@dataclass
class DropTableStmt(ANode):
    name: str
    if_exists: bool = False


@dataclass
class CreateExternalTableStmt(ANode):
    name: str
    columns: list[ColumnDef]
    writable: bool = False
    urls: list[str] = field(default_factory=list)   # LOCATION clause
    exec_cmd: str | None = None                     # EXECUTE clause
    format_opts: dict = field(default_factory=dict)
    reject_limit: int | None = None
    if_not_exists: bool = False


@dataclass
class InsertStmt(ANode):
    table: str
    columns: list[str]
    rows: list[list[ANode]]
    query: ANode | None = None    # INSERT INTO ... SELECT


@dataclass
class DeleteStmt(ANode):
    table: str
    where: ANode | None = None


@dataclass
class UpdateStmt(ANode):
    table: str
    sets: list = field(default_factory=list)   # [(colname, expr)]
    where: ANode | None = None


@dataclass
class CopyStmt(ANode):
    table: str
    path: str
    options: dict = field(default_factory=dict)
    direction: str = "from"       # COPY ... FROM 'file' | TO 'file'


@dataclass
class ExplainStmt(ANode):
    query: ANode
    analyze: bool = False


@dataclass
class ShowStmt(ANode):
    what: str


@dataclass
class SetStmt(ANode):
    name: str
    value: object


@dataclass
class TxStmt(ANode):
    action: str        # begin | commit | abort


@dataclass
class CreateIndexStmt(ANode):
    name: str
    table: str
    column: str
    using: str = "btree"
    if_not_exists: bool = False


@dataclass
class DropIndexStmt(ANode):
    name: str
    if_exists: bool = False


@dataclass
class AnalyzeStmt(ANode):
    table: str | None = None   # None = every table


@dataclass
class CreateExtensionStmt(ANode):
    name: str
    if_not_exists: bool = False


@dataclass
class DeclareCursorStmt(ANode):
    name: str
    query: ANode          # SelectStmt/UnionStmt


@dataclass
class RetrieveStmt(ANode):
    endpoint: int
    cursor: str


@dataclass
class CloseCursorStmt(ANode):
    cursor: str
