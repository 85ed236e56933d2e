"""Plan nodes — the port's copy of greengage_tpu/planner/logical.py.

Holds the nodes TPC-H Q1's physical plan is built from (Scan, Filter,
Project, Aggregate, PartialState, Motion, Sort) with the same fields as
the JAX package's dataclasses; Join, Window, Union, Limit and ConstRel
arrive with the slices that port them.

Column identity: every column carries a unique id string; nodes carry
(output id -> type) schemas. TEXT columns additionally carry the
(table, column) of the dictionary that encodes them.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from greengage_tpu_torch import expr as E
from greengage_tpu_torch import types as T
from greengage_tpu_torch.planner.locus import Locus


@dataclass
class ColInfo:
    id: str
    type: T.SqlType
    name: str                      # user-facing output name
    dict_ref: tuple[str, str] | None = None   # (table, column) for TEXT
    hidden: bool = False           # ORDER BY pass-through, not in the result


@dataclass
class Plan:
    locus: Locus | None = field(default=None, init=False)
    est_rows: float = field(default=0.0, init=False)

    @property
    def children(self) -> list["Plan"]:
        out = []
        for a in ("child", "left", "right"):
            c = getattr(self, a, None)
            if c is not None:
                out.append(c)
        return out

    def out_cols(self) -> list[ColInfo]:
        raise NotImplementedError


@dataclass
class Scan(Plan):
    table: str
    cols: list[ColInfo]            # id = unique, name = storage column name

    def out_cols(self):
        return self.cols


@dataclass
class Filter(Plan):
    child: Plan
    predicate: E.Expr

    def out_cols(self):
        return self.child.out_cols()


@dataclass
class Project(Plan):
    child: Plan
    exprs: list[tuple[ColInfo, E.Expr]]

    def out_cols(self):
        return [c for c, _ in self.exprs]


@dataclass
class Aggregate(Plan):
    child: Plan
    group_keys: list[tuple[ColInfo, E.Expr]]
    aggs: list[tuple[ColInfo, E.Agg]]
    phase: str = "single"          # single | partial | final

    def out_cols(self):
        return [c for c, _ in self.group_keys] + [c for c, _ in self.aggs]


@dataclass
class Sort(Plan):
    child: Plan
    keys: list[tuple[E.Expr, bool, bool | None]]   # expr, desc, nulls_first

    def out_cols(self):
        return self.child.out_cols()


@dataclass
class PartialState(Plan):
    """Exposes a partial Aggregate's STATE columns (the @s/@c/@m naming the
    final phase consumes) as a schema."""

    child: Plan
    cols: list[ColInfo]

    def out_cols(self):
        return self.cols


class MotionKind(enum.Enum):
    REDISTRIBUTE = "Redistribute"
    BROADCAST = "Broadcast"
    GATHER = "Gather"              # to the coordinator (Entry)


@dataclass
class Motion(Plan):
    kind: MotionKind
    child: Plan
    hash_exprs: list[E.Expr] = field(default_factory=list)  # REDISTRIBUTE only
    merge_keys: list | None = None  # GATHER: preserve this sort order

    def out_cols(self):
        return self.child.out_cols()


def describe(plan: Plan, indent: int = 0) -> str:
    """EXPLAIN-style tree rendering, in the JAX package's format."""
    pad = "  " * indent
    name = type(plan).__name__
    extra = ""
    if isinstance(plan, Scan):
        extra = f" {plan.table}"
    elif isinstance(plan, Motion):
        extra = f" {plan.kind.value}"
        if plan.hash_exprs:
            extra += f" by ({', '.join(_expr_str(e) for e in plan.hash_exprs)})"
    elif isinstance(plan, Aggregate):
        extra = f" {plan.phase} keys=({', '.join(c.name for c, _ in plan.group_keys)})"
    locus = f"  [{plan.locus.describe()}]" if plan.locus else ""
    lines = [f"{pad}{name}{extra}{locus}"]
    for c in plan.children:
        lines.append(describe(c, indent + 1))
    return "\n".join(lines)


def _expr_str(e: E.Expr) -> str:
    if isinstance(e, E.ColRef):
        return e.name
    return type(e).__name__
