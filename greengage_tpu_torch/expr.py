"""Expression IR — the port's own copy of greengage_tpu/expr.py.

The reference evaluates expression trees per tuple (ExecQual/ExecProject,
src/backend/executor/execQual.c); we carry a small typed IR that the device
evaluator (ops/expr_eval.py) turns into whole-column torch computations with
three-valued NULL logic.

String handling: TEXT columns are dictionary codes on device. The binder
lowers every string operation into either a code comparison (equality against
a literal present in the dictionary) or a ``Lut`` node — a host-computed
per-dictionary-entry table (bool for predicates like LIKE, int32 rank for
ORDER BY, int32 code translation for cross-table equality) gathered on
device. This keeps arbitrary string semantics off the device hot path at
O(dict_size) host cost per query.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from greengage_tpu_torch import types as T


@dataclass(frozen=True)
class Expr:
    pass


@dataclass(frozen=True)
class ColRef(Expr):
    name: str          # unique id assigned by the binder
    type: T.SqlType


@dataclass(frozen=True)
class Literal(Expr):
    value: object      # python scalar in storage representation (DECIMAL: scaled int)
    type: T.SqlType

    @staticmethod
    def null(type_: T.SqlType) -> "Literal":
        return Literal(None, type_)


@dataclass(frozen=True)
class Param(Expr):
    """A hoisted literal — a runtime parameter of the compiled program.

    The paramize pass (sql/paramize.py) replaces plan-safe literals with
    Params so one XLA executable serves every value of a query shape; the
    executor feeds each slot's value as a traced scalar input. Params are
    never NULL and never TEXT (string literals stay pinned: dictionary
    codes and LIKE lowering are bind-time value rewrites)."""

    slot: int
    type: T.SqlType


@dataclass(frozen=True)
class BinOp(Expr):
    op: str            # + - * / %
    left: Expr
    right: Expr
    type: T.SqlType


@dataclass(frozen=True)
class Cmp(Expr):
    op: str            # = <> < <= > >=
    left: Expr
    right: Expr
    type: T.SqlType = T.BOOL


@dataclass(frozen=True)
class BoolOp(Expr):
    op: str            # and | or  (Kleene 3VL)
    args: tuple[Expr, ...]
    type: T.SqlType = T.BOOL


@dataclass(frozen=True)
class Not(Expr):
    arg: Expr
    type: T.SqlType = T.BOOL


@dataclass(frozen=True)
class IsNull(Expr):
    arg: Expr
    negate: bool = False
    type: T.SqlType = T.BOOL


@dataclass(frozen=True)
class Case(Expr):
    whens: tuple[tuple[Expr, Expr], ...]
    else_: Expr | None
    type: T.SqlType = T.BOOL


@dataclass(frozen=True)
class Cast(Expr):
    arg: Expr
    type: T.SqlType = T.BOOL


@dataclass(frozen=True)
class Lut(Expr):
    """table[codes] gather; table is a host numpy array of len(dictionary).

    An out-of-dictionary sentinel row is appended by the builder so code -1
    (absent literal) can be represented as index len(table)-1.
    """

    arg: Expr
    table_id: str       # key into the plan's constant pool
    type: T.SqlType = T.BOOL


@dataclass(frozen=True)
class RawChain(Expr):
    """String-function chain over a raw-encoded TEXT column.

    The device carries the column's row surrogate unchanged; the chain is
    applied on the host — at predicate staging (table_store.eval_host_pred)
    or at result decode (executor finalize). chain = ((name, *literal_args),
    ...) in application order; see utils/strfuncs.py for semantics.
    """

    arg: Expr           # base-table ColRef of the raw column
    chain: tuple = ()
    type: T.SqlType = T.TEXT


@dataclass(frozen=True)
class InList(Expr):
    arg: Expr
    values: tuple       # storage-representation scalars
    type: T.SqlType = T.BOOL


@dataclass(frozen=True)
class Func(Expr):
    """Scalar function call evaluated on device.

    Resolution order in the evaluator: the device scalar library
    (ops/scalar.py — typed registry with per-function NULL semantics),
    then the extension UDF registry (extensions.py). ``params`` carries
    bind-time static arguments the device implementation needs baked into
    the traced program (DECIMAL scales, date_trunc field, interval
    months) — never row data."""

    name: str           # extract_year | date_trunc | coalesce | round_dec ...
    args: tuple[Expr, ...] = ()
    type: T.SqlType = T.INT32
    params: tuple = ()


@dataclass(frozen=True)
class RawLike(Expr):
    """General LIKE over a raw TEXT column, evaluated ON DEVICE from the
    staged wide byte window (@rw word lanes + @rl length): the pattern's
    literal parts (split on %) match greedily left-to-right over an
    unpacked [rows, W] byte matrix — varlena.c text_like vectorized
    (VERDICT r4 #7). The planner only emits this when every committed row
    fits the window, so device results are exact."""

    words: tuple          # ColRefs of @rw:<col>:<w> int64 lanes, in order
    length: "Expr"        # ColRef of @rl:<col>
    parts: tuple          # literal parts as bytes, in pattern order
    anchored_start: bool
    anchored_end: bool
    type: T.SqlType = T.BOOL


@dataclass(frozen=True)
class RawStrOp(Expr):
    """Scalar string-function chain over a raw TEXT column, evaluated ON
    DEVICE from the staged wide byte window (@rw word lanes + @rl length)
    — the byte-op half of the scalar data-path fusion (ops/scalar.py;
    docs/PERF.md "Scalar data-path fusion"). The chain's steps never move
    bytes: they narrow a per-row (start, length) view over the unpacked
    [rows, W] byte matrix (substr/left/right/trim) or transform the matrix
    elementwise (upper/lower), so the whole expression is VPU
    elementwise/reduce work with no gather.

    Terminal op:
      - out="length": the view's length (INT32) — usable anywhere a
        device int is (projections, aggregates, predicates);
      - out="cmp": equality of the view against ``literal`` (BOOL);
      - out="like": RawLike's greedy %-part matching constrained to the
        view (BOOL).

    The binder only emits this when every committed row fits the staged
    window and the column is pure ASCII where the chain's semantics
    require it (upper/lower/substr/length count characters, the window
    counts bytes)."""

    words: tuple          # ColRefs of @rw:<col>:<w> int64 lanes, in order
    length: "Expr"        # ColRef of @rl:<col>
    steps: tuple = ()     # ((name, *literal args), ...) in application order
    out: str = "cmp"      # cmp | like | length
    literal: bytes = b""  # out="cmp": utf-8 bytes of the compared literal
    parts: tuple = ()     # out="like": literal parts as bytes
    anchored_start: bool = True
    anchored_end: bool = True
    type: T.SqlType = T.BOOL


@dataclass(frozen=True)
class Agg(Expr):
    func: str           # count | count_star | sum | min | max | avg
    arg: Expr | None
    distinct: bool
    type: T.SqlType


def agg_result_type(func: str, arg_type: T.SqlType | None) -> T.SqlType:
    if func in ("count", "count_star"):
        return T.INT64
    if func == "avg":
        # PG returns numeric for int/decimal avg; we use float64 (documented
        # deviation: avg is inexact, sums remain exact)
        return T.FLOAT64
    if func in ("min", "max"):
        return arg_type
    if func == "sum":
        if arg_type.kind is T.Kind.DECIMAL:
            return arg_type
        if arg_type.is_integer:
            return T.INT64
        return T.FLOAT64
    raise ValueError(f"unknown aggregate {func}")


def walk(e: Expr):
    yield e
    for f in (
        getattr(e, "left", None), getattr(e, "right", None), getattr(e, "arg", None),
        getattr(e, "else_", None), getattr(e, "length", None),
    ):
        if isinstance(f, Expr):
            yield from walk(f)
    for a in getattr(e, "args", ()) or ():
        yield from walk(a)
    for a in getattr(e, "words", ()) or ():
        yield from walk(a)
    for c, v in getattr(e, "whens", ()):
        yield from walk(c)
        yield from walk(v)


def columns_used(e: Expr) -> set[str]:
    return {n.name for n in walk(e) if isinstance(n, ColRef)}
