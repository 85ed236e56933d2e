"""SQL type system — the port's own copy of greengage_tpu/types.py.

The reference inherits PostgreSQL's type system (pg_type catalog); we define a
small core with exact device representations:

- BOOL      -> bool_
- INT32     -> int32
- INT64     -> int64
- FLOAT64   -> float64
- DECIMAL   -> scaled int64 (scale = digits after the point). SQL-exact sums
               and products, no float drift (reference: PostgreSQL numeric).
- DATE      -> int32 days since 1970-01-01
- TEXT      -> int32 dictionary codes + host-side dictionary (per column).
               String predicates are evaluated on the host dictionary and
               become boolean lookup tables gathered on device, so arbitrary
               LIKE/regex cost O(dict) on host + one gather on device.

NULLs are carried out-of-band as validity masks (True = valid), mirroring the
columnar engines' approach rather than PostgreSQL's per-tuple null bitmap.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
import re
from decimal import Decimal, ROUND_HALF_UP

import numpy as np


class Kind(enum.Enum):
    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT64 = "float64"
    DECIMAL = "decimal"
    DATE = "date"
    TEXT = "text"


@dataclass(frozen=True)
class SqlType:
    kind: Kind
    scale: int = 0  # decimal digits after the point (DECIMAL only)

    def __post_init__(self):
        if self.kind is not Kind.DECIMAL and self.scale != 0:
            raise ValueError("scale is only valid for DECIMAL")

    # ---- classification ------------------------------------------------
    @property
    def is_numeric(self) -> bool:
        return self.kind in (Kind.INT32, Kind.INT64, Kind.FLOAT64, Kind.DECIMAL)

    @property
    def is_integer(self) -> bool:
        return self.kind in (Kind.INT32, Kind.INT64)

    @property
    def is_orderable(self) -> bool:
        return True  # every core type (incl. BOOL, false < true) is orderable

    # ---- device representation ----------------------------------------
    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(
            {
                Kind.BOOL: np.bool_,
                Kind.INT32: np.int32,
                Kind.INT64: np.int64,
                Kind.FLOAT64: np.float64,
                Kind.DECIMAL: np.int64,
                Kind.DATE: np.int32,
                Kind.TEXT: np.int32,  # dictionary codes
            }[self.kind]
        )

    def __str__(self) -> str:
        if self.kind is Kind.DECIMAL:
            return f"decimal(.,{self.scale})"
        return self.kind.value


BOOL = SqlType(Kind.BOOL)
INT32 = SqlType(Kind.INT32)
INT64 = SqlType(Kind.INT64)
FLOAT64 = SqlType(Kind.FLOAT64)
DATE = SqlType(Kind.DATE)
TEXT = SqlType(Kind.TEXT)


def decimal(scale: int) -> SqlType:
    return SqlType(Kind.DECIMAL, scale)


# --------------------------------------------------------------------------
# Promotion rules (mirrors PostgreSQL's implicit numeric promotion ladder)
# --------------------------------------------------------------------------

_NUM_RANK = {Kind.INT32: 0, Kind.INT64: 1, Kind.DECIMAL: 2, Kind.FLOAT64: 3}


def promote(a: SqlType, b: SqlType) -> SqlType:
    """Common type for comparison / arithmetic alignment of a and b."""
    if a == b:
        return a
    if a.kind == b.kind == Kind.DECIMAL:
        return decimal(max(a.scale, b.scale))
    if a.is_numeric and b.is_numeric:
        ra, rb = _NUM_RANK[a.kind], _NUM_RANK[b.kind]
        hi = a if ra >= rb else b
        lo = b if ra >= rb else a
        if hi.kind is Kind.DECIMAL:
            # integer joins decimal at the decimal's scale
            return decimal(hi.scale if lo.kind is not Kind.DECIMAL else max(a.scale, b.scale))
        return hi
    raise TypeError(f"cannot promote {a} and {b}")


def arith_result(op: str, a: SqlType, b: SqlType) -> SqlType:
    """Result type of a binary arithmetic op, PostgreSQL-flavored."""
    if op in ("+", "-") and a.kind is Kind.DATE and b.is_integer:
        return DATE
    if op == "-" and a.kind is Kind.DATE and b.kind is Kind.DATE:
        return INT32
    if not (a.is_numeric and b.is_numeric):
        raise TypeError(f"{op} not defined for {a}, {b}")
    if a.kind is Kind.FLOAT64 or b.kind is Kind.FLOAT64:
        return FLOAT64
    if a.kind is Kind.DECIMAL or b.kind is Kind.DECIMAL:
        sa = a.scale if a.kind is Kind.DECIMAL else 0
        sb = b.scale if b.kind is Kind.DECIMAL else 0
        if op in ("+", "-"):
            return decimal(max(sa, sb))
        if op == "*":
            return decimal(sa + sb)
        if op == "/":
            # quotient computed in float64 then rescaled; keep 6 frac digits
            return decimal(max(sa, 6))
        raise TypeError(op)
    # PG semantics: integer / integer = integer (truncating)
    if a.kind is Kind.INT64 or b.kind is Kind.INT64:
        return INT64
    return INT32


def literal_type(v) -> SqlType:
    if isinstance(v, bool):
        return BOOL
    if isinstance(v, int):
        return INT32 if -(2**31) <= v < 2**31 else INT64
    if isinstance(v, float):
        return FLOAT64
    if isinstance(v, str):
        return TEXT
    raise TypeError(f"unsupported literal {v!r}")


# --------------------------------------------------------------------------
# Date helpers (host side)
# --------------------------------------------------------------------------

_EPOCH = np.datetime64("1970-01-01", "D")


def date_to_days(iso: str) -> int:
    return int((np.datetime64(iso, "D") - _EPOCH).astype(np.int64))


def days_to_date(days: int) -> str:
    return str(_EPOCH + np.timedelta64(int(days), "D"))


def from_string(v: str, t: SqlType):
    """Parse a string into a type's storage representation — the single
    coercion registry shared by COPY, INSERT literal binding, and loaders."""
    k = t.kind
    if k is Kind.TEXT:
        return v
    if k is Kind.DATE:
        return date_to_days(v)
    if k is Kind.DECIMAL:
        return decimal_to_int(v, t.scale)
    if k is Kind.FLOAT64:
        return float(v)
    if k is Kind.BOOL:
        s = v.strip().lower()
        if s in ("t", "true", "1", "yes", "on"):
            return True
        if s in ("f", "false", "0", "no", "off"):
            return False
        raise ValueError(f"invalid boolean {v!r}")
    return int(v)


def decimal_to_int(value, scale: int) -> int:
    """Parse a decimal literal (str/float/int) to scaled int64, half-up."""

    d = Decimal(str(value)).quantize(Decimal(1).scaleb(-scale), rounding=ROUND_HALF_UP)
    return int(d.scaleb(scale))


@dataclass
class Coded:
    """Bulk-load representation of a TEXT column: a small vocabulary plus an
    int32 code per row. Lets multi-million-row loads skip the per-string
    Python encode loop — the store maps vocab -> dictionary codes once and
    remaps the code array vectorized (the fast path the reference gets from
    gpfdist's parallel format parsing, gpfdist.c).
    """

    vocab: list
    codes: "np.ndarray"

    def __len__(self):
        return len(self.codes)

    def decode(self):
        import numpy as np

        return np.asarray(self.vocab, dtype=object)[self.codes]


def like_to_regex(pattern: str):
    """SQL LIKE pattern -> compiled regex (shared by the dictionary-LUT
    lowering and the raw-text host evaluator)."""

    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("".join(out), re.DOTALL)
