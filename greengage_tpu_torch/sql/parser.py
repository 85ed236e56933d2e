"""Hand-written SQL lexer + recursive-descent parser.

Grammar subset of the reference's PostgreSQL 9.4 bison grammar
(src/backend/parser/gram.y + scan.l) chosen to cover the analytical
workloads (TPC-H/TPC-DS class queries), GP DDL (DISTRIBUTED BY), INSERT,
COPY, EXPLAIN. Precedence follows PG: OR < AND < NOT < comparison/IS/IN/
BETWEEN/LIKE < additive < multiplicative < unary minus.

The port's copy of greengage_tpu/sql/parser.py, with its imports rewritten to the
port's modules; it imports neither jax nor the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import re

from greengage_tpu_torch.sql import ast as A


class SqlError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<num>\d+\.\d*|\.\d+|\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*|"[^"]+")
  | (?P<op><>|!=|<=|>=|\|\||[-+*/%(),.;=<>\[\]])
    """,
    re.VERBOSE,
)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "null", "true", "false", "is",
    "in", "between", "like", "case", "when", "then", "else", "end", "cast",
    "join", "inner", "left", "right", "full", "outer", "cross", "on",
    "distinct",
    "asc", "desc", "nulls", "first", "last", "create", "table", "drop",
    "insert", "into", "values", "copy", "explain", "analyze", "date",
    "interval", "extract", "distributed", "randomly", "replicated", "with",
    "exists", "if", "show", "union", "all", "substring", "for",
    "begin", "commit", "rollback", "abort", "set", "to", "transaction", "work",
    "delete", "update", "over", "partition",
}


class Lexer:
    def __init__(self, text: str):
        self.tokens: list[tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if not m:
                raise SqlError(f"lex error at {text[pos:pos+20]!r}")
            pos = m.end()
            if m.lastgroup == "ws":
                continue
            kind = m.lastgroup
            val = m.group()
            if kind == "ident":
                if val.startswith('"'):
                    self.tokens.append(("name", val[1:-1]))
                elif val.lower() in KEYWORDS:
                    self.tokens.append(("kw", val.lower()))
                else:
                    self.tokens.append(("name", val.lower()))
            elif kind == "str":
                self.tokens.append(("str", val[1:-1].replace("''", "'")))
            elif kind == "num":
                self.tokens.append(("num", val))
            else:
                self.tokens.append(("op", val))
        self.tokens.append(("eof", ""))


class Parser:
    def __init__(self, text: str):
        self.toks = Lexer(text).tokens
        self.i = 0
        self._recursive_ctes: dict = {}

    # ---- token helpers -------------------------------------------------
    def peek(self, k: int = 0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind, val=None):
        t = self.peek()
        if t[0] == kind and (val is None or t[1] == val):
            self.i += 1
            return t
        return None

    def expect(self, kind, val=None):
        t = self.accept(kind, val)
        if t is None:
            raise SqlError(f"expected {val or kind}, got {self.peek()[1]!r}")
        return t

    def at_kw(self, *kws):
        t = self.peek()
        return t[0] == "kw" and t[1] in kws

    # frame words (ROWS/RANGE/UNBOUNDED/...) are context-sensitive like in
    # the reference grammar: plain identifiers elsewhere, recognized only
    # inside an OVER () clause
    def at_word(self, *words):
        t = self.peek()
        return t[0] in ("kw", "name") and t[1] in words

    def accept_word(self, word):
        if self.at_word(word):
            return self.next()
        return None

    def expect_word(self, word):
        t = self.accept_word(word)
        if t is None:
            raise SqlError(f"expected {word}, got {self.peek()[1]!r}")
        return t

    # ---- statements ----------------------------------------------------
    def parse(self) -> list[A.ANode]:
        stmts = []
        while self.peek()[0] != "eof":
            stmts.append(self.statement())
            while self.accept("op", ";"):
                pass
        return stmts

    def statement(self) -> A.ANode:
        if self.at_kw("with"):
            # WITH ctes: inline expansion (non-recursive). The reference
            # materializes shared CTEs via ShareInputScan
            # (src/backend/executor/nodeShareInputScan.c:1); here every
            # reference inlines the subplan and XLA's common-subexpression
            # elimination dedupes identical subprograms within the single
            # compiled SPMD program — the TPU-native sharing analog.
            ctes = self.with_prefix(allow_recursive=True)
            if self.at_kw("insert"):
                stmt = self.insert_stmt()
            else:
                stmt = self.select_or_union()
            stmt = _substitute_ctes(stmt, ctes)
            if self._recursive_ctes:
                if isinstance(stmt, A.InsertStmt):
                    raise SqlError(
                        "WITH RECURSIVE over INSERT is not supported")
                stmt._recursive_ctes = self._recursive_ctes
                self._recursive_ctes = {}
            return stmt
        if self.at_kw("select"):
            return self.select_or_union()
        if self.at_word("declare"):
            # DECLARE <name> PARALLEL RETRIEVE CURSOR FOR <select>
            self.next()
            name = self.expect("name")[1]
            for w in ("parallel", "retrieve", "cursor"):
                self.expect_word(w)
            self.expect("kw", "for")
            return A.DeclareCursorStmt(name, self.select_or_union())
        if self.at_word("retrieve"):
            # RETRIEVE ALL FROM ENDPOINT <n> OF <cursor>
            self.next()
            self.expect_word("all")
            self.expect("kw", "from")
            self.expect_word("endpoint")
            ep = int(self.expect("num")[1])
            self.expect_word("of")
            return A.RetrieveStmt(ep, self.expect("name")[1])
        if self.at_word("close"):
            self.next()
            return A.CloseCursorStmt(self.expect("name")[1])
        if self.at_kw("create"):
            return self.create_table()
        if self.at_kw("drop"):
            return self.drop_table()
        if self.at_word("alter"):
            return self.alter_table()
        if self.at_kw("insert"):
            return self.insert_stmt()
        if self.at_kw("copy"):
            return self.copy_stmt()
        if self.at_kw("delete"):
            self.next()
            self.expect("kw", "from")
            table = self.expect("name")[1]
            where = self.expr() if self.accept("kw", "where") else None
            return A.DeleteStmt(table, where)
        if self.at_kw("update"):
            self.next()
            table = self.expect("name")[1]
            self.expect("kw", "set")
            sets = []
            while True:
                col = self.expect("name")[1]
                self.expect("op", "=")
                sets.append((col, self.expr()))
                if not self.accept("op", ","):
                    break
            where = self.expr() if self.accept("kw", "where") else None
            return A.UpdateStmt(table, sets, where)
        if self.at_kw("explain"):
            self.next()
            analyze = bool(self.accept("kw", "analyze"))
            return A.ExplainStmt(self.statement(), analyze)
        if self.at_kw("analyze"):
            self.next()
            t = self.accept("name")
            return A.AnalyzeStmt(t[1] if t else None)
        if self.at_kw("show"):
            self.next()
            return A.ShowStmt(self.next()[1])
        if self.at_kw("set"):
            self.next()
            name = self.next()[1]
            if not self.accept("op", "="):
                self.expect("kw", "to")
            # negative numeric values lex as two tokens ('-', number):
            # `SET log_min_duration_ms = -1` must parse (-1 = disabled)
            neg = self.accept("op", "-")
            value = self.next()[1]
            if neg:
                value = f"-{value}"
            return A.SetStmt(name, value)
        if self.at_kw("begin"):
            self.next()
            self.accept("kw", "transaction") or self.accept("kw", "work")
            return A.TxStmt("begin")
        if self.at_kw("commit"):
            self.next()
            self.accept("kw", "transaction") or self.accept("kw", "work")
            return A.TxStmt("commit")
        if self.at_kw("rollback") or self.at_kw("abort"):
            self.next()
            self.accept("kw", "transaction") or self.accept("kw", "work")
            return A.TxStmt("abort")
        raise SqlError(f"unexpected {self.peek()[1]!r}")

    # ---- WITH (common table expressions) ------------------------------
    def with_prefix(self, allow_recursive: bool = False) -> dict:
        """Parse `WITH [RECURSIVE] name [(cols)] AS (query) [, ...]`
        -> {name: query}.

        Later CTEs may reference earlier ones (expanded eagerly, so the
        returned queries are self-contained). Self-referencing CTEs under
        RECURSIVE are NOT substituted: they land in
        ``self._recursive_ctes`` as RecursiveCTE (base/recursive split)
        and the name stays a plain table reference the session resolves
        to the materialized worktable result (gram.y:12190 semantics via
        session-level iteration)."""
        self.expect("kw", "with")
        recursive = bool(self.at_word("recursive") and self.next())
        if recursive and not allow_recursive:
            raise SqlError(
                "WITH RECURSIVE is only supported at statement level")
        ctes: dict = {}
        while True:
            name = self.expect("name")[1]
            colnames = None
            if self.accept("op", "("):
                colnames = [self.expect("name")[1]]
                while self.accept("op", ","):
                    colnames.append(self.expect("name")[1])
                self.expect("op", ")")
            self.expect("kw", "as")
            self.expect("op", "(")
            inner = self.with_prefix() if self.at_kw("with") else {}
            q = self.select_or_union()
            self.expect("op", ")")
            q = _substitute_ctes(q, {**ctes, **inner})
            if recursive and _references_table(q, name):
                self._recursive_ctes[name] = _split_recursive_cte(
                    name, q, colnames)
            else:
                if colnames:
                    _apply_cte_column_aliases(q, colnames, name)
                ctes[name] = q
            if not self.accept("op", ","):
                break
        return ctes

    # ---- SELECT --------------------------------------------------------
    def select_or_union(self) -> A.ANode:
        first = self.select_stmt(stop_at_setops=True)
        if not self.at_kw("union"):
            # trailing ORDER BY/LIMIT belong to the single select
            self._select_tail(first)
            return first
        u = A.UnionStmt(selects=[first], all=True)
        is_all = None
        while self.accept("kw", "union"):
            branch_all = bool(self.accept("kw", "all"))
            if is_all is None:
                is_all = branch_all
            elif is_all != branch_all:
                raise SqlError("mixed UNION / UNION ALL is not supported")
            u.selects.append(self.select_stmt(stop_at_setops=True))
        u.all = bool(is_all)
        # ORDER BY / LIMIT after the last branch apply to the union
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            u.order_by.append(self.order_item())
            while self.accept("op", ","):
                u.order_by.append(self.order_item())
        if self.accept("kw", "limit"):
            u.limit = int(self.expect("num")[1])
        if self.accept("kw", "offset"):
            u.offset = int(self.expect("num")[1])
        return u

    def _select_tail(self, s: A.SelectStmt) -> None:
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            s.order_by.append(self.order_item())
            while self.accept("op", ","):
                s.order_by.append(self.order_item())
        if self.accept("kw", "limit"):
            s.limit = int(self.expect("num")[1])
        if self.accept("kw", "offset"):
            s.offset = int(self.expect("num")[1])

    def select_stmt(self, stop_at_setops: bool = False) -> A.SelectStmt:
        self.expect("kw", "select")
        s = A.SelectStmt()
        s.distinct = bool(self.accept("kw", "distinct"))
        s.items.append(self.select_item())
        while self.accept("op", ","):
            s.items.append(self.select_item())
        if self.accept("kw", "from"):
            s.from_.append(self.table_ref())
            while self.accept("op", ","):
                s.from_.append(self.table_ref())
        if self.accept("kw", "where"):
            s.where = self.expr()
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            self._group_by_clause(s)
        if self.accept("kw", "having"):
            s.having = self.expr()
        if not stop_at_setops:
            self._select_tail(s)
        return s

    def _group_by_clause(self, s: A.SelectStmt) -> None:
        """GROUP BY items: plain exprs mixed with ROLLUP/CUBE/GROUPING SETS
        constructs (gram.y:12457 group_clause). Normalized here into either
        s.group_by (plain only) or s.grouping_sets (the cross product of
        every item's set list, PG semantics)."""
        sets: list[list] = [[]]
        saw_construct = False

        def cross(item_sets: list[list]) -> None:
            nonlocal sets
            sets = [s0 + s1 for s0 in sets for s1 in item_sets]
            if len(sets) > 128:
                raise SqlError("too many grouping sets (max 128)")

        while True:
            t = self.peek()
            if t[0] == "name" and t[1] in ("rollup", "cube") \
                    and self.peek(1) == ("op", "("):
                kind = self.next()[1]
                saw_construct = True
                exprs = self._paren_expr_list()
                if kind == "rollup":
                    item = [exprs[:i] for i in range(len(exprs), -1, -1)]
                else:                      # cube: all subsets
                    if len(exprs) > 7:
                        raise SqlError("cube() supports at most 7 columns")
                    item = [[e for j, e in enumerate(exprs) if m >> j & 1]
                            for m in range((1 << len(exprs)) - 1, -1, -1)]
                cross(item)
            elif t[0] == "name" and t[1] == "grouping" \
                    and self.peek(1) == ("name", "sets"):
                self.next()
                self.next()
                saw_construct = True
                self.expect("op", "(")
                item = []
                while True:
                    if self.peek() == ("op", "("):
                        item.append(self._paren_expr_list(allow_empty=True))
                    else:
                        item.append([self.expr()])
                    if not self.accept("op", ","):
                        break
                self.expect("op", ")")
                cross(item)
            else:
                e = self.expr()
                cross([[e]])
            if not self.accept("op", ","):
                break
        if saw_construct:
            s.grouping_sets = sets
        else:
            s.group_by = sets[0]

    def _paren_expr_list(self, allow_empty: bool = False) -> list:
        self.expect("op", "(")
        if allow_empty and self.accept("op", ")"):
            return []
        out = [self.expr()]
        while self.accept("op", ","):
            out.append(self.expr())
        self.expect("op", ")")
        return out

    def select_item(self) -> A.SelectItem:
        if self.peek() == ("op", "*"):
            self.next()
            return A.SelectItem(A.Star())
        if (self.peek()[0] == "name" and self.peek(1) == ("op", ".")
                and self.peek(2) == ("op", "*")):
            t = self.next()[1]
            self.next()
            self.next()
            return A.SelectItem(A.Star(table=t))
        e = self.expr()
        alias = None
        if self.accept("kw", "as"):
            alias = self.next()[1]
        elif self.peek()[0] == "name":
            alias = self.next()[1]
        return A.SelectItem(e, alias)

    def order_item(self) -> A.OrderItem:
        e = self.expr()
        desc = False
        if self.accept("kw", "desc"):
            desc = True
        else:
            self.accept("kw", "asc")
        nulls_first = None
        if self.accept("kw", "nulls"):
            if self.accept("kw", "first"):
                nulls_first = True
            else:
                self.expect("kw", "last")
                nulls_first = False
        return A.OrderItem(e, desc, nulls_first)

    # ---- FROM ----------------------------------------------------------
    def table_ref(self) -> A.TableRef:
        left = self.table_primary()
        while True:
            if self.at_kw("join", "inner", "left", "cross", "right", "full"):
                kind = "inner"
                if self.accept("kw", "left"):
                    self.accept("kw", "outer")
                    kind = "left"
                elif self.accept("kw", "right"):
                    self.accept("kw", "outer")
                    kind = "right"
                elif self.accept("kw", "full"):
                    self.accept("kw", "outer")
                    kind = "full"
                elif self.accept("kw", "cross"):
                    kind = "cross"
                else:
                    self.accept("kw", "inner")
                self.expect("kw", "join")
                right = self.table_primary()
                on = None
                if kind != "cross":
                    self.expect("kw", "on")
                    on = self.expr()
                if kind == "right":  # normalize: a RIGHT JOIN b == b LEFT JOIN a
                    left = A.JoinRef("left", right, left, on)
                else:
                    left = A.JoinRef(kind, left, right, on)
            else:
                return left

    def table_primary(self) -> A.TableRef:
        if self.accept("op", "("):
            if self.at_kw("with"):
                ctes = self.with_prefix()
                q = _substitute_ctes(self.select_or_union(), ctes)
            else:
                q = self.select_or_union()
            self.expect("op", ")")
            self.accept("kw", "as")
            alias = self.expect("name")[1]
            return A.SubqueryRef(q, alias)
        name = self.expect("name")[1]
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("name")[1]
        elif self.peek()[0] == "name":
            alias = self.next()[1]
        return A.BaseTable(name, alias)

    # ---- expressions (precedence climbing) ----------------------------
    def expr(self) -> A.ANode:
        return self.or_expr()

    def or_expr(self) -> A.ANode:
        e = self.and_expr()
        while self.accept("kw", "or"):
            e = A.Bin("or", e, self.and_expr())
        return e

    def and_expr(self) -> A.ANode:
        e = self.not_expr()
        while self.accept("kw", "and"):
            e = A.Bin("and", e, self.not_expr())
        return e

    def not_expr(self) -> A.ANode:
        if self.accept("kw", "not"):
            return A.Unary("not", self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self) -> A.ANode:
        e = self.add_expr()
        while True:
            t = self.peek()
            if t[0] == "op" and t[1] in ("=", "<>", "!=", "<", "<=", ">", ">="):
                self.next()
                op = "<>" if t[1] == "!=" else t[1]
                e = A.Bin(op, e, self.add_expr())
            elif self.at_kw("is"):
                self.next()
                negate = bool(self.accept("kw", "not"))
                self.expect("kw", "null")
                e = A.IsNullTest(e, negate)
            elif self.at_kw("between"):
                self.next()
                lo = self.add_expr()
                self.expect("kw", "and")
                hi = self.add_expr()
                e = A.Between(e, lo, hi)
            elif self.at_kw("in"):
                self.next()
                self.expect("op", "(")
                if self.at_kw("select"):
                    q = self.select_stmt()
                    self.expect("op", ")")
                    e = A.InSubquery(e, q)
                    continue
                vals = [self.expr()]
                while self.accept("op", ","):
                    vals.append(self.expr())
                self.expect("op", ")")
                e = A.InExpr(e, vals)
            elif self.at_kw("like"):
                self.next()
                e = A.LikeExpr(e, self.expect("str")[1])
            elif self.at_kw("not") and self.peek(1)[0] == "kw" and \
                    self.peek(1)[1] in ("between", "in", "like"):
                self.next()
                kw = self.next()[1]
                if kw == "between":
                    lo = self.add_expr()
                    self.expect("kw", "and")
                    hi = self.add_expr()
                    e = A.Between(e, lo, hi, negate=True)
                elif kw == "in":
                    self.expect("op", "(")
                    if self.at_kw("select"):
                        q = self.select_stmt()
                        self.expect("op", ")")
                        e = A.InSubquery(e, q, negate=True)
                        continue
                    vals = [self.expr()]
                    while self.accept("op", ","):
                        vals.append(self.expr())
                    self.expect("op", ")")
                    e = A.InExpr(e, vals, negate=True)
                else:
                    e = A.LikeExpr(e, self.expect("str")[1], negate=True)
            else:
                return e

    def add_expr(self) -> A.ANode:
        e = self.mul_expr()
        while True:
            t = self.peek()
            if t[0] == "op" and t[1] in ("+", "-", "||"):
                self.next()
                rhs = self.mul_expr()
                # the official TPC-DS interval spelling: `date + 30 days`
                # (gram.y accepts the bare unit postfix only right after
                # an additive op, so `select 1 days` stays an alias)
                if t[1] in ("+", "-") and isinstance(rhs, A.Num) \
                        and self.peek()[0] == "name" \
                        and self.peek()[1] in ("day", "days", "week",
                                               "weeks", "month", "months",
                                               "year", "years"):
                    unit = self.next()[1].rstrip("s")
                    rhs = A.IntervalLit(rhs.text, unit)
                e = A.Bin(t[1], e, rhs)
            else:
                return e

    def mul_expr(self) -> A.ANode:
        e = self.unary_expr()
        while True:
            t = self.peek()
            if t[0] == "op" and t[1] in ("*", "/", "%"):
                self.next()
                e = A.Bin(t[1], e, self.unary_expr())
            else:
                return e

    def unary_expr(self) -> A.ANode:
        if self.accept("op", "-"):
            return A.Unary("-", self.unary_expr())
        if self.accept("op", "+"):
            return self.unary_expr()
        return self.primary()

    def primary(self) -> A.ANode:
        t = self.peek()
        if t == ("op", "("):
            self.next()
            if self.at_kw("select"):
                q = self.select_stmt()
                self.expect("op", ")")
                return A.ScalarSubquery(q)
            e = self.expr()
            self.expect("op", ")")
            return e
        if self.at_kw("exists"):
            self.next()
            self.expect("op", "(")
            q = self.select_stmt()
            self.expect("op", ")")
            return A.ExistsExpr(q)
        if t[0] == "num":
            self.next()
            return A.Num(t[1])
        if t[0] == "str":
            self.next()
            return A.Str(t[1])
        if self.at_kw("null"):
            self.next()
            return A.Null()
        if self.at_kw("true"):
            self.next()
            return A.Bool(True)
        if self.at_kw("false"):
            self.next()
            return A.Bool(False)
        if self.at_kw("left", "right") and self.peek(1) == ("op", "("):
            # left()/right() are reserved words (join syntax) but also
            # string functions when followed by an argument list
            name = self.next()[1]
            self.expect("op", "(")
            args = [self.expr()]
            while self.accept("op", ","):
                args.append(self.expr())
            self.expect("op", ")")
            return A.FuncCall(name, args)
        if self.at_kw("substring"):
            # SUBSTRING(x FROM a [FOR b]) and SUBSTRING(x, a[, b])
            self.next()
            self.expect("op", "(")
            args = [self.expr()]
            if self.accept("kw", "from"):
                args.append(self.expr())
                if self.accept("kw", "for"):
                    args.append(self.expr())
            else:
                while self.accept("op", ","):
                    args.append(self.expr())
            self.expect("op", ")")
            return A.FuncCall("substring", args)
        if self.at_kw("date"):
            self.next()
            return A.DateLit(self.expect("str")[1])
        if self.at_kw("interval"):
            self.next()
            v = self.expect("str")[1]
            unit = self.expect("name")[1].rstrip("s") \
                if self.peek()[0] == "name" else "day"
            return A.IntervalLit(v, unit)
        if self.at_kw("case"):
            return self.case_expr()
        if self.at_kw("cast"):
            self.next()
            self.expect("op", "(")
            arg = self.expr()
            self.expect("kw", "as")
            tname, typmod = self.type_name()
            self.expect("op", ")")
            return A.CastExpr(arg, tname, typmod)
        if self.at_kw("extract"):
            self.next()
            self.expect("op", "(")
            field = self.next()[1]
            self.expect("kw", "from")
            arg = self.expr()
            self.expect("op", ")")
            return A.ExtractExpr(field, arg)
        if t[0] == "name":
            # function call or (qualified) column
            if self.peek(1) == ("op", "("):
                fname = self.next()[1]
                self.next()
                star = False
                distinct = False
                args = []
                if self.accept("op", "*"):
                    star = True
                else:
                    distinct = bool(self.accept("kw", "distinct"))
                    if self.peek() != ("op", ")"):
                        args.append(self.expr())
                        while self.accept("op", ","):
                            args.append(self.expr())
                self.expect("op", ")")
                within = None
                if self.at_word("within") and self.peek(1) == ("kw", "group"):
                    self.next()
                    self.next()
                    self.expect("op", "(")
                    self.expect("kw", "order")
                    self.expect("kw", "by")
                    within = self.expr()
                    if self.accept("kw", "desc"):
                        raise SqlError(
                            "WITHIN GROUP (ORDER BY ... DESC) is not "
                            "supported; use 1-q with ascending order")
                    self.accept("kw", "asc")
                    self.expect("op", ")")
                over = None
                if self.accept("kw", "over"):
                    self.expect("op", "(")
                    over = A.WindowSpec()
                    if self.accept("kw", "partition"):
                        self.expect("kw", "by")
                        over.partition_by.append(self.expr())
                        while self.accept("op", ","):
                            over.partition_by.append(self.expr())
                    if self.accept("kw", "order"):
                        self.expect("kw", "by")
                        over.order_by.append(self.order_item())
                        while self.accept("op", ","):
                            over.order_by.append(self.order_item())
                    if self.at_word("rows", "range") \
                            and self.peek(1) != ("op", ")"):
                        mode = self.next()[1]
                        if self.accept("kw", "between"):
                            lo = self._frame_bound()
                            self.expect("kw", "and")
                            hi = self._frame_bound()
                        else:
                            lo = self._frame_bound()
                            hi = ("current", None)
                        over.frame = (mode, lo, hi)
                    self.expect("op", ")")
                return A.FuncCall(fname, args, star=star, distinct=distinct,
                                  over=over, within_order=within)
            parts = [self.next()[1]]
            while self.peek() == ("op", ".") and self.peek(1)[0] == "name":
                self.next()
                parts.append(self.next()[1])
            return A.Name(tuple(parts))
        raise SqlError(f"unexpected {t[1]!r} in expression")

    def case_expr(self) -> A.ANode:
        self.expect("kw", "case")
        whens = []
        while self.accept("kw", "when"):
            c = self.expr()
            self.expect("kw", "then")
            v = self.expr()
            whens.append((c, v))
        else_ = None
        if self.accept("kw", "else"):
            else_ = self.expr()
        self.expect("kw", "end")
        return A.CaseExpr(whens, else_)

    # ---- DDL / DML -----------------------------------------------------
    def type_name(self) -> tuple[str, tuple[int, ...]]:
        name = self.next()[1]
        if name == "double":
            self.accept("name", "precision")
            name = "double precision"
        typmod = ()
        if self.accept("op", "("):
            mods = [int(self.expect("num")[1])]
            while self.accept("op", ","):
                mods.append(int(self.expect("num")[1]))
            self.expect("op", ")")
            typmod = tuple(mods)
        return name, typmod

    def create_table(self):
        self.expect("kw", "create")
        if self.accept_word("resource"):
            self.expect_word("group")
            name = self.expect("name")[1]
            return A.ResourceGroupStmt("create", name,
                                       self.resgroup_options())
        if self.accept_word("writable"):
            self.expect_word("external")
            return self.create_external_table(True)
        if self.accept_word("external"):
            return self.create_external_table(False)
        if self.accept_word("extension"):
            ine = False
            if self.accept("kw", "if"):
                self.expect("kw", "not")
                self.expect("kw", "exists")
                ine = True
            return A.CreateExtensionStmt(self.expect("name")[1], ine)
        if self.accept_word("index"):
            ine = False
            if self.accept("kw", "if"):
                self.expect("kw", "not")
                self.expect("kw", "exists")
                ine = True
            name = self.expect("name")[1]
            self.expect("kw", "on")
            table = self.expect("name")[1]
            using = "btree"
            if self.accept_word("using"):
                using = self.next()[1]
            self.expect("op", "(")
            col = self.expect("name")[1]
            self.expect("op", ")")
            return A.CreateIndexStmt(name, table, col, using, ine)
        self.expect("kw", "table")
        ine = False
        if self.accept("kw", "if"):
            self.expect("kw", "not")
            self.expect("kw", "exists")
            ine = True
        name = self.expect("name")[1]
        self.expect("op", "(")
        cols = [self.column_def()]
        while self.accept("op", ","):
            cols.append(self.column_def())
        self.expect("op", ")")
        options = {}
        if self.accept("kw", "with"):
            self.expect("op", "(")
            while True:
                k = self.expect("name")[1]
                self.expect("op", "=")
                v = self.next()[1]
                options[k] = v
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        dist_kind, dist_keys = "hash", []
        if self.accept("kw", "distributed"):
            if self.accept("kw", "randomly"):
                dist_kind = "random"
            elif self.accept("kw", "replicated"):
                dist_kind = "replicated"
            else:
                self.expect("kw", "by")
                self.expect("op", "(")
                dist_keys.append(self.expect("name")[1])
                while self.accept("op", ","):
                    dist_keys.append(self.expect("name")[1])
                self.expect("op", ")")
        elif cols:
            dist_keys = [cols[0].name]  # GP default: first column
        pkind = pcol = None
        pdefs: list[A.PartitionDef] = []
        if self.accept("kw", "partition"):
            # PARTITION BY RANGE (col) (PARTITION p START (x) END (y)
            # [EVERY (n)], ..., DEFAULT PARTITION d) | PARTITION BY LIST
            # (col) (PARTITION p VALUES (a, b), ...) — the GP 6 syntax
            # subset (reference: src/backend/parser/gram.y partition rules)
            self.expect("kw", "by")
            if self.accept_word("range"):
                pkind = "range"
            else:
                self.expect_word("list")
                pkind = "list"
            self.expect("op", "(")
            pcol = self.expect("name")[1]
            self.expect("op", ")")
            self.expect("op", "(")
            pdefs.append(self.partition_def(pkind))
            while self.accept("op", ","):
                pdefs.append(self.partition_def(pkind))
            self.expect("op", ")")
        return A.CreateTableStmt(name, cols, dist_kind, dist_keys, options,
                                 ine, pkind, pcol, pdefs)

    def create_external_table(self, writable: bool) -> A.CreateExternalTableStmt:
        """CREATE [WRITABLE] EXTERNAL TABLE t (cols) { LOCATION ('url',...)
        | EXECUTE 'cmd' } [FORMAT 'csv' (delimiter ',' header null '')]
        [SEGMENT REJECT LIMIT n] — the GP external-table syntax subset
        (reference: src/backend/parser/gram.y CreateExternalStmt)."""
        self.expect("kw", "table")
        ine = False
        if self.accept("kw", "if"):
            self.expect("kw", "not")
            self.expect("kw", "exists")
            ine = True
        name = self.expect("name")[1]
        self.expect("op", "(")
        cols = [self.column_def()]
        while self.accept("op", ","):
            cols.append(self.column_def())
        self.expect("op", ")")
        urls: list[str] = []
        exec_cmd = None
        if self.accept_word("location"):
            self.expect("op", "(")
            urls.append(self.expect("str")[1])
            while self.accept("op", ","):
                urls.append(self.expect("str")[1])
            self.expect("op", ")")
        else:
            self.expect_word("execute")
            exec_cmd = self.expect("str")[1]
            if self.accept("kw", "on"):   # ON ALL is the only mode
                self.expect("kw", "all")
        fmt: dict = {}
        if self.accept_word("format"):
            kind = self.expect("str")[1].lower()
            if kind not in ("csv", "text"):
                raise SqlError(f"unsupported external format {kind!r}")
            fmt["kind"] = kind
            if self.accept("op", "("):
                while not self.accept("op", ")"):
                    k = self.next()[1]
                    if self.peek()[0] == "str":
                        fmt[k] = self.expect("str")[1]
                    else:
                        fmt[k] = "true"   # bare flag, e.g. HEADER
        reject_limit = None
        if self.accept_word("segment"):
            self.expect_word("reject")
            self.expect("kw", "limit")
            reject_limit = int(self.expect("num")[1])
        return A.CreateExternalTableStmt(
            name, cols, writable, urls, exec_cmd, fmt, reject_limit, ine)

    def partition_def(self, kind: str | None) -> A.PartitionDef:
        if self.accept_word("default"):
            self.expect("kw", "partition")
            return A.PartitionDef(self.expect("name")[1], default=True)
        self.expect("kw", "partition")
        name = self.expect("name")[1]
        if kind == "list" or (kind is None and self.at_kw("values")):
            self.expect("kw", "values")
            self.expect("op", "(")
            vals = [self.expr()]
            while self.accept("op", ","):
                vals.append(self.expr())
            self.expect("op", ")")
            return A.PartitionDef(name, values=vals)
        lo = hi = every = None
        if self.accept_word("start"):
            self.expect("op", "(")
            lo = self.expr()
            self.expect("op", ")")
        if self.accept("kw", "end"):
            self.expect("op", "(")
            hi = self.expr()
            self.expect("op", ")")
        if self.accept_word("every"):
            self.expect("op", "(")
            every = self.expr()
            self.expect("op", ")")
        return A.PartitionDef(name, lo=lo, hi=hi, every=every)

    def alter_table(self):
        self.expect_word("alter")
        if self.accept_word("resource"):
            # ALTER RESOURCE GROUP g SET <option> <value>
            self.expect_word("group")
            name = self.expect("name")[1]
            self.expect("kw", "set")
            opt = self.expect("name")[1]
            return A.ResourceGroupStmt("alter", name,
                                       {opt: int(self.expect("num")[1])})
        self.expect("kw", "table")
        table = self.expect("name")[1]
        if self.accept_word("add"):
            return A.AlterTableStmt(table, "add_partition",
                                    partition=self.partition_def(None))
        self.expect("kw", "drop")
        self.expect("kw", "partition")
        return A.AlterTableStmt(table, "drop_partition",
                                partition_name=self.expect("name")[1])

    def column_def(self) -> A.ColumnDef:
        name = self.expect("name")[1]
        tname, typmod = self.type_name()
        not_null = False
        if self.accept("kw", "not"):
            self.expect("kw", "null")
            not_null = True
        return A.ColumnDef(name, tname, typmod, not_null)

    def resgroup_options(self) -> dict:
        """WITH (concurrency=N, memory_limit_mb=M, cpu_weight=W)."""
        options: dict = {}
        if self.accept("kw", "with"):
            self.expect("op", "(")
            while True:
                k = self.expect("name")[1]
                self.expect("op", "=")
                options[k] = int(self.expect("num")[1])
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        return options

    def drop_table(self):
        self.expect("kw", "drop")
        if self.accept_word("resource"):
            self.expect_word("group")
            return A.ResourceGroupStmt("drop", self.expect("name")[1])
        if self.accept_word("index"):
            ie = False
            if self.accept("kw", "if"):
                self.expect("kw", "exists")
                ie = True
            return A.DropIndexStmt(self.expect("name")[1], ie)
        self.expect("kw", "table")
        ie = False
        if self.accept("kw", "if"):
            self.expect("kw", "exists")
            ie = True
        return A.DropTableStmt(self.expect("name")[1], ie)

    def insert_stmt(self) -> A.InsertStmt:
        self.expect("kw", "insert")
        self.expect("kw", "into")
        table = self.expect("name")[1]
        columns = []
        if self.accept("op", "("):
            columns.append(self.expect("name")[1])
            while self.accept("op", ","):
                columns.append(self.expect("name")[1])
            self.expect("op", ")")
        if self.at_kw("select"):
            return A.InsertStmt(table, columns, [],
                                query=self.select_or_union())
        self.expect("kw", "values")
        rows = []
        while True:
            self.expect("op", "(")
            row = [self.expr()]
            while self.accept("op", ","):
                row.append(self.expr())
            self.expect("op", ")")
            rows.append(row)
            if not self.accept("op", ","):
                break
        return A.InsertStmt(table, columns, rows)

    def _frame_bound(self):
        """UNBOUNDED PRECEDING/FOLLOWING | CURRENT ROW | N PRECEDING/FOLLOWING"""
        if self.accept_word("unbounded"):
            kw = self.next()[1]
            if kw not in ("preceding", "following"):
                raise SqlError(f"expected PRECEDING/FOLLOWING, got {kw!r}")
            return ("unbounded_" + kw, None)
        if self.accept_word("current"):
            self.expect_word("row")
            return ("current", None)
        tok = self.expect("num")[1]
        if "." in tok:
            raise SqlError(f"frame offset must be an integer, got {tok!r}")
        n = int(tok)
        kw = self.next()[1]
        if kw not in ("preceding", "following"):
            raise SqlError(f"expected PRECEDING/FOLLOWING, got {kw!r}")
        return (kw, n)

    def copy_stmt(self) -> A.CopyStmt:
        self.expect("kw", "copy")
        table = self.expect("name")[1]
        direction = "from"
        if self.at_word("to"):
            self.next()
            direction = "to"
        else:
            self.expect("kw", "from")
        path = self.expect("str")[1]
        options = {}
        if self.accept("kw", "with"):
            self.expect("op", "(")
            while True:
                k = self.next()[1]
                v = (self.next()[1]
                     if self.peek()[0] in ("name", "str", "num", "kw")
                     else "true")
                options[k] = v
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        return A.CopyStmt(table, path, options, direction)


def _references_table(node, name: str) -> bool:
    if isinstance(node, A.BaseTable):
        return node.name == name
    if isinstance(node, A.ANode):
        for f in dataclasses.fields(node):
            if _references_table(getattr(node, f.name), name):
                return True
        return False
    if isinstance(node, (list, tuple)):
        return any(_references_table(v, name) for v in node)
    return False


def _split_recursive_cte(name: str, q, colnames):
    """base UNION [ALL] recursive -> RecursiveCTE: branches that scan
    ``name`` are recursive terms, the rest the base."""
    if not isinstance(q, A.UnionStmt):
        raise SqlError(
            f'recursive CTE "{name}" must be <base> UNION [ALL] <recursive>')
    if q.order_by or q.limit is not None:
        raise SqlError(
            f'recursive CTE "{name}" cannot carry ORDER BY/LIMIT')
    base, rec = [], []
    for b in q.selects:
        (rec if _references_table(b, name) else base).append(b)
    if not base:
        raise SqlError(f'recursive CTE "{name}" has no non-recursive term')
    if not rec:
        raise SqlError(f'recursive CTE "{name}" has no recursive term')

    def pack(bs):
        if len(bs) == 1:
            return bs[0]
        return A.UnionStmt(selects=bs, all=True)

    bq, rq = pack(base), pack(rec)
    if colnames:
        for part in (base + rec):
            _apply_cte_column_aliases(part, colnames, name)
    return A.RecursiveCTE(name, bq, rq, union_all=q.all)


def _substitute_ctes(node, ctes: dict):
    """Replace BaseTable references to CTE names with inlined SubqueryRefs.

    Generic dataclass walk over the AST; each reference gets its own deep
    copy of the CTE body (plans are mutated during binding).
    """
    if not ctes:
        return node

    def walk_val(v):
        if isinstance(v, A.BaseTable):
            q = ctes.get(v.name)
            if q is not None:
                # the body may itself reference OTHER ctes (a nested WITH
                # parsed before the outer ones were known) — substitute
                # inside the copy, excluding this name (no self-recursion)
                rest = {k: b for k, b in ctes.items() if k != v.name}
                body = _substitute_ctes(copy.deepcopy(q), rest)
                return A.SubqueryRef(body, v.alias or v.name)
            return v
        if isinstance(v, A.ANode):
            for f in dataclasses.fields(v):
                setattr(v, f.name, walk_val(getattr(v, f.name)))
            return v
        if isinstance(v, list):
            return [walk_val(x) for x in v]
        if isinstance(v, tuple):
            return tuple(walk_val(x) for x in v)
        return v

    return walk_val(node)


def _apply_cte_column_aliases(q, colnames: list, cte: str) -> None:
    """`WITH c(a, b) AS (...)`: rename the query's output columns."""
    target = q
    while isinstance(target, A.UnionStmt):
        # union output names come from the first branch (PG semantics)
        target = target.selects[0]
    items = target.items
    if any(isinstance(i.expr, A.Star) for i in items):
        raise SqlError(
            f'cannot apply column aliases to "{cte}": SELECT * in CTE body')
    if len(items) != len(colnames):
        raise SqlError(
            f'CTE "{cte}" has {len(items)} columns but {len(colnames)} '
            "aliases were given")
    for item, name in zip(items, colnames):
        item.alias = name


def parse(text: str) -> list[A.ANode]:
    return Parser(text).parse()


def parse_one(text: str) -> A.ANode:
    stmts = parse(text)
    if len(stmts) != 1:
        raise SqlError(f"expected one statement, got {len(stmts)}")
    return stmts[0]
