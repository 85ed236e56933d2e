"""Device expression evaluator: typed Expr IR -> whole-column torch ops.

The port's counterpart of greengage_tpu/ops/expr_eval.py (the vectorized
ExecQual/ExecProject). Every node evaluates to ``(values, valid|None)``
where valid is the SQL NULL mask; comparisons/boolean ops follow Kleene
three-valued logic. DECIMAL arithmetic is exact scaled-int64: +/- align
scales, * adds scales, / computes in float64 and rounds half away from zero
back to the result scale.

This slice ports the node kinds TPC-H Q1 and its neighbours need; the
others raise NotImplementedError naming the ROADMAP item that ports them.
Literals evaluate to 0-dim tensors that broadcast against the columns, so
a constant costs no memory pass; ``column()`` broadcasts a result to the
batch shape where a whole column is needed.
"""

from __future__ import annotations

import torch

from greengage_tpu_torch import expr as E
from greengage_tpu_torch import types as T
from greengage_tpu_torch.ops.batch import Batch

_LATER = ("ROADMAP Queue 1 item 1 (the rest of the evaluator comes "
          "with the SQL front end)")

_TORCH_DTYPE = {
    T.Kind.BOOL: torch.bool,
    T.Kind.INT32: torch.int32,
    T.Kind.INT64: torch.int64,
    T.Kind.FLOAT64: torch.float64,
    T.Kind.DECIMAL: torch.int64,
    T.Kind.DATE: torch.int32,
    T.Kind.TEXT: torch.int32,
}


def torch_dtype(t: T.SqlType) -> torch.dtype:
    """The device representation of a SQL type (types.SqlType.np_dtype)."""
    return _TORCH_DTYPE[t.kind]


def and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def rescale(vals, from_scale: int, to_scale: int):
    """Scaled-int64 DECIMAL rescale, rounding half AWAY from zero on
    narrowing (PG numeric rounding). Both floor divisions see non-negative
    operands, so torch's flooring ``//`` truncates here."""
    if from_scale == to_scale:
        return vals
    if to_scale > from_scale:
        return vals * 10 ** (to_scale - from_scale)
    p = 10 ** (from_scale - to_scale)
    half = p // 2
    return torch.where(vals >= 0, (vals + half) // p, -((-vals + half) // p))


def descale(v, scale: int):
    """Float64 value of a scaled-int DECIMAL: a true division by 10^scale
    on every device (torch's CUDA kernel multiplies by the reciprocal when
    the divisor is a host scalar, one ulp off a true division)."""
    return v.to(torch.float64) / torch.full(
        (), 10.0 ** scale, dtype=torch.float64, device=v.device)


def _num_align(lt: T.SqlType, lv, rt: T.SqlType, rv, out: T.SqlType):
    """Align two numeric operands for + - * / under the result type."""
    if out.kind is T.Kind.FLOAT64:
        def to_f(t, v):
            if t.kind is T.Kind.DECIMAL:
                return descale(v, t.scale)
            return v.to(torch.float64)
        return to_f(lt, lv), to_f(rt, rv)
    if out.kind is T.Kind.DECIMAL:
        def to_d(t, v):
            s = t.scale if t.kind is T.Kind.DECIMAL else 0
            return v.to(torch.int64), s
        return to_d(lt, lv), to_d(rt, rv)
    dt = torch_dtype(out)
    return lv.to(dt), rv.to(dt)


class Evaluator:
    """Evaluates Expr trees over a Batch. ``consts`` is the plan's constant
    pool (hoisted parameter vector under "@params@")."""

    def __init__(self, batch: Batch, consts: dict | None = None):
        self.batch = batch
        self.consts = consts or {}
        self.shape = batch.shape
        self.device = batch.device

    # ---- public --------------------------------------------------------
    def value(self, e: E.Expr):
        """-> (values, valid|None)"""
        m = getattr(self, "_eval_" + type(e).__name__.lower(), None)
        if m is None:
            raise NotImplementedError(f"eval {type(e).__name__}: {_LATER}")
        return m(e)

    def column(self, e: E.Expr):
        """value() with the values broadcast to the batch shape."""
        v, valid = self.value(e)
        if valid is not None:
            valid = valid.expand(self.shape)
        return v.expand(self.shape), valid

    def predicate(self, e: E.Expr):
        """WHERE semantics: NULL -> false. Returns a bool tensor."""
        v, valid = self.value(e)
        v = v.to(torch.bool)
        if valid is not None:
            v = v & valid
        return v

    def _const(self, value, dtype):
        return torch.full((), value, dtype=dtype, device=self.device)

    # ---- leaves --------------------------------------------------------
    def _eval_colref(self, e: E.ColRef):
        return self.batch.cols[e.name], self.batch.valids.get(e.name)

    def _eval_literal(self, e: E.Literal):
        dt = torch_dtype(e.type)
        if e.value is None:
            return self._const(0, dt), self._const(False, torch.bool)
        return self._const(e.value, dt), None

    def _eval_param(self, e: E.Param):
        # hoisted literal: the port runs eagerly, so the slot's current
        # value is read from the bound parameter vector at evaluation time
        vec = self.consts.get("@params@")
        if vec is None:
            raise RuntimeError(
                f"parameter slot {e.slot} has no bound value (plan cache "
                "entry executed without its parameter vector)")
        return self._const(vec.values[e.slot], torch_dtype(e.type)), None

    # ---- arithmetic ----------------------------------------------------
    def _eval_binop(self, e: E.BinOp):
        lv, lval = self.value(e.left)
        rv, rval = self.value(e.right)
        lt = e.left.type
        rt = e.right.type
        out = e.type
        valid = and_valid(lval, rval)

        # date arithmetic
        if lt.kind is T.Kind.DATE and rt.kind is T.Kind.DATE and e.op == "-":
            return lv.to(torch.int32) - rv.to(torch.int32), valid
        if lt.kind is T.Kind.DATE:
            r = rv.to(torch.int32)
            return (lv + r if e.op == "+" else lv - r), valid

        if out.kind is T.Kind.DECIMAL:
            (la, ls), (ra, rs) = _num_align(lt, lv, rt, rv, out)
            if e.op in ("+", "-"):
                s = max(ls, rs)
                la, ra = rescale(la, ls, s), rescale(ra, rs, s)
                res = la + ra if e.op == "+" else la - ra
                return rescale(res, s, out.scale), valid
            if e.op == "*":
                res = la * ra  # scale ls+rs
                return rescale(res, ls + rs, out.scale), valid
            if e.op == "/":
                rf = descale(ra, rs)
                q = descale(la, ls) / torch.where(
                    ra == 0, torch.ones_like(rf), rf)
                # round half AWAY from zero (PG numeric; matches rescale).
                # Division by zero yields NULL rather than an error.
                scaled = q * (10.0 ** out.scale)
                half = torch.copysign(torch.full_like(scaled, 0.5), scaled)
                res = torch.trunc(scaled + half).to(torch.int64)
                return res, zero_invalid(valid, ra == 0)
            raise NotImplementedError(e.op)

        la, ra = _num_align(lt, lv, rt, rv, out)
        if e.op == "+":
            return la + ra, valid
        if e.op == "-":
            return la - ra, valid
        if e.op == "*":
            return la * ra, valid
        if e.op == "/":
            if out.kind is T.Kind.FLOAT64:
                res = la / torch.where(ra == 0.0, torch.ones_like(ra), ra)
            else:  # integer division truncating toward zero (PG)
                safe = torch.where(ra == 0, torch.ones_like(ra), ra)
                q = torch.abs(la) // torch.abs(safe)
                res = torch.where((la < 0) ^ (safe < 0), -q, q).to(
                    torch_dtype(out))
            return res, zero_invalid(valid, ra == 0)
        if e.op == "&":
            return la & ra, valid
        if e.op == "%":
            # sign of the dividend (PG): truncated, not floored, remainder
            safe = torch.where(ra == 0, torch.ones_like(ra), ra)
            res = la - (torch.abs(la) // torch.abs(safe)) * torch.sign(la) \
                * torch.abs(safe)
            return res.to(torch_dtype(out)), zero_invalid(valid, ra == 0)
        raise NotImplementedError(e.op)

    # ---- comparison ----------------------------------------------------
    def _eval_cmp(self, e: E.Cmp):
        lv, lval = self.value(e.left)
        rv, rval = self.value(e.right)
        la, ra = _cmp_align(e.left.type, lv, e.right.type, rv)
        res = {
            "=": torch.eq, "<>": torch.ne, "<": torch.lt,
            "<=": torch.le, ">": torch.gt, ">=": torch.ge,
        }[e.op](la, ra)
        return res, and_valid(lval, rval)

    # ---- boolean (Kleene 3VL) -----------------------------------------
    def _eval_boolop(self, e: E.BoolOp):
        vals, valids = [], []
        for a in e.args:
            v, val = self.value(a)
            vals.append(v.to(torch.bool))
            valids.append(val)
        acc_v, acc_val = vals[0], valids[0]
        for v, val in zip(vals[1:], valids[1:]):
            both_valid = and_valid(acc_val, val)
            if e.op == "and":
                # false if any false; null if no false but some null
                decided = (~v & _or_true(val)) | (~acc_v & _or_true(acc_val))
                acc_v = acc_v & v
            else:
                decided = (v & _or_true(val)) | (acc_v & _or_true(acc_val))
                acc_v = acc_v | v
            acc_val = None if both_valid is None else decided | both_valid
        return acc_v, acc_val

    def _eval_not(self, e: E.Not):
        v, val = self.value(e.arg)
        return ~v.to(torch.bool), val

    def _eval_isnull(self, e: E.IsNull):
        _, val = self.value(e.arg)
        if val is None:
            res = self._const(False, torch.bool)
        else:
            res = ~val
        if e.negate:
            res = ~res
        return res, None

    def _eval_case(self, e: E.Case):
        out_t = e.type
        res = self._const(0, torch_dtype(out_t))
        res_valid = self._const(False, torch.bool)
        decided = self._const(False, torch.bool)
        all_valid = self._const(True, torch.bool)
        for cond, val in e.whens:
            c = self.predicate(cond)
            take = c & ~decided
            v, vval = self.value(val)
            v = _cast_to(v, val.type, out_t)
            res = torch.where(take, v, res)
            res_valid = torch.where(take, all_valid if vval is None else vval,
                                    res_valid)
            decided = decided | c
        if e.else_ is not None:
            v, vval = self.value(e.else_)
            v = _cast_to(v, e.else_.type, out_t)
            res = torch.where(decided, res, v)
            res_valid = torch.where(decided, res_valid,
                                    all_valid if vval is None else vval)
        return res, res_valid

    def _eval_cast(self, e: E.Cast):
        v, val = self.value(e.arg)
        return _cast_to(v, e.arg.type, e.type), val


def _or_true(valid):
    return valid if valid is not None else True


def zero_invalid(valid, zero):
    """Division by zero yields NULL (deviation: PG raises; MPP-friendly NULL
    keeps the kernel branch-free)."""
    nz = ~zero
    return nz if valid is None else valid & nz


def _cmp_align(lt, lv, rt, rv):
    if lt.kind is T.Kind.TEXT and rt.kind is T.Kind.TEXT:
        return lv, rv  # code equality only; binder guarantees same dictionary
    if lt.kind is T.Kind.DECIMAL or rt.kind is T.Kind.DECIMAL:
        ls = lt.scale if lt.kind is T.Kind.DECIMAL else 0
        rs = rt.scale if rt.kind is T.Kind.DECIMAL else 0
        s = max(ls, rs)
        return (rescale(lv.to(torch.int64), ls, s),
                rescale(rv.to(torch.int64), rs, s))
    if lt.kind is T.Kind.FLOAT64 or rt.kind is T.Kind.FLOAT64:
        return lv.to(torch.float64), rv.to(torch.float64)
    # promote explicitly: a 0-dim literal would otherwise take the
    # column's narrower type under torch's promotion rules
    dt = torch.promote_types(lv.dtype, rv.dtype)
    return lv.to(dt), rv.to(dt)


def _cast_to(v, from_t: T.SqlType, to_t: T.SqlType):
    if from_t == to_t:
        return v
    if to_t.kind is T.Kind.DECIMAL:
        if from_t.kind is T.Kind.DECIMAL:
            return rescale(v.to(torch.int64), from_t.scale, to_t.scale)
        if from_t.kind is T.Kind.FLOAT64:
            # half to even, as jnp.round
            return torch.round(v * (10.0 ** to_t.scale)).to(torch.int64)
        return v.to(torch.int64) * 10 ** to_t.scale
    if to_t.kind is T.Kind.FLOAT64:
        if from_t.kind is T.Kind.DECIMAL:
            return descale(v, from_t.scale)
        return v.to(torch.float64)
    if to_t.is_integer:
        if from_t.kind is T.Kind.DECIMAL:
            return rescale(v, from_t.scale, 0).to(torch_dtype(to_t))
        return v.to(torch_dtype(to_t))
    if to_t.kind is T.Kind.BOOL:
        return v.to(torch.bool)
    if to_t.kind is T.Kind.DATE and from_t.is_integer:
        return v.to(torch.int32)
    raise NotImplementedError(f"cast {from_t} -> {to_t}")
