"""The port's expression evaluator against the JAX package's on the same
columns: TPC-H Q1's decimal and date expressions, decimal rescale and
division rounding, integer division and modulo sign rules, 3VL, CASE and
casts. Integer and DECIMAL results must be equal; float results too (both
sides compute the same float64 operations)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import greengage_tpu  # noqa: F401  (enables x64)
from greengage_tpu import expr as JE
from greengage_tpu import types as JT
from greengage_tpu.ops.batch import Batch as JBatch
from greengage_tpu.ops.expr_eval import Evaluator as JEvaluator
from greengage_tpu_torch import expr as TE
from greengage_tpu_torch import types as TTy
from greengage_tpu_torch.ops.batch import Batch as TBatch
from greengage_tpu_torch.ops.expr_eval import Evaluator as TEvaluator

N = 4000


def _columns(seed=0):
    rng = np.random.default_rng(seed)
    return {
        # Q1's lineitem columns at storage representation
        "qty": rng.integers(100, 5001, N).astype(np.int64),
        "price": rng.integers(90000, 10**7, N).astype(np.int64),
        "disc": rng.integers(0, 11, N).astype(np.int64),
        "tax": rng.integers(0, 9, N).astype(np.int64),
        "ship": rng.integers(8035, 10600, N).astype(np.int32),
        # signed operands for the rounding and sign rules
        "a": rng.integers(-10**6, 10**6, N).astype(np.int64),
        "b": np.where(rng.random(N) < 0.05, 0,
                      rng.integers(-999, 1000, N)).astype(np.int64),
        "i": rng.integers(-100, 100, N).astype(np.int32),
        "j": rng.integers(-9, 10, N).astype(np.int32),
        "f": rng.normal(0, 1e3, N),
    }


def _valids(seed=0):
    rng = np.random.default_rng(seed + 100)
    return {"a": rng.random(N) < 0.9, "i": rng.random(N) < 0.8}


def _eval(side, build):
    cols, valids = _columns(), _valids()
    if side == "jax":
        b = JBatch({k: jnp.asarray(v) for k, v in cols.items()},
                   {k: jnp.asarray(v) for k, v in valids.items()})
        v, valid = JEvaluator(b).value(build(JE, JT))
        shape = (N,)
    else:
        # two segments of N/2 rows: the port evaluates [nseg, cap] tensors
        b = TBatch({k: torch.from_numpy(v).reshape(2, -1)
                    for k, v in cols.items()},
                   {k: torch.from_numpy(v).reshape(2, -1)
                    for k, v in valids.items()})
        ev = TEvaluator(b)
        v, valid = ev.column(build(TE, TTy))
        shape = (2, N // 2)
    v = np.broadcast_to(np.asarray(v), shape).reshape(-1)
    if valid is not None:
        valid = np.broadcast_to(np.asarray(valid), shape).reshape(-1)
    return v, valid


def _dec(T, s):
    return T.decimal(s)


def q1_disc_price(E, T):
    price = E.ColRef("price", _dec(T, 2))
    disc = E.ColRef("disc", _dec(T, 2))
    return E.BinOp("*", price,
                   E.BinOp("-", E.Literal(1, T.INT32), disc, _dec(T, 2)),
                   _dec(T, 4))


def q1_charge(E, T):
    tax = E.ColRef("tax", _dec(T, 2))
    return E.BinOp("*", q1_disc_price(E, T),
                   E.BinOp("+", E.Literal(1, T.INT32), tax, _dec(T, 2)),
                   _dec(T, 6))


EXPRS = {
    "q1_disc_price": q1_disc_price,
    "q1_charge": q1_charge,
    "q1_date_filter": lambda E, T: E.Cmp(
        "<=", E.ColRef("ship", T.DATE), E.Literal(10471, T.DATE)),
    "date_minus_days": lambda E, T: E.BinOp(
        "-", E.ColRef("ship", T.DATE), E.Literal(90, T.INT32), T.DATE),
    # narrowing rescale rounds half away from zero on negatives too
    "decimal_mul_narrowing": lambda E, T: E.BinOp(
        "*", E.ColRef("a", _dec(T, 2)), E.ColRef("b", _dec(T, 2)), _dec(T, 1)),
    "decimal_div": lambda E, T: E.BinOp(
        "/", E.ColRef("a", _dec(T, 2)), E.ColRef("b", _dec(T, 2)), _dec(T, 6)),
    "decimal_sub_int": lambda E, T: E.BinOp(
        "-", E.ColRef("a", _dec(T, 3)), E.ColRef("i", T.INT32), _dec(T, 3)),
    "int_div_truncates": lambda E, T: E.BinOp(
        "/", E.ColRef("i", T.INT32), E.ColRef("j", T.INT32), T.INT32),
    "int_mod_sign_of_dividend": lambda E, T: E.BinOp(
        "%", E.ColRef("i", T.INT32), E.ColRef("j", T.INT32), T.INT32),
    "float_div": lambda E, T: E.BinOp(
        "/", E.ColRef("f", T.FLOAT64), E.ColRef("j", T.INT32), T.FLOAT64),
    "cmp_decimal_vs_int": lambda E, T: E.Cmp(
        ">", E.ColRef("a", _dec(T, 2)), E.Literal(1000, T.INT32)),
    "and_or_not_3vl": lambda E, T: E.BoolOp("or", (
        E.BoolOp("and", (
            E.Cmp(">", E.ColRef("a", T.INT64), E.Literal(0, T.INT64)),
            E.Cmp("<", E.ColRef("i", T.INT32), E.Literal(10, T.INT32)))),
        E.Not(E.Cmp("=", E.ColRef("j", T.INT32), E.Literal(3, T.INT32))))),
    "is_null": lambda E, T: E.IsNull(E.ColRef("i", T.INT32), negate=False),
    "is_not_null_of_valid_col": lambda E, T: E.IsNull(
        E.ColRef("j", T.INT32), negate=True),
    "case_with_nulls": lambda E, T: E.Case(
        ((E.Cmp("<", E.ColRef("i", T.INT32), E.Literal(0, T.INT32)),
          E.ColRef("a", _dec(T, 2))),
         (E.Cmp("=", E.ColRef("j", T.INT32), E.Literal(0, T.INT32)),
          E.Literal(None, _dec(T, 2)))),
        E.Literal(150, _dec(T, 2)), _dec(T, 2)),
    "cast_decimal_to_int_rounds": lambda E, T: E.Cast(
        E.ColRef("a", _dec(T, 2)), T.INT64),
    "cast_float_to_decimal": lambda E, T: E.Cast(
        E.ColRef("f", T.FLOAT64), _dec(T, 2)),
    "cast_decimal_to_float": lambda E, T: E.Cast(
        E.ColRef("a", _dec(T, 4)), T.FLOAT64),
    "literal_only": lambda E, T: E.BinOp(
        "+", E.Literal(2, T.INT64), E.Literal(3, T.INT64), T.INT64),
}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expr_matches_jax(name):
    jv, jvalid = _eval("jax", EXPRS[name])
    tv, tvalid = _eval("torch", EXPRS[name])
    assert tv.dtype == jv.dtype, (tv.dtype, jv.dtype)
    assert (tvalid is None) == (jvalid is None)
    if jvalid is not None:
        assert np.array_equal(tvalid, jvalid)
        live = jvalid
    else:
        live = np.ones(N, bool)
    if jv.dtype.kind == "f":
        assert np.array_equal(tv[live], jv[live], equal_nan=True)
    else:
        assert np.array_equal(tv[live], jv[live])


def test_unported_node_names_its_roadmap_item():
    b = TBatch({"x": torch.zeros((1, 4), dtype=torch.int32)})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TEvaluator(b).value(TE.InList(TE.ColRef("x", TTy.INT32), (1, 2)))
