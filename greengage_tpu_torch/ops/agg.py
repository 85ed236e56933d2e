"""Grouped aggregation, dense path — the port's counterpart of the dense
half of greengage_tpu/ops/agg.py (the execHHashagg.c analog).

DENSE: every group key has a known finite domain (TEXT dictionary / BOOL);
gid is a mixed-radix index and every aggregate reduces per (segment, group).
Tensors carry the segment axis first: gid and values are ``[nseg, n]``,
per-group results ``[nseg, D]``. The sort-based high-cardinality path
arrives with ROADMAP Queue 1 item 2.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from greengage_tpu_torch.ops.expr_eval import descale


@dataclass
class KeySpec:
    values: torch.Tensor
    valid: torch.Tensor | None
    type: object            # T.SqlType
    hash_lut: torch.Tensor | None = None  # TEXT: per-dict-entry hashes


@dataclass
class AggSpec:
    name: str
    func: str               # count_star | count | sum | min | max | avg
    values: torch.Tensor | None
    valid: torch.Tensor | None
    # DECIMAL inputs are scaled int64; avg must descale its float64 result
    # by 10^scale (sum/min/max stay in scaled-int domain, declared DECIMAL).
    decimal_scale: int = 0


def dense_gid(keys: list[KeySpec], domains: list[int], sel):
    """-> (gid int32[nseg, n] in [0, D), D). domains[i] = |dict_i| + 1
    (index 0 = NULL). Dead rows get group 0."""
    gid = None
    for k, dom in zip(keys, domains):
        idx = k.values.to(torch.int32) + 1
        if k.valid is not None:
            idx = torch.where(k.valid, idx, torch.zeros_like(idx))
        gid = idx if gid is None else gid * dom + idx
    D = 1
    for dom in domains:
        D *= dom
    return torch.where(sel, gid, torch.zeros_like(gid)), D


def dense_decode_keys(keys: list[KeySpec], domains: list[int], D: int):
    """Reconstruct per-group key code tensors [D] (and NULL masks) from gid
    arithmetic — no gathers."""
    iota = torch.arange(D, dtype=torch.int32, device=keys[0].values.device)
    strides = []
    s = 1
    for dom in reversed(domains):
        strides.append(s)
        s *= dom
    strides.reverse()
    out = []
    for k, dom, st in zip(keys, domains, strides):
        idx = (iota // st) % dom
        out.append(((idx - 1).to(k.values.dtype), idx > 0))
    return out


def segment_sum(gid, D: int, vals):
    """Per-(segment, group) sums of ``vals`` [nseg, n] -> [nseg, D] — a
    scatter-add over the flat index seg*D + gid (int64 wraps as the kernel
    does)."""
    S = vals.shape[0]
    flat = _flat_index(gid, D)
    out = torch.zeros(S * D, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, flat, vals.reshape(-1)).reshape(S, D)


def segment_minmax(gid, D: int, vals, func: str, ident):
    """Per-(segment, group) min or max -> [nseg, D]; groups without rows
    keep the identity."""
    S = vals.shape[0]
    flat = _flat_index(gid, D)
    out = torch.full((S * D,), ident, dtype=vals.dtype, device=vals.device)
    red = "amin" if func == "min" else "amax"
    return out.scatter_reduce_(0, flat, vals.reshape(-1), red,
                               include_self=True).reshape(S, D)


def _flat_index(gid, D: int):
    S = gid.shape[0]
    seg = torch.arange(S, dtype=torch.int64, device=gid.device)[:, None] * D
    return (seg + gid.to(torch.int64)).reshape(-1)


def minmax_identity(dtype: torch.dtype, func: str):
    """The min/max identity as a HOST scalar (numpy): the fused kernel's
    job table and the plain scatter both take it by value."""
    if dtype.is_floating_point:
        return np.float64(np.inf if func == "min" else -np.inf)
    info = torch.iinfo(dtype)
    return np.int64(info.max if func == "min" else info.min)


def _run_aggs(aggs: list[AggSpec], sel, seg_sum, seg_minmax):
    """The per-function aggregate semantics, shared by every grouping
    regime. The reduce primitives are injected:

      seg_sum(build, dtype) -> per-group sums of build() (pre-masked to 0)
      seg_minmax(build, dtype, func, ident) -> per-group min/max of build()
        (pre-filled with the identity at dead/NULL rows)

    Inputs arrive as zero-argument builders plus the dtype they produce:
    eager torch has no dead-code elimination, so the fused path's replay
    pass must be able to skip materializing them a second time.

    Semantics kept in ONE place: count(*)/count ignore NULLs per column;
    sum of no rows is NULL; avg = float64 sum/count descaled by the decimal
    scale; min/max of no rows is NULL.
    """
    out_vals: dict[str, torch.Tensor] = {}
    out_valid: dict[str, torch.Tensor | None] = {}
    counts_cache: dict = {}

    def live_count(spec):
        key = None if spec is None or spec.valid is None else id(spec.valid)
        if key not in counts_cache:
            lv = sel if spec is None or spec.valid is None else (sel & spec.valid)
            counts_cache[key] = seg_sum(lambda: lv.to(torch.int64), torch.int64)
        return counts_cache[key]

    live_count(None)
    for spec in aggs:
        if spec.func == "count_star":
            out_vals[spec.name] = live_count(None)
            out_valid[spec.name] = None
            continue
        lv = sel if spec.valid is None else sel & spec.valid
        if spec.func == "count":
            out_vals[spec.name] = live_count(spec)
            out_valid[spec.name] = None
            continue
        vals = spec.values
        if spec.func in ("sum", "avg"):
            acc = torch.float64 if vals.dtype.is_floating_point else torch.int64
            s = seg_sum(lambda vals=vals, lv=lv, acc=acc: torch.where(
                lv, vals.to(acc), torch.zeros((), dtype=acc, device=vals.device)),
                acc)
            cnt = live_count(spec)
            if spec.func == "sum":
                out_vals[spec.name] = s
                out_valid[spec.name] = cnt > 0   # SQL: sum of no rows is NULL
            else:
                denom = torch.where(cnt == 0, torch.ones_like(cnt), cnt).to(
                    torch.float64)
                avg = s.to(torch.float64) / denom
                if spec.decimal_scale:
                    avg = descale(avg, spec.decimal_scale)
                out_vals[spec.name] = avg
                out_valid[spec.name] = cnt > 0
        elif spec.func in ("min", "max"):
            # the identity stays a HOST scalar: the kernel's job table
            # carries it by value
            ident = minmax_identity(vals.dtype, spec.func)
            out_vals[spec.name] = seg_minmax(
                lambda vals=vals, lv=lv, ident=ident: torch.where(
                    lv, vals, torch.tensor(ident.item(), dtype=vals.dtype,
                                           device=vals.device)),
                vals.dtype, spec.func, ident)
            out_valid[spec.name] = live_count(spec) > 0
        else:
            raise NotImplementedError(spec.func)
    return out_vals, out_valid


def dense_aggregate(gid, D: int, aggs: list[AggSpec], sel):
    """aggregate() semantics over dense group ids."""
    def seg_sum(build, dtype):
        return segment_sum(gid, D, build())

    def seg_minmax(build, dtype, func, ident):
        return segment_minmax(gid, D, build(), func, ident.item())

    return _run_aggs(aggs, sel, seg_sum, seg_minmax)
