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


@dataclass(eq=False)
class Job:
    """One per-(segment, group) reduction that ``_run_aggs`` asks for.

    values: the column [nseg, n] as the evaluator hands it over, unmasked
            and uncast, or None for a count of live rows
    live:   the bool live mask [nseg, n] (sel, or sel & valid)
    dtype:  the result dtype (int64 or float64 for sums and counts, the
            column's own for min/max)
    op:     "sum", "min" or "max"; ident: the min/max identity (a host
            scalar), 0 for sums

    A dead row contributes the identity: the reducer applies
    ``live ? value : ident`` itself, so no masked copy is built here.
    """
    values: torch.Tensor | None
    live: torch.Tensor
    dtype: torch.dtype
    op: str = "sum"
    ident: object = 0


def reduce_job(gid, D: int, job: Job):
    """A Job's per-group [nseg, D] result in plain torch: the masking, then
    a scatter over seg*D + gid."""
    if job.values is None:
        return segment_sum(gid, D, job.live.to(torch.int64))
    vals = job.values
    if job.op == "sum":
        zero = torch.zeros((), dtype=job.dtype, device=vals.device)
        return segment_sum(gid, D, torch.where(job.live, vals.to(job.dtype),
                                               zero))
    ident = job.ident.item() if hasattr(job.ident, "item") else job.ident
    fill = torch.tensor(ident, dtype=vals.dtype, device=vals.device)
    return segment_minmax(gid, D, torch.where(job.live, vals, fill), job.op,
                          ident)


def _run_aggs(aggs: list[AggSpec], sel, reduce, masks: dict | None = None):
    """The per-function aggregate semantics, shared by every grouping
    regime. The reduce primitive is injected: ``reduce(job)`` returns the
    per-group [nseg, D] result of one ``Job`` descriptor.

    Descriptors carry the unmasked column and its live mask, so the fused
    kernel reads base columns in place and eager torch builds no masked
    copy the kernel does not need. Live masks (sel & valid) are built once
    per distinct valid mask; a caller that runs this twice over the same
    specs (the fused path's record and replay) passes one ``masks`` dict to
    both runs so the second builds none.

    Semantics kept in ONE place: count(*)/count ignore NULLs per column;
    sum of no rows is NULL; avg = float64 sum/count descaled by the decimal
    scale; min/max of no rows is NULL.
    """
    out_vals: dict[str, torch.Tensor] = {}
    out_valid: dict[str, torch.Tensor | None] = {}
    counts_cache: dict = {}
    masks = {} if masks is None else masks

    def live_mask(spec):
        if spec is None or spec.valid is None:
            return sel
        key = id(spec.valid)
        if key not in masks:
            masks[key] = (spec.valid, sel & spec.valid)
        return masks[key][1]

    def live_count(spec):
        key = None if spec is None or spec.valid is None else id(spec.valid)
        if key not in counts_cache:
            counts_cache[key] = reduce(Job(None, live_mask(spec),
                                           torch.int64))
        return counts_cache[key]

    live_count(None)
    for spec in aggs:
        if spec.func == "count_star":
            out_vals[spec.name] = live_count(None)
            out_valid[spec.name] = None
            continue
        if spec.func == "count":
            out_vals[spec.name] = live_count(spec)
            out_valid[spec.name] = None
            continue
        vals = spec.values
        lv = live_mask(spec)
        if spec.func in ("sum", "avg"):
            acc = torch.float64 if vals.dtype.is_floating_point else torch.int64
            s = reduce(Job(vals, lv, acc))
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
            out_vals[spec.name] = reduce(Job(vals, lv, vals.dtype, spec.func,
                                             ident))
            out_valid[spec.name] = live_count(spec) > 0
        else:
            raise NotImplementedError(spec.func)
    return out_vals, out_valid


def dense_aggregate(gid, D: int, aggs: list[AggSpec], sel):
    """aggregate() semantics over dense group ids."""
    return _run_aggs(aggs, sel, lambda job: reduce_job(gid, D, job))
