"""Grouped aggregation — the port's counterpart of greengage_tpu/ops/agg.py
(the execHHashagg.c analog).

DENSE: every group key has a known finite domain (TEXT dictionary / BOOL);
gid is a mixed-radix index and every aggregate reduces per (segment, group).
SORT: unbounded cardinality; rows sort by key within their segment and each
run of equal keys reduces with cumsum span differences (a scatter for
float64 sums and min/max). Tensors carry the segment axis first: gid and
values are ``[nseg, n]``, per-group results ``[nseg, D]``.
``scalar_aggregate`` is the same semantics with one group per segment (no
GROUP BY), as row reductions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from greengage_tpu_torch import types as T
from greengage_tpu_torch.ops.expr_eval import descale
from greengage_tpu_torch.ops.sort import BIT63, _lexsort, cumsum_rows

BIG = 2 ** 31 - 1   # int32 max: the hop pointer past the last run (ops/join)


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
    does). One group (a scalar aggregate) is a row reduction: a scatter of
    every row onto one address per segment serialises on the card's
    atomics."""
    if D == 1:
        return vals.sum(dim=1, keepdim=True)
    S = vals.shape[0]
    flat = _flat_index(gid, D)
    out = torch.zeros(S * D, dtype=vals.dtype, device=vals.device)
    return out.index_add(0, flat, vals.reshape(-1)).reshape(S, D)


def segment_minmax(gid, D: int, vals, func: str, ident):
    """Per-(segment, group) min or max -> [nseg, D]; groups without rows
    keep the identity. One group is a row reduction, as in segment_sum
    (dead rows already hold the identity)."""
    S = vals.shape[0]
    out = torch.full((S * D,), ident, dtype=vals.dtype, device=vals.device)
    if D == 1:
        if vals.shape[1] == 0:
            return out.reshape(S, 1)
        red = torch.amin if func == "min" else torch.amax
        return red(vals, dim=1, keepdim=True)
    flat = _flat_index(gid, D)
    red = "amin" if func == "min" else "amax"
    return out.scatter_reduce(0, flat, vals.reshape(-1), red,
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
    a scatter over seg*D + gid (a row reduction when D == 1, where gid is
    not read and may be None)."""
    if job.values is None:
        return segment_sum(gid, D, job.live.to(torch.int64))
    vals = job.values
    if job.op == "sum":
        zero = torch.zeros((), dtype=job.dtype, device=vals.device)
        return segment_sum(gid, D, torch.where(job.live, vals.to(job.dtype),
                                               zero))
    ident = job.ident.item() if hasattr(job.ident, "item") else job.ident
    # a fill on the device: torch.tensor(ident, device=...) copies from
    # pageable host memory, which waits for the card
    fill = torch.full((), ident, dtype=vals.dtype, device=vals.device)
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


def scalar_aggregate(aggs: list[AggSpec], sel):
    """aggregate() semantics with one group per segment (no GROUP BY):
    row reductions over the live rows, no group ids -> [nseg, 1] per
    aggregate."""
    return _run_aggs(aggs, sel, lambda job: reduce_job(None, 1, job))


# ---------------------------------------------------------------------------
# Sort-based grouping: the high-cardinality path.
#
# Past the dense-domain regime rows sort by their group keys within each
# segment and every run of equal keys reduces with segmented cumsum-diffs —
# cardinality bounded only by the batch itself (a GROUP BY never produces
# more groups than input rows); only the output capacity chosen for the
# batch above can overflow, which retries through the executor's exact-count
# tier mechanism.
#
# torch sorts no uint64, so every unsigned operand of the JAX package's
# lax.sort is carried as its signed image (bit 63 flipped), whose int64
# order is the uint64 order; the multi-operand sort is ops/sort's chained
# stable sorts, which with the row index as the last operand gives the same
# permutation.
# ---------------------------------------------------------------------------


def _group_encode(k: KeySpec) -> list:
    """Equality-preserving 64-bit encoding (+ a null operand when nullable),
    as the signed image of the JAX package's uint64. Grouping needs
    equal-keys-adjacent, not collation order, so TEXT groups by dictionary
    code and float64 only canonicalizes -0.0/NaN."""
    v = k.values
    if k.type.kind is T.Kind.FLOAT64:
        v = v.to(torch.float64)
        v = torch.where(v == 0.0, torch.zeros_like(v), v)
        v = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), v)
        enc = v.view(torch.int64) ^ BIT63
    else:
        enc = v.to(torch.int64) ^ BIT63
    ops = []
    if k.valid is not None:
        ops.append(k.valid.to(torch.uint8))
        # a NULL row's value operand is uint64 0, whose signed image is BIT63
        enc = torch.where(k.valid, enc, torch.full_like(enc, BIT63))
    ops.append(enc)
    return ops


def pack_bits(bounds: list) -> int | None:
    """Total packed bits for per-key integer bounds [(lo, hi) | None].
    Each key takes ceil(log2(hi - lo + 2)) bits (the +2 reserves field
    value 0 for NULL) plus nothing else. None when any key is unbounded
    or the fields exceed 63 bits (bit 63 carries the dead-row flag)."""
    if not bounds or any(b is None for b in bounds):
        return None
    total = 0
    for lo, hi in bounds:
        span = int(hi) - int(lo) + 2
        if span <= 1:
            span = 2
        total += max(span - 1, 1).bit_length()
        if total > 63:
            return None
    return total


def pack_keys(keys: list[KeySpec], bounds: list, sel):
    """Pack stats-bounded integer keys into ONE 64-bit word per row (dead
    flag in bit 63, then per-key fields, NULL = field value 0).

    -> (signed image of the uint64 word [nseg, n], violation bool scalar).
    ``violation`` fires when any LIVE, non-NULL value falls outside its
    advertised bound — packing would alias distinct keys, so the caller
    must re-run unpacked (stale ANALYZE stats). Equal words <=> equal key
    tuples (including NULL positions) whenever violation is False."""
    word = torch.zeros(sel.shape, dtype=torch.int64, device=sel.device)
    violation = torch.zeros((), dtype=torch.bool, device=sel.device)
    for k, (lo, hi) in zip(keys, bounds):
        span = max(int(hi) - int(lo) + 2, 2)
        width = max(span - 1, 1).bit_length()
        v = k.values.to(torch.int64)
        in_b = (v >= lo) & (v <= hi)
        live = sel if k.valid is None else (sel & k.valid)
        violation = violation | (live & ~in_b).any()
        field = torch.where(in_b, v - int(lo) + 1, torch.zeros_like(v))
        if k.valid is not None:
            field = torch.where(k.valid, field, torch.zeros_like(field))
        word = (word << width) | field
    word = torch.where(sel, word, word | BIT63)
    return word ^ BIT63, violation


def _run_starts(sorted_ops: list, n: int):
    """bool [nseg, n]: the first row of every run of equal operands."""
    S = sorted_ops[0].shape[0]
    first = torch.ones((S, min(n, 1)), dtype=torch.bool,
                       device=sorted_ops[0].device)
    if n <= 1:
        return first
    neq = None
    for s in sorted_ops:
        d = s[:, 1:] != s[:, :-1]
        neq = d if neq is None else neq | d
    return torch.cat([first, neq], dim=1)


def group_sort(keys: list[KeySpec], sel, bounds: list | None = None):
    """Sort each segment's rows by group keys, dead rows last.

    -> (perm int64[nseg, n], boundary bool[nseg, n], sel_sorted
    bool[nseg, n], violation): perm is the gather permutation (sorted_col =
    col.gather(1, perm)); boundary marks the first (live) row of each
    equal-key run — the group's representative row. ``bounds`` (per-key
    (lo, hi) from ANALYZE) enables the packed single-operand sort;
    violation is a bool scalar the caller must route to an overflow flag
    (None when packing was not attempted)."""
    n = sel.shape[-1]
    if bounds is not None and pack_bits(bounds) is not None:
        word, violation = pack_keys(keys, bounds, sel)
        perm = _lexsort([word], n)
        wkey = word.gather(1, perm)
        # the dead flag is bit 63 of the uint64 word: a non-negative image
        sel_sorted = wkey < 0
        return perm, sel_sorted & _run_starts([wkey], n), sel_sorted, \
            violation

    dead = (~sel).to(torch.uint8)
    key_ops = []
    for k in keys:
        key_ops.extend(_group_encode(k))
    perm = _lexsort([dead] + key_ops, n)
    sel_sorted = dead.gather(1, perm) == 0
    if key_ops:
        first = _run_starts([op.gather(1, perm) for op in key_ops], n)
    else:
        first = torch.zeros_like(sel_sorted)
        first[:, :1] = True
    return perm, sel_sorted & first, sel_sorted, None


def sorted_group_aggregate(boundary, sel_sorted, aggs: list[AggSpec],
                           out_cap: int):
    """Table-shaped aggregation over key-sorted rows, per segment.

    -> (vals {name: [nseg, out_cap]}, valids, srcpos int64[nseg, out_cap],
    total int64[nseg]) where group g's values live at slot g (groups
    numbered in key-sort order) and srcpos[:, g] is the SORTED-row index of
    g's first row (gather keys there). Groups beyond out_cap are dropped —
    the caller flags total > out_cap and retries with the exact count.

    Sums and counts are a whole-row cumsum and a span difference at the
    group boundaries; int64 (scaled DECIMAL) sums split into 32-bit limbs
    with separate cumsums, so the span difference is exact whatever the
    batch magnitude. float64 sums and min/max scatter into the group-id
    table (floats cannot limb-split: a span of two near-equal prefixes
    would lose the small group's precision). All spec tensors must already
    be key-sorted."""
    S, n = sel_sorted.shape
    dev = sel_sorted.device
    csb = cumsum_rows(boundary.to(torch.int64))
    total = csb[:, -1] if n else torch.zeros(S, dtype=torch.int64, device=dev)
    # first sorted row of group g; RAW positions keep n for absent groups
    # so the span ends don't truncate the last real group off by one. The
    # JAX package's static choice between its two forms, from its measured
    # costs: a scatter once out_cap is a sizable fraction of the batch,
    # else a binary search per slot. Every real slot has exactly one
    # boundary row, so a plain store gives the scatter-min's slots
    if out_cap * 26 * 10.7 > n * 90:
        stgt = torch.where(boundary, torch.clamp(csb - 1, max=out_cap),
                           out_cap)
        rows = torch.arange(n, device=dev).expand(S, n)
        raw = torch.full((S, out_cap + 1), n, dtype=torch.int64, device=dev)
        raw = raw.scatter(1, stgt, rows)[:, :out_cap]
    else:
        want = torch.arange(1, out_cap + 1, device=dev).expand(S, out_cap)
        raw = torch.searchsorted(csb, want.contiguous())
    last = max(n - 1, 0)
    ends = torch.cat([raw[:, 1:], torch.full((S, 1), n, dtype=torch.int64,
                                             device=dev)], dim=1)
    ends = torch.clamp(ends - 1, 0, last)
    srcpos = torch.clamp(raw, 0, last)
    # per-row group slot (dead rows get the last group's id but every
    # reducer masks them to the identity)
    gid = csb - 1
    tgt = torch.where((gid >= 0) & (gid < out_cap), gid, out_cap)
    before = torch.clamp(srcpos - 1, 0, last)

    def span(cs):
        base = torch.where(srcpos > 0, cs.gather(1, before),
                           torch.zeros((), dtype=cs.dtype, device=dev))
        return cs.gather(1, ends) - base

    def reduce(job: Job):
        if job.values is None:
            masked = job.live.to(torch.int64)
        elif job.op == "sum":
            zero = torch.zeros((), dtype=job.dtype, device=dev)
            masked = torch.where(job.live, job.values.to(job.dtype), zero)
        else:
            ident = job.ident.item() if hasattr(job.ident, "item") \
                else job.ident
            fill = torch.full((), ident, dtype=job.values.dtype, device=dev)
            filled = torch.where(job.live, job.values, fill)
            tbl = torch.full((S, out_cap + 1), ident, dtype=filled.dtype,
                             device=dev)
            red = "amin" if job.op == "min" else "amax"
            return tbl.scatter_reduce(1, tgt, filled, red)[:, :out_cap]
        if masked.dtype == torch.int64:
            lo = masked & 0xFFFFFFFF           # [0, 2^32)
            hi = masked >> 32                  # arithmetic shift
            return (span(cumsum_rows(hi)) << 32) + span(cumsum_rows(lo))
        if masked.dtype == torch.float64:
            tbl = torch.zeros((S, out_cap + 1), dtype=torch.float64,
                              device=dev)
            return tbl.scatter_add(1, tgt, masked)[:, :out_cap]
        return span(cumsum_rows(masked))

    vals, valids = _run_aggs(aggs, sel_sorted, reduce)
    return vals, valids, srcpos, total
