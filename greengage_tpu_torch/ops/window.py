"""Window functions — the port's counterpart of greengage_tpu/ops/window.py
(nodeWindowAgg.c as sort + segmented scans), value-identical to it.

Rows arrive sorted by (partition keys, order keys), ``[nseg, cap]``: every
segment's rows in one call, where the JAX function sees one segment's 1-D
slice inside ``shard_map``. Partition and peer-group boundaries become
start and end index arrays, and every window value is then vectorized
arithmetic:

  row_number  = position - partition_start + 1
  rank        = peer_start - partition_start + 1
  dense_rank  = segmented count of peer boundaries
  sum/count/avg (ORDER BY present)  = running-to-last-peer via cumsum diffs
                (PG's default frame RANGE UNBOUNDED PRECEDING..CURRENT ROW)
  sum/count/avg (no ORDER BY)       = whole-partition via cumsum diffs
  min/max     = segmented scan (reset at partition starts)

The JAX package builds the start arrays with ``lax.cummax`` and the
segmented min/max with ``lax.associative_scan``. Torch scans a long last
axis of few rows with one thread block per row, so here a start or end is
a flat cumsum of the boundaries (each row's group number) and a gather
from a table of group firsts, and the segmented min/max is a log-step
doubling scan over the whole ``[nseg, cap]`` tensor.

The planner guarantees each partition is wholly on one segment, so
everything here is segment-local.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from greengage_tpu_torch.ops.sort import cumsum_rows, float_cumsum_rows


@dataclass
class WinFunc:
    name: str              # output column id
    func: str              # row_number | rank | dense_rank | sum | count |
    #                        avg | min | max | lag | lead | first_value |
    #                        last_value | ntile
    values: torch.Tensor | None
    valid: torch.Tensor | None
    decimal_scale: int = 0
    ordered: bool = False  # window had ORDER BY -> running (peer) frame
    param: object = None   # lag/lead offset (and default), ntile buckets


def ntile_bucket(rn, cnt, param: int):
    """PG ntile bucket (1-based) from a 0-based position within the
    partition and the partition row count (int64 tensors that broadcast)
    — the one formula shared by the segment-local function below and the
    global ordered and range windows (exec/compile.py)."""
    nb = int(param)
    q, r = cnt // nb, cnt % nb
    big = r * (q + 1)
    bucket = torch.where(rn < big,
                         rn // torch.clamp(q + 1, min=1),
                         r + (rn - big) // torch.clamp(q, min=1))
    # more buckets than rows: bucket = rn
    return torch.where(q == 0, torch.clamp(rn, max=nb - 1), bucket) + 1


def _spans(is_first):
    """-> (starts, ends) int64 [S, n]: the first and last index of each
    row's group, where ``is_first`` marks group firsts. Rows before the
    first marked row form a group that starts at 0. Each row's group
    number is a flat cumsum of the marks; a table holds each group's first
    index (plain stores: unmarked rows write a spare slot), and a start or
    end is a gather from it."""
    S, n = is_first.shape
    dev = is_first.device
    idx = torch.arange(n, device=dev).expand(S, n)
    g = cumsum_rows(is_first.to(torch.int64))
    firsts = torch.full((S, n + 2), n, dtype=torch.int64, device=dev)
    firsts = firsts.scatter(1, torch.where(is_first, g - 1, n + 1),
                            idx)[:, :n + 1]
    starts = torch.where(g > 0, firsts.gather(1, torch.clamp(g - 1, min=0)),
                         0)
    ends = firsts.gather(1, g) - 1
    return starts, ends


def _seg_scan_minmax(v, boundary, op):
    """Segmented running min/max along the last axis: the associative scan
    of (flag, value) pairs with reset at boundaries, as a log-step
    doubling scan (each step combines every row with the one d before it;
    min and max are exact in any order, and torch.minimum/maximum
    propagate NaN as jnp.minimum/maximum do)."""
    out, flag = v, boundary
    n = v.shape[-1]
    d = 1
    while d < n:
        pv, pf = out[:, :-d], flag[:, :-d]
        cv, cf = out[:, d:], flag[:, d:]
        out = torch.cat([out[:, :d], torch.where(cf, cv, op(pv, cv))], dim=1)
        flag = torch.cat([flag[:, :d], cf | pf], dim=1)
        d *= 2
    return out


def minmax_identity(dtype, func: str):
    """The identity fill of a min or max: +-inf for floats, the integer
    type's max or min."""
    if dtype.is_floating_point:
        return float("inf") if func == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if func == "min" else info.min


def prefix_sum(x):
    """Inclusive cumsum along the last axis: exact flat scan for integers,
    two-level scan for float64."""
    if x.dtype.is_floating_point:
        return float_cumsum_rows(x)
    return cumsum_rows(x)


def compute(partition_eq_prev, peer_eq_prev, sel_sorted, funcs: list[WinFunc],
            frame: tuple | None = None):
    """Window values over the SORTED batch, every segment at once.

    partition_eq_prev[:, i]: row i has the same partition keys as row i-1
    peer_eq_prev[:, i]: same partition AND same order keys as row i-1
    (both False at i=0 and for dead rows — dead rows sit at the end).
    frame: None = default RANGE peers; (a, b) = ROWS a PRECEDING..b
    FOLLOWING offsets (None = unbounded) applied to sum/count/avg and
    first/last_value via cumsum span differences clamped to the partition.
    -> {name: values}, {name: valid}
    """
    S, n = sel_sorted.shape
    dev = sel_sorted.device
    idx = torch.arange(n, device=dev).expand(S, n)
    p_bound = ~partition_eq_prev
    peer_bound = ~peer_eq_prev
    p_start, p_end = _spans(p_bound)
    peer_start, peer_end = _spans(peer_bound)
    last = max(n - 1, 0)

    def frame_span(has_order):
        """Per-row inclusive [lo, hi] row range the aggregate covers."""
        if frame is None:
            return p_start, (peer_end if has_order else p_end)
        a, b = frame
        lo = p_start if a is None else torch.maximum(p_start, idx - a)
        hi = p_end if b is None else torch.minimum(p_end, idx + b)
        return lo, hi

    out_vals, out_valid = {}, {}
    for f in funcs:
        if f.func == "row_number":
            out_vals[f.name] = idx - p_start + 1
            out_valid[f.name] = None
            continue
        if f.func == "rank":
            out_vals[f.name] = peer_start - p_start + 1
            out_valid[f.name] = None
            continue
        if f.func == "dense_rank":
            cb = cumsum_rows(peer_bound.to(torch.int64))
            out_vals[f.name] = cb - cb.gather(
                1, torch.clamp(p_start, 0, last)) + 1
            out_valid[f.name] = None
            continue
        if f.func == "ntile":
            cnt_p = p_end - p_start + 1
            out_vals[f.name] = ntile_bucket(idx - p_start, cnt_p, f.param)
            out_valid[f.name] = None
            continue
        values = None if f.values is None else f.values.expand(S, n)
        v = (torch.ones((S, n), dtype=torch.bool, device=dev)
             if f.valid is None else f.valid.expand(S, n))
        if f.func in ("lag", "lead"):
            k, default = f.param if isinstance(f.param, tuple) \
                else (f.param, None)
            src = idx - k if f.func == "lag" else idx + k
            ok = (src >= p_start) if f.func == "lag" else (src <= p_end)
            srcc = torch.clamp(src, 0, last)
            vals = values.gather(1, srcc)
            if default is not None:
                # SQL-standard third argument: out-of-partition offsets
                # yield the default instead of NULL
                vals = torch.where(ok, vals, torch.full_like(vals, default))
                out_valid[f.name] = (ok & v.gather(1, srcc) | ~ok) \
                    & sel_sorted
            else:
                out_valid[f.name] = ok & v.gather(1, srcc) & sel_sorted
            out_vals[f.name] = vals
            continue
        if f.func in ("first_value", "last_value"):
            lo, hi = frame_span(f.ordered)
            src = lo if f.func == "first_value" else hi
            srcc = torch.clamp(src, 0, last)
            out_vals[f.name] = values.gather(1, srcc)
            out_valid[f.name] = v.gather(1, srcc) & (hi >= lo) & sel_sorted
            continue

        has_order = f.ordered
        lv = sel_sorted & v
        lo_i, end = frame_span(has_order)
        if f.func in ("sum", "count", "avg"):
            if f.func == "count" and values is None:
                vals = torch.ones((S, n), dtype=torch.int64, device=dev)
            else:
                vals = values
            acc = torch.float64 if vals.dtype.is_floating_point \
                else torch.int64
            cs = prefix_sum(torch.where(lv, vals.to(acc),
                                        torch.zeros((), dtype=acc,
                                                    device=dev)))
            cnt = cumsum_rows(lv.to(torch.int64))
            below = torch.clamp(lo_i - 1, 0, last)
            base = torch.where(lo_i > 0, cs.gather(1, below),
                               torch.zeros((), dtype=acc, device=dev))
            cbase = torch.where(lo_i > 0, cnt.gather(1, below), 0)
            endc = torch.clamp(end, 0, last)
            s = cs.gather(1, endc) - base
            c = cnt.gather(1, endc) - cbase
            s = torch.where(end >= lo_i, s,
                            torch.zeros((), dtype=acc, device=dev))
            c = torch.where(end >= lo_i, c, 0)
            if f.func == "count":
                out_vals[f.name] = c
                out_valid[f.name] = None
            elif f.func == "sum":
                out_vals[f.name] = s
                out_valid[f.name] = c > 0
            else:
                avg = s.to(torch.float64) / torch.where(
                    c == 0, 1, c).to(torch.float64)
                if f.decimal_scale:
                    avg = avg / (10.0 ** f.decimal_scale)
                out_vals[f.name] = avg
                out_valid[f.name] = c > 0
            continue
        if f.func in ("min", "max"):
            filled = torch.where(lv, values, torch.full_like(
                values, minmax_identity(values.dtype, f.func)))
            op = torch.minimum if f.func == "min" else torch.maximum
            run = _seg_scan_minmax(filled, p_bound, op)
            cnt = cumsum_rows(lv.to(torch.int64))
            cbase = torch.where(
                p_start > 0,
                cnt.gather(1, torch.clamp(p_start - 1, 0, last)), 0)
            # frame semantics (binder allows running/whole ROWS frames only):
            #   default       -> peers (ordered) / whole partition
            #   ROWS ..CURRENT ROW   -> running value AT this row
            #   ROWS ..UNBOUNDED FOLLOWING -> whole partition
            if frame == (None, 0):
                end_mm = idx
            elif frame == (None, None):
                end_mm = p_end
            elif has_order:
                end_mm = peer_end
            else:
                end_mm = p_end
            out_vals[f.name] = run.gather(1, end_mm)
            out_valid[f.name] = (cnt.gather(1, end_mm) - cbase) > 0
            continue
        raise NotImplementedError(f.func)
    return out_vals, out_valid
