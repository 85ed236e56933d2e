"""Vectorized hash join — the port's counterpart of greengage_tpu/ops/join.py
(nodeHashjoin.c reimagined for static shapes), row-for-row identical to it.

Sort-based build: each segment's build rows sort ONCE by (bucket, exact key
columns), so rows with equal keys form contiguous *runs* inside their hash
bucket. The table is the sorted tensors plus CSR bucket offsets:

  build = 1 stable lexicographic sort + 1 batched binary search (bucket
          offsets) + a suffix minimum (the run-head hop pointers)
  probe = hop run-head to run-head inside the bucket; each hop is one
          gather per key column

Duplicate build keys are first-class: a probe hit lands on its run's head
and reads the run length, so unique joins (winner = first build row),
multi-match CSR expansion and duplicate detection (any run length > 1) all
fall out of the same structure.

Output keeps the probe side's capacity: each probe row gains a ``matched``
flag and a gathered build-row index, so inner/left/semi/anti joins are all
selection-mask updates plus gathers — no dynamic-size compaction.

SQL NULL semantics: a NULL join key equals nothing, so NULL-keyed rows on
either side never participate (they sort to the dead tail past every live
bucket). Float keys are canonicalized (-0.0 -> 0.0) before sorting so SQL
equality matches run grouping; NaN != NaN falls out of IEEE compare.

Segments are the leading axis: every tensor is ``[nseg, n]`` and a
segment's probe rows meet only its own build rows (the planner's Motions
put matching keys on one segment). Where the JAX package orders uint32 or
uint64 words, the port orders their signed images (bit 63 flipped), so run
order inside a bucket, and with it every hop count, is the JAX package's.

The probe walk is a loop whose trip count the data sets. Inactive rows never
change, so running more hops than needed gives the same result; the host
reads whether any probe is still active only after hops 2, 4, 8, ... (one
read each), so a walk of at most two hops costs one host read.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from greengage_tpu_torch.ops import hashing
from greengage_tpu_torch.ops.agg import BIG, KeySpec, _run_starts
from greengage_tpu_torch.ops.batch import member_batched
from greengage_tpu_torch.ops.sort import (BIT63, _lexsort, cumsum_rows,
                                          suffix_min_rows)


def _canon_values(k: KeySpec):
    """Key values under SQL equality: canonicalize float zeros."""
    v = k.values
    if v.dtype.is_floating_point:
        v = torch.where(v == 0.0, torch.zeros_like(v), v)
    return v


def _bucket_hash(keys: list[KeySpec]):
    """uint32 bucket hash (in int64) over the key columns.

    Joins only need build and probe to agree (probe TEXT codes are already
    translated into the build's code space by the binder), so every column
    — TEXT codes included — hashes as its integer representation; no
    dictionary LUT is needed here, unlike distribution hashing."""
    hs = []
    for k in keys:
        v = _canon_values(k)
        if v.dtype.is_floating_point:
            v = v.to(torch.float64).view(torch.int64)
        hs.append(hashing.hash_i64(v))
    return hashing.row_hash(hs)


def join_pack_bits(bounds: list | None) -> int | None:
    """Total bits to pack join-key tuples with per-key (lo, hi) integer
    bounds. NULL keys never participate in joins (strict selection), so no
    NULL slot is reserved — unlike agg.pack_bits. None = not packable."""
    if not bounds or any(b is None for b in bounds):
        return None
    total = 0
    for lo, hi in bounds:
        span = int(hi) - int(lo) + 1
        if span <= 0:
            return None
        total += max((span - 1).bit_length(), 1)
        if total > 64:
            return None
    return total


def pack_join_keys(keys: list[KeySpec], bounds: list):
    """Pack key columns into one word per row using the BUILD side's
    ANALYZE bounds. -> (signed image of the unsigned word int64[nseg, n],
    in_bounds): rows whose values fall outside the bounds get
    in_bounds=False — on the build side that is a stats-staleness
    violation (the caller flags it and retries unpacked); on the probe
    side such a row simply cannot match any build key. One word makes each
    hop of the probe walk one gather, and the build sort one key operand."""
    word = torch.zeros(keys[0].values.shape, dtype=torch.int64,
                       device=keys[0].values.device)
    in_bounds = torch.ones_like(word, dtype=torch.bool)
    for k, (lo, hi) in zip(keys, bounds):
        span = int(hi) - int(lo) + 1
        width = max((span - 1).bit_length(), 1)
        v = _canon_values(k).to(torch.int64)
        ok = (v >= lo) & (v <= hi)
        in_bounds = in_bounds & ok
        field = torch.where(ok, v - int(lo), torch.zeros_like(v))
        word = (word << width) | field
    return word ^ BIT63, in_bounds


def _strict(keys: list[KeySpec], sel):
    """Live rows whose every key is non-NULL: the rows that participate."""
    strict = sel
    for k in keys:
        if k.valid is not None:
            strict = strict & k.valid
    return strict


@dataclass
class SortTable:
    """Sorted-run join table (see module docstring), per segment.

    Tensors are ``[nseg, n]`` at *sorted position* granularity except
    ``starts``/``counts`` (``[nseg, M]``, bucket granularity).
    ``next_head[:, i]`` is the smallest run-head position >= i (BIG past
    the last run) — the probe walk's hop pointer. ``n_live`` ``[nseg]`` is
    the number of participating build rows (the dead tail starts there)."""

    keys_sorted: list[torch.Tensor]
    rows_sorted: torch.Tensor      # int64 build row index per position
    next_head: torch.Tensor        # int64
    starts: torch.Tensor           # int32 first position of bucket
    counts: torch.Tensor           # int32 live rows in bucket
    n_live: torch.Tensor           # int64 [nseg]
    dup: torch.Tensor              # bool scalar: duplicate build keys
    size: int
    # packed mode: keys_sorted is ONE word column; the probe must apply the
    # same packing (bounds) — build-side out-of-bounds values raise
    # pack_viol (stale stats -> caller re-runs unpacked)
    bounds: list | None = None
    pack_viol: torch.Tensor | None = None


def build(keys: list[KeySpec], sel, table_size: int, num_probes: int,
          key_bounds: list | None = None) -> SortTable:
    """Build the sorted-run table. ``num_probes`` is unused at build time
    (the probe walk takes its own bound). ``key_bounds`` (build-side
    ANALYZE (lo, hi) per key) switches to the packed one-word keys."""
    M = table_size
    assert M & (M - 1) == 0
    S, n = sel.shape
    dev = sel.device
    strict = _strict(keys, sel)
    h = _bucket_hash(keys)
    pack_viol = None
    bounds = None
    if key_bounds is not None and join_pack_bits(key_bounds) is not None:
        word, in_b = pack_join_keys(keys, key_bounds)
        pack_viol = (strict & ~in_b).any()
        # keep the table well-formed even when the flag fires (the run's
        # result is discarded): out-of-bounds rows drop from the table
        strict = strict & in_b
        kvals = [word]
        bounds = key_bounds
    else:
        kvals = [_canon_values(k) for k in keys]
    slot = torch.where(strict, (h & (M - 1)).to(torch.int32),
                       torch.full((), M, dtype=torch.int32, device=dev))
    rows_s = _lexsort([slot] + kvals, n)
    slot_s = slot.gather(1, rows_s)
    keys_s = [kv.gather(1, rows_s) for kv in kvals]
    live_s = slot_s < M

    # bucket b holds sorted positions [bounds[b], bounds[b + 1]): one binary
    # search per bucket over the sorted slots (the dead tail carries slot
    # M), the counts and exclusive prefix sums the JAX package scatters
    edges = torch.arange(M + 1, dtype=torch.int32, device=dev)
    edges = torch.searchsorted(slot_s, edges.expand(S, M + 1).contiguous(),
                               out_int32=True)
    starts = edges[:, :M]
    counts = edges[:, 1:] - starts

    # run heads: first position of each contiguous equal-key run. A bucket
    # boundary always starts a run (equal keys always share a bucket).
    head = _run_starts([slot_s] + keys_s, n) & live_s
    dup = (live_s & ~head).any()
    pos = torch.arange(n, device=dev).expand(S, n)
    next_head = suffix_min_rows(torch.where(head, pos, BIG), BIG)
    return SortTable(
        keys_sorted=keys_s, rows_sorted=rows_s, next_head=next_head,
        starts=starts, counts=counts, n_live=strict.sum(1), dup=dup,
        size=M, bounds=bounds, pack_viol=pack_viol)


def _walk(table: SortTable, keys: list[KeySpec], sel, num_probes: int):
    """Hop the probe's bucket run-head to run-head until its key's run is
    found or the bucket is exhausted. -> (matched, pos, run_count,
    overflow): pos is the run head's sorted position, run_count its
    length."""
    strict = _strict(keys, sel)
    h = _bucket_hash(keys)
    slot = h & (table.size - 1)
    start = table.starts.gather(1, slot).to(torch.int64)
    cnt = table.counts.gather(1, slot)
    end = start + cnt
    if table.bounds is not None:
        word, in_b = pack_join_keys(keys, table.bounds)
        # an out-of-bounds probe key cannot equal any (in-bounds) build key
        strict = strict & in_b
        kvals = [word]
    else:
        kvals = [_canon_values(k) for k in keys]
    n = table.rows_sorted.shape[1]
    last = max(n - 1, 0)

    def next_after(p):
        nxt = table.next_head.gather(1, torch.clamp(p + 1, 0, last))
        return torch.where(p + 1 < n, nxt, BIG)

    pos = start
    active = strict & (cnt > 0)
    matched = torch.zeros_like(sel)
    mpos = torch.zeros_like(start)
    for i in range(num_probes):
        # the JAX loop's condition, read after hops 2, 4, 8, ... (a
        # batched program's members walk the full bound: the hops after
        # the last active probe change nothing)
        if i >= 2 and i & (i - 1) == 0 and not member_batched(active) \
                and not bool(active.any()):
            break
        safe = torch.clamp(pos, 0, last)
        hit = active
        for kv, ks in zip(kvals, table.keys_sorted):
            hit = hit & (kv == ks.gather(1, safe))
        matched = matched | hit
        mpos = torch.where(hit, safe, mpos)
        # hop to the next run head in this bucket
        nxt = next_after(pos)
        active = active & ~hit & (nxt < end)
        pos = torch.where(active, nxt, pos)
    safe = torch.clamp(mpos, 0, last)
    run_end = torch.minimum(torch.minimum(next_after(mpos), end),
                            table.n_live[:, None])
    run_count = torch.where(matched, run_end - safe, 0)
    return matched, safe, run_count, active.any()


def probe(table: SortTable, keys: list[KeySpec], sel, num_probes: int):
    """-> (matched bool[nseg, n], build_row int64[nseg, n], walk_overflow
    bool scalar) over the probe batch. Duplicate build keys resolve to the
    run head = smallest build row index (the stable sort keeps row order
    within a run). walk_overflow means the hop bound was hit with probes
    still active — the caller ORs it into its overflow flag so the executor
    retries at the next tier (bigger table, higher bound)."""
    matched, pos, _, ov = _walk(table, keys, sel, num_probes)
    row = table.rows_sorted.gather(1, pos)
    return matched, torch.where(matched, row, 0), ov


# ---------------------------------------------------------------------------
# Multi-match join: duplicate build keys via the runs themselves
#
# A probe hit knows its run's start position and length, so the output
# expands via prefix sums + a binary search over a static output capacity —
# output row j maps to (probe_row[j], build_row[j]); an overflow flag plus
# the exact total cardinality feed the executor's tier retry, standing in
# for nodeHashjoin's dynamic batching under static shapes.
# ---------------------------------------------------------------------------


def build_multi(keys: list[KeySpec], sel, table_size: int, num_probes: int,
                key_bounds: list | None = None) -> SortTable:
    return build(keys, sel, table_size, num_probes, key_bounds)


def probe_multi(table: SortTable, keys: list[KeySpec], sel, num_probes: int,
                out_cap: int, left_outer: bool = False):
    """-> (present[nseg, K], probe_row[nseg, K], build_row[nseg, K],
    matched[nseg, K], expand_ov, walk_ov, total[nseg]) where total is the
    exact output cardinality per segment — the executor sizes the retry
    capacity from it when expand_ov fires. walk_ov must feed the
    TABLE-side overflow flag (grows M/hop bound at the next tier), NOT the
    expansion flag: ``total`` is an UNDERCOUNT when the walk gave up early.

    left_outer: unmatched probe rows still emit one output row with
    matched=False (NULL-extended build side downstream)."""
    matched, pos, run_count, walk_ov = _walk(table, keys, sel, num_probes)
    count = run_count
    if left_outer:
        count = torch.where(sel & ~matched, 1, count)
    S, P = count.shape
    dev = count.device
    cum = cumsum_rows(count.to(torch.int64))
    total = cum[:, -1] if P else torch.zeros(S, dtype=torch.int64,
                                             device=dev)
    overflow = (total > out_cap).any()
    j = torch.arange(out_cap, device=dev).expand(S, out_cap)
    probe_row = torch.searchsorted(cum, j.contiguous(), right=True)
    pr = torch.clamp(probe_row, 0, max(P - 1, 0))
    prev = torch.where(pr > 0, cum.gather(1, torch.clamp(pr - 1, min=0)), 0)
    ordinal = j - prev
    present = j < total[:, None]
    m_at = matched.gather(1, pr)
    n = table.rows_sorted.shape[1]
    at = torch.clamp(pos.gather(1, pr) + ordinal, 0, max(n - 1, 0))
    build_row = torch.where(m_at, table.rows_sorted.gather(1, at), 0)
    return present, pr, build_row, m_at & present, overflow, walk_ov, total


def gather_build_columns(build_cols: dict, build_valids: dict, build_row,
                         matched):
    """Pull build-side columns across to probe-side capacity. Unmatched rows
    get valid=False (LEFT OUTER null-extension for free)."""
    out_cols, out_valids = {}, {}
    for name, arr in build_cols.items():
        out_cols[name] = arr.gather(1, build_row)
        v = build_valids.get(name)
        gv = v.gather(1, build_row) if v is not None \
            else torch.ones_like(matched)
        out_valids[name] = gv & matched
    return out_cols, out_valids


# ---------------------------------------------------------------------------
# Direct-addressed join: dense integer build keys (the TPC-H PK-FK case)
#
# When ANALYZE shows the build key's domain [min, max] is comparable to the
# build row count (surrogate/sequence keys: orderkey, custkey, ...), the
# hash table degenerates to a dense array indexed by (key - min): build is
# ONE scatter, probe is ONE gather. Unique-key builds only (the dup flag
# reports violations for the executor's re-plan).
# ---------------------------------------------------------------------------


@dataclass
class DirectTable:
    slot_row: torch.Tensor      # int32 [nseg, domain]: build row or -1
    used: torch.Tensor
    overflow: torch.Tensor
    dup: torch.Tensor
    size: int


def build_direct(key: KeySpec, sel, lo: int, domain: int) -> DirectTable:
    """Dense build table over key values in [lo, lo+domain), per segment.

    A participating row scatters its row index to its key's slot (the max
    over duplicates) and adds 1 to the slot's count. Every other row adds
    the identity (row -1 to the max, 0 to the count) to slot row mod
    domain, so each slot holds what the JAX package's scatter gives it,
    while the dead rows — most of a Motion's output buffer, whose empty
    slots hold key 0 — do not pile onto the JAX package's one spare slot
    and serialise the card's atomics there."""
    S, n = sel.shape
    dev = sel.device
    v = key.values.to(torch.int64) - int(lo)
    strict = sel if key.valid is None else sel & key.valid
    in_dom = strict & (v >= 0) & (v < domain)
    rows = torch.arange(n, device=dev).expand(S, n)
    idx = torch.where(in_dom, v, rows % domain)
    slot_row = torch.full((S, domain), -1, dtype=torch.int32, device=dev)
    slot_row = slot_row.scatter_reduce(
        1, idx, torch.where(in_dom, rows.to(torch.int32), -1), "amax")
    # duplicates: a build row that did not win its key's slot shares the
    # key with another (the JAX package counts claims per slot: > 1)
    dup = (in_dom & (slot_row.gather(1, idx) != rows)).any()
    # out-of-domain LIVE build keys cannot be represented -> overflow (the
    # executor retries on the hash table at the next tier)
    return DirectTable(
        slot_row=slot_row, used=slot_row >= 0,
        overflow=(strict & ~in_dom).any(), dup=dup, size=domain)


def probe_direct(table: DirectTable, key: KeySpec, sel, lo: int):
    """-> (matched, build_row) — one gather, no walk, no key re-compare
    (slot index IS the key)."""
    v = key.values.to(torch.int64) - int(lo)
    strict = sel if key.valid is None else sel & key.valid
    in_dom = strict & (v >= 0) & (v < table.size)
    idx = torch.where(in_dom, v, 0)
    row = table.slot_row.gather(1, idx)
    matched = in_dom & (row >= 0)
    return matched, torch.where(matched, row, 0).to(torch.int64)
