"""Multi-key sort — the port's counterpart of greengage_tpu/ops/sort.py (the
tuplesort analog), row-order identical to it.

Every ORDER BY key is encoded order-preservingly into 64 bits:

  int-like  : two's-complement sign flip
  float64   : IEEE trick (negatives bit-inverted)
  text      : dictionary-rank LUT gather (int32 rank), host-precomputed
  DESC      : bitwise NOT of the encoding
  NULLs     : a separate leading operand per nullable key orders the null
              group before/after values (PG defaults: NULLS LAST for ASC,
              NULLS FIRST for DESC)

The JAX package orders those encodings as uint64; torch cannot sort uint64,
so the port carries each encoding's SIGNED IMAGE (bit 63 flipped), whose
int64 order is the uint64 order. Multi-operand ``lax.sort`` becomes chained
stable sorts from the least significant operand, which gives the same
permutation as a lexicographic sort with the row index as the last operand.

Dead rows (sel = false) sort to the end via a leading liveness key. Tensors
are ``[nseg, cap]``; every segment sorts its own row.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from greengage_tpu_torch import types as T

BIT63 = -(1 << 63)        # int64 with only bit 63 set: x ^ BIT63 flips it


@dataclass
class SortKey:
    values: torch.Tensor
    valid: torch.Tensor | None
    type: object                      # T.SqlType
    desc: bool = False
    nulls_first: bool | None = None   # None = PG default by direction
    rank_lut: torch.Tensor | None = None  # TEXT collation ranks


def encode_key64(v, desc: bool, kind: str):
    """Signed image of the order-preserving uint64 encoding of one key
    column. ``kind``: "float" (IEEE trick) or "int" (sign flip, whose
    signed image is the value itself); DESC = bitwise NOT."""
    if kind == "float":
        bits = v.to(torch.float64).view(torch.int64)
        # uint64 encoding: negatives bit-inverted, others get bit 63 set;
        # flipping bit 63 of that gives its signed image
        enc = torch.where(bits < 0, ~bits ^ BIT63, bits)
    else:
        enc = v.to(torch.int64)
    if desc:
        enc = ~enc
    return enc


def _order_encode(k: SortKey) -> list:
    """-> sort operands for this key: [null_order?, encoded_values]."""
    t: T.SqlType = k.type
    v = k.values
    if t.kind is T.Kind.TEXT:
        if k.rank_lut is None:
            raise ValueError("text sort key requires rank LUT")
        idx = torch.where(v < 0, k.rank_lut.shape[0] - 1, v.to(torch.int64))
        v = k.rank_lut[idx]
    enc = encode_key64(
        v, k.desc, "float" if t.kind is T.Kind.FLOAT64 else "int")
    ops = [enc]
    if k.valid is not None:
        nulls_first = k.nulls_first if k.nulls_first is not None else k.desc
        null_pos = 0 if nulls_first else 1
        ops.insert(0, torch.where(k.valid, 1 - null_pos, null_pos).to(
            torch.uint8))
        # neutralize the value operand for null rows so ties are
        # deterministic (uint64 0, whose signed image is BIT63)
        ops[1] = torch.where(k.valid, enc, torch.full_like(enc, BIT63))
    return ops


def order_bounds_bits(bounds: list | None, nkeys: int) -> int | None:
    """Shared field-width budget for ORDER BY key packing: per-key (lo, hi)
    integer bounds must be known for EVERY key and their (span + NULL slot)
    fields fit 63 bits (bit 63 carries the dead-row flag)."""
    if bounds is None or len(bounds) != nkeys \
            or any(b is None for b in bounds):
        return None
    total = 0
    for lo, hi in bounds:
        span = int(hi) - int(lo) + 1
        if span <= 0:
            return None
        total += max(span.bit_length(), 1)   # span+1 field values (NULL)
        if total > 63:
            return None
    return total


def order_pack_bits(keys: list[SortKey], bounds: list | None) -> int | None:
    """Packed-operand feasibility for concrete SortKeys (TEXT collation
    ranks are not packable)."""
    if any(k.rank_lut is not None for k in keys):
        return None
    return order_bounds_bits(bounds, len(keys))


def pack_order_keys(keys: list[SortKey], bounds: list, sel):
    """Order-preserving pack of bounded integer ORDER BY keys into one
    word (dead flag at bit 63, fields MSB-first in key priority):

      ASC : field = v - lo (+1 when NULLS FIRST); NULL = 0 or span
      DESC: field = hi - v (+1 when NULLS FIRST); NULL = 0 or span

    -> (word: signed image of the uint64 word [nseg, n], violation bool
    scalar): violation = a live non-NULL value outside its advertised
    bound (stale stats) — packing would mis-order, caller re-runs
    unpacked."""
    word = torch.zeros(sel.shape, dtype=torch.int64, device=sel.device)
    violation = torch.zeros((), dtype=torch.bool, device=sel.device)
    for k, (lo, hi) in zip(keys, bounds):
        span = int(hi) - int(lo) + 1
        width = max(span.bit_length(), 1)
        v = k.values.to(torch.int64)
        in_b = (v >= lo) & (v <= hi)
        live = sel if k.valid is None else (sel & k.valid)
        violation = violation | (live & ~in_b).any()
        base = (int(hi) - v) if k.desc else (v - int(lo))
        base = torch.where(in_b, base, torch.zeros_like(base))
        nulls_first = k.nulls_first if k.nulls_first is not None else k.desc
        if nulls_first:
            field, null_val = base + 1, 0
        else:
            field, null_val = base, span
        if k.valid is not None:
            field = torch.where(k.valid, field, torch.full_like(field, null_val))
        word = (word << width) | field
    word = torch.where(sel, word, word | BIT63)
    return word ^ BIT63, violation


def _lexsort(operands, n: int):
    """Stable lexicographic argsort of [nseg, n] operands along the last
    axis (first operand most significant) — chained stable sorts from the
    least significant operand."""
    first = operands[0]
    perm = torch.arange(n, device=first.device).expand(first.shape).contiguous()
    for op in reversed(operands):
        _, idx = torch.sort(op.gather(-1, perm), dim=-1, stable=True)
        perm = perm.gather(-1, idx)
    return perm


def sort_batch(keys: list[SortKey], sel, capacity: int,
               bounds: list | None = None):
    """-> (perm int64[nseg, capacity], sel_sorted bool[nseg, capacity],
    violation).

    perm is the gather permutation: out_col = col.gather(-1, perm). Stable
    on ties. ``bounds`` enables the packed single-operand sort; violation
    is None when packing wasn't attempted, else a bool scalar the caller
    must route to a pack-overflow flag.
    """
    if bounds is not None and order_pack_bits(keys, bounds) is not None:
        word, violation = pack_order_keys(keys, bounds, sel)
        perm = _lexsort([word], capacity)
        # the dead flag is bit 63 of the uint64 word: a non-negative image
        sel_sorted = word.gather(-1, perm) < 0
        return perm, sel_sorted, violation

    dead = (~sel).to(torch.uint8)        # live rows first
    operands = [dead]
    for k in keys:
        operands.extend(_order_encode(k))
    perm = _lexsort(operands, capacity)
    return perm, dead.gather(-1, perm) == 0, None


def apply_perm(cols: dict, valids: dict, perm):
    out_c = {n: a.gather(-1, perm) for n, a in cols.items()}
    out_v = {n: (a.gather(-1, perm) if a is not None else None)
             for n, a in valids.items()}
    return out_c, out_v


def limit(cols: dict, valids: dict, sel, k: int):
    """Static LIMIT after a sort (rows already compacted to the front)."""
    out_c = {n: a[..., :k] for n, a in cols.items()}
    out_v = {n: (a[..., :k] if a is not None else None)
             for n, a in valids.items()}
    return out_c, out_v, sel[..., :k]


def compact(cols: dict, valids: dict, sel, k: int):
    """Gather the live rows (order preserved) into the first min(live, k)
    slots of a k-capacity batch, without a sort: a cumsum and one binary
    search per output slot (slot j reads the row where cumsum(sel) first
    reaches j+1).

    -> (cols, valids, sel_out) with capacity k; rows beyond k are DROPPED
    (callers pair this with an overflow flag on count > k).
    """
    S, n = sel.shape
    cs = torch.cumsum(sel.to(torch.int32), dim=-1)
    total = cs[:, -1:] if n else torch.zeros((S, 1), dtype=torch.int32,
                                             device=sel.device)
    want = torch.arange(1, k + 1, dtype=torch.int32, device=sel.device)
    src = torch.searchsorted(cs, want.expand(S, k).contiguous())
    src = src.clamp(0, max(n - 1, 0))
    out_c = {name: a.gather(-1, src) for name, a in cols.items()}
    out_v = {name: (a.gather(-1, src) if a is not None else None)
             for name, a in valids.items()}
    sel_out = want.expand(S, k) <= total
    return out_c, out_v, sel_out
