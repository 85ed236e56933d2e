"""Distribution/group hashing — the port's counterpart of
greengage_tpu/ops/hashing.py, bit-identical to it.

fmix32 over the 32-bit halves of each 64-bit value, FNV-combine across
columns, NULL column contributes hash 0, placement = row_hash % numsegments.

Torch has little uint32 arithmetic, so a hash is an int64 tensor holding a
value in [0, 2^32): products are taken in int64 (they may wrap past 2^63;
the low 32 bits stay right) and masked back to 32 bits, and every right
shift of a value that may be negative is masked after it (torch shifts
int64 arithmetically).
"""

from __future__ import annotations

import numpy as np
import torch

from greengage_tpu_torch import to_device
from greengage_tpu_torch import types as T
from greengage_tpu_torch.storage.native import hash_bytes

HASH_INIT = 0x9E3779B9
COMBINE_MUL = 0x01000193
M32 = 0xFFFFFFFF
_CANON_NAN_BITS = 0x7FF8000000000000


def _fmix32(h):
    h = h & M32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    h = h ^ (h >> 16)
    return h


def hash_i64(vals, seed: int = 0):
    """uint32 hash (as int64) of an int64-representable tensor."""
    u = vals.to(torch.int64)
    lo = u & M32
    hi = (u >> 32) & M32
    h = (seed ^ HASH_INIT) & M32
    h = _fmix32(lo ^ h)
    h = _fmix32(h ^ hi)
    return h


def hash_combine(acc, h):
    return _fmix32(((acc * COMBINE_MUL) & M32) ^ h)


def _canon_f64_bits(arr):
    """hashfloat8 parity: -0.0 -> 0.0, all NaNs -> one pattern."""
    arr = torch.where(arr == 0.0, torch.zeros_like(arr), arr)
    bits = arr.view(torch.int64)
    return torch.where(torch.isnan(arr),
                       torch.full_like(bits, _CANON_NAN_BITS), bits)


def column_hash(arr, valid, type_: T.SqlType, seed: int = 0, text_lut=None):
    """Per-column hash; NULL rows -> 0. TEXT uses the dictionary hash LUT
    (one extra sentinel row, hash 0, for code -1)."""
    if type_.kind is T.Kind.TEXT:
        if text_lut is None:
            raise ValueError("TEXT hashing requires the dictionary hash LUT")
        idx = torch.where(arr < 0, text_lut.shape[0] - 1, arr.to(torch.int64))
        h = text_lut[idx]
    elif type_.kind is T.Kind.FLOAT64:
        h = hash_i64(_canon_f64_bits(arr.to(torch.float64)), seed)
    else:
        h = hash_i64(arr, seed)
    if valid is not None:
        h = torch.where(valid, h, torch.zeros_like(h))
    return h


def row_hash(col_hashes):
    """Combine per-column hashes: acc = h0; acc = combine(acc, hi)."""
    acc = col_hashes[0]
    for h in col_hashes[1:]:
        acc = hash_combine(acc, h)
    return acc


def segment_of(rowhash, numsegments: int):
    return (rowhash % numsegments).to(torch.int32)


def hash_text(s: str, seed: int = 0) -> int:
    """uint32 hash of a string's UTF-8 bytes (8-byte little-endian chunk
    folding + length): the storage layer's ``hash_bytes``
    (storage/native.py), its one definition, which TEXT dictionary hash
    LUTs and row placement are built from."""
    return hash_bytes(s.encode("utf-8"), seed)


def text_hash_lut(values: list[str], device=None) -> torch.Tensor:
    """Per-dictionary-entry hashes plus the sentinel row (hash 0): the
    values of the storage dictionary's ``hashes()``, which the JAX compiler
    reads."""
    lut = np.fromiter((hash_bytes(v.encode("utf-8")) for v in values),
                      dtype=np.int64, count=len(values))
    return to_device(np.concatenate([lut, np.zeros(1, np.int64)]),
                     device or "cpu", torch.int64)
