"""The port's hashing (greengage_tpu_torch/ops/hashing.py) against the JAX
package's and the storage layer's: distribution hashes must be
bit-identical, or rows land on other segments than the storage put them."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from greengage_tpu import types as JT
from greengage_tpu.ops import hashing as jh
from greengage_tpu.storage import native
from greengage_tpu.storage.dictionary import Dictionary
from greengage_tpu_torch import types as TT
from greengage_tpu_torch.ops import hashing as th

# edge values first: products of values >= 2^31 pass 2^63 inside the
# port's int64 arithmetic, and negative values exercise the masked shifts
EDGES = [0, 1, -1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, -(2**31), 2**40,
         -(2**40), 987654321, 2**63 - 1, -(2**63)]


def _vals(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    rand = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    return np.concatenate([np.array(EDGES, dtype=np.int64), rand])


def _jax(a):
    return np.asarray(a).astype(np.int64)


def _port(t):
    return t.numpy().astype(np.int64)


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_hash_i64_bit_identical(seed):
    v = _vals(seed=seed & 0xFF)
    want = _jax(jh.hash_i64(jnp.asarray(v), seed))
    got = _port(th.hash_i64(torch.from_numpy(v), seed))
    assert np.array_equal(got, want)
    assert np.array_equal(got, native.hash_i64(v, seed).astype(np.int64))


def test_hash_combine_and_row_hash_bit_identical():
    a, b, c = _vals(seed=1), _vals(seed=2), _vals(seed=3)
    jcols = [jh.hash_i64(jnp.asarray(x)) for x in (a, b, c)]
    tcols = [th.hash_i64(torch.from_numpy(x)) for x in (a, b, c)]
    assert np.array_equal(_port(th.hash_combine(tcols[0], tcols[1])),
                          _jax(jh.hash_combine(jcols[0], jcols[1])))
    assert np.array_equal(_port(th.row_hash(tcols)), _jax(jh.row_hash(jcols)))


@pytest.mark.parametrize("nseg", [1, 3, 8])
def test_segment_of_matches_storage_placement(nseg):
    v = _vals(seed=4)
    want = np.asarray(jh.segment_of(jh.hash_i64(jnp.asarray(v)), nseg))
    got = th.segment_of(th.hash_i64(torch.from_numpy(v)), nseg)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    host = (native.hash_i64(v) % np.uint32(nseg)).astype(np.int32)
    assert np.array_equal(got.numpy(), host)


def test_column_hash_float_null_and_text():
    f = np.array([0.0, -0.0, 1.5, -2.25, np.nan, -np.nan, np.inf, 1e300])
    valid = np.array([1, 1, 1, 0, 1, 1, 1, 1], dtype=bool)
    want = _jax(jh.column_hash(jnp.asarray(f), jnp.asarray(valid), JT.FLOAT64))
    got = _port(th.column_hash(torch.from_numpy(f), torch.from_numpy(valid),
                               TT.FLOAT64))
    assert np.array_equal(got, want)
    assert got[0] == got[1]                      # -0.0 hashes as 0.0
    assert got[3] == 0                           # NULL contributes 0

    words = ["A", "N", "R", "", "TAKE BACK RETURN", "ünïcode", "x" * 17]
    lut = th.text_hash_lut(words)
    assert np.array_equal(_port(lut), Dictionary(list(words)).hashes()
                          .astype(np.int64))
    codes = np.array([0, 2, -1, 6, 4], dtype=np.int32)
    want = _jax(jh.column_hash(jnp.asarray(codes), None, JT.TEXT,
                               text_lut=jnp.asarray(Dictionary(list(words))
                                                    .hashes())))
    got = _port(th.column_hash(torch.from_numpy(codes), None, TT.TEXT,
                               text_lut=lut))
    assert np.array_equal(got, want)
    assert got[2] == 0                           # code -1 -> sentinel row


@pytest.mark.parametrize("s", ["", "F", "hello world", "exactly8", "nine char",
                               "Customer#000000001"])
def test_hash_text_matches_storage(s):
    assert th.hash_text(s) == native.hash_bytes(s.encode("utf-8"))
