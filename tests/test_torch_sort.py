"""The port's sort (greengage_tpu_torch/ops/sort.py) against the JAX
package's, segment by segment: the same permutation (stable, dead rows
last) from the multi-operand and the packed single-word paths, and the
same compaction."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import greengage_tpu  # noqa: F401  (enables x64)
from greengage_tpu import types as JT
from greengage_tpu.ops import sort as jsort
from greengage_tpu_torch import types as TT
from greengage_tpu_torch.ops import sort as tsort

NSEG, N = 3, 400


def _data(seed=0):
    rng = np.random.default_rng(seed)
    words = ["pear", "apple", "fig", "banana", "kiwi"]
    rank = np.argsort(np.argsort(np.asarray(words, dtype=object),
                                 kind="stable"), kind="stable")
    return dict(
        i=rng.integers(-5, 6, (NSEG, N)).astype(np.int64),  # many ties
        i_valid=rng.random((NSEG, N)) < 0.85,
        f=np.where(rng.random((NSEG, N)) < 0.1, -0.0,
                   rng.normal(size=(NSEG, N)).round(1)),
        t=rng.integers(-1, len(words), (NSEG, N)).astype(np.int32),
        lut=np.concatenate([rank, [-1]]).astype(np.int32),
        d=rng.integers(8000, 8040, (NSEG, N)).astype(np.int32),
        sel=rng.random((NSEG, N)) < 0.7,
    )


def _keys(side, d, s, spec):
    if side == "jax":
        mod, T, xp = jsort, JT, (lambda a: jnp.asarray(a[s]))
        lut = jnp.asarray(d["lut"])
    else:
        mod, T, xp = tsort, TT, torch.from_numpy
        lut = torch.from_numpy(d["lut"]).to(torch.int64)
    out = []
    for col, desc, nf in spec:
        if col == "i":
            out.append(mod.SortKey(xp(d["i"]), xp(d["i_valid"]), T.INT64,
                                   desc, nf))
        elif col == "f":
            out.append(mod.SortKey(xp(d["f"]), None, T.FLOAT64, desc, nf))
        elif col == "t":
            out.append(mod.SortKey(xp(d["t"]), None, T.TEXT, desc, nf,
                                   rank_lut=lut))
        else:
            out.append(mod.SortKey(xp(d["d"]), None, T.DATE, desc, nf))
    return out


SPECS = {
    "int_nullable_asc": [("i", False, None)],
    "int_desc_nulls_last": [("i", True, False)],
    "float_then_int": [("f", False, None), ("i", True, None)],
    "float_desc": [("f", True, None)],
    "text_rank_then_date": [("t", False, None), ("d", True, None)],
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_sort_batch_matches_jax(name):
    d = _data()
    perm, sel_sorted, viol = tsort.sort_batch(
        _keys("torch", d, None, SPECS[name]), torch.from_numpy(d["sel"]), N)
    assert viol is None
    for s in range(NSEG):
        jperm, jsel, _ = jsort.sort_batch(
            _keys("jax", d, s, SPECS[name]), jnp.asarray(d["sel"][s]), N)
        assert np.array_equal(perm[s].numpy(), np.asarray(jperm))
        assert np.array_equal(sel_sorted[s].numpy(), np.asarray(jsel))


@pytest.mark.parametrize("desc,nf", [(False, None), (True, None),
                                     (False, True)])
def test_packed_sort_matches_jax(desc, nf):
    d = _data(1)
    spec = [("d", desc, nf), ("i", not desc, nf)]
    bounds = [(8000, 8039), (-5, 5)]
    tkeys = _keys("torch", d, None, spec)
    assert tsort.order_pack_bits(tkeys, bounds) is not None
    perm, sel_sorted, viol = tsort.sort_batch(
        tkeys, torch.from_numpy(d["sel"]), N, bounds)
    assert not bool(viol)
    for s in range(NSEG):
        jperm, jsel, jviol = jsort.sort_batch(
            _keys("jax", d, s, spec), jnp.asarray(d["sel"][s]), N, bounds)
        assert np.array_equal(perm[s].numpy(), np.asarray(jperm))
        assert np.array_equal(sel_sorted[s].numpy(), np.asarray(jsel))
    # a live value outside the advertised bounds is reported
    _, _, viol = tsort.sort_batch(tkeys, torch.from_numpy(d["sel"]), N,
                                  [(8000, 8039), (-2, 2)])
    assert bool(viol)


def test_encode_key64_orders_like_uint64():
    v = np.array([-np.inf, -3.5, -0.0, 0.0, 1e-300, 2.0, np.inf])
    for desc in (False, True):
        enc = tsort.encode_key64(torch.from_numpy(v), desc, "float").numpy()
        jenc = np.asarray(jsort.encode_key64(jnp.asarray(v), desc, "float"))
        # the port's signed image is the JAX uint64 encoding, bit 63 flipped
        assert np.array_equal(enc.view(np.uint64) ^ np.uint64(1 << 63), jenc)


@pytest.mark.parametrize("k", [1, 150, N])
def test_compact_matches_jax(k):
    d = _data(2)
    cols = {"i": torch.from_numpy(d["i"])}
    valids = {"i": torch.from_numpy(d["i_valid"])}
    oc, ov, osel = tsort.compact(cols, valids, torch.from_numpy(d["sel"]), k)
    for s in range(NSEG):
        jc, jv, jsel = jsort.compact({"i": jnp.asarray(d["i"][s])},
                                     {"i": jnp.asarray(d["i_valid"][s])},
                                     jnp.asarray(d["sel"][s]), k)
        assert np.array_equal(osel[s].numpy(), np.asarray(jsel))
        live = np.asarray(jsel)
        assert np.array_equal(oc["i"][s].numpy()[live],
                              np.asarray(jc["i"])[live])
        assert np.array_equal(ov["i"][s].numpy()[live],
                              np.asarray(jv["i"])[live])


@pytest.mark.parametrize("shape", [(1, 5), (3, 1000), (8, 3001), (2, 2048),
                                   (4, 0)])
def test_row_scans_equal_torch(shape):
    """cumsum_rows and suffix_min_rows (the flat and two-level scans the
    port takes on the card) equal torch's own scans along the last axis,
    int64 wrap-around included."""
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randint(-2 ** 62, 2 ** 62, shape, generator=g)
    assert torch.equal(tsort.cumsum_rows(x), torch.cumsum(x, dim=1))
    b = torch.randint(0, 2, shape, generator=g, dtype=torch.int32)
    assert torch.equal(tsort.cumsum_rows(b), torch.cumsum(b, dim=1))
    big = 2 ** 31 - 1
    h = torch.where(b > 0, torch.arange(shape[1]).expand(shape), big)
    want = h.flip(1).cummin(1).values.flip(1) if shape[1] else h
    for block in (1024, 7):
        assert torch.equal(tsort.suffix_min_rows(h, big, block), want)


@pytest.mark.parametrize("shape", [(1, 5), (3, 1000), (8, 3001), (2, 2048),
                                   (4, 0)])
def test_window_scans_equal_torch(shape):
    """float_cumsum_rows and prefix_minmax_rows (the two-level scans of the
    window lowerings) against torch's own scans along the last axis: the
    running min and max exactly, NaN included; the float sum within 8 ulps
    of the row's prefix of absolute values."""
    g = torch.Generator().manual_seed(sum(shape) + 1)
    x = torch.randn(shape, generator=g, dtype=torch.float64) * 1e6
    bound = 8 * torch.finfo(torch.float64).eps * x.abs().cumsum(1)
    ix = torch.randint(-2 ** 62, 2 ** 62, shape, generator=g)
    if shape[1] > 3:
        x[0, 3] = float("nan")
    for block in (1024, 7):
        got = tsort.float_cumsum_rows(x, block)
        want = torch.cumsum(x, dim=1)
        assert torch.equal(got.isnan(), want.isnan())
        fin = ~want.isnan()
        assert bool(((got - want).abs()[fin] <= bound[fin]).all())
        for func, fill, ifill in (("min", float("inf"), 2 ** 63 - 1),
                                  ("max", float("-inf"), -2 ** 63)):
            op = torch.cummin if func == "min" else torch.cummax
            want = op(x, dim=1).values if shape[1] else x
            assert torch.equal(tsort.prefix_minmax_rows(x, func, fill,
                                                        block).isnan(),
                               want.isnan())
            assert torch.equal(tsort.prefix_minmax_rows(x, func, fill,
                                                        block)[~want.isnan()],
                               want[~want.isnan()])
            want = op(ix, dim=1).values if shape[1] else ix
            assert torch.equal(tsort.prefix_minmax_rows(ix, func, ifill,
                                                        block), want)
