"""The port's Redistribute and Broadcast Motions (greengage_tpu_torch/
parallel/motion.py) against the JAX package's under shard_map on the
8-device CPU mesh: received rows must be identical, row for row, with the
same overflow flag."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import greengage_tpu  # noqa: F401  (enables x64)
from greengage_tpu.exec.compile import _shard_map
from greengage_tpu.parallel import SEG_AXIS, make_mesh
from greengage_tpu.parallel import motion as jmotion
from greengage_tpu_torch.parallel import motion as tmotion

NSEG = 8


def _inputs(seed, n, live=0.8, skew=False):
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, NSEG, (NSEG, n)).astype(np.int32)
    if skew:
        dest[:, : n * 3 // 4] = 3        # most rows to one segment
    present = rng.random((NSEG, n)) < live
    arrs = {"k": rng.integers(-(2**40), 2**40, (NSEG, n)).astype(np.int64),
            "v": rng.normal(size=(NSEG, n)),
            "@v:k": rng.random((NSEG, n)) < 0.9}
    return arrs, present, dest


def _jax_redistribute(devices8, arrs, present, dest, capacity, nbuckets):
    mesh = make_mesh(NSEG, devices8)
    names = sorted(arrs)

    def step(pres, dst, *cols):
        recv, precv, ov = jmotion.redistribute(
            dict(zip(names, cols)), pres, dst, NSEG, capacity,
            nbuckets=nbuckets)
        return (precv, jnp.broadcast_to(ov, (1,))) + tuple(
            recv[k] for k in names)

    fn = jax.jit(_shard_map(step, mesh=mesh,
                            in_specs=P(SEG_AXIS), out_specs=P(SEG_AXIS)))
    shard = NamedSharding(mesh, P(SEG_AXIS))
    args = [jax.device_put(np.ascontiguousarray(a).reshape(-1), shard)
            for a in [present, dest] + [arrs[k] for k in names]]
    out = [np.asarray(o) for o in fn(*args)]
    recv = {k: o.reshape(NSEG, -1) for k, o in zip(names, out[2:])}
    return recv, out[0].reshape(NSEG, -1), bool(out[1].any())


@pytest.mark.parametrize("n,capacity,nbuckets,skew", [
    (300, 64, 1, False),
    (300, 64, 2, False),
    (257, 40, 4, False),
    (200, 64, 2, True),          # one destination overflows its bucket
    (100, 30, 4, False),         # uneven split falls back to one exchange
], ids=["one_exchange", "two_buckets", "four_buckets", "overflow",
        "uneven_split"])
def test_redistribute_matches_jax_row_for_row(devices8, n, capacity,
                                              nbuckets, skew):
    arrs, present, dest = _inputs(n + capacity, n, skew=skew)
    jrecv, jprecv, jov = _jax_redistribute(devices8, arrs, present, dest,
                                           capacity, nbuckets)
    trecv, tprecv, tov = tmotion.redistribute(
        {k: torch.from_numpy(v) for k, v in arrs.items()},
        torch.from_numpy(present), torch.from_numpy(dest), NSEG, capacity,
        nbuckets=nbuckets)
    assert bool(tov) == jov == skew
    assert np.array_equal(tprecv.numpy(), jprecv)
    for k in arrs:
        assert trecv[k].dtype == torch.from_numpy(arrs[k]).dtype
        # slots past a bucket's rows are zero-filled on both sides
        assert np.array_equal(trecv[k].numpy(), jrecv[k]), k
    if not skew:   # nothing dropped: every live row arrives exactly once
        assert int(tprecv.sum()) == int(present.sum())


def test_broadcast_matches_jax(devices8):
    arrs, present, _ = _inputs(9, 50)
    mesh = make_mesh(NSEG, devices8)

    def step(pres, k):
        recv, precv = jmotion.broadcast({"k": k}, pres)
        return precv, recv["k"]

    fn = jax.jit(_shard_map(step, mesh=mesh,
                            in_specs=P(SEG_AXIS), out_specs=P(SEG_AXIS)))
    shard = NamedSharding(mesh, P(SEG_AXIS))
    jp, jk = (np.asarray(o).reshape(NSEG, -1) for o in fn(
        jax.device_put(present.reshape(-1), shard),
        jax.device_put(arrs["k"].reshape(-1), shard)))
    trecv, tp = tmotion.broadcast({"k": torch.from_numpy(arrs["k"])},
                                  torch.from_numpy(present))
    assert np.array_equal(tp.numpy(), jp)
    assert np.array_equal(trecv["k"].numpy(), jk)
