"""The port's dense aggregation (greengage_tpu_torch/ops/agg.py) and fused
aggregation (ops/fused_agg.py) against the JAX package's, segment by
segment. On the CPU the port's fused path runs the kernel's plain torch
version; the JAX side runs its Pallas kernel in interpret mode.

Tolerances: integer and DECIMAL results (scaled int64) must be equal. The
float64 avg may differ by an ulp (relative 1e-12): XLA compiles the JAX
side's division by 10^scale into a multiplication by the reciprocal, the
port divides truly."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import greengage_tpu  # noqa: F401  (enables x64)
from greengage_tpu.ops import agg as jagg
from greengage_tpu.ops import fused_agg as jfused
from greengage_tpu_torch.ops import agg as tagg
from greengage_tpu_torch.ops import fused_agg as tfused


def _keys(rng, nseg, n, null_frac=0.1):
    rf = rng.integers(0, 3, (nseg, n)).astype(np.int32)
    ls = rng.integers(0, 2, (nseg, n)).astype(np.int32)
    ls_valid = rng.random((nseg, n)) >= null_frac
    return rf, ls, ls_valid


def test_dense_gid_and_decode_match_jax():
    rng = np.random.default_rng(0)
    nseg, n = 4, 777
    rf, ls, ls_valid = _keys(rng, nseg, n)
    sel = rng.random((nseg, n)) < 0.8
    tk = [tagg.KeySpec(torch.from_numpy(rf), None, None),
          tagg.KeySpec(torch.from_numpy(ls), torch.from_numpy(ls_valid), None)]
    tgid, D = tagg.dense_gid(tk, [4, 3], torch.from_numpy(sel))
    assert D == 12 and tgid.dtype == torch.int32
    for s in range(nseg):
        jk = [jagg.KeySpec(jnp.asarray(rf[s]), None, None),
              jagg.KeySpec(jnp.asarray(ls[s]), jnp.asarray(ls_valid[s]), None)]
        jgid, _ = jagg.dense_gid(jk, [4, 3], jnp.asarray(sel[s]))
        assert np.array_equal(tgid[s].numpy(), np.asarray(jgid))
    jdec = jagg.dense_decode_keys(
        [jagg.KeySpec(jnp.asarray(rf[0]), None, None),
         jagg.KeySpec(jnp.asarray(ls[0]), None, None)], [4, 3], 12)
    tdec = tagg.dense_decode_keys(tk, [4, 3], 12)
    for (jc, jv), (tc, tv) in zip(jdec, tdec):
        assert np.array_equal(tc.numpy(), np.asarray(jc))
        assert np.array_equal(tv.numpy(), np.asarray(jv))


def _q1_like_specs(mod, cols, valids, xp):
    """Q1's partial aggregate plus min/max and a nullable count."""
    qty, price, disc, dp = (xp(cols[k]) for k in ("qty", "price", "disc",
                                                  "dp"))
    disc_valid = xp(valids["disc"])
    return [
        mod.AggSpec("sum_qty", "sum", qty, None),
        mod.AggSpec("sum_price", "sum", price, None),
        mod.AggSpec("sum_dp", "sum", dp, None),
        mod.AggSpec("avg_qty", "avg", qty, None, 2),
        mod.AggSpec("avg_disc", "avg", disc, disc_valid, 2),
        mod.AggSpec("min_price", "min", price, None),
        mod.AggSpec("max_disc", "max", disc, disc_valid),
        mod.AggSpec("cnt_disc", "count", disc, disc_valid),
        mod.AggSpec("cnt", "count_star", None, None),
    ]


def _agg_inputs(seed, nseg, n, D, live):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, D, (nseg, n)).astype(np.int32)
    sel = rng.random((nseg, n)) < live
    gid = np.where(sel, gid, 0).astype(np.int32)
    price = rng.integers(90000, 10**7, (nseg, n)).astype(np.int64)
    disc = rng.integers(0, 11, (nseg, n)).astype(np.int64)
    cols = {"qty": rng.integers(100, 5001, (nseg, n)).astype(np.int64),
            "price": price, "disc": disc, "dp": price * (100 - disc)}
    valids = {"disc": rng.random((nseg, n)) < 0.9}
    return gid, sel, cols, valids


def _compare(tvals, tvalids, jvals, jvalids, s):
    assert sorted(tvals) == sorted(jvals)
    for k in jvals:
        jv = np.asarray(jvals[k])
        tv = tvals[k][s].numpy()
        assert tv.dtype == jv.dtype, (k, tv.dtype, jv.dtype)
        jvalid = None if jvalids.get(k) is None else np.asarray(jvalids[k])
        tvalid = None if tvalids.get(k) is None else tvalids[k][s].numpy()
        assert (tvalid is None) == (jvalid is None), k
        if jvalid is not None:
            assert np.array_equal(tvalid, jvalid), k
            tv, jv = tv[jvalid], jv[jvalid]
        if jv.dtype.kind == "f":
            # see the module docstring: at most an ulp apart
            np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=0, err_msg=k)
        else:
            assert np.array_equal(tv, jv), k


def test_dense_aggregate_matches_jax():
    nseg, n, D = 3, 1500, 12
    gid, sel, cols, valids = _agg_inputs(1, nseg, n, D, 0.85)
    tvals, tvalids = tagg.dense_aggregate(
        torch.from_numpy(gid), D,
        _q1_like_specs(tagg, cols, valids, torch.from_numpy),
        torch.from_numpy(sel))
    for s in range(nseg):
        jvals, jvalids = jagg.dense_aggregate(
            jnp.asarray(gid[s]), D,
            _q1_like_specs(jagg, {k: v[s] for k, v in cols.items()},
                           {k: v[s] for k, v in valids.items()}, jnp.asarray),
            jnp.asarray(sel[s]))
        _compare(tvals, tvalids, jvals, jvalids, s)


# Keep n small: interpret mode unrolls D x jobs masked reductions per grid
# step, so D=64 runs fewer jobs than the Q1-shaped cases.
FUSED_CASES = [
    ("D1_ragged", 1, 1, 1001, 0.9, None),
    ("D12_q1_shape", 12, 2, 2049, 0.9, None),
    ("D12_all_dead", 12, 1, 333, 0.0, None),
    ("D64_ragged", 64, 1, 515, 0.95, ("sum_dp", "cnt")),
]


@pytest.mark.parametrize("name,D,nseg,n,live,only",
                         FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
def test_fused_dense_aggregate_matches_jax_interpret(name, D, nseg, n, live,
                                                     only):
    gid, sel, cols, valids = _agg_inputs(2, nseg, n, D, live)

    def specs(mod, c, v, xp):
        out = _q1_like_specs(mod, c, v, xp)
        return [s for s in out if only is None or s.name in only]

    assert tfused.supported(specs(tagg, cols, valids, torch.from_numpy))
    tvals, tvalids = tfused.fused_dense_aggregate(
        torch.from_numpy(gid), D, specs(tagg, cols, valids, torch.from_numpy),
        torch.from_numpy(sel))
    plain_vals, _ = tagg.dense_aggregate(
        torch.from_numpy(gid), D, specs(tagg, cols, valids, torch.from_numpy),
        torch.from_numpy(sel))
    for k in plain_vals:
        assert torch.equal(tvals[k], plain_vals[k]), k
    # every segment equals the port's unfused path above; the first also
    # equals the JAX kernel (each interpret-mode call costs seconds)
    jvals, jvalids = jfused.fused_dense_aggregate(
        jnp.asarray(gid[0]), D,
        specs(jagg, {k: v[0] for k, v in cols.items()},
              {k: v[0] for k, v in valids.items()}, jnp.asarray),
        jnp.asarray(sel[0]), interpret=True)
    _compare(tvals, tvalids, jvals, jvalids, 0)


def _table(gid, D, jobs):
    """(values, op, ident) jobs, every row live -> the kernel's JobTable."""
    live = torch.ones(gid.shape, dtype=torch.bool, device=gid.device)
    descs = [tagg.Job(v, live, v.dtype if op != "sum" else
                      (torch.float64 if v.dtype.is_floating_point
                       else torch.int64), op, ident)
             for v, op, ident in jobs]
    return tfused.job_table(gid, D, descs)


def _results(table):
    out = tfused._segment_reduce_fused(table)
    return [out[s] for s in table.slots]


def test_fused_plain_version_float_and_identities():
    """The kernel's plain version on float64 and min/max jobs: groups
    without rows keep each job's identity, as the TPU kernel's scratch
    initialisation leaves them."""
    rng = np.random.default_rng(3)
    nseg, n, D = 2, 300, 5
    gid = torch.from_numpy(rng.integers(0, 3, (nseg, n)).astype(np.int32))
    f = torch.from_numpy(rng.random((nseg, n)))
    i = torch.from_numpy(rng.integers(-50, 50, (nseg, n)))
    jobs = [(f, "sum", 0.0), (f, "min", float("inf")), (i, "max", -2**63),
            (i.to(torch.int32), "min", 2**31 - 1)]
    out = _results(_table(gid, D, jobs))
    assert [o.dtype for o in out] == [torch.float64, torch.float64,
                                      torch.int64, torch.int64]
    for s in range(nseg):
        for g in range(D):
            m = gid[s] == g
            if m.any():
                assert torch.isclose(out[0][s, g], f[s][m].sum(), rtol=1e-12)
                assert out[1][s, g] == f[s][m].min()
                assert out[2][s, g] == i[s][m].max()
                assert out[3][s, g] == i[s][m].min()
            else:
                assert out[0][s, g] == 0.0 and out[1][s, g] == float("inf")
                assert out[2][s, g] == -2**63 and out[3][s, g] == 2**31 - 1


def test_fused_wrapper_rejects_a_device_without_a_kernel():
    gid = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    table = _table(gid, 3, [(gid.to(torch.int64), "sum", 0)])
    with pytest.raises(ValueError, match="no kernel"):
        tfused._segment_reduce_fused(table)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 12, 64])
def test_fused_kernel_matches_plain_on_card(cuda_device, D):
    rng = np.random.default_rng(D)
    nseg, n = 8, 10_007
    gid = torch.from_numpy(rng.integers(0, D, (nseg, n)).astype(np.int32))
    i = torch.from_numpy(rng.integers(-10**12, 10**12, (nseg, n)))
    f = torch.from_numpy(rng.random((nseg, n)))
    jobs = [(i, "sum", 0), (i, "min", 2**63 - 1), (i, "max", -2**63),
            (f, "sum", 0.0), (f, "max", float("-inf"))]
    dev_jobs = [(v.to(cuda_device), op, ident) for v, op, ident in jobs]
    before = tfused.LAUNCHES
    got = _results(_table(gid.to(cuda_device), D, dev_jobs))
    assert tfused.LAUNCHES == before + 1
    want = _results(_table(gid, D, jobs))
    for g, w in zip(got, want):
        g = g.cpu()
        if w.dtype == torch.float64:
            torch.testing.assert_close(g, w, rtol=1e-12, atol=0)
        else:
            assert torch.equal(g, w)
