"""The fused dense-aggregation wrapper (greengage_tpu_torch/ops/fused_agg.py):
its job-table builder as a pure function, its plain version against the
port's unfused dense path, its refusals and launch plan, and (on a card)
the CUDA kernel against the plain version on both accumulation paths.

Tolerances: integer and DECIMAL results must be equal. float64 sums may
differ by summation order (relative 1e-12); float64 min/max must be equal.
"""

import ctypes
import struct

import numpy as np
import pytest

import torch

import chip_smoke
from greengage_tpu_torch import entry
from greengage_tpu_torch.config import Settings
from greengage_tpu_torch.ops import agg as tagg
from greengage_tpu_torch.ops import fused_agg as tfused
from greengage_tpu_torch.utils import tpch as ttpch


def _assert_same(got, want, key):
    assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
    if got.dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0,
                                   equal_nan=True, msg=key)
    else:
        assert torch.equal(got, want), key


def _inputs(seed, nseg, n, D, live=0.8):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, D - 1 if D > 2 else D, (nseg, n)).astype(np.int32)
    sel = rng.random((nseg, n)) < live
    gid = np.where(sel, gid, 0).astype(np.int32)
    f = rng.random((nseg, n)) * 100.0 - 50.0
    f[rng.random((nseg, n)) < 0.01] = np.nan
    cols = {
        "b": torch.from_numpy(rng.random((nseg, n)) < 0.5),
        "i32": torch.from_numpy(rng.integers(-10**6, 10**6, (nseg, n))
                                .astype(np.int32)),
        "i64": torch.from_numpy(rng.integers(-10**12, 10**12, (nseg, n))),
        "f64": torch.from_numpy(f),
        "f64_clean": torch.from_numpy(rng.random((nseg, n)) * 1e6),
    }
    valid = torch.from_numpy(rng.random((nseg, n)) < 0.7)
    return torch.from_numpy(gid), torch.from_numpy(sel), cols, valid


def _specs(cols, valid, nseg, n):
    A = tagg.AggSpec
    lit = torch.full((), 7, dtype=torch.int64).expand(nseg, n)
    null_lit = torch.zeros((), dtype=torch.bool).expand(nseg, n)
    return [
        A("sum_b", "sum", cols["b"], None),
        A("sum_i32", "sum", cols["i32"], valid),
        A("min_i32", "min", cols["i32"], valid),
        A("max_i32", "max", cols["i32"], None),
        A("sum_i64", "sum", cols["i64"], None),
        A("sum_i64_again", "sum", cols["i64"], None),     # duplicate job
        A("avg_i64", "avg", cols["i64"], valid, 2),
        A("min_i64", "min", cols["i64"], valid),
        A("max_i64", "max", cols["i64"], valid),          # same mask
        A("sum_f", "sum", cols["f64"], None),
        A("min_f", "min", cols["f64"], valid),
        A("max_f", "max", cols["f64"], None),
        A("avg_f", "avg", cols["f64_clean"], None),
        A("cnt_valid", "count", cols["i32"], valid),
        A("cnt", "count_star", None, None),
        A("sum_lit", "sum", lit, None),                   # stride-0 literal
        A("max_lit", "max", lit, null_lit),               # NULL literal
    ]


@pytest.mark.parametrize("nseg,n,D", [(1, 1, 1), (3, 257, 12), (2, 1001, 64),
                                      (4, 6, 5)])
def test_plain_version_equals_dense_aggregate(nseg, n, D):
    gid, sel, cols, valid = _inputs(nseg * 1000 + n, nseg, n, D)
    specs = _specs(cols, valid, nseg, n)
    got, got_valid = tfused.fused_dense_aggregate(gid, D, specs, sel)
    want, want_valid = tagg.dense_aggregate(gid, D, specs, sel)
    assert sorted(got) == sorted(want)
    for k in want:
        _assert_same(got[k], want[k], k)
        if want_valid[k] is None:
            assert got_valid[k] is None, k
        else:
            assert torch.equal(got_valid[k], want_valid[k]), k


def test_plain_version_identities_on_empty_groups_and_nan():
    gid, sel, cols, valid = _inputs(5, 2, 300, 12)   # group 11 never used
    vals, valids = tfused.fused_dense_aggregate(
        gid, 12, _specs(cols, valid, 2, 300), sel)
    assert not valids["min_i64"][:, 11].any()
    assert (vals["min_i64"][:, 11] == 2**63 - 1).all()
    assert (vals["max_i32"][:, 11] == -2**31).all()
    assert (vals["min_f"][:, 11] == float("inf")).all()
    assert (vals["cnt"][:, 11] == 0).all()
    # a NaN in a live row makes its group's float sum and max NaN
    f, live = cols["f64"], sel
    for s in range(2):
        for g in range(11):
            m = (gid[s] == g) & live[s]
            has_nan = bool(f[s][m].isnan().any())
            assert bool(vals["sum_f"][s, g].isnan()) == has_nan
            assert bool(vals["max_f"][s, g].isnan()) == has_nan


def test_all_rows_dead_gives_identities():
    gid, sel, cols, valid = _inputs(6, 2, 99, 12, live=0.0)
    vals, valids = tfused.fused_dense_aggregate(
        gid, 12, _specs(cols, valid, 2, 99), sel)
    assert (vals["cnt"] == 0).all() and (vals["sum_i64"] == 0).all()
    assert not valids["min_i64"].any()


def _job(v, live, op="sum", ident=0, dtype=None):
    if dtype is None:
        dtype = (v.dtype if op != "sum" else torch.float64
                 if v.dtype.is_floating_point else torch.int64)
    return tagg.Job(v, live, dtype, op, ident)


def test_job_table_removes_duplicates():
    rng = np.random.default_rng(0)
    nseg, n = 2, 40
    gid = torch.zeros((nseg, n), dtype=torch.int32)
    a = torch.from_numpy(rng.integers(0, 9, (nseg, n)))
    b = torch.from_numpy(rng.random((nseg, n)))
    lit = torch.full((), 3, dtype=torch.int64).expand(nseg, n)
    m1 = torch.from_numpy(rng.random((nseg, n)) < 0.5)
    m2 = m1.clone()                      # equal values, its own storage
    descs = [
        tagg.Job(None, m1, torch.int64),             # count under m1
        _job(a, m1),                                 # sum a
        _job(lit, m1),                               # a broadcast column
        _job(a.view(nseg, n), m1),                   # same storage: dup
        _job(b, m2),                                 # float sum under m2
        _job(a, m1, "min", 2**63 - 1),               # another op on a
        tagg.Job(None, m1, torch.int64),             # dup count
        _job(a, m2),                                 # same column, m2
        _job(a.t().contiguous().t(), m1),            # a copy: new column
    ]
    t = tfused.job_table(gid, 5, descs)
    # streamed columns first, in first-seen order; the literal last
    assert [c.data_ptr() for c in t.cols[:3]] == [
        a.data_ptr(), b.data_ptr(), t.cols[2].data_ptr()]
    assert t.nstream == 3 and t.cols[3].stride() == (0, 0)
    assert len(t.masks) == 2
    assert t.masks[0].data_ptr() == m1.data_ptr()
    # (col, mask, op, is_float, ident), grouped by streamed column, then
    # the per-segment constants (the count and the literal)
    assert t.jobs == [(0, 0, 0, False, 0), (0, 0, 1, False, 2**63 - 1),
                      (0, 1, 0, False, 0), (1, 1, 0, True, 0.0),
                      (2, 0, 0, False, 0), (-1, 0, 0, False, 0),
                      (3, 0, 0, False, 0)]
    assert t.slots == [5, 0, 6, 0, 3, 1, 5, 2, 4]
    assert t.job_begin() == [0, 3, 4, 5]
    # gid + a + b + a's copy + two masks; the literal is not streamed
    assert t.bytes_per_row == 4 + 8 + 8 + 8 + 1 + 1


def test_job_table_streams_a_non_contiguous_column_contiguously():
    gid = torch.zeros((3, 8), dtype=torch.int32)
    wide = torch.arange(48, dtype=torch.int64).reshape(3, 16)
    t = tfused.job_table(gid, 2, [_job(wide[:, ::2], None)])
    assert t.cols[0].is_contiguous() and t.nstream == 1
    assert torch.equal(t.cols[0], wide[:, ::2])
    assert t.masks == [] and t.jobs == [(0, -1, 0, False, 0)]
    assert t.bytes_per_row == 4 + 8


def test_job_table_aligns_an_offset_gid():
    """The kernel reads 4 gids with one 16-byte load: a gid that starts
    inside a larger tensor is copied to an aligned one."""
    base = torch.arange(15, dtype=torch.int32).reshape(3, 5) % 3
    gid = base[1:]                       # starts 20 bytes in
    assert gid.data_ptr() % 16
    t = tfused.job_table(gid, 3, [tagg.Job(None, None, torch.int64)])
    assert t.gid.data_ptr() % 16 == 0 and torch.equal(t.gid, gid)


def _q1_tables(monkeypatch):
    tables = []
    plain = tfused._segment_reduce_plain

    def spy(table):
        tables.append(table)
        return plain(table)

    monkeypatch.setattr(tfused, "_segment_reduce_plain", spy)
    data = ttpch.generate(0.002)
    entry.run_q1(data, nseg=8, device="cpu",
                 settings=Settings(fused_dense_min_rows=1))
    return tables


def test_q1_partial_reads_each_base_column_and_mask_once(monkeypatch):
    t = _q1_tables(monkeypatch)[0]
    # quantity, extendedprice, the two decimal products, discount; one
    # live mask (the filter's selection); the recorded 8 jobs are 6
    assert (len(t.cols), t.nstream, len(t.masks)) == (5, 5, 1)
    assert len(t.slots) == 8 and len(t.jobs) == 6
    assert all(c.dtype == torch.int64 for c in t.cols)
    assert [j[0] for j in t.jobs] == [0, 1, 2, 3, 4, -1]
    assert all(j[1] == 0 and j[2] == 0 for j in t.jobs)
    assert t.bytes_per_row == 45
    nseg, n = t.gid.shape
    rows = nseg * n
    blocks = 3
    out_ws = nseg * 6 * 12 * 8 + 2 * nseg * blocks * 6 * 12 * 8
    assert chip_smoke.kernel_bytes(t, blocks) == rows * 45 + out_ws


def test_q1_kernel_bound_counts_pr1_inputs(monkeypatch):
    """chip_smoke's bound for the 8 pre-masked int64 jobs of the first
    kernel: the gid and 8 columns, 68 B per row."""
    gid = torch.zeros((2, 16), dtype=torch.int32)
    cols = [torch.zeros((2, 16), dtype=torch.int64) for _ in range(8)]
    t = tfused.job_table(gid, 12, [_job(c, None) for c in cols])
    assert t.bytes_per_row == 68
    assert chip_smoke.kernel_bytes(t, 1) == 32 * 68 + 3 * 2 * 8 * 12 * 8


@pytest.mark.parametrize("what", ["dtype", "gid_dtype", "gid_strides",
                                  "device", "jobs", "mask_dtype", "shape",
                                  "result_dtype"])
def test_wrapper_refusals(what):
    nseg, n = 2, 16
    gid = torch.zeros((nseg, n), dtype=torch.int32)
    v = torch.zeros((nseg, n), dtype=torch.int64)
    live = torch.ones((nseg, n), dtype=torch.bool)
    descs = [_job(v, live)]
    match = {"dtype": "column dtype", "gid_dtype": "gid", "gid_strides":
             "gid", "device": "on meta", "jobs": "jobs", "mask_dtype":
             "mask dtype", "shape": "shape", "result_dtype": "result dtype"}
    if what == "dtype":
        descs = [_job(v.to(torch.float32), live)]
    elif what == "gid_dtype":
        gid = gid.to(torch.int64)
    elif what == "gid_strides":
        gid = torch.zeros((n, nseg), dtype=torch.int32).t()
    elif what == "device":
        descs = [_job(v.to("meta"), live)]
    elif what == "jobs":
        descs = [_job(v, live, "min", i) for i in range(tfused.MAX_JOBS + 1)]
    elif what == "mask_dtype":
        descs = [_job(v, live.to(torch.int32))]
    elif what == "shape":
        descs = [_job(v[:, :-1], live[:, :-1])]
    else:
        descs = [tagg.Job(v, live, torch.float64)]
    with pytest.raises(ValueError, match=match[what]):
        tfused.job_table(gid, 4, descs)


def test_launch_plan_picks_the_path_by_size():
    lane, warp = tfused.PATH_LANE, tfused.PATH_WARP
    # Q1's 6 distinct jobs over 12 groups, and the first kernel's 8
    assert tfused.launch_plan(6, 12) == (lane, 8, 8 * 6 * 12 * 256)
    assert tfused.launch_plan(8, 12) == (lane, 8, 8 * 8 * 12 * 256)
    assert tfused.launch_plan(1, 113)[0] == lane
    assert tfused.launch_plan(1, 114) == (warp, 8, 8 * 114 * 8)
    # the compile gate's largest J * D, 4096
    assert tfused.launch_plan(64, 64) == (warp, 7, 7 * 64 * 64 * 8)
    with pytest.raises(ValueError, match="shared memory"):
        tfused.launch_plan(64, 512)
    assert tfused.blocks_per_segment(132, 1, 8, 7_500_000, 256) == 16
    assert tfused.blocks_per_segment(132, 1, 256, 7_500_000, 256) == 1
    assert tfused.blocks_per_segment(132, 4, 1, 5, 256) == 1


def test_ctypes_table_matches_the_kernels_layout():
    # sizeof(Table) in csrc/fused_dense_agg.cu: 32 B of scalars, 32 + 16
    # columns and masks of 24 B, 64 jobs of 24 B, 33 ints, padded to 8
    assert ctypes.sizeof(tfused._Table) == 2856
    gid = torch.zeros((2, 8), dtype=torch.int32)
    f = torch.zeros((2, 8), dtype=torch.float64)
    lit = torch.full((), 1, dtype=torch.int32).expand(2, 8)
    live = torch.ones((2, 8), dtype=torch.bool)
    t = tfused._ctable(tfused.job_table(gid, 3, [
        _job(f, live, "max", float("-inf")), _job(lit, live),
        tagg.Job(None, None, torch.int64)]))
    assert (t.n, t.D, t.J, t.ncols, t.nmasks) == (8, 3, 3, 1, 1)
    assert (t.cols[0].dtype, t.cols[0].bcast, t.cols[0].seg_stride) == (3, 0, 8)
    assert (t.cols[1].dtype, t.cols[1].bcast) == (1, 1)
    assert t.jobs[0].ident == struct.unpack(
        "<q", struct.pack("<d", float("-inf")))[0]
    assert (t.jobs[0].op, t.jobs[0].is_float) == (2, 1)
    assert (t.jobs[2].col, t.jobs[2].mask) == (-1, -1)
    assert list(t.col_begin)[:2] == [0, 1]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    return torch.device("cuda")


def _card_table(dev, seed, nseg, n, D, njobs):
    """njobs jobs over int64, int32, bool and float64 columns under two
    live masks, sums, mins and maxes, and a count -> (the table on dev, the
    same table on the CPU)."""
    gid, sel, cols, valid = _inputs(seed, nseg, n, D)
    sv = sel & valid
    descs = []
    kinds = [("i64", "sum"), ("i64", "min"), ("i64", "max"), ("f64", "sum"),
             ("f64", "min"), ("f64", "max"), ("i32", "sum"), ("b", "sum"),
             ("f64_clean", "sum")]
    for j in range(njobs):
        name, op = kinds[j % len(kinds)]
        v = cols[name]
        ident = tagg.minmax_identity(v.dtype, op) if op != "sum" else 0
        descs.append(_job(v, sel if j % 2 else sv, op, ident))
    descs.append(tagg.Job(None, sel, torch.int64))
    on_dev = {}

    def to(t):
        if t is None:
            return None
        if id(t) not in on_dev:
            on_dev[id(t)] = t.to(dev)
        return on_dev[id(t)]

    return (tfused.job_table(gid.to(dev), D, [
        tagg.Job(to(d.values), to(d.live), d.dtype, d.op, d.ident)
        for d in descs]), tfused.job_table(gid, D, descs))


@pytest.mark.cuda
@pytest.mark.parametrize("D,njobs,path", [(12, 8, 0), (1, 9, 0),
                                          (64, 40, 1)])
def test_kernel_matches_plain_on_both_paths(cuda_device, D, njobs, path):
    dev_t, cpu_t = _card_table(cuda_device, D, 8, 20_011, D, njobs)
    assert tfused.launch_plan(len(dev_t.jobs), D)[0] == path
    before = tfused.LAUNCHES
    got = tfused._segment_reduce_fused(dev_t)
    assert tfused.LAUNCHES == before + 1
    torch.cuda.synchronize()
    want = tfused._segment_reduce_plain(cpu_t)
    for j, (g, w) in enumerate(zip(got, want)):
        _assert_same(g.cpu(), w, j)


@pytest.mark.cuda
@pytest.mark.parametrize("D,njobs", [(12, 8), (64, 40)])
def test_kernel_float_sums_are_bit_identical_run_to_run(cuda_device, D,
                                                        njobs):
    dev_t, _ = _card_table(cuda_device, 7, 4, 100_003, D, njobs)
    a = [r.clone() for r in tfused._segment_reduce_fused(dev_t)]
    b = tfused._segment_reduce_fused(dev_t)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int64), y.view(torch.int64))


@pytest.mark.cuda
def test_fused_path_never_waits_for_the_device(cuda_device):
    gid, sel, cols, valid = _inputs(9, 4, 5_001, 12)
    specs = [tagg.AggSpec(s.name, s.func,
                          None if s.values is None else s.values.to(
                              cuda_device),
                          None if s.valid is None else s.valid.to(
                              cuda_device), s.decimal_scale)
             for s in _specs(cols, valid, 4, 5_001)]
    gid, sel = gid.to(cuda_device), sel.to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        vals, _ = tfused.fused_dense_aggregate(gid, 12, specs, sel)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, _ = tagg.dense_aggregate(gid, 12, specs, sel)
    for k in want:
        _assert_same(vals[k].cpu(), want[k].cpu(), k)
