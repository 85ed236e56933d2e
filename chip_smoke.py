"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 10] [--nseg 8] [--reps 5] [--profile]

Phases, one JSON line each; any failure exits non-zero:

  device   the card's name and power limit (nvidia-smi)
  build    compile every CUDA kernel of the port (nvcc, sm_90a)
  kernel   each kernel against its plain PyTorch version on the card, at
           edge shapes and at the shapes TPC-H Q1 gives it; times of the
           kernel, the plain version and one library call, and the bound
  q1       TPC-H Q1 at scale factor ``--sf`` over ``--nseg`` segments through
           the port's entry points, checked exactly against a numpy
           reference on the same data; the kernel launch counts of that run
           (``--profile`` adds device time by kernel for one warm run)
  dryrun   the distributed step's exact-sum check

then the kernel table, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is visible or the port's package is missing.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
KERNEL_SOURCE = "greengage_tpu_torch/csrc/fused_dense_agg.cu"
KERNEL_REPLACES = "greengage_tpu/ops/fused_agg.py:41"
FLOAT_RTOL = 1e-12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_bytes(table, blocks: int) -> int:
    """Bytes one fused launch must move: every streamed column and mask and
    the gid read once per row (the job table's bytes per row), the
    [nseg, J, D] output written once, and the [nseg, blocks, J, D] block
    workspace written and read once."""
    nseg, n = table.gid.shape
    jd = len(table.jobs) * table.D
    return nseg * n * table.bytes_per_row + nseg * jd * 8 \
        + 2 * nseg * blocks * jd * 8


def _case(torch, rng, dev, nseg, n, D, spec, live_frac, masked=True):
    """Random kernel inputs as agg.Job descriptors. spec: (column kind,
    op) pairs; kind in i64 / i32 / bool / f64 / f64nan / lit (a stride-0
    literal) / count. Masked jobs alternate between sel and sel & valid;
    pre-masked ones carry no mask and identities at dead rows."""
    from greengage_tpu_torch.ops import agg as agg_ops

    sel = torch.from_numpy(rng.random((nseg, n)) < live_frac).to(dev)
    valid = torch.from_numpy(rng.random((nseg, n)) < 0.8).to(dev)
    sv = sel & valid
    gid = torch.from_numpy(rng.integers(0, D, (nseg, n), dtype=np.int32))
    gid = torch.where(sel, gid.to(dev), 0).to(torch.int32).contiguous()
    cols = {}
    descs = []
    for j, (kind, op) in enumerate(spec):
        if kind not in cols:
            if kind == "i64":
                v = torch.from_numpy(rng.integers(-10**12, 10**12, (nseg, n)))
            elif kind == "i32":
                v = torch.from_numpy(rng.integers(-2**31, 2**31, (nseg, n),
                                                  dtype=np.int32))
            elif kind == "bool":
                v = torch.from_numpy(rng.random((nseg, n)) < 0.5)
            elif kind == "lit":
                v = torch.full((), 12345, dtype=torch.int64)
            elif kind == "count":
                v = None
            else:
                f = rng.random((nseg, n)) * 1000.0 - 200.0
                if kind == "f64nan":
                    f[rng.random((nseg, n)) < 0.001] = np.nan
                v = torch.from_numpy(f)
            cols[kind] = None if v is None else v.to(dev).expand(nseg, n)
        v = cols[kind]
        mask = (sel if j % 2 else sv) if masked else None
        dtype = torch.int64 if v is None else v.dtype
        if op == "sum" and v is not None:
            dtype = torch.float64 if v.dtype.is_floating_point \
                else torch.int64
        ident = 0 if op == "sum" else agg_ops.minmax_identity(v.dtype, op)
        if not masked and v is not None:
            fill = torch.tensor(ident.item() if op != "sum" else 0,
                                dtype=v.dtype, device=dev)
            v = torch.where(sel, v, fill).contiguous()
        descs.append(agg_ops.Job(v, mask, dtype, op, ident))
    return gid, descs


def _q1_pr1_table(torch, dev, nseg, n, seed=0):
    """The first kernel's Q1-shaped inputs: gid over the 6 live
    (returnflag, linestatus) groups of D = 12 plus ~1.4% dead rows in group
    0, and 8 pre-masked int64 sum jobs (a 0/1 count and 7 value columns of
    scaled-decimal magnitude), no masks: 68 B per row."""
    from greengage_tpu_torch.ops import agg as agg_ops
    from greengage_tpu_torch.ops import fused_agg

    g = torch.Generator(device=dev).manual_seed(seed)
    rf = torch.randint(1, 4, (nseg, n), device=dev, generator=g)
    ls = torch.randint(1, 3, (nseg, n), device=dev, generator=g)
    live = torch.rand((nseg, n), device=dev, generator=g) > 0.014
    gid = torch.where(live, rf * 3 + ls, 0).to(torch.int32).contiguous()
    cols = [live.to(torch.int64)] + [torch.where(live, torch.randint(
        0, 10**11, (nseg, n), device=dev, generator=g), 0).contiguous()
        for _ in range(7)]
    return fused_agg.job_table(gid, 12, [
        agg_ops.Job(c, None, torch.int64) for c in cols])


def _q1_real_table(torch, dev, nseg, n, minmax=False, seed=1):
    """Q1's partial aggregate as _run_aggs records it through the port's
    fused path: gid, the filter's selection and the five base columns the
    Project hands over (quantity, extendedprice, the two decimal products,
    discount), with Q1's value ranges; 8 recorded jobs, 6 distinct.
    minmax adds min(extendedprice) and max(quantity), which take the
    general lane path."""
    from greengage_tpu_torch.ops import agg as agg_ops
    from greengage_tpu_torch.ops import fused_agg

    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(lo, hi):
        return torch.randint(lo, hi, (nseg, n), device=dev, generator=g)

    rf, ls = draw(0, 3), draw(0, 2)
    sel = torch.rand((nseg, n), device=dev, generator=g) > 0.014
    qty, price = draw(100, 5001), draw(90000, 10**7)
    disc, tax = draw(0, 11), draw(0, 9)
    dp = price * (100 - disc)
    charge = dp * (100 + tax)
    keys = [agg_ops.KeySpec(rf, None, None), agg_ops.KeySpec(ls, None, None)]
    gid, D = agg_ops.dense_gid(keys, [4, 3], sel)
    specs = _q1_specs([qty, price, dp, charge, disc])
    if minmax:
        specs += [agg_ops.AggSpec("min_price@m", "min", price, None),
                  agg_ops.AggSpec("max_qty@m", "max", qty, None)]
    return fused_agg.job_table(gid, D, fused_agg.record_jobs(specs, sel))


def _q1_specs(cols):
    """The AggSpecs of Q1's partial Aggregate (exec/compile.py's partial
    phase: @s sums, @c counts, and the @used presence count) over
    quantity, extendedprice, the two decimal products and discount; with
    fewer columns, every aggregate reads the first."""
    from greengage_tpu_torch.ops import agg as agg_ops

    qty, price, dp, charge, disc = (list(cols) * 5)[:5]
    A = agg_ops.AggSpec
    return [A("sum_qty@s", "sum", qty, None),
            A("sum_base@s", "sum", price, None),
            A("sum_disc@s", "sum", dp, None),
            A("sum_charge@s", "sum", charge, None),
            A("avg_qty@s", "sum", qty, None),
            A("avg_qty@c", "count", qty, None),
            A("avg_price@s", "sum", price, None),
            A("avg_price@c", "count", price, None),
            A("avg_disc@s", "sum", disc, None),
            A("avg_disc@c", "count", disc, None),
            A("count@c", "count_star", None, None),
            A("@used", "count_star", None, None)]


def compare(torch, got, want) -> float:
    """int64 equal; float64 NaN where the plain version has NaN and
    otherwise within relative 1e-12 (of max(|want|, 1)). -> max abs err."""
    err = 0.0
    for a, b in zip(got, want):
        if a.dtype != b.dtype:
            raise AssertionError(f"dtype {a.dtype} != {b.dtype}")
        if a.dtype == torch.float64:
            nan = b.isnan()
            if not torch.equal(a.isnan(), nan):
                raise AssertionError("NaN where the plain version has none")
            a, b = a[~nan], b[~nan]
            same = a == b                    # infinities of empty groups
            d = torch.where(same, 0.0, (a - b).abs())
            lim = FLOAT_RTOL * b.abs().clamp_min(1.0)
            if bool((d > lim).any()):
                raise AssertionError(f"float64 result off by {float(d.max())}")
            err = max(err, float(d.max()) if d.numel() else 0.0)
        elif not torch.equal(a, b):
            raise AssertionError("int64 result differs from the plain version")
    return err


def _bit_identical(torch, a, b) -> bool:
    return all(torch.equal(x.view(torch.int64), y.view(torch.int64))
               for x, y in zip(a, b))


def _library_ms(torch, table, want) -> float:
    gid, D = table.gid, table.D
    nseg = gid.shape[0]
    dev = gid.device
    vals = []
    for c, m, _, _, _ in table.jobs:
        live = table.masks[m] if m >= 0 else None
        v = table.cols[c] if c >= 0 else torch.ones_like(gid, dtype=torch.int64)
        vals.append((v if live is None else torch.where(live, v, 0)).reshape(-1))
    stacked = torch.stack(vals, dim=1)
    del vals
    flat = (torch.arange(nseg, device=dev)[:, None] * D
            + gid.to(torch.int64)).reshape(-1)
    J = len(table.jobs)

    def library():
        return torch.zeros((nseg * D, J), dtype=torch.int64,
                           device=dev).index_add_(0, flat, stacked)

    ms = cuda_ms(torch, library, 5)
    if not torch.equal(library().reshape(nseg, D, J).permute(2, 0, 1),
                       torch.stack(want)):
        raise AssertionError("index_add_ yardstick disagrees")
    return ms


def _timed_form(torch, table, name: str, reps: int) -> dict:
    """Kernel, plain and library times of one table at Q1's shapes, and
    its bound. The library yardstick, for a table of sums, is ONE
    index_add_ of the stacked, already masked job values into
    [nseg * D, jobs] (the masking and stacking are not timed; the port
    never calls it); other tables have none."""
    from greengage_tpu_torch.ops import fused_agg

    gid, D = table.gid, table.D
    nseg, n = gid.shape
    got = fused_agg._segment_reduce_kernel(table)
    want = fused_agg._segment_reduce_plain(table)
    err = compare(torch, got, want)
    ms = cuda_ms(torch, lambda: fused_agg._segment_reduce_kernel(table), reps)
    plain_ms = cuda_ms(torch, lambda: fused_agg._segment_reduce_plain(table),
                       3)
    library_ms = None
    if all(op == 0 for _, _, op, _, _ in table.jobs):
        library_ms = _library_ms(torch, table, want)
    path, threads, smem, blocks = fused_agg.launch_shape(table)
    nbytes = kernel_bytes(table, blocks)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"phase": "kernel", "case": name, "nseg": nseg, "n": n, "D": D,
           "jobs": len(table.jobs), "recorded_jobs": len(table.slots),
           "columns": table.nstream, "masks": len(table.masks),
           "bytes_per_row": table.bytes_per_row, "bytes": nbytes,
           "path": path, "threads": threads, "shared_bytes": smem,
           "blocks_per_segment": blocks, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "share_of_bound": bound_ms / ms, "max_abs_err": err, "ok": True}
    emit(row)
    return row


def phase_kernel(torch, dev, nseg_q1: int, rows_q1: int) -> dict:
    from greengage_tpu_torch.ops import fused_agg

    rng = np.random.default_rng(11)
    ints = [("i64", "sum")] * 2 + [("i64", "min"), ("i64", "max"),
                                   ("count", "sum")]
    dtypes = [("i64", "sum"), ("i64", "min"), ("i64", "max"), ("i32", "sum"),
              ("i32", "min"), ("i32", "max"), ("bool", "sum"), ("f64", "sum"),
              ("f64", "min"), ("f64", "max"), ("count", "sum")]
    # int64 sums, each column feeding one job: the merged-rows update
    sums = [("i64", "sum"), ("i32", "sum"), ("bool", "sum"), ("count", "sum"),
            ("lit", "sum")]
    floats = [("f64", "sum"), ("f64nan", "sum"), ("f64nan", "min"),
              ("f64nan", "max"), ("i64", "sum")]
    # 40 recorded jobs over 64 groups take the warp-aggregated path
    wide = (dtypes * 4)[:39] + [("count", "sum")]
    # the lane-private path holds J * D <= 113: the dtype cases run D = 8
    cases = [
        # name, nseg, n, D, spec, live, masked
        ("lane: D=1 one segment ragged", 1, 100_003, 1, ints, 0.98, True),
        ("lane: D=12 eight segments", 8, 50_001, 12, ints, 0.98, True),
        ("lane: sums, masked", 8, 50_001, 12, sums, 0.98, True),
        ("lane: sums, pre-masked", 8, 50_001, 12, sums[:3], 0.98, False),
        ("lane: sums, all rows dead", 8, 4_097, 12, sums, 0.0, True),
        ("lane: sums, one row per segment", 8, 1, 12, sums, 1.0, True),
        ("lane: masked, every dtype, duplicates", 8, 50_001, 8,
         dtypes + dtypes[:3] * 2, 0.98, True),
        ("lane: pre-masked, every dtype", 8, 50_001, 8, dtypes, 0.98, False),
        ("lane: stride-0 literal", 8, 4_099, 12,
         [("lit", "sum"), ("lit", "max"), ("i64", "sum")], 0.9, True),
        ("lane: float64 with NaN", 8, 65_537, 12, floats, 0.97, True),
        ("lane: all rows dead", 8, 4_097, 8, dtypes, 0.0, True),
        ("lane: one row", 1, 1, 8, dtypes, 1.0, True),
        ("lane: one row per segment", 8, 1, 12, ints, 1.0, True),
        ("warp: D=64 masked, every dtype", 8, 30_011, 64, wide, 0.9, True),
        ("warp: D=64 pre-masked", 3, 20_001, 64, dtypes * 2, 0.9, False),
        ("warp: D=12 masked, 14 jobs", 8, 50_001, 12,
         dtypes + dtypes[:3] * 2, 0.98, True),
        ("warp: all rows dead", 2, 999, 64, wide, 0.0, True),
        ("warp: float64 with NaN", 4, 7_777, 64, floats * 8, 0.95, True),
    ]
    max_err = 0.0
    paths = set()
    for name, nseg, n, D, spec, live, masked in cases:
        gid, descs = _case(torch, rng, dev, nseg, n, D, spec, live, masked)
        table = fused_agg.job_table(gid, D, descs)
        path = fused_agg.launch_plan(len(table.jobs), D)[0]
        if path != (fused_agg.PATH_LANE if name.startswith("lane")
                    else fused_agg.PATH_WARP):
            raise AssertionError(f"{name}: took path {path}")
        paths.add(path)
        got = fused_agg._segment_reduce_kernel(table)
        torch.cuda.synchronize()
        want = fused_agg._segment_reduce_plain(table)
        err = compare(torch, got, want)
        max_err = max(max_err, err)
        emit({"phase": "kernel", "case": name, "nseg": nseg, "n": n, "D": D,
              "jobs": len(table.jobs), "recorded_jobs": len(descs),
              "path": path, "max_abs_err": err, "ok": True})
    if paths != {fused_agg.PATH_LANE, fused_agg.PATH_WARP}:
        raise AssertionError(f"the cases took paths {paths}, not both")

    # float64 sums twice on the same inputs: bit-identical on both paths
    for name, D, spec in (("lane", 12, floats), ("warp", 64, floats * 8)):
        gid, descs = _case(torch, rng, dev, 8, 1_000_003, D, spec, 0.97)
        table = fused_agg.job_table(gid, D, descs)
        a = [r.clone() for r in fused_agg._segment_reduce_kernel(table)]
        b = fused_agg._segment_reduce_kernel(table)
        if not _bit_identical(torch, a, b):
            raise AssertionError(f"{name}: two runs differ")
        emit({"phase": "kernel", "case": f"{name}: float64 run to run",
              "nseg": 8, "n": 1_000_003, "D": D, "bit_identical": True,
              "ok": True})
        del gid, descs, table, a, b

    # the wrapper and the fused path around it never wait for the device
    gid, descs = _case(torch, rng, dev, 8, 10_001, 12, sums, 0.9)
    table = fused_agg.job_table(gid, 12, descs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused_agg._segment_reduce_kernel(table)
        fused_agg.fused_dense_aggregate(gid, 12, _q1_specs(table.cols[:1]),
                                        descs[0].live)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    emit({"phase": "kernel", "case": "no host synchronisation (torch sync "
          "debug mode 'error')", "ok": True})

    # TPC-H Q1's partial aggregate at --sf, in two forms
    n = -(-rows_q1 // nseg_q1)
    pr1 = _timed_form(torch, _q1_pr1_table(torch, dev, nseg_q1, n),
                      "Q1 partial aggregate, first kernel's inputs (8 "
                      "pre-masked int64 columns)", 20)
    torch.cuda.empty_cache()
    q1 = _timed_form(torch, _q1_real_table(torch, dev, nseg_q1, n),
                     "Q1 partial aggregate, Q1's job table (gid, selection, "
                     "5 base columns)", 20)
    torch.cuda.empty_cache()
    mm = _timed_form(torch, _q1_real_table(torch, dev, nseg_q1, n, True),
                     "Q1 partial aggregate with min and max (general lane "
                     "path)", 20)
    max_err = max(max_err, pr1["max_abs_err"], q1["max_abs_err"],
                  mm["max_abs_err"])
    torch.cuda.empty_cache()
    return {"name": "fused_dense_agg", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
            "max_abs_err": max_err, "ms": q1["ms"],
            "plain_ms": q1["plain_ms"], "bound_ms": q1["bound_ms"],
            "bound_by": "bytes", "library_ms": q1["library_ms"]}


# ---------------------------------------------------------------------------
# TPC-H Q1 against a numpy reference
# ---------------------------------------------------------------------------

def q1_reference(li: dict, cutoff: int) -> dict:
    """Independent numpy Q1 over the generator's columns: exact int64
    sums and counts per (returnflag, linestatus) with np.add.at, avg as
    the same float64 division the engine does."""
    rf, ls = li["l_returnflag"], li["l_linestatus"]
    m = li["l_shipdate"] <= cutoff
    nls = len(ls.vocab)
    g = (rf.codes.astype(np.int64) * nls + ls.codes)[m]
    qty = li["l_quantity"][m]
    ep = li["l_extendedprice"][m]
    disc = li["l_discount"][m]
    tax = li["l_tax"][m]
    dp = ep * (100 - disc)
    cols = {"qty": qty, "base": ep, "disc_price": dp,
            "charge": dp * (100 + tax), "disc": disc}
    G = len(rf.vocab) * nls
    sums = {}
    for k, v in cols.items():
        s = np.zeros(G, np.int64)
        np.add.at(s, g, v)
        sums[k] = s
    cnt = np.zeros(G, np.int64)
    np.add.at(cnt, g, 1)
    out = {}
    for gi in range(G):
        if cnt[gi] == 0:
            continue
        c = np.float64(cnt[gi])
        key = (rf.vocab[gi // nls], ls.vocab[gi % nls])
        out[key] = dict(
            sum_qty=int(sums["qty"][gi]), sum_base_price=int(sums["base"][gi]),
            sum_disc_price=int(sums["disc_price"][gi]),
            sum_charge=int(sums["charge"][gi]),
            avg_qty=np.float64(sums["qty"][gi]) / c / 100.0,
            avg_price=np.float64(sums["base"][gi]) / c / 100.0,
            avg_disc=np.float64(sums["disc"][gi]) / c / 100.0,
            count_order=int(cnt[gi]))
    return out


def check_q1(res, ref: dict) -> int:
    rows = res.rows()
    keys = [(r[0], r[1]) for r in rows]
    if keys != sorted(ref):
        raise AssertionError(f"groups {keys} != {sorted(ref)}")
    ids = dict(zip(res.columns, res._order))
    for i, key in enumerate(keys):
        want = ref[key]
        for name, w in want.items():
            cid = ids[name]
            got = res.raw[cid][i]
            if isinstance(w, int):
                ok = int(got) == w
            else:   # avg: bit-for-bit after the same float64 division
                ok = np.float64(got).tobytes() == np.float64(w).tobytes()
            if not ok:
                raise AssertionError(f"{key} {name}: {got!r} != {w!r}")
    return len(rows)


def profile_q1(torch, run) -> dict:
    """One warm Q1 under torch.profiler: device time by kernel, by the
    torch op that launched it, and the device's busy share of the host
    wall time (kernel time only, so nothing is counted twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels, ops = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if dev_us <= 0:
            continue
        row = (dev_us, e.key[:80], e.count)
        (kernels if e.device_type == DeviceType.CUDA else ops).append(row)
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    busy = sum(r[0] for r in kernels)

    def top(rows):
        return [{"name": k, "device_us": us, "calls": c}
                for us, k, c in rows[:12]]

    return {"phase": "profile", "wall_us": wall_us, "device_us": busy,
            "device_busy_share": busy / wall_us, "kernel_launches":
            sum(r[2] for r in kernels), "by_kernel": top(kernels),
            "by_op": top(ops)}


def phase_q1(torch, dev, sf: float, nseg: int, reps: int, name: str,
             profile: bool = False):
    from greengage_tpu_torch import entry
    from greengage_tpu_torch.ops import fused_agg
    from greengage_tpu_torch.utils import tpch

    t = time.perf_counter()
    data = tpch.generate(sf)
    li = data["lineitem"]
    gen_s = time.perf_counter() - t
    nrows = len(li["l_orderkey"])
    t = time.perf_counter()
    table = entry.load_lineitem(li, nseg, dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t

    # the main path: every launch count set to 0 just before, read after
    fused_agg.LAUNCHES = 0
    t = time.perf_counter()
    res = entry.q1_result(table)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    launches = fused_agg.LAUNCHES
    if launches < 1:
        raise AssertionError("Q1 did not launch the fused_dense_agg kernel")

    warm = []
    for _ in range(reps):
        t = time.perf_counter()
        again = entry.q1_result(table)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t)
    warm_s = statistics.median(warm)
    t = time.perf_counter()
    ref = q1_reference(li, entry.Q1_CUTOFF)
    ref_s = time.perf_counter() - t
    ngroups = check_q1(res, ref)
    check_q1(again, ref)
    rows = res.rows()
    if profile:
        emit(profile_q1(torch, lambda: entry.q1_result(table)))
    emit({"phase": "q1", "sf": sf, "nseg": nseg, "lineitem_rows": nrows,
          "segment_capacity": table.capacity, "groups": ngroups,
          "generate_s": gen_s, "stage_s": stage_s, "cold_s": cold_s,
          "warm_median_s": warm_s, "warm_s": warm, "reference_s": ref_s,
          "rows_per_s": nrows / warm_s, "device": name,
          "fused_dense_agg_launches": launches,
          "first_row": [str(v) for v in rows[0]], "ok": True})
    del data, li, table
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--nseg", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm Q1 run (torch.profiler)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from greengage_tpu_torch import build

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi_line = smi()
    emit({"phase": "device", "name": name, "nvidia_smi": smi_line,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t = time.perf_counter()
    logs = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "kernels": list(build.KERNELS),
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "entry function" in ln or "Used" in ln
                        or "stack frame" in ln]
                    for k, v in logs.items()}})

    # Q1's lineitem at this scale: ~6M rows per unit of scale factor
    kernel = phase_kernel(torch, dev, args.nseg, int(6_000_000 * args.sf))
    torch.cuda.empty_cache()
    kernel["launches"] = phase_q1(torch, dev, args.sf, args.nseg, args.reps,
                                  name, args.profile)

    from greengage_tpu_torch import entry

    emit({"phase": "dryrun", "nseg": args.nseg,
          "rows": entry.dryrun_step(args.nseg, dev), "ok": True})
    emit({"kernels": [kernel]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
