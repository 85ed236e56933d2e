"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 10] [--nseg 8] [--reps 5] [--profile]

Phases, one JSON line each; any failure exits non-zero:

  device   the card's name and power limit (nvidia-smi)
  build    compile every CUDA kernel of the port (nvcc, sm_90a) and the
           host codec (native/ggcodec.cpp, g++) into
           greengage_tpu_torch/_build/; the codec's route
  kernel   each kernel against its plain PyTorch version on the card, at
           edge shapes and at the shapes TPC-H Q1 gives it; times of the
           kernel, the plain version and one library call, and the bound
  generate TPC-H data at scale factor ``--sf`` (every table)
  q1       TPC-H Q1 over ``--nseg`` segments through the hand-built
           physical plan (entry.q1_result), checked exactly against a
           numpy reference on the same data; the kernel launch counts of
           that run (``--profile`` adds device time by kernel for one warm
           run)
  sql      SQL in, rows out: greengage_tpu_torch.connect, the TPC-H DDL,
           a bulk load of lineitem, ANALYZE, then Q1 and Q6 as text. Q1
           equals the numpy reference and the physical plan's rows, and
           launches the fused kernel exactly once per statement, its
           aggregate under sync debug mode "error"; Q6 and a scalar
           min/max equal numpy references. Load, analyze, plan and cold
           times, warm medians of SQL Q1, the physical-plan Q1, SQL Q6 and
           the min/max in turn,
           the device memory peak and the host syncs of one warm SQL Q1
           (``--profile`` profiles one warm SQL Q1 too)
  joins    TPC-H Q3 and Q12 as SQL on the sql phase's Database: orders
           and customer loaded and analyzed beside lineitem; Q3 and Q12
           exact against numpy references, Q3 through the sort-built hash
           tables (no_direct) equal to its direct-path rows, Q12's fused
           kernel launches per statement and its time at Q12's job table,
           warm medians of SQL Q1, SQL Q3,
           hash-path Q3 and SQL Q12 in turn, the host syncs of one warm Q3
           on each path, the device memory peak (``--profile`` profiles
           one warm Q3 on each path and one warm Q12)
  windows  window functions, ROLLUP, UNION and constant relations as SQL
           on the same Database: a segment-local window over lineitem,
           windows over a Redistribute by their partition key (ranks, a
           running max, a float64 running sum), the global
           unordered, ordered (ranks, ntile, lag/lead) and range
           (sampled-splitter repartition, running aggregates) modes over
           orders, a ROLLUP through the fused kernel, UNION ALL and a
           distinct UNION, SELECT without FROM and a constant relation
           crossed onto lineitem; each exact against a numpy reference
           and planned in its named mode with no one-segment funnel; cold
           seconds, warm medians in turn with SQL Q1, tiers_used, the
           host syncs of one warm statement per window mode, the fused
           kernel's launches per ROLLUP, the kernel against its plain
           version and its bound at the ROLLUP's two job tables, each
           warm statement's attempts and the flags it re-ran for (none a
           cap hint sizes) and the device
           memory peak (``--profile`` profiles one warm statement per
           window mode)
  spill    admission and spill passes on the same Database: the earlier
           phases' statements at the default ceiling (none spills; each
           one's est_bytes x nseg beside what it is admitted at, measured
           or estimated, and its peak), Q1 past a quarter of what it is
           admitted at (not below an eighth of its estimate) in
           partial-aggregate passes (one fused launch per pass where the
           gate passes, its peak below the unspilled Q1's), Q3's joins
           grouped by order priority (a first run, admitted by its
           estimate), a PARTITION BY window and an ORDER BY past ceilings
           set as Q1's, each exact against numpy; a real
           out-of-memory error (a ballast tensor, admission off) demoted
           to the spill passes; a warm Q1 with another date literal
           hitting the plan cache; the host syncs of a spilled Q1, and
           the kernel against its plain version and bound at one pass's
           job table
  serve    concurrent statements on the same Database: 64 TPC-H Q6s from
           16 threads, batching off and on; a cancelled batch member; Q3
           past its statement timeout; a resource queue of one slot
  wire     SQL over the server's unix socket on the same Database
           (runtime/server.py): Q1, Q6 and Q3 exact against numpy, Q1
           launching the fused kernel once (the kernel line's numbers are
           its job table's: this is the main path); warm medians over the
           wire beside the in-process ones, in turn; 64 Q6s from 16
           connections with batching on, beside the serve phase's
           in-process numbers; ps and cancel of a held statement; a
           client gone mid-statement; the mem and metrics ops; a warm Q1
           admitted by its measured bytes; a brownout caused by a ballast
           tensor on the card, batching off while it lasts, then cleared;
           max_connections = 2 shedding a third connection; TCP with a
           user's password; stop() with a statement in flight
  measure  on the same Database: the cost model's six primitives and the
           memory bandwidth measured on the card (mgmt/cli.py), each
           beside the TPU v5e default and the ratio; the TPC-H corpus
           re-planned under them (the plans that change); Q1, Q3 and Q12
           exact under them, warm times beside the defaults' (before and
           after), the defaults restored; EXPLAIN ANALYZE of SQL Q1 (the
           kernel line's numbers: this is the main path) with per-node
           rows against numpy, one kernel launch held against its plain
           version, a warm run admitted by its measured bytes, and its
           time beside the plain Q1's in turns; EXPLAIN ANALYZE of Q3 with
           each join's rows against numpy; the feedback loop on an
           un-analyzed 60M-row table (the default 1/3 selectivity
           corrected after one run, one promotion in five runs, the
           checkperf op over the server); a warm Q6's host syncs (2); CREATE
           EXTENSION geo over 60M float64 points (count exact, sum to a
           relative 1e-12, against numpy); the FTS probe
  tpch22_sf10  all 22 TPC-H statements (utils/plancorpus.TPCH22) on the
           measure phase's Database, supplier and partsupp loaded beside
           its tables: each cold, then ``--reps`` warm; the warm median,
           the fused kernel's launches, tiers_used, spill passes, the
           measured against the estimated bytes, and the kernel against
           its plain version and bound at the job table of every statement
           that launches it
  tpch22_check  the 22 statements on the card at SF 1 (CHECK_SF), each
           exact against the port's own CPU rows (connect(device="cpu"))
           on the same data
  durable  the main path from disk: lineitem, orders and customer written
           into a fresh database directory (block files, the manifest),
           the Database closed and the directory reopened; SQL Q1 cold
           (staged from the block files: the kernel line's numbers are its
           job table's) and warm, one fused launch each, exact against
           numpy; Q3 and Q12 exact; write seconds, bytes on disk, reopen
           seconds, staging and warm times beside the in-memory store's;
           the directory removed at the end
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
# the in-memory store's numbers (sql and joins phases), beside which the
# durable phase prints the same statements read from a directory
MEMORY_STORE: dict = {}


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
    """The library yardstick: one index_add_ of the stacked, already masked
    sum jobs into [nseg * D, jobs] (one per accumulation dtype), and one
    scatter_reduce_ with amin or amax per min or max job (masked rows
    carry the job's identity). The masking and stacking are not timed;
    the port never calls it. Held equal to the plain version's results."""
    gid, D = table.gid, table.D
    nseg = gid.shape[0]
    dev = gid.device
    flat = (torch.arange(nseg, device=dev)[:, None] * D
            + gid.to(torch.int64)).reshape(-1)
    sums: dict = {}          # dtype -> [(job index, values)]
    minmax = []              # (job index, values, reduce, identity, dtype)
    for j, (c, m, op, is_float, ident) in enumerate(table.jobs):
        dt = torch.float64 if is_float else torch.int64
        v = table.cols[c].to(dt) if c >= 0 \
            else torch.ones_like(gid, dtype=dt)
        fill = 0 if op == 0 else ident
        if m >= 0:
            v = torch.where(table.masks[m], v,
                            torch.tensor(fill, dtype=dt, device=dev))
        if op == 0:
            sums.setdefault(dt, []).append((j, v.reshape(-1)))
        else:
            minmax.append((j, v.reshape(-1), "amin" if op == 1 else "amax",
                           ident, dt))
    stacks = {dt: ([j for j, _ in vs], torch.stack([v for _, v in vs], 1))
              for dt, vs in sums.items()}

    def library():
        out = {}
        for dt, (idx, stacked) in stacks.items():
            r = torch.zeros((nseg * D, len(idx)), dtype=dt,
                            device=dev).index_add_(0, flat, stacked)
            out.update({j: r[:, k] for k, j in enumerate(idx)})
        for j, v, how, ident, dt in minmax:
            out[j] = torch.full((nseg * D,), ident, dtype=dt,
                                device=dev).scatter_reduce_(
                0, flat, v, reduce=how, include_self=True)
        return out

    ms = cuda_ms(torch, library, 5)
    got = library()
    for j, w in enumerate(want):
        if not torch.equal(got[j].reshape(nseg, D), w):
            raise AssertionError(f"the library yardstick disagrees at job "
                                 f"{j}")
    return ms


def _timed_form(torch, table, name: str, reps: int) -> dict:
    """Kernel, plain and library times of one job table, and its bound
    (the library yardstick: _library_ms)."""
    from greengage_tpu_torch.ops import fused_agg

    gid, D = table.gid, table.D
    nseg, n = gid.shape
    got = fused_agg._segment_reduce_kernel(table)
    want = fused_agg._segment_reduce_plain(table)
    err = compare(torch, got, want)
    ms = cuda_ms(torch, lambda: fused_agg._segment_reduce_kernel(table), reps)
    plain_ms = cuda_ms(torch, lambda: fused_agg._segment_reduce_plain(table),
                       3)
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


def phase_q1(torch, dev, data, sf: float, nseg: int, reps: int, name: str,
             profile: bool = False):
    """-> (launches, the physical-plan Q1's rows, the staged table, the
    numpy reference)."""
    from greengage_tpu_torch import entry
    from greengage_tpu_torch.ops import fused_agg

    li = data["lineitem"]
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
        emit(dict(profile_q1(torch, lambda: entry.q1_result(table)),
                  path="q1 physical plan"))
    emit({"phase": "q1", "sf": sf, "nseg": nseg, "lineitem_rows": nrows,
          "segment_capacity": table.capacity, "groups": ngroups,
          "stage_s": stage_s, "cold_s": cold_s,
          "warm_median_s": warm_s, "warm_s": warm, "reference_s": ref_s,
          "rows_per_s": nrows / warm_s, "device": name,
          "fused_dense_agg_launches": launches,
          "first_row": [str(v) for v in rows[0]], "ok": True})
    return launches, rows, table, ref


# ---------------------------------------------------------------------------
# SQL in, rows out: the port's Database
# ---------------------------------------------------------------------------

# tests/test_sql.py's Q1 (pricing summary) and the plan corpus's Q6
# (forecasting revenue change), as a user sends them
SQL_Q1 = """
      select l_returnflag, l_linestatus,
             sum(l_quantity) as sum_qty,
             sum(l_extendedprice) as sum_base_price,
             sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
             sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
             avg(l_quantity) as avg_qty,
             avg(l_extendedprice) as avg_price,
             avg(l_discount) as avg_disc,
             count(*) as count_order
      from lineitem
      where l_shipdate <= date '1998-12-01' - interval '90' day
      group by l_returnflag, l_linestatus
      order by l_returnflag, l_linestatus
"""
SQL_Q6 = """
      select sum(l_extendedprice * l_discount) as revenue
      from lineitem
      where l_shipdate >= date '1994-01-01'
        and l_shipdate < date '1995-01-01'
        and l_discount between 0.05 and 0.07 and l_quantity < 24"""
# a scalar min/max: row reductions, as Q6's sum
SQL_MINMAX = """
      select min(l_extendedprice), max(l_extendedprice), min(l_shipdate),
             max(l_shipdate)
      from lineitem where l_quantity < 24"""


def _days(iso: str) -> int:
    return int((np.datetime64(iso) - np.datetime64("1970-01-01"))
               .astype(np.int64))


def q6_reference(li: dict) -> int:
    """Independent numpy Q6 over the generator's columns: the exact int64
    sum of extendedprice x discount (scale 4) over the filter."""
    sd, disc, qty = li["l_shipdate"], li["l_discount"], li["l_quantity"]
    m = ((sd >= _days("1994-01-01")) & (sd < _days("1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (qty < 2400))
    return int(np.sum(li["l_extendedprice"][m].astype(np.int64)
                      * disc[m].astype(np.int64)))


def minmax_reference(li: dict) -> list[int]:
    """SQL_MINMAX in numpy: the raw (scaled int64, day) values."""
    m = li["l_quantity"] < 2400
    ep, sd = li["l_extendedprice"][m], li["l_shipdate"][m]
    return [int(ep.min()), int(ep.max()), int(sd.min()), int(sd.max())]


def sync_census(torch, fn) -> dict:
    """Run fn once with torch's sync debug mode on "warn": -> each
    synchronising call site (file:line of the Python frame that made the
    torch call) and how often it synchronised."""
    import os
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites: dict = {}
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        site = f"{os.path.relpath(w.filename)}:{w.lineno}"
        sites[site] = sites.get(site, 0) + 1
    return sites


def phase_sql(torch, data, nseg: int, reps: int, name: str, q1_table,
              q1_rows, q1_ref, profile: bool = False):
    """SQL in, rows out through greengage_tpu_torch.connect at the data
    the q1 phase generated: DDL, a bulk load of lineitem, ANALYZE, then Q1
    and Q6 as text. Q1 must equal the numpy reference exactly and the
    physical plan's rows, launching the fused kernel exactly once per
    statement with no host synchronisation inside the aggregate; Q6 must
    equal its numpy reference exactly. -> (the kernel's launches in the
    main path's run (one cold Q1 and one cold Q6), the Database, which the
    joins phase goes on with)."""
    import greengage_tpu_torch
    from greengage_tpu_torch import entry
    from greengage_tpu_torch.ops import fused_agg
    from greengage_tpu_torch.sql.parser import parse
    from greengage_tpu_torch.utils import tpch

    li = data["lineitem"]
    db = greengage_tpu_torch.connect(numsegments=nseg)
    db.sql(tpch.DDL)
    t = time.perf_counter()
    db.load_table("lineitem", li)
    load_s = time.perf_counter() - t
    t = time.perf_counter()
    db.sql("analyze lineitem")
    analyze_s = time.perf_counter() - t
    t = time.perf_counter()
    db._plan(parse(SQL_Q1)[0])
    plan_ms = (time.perf_counter() - t) * 1e3

    # the main path: every launch count set to 0 just before, read after
    fused_agg.LAUNCHES = 0
    t = time.perf_counter()
    res = db.sql(SQL_Q1)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    q1_launches = fused_agg.LAUNCHES
    t = time.perf_counter()
    res6 = db.sql(SQL_Q6)
    torch.cuda.synchronize()
    cold6_s = time.perf_counter() - t
    launches = fused_agg.LAUNCHES
    if q1_launches != 1 or launches != 1:
        raise AssertionError(f"SQL Q1 launched the fused kernel "
                             f"{q1_launches} times and Q6 "
                             f"{launches - q1_launches}, expected 1 and 0")
    check_q1(res, q1_ref)
    if res.rows() != q1_rows:
        raise AssertionError("SQL Q1's rows differ from the physical plan's")
    want6 = q6_reference(li)
    got6 = int(res6.raw[res6._order[0]][0])
    if got6 != want6:
        raise AssertionError(f"Q6 revenue {got6} != numpy {want6}")

    # warm medians: SQL Q1, the physical-plan Q1, SQL Q6 and the scalar
    # min/max in turn, one warm-up each, then reps runs; every SQL Q1
    # launches exactly once
    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    warm = {"sql_q1": [], "plan_q1": [], "sql_q6": [], "sql_minmax": []}
    for i in range(reps + 1):
        before = fused_agg.LAUNCHES
        again, s1 = timed(lambda: db.sql(SQL_Q1))
        if fused_agg.LAUNCHES != before + 1:
            raise AssertionError("a warm SQL Q1 did not launch the fused "
                                 "kernel exactly once")
        _, s2 = timed(lambda: entry.q1_result(q1_table))
        again6, s3 = timed(lambda: db.sql(SQL_Q6))
        minmax, s4 = timed(lambda: db.sql(SQL_MINMAX))
        if i:
            warm["sql_q1"].append(s1)
            warm["plan_q1"].append(s2)
            warm["sql_q6"].append(s3)
            warm["sql_minmax"].append(s4)
    check_q1(again, q1_ref)
    if int(again6.raw[again6._order[0]][0]) != want6:
        raise AssertionError("a warm Q6 differs from the numpy reference")
    got_mm = [int(minmax.raw[c][0]) for c in minmax._order]
    if got_mm != minmax_reference(li):
        raise AssertionError(f"the scalar min/max {got_mm} != numpy "
                             f"{minmax_reference(li)}")

    # no host synchronisation inside the aggregate: the fused aggregate of
    # one warm SQL Q1 runs under sync debug mode "error"
    real = fused_agg.fused_dense_aggregate

    def guarded(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    fused_agg.fused_dense_aggregate = guarded
    try:
        before = fused_agg.LAUNCHES
        check_q1(db.sql(SQL_Q1), q1_ref)
        if fused_agg.LAUNCHES != before + 1:
            raise AssertionError("the guarded SQL Q1 did not launch once")
    finally:
        fused_agg.fused_dense_aggregate = real
    # the statement waits for the card twice, both in the executor: the
    # one read of the flags and live count, and the presentation's copy
    syncs = sync_census(torch, lambda: db.sql(SQL_Q1))
    inside = [s for s in syncs
              if not s.startswith("greengage_tpu_torch/exec/executor.py:")]
    if inside:
        raise AssertionError(f"a warm SQL Q1 synchronised outside the "
                             f"executor: {syncs}")

    if profile:
        emit(dict(profile_q1(torch, lambda: db.sql(SQL_Q1)), path="sql q1"))
    med = {k: statistics.median(v) for k, v in warm.items()}
    MEMORY_STORE.update(q1_cold_stage_ms=res.stats.get("stage_ms"),
                        q1_cold_s=cold_s, q1_warm_median_s=med["sql_q1"])
    emit({"phase": "sql", "sf_rows": len(li["l_orderkey"]), "nseg": nseg,
          "device": name, "load_s": load_s, "analyze_s": analyze_s,
          "q1_parse_bind_plan_ms": plan_ms,
          "q1_cold_s": cold_s, "q6_cold_s": cold6_s,
          "q1_cold_stats": {k: v for k, v in res.stats.items()
                            if k != "metrics"},
          "warm_median_s": med, "warm_s": warm,
          "q1_warm_stats": {k: v for k, v in again.stats.items()
                            if k != "metrics"},
          "sql_over_plan_ms": (med["sql_q1"] - med["plan_q1"]) * 1e3,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "syncs_per_warm_q1": sum(syncs.values()), "sync_sites": syncs,
          "fused_dense_agg_launches": launches, "q6_revenue": got6,
          "ok": True})
    return launches, db


# ---------------------------------------------------------------------------
# joins and sort-based grouping: TPC-H Q3 and Q12 as SQL
# ---------------------------------------------------------------------------

# the plan corpus's Q3 (shipping priority) and Q12 (shipping modes and
# order priority), as a user sends them
SQL_Q3 = """
      select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
             o_orderdate, o_shippriority
      from customer, orders, lineitem
      where c_mktsegment = 'BUILDING'
        and c_custkey = o_custkey and l_orderkey = o_orderkey
        and o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15'
      group by l_orderkey, o_orderdate, o_shippriority
      order by revenue desc, o_orderdate limit 10"""
SQL_Q12 = """
      select l_shipmode,
             sum(case when o_orderpriority = '1-URGENT'
                       or o_orderpriority = '2-HIGH' then 1 else 0 end)
               as high_line_count,
             sum(case when o_orderpriority <> '1-URGENT'
                       and o_orderpriority <> '2-HIGH' then 1 else 0 end)
               as low_line_count
      from orders, lineitem
      where o_orderkey = l_orderkey
        and l_shipmode in ('MAIL', 'SHIP')
        and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
        and l_receiptdate >= date '1994-01-01'
        and l_receiptdate < date '1995-01-01'
      group by l_shipmode order by l_shipmode"""


def q3_reference(data: dict) -> list:
    """Independent numpy Q3: filters by the BUILDING code and the dates,
    joins by indexing (the keys are dense and 1-based), sums
    extendedprice x (100 - discount) (scale 4) per orderkey with
    np.add.at. -> every group as (revenue, orderdate, orderkey), in the
    query's order (revenue desc, orderdate), ties by orderkey."""
    c, o, li = data["customer"], data["orders"], data["lineitem"]
    seg = c["c_mktsegment"]
    cust_ok = np.zeros(len(c["c_custkey"]) + 1, bool)
    cust_ok[c["c_custkey"]] = seg.codes == seg.vocab.index("BUILDING")
    cut = _days("1995-03-15")
    order_ok = np.zeros(len(o["o_orderkey"]) + 1, bool)
    order_ok[o["o_orderkey"]] = ((o["o_orderdate"] < cut)
                                 & cust_ok[o["o_custkey"]])
    ok = order_ok[li["l_orderkey"]] & (li["l_shipdate"] > cut)
    keys = li["l_orderkey"][ok]
    rev = np.zeros(len(order_ok), np.int64)
    np.add.at(rev, keys, li["l_extendedprice"][ok].astype(np.int64)
              * (100 - li["l_discount"][ok].astype(np.int64)))
    odate = np.zeros(len(order_ok), np.int64)
    odate[o["o_orderkey"]] = o["o_orderdate"]
    groups = np.unique(keys)
    order = np.lexsort((groups, odate[groups], -rev[groups]))
    g = groups[order]
    return list(zip(rev[g].tolist(), odate[g].tolist(), g.tolist()))


def check_q3(res, ref: list) -> None:
    """Q3's rows against the reference: the (revenue, orderdate) sequence
    exactly; the orderkeys as a multiset within each run of equal
    (revenue, orderdate), where the query leaves the order open."""
    ids = dict(zip(res.columns, res._order))
    got = list(zip(res.raw[ids["revenue"]].tolist(),
                   res.raw[ids["o_orderdate"]].tolist(),
                   res.raw[ids["l_orderkey"]].tolist()))
    if [(r, d) for r, d, _ in got] != [(r, d) for r, d, _ in ref[:10]]:
        raise AssertionError(f"Q3 (revenue, orderdate) {got} != {ref[:10]}")
    groups = set(ref)
    if len(set(got)) != len(got) or not groups.issuperset(got):
        raise AssertionError(f"Q3 rows {got} are not distinct groups")
    if any(int(v) != 0 for v in res.raw[ids["o_shippriority"]]):
        raise AssertionError("Q3 o_shippriority is not 0")


def q12_reference(data: dict) -> list:
    """Independent numpy Q12: the lineitem filter, each line's order
    priority by indexing orders (dense, 1-based keys), and the high and
    low line counts per shipmode. -> [(shipmode, high, low)] by name."""
    o, li = data["orders"], data["lineitem"]
    mode = li["l_shipmode"]
    wanted = [mode.vocab.index("MAIL"), mode.vocab.index("SHIP")]
    ok = (np.isin(mode.codes, wanted)
          & (li["l_commitdate"] < li["l_receiptdate"])
          & (li["l_shipdate"] < li["l_commitdate"])
          & (li["l_receiptdate"] >= _days("1994-01-01"))
          & (li["l_receiptdate"] < _days("1995-01-01")))
    pri = o["o_orderpriority"]
    high_codes = [pri.vocab.index("1-URGENT"), pri.vocab.index("2-HIGH")]
    high_of = np.zeros(len(o["o_orderkey"]) + 1, bool)
    high_of[o["o_orderkey"]] = np.isin(pri.codes, high_codes)
    high = high_of[li["l_orderkey"][ok]]
    codes = mode.codes[ok]
    out = []
    for code in sorted(wanted, key=lambda c: mode.vocab[c]):
        m = codes == code
        out.append((mode.vocab[code], int((m & high).sum()),
                    int((m & ~high).sum())))
    return out


def check_q12(res, ref: list) -> None:
    got = [(str(m), int(h), int(lo)) for m, h, lo in res.rows()]
    if got != ref:
        raise AssertionError(f"Q12 {got} != numpy {ref}")


def phase_joins(torch, data, db, nseg: int, reps: int, name: str,
                profile: bool = False, require_fused: bool = True) -> int:
    """TPC-H Q3 and Q12 as SQL on the sql phase's Database: load orders and
    customer beside lineitem and ANALYZE them; Q3 (three-way join, a
    GROUP BY without a dense domain, ORDER BY ... LIMIT) and Q12 (a join
    into the fused kernel's GROUP BY) equal numpy references exactly; Q3
    through the sort-built hash tables (no_direct) equals its direct-path
    rows; every warm Q12 launches the fused kernel as its gate decided
    (``stats["fused_gate"]``: once when it passed, never when it declined;
    ``require_fused`` asks that it passed, as it does at SF10: below
    ~SF 2 a warm Q12's join output, sized by its cap hint, has fewer rows
    per segment than ``fused_dense_min_rows``, and the gate declines in
    both packages); warm medians of
    SQL Q1, SQL Q3, Q3 over the hash path and SQL Q12 in turn; the kernel
    against its plain version and its bound at Q12's job table (when the
    warm gate passed); the host
    syncs of one warm Q3 on each path; the device memory peak. -> the
    kernel's launches in the main path's run (one cold Q3, one cold
    Q12)."""
    from greengage_tpu_torch.ops import fused_agg
    from greengage_tpu_torch.sql.parser import parse

    torch.cuda.reset_peak_memory_stats()
    load_s = {}
    for table in ("orders", "customer"):
        # customer's c_name is unique per row: coded in bulk, it stays a
        # dictionary column (Q3 never reads it)
        cols = _coded(data[table])
        t = time.perf_counter()
        db.load_table(table, cols)
        db.sql(f"analyze {table}")
        load_s[table] = time.perf_counter() - t

    # the main path: every launch count set to 0 just before, read after
    fused_agg.LAUNCHES = 0
    t = time.perf_counter()
    res3 = db.sql(SQL_Q3)
    torch.cuda.synchronize()
    cold3_s = time.perf_counter() - t
    q3_launches = fused_agg.LAUNCHES
    t = time.perf_counter()
    res12 = db.sql(SQL_Q12)
    torch.cuda.synchronize()
    cold12_s = time.perf_counter() - t
    launches = fused_agg.LAUNCHES
    # Q12's partial Aggregate takes the kernel once per run of its plan;
    # a first run that met duplicate build keys ran the unique-key plan too
    want12 = 1 + res12.stats["multi_join_replan"]
    if q3_launches != 0 or launches != want12:
        raise AssertionError(f"Q3 launched the fused kernel {q3_launches} "
                             f"times and Q12 {launches - q3_launches}, "
                             f"expected 0 and {want12}")
    t = time.perf_counter()
    ref3 = q3_reference(data)
    ref12 = q12_reference(data)
    ref_s = time.perf_counter() - t
    check_q3(res3, ref3)
    check_q12(res12, ref12)

    planned3, consts3, _ = db._plan(parse(SQL_Q3)[0])

    def hash_q3():
        return db.executor.run(planned3, consts3, no_direct=True)

    hashed = hash_q3()
    if hashed.rows() != res3.rows():
        raise AssertionError("Q3 over the hash tables differs from the "
                             "direct path")

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    warm = {"sql_q1": [], "sql_q3": [], "hash_q3": [], "sql_q12": []}
    for i in range(reps + 1):
        _, s1 = timed(lambda: db.sql(SQL_Q1))
        again3, s2 = timed(lambda: db.sql(SQL_Q3))
        againh, s3 = timed(hash_q3)
        before = fused_agg.LAUNCHES
        again12, s4 = timed(lambda: db.sql(SQL_Q12))
        gate = again12.stats["fused_gate"]
        if require_fused and not gate:
            raise AssertionError("the fused gate declined a warm SQL Q12")
        if fused_agg.LAUNCHES != before + int(gate):
            raise AssertionError(
                f"a warm SQL Q12 launched the fused kernel "
                f"{fused_agg.LAUNCHES - before} times, its gate "
                f"{'passed' if gate else 'declined'}")
        if i:
            for k, v in zip(warm, (s1, s2, s3, s4)):
                warm[k].append(v)
    check_q3(again3, ref3)
    check_q12(again12, ref12)
    if againh.rows() != again3.rows():
        raise AssertionError("a warm hash-path Q3 differs")

    # the job table a warm Q12 hands the kernel (gid, the join's
    # selection, the CASE columns), timed as the kernel phase times Q1's
    tables = []
    fused = fused_agg._segment_reduce_fused

    def keep(table):
        tables.append(table)
        return fused(table)

    fused_agg._segment_reduce_fused = keep
    try:
        check_q12(db.sql(SQL_Q12), ref12)
    finally:
        fused_agg._segment_reduce_fused = fused
    q12_kernel = {"ms": None, "bound_ms": None, "max_abs_err": None}
    if tables:
        q12_kernel = _timed_form(torch, tables[0], "Q12 partial aggregate "
                                 "over the join output (Q12's job table)",
                                 20)
    del tables

    # the direct path waits for the card in the executor only (the flags
    # and the presentation); the hash path's walk reads the host too
    syncs = sync_census(torch, lambda: db.sql(SQL_Q3))
    inside = [s for s in syncs
              if not s.startswith("greengage_tpu_torch/exec/executor.py:")]
    if inside:
        raise AssertionError(f"a warm SQL Q3 synchronised outside the "
                             f"executor: {syncs}")
    hash_syncs = sync_census(torch, hash_q3)
    if profile:
        emit(dict(profile_q1(torch, lambda: db.sql(SQL_Q3)), path="sql q3"))
        emit(dict(profile_q1(torch, hash_q3), path="q3 hash tables"))
        emit(dict(profile_q1(torch, lambda: db.sql(SQL_Q12)),
                  path="sql q12"))
    med = {k: statistics.median(v) for k, v in warm.items()}
    MEMORY_STORE.update(q3_warm_median_s=med["sql_q3"],
                        q12_warm_median_s=med["sql_q12"],
                        q1_warm_median_beside_joins_s=med["sql_q1"])
    emit({"phase": "joins", "nseg": nseg, "device": name,
          "orders_rows": len(data["orders"]["o_orderkey"]),
          "customer_rows": len(data["customer"]["c_custkey"]),
          "load_analyze_s": load_s, "reference_s": ref_s,
          "q3_cold_s": cold3_s, "q12_cold_s": cold12_s,
          "q3_cold_stats": {k: v for k, v in res3.stats.items()
                            if k != "metrics"},
          "q12_cold_stats": {k: v for k, v in res12.stats.items()
                             if k != "metrics"},
          "warm_median_s": med, "warm_s": warm,
          "q3_warm_stats": {k: v for k, v in again3.stats.items()
                            if k != "metrics"},
          "hash_q3_warm_stats": {k: v for k, v in againh.stats.items()
                                 if k != "metrics"},
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "syncs_per_warm_q3": sum(syncs.values()), "sync_sites": syncs,
          "syncs_per_warm_hash_q3": sum(hash_syncs.values()),
          "hash_sync_sites": hash_syncs,
          "q3_first_row": [str(v) for v in res3.rows()[0]],
          "q12_rows": [[str(v) for v in r] for r in res12.rows()],
          "q12_warm_fused_gate": gate,
          "q12_kernel_ms": q12_kernel["ms"],
          "q12_kernel_bound_ms": q12_kernel["bound_ms"],
          "q12_kernel_max_abs_err": q12_kernel["max_abs_err"],
          "fused_dense_agg_launches": launches, "ok": True})
    return launches


# ---------------------------------------------------------------------------
# windows, ROLLUP, UNION and constant relations as SQL
# ---------------------------------------------------------------------------

# name -> (statement, the planned mode of each of its Window nodes (None:
# segment-local), whether a range-repartition Motion feeds it)
WINDOWS = {
    "win_local": ("""
      select rn, count(*), sum(l_extendedprice), sum(run_qty)
      from (select l_extendedprice,
                   row_number() over (partition by l_orderkey
                                      order by l_extendedprice desc,
                                               l_linenumber) rn,
                   sum(l_quantity) over (partition by l_orderkey
                                         order by l_linenumber) run_qty
            from lineitem) t
      group by rn order by rn""", {None}, False),
    "win_partition": ("""
      select count(*), sum(cust_total), max(cust_total), sum(cust_rank)
      from (select sum(o_totalprice) over (partition by o_custkey)
                     cust_total,
                   rank() over (partition by o_custkey order by o_orderdate)
                     cust_rank
            from orders) t""", {None}, False),
    # a segment-local running max (the doubling min/max scan) and a
    # float64 running sum (the two-level float scan), sampled
    "win_running": ("""
      select o_orderkey, run_max, run_fsum
      from (select o_orderkey,
                   max(o_totalprice) over (partition by o_custkey
                                           order by o_orderdate) run_max,
                   sum(cast(o_totalprice as double precision))
                     over (partition by o_custkey order by o_orderdate)
                     run_fsum
            from orders) t
      where o_orderkey % 65536 = 1 order by o_orderkey""", {None}, False),
    "win_global_unordered": ("""
      select count(*), min(tot), max(tot), max(rn), sum(rn)
      from (select sum(o_totalprice) over () tot, row_number() over () rn
            from orders) t""", {True}, False),
    "win_global_ordered": ("""
      select nt, count(*), min(o_orderkey), max(o_orderkey), sum(dr),
             sum(rk)
      from (select o_orderkey,
                   ntile(100) over (order by o_orderkey) nt,
                   dense_rank() over (order by o_orderdate) dr,
                   rank() over (order by o_totalprice desc) rk
            from orders) t
      group by nt order by nt""", {"ordered"}, False),
    "win_lag_lead": ("""
      select o_orderkey, lp, lc
      from (select o_orderkey,
                   lag(o_totalprice) over (order by o_orderdate,
                                           o_orderkey) lp,
                   lead(o_custkey, 2) over (order by o_orderdate,
                                            o_orderkey) lc
            from orders) t
      where o_orderkey % 65536 = 1 order by o_orderkey""", {"ordered"},
                     False),
    "win_global_range": ("""
      select o_orderkey, rs, rc, rmax
      from (select o_orderkey,
                   sum(o_totalprice) over (order by o_totalprice,
                                           o_orderkey) rs,
                   count(*) over (order by o_totalprice, o_orderkey) rc,
                   max(o_orderdate) over (order by o_totalprice,
                                          o_orderkey) rmax
            from orders) t
      where o_orderkey % 65536 = 1 order by o_orderkey""", {"range"}, True),
}
# the most host syncs a warm statement may take (else 2: the flag read
# and the presentation's copy, one more per retry). win_local's GROUP BY
# rn Redistribute overflows tier 0 at SF10 in the JAX package too: the
# buckets are now sized as the JAX package sizes them (ROADMAP Queue 3
# item 3, fixed; tests/test_torch_window.py
# test_windows_phase_retries_against_jax), and a Redistribute overflow
# reports no exact count for a cap hint to keep, in either package
SYNCS = {"win_local": 3}
# the overflow flags that report the exact count their retry is sized from
# (and a cap hint keeps): group tables, join expansions, the pre-Gather
# compaction. A Redistribute bucket's or a hash table's reports none
EXACT_FLAGS = ("agg_overflow", "join_expand_overflow",
               "gather_compact_overflow")
# the warm times of the two statements that re-ran their retries on
# every warm run before the cap hints (PERF.md section 5, H100 80GB HBM3
# at 700 W): seconds, min and max
WARM_S_BEFORE_HINTS = {"win_local": (0.536, 0.541),
                       "union": (0.04665, 0.04695)}
SQL_ROLLUP = """
      select l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice),
             count(*)
      from lineitem where l_shipdate <= date '1998-09-02'
      group by rollup (l_returnflag, l_linestatus)
      order by l_returnflag, l_linestatus"""
# the plan corpus's union_all_branches
SQL_UNION_ALL = """
      select o_orderkey as k, o_totalprice as v from orders
        where o_totalprice > 150000
      union all
      select l_orderkey as k, l_extendedprice as v from lineitem
        where l_quantity > 45
      order by k, v limit 40"""
SQL_UNION = """
      select count(*) from (select o_custkey from orders
                            where o_totalprice > 499000
                            union
                            select c_custkey from customer
                            where c_nationkey < 3) u"""
SQL_CONST = "select 1 + 2, date '1998-12-01' - interval '90' day"
SQL_CONSTREL = """
      select count(*), sum(l_quantity * k) from lineitem, (select 2 as k) c"""


def _group_starts(keys) -> np.ndarray:
    """Index of the first row of each row's run of equal ``keys``."""
    first = np.ones(len(keys), bool)
    first[1:] = keys[1:] != keys[:-1]
    return np.maximum.accumulate(np.where(first, np.arange(len(keys)), 0))


def window_references(data: dict) -> dict:
    """Independent numpy references of the windows phase's statements, as
    the raw (scaled int64, day) values of their rows."""
    o, li, c = data["orders"], data["lineitem"], data["customer"]
    ref = {}
    # win_local: lineitem is generated by orderkey with linenumber 1..k,
    # at most 7 lines per order: a row's number is 1 + the lines of its
    # order that sort before it, counted over each pair of rows up to 6
    # apart (of a pair in one order, exactly one sorts first)
    lk, ln = li["l_orderkey"], li["l_linenumber"]
    ep, qty = li["l_extendedprice"].astype(np.int64), \
        li["l_quantity"].astype(np.int64)
    if np.any(np.diff(lk) < 0) or np.any(ln != np.arange(len(lk))
                                         - _group_starts(lk) + 1):
        raise AssertionError("lineitem is not grouped by order")
    n = len(lk)
    rn = np.ones(n, np.int64)
    for d in range(1, 7):
        a, b = slice(0, n - d), slice(d, n)
        same = lk[a] == lk[b]
        a_first = (ep[a] > ep[b]) | ((ep[a] == ep[b]) & (ln[a] < ln[b]))
        rn[b] += same & a_first
        rn[a] += same & ~a_first
    cs = np.cumsum(qty)
    start = np.arange(n) - (ln.astype(np.int64) - 1)
    run = cs - np.where(start > 0, cs[np.maximum(start - 1, 0)], 0)
    ref["win_local"] = [(r, int((rn == r).sum()), int(ep[rn == r].sum()),
                         int(run[rn == r].sum()))
                        for r in range(1, int(rn.max()) + 1)]
    # win_partition
    ck, tp, od = o["o_custkey"], o["o_totalprice"].astype(np.int64), \
        o["o_orderdate"].astype(np.int64)
    tot = np.bincount(ck, weights=tp).astype(np.int64)
    cnt = np.bincount(ck)
    order = np.lexsort((od, ck))
    sk, sd = ck[order], od[order]
    pos = np.arange(len(order))
    peer = _group_starts(sk * (1 << 20) + (sd - sd.min()))
    rank = peer - _group_starts(sk) + 1
    ref["win_partition"] = [(len(ck), int((cnt * tot).sum()), int(tot.max()),
                             int(rank.sum()))]
    # win_running over (custkey, orderdate) with peers: the running max and
    # the running sum of cents (exact, int64) at each peer group's last row
    first = np.r_[True, sk[1:] != sk[:-1]]
    gi = np.cumsum(first) - 1
    rmax = np.maximum.accumulate(gi * (1 << 40) + tp[order]) - gi * (1 << 40)
    peer_first = first | np.r_[True, sd[1:] != sd[:-1]]
    peer_end = (np.r_[np.flatnonzero(peer_first)[1:], len(order)]
                - 1)[np.cumsum(peer_first) - 1]
    cs = np.cumsum(tp[order])
    cstart = _group_starts(sk)
    run = cs[peer_end] - np.where(cstart > 0, cs[np.maximum(cstart - 1, 0)],
                                  0)
    at = np.empty(len(order), np.int64)
    at[order] = pos
    okey = o["o_orderkey"]
    sample = okey % 65536 == 1
    ref["win_running"] = [(int(k), int(rmax[peer_end[p]]),
                           int(run[p]) / 100)
                          for k, p in zip(okey[sample], at[sample])]
    # what every float64 running sum is exact to: the sum of |value| over
    # the table bounds every segment's prefix
    ref["win_running_total"] = float(tp.sum()) / 100
    # win_global_unordered
    N = len(tp)
    ref["win_global_unordered"] = [(N, int(tp.sum()), int(tp.sum()), N,
                                    N * (N + 1) // 2)]
    # win_global_ordered: orderkeys are 1..N in order; ntile(100) of
    # position p; dense rank of the date; rank by totalprice desc
    if not np.array_equal(okey, np.arange(1, N + 1)):
        raise AssertionError("orderkeys are not 1..N")
    q, r = divmod(N, 100)
    nt = np.where(pos < r * (q + 1), pos // (q + 1),
                  r + (pos - r * (q + 1)) // q) + 1
    dr = np.unique(od, return_inverse=True)[1].astype(np.int64) + 1
    stp = np.sort(tp)
    rk = N - np.searchsorted(stp, tp, side="right") + 1
    # nt rises with the position: each bucket is one run of rows
    lo = np.flatnonzero(np.r_[True, nt[1:] != nt[:-1]])
    hi = np.r_[lo[1:], N]
    ref["win_global_ordered"] = list(zip(
        nt[lo].tolist(), (hi - lo).tolist(), okey[lo].tolist(),
        okey[hi - 1].tolist(), np.add.reduceat(dr, lo).tolist(),
        np.add.reduceat(rk, lo).tolist()))
    # win_lag_lead over (orderdate, orderkey)
    order = np.lexsort((okey, od))
    at[order] = pos
    lag = [int(tp[order[p - 1]]) if p >= 1 else None
           for p in at[sample]]
    lead = [int(ck[order[p + 2]]) if p + 2 < N else None
            for p in at[sample]]
    ref["win_lag_lead"] = list(zip(okey[sample].tolist(), lag, lead))
    # win_global_range over (totalprice, orderkey): unique keys, so the
    # running frame ends at the row itself
    order = np.lexsort((okey, tp))
    at[order] = pos
    rs = np.cumsum(tp[order])
    rmax = np.maximum.accumulate(od[order])
    ref["win_global_range"] = [
        (int(k), int(rs[p]), int(p) + 1, int(rmax[p]))
        for k, p in zip(okey[sample], at[sample])]
    # rollup: (flag, status) groups, flag subtotals, the grand total; NULL
    # keys sort last
    m = li["l_shipdate"] <= _days("1998-09-02")
    fl, st = li["l_returnflag"], li["l_linestatus"]
    rows = []
    for f in sorted(fl.vocab):
        mf = m & (fl.codes == fl.vocab.index(f))
        for s_ in sorted(st.vocab):
            mfs = mf & (st.codes == st.vocab.index(s_))
            if mfs.any():
                rows.append((f, s_, int(qty[mfs].sum()), int(ep[mfs].sum()),
                             int(mfs.sum())))
        rows.append((f, None, int(qty[mf].sum()), int(ep[mf].sum()),
                     int(mf.sum())))
    rows.append((None, None, int(qty[m].sum()), int(ep[m].sum()),
                 int(m.sum())))
    ref["rollup"] = rows
    # union_all_branches: (k, v) by (k, v), the first 40
    mo, ml = tp > 15000000, qty > 4500
    k = np.concatenate([okey[mo], lk[ml]])
    v = np.concatenate([tp[mo], ep[ml]])
    u = np.lexsort((v, k))[:40]
    ref["union_all"] = list(zip(k[u].tolist(), v[u].tolist()))
    ref["union"] = [(len(np.union1d(ck[tp > 49900000],
                                    c["c_custkey"][c["c_nationkey"] < 3])),)]
    ref["constrel"] = [(n, 2 * int(qty.sum()))]
    return ref


def _raw_rows(res) -> list:
    """A result's rows as raw values (scaled int64 DECIMAL, days; TEXT
    decoded), None for NULL."""
    out = []
    for i in range(len(res)):
        row = []
        for cid in res._order:
            v = res.valids.get(cid)
            if v is not None and not v[i]:
                row.append(None)
            elif res.cols[cid].dtype == object:
                row.append(res.cols[cid][i])
            else:
                row.append(res.raw[cid][i].item())
        out.append(tuple(row))
    return out


def _windows_of(plan) -> list:
    from greengage_tpu_torch.planner.logical import Window

    out, stack = [], [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, Window):
            out.append(p)
        stack.extend(p.children)
    return out


def check_window_plan(db, name: str, text: str, modes: set,
                      ranged: bool) -> list:
    """The statement's Window nodes take the named mode, a range mode sits
    on a range-repartition Motion, and nothing funnels to one segment.
    -> the modes planned."""
    from greengage_tpu_torch.planner.logical import Motion, describe
    from greengage_tpu_torch.sql.parser import parse

    planned, _, _ = db._plan(parse(text)[0])
    wins = _windows_of(planned)
    got = [getattr(w, "global_mode", None) for w in wins]
    if not wins or set(got) != modes:
        raise AssertionError(f"{name} planned window modes {got}, "
                             f"expected {modes}")
    if "SingleQE" in describe(planned):
        raise AssertionError(f"{name} funnels to one segment")
    if ranged and not all(isinstance(w.child, Motion)
                          and w.child.range_spec is not None for w in wins):
        raise AssertionError(f"{name} has no range repartition")
    return got


def phase_windows(torch, data, db, nseg: int, reps: int, name: str,
                  profile: bool = False) -> int:
    """Window functions, ROLLUP, UNION and constant relations as SQL on the
    joins phase's Database (lineitem, orders and customer loaded whole):
    every statement exact against window_references, every window
    statement planned in its mode without a one-segment funnel, the
    ROLLUP's fused-kernel launches (one per keyed branch: 2) on every run;
    cold seconds, warm medians in turn with SQL Q1, tiers_used, the host
    syncs of one warm statement per window mode, the device memory peak;
    the kernel against its plain version, its bound and one index_add_ at
    the two job tables a warm ROLLUP hands it. -> (the kernel's launches
    in the main path's run (every statement once, cold), its launches per
    ROLLUP, the two tables' _timed_form rows)."""
    from greengage_tpu_torch.ops import fused_agg

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    ref = window_references(data)
    ref_s = time.perf_counter() - t
    stmts = {k: v[0] for k, v in WINDOWS.items()}
    stmts.update(rollup=SQL_ROLLUP, union_all=SQL_UNION_ALL,
                 union=SQL_UNION, const=SQL_CONST, constrel=SQL_CONSTREL)
    modes = {k: check_window_plan(db, k, *v) for k, v in WINDOWS.items()}

    def check(key, res):
        if key == "const":
            # the host path: decoded values, no raw storage form
            got, want = res.rows(), [(3, np.datetime64("1998-09-02"))]
        else:
            got, want = _raw_rows(res), ref[key]
        if key == "win_running":
            # keys and DECIMAL maxes exact; a float64 running sum is a
            # difference of two running sums, exact to 64 ulps of the
            # table's sum of |value| (which bounds every prefix)
            tol = 64 * np.finfo(np.float64).eps * ref["win_running_total"]
            err = max((abs(g[2] - w[2]) for g, w in zip(got, want)
                       if g[:2] == w[:2]), default=0.0)
            float_err[key] = err
            if len(got) == len(want) and err <= tol and all(
                    g[:2] == w[:2] for g, w in zip(got, want)):
                return
        if got != want:
            raise AssertionError(f"{key}: {got[:5]} != numpy {want[:5]} "
                                 f"({len(got)} and {len(want)} rows)")

    float_err = {}
    # the main path: every launch count set to 0 just before, read after
    fused_agg.LAUNCHES = 0
    cold, stats, rollup_launches = {}, {}, None
    for key, text in stmts.items():
        before = fused_agg.LAUNCHES
        t = time.perf_counter()
        res = db.sql(text)
        torch.cuda.synchronize()
        cold[key] = time.perf_counter() - t
        if key == "rollup":
            rollup_launches = fused_agg.LAUNCHES - before
        check(key, res)
        stats[key] = {k: v for k, v in getattr(res, "stats", {}).items()
                      if k in ("tiers_used", "attempts", "fused_gate",
                               "wall_ms", "stage_ms")}
    launches = fused_agg.LAUNCHES
    if rollup_launches != 2 or launches != 2:
        raise AssertionError(f"the ROLLUP launched the fused kernel "
                             f"{rollup_launches} times and the phase "
                             f"{launches}, expected 2 and 2")

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    warm = {"sql_q1": [], **{k: [] for k in stmts}}
    attempts, retried = {}, {}
    for i in range(reps + 1):
        _, s1 = timed(lambda: db.sql(SQL_Q1))
        if i:
            warm["sql_q1"].append(s1)
        for key, text in stmts.items():
            before = fused_agg.LAUNCHES
            res, sec = timed(lambda: db.sql(text))
            if key == "rollup" and fused_agg.LAUNCHES != before + 2:
                raise AssertionError("a warm ROLLUP did not launch the "
                                     "fused kernel twice")
            if i:
                warm[key].append(sec)
            if i == reps:
                check(key, res)
                attempts[key] = res.stats.get("attempts")
                retried[key] = res.stats.get("retried")
            if i:
                # a warm run starts at the exact counts its statement's last
                # run measured (the cap hints): no warm retry may come from
                # an overflow that reports one
                hinted = [f for flags in res.stats.get("retried", ())
                          for f in flags if f.startswith(EXACT_FLAGS)]
                if hinted:
                    raise AssertionError(f"a warm {key} re-ran for {hinted}, "
                                         "which its cap hints should size")
    if profile:
        for key in ("win_local", "win_partition", "win_running",
                    "win_global_unordered", "win_global_ordered",
                    "win_global_range", "rollup"):
            emit(dict(profile_q1(torch, lambda: db.sql(stmts[key])),
                      path=key))
    # one warm statement per window mode waits for the card in the
    # executor only, twice as a warm SQL Q1 does: the flag read and the
    # presentation's copy; a statement that retries reads its flags once
    # more per attempt, and no statement waits more than SYNCS says
    syncs, bad = {}, []
    for key in ("win_local", "win_partition", "win_running",
                "win_global_unordered", "win_global_ordered",
                "win_lag_lead", "win_global_range"):
        box = []
        syncs[key] = sync_census(torch, lambda: box.append(
            db.sql(stmts[key])))
        inside = [s for s in syncs[key] if not s.startswith(
            "greengage_tpu_torch/exec/executor.py:")]
        n = sum(syncs[key].values())
        if inside or n != 1 + box[0].stats["attempts"] \
                or n > SYNCS.get(key, 2):
            bad.append((key, syncs[key], box[0].stats["attempts"]))

    peak = torch.cuda.max_memory_allocated()

    # the ROLLUP's job tables (one per keyed branch, gid, the l_shipdate
    # mask, 2 sums and a count), timed as the kernel phase times Q1's
    tables = []
    fused = fused_agg._segment_reduce_fused

    def keep(table):
        tables.append(table)
        return fused(table)

    fused_agg._segment_reduce_fused = keep
    try:
        check("rollup", db.sql(SQL_ROLLUP))
    finally:
        fused_agg._segment_reduce_fused = fused
    if len(tables) != 2:
        raise AssertionError(f"a warm ROLLUP handed the kernel "
                             f"{len(tables)} job tables, expected 2")
    forms = [_timed_form(torch, t, f"ROLLUP keyed branch, D = {t.D} "
                         f"(lineitem, l_shipdate mask, 2 sums, a count)", 20)
             for t in tables]
    del tables
    med = {k: statistics.median(v) for k, v in warm.items()}
    emit({"phase": "windows", "nseg": nseg, "device": name,
          "orders_rows": len(data["orders"]["o_orderkey"]),
          "lineitem_rows": len(data["lineitem"]["l_orderkey"]),
          "reference_s": ref_s, "window_modes": modes, "cold_s": cold,
          "cold_stats": stats, "warm_median_s": med, "warm_s": warm,
          "rows": {k: len(v) for k, v in ref.items() if isinstance(v, list)},
          "max_memory_allocated": peak,
          "syncs": {k: sum(v.values()) for k, v in syncs.items()},
          "sync_sites": syncs, "float_max_abs_err": float_err,
          "warm_attempts": attempts,
          "warm_s_before_hints": WARM_S_BEFORE_HINTS,
          "warm_retried": retried,
          "rollup_fused_launches": rollup_launches,
          "rollup_kernel_ms": [f["ms"] for f in forms],
          "rollup_kernel_bound_ms": [f["bound_ms"] for f in forms],
          "fused_dense_agg_launches": launches, "ok": not bad})
    if bad:
        raise AssertionError(f"warm window statements synchronised "
                             f"outside the executor, other than once more "
                             f"than their attempts, or more than {SYNCS} "
                             f"times (else 2): {bad}")
    return launches, rollup_launches, forms


# ---------------------------------------------------------------------------
# admission, spill passes, the OOM demotion and the plan cache
# ---------------------------------------------------------------------------

# Q1 with its cutoff as a plain date: the literal is hoisted into the plan
# cache's parameter vector (the interval arithmetic of SQL_Q1 stays pinned)
SQL_Q1_AT = SQL_Q1.replace("date '1998-12-01' - interval '90' day",
                           "date '{}'")
# Q3's joins and filters grouped by order priority: TPC-H Q3 itself groups
# by lineitem's distribution key, a one-phase aggregate with no partial
# states to capture, which neither package spills
SQL_Q3_BY_PRIORITY = """
      select o_orderpriority,
             sum(l_extendedprice * (1 - l_discount)) as revenue,
             count(*) as lines
      from customer, orders, lineitem
      where c_mktsegment = 'BUILDING'
        and c_custkey = o_custkey and l_orderkey = o_orderkey
        and o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15'
      group by o_orderpriority order by o_orderpriority"""
SQL_WIN_SPILL = """
      select o_orderkey, ct
      from (select o_orderkey,
                   sum(o_totalprice) over (partition by o_custkey) ct
            from orders) t
      where o_orderkey % 1024 = 1"""
SQL_SORT_SPILL = """
      select l_orderkey, l_linenumber, l_extendedprice from lineitem
      where l_quantity < 3
      order by l_extendedprice desc, l_orderkey, l_linenumber"""


def q3_by_priority_reference(data: dict) -> list:
    """(orderpriority, revenue at scale 4, lines) per order priority, in
    priority order, over Q3's joins and filters (q3_reference's)."""
    c, o, li = data["customer"], data["orders"], data["lineitem"]
    seg = c["c_mktsegment"]
    cust_ok = np.zeros(len(c["c_custkey"]) + 1, bool)
    cust_ok[c["c_custkey"]] = seg.codes == seg.vocab.index("BUILDING")
    cut = _days("1995-03-15")
    order_ok = np.zeros(len(o["o_orderkey"]) + 1, bool)
    order_ok[o["o_orderkey"]] = ((o["o_orderdate"] < cut)
                                 & cust_ok[o["o_custkey"]])
    prio = o["o_orderpriority"]
    code = np.zeros(len(order_ok), np.int64)
    code[o["o_orderkey"]] = prio.codes
    ok = order_ok[li["l_orderkey"]] & (li["l_shipdate"] > cut)
    g = code[li["l_orderkey"][ok]]
    rev = li["l_extendedprice"][ok].astype(np.int64) \
        * (100 - li["l_discount"][ok].astype(np.int64))
    sums = np.zeros(len(prio.vocab), np.int64)
    np.add.at(sums, g, rev)
    cnt = np.bincount(g, minlength=len(prio.vocab))
    return sorted((prio.vocab[i], int(sums[i]), int(cnt[i]))
                  for i in range(len(prio.vocab)) if cnt[i])


def win_spill_reference(data: dict) -> list:
    o = data["orders"]
    ck, tp, ok = o["o_custkey"], o["o_totalprice"].astype(np.int64), \
        o["o_orderkey"]
    tot = np.zeros(int(ck.max()) + 1, np.int64)
    np.add.at(tot, ck, tp)
    m = ok % 1024 == 1
    return sorted(zip(ok[m].tolist(), tot[ck[m]].tolist()))


def sort_spill_reference(data: dict) -> list:
    li = data["lineitem"]
    m = li["l_quantity"] < 300             # 3.00 at scale 2
    k, ln, ep = li["l_orderkey"][m], li["l_linenumber"][m], \
        li["l_extendedprice"][m].astype(np.int64)
    order = np.lexsort((ln, k, -ep))
    return [k[order], ln[order], ep[order]]


def _fresh_peak(torch, db) -> int:
    """Drop the staged tables and the allocator's free blocks, reset the
    peak: -> the bytes still allocated (the baseline of the next peak)."""
    db.executor._stage_cache.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _admitted(db, text: str):
    """Run ``text`` until two runs in a row are admitted alike (by the
    same bytes, measured or estimated): a statement's first run measures
    its program, and the next runs are admitted by what it measured. ->
    the last run's Result, whose ``stats["mem"]["admitted_bytes"]`` the
    next run is admitted at."""
    prev = None
    for _ in range(5):
        res = db.sql(text)
        mem = res.stats["mem"]
        cur = (mem["admitted_by"], mem["admitted_bytes"])
        if cur == prev:
            return res
        prev = cur
    raise AssertionError(f"admission of {text.strip()[:60]!r} never "
                         f"settled: {res.stats['mem']}")


def _spill_ceiling_mb(res, share: int) -> int:
    """A spill ceiling from what a settled run of the statement was
    admitted at: 1/share of its admitted bytes, but not below an eighth
    of its estimate, because the passes are sized by their estimates (as
    in the JAX package), and far below that no pass fits; always below
    the admitted bytes, so the statement spills."""
    mem = res.stats["mem"]
    ceiling = max(mem["admitted_bytes"] // share, mem["est_bytes"] // 8)
    if ceiling >= mem["admitted_bytes"]:
        raise AssertionError(f"no ceiling below what the statement is "
                             f"admitted at: {mem}")
    return max(ceiling >> 20, 1)


def _at_limit(db, mb: int, text: str):
    db.sql(f"set vmem_protect_limit_mb = {mb}")
    try:
        return db.sql(text)
    finally:
        db.sql("set vmem_protect_limit_mb = 12288")


def phase_spill(torch, data, db, nseg: int, reps: int, name: str,
                require_fused: bool = True):
    """Admission and spill passes at SF10 on the windows phase's Database.
    Each ceiling is set from what the statement is admitted at
    (``stats["mem"]["admitted_bytes"]`` of a settled run: its measured
    bytes once its program was measured, its estimate before; see
    ``_spill_ceiling_mb``): Q1 past a quarter of it (not below an eighth
    of its estimate) in at least 4 partial-aggregate passes (the
    fused kernel launched once per pass; its peak memory below the
    unspilled statement's), Q3's joins grouped by order priority (join +
    partial aggregate over lineitem chunks),
    a PARTITION BY window spill and an ORDER BY sort spill, each exact
    against numpy; a real out-of-memory error (a ballast tensor leaves Q1
    too little room, admission off) demoted to the spill passes; the plan
    cache hit of a warm Q1 with another cutoff. -> (the kernel's launches
    in the phase, the _timed_form row of one spilled pass's job table)."""
    from greengage_tpu_torch.ops import fused_agg

    li = data["lineitem"]
    cut_a, cut_b = "1998-09-02", "1998-08-15"
    ref_a = q1_reference(li, _days(cut_a))
    q1_a = SQL_Q1_AT.format(cut_a)
    out = {"phase": "spill", "nseg": nseg, "device": name}
    ex = db.executor
    real_single = ex.run_single
    per_run = []

    def counted_single(*a, **k):
        before = fused_agg.LAUNCHES
        res = real_single(*a, **k)
        per_run.append(("merge" if k.get("aux_tables") else "pass",
                        fused_agg.LAUNCHES - before,
                        res.stats.get("fused_gate", False)))
        return res

    # the earlier phases' statements at the default ceiling: none may
    # spill; each one's estimate for every segment beside its own peak
    # over what was allocated before it (warm: its tables staged)
    est_vs_peak = {}
    earlier = {"q1": SQL_Q1, "q6": SQL_Q6, "minmax": SQL_MINMAX,
               "q3": SQL_Q3, "q12": SQL_Q12,
               **{k: v[0] for k, v in WINDOWS.items()}, "rollup": SQL_ROLLUP,
               "union_all": SQL_UNION_ALL, "union": SQL_UNION,
               "constrel": SQL_CONSTREL}
    for key, text in earlier.items():
        _admitted(db, text)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = db.sql(text)
        torch.cuda.synchronize()
        if "spill_passes" in res.stats:
            raise AssertionError(f"{key} spilled at the default ceiling")
        mem = res.stats["mem"]
        est_vs_peak[key] = {
            "est_bytes_x_nseg": mem["est_bytes"] * nseg,
            "admitted_by": mem["admitted_by"],
            "admitted_bytes_x_nseg": mem["admitted_bytes"] * nseg,
            "measured": mem["measured"],
            "peak_over_base": torch.cuda.max_memory_allocated() - base}
    out["est_vs_peak"] = est_vs_peak

    # the main path of this slice: every launch count set to 0 just
    # before, read after
    fused_agg.LAUNCHES = 0
    ex.run_single = counted_single
    try:
        # ---- Q1: unspilled, then past a quarter of what it is admitted
        # at -------------------------------------------------------------
        _admitted(db, q1_a)
        base = _fresh_peak(torch, db)
        t = time.perf_counter()
        full = db.sql(q1_a)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t
        check_q1(full, ref_a)
        peak_full = torch.cuda.max_memory_allocated() - base
        est = full.stats["mem"]["est_bytes"]
        admitted = full.stats["mem"]["admitted_bytes"]
        limit_mb = _spill_ceiling_mb(full, 4)
        base = _fresh_peak(torch, db)
        per_run.clear()
        before = fused_agg.LAUNCHES
        t = time.perf_counter()
        spilled = _at_limit(db, limit_mb, q1_a)
        torch.cuda.synchronize()
        spill_s = time.perf_counter() - t
        peak_spill = torch.cuda.max_memory_allocated() - base
        launches_q1 = fused_agg.LAUNCHES - before
        check_q1(spilled, ref_a)
        passes = spilled.stats.get("spill_passes", 0)
        pass_runs = [(n, g) for kind, n, g in per_run if kind == "pass"]
        pass_launches = [n for n, _ in pass_runs]
        merge_launches = sum(n for kind, n, _ in per_run if kind == "merge")
        # each pass launches the kernel as its gate decided: below ~SF 2
        # a pass's lineitem chunk has fewer rows per segment than
        # fused_dense_min_rows and the gate declines (as the JAX
        # package's does); at SF10 every pass takes it
        if passes < 4 or len(pass_runs) != passes \
                or any(n != int(g) for n, g in pass_runs) \
                or (require_fused and not all(g for _, g in pass_runs)) \
                or launches_q1 != sum(pass_launches) + merge_launches:
            raise AssertionError(
                f"spilled Q1: {passes} passes, (launches, gate) per run "
                f"{per_run}, {launches_q1} in all: expected at least 4 "
                "passes, each launching as its gate decided, plus the "
                "merge's")
        if not peak_spill < peak_full:
            raise AssertionError(f"spilled Q1 peaked at {peak_spill} bytes, "
                                 f"not below the unspilled {peak_full}")
        out["q1"] = {"est_bytes": est, "est_bytes_x_nseg": est * nseg,
                     "admitted_by": full.stats["mem"]["admitted_by"],
                     "admitted_bytes": admitted,
                     "limit_mb": limit_mb, "passes": passes,
                     "pass_launches": pass_launches,
                     "merge_launches": merge_launches,
                     "peak_unspilled": peak_full, "peak_spilled": peak_spill,
                     "unspilled_s": full_s, "spilled_s": spill_s,
                     "spilled_stats": {k: v for k, v in spilled.stats.items()
                                       if k != "metrics"}}

        # ---- Q3's joins over lineitem: join + partial aggregate ---------
        # the passes are sized by their estimates (as in the JAX
        # package): the orders side (its scans, Redistributes and the
        # join's build table) stays whole in every pass, ~58% of the
        # estimate, so only a ceiling above ~0.83 of it lets lineitem
        # chunks alone fit, and no ceiling below its measured bytes
        # (~0.5 of the estimate) has passes that fit. Its first run is
        # admitted by the estimate (no program of it has launched yet):
        # the statement is forgotten (its cap hints and cached programs)
        # before that run and again before the spilled one, so both are
        # first runs. A forgotten statement of a measured shape is
        # admitted by the feedback store's measurement, so the spilled
        # run turns measured admission off: both are admitted alike, by
        # the estimate
        from greengage_tpu_torch.sql.parser import parse as _parse

        q3_ref = q3_by_priority_reference(data)
        q3_key = db._cached_plan(_parse(SQL_Q3_BY_PRIORITY)[0])[3]
        ex.forget(q3_key)
        full3 = db.sql(SQL_Q3_BY_PRIORITY)
        if _raw_rows(full3) != q3_ref:
            raise AssertionError(f"Q3 by priority {_raw_rows(full3)} "
                                 f"differs from numpy {q3_ref}")
        est3 = full3.stats["mem"]["est_bytes"]
        adm3 = full3.stats["mem"]["admitted_bytes"]
        if full3.stats["mem"]["admitted_by"] != "estimate":
            raise AssertionError(f"a first Q3 by priority was admitted by "
                                 f"{full3.stats['mem']}")
        ex.forget(q3_key)
        db.sql("set mem_accounting_enabled = off")
        try:
            t = time.perf_counter()
            sp3 = _at_limit(db, max((adm3 * 9 // 10) >> 20, 1),
                            SQL_Q3_BY_PRIORITY)
            torch.cuda.synchronize()
        finally:
            db.sql("set mem_accounting_enabled = on")
        if sp3.stats.get("spill_passes", 0) < 2 \
                or _raw_rows(sp3) != q3_ref:
            raise AssertionError(f"spilled Q3 by priority: {sp3.stats}")
        out["q3_by_priority"] = {"est_bytes": est3, "admitted_bytes": adm3,
                             "admitted_by":
                                 full3.stats["mem"]["admitted_by"],
                             "rows": len(sp3),
                             "passes": sp3.stats["spill_passes"],
                             "spilled_s": time.perf_counter() - t}

        # ---- a PARTITION BY window and an ORDER BY ----------------------
        for key, text, kind in (("window", SQL_WIN_SPILL, "window"),
                                ("sort", SQL_SORT_SPILL, "sort")):
            plain = _admitted(db, text)
            est_k = plain.stats["mem"]["est_bytes"]
            adm_k = plain.stats["mem"]["admitted_bytes"]
            t = time.perf_counter()
            res = _at_limit(db, _spill_ceiling_mb(plain, 4), text)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
            if res.stats.get("spill_kind") != kind \
                    or res.stats.get("spill_passes", 0) < 2:
                raise AssertionError(f"{key} spill: {res.stats}")
            raw = [res.raw[c] for c in res._order]
            if key == "window":
                want = win_spill_reference(data)
                got = sorted(zip(raw[0].tolist(), raw[1].tolist()))
                ok = got == want
            else:
                want = sort_spill_reference(data)
                ok = all(np.array_equal(g, w) for g, w in zip(raw, want))
            if not ok:
                raise AssertionError(f"{key} spill differs from numpy")
            out[key] = {"est_bytes": est_k, "admitted_bytes": adm_k,
                        "admitted_by": plain.stats["mem"]["admitted_by"],
                        "rows": len(res),
                        "passes": res.stats["spill_passes"], "spilled_s": sec}

        # ---- the sort spill again, the cost-feedback loop off and on in
        # turn: its spread within one run, and what a spilled run teaches
        # the loop (its exact row count alone: no per-node counts, so no
        # promotion from one pass's count)
        n_sort = int((data["lineitem"]["l_quantity"] < 300).sum())
        turns: dict = {"off": [], "on": []}
        promotions: dict = {"off": [], "on": []}
        ceiling = _spill_ceiling_mb(plain, 4)
        try:
            for mode in ("off", "on", "on", "off", "off", "on"):
                db.sql(f"set cost_feedback = {mode}")
                gen = db.feedback.gen
                t = time.perf_counter()
                res = _at_limit(db, ceiling, SQL_SORT_SPILL)
                torch.cuda.synchronize()
                turns[mode].append(time.perf_counter() - t)
                promotions[mode].append(db.feedback.gen - gen)
                if "node_rows" in res.stats or len(res) != n_sort \
                        or res.stats.get("spill_passes", 0) < 2 \
                        or promotions[mode][-1]:
                    raise AssertionError(
                        f"sort spill turn ({mode}): {len(res)} rows (numpy "
                        f"{n_sort}), {promotions[mode][-1]} promotions, "
                        f"node rows {res.stats.get('node_rows')}")
        finally:
            db.sql("set cost_feedback = on")
        out["sort"]["turns_s"] = turns
        out["sort"]["turn_promotions"] = promotions

        # ---- a real out-of-memory error, demoted ------------------------
        db.sql(q1_a)                              # warm: lineitem staged
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        check_q1(db.sql(q1_a), ref_a)
        need = torch.cuda.max_memory_allocated() - base
        # the allocator's cached blocks count as free for the statement:
        # return them first, so the ballast leaves exactly ``room``
        torch.cuda.empty_cache()
        free, _total = torch.cuda.mem_get_info()
        room = need // 2
        ballast = torch.empty(max(free - room, 0) // (2 << 20) * (2 << 20),
                              dtype=torch.uint8, device="cuda")
        try:
            res = _at_limit(db, 0, q1_a)
        finally:
            ballast_bytes = ballast.numel()
            del ballast
            torch.cuda.empty_cache()
        if res.stats.get("oom_demoted") is not True:
            raise AssertionError(f"Q1 with {room} bytes of room was not "
                                 f"demoted: {res.stats}")
        check_q1(res, ref_a)
        out["oom"] = {"statement_needs": need, "room_left": room,
                      "ballast_bytes": ballast_bytes,
                      "passes": res.stats["spill_passes"]}
    finally:
        ex.run_single = real_single
    launches = fused_agg.LAUNCHES

    # ---- the plan cache: a warm Q1 with another cutoff ------------------
    q1_b = SQL_Q1_AT.format(cut_b)
    hit = db.sql(q1_b)
    check_q1(hit, q1_reference(li, _days(cut_b)))
    if not hit.stats["plan_cache"]["hit"] \
            or hit.stats["plan_cache"]["params"] < 1:
        raise AssertionError(f"Q1 with another literal missed the plan "
                             f"cache: {hit.stats['plan_cache']}")
    warm = []
    for i in range(reps + 1):
        t = time.perf_counter()
        db.sql(q1_b)
        torch.cuda.synchronize()
        if i:
            warm.append(time.perf_counter() - t)
    out["plan_cache"] = {
        "miss_parse_ms": full.stats["parse_ms"],
        "miss_plan_ms": full.stats["plan_ms"],
        "hit_parse_ms": hit.stats["parse_ms"],
        "hit_plan_ms": hit.stats["plan_ms"], "hit": hit.stats["plan_cache"],
        "warm_q1_s": warm, "warm_q1_median_s": statistics.median(warm)}

    # host syncs of one spilled Q1 (each pass reads its flags and its
    # partial states back by design)
    syncs = sync_census(torch, lambda: _at_limit(db, limit_mb, q1_a))
    out["spilled_q1_syncs"] = sum(syncs.values())
    out["spilled_q1_sync_sites"] = syncs

    # the fused kernel at one spilled pass's job table
    tables = []
    fused = fused_agg._segment_reduce_fused

    def keep(table):
        if not tables:
            tables.append(table)
        return fused(table)

    fused_agg._segment_reduce_fused = keep
    try:
        check_q1(_at_limit(db, limit_mb, q1_a), ref_a)
    finally:
        fused_agg._segment_reduce_fused = fused
    # (none below ~SF 2, where the passes' gate declines)
    form = {"ms": None, "plain_ms": None, "bound_ms": None,
            "library_ms": None, "max_abs_err": None, "n": None}
    if tables:
        form = _timed_form(torch, tables[0], "spilled Q1 pass (lineitem "
                           "chunk, Q1's job table)", 20)
    del tables
    out.update(fused_dense_agg_launches=launches, pass_kernel_ms=form["ms"],
               pass_kernel_bound_ms=form["bound_ms"],
               pass_table_rows=form["n"],
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               ok=True)
    emit(out)
    return launches, form


# ---------------------------------------------------------------------------
# batched serving, cancellation, statement timeouts, the resource queue
# ---------------------------------------------------------------------------

# TPC-H Q6 as a served template: the specification's substitution
# parameters (DATE = January 1 of a year in 1993-1997, DISCOUNT in
# 0.02-0.09, QUANTITY in 24-25). The upper date is a plain date: an
# interval stays pinned in the plan key, and no two statements would share
# a plan
SQL_Q6_AT = """
      select sum(l_extendedprice * l_discount) as revenue
      from lineitem
      where l_shipdate >= date '{y}-01-01'
        and l_shipdate < date '{y1}-01-01'
        and l_discount between {dlo:.2f} and {dhi:.2f}
        and l_quantity < {q}"""
SERVE_CLIENTS = 16
SERVE_STATEMENTS = 64


def q6_params(rng, n: int) -> list[tuple]:
    """n Q6 substitutions drawn from ``rng``: (year, discount in
    hundredths, quantity)."""
    return [(int(rng.integers(1993, 1998)), int(rng.integers(2, 10)),
             int(rng.integers(24, 26))) for _ in range(n)]


def q6_text(p: tuple) -> str:
    y, d, q = p
    return SQL_Q6_AT.format(y=y, y1=y + 1, dlo=(d - 1) / 100,
                            dhi=(d + 1) / 100, q=q)


def q6_references(li: dict, params: list) -> list[int]:
    """Q6 at each substitution in numpy: the exact int64 sum of
    extendedprice x discount (scale 4) over the filter. The shipdate
    range selects each year's rows once; every substitution of that year
    filters those."""
    sd, disc, qty = li["l_shipdate"], li["l_discount"], li["l_quantity"]
    years = {}
    for y in sorted({p[0] for p in params}):
        idx = np.nonzero((sd >= _days(f"{y}-01-01"))
                         & (sd < _days(f"{y + 1}-01-01")))[0]
        d = disc[idx].astype(np.int64)
        years[y] = (d, qty[idx],
                    li["l_extendedprice"][idx].astype(np.int64) * d)
    out = []
    for y, d0, q in params:
        d, qy, prod = years[y]
        m = (d >= d0 - 1) & (d <= d0 + 1) & (qy < q * 100)
        out.append(int(np.sum(prod[m])))
    return out


def _check_q6(res, want: int, what: str) -> None:
    got = res.raw[res._order[0]]
    if len(got) != 1 or int(got[0]) != want:
        raise AssertionError(f"{what}: Q6 {got.tolist()} != {want}")


def _serve_run(torch, db, texts: list, refs: list, clients: int,
               run_one=None) -> dict:
    """Every statement of ``texts`` from ``clients`` threads (statement i
    on thread i % clients), each exact against refs[i]: through
    ``db.sql``, or ``run_one(k, i)`` (client k runs and checks statement
    i). -> throughput, latencies, the batch counters' deltas and the
    width histogram."""
    import threading

    from greengage_tpu_torch.runtime.logger import counters, histograms

    lat = [None] * len(texts)
    errors = []
    c0 = counters.snapshot()
    h0 = histograms.snapshot().get("batch_width", {"counts": None})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    def in_process(k, i):
        _check_q6(db.sql(texts[i]), refs[i], f"served statement {i}")

    run_one = run_one or in_process

    def client(k):
        try:
            for i in range(k, len(texts), clients):
                t = time.perf_counter()
                run_one(k, i)
                lat[i] = time.perf_counter() - t
        except BaseException as e:   # re-raised on the main thread
            errors.append(e)

    ts = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    d = counters.since(c0, "batch_")
    h1 = histograms.snapshot().get("batch_width")
    widths = {}
    if h1 is not None:
        prev = h0["counts"] or [0] * len(h1["counts"])
        widths = {int(b): c - p for b, c, p in
                  zip(h1["buckets"], h1["counts"], prev) if c - p}
    ms = sorted(x * 1e3 for x in lat)
    return {"statements": len(texts), "clients": clients, "wall_s": wall,
            "statements_per_s": len(texts) / wall,
            "p50_ms": ms[len(ms) // 2],
            "p99_ms": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
            "dispatches": d.get("batch_dispatch_total", 0),
            "members": d.get("batch_members_total", 0),
            "width_histogram": widths,
            "batch_fallback_total": d.get("batch_fallback_total", 0),
            "flush_full": d.get("batch_window_flush_full", 0),
            "flush_timer": d.get("batch_window_flush_timer", 0),
            "peak_bytes_over_base": torch.cuda.max_memory_allocated() - base}


def phase_serve(torch, data, db, nseg: int, seed: int, name: str) -> int:
    """Concurrent statements on the spill phase's Database: TPC-H Q6 as a
    served template (64 statements from 16 client threads, batching off
    and then on, every answer exact against numpy, no batch falling
    back), a cancelled batch member whose batch-mates stay exact, Q3
    past its statement timeout in staging, and four Q6s through a
    resource queue of one slot. -> the fused kernel's launches in the
    phase (batched programs never take it; Q6 and Q3 do not group by a
    dense key)."""
    import threading

    from greengage_tpu_torch.exec.executor import effective_limit_bytes
    from greengage_tpu_torch.ops import fused_agg
    from greengage_tpu_torch.runtime.faultinject import faults
    from greengage_tpu_torch.runtime.interrupt import (REGISTRY,
                                                       StatementCancelled)
    from greengage_tpu_torch.sql.parser import parse

    li = data["lineitem"]
    rng = np.random.default_rng(seed)
    params = q6_params(rng, SERVE_STATEMENTS)
    texts = [q6_text(p) for p in params]
    t = time.perf_counter()
    refs = q6_references(li, params)
    out = {"phase": "serve", "nseg": nseg, "device": name,
           "reference_s": time.perf_counter() - t,
           "distinct_parameters": len(set(params))}
    fused_agg.LAUNCHES = 0

    # ---- batch width from the estimates: est_bytes x width per segment
    # against the ceiling, widths a power of two, at most 16 -----------
    _check_q6(db.sql(texts[0]), refs[0], "warm-up")
    planned, consts, _outs, ek = db._cached_plan(parse(texts[0])[0])
    est1 = db.executor.compile(planned, db.executor._with_params(consts),
                               no_direct=False).est_bytes
    limit = effective_limit_bytes(db.settings, db.executor.layout)
    width = 16
    while width > 1 and est1 * width > limit:
        width //= 2
    pv = [db._cached_plan(parse(x)[0])[1]["@params@"]
          for x in texts[:width]]
    comp, _tables, _c, _ = db.executor.prepare_batch(planned, consts, ek,
                                                     pv)
    del _tables, _c
    out["admission"] = {
        "est_bytes_per_member_segment": est1,
        "est_bytes_x_bucket": comp.est_bytes, "bucket": comp.batch_width,
        "ceiling_bytes": limit, "batch_max_width": width,
        "est_bytes_x_bucket_x_nseg": comp.est_bytes * nseg}
    del comp
    db.sql(f"set batch_max_width = {width}")

    # ---- what the traces cost: the device-memory sampler and a warm Q6
    # with tracing on and off, in turns --------------------------------
    from greengage_tpu_torch.runtime import memaccount, trace

    def call_us(fn, n=2000):
        fn()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) / n * 1e6

    if memaccount.sample_watermark() != torch.cuda.memory_allocated():
        raise AssertionError("the trace's sampler reads another counter")
    on_off = {"on": [], "off": []}
    for i in range(22):
        mode = ("on", "off")[(i + i // 2) % 2]
        db.sql(f"set trace_enabled = {mode}")
        torch.cuda.synchronize()
        t = time.perf_counter()
        db.sql(texts[0])
        torch.cuda.synchronize()
        on_off[mode].append((time.perf_counter() - t) * 1e3)
    db.sql("set trace_enabled = on")
    db.sql(texts[0])
    spans = trace.TRACES.last().export()
    out["trace_cost"] = {
        "memory_allocated_us": call_us(torch.cuda.memory_allocated),
        "sampler_us": call_us(memaccount.sample_watermark),
        "q6_spans": len(spans),
        "q6_sampled_spans": sum("hbm_bytes" in sp["args"] for sp in spans),
        "q6_warm_ms_trace_on": statistics.median(on_off["on"]),
        "q6_warm_ms_trace_off": statistics.median(on_off["off"])}

    # ---- 64 statements, batching off, then on --------------------------
    torch.cuda.empty_cache()
    out["serial"] = _serve_run(torch, db, texts, refs, SERVE_CLIENTS)
    db.sql("set batch_serving_enabled = on")
    db.sql("set batch_window_ms = 2")
    _check_q6(db.sql(texts[1]), refs[1], "batched warm-up")
    torch.cuda.empty_cache()
    out["batched"] = _serve_run(torch, db, texts, refs, SERVE_CLIENTS)
    b = out["batched"]
    if b["batch_fallback_total"] != 0:
        raise AssertionError(f"batched Q6 fell back: {b}")
    if b["members"] != SERVE_STATEMENTS or b["members"] <= b["dispatches"]:
        raise AssertionError(f"no batching: {b}")
    # one batch's host syncs: its flag read and its outputs' copy
    syncs = sync_census(torch, lambda: db.executor.run_batch(
        planned, consts, ek, pv))
    out["batch_syncs"] = {"width": len(pv), "syncs": sum(syncs.values()),
                          "sites": syncs}
    db.sql("set batch_serving_enabled = off")
    syncs = sync_census(torch, lambda: db.sql(texts[1]))
    out["classic_statement_syncs"] = sum(syncs.values())
    db.sql("set batch_serving_enabled = on")
    out["batch_launches_fused"] = fused_agg.LAUNCHES
    if fused_agg.LAUNCHES:
        raise AssertionError("a batched program launched the fused kernel")

    # ---- a cancelled member: its batch-mates stay exact ----------------
    db.sql("set batch_window_ms = 300")
    faults.inject("batch_dispatch", "sleep", sleep_s=1.0, occurrences=1)
    got, errs = {}, {}

    def member(i):
        try:
            # the marker leads the text: the activity listing keeps a
            # statement's first 200 characters
            got[i] = db.sql(f"-- member {i}\n" + texts[i])
        except StatementCancelled as e:
            errs[i] = e.cause

    try:
        plug = threading.Thread(target=member, args=(2,))
        plug.start()
        time.sleep(0.3)                # the plug's batch holds the device
        ms = [threading.Thread(target=member, args=(i,)) for i in (3, 4, 5)]
        for th in ms:
            th.start()
        time.sleep(0.3)                # the members wait in one window
        victim = [r for r in REGISTRY.snapshot()
                  if r["sql"].startswith("-- member 4")]
        if not victim or not REGISTRY.cancel(victim[0]["id"], "user"):
            raise AssertionError("member 4 was not in flight")
        for th in ms + [plug]:
            th.join(timeout=60)
    finally:
        faults.reset("batch_dispatch")
    if errs != {4: "user"}:
        raise AssertionError(f"cancelled member: {errs}")
    for i in (2, 3, 5):
        _check_q6(got[i], refs[i], f"member {i} beside a cancelled one")
    out["cancel"] = {"cancelled": {str(k): v for k, v in errs.items()},
                     "mates_exact": [2, 3, 5],
                     "mates_batch_width": [got[i].stats.get("batch_width")
                                           for i in (3, 5)]}
    db.sql("set batch_serving_enabled = off")

    # ---- Q3 past its statement timeout, in staging ---------------------
    for table in ("customer", "orders", "lineitem"):
        db.executor.invalidate_table(table)
    db.sql("set scan_threads = 1")
    db.sql("set statement_timeout_s = 1.0")
    faults.inject("cancel_in_staging", "sleep", sleep_s=0.3,
                  occurrences=-1)
    t = time.perf_counter()
    cause = None
    try:
        db.sql(SQL_Q3)
    except StatementCancelled as e:
        cause = e.cause
    finally:
        faults.reset("cancel_in_staging")
        db.sql("set statement_timeout_s = 0")
        db.sql("set scan_threads = 0")
    took = time.perf_counter() - t
    if cause != "timeout":
        raise AssertionError(f"Q3 past its timeout ended with {cause!r}")
    check_q3(db.sql(SQL_Q3), q3_reference(data))
    out["timeout"] = {"cause": cause, "raised_after_s": took,
                      "next_statement": "exact"}

    # ---- the resource queue: four Q6s through one slot -----------------
    db.sql("set resource_queue_active = 1")
    q0 = db.resqueue.stats()
    seen = {"active": 0, "waiting": 0}
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            st = db.resqueue.stats()
            seen["active"] = max(seen["active"], st["active"])
            seen["waiting"] = max(seen["waiting"], st["waiting"])
            time.sleep(0.0005)

    w = threading.Thread(target=watch)
    w.start()
    try:
        res4 = _serve_run(torch, db, texts[:4], refs[:4], 4)
    finally:
        stop.set()
        w.join()
        db.sql("set resource_queue_active = 0")
    q1_ = db.resqueue.stats()
    admitted = q1_["admitted"] - q0["admitted"]
    if admitted != 4 or seen["active"] != 1 or q1_["active"]:
        raise AssertionError(f"resource queue: {q0} -> {q1_}, {seen}")
    out["resource_queue"] = {"admitted": admitted,
                             "max_active": seen["active"],
                             "max_waiting": seen["waiting"],
                             "wall_s": res4["wall_s"]}
    launches = fused_agg.LAUNCHES
    out.update(fused_dense_agg_launches=launches,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               ok=True)
    emit(out)
    return launches, out


# ---------------------------------------------------------------------------
# SQL over the wire: the server, overload protection and measured memory
# ---------------------------------------------------------------------------

def _q1_frame_rows(ref: dict) -> list:
    """Q1's rows as the server's frame carries them, from the numpy
    reference: DECIMAL sums descaled to float64 as the engine presents
    them (scale 2 for the quantity and price, 4 and 6 for the products),
    avg as its float64, counts as ints."""
    scales = {"sum_qty": 2, "sum_base_price": 2, "sum_disc_price": 4,
              "sum_charge": 6}
    rows = []
    for key in sorted(ref):
        w = ref[key]
        row = list(key)
        for name in ("sum_qty", "sum_base_price", "sum_disc_price",
                     "sum_charge", "avg_qty", "avg_price", "avg_disc",
                     "count_order"):
            v = w[name]
            if name in scales:
                v = float(np.float64(v) / (10.0 ** scales[name]))
            elif isinstance(v, int):
                v = int(v)
            else:
                v = float(v)
            row.append(v)
        rows.append(row)
    return rows


def _check_frame(frame: dict, want_rows: list, what: str) -> None:
    if not frame.get("ok") or frame.get("rows") != want_rows:
        raise AssertionError(f"{what} over the wire: {frame} != {want_rows}")


def _check_q3_frame(frame: dict, ref: list) -> None:
    """Q3 over the wire against the numpy reference: (revenue, orderdate)
    in order exactly, the orderkeys distinct groups of the reference."""
    if not frame.get("ok") or frame["columns"] != [
            "l_orderkey", "revenue", "o_orderdate", "o_shippriority"]:
        raise AssertionError(f"Q3 over the wire: {frame}")
    epoch = np.datetime64("1970-01-01", "D")
    want = [(float(np.float64(r) / 1e4), str(epoch + np.timedelta64(d, "D")))
            for r, d, _ in ref[:10]]
    got = [(r[1], r[2]) for r in frame["rows"]]
    if got != want:
        raise AssertionError(f"Q3 over the wire {got} != {want}")
    keys = {k for _, _, k in ref}
    if len({r[0] for r in frame["rows"]}) != 10 \
            or not all(r[0] in keys and r[3] == 0 for r in frame["rows"]):
        raise AssertionError(f"Q3 over the wire: rows {frame['rows']}")


def _wait_for(pred, timeout_s: float = 10.0, what: str = "") -> None:
    end = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def phase_wire(torch, data, db, nseg: int, reps: int, seed: int, name: str,
               smi_line: str, serve: dict) -> tuple[int, dict]:
    """SQL over the server's socket on the serve phase's Database (SF10, 8
    segments): SQL Q1, Q6 and Q3 over the wire, each exact against numpy,
    Q1 launching the fused kernel once; warm medians over the wire and in
    process, in turn; 64 Q6s from 16 connections with batching on, beside
    the serve phase's in-process numbers; ps and cancel of a statement
    held at a fault point; a client gone mid-statement; the mem and
    metrics ops; measured admission of a warm Q1; a brownout caused by
    the card's allocator (a ballast tensor) that disables batching and
    clears; a connection cap; TCP with authentication; stop() with a
    statement in flight. -> (the fused kernel's launches by the wire's
    Q1, the _timed_form row of the job table it handed the kernel)."""
    import socket
    import tempfile
    import threading

    from greengage_tpu_torch.ops import fused_agg
    from greengage_tpu_torch.runtime import auth, memaccount, overload
    from greengage_tpu_torch.runtime.faultinject import faults
    from greengage_tpu_torch.runtime.interrupt import REGISTRY
    from greengage_tpu_torch.runtime.logger import counters
    from greengage_tpu_torch.runtime.server import (SqlClient, SqlServer,
                                                    _encode_value)

    li = data["lineitem"]
    t_ref = time.perf_counter()
    q1_rows = _q1_frame_rows(q1_reference(li, _days("1998-09-02")))
    q6_rows = [[float(np.float64(q6_reference(li)) / 1e4)]]
    q3_ref = q3_reference(data)
    rng = np.random.default_rng(seed + 1)
    params = q6_params(rng, SERVE_STATEMENTS)
    texts = [q6_text(p) for p in params]
    refs = q6_references(li, params)
    out = {"phase": "wire", "nseg": nseg, "device": name, "card": smi_line,
           "reference_s": time.perf_counter() - t_ref}
    tmp = tempfile.mkdtemp(prefix="gg-wire-")
    sock = f"{tmp}/gg.sock"
    srv = SqlServer(db, sock, host="127.0.0.1", port=0)
    srv.start()
    clients = []

    def client(**kw):
        c = SqlClient(sock, **kw) if not kw else SqlClient(**kw)
        clients.append(c)
        return c

    try:
        c = client()
        # ---- the main path: Q1 over the wire, one launch ---------------
        tables = []
        fused = fused_agg._segment_reduce_fused

        def keep(table):
            tables.append(table)
            return fused(table)

        fused_agg._segment_reduce_fused = keep
        fused_agg.LAUNCHES = 0
        try:
            f1 = c.sql(SQL_Q1)
        finally:
            fused_agg._segment_reduce_fused = fused
        launches = fused_agg.LAUNCHES
        if launches != 1:
            raise AssertionError(f"SQL Q1 over the wire launched the fused "
                                 f"kernel {launches} times")
        _check_frame(f1, q1_rows, "SQL Q1")
        form = _timed_form(torch, tables[0], "SQL Q1 over the wire (Q1's "
                           "job table)", 20)
        del tables
        _check_frame(c.sql(SQL_Q6), q6_rows, "SQL Q6")
        _check_q3_frame(c.sql(SQL_Q3), q3_ref)
        # the in-process Result encodes to the same frame
        res1 = db.sql(SQL_Q1)
        if [[_encode_value(v) for v in r] for r in res1.rows()] != q1_rows:
            raise AssertionError("in-process Q1 encodes to another frame")

        # ---- warm medians: in process and over the wire, in turn -------
        warm = {f"{w}_{q}": [] for q in ("q1", "q6", "q3")
                for w in ("sql", "wire")}
        for i in range(reps + 1):
            for q, text in (("q1", SQL_Q1), ("q6", SQL_Q6), ("q3", SQL_Q3)):
                t = time.perf_counter()
                db.sql(text)
                torch.cuda.synchronize()
                s1 = time.perf_counter() - t
                t = time.perf_counter()
                c.sql(text)
                s2 = time.perf_counter() - t
                if i:
                    warm[f"sql_{q}"].append(s1)
                    warm[f"wire_{q}"].append(s2)
        out["warm_median_s"] = {k: statistics.median(v)
                                for k, v in warm.items()}
        out["warm_s"] = warm

        # ---- 64 Q6s from 16 connections, batching on -------------------
        db.sql("set batch_serving_enabled = on")
        db.sql("set batch_window_ms = 2")
        conns = [client() for _ in range(SERVE_CLIENTS)]

        def over_the_wire(k, i):
            _check_frame(conns[k].sql(texts[i]),
                         [[float(np.float64(refs[i]) / 1e4)]],
                         f"served Q6 {i}")

        try:
            served = _serve_run(torch, db, texts, refs, SERVE_CLIENTS,
                                over_the_wire)
        finally:
            db.sql("set batch_serving_enabled = off")
        b = serve["batched"]
        served["in_process"] = {k: b[k] for k in ("statements_per_s",
                                                  "p50_ms", "p99_ms")}
        out["served"] = served
        if served["batch_fallback_total"] \
                or served["members"] <= served["dispatches"]:
            raise AssertionError(f"served Q6 over the wire: {served}")
        for cc in conns:
            cc.close()
            clients.remove(cc)

        # ---- ps shows a held statement; cancel ends it, cause user -----
        faults.inject("cancel_before_dispatch", "sleep", sleep_s=3.0,
                      occurrences=1)
        victim = {}

        def held():
            vc = SqlClient(sock)
            victim["frame"] = vc.op({"sql": "-- wire-victim\n" + SQL_Q6})
            vc.close()

        th = threading.Thread(target=held)
        try:
            th.start()
            sid = []

            def seen():
                sid[:] = [r["id"] for r in c.op({"op": "ps"})["rows"]
                          if r["sql"].startswith("-- wire-victim")]
                return bool(sid)

            _wait_for(seen, what="ps to show the held statement")
            if c.op({"op": "cancel", "id": sid[0]}) != {"ok": True}:
                raise AssertionError("cancel frame refused")
            th.join(timeout=30)
        finally:
            faults.reset("cancel_before_dispatch")
        if victim["frame"].get("cancelled") != "user":
            raise AssertionError(f"cancelled statement: {victim['frame']}")
        out["cancel"] = {"cause": "user", "statement_id": sid[0]}

        # ---- a client gone mid-statement --------------------------------
        gone0 = counters.get("statements_cancelled_client_gone")
        faults.inject("cancel_before_dispatch", "sleep", sleep_s=1.0,
                      occurrences=1)
        try:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(sock)
            s.sendall((json.dumps({"sql": "-- wire-gone\n" + SQL_Q6})
                       + "\n").encode())
            _wait_for(lambda: any(r["sql"].startswith("-- wire-gone")
                                  for r in c.op({"op": "ps"})["rows"]),
                      what="the gone client's statement")
            s.close()
            _wait_for(lambda: counters.get(
                "statements_cancelled_client_gone") == gone0 + 1,
                what="client_gone")
        finally:
            faults.reset("cancel_before_dispatch")
        _check_frame(c.sql(SQL_Q6), q6_rows, "Q6 after a client left")
        out["client_gone"] = counters.get(
            "statements_cancelled_client_gone") - gone0

        # ---- the mem and metrics ops ------------------------------------
        mem = c.op({"op": "mem"})["mem"]
        if not mem["device"] or mem["device"]["bytes_in_use"] <= 0:
            raise AssertionError(f"mem op device stats: {mem['device']}")
        measured = [e for e in mem["executables"] if e["measured"]]
        if not measured:
            raise AssertionError("mem op: no measured program")
        text = c.op({"op": "metrics"})["text"]
        for fam in ("ggtpu_device_bytes_in_use", "ggtpu_host_rss_bytes",
                    "ggtpu_server_connections_total"):
            if f"\n{fam} " not in "\n" + text:
                raise AssertionError(f"metrics op lacks {fam}")
        out["mem_op"] = {"device": mem["device"],
                         "executables": len(mem["executables"]),
                         "measured_executables": len(measured)}

        # ---- measured admission of a warm Q1 ----------------------------
        runs0 = counters.get("mem_analysis_runs")
        adm = [db.sql(SQL_Q1).stats["mem"] for _ in range(3)]
        if any(m["admitted_by"] != "measured" for m in adm) \
                or counters.get("mem_analysis_runs") != runs0:
            raise AssertionError(f"warm Q1 admission: {adm}, analysis runs "
                                 f"{runs0} -> "
                                 f"{counters.get('mem_analysis_runs')}")
        m = adm[-1]
        out["q1_admission"] = {
            "admitted_by": m["admitted_by"],
            "admitted_bytes": m["admitted_bytes"],
            "est_bytes": m["est_bytes"],
            "measured_x_nseg": m["measured"],
            "measured_total": sum(m["measured"].values()),
            "est_bytes_x_nseg": m["est_bytes"] * nseg}

        # ---- a brownout from the card's allocator ------------------------
        s0 = db.settings
        enter, exit_ = float(s0.brownout_enter_pct), float(s0.brownout_exit_pct)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        st = memaccount.device_memory_stats()
        total, used = st["bytes_limit"], st["bytes_in_use"]
        free, _ = torch.cuda.mem_get_info()
        need = int(enter * total) - used + (256 << 20)
        if need > free - (4 << 30):
            # the card's free memory cannot reach the default bar with room
            # for Q6 left: a lower bar, stated in the line
            enter = (used + free - (6 << 30)) / total
            exit_ = enter - 0.1
            db.sql(f"set brownout_enter_pct = {enter}")
            db.sql(f"set brownout_exit_pct = {exit_}")
            need = int(enter * total) - used + (256 << 20)
        e0 = counters.get("brownout_entered_total")
        ballast = torch.empty(need, dtype=torch.uint8, device="cuda")
        try:
            st1 = c.op({"op": "status"})
            ov = st1["overload"]
            if not ov["brownout"] or "device memory" not in (ov["reason"]
                                                              or ""):
                raise AssertionError(f"no brownout past the bar: {ov}")
            db.sql("set batch_serving_enabled = on")
            m0 = counters.get("batch_members_total")
            r6 = db.sql(texts[0])
            _check_q6(r6, refs[0], "Q6 in a brownout")
            if r6.stats.get("batched") or \
                    counters.get("batch_members_total") != m0:
                raise AssertionError("a Q6 in a brownout was batched")
            db.sql("set batch_serving_enabled = off")
        finally:
            del ballast
            torch.cuda.empty_cache()
        db.sql("set brownout_exit_s = 0")
        st2 = c.op({"op": "status"})
        if st2["overload"]["brownout"]:
            raise AssertionError(f"brownout did not clear: {st2['overload']}")
        db.sql("set brownout_exit_s = 5")
        db.sql("set brownout_enter_pct = 0.92")
        db.sql("set brownout_exit_pct = 0.80")
        out["brownout"] = {
            "enter_pct": enter, "exit_pct": exit_, "bytes_limit": total,
            "ballast_bytes": need, "reason": ov["reason"],
            "entered": counters.get("brownout_entered_total") - e0,
            "q6_serial": True, "cleared": True}

        # ---- max_connections = 2: a third connect is shed ---------------
        for cc in list(clients):
            cc.close()
            clients.remove(cc)
        _wait_for(lambda: counters.get("server_active_connections") == 0,
                  what="the connections to close")
        db.sql("set max_connections = 2")
        shed0 = counters.get("connections_shed_total")
        try:
            a, b2 = client(), client()
            a.sql("select 1")
            b2.sql("select 1")
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(sock)
            f = s.makefile("rb")
            frame = json.loads(f.readline())
            rest = f.readline()
            f.close()
            s.close()
        finally:
            db.sql("set max_connections = 100")
        if frame.get("code") != "too_many_connections" or rest != b"" \
                or counters.get("connections_shed_total") != shed0 + 1:
            raise AssertionError(f"third connection: {frame}, {rest!r}")
        out["connection_cap"] = {"max_connections": 2,
                                 "third": frame["code"]}
        for cc in (a, b2):
            cc.close()
            clients.remove(cc)

        # ---- TCP with a user from auth.add_user -------------------------
        auth.add_user(db.path, "wire_user", "wire-password")
        tc = client(host="127.0.0.1", port=srv.port, user="wire_user",
                    password="wire-password")
        _check_frame(tc.sql(SQL_Q6), q6_rows, "Q6 over TCP")
        refused = False
        try:
            SqlClient(host="127.0.0.1", port=srv.port, user="wire_user",
                      password="not-it")
        except PermissionError:
            refused = True
        if not refused:
            raise AssertionError("a wrong password was accepted")
        out["tcp"] = {"port": srv.port, "q6": "exact",
                      "wrong_password": "refused"}

        # ---- stop() with a statement in flight --------------------------
        faults.inject("cancel_before_dispatch", "sleep", sleep_s=1.0,
                      occurrences=1)
        last = {}

        def in_flight():
            last["frame"] = tc.op({"sql": "-- wire-drain\n" + SQL_Q6})

        th = threading.Thread(target=in_flight)
        try:
            th.start()
            _wait_for(lambda: any(r["sql"].startswith("-- wire-drain")
                                  for r in REGISTRY.snapshot()),
                      what="the drain victim")
            t = time.perf_counter()
            srv.stop()
            drain_s = time.perf_counter() - t
            th.join(timeout=30)
        finally:
            faults.reset("cancel_before_dispatch")
        if last.get("frame", {}).get("cancelled") != "shutdown":
            raise AssertionError(f"statement at stop(): {last}")
        left = [x.name for x in threading.enumerate()
                if x.name.startswith(("gg-server", "gg-client-watch"))]
        if left:
            raise AssertionError(f"server threads left: {left}")
        out["drain"] = {"cancelled": "shutdown", "stop_s": drain_s,
                        "threads_left": 0}
    finally:
        srv.stop()
        for cc in clients:
            try:
                cc.close()
            except OSError:
                pass
        overload.CONTROLLER.reset()
    out.update(fused_dense_agg_launches=launches,
               q1_kernel_ms=form["ms"], q1_kernel_bound_ms=form["bound_ms"],
               ok=True)
    emit(out)
    return launches, form


# ---------------------------------------------------------------------------
# measure: the card's own cost calibration, EXPLAIN ANALYZE, the feedback
# loop at scale, a UDF and the FTS probe
# ---------------------------------------------------------------------------

FEEDBACK_ROWS = 60_000_000      # the un-analyzed (l_orderkey, l_quantity)
GEO_ROWS = 60_000_000           # float64 lat/lon points: 0.96 GB
GEO_POINT = (48.8566, 2.3522)   # Paris
GEO_KM = 500.0
GEO_EDGE_KM = 1e-6              # points this close to GEO_KM may go either way
SQL_FEEDBACK = "select count(*) from fb where l_quantity >= 0.00"
SQL_GEO_COUNT = (f"select count(*) from pts where haversine_km(lat, lon, "
                 f"{GEO_POINT[0]}, {GEO_POINT[1]}) < {GEO_KM}")
SQL_GEO_SUM = (f"select sum(haversine_km(lat, lon, {GEO_POINT[0]}, "
               f"{GEO_POINT[1]})) from pts")


def haversine_reference(lat, lon, lat2: float, lon2: float) -> np.ndarray:
    """numpy float64 great-circle distances (km), the geo extension's
    formula."""
    p1, p2 = np.radians(lat), np.radians(lat2)
    dphi = p2 - p1
    dlmb = np.radians(lon2 - lon)
    a = np.sin(dphi / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dlmb / 2) ** 2
    return 2 * 6371.0088 * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def _plan_node_rows(text: str) -> list:
    """(node name, actual rows) of each annotated EXPLAIN ANALYZE tree
    line, in tree order."""
    import re

    out = []
    for ln in text.split("\n"):
        if re.match(r"^ \S", ln):
            break
        m = re.search(r"actual rows=(\d+)", ln)
        out.append((ln.strip().split("  ")[0], int(m.group(1))
                    if m else None))
    return out


def _rows_of(nodes: list, prefix: str) -> list:
    return [n for name, n in nodes if name.startswith(prefix)]


def _coded(cols: dict) -> dict:
    """A generated table with its text columns given as lists turned into
    dictionary columns (a unique name per row would be raw TEXT, which is
    not ported; no statement here reads one)."""
    from greengage_tpu_torch.types import Coded

    out = dict(cols)
    for k, v in cols.items():
        if isinstance(v, list):
            vocab, codes = np.unique(np.asarray(v, dtype=object),
                                     return_inverse=True)
            out[k] = Coded(list(vocab), codes.astype(np.int32))
    return out


def _plans(db, texts: dict) -> dict:
    from greengage_tpu_torch.planner.logical import describe
    from greengage_tpu_torch.sql.parser import parse

    return {k: describe(db._plan(parse(q)[0])[0]) for k, q in texts.items()}


def phase_measure(torch, data, db, nseg: int, reps: int, name: str,
                  smi_line: str) -> tuple[int, dict]:
    """On the wire phase's Database (SF10, 8 segments): the card's cost
    primitives and memory bandwidth beside the TPU v5e defaults, the corpus
    plans that change under them, Q1/Q3/Q12 exact under them, the defaults
    restored; EXPLAIN ANALYZE of SQL Q1 (the main path: node rows against
    numpy, one kernel launch held against its plain version, measured
    admission when warm, its time beside the plain Q1's) and of Q3 (join
    rows against numpy); the feedback loop on a 60M-row un-analyzed table
    with the checkperf op; a warm Q6's host syncs; CREATE EXTENSION geo over
    60M points against numpy float64; the FTS probe. -> (the fused
    kernel's launches by EXPLAIN ANALYZE Q1, the _timed_form row of the job
    table it handed the kernel)."""
    import math
    import tempfile

    from greengage_tpu_torch.exec.executor import shape_of
    from greengage_tpu_torch.mgmt import cli
    from greengage_tpu_torch.ops import fused_agg
    from greengage_tpu_torch.planner import cost, feedback
    from greengage_tpu_torch.runtime.server import SqlClient, SqlServer
    from greengage_tpu_torch.sql.parser import parse
    from greengage_tpu_torch.utils.plancorpus import TPCH_QUERIES

    li = data["lineitem"]
    out = {"phase": "measure", "nseg": nseg, "device": name,
           "card": smi_line}

    # ---- the card's calibration beside the TPU v5e defaults -------------
    t = time.perf_counter()
    cal = cli._measure_device_primitives()
    hbm_mbps = cli.device_bandwidth(1024)
    defaults = cost.CALIBRATION_DEFAULTS
    out["calibration"] = {
        k: {"h100": v, "tpu_v5e_default": defaults[k],
            "h100_over_default": v / defaults[k]} for k, v in cal.items()}
    out["hbm_bandwidth"] = {"MBps": hbm_mbps,
                            "fraction_of_3.35TBps": hbm_mbps * 1e6
                            / HBM_BYTES_PER_S}
    out["calibration_s"] = time.perf_counter() - t
    if len(cal) != 6 or not all(v > 0 for v in cal.values()):
        raise AssertionError(f"card primitives: {cal}")

    # ---- the corpus re-planned under the card's calibration -------------
    for table in ("nation", "region", "part"):
        if not db.store.segment_rowcounts(table) \
                or not sum(db.store.segment_rowcounts(table)):
            db.load_table(table, _coded(data[table]))
            db.sql(f"analyze {table}")
    before = _plans(db, TPCH_QUERIES)
    db.set_calibration(cal)
    under = _plans(db, TPCH_QUERIES)
    changed = sorted(k for k in TPCH_QUERIES if under[k] != before[k])
    out["plans"] = {"statements": len(TPCH_QUERIES), "changed": changed,
                    "diffs": {k: {"default": before[k], "h100": under[k]}
                              for k in changed}}

    # ---- Q1, Q3, Q12 exact under it; warm times beside the defaults -----
    q1_ref = q1_reference(li, _days("1998-09-02"))
    q3_ref = q3_reference(data)
    q12_ref = q12_reference(data)
    checks = {"q1": (SQL_Q1, lambda r: check_q1(r, q1_ref)),
              "q3": (SQL_Q3, lambda r: check_q3(r, q3_ref)),
              "q12": (SQL_Q12, lambda r: check_q12(r, q12_ref))}

    def warm_times(tag):
        got = {}
        for key, (text, check) in checks.items():
            check(db.sql(text))
            times = []
            for _ in range(reps):
                t = time.perf_counter()
                res = db.sql(text)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            check(res)
            got[key] = statistics.median(times)
        return got

    db.set_calibration(None)
    warm = {"default_1": warm_times("default")}
    db.set_calibration(cal)
    warm["h100"] = warm_times("h100")
    db.set_calibration(None)
    warm["default_2"] = warm_times("default")
    out["warm_median_s"] = warm
    restored = _plans(db, {"q3": TPCH_QUERIES["q3_shipping_priority"]})
    if restored["q3"] != before["q3_shipping_priority"]:
        raise AssertionError("Q3 under the restored defaults differs from "
                             "its default plan")
    if cost.current_calibration() != defaults:
        raise AssertionError("the defaults were not restored")
    out["defaults_restored"] = True

    # ---- EXPLAIN ANALYZE of SQL Q1: the main path ------------------------
    tables = []
    fused = fused_agg._segment_reduce_fused

    def keep(table):
        tables.append(table)
        return fused(table)

    explain_q1 = "explain analyze " + SQL_Q1
    db.sql(SQL_Q1)
    fused_agg._segment_reduce_fused = keep
    fused_agg.LAUNCHES = 0
    try:
        t = time.perf_counter()
        ea = db.sql(explain_q1)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t
    finally:
        fused_agg._segment_reduce_fused = fused
    launches = fused_agg.LAUNCHES
    if launches != 1 or len(tables) != 1:
        raise AssertionError(f"EXPLAIN ANALYZE Q1 launched the fused kernel "
                             f"{launches} times")
    nodes = _plan_node_rows(ea.plan_text)
    cutoff = _days("1998-09-02")
    want = {"Scan lineitem": len(li["l_orderkey"]),
            "Filter": int((li["l_shipdate"] <= cutoff).sum()),
            "Aggregate final": len(q1_ref)}
    got = {k: _rows_of(nodes, k) for k in want}
    if any(g != [w] for g, w in zip(got.values(), want.values())) \
            or nodes[1][1] != len(q1_ref) \
            or "Fused dense-agg kernel: cuda" not in ea.plan_text:
        raise AssertionError(f"EXPLAIN ANALYZE Q1 rows {nodes} against "
                             f"numpy {want}:\n{ea.plan_text}")
    form = _timed_form(torch, tables[0], "EXPLAIN ANALYZE SQL Q1 (Q1's job "
                       "table, instrumented)", 20)
    del tables
    # warm: the instrumented program measured on its first launch, then
    # admitted by what it measured
    warm_ea = db.sql(explain_q1).plan_text
    mem_line = [ln for ln in warm_ea.split("\n")
                if ln.startswith(" Memory:")]
    if not mem_line or "executable measured: args" not in mem_line[0] \
            or "(admitted by measured bytes)" not in mem_line[0]:
        raise AssertionError(f"warm EXPLAIN ANALYZE Q1 memory: {mem_line}")
    pair = {"explain_analyze": [], "plain": []}
    for _ in range(reps):
        for key, text in (("explain_analyze", explain_q1),
                          ("plain", SQL_Q1)):
            t = time.perf_counter()
            db.sql(text)
            torch.cuda.synchronize()
            pair[key].append(time.perf_counter() - t)
    out["explain_q1"] = {
        "node_rows": nodes, "numpy": want, "groups": len(q1_ref),
        "cold_s": cold_s,
        "memory_line": mem_line[0].strip(),
        "warm_median_s": {k: statistics.median(v) for k, v in pair.items()},
        "warm_s": pair, "kernel_ms": form["ms"],
        "kernel_bound_ms": form["bound_ms"], "launches": launches}

    # ---- EXPLAIN ANALYZE of Q3: each join's rows against numpy ----------
    c, o = data["customer"], data["orders"]
    seg = c["c_mktsegment"]
    cust_ok = np.zeros(len(c["c_custkey"]) + 1, bool)
    cust_ok[c["c_custkey"]] = seg.codes == seg.vocab.index("BUILDING")
    cut = _days("1995-03-15")
    order_ok = np.zeros(len(o["o_orderkey"]) + 1, bool)
    order_ok[o["o_orderkey"]] = ((o["o_orderdate"] < cut)
                                 & cust_ok[o["o_custkey"]])
    line_ok = order_ok[li["l_orderkey"]] & (li["l_shipdate"] > cut)
    q3_joins = sorted([int(order_ok.sum()), int(line_ok.sum())])
    ea3 = db.sql("explain analyze " + SQL_Q3).plan_text
    nodes3 = _plan_node_rows(ea3)
    joins = sorted(_rows_of(nodes3, "Join inner"))
    if joins != q3_joins:
        raise AssertionError(f"EXPLAIN ANALYZE Q3 join rows {joins} != "
                             f"numpy {q3_joins}:\n{ea3}")
    out["explain_q3"] = {"join_rows": joins, "numpy": q3_joins,
                         "node_rows": nodes3}

    # ---- the feedback loop at scale --------------------------------------
    n_fb = min(FEEDBACK_ROWS, len(li["l_orderkey"]))
    db.sql("create table fb (l_orderkey bigint, l_quantity decimal(15,2)) "
           "distributed by (l_orderkey)")
    t = time.perf_counter()
    db.load_table("fb", {"l_orderkey": li["l_orderkey"][:n_fb],
                         "l_quantity": li["l_quantity"][:n_fb]})
    load_s = time.perf_counter() - t

    def filter_rows():
        line = [ln for ln in db.sql("explain " + SQL_FEEDBACK)
                .plan_text.split("\n") if "Filter" in ln][0]
        import re

        return int(re.search(r" rows=(\d+)", line).group(1))

    gen0 = db.feedback.gen
    est_cold = filter_rows()
    runs = []
    for i in range(5):
        t = time.perf_counter()
        r = db.sql(SQL_FEEDBACK)
        torch.cuda.synchronize()
        runs.append({"s": time.perf_counter() - t,
                     "plan_cache_hit": r.stats["plan_cache"]["hit"],
                     "gen": db.feedback.gen})
        if int(r.rows()[0][0]) != n_fb:
            raise AssertionError(f"feedback count {r.rows()} != {n_fb}")
        if i == 0:
            est_warm = filter_rows()
    # describe() prints the float estimate truncated: the corrected one
    # (est x actual/est) may print one below the count
    if not est_cold * 2.5 < n_fb < est_cold * 3.5 \
            or not 0 <= n_fb - est_warm <= 1 \
            or db.feedback.gen != gen0 + 1:
        raise AssertionError(f"feedback: estimate {est_cold} -> {est_warm} "
                             f"for {n_fb} rows, gen {gen0} -> "
                             f"{db.feedback.gen}")
    tmp = tempfile.mkdtemp(prefix="gg-measure-")
    srv = SqlServer(db, f"{tmp}/gg.sock")
    srv.start()
    try:
        cl = SqlClient(f"{tmp}/gg.sock")
        frame = cl.op({"op": "checkperf"})
        cl.close()
    finally:
        srv.stop()
    # the statement's shape and its Filter's digest, as the store keys them
    planned, _c, _o, ek = db._cached_plan(parse(SQL_FEEDBACK)[0])
    filt = planned
    while type(filt).__name__ != "Filter":
        filt = filt.children[0]
    shape = [s for s in frame["feedback"]["shapes"]
             if s["shape"] == feedback.shape_key(shape_of(ek))]
    scale = frame["feedback"]["scales"].get(feedback.node_digest(filt))
    if not frame["ok"] or not shape or shape[0]["runs"] < 5 \
            or scale is None or abs(scale - n_fb / est_cold) > 0.01:
        raise AssertionError(f"checkperf frame: {frame}")
    out["feedback"] = {"rows": n_fb, "load_s": load_s,
                       "estimate_cold": est_cold, "estimate_after_one_run":
                       est_warm, "gen_before": gen0,
                       "gen_after_five_runs": db.feedback.gen,
                       "runs": runs, "checkperf_shape": shape[0],
                       "checkperf_filter_scale": scale}
    db.sql("drop table fb")

    # ---- a warm Q6's host syncs: still 2 per classic statement ----------
    for _ in range(3):
        db.sql(SQL_Q6)
    syncs = sync_census(torch, lambda: db.sql(SQL_Q6))
    out["q6_syncs"] = {"syncs": sum(syncs.values()), "sites": syncs}
    if sum(syncs.values()) != 2:
        raise AssertionError(f"a warm Q6 synchronised {syncs}")

    # ---- UDFs: CREATE EXTENSION geo over 60M points ----------------------
    if db.sql("create extension geo") != "CREATE EXTENSION":
        raise AssertionError("create extension geo")
    rng = np.random.default_rng(20241017)
    lat = np.degrees(np.arcsin(rng.uniform(-1.0, 1.0, GEO_ROWS)))
    lon = rng.uniform(-180.0, 180.0, GEO_ROWS)
    db.sql("create table pts (lat double precision, lon double precision) "
           "distributed randomly")
    t = time.perf_counter()
    db.load_table("pts", {"lat": lat, "lon": lon})
    geo = {"rows": GEO_ROWS, "load_s": time.perf_counter() - t}
    t = time.perf_counter()
    d = haversine_reference(lat, lon, *GEO_POINT)
    lo = int((d < GEO_KM - GEO_EDGE_KM).sum())
    hi = int((d < GEO_KM + GEO_EDGE_KM).sum())
    want_sum = math.fsum(d.tolist())
    geo["reference_s"] = time.perf_counter() - t
    del d
    for key, text in (("count", SQL_GEO_COUNT), ("sum", SQL_GEO_SUM)):
        db.sql(text)
        t = time.perf_counter()
        r = db.sql(text)
        torch.cuda.synchronize()
        geo[f"{key}_warm_s"] = time.perf_counter() - t
        v = r.rows()[0][0]
        if key == "count":
            if not lo <= int(v) <= hi:
                raise AssertionError(f"geo count {v} outside [{lo}, {hi}]")
            geo.update(count=int(v), count_within_edge=hi - lo)
        else:
            rel = abs(float(v) - want_sum) / want_sum
            if rel > FLOAT_RTOL:
                raise AssertionError(f"geo sum {v} vs {want_sum}: {rel}")
            geo.update(sum=float(v), sum_reference=want_sum, sum_rel_err=rel)
    out["geo"] = geo
    db.sql("drop table pts")
    del lat, lon

    # ---- FTS: every primary up -------------------------------------------
    t = time.perf_counter()
    probe = db.fts.probe_once()
    fts_ms = (time.perf_counter() - t) * 1e3
    if probe != {s: True for s in range(nseg)}:
        raise AssertionError(f"FTS probe: {probe}")
    out["fts"] = {"all_up": True, "primaries": len(probe),
                  "probe_ms": fts_ms, "per_primary_ms": fts_ms / len(probe)}
    out.update(fused_dense_agg_launches=launches, ok=True)
    emit(out)
    return launches, form

# ---------------------------------------------------------------------------
# all 22 TPC-H statements on the card; the main path from a directory
# ---------------------------------------------------------------------------

def _rows_match(got: list, want: list) -> bool:
    """Rows equal value for value: integers, DECIMAL, dates and text
    exactly, float64 within FLOAT_RTOL relative (a reordered sum)."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if a is None or b is None:
                if not (a is None and b is None):
                    return False
            elif isinstance(a, (float, np.floating)):
                if not (a == b or abs(a - b) <= FLOAT_RTOL * max(abs(a),
                                                                  abs(b))):
                    return False
            elif a != b:
                return False
    return True


def _load_tpch(db, data: dict, tables=None) -> dict:
    """DDL and a bulk load of the generated tables (text as dictionary
    columns, _coded), analyzed. -> seconds per table."""
    from greengage_tpu_torch.utils import tpch

    db.sql(tpch.DDL)
    out = {}
    for table, cols in data.items():
        if tables is not None and table not in tables:
            continue
        t = time.perf_counter()
        db.load_table(table, _coded(cols))
        db.sql(f"analyze {table}")
        out[table] = time.perf_counter() - t
    return out


def _mem_of(res) -> dict:
    mem = res.stats.get("mem") or {}
    meas = mem.get("measured") or {}
    return {"est_bytes_per_segment": mem.get("est_bytes"),
            "admitted_bytes": mem.get("admitted_bytes"),
            "admitted_by": mem.get("admitted_by"),
            "measured_bytes": sum(meas.values()) if meas else None}


# the one shared fault a TPC-H statement meets on the card, by its error:
# a multi-match re-plan past the ceiling with no spillable cut (ROADMAP
# Queue 3 item 13; the JAX package raises the same, tests/
# test_torch_sql_breadth_tpch.py pins both)
KNOWN_FAULTS = {"not spillable": "ROADMAP Queue 3 item 13"}
# the card against the CPU's rows at TPC-H SF 1 (6M lineitem rows): the
# CPU's runs take ~270 s of the script's time there (PERF.md)
CHECK_SF = 1.0


def _known_fault(err: str) -> str | None:
    for text, item in KNOWN_FAULTS.items():
        if text in err:
            return item
    return None


def phase_tpch22_check(torch, nseg: int, sf: float, name: str) -> int:
    """All 22 TPC-H statements (utils/plancorpus.TPCH22) on the card, each
    exact against the port's own CPU rows (connect(device="cpu")) on the
    same data at scale factor ``sf``, 8 segments. -> the fused kernel's
    launches by the 22 card runs."""
    import greengage_tpu_torch
    from greengage_tpu_torch.ops import fused_agg
    from greengage_tpu_torch.utils import tpch
    from greengage_tpu_torch.utils.plancorpus import TPCH22

    t = time.perf_counter()
    data = tpch.generate(sf)
    gen_s = time.perf_counter() - t
    card = greengage_tpu_torch.connect(numsegments=nseg)
    cpu = greengage_tpu_torch.connect(numsegments=nseg, device="cpu")
    load_s = {"card": sum(_load_tpch(card, data).values()),
              "cpu": sum(_load_tpch(cpu, data).values())}
    del data
    stmts, failed, launches = {}, {}, 0
    try:
        for q in sorted(TPCH22, key=lambda k: int(k[1:])):
            row = {}
            answers = {}
            try:
                for side, db in (("card", card), ("cpu", cpu)):
                    before = fused_agg.LAUNCHES
                    t = time.perf_counter()
                    try:
                        answers[side] = db.sql(TPCH22[q])
                    except Exception as e:   # held against the other side
                        answers[side] = f"{type(e).__name__}: {e}"
                    if side == "card":
                        torch.cuda.synchronize()
                        row["launches"] = fused_agg.LAUNCHES - before
                        launches += row["launches"]
                    row[f"{side}_s"] = time.perf_counter() - t
                got, want = answers["card"], answers["cpu"]
                if isinstance(got, str) or isinstance(want, str):
                    # a refusal must be the same typed error on both
                    # sides and a logged fault
                    item = _known_fault(str(got))
                    if got != want or item is None:
                        raise AssertionError(f"card {got!s:.300} / cpu "
                                             f"{want!s:.300}")
                    row["known_fault"] = item
                    row["error"] = got[:300]
                else:
                    row["tiers_used"] = got.stats.get("tiers_used")
                    row["fused_gate"] = got.stats.get("fused_gate")
                    row["rows"] = len(got)
                    if not _rows_match(got.rows(), want.rows()):
                        raise AssertionError(
                            f"card rows {got.rows()[:3]} != cpu rows "
                            f"{want.rows()[:3]} ({len(got)} / "
                            f"{len(want)})")
            except Exception as e:   # reported with the others below
                failed[q] = f"{type(e).__name__}: {e}"[:500]
            finally:
                answers.clear()
                torch.cuda.empty_cache()
            stmts[q] = row
    finally:
        card.close()
        cpu.close()
        torch.cuda.empty_cache()
    emit({"phase": "tpch22_check", "sf": sf, "nseg": nseg, "device": name,
          "generate_s": gen_s, "load_analyze_s": load_s,
          "statements": stmts, "failed": failed,
          "known_faults": {q: r["known_fault"] for q, r in stmts.items()
                           if "known_fault" in r},
          "fused_dense_agg_launches": launches, "ok": not failed})
    if failed:
        raise AssertionError(f"tpch22 at SF {sf}: {sorted(failed)} failed")
    return launches


def phase_tpch22_sf10(torch, data, db, nseg: int, reps: int,
                      name: str) -> tuple[int, list]:
    """All 22 TPC-H statements on the measure phase's Database (the
    script's data; supplier and partsupp loaded beside the tables the
    earlier phases loaded): each cold, then ``reps`` warm. Prints the warm
    median, the fused kernel's launches, tiers_used, spill passes and the
    measured against the estimated bytes; the kernel is held against its
    plain version and timed at the job table of every statement that
    launches it. -> (the launches of the 22 cold runs, those rows)."""
    from greengage_tpu_torch.ops import fused_agg
    from greengage_tpu_torch.utils.plancorpus import TPCH22

    loaded = {}
    for table in data:
        if not sum(db.store.segment_rowcounts(table) or [0]):
            loaded.update(_load_tpch(db, data, tables=[table]))
    stmts, failed, forms, launches = {}, {}, [], 0
    fused = fused_agg._segment_reduce_fused
    for q in sorted(TPCH22, key=lambda k: int(k[1:])):
        row = {}
        tables = []

        def keep(table):
            tables.append(table)
            return fused(table)

        try:
            fused_agg._segment_reduce_fused = keep
            before = fused_agg.LAUNCHES
            t = time.perf_counter()
            res = db.sql(TPCH22[q])
            torch.cuda.synchronize()
            row["cold_s"] = time.perf_counter() - t
            row["launches"] = fused_agg.LAUNCHES - before
            launches += row["launches"]
            fused_agg._segment_reduce_fused = fused
            row["cold_tiers_used"] = res.stats.get("tiers_used")
            row["cold_spill_passes"] = res.stats.get("spill_passes")
            row["rows"] = len(res)
            warm = []
            for _ in range(reps):
                t = time.perf_counter()
                res = db.sql(TPCH22[q])
                torch.cuda.synchronize()
                warm.append(time.perf_counter() - t)
            row["warm_median_s"] = statistics.median(warm)
            row["warm_s"] = warm
            row["tiers_used"] = res.stats.get("tiers_used")
            row["spill_passes"] = res.stats.get("spill_passes")
            row["fused_gate"] = res.stats.get("fused_gate")
            row["multi_join_replan"] = res.stats.get("multi_join_replan")
            row["mem"] = _mem_of(res)
            if tables:
                form = _timed_form(torch, tables[0],
                                   f"tpch22 {q}'s job table (SF10)", 20)
                forms.append(dict(form, statement=q,
                                  launches_cold=row["launches"]))
                row["kernel_ms"] = form["ms"]
                row["kernel_bound_ms"] = form["bound_ms"]
        except Exception as e:   # reported with the others below
            err = f"{type(e).__name__}: {e}"
            item = _known_fault(err)
            if item is None:
                failed[q] = err[:500]
            else:
                row.update(known_fault=item, error=err[:300])
        finally:
            fused_agg._segment_reduce_fused = fused
            del tables
            torch.cuda.empty_cache()
        stmts[q] = row
    emit({"phase": "tpch22_sf10", "nseg": nseg, "device": name,
          "loaded_s": loaded, "statements": stmts, "failed": failed,
          "known_faults": {q: r["known_fault"] for q, r in stmts.items()
                           if "known_fault" in r},
          "fused_dense_agg_launches": launches,
          "kernel_statements": [f["statement"] for f in forms],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "ok": not failed})
    if failed:
        raise AssertionError(f"tpch22 at SF10: {sorted(failed)} failed")
    return launches, forms


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _s, fs in os.walk(path) for f in fs)


def phase_durable(torch, data, nseg: int, reps: int, name: str) -> tuple:
    """The main path from disk: lineitem, orders and customer written into
    a fresh database directory (block files and the manifest), the
    Database closed and the directory reopened in a new one; SQL Q1 cold
    (staged from the block files) and warm, one fused launch each, exact
    against numpy; Q3 and Q12 exact; write, reopen and staging times beside
    the in-memory store's. The directory goes at the end. -> (the kernel's
    launches by the cold Q1, the _timed_form row of its job table)."""
    import os
    import shutil

    import greengage_tpu_torch
    from greengage_tpu_torch.ops import fused_agg
    from greengage_tpu_torch.storage import native

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_durable_smoke")
    shutil.rmtree(path, ignore_errors=True)
    out = {"phase": "durable", "nseg": nseg, "device": name,
           "codec_route": native.route(), "reduced": []}
    try:
        db = greengage_tpu_torch.connect(path=path, numsegments=nseg)
        t = time.perf_counter()
        out["write_s"] = _load_tpch(db, data, tables=("lineitem", "orders",
                                                      "customer"))
        out["write_total_s"] = time.perf_counter() - t
        db.close()
        del db
        torch.cuda.empty_cache()
        out["bytes_on_disk"] = _dir_bytes(path)
        out["rows"] = {k: len(next(iter(data[k].values())))
                       for k in ("lineitem", "orders", "customer")}

        t = time.perf_counter()
        db = greengage_tpu_torch.connect(path=path, numsegments=nseg)
        out["reopen_s"] = time.perf_counter() - t

        def timed(fn):
            t = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            return res, time.perf_counter() - t

        q1_ref = q1_reference(data["lineitem"], _days("1998-09-02"))
        tables = []
        fused = fused_agg._segment_reduce_fused

        def keep(table):
            tables.append(table)
            return fused(table)

        # the main path: every launch count set to 0 just before, read after
        fused_agg._segment_reduce_fused = keep
        try:
            fused_agg.LAUNCHES = 0
            res, cold_s = timed(lambda: db.sql(SQL_Q1))
            launches = fused_agg.LAUNCHES
        finally:
            fused_agg._segment_reduce_fused = fused
        if launches != 1:
            raise AssertionError(f"a cold Q1 from the directory launched "
                                 f"the fused kernel {launches} times")
        check_q1(res, q1_ref)
        out.update(q1_cold_s=cold_s, q1_cold_stage_ms=res.stats["stage_ms"],
                   q1_cold_stats={k: v for k, v in res.stats.items()
                                  if k != "metrics"})
        form = _timed_form(torch, tables[0], "durable Q1's job table "
                           "(SQL Q1 staged from block files)", 20)
        del tables
        ref3, ref12 = q3_reference(data), q12_reference(data)
        res3, cold3_s = timed(lambda: db.sql(SQL_Q3))
        check_q3(res3, ref3)
        res12, cold12_s = timed(lambda: db.sql(SQL_Q12))
        check_q12(res12, ref12)
        warm = {"sql_q1": [], "sql_q3": [], "sql_q12": []}
        for i in range(reps + 1):
            before = fused_agg.LAUNCHES
            again, s1 = timed(lambda: db.sql(SQL_Q1))
            if fused_agg.LAUNCHES != before + 1:
                raise AssertionError("a warm Q1 from the directory did not "
                                     "launch the fused kernel once")
            again3, s2 = timed(lambda: db.sql(SQL_Q3))
            again12, s3 = timed(lambda: db.sql(SQL_Q12))
            if i:
                for k, v in zip(warm, (s1, s2, s3)):
                    warm[k].append(v)
        check_q1(again, q1_ref)
        check_q3(again3, ref3)
        check_q12(again12, ref12)
        db.close()
        out.update(q3_cold_s=cold3_s, q12_cold_s=cold12_s,
                   warm_median_s={k: statistics.median(v)
                                  for k, v in warm.items()},
                   warm_s=warm, memory_store=dict(MEMORY_STORE),
                   q1_warm_stage_ms=again.stats["stage_ms"],
                   fused_dense_agg_launches=launches,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   ok=True)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    out["directory_removed"] = not os.path.exists(path)
    emit(out)
    return launches, form


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--nseg", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0,
                    help="draws the serve phase's Q6 substitutions")
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

    from greengage_tpu_torch.storage import native

    t = time.perf_counter()
    codec = native.route()
    codec_s = time.perf_counter() - t
    t = time.perf_counter()
    logs = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "codec": {"route": codec, "library": native.library_path(),
                    "seconds": codec_s, "log": native.build_log()[-2000:]},
          "kernels": list(build.KERNELS),
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "entry function" in ln or "Used" in ln
                        or "stack frame" in ln]
                    for k, v in logs.items()}})

    # Q1's lineitem at this scale: ~6M rows per unit of scale factor
    kernel = phase_kernel(torch, dev, args.nseg, int(6_000_000 * args.sf))
    torch.cuda.empty_cache()

    from greengage_tpu_torch import entry
    from greengage_tpu_torch.utils import tpch

    t = time.perf_counter()
    data = tpch.generate(args.sf)
    emit({"phase": "generate", "sf": args.sf,
          "seconds": time.perf_counter() - t})
    plan_launches, q1_rows, q1_table, q1_ref = phase_q1(
        torch, dev, data, args.sf, args.nseg, args.reps, name, args.profile)
    sql_launches, db = phase_sql(torch, data, args.nseg, args.reps, name,
                                 q1_table, q1_rows, q1_ref, args.profile)
    del q1_table
    torch.cuda.empty_cache()
    join_launches = phase_joins(torch, data, db, args.nseg, args.reps, name,
                                args.profile, require_fused=args.sf >= 10)
    torch.cuda.empty_cache()
    window_launches, rollup_launches, forms = phase_windows(
        torch, data, db, args.nseg, args.reps, name, args.profile)
    torch.cuda.empty_cache()
    spill_launches, pass_form = phase_spill(torch, data, db, args.nseg,
                                            args.reps, name,
                                            require_fused=args.sf >= 10)
    torch.cuda.empty_cache()
    serve_launches, served = phase_serve(torch, data, db, args.nseg,
                                         args.seed, name)
    torch.cuda.empty_cache()
    wire_launches, wire_form = phase_wire(torch, data, db, args.nseg,
                                          args.reps, args.seed, name,
                                          smi_line, served)
    torch.cuda.empty_cache()
    explain_launches, explain_form = phase_measure(torch, data, db,
                                                   args.nseg, args.reps,
                                                   name, smi_line)
    torch.cuda.empty_cache()
    tpch22_launches, tpch22_forms = phase_tpch22_sf10(
        torch, data, db, args.nseg, args.reps, name)
    db.close()
    del db
    torch.cuda.empty_cache()
    check_launches = phase_tpch22_check(torch, args.nseg, CHECK_SF, name)
    durable_launches, durable_form = phase_durable(torch, data, args.nseg,
                                                   args.reps, name)
    del data
    torch.cuda.empty_cache()
    # SQL Q1 from a reopened directory is this slice's main path: the
    # kernel's numbers are those of the job table its cold run handed the
    # kernel; EXPLAIN ANALYZE's Q1 table, the wire's, the spilled pass's,
    # the synthetic Q1 table, the ROLLUP's two tables (summed per
    # statement) and the tpch22 statements' tables stay beside them, and
    # every earlier path is read as it was driven
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    kernel["q1_table"] = {k: kernel[k] for k in keys}
    kernel["spill_pass_table"] = {k: pass_form[k] for k in keys}
    kernel["rollup_tables"] = {
        k: (None if any(f[k] is None for f in forms)
            else sum(f[k] for f in forms)) for k in keys}
    kernel["wire_q1_table"] = {k: wire_form[k] for k in keys}
    kernel["explain_q1_table"] = {k: explain_form[k] for k in keys}
    kernel["tpch22_tables"] = {
        f["statement"]: dict({k: f[k] for k in keys},
                             launches=f["launches_cold"])
        for f in tpch22_forms}
    kernel.update({k: durable_form[k] for k in keys})
    kernel["max_abs_err"] = max(
        e for e in [kernel["max_abs_err"], pass_form["max_abs_err"],
                    wire_form["max_abs_err"], explain_form["max_abs_err"],
                    durable_form["max_abs_err"]]
        + [f["max_abs_err"] for f in forms + tpch22_forms]
        if e is not None)
    kernel["measured_at"] = ("the job table SQL Q1 hands the kernel, "
                             "staged from a reopened directory's block "
                             "files")
    kernel["launches"] = durable_launches
    kernel["launches_per_sql_rollup"] = rollup_launches
    kernel["launches_by_path"] = {"sql_durable": durable_launches,
                                  "tpch22_check": check_launches,
                                  "tpch22_sf10": tpch22_launches,
                                  "sql_explain": explain_launches,
                                  "sql_wire": wire_launches,
                                  "sql_serve": serve_launches,
                                  "sql_spill": spill_launches,
                                  "sql_windows": window_launches,
                                  "sql_q12": join_launches,
                                  "sql": sql_launches,
                                  "q1_plan": plan_launches}

    emit({"phase": "dryrun", "nseg": args.nseg,
          "rows": entry.dryrun_step(args.nseg, dev), "ok": True})
    emit({"kernels": [kernel]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
