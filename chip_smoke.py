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

def _jobs(torch, rng, dev, nseg, n, D, spec, live_frac):
    """Random dense-aggregation inputs as ops/agg._run_aggs hands them to
    the kernel: gid 0 and identity-filled values at dead rows."""
    live = torch.from_numpy(rng.random((nseg, n)) < live_frac).to(dev)
    gid = torch.from_numpy(rng.integers(0, D, (nseg, n), dtype=np.int32))
    gid = torch.where(live, gid.to(dev), 0).to(torch.int32).contiguous()
    jobs = []
    for kind, op in spec:
        if kind == "f":
            v = torch.from_numpy(rng.random((nseg, n)) * 1000.0).to(dev)
            ident = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}[op]
        else:
            v = torch.from_numpy(
                rng.integers(-10**12, 10**12, (nseg, n))).to(dev)
            ident = {"sum": 0, "min": 2**63 - 1, "max": -2**63}[op]
        fill = torch.tensor(ident, dtype=v.dtype, device=dev)
        jobs.append((torch.where(live, v, fill).contiguous(), op, ident))
    return gid, jobs


def _q1_jobs(torch, dev, nseg, n, J, seed=0):
    """Q1-shaped kernel inputs built on the card: gid over the 6 live
    (returnflag, linestatus) groups of D = 12 plus ~1.4% dead rows in group
    0, and J int64 sum jobs of scaled-decimal magnitude."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rf = torch.randint(1, 4, (nseg, n), device=dev, generator=g)
    ls = torch.randint(1, 3, (nseg, n), device=dev, generator=g)
    live = torch.rand((nseg, n), device=dev, generator=g) > 0.014
    gid = torch.where(live, rf * 3 + ls, 0).to(torch.int32).contiguous()
    jobs = [(torch.where(live, torch.randint(
        0, 10**11, (nseg, n), device=dev, generator=g), 0).contiguous(),
        "sum", 0) for _ in range(J)]
    return gid, jobs


def compare(torch, got, want) -> float:
    err = 0.0
    for a, b in zip(got, want):
        if a.dtype == torch.float64:
            d = (a - b).abs()
            lim = FLOAT_RTOL * b.abs().clamp_min(1.0)
            if bool((d > lim).any()):
                raise AssertionError(f"float64 result off by {float(d.max())}")
            err = max(err, float(d.max()) if d.numel() else 0.0)
        elif not torch.equal(a, b):
            raise AssertionError("int64 result differs from the plain version")
    return err


def phase_kernel(torch, dev, nseg_q1: int, rows_q1: int) -> dict:
    from greengage_tpu_torch.ops import fused_agg

    rng = np.random.default_rng(11)
    ints = [("i", "sum")] * 4 + [("i", "min"), ("i", "max")]
    cases = [
        ("D=1 one segment ragged", 1, 100_003, 1, ints, 0.98),
        ("D=12 eight segments", 8, 50_001, 12, ints, 0.98),
        ("D=64 eight segments", 8, 30_011, 64, ints, 0.9),
        ("all rows dead", 8, 4_097, 12, ints, 0.0),
        ("float64 jobs", 8, 65_537, 12,
         [("f", "sum"), ("f", "min"), ("f", "max"), ("i", "sum")], 0.97),
        ("one row", 1, 1, 12, ints, 1.0),
    ]
    max_err = 0.0
    for name, nseg, n, D, spec, live in cases:
        gid, jobs = _jobs(torch, rng, dev, nseg, n, D, spec, live)
        got = fused_agg._segment_reduce_kernel(gid, D, jobs)
        torch.cuda.synchronize()
        want = fused_agg._segment_reduce_plain(gid, D, jobs)
        err = compare(torch, got, want)
        max_err = max(max_err, err)
        emit({"phase": "kernel", "case": name, "nseg": nseg, "n": n, "D": D,
              "jobs": len(jobs), "max_abs_err": err, "ok": True})

    # TPC-H Q1's partial aggregate: 8 int64 jobs (count, 4 sums, 3 avg
    # sums) over D = 12 groups on every segment
    D, J = 12, 8
    n = -(-rows_q1 // nseg_q1)
    gid, jobs = _q1_jobs(torch, dev, nseg_q1, n, J)
    got = fused_agg._segment_reduce_kernel(gid, D, jobs)
    want = fused_agg._segment_reduce_plain(gid, D, jobs)
    max_err = max(max_err, compare(torch, got, want))
    ms = cuda_ms(torch, lambda: fused_agg._segment_reduce_kernel(
        gid, D, jobs), 20)
    plain_ms = cuda_ms(torch, lambda: fused_agg._segment_reduce_plain(
        gid, D, jobs), 3)
    # the library yardstick: ONE index_add_ of the stacked [rows, J] jobs
    # into [nseg * D, J] computes the same sums (never used by the port)
    flat = (torch.arange(nseg_q1, device=dev)[:, None] * D
            + gid.to(torch.int64)).reshape(-1)
    stacked = torch.stack([v.reshape(-1) for v, _, _ in jobs], dim=1)
    library_ms = cuda_ms(torch, lambda: torch.zeros(
        (nseg_q1 * D, J), dtype=torch.int64, device=dev).index_add_(
            0, flat, stacked), 5)
    lib = torch.zeros((nseg_q1 * D, J), dtype=torch.int64,
                      device=dev).index_add_(0, flat, stacked)
    if not torch.equal(lib.reshape(nseg_q1, D, J).permute(2, 0, 1),
                       torch.stack(want)):
        raise AssertionError("index_add_ yardstick disagrees")
    del stacked, flat
    nbytes = nseg_q1 * n * (4 + 8 * J) + nseg_q1 * J * D * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"phase": "kernel", "case": "Q1 partial aggregate", "nseg": nseg_q1,
           "n": n, "D": D, "jobs": J, "bytes": nbytes, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "ok": True}
    emit(row)
    return {"name": "fused_dense_agg", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


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
          "ptxas": {k: [ln for ln in v.splitlines() if "ptxas info" in ln]
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
