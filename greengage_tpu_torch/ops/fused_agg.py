"""Single-pass fused dense aggregation — the port's counterpart of
greengage_tpu/ops/fused_agg.py.

The kernel (csrc/fused_dense_agg.cu, CUDA C++ for sm_90a) computes every
segmented reduction of a dense GROUP BY in one pass over the rows; the
source's header says what bounds it and how it is laid out. Semantics come
by record/replay around ops/agg._run_aggs, the single source of SQL
aggregate truth: a recording pass captures every reduction _run_aggs asks
for (already masked or identity-filled), one launch computes them all, and a
replay pass hands the results back in the same order.

``_segment_reduce_plain`` is the same function in plain torch. The wrapper
takes it only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from greengage_tpu_torch.ops import agg as agg_ops

OPS = {"sum": 0, "min": 1, "max": 2}
MAX_JOBS = 64
THREADS = 256
SHARED_BYTES = 48 * 1024     # per block, without the opt-in attribute
LAUNCHES = 0

_fn = None
_sm_count: dict[int, int] = {}


def supported(aggs) -> bool:
    return all(s.func in ("sum", "count", "count_star", "avg", "min", "max")
               for s in aggs)


def _job_values(v):
    """A job column as the kernel reads it: int64 or float64, contiguous."""
    dt = torch.float64 if v.dtype.is_floating_point else torch.int64
    return v.to(dt).contiguous()


def _segment_reduce_plain(gid, D: int, jobs):
    """jobs: list of (values[nseg, n], op, ident) -> list of [nseg, D]
    results (int64 or float64), via scatter-add / scatter-reduce over
    seg*D + gid."""
    out = []
    for v, op, ident in jobs:
        v = _job_values(v)
        if op == "sum":
            out.append(agg_ops.segment_sum(gid, D, v))
        else:
            out.append(agg_ops.segment_minmax(gid, D, v, op, ident))
    return out


def _launcher():
    global _fn
    if _fn is None:
        from greengage_tpu_torch import build

        fn = build.load("fused_dense_agg").ggt_fused_dense_agg
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch_shape(device: torch.device, nseg: int, n: int, J: int, D: int):
    """-> (blocks_per_segment, copies): about 8 resident 256-thread blocks
    per SM across all segments, and as many per-warp partial copies as fit
    the block's shared memory (at most one per warp)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    per_copy = J * D * 8
    if per_copy > SHARED_BYTES:
        raise ValueError(
            f"fused_dense_agg: {J} jobs x {D} groups need {per_copy} bytes "
            f"of shared memory per copy, above {SHARED_BYTES}")
    copies = max(1, min(THREADS // 32, SHARED_BYTES // per_copy))
    want = -(-_sm_count[idx] * 8 // nseg)
    blocks = max(1, min(want, -(-n // THREADS)))
    return blocks, copies


def _segment_reduce_kernel(gid, D: int, jobs):
    global LAUNCHES
    dev = gid.device
    if gid.dtype != torch.int32 or gid.dim() != 2 or not gid.is_contiguous():
        raise ValueError("fused_dense_agg: gid must be a contiguous int32 "
                         f"[nseg, n] tensor, got {gid.dtype} {tuple(gid.shape)}")
    if not 1 <= len(jobs) <= MAX_JOBS:
        raise ValueError(f"fused_dense_agg: {len(jobs)} jobs, supported "
                         f"1..{MAX_JOBS}")
    if D < 1:
        raise ValueError(f"fused_dense_agg: domain {D} must be positive")
    nseg, n = gid.shape
    cols, words = [], []
    for v, op, ident in jobs:
        if v.device != dev or tuple(v.shape) != (nseg, n):
            raise ValueError("fused_dense_agg: every job must be a "
                             f"[{nseg}, {n}] tensor on {dev}")
        v = _job_values(v)
        cols.append(v)
        is_float = v.dtype == torch.float64
        bits = torch.tensor(float(ident), dtype=torch.float64).view(
            torch.int64).item() if is_float else int(ident)
        words.append((v.data_ptr(), bits, OPS[op] | (int(is_float) << 8)))
    J = len(jobs)
    meta = torch.tensor([w[0] for w in words] + [w[1] for w in words]
                        + [w[2] for w in words], dtype=torch.int64).to(dev)
    out = meta[J:2 * J].view(1, J, 1).repeat(nseg, 1, D)
    if nseg and n:
        blocks, copies = launch_shape(dev, nseg, n, J, D)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(gid.data_ptr(), nseg, n, D, meta.data_ptr(), J,
                          out.data_ptr(), blocks, THREADS, copies, stream)
        if err != 0:
            raise RuntimeError(f"fused_dense_agg launch failed: CUDA error "
                               f"{err} ({nseg} x {n} rows, {J} jobs, D={D})")
        LAUNCHES += 1
    results = []
    fout = out.view(torch.float64)
    for j, c in enumerate(cols):
        results.append(fout[:, j] if c.dtype == torch.float64 else out[:, j])
    return results


def _segment_reduce_fused(gid, D: int, jobs):
    """jobs: list of (values[nseg, n] pre-masked/filled, op, ident) with op
    in {'sum','min','max'} -> list of per-group [nseg, D] results."""
    if gid.device.type == "cpu":
        return _segment_reduce_plain(gid, D, jobs)
    if gid.device.type != "cuda":
        raise ValueError(f"fused_dense_agg: no kernel for {gid.device}")
    return _segment_reduce_kernel(gid, D, jobs)


def fused_dense_aggregate(gid, D: int, aggs, sel):
    """Drop-in for agg.dense_aggregate: -> (vals, valids) with identical
    semantics, computed in one pass. Only call when supported(aggs)."""
    # pass 1: record every segmented reduction _run_aggs asks for; the
    # placeholder results flow into arithmetic that is thrown away
    jobs: list = []

    def rec_sum(build, dtype):
        acc_float = dtype.is_floating_point
        jobs.append((build(), "sum", 0.0 if acc_float else 0))
        return torch.zeros((gid.shape[0], D), dtype=dtype, device=gid.device)

    def rec_minmax(build, dtype, func, ident):
        jobs.append((build(), func, ident.item()))
        return torch.zeros((gid.shape[0], D), dtype=dtype, device=gid.device)

    agg_ops._run_aggs(aggs, sel, rec_sum, rec_minmax)
    results = _segment_reduce_fused(gid, D, jobs)
    jobs.clear()

    # pass 2: replay with the fused results, in the same call order; the
    # builders are not called again
    it = iter(results)

    def replay_sum(build, dtype):
        return next(it)

    def replay_minmax(build, dtype, func, ident):
        r = next(it)
        return r if dtype.is_floating_point else r.to(dtype)

    return agg_ops._run_aggs(aggs, sel, replay_sum, replay_minmax)
