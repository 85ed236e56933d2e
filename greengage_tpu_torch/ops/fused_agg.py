"""Single-pass fused dense aggregation — the port's counterpart of
greengage_tpu/ops/fused_agg.py.

The kernel (csrc/fused_dense_agg.cu, CUDA C++ for sm_90a) computes every
segmented reduction of a dense GROUP BY in one pass over the rows; the
source's header says what bounds it and how it is laid out. Semantics come
by record/replay around ops/agg._run_aggs, the single source of SQL
aggregate truth: a recording pass captures every ``agg.Job`` descriptor
_run_aggs asks for (a column or a count, its live mask, op, identity), one
launch computes them all, and a replay pass hands the results back in the
same order.

Between the two passes ``job_table`` turns the descriptors into the table
the kernel takes by value: distinct columns (by storage pointer, dtype and
strides), distinct masks (by pointer) and distinct jobs (same column, mask
and op). Each of them is read once per row, however many aggregates name
it; a duplicate job's result feeds every replay slot that asked for it.

``_segment_reduce_plain`` is the same function in plain torch. The wrapper
takes it only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass

import torch

from greengage_tpu_torch.ops import agg as agg_ops

OPS = {"sum": 0, "min": 1, "max": 2}
OP_NAMES = {code: name for name, code in OPS.items()}
# element types a column may have, by the code the kernel switches on
DTYPES = {torch.bool: 0, torch.int32: 1, torch.int64: 2, torch.float64: 3}
MAX_COLS = 32
MAX_MASKS = 16
MAX_JOBS = 64
NONE = -1          # no column (a count), or no mask (every row live)
THREADS_PER_WARP = 32
MAX_WARPS = 8
# H100: shared memory one block may opt in to, less the kernel's static
# per-job constants (MAX_JOBS x 8 B)
SHARED_BYTES = 232448 - 8 * MAX_JOBS
# the lane-private path is taken while this many warps' copies fit a block
LANE_PATH_MIN_WARPS = 8
PATH_LANE, PATH_WARP = 0, 1
LAUNCHES = 0

_lib = None
_sm_count: dict[int, int] = {}


def supported(aggs) -> bool:
    return all(s.func in ("sum", "count", "count_star", "avg", "min", "max")
               for s in aggs)


# ---------------------------------------------------------------------------
# the job table
# ---------------------------------------------------------------------------

@dataclass
class JobTable:
    """Distinct columns, masks and jobs of one fused launch.

    cols / masks: tensors as the kernel reads them, each [nseg, n]: either
    contiguous and 16-byte aligned (streamed, one element per row), or with
    row stride 0 (a broadcast literal: one value per segment). Streamed
    columns come first (``nstream`` of them).
    jobs: (col or -1 for a count, mask or -1, op code, is_float, ident),
    grouped by streamed column in column order, then the jobs whose value is
    one per segment (counts and broadcast columns).
    slots: recorded descriptor i -> its job in ``jobs``.
    """
    gid: torch.Tensor
    D: int
    cols: list
    masks: list
    jobs: list
    slots: list
    nstream: int

    @property
    def bytes_per_row(self) -> int:
        """Bytes the kernel reads per row: the gid and every streamed
        column and mask once."""
        return (self.gid.element_size()
                + sum(c.element_size() for c in self.cols if _streamed(c))
                + sum(m.element_size() for m in self.masks if _streamed(m)))

    def job_begin(self) -> list[int]:
        """-> [nstream + 1]: the first job of each streamed column, then
        the first job of the per-segment constants."""
        out, j = [], 0
        for c in range(self.nstream):
            out.append(j)
            while j < len(self.jobs) and self.jobs[j][0] == c:
                j += 1
        out.append(j)
        return out


def _streamed(t) -> bool:
    return t.stride(1) != 0 or t.shape[1] <= 1


def _as_read(t):
    """A column or mask in a form the kernel reads: broadcast (row stride
    0) as it is, anything else contiguous and 16-byte aligned."""
    if t.dim() == 2 and t.shape[1] > 1 and t.stride(1) == 0:
        return t
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def _check_gid(gid):
    if (gid.dtype != torch.int32 or gid.dim() != 2
            or not gid.is_contiguous()):
        raise ValueError("fused_dense_agg: gid must be a contiguous int32 "
                         f"[nseg, n] tensor, got {gid.dtype} "
                         f"{tuple(gid.shape)} strides {gid.stride()}")


def job_table(gid, D: int, descs) -> JobTable:
    """Host-side: ``agg.Job`` descriptors -> the JobTable of one launch,
    with duplicate columns, masks and jobs removed. Raises on what neither
    the kernel nor its plain version takes."""
    _check_gid(gid)
    gid = _as_read(gid)
    if D < 1:
        raise ValueError(f"fused_dense_agg: domain {D} must be positive")
    shape, dev = tuple(gid.shape), gid.device

    def check(t, what):
        if t.device != dev:
            raise ValueError(f"fused_dense_agg: {what} on {t.device}, gid on "
                             f"{dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_dense_agg: {what} of shape "
                             f"{tuple(t.shape)}, expected {shape}")

    cols, col_ix, masks, mask_ix = [], {}, [], {}
    keyed = []
    for d in descs:
        c = NONE
        if d.values is not None:
            v = d.values
            check(v, "a column")
            if v.dtype not in DTYPES:
                raise ValueError(f"fused_dense_agg: column dtype {v.dtype}, "
                                 f"supported {sorted(map(str, DTYPES))}")
            key = (v.data_ptr(), v.dtype, v.stride())
            if key not in col_ix:
                col_ix[key] = len(cols)
                cols.append(_as_read(v))
            c = col_ix[key]
        is_float = d.values is not None and d.values.dtype == torch.float64
        if d.dtype.is_floating_point != is_float:
            raise ValueError(f"fused_dense_agg: result dtype {d.dtype} does "
                             "not follow its column")
        m = NONE
        if d.live is not None:
            check(d.live, "a live mask")
            if d.live.dtype != torch.bool:
                raise ValueError(f"fused_dense_agg: live mask dtype "
                                 f"{d.live.dtype}, expected bool")
            key = (d.live.data_ptr(), d.live.stride())
            if key not in mask_ix:
                mask_ix[key] = len(masks)
                masks.append(_as_read(d.live))
            m = mask_ix[key]
        if d.op not in OPS:
            raise ValueError(f"fused_dense_agg: op {d.op!r}")
        ident = 0 if d.op == "sum" else d.ident
        ident = float(ident) if is_float else int(ident)
        keyed.append((c, m, OPS[d.op], is_float, ident))
    if len(cols) > MAX_COLS or len(masks) > MAX_MASKS:
        raise ValueError(f"fused_dense_agg: {len(cols)} columns and "
                         f"{len(masks)} masks, supported {MAX_COLS} and "
                         f"{MAX_MASKS}")

    # streamed columns first, keeping first-seen order
    order = sorted(range(len(cols)), key=lambda i: not _streamed(cols[i]))
    remap = {old: new for new, old in enumerate(order)}
    cols = [cols[i] for i in order]
    nstream = sum(_streamed(c) for c in cols)
    keyed = [(remap.get(c, c), m, op, f, ident)
             for c, m, op, f, ident in keyed]
    distinct = list(dict.fromkeys(keyed))

    def group(job):
        c = job[0]
        return c if 0 <= c < nstream else nstream

    jobs = sorted(distinct, key=group)       # stable: first-seen order
    if len(jobs) > MAX_JOBS:
        raise ValueError(f"fused_dense_agg: {len(jobs)} jobs, supported "
                         f"1..{MAX_JOBS}")
    where = {job: i for i, job in enumerate(jobs)}
    return JobTable(gid, D, cols, masks, jobs, [where[k] for k in keyed],
                    nstream)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _segment_reduce_plain(table: JobTable):
    """-> one [nseg, D] result per job of the table (int64, or float64 for
    a float job), as the kernel computes it: agg.reduce_job's masking and
    scatter over seg*D + gid, widened."""
    gid = table.gid
    out = []
    for c, m, op, is_float, ident in table.jobs:
        live = (table.masks[m] if m != NONE
                else torch.ones(gid.shape, dtype=torch.bool,
                                device=gid.device))
        acc = torch.float64 if is_float else torch.int64
        col = table.cols[c] if c != NONE else None
        out.append(agg_ops.reduce_job(gid, table.D, agg_ops.Job(
            col, live, acc, OP_NAMES[op], ident)).to(acc))
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class _Col(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("seg_stride", ctypes.c_longlong),
                ("dtype", ctypes.c_int), ("bcast", ctypes.c_int)]


class _Job(ctypes.Structure):
    _fields_ = [("ident", ctypes.c_longlong), ("col", ctypes.c_int),
                ("mask", ctypes.c_int), ("op", ctypes.c_int),
                ("is_float", ctypes.c_int)]


class _Table(ctypes.Structure):
    """Mirror of ``Table`` in csrc/fused_dense_agg.cu, passed by value as
    the kernel's __grid_constant__ parameter."""
    _fields_ = [("gid", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("D", ctypes.c_int), ("J", ctypes.c_int),
                ("ncols", ctypes.c_int), ("nmasks", ctypes.c_int),
                ("cols", _Col * MAX_COLS), ("masks", _Col * MAX_MASKS),
                ("jobs", _Job * MAX_JOBS),
                ("col_begin", ctypes.c_int * (MAX_COLS + 1))]


def _ident_bits(ident, is_float: bool) -> int:
    if is_float:
        return struct.unpack("<q", struct.pack("<d", ident))[0]
    return int(ident)


def _ctable(table: JobTable) -> _Table:
    t = _Table()
    t.gid = table.gid.data_ptr()
    t.n = table.gid.shape[1]
    t.D, t.J = table.D, len(table.jobs)
    t.ncols, t.nmasks = table.nstream, len(table.masks)
    for dst, src in ((t.cols, table.cols), (t.masks, table.masks)):
        for i, x in enumerate(src):
            dst[i].ptr = x.data_ptr()
            dst[i].seg_stride = x.stride(0)
            dst[i].dtype = DTYPES[x.dtype]
            dst[i].bcast = int(not _streamed(x))
    for i, (c, m, op, is_float, ident) in enumerate(table.jobs):
        j = t.jobs[i]
        j.col, j.mask, j.op, j.is_float = c, m, op, int(is_float)
        j.ident = _ident_bits(ident, is_float)
    for i, b in enumerate(table.job_begin()):
        t.col_begin[i] = b
    return t


def _kernels():
    global _lib
    if _lib is None:
        from greengage_tpu_torch import build

        lib = build.load("fused_dense_agg")
        lib.ggt_fused_dense_agg_table_bytes.restype = ctypes.c_int
        lib.ggt_fused_dense_agg_table_bytes.argtypes = []
        if lib.ggt_fused_dense_agg_table_bytes() != ctypes.sizeof(_Table):
            raise RuntimeError("fused_dense_agg: the kernel's Table layout "
                               "differs from the wrapper's")
        lib.ggt_fused_dense_agg_occupancy.restype = ctypes.c_int
        lib.ggt_fused_dense_agg_occupancy.argtypes = [
            ctypes.POINTER(_Table), ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]
        lib.ggt_fused_dense_agg.restype = ctypes.c_int
        lib.ggt_fused_dense_agg.argtypes = [
            ctypes.POINTER(_Table), ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p]
        _lib = lib
    return _lib


def launch_plan(J: int, D: int) -> tuple[int, int, int]:
    """-> (path, warps per block, dynamic shared bytes per block).

    PATH_LANE keeps a [J, D, 32] copy of the partials per warp, one slot
    per lane, while LANE_PATH_MIN_WARPS such copies fit a block; beyond
    that PATH_WARP keeps a [J, D] copy per warp, updated once per distinct
    group per warp (warp-aggregated). What neither fits raises."""
    lane_bytes = J * D * THREADS_PER_WARP * 8
    if lane_bytes * LANE_PATH_MIN_WARPS <= SHARED_BYTES:
        warps = min(MAX_WARPS, SHARED_BYTES // lane_bytes)
        return PATH_LANE, warps, warps * lane_bytes
    warp_bytes = J * D * 8
    if warp_bytes > SHARED_BYTES:
        raise ValueError(f"fused_dense_agg: {J} jobs x {D} groups need "
                         f"{warp_bytes} bytes of shared memory per warp, "
                         f"above {SHARED_BYTES}")
    warps = min(MAX_WARPS, SHARED_BYTES // warp_bytes)
    return PATH_WARP, warps, warps * warp_bytes


def blocks_per_segment(sm_count: int, blocks_per_sm: int, nseg: int, n: int,
                       threads: int) -> int:
    """As many blocks as fit the card at once across all segments (one
    wave: a second, partial wave would double the time), and no more than
    a segment's 4-row quads give threads."""
    want = sm_count * max(blocks_per_sm, 1) // nseg
    return max(1, min(want, -(-n // (4 * threads))))


def _sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _sm_count[idx]


def launch_shape(table: JobTable, ct: _Table | None = None):
    """-> (path, threads, shared bytes, blocks per segment) of the launch
    for this table on its card."""
    nseg, n = table.gid.shape
    path, warps, smem = launch_plan(len(table.jobs), table.D)
    threads = warps * THREADS_PER_WARP
    per_sm = ctypes.c_int(0)
    err = _kernels().ggt_fused_dense_agg_occupancy(
        ctypes.byref(_ctable(table) if ct is None else ct), path, threads,
        smem, ctypes.byref(per_sm))
    if err != 0:
        raise RuntimeError(f"fused_dense_agg: occupancy query failed: CUDA "
                           f"error {err}")
    blocks = blocks_per_segment(_sms(table.gid.device), per_sm.value, nseg,
                                n, threads)
    return path, threads, smem, blocks


def _segment_reduce_kernel(table: JobTable):
    """One launch of the kernel over the table -> one [nseg, D] result per
    job. Allocates the output and the workspace with torch.empty and never
    waits for the device."""
    global LAUNCHES
    gid, D = table.gid, table.D
    dev = gid.device
    nseg, n = gid.shape
    J = len(table.jobs)
    if J < 1:
        raise ValueError("fused_dense_agg: no jobs")
    if nseg == 0 or n == 0:
        return [torch.full((nseg, D), ident,
                           dtype=torch.float64 if f else torch.int64,
                           device=dev)
                for _, _, _, f, ident in table.jobs]
    ct = _ctable(table)
    path, threads, smem, blocks = launch_shape(table, ct)
    ws = torch.empty((nseg, blocks, J, D), dtype=torch.int64, device=dev)
    out = torch.empty((nseg, J, D), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernels().ggt_fused_dense_agg(
        ctypes.byref(ct), nseg, ws.data_ptr(), out.data_ptr(), blocks,
        threads, path, smem, stream)
    if err != 0:
        raise RuntimeError(f"fused_dense_agg launch failed: CUDA error {err} "
                           f"({nseg} x {n} rows, {J} jobs, D={D}, path "
                           f"{path}, {threads} threads, {smem} B shared)")
    LAUNCHES += 1
    fout = out.view(torch.float64)
    return [fout[:, j] if job[3] else out[:, j]
            for j, job in enumerate(table.jobs)]


def _segment_reduce_fused(table: JobTable):
    """-> one [nseg, D] result per job of the table: the kernel for CUDA
    tensors, its plain version for CPU tensors."""
    dev = table.gid.device
    if dev.type == "cpu":
        return _segment_reduce_plain(table)
    if dev.type != "cuda":
        raise ValueError(f"fused_dense_agg: no kernel for {dev}")
    return _segment_reduce_kernel(table)


def record_jobs(aggs, sel, masks: dict | None = None):
    """Run _run_aggs once with a recording reducer -> the Job descriptors
    it asks for, in call order. The placeholder results flow into
    arithmetic that is thrown away."""
    descs: list = []

    def rec(job):
        descs.append(job)
        return torch.zeros(sel.shape[0], 1, dtype=job.dtype,
                           device=sel.device)

    agg_ops._run_aggs(aggs, sel, rec, masks)
    return descs


def fused_dense_aggregate(gid, D: int, aggs, sel):
    """Drop-in for agg.dense_aggregate: -> (vals, valids) with identical
    semantics, computed in one pass. Only call when supported(aggs)."""
    masks: dict = {}
    descs = record_jobs(aggs, sel, masks)
    table = job_table(gid, D, descs)
    results = _segment_reduce_fused(table)

    # replay with the fused results, in the same call order; the live
    # masks built by the recording pass are reused
    it = iter(table.slots)

    def replay(job):
        r = results[next(it)]
        return r if r.dtype == job.dtype else r.to(job.dtype)

    return agg_ops._run_aggs(aggs, sel, replay, masks)
