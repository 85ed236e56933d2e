// Fused dense aggregation for Hopper (sm_90a) — one pass over the rows for
// every aggregate of a small-domain GROUP BY.
//
// Replaces the TPU kernel greengage_tpu/ops/fused_agg.py::_segment_reduce_fused
// (pl.pallas_call at fused_agg.py:157). For dense group ids gid[seg, r] in
// [0, D) and J jobs, it returns every job's per-(segment, group) result
// out[seg, j, g]. A job names a column (or none, for a count of live rows),
// a live mask (or none), an op in {sum, min, max} and an identity; a row
// contributes live ? widen(column[seg, r]) : identity. The caller
// (ops/fused_agg.py::job_table) has removed duplicate columns, masks and
// jobs, so each base column and mask is read once however many aggregates
// name it, and nothing is masked or cast before the kernel.
//
// What bounds it on an H100: device memory. It reads, per row, the int32
// gid plus every distinct streamed column and mask once (TPC-H Q1's partial
// aggregate: 4 + 5 x 8 + 1 = 45 B, 2.7 GB at SF10, ~0.81 ms at 3.35 TB/s),
// and writes nseg * J * D * 8 bytes. What the design does about it:
//   - The job table travels by value as a __grid_constant__ parameter: no
//     device table, no upload, no host synchronisation.
//   - Each thread takes 4 consecutive rows per step with 16-byte loads (4
//     gids, 4 mask bytes, two int64 pairs per column), and issues the loads
//     of up to NC columns (a template parameter) before the first update,
//     so a row tile's loads are all in flight together. Segment starts need
//     not be 16-byte aligned: each segment's few head and tail rows outside
//     the aligned quads are taken one by one.
//   - Lane-private partials (PATH_LANE): shared memory [warp][J][D][32],
//     one slot per lane, updated with plain 64-bit loads and stores: no
//     atomics, no two lanes on one address. Taken while 8 warps' copies fit
//     (J * D <= 113); Q1 has J * D = 72.
//   - Warp-aggregated partials (PATH_WARP), for larger J * D: a [J][D] copy
//     per warp. Per row, __match_any_sync finds the lanes with the same
//     group, a shuffle tree combines their values, and the lowest of them
//     updates the copy: one update per distinct group per warp.
//   - A fixed-order fold: each block folds its warps' (and lanes') copies
//     in index order into a workspace [nseg, blocks, J, D]; a second kernel
//     folds each segment's blocks in index order into out. No atomics
//     anywhere, so with the same inputs and launch shape every result,
//     float64 sums included, is bit-identical from run to run.
//
// Exactness: int64 wrapping addition, min and max are order-free, so
// integer results are bit-identical to the plain version; float64 sums
// differ from it only by summation order (relative 1e-12 on Q1-like
// magnitudes). NaN propagates through min and max as in torch.amin.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_COLS = 32;
constexpr int MAX_MASKS = 16;
constexpr int MAX_JOBS = 64;
constexpr int OP_SUM = 0;
constexpr int OP_MIN = 1;
constexpr int OP_MAX = 2;
constexpr int DT_BOOL = 0, DT_I32 = 1, DT_I64 = 2, DT_F64 = 3;
constexpr int PATH_LANE = 0;
constexpr int ALWAYS_BIT = 31;  // the live bit of a job without a mask
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 256;

struct Col {            // a column or a mask, [nseg, n]
  const void* ptr;
  long long seg_stride;  // elements; streamed arrays have n
  int dtype;             // DT_*; masks are DT_BOOL
  int bcast;             // row stride 0: one value per segment
};

struct Job {
  long long ident;       // int64, or the bits of a float64
  int col;               // -1: a count of live rows
  int mask;              // -1: every row is live
  int op;                // OP_SUM, OP_MIN, OP_MAX
  int is_float;
};

// Mirrors ops/fused_agg.py::_Table. Streamed columns are cols[0, ncols);
// jobs are grouped by streamed column: col_begin[c] is the first job of
// column c and col_begin[ncols] the first job whose value is one per
// segment (a count, or a broadcast column).
struct Table {
  const int32_t* gid;    // [nseg, n] contiguous
  long long n;
  int D, J, ncols, nmasks;
  Col cols[MAX_COLS];
  Col masks[MAX_MASKS];
  Job jobs[MAX_JOBS];
  int col_begin[MAX_COLS + 1];
};

__device__ __forceinline__ bool replaces(int op, double cur, double v) {
  if (cur != cur) return false;  // NaN already won
  if (v != v) return true;       // NaN propagates
  return op == OP_MIN ? v < cur : v > cur;
}

// cur (+) v under the job's op, on int64 words (float64 jobs hold bits)
__device__ __forceinline__ long long combine(int op, int is_float,
                                             long long cur, long long v) {
  if (is_float) {
    const double x = __longlong_as_double(cur), y = __longlong_as_double(v);
    if (op == OP_SUM) return __double_as_longlong(x + y);
    return replaces(op, x, y) ? v : cur;
  }
  if (op == OP_SUM)
    return static_cast<long long>(static_cast<unsigned long long>(cur) +
                                  static_cast<unsigned long long>(v));
  return op == OP_MIN ? (v < cur ? v : cur) : (v > cur ? v : cur);
}

// one element of a column, widened: bool and int32 to int64, float64 bits
__device__ __forceinline__ long long load1(const Col& c, long long i) {
  switch (c.dtype) {
    case DT_BOOL:
      return __ldg(static_cast<const unsigned char*>(c.ptr) + i);
    case DT_I32:
      return __ldg(static_cast<const int32_t*>(c.ptr) + i);
    default:
      return __ldg(static_cast<const long long*>(c.ptr) + i);
  }
}

// 4 consecutive elements from i, which is 4-aligned in a 16-byte-aligned
// array: one 16-byte load (int32), two (int64, float64) or 4 bytes (bool)
__device__ __forceinline__ void load4(const Col& c, long long i,
                                      long long v[4]) {
  switch (c.dtype) {
    case DT_BOOL: {
      const unsigned w = __ldg(reinterpret_cast<const unsigned*>(
          static_cast<const unsigned char*>(c.ptr) + i));
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = (w >> (8 * r)) & 0xff;
      break;
    }
    case DT_I32: {
      const int4 w = __ldg(reinterpret_cast<const int4*>(
          static_cast<const int32_t*>(c.ptr) + i));
      v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
      break;
    }
    default: {
      const longlong2* p = reinterpret_cast<const longlong2*>(
          static_cast<const long long*>(c.ptr) + i);
      const longlong2 a = __ldg(p), b = __ldg(p + 1);
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    }
  }
}

// Lanes with equal `peers` masks combine their x; the lowest lane of each
// peer set ends with the whole set's result. A fixed shuffle tree for a
// given peer set, so the result does not vary from run to run. Every lane
// of the warp calls it.
__device__ __forceinline__ long long reduce_peers(unsigned peers, long long x,
                                                  int op, int is_float) {
  const int lane = threadIdx.x & 31;
  int rel = __popc(peers & ((1u << lane) - 1u));  // rank among peers
  unsigned rest = peers & (0xfffffffeu << lane);  // peers above this lane
  while (__any_sync(FULL, rest)) {
    const int next = __ffs(rest);
    const long long t = __shfl_sync(FULL, x, (next - 1) & 31);
    if (next) x = combine(op, is_float, x, t);
    rest &= ~__ballot_sync(FULL, rel & 1);
    rel >>= 1;
  }
  return x;
}

__device__ __forceinline__ long long add64(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

// The rows of a step that share a group: row r joins the first row with
// its group. Nothing of it is indexed at run time, so it stays in registers.
struct Merge {
  bool d1, d2_0, d2_1, d3_0, d3_1, d3_2;  // row r joins the first row o
  bool keep[4];                            // rows left after the merge

  __device__ __forceinline__ explicit Merge(const int k[4]) {
    d1 = k[1] == k[0];
    d2_0 = k[2] == k[0];
    d2_1 = !d2_0 && k[2] == k[1];
    d3_0 = k[3] == k[0];
    d3_1 = !d3_0 && k[3] == k[1];
    d3_2 = !d3_0 && !d3_1 && k[3] == k[2];
    keep[0] = k[0] >= 0;
    keep[1] = k[1] >= 0 && !d1;
    keep[2] = k[2] >= 0 && !d2_0 && !d2_1;
    keep[3] = k[3] >= 0 && !d3_0 && !d3_1 && !d3_2;
  }

  // v[r] = the values of the rows that join row r, combined in a fixed
  // order
  __device__ __forceinline__ void fold(long long v[4], int op,
                                      int is_float) const {
    if (d1) v[0] = combine(op, is_float, v[0], v[1]);
    if (d2_0) v[0] = combine(op, is_float, v[0], v[2]);
    if (d2_1) v[1] = combine(op, is_float, v[1], v[2]);
    if (d3_0) v[0] = combine(op, is_float, v[0], v[3]);
    if (d3_1) v[1] = combine(op, is_float, v[1], v[3]);
    if (d3_2) v[2] = combine(op, is_float, v[2], v[3]);
  }
};

// The partials of one block and the per-segment values of constant jobs.
struct Ctx {
  const Table& t;
  long long* part;       // this warp's copy (PATH_LANE: + lane)
  const long long* cval; // [J] per-segment values of constant jobs
  long long seg;
};

// PATH_LANE, one job whose op and type are template constants: fold the
// 4 rows' values (x, or the job's per-segment constant when CONST) into
// this lane's slots. The rows are merged by group first, so the slots the
// job touches are distinct and their loads go out together.
template <int OP, bool FLOAT, bool CONST>
__device__ __forceinline__ void lane_job(const Ctx& cx, int j, const int k[4],
                                         const unsigned bits[4],
                                         const Merge& mg,
                                         const long long x[4]) {
  const Job& jb = cx.t.jobs[j];
  const int bit = jb.mask < 0 ? ALWAYS_BIT : jb.mask;
  long long v[4], cur[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    v[r] = ((bits[r] >> bit) & 1u) ? (CONST ? cx.cval[j] : x[r]) : jb.ident;
  mg.fold(v, OP, FLOAT);
  long long* base = cx.part + (j * cx.t.D << 5);
#pragma unroll
  for (int r = 0; r < 4; ++r) cur[r] = mg.keep[r] ? base[k[r] << 5] : 0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (mg.keep[r]) base[k[r] << 5] = combine(OP, FLOAT, cur[r], v[r]);
}

// PATH_LANE, any op: jobs [j0, j1), one at a time, each through the
// lane_job of its op and type. (Dispatching once per job keeps every
// combine a constant; taking several jobs' loads at once measured twice
// as slow as one job at a time.)
template <bool CONST>
__device__ __forceinline__ void lane_jobs(const Ctx& cx, int j0, int j1,
                                          const int k[4],
                                          const unsigned bits[4],
                                          const Merge& mg,
                                          const long long x[4]) {
  for (int j = j0; j < j1; ++j) {
    const Job& jb = cx.t.jobs[j];
    switch (jb.op * 2 + jb.is_float) {
      case OP_SUM * 2:
        lane_job<OP_SUM, false, CONST>(cx, j, k, bits, mg, x); break;
      case OP_SUM * 2 + 1:
        lane_job<OP_SUM, true, CONST>(cx, j, k, bits, mg, x); break;
      case OP_MIN * 2:
        lane_job<OP_MIN, false, CONST>(cx, j, k, bits, mg, x); break;
      case OP_MIN * 2 + 1:
        lane_job<OP_MIN, true, CONST>(cx, j, k, bits, mg, x); break;
      case OP_MAX * 2:
        lane_job<OP_MAX, false, CONST>(cx, j, k, bits, mg, x); break;
      default:
        lane_job<OP_MAX, true, CONST>(cx, j, k, bits, mg, x);
    }
  }
}

// PATH_WARP: fold job j's values for the 4 rows (k[r] < 0: no row) into
// this warp's copy, one update per distinct group per warp. Every lane of
// the warp calls it.
__device__ __forceinline__ void warp_update(const Ctx& cx, int j,
                                            const int k[4],
                                            const unsigned bits[4],
                                            const unsigned peers[4],
                                            const long long x[4]) {
  const Job& jb = cx.t.jobs[j];
  const int bit = jb.mask < 0 ? ALWAYS_BIT : jb.mask;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool live = k[r] >= 0 && ((bits[r] >> bit) & 1u);
    const long long v = reduce_peers(peers[r], live ? x[r] : jb.ident,
                                     jb.op, jb.is_float);
    if (k[r] >= 0 && lane == __ffs(peers[r]) - 1) {
      long long* p = cx.part + static_cast<long long>(j) * cx.t.D + k[r];
      *p = combine(jb.op, jb.is_float, *p, v);
    }
  }
}

// SUMS (PATH_LANE, every job an int64 sum, streamed column c feeding job
// c alone): the step's 4 rows are first merged by group in registers, so
// the rows left have distinct groups and every partial they touch is a
// distinct slot. Then all loads of those slots are issued together, then
// all stores: one shared-memory round trip per step instead of one per
// (row, job). Written with scalars and constant indices only, so nothing
// lands in local memory.
template <int NC>
__device__ __forceinline__ void sums_update(const Ctx& cx, const int k[4],
                                            const unsigned bits[4],
                                            const Merge& mg,
                                            long long (&x)[NC][4]) {
  const Table& t = cx.t;
  const int D = t.D;
  // NC == ncols here (the host picks it so): every loop unrolls fully
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int m = t.jobs[c].mask;
    const int bit = m < 0 ? ALWAYS_BIT : m;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      x[c][r] = ((bits[r] >> bit) & 1u) ? x[c][r] : 0;
    mg.fold(x[c], OP_SUM, 0);
  }
  long long cur[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cur[c][r] = mg.keep[r] ? cx.part[(c * D + k[r]) << 5] : 0;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (mg.keep[r]) cx.part[(c * D + k[r]) << 5] = add64(cur[c][r], x[c][r]);
  }
  for (int j = t.ncols; j < t.J; ++j) {     // counts, broadcast columns
    const int m = t.jobs[j].mask;
    const int bit = m < 0 ? ALWAYS_BIT : m;
    long long v[4], c4[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = ((bits[r] >> bit) & 1u) ? cx.cval[j] : 0;
    mg.fold(v, OP_SUM, 0);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      c4[r] = mg.keep[r] ? cx.part[(j * D + k[r]) << 5] : 0;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (mg.keep[r]) cx.part[(j * D + k[r]) << 5] = add64(c4[r], v[r]);
  }
}

// Up to NC columns from c0 for rows at.. (VEC: 4 rows, else 1) into x.
template <int NC, bool VEC>
__device__ __forceinline__ void load_cols(const Table& t, int c0, long long at,
                                          bool ok, long long x[NC][4]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    x[c][0] = x[c][1] = x[c][2] = x[c][3] = 0;
    if (ok && c0 + c < t.ncols) {
      if (VEC) load4(t.cols[c0 + c], at, x[c]);
      else x[c][0] = load1(t.cols[c0 + c], at);
    }
  }
}

// Rows row0..row0+3 of segment seg (VEC: 4-aligned, all four in range;
// else row0 alone, when ok) through every job. Every lane of a warp calls
// it on PATH_WARP. The loads of the gid, the first NC columns and the
// masks are all issued before any of them is used.
template <int NC, bool WARP_AGG, bool SUMS, bool VEC>
__device__ __forceinline__ void rows(const Ctx& cx, long long row0, bool ok) {
  const Table& t = cx.t;
  const long long at = cx.seg * t.n + row0;
  int k[4] = {-1, -1, -1, -1};
  unsigned bits[4];
  long long x[NC][4];
  if (ok) {
    if (VEC) {
      const int4 g = __ldg(reinterpret_cast<const int4*>(t.gid + at));
      k[0] = g.x; k[1] = g.y; k[2] = g.z; k[3] = g.w;
    } else {
      k[0] = __ldg(t.gid + at);
    }
  }
  load_cols<NC, VEC>(t, 0, at, ok, x);
#pragma unroll
  for (int r = 0; r < 4; ++r) bits[r] = 1u << ALWAYS_BIT;
  for (int m = 0; m < t.nmasks; ++m) {
    const Col& mc = t.masks[m];
    long long w[4] = {0, 0, 0, 0};
    if (mc.bcast) {
      w[0] = w[1] = w[2] = w[3] = load1(mc, cx.seg * mc.seg_stride);
    } else if (ok) {
      if (VEC) load4(mc, at, w);
      else w[0] = load1(mc, at);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      bits[r] |= static_cast<unsigned>(w[r] & 1) << m;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (static_cast<unsigned>(k[r]) >= static_cast<unsigned>(t.D)) k[r] = -1;
  const Merge mg(k);
  if (SUMS) {
    sums_update<NC>(cx, k, bits, mg, x);
    return;
  }
  if (!WARP_AGG) {
    for (int c0 = 0; c0 < t.ncols; c0 += NC) {
      if (c0 > 0) load_cols<NC, VEC>(t, c0, at, ok, x);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (c0 + c < t.ncols)
          lane_jobs<false>(cx, t.col_begin[c0 + c], t.col_begin[c0 + c + 1],
                           k, bits, mg, x[c]);
    }
    lane_jobs<true>(cx, t.col_begin[t.ncols], t.J, k, bits, mg, x[0]);
    return;
  }
  unsigned peers[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) peers[r] = __match_any_sync(FULL, k[r]);
  for (int c0 = 0; c0 < t.ncols; c0 += NC) {
    if (c0 > 0) load_cols<NC, VEC>(t, c0, at, ok, x);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c0 + c < t.ncols) {
        for (int j = t.col_begin[c0 + c]; j < t.col_begin[c0 + c + 1]; ++j)
          warp_update(cx, j, k, bits, peers, x[c]);
      }
    }
  }
  for (int j = t.col_begin[t.ncols]; j < t.J; ++j) {
    const long long v = cx.cval[j];
    const long long xs[4] = {v, v, v, v};
    warp_update(cx, j, k, bits, peers, xs);
  }
}

// Stage 1: grid (blocks, nseg). Each block walks its segment's aligned
// 4-row quads with a warp-uniform grid-strided loop, then folds its
// partials in a fixed order into ws[seg, blockIdx.x].
template <int NC, bool WARP_AGG, bool SUMS>
__global__ void __launch_bounds__(MAX_THREADS)
    fused_dense_agg_kernel(const __grid_constant__ Table t, long long* ws) {
  extern __shared__ long long part[];  // PATH_LANE [W][J*D][32], else [W][J*D]
  __shared__ long long cval[MAX_JOBS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = blockDim.x >> 5;
  const int JD = t.J * t.D;
  const int slot = WARP_AGG ? 1 : 32;
  const long long seg = blockIdx.y;

  for (int i = tid; i < W * JD * slot; i += blockDim.x)
    part[i] = t.jobs[(i / slot) % JD / t.D].ident;
  for (int j = t.col_begin[t.ncols] + tid; j < t.J; j += blockDim.x) {
    const int c = t.jobs[j].col;
    cval[j] = c < 0 ? 1 : load1(t.cols[c], seg * t.cols[c].seg_stride);
  }
  __syncthreads();

  const Ctx cx{t, part + static_cast<long long>(warp) * JD * slot +
                      (WARP_AGG ? 0 : lane),
               cval, seg};
  const long long n = t.n;
  // rows [0, head) and [tail, n) lie outside the 16-byte-aligned quads
  const long long align = (4 - (seg * n) % 4) % 4;
  const long long head = align < n ? align : n;
  const long long nq = (n - head) / 4;
  const long long tail = head + 4 * nq;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long qb = static_cast<long long>(blockIdx.x) * blockDim.x +
                      warp * 32;
       qb < nq; qb += stride) {
    const long long q = qb + lane;
    rows<NC, WARP_AGG, SUMS, true>(cx, head + 4 * q, q < nq);
  }
  if (blockIdx.x == 0 && warp == 0) {
    const long long nscalar = head + (n - tail);
    const long long r = lane < head ? lane : tail + (lane - head);
    rows<NC, WARP_AGG, SUMS, false>(cx, r, lane < nscalar);
  }
  __syncthreads();

  long long* dst = ws + (seg * gridDim.x + blockIdx.x) * JD;
  if (!WARP_AGG) {
    // warp w folds entries w, w + W, ...: its lanes read one entry's 32
    // slots of every warp copy in order, then a fixed shuffle tree
    for (int e = warp; e < JD; e += W) {
      const Job& jb = t.jobs[e / t.D];
      long long acc = part[static_cast<long long>(e) * 32 + lane];
      for (int w = 1; w < W; ++w)
        acc = combine(jb.op, jb.is_float, acc,
                      part[(static_cast<long long>(w) * JD + e) * 32 + lane]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const long long o = __shfl_down_sync(FULL, acc, off);
        if (lane < off) acc = combine(jb.op, jb.is_float, acc, o);
      }
      if (lane == 0) dst[e] = acc;
    }
  } else {
    for (int e = tid; e < JD; e += blockDim.x) {
      const Job& jb = t.jobs[e / t.D];
      long long acc = part[e];
      for (int w = 1; w < W; ++w)
        acc = combine(jb.op, jb.is_float, acc,
                      part[static_cast<long long>(w) * JD + e]);
      dst[e] = acc;
    }
  }
}

// Stage 2: out[seg, e] = the fold of ws[seg, 0..blocks) in index order.
__global__ void fold_blocks_kernel(const __grid_constant__ Table t,
                                   const long long* __restrict__ ws,
                                   long long nseg, int blocks,
                                   long long* __restrict__ out) {
  const int JD = t.J * t.D;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= nseg * JD) return;
  const long long seg = i / JD;
  const int e = static_cast<int>(i % JD);
  const Job& jb = t.jobs[e / t.D];
  const long long* src = ws + seg * blocks * JD + e;
  long long acc = src[0];
  for (int b = 1; b < blocks; ++b)
    acc = combine(jb.op, jb.is_float, acc, src[static_cast<long long>(b) * JD]);
  out[i] = acc;
}

typedef void (*Stage1)(Table, long long*);

template <bool WARP_AGG, bool SUMS>
Stage1 pick_nc(int nc) {
  switch (nc) {
    case 1: return fused_dense_agg_kernel<1, WARP_AGG, SUMS>;
    case 2: return fused_dense_agg_kernel<2, WARP_AGG, SUMS>;
    case 3: return fused_dense_agg_kernel<3, WARP_AGG, SUMS>;
    case 4: return fused_dense_agg_kernel<4, WARP_AGG, SUMS>;
    case 5: return fused_dense_agg_kernel<5, WARP_AGG, SUMS>;
    case 6: return fused_dense_agg_kernel<6, WARP_AGG, SUMS>;
    case 7: return fused_dense_agg_kernel<7, WARP_AGG, SUMS>;
    default: return fused_dense_agg_kernel<8, WARP_AGG, SUMS>;
  }
}

// The stage-1 instantiation for this table and path: NC = the streamed
// columns, up to 8 in flight; SUMS when every job is an int64 sum and each
// streamed column feeds exactly one job.
Stage1 pick(const Table& t, int path) {
  const int nc = t.ncols < 1 ? 1 : (t.ncols > 8 ? 8 : t.ncols);
  if (path != PATH_LANE) return pick_nc<true, false>(nc);
  bool sums = t.ncols >= 1 && t.ncols <= 8;
  for (int j = 0; j < t.J; ++j)
    sums = sums && t.jobs[j].op == OP_SUM && !t.jobs[j].is_float;
  for (int c = 0; c <= t.ncols; ++c) sums = sums && t.col_begin[c] == c;
  return sums ? pick_nc<false, true>(nc) : pick_nc<false, false>(nc);
}

bool valid(const Table& t, int path, int threads, long long smem) {
  return t.J >= 1 && t.J <= MAX_JOBS && t.D >= 1 && t.ncols >= 0 &&
         t.ncols <= MAX_COLS && t.nmasks >= 0 && t.nmasks <= MAX_MASKS &&
         threads >= 32 && threads <= MAX_THREADS && threads % 32 == 0 &&
         smem >= 0 && (path == PATH_LANE || path == 1);
}

cudaError_t prepare(Stage1 k, long long smem) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" int ggt_fused_dense_agg_table_bytes() {
  return static_cast<int>(sizeof(Table));
}

// `table` points to a Table (ops/fused_agg.py::_Table). Resident stage-1
// blocks per SM for this table, path, block size and dynamic shared
// memory -> *blocks. Returns a cudaError_t (0 = success).
extern "C" int ggt_fused_dense_agg_occupancy(const void* table, int path,
                                             int threads, long long smem,
                                             int* blocks) {
  const Table* t = static_cast<const Table*>(table);
  if (!valid(*t, path, threads, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const Stage1 k = pick(*t, path);
  cudaError_t err = prepare(k, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, reinterpret_cast<const void*>(k), threads,
        static_cast<size_t>(smem));
  return static_cast<int>(err);
}

// Launches stage 1 on grid (blocks, nseg) and stage 2 on `stream`; returns
// the first cudaGetLastError() that is not 0, else 0. ws: int64 [nseg,
// blocks, J, D]; out: int64 [nseg, J, D] (float64 jobs hold bits).
extern "C" int ggt_fused_dense_agg(const void* table, long long nseg, void* ws,
                                   void* out, int blocks, int threads,
                                   int path, long long smem, void* stream) {
  const Table* t = static_cast<const Table*>(table);
  if (!valid(*t, path, threads, smem) || nseg < 1 || nseg > 65535 ||
      blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Stage1 k = pick(*t, path);
  cudaError_t err = prepare(k, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Table tab = *t;
  long long* wsp = static_cast<long long*>(ws);
  void* args[] = {&tab, &wsp};
  cudaLaunchKernel(reinterpret_cast<const void*>(k),
                   dim3(blocks, static_cast<unsigned>(nseg)), dim3(threads),
                   args, static_cast<size_t>(smem), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = nseg * t->J * t->D;
  const int fold_threads = 256;
  fold_blocks_kernel<<<static_cast<unsigned>((total + fold_threads - 1) /
                                             fold_threads),
                       fold_threads, 0, s>>>(
      tab, static_cast<const long long*>(ws), nseg, blocks,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
