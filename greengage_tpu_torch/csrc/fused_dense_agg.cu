// Fused dense aggregation for Hopper (sm_90a) — one pass over the rows for
// every aggregate of a small-domain GROUP BY.
//
// Replaces the TPU kernel greengage_tpu/ops/fused_agg.py::_segment_reduce_fused
// (pl.pallas_call at fused_agg.py:157). For dense group ids gid[seg, r] in
// [0, D) and J jobs (values[seg, r], op in {sum, min, max}, identity), already
// masked or identity-filled by ops/agg.py::_run_aggs, it returns every job's
// per-(segment, group) result out[seg, j, g].
//
// What bounds it on an H100: device memory. It reads n * (4 + 8 * J) bytes
// once (TPC-H Q1 at SF10: 60M rows x 68 B = 4.1 GB, about 1.2 ms at
// 3.35 TB/s) and writes nseg * J * D * 8 bytes. The TPU version walks
// (64, 128)-row tiles in order and carries lane partials in VMEM from one
// grid step to the next; here blocks run in parallel and in no order, so:
//   - one launch covers every segment: grid (blocks_per_segment, nseg);
//   - each block walks its segment's rows with a grid-strided loop (adjacent
//     threads read adjacent rows of every column: coalesced loads) and masks
//     the ragged edge itself instead of padding with the identity;
//   - each warp group updates its own [J, D] copy of the partials in shared
//     memory with shared-memory atomics (up to `copies` copies per block,
//     8 B per entry), so warps of one block contend less;
//   - at the end the block folds its copies and adds one partial per
//     (job, group) into out[seg] with global atomics. The caller fills out
//     with each job's identity before the launch.
// Shared-atomic contention on few groups (Q1: D = 12, 6 of them live) is the
// expected limit of this simple design.
//
// Exactness: int64 wrapping addition, min and max are associative and
// commutative, so integer results are bit-identical whatever the order;
// float64 sums depend on the order of the atomics (relative 1e-12 on Q1-like
// magnitudes), float64 min/max do not. NaN propagates as in jnp.minimum.
//
// Jobs arrive as a device array of int64 words, J jobs:
//   meta[0, J)    value column base pointers ([nseg, n] contiguous, int64 or
//                 float64 elements)
//   meta[J, 2J)   identity (int64, or the bits of a float64)
//   meta[2J, 3J)  op | (is_float << 8), op 0 = sum, 1 = min, 2 = max
// so the J value columns are read in place, never stacked into a copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_SUM = 0;
constexpr int OP_MIN = 1;
constexpr int MAX_JOBS = 64;

__device__ __forceinline__ void atomic_update_i64(long long* p, int op,
                                                  long long v) {
  if (op == OP_SUM) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p),
              static_cast<unsigned long long>(v));
  } else if (op == OP_MIN) {
    atomicMin(p, v);
  } else {
    atomicMax(p, v);
  }
}

__device__ __forceinline__ bool replaces(int op, double cur, double v) {
  if (cur != cur) return false;             // NaN already won
  if (v != v) return true;                  // NaN propagates
  return op == OP_MIN ? v < cur : v > cur;
}

__device__ __forceinline__ void atomic_update_f64(double* p, int op,
                                                  double v) {
  if (op == OP_SUM) {
    atomicAdd(p, v);
    return;
  }
  unsigned long long* a = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *a;
  while (replaces(op, __longlong_as_double(static_cast<long long>(old)), v)) {
    const unsigned long long seen = atomicCAS(
        a, old, static_cast<unsigned long long>(__double_as_longlong(v)));
    if (seen == old) break;
    old = seen;
  }
}

__device__ __forceinline__ long long fold(int op, bool is_float, long long a,
                                          long long b) {
  if (is_float) {
    const double x = __longlong_as_double(a), y = __longlong_as_double(b);
    if (op == OP_SUM) return __double_as_longlong(x + y);
    return replaces(op, x, y) ? b : a;
  }
  if (op == OP_SUM)
    return static_cast<long long>(static_cast<unsigned long long>(a) +
                                  static_cast<unsigned long long>(b));
  return op == OP_MIN ? (b < a ? b : a) : (b > a ? b : a);
}

__global__ void fused_dense_agg_kernel(const int32_t* __restrict__ gid,
                                       long long n, int D,
                                       const long long* __restrict__ meta,
                                       int J, long long* __restrict__ out,
                                       int copies) {
  extern __shared__ long long partial[];    // [copies][J][D]
  __shared__ const char* col[MAX_JOBS];
  __shared__ int opf[MAX_JOBS];

  const int tid = threadIdx.x;
  const int per = J * D;
  for (int j = tid; j < J; j += blockDim.x) {
    col[j] = reinterpret_cast<const char*>(meta[j]);
    opf[j] = static_cast<int>(meta[2 * J + j]);
  }
  for (int i = tid; i < copies * per; i += blockDim.x)
    partial[i] = meta[J + (i % per) / D];
  __syncthreads();

  const long long seg = blockIdx.y;
  const long long base = seg * n;
  const int32_t* g = gid + base;
  long long* mine = partial + ((tid >> 5) % copies) * per;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
       r < n; r += stride) {
    const int k = g[r];
    if (static_cast<unsigned>(k) >= static_cast<unsigned>(D)) continue;
    for (int j = 0; j < J; ++j) {
      const int op = opf[j] & 0xff;
      long long* slot = mine + j * D + k;
      if (opf[j] >> 8) {
        const double v = reinterpret_cast<const double*>(col[j])[base + r];
        atomic_update_f64(reinterpret_cast<double*>(slot), op, v);
      } else {
        const long long v = reinterpret_cast<const long long*>(col[j])[base + r];
        atomic_update_i64(slot, op, v);
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < per; i += blockDim.x) {
    const int j = i / D;
    const int op = opf[j] & 0xff;
    const bool is_float = opf[j] >> 8;
    long long acc = partial[i];
    for (int c = 1; c < copies; ++c)
      acc = fold(op, is_float, acc, partial[c * per + i]);
    long long* dst = out + seg * per + i;
    if (is_float)
      atomic_update_f64(reinterpret_cast<double*>(dst), op,
                        __longlong_as_double(acc));
    else
      atomic_update_i64(dst, op, acc);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// gid: int32 [nseg, n]; meta: int64 [3 * J] on the device; out: int64
// [nseg, J, D] prefilled with each job's identity (float64 jobs hold bits).
extern "C" int ggt_fused_dense_agg(const void* gid, long long nseg,
                                   long long n, int D, const void* meta,
                                   int J, void* out, int blocks_per_segment,
                                   int threads, int copies, void* stream) {
  if (J < 1 || J > MAX_JOBS || D < 1 || nseg < 1 || copies < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(copies) * J * D * sizeof(long long);
  const dim3 grid(blocks_per_segment, static_cast<unsigned>(nseg));
  fused_dense_agg_kernel<<<grid, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gid), n, D,
      static_cast<const long long*>(meta), J, static_cast<long long*>(out),
      copies);
  return static_cast<int>(cudaGetLastError());
}
