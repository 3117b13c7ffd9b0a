// Row-batched |x| histogram and the threshold mask for Hopper (sm_90a).
//
//   hist[n, b] = #{p < P : #{e < E : |x[n, p]| >= edges[n, e]} = b}
//
// x (N, P) fp32 with row stride ldx (any stride, any alignment), edges
// (N, E) fp32 contiguous, hist (N, E+1) int32 contiguous (zeroed here).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/sparsify.py
// (_hist_rows_kernel behind abs_histogram_rows, and through it the flat
// abs_histogram).  The TPU kernel walks each row in order with the
// histogram in VMEM, pads the row with +inf and subtracts the padding from
// the last bucket afterwards; blocks here run in parallel over (row, column
// range), count only the P real elements, and add their counts into the
// row's histogram with one global atomic per non-empty bucket.  Counts are
// integers, so the order of those atomics does not change the result.
//
// Bound: bytes (x read once).  The top-k threshold calls this twice per
// round on the same data: once on 128 log-spaced edges (the coarse pass:
// magnitudes spread over a hundred buckets) and once on 128 linear edges
// inside one coarse bin (the fine pass: most magnitudes fall below the
// first edge, in bucket 0).  The design:
// * the two end buckets cost two compares and a register: a < e[0] (or a
//   NaN) is bucket 0, a >= e[E-1] is bucket E; each thread counts them in
//   registers and adds them once per block, so the fine pass's bucket 0
//   and the coarse pass's extremes take no atomic;
// * a middle magnitude's bucket needs no branch: a start interpolated
//   between e[0] and e[E-1] (the float bits for log-spaced edges, a
//   piecewise-linear log2; the values for the others), then one compare
//   down and one up.  That is exact wherever the start lands within one
//   bucket, which each block checks for its row once its edges are in
//   shared memory (the start is monotone in a, so the two ends of each
//   bucket's interval suffice).  A row that fails the check takes a
//   binary search.  Without branches the compiler interleaves a thread's
//   elements; a search with loops ran them one after another (the sweep
//   in PERF.md).  The bucket is added with a shared atomic into the
//   histogram of its warp;
// * 16-byte loads (a per-row peel of up to 3 elements reaches the first
//   16-byte boundary, a tail of up to 3 follows the last), kUnroll of
//   them in flight per thread, at most 32 registers so that 2048 threads
//   fit on an SM;
// * the grid is sized from N and P: kWaves grids' worth of resident
//   blocks over the card, split evenly over the rows, each block at least
//   kMinVecs vectors, so that the flat N = 1 form runs hundreds of blocks;
// * a row whose edges are not non-decreasing (fine edges t0*(1-s) + t1*s
//   are two roundings and may step down by an ulp; each block checks its
//   own) counts the compare over every edge for each element instead,
//   exact for any edges.
// A NaN magnitude compares false with every edge and lands in bucket 0;
// the counts of a row sum to P.
//
// The threshold mask (threshold_mask_f32) keeps the entries with
// |x| >= t: vals[i] = x[i] where kept, else +0, and mask[i] = 1 where kept,
// else 0; a NaN is dropped.  x (M,) fp32, t one fp32 on the device (the
// threshold the histogram pass picked, so no host read sits between them),
// vals (M,) fp32, mask (M,) bytes.  Replaces _mask_kernel behind
// threshold_mask in src/repro/kernels/sparsify.py.
//
// Bound: bytes, 9 per element (x read, the values and the mask written)
// against a compare and a select.  A thread step takes one 4-element chunk:
// one 16-byte load of x, one 16-byte store of the values and one 4-byte
// store of four packed keep bytes, each a coalesced access of the warp and
// each with the streaming hint; the grid is one block per kThreads *
// kMaskVecs chunks, up to kMaskWaves grids of resident blocks (the whole
// state, 1024 nodes' P, is 579,555 blocks, under that cap), and the loop
// strides over any rest.  The threshold is read once per thread.  At one
// node's P (579,594 elements, 5.2 MB, 1.6 us at the memory rate) the time
// is the launch and one round trip to memory, where the kernel before it
// (one element a thread step, four steps a thread) made four.  Over the
// whole state, grids of 1 to 16 waves that loop, with 1 to 8 chunks a
// thread loaded before any store, were 6-17% slower than this grid, which
// is as fast as the kernel before it: many short blocks keep the addresses
// in flight at any moment in one narrow window of memory.  The hints took
// a tenth off the time at one node's P and changed at most 1% over the
// whole state (tools/ab_threshold_mask.py, PERF.md).
//
// Alignment: the values and the mask are the wrapper's own allocations,
// so the launcher takes them 16- and 4-byte aligned and refuses others
// (cudaErrorInvalidValue); the chunks start at element 0 and a tail of up
// to 3 elements follows them, one a thread.  x may start anywhere on 4
// bytes (a slice such as x[1:]); where it is not 16-byte aligned the chunks
// load x as four plain 4-byte words (the warp's four loads cover the same
// 512 bytes).
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;         // floats per load: 16 bytes
constexpr int kUnroll = 2;      // loads in flight per thread
constexpr int kMinBlocks = 2048 / kThreads;  // resident blocks per SM the registers allow
constexpr int kMinVecs = 512;   // least vectors a block counts (when P allows)
constexpr int kWaves = 8;       // the grid: kWaves x resident blocks of the card
constexpr int kMaxEdges = 1024;
constexpr int kMaskVecs = 1;      // threshold mask: 4-element chunks a thread step (all loads first)
constexpr int kMaskWaves = 1024;  // threshold mask: the grid, at most kMaskWaves x resident blocks

struct alignas(4 * kVec) Pack { float v[kVec]; };

// How a block finds the bucket of a magnitude of its row.
enum Mode {
  kLogStep,     // monotone edges, the log-domain start within one bucket: one step each way
  kLinearStep,  // the same with the linear start
  kSearch,      // other monotone edges: a binary search
  kCompareAll,  // edges that are not non-decreasing: the compare over every edge
};

// One row's edges (in shared memory) and the interpolation between its
// end edges e0 and eL.
struct Row {
  const float* e;
  int E;
  float e0, eL;
  uint32_t b0, scale;  // kLogStep: bits of e0, (E-1) 2^32 / (bits(eL) - bits(e0))
  float inv;           // kLinearStep: (E-1) / (eL - e0)
};

// The bucket a search starts from, in [1, E-1] and non-decreasing in a.
// kLogStep interpolates the float bits, a piecewise-linear log2 (within
// 0.09 of it); kLinearStep the values, truncated by an add of 2^23.
template <Mode M>
__device__ __forceinline__ int start(float a, const Row& r) {
  if constexpr (M == kLogStep) {
    const uint32_t b = 1u + __umulhi(__float_as_uint(a) - r.b0, r.scale);
    return static_cast<int>(min(b, static_cast<uint32_t>(r.E - 1)));
  } else {
    const float t = fminf(fmaxf(__fmaf_rn(__fsub_rn(a, r.e0), r.inv, 1.f), 1.f),
                          static_cast<float>(r.E - 1));
    return __float_as_int(__fadd_rz(t, 8388608.f)) - 0x4B000000;
  }
}

// Whether start<M> lands within one bucket of every magnitude's bucket:
// start is monotone, so the two ends of each bucket's interval
// [e[b-1], e[b]) suffice.  Each thread checks some buckets.
template <Mode M>
__device__ __forceinline__ bool start_within_one(const Row& r) {
  bool ok = true;
  for (int b = 1 + threadIdx.x; b < r.E; b += kThreads) {
    const float lo = fmaxf(r.e[b - 1], 0.f);
    if (r.e[b] > lo) {  // holds magnitudes; the largest of them is one ulp below e[b] > 0
      const float hi = __uint_as_float(__float_as_uint(r.e[b]) - 1u);
      ok = ok && start<M>(lo, r) >= b - 1 && start<M>(hi, r) <= b + 1;
    }
  }
  return ok;
}

// Counts one magnitude: the end buckets into c0 and cE, a middle one into
// the warp's histogram my.
template <Mode M>
__device__ __forceinline__ void count(float v, bool valid, const Row& r, int* my, int& c0,
                                      int& cE) {
  const float a = fabsf(v);
  if constexpr (M == kCompareAll) {
    int b = 0;
    for (int e = 0; e < r.E; ++e) b += (a >= r.e[e]) ? 1 : 0;
    if (valid) atomicAdd(&my[b], 1);
  } else {
    const bool lo = !(a >= r.e0), hi = a >= r.eL;  // a NaN is lo
    c0 += (valid && lo) ? 1 : 0;
    cE += (valid && !lo && hi) ? 1 : 0;
    const bool mid = valid && !lo && !hi;  // e0 <= a < eL: E >= 2, bucket in [1, E-1]
    int b;
    if constexpr (M == kSearch) {
      b = 0;
      for (int top = r.E; b < top;) {
        const int m = (b + top) >> 1;
        if (a >= r.e[m]) b = m + 1; else top = m;
      }
    } else {  // start within one bucket: one compare down, one up, no branch
      b = start<M>(a, r);
      b -= (a < r.e[b - 1]) ? 1 : 0;
      b += (a >= r.e[b]) ? 1 : 0;
    }
    if (mid) atomicAdd(&my[b], 1);
  }
}

// Columns of a row before its first (4 * kVec)-byte boundary, at most P.
__device__ __forceinline__ int64_t row_peel(const float* row, int64_t P) {
  const int64_t mis = static_cast<int64_t>((reinterpret_cast<uintptr_t>(row) / 4) % kVec);
  const int64_t h = (kVec - mis) % kVec;
  return h < P ? h : P;
}

// Block j of J counts vectors [V j / J, V (j+1) / J) of the row after its
// peel; block 0 also counts the peel, block J-1 the tail.
template <Mode M>
__device__ __forceinline__ void count_columns(const float* xr, int64_t P, int j, int J,
                                              const Row& r, int* my, int& c0, int& cE) {
  const int tid = threadIdx.x;
  const int64_t h = row_peel(xr, P);
  const int64_t V = (P - h) / kVec;        // vectors after the peel
  const int64_t tail = h + V * kVec;       // first column after them
  if (j == 0) count<M>(tid < h ? xr[tid] : 0.f, tid < h, r, my, c0, cE);
  if (j == J - 1) count<M>(tail + tid < P ? xr[tail + tid] : 0.f, tail + tid < P, r, my, c0, cE);
  const Pack* xv = reinterpret_cast<const Pack*>(xr + h);
  const int64_t v1 = V * (j + 1) / J;
  for (int64_t base = V * j / J; base < v1; base += static_cast<int64_t>(kUnroll) * kThreads) {
    Pack buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = base + u * kThreads + tid;
      buf[u] = v < v1 ? xv[v] : Pack{};
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = base + u * kThreads + tid < v1;
#pragma unroll
      for (int i = 0; i < kVec; ++i) count<M>(buf[u].v[i], valid, r, my, c0, cE);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
abs_histogram_rows_kernel(const float* __restrict__ x, int64_t ldx, int64_t P,
                          const float* __restrict__ edges, int E, int J,
                          int* __restrict__ hist) {
  extern __shared__ float smem[];
  float* s_e = smem;                                // [E]
  int* s_h = reinterpret_cast<int*>(smem + E);      // [kWarps][E + 1]
  const int64_t n = blockIdx.x / J;
  const int j = static_cast<int>(blockIdx.x % J);
  const int B = E + 1;
  const int tid = threadIdx.x;
  for (int i = tid; i < E; i += kThreads) s_e[i] = edges[n * E + i];
  for (int i = tid; i < kWarps * B; i += kThreads) s_h[i] = 0;
  __syncthreads();
  bool ok = true;
  for (int i = tid + 1; i < E; i += kThreads) ok = ok && s_e[i] >= s_e[i - 1];
  const bool mono = __syncthreads_and(ok) != 0;  // (NaN edges: not monotone)

  Row r;
  r.e = s_e;
  r.E = E;
  // E = 0: every element is bucket 0 = bucket E; the +inf edges send it there
  r.e0 = E ? s_e[0] : INFINITY;
  r.eL = E ? s_e[E - 1] : INFINITY;
  // log-spaced edges, such as the coarse pass's: a normal e0 and eL > 2 e0,
  // so that bits(eL) - bits(e0) >= 2^23 and the scale below is under 2^19
  const bool lg = r.e0 >= FLT_MIN && r.eL > 2.f * r.e0;
  const uint32_t span = __float_as_uint(r.eL) - __float_as_uint(r.e0);
  r.b0 = __float_as_uint(r.e0);
  r.scale = lg ? static_cast<uint32_t>((static_cast<uint64_t>(E - 1) << 32) / span) : 0u;
  r.inv = static_cast<float>(E - 1) / (r.eL - r.e0);
  Mode mode = mono ? kSearch : kCompareAll;
  if (mono && E >= 2) {  // (E < 2 leaves no middle bucket to start in)
    const bool step = lg ? start_within_one<kLogStep>(r) : start_within_one<kLinearStep>(r);
    if (__syncthreads_and(step)) mode = lg ? kLogStep : kLinearStep;
  }

  int* my = s_h + (tid >> 5) * B;
  int c0 = 0, cE = 0;  // the end buckets of a monotone row, per thread
  const float* xr = x + n * ldx;
  switch (mode) {
    case kLogStep: count_columns<kLogStep>(xr, P, j, J, r, my, c0, cE); break;
    case kLinearStep: count_columns<kLinearStep>(xr, P, j, J, r, my, c0, cE); break;
    case kSearch: count_columns<kSearch>(xr, P, j, J, r, my, c0, cE); break;
    default: count_columns<kCompareAll>(xr, P, j, J, r, my, c0, cE); break;
  }
  c0 = __reduce_add_sync(0xffffffffu, c0);
  cE = __reduce_add_sync(0xffffffffu, cE);
  if ((tid & 31) == 0) {
    if (c0) atomicAdd(&my[0], c0);
    if (cE) atomicAdd(&my[E], cE);
  }
  __syncthreads();
  for (int i = tid; i < B; i += kThreads) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_h[w * B + i];
    if (sum) atomicAdd(&hist[n * B + i], sum);
  }
}

// The chunks' 16-byte loads and their stores, with the streaming hint
// (evict first: each byte is touched once).
__device__ __forceinline__ float4 load_x4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void store_vals4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void store_mask4(uint8_t* p, uint32_t w) {
  __stcs(reinterpret_cast<unsigned int*>(p), w);
}

// The V = M / 4 chunks, kMaskVecs a thread: chunk c = base + u kThreads of
// the block step at base; then elements [4 V, M) one a thread (kVecX: x is
// 16-byte aligned).
template <bool kVecX>
__global__ void __launch_bounds__(kThreads)
threshold_mask_kernel(const float* __restrict__ x, int64_t M, const float* __restrict__ t,
                      float* __restrict__ vals, uint8_t* __restrict__ mask) {
  const float th = *t;
  const int64_t V = M / kVec;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kMaskVecs;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kMaskVecs + threadIdx.x;
       base < V; base += step) {
    float4 in[kMaskVecs];
#pragma unroll
    for (int u = 0; u < kMaskVecs; ++u) {
      const int64_t c = base + static_cast<int64_t>(u) * kThreads;
      if (c < V) {
        if constexpr (kVecX) {
          in[u] = load_x4(x + c * kVec);
        } else {
          const float* p = x + c * kVec;
          in[u] = make_float4(p[0], p[1], p[2], p[3]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kMaskVecs; ++u) {
      const int64_t c = base + static_cast<int64_t>(u) * kThreads;
      if (c < V) {
        const float e[kVec] = {in[u].x, in[u].y, in[u].z, in[u].w};
        float o[kVec];
        uint32_t word = 0;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const bool keep = fabsf(e[k]) >= th;
          o[k] = keep ? e[k] : 0.f;
          word |= static_cast<uint32_t>(keep) << (8 * k);
        }
        store_vals4(vals + c * kVec, make_float4(o[0], o[1], o[2], o[3]));
        store_mask4(mask + c * kVec, word);
      }
    }
  }
  const int64_t i = V * kVec + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < M) {  // the tail: fewer than kVec elements, in the first block
    const float v = x[i];
    const bool keep = fabsf(v) >= th;
    vals[i] = keep ? v : 0.f;
    mask[i] = keep ? 1 : 0;
  }
}

// Blocks per row: kWaves grids of resident blocks (2048 threads per SM)
// over the rows, each block at least kMinVecs vectors.
int64_t blocks_per_row(int N, int64_t P) {
  const int64_t want = static_cast<int64_t>(kWaves) * (2048 / kThreads) * sm_count();
  const int64_t by_card = (want + N - 1) / N;
  const int64_t by_row = (P / kVec + kMinVecs - 1) / kMinVecs;
  int64_t J = by_card < by_row ? by_card : by_row;
  if (J < 1) J = 1;
  if (J * N > 0x7fffffff) J = 0x7fffffff / N;
  return J;
}

}  // namespace

extern "C" {

int abs_histogram_rows_f32(const void* x, long long ldx, int N, long long P,
                           const void* edges, int E, void* hist, void* stream) {
  if (N <= 0) return 0;
  if (E < 0 || E > kMaxEdges) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) * static_cast<size_t>(N) * (E + 1), s);
  if (err != cudaSuccess || P <= 0) return static_cast<int>(err);
  const int64_t J = blocks_per_row(N, P);
  const size_t smem = sizeof(float) * E + sizeof(int) * kWarps * (E + 1);
  abs_histogram_rows_kernel<<<static_cast<unsigned>(J * N), kThreads, smem, s>>>(
      static_cast<const float*>(x), ldx, P, static_cast<const float*>(edges), E,
      static_cast<int>(J), static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

int threshold_mask_f32(const void* x, long long M, const void* t, void* vals, void* mask,
                       void* stream) {
  if (M <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(vals) % 16 != 0 || reinterpret_cast<uintptr_t>(mask) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kMaskVecs;
  int64_t blocks = std::max<int64_t>((M / kVec + per_block - 1) / per_block, 1);
  const int64_t cap = static_cast<int64_t>(kMaskWaves) * (2048 / kThreads) * sm_count();
  if (blocks > cap) blocks = cap;  // the loop strides over the rest
  const dim3 grid(static_cast<unsigned>(blocks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* tp = static_cast<const float*>(t);
  auto* vp = static_cast<float*>(vals);
  auto* mp = static_cast<uint8_t*>(mask);
  if (vec_x)
    threshold_mask_kernel<true><<<grid, kThreads, 0, st>>>(xp, M, tp, vp, mp);
  else
    threshold_mask_kernel<false><<<grid, kThreads, 0, st>>>(xp, M, tp, vp, mp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
