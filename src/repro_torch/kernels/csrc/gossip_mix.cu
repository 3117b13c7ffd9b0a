// Fused gather-merge gossip kernel for Hopper (sm_90a).
//
//   out[n, :] = sum_{k<K} w[n, k] * X[rows[n, k], :]
//
// X (R, P) fp32 or bf16 with row stride ldx, rows (N, K) int32, w (N, K)
// fp32; out (N, P) in X's dtype with row stride ldo.  Accumulates in fp32.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gossip_mix.py
// (_kernel_nodes behind gossip_mix_nodes, _kernel behind gossip_mix).  The
// TPU kernel reads a pre-built (N, 1+D, P) stack of operand rows; this one
// reads each operand row by index straight from device memory, so neither
// the stack nor the (N, D, P) gather of the reference's apply_W exists.
//
// Bound: bytes.  The work is 2*K flops per output element against at least
// one element read and one written: far under the card's ops-per-byte
// ridge.  The least traffic is X read once and out written once; a kernel
// that fetches every neighbour row from device memory moves about K times X
// instead, unless the L2 cache catches the reuse of a row by its
// neighbours.  So the design keeps as many bytes in flight as the card
// needs, at every N:
// * rows are read with the widest vector load that the row strides and
//   the base pointers allow (up to 16 bytes), with a masked tail where the
//   row length is not a multiple of the vector;
// * the grid is sized from N and P: each block takes one receiver and a
//   column tile of 256 threads x ITEMS vectors, ITEMS 4 (1024 vectors, the
//   N = 1024 engine merge's tile) shrunk to 2 or 1 until the grid puts at
//   least 4 blocks on each SM, so the N = 1 form fills the card too;
// * each thread loads its ITEMS vectors of one operand row before their
//   FMAs, slot by slot in a runtime loop over K (a variant with K <= 8 as
//   a template argument, all K rows' loads issued first, was 0.4% faster
//   at N = 1024 and within the spread at N = 1 on an H100, too little
//   for a second code path: PERF.md, tools/ab_gossip_mix.py);
// * the column loop's bound is the block's tile start, the same for every
//   thread (a per-thread bound made the N = 1024 merge measurably slower);
// * the K row ids and weights sit in shared memory; a null row table means
//   rows n*K + k (the stacked (N, K, M) and flat (K, M) forms), so their
//   wrappers build no index tensor.
// Accumulation is fp32 in slot order, as the twin adds.  Zero-weight
// padding slots are not skipped: 0 * x propagates a NaN or Inf row exactly
// as the reference does.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 64;   // operand slots per receiver

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V, int ITEMS>
__global__ void __launch_bounds__(kThreads)
gossip_mix_rows_kernel(const T* __restrict__ X, int64_t ldx,
                       const int32_t* __restrict__ rows,
                       const float* __restrict__ w, int K,
                       T* __restrict__ out, int64_t ldo, int64_t P) {
  __shared__ int64_t s_off[kMaxK];
  __shared__ float s_w[kMaxK];
  const int64_t n = blockIdx.x;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int64_t r = rows != nullptr ? static_cast<int64_t>(rows[n * K + k]) : n * K + k;
    s_off[k] = r * ldx;
    s_w[k] = w[n * K + k];
  }
  __syncthreads();

  using VT = Vec<T, V>;
  const int64_t groups = P / V;  // whole vectors; the P % V tail is below
  const int64_t tile = static_cast<int64_t>(kThreads) * ITEMS;
  VT* o = reinterpret_cast<VT*>(out + n * ldo);
  for (int64_t base = static_cast<int64_t>(blockIdx.y) * tile; base < groups;
       base += static_cast<int64_t>(gridDim.y) * tile) {
    float acc[ITEMS][V];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      const VT* x = reinterpret_cast<const VT*>(X + s_off[k]);
      const float wk = s_w[k];
      VT buf[ITEMS] = {};
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int64_t g = base + threadIdx.x + static_cast<int64_t>(i) * kThreads;
        if (g < groups) buf[i] = x[g];
      }
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[i][j] = fmaf(wk, to_f32(buf[i].v[j]), acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int64_t g = base + threadIdx.x + static_cast<int64_t>(i) * kThreads;
      if (g < groups) {
        VT r;
#pragma unroll
        for (int j = 0; j < V; ++j) r.v[j] = from_f32<T>(acc[i][j]);
        o[g] = r;
      }
    }
  }
  // masked tail: the last P % V columns, one scalar each, in column tile 0
  if (blockIdx.y == 0) {
    for (int64_t c = groups * V + threadIdx.x; c < P; c += blockDim.x) {
      float acc = 0.f;
      for (int k = 0; k < K; ++k) acc = fmaf(s_w[k], to_f32(X[s_off[k] + c]), acc);
      out[n * ldo + c] = from_f32<T>(acc);
    }
  }
}

template <typename T, int V, int ITEMS>
cudaError_t launch_tiles(const void* X, int64_t ldx, const void* rows, const void* w, int N,
                         int K, int64_t P, void* out, int64_t ldo, cudaStream_t stream) {
  const int64_t groups = P / V;
  const int64_t tile = static_cast<int64_t>(kThreads) * ITEMS;
  int64_t tiles = (groups + tile - 1) / tile;
  if (tiles < 1) tiles = 1;          // P < V: tile 0 runs the tail alone
  if (tiles > 65535) tiles = 65535;  // the column loop strides over the rest
  dim3 grid(static_cast<unsigned>(N), static_cast<unsigned>(tiles));
  gossip_mix_rows_kernel<T, V, ITEMS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(X), ldx, static_cast<const int32_t*>(rows),
      static_cast<const float*>(w), K, static_cast<T*>(out), ldo, P);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch(const void* X, int64_t ldx, const void* rows, const void* w,
                   int N, int K, int64_t P, void* out, int64_t ldo,
                   cudaStream_t stream) {
  // the largest column tile (up to 1024 vectors) that still gives the grid
  // at least 4 blocks per SM
  const int64_t groups = P / V, want = 4 * static_cast<int64_t>(sm_count());
  int items = 4;
  while (items > 1 && N * ((groups + kThreads * items - 1) / (kThreads * items)) < want)
    items /= 2;
  switch (items) {
    case 4: return launch_tiles<T, V, 4>(X, ldx, rows, w, N, K, P, out, ldo, stream);
    case 2: return launch_tiles<T, V, 2>(X, ldx, rows, w, N, K, P, out, ldo, stream);
    default: return launch_tiles<T, V, 1>(X, ldx, rows, w, N, K, P, out, ldo, stream);
  }
}

template <typename T, int VMAX>
int dispatch(const void* X, long long ldx, const void* rows, const void* w,
             int N, int K, long long P, void* out, long long ldo, int vec,
             void* stream) {
  if (N <= 0 || P <= 0) return 0;
  if (K <= 0 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 1: return static_cast<int>(launch<T, 1>(X, ldx, rows, w, N, K, P, out, ldo, s));
    case 2: return static_cast<int>(launch<T, 2>(X, ldx, rows, w, N, K, P, out, ldo, s));
    case 4: return static_cast<int>(launch<T, 4>(X, ldx, rows, w, N, K, P, out, ldo, s));
    case 8:
      if constexpr (VMAX >= 8)
        return static_cast<int>(launch<T, 8>(X, ldx, rows, w, N, K, P, out, ldo, s));
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// vec: elements per vector access, a power of two that divides ldx, ldo
// and both base pointers' element alignment (1, 2 or 4 for fp32; up to 8
// for bf16).  The caller chooses it.  rows may be null: rows n*K + k.
int gossip_mix_rows_f32(const void* X, long long ldx, const void* rows,
                        const void* w, int N, int K, long long P, void* out,
                        long long ldo, int vec, void* stream) {
  return dispatch<float, 4>(X, ldx, rows, w, N, K, P, out, ldo, vec, stream);
}

int gossip_mix_rows_bf16(const void* X, long long ldx, const void* rows,
                         const void* w, int N, int K, long long P, void* out,
                         long long ldo, int vec, void* stream) {
  return dispatch<__nv_bfloat16, 8>(X, ldx, rows, w, N, K, P, out, ldo, vec,
                                     stream);
}

}  // extern "C"
