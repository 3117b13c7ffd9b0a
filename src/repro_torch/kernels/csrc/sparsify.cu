// Row-batched |x| histogram and the threshold mask for Hopper (sm_90a).
//
//   hist[n, b] = #{p < P : #{e < E : |x[n, p]| >= edges[n, e]} = b}
//
// x (N, P) fp32 with row stride ldx, edges (N, E) fp32 contiguous,
// monotone (N,) bytes (1 where the row's edges are non-decreasing),
// hist (N, E+1) int32 contiguous and zeroed by the caller.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/sparsify.py
// (_hist_rows_kernel behind abs_histogram_rows, and through it the flat
// abs_histogram).  The TPU kernel walks each row in order with the
// histogram in VMEM, pads the row with +inf and subtracts the padding from
// the last bucket afterwards; blocks here run in parallel over (row, column
// chunk), count only the P real elements, and add their counts into the
// row's histogram with one global atomic per non-empty bucket.  Counts are
// integers, so the order of those atomics does not change the result.
//
// Bound: bytes.  Each element is read once; its bucket costs a binary
// search over the row's edges in shared memory (log2(E+1) steps) and one
// shared-memory atomic into the histogram of its warp (one histogram per
// warp keeps the atomics of one hot bucket apart).
//
// Exactness: a binary search gives #{e : a >= edges[e]} only where the
// edges are non-decreasing.  Fine edges t0*(1-s) + t1*s are two roundings
// and may step down by an ulp, so a row whose edges are not monotone (the
// caller says which) counts the compare over every edge instead.  A NaN
// magnitude compares false with every edge and lands in bucket 0.
//
// The threshold mask (threshold_mask_f32) keeps the entries with
// |x| >= t: vals[i] = x[i] where kept, else +0, and mask[i] = 1 where kept,
// else 0; a NaN is dropped.  x (M,) fp32, t one fp32 on the device (the
// threshold the histogram pass picked, so no host read sits between them),
// vals (M,) fp32, mask (M,) bytes.  Replaces _mask_kernel behind
// threshold_mask in src/repro/kernels/sparsify.py.  Bound: bytes, 9 per
// element for a compare and a select.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 32;    // elements per thread per block
constexpr int kMaxEdges = 1024;
constexpr int kMaskItems = 4;  // elements per thread of the threshold mask

__global__ void __launch_bounds__(kThreads)
abs_histogram_rows_kernel(const float* __restrict__ x, int64_t ldx, int64_t P,
                          const float* __restrict__ edges, int E,
                          const uint8_t* __restrict__ monotone,
                          int* __restrict__ hist) {
  extern __shared__ float smem[];
  float* s_e = smem;                                // [E]
  int* s_h = reinterpret_cast<int*>(smem + E);      // [kWarps][E + 1]
  const int64_t n = blockIdx.x;
  const int B = E + 1;
  for (int i = threadIdx.x; i < E; i += blockDim.x) s_e[i] = edges[n * E + i];
  for (int i = threadIdx.x; i < kWarps * B; i += blockDim.x) s_h[i] = 0;
  __syncthreads();

  const bool mono = monotone[n] != 0;
  int* my = s_h + (threadIdx.x >> 5) * B;
  const float* xr = x + n * ldx;
  const int64_t chunk = static_cast<int64_t>(kThreads) * kItems;
  for (int64_t base = static_cast<int64_t>(blockIdx.y) * chunk; base < P;
       base += static_cast<int64_t>(gridDim.y) * chunk) {
    const int64_t end = base + chunk < P ? base + chunk : P;
    for (int64_t c = base + threadIdx.x; c < end; c += kThreads) {
      const float a = fabsf(xr[c]);
      int b = 0;
      if (mono) {
        int hi = E;
        while (b < hi) {
          const int mid = (b + hi) >> 1;
          if (a >= s_e[mid]) b = mid + 1; else hi = mid;
        }
      } else {
        for (int e = 0; e < E; ++e) b += (a >= s_e[e]) ? 1 : 0;
      }
      atomicAdd(&my[b], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_h[w * B + i];
    if (sum) atomicAdd(&hist[n * B + i], sum);
  }
}

__global__ void __launch_bounds__(kThreads)
threshold_mask_kernel(const float* __restrict__ x, int64_t M, const float* __restrict__ t,
                      float* __restrict__ vals, uint8_t* __restrict__ mask) {
  const float th = *t;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < M;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float v = x[i];
    const bool keep = fabsf(v) >= th;
    vals[i] = keep ? v : 0.f;
    mask[i] = keep ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int abs_histogram_rows_f32(const void* x, long long ldx, int N, long long P,
                           const void* edges, int E, const void* monotone,
                           void* hist, void* stream) {
  if (N <= 0 || P <= 0) return 0;
  if (E < 0 || E > kMaxEdges) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunk = static_cast<int64_t>(kThreads) * kItems;
  int64_t chunks = (P + chunk - 1) / chunk;
  if (chunks > 65535) chunks = 65535;  // the chunk loop strides over the rest
  const size_t smem = sizeof(float) * E + sizeof(int) * kWarps * (E + 1);
  dim3 grid(static_cast<unsigned>(N), static_cast<unsigned>(chunks));
  abs_histogram_rows_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ldx, P, static_cast<const float*>(edges), E,
      static_cast<const uint8_t*>(monotone), static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

int threshold_mask_f32(const void* x, long long M, const void* t, void* vals, void* mask,
                       void* stream) {
  if (M <= 0) return 0;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kMaskItems;
  int64_t blocks = (M + per_block - 1) / per_block;
  if (blocks > 1 << 20) blocks = 1 << 20;  // the loop strides over the rest
  threshold_mask_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), M, static_cast<const float*>(t),
      static_cast<float*>(vals), static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
