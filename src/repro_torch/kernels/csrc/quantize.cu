// Per-row symmetric int8 codec for Hopper (sm_90a).
//
//   scale[r]    = max(max_c |x[r, c]| * fl(1/127), 1e-12)
//   codes[r, c] = clip(rint(x[r, c] / scale[r]), -127, 127)             (round)
//              or clip(floor(x[r, c] / scale[r] + noise[r, c]), ...)    (noise)
//   out[r, c]   = float(codes[r, c]) * scale[r]                         (dequantize)
//
// x (R, C) fp32 with row stride ldx, noise (R, C) fp32 with row stride ldn
// or null, codes (R, C) int8 with row stride ldc, scale (R,) fp32.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quantize.py
// (_q_kernel and _q_kernel_sr behind quantize, _dq_kernel behind
// dequantize).  The TPU kernel holds a whole row in VMEM and reads it once;
// a row of the sharing payload (C = 57,959 fp32, 232 KB) does not fit a
// block's shared memory here, so the quantize block reads its row twice:
// once for the absmax, once for the codes (the second read mostly from L2).
//
// Bound: bytes.  A few operations per element against 5 bytes moved.  One
// block per row: a strided absmax over the row, a warp-shuffle and
// shared-memory reduction, then the code pass.  Dequantize is one
// elementwise pass over a (row, column-chunk) grid.
//
// Bitwise parity with the reference as XLA compiles it: under jit XLA
// rewrites amax / 127 into amax * fl(1/127), the fp32 reciprocal, so the
// scale here is that product; x / scale stays an IEEE division (no
// --use_fast_math); rintf rounds half to even as jnp.round does; nothing
// here is contracted into a fused multiply-add.  A NaN propagates as in the
// reference: a row holding one gets a NaN scale (max and the 1e-12 floor
// keep the NaN, where fmaxf would drop it), and a NaN quotient becomes code
// 0, as XLA's float-to-int conversion makes it.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQThreads = 1024;
constexpr int kDqThreads = 256;
constexpr int kDqItems = 8;  // elements per thread per dequantize block
constexpr float kInv127 = 1.0f / 127.0f;  // rounded once, to fp32

// max that keeps a NaN of either operand (jnp.max, torch.amax).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b != b || b > a) ? b : a;
}

// clip(y, -127, 127) as int8; a NaN becomes 0.
__device__ __forceinline__ int8_t to_code(float y) {
  return y != y ? int8_t(0)
                : static_cast<int8_t>(static_cast<int>(fminf(fmaxf(y, -127.f), 127.f)));
}

__global__ void __launch_bounds__(kQThreads)
quantize_rows_kernel(const float* __restrict__ x, int64_t ldx,
                     const float* __restrict__ noise, int64_t ldn, int64_t C,
                     int8_t* __restrict__ codes, int64_t ldc,
                     float* __restrict__ scale) {
  __shared__ float s_max[kQThreads / 32];
  const int64_t r = blockIdx.x;
  const float* xr = x + r * ldx;
  float m = 0.f;
  for (int64_t c = threadIdx.x; c < C; c += blockDim.x) m = max_nan(m, fabsf(xr[c]));
  for (int off = 16; off > 0; off >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < (blockDim.x >> 5) ? s_max[threadIdx.x] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (threadIdx.x == 0) s_max[0] = max_nan(1e-12f, __fmul_rn(m, kInv127));
  }
  __syncthreads();
  const float s = s_max[0];
  if (threadIdx.x == 0) scale[r] = s;
  int8_t* cr = codes + r * ldc;
  if (noise == nullptr) {
    for (int64_t c = threadIdx.x; c < C; c += blockDim.x) {
      cr[c] = to_code(rintf(xr[c] / s));
    }
  } else {
    const float* nr = noise + r * ldn;
    for (int64_t c = threadIdx.x; c < C; c += blockDim.x) {
      cr[c] = to_code(floorf(__fadd_rn(xr[c] / s, nr[c])));
    }
  }
}

__global__ void __launch_bounds__(kDqThreads)
dequantize_rows_kernel(const int8_t* __restrict__ codes, int64_t ldc,
                       const float* __restrict__ scale, int64_t C,
                       float* __restrict__ out, int64_t ldo) {
  const int64_t r = blockIdx.x;
  const float s = scale[r];
  const int8_t* cr = codes + r * ldc;
  float* orow = out + r * ldo;
  const int64_t tile = static_cast<int64_t>(kDqThreads) * kDqItems;
  for (int64_t base = static_cast<int64_t>(blockIdx.y) * tile; base < C;
       base += static_cast<int64_t>(gridDim.y) * tile) {
#pragma unroll
    for (int i = 0; i < kDqItems; ++i) {
      const int64_t c = base + threadIdx.x + static_cast<int64_t>(i) * kDqThreads;
      if (c < C) orow[c] = __fmul_rn(static_cast<float>(cr[c]), s);
    }
  }
}

}  // namespace

extern "C" {

// noise may be null (round to nearest even); scale receives R floats.
int quantize_rows_f32(const void* x, long long ldx, const void* noise,
                      long long ldn, int R, long long C, void* codes,
                      long long ldc, void* scale, void* stream) {
  if (R <= 0) return 0;
  quantize_rows_kernel<<<R, kQThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ldx, static_cast<const float*>(noise), ldn,
      C, static_cast<int8_t*>(codes), ldc, static_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
}

int dequantize_rows_f32(const void* codes, long long ldc, const void* scale,
                        int R, long long C, void* out, long long ldo,
                        void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const int64_t tile = static_cast<int64_t>(kDqThreads) * kDqItems;
  int64_t tiles = (C + tile - 1) / tile;
  if (tiles > 65535) tiles = 65535;  // the column loop strides over the rest
  dim3 grid(static_cast<unsigned>(R), static_cast<unsigned>(tiles));
  dequantize_rows_kernel<<<grid, kDqThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), ldc, static_cast<const float*>(scale), C,
      static_cast<float*>(out), ldo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
