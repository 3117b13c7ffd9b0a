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
// dequantize).  The TPU kernel holds a whole row in VMEM and reads it once.
// A row of the sharing payload (C = 57,959 fp32, 232 KB) does not fit one
// block here, so a row goes to a thread-block cluster (Hopper): G blocks of
// kQThreads threads, G the least power of two up to kMaxCluster whose
// registers hold the row (kQVecs 4-column groups per thread: G = 8 at
// C = 57,959, about 29 values a thread).  Each block keeps its slice in
// registers, reduces its absmax, and the cluster combines the G block
// maxima over distributed shared memory; then each block writes its codes
// from the registers it read, packed four to a 32-bit word.  So x is read
// from device memory once.  A row longer than the cluster's registers hold
// (C > kMaxCluster * kQThreads * kQVecs * 4 = 65,536) reads the rest of
// its slice again in the code pass, from L2 where it stays there.
//
// Bound: bytes.  A few operations per element against 5 bytes moved (9
// with the noise); the IEEE division is the largest of them (a multiply
// in its place, wrong by construction, took a fifth off the time on an
// H100: PERF.md).  Loads and stores are 16 bytes (x, noise) and 4 bytes
// (codes) where every row's x, codes and noise reach those boundaries
// after the same peel of up to 3 columns (contiguous rows always do; the
// host checks the base addresses and row strides); otherwise the same
// arithmetic runs on single columns.
//
// Dequantize, bound by bytes too (one multiply against 5 bytes an
// element): contiguous rows, as every caller hands them, are one flat
// elementwise pass over the R * C elements, whatever C is, so rows as
// narrow as the cohort path's leaves (C = 2, 16, 32) fill the threads they
// launch.  A warp step takes 512 elements, each lane four chunks of 4
// (one 4-byte code load and one 16-byte store each, every access
// coalesced over the warp), on a grid of a few waves of resident blocks
// that strides over the rest; each chunk finds its row by one 32-bit
// division and steps to the next row's scale where a row ends.  Strided
// rows, and contiguous ones past 2^32 elements (17 GB of output, more
// than any path holds), keep a (row, column-chunk) grid of single columns.
//
// Bitwise parity with the reference as XLA compiles it: under jit XLA
// rewrites amax / 127 into amax * fl(1/127), the fp32 reciprocal, so the
// scale here is that product; x / scale stays an IEEE division (no
// --use_fast_math); rintf rounds half to even as jnp.round does; nothing
// here is contracted into a fused multiply-add.  A NaN propagates as in the
// reference: a row holding one gets a NaN scale (max and the 1e-12 floor
// keep the NaN, where fmaxf would drop it), and a NaN quotient becomes code
// 0, as XLA's float-to-int conversion makes it.  The absmax is exact in
// any order, so the cluster's order of reduction changes no bit.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after the launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kQThreads = 256;
constexpr int kQVecs = 8;        // 4-column groups a thread holds in registers
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kMaxColumns = 1 << 30;  // per row: in-row offsets are 32-bit
constexpr int kDqThreads = 256;
constexpr int kDqItems = 8;   // elements per thread per block of the strided dequantize
constexpr int kDqWarpStep = 512;  // flat dequantize: elements per warp step (16 a lane)
constexpr int kDqWaves = 4;   // flat dequantize: grids of resident blocks, at most
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

template <bool kNoise>
__device__ __forceinline__ int8_t code_of(float x, float s, float u) {
  return kNoise ? to_code(floorf(__fadd_rn(x / s, u))) : to_code(rintf(x / s));
}

// W consecutive columns, loaded with one access where W = 4.
template <int W> struct alignas(4 * W) Group { float v[W]; };

template <int W>
__device__ __forceinline__ void store_codes(int8_t* p, const int8_t (&c)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<uint32_t*>(p) =
        uint32_t(uint8_t(c[0])) | uint32_t(uint8_t(c[1])) << 8 |
        uint32_t(uint8_t(c[2])) << 16 | uint32_t(uint8_t(c[3])) << 24;
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) p[k] = c[k];
  }
}

template <int W, bool kNoise>
__device__ __forceinline__ void code_group(const Group<W>& g, const float* nr, float s,
                                           int8_t* cr) {
  Group<W> u{};
  if constexpr (kNoise) u = *reinterpret_cast<const Group<W>*>(nr);
  int8_t c[W];
#pragma unroll
  for (int k = 0; k < W; ++k) c[k] = code_of<kNoise>(g.v[k], s, u.v[k]);
  store_codes<W>(cr, c);
}

// Columns of a row before its first 16-byte boundary (fp32).
__device__ __forceinline__ int peel16(const float* p) {
  return static_cast<int>((4 - (reinterpret_cast<uintptr_t>(p) / 4) % 4) % 4);
}

// One row per cluster of G blocks.  With W = 4, columns [0, h) (x's peel
// to a 16-byte boundary, the same for codes' 4-byte and noise's 16-byte
// ones: the host checks) and [h + 4V, C) are single columns, one to each
// of the cluster's first threads, and the V 4-column groups between go to
// thread v mod S (S = G * kQThreads); with W = 1 every column is a group.
// The first kQVecs * 4 / W groups of a thread stay in registers from the
// absmax pass to the code pass; any further ones are read again.
template <int W, bool kNoise>
__global__ void __launch_bounds__(kQThreads)
quantize_rows_kernel(const float* __restrict__ x, int64_t ldx,
                     const float* __restrict__ noise, int64_t ldn, int C,
                     int8_t* __restrict__ codes, int64_t ldc,
                     float* __restrict__ scale) {
  constexpr int kSlots = kQVecs * 4 / W;
  __shared__ float s_warp[kQThreads / 32];
  __shared__ float s_block;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int64_t r = blockIdx.x / G;
  const float* xr = x + r * ldx;
  const float* nr = kNoise ? noise + r * ldn : nullptr;
  int8_t* cr = codes + r * ldc;
  const int h = W == 1 ? 0 : min(peel16(xr), C);
  const int tid = threadIdx.x;
  const int S = G * kQThreads;
  const int t = static_cast<int>(cluster.block_rank()) * kQThreads + tid;
  const int V = (C - h) / W, tail = h + V * W;
  const int sc = t < h ? t : tail + (t - h);   // this thread's single column
  const bool has_sc = t < h + (C - tail);
  const float* xw = xr + h;

  Group<W> reg[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int v = t + i * S;
    reg[i] = v < V ? *reinterpret_cast<const Group<W>*>(xw + v * W) : Group<W>{};
  }
  const float xs = has_sc ? xr[sc] : 0.f;
  float m = fabsf(xs);
#pragma unroll
  for (int i = 0; i < kSlots; ++i)
#pragma unroll
    for (int k = 0; k < W; ++k) m = max_nan(m, fabsf(reg[i].v[k]));
  for (int v = t + kSlots * S; v < V; v += S) {
    const Group<W> g = *reinterpret_cast<const Group<W>*>(xw + v * W);
#pragma unroll
    for (int k = 0; k < W; ++k) m = max_nan(m, fabsf(g.v[k]));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((tid & 31) == 0) s_warp[tid >> 5] = m;
  __syncthreads();
  if (tid < 32) {
    m = tid < kQThreads / 32 ? s_warp[tid] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (tid == 0) s_block = m;
  }
  cluster.sync();  // every block's maximum is in its shared memory
  m = 0.f;
  for (int b = 0; b < G; ++b) m = max_nan(m, *cluster.map_shared_rank(&s_block, b));
  // done reading the other blocks' shared memory; the wait before the
  // kernel returns keeps every block's alive until all have read it
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  const float s = max_nan(1e-12f, __fmul_rn(m, kInv127));
  if (t == 0) scale[r] = s;

  const float* nw = kNoise ? nr + h : nullptr;
  int8_t* cw = cr + h;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int v = t + i * S;
    if (v < V) code_group<W, kNoise>(reg[i], kNoise ? nw + v * W : nullptr, s, cw + v * W);
  }
  if (has_sc) cr[sc] = code_of<kNoise>(xs, s, kNoise ? nr[sc] : 0.f);
  for (int v = t + kSlots * S; v < V; v += S) {
    const Group<W> g = *reinterpret_cast<const Group<W>*>(xw + v * W);
    code_group<W, kNoise>(g, kNoise ? nw + v * W : nullptr, s, cw + v * W);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <int W, bool kNoise>
cudaError_t launch_quantize(const cudaLaunchConfig_t& cfg, const void* x, int64_t ldx,
                            const void* noise, int64_t ldn, int C, void* codes, int64_t ldc,
                            void* scale) {
  return cudaLaunchKernelEx(&cfg, quantize_rows_kernel<W, kNoise>,
                            static_cast<const float*>(x), ldx,
                            static_cast<const float*>(noise), ldn, C,
                            static_cast<int8_t*>(codes), ldc, static_cast<float*>(scale));
}

// Strided rows (a row stride other than C in codes or out), and R * C of
// 2^32 elements or more: one block per (row, column chunk), single columns.
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

// Division of flat indices below 2^32 by the row width C (1 <= C < 2^32),
// by an invariant-integer multiplier (the round-up method of Granlund and
// Montgomery: q = (t + ((i - t) >> s1)) >> s2, t = umulhi(m, i), exact for
// every 32-bit i).
struct RowDiv {
  int64_t C;
  uint32_t m;
  int s1, s2;
};

RowDiv row_div(int64_t C) {
  int l = 0;
  while ((int64_t{1} << l) < C) ++l;
  const uint32_t m =
      static_cast<uint32_t>(((uint64_t{1} << 32) * ((uint64_t{1} << l) - C)) / C + 1);
  return RowDiv{C, m, l < 1 ? l : 1, l > 1 ? l - 1 : 0};
}

__device__ __forceinline__ int64_t row_of(int64_t i, const RowDiv& d) {
  const uint32_t n = static_cast<uint32_t>(i), t = __umulhi(d.m, n);
  return (t + ((n - t) >> d.s1)) >> d.s2;
}

// Contiguous rows (ldc == ldo == C) as one flat pass over n = R * C < 2^32
// elements, whatever C is.  A warp step covers kDqWarpStep consecutive
// elements: lane l takes the 4-element chunks at l * 4 + j * 128 (j < 4),
// so each of its loads and stores is one coalesced access of the warp.
// With kVec (codes 4-byte and out 16-byte aligned: the host checks) a
// chunk is one 4-byte load of codes and one 16-byte store; without,
// single elements.  A chunk finds the row r of its first element by one
// division; for C >= 4 its elements lie in rows r and r + 1, split where
// column C is reached, otherwise each finds its own (at most 4 rows), all
// without a branch.  The tail (under kDqWarpStep elements) goes one
// element to a thread.
template <bool kVec>
__global__ void __launch_bounds__(kDqThreads)
dequantize_flat_kernel(const int8_t* __restrict__ codes, const float* __restrict__ scale,
                       RowDiv d, int64_t n, float* __restrict__ out) {
  constexpr int kChunks = kDqWarpStep / 128;
  const int64_t C = d.C;
  const int64_t steps = n / kDqWarpStep;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kDqThreads + threadIdx.x;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kDqThreads;
  for (int64_t i = steps * kDqWarpStep + t; i < n; i += threads)
    out[i] = __fmul_rn(static_cast<float>(codes[i]), __ldg(scale + row_of(i, d)));
  const int lane = threadIdx.x % 32;
  for (int64_t w = t / 32; w < steps; w += threads / 32) {
    const int64_t base = w * kDqWarpStep + lane * 4;
    int8_t q[kChunks][4];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int64_t i = base + j * 128;
      if constexpr (kVec) {
        const uint32_t word = *reinterpret_cast<const uint32_t*>(codes + i);
#pragma unroll
        for (int k = 0; k < 4; ++k) q[j][k] = static_cast<int8_t>(word >> (8 * k));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) q[j][k] = codes[i + k];
      }
    }
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int64_t i = base + j * 128;
      const int64_t r = row_of(i, d), c = i - r * C;
      float v[4];
      if (C >= 4) {  // rows r and r + 1 (r + 1 only if the chunk reaches it)
        const float s0 = __ldg(scale + r), s1 = __ldg(scale + r + (c + 3 >= C));
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = __fmul_rn(static_cast<float>(q[j][k]), c + k < C ? s0 : s1);
      } else {  // C = 1, 2, 3: element k's row is r + (c + k) / C
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int64_t rk = r + (c + k >= C) + (c + k >= 2 * C) + (c + k >= 3 * C);
          v[k] = __fmul_rn(static_cast<float>(q[j][k]), __ldg(scale + rk));
        }
      }
      if constexpr (kVec) {
        *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) out[i + k] = v[k];
      }
    }
  }
}

// Blocks per row: the least power of two up to kMaxCluster whose threads
// hold C columns in registers.
int cluster_size(int64_t C) {
  int G = 1;
  while (G < kMaxCluster && static_cast<int64_t>(G) * kQThreads * kQVecs * 4 < C) G *= 2;
  return G;
}

}  // namespace

extern "C" {

// noise may be null (round to nearest even); scale receives R floats.
// A row holds at most kMaxColumns columns.
int quantize_rows_f32(const void* x, long long ldx, const void* noise,
                      long long ldn, int R, long long C, void* codes,
                      long long ldc, void* scale, void* stream) {
  if (R <= 0) return 0;
  const int G = cluster_size(C);
  if (C < 0 || C > kMaxColumns || static_cast<int64_t>(R) * G > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(R * G));
  cfg.blockDim = dim3(kQThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = G;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // 16-byte groups where every row's x, codes (and noise) reach their 16-,
  // 4- (and 16-) byte boundaries after the same peel
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x) / 4;
  const bool vec = ((xa - reinterpret_cast<uintptr_t>(codes)) & 3) == 0 &&
                   (static_cast<uint64_t>(ldx - ldc) & 3) == 0 &&
                   (noise == nullptr ||
                    (((reinterpret_cast<uintptr_t>(noise) / 4 - xa) & 3) == 0 &&
                     (static_cast<uint64_t>(ldn - ldx) & 3) == 0));
  const int c = static_cast<int>(C);
  cudaError_t err;
  if (noise == nullptr)
    err = vec ? launch_quantize<4, false>(cfg, x, ldx, noise, ldn, c, codes, ldc, scale)
              : launch_quantize<1, false>(cfg, x, ldx, noise, ldn, c, codes, ldc, scale);
  else
    err = vec ? launch_quantize<4, true>(cfg, x, ldx, noise, ldn, c, codes, ldc, scale)
              : launch_quantize<1, true>(cfg, x, ldx, noise, ldn, c, codes, ldc, scale);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

int dequantize_rows_f32(const void* codes, long long ldc, const void* scale,
                        int R, long long C, void* out, long long ldo,
                        void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(R) * C;
  if (ldc == C && ldo == C && n < (int64_t{1} << 32)) {
    // one flat pass; 4-byte code loads and 16-byte stores where codes and
    // out are aligned to them (out, the wrapper's own, always is)
    const bool vec = reinterpret_cast<uintptr_t>(codes) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int64_t steps = n / kDqWarpStep;
    int64_t blocks = std::max<int64_t>(1, (steps + kDqThreads / 32 - 1) / (kDqThreads / 32));
    const int64_t cap = static_cast<int64_t>(kDqWaves) * (2048 / kDqThreads) * sm_count();
    if (blocks > cap) blocks = cap;  // the warp-step loop strides over the rest
    const dim3 grid(static_cast<unsigned>(blocks));
    const auto* c = static_cast<const int8_t*>(codes);
    const auto* s = static_cast<const float*>(scale);
    auto* o = static_cast<float*>(out);
    if (vec)
      dequantize_flat_kernel<true><<<grid, kDqThreads, 0, st>>>(c, s, row_div(C), n, o);
    else
      dequantize_flat_kernel<false><<<grid, kDqThreads, 0, st>>>(c, s, row_div(C), n, o);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t tile = static_cast<int64_t>(kDqThreads) * kDqItems;
  int64_t tiles = (C + tile - 1) / tile;
  if (tiles > 65535) tiles = 65535;  // the column loop strides over the rest
  dim3 grid(static_cast<unsigned>(R), static_cast<unsigned>(tiles));
  dequantize_rows_kernel<<<grid, kDqThreads, 0, st>>>(
      static_cast<const int8_t*>(codes), ldc, static_cast<const float*>(scale), C,
      static_cast<float*>(out), ldo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
