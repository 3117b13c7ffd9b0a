// Mamba2 SSD intra-chunk step for Hopper (sm_90a).
//
// Per chunk cell g and head h, over the L positions of the chunk:
//   y[g, i, h, :]  = sum_{j <= i} (C[g,i] . B[g,j]) exp(cum[g,i,h] - cum[g,j,h]) xdt[g,j,h,:]
//   state[g, h]    = sum_j (B[g,j] exp(cum[g,L-1,h] - cum[g,j,h]))^T xdt[g,j,h,:]   (N, P)
//   decay[g, h]    = exp(cum[g,L-1,h])
// all in fp32.  xdt (G, L, H, P), B and C (G, L, N) and cum (G, L, H) are
// read through their strides (unit stride over P and N), so the head-major
// copies the reference makes (kernels/ssd_chunk.py moves H next to G) are
// never built; y (G, L, H, P), state (G, H, N, P) and decay (G, H) are
// written contiguous.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_chunk.py
// (ssd_chunk, _kernel).  The TPU kernel holds a whole (L, L) score tile of
// one (g, h) cell in VMEM; at the published chunk L = 256 that tile alone is
// 256 KB of fp32, more than a block's 227 KB of shared memory.  Here one
// launch runs two kinds of block per (g, h): ceil(L / 64) "y" blocks, each
// for 64 rows i, which walk the 64-wide tiles of j <= i (scores C B^T times
// the decay into shared memory, then scores @ xdt into registers), and
// ceil(N / 64) "state" blocks, each for 64 state rows n, which walk all of
// j.  The decay exp(cum_i - cum_j) is taken only where j <= i: above the
// diagonal the difference is positive and exp could overflow to inf, and
// inf * 0 would be NaN, so the mask comes first, as the reference's where.
//
// Bound: operations at the published shapes (C B^T once per cell, L^2 N;
// the causal half of scores @ xdt, L^2 P / 2 per head; the state, L N P per
// head; two flops per multiply-add at the fp32 rate).  This first design
// recomputes C B^T for every head, as the TPU kernel does (n_groups = 1
// shares B and C across heads), and uses plain fp32 FMAs on a 16 x 16 grid
// of threads with 4 x (P/16) outputs each; no TF32, since the reference is
// fp32.  Sharing C B^T across heads and tensor-core products are later
// work; PERF.md holds its time against the bound.
//
// Plain C interface (loaded with ctypes); the entry point returns
// cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // rows i (y blocks), rows n (state blocks), keys j per tile
constexpr int kPad = kT + 1;    // row stride of the transposed tiles (no bank conflicts)
constexpr int kThreads = 256;   // 16 x 16

// PT: P columns per thread, P <= 16 * PT.
template <int PT>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ xdt, int64_t xg, int64_t xl, int64_t xh,
                 const float* __restrict__ Bm, int64_t bg, int64_t bl,
                 const float* __restrict__ Cm, int64_t cg, int64_t cl,
                 const float* __restrict__ cum, int64_t ug, int64_t ul, int64_t uh,
                 float* __restrict__ y, float* __restrict__ st, float* __restrict__ dec,
                 int H, int L, int N, int P, int nI) {
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.x / H, h = blockIdx.x % H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* xp = xdt + g * xg + h * xh;
  const float* bp = Bm + g * bg;
  const float* up = cum + g * ug + h * uh;

  float acc[4][PT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < PT; ++c) acc[r][c] = 0.f;

  if (static_cast<int>(blockIdx.y) < nI) {
    // ---- y rows [i0, i0 + 64) -------------------------------------------
    float* sC = smem;                 // [N][kPad]  C[i0 + i, n] at n * kPad + i
    float* sB = sC + N * kPad;        // [N][kPad]  B[j0 + j, n]
    float* sX = sB + N * kPad;        // [kT][P]    xdt[j0 + j, p]
    float* sS = sX + kT * P;          // [kT][kPad] scores (i, j)
    float* sCi = sS + kT * kPad;      // [kT] cum at the rows
    float* sCj = sCi + kT;            // [kT] cum at the keys
    const int i0 = blockIdx.y * kT;
    const float* cp = Cm + g * cg;
    for (int idx = threadIdx.x; idx < kT * N; idx += kThreads) {
      const int i = idx / N, n = idx % N;
      sC[n * kPad + i] = (i0 + i < L) ? cp[static_cast<int64_t>(i0 + i) * cl + n] : 0.f;
    }
    for (int i = threadIdx.x; i < kT; i += kThreads)
      sCi[i] = (i0 + i < L) ? up[static_cast<int64_t>(i0 + i) * ul] : 0.f;
    const int jend = min(L, i0 + kT);
    for (int j0 = 0; j0 < jend; j0 += kT) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < kT * N; idx += kThreads) {
        const int j = idx / N, n = idx % N;
        sB[n * kPad + j] = (j0 + j < L) ? bp[static_cast<int64_t>(j0 + j) * bl + n] : 0.f;
      }
      for (int idx = threadIdx.x; idx < kT * P; idx += kThreads) {
        const int j = idx / P, p = idx % P;
        sX[idx] = (j0 + j < L) ? xp[static_cast<int64_t>(j0 + j) * xl + p] : 0.f;
      }
      for (int j = threadIdx.x; j < kT; j += kThreads)
        sCj[j] = (j0 + j < L) ? up[static_cast<int64_t>(j0 + j) * ul] : 0.f;
      __syncthreads();
      // scores (i, j) = (C_i . B_j) exp(cum_i - cum_j) where j <= i, else 0
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float a[4], bb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = sC[n * kPad + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) bb[c] = sB[n * kPad + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bb[c], s[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int il = ty + 16 * r, jl = tx + 16 * c;
          const int i = i0 + il, j = j0 + jl;
          // mask first: above the diagonal cum_i - cum_j > 0 may overflow exp
          sS[il * kPad + jl] = (j <= i && i < L) ? s[r][c] * expf(sCi[il] - sCj[jl]) : 0.f;
        }
      __syncthreads();
      const int jn = min(kT, L - j0);
      for (int j = 0; j < jn; ++j) {
        float a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = sS[(ty + 16 * r) * kPad + j];
#pragma unroll
        for (int c = 0; c < PT; ++c) {
          const int p = tx + 16 * c;
          const float xv = p < P ? sX[j * P + p] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(a[r], xv, acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      if (i >= L) continue;
      float* yp = y + ((static_cast<int64_t>(g) * L + i) * H + h) * P;
#pragma unroll
      for (int c = 0; c < PT; ++c) {
        const int p = tx + 16 * c;
        if (p < P) yp[p] = acc[r][c];
      }
    }
    return;
  }

  // ---- state rows [n0, n0 + 64) and the chunk decay --------------------
  float* sBw = smem;               // [kT][kPad]  B[j0 + j, n0 + n] * exp(cum_last - cum_j)
  float* sX = sBw + kT * kPad;     // [kT][P]
  const int n0 = (blockIdx.y - nI) * kT;
  const float last = up[static_cast<int64_t>(L - 1) * ul];
  if (n0 == 0 && threadIdx.x == 0) dec[static_cast<int64_t>(g) * H + h] = expf(last);
  for (int j0 = 0; j0 < L; j0 += kT) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kT * kT; idx += kThreads) {
      const int j = idx / kT, n = idx % kT;
      float val = 0.f;
      if (j0 + j < L && n0 + n < N)
        val = bp[static_cast<int64_t>(j0 + j) * bl + n0 + n] *
              expf(last - up[static_cast<int64_t>(j0 + j) * ul]);
      sBw[j * kPad + n] = val;
    }
    for (int idx = threadIdx.x; idx < kT * P; idx += kThreads) {
      const int j = idx / P, p = idx % P;
      sX[idx] = (j0 + j < L) ? xp[static_cast<int64_t>(j0 + j) * xl + p] : 0.f;
    }
    __syncthreads();
    const int jn = min(kT, L - j0);
    for (int j = 0; j < jn; ++j) {
      float a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sBw[j * kPad + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < PT; ++c) {
        const int p = tx + 16 * c;
        const float xv = p < P ? sX[j * P + p] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(a[r], xv, acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + ty + 16 * r;
    if (n >= N) continue;
    float* sp = st + ((static_cast<int64_t>(g) * H + h) * N + n) * P;
#pragma unroll
    for (int c = 0; c < PT; ++c) {
      const int p = tx + 16 * c;
      if (p < P) sp[p] = acc[r][c];
    }
  }
}

template <int PT>
int launch(const float* xdt, int64_t xg, int64_t xl, int64_t xh, const float* Bm,
           int64_t bg, int64_t bl, const float* Cm, int64_t cg, int64_t cl,
           const float* cum, int64_t ug, int64_t ul, int64_t uh, float* y, float* st,
           float* dec, int G, int L, int H, int N, int P, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nI = (L + kT - 1) / kT, nN = (N + kT - 1) / kT;
  const dim3 grid(static_cast<unsigned>(G) * static_cast<unsigned>(H),
                  static_cast<unsigned>(nI + nN));
  ssd_chunk_kernel<PT><<<grid, kThreads, smem, stream>>>(
      xdt, xg, xl, xh, Bm, bg, bl, Cm, cg, cl, cum, ug, ul, uh, y, st, dec, H, L, N, P, nI);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the launch needs for (N, P), in bytes (0: P too wide).
extern "C" long long ssd_chunk_smem_bytes(int N, int P) {
  if (P <= 0 || P > 128 || N <= 0) return 0;
  const long long y_blk = 2LL * N * kPad + static_cast<long long>(kT) * P + kT * kPad + 2 * kT;
  const long long st_blk = static_cast<long long>(kT) * kPad + static_cast<long long>(kT) * P;
  return 4 * (y_blk > st_blk ? y_blk : st_blk);
}

extern "C" int ssd_chunk_f32(const float* xdt, int64_t xg, int64_t xl, int64_t xh,
                             const float* Bm, int64_t bg, int64_t bl, const float* Cm,
                             int64_t cg, int64_t cl, const float* cum, int64_t ug,
                             int64_t ul, int64_t uh, float* y, float* st, float* dec,
                             int G, int L, int H, int N, int P, void* stream) {
  const long long smem = ssd_chunk_smem_bytes(N, P);
  if (G <= 0 || L <= 0 || H <= 0 || smem == 0 || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  if (P <= 16) return launch<1>(xdt, xg, xl, xh, Bm, bg, bl, Cm, cg, cl, cum, ug, ul, uh, y, st, dec, G, L, H, N, P, sm, s);
  if (P <= 32) return launch<2>(xdt, xg, xl, xh, Bm, bg, bl, Cm, cg, cl, cum, ug, ul, uh, y, st, dec, G, L, H, N, P, sm, s);
  if (P <= 64) return launch<4>(xdt, xg, xl, xh, Bm, bg, bl, Cm, cg, cl, cum, ug, ul, uh, y, st, dec, G, L, H, N, P, sm, s);
  return launch<8>(xdt, xg, xl, xh, Bm, bg, bl, Cm, cg, cl, cum, ug, ul, uh, y, st, dec, G, L, H, N, P, sm, s);
}
