// Causal sliding-window flash attention for Hopper (sm_90a).
//
//   out[b, i, h, :] = softmax_j( q[b,i,h,:] . k[b,j,h/G,:] * D^-1/2 ) v[b,j,h/G,:]
//   over the keys i - window < j <= i, with G = H / Hkv query heads per KV
//   head; fp32 scores, softmax and accumulation, output in the input dtype.
//
// q (B, S, H, D), k and v (B, S, Hkv, D), out (B, S, H, D): fp32 or bf16,
// each with its own batch, position and head strides and unit stride over
// D, which is the layout attn_apply holds them in.  Each query head reads
// its KV head by h / G, so the reference's repeated and transposed copies
// of k, v and q (models/attention.py, the pallas_swa route) are never made.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/swa_attention.py
// (swa_attention, _kernel).  Like it, a block visits only the key tiles that
// meet (q - window, q] for its query tile, so the work is O(S * window),
// keeps the running (m, l, acc) state on chip, and masks with the finite
// -1e30 of the reference.
//
// Bound: operations at long windows (2 * 2 * D flops per in-window (q, k)
// pair against each of q, k, v read once and out written once); bytes at
// short ones.  This first design is plain fp32 arithmetic, no tensor
// cores: one query row per thread (its q row and accumulator in
// registers), 128 rows per block, key and value tiles converted to fp32 in
// shared memory and read by every thread of the block at the same address
// (a broadcast, no bank conflicts), 16 keys scored at once per thread for
// independent FMA chains.  A row skips every 16-key group that lies wholly
// outside its window, so a fully masked group never enters the softmax and
// no inf - inf arises.  Blocks run longest query tile first.  Tensor-core
// products (mma / wgmma on bf16) and TMA loads are later work; PERF.md
// holds its time against the bound.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;          // query rows per block, one per thread
constexpr float kNegInf = -1e30f;   // the reference's mask value

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// DMAX: head dim rounded up to 32, 64 or 128 (q, acc and the tiles are
// zero-padded past D).  KEYS * DMAX fp32 is 16 KB per tile, 32 KB for k and v.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kRows)
swa_attention_kernel(const T* __restrict__ q, int64_t qb, int64_t qs, int64_t qh,
                     const T* __restrict__ k, int64_t kb, int64_t ks, int64_t kh,
                     const T* __restrict__ v, int64_t vb, int64_t vs, int64_t vh,
                     T* __restrict__ out, int64_t ob, int64_t os, int64_t oh,
                     int BH, int S, int H, int G, int D, int window, float scale) {
  constexpr int KEYS = 4096 / DMAX;
  constexpr int SUB = DMAX > 64 ? 8 : 16;
  __shared__ __align__(16) float sk[KEYS][DMAX];
  __shared__ __align__(16) float sv[KEYS][DMAX];

  const int nq = (S + kRows - 1) / kRows;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / BH);  // longest tiles first
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H, h = bh % H, hk = h / G;
  const int q0 = qt * kRows;
  const int row = q0 + static_cast<int>(threadIdx.x);
  const bool active = row < S;

  float qr[DMAX], acc[DMAX];
  const T* qp = q + b * qb + static_cast<int64_t>(active ? row : 0) * qs + h * qh;
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    qr[d] = (active && d < D) ? to_f32(qp[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const T* kp = k + b * kb + hk * kh;
  const T* vp = v + b * vb + hk * vh;
  const int hi = min(S, q0 + kRows);            // keys [lo, hi) meet the tile's windows
  const int lo = max(0, q0 - window + 1);
  for (int t = (lo / KEYS) * KEYS; t < hi; t += KEYS) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < KEYS * DMAX; idx += kRows) {
      const int j = idx / DMAX, d = idx % DMAX, key = t + j;
      const bool ok = key < S && d < D;
      sk[j][d] = ok ? to_f32(kp[static_cast<int64_t>(key) * ks + d]) : 0.f;
      sv[j][d] = ok ? to_f32(vp[static_cast<int64_t>(key) * vs + d]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < KEYS; j0 += SUB) {
      const int first = t + j0;
      // the whole group after the row, or at or before row - window: skip
      if (first > row || first + SUB - 1 <= row - window) continue;
      float s[SUB];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DMAX; ++d) dot = fmaf(qr[d], sk[j0 + jj][d], dot);
        const int key = first + jj;
        const bool in = key <= row && key > row - window;
        s[jj] = in ? dot * scale : kNegInf;
        mx = fmaxf(mx, s[jj]);
      }
      // at least one key of the group is in the window, so mx is a score
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);   // 0 when m is still -1e30
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int key = first + jj;
        const bool in = key <= row && key > row - window;
        s[jj] = in ? expf(s[jj] - m_new) : 0.f;
        psum += s[jj];
      }
      l = l * alpha + psum;
      m = m_new;
#pragma unroll
      for (int d = 0; d < DMAX; ++d) {
        float a = acc[d] * alpha;
#pragma unroll
        for (int jj = 0; jj < SUB; ++jj) a = fmaf(s[jj], sv[j0 + jj][d], a);
        acc[d] = a;
      }
    }
  }
  if (!active) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* op = out + b * ob + static_cast<int64_t>(row) * os + h * oh;
#pragma unroll
  for (int d = 0; d < DMAX; ++d)
    if (d < D) op[d] = from_f32<T>(acc[d] * inv);
}

template <typename T>
int launch(const void* q, int64_t qb, int64_t qs, int64_t qh,
           const void* k, int64_t kb, int64_t ks, int64_t kh,
           const void* v, int64_t vb, int64_t vs, int64_t vh,
           void* out, int64_t ob, int64_t os, int64_t oh,
           int B, int S, int H, int Hkv, int D, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || D <= 0 || D > 128 || window <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int BH = B * H, G = H / Hkv;
  const int nq = (S + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>(nq) * static_cast<unsigned>(BH));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
#define SWA_LAUNCH(DM)                                                              \
  swa_attention_kernel<T, DM><<<grid, kRows, 0, st>>>(                               \
      qt, qb, qs, qh, kt, kb, ks, kh, vt, vb, vs, vh, ot, ob, os, oh, BH, S, H, G, D, \
      window, scale)
  if (D <= 32) SWA_LAUNCH(32);
  else if (D <= 64) SWA_LAUNCH(64);
  else SWA_LAUNCH(128);
#undef SWA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SWA_ENTRY(NAME, T)                                                             \
  extern "C" int NAME(const void* q, int64_t qb, int64_t qs, int64_t qh,             \
                      const void* k, int64_t kb, int64_t ks, int64_t kh,             \
                      const void* v, int64_t vb, int64_t vs, int64_t vh,             \
                      void* out, int64_t ob, int64_t os, int64_t oh, int B, int S,   \
                      int H, int Hkv, int D, int window, float scale, void* stream) { \
    return launch<T>(q, qb, qs, qh, k, kb, ks, kh, v, vb, vs, vh, out, ob, os, oh, B, \
                     S, H, Hkv, D, window, scale, stream);                            \
  }

SWA_ENTRY(swa_attention_f32, float)
SWA_ENTRY(swa_attention_bf16, __nv_bfloat16)
