// Causal sliding-window flash attention for Hopper (sm_90a).
//
//   out[b, i, h, :] = softmax_j( q[b,i,h,:] . k[b,j,h/G,:] * D^-1/2 ) v[b,j,h/G,:]
//   over the keys i - window < j <= i, with G = H / Hkv query heads per KV
//   head; fp32 softmax and accumulation, output in the input dtype.
//
// q (B, S, H, D), k and v (B, S, Hkv, D), out (B, S, H, D), each with its
// own batch, position and head strides and unit stride over D, which is
// the layout attn_apply holds them in.  Each query head reads its KV head
// by h / G, so the reference's repeated and transposed copies of k, v and
// q (models/attention.py, the pallas_swa route) are never made.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/swa_attention.py
// (swa_attention, _kernel).  Like it, a block visits only the key tiles that
// meet (q - window, q] for its query tile, so the work is O(S * window),
// keeps the running (m, l, acc) state on chip, and masks with the finite
// -1e30 of the reference.  Blocks run longest query tile first.
//
// Bound: operations at long windows (2 * 2 * D flops per in-window (q, k)
// pair against each of q, k, v read once and out written once); bytes at
// short ones.  Two routes, chosen by the dtype (the wrapper's _route):
//
// * bf16, "mma" (swa_mma_kernel): the FlashAttention-2 design on the
//   tensor cores, whose bf16 rate (989 TFLOP/s dense) is the only way to the
//   operations bound.  A block of 4 warps takes one (b, h) and 128 query
//   rows (64 at head dim 128, where the registers allow one 16-row group
//   per warp), each warp 32 rows as two m16 row groups whose Q fragments
//   are loaded once (ldmatrix) and held in registers.  Key tiles of 64
//   keys stream through a two-stage ring of K and V tiles in dynamic
//   shared memory by 16-byte cp.async copies (zero-filled past S and past
//   D), rows XOR-swizzled so that ldmatrix reads are free of bank
//   conflicts; one barrier per tile, after which every warp is done with
//   the stage that the next tile's copies then fill.  S = Q K^T and O += P V are mma.sync m16n8k16 bf16 -> fp32,
//   K by ldmatrix.x4 and V by ldmatrix.x4.trans; P is the S accumulator
//   exponentiated (2^x on the SFU of one fused multiply-add of the raw
//   score, s D^-1/2 log2 e - m D^-1/2 log2 e) and rounded to bf16 in
//   registers (the accumulator layout of m16n8k16 is its A-fragment
//   layout), so P never goes to shared memory; O stays in fp32 registers.
//   The online softmax (running max m and sum l per row, row max by
//   __shfl_xor within the quad) is fp32.  Only tiles that cross the
//   causal diagonal or the window's lower edge are masked; a row whose
//   window holds no key of a tile skips it (p = 0, its m, l and O
//   unchanged), so no fully masked row enters the softmax, no inf - inf
//   arises, and nothing relies on a later alpha = 0.  A warp skips a tile
//   that no row of its own meets.  Rows or strides that are not 16-byte
//   aligned, or a head dim that is not a multiple of 8, load the same
//   tiles by plain loads instead of cp.async.
// * fp32, "simt" (swa_attention_kernel): plain fp32 FMAs, one query row
//   per thread (its q row and accumulator in registers), 128 rows per
//   block, key and value tiles converted to fp32 in shared memory and read
//   by every thread of the block at the same address (a broadcast, no bank
//   conflicts), 16 keys scored at once per thread for independent FMA
//   chains.  A row skips every 16-key group that lies wholly outside its
//   window.  Full fp32 numerics: it beats scaled_dot_product_attention in
//   fp32, where the tensor cores would round.
//
// The bf16 route holds 255 registers a thread, so 2 blocks (8 warps) fit
// on an SM: each scheduler has 2 warps to hide the latency of the chain
// ldmatrix -> mma -> softmax -> mma, and the tensor cores idle while a
// warp runs its softmax.  The next step (PERF.md) is wgmma with TMA loads
// and a producer warp, whose accumulators and asynchronous products free
// the registers and overlap the softmax with the products.  Plain C interface (loaded with ctypes); each entry point
// returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;          // query rows per block, one per thread
constexpr float kNegInf = -1e30f;   // the reference's mask value

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

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

// ---------------------------------------------------------------------------
// The bf16 route: mma.sync on the tensor cores.

// Tile shape, chosen on the card at the prefill shape (bf16, S 4096, D
// 64): 64-key tiles, 32 rows per warp, Q held in registers and 4 warps per
// block beat 128-key tiles of 16 rows per warp, 32-key tiles (with or
// without a register cap for 3 blocks per SM), Q reloaded from shared
// memory for each tile, 8 warps per block and a third stage.
constexpr int kWarps = 4;   // warps per block
constexpr int kKeys = 64;   // keys per K/V tile
constexpr int kStages = 2;  // K/V tiles in the ring

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, past L1; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c += a (16x16, row) b (16x8, col): bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU, subnormal results flushed to zero
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Offset, in 16-byte chunks, of chunk c of row r in a tile of rows of CH
// chunks.  The XOR sends the 8 rows that one ldmatrix phase reads at one
// column chunk to the 8 distinct 16-byte bank groups of a 128-byte line
// (rows of 64 bytes pair up in a line, hence r >> 1 at CH = 4).
template <int CH>
__device__ __forceinline__ int swizzle(int r, int c) {
  if constexpr (CH == 4) return r * CH + (c ^ ((r >> 1) & 3));
  else return r * CH + (c ^ (r & 7));
}

// Rows [r0, r0 + ROWS) of an (S, D) bf16 matrix with row stride ld into a
// swizzled (ROWS, DP) tile; rows past S and columns past D are zeros.
template <int DP, int ROWS, bool ALIGNED>
__device__ __forceinline__ void load_tile(uint8_t* tile, const bf16* src, int64_t ld, int r0,
                                          int S, int D) {
  constexpr int CH = DP / 8;
  static_assert(ROWS * CH % (kWarps * 32) == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / (kWarps * 32); ++i) {
    const int idx = static_cast<int>(threadIdx.x) + i * kWarps * 32;
    const int r = idx / CH, c = idx % CH, row = r0 + r;
    uint8_t* dst = tile + swizzle<CH>(r, c) * 16;
    if constexpr (ALIGNED) {  // D % 8 == 0: a chunk is wholly in or wholly out
      const bool ok = row < S && c * 8 < D;
      cp_async16(smem_addr(dst), ok ? src + static_cast<int64_t>(row) * ld + c * 8 : src,
                 ok ? 16 : 0);
    } else {
      alignas(16) bf16 buf[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int d = c * 8 + e;
        buf[e] = (row < S && d < D) ? src[static_cast<int64_t>(row) * ld + d]
                                    : __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(buf);
    }
  }
}

// The online softmax over one key tile's raw scores s (the S accumulator):
// the running max m (raw scores) and this thread's share l of each row's
// sum are updated, O is rescaled, and s becomes p = 2^((s - m) D^-1/2 log2 e).
// MASKED: the tile crosses the diagonal or the window's lower edge, so keys
// outside a row's window get -1e30 and a row that holds no key of the tile
// skips it (p = 0, its m, l and O unchanged).
template <bool MASKED, int MW, int NB, int DB>
__device__ __forceinline__ void online_softmax(float (&s)[MW][NB][4], float (&o)[MW][DB][4],
                                               float (&m)[MW][2], float (&l)[MW][2], int t0,
                                               int w0, int g, int tq, int window,
                                               float scale_log2) {
#pragma unroll
  for (int mg = 0; mg < MW; ++mg)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {  // rows g and g + 8 of the group
      const int row = w0 + mg * 16 + g + hr * 8;
      const bool any = !MASKED || (t0 <= row && t0 + kKeys - 1 > row - window);
      float mx = kNegInf;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (MASKED) {
            const int key = t0 + nb * 8 + tq * 2 + e;
            if (!(key <= row && key > row - window)) s[mg][nb][hr * 2 + e] = kNegInf;
          }
          mx = fmaxf(mx, s[mg][nb][hr * 2 + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = any ? fmaxf(m[mg][hr], mx) : m[mg][hr];
      const float alpha = any ? fast_exp2((m[mg][hr] - m_new) * scale_log2) : 1.f;
      const float shift = m_new * scale_log2;
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(fmaf(s[mg][nb][hr * 2 + e], scale_log2, -shift));
          s[mg][nb][hr * 2 + e] = any ? p : 0.f;
          sum += any ? p : 0.f;
        }
      l[mg][hr] = l[mg][hr] * alpha + sum;
      m[mg][hr] = m_new;
#pragma unroll
      for (int db = 0; db < DB; ++db) {
        o[mg][db][hr * 2] *= alpha;
        o[mg][db][hr * 2 + 1] *= alpha;
      }
    }
}

// DP: head dim rounded up to 32, 64 or 128; MW: m16 row groups per warp.
template <int DP, int MW, bool ALIGNED>
__global__ void __launch_bounds__(kWarps * 32)
swa_mma_kernel(const bf16* __restrict__ q, int64_t qb, int64_t qs, int64_t qh,
               const bf16* __restrict__ k, int64_t kb, int64_t ks, int64_t kh,
               const bf16* __restrict__ v, int64_t vb, int64_t vs, int64_t vh,
               bf16* __restrict__ out, int64_t ob, int64_t os, int64_t oh,
               int BH, int S, int H, int G, int D, int window, float scale_log2,
               bool out_pairs) {
  constexpr int CH = DP / 8;            // 16-byte chunks per row
  constexpr int BQ = kWarps * 16 * MW;  // query rows per block
  constexpr int KS = DP / 16;           // k16 steps of Q K^T
  constexpr int NB = kKeys / 8;         // n8 blocks of scores per tile
  constexpr int PS = kKeys / 16;        // k16 steps of P V
  constexpr int DB = DP / 8;            // n8 blocks of the output
  constexpr int TILE = kKeys * DP * 2;  // bytes of one K or V tile
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sq = smem;                   // the (BQ, DP) Q tile, then the ring:
  uint8_t* ring = smem + BQ * DP * 2;   // stage s holds K at 2 s TILE, V after it

  const int nq = (S + BQ - 1) / BQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / BH);  // longest tiles first
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H, h = bh % H, hk = h / G;
  const int q0 = qt * BQ;
  const int warp = static_cast<int>(threadIdx.x) >> 5, lane = static_cast<int>(threadIdx.x) & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row, column pair
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: which 8x8 matrix, which row
  const int w0 = q0 + warp * 16 * MW;       // the warp's rows [w0, wlast]
  const int wlast = w0 + 16 * MW - 1;

  const bf16* qp = q + b * qb + h * qh;
  const bf16* kp = k + b * kb + hk * kh;
  const bf16* vp = v + b * vb + hk * vh;
  const int hi = min(S, q0 + BQ);  // keys [lo, hi) meet the tile's windows
  const int lo = max(0, q0 - window + 1);
  const int t_first = (lo / kKeys) * kKeys;
  const int ntiles = (hi - t_first + kKeys - 1) / kKeys;

  // the ring's first kStages - 1 tiles (Q with the first), one group each
  load_tile<DP, BQ, ALIGNED>(sq, qp, qs, q0, S, D);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) {
      load_tile<DP, kKeys, ALIGNED>(ring + st * 2 * TILE, kp, ks, t_first + st * kKeys, S, D);
      load_tile<DP, kKeys, ALIGNED>(ring + st * 2 * TILE + TILE, vp, vs, t_first + st * kKeys,
                                    S, D);
    }
    cp_async_commit();
  }

  uint32_t qf[MW][KS][4];
  float o[MW][DB][4];
  float m[MW][2], l[MW][2];
#pragma unroll
  for (int mg = 0; mg < MW; ++mg) {
#pragma unroll
    for (int db = 0; db < DB; ++db)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mg][db][e] = 0.f;
    m[mg][0] = m[mg][1] = kNegInf;
    l[mg][0] = l[mg][1] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_first + it * kKeys;
    // tile it has landed once at most kStages - 2 newer groups are pending;
    // after the barrier every warp is also done with tile it - 1, whose
    // stage then takes tile it + kStages - 1: one barrier per tile
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int ahead = it + kStages - 1;
    if (ahead < ntiles) {
      uint8_t* nxt = ring + (ahead % kStages) * 2 * TILE;
      load_tile<DP, kKeys, ALIGNED>(nxt, kp, ks, t_first + ahead * kKeys, S, D);
      load_tile<DP, kKeys, ALIGNED>(nxt + TILE, vp, vs, t_first + ahead * kKeys, S, D);
    }
    cp_async_commit();
    if (it == 0) {  // the warp's Q fragments, held for the whole row tile
#pragma unroll
      for (int mg = 0; mg < MW; ++mg)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int r = warp * 16 * MW + mg * 16 + lr + (lm & 1) * 8;
          ldmatrix_x4(qf[mg][kk], smem_addr(sq) + swizzle<CH>(r, kk * 2 + (lm >> 1)) * 16);
        }
    }
    // the warp works on the tile only if some row of its own meets it
    if (t0 <= wlast && t0 + kKeys - 1 > w0 - window) {
      const uint32_t kt = smem_addr(ring + (it % kStages) * 2 * TILE);
      const uint32_t vt = kt + TILE;
      float s[MW][NB][4];
#pragma unroll
      for (int mg = 0; mg < MW; ++mg)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mg][nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int np = 0; np < NB / 2; ++np) {  // 16 keys: two n8 blocks
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + swizzle<CH>(np * 16 + lr + (lm >> 1) * 8, kk * 2 + (lm & 1)) * 16);
#pragma unroll
          for (int mg = 0; mg < MW; ++mg) {
            mma_bf16(s[mg][2 * np], qf[mg][kk], bk[0], bk[1]);
            mma_bf16(s[mg][2 * np + 1], qf[mg][kk], bk[2], bk[3]);
          }
        }
      // masks only where the tile crosses the diagonal or the window's edge
      if (t0 + kKeys - 1 <= w0 && t0 > wlast - window)
        online_softmax<false>(s, o, m, l, t0, w0, g, tq, window, scale_log2);
      else
        online_softmax<true>(s, o, m, l, t0, w0, g, tq, window, scale_log2);
      // the C layout of two n8 score blocks is the A layout of one k16 step
      uint32_t pf[MW][PS][4];
#pragma unroll
      for (int mg = 0; mg < MW; ++mg)
#pragma unroll
        for (int ps = 0; ps < PS; ++ps) {
          pf[mg][ps][0] = pack_bf16(s[mg][2 * ps][0], s[mg][2 * ps][1]);
          pf[mg][ps][1] = pack_bf16(s[mg][2 * ps][2], s[mg][2 * ps][3]);
          pf[mg][ps][2] = pack_bf16(s[mg][2 * ps + 1][0], s[mg][2 * ps + 1][1]);
          pf[mg][ps][3] = pack_bf16(s[mg][2 * ps + 1][2], s[mg][2 * ps + 1][3]);
        }
#pragma unroll
      for (int ps = 0; ps < PS; ++ps)
#pragma unroll
        for (int dp = 0; dp < DB / 2; ++dp) {  // 16 output columns: two n8 blocks
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vt + swizzle<CH>(ps * 16 + lr + (lm & 1) * 8, dp * 2 + (lm >> 1)) * 16);
#pragma unroll
          for (int mg = 0; mg < MW; ++mg) {
            mma_bf16(o[mg][2 * dp], pf[mg][ps], bv[0], bv[1]);
            mma_bf16(o[mg][2 * dp + 1], pf[mg][ps], bv[2], bv[3]);
          }
        }
    }
  }

#pragma unroll
  for (int mg = 0; mg < MW; ++mg)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float sum = l[mg][hr];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      const int row = w0 + mg * 16 + g + hr * 8;
      if (row >= S) continue;
      bf16* op = out + b * ob + static_cast<int64_t>(row) * os + h * oh;
#pragma unroll
      for (int db = 0; db < DB; ++db) {
        const int d = db * 8 + tq * 2;
        const float x0 = o[mg][db][hr * 2] * inv, x1 = o[mg][db][hr * 2 + 1] * inv;
        if (out_pairs) {  // D even, so d < D means d + 1 < D
          if (d < D) *reinterpret_cast<__nv_bfloat162*>(op + d) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (d < D) op[d] = __float2bfloat16(x0);
          if (d + 1 < D) op[d + 1] = __float2bfloat16(x1);
        }
      }
    }
}

template <int DP, int MW, bool ALIGNED>
int launch_mma(const bf16* q, int64_t qb, int64_t qs, int64_t qh,
               const bf16* k, int64_t kb, int64_t ks, int64_t kh,
               const bf16* v, int64_t vb, int64_t vs, int64_t vh,
               bf16* out, int64_t ob, int64_t os, int64_t oh,
               int B, int S, int H, int Hkv, int D, int window, float scale,
               cudaStream_t st) {
  constexpr int BQ = kWarps * 16 * MW;
  constexpr int smem = (BQ + 2 * kStages * kKeys) * DP * 2;
  auto kernel = swa_mma_kernel<DP, MW, ALIGNED>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int BH = B * H, nq = (S + BQ - 1) / BQ;
  const bool pairs = D % 2 == 0 && ob % 2 == 0 && os % 2 == 0 && oh % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const float log2e = 1.4426950408889634f;
  kernel<<<static_cast<unsigned>(nq) * static_cast<unsigned>(BH), kWarps * 32, smem, st>>>(
      q, qb, qs, qh, k, kb, ks, kh, v, vb, vs, vh, out, ob, os, oh, BH, S, H, H / Hkv, D,
      window, scale * log2e, pairs);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int MW>
int dispatch_mma(const void* q, int64_t qb, int64_t qs, int64_t qh,
                 const void* k, int64_t kb, int64_t ks, int64_t kh,
                 const void* v, int64_t vb, int64_t vs, int64_t vh,
                 void* out, int64_t ob, int64_t os, int64_t oh,
                 int B, int S, int H, int Hkv, int D, int window, float scale,
                 cudaStream_t st) {
  // cp.async needs each row chunk on a 16-byte boundary: bases and strides
  // multiples of 8 elements, D a multiple of 8
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool aligned = D % 8 == 0 && a16(q) && a16(k) && a16(v) && qb % 8 == 0 &&
                       qs % 8 == 0 && qh % 8 == 0 && kb % 8 == 0 && ks % 8 == 0 &&
                       kh % 8 == 0 && vb % 8 == 0 && vs % 8 == 0 && vh % 8 == 0;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  bf16* ot = static_cast<bf16*>(out);
  if (aligned)
    return launch_mma<DP, MW, true>(qt, qb, qs, qh, kt, kb, ks, kh, vt, vb, vs, vh, ot, ob,
                                    os, oh, B, S, H, Hkv, D, window, scale, st);
  return launch_mma<DP, MW, false>(qt, qb, qs, qh, kt, kb, ks, kh, vt, vb, vs, vh, ot, ob,
                                   os, oh, B, S, H, Hkv, D, window, scale, st);
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

// The bf16 route: the tensor-core kernel, same arguments as the fp32 entry.
extern "C" int swa_attention_bf16_mma(const void* q, int64_t qb, int64_t qs, int64_t qh,
                                      const void* k, int64_t kb, int64_t ks, int64_t kh,
                                      const void* v, int64_t vb, int64_t vs, int64_t vh,
                                      void* out, int64_t ob, int64_t os, int64_t oh, int B,
                                      int S, int H, int Hkv, int D, int window, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || D <= 0 || D > 128 || window <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWA_MMA(DP, MW)                                                                   \
  dispatch_mma<DP, MW>(q, qb, qs, qh, k, kb, ks, kh, v, vb, vs, vh, out, ob, os, oh, B, S, \
                       H, Hkv, D, window, scale, st)
  if (D <= 32) return SWA_MMA(32, 2);
  if (D <= 64) return SWA_MMA(64, 2);
  return SWA_MMA(128, 1);  // 64 rows per block: O and Q of 32 rows would not fit in registers
#undef SWA_MMA
}
