// Mamba2 SSD intra-chunk step for Hopper (sm_90a).
//
// Per chunk cell g and head h, over the L positions of the chunk:
//   y[g, i, h, :]  = sum_{j <= i} (C[g,i] . B[g,j]) exp(cum[g,i,h] - cum[g,j,h]) xdt[g,j,h,:]
//   state[g, h]    = sum_j (B[g,j] exp(cum[g,L-1,h] - cum[g,j,h]))^T xdt[g,j,h,:]   (N, P)
//   decay[g, h]    = exp(cum[g,L-1,h])
// xdt (G, L, H, P), B and C (G, L, N) and cum (G, L, H) are read through
// their strides (unit stride over P and N), so the head-major copies the
// reference makes (kernels/ssd_chunk.py moves H next to G) are never built;
// y (G, L, H, P), state (G, H, N, P) and decay (G, H) are written
// contiguous.  L <= 256 (a 64-row tile's C.B^T row must fit shared memory).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_chunk.py
// (ssd_chunk, _kernel).  The TPU kernel holds a whole (L, L) score tile of
// one (g, h) cell in VMEM; at the published chunk L = 256 that tile alone is
// 256 KB of fp32, more than a block's 227 KB of shared memory.
//
// Design.  B and C are shared by every head (n_groups = 1), so C.B^T is too:
// one launch runs two kinds of block, heaviest first.
//  * "y" blocks own (g, a 64-row tile i, a group of up to 16 heads).  They
//    compute the causal tiles C_i.B_j^T (j <= i) once into shared memory,
//    then per head form S = C.B^T * exp(cum_i - cum_j) where j <= i (the
//    mask comes first: above the diagonal the difference is positive and
//    exp could overflow to inf) and accumulate y_h = S . xdt_h.
//  * "state" blocks own (g, 64 state rows n, a group of up to 16 heads) and
//    accumulate (B * exp(cum_L - cum))^T . xdt_h per head, B's rows held in
//    shared memory across the heads.
// A block walks its heads (and 64-column passes over P) as units; each
// unit's xdt tile and cum values stream into one of two shared buffers by
// cp.async while the other unit computes.  Warps: 4 groups of 16 rows x
// kSplit shares of the reduction steps, whose partial sums meet in shared
// memory.
//
// Products on the tensor cores at fp32 accuracy: mma.sync m16n8k8 with TF32
// operands, each fp32 operand split as x = hi + lo (both rounded to TF32,
// cvt.rna) and every product taken as lo*hi + hi*lo + hi*hi into fp32
// accumulators (3xTF32); the dropped lo*lo term and the rounding of lo
// leave about 2^-21 of each product.  Process-wide TF32 stays off: the
// split is explicit here.
//
// Bound: operations at the published shapes (C.B^T once per cell over
// j <= i, L^2 N / 2; the causal half of S . xdt, L^2 P / 2 per head; the
// state, L N P per head): at the fp32 rate, and at the TF32 tensor rate
// with three products per multiply-add; PERF.md holds both against the
// kernel's time.
//
// Plain C interface (loaded with ctypes); the entry point returns
// cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;            // rows per block: i (y blocks) or n (state blocks)
constexpr int kCols = 64;            // P columns per unit
constexpr int kMaxL = 256;
// 16 warps, the loops not unrolled: at the 128 registers a thread may then
// hold, the fastest of 8 or 16 warps, unrolled or not
// (tools/sweep_payload_ssd.py, PERF.md)
constexpr int kThreads = 512;
constexpr int kSplit = kThreads / 128;  // warps per 16-row group, each a share of the steps
// heads per block: of 4, 8 and 16, 16 was the fastest at the Mamba2-370M
// forward's shape (H 32: 384 blocks; tools/sweep_payload_ssd.py, PERF.md)
constexpr int kHeads = 16;
constexpr int kNc = 128;             // N per C.B^T chunk
// Row strides in floats, chosen so that every fragment read of a warp hits
// 32 distinct banks: 72 = 8 (mod 32) where lanes step rows by the thread's
// index in its quad, 260 and 132 = 4 (mod 32) where they step rows by its
// quad.
constexpr int kXs = kCols + 8;       // xdt tile [j][p]; state block's B [j][n]
constexpr int kCBs = kMaxL + 4;      // C.B^T tile [i][j]
constexpr int kKs = kNc + 4;         // C and B chunks [row][n]
// one unit's buffer: xdt tile, cum at the keys, cum at the rows, weights
constexpr int kBufX = kMaxL * kXs;
constexpr int kBuf = kBufX + kMaxL + kRows + kMaxL;
constexpr int kCB = kRows * kCBs;    // y blocks: C.B^T before the buffers
constexpr int kBh = kMaxL * kXs;     // state blocks: B before the buffers
constexpr int kSmemFloats = (kCB > kBh ? kCB : kBh) + 2 * kBuf;
static_assert(2 * kRows * kKs <= kBuf, "the C and B chunks fit one unit buffer");
static_assert((kSplit - 1) * kRows * kXs <= kBufX, "the partial sums fit one xdt tile");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (0..16) bytes; the rest of the 16 is zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

// Stage rows [0, rows) x columns [0, cols) of a strided fp32 matrix (element
// (r, c) at src + r * ld + c, valid for r < vr and c < vc) into shared
// memory with row stride lds; zeros elsewhere.  vec: 16-byte copies (src
// and ld 16-byte aligned, cols a multiple of 4).
__device__ void stage(float* dst, int lds, const float* src, int64_t ld, int rows, int cols,
                      int vr, int vc, bool vec) {
  if (vec) {
    const int nv = cols / 4;
    for (int q = threadIdx.x; q < rows * nv; q += kThreads) {
      const int r = q / nv, c = (q % nv) * 4;
      const int bytes = r < vr ? 4 * max(0, min(4, vc - c)) : 0;
      cp_async16(dst + r * lds + c, bytes ? src + r * ld + c : src, bytes);
    }
  } else {
    for (int q = threadIdx.x; q < rows * cols; q += kThreads) {
      const int r = q / cols, c = q % cols;
      const int bytes = (r < vr && c < vc) ? 4 : 0;
      cp_async4(dst + r * lds + c, bytes ? src + r * ld + c : src, bytes);
    }
  }
}

// x = hi + lo, both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b with fp32 operands as 3xTF32, the small products first: a is
// the m16n8k8 A fragment (rows g, g+8 x columns t, t+4 of the quad layout),
// split once and used against many B fragments, b0/b1 the B fragment (rows
// t, t+4 of column g).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

struct Args {
  const float* xdt; int64_t xg, xl, xh;
  const float* Bm; int64_t bg, bl;
  const float* Cm; int64_t cg, cl;
  const float* cum; int64_t ug, ul, uh;
  float* y; float* st; float* dec;
  int G, L, H, N, P;
  int vx, vb, vc;      // 16-byte copies of xdt, B, C
};

__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int nI = (a.L + kRows - 1) / kRows, nN = (a.N + kRows - 1) / kRows;
  const int hgroups = (a.H + kHeads - 1) / kHeads;
  const int passes = (a.P + kCols - 1) / kCols;

  // ---- which block: y blocks of the last i tile, state blocks, then the
  // other i tiles from heavy to light ----------------------------------------
  int b = blockIdx.x, it = -1, g, nh = 0, hgrp;
  const int ny = a.G * hgroups, ns = a.G * nN * hgroups;
  if (b < ny) {
    it = nI - 1;
  } else if (b < ny + ns) {
    b -= ny;
  } else {
    b -= ny + ns;
    it = nI - 2 - b / ny;
    b %= ny;
  }
  const bool state = it < 0;
  if (state) {
    g = b / (nN * hgroups);
    nh = (b / hgroups) % nN;
  } else {
    g = b / hgroups;
  }
  hgrp = b % hgroups;
  const int h0 = hgrp * kHeads, nheads = min(kHeads, a.H - h0);
  const int units = nheads * passes;
  // key rows a unit stages: j < 64 (it + 1) for a y block, all of L for a
  // state block (rows from L on are zeros)
  const int jrows = state ? ((a.L + 7) / 8) * 8 : kRows * (it + 1);
  const int r0 = state ? kRows * nh : kRows * it;   // the block's first row (n or i)

  float* fixed = smem;                                    // C.B^T (y) or B (state)
  float* bufs = smem + (kCB > kBh ? kCB : kBh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 3, kh = warp >> 2, gq = lane >> 2, tq = lane & 3;
  const int i0 = 16 * rg + gq, i1 = i0 + 8;              // the thread's two rows (local)

  auto prefetch = [&](int u) {
    float* buf = bufs + (u & 1) * kBuf;
    const int h = h0 + u / passes, p0 = kCols * (u % passes);
    stage(buf, kXs, a.xdt + g * a.xg + h * a.xh + p0, a.xl, jrows, kCols, a.L, a.P - p0,
          a.vx != 0);
    stage(buf + kBufX, 1, a.cum + g * a.ug + h * a.uh, a.ul, jrows, 1, a.L, 1, false);
    if (!state)
      stage(buf + kBufX + kMaxL, 1, a.cum + g * a.ug + r0 * a.ul + h * a.uh, a.ul, kRows, 1,
            a.L - r0, 1, false);
  };

  if (state)  // B's rows j and columns [r0, r0 + 64), for every head of the block
    stage(fixed, kXs, a.Bm + g * a.bg + r0, a.bl, jrows, kRows, a.L, a.N - r0, a.vb != 0);
  prefetch(0);
  cp_async_commit();

  if (!state) {
    // ---- C_i . B_j^T for j <= i: warp (rg, kh) takes the 8-column tiles
    // nt = kh, kh + kSplit, ... of each 64-key tile, as far as its rows reach
    float* Cs = bufs + kBuf;             // the second unit buffer, free until unit 1
    float* Bs = Cs + kRows * kKs;
    const int jlim = kRows * it + 16 * rg + 16;
    for (int n0 = 0; n0 < a.N; n0 += kNc) {
      const int nk = (min(kNc, a.N - n0) + 7) / 8;
      for (int jt = 0; jt <= it; ++jt) {
        __syncthreads();  // the chunks' last readers are done
        if (jt == 0)
          stage(Cs, kKs, a.Cm + g * a.cg + r0 * a.cl + n0, a.cl, kRows, kNc, a.L - r0,
                a.N - n0, a.vc != 0);
        stage(Bs, kKs, a.Bm + g * a.bg + (kRows * jt) * a.bl + n0, a.bl, kRows, kNc,
              a.L - kRows * jt, a.N - n0, a.vb != 0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        constexpr int kQ = 8 / kSplit;
        float acc[kQ][4] = {};
        for (int ks = 0; ks < nk; ++ks) {
          const int k0 = 8 * ks + tq;
          const float fa[4] = {Cs[i0 * kKs + k0], Cs[i1 * kKs + k0], Cs[i0 * kKs + k0 + 4],
                               Cs[i1 * kKs + k0 + 4]};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split(fa[e], ah[e], al[e]);
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const int nt = kh + kSplit * q;
            if (kRows * jt + 8 * nt >= jlim) continue;
            const float* br = Bs + (8 * nt + gq) * kKs + k0;
            mma3(acc[q], ah, al, br[0], br[4]);
          }
        }
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int nt = kh + kSplit * q;
          if (kRows * jt + 8 * nt >= jlim) continue;
          float* c0p = fixed + i0 * kCBs + kRows * jt + 8 * nt + 2 * tq;
          float* c1p = fixed + i1 * kCBs + kRows * jt + 8 * nt + 2 * tq;
          if (n0 == 0) {
            c0p[0] = acc[q][0]; c0p[1] = acc[q][1]; c1p[0] = acc[q][2]; c1p[1] = acc[q][3];
          } else {
            c0p[0] += acc[q][0]; c0p[1] += acc[q][1]; c1p[0] += acc[q][2]; c1p[1] += acc[q][3];
          }
        }
      }
    }
  }

  // ---- the units: per head (and 64-column pass), one product of the
  // block's 64 rows against the unit's xdt tile --------------------------
  for (int u = 0; u < units; ++u) {
    __syncthreads();  // the other buffer's last readers (or C.B^T's writers) are done
    if (u + 1 < units) prefetch(u + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* buf = bufs + (u & 1) * kBuf;
    const float* X = buf;
    const float* cumj = buf + kBufX;
    const int h = h0 + u / passes, p0 = kCols * (u % passes);
    float acc[8][4] = {};
    if (state) {
      float* wj = buf + kBufX + kMaxL + kRows;
      const float last = cumj[a.L - 1];
      for (int j = threadIdx.x; j < jrows; j += kThreads)
        wj[j] = j < a.L ? expf(last - cumj[j]) : 0.f;
      if (nh == 0 && p0 == 0 && threadIdx.x == 0)
        a.dec[static_cast<int64_t>(g) * a.H + h] = expf(last);
      __syncthreads();
      for (int ks = kh; ks < jrows / 8; ks += kSplit) {
        const int j0 = 8 * ks + tq, j1 = j0 + 4;
        const float fa[4] = {fixed[j0 * kXs + i0], fixed[j0 * kXs + i1], fixed[j1 * kXs + i0],
                             fixed[j1 * kXs + i1]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(fa[e], ah[e], al[e]);
        const float w0 = wj[j0], w1 = wj[j1];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mma3(acc[nt], ah, al, X[j0 * kXs + 8 * nt + gq] * w0, X[j1 * kXs + 8 * nt + gq] * w1);
      }
    } else {
      const float* cumi = buf + kBufX + kMaxL;
      const float ci0 = cumi[i0], ci1 = cumi[i1];
      const int ig0 = r0 + i0, ig1 = r0 + i1;
      const int nks = (r0 + 16 * rg + 16) / 8;
      for (int ks = kh; ks < nks; ks += kSplit) {
        const int j0 = 8 * ks + tq, j1 = j0 + 4;
        const float cj0 = cumj[j0], cj1 = cumj[j1];
        // mask before exp: above the diagonal cum_i - cum_j may overflow
        const float fa[4] = {
            j0 <= ig0 ? fixed[i0 * kCBs + j0] * expf(ci0 - cj0) : 0.f,
            j0 <= ig1 ? fixed[i1 * kCBs + j0] * expf(ci1 - cj0) : 0.f,
            j1 <= ig0 ? fixed[i0 * kCBs + j1] * expf(ci0 - cj1) : 0.f,
            j1 <= ig1 ? fixed[i1 * kCBs + j1] * expf(ci1 - cj1) : 0.f};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(fa[e], ah[e], al[e]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mma3(acc[nt], ah, al, X[j0 * kXs + 8 * nt + gq], X[j1 * kXs + 8 * nt + gq]);
      }
    }
    // the shares of the steps meet in the unit's buffer; the first adds
    // the others' in order and writes out
    __syncthreads();
    if (kh > 0) {
      float* red = buf + (kh - 1) * kRows * kXs;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = 8 * nt + 2 * tq;
        red[i0 * kXs + c] = acc[nt][0]; red[i0 * kXs + c + 1] = acc[nt][1];
        red[i1 * kXs + c] = acc[nt][2]; red[i1 * kXs + c + 1] = acc[nt][3];
      }
    }
    __syncthreads();
    if (kh == 0) {
      const int pw = min(kCols, a.P - p0);
      const int limit = state ? a.N : a.L;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int il = half ? i1 : i0, rgl = r0 + il;
        if (rgl >= limit) continue;
        float* out = state
            ? a.st + ((static_cast<int64_t>(g) * a.H + h) * a.N + rgl) * a.P + p0
            : a.y + ((static_cast<int64_t>(g) * a.L + rgl) * a.H + h) * a.P + p0;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = 8 * nt + 2 * tq;
          float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
#pragma unroll
          for (int sh = 1; sh < kSplit; ++sh) {
            const float* red = buf + (sh - 1) * kRows * kXs + il * kXs + c;
            v0 += red[0];
            v1 += red[1];
          }
          if (c < pw) out[c] = v0;
          if (c + 1 < pw) out[c + 1] = v1;
        }
      }
    }
  }
}

bool aligned16(const float* p, int64_t s0, int64_t s1, int64_t s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0;
}

}  // namespace

// Shared memory the launch needs for (N, P), in bytes (0: P too wide).
extern "C" long long ssd_chunk_smem_bytes(int N, int P) {
  if (P <= 0 || P > 128 || N <= 0) return 0;
  return 4LL * kSmemFloats;
}

extern "C" int ssd_chunk_f32(const float* xdt, int64_t xg, int64_t xl, int64_t xh,
                             const float* Bm, int64_t bg, int64_t bl, const float* Cm,
                             int64_t cg, int64_t cl, const float* cum, int64_t ug,
                             int64_t ul, int64_t uh, float* y, float* st, float* dec,
                             int G, int L, int H, int N, int P, void* stream) {
  const long long smem = ssd_chunk_smem_bytes(N, P);
  if (G <= 0 || L <= 0 || L > kMaxL || H <= 0 || smem == 0 || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{xdt, xg, xl, xh, Bm, bg, bl, Cm, cg, cl, cum, ug, ul, uh, y, st, dec,
               G, L, H, N, P,
               aligned16(xdt, xg, xl, xh), aligned16(Bm, bg, bl, 0), aligned16(Cm, cg, cl, 0)};
  const int nI = (L + kRows - 1) / kRows, nN = (N + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(G) * ((H + kHeads - 1) / kHeads) * (nI + nN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssd_chunk_kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
