// Secure-aggregation mask apply for Hopper (sm_90a).
//
//   out[b, m] = x[rows[b], m] + sum_{k : sign[b,k] != 0} sign[b,k] * U(bits[b,k,m])
//   U(v)      = ((v >> 8) * 2^-24 * 2 - 1) * bound            (uniform in [-bound, bound))
//
// x (R, M) fp32 with row stride ldx; rows (B,) int32 into x, or null for
// row b of x itself; signs (B, K) fp32 in {-1, 0, +1}; out (B, M) fp32 with
// row stride ldo.  out may be x itself when rows is null: each thread reads
// and then writes only its own positions, and a message with no nonzero
// sign is left as it is (the recovery pass, where most messages lost no
// co-neighbour, reads and writes only the rest).
//
// Two bit sources, one per entry point:
// * keyed (secure_mask_rows_keyed_f32): keys (B, K, 2) uint32 words, the
//   bits computed here by Threefry-2x32 in the reference's counter layout:
//   h = ceil(M/2), lane q < h ciphers the counter words (q, q+h), or (q, 0)
//   where q+h = M; output y0 is position q's word and y1 position q+h's.
//   Replaces _kernel_nodes_keyed behind secure_mask_apply_nodes_keyed in
//   src/repro/kernels/secure_mask.py.  The TPU kernel computes a cipher
//   call for every position and keeps one of its two outputs; a thread here
//   runs one call per lane and writes both positions, half the integer work.
// * staged (secure_mask_rows_bits_f32): bits (B, K, M) uint32, contiguous.
//   Replaces _kernel_nodes and _kernel behind secure_mask_apply_nodes and
//   secure_mask_apply.
//
// Bound: the keyed kernel by integer operations.  A cipher call gives two
// mask words for 20 funnel-shift rotates, 20 xors and 26 adds, against 16
// bytes moved; rotates, xors and the two >> 8 issue only on the integer ALU,
// 64 per SM and clock, while the compiler puts part of the adds on the FMA
// pipe (IMAD.IADD).  The staged kernel by bytes: 4 K + 8 bytes per position
// for a handful of operations.  Slots whose sign is 0 are skipped: they would
// add exact zeros.  The staged kernel's grid is sized by the card over
// (B, column chunks) of 128-thread blocks; a thread step takes 8 positions
// of a warp's 256 in the widest coalesced accesses that x's row, every
// slot's bit row and out reach after one peel (16 bytes, or 8 where
// M = 2 mod 4 leaves the slot rows at stride M 8-byte aligned), all its
// loads issued before it sums, so that one message (B = 1) keeps as many
// loads in flight as its rows allow; the block's nonzero slots are found
// by one load of all K signs (tools/ab_codec_mask.py --variants times the
// other choices; PERF.md has the times).
//
// Bitwise parity with the reference: the mapping and the sum are written
// with __fmul_rn / __fadd_rn, so nothing is contracted into a fused
// multiply-add and every rounding is the reference's: masks are bitwise
// ref.mask_bits_to_uniform's, and the sum runs over k in order from 0, then
// adds x, as the plain twin does.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;    // keyed: lanes per thread in a block's column chunk
constexpr int kMaxK = 64;    // slots per message: the shared-memory tables
constexpr int kStageThreads = 128;  // staged: threads per block
constexpr int kStagePos = 8;    // staged: positions per thread step
constexpr int kStageSlots = 8;  // staged: bit rows whose loads are issued together
constexpr int kStageWaves = 2;  // staged: waves of resident blocks the grid aims at

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// Threefry-2x32, 20 rounds: kernels/ref.py threefry2x32_ref.
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  x0 += k1;
  x1 += k2;
#define ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)  x0 += k2; x1 += k3 + 1u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24) x0 += k3; x1 += k1 + 2u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)  x0 += k1; x1 += k2 + 3u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24) x0 += k2; x1 += k3 + 4u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)  x0 += k3; x1 += k1 + 5u;
#undef ROUND
}

// sign * U(bits), rounded as the reference rounds it.
__device__ __forceinline__ float signed_mask(uint32_t bits, float sign, float bound) {
  const float u01 = __fmul_rn(static_cast<float>(bits >> 8), 5.9604644775390625e-08f);
  return __fmul_rn(sign, __fmul_rn(__fadd_rn(__fmul_rn(u01, 2.0f), -1.0f), bound));
}

// The block's message: its nonzero slots, compacted into shared memory in
// slot order.  The first kMaxK threads read one sign each at once (one
// load's latency, not K in a row), and two ballots give each nonzero
// slot its place.
__device__ __forceinline__ int load_slots(const float* signs, int K, int64_t b,
                                          float* s_sign, int* s_slot) {
  static_assert(kMaxK % 32 == 0 && kMaxK <= kThreads && kMaxK <= kStageThreads,
                "whole warps read the signs");
  __shared__ unsigned s_live[kMaxK / 32];
  const int k = threadIdx.x;
  float s = 0.f;
  if (k < kMaxK) {
    if (k < K) s = signs[b * K + k];
    const unsigned live = __ballot_sync(0xffffffffu, s != 0.f);
    if (k % 32 == 0) s_live[k / 32] = live;
  }
  __syncthreads();
  int n = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kMaxK / 32; ++w) {
    const int c = __popc(s_live[w]);
    if (w < k / 32) before += c;
    n += c;
  }
  if (k < kMaxK && s != 0.f) {
    const int at = before + __popc(s_live[k / 32] & ((1u << (k % 32)) - 1u));
    s_sign[at] = s;
    s_slot[at] = k;
  }
  __syncthreads();
  return n;
}

__global__ void __launch_bounds__(kThreads)
secure_mask_keyed_kernel(const float* x, int64_t ldx, const int32_t* __restrict__ rows,
                         int64_t M, const uint32_t* __restrict__ keys,
                         const float* __restrict__ signs, int K, float bound, float* out,
                         int64_t ldo) {
  __shared__ float s_sign[kMaxK];
  __shared__ int s_slot[kMaxK];
  __shared__ uint32_t s_k1[kMaxK], s_k2[kMaxK];
  const int64_t b = blockIdx.x;
  const int n = load_slots(signs, K, b, s_sign, s_slot);
  if (n == 0 && rows == nullptr && out == x) return;  // in place: nothing to add
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_k1[i] = keys[(b * K + s_slot[i]) * 2];
    s_k2[i] = keys[(b * K + s_slot[i]) * 2 + 1];
  }
  __syncthreads();
  const float* xr = x + (rows ? static_cast<int64_t>(rows[b]) : b) * ldx;
  float* orow = out + b * ldo;
  const int64_t h = (M + 1) / 2;
  for (int64_t q = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x; q < h;
       q += static_cast<int64_t>(gridDim.y) * blockDim.x) {
    const int64_t q1 = q + h;
    const bool has1 = q1 < M;
    float acc0 = 0.f, acc1 = 0.f;
    for (int k = 0; k < n; ++k) {
      uint32_t y0 = static_cast<uint32_t>(q), y1 = has1 ? static_cast<uint32_t>(q1) : 0u;
      threefry2x32(s_k1[k], s_k2[k], y0, y1);
      acc0 = __fadd_rn(acc0, signed_mask(y0, s_sign[k], bound));
      acc1 = __fadd_rn(acc1, signed_mask(y1, s_sign[k], bound));
    }
    const float x0 = xr[q];
    const float x1 = has1 ? xr[q1] : 0.f;
    orow[q] = __fadd_rn(x0, acc0);
    if (has1) orow[q1] = __fadd_rn(x1, acc1);
  }
}

// W consecutive 32-bit words, loaded or stored with one access.
template <int W> struct alignas(4 * W) Words { uint32_t v[W]; };

template <int W>
__device__ __forceinline__ void load_words(const void* p, uint32_t* dst) {
  const Words<W> w = *reinterpret_cast<const Words<W>*>(p);
#pragma unroll
  for (int i = 0; i < W; ++i) dst[i] = w.v[i];
}

// Staged bits.  A warp step covers 32 * kStagePos consecutive positions
// of one message: lane l takes kStagePos of them, in accesses of W words
// at l * W + a * 32 * W, so each access is coalesced over the warp.  A
// thread issues the loads of x and of up to kStageSlots nonzero slots'
// bit rows before it sums any of them, each position over its slots in
// order.  Rows of x, of the bits and of out share one peel h to their
// W-word boundaries (the host checks); the peel and the tail go one
// position to a thread of the message's chunks.
template <int W>
__global__ void __launch_bounds__(kStageThreads)
secure_mask_bits_kernel(const float* x, int64_t ldx, const int32_t* __restrict__ rows,
                        int64_t M, const uint32_t* __restrict__ bits,
                        const float* __restrict__ signs, int K, float bound, float* out,
                        int64_t ldo) {
  static_assert(kStagePos % W == 0, "a step is whole accesses");
  constexpr int kStep = 32 * kStagePos;
  __shared__ float s_sign[kMaxK];
  __shared__ int s_slot[kMaxK];
  const int64_t b = blockIdx.x;
  const int n = load_slots(signs, K, b, s_sign, s_slot);
  if (n == 0 && rows == nullptr && out == x) return;  // in place: nothing to add
  const float* xr = x + (rows ? static_cast<int64_t>(rows[b]) : b) * ldx;
  const uint32_t* br = bits + b * K * M;
  float* orow = out + b * ldo;
  int64_t h = W == 1 ? 0 : (W - (reinterpret_cast<uintptr_t>(xr) / 4) % W) % W;
  if (h > M) h = M;
  const int64_t steps = (M - h) / kStep;
  const int64_t tail = h + steps * kStep;
  const int64_t t = static_cast<int64_t>(blockIdx.y) * kStageThreads + threadIdx.x;
  const int64_t threads = static_cast<int64_t>(gridDim.y) * kStageThreads;
  for (int64_t e = t; e < h + (M - tail); e += threads) {
    const int64_t m = e < h ? e : tail + (e - h);
    float acc = 0.f;
    for (int k = 0; k < n; ++k)
      acc = __fadd_rn(acc, signed_mask(br[s_slot[k] * M + m], s_sign[k], bound));
    orow[m] = __fadd_rn(xr[m], acc);
  }
  const int lane = threadIdx.x % 32;
  for (int64_t w = t / 32; w < steps; w += threads / 32) {
    const int64_t m = h + w * kStep + lane * W;  // access a at m + a * 32 * W
    uint32_t xv[kStagePos];
#pragma unroll
    for (int a = 0; a < kStagePos; a += W) load_words<W>(xr + m + a * 32, xv + a);
    float acc[kStagePos];
#pragma unroll
    for (int p = 0; p < kStagePos; ++p) acc[p] = 0.f;
    for (int k0 = 0; k0 < n; k0 += kStageSlots) {
      uint32_t wv[kStageSlots][kStagePos];
#pragma unroll
      for (int s = 0; s < kStageSlots; ++s)
        if (k0 + s < n) {
          const uint32_t* bk = br + s_slot[k0 + s] * M + m;
#pragma unroll
          for (int a = 0; a < kStagePos; a += W) load_words<W>(bk + a * 32, wv[s] + a);
        }
#pragma unroll
      for (int s = 0; s < kStageSlots; ++s)
        if (k0 + s < n) {
#pragma unroll
          for (int p = 0; p < kStagePos; ++p)
            acc[p] = __fadd_rn(acc[p], signed_mask(wv[s][p], s_sign[k0 + s], bound));
        }
    }
#pragma unroll
    for (int a = 0; a < kStagePos; a += W) {
      Words<W> o;
#pragma unroll
      for (int i = 0; i < W; ++i)
        o.v[i] = __float_as_uint(__fadd_rn(__uint_as_float(xv[a + i]), acc[a + i]));
      *reinterpret_cast<Words<W>*>(orow + m + a * 32) = o;
    }
  }
}

// The staged grid: (B, column chunks), chunks sized by the card so that
// the grid holds kStageWaves waves of resident blocks where the rows have
// that much work, and at most one block per kStageThreads steps of a row; the
// step loop strides over the rest.  One message (B = 1) at M = 579,594 so
// fills 0.27 of a wave; the 1 and 2 positions a step that would give it
// two waves and one were slower at B = 1 and at B = 1024 on an H100
// (PERF.md).
dim3 staged_grid(int64_t B, int64_t M) {
  const int64_t by_row =
      std::max<int64_t>(1, (M / kStagePos + kStageThreads - 1) / kStageThreads);
  const int64_t want = static_cast<int64_t>(kStageWaves) * (2048 / kStageThreads) * sm_count();
  int64_t chunks = std::min(by_row, (want + B - 1) / B);
  chunks = std::min<int64_t>(std::max<int64_t>(chunks, 1), 65535);
  return dim3(static_cast<unsigned>(B), static_cast<unsigned>(chunks));
}

dim3 grid_for(int64_t B, int64_t work) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kItems;
  int64_t chunks = (work + per_block - 1) / per_block;
  if (chunks > 65535) chunks = 65535;  // the loop strides over the rest
  return dim3(static_cast<unsigned>(B), static_cast<unsigned>(chunks));
}

}  // namespace

extern "C" {

int secure_mask_rows_keyed_f32(const void* x, long long ldx, const void* rows, int B,
                               long long M, const void* keys, const void* signs, int K,
                               float bound, void* out, long long ldo, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (K < 0 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  secure_mask_keyed_kernel<<<grid_for(B, (M + 1) / 2), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ldx, static_cast<const int32_t*>(rows), M,
      static_cast<const uint32_t*>(keys), static_cast<const float*>(signs), K, bound,
      static_cast<float*>(out), ldo);
  return static_cast<int>(cudaGetLastError());
}

int secure_mask_rows_bits_f32(const void* x, long long ldx, const void* rows, int B,
                              long long M, const void* bits, const void* signs, int K,
                              float bound, void* out, long long ldo, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (K < 0 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  // the widest access (4, 2 or 1 words) whose boundaries every row of x,
  // of the bits and of out reach after the same peel
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x) / 4;
  auto same_peel = [&](int w) {
    const uint64_t m = static_cast<uint64_t>(w - 1);
    return w <= kStagePos && ((xa - reinterpret_cast<uintptr_t>(bits) / 4) & m) == 0 &&
           ((xa - reinterpret_cast<uintptr_t>(out) / 4) & m) == 0 &&
           (static_cast<uint64_t>(ldx) & m) == 0 && (static_cast<uint64_t>(M) & m) == 0 &&
           (static_cast<uint64_t>(ldo) & m) == 0;
  };
  const dim3 grid = staged_grid(B, M);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* rw = static_cast<const int32_t*>(rows);
  const auto* bw = static_cast<const uint32_t*>(bits);
  const auto* sg = static_cast<const float*>(signs);
  auto* of = static_cast<float*>(out);
  constexpr int kW4 = std::min(4, kStagePos), kW2 = std::min(2, kStagePos);
  if (same_peel(4))
    secure_mask_bits_kernel<kW4><<<grid, kStageThreads, 0, st>>>(xf, ldx, rw, M, bw, sg, K,
                                                                bound, of, ldo);
  else if (same_peel(2))
    secure_mask_bits_kernel<kW2><<<grid, kStageThreads, 0, st>>>(xf, ldx, rw, M, bw, sg, K,
                                                                bound, of, ldo);
  else
    secure_mask_bits_kernel<1><<<grid, kStageThreads, 0, st>>>(xf, ldx, rw, M, bw, sg, K,
                                                                bound, of, ldo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
