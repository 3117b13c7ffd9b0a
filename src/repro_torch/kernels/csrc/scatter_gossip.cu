// Payload-indexed gossip merge for Hopper (sm_90a): DecentralizePy's
// missing-coordinate rule over sparse (idx, val) payloads.
//
//   out[n] = X[n] + sum_{s<S} scatter(idx[r], (val[r] - X[n][idx[r]]) * w[n, s]),
//            r = rows[n, s]
//
// X (N, P) fp32 with row stride ldx; idx (R, k) int32 and val (R, k) fp32
// (row strides ldi, ldv), one payload per sender row, each idx row sorted
// ascending (the wrapper sorts rows that are not known to be); rows (N, S)
// int32 in [0, R) and w (N, S) fp32 contiguous; out (N, P) fp32 with row
// stride ldo.  A coordinate outside [0, P) is dropped, as the reference's
// scatter drops it.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/scatter_gossip.py
// (_kernel behind payload_mix_nodes).  The TPU has no fast VMEM scatter, so
// that kernel applies a (K*k, block) one-hot compare to every column block
// of a pre-built (N, K, k) payload stack.  Here each receiver reads its
// senders' payload rows by index (no stack exists).
//
// Design: one block per (receiver n, column tile [c0, c0 + kTile)), n
// fastest, so the blocks in flight at once work on one tile of every
// receiver and read the same sender rows: the circulant overlay's
// neighbours share them, and L2 serves most of those reads.  A block
//   1. loads X[n][c0:c0+kTile] into shared memory twice, as `own` and as
//      the accumulator, with coalesced 16-byte loads where rows allow;
//   2. finds, in each slot's sender row, the sub-range of entries whose
//      index lies in the tile: two searches per slot, one half-warp each,
//      16 probes a round, so a 57,959-entry row takes 4 rounds (warp w
//      searches slots w, w + 4, ...);
//   3. applies the slots in order, acc[c - c0] += (val - own[c - c0]) * w
//      with shared-memory atomics and the subtract and multiply rounded as
//      the twin rounds them (no fused multiply-add), a barrier between
//      slots;
//   4. writes the tile to out[n] once, coalesced.
// Determinism: `own` is X itself, never the partly updated accumulator, and
// the slots go in order.  Within a slot every strategy's indices are
// distinct, so each element takes at most one add per slot and the result
// does not depend on the order of the atomics: two launches give the same
// bits, the twin's (CUDA scatter_add_ adds once per element per slot, in
// the same order of slots).  Duplicates within one slot still sum, in no
// fixed order.
//
// Bound: bytes.  X is read and out written once; each sender's payload row
// (8 bytes an entry) is read from memory about once per tile wave, the
// other readers hitting L2.  Three operations per entry: far under the
// ops-per-byte ridge.  The searches cost 2*S*ceil(log16 k) dependent L2
// reads per block, hidden by the other blocks resident on the SM.
//
// Plain C interface (loaded with ctypes); the entry point returns
// cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 2048 columns and 4 warps a block (own + acc = 16 KB of shared memory):
// the fastest of the tile and block sizes tools/sweep_payload_ssd.py tries
// on one H100 (PERF.md); more resident blocks hide more of each block's
// dependent reads
constexpr int kTile = 2048;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 64;    // slots whose ranges a block holds at once

// First position in the ascending row ir[0, k) whose value is >= v, by a
// 16-ary search over one half-warp (lanes h*16 .. h*16+15, h = half).  Both
// halves of the warp call it together, each with its own row and value.
__device__ int lower_bound16(const int32_t* __restrict__ ir, int k, int64_t v, int half) {
  const int lane = threadIdx.x & 15;
  int a = 0, b = k;  // the answer lies in [a, b]; position b counts as >= v
  while (__any_sync(0xffffffffu, b > a)) {
    const int step = (b - a + 15) / 16;
    const int p = a + (lane + 1) * step - 1;
    const bool ge = b <= a || p >= b || static_cast<int64_t>(__ldg(ir + p)) >= v;
    const unsigned bits = (__ballot_sync(0xffffffffu, ge) >> (16 * half)) & 0xffffu;
    if (b > a) {
      const int first = bits ? __ffs(bits) - 1 : 16;
      const int lo = first == 0 ? a : a + first * step;    // one past the last probe below v
      const int hi = first == 16 ? b : min(b, a + (first + 1) * step - 1);
      a = lo;
      b = hi;
    }
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
payload_mix_rows_kernel(const float* __restrict__ X, int64_t ldx,
                        const int32_t* __restrict__ idx, int64_t ldi,
                        const float* __restrict__ val, int64_t ldv, int k,
                        const int32_t* __restrict__ rows,
                        const float* __restrict__ w, int S, int64_t P,
                        float* __restrict__ out, int64_t ldo, int vec) {
  __shared__ __align__(16) float own[kTile];
  __shared__ __align__(16) float acc[kTile];
  __shared__ int range[2 * kMaxSlots];
  const int64_t n = blockIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int width = static_cast<int>(min(static_cast<int64_t>(kTile), P - c0));
  const float* xr = X + n * ldx + c0;
  float* orow = out + n * ldo + c0;

  // 1. the tile of X (loads issued before the searches' dependent reads)
  const int nv = vec ? width / 4 : 0;
  for (int q = threadIdx.x; q < nv; q += kThreads) {
    const float4 x4 = __ldg(reinterpret_cast<const float4*>(xr) + q);
    reinterpret_cast<float4*>(own)[q] = x4;
    reinterpret_cast<float4*>(acc)[q] = x4;
  }
  for (int c = 4 * nv + threadIdx.x; c < width; c += kThreads) {
    const float x = __ldg(xr + c);
    own[c] = x;
    acc[c] = x;
  }

  // 2-3. per group of up to kMaxSlots slots: each slot's entries in
  // [c0, c0 + width) (warp w searches slots w, w + kWarps, ...), then the
  // slots in order
  const int warp = threadIdx.x >> 5, half = (threadIdx.x >> 4) & 1;
  for (int s0 = 0; s0 < S; s0 += kMaxSlots) {
    const int sn = min(kMaxSlots, S - s0);
    for (int s = warp; s < sn; s += kWarps) {
      const int32_t* ir = idx + static_cast<int64_t>(rows[n * S + s0 + s]) * ldi;
      const int pos = lower_bound16(ir, k, half ? c0 + width : c0, half);
      if ((threadIdx.x & 15) == 0) range[2 * s + half] = pos;
    }
    __syncthreads();
    for (int s = 0; s < sn; ++s) {
      const int64_t r = rows[n * S + s0 + s];
      const float ws = w[n * S + s0 + s];
      const int32_t* ir = idx + r * ldi;
      const float* vr = val + r * ldv;
      const int hi = range[2 * s + 1];
      for (int j = range[2 * s] + threadIdx.x; j < hi; j += kThreads) {
        const int c = static_cast<int>(__ldg(ir + j) - c0);
        // in the tile by the search; the guard keeps a row that breaks the
        // sorted promise inside the tile's shared memory
        if (static_cast<unsigned>(c) < static_cast<unsigned>(width))
          atomicAdd(&acc[c], __fmul_rn(__fsub_rn(__ldg(vr + j), own[c]), ws));
      }
      __syncthreads();
    }
  }

  // 4. the tile, written once
  for (int q = threadIdx.x; q < nv; q += kThreads)
    reinterpret_cast<float4*>(orow)[q] = reinterpret_cast<const float4*>(acc)[q];
  for (int c = 4 * nv + threadIdx.x; c < width; c += kThreads) orow[c] = acc[c];
}

}  // namespace

extern "C" {

int payload_mix_rows_tile_cols() { return kTile; }

int payload_mix_rows_f32(const void* X, long long ldx, const void* idx,
                         long long ldi, const void* val, long long ldv, int k,
                         const void* rows, const void* w, int N, int S,
                         long long P, void* out, long long ldo, void* stream) {
  if (N <= 0 || P <= 0) return 0;
  const long long tiles = (P + kTile - 1) / kTile;
  if (S < 0 || k < 0 || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte accesses when every row of X and out starts on a 16-byte boundary
  const int vec = (reinterpret_cast<uintptr_t>(X) % 16 == 0 && ldx % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 && ldo % 4 == 0);
  const dim3 grid(static_cast<unsigned>(N), static_cast<unsigned>(tiles));
  payload_mix_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), ldx, static_cast<const int32_t*>(idx), ldi,
      static_cast<const float*>(val), ldv, k, static_cast<const int32_t*>(rows),
      static_cast<const float*>(w), S, P, static_cast<float*>(out), ldo, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
