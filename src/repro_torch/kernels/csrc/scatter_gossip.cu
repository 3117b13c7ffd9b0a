// Payload-indexed gossip merge for Hopper (sm_90a): DecentralizePy's
// missing-coordinate rule over sparse (idx, val) payloads.
//
//   out[n] = X[n] + sum_{s<S} scatter(idx[r], (val[r] - X[n][idx[r]]) * w[n, s]),
//            r = rows[n, s]
//
// X (N, P) fp32 with row stride ldx; idx (R, k) int32 and val (R, k) fp32
// (row strides ldi, ldv), one payload per sender row; rows (N, S) int32 in
// [0, R) and w (N, S) fp32 contiguous; out (N, P) fp32 with row stride ldo.
// A coordinate outside [0, P) is dropped, as the reference's scatter drops it.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/scatter_gossip.py
// (_kernel behind payload_mix_nodes).  The TPU has no fast VMEM scatter, so
// that kernel applies a (K*k, block) one-hot compare to every column block
// of a pre-built (N, K, k) payload stack.  Here each receiver reads its
// senders' payload rows by index (no stack exists) and scatters straight
// into its output row with atomic adds.
//
// Semantics and determinism: `own` is read from the input X, never from
// the partly updated output.  One block per receiver copies X[n] into
// out[n], then applies the slots in order with a block barrier between
// slots.  Within a slot the indices of every strategy's payload are
// distinct, so each output element takes at most one add per slot and the
// result does not depend on the order of the atomics: two launches give the
// same bits.  (Duplicates within one slot still sum, in no fixed order.)
//
// Bound: bytes.  X is read and out written once; each payload entry costs
// its 8 bytes of (idx, val) and a scattered 4-byte read of X[n] and
// read-modify-write of out[n], which the L2 cache absorbs only in part.
// Three operations per entry: far under the ops-per-byte ridge.
//
// Plain C interface (loaded with ctypes); the entry point returns
// cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
payload_mix_rows_kernel(const float* __restrict__ X, int64_t ldx,
                        const int32_t* __restrict__ idx, int64_t ldi,
                        const float* __restrict__ val, int64_t ldv, int k,
                        const int32_t* __restrict__ rows,
                        const float* __restrict__ w, int S, int64_t P,
                        float* __restrict__ out, int64_t ldo) {
  const int64_t n = blockIdx.x;
  const float* xr = X + n * ldx;
  float* orow = out + n * ldo;
  for (int64_t c = threadIdx.x; c < P; c += kThreads) orow[c] = xr[c];
  __syncthreads();
  for (int s = 0; s < S; ++s) {
    const int64_t r = rows[n * S + s];
    const float ws = w[n * S + s];
    const int32_t* ir = idx + r * ldi;
    const float* vr = val + r * ldv;
    for (int j = threadIdx.x; j < k; j += kThreads) {
      const int32_t c = ir[j];
      if (c < 0 || c >= P) continue;
      atomicAdd(&orow[c], __fmul_rn(__fsub_rn(vr[j], xr[c]), ws));
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int payload_mix_rows_f32(const void* X, long long ldx, const void* idx,
                         long long ldi, const void* val, long long ldv, int k,
                         const void* rows, const void* w, int N, int S,
                         long long P, void* out, long long ldo, void* stream) {
  if (N <= 0 || P <= 0) return 0;
  if (S < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  payload_mix_rows_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), ldx, static_cast<const int32_t*>(idx), ldi,
      static_cast<const float*>(val), ldv, k, static_cast<const int32_t*>(rows),
      static_cast<const float*>(w), S, P, static_cast<float*>(out), ldo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
