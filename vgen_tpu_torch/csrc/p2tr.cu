// The P2TR kernels F, G, H and I, with a plain C interface for ctypes
// (vgen_tpu_torch/csrc/build.py builds this file with nvcc for sm_90a, in
// parallel with kernels.cu; vgen_tpu_torch/ops/fused.py wraps the entry
// points).  Each launcher takes the caller's stream, launches without
// synchronising, and returns cudaGetLastError() (0 on success).
//
// Kernel F, p2tr_ladder
//   Replaces vgen_tpu/ops/pallas_fused.py _make_p2tr_ladder_kernel with
//   finish=True (called through p2tr_ladder_finish_fn), and, through the
//   template flag kFinish = false, with finish=False (p2tr_ladder_fn, the
//   affine-input form that p2tr_output_key_pallas drives).
//   Computes: per lane, the full affine finish of kernel A's inverse (or
//   the affine input), the even-Y internal key, t = TapTweak(x) (one SHA-256
//   compression from the host midstate), t < n, and Q = P + t*G by 32
//   fixed 8-bit windows of lean Jacobian mixed adds -> X, Z (8, N) and ok.
//   Y is not written: nothing reads it.
//   Bound: 32-bit integer multiply throughput.  About 32 x 11 = 352 field
//   multiplies per lane (each 64 32x32->64 products and the folds) against
//   one SHA-256 compression; it reads 96 bytes (plus 16 table words per
//   nonzero digit, served by L2: the table is 512 KB) and writes 68 per lane.
//   Design: the TPU selected table entries by a one-hot byte-plane matmul
//   (p2tr_planes); here each thread reads table[w][digit] by index through
//   the read-only path (__ldg).  The window loop is not unrolled, to keep
//   the code and register footprint of one lean add.
//
// Kernel G, batch_inverse_chain
//   Replaces _inv_chain_calls(C, guard_zero=True) (its fwd, inv and bwd
//   pallas_calls) as driven by batch_inverse_chain_pallas.
//   Computes: canonical inverses of an (8, N) array, zero guarded to 1.
//   Bound: 32-bit integer multiply throughput, as kernel A (3 multiplies
//   per element plus one inversion per chain of M).
//   Design: kernel A's per-thread chain (scan_lanes.cuh inv_chain_thread)
//   with the input read straight from the array.
//
// Kernel H, p2tr_finish_range
//   Replaces _make_p2tr_finish_range_kernel (with _p2tr_qx_in_kernel) as
//   called through p2tr_finish_range_fn.
//   Computes: qx = X * zi^2, ok &= Z != 0, the 8-word interval compare,
//   masked by b < remaining[k] -> 0/1.
//   Bound: memory: 100 bytes read and 4 written per lane against two
//   field multiplies.
//   Design: one thread per lane; the interval table (at most 8 slots of 8
//   words) staged in shared memory.
//
// Kernel I, p2tr_finish_match
//   Replaces _make_p2tr_finish_match_kernel as called through
//   p2tr_finish_match_fn.
//   Computes: qx as in H, the bech32m symbols of witness v1 (52 five-bit
//   groups and the polymod checksum, 59 symbols) and the DFA walk of
//   T + 1 = 60 steps -> 0/1.
//   Bound: memory and the walk's 60 dependent table loads (read-only cache).
//   Design: H's body with dfa.cuh's walk by table lookup, no state cap.

#include <cuda_runtime.h>

#include "p2tr_lanes.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kFinish>
__global__ void __launch_bounds__(kThreads)
    ladder_kernel(const uint32_t* __restrict__ bx, const uint32_t* __restrict__ by,
                  const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
                  const uint32_t* __restrict__ inv, const uint32_t* __restrict__ table,
                  uint32_t* __restrict__ X, uint32_t* __restrict__ Z,
                  int32_t* __restrict__ ok, long B, long N) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  if constexpr (kFinish) {
    ok[e] = vg::p2tr_ladder_lane(bx, by, tx, ty, inv, table, X, Z, B, N, e);
  } else {
    // affine input: (tx, ty) hold the internal keys' (x, y)
    ok[e] = vg::p2tr_ladder_affine_lane(tx, ty, table, X, Z, N, e);
  }
}

__global__ void __launch_bounds__(kThreads)
    inv_chain_kernel(const uint32_t* __restrict__ v, uint32_t* __restrict__ out,
                     uint32_t* __restrict__ scratch, long N, long T, int M) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  vg::inv_chain_thread(vg::GuardedInput{v, N}, out, scratch, N, T, M, t);
}

__global__ void __launch_bounds__(kThreads)
    finish_range_kernel(const uint32_t* __restrict__ X, const uint32_t* __restrict__ Z,
                        const uint32_t* __restrict__ zi, const int32_t* __restrict__ ok,
                        const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
                        int n_slots, const int32_t* __restrict__ remaining,
                        int32_t* __restrict__ out, long B, long N) {
  __shared__ uint32_t s_lo[8 * 8], s_hi[8 * 8];
  for (int i = threadIdx.x; i < n_slots * 8; i += blockDim.x) {
    s_lo[i] = lo[i];
    s_hi[i] = hi[i];
  }
  __syncthreads();
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  out[e] = vg::p2tr_range_lane(X, Z, zi, ok, s_lo, s_hi, n_slots, remaining, B,
                               N, e);
}

__global__ void __launch_bounds__(kThreads)
    finish_match_kernel(const uint32_t* __restrict__ X, const uint32_t* __restrict__ Z,
                        const uint32_t* __restrict__ zi, const int32_t* __restrict__ ok,
                        const int32_t* __restrict__ table,
                        const int32_t* __restrict__ accept, int width, int start,
                        const int32_t* __restrict__ remaining,
                        int32_t* __restrict__ out, long B, long N) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  const vg::Dfa dfa{table, accept, width, start};
  out[e] = vg::p2tr_dfa_lane(X, Z, zi, ok, dfa, remaining, B, N, e);
}

unsigned blocks_for(long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Kernel F.  bx, by (K, 8); tx, ty (8, B); inv (8, K*B); table
// (32, 256, 2, 8) -> X, Z (8, K*B), ok (K*B,).
int vgen_p2tr_ladder(const void* bx, const void* by, const void* tx,
                     const void* ty, const void* inv, const void* table, void* X,
                     void* Z, void* ok, int K, int B, void* stream) {
  const long N = (long)K * B;
  ladder_kernel<true><<<blocks_for(N), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)tx,
      (const uint32_t*)ty, (const uint32_t*)inv, (const uint32_t*)table,
      (uint32_t*)X, (uint32_t*)Z, (int32_t*)ok, (long)B, N);
  return (int)cudaGetLastError();
}

// Kernel F with finish=False.  x, y (8, N) affine internal keys -> X, Z
// (8, N), ok (N,).
int vgen_p2tr_ladder_affine(const void* x, const void* y, const void* table,
                            void* X, void* Z, void* ok, int N, void* stream) {
  ladder_kernel<false><<<blocks_for(N), kThreads, 0, (cudaStream_t)stream>>>(
      nullptr, nullptr, (const uint32_t*)x, (const uint32_t*)y, nullptr,
      (const uint32_t*)table, (uint32_t*)X, (uint32_t*)Z, (int32_t*)ok,
      (long)N, (long)N);
  return (int)cudaGetLastError();
}

// Kernel G.  v (8, N) -> out (8, N); scratch (8, N); M divides N.
int vgen_batch_inverse_chain(const void* v, void* out, void* scratch, int N,
                             int M, void* stream) {
  const long T = (long)N / M;
  inv_chain_kernel<<<blocks_for(T), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)v, (uint32_t*)out, (uint32_t*)scratch, (long)N, T, M);
  return (int)cudaGetLastError();
}

// Kernel H.  X, Z, zi (8, K*B); ok (K*B,); lo, hi (n_slots, 8) with
// n_slots <= 8; remaining (K,) -> out (K, B) 0/1.
int vgen_p2tr_finish_range(const void* X, const void* Z, const void* zi,
                           const void* ok, const void* lo, const void* hi,
                           int n_slots, const void* remaining, void* out, int K,
                           int B, void* stream) {
  if (n_slots < 1 || n_slots > 8) return (int)cudaErrorInvalidValue;
  const long N = (long)K * B;
  finish_range_kernel<<<blocks_for(N), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)X, (const uint32_t*)Z, (const uint32_t*)zi,
      (const int32_t*)ok, (const uint32_t*)lo, (const uint32_t*)hi, n_slots,
      (const int32_t*)remaining, (int32_t*)out, (long)B, N);
  return (int)cudaGetLastError();
}

// Kernel I.  X, Z, zi, ok, remaining as kernel H; table (S, width) and
// accept (S,) int32, width 34 -> out (K, B) 0/1.
int vgen_p2tr_finish_match(const void* X, const void* Z, const void* zi,
                           const void* ok, const void* table, const void* accept,
                           int width, int start, const void* remaining, void* out,
                           int K, int B, void* stream) {
  const long N = (long)K * B;
  finish_match_kernel<<<blocks_for(N), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)X, (const uint32_t*)Z, (const uint32_t*)zi,
      (const int32_t*)ok, (const int32_t*)table, (const int32_t*)accept, width,
      start, (const int32_t*)remaining, (int32_t*)out, (long)B, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
