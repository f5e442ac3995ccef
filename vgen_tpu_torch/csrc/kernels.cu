// The kernels of the scan steps (interval and DFA, random and range), with a
// plain C interface for ctypes (vgen_tpu_torch/csrc/build.py builds this file with
// nvcc for sm_90a; vgen_tpu_torch/ops/fused.py wraps the entry points).
// Each launcher takes the caller's stream, launches without synchronising,
// and returns cudaGetLastError() (0 on success).
//
// Kernel A, batch_inverse_dx
//   Replaces vgen_tpu/ops/pallas_fused.py _inv_dx_calls (its fwd, inv and
//   bwd pallas_calls) as driven by batch_inverse_dx_pallas.
//   Computes: the canonical inverse of dx = tx[b] - bx[k] for all K*B lanes,
//   zero dx guarded to 1.
//   Bound: 32-bit integer multiply throughput.  About 3 field multiplies
//   per element (forward product, backward product, backward accumulate)
//   plus one 270-step addition-chain inversion amortised over M elements;
//   the prefix scratch adds 64 bytes written and read per element.
//   Design: the TPU ran one long chain as a sequential grid carrying the
//   running product in VMEM.  Here blocks run in no order, so every thread
//   owns its own chain of M elements strided by the thread count (loads
//   coalesce), and the three passes are one launch.  The output is
//   canonical, so the chain geometry does not change the result.
//
// Kernel B, range_glv_match
//   Replaces vgen_tpu/ops/pallas_fused.py _make_range_glv_kernel (glv=True,
//   compressed-hash160 formats) as called through fused_range_match_fn, and
//   the per-window lax.scan of _build_step: one launch covers all K windows.
//   Computes: per lane, the x-only affine add, x * beta, x * beta^2, six
//   hash160s of (2 + pi) || x_v, the interval compare, and a 6-bit mask
//   (bit 2v + pi); 0 where dx == 0 or b >= remaining[k].
//   Bound: integer ALU.  Six SHA-256 + RIPEMD-160 pairs per lane (about
//   25k 32-bit logic/add instructions) dominate the five field multiplies;
//   it reads 96 bytes and writes 4 bytes per lane.
//   Design: one thread per lane keeps the whole hash state in registers;
//   the interval table (at most 8 slots) is staged in shared memory.
//
// Kernel C, range_match
//   Replaces vgen_tpu/ops/pallas_fused.py _make_range_kernel (glv=False,
//   P2PKH and P2WPKH) as called through fused_range_match_fn, and the
//   per-window lax.scan of _build_step: one launch covers all K windows.
//   Computes: per lane, the full affine add with y canonical, hash160 of
//   (2 + (y & 1)) || x, the interval compare -> 0/1; 0 where dx == 0 or
//   b >= remaining[k].
//   Bound: integer ALU, one SHA-256 + RIPEMD-160 pair and three field
//   multiplies per key (a sixth of kernel B's hashing per lane), 96 bytes
//   read and 4 written per lane.
//   Design: kernel B's lane with the y of the full finish in place of the
//   GLV loop; y is exact (every field op returns a value < p), so its
//   parity is the prefix byte's.
//
// Kernel D, dfa_match
//   Replaces _make_kernel (glv=False) as called through fused_match_fn,
//   for P2PKH (Base58Check, W = 60) and P2WPKH (bech32, W = 34).
//   Computes: per lane, the full finish and hash160 as in C, the address
//   symbols (Base58Check: SHA256d checksum, 7 rounds of division by 58^5
//   on 7 words, the reference's leading-zero shift; bech32: 32 five-bit
//   groups and the polymod checksum), and the DFA walk of T + 1 steps
//   -> 0/1.
//   Bound: integer ALU (three SHA-256 compressions, one RIPEMD-160 and 49
//   64-bit divisions by a constant for P2PKH) and T + 1 dependent loads
//   from the DFA table, which the read-only cache serves (a table of S
//   states is S * W * 4 bytes).
//   Design: the TPU walked the DFA as a one-hot (S, W) f32 matmul per
//   symbol, exact only up to 256 states; here each thread follows the
//   table by index (__ldg), so any state count works.  Symbols sit in a
//   per-thread array (34 or 39 bytes, local memory where the shift indexes
//   it at run time).  Format is a template parameter.
//
// Kernel E, glv_dfa_match
//   Replaces _make_glv_dfa_kernel (glv=True, the compressed-key formats)
//   as called through fused_match_fn.
//   Computes: per lane, kernel B's x-only finish, then for v in 0..2 and
//   pi in 0..1 the symbols of hash160((2 + pi) || beta^v x) through the
//   DFA -> a 6-bit mask (bit 2v + pi, kernel B's layout).
//   Bound: six times kernel D's hashing, encoding and walk per lane, for
//   six keys.
//   Design: D's body shared through dfa.cuh; the variant loops are not
//   unrolled, to bound the code size of the six inlined encoders.

#include <cuda_runtime.h>

#include "scan_lanes.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    inv_dx_kernel(const uint32_t* __restrict__ bx, const uint32_t* __restrict__ tx,
                  uint32_t* __restrict__ out, uint32_t* __restrict__ scratch,
                  long B, long N, long T, int M) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  vg::inv_dx_thread(bx, tx, out, scratch, B, N, T, M, t);
}

// Kernels B (kGlv) and C: the interval table (at most 8 slots) is staged in
// shared memory.
template <bool kGlv>
__global__ void __launch_bounds__(kThreads)
    interval_kernel(const uint32_t* __restrict__ bx, const uint32_t* __restrict__ by,
                    const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
                    const uint32_t* __restrict__ inv, const uint32_t* __restrict__ lo,
                    const uint32_t* __restrict__ hi, int n_slots,
                    const int32_t* __restrict__ remaining, int32_t* __restrict__ out,
                    long B, long N) {
  __shared__ uint32_t s_lo[8 * 5], s_hi[8 * 5];
  for (int i = threadIdx.x; i < n_slots * 5; i += blockDim.x) {
    s_lo[i] = lo[i];
    s_hi[i] = hi[i];
  }
  __syncthreads();
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  if constexpr (kGlv) {
    out[e] = vg::range_glv_lane(bx, by, tx, ty, inv, s_lo, s_hi, n_slots,
                                remaining, B, N, e);
  } else {
    out[e] = vg::range_lane(bx, by, tx, ty, inv, s_lo, s_hi, n_slots, remaining,
                            B, N, e);
  }
}

template <int kFmt, bool kGlv>
__global__ void __launch_bounds__(kThreads)
    dfa_kernel(const uint32_t* __restrict__ bx, const uint32_t* __restrict__ by,
               const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
               const uint32_t* __restrict__ inv, const int32_t* __restrict__ table,
               const int32_t* __restrict__ accept, int width, int start,
               const int32_t* __restrict__ remaining, int32_t* __restrict__ out,
               long B, long N) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  const vg::Dfa dfa{table, accept, width, start};
  if constexpr (kGlv) {
    out[e] = vg::glv_dfa_lane<kFmt>(bx, by, tx, ty, inv, dfa, remaining, B, N, e);
  } else {
    out[e] = vg::dfa_lane<kFmt>(bx, by, tx, ty, inv, dfa, remaining, B, N, e);
  }
}

template <bool kGlv>
int launch_interval(const void* bx, const void* by, const void* tx,
                    const void* ty, const void* inv, const void* lo,
                    const void* hi, int n_slots, const void* remaining,
                    void* out, int K, int B, void* stream) {
  const long N = (long)K * B;
  const unsigned blocks = (unsigned)((N + kThreads - 1) / kThreads);
  interval_kernel<kGlv><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)tx,
      (const uint32_t*)ty, (const uint32_t*)inv, (const uint32_t*)lo,
      (const uint32_t*)hi, n_slots, (const int32_t*)remaining, (int32_t*)out,
      (long)B, N);
  return (int)cudaGetLastError();
}

template <bool kGlv>
int launch_dfa(const void* bx, const void* by, const void* tx, const void* ty,
               const void* inv, const void* table, const void* accept,
               int width, int start, int fmt, const void* remaining, void* out,
               int K, int B, void* stream) {
  if (fmt != vg::kFmtP2PKH && fmt != vg::kFmtP2WPKH) return (int)cudaErrorInvalidValue;
  const long N = (long)K * B;
  const unsigned blocks = (unsigned)((N + kThreads - 1) / kThreads);
  auto kernel = fmt == vg::kFmtP2PKH ? dfa_kernel<vg::kFmtP2PKH, kGlv>
                                     : dfa_kernel<vg::kFmtP2WPKH, kGlv>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)tx,
      (const uint32_t*)ty, (const uint32_t*)inv, (const int32_t*)table,
      (const int32_t*)accept, width, start, (const int32_t*)remaining,
      (int32_t*)out, (long)B, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bx (K, 8), tx (8, B) -> out (8, K*B); scratch (8, K*B); M divides K*B.
int vgen_batch_inverse_dx(const void* bx, const void* tx, void* out,
                          void* scratch, int K, int B, int M, void* stream) {
  const long N = (long)K * B;
  const long T = N / M;
  const unsigned blocks = (unsigned)((T + kThreads - 1) / kThreads);
  inv_dx_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bx, (const uint32_t*)tx, (uint32_t*)out,
      (uint32_t*)scratch, (long)B, N, T, M);
  return (int)cudaGetLastError();
}

// bx, by (K, 8); tx, ty (8, B); inv (8, K*B); lo, hi (n_slots, 5) with
// n_slots <= 8; remaining (K,) -> out (K, B) int32 variant masks.
int vgen_range_glv_match(const void* bx, const void* by, const void* tx,
                         const void* ty, const void* inv, const void* lo,
                         const void* hi, int n_slots, const void* remaining,
                         void* out, int K, int B, void* stream) {
  return launch_interval<true>(bx, by, tx, ty, inv, lo, hi, n_slots, remaining,
                               out, K, B, stream);
}

// Kernel C.  Same arguments as vgen_range_glv_match -> out (K, B) 0/1.
int vgen_range_match(const void* bx, const void* by, const void* tx,
                     const void* ty, const void* inv, const void* lo,
                     const void* hi, int n_slots, const void* remaining,
                     void* out, int K, int B, void* stream) {
  return launch_interval<false>(bx, by, tx, ty, inv, lo, hi, n_slots,
                                remaining, out, K, B, stream);
}

// Kernels D (glv = 0) and E (glv = 1).  bx, by (K, 8); tx, ty (8, B);
// inv (8, K*B); table (S, width) and accept (S,) int32; fmt 0 = P2PKH,
// 1 = P2WPKH; remaining (K,) -> out (K, B): 0/1 (D) or the 6-bit mask (E).
int vgen_dfa_match(const void* bx, const void* by, const void* tx,
                   const void* ty, const void* inv, const void* table,
                   const void* accept, int width, int start, int fmt,
                   const void* remaining, void* out, int K, int B,
                   void* stream) {
  return launch_dfa<false>(bx, by, tx, ty, inv, table, accept, width, start,
                           fmt, remaining, out, K, B, stream);
}

int vgen_glv_dfa_match(const void* bx, const void* by, const void* tx,
                       const void* ty, const void* inv, const void* table,
                       const void* accept, int width, int start, int fmt,
                       const void* remaining, void* out, int K, int B,
                       void* stream) {
  return launch_dfa<true>(bx, by, tx, ty, inv, table, accept, width, start,
                          fmt, remaining, out, K, B, stream);
}

}  // extern "C"
