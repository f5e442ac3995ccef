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
//   compression from the host midstate), t < n, and Q = P + t*G by fixed
//   windows of lean Jacobian mixed adds -> X, Z (8, N) and ok.  Y is not
//   written: nothing reads it.
//   Bound: 32-bit integer multiply throughput.  Each window with a nonzero
//   digit is one lean add (8 multiplies, 3 squarings), against one SHA-256
//   compression; it reads 96 bytes (plus the 64-byte table entry of each
//   nonzero digit, served by L2) and writes 68 per lane.
//   Design: the window is a template parameter, (kBits, kSigned) of
//   p2tr_lanes.cuh LadderWindows, instanced below for the widths
//   vgen_tpu_torch.ops.fused.LADDER_WINDOWS lists; the launcher takes the
//   width and signedness and the table of that schedule (scan/tables.py
//   ladder_table).  Wider windows cut the adds (8 bits: 32 windows; 16
//   signed, the product's: 17, 16.5 nonzero) for a larger table (512 KB;
//   34 MiB, still within L2's 50 MB); signed digits halve the table for
//   one negation of y per negative digit.  The TPU selected
//   table entries by a one-hot byte-plane matmul (p2tr_planes); here each
//   thread reads table[w][digit] by index through the read-only path in
//   four 16-byte loads.  The digits come out of t by shifts on registers
//   and the window loop is not unrolled, to keep the code and register
//   footprint of one lean add.
//
// Kernel G, batch_inverse_chain
//   Replaces _inv_chain_calls(C, guard_zero=True) (its fwd, inv and bwd
//   pallas_calls) as driven by batch_inverse_chain_pallas.
//   Computes: canonical inverses of an (8, N) array, zero guarded to 1.
//   Bound: 32-bit integer multiply throughput, as kernel A (3 multiplies
//   per element, one inversion per group of M * G elements and the
//   group's product tree).
//   Design: kernel A's block (inv_block.cuh) with the input read straight
//   from the array.
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
//   Replaces _make_p2tr_finish_match_kernel (kernel :978) as called through
//   p2tr_finish_match_fn.
//   Computes: qx as in H, the bech32m address of witness v1 (52 five-bit
//   groups and the checksum, 59 symbols) and the DFA walk of T + 1 = 60
//   steps -> 0/1.
//   Bound: memory, 100 bytes read and 4 written per lane, against the
//   field multiply and squaring, 52 table lookups and the latency of the
//   walk's 60 dependent table loads.
//   Design (the H100 redesign; the per-lane form, p2tr_dfa_lane, stays
//   in the probe unit as i_lane, probes/p2tr_match_lanes.cuh): tiles of 256 lanes
//   of one window, one per block over a (tiles per window, K) grid
//   (p2tr_lanes.cuh p2tr_finish_tile), so no lane divides by B and a lane
//   at or past remaining[k] loads nothing; the symbols walked in registers
//   as they are made (dfa.cuh bech32m_p2tr_walk: no per-thread array);
//   the checksum a XOR of 52 independent table lookups (encode.cuh
//   bech32m_p2tr_checksum), where the polymod's chain of 58 dependent
//   steps took 0.246 of 0.452 ms (NVIDIA H100 80GB HBM3, 700 W; python -m
//   vgen_tpu_torch.probes.profile_p2tr_match); the table in kernel D's
//   two forms (dfa.cuh with_dfa_table), the narrow one copied into shared
//   memory where the wrapper chooses it (vgen_tpu_torch/ops/fused.py
//   dfa_form, up to the form's cap for I), else the int32 one through the
//   read-only cache; no state cap.

#include <cuda_runtime.h>

#include <type_traits>

#include "inv_block.cuh"
#include "p2tr_lanes.cuh"

namespace {

constexpr int kThreads = vg::kLadderThreads;  // kernels F and H

template <bool kFinish, int kBits, bool kSigned>
__global__ void __launch_bounds__(kThreads)
    ladder_kernel(const uint32_t* __restrict__ bx, const uint32_t* __restrict__ by,
                  const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
                  const uint32_t* __restrict__ inv, const uint32_t* __restrict__ table,
                  uint32_t* __restrict__ X, uint32_t* __restrict__ Z,
                  int32_t* __restrict__ ok, long B, long N) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  if constexpr (kFinish) {
    ok[e] = vg::p2tr_ladder_lane<kBits, kSigned>(bx, by, tx, ty, inv, table, X,
                                                 Z, B, N, e);
  } else {
    // affine input: (tx, ty) hold the internal keys' (x, y)
    ok[e] = vg::p2tr_ladder_affine_lane<kBits, kSigned>(tx, ty, table, X, Z, N,
                                                        e);
  }
}

// The ladder's window schedules (kBits, kSigned), as
// vgen_tpu_torch/ops/fused.py LADDER_WINDOWS lists them
#define VG_LADDER_WINDOWS(X)                                           \
  X(8, false) X(12, false) X(13, false) X(14, false) X(13, true)       \
      X(14, true) X(15, true) X(16, true)

unsigned blocks_for(long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

// Launch kernel F with the schedule (bits, sgn); false for one that is not
// instanced.
template <bool kFinish>
bool launch_ladder(int bits, int sgn, const uint32_t* bx, const uint32_t* by,
                   const uint32_t* tx, const uint32_t* ty, const uint32_t* inv,
                   const uint32_t* table, uint32_t* X, uint32_t* Z, int32_t* ok,
                   long B, long N, cudaStream_t stream) {
#define VG_LAUNCH_LADDER(kBits, kSigned)                                  \
  if (bits == kBits && (sgn != 0) == kSigned) {                           \
    ladder_kernel<kFinish, kBits, kSigned>                                \
        <<<blocks_for(N), kThreads, 0, stream>>>(bx, by, tx, ty, inv, table, \
                                                 X, Z, ok, B, N);         \
    return true;                                                          \
  }
  VG_LADDER_WINDOWS(VG_LAUNCH_LADDER)
#undef VG_LAUNCH_LADDER
  return false;
}

__global__ void __launch_bounds__(vg::kInvThreads, 1)
    inv_chain_kernel(const uint32_t* __restrict__ v, uint32_t* __restrict__ out,
                     uint32_t* __restrict__ scratch, long N, long T, int M,
                     int G) {
  vg::inv_block(vg::GuardedInput{v, N, T}, out, scratch, N, T, M, G);
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

// Kernel I: one tile of 256 lanes of window blockIdx.y per block, the
// table in form kShared (with_dfa_table).
template <bool kShared>
__global__ void __launch_bounds__(vg::kTileLanes)
    finish_match_tile_kernel(const uint32_t* __restrict__ X,
                             const uint32_t* __restrict__ Z,
                             const uint32_t* __restrict__ zi,
                             const int32_t* __restrict__ ok,
                             const void* __restrict__ table,
                             const void* __restrict__ accept, int n_states,
                             int width, int start,
                             const int32_t* __restrict__ remaining,
                             int32_t* __restrict__ out, int K, int B) {
  extern __shared__ __align__(16) uint32_t s_table[];
  vg::with_dfa_table<kShared>(
      table, accept, n_states, width, start, s_table, [&](const auto& dfa) {
        using D = std::decay_t<decltype(dfa)>;
        vg::p2tr_finish_tile(vg::Bech32mWalk<D>{dfa}, X, Z, zi, ok, remaining,
                             out, K, B, blockIdx.y, blockIdx.x, threadIdx.x);
      });
}

}  // namespace

extern "C" {

// Kernel F.  bx, by (K, 8); tx, ty (8, B); inv (8, K*B); table of the
// schedule (bits, sgn) (windows, entries, 2, 8) -> X, Z (8, K*B), ok
// (K*B,); cudaErrorInvalidValue for a schedule that is not instanced.
int vgen_p2tr_ladder(const void* bx, const void* by, const void* tx,
                     const void* ty, const void* inv, const void* table, void* X,
                     void* Z, void* ok, int K, int B, int bits, int sgn,
                     void* stream) {
  if (!launch_ladder<true>(bits, sgn, (const uint32_t*)bx, (const uint32_t*)by,
                           (const uint32_t*)tx, (const uint32_t*)ty,
                           (const uint32_t*)inv, (const uint32_t*)table,
                           (uint32_t*)X, (uint32_t*)Z, (int32_t*)ok, (long)B,
                           (long)K * B, (cudaStream_t)stream))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Kernel F with finish=False.  x, y (8, N) affine internal keys -> X, Z
// (8, N), ok (N,).
int vgen_p2tr_ladder_affine(const void* x, const void* y, const void* table,
                            void* X, void* Z, void* ok, int N, int bits, int sgn,
                            void* stream) {
  if (!launch_ladder<false>(bits, sgn, nullptr, nullptr, (const uint32_t*)x,
                            (const uint32_t*)y, nullptr, (const uint32_t*)table,
                            (uint32_t*)X, (uint32_t*)Z, (int32_t*)ok, (long)N,
                            (long)N, (cudaStream_t)stream))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Kernel G.  v (8, N) -> out (8, N); scratch (8, N); M divides N; groups of
// G chains share an inversion (inv_block.cuh).
int vgen_batch_inverse_chain(const void* v, void* out, void* scratch, int N,
                             int M, int G, void* stream) {
  if (!vg::inv_group_ok(G)) return (int)cudaErrorInvalidValue;
  const long T = (long)N / M;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* v_ = (const uint32_t*)v;
  uint32_t *out_ = (uint32_t*)out, *scratch_ = (uint32_t*)scratch;
  return vg::inv_launch(inv_chain_kernel, T, s, v_, out_, scratch_, (long)N,
                        T, M, G);
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

// Kernel I.  X, Z, zi, ok, remaining as kernel H.  shared: table
// (n_states, width) uint16 and accept (n_states,) uint8, at most
// vg::kDfaSharedMax bytes together, width even; else both int32; width 34
// -> out (K, B) 0/1.
int vgen_p2tr_finish_match(int shared, const void* X, const void* Z,
                           const void* zi, const void* ok, const void* table,
                           const void* accept, int n_states, int width,
                           int start, const void* remaining, void* out, int K,
                           int B, void* stream) {
  const long table_bytes = (long)n_states * width * 2 + n_states;
  if (shared && (width % 2 || table_bytes > vg::kDfaSharedMax))
    return (int)cudaErrorInvalidValue;
  if ((long)K * B == 0) return 0;
  const auto kernel =
      shared ? finish_match_tile_kernel<true> : finish_match_tile_kernel<false>;
  kernel<<<vg::tile_grid(K, B), vg::kTileLanes, shared ? (int)table_bytes : 0,
           (cudaStream_t)stream>>>(
      (const uint32_t*)X, (const uint32_t*)Z, (const uint32_t*)zi,
      (const int32_t*)ok, table, accept, n_states, width, start,
      (const int32_t*)remaining, (int32_t*)out, K, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
