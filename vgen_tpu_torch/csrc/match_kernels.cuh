// Kernels B to E as templates on the address format, and their launchers
// over a list of formats (kernels.cu instantiates them for the five hash
// formats).  Each launcher takes the caller's stream, launches without
// synchronising, and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a format not in its list.
#pragma once

#include <cuda_runtime.h>

#include "scan_lanes.cuh"

namespace vg {

constexpr int kMatchThreads = 256;

// Kernels B (kGlv) and C: the interval table (at most 8 slots) is staged in
// shared memory.
template <int kFmt, bool kGlv>
__global__ void __launch_bounds__(kMatchThreads)
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
    out[e] = range_glv_lane<kFmt>(bx, by, tx, ty, inv, s_lo, s_hi, n_slots,
                                  remaining, B, N, e);
  } else {
    out[e] = range_lane<kFmt>(bx, by, tx, ty, inv, s_lo, s_hi, n_slots,
                              remaining, B, N, e);
  }
}

// Kernels D and E (kGlv).
template <int kFmt, bool kGlv>
__global__ void __launch_bounds__(kMatchThreads)
    dfa_kernel(const uint32_t* __restrict__ bx, const uint32_t* __restrict__ by,
               const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
               const uint32_t* __restrict__ inv, const int32_t* __restrict__ table,
               const int32_t* __restrict__ accept, int width, int start,
               const int32_t* __restrict__ remaining, int32_t* __restrict__ out,
               long B, long N) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  const Dfa dfa{table, accept, width, start};
  if constexpr (kGlv) {
    out[e] = glv_dfa_lane<kFmt>(bx, by, tx, ty, inv, dfa, remaining, B, N, e);
  } else {
    out[e] = dfa_lane<kFmt>(bx, by, tx, ty, inv, dfa, remaining, B, N, e);
  }
}

inline unsigned match_blocks(long N) {
  return (unsigned)((N + kMatchThreads - 1) / kMatchThreads);
}

// Launch kernel B (kGlv) or C for format fmt, the first of kFmts it equals.
template <bool kGlv, int kFmt, int... kRest>
int launch_interval(int fmt, const void* bx, const void* by, const void* tx,
                    const void* ty, const void* inv, const void* lo,
                    const void* hi, int n_slots, const void* remaining,
                    void* out, int K, int B, void* stream) {
  if (fmt != kFmt) {
    if constexpr (sizeof...(kRest) > 0) {
      return launch_interval<kGlv, kRest...>(fmt, bx, by, tx, ty, inv, lo, hi,
                                             n_slots, remaining, out, K, B,
                                             stream);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  const long N = (long)K * B;
  interval_kernel<kFmt, kGlv><<<match_blocks(N), kMatchThreads, 0,
                                (cudaStream_t)stream>>>(
      (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)tx,
      (const uint32_t*)ty, (const uint32_t*)inv, (const uint32_t*)lo,
      (const uint32_t*)hi, n_slots, (const int32_t*)remaining, (int32_t*)out,
      (long)B, N);
  return (int)cudaGetLastError();
}

// Launch kernel D or E (kGlv) for format fmt, the first of kFmts it equals.
template <bool kGlv, int kFmt, int... kRest>
int launch_dfa(int fmt, const void* bx, const void* by, const void* tx,
               const void* ty, const void* inv, const void* table,
               const void* accept, int width, int start, const void* remaining,
               void* out, int K, int B, void* stream) {
  if (fmt != kFmt) {
    if constexpr (sizeof...(kRest) > 0) {
      return launch_dfa<kGlv, kRest...>(fmt, bx, by, tx, ty, inv, table, accept,
                                        width, start, remaining, out, K, B,
                                        stream);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  const long N = (long)K * B;
  dfa_kernel<kFmt, kGlv><<<match_blocks(N), kMatchThreads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)tx,
      (const uint32_t*)ty, (const uint32_t*)inv, (const int32_t*)table,
      (const int32_t*)accept, width, start, (const int32_t*)remaining,
      (int32_t*)out, (long)B, N);
  return (int)cudaGetLastError();
}

}  // namespace vg
