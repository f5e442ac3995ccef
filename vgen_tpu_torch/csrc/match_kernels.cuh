// Kernels B to E as templates on the address format, and their launchers
// over a list of formats (kernels.cu instantiates them for the five hash
// formats).  Each launcher takes the caller's stream, launches without
// synchronising, and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a format not in its list.
//
// B and E run one thread per lane over a grid of N / 256 blocks
// (interval_kernel, dfa_kernel with kGlv); their kGlv = false instances
// are kernels C and D on the per-lane grid, which the probe unit keeps for
// comparison.  The product's C and D take tiles of 256 lanes of one
// window, one tile per block (range_tile_kernel and the two table forms
// of D, dfa_tile_kernel<kFmt, kShared>).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "scan_lanes.cuh"

namespace vg {

constexpr int kMatchThreads = 256;

// Kernel C's interval table (at most 8 slots of 5 words) into the block's
// shared memory s_lo, s_hi.
__device__ __forceinline__ void stage_intervals(uint32_t* s_lo, uint32_t* s_hi,
                                                const uint32_t* lo,
                                                const uint32_t* hi,
                                                int n_slots) {
  for (int i = threadIdx.x; i < n_slots * 5; i += blockDim.x) {
    s_lo[i] = lo[i];
    s_hi[i] = hi[i];
  }
  __syncthreads();
}

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

// Kernel C: one tile of 256 lanes of window blockIdx.y per block.
template <int kFmt>
__global__ void __launch_bounds__(kTileLanes)
    range_tile_kernel(const uint32_t* __restrict__ bx,
                      const uint32_t* __restrict__ by,
                      const uint32_t* __restrict__ tx,
                      const uint32_t* __restrict__ ty,
                      const uint32_t* __restrict__ inv,
                      const uint32_t* __restrict__ lo,
                      const uint32_t* __restrict__ hi, int n_slots,
                      const int32_t* __restrict__ remaining,
                      int32_t* __restrict__ out, int K, int B) {
  __shared__ uint32_t s_lo[8 * 5], s_hi[8 * 5];
  stage_intervals(s_lo, s_hi, lo, hi, n_slots);
  const SingleKeyLane<kFmt, IntervalHit> lane{bx, by, {s_lo, s_hi, n_slots}};
  single_key_tile(lane, tx, ty, inv, remaining, out, K, B, blockIdx.y,
                  blockIdx.x, threadIdx.x);
}

// Kernel D, C's tiles: the address walked in registers (dfa.cuh
// address_walk) over the table in form kShared (with_dfa_table).
template <int kFmt, bool kShared>
__global__ void __launch_bounds__(kTileLanes)
    dfa_tile_kernel(const uint32_t* __restrict__ bx,
                    const uint32_t* __restrict__ by,
                    const uint32_t* __restrict__ tx,
                    const uint32_t* __restrict__ ty,
                    const uint32_t* __restrict__ inv,
                    const void* __restrict__ table,
                    const void* __restrict__ accept, int n_states, int width,
                    int start, const int32_t* __restrict__ remaining,
                    int32_t* __restrict__ out, int K, int B) {
  extern __shared__ __align__(16) uint32_t s_table[];
  with_dfa_table<kShared>(
      table, accept, n_states, width, start, s_table, [&](const auto& dfa) {
        using D = std::decay_t<decltype(dfa)>;
        const SingleKeyLane<kFmt, WalkHit<kFmt, D>> lane{bx, by, {dfa}};
        single_key_tile(lane, tx, ty, inv, remaining, out, K, B, blockIdx.y,
                        blockIdx.x, threadIdx.x);
      });
}

// f(std::integral_constant<int, fmt>) for the first of kFmts that equals
// fmt, or cudaErrorInvalidValue
template <int kFmt, int... kRest, class F>
int for_format(int fmt, F&& f) {
  if (fmt == kFmt) return f(std::integral_constant<int, kFmt>{});
  if constexpr (sizeof...(kRest) > 0) {
    return for_format<kRest...>(fmt, f);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// Launch kernel C for fmt: same arguments as launch_interval.
template <int... kFmts>
int launch_range_tiles(int fmt, const void* bx, const void* by,
                       const void* tx, const void* ty, const void* inv,
                       const void* lo, const void* hi, int n_slots,
                       const void* remaining, void* out, int K, int B,
                       void* stream) {
  return for_format<kFmts...>(fmt, [&](auto f) {
    if ((long)K * B == 0) return 0;
    range_tile_kernel<decltype(f)::value>
        <<<tile_grid(K, B), kTileLanes, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)tx,
            (const uint32_t*)ty, (const uint32_t*)inv, (const uint32_t*)lo,
            (const uint32_t*)hi, n_slots, (const int32_t*)remaining,
            (int32_t*)out, K, B);
    return (int)cudaGetLastError();
  });
}

// Launch kernel D for fmt.  shared: table (n_states, width) uint16 and
// accept (n_states,) uint8, at most kDfaSharedMax bytes together, width
// even; else both int32.
template <int... kFmts>
int launch_dfa_tiles(int fmt, int shared, const void* bx, const void* by,
                     const void* tx, const void* ty, const void* inv,
                     const void* table, const void* accept, int n_states,
                     int width, int start, const void* remaining, void* out,
                     int K, int B, void* stream) {
  const long table_bytes = (long)n_states * width * 2 + n_states;
  if (shared && (width % 2 || table_bytes > kDfaSharedMax))
    return (int)cudaErrorInvalidValue;
  return for_format<kFmts...>(fmt, [&](auto f) {
    constexpr int kFmt = decltype(f)::value;
    if ((long)K * B == 0) return 0;
    const auto kernel = shared ? dfa_tile_kernel<kFmt, true>
                               : dfa_tile_kernel<kFmt, false>;
    kernel<<<tile_grid(K, B), kTileLanes, shared ? (int)table_bytes : 0,
             (cudaStream_t)stream>>>(
        (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)tx,
        (const uint32_t*)ty, (const uint32_t*)inv, table, accept, n_states,
        width, start, (const int32_t*)remaining, (int32_t*)out, K, B);
    return (int)cudaGetLastError();
  });
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
