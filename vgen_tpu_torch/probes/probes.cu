// The ten probe kernels, for the measurement tools of
// vgen_tpu_torch/probes (never launched by a scan).  They replace the
// TPU probes of scripts/:
//
// - probe_primitive<kPrim>: scripts/roofline.py:162 (make, body _body,
//   feedback _feedback): R dependent repetitions of one production
//   primitive of csrc/ per lane;
// - probe_issue<kOp, kChains>: scripts/microbench_vpu.py:66 (make): R
//   repetitions of one instruction in kChains dependent chains per lane;
// - probe_fieldmul<kMode>: scripts/microbench_fieldmul.py:120 (make): R
//   repetitions of one part of the field multiply or one hash;
// - probe_glv_stage<kMode>: scripts/profile_glv.py:165 (make_kernel :87):
//   kernel B's P2PKH lane cut down by stage, to split B's time;
// - probe_vtile<kKeysPerThread>: scripts/proto_vtile.py:65
//   (make_vtile_range_glv :40): kernel B's P2PKH lane over blocks of T
//   threads and V keys per thread;
// - probe_rows<kShape, kMul>: scripts/microbench_rows.py:51, :69, :92
//   (make_row1d, make_row2d, make_full2d): one dependent chain per lane
//   over two block shapes, or 16 independent chains;
// - probe_layout<kLayout>: scripts/microbench_layout.py:75 (make :60): R
//   chained field multiplies with the operands in one of four layouts;
// - probe_single_key<kStage>: no TPU probe; kernel D's P2PKH lane over the
//   product's tiles cut after a stage, for profile_dfa.py, which also
//   launches C and D over the persistent tile loop (probe_range_tiles,
//   probe_dfa_tiles), D with kernel E's symbol arrays, and C and D on the
//   per-lane grid (match_kernels.cuh interval_kernel, dfa_kernel);
// - probe_p2tr_match<kMode, kShared>: no TPU probe; kernel I's lane over
//   the product's tiles cut after a stage (qx, the bech32m checksum by
//   table lookups and by the polymod) or walking with the polymod's
//   checksum or a per-thread symbol array, in either table form, for
//   profile_p2tr_match.py, which also launches the product's walk under a
//   minimum of 4 blocks per SM (probe_p2tr_match_bounded) and the
//   per-lane kernel I (probe_p2tr_match_lane, the per-lane grid);
// - probe_ladder_stage<kStage>: no TPU probe; kernel F's lane at the
//   product's window schedule cut after a stage, for profile_ladder.py.
//
// The TPU probes timed (16, 8, 512) VMEM tiles of 16-bit limbs and
// one-hot matmuls; here a lane is one thread on 32-bit limbs, the layout
// of kernels A to I, and the DFA step is a table load.  The first three
// are bound by their repetitions' operations (the loads and stores are
// two (8, N) reads and one write), which is what they measure.  The stage
// and tile probes are bound as kernel B is, by the hashes' ALU work (96
// bytes read and 4 written per lane); the row chains by their add, rotate
// and XOR (or multiply) per step, and by the latency of one dependent
// chain where too few warps run; the layout probe by its multiplies at R
// = 8 and by its 96 bytes per lane at R = 1.  Built into its own library
// (csrc/build.py unit "probes"), so the product's units do not grow.
#include <cuda_runtime.h>

#include <type_traits>

#include "geometry_lanes.cuh"
#include "inv_stages.cuh"
#include "ladder_stages.cuh"
#include "match_kernels.cuh"
#include "p2tr_match_lanes.cuh"
#include "single_key_lanes.cuh"

namespace {

using namespace vg;
using namespace vg::probe;

constexpr int kBlock = 128;

// dfachar60s stages the (64, 60) table in shared memory as kernel D's
// narrow form (uint16), the other instances read the int32 table
template <int kPrim>
__global__ void probe_primitive(const uint32_t* a_in, const uint32_t* b_in,
                                const int32_t* table, uint32_t* out, long n,
                                int reps) {
  constexpr bool kShared = kPrim == kDfaChar60Shared;
  __shared__ uint16_t s_table[kShared ? kDfaStates * kDfaWidth : 1];
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < kDfaStates * kDfaWidth; i += blockDim.x)
      s_table[i] = (uint16_t)table[i];
    __syncthreads();
  }
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t a[8], b[8], r[8];
  fe_load(a, a_in, n, e);
  fe_load(b, b_in, n, e);
  if constexpr (kShared) {
    primitive_lane<kPrim>(r, a, b, (const uint16_t*)s_table, reps);
  } else {
    primitive_lane<kPrim>(r, a, b, table, reps);
  }
  fe_store(out, n, e, r);
}

template <int kOp, int kChains>
__global__ void probe_issue(const uint32_t* a_in, const uint32_t* b_in,
                            uint32_t* out, long n, int reps) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t a[8], b[8], r[8];
  fe_load(a, a_in, n, e);
  fe_load(b, b_in, n, e);
  issue_lane<kOp, kChains>(r, a, b, reps);
  fe_store(out, n, e, r);
}

template <int kMode>
__global__ void probe_fieldmul(const uint32_t* a_in, const uint32_t* b_in,
                               uint32_t* out, long n, int reps) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t a[8], b[8], r[8];
  fe_load(a, a_in, n, e);
  fe_load(b, b_in, n, e);
  fieldmul_lane<kMode>(r, a, b, reps);
  fe_store(out, n, e, r);
}

// kernel F's block and the product's window schedule (p2tr_lanes.cuh)
template <int kStage>
__global__ void __launch_bounds__(kLadderThreads)
    probe_ladder_stage(const uint32_t* __restrict__ bx,
                       const uint32_t* __restrict__ by,
                       const uint32_t* __restrict__ tx,
                       const uint32_t* __restrict__ ty,
                       const uint32_t* __restrict__ inv,
                       const uint32_t* __restrict__ table,
                       uint32_t* __restrict__ X, uint32_t* __restrict__ Z,
                       int32_t* __restrict__ ok, long B, long N) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  ok[e] = ladder_stage_lane<kStage, kLadderBits, kLadderSigned>(
      bx, by, tx, ty, inv, table, X, Z, B, N, e);
}

// kernel B's staging of the interval table (at most 8 slots)
__device__ __forceinline__ void stage_intervals(uint32_t* s_lo, uint32_t* s_hi,
                                                const uint32_t* lo,
                                                const uint32_t* hi,
                                                int n_slots) {
  for (int i = threadIdx.x + threadIdx.y * blockDim.x; i < n_slots * 5;
       i += blockDim.x * blockDim.y) {
    s_lo[i] = lo[i];
    s_hi[i] = hi[i];
  }
  __syncthreads();
}

template <int kMode>
__global__ void __launch_bounds__(kStageThreads)
    probe_glv_stage(const uint32_t* __restrict__ bx,
                    const uint32_t* __restrict__ by,
                    const uint32_t* __restrict__ tx,
                    const uint32_t* __restrict__ ty,
                    const uint32_t* __restrict__ inv,
                    const uint32_t* __restrict__ lo,
                    const uint32_t* __restrict__ hi, int n_slots,
                    const int32_t* __restrict__ remaining,
                    int32_t* __restrict__ out, long B, long N) {
  __shared__ uint32_t s_lo[8 * 5], s_hi[8 * 5];
  stage_intervals(s_lo, s_hi, lo, hi, n_slots);
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N / kStageLanesPerThread<kMode>) return;
  glv_stage_thread<kMode>(bx, by, tx, ty, inv, s_lo, s_hi, n_slots, remaining,
                          out, B, N, t);
}

template <int kKeysPerThread>
__global__ void __launch_bounds__(kVtileMaxThreads)
    probe_vtile(const uint32_t* __restrict__ bx, const uint32_t* __restrict__ by,
                const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
                const uint32_t* __restrict__ inv,
                const uint32_t* __restrict__ lo,
                const uint32_t* __restrict__ hi, int n_slots,
                const int32_t* __restrict__ remaining,
                int32_t* __restrict__ out, long B, long N) {
  __shared__ uint32_t s_lo[8 * 5], s_hi[8 * 5];
  stage_intervals(s_lo, s_hi, lo, hi, n_slots);
  vtile_thread<kKeysPerThread>(bx, by, tx, ty, inv, s_lo, s_hi, n_slots,
                               remaining, out, B, N, blockIdx.x, blockDim.x,
                               threadIdx.x);
}

// x (16, lanes) -> out (1, lanes), or (16, lanes) for full2d; the lane of
// a thread counts along x, then y (row2d's blocks are (128, T / 128)).  The
// one-chain shapes hold 17 live words, so two blocks of 1024 threads fit
// an SM (32 registers a thread: 16 warps per scheduler); full2d's 32 words
// do not.
template <int kShape, int kMul>
__global__ void __launch_bounds__(kRowThreads, kShape == kFull2d ? 1 : 2)
    probe_rows(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               long lanes, int steps) {
  const long lane = (long)blockIdx.x * (blockDim.x * blockDim.y) +
                    threadIdx.y * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t xs[16], r[16];
#pragma unroll
  for (int i = 0; i < 16; i++) xs[i] = x[i * lanes + lane];
  rows_lane<kShape, kMul>(r, xs, steps);
#pragma unroll
  for (int i = 0; i < (kShape == kFull2d ? 16 : 1); i++)
    out[i * lanes + lane] = r[i];
}

template <int kLayout>
__global__ void probe_layout(const uint32_t* __restrict__ a,
                             const uint32_t* __restrict__ b,
                             uint32_t* __restrict__ out, long n, int reps) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  layout_lane<kLayout>(out, a, b, n, e, reps);
}

// Thread threadIdx.x's lanes of kernel C or D under schedule kSchedule
// (stage: the prefetch's buffer, at the start of dynamic shared memory).
template <int kSchedule, class Lane>
__device__ __forceinline__ void run_tiles(const Lane& lane, const uint32_t* tx,
                                          const uint32_t* ty,
                                          const uint32_t* inv,
                                          const int32_t* remaining,
                                          int32_t* out, int K, int B,
                                          uint32_t* stage) {
  if constexpr (kSchedule == kTileGrid) {
    single_key_tile(lane, tx, ty, inv, remaining, out, K, B, blockIdx.y,
                    blockIdx.x, threadIdx.x);
  } else {
    single_key_tiles<kSchedule == kTilePrefetch>(
        lane, tx, ty, inv, remaining, out, K, B, blockIdx.x, gridDim.x,
        threadIdx.x, stage);
  }
}

template <int kSchedule>
constexpr int kStageOf = kSchedule == kTilePrefetch ? kStageBytes : 0;

// Kernel C (P2PKH) under schedule kSchedule.
template <int kSchedule>
__global__ void __launch_bounds__(kTileLanes)
    probe_range_tiles(const uint32_t* __restrict__ bx,
                      const uint32_t* __restrict__ by,
                      const uint32_t* __restrict__ tx,
                      const uint32_t* __restrict__ ty,
                      const uint32_t* __restrict__ inv,
                      const uint32_t* __restrict__ lo,
                      const uint32_t* __restrict__ hi, int n_slots,
                      const int32_t* __restrict__ remaining,
                      int32_t* __restrict__ out, int K, int B) {
  extern __shared__ __align__(16) uint32_t dyn[];
  __shared__ uint32_t s_lo[8 * 5], s_hi[8 * 5];
  stage_intervals(s_lo, s_hi, lo, hi, n_slots);
  const SingleKeyLane<kFmtP2PKH, IntervalHit> lane{bx, by,
                                                   {s_lo, s_hi, n_slots}};
  run_tiles<kSchedule>(lane, tx, ty, inv, remaining, out, K, B, dyn);
}

// Kernel D under schedule kSchedule, its table in form kShared (after the
// stage buffer), the symbols walked in registers or (kArrays) in a
// per-thread array.
template <int kFmt, int kSchedule, bool kArrays, bool kShared>
__global__ void __launch_bounds__(kTileLanes)
    probe_dfa_tiles(const uint32_t* __restrict__ bx,
                    const uint32_t* __restrict__ by,
                    const uint32_t* __restrict__ tx,
                    const uint32_t* __restrict__ ty,
                    const uint32_t* __restrict__ inv,
                    const void* __restrict__ table,
                    const void* __restrict__ accept, int n_states, int width,
                    int start, const int32_t* __restrict__ remaining,
                    int32_t* __restrict__ out, int K, int B) {
  extern __shared__ __align__(16) uint32_t dyn[];
  with_dfa_table<kShared>(
      table, accept, n_states, width, start, dyn + kStageOf<kSchedule> / 4,
      [&](const auto& dfa) {
        using D = std::decay_t<decltype(dfa)>;
        using Hit = std::conditional_t<kArrays, ArrayHit<kFmt, D>,
                                       WalkHit<kFmt, D>>;
        const SingleKeyLane<kFmt, Hit> lane{bx, by, {dfa}};
        run_tiles<kSchedule>(lane, tx, ty, inv, remaining, out, K, B, dyn);
      });
}

// Kernel D's P2PKH lane cut after stage kStage, one tile per block.
template <int kStage>
__global__ void __launch_bounds__(kTileLanes)
    probe_single_key(const uint32_t* __restrict__ bx,
                     const uint32_t* __restrict__ by,
                     const uint32_t* __restrict__ tx,
                     const uint32_t* __restrict__ ty,
                     const uint32_t* __restrict__ inv,
                     const int32_t* __restrict__ remaining,
                     int32_t* __restrict__ out, int K, int B) {
  const StageLane<kStage> lane{bx, by};
  single_key_tile(lane, tx, ty, inv, remaining, out, K, B, blockIdx.y,
                  blockIdx.x, threadIdx.x);
}

// Kernel I's lane cut after stage kMode, or walking in form kShared (the
// register walk with the polymod's checksum, the product's walk, a
// per-thread symbol array), one tile per block, as the product's kernel I.
template <int kMode, bool kShared>
__device__ __forceinline__ void p2tr_match_tile(
    const uint32_t* __restrict__ X, const uint32_t* __restrict__ Z,
    const uint32_t* __restrict__ zi, const int32_t* __restrict__ ok,
    const void* __restrict__ table, const void* __restrict__ accept,
    int n_states, int width, int start, const int32_t* __restrict__ remaining,
    int32_t* __restrict__ out, int K, int B) {
  extern __shared__ __align__(16) uint32_t s_table[];
  if constexpr (kMode == kPmQx || kMode == kPmChecksum ||
                kMode == kPmPolymod) {
    p2tr_finish_tile(P2trStage<kMode>{}, X, Z, zi, ok, remaining, out, K, B,
                     blockIdx.y, blockIdx.x, threadIdx.x);
  } else {
    with_dfa_table<kShared>(
        table, accept, n_states, width, start, s_table, [&](const auto& dfa) {
          using D = std::decay_t<decltype(dfa)>;
          using Match = std::conditional_t<
              kMode == kPmPolymodWalk, Bech32mPolymodWalk<D>,
              std::conditional_t<kMode == kPmArrays, Bech32mArrays<D>,
                                 Bech32mWalk<D>>>;
          p2tr_finish_tile(Match{dfa}, X, Z, zi, ok, remaining, out, K, B,
                           blockIdx.y, blockIdx.x, threadIdx.x);
        });
  }
}

template <int kMode, bool kShared>
__global__ void __launch_bounds__(kTileLanes)
    probe_p2tr_match(const uint32_t* __restrict__ X,
                     const uint32_t* __restrict__ Z,
                     const uint32_t* __restrict__ zi,
                     const int32_t* __restrict__ ok,
                     const void* __restrict__ table,
                     const void* __restrict__ accept, int n_states, int width,
                     int start, const int32_t* __restrict__ remaining,
                     int32_t* __restrict__ out, int K, int B) {
  p2tr_match_tile<kMode, kShared>(X, Z, zi, ok, table, accept, n_states,
                                  width, start, remaining, out, K, B);
}

// kPmBounded: the product's kernel I with a minimum of 4 resident blocks
// per SM (at most 64 registers a thread)
template <bool kShared>
__global__ void __launch_bounds__(kTileLanes, 4)
    probe_p2tr_match_bounded(const uint32_t* __restrict__ X,
                             const uint32_t* __restrict__ Z,
                             const uint32_t* __restrict__ zi,
                             const int32_t* __restrict__ ok,
                             const void* __restrict__ table,
                             const void* __restrict__ accept, int n_states,
                             int width, int start,
                             const int32_t* __restrict__ remaining,
                             int32_t* __restrict__ out, int K, int B) {
  p2tr_match_tile<kPmBounded, kShared>(X, Z, zi, ok, table, accept, n_states,
                                       width, start, remaining, out, K, B);
}

// The per-lane kernel I (kPmLane): one thread per lane over N / 256 blocks,
// k = e / B, the symbols in a per-thread array, the int32 table through
// the read-only cache (p2tr_match_lanes.cuh p2tr_dfa_lane).
__global__ void __launch_bounds__(kTileLanes)
    probe_p2tr_match_lane(const uint32_t* __restrict__ X,
                          const uint32_t* __restrict__ Z,
                          const uint32_t* __restrict__ zi,
                          const int32_t* __restrict__ ok,
                          const int32_t* __restrict__ table,
                          const int32_t* __restrict__ accept, int width,
                          int start, const int32_t* __restrict__ remaining,
                          int32_t* __restrict__ out, long B, long N) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  const Dfa dfa{table, accept, width, start};
  out[e] = p2tr_dfa_lane(X, Z, zi, ok, dfa, remaining, B, N, e);
}

// Launch a tile kernel over K windows of B lanes under schedule kSchedule
// with smem bytes of dynamic shared memory: the grid (tiles per window,
// K), or for the persistent schedules the SM count times the blocks of
// kTileLanes threads resident per SM (the occupancy API), at most the
// tiles.
template <int kSchedule, class Kernel, class... Args>
int launch_tiles(Kernel kernel, int smem, int K, int B, void* stream,
                 Args... args) {
  if ((long)K * B == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid = tile_grid(K, B);
  if constexpr (kSchedule != kTileGrid) {
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kTileLanes, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long g = (long)sms * per_sm, tiles = (long)grid.x * K;
    grid = dim3((unsigned)(g < tiles ? g : tiles));
  }
  kernel<<<grid, kTileLanes, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

unsigned blocks(long n) { return (unsigned)((n + kBlock - 1) / kBlock); }

// f(std::integral_constant<int, code>) for code in [kFirst, kEnd), or
// cudaErrorInvalidValue for another code
template <int kFirst, int kEnd, class F>
int dispatch(int code, F&& f) {
  if constexpr (kFirst >= kEnd) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (code == kFirst) return f(std::integral_constant<int, kFirst>{});
    return dispatch<kFirst + 1, kEnd>(code, f);
  }
}

// k where v = 2^k, k < n; -1 otherwise (the template code of a count of
// chains or keys per thread)
int pow2_code(int v, int n) {
  for (int k = 0; k < n; k++)
    if (v == 1 << k) return k;
  return -1;
}

int launch_primitive(int prim, const void* a, const void* b,
                     const void* table, void* out, int n, int reps,
                     void* stream) {
  return dispatch<0, kNumPrimitives>(prim, [&](auto p) {
    probe_primitive<decltype(p)::value>
        <<<blocks(n), kBlock, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)a, (const uint32_t*)b, (const int32_t*)table,
            (uint32_t*)out, n, reps);
    return (int)cudaGetLastError();
  });
}

// kChains 1, 2, 4 or 8
int launch_issue(int op, int chains, const void* a, const void* b, void* out,
                 int n, int reps, void* stream) {
  return dispatch<0, kNumIssueOps>(op, [&](auto o) {
    return dispatch<0, 4>(pow2_code(chains, 4), [&](auto c) {
      probe_issue<decltype(o)::value, 1 << decltype(c)::value>
          <<<blocks(n), kBlock, 0, (cudaStream_t)stream>>>(
              (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n,
              reps);
      return (int)cudaGetLastError();
    });
  });
}

int launch_fieldmul(int mode, const void* a, const void* b, void* out, int n,
                    int reps, void* stream) {
  return dispatch<0, kNumFieldMulModes>(mode, [&](auto m) {
    probe_fieldmul<decltype(m)::value>
        <<<blocks(n), kBlock, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, reps);
    return (int)cudaGetLastError();
  });
}

// Kernel B's contract (csrc/kernels.cu vgen_range_glv_match) for P2PKH:
// bx, by (K, 8); tx, ty (8, B); inv (8, K*B); lo, hi (n_slots, 5), n_slots
// <= 8; remaining (K,) -> out (K, B) int32.  probe_glv_stage: mode a
// GlvStage (K*B even for the two-lane modes).  probe_vtile: V =
// keys_per_thread in {1, 2, 4}, T = threads in [32, 512] a multiple of 32.
int launch_glv_stage(int mode, const void* bx, const void* by, const void* tx,
                     const void* ty, const void* inv, const void* lo,
                     const void* hi, int n_slots, const void* remaining,
                     void* out, int K, int B, void* stream) {
  const long N = (long)K * B;
  return dispatch<0, kNumGlvStages>(mode, [&](auto m) {
    constexpr int kMode = decltype(m)::value;
    const long threads = N / kStageLanesPerThread<kMode>;
    probe_glv_stage<kMode><<<(unsigned)((threads + kStageThreads - 1) /
                                        kStageThreads),
                             kStageThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)tx,
        (const uint32_t*)ty, (const uint32_t*)inv, (const uint32_t*)lo,
        (const uint32_t*)hi, n_slots, (const int32_t*)remaining, (int32_t*)out,
        (long)B, N);
    return (int)cudaGetLastError();
  });
}

int launch_vtile(int keys_per_thread, int threads, const void* bx,
                 const void* by, const void* tx, const void* ty,
                 const void* inv, const void* lo, const void* hi, int n_slots,
                 const void* remaining, void* out, int K, int B,
                 void* stream) {
  const long N = (long)K * B;
  if (threads < 32 || threads > kVtileMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  return dispatch<0, 3>(pow2_code(keys_per_thread, 3), [&](auto c) {
    constexpr int kKeys = 1 << decltype(c)::value;
    const long tile = (long)kKeys * threads;
    probe_vtile<kKeys><<<(unsigned)((N + tile - 1) / tile), threads, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)tx,
        (const uint32_t*)ty, (const uint32_t*)inv, (const uint32_t*)lo,
        (const uint32_t*)hi, n_slots, (const int32_t*)remaining, (int32_t*)out,
        (long)B, N);
    return (int)cudaGetLastError();
  });
}

// x (16, lanes) uint32 -> out (1, lanes), or (16, lanes) for full2d (shape
// a RowShape, mul 0 or 1); steps a multiple of 64; threads per block a
// multiple of 128 up to 1024, laid out (128, threads / 128) for row2d.
int launch_rows(int shape, int mul, const void* x, void* out, int lanes,
                int steps, int threads, void* stream) {
  if (threads < 128 || threads > kRowThreads || threads % 128 ||
      steps % kRowUnroll)
    return (int)cudaErrorInvalidValue;
  return dispatch<0, kNumRowShapes>(shape, [&](auto s) {
    return dispatch<0, 2>(mul, [&](auto m) {
      constexpr int kShape = decltype(s)::value;
      const dim3 block = kShape == kRow2d ? dim3(128, threads / 128)
                                          : dim3(threads);
      probe_rows<kShape, decltype(m)::value>
          <<<(unsigned)((lanes + threads - 1) / threads), block, 0,
             (cudaStream_t)stream>>>((const uint32_t*)x, (uint32_t*)out,
                                     (long)lanes, steps);
      return (int)cudaGetLastError();
    });
  });
}

// Blocks of `threads` threads of probe_rows<shape, mul> one SM holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the
// cudaError.
int rows_blocks_per_sm(int shape, int mul, int threads) {
  int blocks = 0;
  const int rc = dispatch<0, kNumRowShapes>(shape, [&](auto s) {
    return dispatch<0, 2>(mul, [&](auto m) {
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, probe_rows<decltype(s)::value, decltype(m)::value>,
          threads, 0);
    });
  });
  return rc != 0 ? -rc : blocks;
}

// a, b, out: n lanes of 8 uint32 limbs each in layout `layout` (a Layout;
// n a multiple of 128) -> out = a after R repetitions of a = a * b mod p,
// b ^= a, in the same layout.
int launch_layout(int layout, const void* a, const void* b, void* out, int n,
                  int reps, void* stream) {
  return dispatch<0, kNumLayouts>(layout, [&](auto l) {
    probe_layout<decltype(l)::value><<<blocks(n), kBlock, 0,
                                       (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, reps);
    return (int)cudaGetLastError();
  });
}

// Kernel C's and D's contracts (csrc/kernels.cu vgen_range_match,
// vgen_dfa_match), by mode (single_key_lanes.cuh SingleKeyMode): the
// stages read bx, by, tx, ty, inv and remaining; the C modes lo, hi,
// n_slots too; D's tile modes the narrow table (uint16 table, uint8
// accept, n_states x width) where shared, else the int32 one, as D's
// per-lane grid mode always.  The modes of kSkAnyFormat take any hash
// format fmt (csrc/dfa.cuh kFmtP2PKH ...), the others P2PKH alone.
#define VG_ALL_HASH_FORMATS                                                  \
  kFmtP2PKH, kFmtP2WPKH, kFmtP2SHP2WPKH, kFmtP2PKHUncompressed, kFmtEthereum

int launch_single_key(int mode, int fmt, int shared, const void* bx,
                      const void* by, const void* tx, const void* ty,
                      const void* inv, const void* lo, const void* hi,
                      int n_slots, const void* table, const void* accept,
                      int n_states, int width, int start,
                      const void* remaining, void* out, int K, int B,
                      void* stream) {
  if (fmt != kFmtP2PKH && !kSkAnyFormat(mode))
    return (int)cudaErrorInvalidValue;
  const int table_bytes = n_states * width * 2 + n_states;
  if (shared && (width % 2 || table_bytes > kDfaSharedMax))
    return (int)cudaErrorInvalidValue;
  using Lanes = const uint32_t*;
  const auto c = [&](auto sched) {
    constexpr int kS = decltype(sched)::value;
    return launch_tiles<kS>(probe_range_tiles<kS>, kStageOf<kS>, K, B, stream,
                            (Lanes)bx, (Lanes)by, (Lanes)tx, (Lanes)ty,
                            (Lanes)inv, (Lanes)lo, (Lanes)hi, n_slots,
                            (const int32_t*)remaining, (int32_t*)out, K, B);
  };
  const auto d = [&](auto f, auto sched, auto arrays) {
    constexpr int kF = decltype(f)::value, kS = decltype(sched)::value;
    constexpr bool kA = decltype(arrays)::value;
    const auto kernel = shared ? probe_dfa_tiles<kF, kS, kA, true>
                               : probe_dfa_tiles<kF, kS, kA, false>;
    return launch_tiles<kS>(kernel, kStageOf<kS> + (shared ? table_bytes : 0),
                            K, B, stream, (Lanes)bx, (Lanes)by, (Lanes)tx,
                            (Lanes)ty, (Lanes)inv, table, accept, n_states,
                            width, start, (const int32_t*)remaining,
                            (int32_t*)out, K, B);
  };
  using Persistent = std::integral_constant<int, kTilePersistent>;
  using Prefetch = std::integral_constant<int, kTilePrefetch>;
  using P2PKH = std::integral_constant<int, kFmtP2PKH>;
  switch (mode) {
    case kSkCPersistent: return c(Persistent{});
    case kSkCPrefetch: return c(Prefetch{});
    case kSkDPersistent: return d(P2PKH{}, Persistent{}, std::false_type{});
    case kSkDPrefetch: return d(P2PKH{}, Prefetch{}, std::false_type{});
    case kSkDArrays:
      return for_format<VG_ALL_HASH_FORMATS>(fmt, [&](auto f) {
        return d(f, std::integral_constant<int, kTileGrid>{},
                 std::true_type{});
      });
    case kSkCLane:
      return launch_interval<false, VG_ALL_HASH_FORMATS>(
          fmt, bx, by, tx, ty, inv, lo, hi, n_slots, remaining, out, K, B,
          stream);
    case kSkDLane:
      return launch_dfa<false, VG_ALL_HASH_FORMATS>(
          fmt, bx, by, tx, ty, inv, table, accept, width, start, remaining,
          out, K, B, stream);
  }
  return dispatch<0, kNumSingleKeyStages>(mode, [&](auto m) {
    return launch_tiles<kTileGrid>(
        probe_single_key<decltype(m)::value>, 0, K, B, stream, (Lanes)bx,
        (Lanes)by, (Lanes)tx, (Lanes)ty, (Lanes)inv,
        (const int32_t*)remaining, (int32_t*)out, K, B);
  });
}

// Kernel I's contract (csrc/p2tr.cu vgen_p2tr_finish_match), by mode
// (p2tr_match_lanes.cuh P2trMatchMode): X, Z, zi (8, K*B), ok (K*B,),
// remaining (K,); the tile walks the narrow table (uint16 table, uint8
// accept, n_states x width) where shared, else the int32 one, as kPmLane
// always; the stages read no table and take no shared form.
int launch_p2tr_match(int mode, int shared, const void* X, const void* Z,
                      const void* zi, const void* ok, const void* table,
                      const void* accept, int n_states, int width, int start,
                      const void* remaining, void* out, int K, int B,
                      void* stream) {
  const int table_bytes = n_states * width * 2 + n_states;
  const bool walks = mode >= kPmPolymodWalk && mode <= kPmArrays;
  if (shared && (!walks || width % 2 || table_bytes > kDfaSharedMax))
    return (int)cudaErrorInvalidValue;
  using Rows = const uint32_t*;
  if (mode == kPmLane) {
    const long N = (long)K * B;
    if (N == 0) return 0;
    probe_p2tr_match_lane<<<(unsigned)((N + kTileLanes - 1) / kTileLanes),
                            kTileLanes, 0, (cudaStream_t)stream>>>(
        (Rows)X, (Rows)Z, (Rows)zi, (const int32_t*)ok, (const int32_t*)table,
        (const int32_t*)accept, width, start, (const int32_t*)remaining,
        (int32_t*)out, (long)B, N);
    return (int)cudaGetLastError();
  }
  const auto go = [&](auto kernel) {
    return launch_tiles<kTileGrid>(
        kernel, shared ? table_bytes : 0, K, B, stream, (Rows)X, (Rows)Z,
        (Rows)zi, (const int32_t*)ok, table, accept, n_states, width, start,
        (const int32_t*)remaining, (int32_t*)out, K, B);
  };
  return dispatch<0, kPmLane>(mode, [&](auto m) {
    constexpr int kM = decltype(m)::value;
    constexpr bool kWalks = kM >= kPmPolymodWalk && kM <= kPmArrays;
    if constexpr (kM == kPmBounded) {
      return shared ? go(probe_p2tr_match_bounded<true>)
                    : go(probe_p2tr_match_bounded<false>);
    } else {
      return shared ? go(probe_p2tr_match<kM, kWalks>)
                    : go(probe_p2tr_match<kM, false>);
    }
  });
}

// Blocks of the product's kernel D (P2PKH) resident per SM: the shared
// form with a table of table_bytes, or the int32 one; or minus the
// cudaError.  What the shared-memory budget costs in occupancy.
int dfa_blocks_per_sm(int shared, int table_bytes) {
  int blocks = 0;
  const cudaError_t e =
      shared ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &blocks, dfa_tile_kernel<kFmtP2PKH, true>, kTileLanes,
                   table_bytes)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &blocks, dfa_tile_kernel<kFmtP2PKH, false>, kTileLanes, 0);
  return e != cudaSuccess ? -(int)e : blocks;
}

// Kernel A by stage at (M, G), T = K B / M chains (inv_stages.cuh): stage
// 0, 1, 2 the forward chains, trees, backward chains.  bx (K, 8), tx (8,
// B); leaf (8, T); out, scratch (8, K B).
int launch_inv_stage(int stage, const void* bx, const void* tx, void* leaf,
                     void* out, void* scratch, int K, int B, int M, int G,
                     void* stream) {
  const long N = (long)K * B, T = N / M;
  if (!inv_group_ok(G) || G > 256) return (int)cudaErrorInvalidValue;
  const bool tree = stage == kStageTree;
  const unsigned blocks =
      (unsigned)(tree ? (T + kInvBlock - 1) / kInvBlock : (T + 255) / 256);
  return dispatch<0, 3>(stage, [&](auto m) {
    inv_stage_kernel<decltype(m)::value>
        <<<blocks, tree ? 32 : 256, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)bx, (const uint32_t*)tx, (uint32_t*)leaf,
            (uint32_t*)out, (uint32_t*)scratch, B, N, T, M, G);
    return (int)cudaGetLastError();
  });
}

// Kernel F's contract (csrc/p2tr.cu vgen_p2tr_ladder) at the product's
// schedule, cut after stage (ladder_stages.cuh LadderStage).
int launch_ladder_stage(int stage, const void* bx, const void* by,
                        const void* tx, const void* ty, const void* inv,
                        const void* table, void* X, void* Z, void* ok, int K,
                        int B, void* stream) {
  const long N = (long)K * B;
  if (N == 0) return 0;
  using Rows = const uint32_t*;
  return dispatch<0, kNumLadderStages>(stage, [&](auto s) {
    probe_ladder_stage<decltype(s)::value>
        <<<(unsigned)((N + kLadderThreads - 1) / kLadderThreads),
           kLadderThreads, 0, (cudaStream_t)stream>>>(
            (Rows)bx, (Rows)by, (Rows)tx, (Rows)ty, (Rows)inv, (Rows)table,
            (uint32_t*)X, (uint32_t*)Z, (int32_t*)ok, (long)B, N);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// C entry points.  probe_primitive, probe_issue, probe_fieldmul: a, b, out
// (8, n) uint32 limb-major on the card; the DFA table (64, W) int32 (read
// by the dfachar instances only).  The others: see their launchers
// above.  Each launches on the caller's stream and returns
// cudaGetLastError().
extern "C" {

int vgen_probe_primitive(int prim, const void* a, const void* b,
                         const void* table, void* out, int n, int reps,
                         void* stream) {
  return launch_primitive(prim, a, b, table, out, n, reps, stream);
}

int vgen_probe_issue(int op, int chains, const void* a, const void* b,
                     void* out, int n, int reps, void* stream) {
  return launch_issue(op, chains, a, b, out, n, reps, stream);
}

int vgen_probe_fieldmul(int mode, const void* a, const void* b, void* out,
                        int n, int reps, void* stream) {
  return launch_fieldmul(mode, a, b, out, n, reps, stream);
}

int vgen_probe_glv_stage(int mode, const void* bx, const void* by,
                         const void* tx, const void* ty, const void* inv,
                         const void* lo, const void* hi, int n_slots,
                         const void* remaining, void* out, int K, int B,
                         void* stream) {
  return launch_glv_stage(mode, bx, by, tx, ty, inv, lo, hi, n_slots,
                          remaining, out, K, B, stream);
}

int vgen_probe_vtile(int keys_per_thread, int threads, const void* bx,
                     const void* by, const void* tx, const void* ty,
                     const void* inv, const void* lo, const void* hi,
                     int n_slots, const void* remaining, void* out, int K,
                     int B, void* stream) {
  return launch_vtile(keys_per_thread, threads, bx, by, tx, ty, inv, lo, hi,
                      n_slots, remaining, out, K, B, stream);
}

int vgen_probe_rows(int shape, int mul, const void* x, void* out, int lanes,
                    int steps, int threads, void* stream) {
  return launch_rows(shape, mul, x, out, lanes, steps, threads, stream);
}

int vgen_probe_rows_blocks_per_sm(int shape, int mul, int threads) {
  return rows_blocks_per_sm(shape, mul, threads);
}

int vgen_probe_layout(int layout, const void* a, const void* b, void* out,
                      int n, int reps, void* stream) {
  return launch_layout(layout, a, b, out, n, reps, stream);
}

int vgen_probe_single_key(int mode, int fmt, int shared, const void* bx,
                          const void* by,
                          const void* tx, const void* ty, const void* inv,
                          const void* lo, const void* hi, int n_slots,
                          const void* table, const void* accept, int n_states,
                          int width, int start, const void* remaining,
                          void* out, int K, int B, void* stream) {
  return launch_single_key(mode, fmt, shared, bx, by, tx, ty, inv, lo, hi,
                           n_slots, table, accept, n_states, width, start,
                           remaining, out, K, B, stream);
}

int vgen_probe_p2tr_match(int mode, int shared, const void* X, const void* Z,
                          const void* zi, const void* ok, const void* table,
                          const void* accept, int n_states, int width,
                          int start, const void* remaining, void* out, int K,
                          int B, void* stream) {
  return launch_p2tr_match(mode, shared, X, Z, zi, ok, table, accept,
                           n_states, width, start, remaining, out, K, B,
                           stream);
}

int vgen_probe_dfa_blocks_per_sm(int shared, int table_bytes) {
  return dfa_blocks_per_sm(shared, table_bytes);
}

int vgen_probe_inv_stage(int stage, const void* bx, const void* tx,
                         void* leaf, void* out, void* scratch, int K, int B,
                         int M, int G, void* stream) {
  return launch_inv_stage(stage, bx, tx, leaf, out, scratch, K, B, M, G,
                          stream);
}

int vgen_probe_ladder_stage(int stage, const void* bx, const void* by,
                            const void* tx, const void* ty, const void* inv,
                            const void* table, void* X, void* Z, void* ok,
                            int K, int B, void* stream) {
  return launch_ladder_stage(stage, bx, by, tx, ty, inv, table, X, Z, ok, K,
                             B, stream);
}

// One thread inverts a (8, 1) reps times in a row -> out (8, 1).
int vgen_probe_inv_lane(const void* a, void* out, int reps, void* stream) {
  inv_lane_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const uint32_t*)a,
                                                     (uint32_t*)out, reps);
  return (int)cudaGetLastError();
}

}  // extern "C"
