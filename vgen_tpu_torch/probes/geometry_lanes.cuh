// Per-thread bodies of the four stage and geometry probes (probes.cu
// launches them).  Each calls the production functions of csrc/ (the
// affine add lane_add, fe_mul, value_words, in_intervals, kernel B's lane
// range_glv_lane) or the column-sum multiply of candidates.cuh.  Like the
// other headers this compiles as plain C++ too, so every body can be held
// against its plain PyTorch version with a host compiler.
//
// - probe_glv_stage<kMode>: kernel B's P2PKH lane cut down by stage (the
//   x-only finish, the beta products, the hashes), one or two lanes per
//   thread;
// - probe_vtile<kKeysPerThread>: kernel B's P2PKH lane, V keys per thread
//   in a loop over blocks of T threads;
// - probe_rows<kShape, kMul>: one dependent 32-bit chain per lane, or 16
//   independent ones;
// - probe_layout<kLayout>: R chained field multiplies, the operands in one
//   of four global-memory layouts.
#pragma once

#include "probe_lanes.cuh"

namespace vg {
namespace probe {

// probe_glv_stage instances (vgen_tpu_torch/probes/profile_glv.py MODES)
enum GlvStage {
  kStageEc, kStageEc2, kStageEcc, kStageHash2, kStageHash2R, kStageFull,
  kStageFullR, kNumGlvStages
};
// probe_rows instances (microbench_rows.py SHAPES)
enum RowShape { kRow1d, kRow2d, kFull2d, kNumRowShapes };
// probe_layout instances (microbench_layout.py LAYOUTS)
enum Layout { kLimbMajor, kLaneMajor, kTile32, kTile128, kNumLayouts };

constexpr int kStageThreads = 256;      // kernel B's block
constexpr int kVtileMaxThreads = 512;   // the largest T of probe_vtile
constexpr int kRowThreads = 1024;       // probe_rows' largest block
constexpr int kRowUnroll = 64;          // chain steps per loop iteration

// the two-lane stage modes: lanes t and t + N/2 of thread t, so N / 2
// threads (a constant, which the launch reads on the host too)
template <int kMode>
constexpr bool kStageTwoLanes = kMode == kStageHash2R || kMode == kStageFullR;
template <int kMode>
constexpr int kStageLanesPerThread = kStageTwoLanes<kMode> ? 2 : 1;

// x of lane e = k*B + b after kernel B's x-only finish; false, and x zero,
// where dx == 0 or b >= remaining[k]
VG_FN bool stage_finish(uint32_t x[8], const uint32_t* bx, const uint32_t* by,
                        const uint32_t* tx, const uint32_t* ty,
                        const uint32_t* inv, const int32_t* remaining, long B,
                        long N, long e) {
  const long k = e / B, b = e - k * B;
  uint32_t y[8];
  if (b < (long)remaining[k] &&
      lane_add<false>(x, y, bx, by, tx, ty, inv, B, N, e))
    return true;
#pragma unroll
  for (int i = 0; i < 8; i++) x[i] = 0u;
  return false;
}

// ec, ec2, ecc: xs = (x, beta x, beta (beta x)), then 0 (ec) or 2 more
// multiplies by beta of each, by fe_mul (ec2) or the column form (ecc);
// 1 where the low 16 bits of some xs[v] equal v (the TPU body ORs 1 for
// each v), else 0
template <int kMode>
VG_FN int32_t stage_ec_mask(const uint32_t x[8]) {
  uint32_t u[8], xs[3][8];
#pragma unroll
  for (int i = 0; i < 8; i++) u[i] = BETA[i];
  fe_copy(xs[0], x);
  fe_mul(xs[1], x, u);
  fe_mul(xs[2], xs[1], u);
  constexpr int kExtra = kMode == kStageEc ? 0 : 2;
#pragma unroll
  for (int r = 0; r < kExtra; r++) {
#pragma unroll
    for (int v = 0; v < 3; v++) {
      if constexpr (kMode == kStageEcc) {
        fe_mul_colsum(xs[v], xs[v], u);
      } else {
        fe_mul(xs[v], xs[v], u);
      }
    }
  }
  int32_t mask = 0;
#pragma unroll
  for (int v = 0; v < 3; v++)
    if ((xs[v][0] & 0xFFFFu) == (uint32_t)v) mask = 1;
  return mask;
}

// One lane of a one-lane mode: ec, ec2 and ecc as above; hash2 bits 0 and
// 1, hash160(02 + pi || x) in an interval; full kernel B's P2PKH lane.
template <int kMode>
VG_FN int32_t glv_stage_lane(const uint32_t* bx, const uint32_t* by,
                             const uint32_t* tx, const uint32_t* ty,
                             const uint32_t* inv, const uint32_t* lo,
                             const uint32_t* hi, int n_slots,
                             const int32_t* remaining, long B, long N, long e) {
  if constexpr (kMode == kStageFull) {
    return range_glv_lane<kFmtP2PKH>(bx, by, tx, ty, inv, lo, hi, n_slots,
                                     remaining, B, N, e);
  } else {
    uint32_t x[8];
    if (!stage_finish(x, bx, by, tx, ty, inv, remaining, B, N, e)) return 0;
    if constexpr (kMode == kStageHash2) {
      int32_t mask = 0;
#pragma unroll
      for (int pi = 0; pi < 2; pi++) {
        uint32_t h[5];
        value_words<kFmtP2PKH>(h, x, x, (uint32_t)pi);
        if (in_intervals(h, lo, hi, n_slots)) mask |= 1 << pi;
      }
      return mask;
    } else {
      return stage_ec_mask<kMode>(x);
    }
  }
}

// hash2r (kVariants 1) and fullr (3): kernel B's variant loop over two
// lanes' x at once; the two lanes' hashes are independent straight-line
// code in one block, which the compiler interleaves.
template <int kVariants>
VG_FN void stage_hash_pair(int32_t mask[2], uint32_t x[2][8],
                           const uint32_t* lo, const uint32_t* hi,
                           int n_slots) {
  uint32_t u[8];
#pragma unroll
  for (int i = 0; i < 8; i++) u[i] = BETA[i];
  mask[0] = mask[1] = 0;
#pragma unroll 1
  for (int v = 0; v < kVariants; v++) {
    if (v > 0) {
      fe_mul(x[0], x[0], u);
      fe_mul(x[1], x[1], u);
    }
#pragma unroll
    for (int pi = 0; pi < 2; pi++) {
      uint32_t h0[5], h1[5];
      value_words<kFmtP2PKH>(h0, x[0], x[0], (uint32_t)pi);
      value_words<kFmtP2PKH>(h1, x[1], x[1], (uint32_t)pi);
      if (in_intervals(h0, lo, hi, n_slots)) mask[0] |= 1 << (2 * v + pi);
      if (in_intervals(h1, lo, hi, n_slots)) mask[1] |= 1 << (2 * v + pi);
    }
  }
}

// Thread t of N / kStageLanesPerThread<kMode>: out[e] for its lane e = t,
// or for the two-lane modes its lanes t and t + N/2 (N even).
template <int kMode>
VG_FN void glv_stage_thread(const uint32_t* bx, const uint32_t* by,
                            const uint32_t* tx, const uint32_t* ty,
                            const uint32_t* inv, const uint32_t* lo,
                            const uint32_t* hi, int n_slots,
                            const int32_t* remaining, int32_t* out, long B,
                            long N, long t) {
  if constexpr (kStageTwoLanes<kMode>) {
    const long e[2] = {t, t + N / 2};
    uint32_t x[2][8];
    bool ok[2];
#pragma unroll
    for (int i = 0; i < 2; i++)
      ok[i] = stage_finish(x[i], bx, by, tx, ty, inv, remaining, B, N, e[i]);
    int32_t mask[2];
    stage_hash_pair<kMode == kStageFullR ? 3 : 1>(mask, x, lo, hi, n_slots);
#pragma unroll
    for (int i = 0; i < 2; i++) out[e[i]] = ok[i] ? mask[i] : 0;
  } else {
    out[t] = glv_stage_lane<kMode>(bx, by, tx, ty, inv, lo, hi, n_slots,
                                   remaining, B, N, t);
  }
}

// Thread t of block `block` (T threads): kernel B's P2PKH lane for its
// kKeysPerThread keys e = (block V + j) T + t, j < V, one after another
// (the TPU's (V, T) tile of lanes); keys past N are skipped.
template <int kKeysPerThread>
VG_FN void vtile_thread(const uint32_t* bx, const uint32_t* by,
                        const uint32_t* tx, const uint32_t* ty,
                        const uint32_t* inv, const uint32_t* lo,
                        const uint32_t* hi, int n_slots,
                        const int32_t* remaining, int32_t* out, long B, long N,
                        long block, int T, int t) {
  const long base = block * kKeysPerThread * T + t;
#pragma unroll 1
  for (int j = 0; j < kKeysPerThread; j++) {
    const long e = base + (long)j * T;
    if (e < N)
      out[e] = range_glv_lane<kFmtP2PKH>(bx, by, tx, ty, inv, lo, hi, n_slots,
                                         remaining, B, N, e);
  }
}

// One step of the row chains: r * x + 1 where it multiplies, else
// (r + x) ^ rotl(r, 7)
VG_FN uint32_t row_step(uint32_t r, uint32_t x, bool mul) {
  return mul ? r * x + 1u : (r + x) ^ rotl32(r, 7);
}

// A lane's chains over its 16 input words x (steps a multiple of
// kRowUnroll).  row1d, row2d: one chain r = x[0], step i with x[i mod 16],
// a multiply at every fourth step when kMul; r[0] is the result.  full2d:
// 16 independent chains r[c] = x[c] of steps / 16 steps each with x[c], a
// multiply at every fourth.
template <int kShape, int kMul>
VG_FN void rows_lane(uint32_t r[16], const uint32_t x[16], int steps) {
  if constexpr (kShape == kFull2d) {
#pragma unroll
    for (int c = 0; c < 16; c++) r[c] = x[c];
    VG_NO_UNROLL
    for (int i = 0; i < steps; i += kRowUnroll) {
#pragma unroll
      for (int u = 0; u < kRowUnroll / 16; u++) {
#pragma unroll
        for (int c = 0; c < 16; c++)
          r[c] = row_step(r[c], x[c], kMul && u == 0);
      }
    }
  } else {
    uint32_t acc = x[0];
    VG_NO_UNROLL
    for (int i = 0; i < steps; i += kRowUnroll) {
#pragma unroll
      for (int u = 0; u < kRowUnroll; u++)
        acc = row_step(acc, x[u % 16], kMul && u % 4 == 0);
    }
    r[0] = acc;
  }
}

// Where limb l of lane e lies in an (8, n) layout's n * 8 words: limb-major
// (8, n), lane-major (n, 8), or tiles of 32 or 128 lanes (n / W, 8, W)
template <int kLayout>
VG_FN long layout_index(long n, long e, int l) {
  if constexpr (kLayout == kLimbMajor) return l * n + e;
  if constexpr (kLayout == kLaneMajor) return e * 8 + l;
  constexpr long W = kLayout == kTile32 ? 32 : 128;
  return (e / W) * (8 * W) + l * W + e % W;
}

// Lane-major lanes move as two 16-byte vectors on the card
template <int kLayout>
VG_FN void layout_load(uint32_t r[8], const uint32_t* src, long n, long e) {
#ifdef __CUDACC__
  if constexpr (kLayout == kLaneMajor) {
    const uint4 lo = reinterpret_cast<const uint4*>(src)[2 * e];
    const uint4 hi = reinterpret_cast<const uint4*>(src)[2 * e + 1];
    r[0] = lo.x, r[1] = lo.y, r[2] = lo.z, r[3] = lo.w;
    r[4] = hi.x, r[5] = hi.y, r[6] = hi.z, r[7] = hi.w;
    return;
  }
#endif
#pragma unroll
  for (int l = 0; l < 8; l++) r[l] = src[layout_index<kLayout>(n, e, l)];
}

template <int kLayout>
VG_FN void layout_store(uint32_t* dst, long n, long e, const uint32_t a[8]) {
#ifdef __CUDACC__
  if constexpr (kLayout == kLaneMajor) {
    reinterpret_cast<uint4*>(dst)[2 * e] = make_uint4(a[0], a[1], a[2], a[3]);
    reinterpret_cast<uint4*>(dst)[2 * e + 1] =
        make_uint4(a[4], a[5], a[6], a[7]);
    return;
  }
#endif
#pragma unroll
  for (int l = 0; l < 8; l++) dst[layout_index<kLayout>(n, e, l)] = a[l];
}

// Lane e: a, b from their layout, R repetitions of a = a * b mod p, b ^= a,
// then a stored in the same layout
template <int kLayout>
VG_FN void layout_lane(uint32_t* out, const uint32_t* a_in,
                       const uint32_t* b_in, long n, long e, int reps) {
  uint32_t a[8], b[8];
  layout_load<kLayout>(a, a_in, n, e);
  layout_load<kLayout>(b, b_in, n, e);
  VG_NO_UNROLL
  for (int i = 0; i < reps; i++) {
    fe_mul(a, a, b);
#pragma unroll
    for (int l = 0; l < 8; l++) b[l] ^= a[l];
  }
  layout_store<kLayout>(out, n, e, a);
}

}  // namespace probe
}  // namespace vg
