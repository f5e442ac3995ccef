// Per-thread bodies of the three probe kernels (probes.cu launches them).
// Each lane loads a, b (8 limbs each, limb-major (8, N) arrays, as kernels
// A to I), runs R dependent repetitions and stores 8 limbs.  Like the
// headers in csrc/ this compiles as plain C++ too, so every body can be
// held against its plain PyTorch version with a host compiler.
//
// - probe_primitive: one production function of csrc/ per repetition; its
//   output words are folded back into a (a[j mod 8] ^= out[j mod n] for j
//   < max(8, n)), then b ^= a, both reduced below p, so each repetition
//   depends on the last and every input stays a field element;
// - probe_issue: one instruction (or a one-to-one mix) in kChains
//   independent dependent chains per lane, two or three steps a
//   repetition with no register moves;
// - probe_fieldmul: one part of the field multiply, a candidate form of
//   it, or one of hash160's two hashes, with the same fold as
//   probe_primitive.
#pragma once

#include "candidates.cuh"
#include "p2tr_lanes.cuh"

#ifdef __CUDACC__
#define VG_NO_UNROLL _Pragma("unroll 1")
#define VG_FUNNEL_L(lo, hi, n) __funnelshift_l(lo, hi, n)
#define VG_FMAF(x, y, z) __fmaf_rn(x, y, z)
#define VG_AS_UINT(f) __float_as_uint(f)
#else
#include <cmath>
#include <cstring>
#define VG_NO_UNROLL
#define VG_FUNNEL_L(lo, hi, n) \
  ((uint32_t)(((((vg::u64)(hi)) << 32) | (uint32_t)(lo)) << ((n) & 31) >> 32))
#define VG_FMAF(x, y, z) std::fmaf(x, y, z)
inline uint32_t VG_AS_UINT(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
#endif

namespace vg {
namespace probe {

// probe_primitive instances (vgen_tpu_torch/probes/roofline.py PRIMITIVES)
enum Primitive {
  kEmpty, kFeMul, kFeSqr, kFeSqrDedicated, kHash160c, kScriptHash, kHash160u,
  kKeccak, kTagged, kLeanAdd, kDfaChar24, kDfaChar60, kB58Symbols, kEthSymbols,
  kDfaChar60Shared, kNumPrimitives
};
// probe_issue instances (microbench_vpu.py OPS)
enum IssueOp {
  kIadd3, kLop3, kShf, kImad, kImadHi, kImadWide, kFfma, kLop3Imad,
  kIadd3Lop3Shf, kNumIssueOps
};
// probe_fieldmul instances (microbench_fieldmul.py MODES); the whole
// fe_mul, the dedicated squaring and hash160 are probe_primitive's
enum FieldMulMode {
  kFmMulWide, kFmNoCarry, kFmFold, kFmCarry, kFmU64Mul, kFmSha256,
  kFmRipemd160, kNumFieldMulModes
};

constexpr int kDfaStates = 64;  // the probe's DFA table is (64, W) int32
constexpr int kDfaWidth = 60;   // its row length

// a[j mod 8] ^= out[j mod n] for j < max(8, n); b ^= a; both below p
template <int n>
VG_FN void feedback(uint32_t a[8], uint32_t b[8], const uint32_t out[n]) {
#pragma unroll
  for (int j = 0; j < (n > 8 ? n : 8); j++) a[j % 8] ^= out[j % n];
  fe_normalize(a);
#pragma unroll
  for (int i = 0; i < 8; i++) b[i] ^= a[i];
  fe_normalize(b);
}

// table: the (64, 60) DFA table as int32, or, for dfachar60s, as the
// kernel stages it (uint16 in shared memory; any integer type on the host)
template <int kPrim, class T>
VG_FN void primitive_rep(uint32_t a[8], uint32_t b[8], const T* table) {
  if constexpr (kPrim == kEmpty) {
    // the fold alone; b[0] + 1, since a fold of b[0] itself would be the
    // xor-swap pair a ^= b, b ^= a, which repeats every three repetitions
    const uint32_t out[1] = {b[0] + 1u};
    feedback<1>(a, b, out);
  } else if constexpr (kPrim == kFeMul || kPrim == kFeSqr ||
                       kPrim == kFeSqrDedicated || kPrim == kTagged) {
    uint32_t out[8];
    if constexpr (kPrim == kFeMul) fe_mul(out, a, b);
    if constexpr (kPrim == kFeSqr) fe_sqr_by_mul(out, a);
    if constexpr (kPrim == kFeSqrDedicated) fe_sqr(out, a);
    if constexpr (kPrim == kTagged) taptweak_hash(out, a);
    feedback<8>(a, b, out);
  } else if constexpr (kPrim == kHash160c || kPrim == kHash160u) {
    uint32_t st[8], out[5];
    if constexpr (kPrim == kHash160c) sha256_x33(st, a, 2u + (b[0] & 1u));
    if constexpr (kPrim == kHash160u) sha256_x65(st, a, b);
    ripemd160_sha_state(out, st);
    feedback<5>(a, b, out);
  } else if constexpr (kPrim == kScriptHash || kPrim == kKeccak) {
    uint32_t out[5];
    if constexpr (kPrim == kScriptHash) script_hash(out, a);
    if constexpr (kPrim == kKeccak) eth_account(out, a, b);
    feedback<5>(a, b, out);
  } else if constexpr (kPrim == kLeanAdd) {
    // (X1, Y1, Z1) = (a, b, a) plus the affine (b, a)
    uint32_t X[8], Y[8], Z[8], out[25];
    fe_copy(X, a);
    fe_copy(Y, b);
    fe_copy(Z, a);
    out[24] = jacobian_add_affine_lean(X, Y, Z, b, a) ? 1u : 0u;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      out[i] = X[i];
      out[8 + i] = Y[i];
      out[16 + i] = Z[i];
    }
    feedback<25>(a, b, out);
  } else if constexpr (kPrim == kDfaChar24 || kPrim == kDfaChar60) {
    // one table step from state b[0] mod 64 on symbol a[0] mod W
    constexpr int W = kPrim == kDfaChar24 ? 24 : 60;
    const Dfa dfa{table, nullptr, W, 0};
    const uint32_t out[1] = {(uint32_t)dfa_step(
        dfa, (int)(b[0] % kDfaStates), (int)(a[0] % W))};
    feedback<1>(a, b, out);
  } else if constexpr (kPrim == kDfaChar60Shared) {
    // dfachar60's step through kernel D's plain-load form (DfaPlain)
    const DfaPlain<T, T> dfa{table, nullptr, kDfaWidth, 0};
    const uint32_t out[1] = {(uint32_t)dfa_step(
        dfa, (int)(b[0] % kDfaStates), (int)(a[0] % kDfaWidth))};
    feedback<1>(a, b, out);
  } else if constexpr (kPrim == kB58Symbols) {
    // Base58Check (version 0) of the value a[0..4]: 34 symbols, length
    uint8_t syms[kBase58Syms];
    uint32_t out[kBase58Syms + 1];
    out[kBase58Syms] = (uint32_t)base58check_symbols(syms, 0u, a);
#pragma unroll
    for (int j = 0; j < kBase58Syms; j++) out[j] = syms[j];
    feedback<kBase58Syms + 1>(a, b, out);
  } else if constexpr (kPrim == kEthSymbols) {
    // EIP-55 symbols of the account a[0..4]
    uint8_t syms[kEthSyms];
    uint32_t out[kEthSyms];
    eip55_symbols(syms, a);
#pragma unroll
    for (int j = 0; j < kEthSyms; j++) out[j] = syms[j];
    feedback<kEthSyms>(a, b, out);
  }
}

// r = a after R repetitions of primitive kPrim
template <int kPrim, class T>
VG_FN void primitive_lane(uint32_t r[8], const uint32_t a_in[8],
                          const uint32_t b_in[8], const T* table, int reps) {
  uint32_t a[8], b[8];
  fe_copy(a, a_in);
  fe_copy(b, b_in);
  VG_NO_UNROLL
  for (int i = 0; i < reps; i++) primitive_rep<kPrim>(a, b, table);
  fe_copy(r, a);
}

// Repetitions of probe_issue per loop iteration (R must be a multiple),
// so the loop's own counter, compare and branch are a small share
constexpr int kIssueUnroll = 8;

// One chain step of a 32-bit instruction: x becomes f(x, y, k).  The
// funnel shift's amount is k mod 32, a register: by a constant, nvcc
// fuses a funnel shift that feeds an add into LEA.HI.
template <int kStep>
VG_FN uint32_t issue_step(uint32_t x, uint32_t y, uint32_t k) {
  if constexpr (kStep == kIadd3) return x + y + k;
  if constexpr (kStep == kLop3) return (x | y) ^ k;
  if constexpr (kStep == kShf) return VG_FUNNEL_L(y, x, k);
  if constexpr (kStep == kImad) return x * y + k;
  if constexpr (kStep == kImadHi) return mul_hi(x, y) + k;
  return 0u;
}

// One repetition of op kOp on every chain: x from (x, y), then y from
// (y, x), then for the three-op mix x again
template <int kOp, int kChains>
VG_FN void issue_rep(uint32_t x[kChains], uint32_t y[kChains], uint32_t k) {
  constexpr int s0 = kOp == kLop3Imad ? kLop3 : (kOp == kIadd3Lop3Shf ? kIadd3 : kOp);
  constexpr int s1 = kOp == kLop3Imad ? kImad : (kOp == kIadd3Lop3Shf ? kLop3 : kOp);
#pragma unroll
  for (int c = 0; c < kChains; c++) x[c] = issue_step<s0>(x[c], y[c], k);
#pragma unroll
  for (int c = 0; c < kChains; c++) y[c] = issue_step<s1>(y[c], x[c], k);
  if constexpr (kOp == kIadd3Lop3Shf) {
#pragma unroll
    for (int c = 0; c < kChains; c++) x[c] = issue_step<kShf>(x[c], y[c], k);
  }
}

// r[c] = chain c's x ^ y after R repetitions (c < kChains), a[c] for the
// lanes' other limbs.  Chain c starts at x = a[c], y = b[c]; every chain
// adds or folds in the one constant k = a[1] ^ b[3], so that consecutive
// instructions of the chains read k from the operand reuse cache and only
// x and y from the register banks (a third operand of its own per chain
// costs bank conflicts, which cap a two-pipe mix below the issue rate).
// Each step depends on the one before it.  IMAD.WIDE chains hold 64-bit x
// = a[c] | b[c] << 32 and y = b[c] | a[c] << 32 and add K = k << 32 | ~k:
// x = lo(x) hi(y) + K, y = lo(y) hi(x) + K, and r[c] = the four halves'
// XOR.  FFMA chains run in f32: x = 0.25 + (a[c] & 0xFFFF) 2^-18, the
// shared multiplier m = 0.5 + (b[0] & 0xFFFF) 2^-18 and addend k = 0.25 +
// (a[0] >> 16) 2^-18, x = fma(x, m, k) twice a repetition, and r[c] = x's
// bits; x stays in [0.25, 2), so every product and sum is exact in f64
// (the plain version's route to the same bits).
template <int kOp, int kChains>
VG_FN void issue_lane(uint32_t r[8], const uint32_t a[8], const uint32_t b[8],
                      int reps) {
  fe_copy(r, a);
  const uint32_t k = a[1] ^ b[3];
  if constexpr (kOp == kFfma) {
    const float m = 0.5f + (float)(b[0] & 0xFFFFu) * 0x1p-18f;
    const float kf = 0.25f + (float)(a[0] >> 16) * 0x1p-18f;
    float x[kChains];
#pragma unroll
    for (int c = 0; c < kChains; c++)
      x[c] = 0.25f + (float)(a[c] & 0xFFFFu) * 0x1p-18f;
    VG_NO_UNROLL
    for (int i = 0; i < reps; i += kIssueUnroll) {
#pragma unroll
      for (int u = 0; u < 2 * kIssueUnroll; u++) {
#pragma unroll
        for (int c = 0; c < kChains; c++) x[c] = VG_FMAF(x[c], m, kf);
      }
    }
#pragma unroll
    for (int c = 0; c < kChains; c++) r[c] = VG_AS_UINT(x[c]);
  } else if constexpr (kOp == kImadWide) {
    const u64 K = ((u64)k << 32) | (uint32_t)~k;
    u64 x[kChains], y[kChains];
#pragma unroll
    for (int c = 0; c < kChains; c++) {
      x[c] = a[c] | ((u64)b[c] << 32);
      y[c] = b[c] | ((u64)a[c] << 32);
    }
    VG_NO_UNROLL
    for (int i = 0; i < reps; i += kIssueUnroll) {
#pragma unroll
      for (int u = 0; u < kIssueUnroll; u++) {
#pragma unroll
        for (int c = 0; c < kChains; c++)
          x[c] = (u64)(uint32_t)x[c] * (uint32_t)(y[c] >> 32) + K;
#pragma unroll
        for (int c = 0; c < kChains; c++)
          y[c] = (u64)(uint32_t)y[c] * (uint32_t)(x[c] >> 32) + K;
      }
    }
#pragma unroll
    for (int c = 0; c < kChains; c++)
      r[c] = (uint32_t)x[c] ^ (uint32_t)(x[c] >> 32) ^ (uint32_t)y[c] ^
             (uint32_t)(y[c] >> 32);
  } else {
    uint32_t x[kChains], y[kChains];
#pragma unroll
    for (int c = 0; c < kChains; c++) {
      x[c] = a[c];
      y[c] = b[c];
    }
    VG_NO_UNROLL
    for (int i = 0; i < reps; i += kIssueUnroll) {
#pragma unroll
      for (int u = 0; u < kIssueUnroll; u++) issue_rep<kOp, kChains>(x, y, k);
    }
#pragma unroll
    for (int c = 0; c < kChains; c++) r[c] = x[c] ^ y[c];
  }
}

template <int kMode>
VG_FN void fieldmul_rep(uint32_t a[8], uint32_t b[8]) {
  if constexpr (kMode == kFmU64Mul) {
    uint32_t out[8];
    fe_mul_u64(out, a, b);
    feedback<8>(a, b, out);
  } else if constexpr (kMode == kFmMulWide) {
    uint32_t out[16];
    fe_mul_wide(out, a, b);
    feedback<16>(a, b, out);
  } else if constexpr (kMode == kFmNoCarry) {
    // the 16 columns' low and high words
    u64 cols[16];
    uint32_t out[32];
    fe_mul_cols_nocarry(cols, a, b);
#pragma unroll
    for (int k = 0; k < 16; k++) {
      out[2 * k] = (uint32_t)cols[k];
      out[2 * k + 1] = (uint32_t)(cols[k] >> 32);
    }
    feedback<32>(a, b, out);
  } else if constexpr (kMode == kFmFold) {
    // the 512-bit value b || a
    uint32_t t[16], out[8];
#pragma unroll
    for (int i = 0; i < 8; i++) {
      t[i] = a[i];
      t[8 + i] = b[i];
    }
    fe_reduce512(out, t);
    feedback<8>(a, b, out);
  } else if constexpr (kMode == kFmCarry) {
    // columns a[k mod 8] + (b[k mod 8] << 4), below 2^37
    u64 cols[16];
    uint32_t out[17];
#pragma unroll
    for (int k = 0; k < 16; k++) cols[k] = (u64)a[k % 8] + ((u64)b[k % 8] << 4);
    out[16] = fe_carry_cols(out, cols);
    feedback<17>(a, b, out);
  } else if constexpr (kMode == kFmSha256) {
    uint32_t out[8];
    sha256_x33(out, a, 2u + (b[0] & 1u));
    feedback<8>(a, b, out);
  } else if constexpr (kMode == kFmRipemd160) {
    // RIPEMD-160 of the digest whose state words are a
    uint32_t out[5];
    ripemd160_sha_state(out, a);
    feedback<5>(a, b, out);
  }
}

template <int kMode>
VG_FN void fieldmul_lane(uint32_t r[8], const uint32_t a_in[8],
                         const uint32_t b_in[8], int reps) {
  uint32_t a[8], b[8];
  fe_copy(a, a_in);
  fe_copy(b, b_in);
  VG_NO_UNROLL
  for (int i = 0; i < reps; i++) fieldmul_rep<kMode>(a, b);
  fe_copy(r, a);
}

}  // namespace probe
}  // namespace vg
