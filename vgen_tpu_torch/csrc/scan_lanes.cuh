// Per-thread bodies of the scan kernels (kernels.cu launches them).
// Kept apart from the launch code so the arithmetic can also be driven
// from a host compiler.
//
// Arrays are limb-major (8, N) uint32: limb l of element e is at l*N + e.
#pragma once

#include "field.cuh"
#include "dfa.cuh"
#include "ripemd160.cuh"
#include "sha256.cuh"

namespace vg {

// cube root of unity mod p: (beta x, y) = lambda * (x, y) on the curve
VG_CONSTANT uint32_t BETA[8] = {0x719501EEu, 0xC1396C28u, 0x12F58995u,
                                0x9CF04975u, 0xAC3434E9u, 0x6E64479Eu,
                                0x657C0710u, 0x7AE96A2Bu};

// dx of element e = k*B + b: tx[b] - bx[k], with a zero (the doubling
// lane, tx == bx) replaced by 1 so it cannot poison the chain.
VG_FN void dx_of(uint32_t r[8], const uint32_t* bx, const uint32_t* tx,
                 long B, long e) {
  const long k = e / B, b = e - k * B;
  uint32_t t[8], base[8];
  fe_load(t, tx, B, b);
#pragma unroll
  for (int i = 0; i < 8; i++) base[i] = bx[k * 8 + i];
  fe_sub(r, t, base);
  if (fe_is_zero(r)) r[0] = 1u;
}

// Kernel A, thread t of T = N / M: a Montgomery chain over the M elements
// e = t + j*T (strided by the thread count, so each step's loads and stores
// coalesce).  Forward: exclusive prefix products into scratch.  One
// inversion of the chain total.  Backward: inv[e] = acc * prefix[e],
// acc *= dx[e].  dx is recomputed from tx and bx instead of stored.
VG_FN void inv_dx_thread(const uint32_t* bx, const uint32_t* tx,
                         uint32_t* out, uint32_t* scratch, long B, long N,
                         long T, int M, long t) {
  uint32_t acc[8], dx[8], pre[8];
  fe_set_one(acc);
  for (int j = 0; j < M; j++) {
    const long e = t + j * T;
    fe_store(scratch, N, e, acc);
    dx_of(dx, bx, tx, B, e);
    fe_mul(acc, acc, dx);
  }
  fe_inv(acc, acc);
  for (int j = M - 1; j >= 0; j--) {
    const long e = t + j * T;
    fe_load(pre, scratch, N, e);
    fe_mul(pre, acc, pre);
    fe_store(out, N, e, pre);
    dx_of(dx, bx, tx, B, e);
    fe_mul(acc, acc, dx);
  }
}

// Lexicographic lo[s] <= w <= hi[s] for any slot s (word 0 most
// significant).  Padding slots have lo > hi and never match.
VG_FN bool in_intervals(const uint32_t w[5], const uint32_t* lo,
                        const uint32_t* hi, int n_slots) {
  bool hit = false;
  for (int s = 0; s < n_slots; s++) {
    int ge = 0, le = 0;  // 0 undecided, 1 true, -1 false
    for (int i = 0; i < 5; i++) {
      const uint32_t l = lo[s * 5 + i], h = hi[s * 5 + i];
      if (ge == 0 && w[i] != l) ge = w[i] > l ? 1 : -1;
      if (le == 0 && w[i] != h) le = w[i] < h ? 1 : -1;
    }
    hit |= (ge >= 0) && (le >= 0);
  }
  return hit;
}

// The affine add of window k's base point and table point b of lane
// e = k*B + b, from the lane's precomputed inverse of dx = tx - bx:
// lambda = (ty - by) / dx, x = lambda^2 - bx - tx and, when kWithY,
// y = lambda (bx - x) - by.  Every value is canonical (< p), so y's parity
// is the compressed-key prefix's.  Returns false where dx == 0 (the
// doubling lane), leaving x and y unset.
template <bool kWithY>
VG_FN bool lane_add(uint32_t x[8], uint32_t y[8], const uint32_t* bx,
                    const uint32_t* by, const uint32_t* tx, const uint32_t* ty,
                    const uint32_t* inv, long B, long N, long e) {
  const long k = e / B, b = e - k * B;
  uint32_t base[8], t[8], lam[8], u[8];
#pragma unroll
  for (int i = 0; i < 8; i++) base[i] = bx[k * 8 + i];
  fe_load(t, tx, B, b);
  fe_sub(lam, t, base);
  if (fe_is_zero(lam)) return false;
  fe_load(lam, ty, B, b);
#pragma unroll
  for (int i = 0; i < 8; i++) u[i] = by[k * 8 + i];
  fe_sub(lam, lam, u);
  fe_load(x, inv, N, e);
  fe_mul(lam, lam, x);
  fe_sqr(x, lam);
  fe_sub(x, x, base);
  fe_sub(x, x, t);
  if constexpr (kWithY) {
    fe_sub(t, base, x);
    fe_mul(t, lam, t);
    fe_sub(y, t, u);
  }
  return true;
}

// Kernel B, lane e = k*B + b: x-only affine add of window base k and table
// point b, then bit 2v+pi of the result is set when
// hash160((2+pi) || beta^v * x) lies in an interval.  0 where dx == 0 or
// b >= remaining[k].
VG_FN int32_t range_glv_lane(const uint32_t* bx, const uint32_t* by,
                             const uint32_t* tx, const uint32_t* ty,
                             const uint32_t* inv, const uint32_t* lo,
                             const uint32_t* hi, int n_slots,
                             const int32_t* remaining, long B, long N,
                             long e) {
  const long k = e / B, b = e - k * B;
  if (b >= (long)remaining[k]) return 0;
  uint32_t x[8], u[8];
  if (!lane_add<false>(x, u, bx, by, tx, ty, inv, B, N, e)) return 0;
  // the variants' x-coordinates: x, beta x, beta^2 x = beta (beta x)
#pragma unroll
  for (int i = 0; i < 8; i++) u[i] = BETA[i];
  int32_t mask = 0;
#pragma unroll 1
  for (int v = 0; v < 3; v++) {
    if (v > 0) fe_mul(x, x, u);
#pragma unroll
    for (int pi = 0; pi < 2; pi++) {
      uint32_t st[8], h[5];
      sha256_x33(st, x, 2u + pi);
      ripemd160_sha_state(h, st);
      if (in_intervals(h, lo, hi, n_slots)) mask |= 1 << (2 * v + pi);
    }
  }
  return mask;
}

// Kernel C, lane e = k*B + b: the full affine add, then 1 when
// hash160((2 + (y & 1)) || x) lies in an interval.  0 where dx == 0 or
// b >= remaining[k].
VG_FN int32_t range_lane(const uint32_t* bx, const uint32_t* by,
                         const uint32_t* tx, const uint32_t* ty,
                         const uint32_t* inv, const uint32_t* lo,
                         const uint32_t* hi, int n_slots,
                         const int32_t* remaining, long B, long N, long e) {
  const long k = e / B, b = e - k * B;
  if (b >= (long)remaining[k]) return 0;
  uint32_t x[8], y[8], st[8], h[5];
  if (!lane_add<true>(x, y, bx, by, tx, ty, inv, B, N, e)) return 0;
  sha256_x33(st, x, 2u + (y[0] & 1u));
  ripemd160_sha_state(h, st);
  return in_intervals(h, lo, hi, n_slots) ? 1 : 0;
}

// Kernel D, lane e: the full affine add, hash160 of the compressed key, its
// address symbols in format kFmt, the DFA walk -> 0/1.  0 where dx == 0 or
// b >= remaining[k].
template <int kFmt>
VG_FN int32_t dfa_lane(const uint32_t* bx, const uint32_t* by,
                       const uint32_t* tx, const uint32_t* ty,
                       const uint32_t* inv, const Dfa& dfa,
                       const int32_t* remaining, long B, long N, long e) {
  const long k = e / B, b = e - k * B;
  if (b >= (long)remaining[k]) return 0;
  uint32_t x[8], y[8], st[8], h[5];
  if (!lane_add<true>(x, y, bx, by, tx, ty, inv, B, N, e)) return 0;
  sha256_x33(st, x, 2u + (y[0] & 1u));
  ripemd160_sha_state(h, st);
  return h160_matches<kFmt>(dfa, h) ? 1 : 0;
}

// Kernel E, lane e: the x-only affine add, then for v in 0..2 and pi in
// 0..1 the address of hash160((2+pi) || beta^v x) in format kFmt through
// the DFA; bit 2v+pi is set on accept (the bit layout of kernel B and of
// vgen_tpu.crypto.secp256k1.glv_bit_variant_keys(parity_exact=False)).
// 0 where dx == 0 or b >= remaining[k].
template <int kFmt>
VG_FN int32_t glv_dfa_lane(const uint32_t* bx, const uint32_t* by,
                           const uint32_t* tx, const uint32_t* ty,
                           const uint32_t* inv, const Dfa& dfa,
                           const int32_t* remaining, long B, long N, long e) {
  const long k = e / B, b = e - k * B;
  if (b >= (long)remaining[k]) return 0;
  uint32_t x[8], u[8];
  if (!lane_add<false>(x, u, bx, by, tx, ty, inv, B, N, e)) return 0;
#pragma unroll
  for (int i = 0; i < 8; i++) u[i] = BETA[i];
  int32_t mask = 0;
#pragma unroll 1
  for (int v = 0; v < 3; v++) {
    if (v > 0) fe_mul(x, x, u);
#pragma unroll 1
    for (int pi = 0; pi < 2; pi++) {
      uint32_t st[8], h[5];
      sha256_x33(st, x, 2u + pi);
      ripemd160_sha_state(h, st);
      if (h160_matches<kFmt>(dfa, h)) mask |= 1 << (2 * v + pi);
    }
  }
  return mask;
}

}  // namespace vg
