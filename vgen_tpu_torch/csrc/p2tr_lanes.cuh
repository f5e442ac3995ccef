// Per-thread bodies of the P2TR kernels F, G, H and I (p2tr.cu launches
// them).  Like the other headers this compiles as plain C++ too, so the
// arithmetic can be driven from a host compiler.
//
// Arrays are limb-major (8, N) uint32: limb l of element e is at l*N + e.
// The window table is (32, 256, 2, 8) uint32: entry [w][d] is the affine
// (x, y) of d * 2^(8w) * G, the d = 0 rows filler.
#pragma once

#include "scan_lanes.cuh"

namespace vg {

// SHA-256 state after SHA256("TapTweak") || SHA256("TapTweak"), the first
// block of every BIP341 TapTweak tagged hash (sha256.tagged_midstate).
VG_CONSTANT uint32_t TAPTWEAK_MID[8] = {0xD129A2F3u, 0x701C655Du, 0x6583B6C3u,
                                        0xB9419727u, 0x95F4E232u, 0x94FD54F4u,
                                        0xA2AE8D85u, 0x47CA590Bu};

// secp256k1 group order n, little-endian limbs
VG_CONSTANT uint32_t ORDER_N[8] = {0xD0364141u, 0xBFD25E8Cu, 0xAF48A03Bu,
                                   0xBAAEDCE6u, 0xFFFFFFFEu, 0xFFFFFFFFu,
                                   0xFFFFFFFFu, 0xFFFFFFFFu};

// t = the TapTweak tagged hash of x (32 bytes big-endian), as a 256-bit
// big-endian number in little-endian limbs: one compression of x and the
// padding of a 96-byte message from the midstate.
VG_FN void taptweak_hash(uint32_t t[8], const uint32_t x[8]) {
  uint32_t w[16], st[8];
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = x[7 - i];
  w[8] = 0x80000000u;
#pragma unroll
  for (int i = 9; i < 15; i++) w[i] = 0u;
  w[15] = 96u * 8u;
#pragma unroll
  for (int i = 0; i < 8; i++) st[i] = TAPTWEAK_MID[i];
  sha256_compress(st, w);
#pragma unroll
  for (int i = 0; i < 8; i++) t[i] = st[7 - i];
}

// a < n, comparing from the most significant limb
VG_FN bool below_order(const uint32_t a[8]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const u64 d = (u64)a[i] - ORDER_N[i] - borrow;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow != 0;
}

// (X, Y, Z) += (x2, y2) by the mixed add without the doubling and infinity
// fallbacks, 8M + 3S (vgen_tpu/ops/curve.py jacobian_add_affine_lean).
// Returns false where H == 0 (P == +-Q); the caller masks such lanes.
VG_FN bool jacobian_add_affine_lean(uint32_t X[8], uint32_t Y[8], uint32_t Z[8],
                                    const uint32_t x2[8], const uint32_t y2[8]) {
  uint32_t zz[8], H[8], r[8], t[8];
  fe_sqr(zz, Z);         // Z1^2
  fe_mul(H, x2, zz);     // U2
  fe_sub(H, H, X);       // H = U2 - X1
  fe_mul(r, y2, Z);
  fe_mul(r, r, zz);      // S2
  fe_sub(r, r, Y);       // r = S2 - Y1
  const bool ok = !fe_is_zero(H);
  fe_mul(Z, Z, H);       // Z3 = Z1 H
  fe_sqr(zz, H);         // HH
  fe_mul(H, H, zz);      // HHH
  fe_mul(zz, X, zz);     // V = X1 HH
  fe_mul(Y, Y, H);       // Y1 HHH
  fe_sqr(X, r);
  fe_sub(X, X, H);
  fe_mul_small(t, zz, 2u);
  fe_sub(X, X, t);       // X3 = r^2 - HHH - 2V
  fe_sub(t, zz, X);
  fe_mul(t, r, t);
  fe_sub(Y, t, Y);       // Y3 = r (V - X3) - Y1 HHH
  return ok;
}

// The ladder of one lane: from the internal key (x, y), its even-Y form P,
// t = TapTweak(x), then Q = P + t*G by 32 fixed 8-bit windows (byte w of t
// selects table[w][digit]; digit 0 adds nothing).  Writes Q's X and Z;
// returns t < n and no add hit H == 0.
VG_FN bool taptweak_ladder(uint32_t X[8], uint32_t Z[8], const uint32_t x[8],
                           const uint32_t y[8], const uint32_t* table) {
  uint32_t Y[8], t[8], px[8], py[8];
  if (y[0] & 1u) {
    fe_neg(Y, y);
  } else {
    fe_copy(Y, y);
  }
  taptweak_hash(t, x);
  bool ok = below_order(t);
  fe_copy(X, x);
  fe_set_one(Z);
#pragma unroll 1
  for (int w = 0; w < 32; w++) {
    const uint32_t digit = (t[w >> 2] >> (8 * (w & 3))) & 255u;
    if (digit == 0u) continue;
    const uint32_t* p = table + ((long)w * 256 + digit) * 16;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      px[i] = VG_LDG(p + i);
      py[i] = VG_LDG(p + 8 + i);
    }
    ok = jacobian_add_affine_lean(X, Y, Z, px, py) && ok;
  }
  return ok;
}

// The full affine add of window k's base point and table point b of lane
// e = k*B + b, computed on every lane (lane_add's formulas; a dx == 0 lane
// carries the guarded inverse 1 from kernel A and is masked by the
// result): returns dx != 0.
VG_FN bool lane_add_all(uint32_t x[8], uint32_t y[8], const uint32_t* bx,
                        const uint32_t* by, const uint32_t* tx, const uint32_t* ty,
                        const uint32_t* inv, long B, long N, long e) {
  const long k = e / B, b = e - k * B;
  uint32_t base[8], t[8], lam[8], u[8];
#pragma unroll
  for (int i = 0; i < 8; i++) base[i] = bx[k * 8 + i];
  fe_load(t, tx, B, b);
  fe_sub(lam, t, base);
  const bool valid = !fe_is_zero(lam);
  fe_load(lam, ty, B, b);
#pragma unroll
  for (int i = 0; i < 8; i++) u[i] = by[k * 8 + i];
  fe_sub(lam, lam, u);
  fe_load(x, inv, N, e);
  fe_mul(lam, lam, x);
  fe_sqr(x, lam);
  fe_sub(x, x, base);
  fe_sub(x, x, t);
  fe_sub(t, base, x);
  fe_mul(t, lam, t);
  fe_sub(y, t, u);
  return valid;
}

// Kernel F (finish), lane e: the full finish, then the ladder; X and Z
// stored at e, returns ok (0/1) including dx != 0.
VG_FN int32_t p2tr_ladder_lane(const uint32_t* bx, const uint32_t* by,
                               const uint32_t* tx, const uint32_t* ty,
                               const uint32_t* inv, const uint32_t* table,
                               uint32_t* Xo, uint32_t* Zo, long B, long N, long e) {
  uint32_t x[8], y[8], X[8], Z[8];
  const bool valid = lane_add_all(x, y, bx, by, tx, ty, inv, B, N, e);
  const bool ok = taptweak_ladder(X, Z, x, y, table);
  fe_store(Xo, N, e, X);
  fe_store(Zo, N, e, Z);
  return (ok && valid) ? 1 : 0;
}

// Kernel F (affine input), lane e: the ladder of the affine key (x, y).
VG_FN int32_t p2tr_ladder_affine_lane(const uint32_t* xs, const uint32_t* ys,
                                      const uint32_t* table, uint32_t* Xo,
                                      uint32_t* Zo, long N, long e) {
  uint32_t x[8], y[8], X[8], Z[8];
  fe_load(x, xs, N, e);
  fe_load(y, ys, N, e);
  const bool ok = taptweak_ladder(X, Z, x, y, table);
  fe_store(Xo, N, e, X);
  fe_store(Zo, N, e, Z);
  return ok ? 1 : 0;
}

// The output key's x of lane e: qx = X * zi^2; returns ok[e] && Z != 0.
VG_FN bool p2tr_qx(uint32_t qx[8], const uint32_t* X, const uint32_t* Z,
                   const uint32_t* zi, const int32_t* ok, long N, long e) {
  uint32_t v[8];
  fe_load(v, Z, N, e);
  const bool live = ok[e] != 0 && !fe_is_zero(v);
  fe_load(v, zi, N, e);
  fe_sqr(v, v);
  fe_load(qx, X, N, e);
  fe_mul(qx, qx, v);
  return live;
}

// Kernel H, lane e = k*B + b: 1 when the output key's x (8 big-endian
// words) lies in an interval; 0 where ok is 0, Z is 0 or b >= remaining[k].
VG_FN int32_t p2tr_range_lane(const uint32_t* X, const uint32_t* Z,
                              const uint32_t* zi, const int32_t* ok,
                              const uint32_t* lo, const uint32_t* hi,
                              int n_slots, const int32_t* remaining, long B,
                              long N, long e) {
  const long k = e / B, b = e - k * B;
  if (b >= (long)remaining[k]) return 0;
  uint32_t qx[8], w[8];
  if (!p2tr_qx(qx, X, Z, zi, ok, N, e)) return 0;
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = qx[7 - i];
  return in_intervals<8>(w, lo, hi, n_slots) ? 1 : 0;
}

// Kernel I, lane e: 1 when the DFA accepts the bech32m address of the
// output key; 0 where ok is 0, Z is 0 or b >= remaining[k].
VG_FN int32_t p2tr_dfa_lane(const uint32_t* X, const uint32_t* Z,
                            const uint32_t* zi, const int32_t* ok, const Dfa& dfa,
                            const int32_t* remaining, long B, long N, long e) {
  const long k = e / B, b = e - k * B;
  if (b >= (long)remaining[k]) return 0;
  uint32_t qx[8];
  if (!p2tr_qx(qx, X, Z, zi, ok, N, e)) return 0;
  uint8_t syms[kBech32mSyms];
  bech32m_p2tr_symbols(syms, qx);
  return dfa_walk(dfa, syms, kBech32mSyms, kBech32mSyms) ? 1 : 0;
}

}  // namespace vg
