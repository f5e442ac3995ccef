// secp256k1 group operations for the native CPU scanner.
//
// The scan hot loop mirrors the device design (vgen_tpu/ops/curve.py and the
// reference's incremental i*G trick, reference src/gpu.rs:901-910 +
// shaders/search.wgsl:17): one base point B = k*G per batch, then P_i =
// B + T[i] by affine addition with a Montgomery-batched inversion over the
// whole batch.
#pragma once

#include <vector>

#include "field.h"

namespace vgen {

struct Aff {
  Fe x, y;
  bool inf = false;
};

struct Jac {
  Fe X, Y, Z;  // Z == 0 <=> infinity
};

inline const Aff& generator() {
  static Aff G = [] {
    Aff g;
    static const unsigned char gx[32] = {
        0x79, 0xBE, 0x66, 0x7E, 0xF9, 0xDC, 0xBB, 0xAC, 0x55, 0xA0, 0x62,
        0x95, 0xCE, 0x87, 0x0B, 0x07, 0x02, 0x9B, 0xFC, 0xDB, 0x2D, 0xCE,
        0x28, 0xD9, 0x59, 0xF2, 0x81, 0x5B, 0x16, 0xF8, 0x17, 0x98};
    static const unsigned char gy[32] = {
        0x48, 0x3A, 0xDA, 0x77, 0x26, 0xA3, 0xC4, 0x65, 0x5D, 0xA4, 0xFB,
        0xFC, 0x0E, 0x11, 0x08, 0xA8, 0xFD, 0x17, 0xB4, 0x48, 0xA6, 0x85,
        0x54, 0x19, 0x9C, 0x47, 0xD0, 0x8F, 0xFB, 0x10, 0xD4, 0xB8};
    fe_from_bytes_be(g.x, gx);
    fe_from_bytes_be(g.y, gy);
    return g;
  }();
  return G;
}

inline void jac_set_infinity(Jac& p) {
  p.X = Fe{{1, 0, 0, 0}};
  p.Y = Fe{{1, 0, 0, 0}};
  p.Z = Fe{{0, 0, 0, 0}};
}

inline bool jac_is_infinity(const Jac& p) { return fe_is_zero(p.Z); }

inline void jac_from_affine(Jac& r, const Aff& a) {
  r.X = a.x;
  r.Y = a.y;
  r.Z = Fe{{1, 0, 0, 0}};
}

// dbl-2009-l (a = 0).  Alias-safe: r may be the same object as p.
inline void jac_double(Jac& r, const Jac& p) {
  if (jac_is_infinity(p)) {
    r = p;
    return;
  }
  Fe A, B, C, D, E, F, t, t2, X3, Y3, Z3;
  fe_sqr(A, p.X);
  fe_sqr(B, p.Y);
  fe_sqr(C, B);
  fe_add(t, p.X, B);
  fe_sqr(t, t);
  fe_sub(t, t, A);
  fe_sub(t, t, C);
  fe_add(D, t, t);
  fe_add(E, A, A);
  fe_add(E, E, A);
  fe_sqr(F, E);
  fe_add(t2, D, D);
  fe_sub(X3, F, t2);
  fe_sub(t, D, X3);
  fe_mul(t, E, t);
  Fe C8;
  fe_add(C8, C, C);
  fe_add(C8, C8, C8);
  fe_add(C8, C8, C8);
  fe_sub(Y3, t, C8);
  fe_mul(t, p.Y, p.Z);
  fe_add(Z3, t, t);
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

// Mixed add r = p + q (q affine).
inline void jac_add_affine(Jac& r, const Jac& p, const Aff& q) {
  if (q.inf) {
    r = p;
    return;
  }
  if (jac_is_infinity(p)) {
    jac_from_affine(r, q);
    return;
  }
  Fe Z1Z1, U2, S2, H, rr, HH, HHH, V, t;
  fe_sqr(Z1Z1, p.Z);
  fe_mul(U2, q.x, Z1Z1);
  fe_mul(S2, q.y, p.Z);
  fe_mul(S2, S2, Z1Z1);
  fe_sub(H, U2, p.X);
  fe_sub(rr, S2, p.Y);
  if (fe_is_zero(H)) {
    if (fe_is_zero(rr)) {
      jac_double(r, p);
      return;
    }
    jac_set_infinity(r);
    return;
  }
  fe_sqr(HH, H);
  fe_mul(HHH, H, HH);
  fe_mul(V, p.X, HH);
  fe_sqr(t, rr);
  fe_sub(t, t, HHH);
  Fe V2, X3, Y3, Z3;
  fe_add(V2, V, V);
  fe_sub(X3, t, V2);
  fe_sub(t, V, X3);
  fe_mul(t, rr, t);
  Fe YH;
  fe_mul(YH, p.Y, HHH);
  fe_sub(Y3, t, YH);
  fe_mul(Z3, p.Z, H);  // alias-safe: outputs assigned after all reads of p
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

inline void jac_to_affine(Aff& r, const Jac& p) {
  if (jac_is_infinity(p)) {
    r.inf = true;
    return;
  }
  Fe zi, zi2, zi3;
  fe_inv(zi, p.Z);
  fe_sqr(zi2, zi);
  fe_mul(zi3, zi2, zi);
  fe_mul(r.x, p.X, zi2);
  fe_mul(r.y, p.Y, zi3);
  r.inf = false;
}

// scalar (32 bytes BE) * G, double-and-add.  Cold path only (one per batch).
inline void scalar_mul_g(Aff& r, const unsigned char* k32) {
  Jac acc;
  jac_set_infinity(acc);
  const Aff& G = generator();
  for (int i = 0; i < 256; i++) {
    jac_double(acc, acc);
    int byte = i / 8, bit = 7 - (i % 8);
    if ((k32[byte] >> bit) & 1) jac_add_affine(acc, acc, G);
  }
  jac_to_affine(r, acc);
}

// Batch affine add: out[i] = B + T[i], one inversion per batch via the
// Montgomery product chain (the reference's search.wgsl:59-135 scheme,
// sequential on CPU).  T entries must differ from B in x (vanishing
// probability for random B; caller masks by checking dx == 0 -> skip).
inline void batch_affine_add(std::vector<Aff>& out, const Aff& B,
                             const Aff* T, int n) {
  std::vector<Fe> dx(n), pref(n);
  Fe acc{{1, 0, 0, 0}};
  for (int i = 0; i < n; i++) {
    fe_sub(dx[i], T[i].x, B.x);
    if (fe_is_zero(dx[i])) dx[i] = Fe{{1, 0, 0, 0}};  // masked degenerate
    pref[i] = acc;
    fe_mul(acc, acc, dx[i]);
  }
  Fe inv_all;
  fe_inv(inv_all, acc);
  for (int i = n - 1; i >= 0; i--) {
    Fe inv_i;
    fe_mul(inv_i, inv_all, pref[i]);     // 1/dx[i]
    fe_mul(inv_all, inv_all, dx[i]);     // strip dx[i]
    Fe lam, t;
    fe_sub(t, T[i].y, B.y);
    fe_mul(lam, t, inv_i);
    Fe x3, y3;
    fe_sqr(x3, lam);
    fe_sub(x3, x3, B.x);
    fe_sub(x3, x3, T[i].x);
    fe_sub(t, B.x, x3);
    fe_mul(t, lam, t);
    fe_sub(y3, t, B.y);
    out[i].x = x3;
    out[i].y = y3;
    out[i].inf = false;
  }
}

}  // namespace vgen
