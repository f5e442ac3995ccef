// Per-thread bodies of the table kernels T1 and T2 (tables.cu launches
// them), which build the i*G table of the scan and the P2TR ladder's
// window table on the card.  Like the other headers this compiles as plain
// C++ too, so the arithmetic can be driven from a host compiler.
//
// R rows of count multiples: row r holds [1..count] * P_r of an affine base
// point P_r.  The rows accumulate in Jacobian coordinates, limb-major (8,
// R count) uint32 arrays X, Y, Z with column c of row r at r * count + c
// holding (c + 1) P_r.  bases (R, steps, 2, 8) uint32 holds the affine
// 2^s P_r of each row, computed on the host.
#pragma once

#include "p2tr_lanes.cuh"

namespace vg {

// What jacobian_add_affine_full met
enum AddKind { kAdded = 0, kDoubled = 1, kInfinity = 2 };

// (X, Y, Z) = 2 (X, Y, Z) in Jacobian coordinates by dbl-2009-l for a = 0
// (vgen_tpu/ops/curve.py jacobian_double): 2M + 5S.
VG_FN void jacobian_double(uint32_t X[8], uint32_t Y[8], uint32_t Z[8]) {
  uint32_t A[8], Bv[8], C[8], D[8];
  fe_mul(Z, Y, Z);
  fe_mul_small(Z, Z, 2u);   // Z3 = 2 Y1 Z1
  fe_sqr(A, X);
  fe_sqr(Bv, Y);
  fe_sqr(C, Bv);
  fe_add(D, X, Bv);
  fe_sqr(D, D);
  fe_sub(D, D, A);
  fe_sub(D, D, C);
  fe_mul_small(D, D, 2u);   // D = 2 ((X1 + B)^2 - A - C)
  fe_mul_small(A, A, 3u);   // E = 3A
  fe_sqr(X, A);
  fe_mul_small(Bv, D, 2u);
  fe_sub(X, X, Bv);         // X3 = E^2 - 2D
  fe_sub(D, D, X);
  fe_mul(Y, A, D);
  fe_mul_small(C, C, 8u);
  fe_sub(Y, Y, C);          // Y3 = E (D - X3) - 8C
}

// (X, Y, Z) += (x2, y2), the mixed add with its doubling
// (vgen_tpu/ops/curve.py jacobian_add_affine without z1_is_zero).  The
// lean add first; where it meets H == 0 it left Z = 0 and X = r^2, and r ==
// 0 (P == Q) takes the doubling of the saved operand by a branch: in a
// table build one lane per row and step meets it, so a select would make
// every lane pay the doubling.  P == -Q stays the point at infinity as the
// lean add left it (Z = 0, X = r^2, Y = -r^3), and is reported.
VG_FN AddKind jacobian_add_affine_full(uint32_t X[8], uint32_t Y[8],
                                       uint32_t Z[8], const uint32_t x2[8],
                                       const uint32_t y2[8]) {
  uint32_t X1[8], Y1[8], Z1[8];
  fe_copy(X1, X);
  fe_copy(Y1, Y);
  fe_copy(Z1, Z);
  if (jacobian_add_affine_lean(X, Y, Z, x2, y2)) return kAdded;
  if (!fe_is_zero(X)) return kInfinity;
  fe_copy(X, X1);
  fe_copy(Y, Y1);
  fe_copy(Z, Z1);
  jacobian_double(X, Y, Z);
  return kDoubled;
}

// T1's start: column 0 of row r is P_r = bases[r][0], Z = 1.
VG_FN void table_first_column(uint32_t* X, uint32_t* Y, uint32_t* Z,
                              const uint32_t* bases, long NT, long count,
                              int steps, long r) {
  const uint32_t* base = bases + r * steps * 16;
  const long e = r * count;
#pragma unroll
  for (int l = 0; l < 8; l++) {
    X[l * NT + e] = VG_LDG(base + l);
    Y[l * NT + e] = VG_LDG(base + 8 + l);
    Z[l * NT + e] = l == 0 ? 1u : 0u;
  }
}

// T1, one lane of log-doubling step s (n = 2^s): column n + i of row r
// becomes column i + 2^s P_r, for i < min(n, count - n).  The step reads
// columns [0, n) and writes [n, 2n), so a launch may update the arrays in
// place.  NT = R count, the arrays' stride.  Returns what the add met.
VG_FN AddKind table_grow_lane(uint32_t* X, uint32_t* Y, uint32_t* Z,
                              const uint32_t* bases, long NT, long count,
                              int steps, int s, long r, long i) {
  uint32_t a[8], b[8], c[8], x2[8], y2[8];
  const long src = r * count + i;
  const uint32_t* base = bases + (r * steps + s) * 16;
#pragma unroll
  for (int l = 0; l < 8; l++) {
    x2[l] = VG_LDG(base + l);
    y2[l] = VG_LDG(base + 8 + l);
  }
  fe_load(a, X, NT, src);
  fe_load(b, Y, NT, src);
  fe_load(c, Z, NT, src);
  const AddKind kind = jacobian_add_affine_full(a, b, c, x2, y2);
  const long dst = src + (1L << s);
  fe_store(X, NT, dst, a);
  fe_store(Y, NT, dst, b);
  fe_store(Z, NT, dst, c);
  return kind;
}

// T2, one lane: the affine (x, y) = (X zi^2, Y zi^3) of column i of row r,
// zi = 1 / Z from kernel G, written in the consumer's layout.  ladder == 0:
// the i*G table, (8, NT) limb-major tx = out_x and ty = out_y (R = 1).
// ladder != 0: the ladder table out_x (R, count + 1, 2, 8), entry [r][i +
// 1] = (x, y), and the lane of column 0 also zeroes the filler entry
// [r][0].
VG_FN void table_affine_lane(const uint32_t* X, const uint32_t* Y,
                             const uint32_t* zi, uint32_t* out_x,
                             uint32_t* out_y, long NT, long count, int ladder,
                             long r, long i) {
  uint32_t x[8], y[8], z[8], z2[8];
  const long e = r * count + i;
  fe_load(z, zi, NT, e);
  fe_sqr(z2, z);
  fe_load(x, X, NT, e);
  fe_mul(x, x, z2);
  fe_mul(z2, z2, z);
  fe_load(y, Y, NT, e);
  fe_mul(y, y, z2);
  if (!ladder) {
    fe_store(out_x, NT, e, x);
    fe_store(out_y, NT, e, y);
    return;
  }
  uint32_t* entry = out_x + (r * (count + 1) + i + 1) * 16;
#pragma unroll
  for (int l = 0; l < 8; l++) {
    entry[l] = x[l];
    entry[8 + l] = y[l];
  }
  if (i == 0) {
    uint32_t* filler = entry - 16;
#pragma unroll
    for (int l = 0; l < 16; l++) filler[l] = 0u;
  }
}

}  // namespace vg
