// Field-multiply forms the product does not use, timed by the probes
// beside the production ones (csrc/field.cuh): the squaring as a full
// multiply (the product's squaring before its dedicated one), the
// multiply with 64-bit accumulators (the product's before its carry
// chains), the product split into column sums with no carry and a
// separate carry pass (the TPU's "nocarry" form), and the whole multiply
// in that form.  Like the headers in csrc/ this compiles as plain C++ too.
#pragma once

#include "field.cuh"

namespace vg {

// r = a^2 mod p as the full multiply fe_mul(a, a): the squaring the
// product used before csrc/field.cuh gained its dedicated fe_sqr, kept so
// that the probes time both.
VG_FN void fe_sqr_by_mul(uint32_t r[8], const uint32_t a[8]) { fe_mul(r, a, a); }

// r = a * b mod p with every partial product and carry in a 64-bit
// accumulator: one row of eight multiply-adds per limb of a, then the
// fold lo + hi * 977 + (hi << 32) and twice more what carries out, then
// the conditional subtract of p.  r may alias a or b.
VG_FN void fe_mul_u64(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t t[16], s[8], v[8];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (u64)a[i] * b[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  // fold 1: lo + hi * 977 + (hi << 32); each step < 2^43
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (u64)t[i] + (u64)t[8 + i] * 977u;
    if (i > 0) c += t[7 + i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  const u64 top = c + t[15];  // bits 256.., < 2^34
  // fold 2: top * (2^32 + 977)
  const u64 t977 = top * 977u;
  c = (u64)s[0] + (uint32_t)t977;
  s[0] = (uint32_t)c;
  c = (c >> 32) + (u64)s[1] + (t977 >> 32) + (uint32_t)top;
  s[1] = (uint32_t)c;
  c = (c >> 32) + (u64)s[2] + (top >> 32);
  s[2] = (uint32_t)c;
  c >>= 32;
#pragma unroll
  for (int i = 3; i < 8; i++) {
    c += s[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  // fold 3: a carry out here leaves a small low part, so this cannot carry
  const uint32_t c3 = (uint32_t)c;
  c = (u64)s[0] + 977u * c3;
  s[0] = (uint32_t)c;
  c = (c >> 32) + (u64)s[1] + c3;
  s[1] = (uint32_t)c;
  c >>= 32;
#pragma unroll
  for (int i = 2; i < 8; i++) {
    c += s[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  // s >= p exactly when s + (2^32 + 977) carries out of 2^256
  c = (u64)s[0] + 977u;
  v[0] = (uint32_t)c;
  c = (c >> 32) + (u64)s[1] + 1u;
  v[1] = (uint32_t)c;
  c >>= 32;
#pragma unroll
  for (int i = 2; i < 8; i++) {
    c += s[i];
    v[i] = (uint32_t)c;
    c >>= 32;
  }
  const uint32_t m = 0u - (uint32_t)c;
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = (v[i] & m) | (s[i] & ~m);
}

// Column sums of a * b with no carry between columns: the low half of
// a[i] b[j] adds to column i + j, the high half to column i + j + 1.
// Each column sums at most 16 halves, so stays below 2^36.
VG_FN void fe_mul_cols_nocarry(u64 cols[16], const uint32_t a[8], const uint32_t b[8]) {
#pragma unroll
  for (int k = 0; k < 16; k++) cols[k] = 0ull;
#pragma unroll
  for (int i = 0; i < 8; i++) {
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const u64 p = (u64)a[i] * b[j];
      cols[i + j] += (uint32_t)p;
      cols[i + j + 1] += p >> 32;
    }
  }
}

// Carry propagation of 16 columns (each below 2^63) into 16 limbs;
// returns the carry out of the top limb.
VG_FN uint32_t fe_carry_cols(uint32_t t[16], const u64 cols[16]) {
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < 16; k++) {
    c += cols[k];
    t[k] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// r = a * b mod p in the column form: the column sums, one carry pass (the
// product is below 2^512, so nothing carries out), then the production
// fold.  r may alias a or b.
VG_FN void fe_mul_colsum(uint32_t r[8], const uint32_t a[8],
                          const uint32_t b[8]) {
  u64 cols[16];
  uint32_t t[16];
  fe_mul_cols_nocarry(cols, a, b);
  fe_carry_cols(t, cols);
  fe_reduce512(r, t);
}

}  // namespace vg
