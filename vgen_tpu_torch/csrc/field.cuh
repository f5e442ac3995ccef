// secp256k1 base field F_p on 8 x 32-bit little-endian limbs.
//
// p = 2^256 - 2^32 - 977, so 2^256 = 2^32 + 977 (mod p): the high half of
// a 512-bit product folds back with a multiply by 977 and a one-limb shift
// (the algorithm of vgen_tpu/native/src/field.h, there on 64-bit limbs).
// Products are 32 x 32 -> 64 bits in unsigned long long; carry chains in
// PTX (mad.lo.cc / madc.hi.cc) are for a later change.
//
// Every function keeps values canonical (< p).  The header also compiles
// as plain C++ (VG_FN is then an inline host function), so its arithmetic
// can be exercised with a host compiler.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define VG_FN __device__ __forceinline__
#define VG_CONSTANT __constant__
#else
#define VG_FN inline
#define VG_CONSTANT static const
#endif

namespace vg {

typedef unsigned long long u64;

VG_FN void fe_copy(uint32_t r[8], const uint32_t a[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = a[i];
}

VG_FN void fe_set_one(uint32_t r[8]) {
  r[0] = 1u;
#pragma unroll
  for (int i = 1; i < 8; i++) r[i] = 0u;
}

VG_FN bool fe_is_zero(const uint32_t a[8]) {
  uint32_t acc = a[0];
#pragma unroll
  for (int i = 1; i < 8; i++) acc |= a[i];
  return acc == 0u;
}

// r[l] = src[l * stride + idx]: one limb-major column of an (8, stride) array
VG_FN void fe_load(uint32_t r[8], const uint32_t* src, long stride, long idx) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = src[i * stride + idx];
}

VG_FN void fe_store(uint32_t* dst, long stride, long idx, const uint32_t a[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) dst[i * stride + idx] = a[i];
}

// a < 2^256 -> a mod p.  a >= p exactly when a + (2^32 + 977) carries out
// of 2^256, and then that sum (mod 2^256) is a - p.
VG_FN void fe_normalize(uint32_t a[8]) {
  uint32_t t[8];
  u64 c = (u64)a[0] + 977u;
  t[0] = (uint32_t)c;
  c = (c >> 32) + (u64)a[1] + 1u;
  t[1] = (uint32_t)c;
  c >>= 32;
#pragma unroll
  for (int i = 2; i < 8; i++) {
    c += a[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  const uint32_t m = 0u - (uint32_t)c;  // all ones when a >= p
#pragma unroll
  for (int i = 0; i < 8; i++) a[i] = (t[i] & m) | (a[i] & ~m);
}

// r = a - b mod p (a, b canonical).  On borrow the wrapped difference is
// a - b + 2^256; adding p is subtracting 2^32 + 977, which cannot borrow.
VG_FN void fe_sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 t = (u64)a[i] - b[i] - borrow;
    r[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  u64 t = (u64)r[0] - (u64)(977u * borrow);
  r[0] = (uint32_t)t;
  uint32_t br = (uint32_t)(t >> 63);
  t = (u64)r[1] - borrow - br;
  r[1] = (uint32_t)t;
  br = (uint32_t)(t >> 63);
#pragma unroll
  for (int i = 2; i < 8; i++) {
    t = (u64)r[i] - br;
    r[i] = (uint32_t)t;
    br = (uint32_t)(t >> 63);
  }
}

// r = a + b mod p (a, b canonical).  A carry out of 2^256 is worth
// 2^32 + 977, and then the folded sum is already < p; otherwise the sum
// (< 2^256) is normalized.
VG_FN void fe_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (u64)a[i] + b[i];
    r[i] = (uint32_t)c;
    c >>= 32;
  }
  const uint32_t carry = (uint32_t)c;
  c = (u64)r[0] + 977u * carry;
  r[0] = (uint32_t)c;
  c = (c >> 32) + (u64)r[1] + carry;
  r[1] = (uint32_t)c;
  c >>= 32;
#pragma unroll
  for (int i = 2; i < 8; i++) {
    c += r[i];
    r[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_normalize(r);
}

// r = -a mod p, canonical (-0 = 0), so r[0] & 1 is the parity of -a.
VG_FN void fe_neg(uint32_t r[8], const uint32_t a[8]) {
  const uint32_t m = fe_is_zero(a) ? 0u : ~0u;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint32_t pi = i == 0 ? 0xFFFFFC2Fu : (i == 1 ? 0xFFFFFFFEu : ~0u);
    const u64 t = (u64)pi - a[i] - borrow;
    r[i] = (uint32_t)t & m;
    borrow = (uint32_t)(t >> 63);
  }
}

// r = a * k mod p for a small constant k < 2^16.
VG_FN void fe_mul_small(uint32_t r[8], const uint32_t a[8], uint32_t k) {
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (u64)a[i] * k;
    r[i] = (uint32_t)c;
    c >>= 32;
  }
  // fold the top (< 2^16) as top * (2^32 + 977); a second carry leaves a
  // small low part, so its fold cannot carry again
#pragma unroll
  for (int f = 0; f < 2; f++) {
    const uint32_t top = (uint32_t)c;
    c = (u64)r[0] + (u64)977u * top;
    r[0] = (uint32_t)c;
    c = (c >> 32) + (u64)r[1] + top;
    r[1] = (uint32_t)c;
    c >>= 32;
#pragma unroll
    for (int i = 2; i < 8; i++) {
      c += r[i];
      r[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  fe_normalize(r);
}

// r = a * b mod p.  r may alias a or b.
VG_FN void fe_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t t[16];
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
  uint32_t s[8];
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
  fe_normalize(s);
  fe_copy(r, s);
}

VG_FN void fe_sqr(uint32_t r[8], const uint32_t a[8]) { fe_mul(r, a, a); }

VG_FN void fe_sqr_n(uint32_t r[8], int n) {
  for (int i = 0; i < n; i++) fe_sqr(r, r);
}

// r = a^(p-2): the secp256k1 addition chain of vgen_tpu/ops/field.py inv,
// 255 squarings and 15 multiplies.  inv(0) = 0.
VG_FN void fe_inv(uint32_t r[8], const uint32_t a[8]) {
  uint32_t x1[8], x2[8], x3[8], x11[8], x22[8], x44[8], t[8], u[8];
  fe_copy(x1, a);
  fe_sqr(x2, x1);
  fe_mul(x2, x2, x1);
  fe_sqr(x3, x2);
  fe_mul(x3, x3, x1);
  fe_copy(t, x3);  // x6
  fe_sqr_n(t, 3);
  fe_mul(t, t, x3);
  fe_sqr_n(t, 3);  // x9
  fe_mul(t, t, x3);
  fe_copy(x11, t);
  fe_sqr_n(x11, 2);
  fe_mul(x11, x11, x2);
  fe_copy(x22, x11);
  fe_sqr_n(x22, 11);
  fe_mul(x22, x22, x11);
  fe_copy(x44, x22);
  fe_sqr_n(x44, 22);
  fe_mul(x44, x44, x22);
  fe_copy(t, x44);  // x88
  fe_sqr_n(t, 44);
  fe_mul(t, t, x44);
  fe_copy(u, t);  // x176
  fe_sqr_n(u, 88);
  fe_mul(u, u, t);
  fe_sqr_n(u, 44);  // x220
  fe_mul(u, u, x44);
  fe_sqr_n(u, 3);  // x223
  fe_mul(u, u, x3);
  fe_sqr_n(u, 23);
  fe_mul(u, u, x22);
  fe_sqr_n(u, 5);
  fe_mul(u, u, x1);
  fe_sqr_n(u, 3);
  fe_mul(u, u, x2);
  fe_sqr_n(u, 2);
  fe_mul(r, u, x1);
}

}  // namespace vg
