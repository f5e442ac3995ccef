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
// a table the compiler builds (constexpr) into device memory, read through
// the read-only cache (VG_LDG) by lanes that index it at run time
#define VG_TABLE __device__ const
// a constexpr function the compiler runs for such a table
#define VG_HD __host__ __device__
#define VG_LDG(p) __ldg(p)
#else
#define VG_FN inline
#define VG_CONSTANT static const
#define VG_TABLE static constexpr
#define VG_HD
#define VG_LDG(p) (*(p))
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

// t = a * b, the 512-bit product in 16 limbs: one row of eight
// multiply-adds per limb of a, each row's carry chain in 64 bits.
VG_FN void fe_mul_wide(uint32_t t[16], const uint32_t a[8], const uint32_t b[8]) {
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
}

// r = t mod p for any 512-bit t (16 limbs), canonical: the high half
// folds back as hi * 977 + (hi << 32), then twice more what carries out.
VG_FN void fe_reduce512(uint32_t r[8], const uint32_t t[16]) {
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

// r = a * b mod p.  r may alias a or b.
VG_FN void fe_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t t[16];
  fe_mul_wide(t, a, b);
  fe_reduce512(r, t);
}

// r = a^2 mod p with 36 products: the 28 cross products a[i] a[j] (i < j)
// in rows with 64-bit carry chains, doubled by a one-bit shift, plus the
// 8 squares a[i]^2, then the fold of fe_mul.  r may alias a.
VG_FN void fe_sqr(uint32_t r[8], const uint32_t a[8]) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < 7; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = i + 1; j < 8; j++) {
      c += (u64)a[i] * a[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  // the cross sum is below 2^511, so doubling it cannot carry out
#pragma unroll
  for (int i = 15; i > 0; i--) t[i] = (t[i] << 1) | (t[i - 1] >> 31);
  t[0] <<= 1;
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const u64 sq = (u64)a[i] * a[i];
    c += (u64)t[2 * i] + (uint32_t)sq;
    t[2 * i] = (uint32_t)c;
    c = (c >> 32) + (u64)t[2 * i + 1] + (sq >> 32);
    t[2 * i + 1] = (uint32_t)c;
    c >>= 32;
  }
  fe_reduce512(r, t);
}

// r = a^-1 mod p by Bernstein and Yang's divsteps, in the constant-time
// form of libsecp256k1's modinv32: 20 rounds of 30 steps on signed 30-bit
// limbs (600 steps; 590 suffice for any 256-bit input), each round's
// transition matrix then applied to (d, e) mod p and to (f, g).  Its
// dependent chain is 32-bit steps and short multiply-adds: on one lane
// about a sixth of the latency of the 270-step addition chain a^(p-2).
// inv(0) = 0; the result is canonical.
namespace divsteps {

constexpr int32_t kM30 = 0x3FFFFFFF;
constexpr uint32_t kPInv30 = 0x2DDACACFu;  // p^-1 mod 2^30

// limb i of p in signed 30-bit limbs: -977 - 4 2^30 + 2^16 2^240
VG_FN int32_t p30(int i) {
  return i == 0 ? -977 : i == 1 ? -4 : i == 8 ? 65536 : 0;
}

// 30 steps on the low bits of f (odd) and g: the transition matrix
// t = (u, v, q, r), scaled by 2^30, and the new zeta = -(delta + 1/2).
VG_FN int32_t steps(int32_t zeta, uint32_t f, uint32_t g, int32_t t[4]) {
  uint32_t u = 1u, v = 0u, q = 0u, r = 1u;
#pragma unroll
  for (int i = 0; i < 30; i++) {
    const uint32_t c1 = (uint32_t)(zeta >> 31);  // zeta < 0
    const uint32_t c2 = 0u - (g & 1u);           // g odd
    g += ((f ^ c1) - c1) & c2;
    q += ((u ^ c1) - c1) & c2;
    r += ((v ^ c1) - c1) & c2;
    const uint32_t c = c1 & c2;  // swap: f takes the old g
    zeta = (zeta ^ (int32_t)c) - 1;
    f += g & c;
    u += q & c;
    v += r & c;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return zeta;
}

// (f, g) = t (f, g) / 2^30, exactly
VG_FN void update_fg(int32_t f[9], int32_t g[9], const int32_t t[4]) {
  int64_t cf = ((int64_t)t[0] * f[0] + (int64_t)t[1] * g[0]) >> 30;
  int64_t cg = ((int64_t)t[2] * f[0] + (int64_t)t[3] * g[0]) >> 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cf += (int64_t)t[0] * f[i] + (int64_t)t[1] * g[i];
    cg += (int64_t)t[2] * f[i] + (int64_t)t[3] * g[i];
    f[i - 1] = (int32_t)cf & kM30;
    g[i - 1] = (int32_t)cg & kM30;
    cf >>= 30;
    cg >>= 30;
  }
  f[8] = (int32_t)cf;
  g[8] = (int32_t)cg;
}

// (d, e) = (t (d, e) + p (md, me)) / 2^30, md and me chosen so that the
// division is exact: (d, e) stay in (-2p, p)
VG_FN void update_de(int32_t d[9], int32_t e[9], const int32_t t[4]) {
  const int32_t sd = d[8] >> 31, se = e[8] >> 31;
  int32_t md = (t[0] & sd) + (t[1] & se);
  int32_t me = (t[2] & sd) + (t[3] & se);
  int64_t cd = (int64_t)t[0] * d[0] + (int64_t)t[1] * e[0];
  int64_t ce = (int64_t)t[2] * d[0] + (int64_t)t[3] * e[0];
  md -= (int32_t)((kPInv30 * (uint32_t)cd + (uint32_t)md) & kM30);
  me -= (int32_t)((kPInv30 * (uint32_t)ce + (uint32_t)me) & kM30);
  cd = (cd + (int64_t)p30(0) * md) >> 30;
  ce = (ce + (int64_t)p30(0) * me) >> 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cd += (int64_t)t[0] * d[i] + (int64_t)t[1] * e[i] + (int64_t)p30(i) * md;
    ce += (int64_t)t[2] * d[i] + (int64_t)t[3] * e[i] + (int64_t)p30(i) * me;
    d[i - 1] = (int32_t)cd & kM30;
    e[i - 1] = (int32_t)ce & kM30;
    cd >>= 30;
    ce >>= 30;
  }
  d[8] = (int32_t)cd;
  e[8] = (int32_t)ce;
}

// r in (-2p, p), negated if sign < 0 -> [0, p), limbs in [0, 2^30)
VG_FN void normalize(int32_t r[9], int32_t sign) {
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int pass = 0; pass < 2; pass++) {
    const int32_t add = r[8] >> 31;
#pragma unroll
    for (int i = 0; i < 9; i++) {
      r[i] += p30(i) & add;
      if (pass == 0) r[i] = (r[i] ^ neg) - neg;
    }
#pragma unroll
    for (int i = 0; i < 8; i++) {
      r[i + 1] += r[i] >> 30;
      r[i] &= kM30;
    }
  }
}

}  // namespace divsteps

VG_FN void fe_inv(uint32_t r[8], const uint32_t a[8]) {
  using namespace divsteps;
  int32_t d[9], e[9], f[9], g[9];
#pragma unroll
  for (int i = 0; i < 9; i++) {
    d[i] = 0;
    e[i] = i == 0;
    f[i] = p30(i);
    // bits 30 i .. 30 i + 29 of a
    const int w = 30 * i / 32, s = 30 * i % 32;
    uint32_t x = a[w] >> s;
    if (s > 2 && w < 7) x |= a[w + 1] << (32 - s);
    g[i] = (int32_t)(x & kM30);
  }
  int32_t zeta = -1;  // delta = 1/2
#pragma unroll 1
  for (int round = 0; round < 20; round++) {
    int32_t t[4];
    zeta = steps(zeta, (uint32_t)f[0], (uint32_t)g[0], t);
    update_de(d, e, t);
    update_fg(f, g, t);
  }
  // f = +-1 now, and d = +-a^-1
  normalize(d, f[8]);
#pragma unroll
  for (int w = 0; w < 8; w++) {
    const int i = 32 * w / 30, s = 32 * w % 30;
    r[w] = ((uint32_t)d[i] >> s) | ((uint32_t)d[i + 1] << (30 - s));
  }
}

}  // namespace vg
