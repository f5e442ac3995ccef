// secp256k1 base-field arithmetic on 4x64-bit limbs (__int128 products).
//
// Native CPU counterpart of the device field (vgen_tpu/ops/field.py) and the
// reference's WGSL field (reference shaders/field.wgsl:9-210) -- but sized
// for 64-bit scalar cores instead of u32 SIMT lanes.  Reduction uses the
// same identity 2^256 == 2^32 + 977 (mod p).
#pragma once

#include <cstdint>
#include <cstring>

namespace vgen {

using u64 = std::uint64_t;
using u128 = unsigned __int128;

struct Fe {  // little-endian limbs, canonical (< p) at API boundaries
  u64 n[4];
};

static constexpr u64 P0 = 0xFFFFFFFEFFFFFC2FULL;
static constexpr u64 P1 = 0xFFFFFFFFFFFFFFFFULL;
static constexpr u64 P2 = 0xFFFFFFFFFFFFFFFFULL;
static constexpr u64 P3 = 0xFFFFFFFFFFFFFFFFULL;
// 2^256 mod p = 2^32 + 977
static constexpr u64 C977 = 0x1000003D1ULL;

inline bool fe_is_zero(const Fe& a) {
  return (a.n[0] | a.n[1] | a.n[2] | a.n[3]) == 0;
}

inline bool fe_eq(const Fe& a, const Fe& b) {
  return ((a.n[0] ^ b.n[0]) | (a.n[1] ^ b.n[1]) | (a.n[2] ^ b.n[2]) |
          (a.n[3] ^ b.n[3])) == 0;
}

inline bool fe_geq_p(const Fe& a) {
  if (a.n[3] != P3) return a.n[3] > P3;
  if (a.n[2] != P2) return a.n[2] > P2;
  if (a.n[1] != P1) return a.n[1] > P1;
  return a.n[0] >= P0;
}

// Borrow-chain subtraction: r = a - b, returns borrow.
inline u64 sub256(Fe& r, const Fe& a, const Fe& b) {
  u64 borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 t = (u128)a.n[i] - b.n[i] - borrow;
    r.n[i] = (u64)t;
    borrow = (u64)(t >> 127);  // top bit set iff wrapped negative
  }
  return borrow;
}

inline u64 add256(Fe& r, const Fe& a, const Fe& b) {
  u128 c = 0;
  for (int i = 0; i < 4; i++) {
    c += (u128)a.n[i] + b.n[i];
    r.n[i] = (u64)c;
    c >>= 64;
  }
  return (u64)c;
}

inline void fe_normalize(Fe& a) {
  if (fe_geq_p(a)) {
    Fe p{{P0, P1, P2, P3}};
    Fe r;
    sub256(r, a, p);
    a = r;
  }
}

inline void fe_add(Fe& r, const Fe& a, const Fe& b) {
  u64 carry = add256(r, a, b);
  if (carry) {  // r_true = r + 2^256 == r + 2^32 + 977 (mod p)
    u128 c = (u128)r.n[0] + C977;
    r.n[0] = (u64)c;
    c >>= 64;
    for (int i = 1; i < 4 && c; i++) {
      c += r.n[i];
      r.n[i] = (u64)c;
      c >>= 64;
    }
    // a,b < p < 2^256-2^32-977 so no second overflow possible here
  }
  fe_normalize(r);
}

inline void fe_sub(Fe& r, const Fe& a, const Fe& b) {
  u64 borrow = sub256(r, a, b);
  if (borrow) {  // add p back == subtract 2^32+977 mod 2^256
    u128 c = (u128)r.n[0] - C977;
    r.n[0] = (u64)c;
    u64 br2 = (c >> 127) ? 1 : 0;
    for (int i = 1; i < 4 && br2; i++) {
      u128 t = (u128)r.n[i] - br2;
      r.n[i] = (u64)t;
      br2 = (t >> 127) ? 1 : 0;
    }
  }
}

inline void fe_neg(Fe& r, const Fe& a) {
  if (fe_is_zero(a)) {
    r = a;
    return;
  }
  Fe p{{P0, P1, P2, P3}};
  sub256(r, p, a);
}

// Full 256x256 -> reduce mod p.  Schoolbook with 128-bit accumulators, then
// two folds of the high 256 bits via 2^256 == 2^32+977.
inline void fe_mul(Fe& r, const Fe& a, const Fe& b) {
  u64 w[8];
  {
    u128 acc = 0;
    for (int k = 0; k < 7; k++) {
      u64 over = 0;  // 128-bit overflows of the running column sum
      for (int i = (k < 4 ? 0 : k - 3); i <= (k < 4 ? k : 3); i++) {
        int j = k - i;
        u128 p = (u128)a.n[i] * b.n[j];
        acc += p;
        if (acc < p) over++;
      }
      w[k] = (u64)acc;
      acc = (acc >> 64) | ((u128)over << 64);
    }
    w[7] = (u64)acc;
  }
  // fold: result = lo + hi * (2^32 + 977)
  u64 lo[5];  // 4 limbs + carry limb
  {
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
      u128 t = (u128)w[4 + i] * C977 + w[i] + c;
      lo[i] = (u64)t;
      c = t >> 64;
    }
    lo[4] = (u64)c;
  }
  // second fold of the (max 65-bit) overflow
  {
    u128 t = (u128)lo[4] * C977 + lo[0];
    r.n[0] = (u64)t;
    u128 c = t >> 64;
    for (int i = 1; i < 4; i++) {
      c += lo[i];
      r.n[i] = (u64)c;
      c >>= 64;
    }
    if (c) {  // third fold, carry is 1
      u128 t2 = (u128)r.n[0] + C977;
      r.n[0] = (u64)t2;
      u64 cc = (u64)(t2 >> 64);
      for (int i = 1; i < 4 && cc; i++) {
        u128 t3 = (u128)r.n[i] + cc;
        r.n[i] = (u64)t3;
        cc = (u64)(t3 >> 64);
      }
    }
  }
  fe_normalize(r);
}

inline void fe_sqr(Fe& r, const Fe& a) { fe_mul(r, a, a); }

// Fermat inversion via the standard secp256k1 addition chain.
inline void fe_inv(Fe& r, const Fe& a) {
  Fe x1 = a, x2, x3, x6, x9, x11, x22, x44, x88, x176, x220, x223, t;
  auto sqn = [](Fe& out, const Fe& in, int n) {
    out = in;
    for (int i = 0; i < n; i++) fe_sqr(out, out);
  };
  sqn(t, x1, 1);
  fe_mul(x2, t, x1);
  sqn(t, x2, 1);
  fe_mul(x3, t, x1);
  sqn(t, x3, 3);
  fe_mul(x6, t, x3);
  sqn(t, x6, 3);
  fe_mul(x9, t, x3);
  sqn(t, x9, 2);
  fe_mul(x11, t, x2);
  sqn(t, x11, 11);
  fe_mul(x22, t, x11);
  sqn(t, x22, 22);
  fe_mul(x44, t, x22);
  sqn(t, x44, 44);
  fe_mul(x88, t, x44);
  sqn(t, x88, 88);
  fe_mul(x176, t, x88);
  sqn(t, x176, 44);
  fe_mul(x220, t, x44);
  sqn(t, x220, 3);
  fe_mul(x223, t, x3);
  sqn(t, x223, 23);
  fe_mul(t, t, x22);
  sqn(t, t, 5);
  fe_mul(t, t, x1);
  sqn(t, t, 3);
  fe_mul(t, t, x2);
  sqn(t, t, 2);
  fe_mul(r, t, x1);
}

inline void fe_from_bytes_be(Fe& r, const unsigned char* b) {
  for (int i = 0; i < 4; i++) {
    u64 v = 0;
    for (int j = 0; j < 8; j++) v = (v << 8) | b[(3 - i) * 8 + j];
    r.n[i] = v;
  }
}

inline void fe_to_bytes_be(unsigned char* b, const Fe& a) {
  for (int i = 0; i < 4; i++) {
    u64 v = a.n[3 - i];
    for (int j = 7; j >= 0; j--) {
      b[i * 8 + (7 - j)] = (unsigned char)(v >> (8 * j));
    }
  }
}

}  // namespace vgen
