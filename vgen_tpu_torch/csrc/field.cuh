// secp256k1 base field F_p on 8 x 32-bit little-endian limbs.
//
// p = 2^256 - 2^32 - 977, so 2^256 = 2^32 + 977 (mod p): the high half of
// a 512-bit product folds back with a multiply by 977 and a one-limb shift
// (the algorithm of vgen_tpu/native/src/field.h, there on 64-bit limbs).
// Every partial product and carry runs in 32-bit carry chains (PTX's
// mad.lo.cc / madc.hi.cc, add.cc / addc, sub.cc / subc; below): no 64-bit
// accumulator.
//
// Every function keeps values canonical (< p).  The header also compiles
// as plain C++ (VG_FN is then an inline host function, and each chain
// instruction a function that keeps the carry flag in a variable), so its
// arithmetic can be exercised with a host compiler.
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

// Carry chains: PTX's add.cc / addc, sub.cc / subc and the multiply-adds
// mad.lo.cc / madc.lo.cc / mad.hi.cc / madc.hi.cc / madc.hi, one
// instruction each.  A ".cc" form writes the carry flag (for a subtract,
// the borrow), a "c" form adds it in (subtracts it), and a chain runs in
// program order from its first instruction, which reads no flag.  On the
// card each is inline PTX, volatile, so that nothing moves between the
// links of a chain; as plain C++ the flag is a variable of the thread, so
// a host compiler runs the same sequence.  addc(0, 0) reads the flag,
// subc(0, 0) turns a borrow into an all-ones mask.  A chain spans several
// asm statements, so it relies on ptxas carrying the flag from one to the
// next in program order, which PTX does not promise: chip_smoke.py and
// tests/test_torch_cuda.py, which hold every kernel bit-equal to its plain
// version on the card, are the guard.
#ifdef __CUDACC__
#define VG_CC2(name, op)                                              \
  VG_FN uint32_t name(uint32_t a, uint32_t b) {                       \
    uint32_t r;                                                       \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));       \
    return r;                                                         \
  }
#define VG_CC3(name, op)                                              \
  VG_FN uint32_t name(uint32_t a, uint32_t b, uint32_t c) {           \
    uint32_t r;                                                       \
    asm volatile(op " %0, %1, %2, %3;"                                \
                 : "=r"(r) : "r"(a), "r"(b), "r"(c));                 \
    return r;                                                         \
  }
VG_CC2(add_cc, "add.cc.u32")
VG_CC2(addc_cc, "addc.cc.u32")
VG_CC2(addc, "addc.u32")
VG_CC2(sub_cc, "sub.cc.u32")
VG_CC2(subc_cc, "subc.cc.u32")
VG_CC2(subc, "subc.u32")
VG_CC3(mad_lo_cc, "mad.lo.cc.u32")
VG_CC3(madc_lo_cc, "madc.lo.cc.u32")
VG_CC3(mad_hi_cc, "mad.hi.cc.u32")
VG_CC3(madc_hi_cc, "madc.hi.cc.u32")
VG_CC3(madc_hi, "madc.hi.u32")
#undef VG_CC2
#undef VG_CC3
#else
namespace chain {
inline thread_local uint32_t carry_flag = 0u;
// d = s mod 2^32; the flag takes s >> 32 (0 or 1) where `out` is set
inline uint32_t put(u64 s, bool out) {
  if (out) carry_flag = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
// d = a - b - borrow mod 2^32; the flag takes the borrow where `out` is set
inline uint32_t take(uint32_t a, uint32_t b, uint32_t borrow, bool out) {
  const u64 d = (u64)a - b - borrow;
  if (out) carry_flag = (uint32_t)(d >> 63);
  return (uint32_t)d;
}
inline u64 lo(uint32_t a, uint32_t b) { return (uint32_t)((u64)a * b); }
inline u64 hi(uint32_t a, uint32_t b) { return ((u64)a * b) >> 32; }
}  // namespace chain
inline uint32_t add_cc(uint32_t a, uint32_t b) {
  return chain::put((u64)a + b, true);
}
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
  return chain::put((u64)a + b + chain::carry_flag, true);
}
inline uint32_t addc(uint32_t a, uint32_t b) {
  return chain::put((u64)a + b + chain::carry_flag, false);
}
inline uint32_t sub_cc(uint32_t a, uint32_t b) {
  return chain::take(a, b, 0u, true);
}
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  return chain::take(a, b, chain::carry_flag, true);
}
inline uint32_t subc(uint32_t a, uint32_t b) {
  return chain::take(a, b, chain::carry_flag, false);
}
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return chain::put(chain::lo(a, b) + c, true);
}
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return chain::put(chain::lo(a, b) + c + chain::carry_flag, true);
}
inline uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return chain::put(chain::hi(a, b) + c, true);
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return chain::put(chain::hi(a, b) + c + chain::carry_flag, true);
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  return chain::put(chain::hi(a, b) + c + chain::carry_flag, false);
}
#endif

// the high half of a * b
VG_FN uint32_t mul_hi(uint32_t a, uint32_t b) {
#ifdef __CUDACC__
  return __umulhi(a, b);
#else
  return (uint32_t)(((u64)a * b) >> 32);
#endif
}

// a + c 2^256 mod p, in place: c is 0 or 1, and where it is 1, a + 2^32 +
// 977 < 2^256 (each caller's c is a carry out of 2^256 that left a far
// below that).  With v = a + (2^32 + 977), carrying out of 2^256 exactly
// when a >= p: where either carries, the value less p is v (mod 2^256),
// otherwise a.
VG_FN void fe_reduce_once(uint32_t a[8], uint32_t c) {
  uint32_t v[8];
  v[0] = add_cc(a[0], 977u);
  v[1] = addc_cc(a[1], 1u);
#pragma unroll
  for (int i = 2; i < 8; i++) v[i] = addc_cc(a[i], 0u);
  const uint32_t m = 0u - addc(c, 0u);  // all ones when the value >= p
#pragma unroll
  for (int i = 0; i < 8; i++) a[i] = (v[i] & m) | (a[i] & ~m);
}

// a < 2^256 -> a mod p
VG_FN void fe_normalize(uint32_t a[8]) { fe_reduce_once(a, 0u); }

// r = a - b mod p (a, b canonical).  On borrow the wrapped difference is
// a - b + 2^256; adding p is subtracting 2^32 + 977, which cannot borrow.
VG_FN void fe_sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  r[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < 8; i++) r[i] = subc_cc(a[i], b[i]);
  const uint32_t m = subc(0u, 0u);  // all ones on borrow
  r[0] = sub_cc(r[0], m & 977u);
  r[1] = subc_cc(r[1], m & 1u);
#pragma unroll
  for (int i = 2; i < 7; i++) r[i] = subc_cc(r[i], 0u);
  r[7] = subc(r[7], 0u);
}

// r = a + b mod p (a, b canonical).  A carry out of 2^256 leaves a sum
// below 2^256 - 2^33, which fe_reduce_once takes.
VG_FN void fe_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  r[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < 8; i++) r[i] = addc_cc(a[i], b[i]);
  fe_reduce_once(r, addc(0u, 0u));
}

// r = -a mod p, canonical (-0 = 0), so r[0] & 1 is the parity of -a.
VG_FN void fe_neg(uint32_t r[8], const uint32_t a[8]) {
  const uint32_t m = fe_is_zero(a) ? 0u : ~0u;
  r[0] = sub_cc(0xFFFFFC2Fu, a[0]);
  r[1] = subc_cc(0xFFFFFFFEu, a[1]);
#pragma unroll
  for (int i = 2; i < 7; i++) r[i] = subc_cc(~0u, a[i]);
  r[7] = subc(~0u, a[7]);
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] &= m;
}

// r = a * k mod p for a small constant k < 2^16: the low halves of a[i] k,
// the high halves one limb up in a chain, then the top word (< 2^16)
// folded back as top * (2^32 + 977), whose carry out leaves a small value.
// r may alias a.
VG_FN void fe_mul_small(uint32_t r[8], const uint32_t a[8], uint32_t k) {
  uint32_t s[8];
#pragma unroll
  for (int i = 0; i < 8; i++) s[i] = a[i] * k;
  s[1] = mad_hi_cc(a[0], k, s[1]);
#pragma unroll
  for (int i = 2; i < 8; i++) s[i] = madc_hi_cc(a[i - 1], k, s[i]);
  const uint32_t top = madc_hi(a[7], k, 0u);
  s[0] = mad_lo_cc(top, 977u, s[0]);
  s[1] = addc_cc(s[1], top);
#pragma unroll
  for (int i = 2; i < 8; i++) s[i] = addc_cc(s[i], 0u);
  fe_reduce_once(s, addc(0u, 0u));
  fe_copy(r, s);
}

// acc[s..s+7] += a (b[j0] + b[j0 + 2] 2^64 + ...), four products whose
// halves fill two adjacent limbs each, in one chain; its carry into
// acc[s + 8]
VG_FN void mad_pairs(uint32_t acc[17], uint32_t a, const uint32_t b[8], int j0,
                     int s) {
  acc[s] = mad_lo_cc(a, b[j0], acc[s]);
  acc[s + 1] = madc_hi_cc(a, b[j0], acc[s + 1]);
#pragma unroll
  for (int j = j0 + 2; j < 8; j += 2) {
    acc[s + j - j0] = madc_lo_cc(a, b[j], acc[s + j - j0]);
    acc[s + j - j0 + 1] = madc_hi_cc(a, b[j], acc[s + j - j0 + 1]);
  }
  acc[s + 8] = addc(acc[s + 8], 0u);
}

// t = a * b, the 512-bit product in 16 limbs, by even and odd columns (as
// sppark's mul_n and cmad_n): the products a[i] b[j] with i + j even go to
// E, the others to O, each product's low half at limb i + j and its high
// half at i + j + 1, so a row's products of one parity fill eight
// consecutive limbs of their accumulator in one chain, two short chains a
// row.  No row writes below its own index, so limbs i - 1 and i of E + O
// are final once row i is done, and for odd i merged then: fewer
// accumulator words stay live.  The merge's carry waits in c between rows
// (a chain cannot span another chain) and is put back into the flag as c +
// (2^32 - 1) carries; the last eight limbs merge in one chain.
VG_FN void fe_mul_wide(uint32_t t[16], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t E[17], O[17];
#pragma unroll
  for (int k = 0; k < 17; k++) E[k] = O[k] = 0u;
  uint32_t c = 0u;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const int j = i & 1;  // b[j], b[j + 2], ... go to E, the others to O
    mad_pairs(E, a[i], b, j, i + j);
    mad_pairs(O, a[i], b, 1 - j, i + 1 - j);
    if (j == 1) {
      add_cc(c, ~0u);
      t[i - 1] = addc_cc(E[i - 1], O[i - 1]);
      t[i] = addc_cc(E[i], O[i]);
      c = addc(0u, 0u);
    }
  }
  add_cc(c, ~0u);
#pragma unroll
  for (int k = 8; k < 15; k++) t[k] = addc_cc(E[k], O[k]);
  t[15] = addc(E[15], O[15]);
}

// r = t mod p for any 512-bit t (16 limbs), canonical.  Fold 1: lo + hi *
// 977 + (hi << 32), in three chains (the low halves of hi * 977 with lo,
// their high halves one limb up, hi one limb up), leaves s < 2^256 and a
// top word T below 2^32 + 979, its bit 32 apart.  Fold 2 adds T (2^32 +
// 977) < 2^66 as three limbs; fe_reduce_once takes what carries out.
VG_FN void fe_reduce512(uint32_t r[8], const uint32_t t[16]) {
  uint32_t s[8];
  s[0] = mad_lo_cc(t[8], 977u, t[0]);
#pragma unroll
  for (int i = 1; i < 8; i++) s[i] = madc_lo_cc(t[8 + i], 977u, t[i]);
  uint32_t top = addc(0u, 0u);
  s[1] = mad_hi_cc(t[8], 977u, s[1]);
#pragma unroll
  for (int i = 2; i < 8; i++) s[i] = madc_hi_cc(t[7 + i], 977u, s[i]);
  top = madc_hi(t[15], 977u, top);  // at most 978
  s[1] = add_cc(s[1], t[8]);
#pragma unroll
  for (int i = 2; i < 8; i++) s[i] = addc_cc(s[i], t[7 + i]);
  top = addc_cc(top, t[15]);
  const uint32_t top_hi = addc(0u, 0u);
  // T (2^32 + 977) = top 977 + (top + 977 top_hi) 2^32 + top_hi 2^64, where
  // top + 977 top_hi cannot wrap: top_hi = 1 leaves top <= 978
  const uint32_t a1 = add_cc(mul_hi(top, 977u), top + 977u * top_hi);
  const uint32_t a2 = addc(top_hi, 0u);
  s[0] = add_cc(s[0], top * 977u);
  s[1] = addc_cc(s[1], a1);
  s[2] = addc_cc(s[2], a2);
#pragma unroll
  for (int i = 3; i < 8; i++) s[i] = addc_cc(s[i], 0u);
  fe_reduce_once(s, addc(0u, 0u));
  fe_copy(r, s);
}

// r = a * b mod p.  r may alias a or b.
VG_FN void fe_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t t[16];
  fe_mul_wide(t, a, b);
  fe_reduce512(r, t);
}

// r = a^2 mod p with 36 products: the 28 cross products a[i] a[j] (i < j)
// in rows of two chains, as fe_mul_wide's, doubled by a chain that adds
// the sum to itself (the sum is below 2^511, so nothing carries out), then
// the 8 squares a[i]^2 added in one chain, then the fold of fe_mul.  r may
// alias a.
VG_FN void fe_sqr(uint32_t r[8], const uint32_t a[8]) {
  uint32_t t[16];
  // row 0: a[0] a[1..7] into t[1..8]
#pragma unroll
  for (int j = 1; j < 8; j++) t[j] = a[0] * a[j];
  t[2] = mad_hi_cc(a[0], a[1], t[2]);
#pragma unroll
  for (int j = 2; j < 7; j++) t[j + 1] = madc_hi_cc(a[0], a[j], t[j + 1]);
  t[8] = madc_hi(a[0], a[7], 0u);
  // rows 1 to 6: a[i] a[i+1..7] into t[2i+1..i+8]
#pragma unroll
  for (int i = 1; i < 7; i++) {
    t[2 * i + 1] = mad_lo_cc(a[i], a[i + 1], t[2 * i + 1]);
#pragma unroll
    for (int j = i + 2; j < 8; j++) t[i + j] = madc_lo_cc(a[i], a[j], t[i + j]);
    t[i + 8] = addc(0u, 0u);
    if (i < 6) {
      t[2 * i + 2] = mad_hi_cc(a[i], a[i + 1], t[2 * i + 2]);
#pragma unroll
      for (int j = i + 2; j < 7; j++)
        t[i + j + 1] = madc_hi_cc(a[i], a[j], t[i + j + 1]);
      t[i + 8] = madc_hi(a[i], a[7], t[i + 8]);
    } else {
      t[14] += mul_hi(a[6], a[7]);  // a one-product row: no chain
    }
  }
  // doubled: the cross products fill t[1..14]; t[0] and t[15], not yet
  // written, are set below
  t[1] = add_cc(t[1], t[1]);
#pragma unroll
  for (int i = 2; i < 15; i++) t[i] = addc_cc(t[i], t[i]);
  t[15] = addc(0u, 0u);
  // plus the squares
  t[0] = a[0] * a[0];
  t[1] = mad_hi_cc(a[0], a[0], t[1]);
#pragma unroll
  for (int i = 1; i < 7; i++) {
    t[2 * i] = madc_lo_cc(a[i], a[i], t[2 * i]);
    t[2 * i + 1] = madc_hi_cc(a[i], a[i], t[2 * i + 1]);
  }
  t[14] = madc_lo_cc(a[7], a[7], t[14]);
  t[15] = madc_hi(a[7], a[7], t[15]);
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
