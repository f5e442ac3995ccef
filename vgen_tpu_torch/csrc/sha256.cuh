// SHA-256 of a 33-byte compressed public key (parity || x big-endian) or a
// 65-byte uncompressed one (04 || x || y), with the message schedule built
// straight from 8 x 32-bit limbs, and the P2SH-P2WPKH script hash.  The 64
// rounds are unrolled; the constant schedule words (padding and length) are
// folded by the compiler.
#pragma once

#include "field.cuh"
#include "ripemd160.cuh"

namespace vg {

VG_CONSTANT uint32_t SHA256_K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};

VG_FN uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

// One compression of w[16] into st[8] (st is updated in place).
VG_FN void sha256_compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; t++) {
    if (t >= 16) {
      const uint32_t w15 = w[(t - 15) & 15];
      const uint32_t w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + SHA256_K[t] + w[t & 15];
    const uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

VG_FN void sha256_init(uint32_t st[8]) {
  st[0] = 0x6A09E667u;
  st[1] = 0xBB67AE85u;
  st[2] = 0x3C6EF372u;
  st[3] = 0xA54FF53Au;
  st[4] = 0x510E527Fu;
  st[5] = 0x9B05688Cu;
  st[6] = 0x1F83D9ABu;
  st[7] = 0x5BE0CD19u;
}

// st = SHA-256(parity || x big-endian) as 8 big-endian state words.
// x[7] is the most significant limb: word 0 is the parity byte and x's top
// three bytes, words 1..7 straddle two limbs by 8 bits, word 8 is x's last
// byte and the 0x80 pad, word 15 the bit length 264.
VG_FN void sha256_x33(uint32_t st[8], const uint32_t x[8], uint32_t parity) {
  uint32_t w[16];
  w[0] = (parity << 24) | (x[7] >> 8);
#pragma unroll
  for (int i = 1; i < 8; i++) w[i] = (x[8 - i] << 24) | (x[7 - i] >> 8);
  w[8] = (x[0] << 24) | 0x00800000u;
#pragma unroll
  for (int i = 9; i < 15; i++) w[i] = 0u;
  w[15] = 264u;
  sha256_init(st);
  sha256_compress(st, w);
}

// st = SHA-256(04 || x || y big-endian): two compressions.  Block 1: word 0
// is 0x04 and x's top three bytes, words 1..7 straddle x's limbs by 8 bits,
// word 8 is x's last byte and y's top three, words 9..15 straddle y's
// limbs.  Block 2: y's last byte, the 0x80 pad, the bit length 520.
VG_FN void sha256_x65(uint32_t st[8], const uint32_t x[8], const uint32_t y[8]) {
  uint32_t w[16];
  w[0] = (0x04u << 24) | (x[7] >> 8);
#pragma unroll
  for (int i = 1; i < 8; i++) w[i] = (x[8 - i] << 24) | (x[7 - i] >> 8);
  w[8] = (x[0] << 24) | (y[7] >> 8);
#pragma unroll
  for (int i = 1; i < 8; i++) w[8 + i] = (y[8 - i] << 24) | (y[7 - i] >> 8);
  sha256_init(st);
  sha256_compress(st, w);
  w[0] = (y[0] << 24) | 0x00800000u;
#pragma unroll
  for (int i = 1; i < 15; i++) w[i] = 0u;
  w[15] = 520u;
  sha256_compress(st, w);
}

// out = hash160(00 14 || h), the P2SH-P2WPKH redeem script's hash of a key
// hash h[5] (big-endian words): one compression of the 22-byte script (the
// 0x80 pad at byte 22, bit length 176), then RIPEMD-160.  out may alias h.
VG_FN void script_hash(uint32_t out[5], const uint32_t h[5]) {
  uint32_t w[16], st[8];
  w[0] = 0x00140000u | (h[0] >> 16);
#pragma unroll
  for (int i = 1; i < 5; i++) w[i] = (h[i - 1] << 16) | (h[i] >> 16);
  w[5] = (h[4] << 16) | 0x8000u;
#pragma unroll
  for (int i = 6; i < 15; i++) w[i] = 0u;
  w[15] = 176u;
  sha256_init(st);
  sha256_compress(st, w);
  ripemd160_sha_state(out, st);
}

}  // namespace vg
