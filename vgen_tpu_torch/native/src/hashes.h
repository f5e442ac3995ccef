// SHA-256, RIPEMD-160, Keccak-256 for the native CPU scanner.
//
// Counterparts of the device kernels (vgen_tpu/ops/sha256.py /
// ripemd160.py / keccak.py; reference shaders/sha256.wgsl,
// ripemd160.wgsl).  Spec implementations, no lookup-table tricks.
#pragma once

#include <cstdint>
#include <cstring>

namespace vgen {

using u8 = std::uint8_t;
using u32 = std::uint32_t;
using u64b = std::uint64_t;

// ---------------------------------------------------------------- SHA-256

inline u32 rotr32(u32 x, int n) { return (x >> n) | (x << (32 - n)); }

static const u32 SHA256_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline void sha256_compress(u32 h[8], const u8 block[64]) {
  u32 w[64];
  for (int i = 0; i < 16; i++) {
    w[i] = ((u32)block[4 * i] << 24) | ((u32)block[4 * i + 1] << 16) |
           ((u32)block[4 * i + 2] << 8) | block[4 * i + 3];
  }
  for (int i = 16; i < 64; i++) {
    u32 s0 = rotr32(w[i - 15], 7) ^ rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3);
    u32 s1 = rotr32(w[i - 2], 17) ^ rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  u32 a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6],
      hh = h[7];
  for (int i = 0; i < 64; i++) {
    u32 S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    u32 ch = (e & f) ^ (~e & g);
    u32 t1 = hh + S1 + ch + SHA256_K[i] + w[i];
    u32 S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    u32 maj = (a & b) ^ (a & c) ^ (b & c);
    u32 t2 = S0 + maj;
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
  h[5] += f;
  h[6] += g;
  h[7] += hh;
}

inline void sha256(u8 out[32], const u8* msg, size_t len) {
  u32 h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
              0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  size_t i = 0;
  for (; i + 64 <= len; i += 64) sha256_compress(h, msg + i);
  u8 block[128] = {0};
  size_t rem = len - i;
  std::memcpy(block, msg + i, rem);
  block[rem] = 0x80;
  size_t blocks = (rem + 9 <= 64) ? 1 : 2;
  u64b bits = (u64b)len * 8;
  for (int j = 0; j < 8; j++) {
    block[blocks * 64 - 1 - j] = (u8)(bits >> (8 * j));
  }
  sha256_compress(h, block);
  if (blocks == 2) sha256_compress(h, block + 64);
  for (int j = 0; j < 8; j++) {
    out[4 * j] = (u8)(h[j] >> 24);
    out[4 * j + 1] = (u8)(h[j] >> 16);
    out[4 * j + 2] = (u8)(h[j] >> 8);
    out[4 * j + 3] = (u8)h[j];
  }
}

// ------------------------------------------------------------- RIPEMD-160

inline u32 rotl32(u32 x, int n) { return (x << n) | (x >> (32 - n)); }

inline void ripemd160(u8 out[20], const u8* msg, size_t len) {
  static const int R1[80] = {
      0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
      7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
      3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
      1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
      4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13};
  static const int R2[80] = {
      5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
      6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
      15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
      8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
      12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11};
  static const int S1[80] = {
      11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
      7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
      11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
      11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
      9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6};
  static const int S2[80] = {
      8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
      9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
      9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
      15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
      8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11};
  static const u32 K1[5] = {0, 0x5a827999, 0x6ed9eba1, 0x8f1bbcdc,
                            0xa953fd4e};
  static const u32 K2[5] = {0x50a28be6, 0x5c4dd124, 0x6d703ef3, 0x7a6d76e9,
                            0};
  auto f = [](int j, u32 x, u32 y, u32 z) -> u32 {
    if (j < 16) return x ^ y ^ z;
    if (j < 32) return (x & y) | (~x & z);
    if (j < 48) return (x | ~y) ^ z;
    if (j < 64) return (x & z) | (y & ~z);
    return x ^ (y | ~z);
  };
  u32 h[5] = {0x67452301, 0xefcdab89, 0x98badcfe, 0x10325476, 0xc3d2e1f0};
  // padding
  u8 block[128] = {0};
  size_t full = len / 64;
  for (size_t bi = 0; bi < full; bi++) {
    // compress from msg directly
    const u8* p = msg + bi * 64;
    u32 x[16];
    for (int i = 0; i < 16; i++) {
      x[i] = (u32)p[4 * i] | ((u32)p[4 * i + 1] << 8) |
             ((u32)p[4 * i + 2] << 16) | ((u32)p[4 * i + 3] << 24);
    }
    u32 a1 = h[0], b1 = h[1], c1 = h[2], d1 = h[3], e1 = h[4];
    u32 a2 = a1, b2 = b1, c2 = c1, d2 = d1, e2 = e1;
    for (int j = 0; j < 80; j++) {
      u32 t = rotl32(a1 + f(j, b1, c1, d1) + x[R1[j]] + K1[j / 16], S1[j]) +
              e1;
      a1 = e1;
      e1 = d1;
      d1 = rotl32(c1, 10);
      c1 = b1;
      b1 = t;
      t = rotl32(a2 + f(79 - j, b2, c2, d2) + x[R2[j]] + K2[j / 16], S2[j]) +
          e2;
      a2 = e2;
      e2 = d2;
      d2 = rotl32(c2, 10);
      c2 = b2;
      b2 = t;
    }
    u32 t = h[1] + c1 + d2;
    h[1] = h[2] + d1 + e2;
    h[2] = h[3] + e1 + a2;
    h[3] = h[4] + a1 + b2;
    h[4] = h[0] + b1 + c2;
    h[0] = t;
  }
  size_t rem = len - full * 64;
  std::memcpy(block, msg + full * 64, rem);
  block[rem] = 0x80;
  size_t blocks = (rem + 9 <= 64) ? 1 : 2;
  u64b bits = (u64b)len * 8;
  for (int j = 0; j < 8; j++) {
    block[blocks * 64 - 8 + j] = (u8)(bits >> (8 * j));  // little-endian
  }
  for (size_t bi = 0; bi < blocks; bi++) {
    const u8* p = block + bi * 64;
    u32 x[16];
    for (int i = 0; i < 16; i++) {
      x[i] = (u32)p[4 * i] | ((u32)p[4 * i + 1] << 8) |
             ((u32)p[4 * i + 2] << 16) | ((u32)p[4 * i + 3] << 24);
    }
    u32 a1 = h[0], b1 = h[1], c1 = h[2], d1 = h[3], e1 = h[4];
    u32 a2 = a1, b2 = b1, c2 = c1, d2 = d1, e2 = e1;
    for (int j = 0; j < 80; j++) {
      u32 t = rotl32(a1 + f(j, b1, c1, d1) + x[R1[j]] + K1[j / 16], S1[j]) +
              e1;
      a1 = e1;
      e1 = d1;
      d1 = rotl32(c1, 10);
      c1 = b1;
      b1 = t;
      t = rotl32(a2 + f(79 - j, b2, c2, d2) + x[R2[j]] + K2[j / 16], S2[j]) +
          e2;
      a2 = e2;
      e2 = d2;
      d2 = rotl32(c2, 10);
      c2 = b2;
      b2 = t;
    }
    u32 t = h[1] + c1 + d2;
    h[1] = h[2] + d1 + e2;
    h[2] = h[3] + e1 + a2;
    h[3] = h[4] + a1 + b2;
    h[4] = h[0] + b1 + c2;
    h[0] = t;
  }
  for (int i = 0; i < 5; i++) {
    out[4 * i] = (u8)h[i];
    out[4 * i + 1] = (u8)(h[i] >> 8);
    out[4 * i + 2] = (u8)(h[i] >> 16);
    out[4 * i + 3] = (u8)(h[i] >> 24);
  }
}

inline void hash160(u8 out[20], const u8* msg, size_t len) {
  u8 sha[32];
  sha256(sha, msg, len);
  ripemd160(out, sha, 32);
}

// ------------------------------------------------------------- Keccak-256

inline u64b rotl64(u64b x, int n) { return (x << n) | (x >> (64 - n)); }

inline void keccak_f(u64b st[25]) {
  static const u64b RC[24] = {
      0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
      0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
      0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
      0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
      0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
      0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
      0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
      0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};
  static const int ROTC[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2, 14,
                               27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  static const int PILN[24] = {10, 7,  11, 17, 18, 3,  5,  16, 8,  21, 24, 4,
                               15, 23, 19, 13, 12, 2,  20, 14, 22, 9,  6,  1};
  for (int rnd = 0; rnd < 24; rnd++) {
    u64b bc[5];
    for (int x = 0; x < 5; x++)
      bc[x] = st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20];
    for (int x = 0; x < 5; x++) {
      u64b t = bc[(x + 4) % 5] ^ rotl64(bc[(x + 1) % 5], 1);
      for (int y = 0; y < 25; y += 5) st[y + x] ^= t;
    }
    u64b t = st[1];
    for (int i = 0; i < 24; i++) {
      int j = PILN[i];
      u64b tmp = st[j];
      st[j] = rotl64(t, ROTC[i]);
      t = tmp;
    }
    for (int y = 0; y < 25; y += 5) {
      u64b b0 = st[y], b1 = st[y + 1], b2 = st[y + 2], b3 = st[y + 3],
           b4 = st[y + 4];
      st[y] = b0 ^ (~b1 & b2);
      st[y + 1] = b1 ^ (~b2 & b3);
      st[y + 2] = b2 ^ (~b3 & b4);
      st[y + 3] = b3 ^ (~b4 & b0);
      st[y + 4] = b4 ^ (~b0 & b1);
    }
    st[0] ^= RC[rnd];
  }
}

inline void keccak256(u8 out[32], const u8* msg, size_t len) {
  u64b st[25] = {0};
  const size_t rate = 136;  // 1088-bit rate
  size_t i = 0;
  auto absorb_block = [&](const u8* p) {
    for (size_t j = 0; j < rate / 8; j++) {
      u64b v = 0;
      for (int k = 7; k >= 0; k--) v = (v << 8) | p[8 * j + k];
      st[j] ^= v;
    }
    keccak_f(st);
  };
  for (; i + rate <= len; i += rate) absorb_block(msg + i);
  u8 last[136] = {0};
  std::memcpy(last, msg + i, len - i);
  last[len - i] ^= 0x01;  // Keccak (pre-SHA3) domain padding
  last[rate - 1] ^= 0x80;
  absorb_block(last);
  for (int j = 0; j < 4; j++) {
    u64b v = st[j];
    for (int k = 0; k < 8; k++) out[8 * j + k] = (u8)(v >> (8 * k));
  }
}

}  // namespace vgen
