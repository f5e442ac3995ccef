// Keccak-f[1600] on 25 64-bit lanes, per thread, and the Ethereum account
// keccak256(x || y)[12:32] of a public key.  The TPU emulated the 64-bit
// lanes as 32-bit hi/lo pairs; here a lane is a uint64_t and a rotate
// lowers to two funnel shifts.  The 24 rounds run as a loop (the round
// constant read from constant memory); within a round every lane index
// and rotation is a compile-time constant, so the state stays in
// registers.
#pragma once

#include "ripemd160.cuh"

namespace vg {

VG_CONSTANT uint64_t KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

VG_FN uint64_t rotl64(uint64_t x, int n) {
  return n == 0 ? x : (x << n) | (x >> (64 - n));
}

// The permutation of a[25], lane x + 5y.
VG_FN void keccak_f1600(uint64_t a[25]) {
  // rho offset of lane x + 5y
  constexpr int kRot[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                            25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
#pragma unroll 1
  for (int r = 0; r < 24; r++) {
    uint64_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; x++) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; x++) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d;
    }
    // rho and pi: lane (x, y) moves to (y, 2x + 3y)
#pragma unroll
    for (int x = 0; x < 5; x++) {
#pragma unroll
      for (int y = 0; y < 5; y++) {
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], kRot[x + 5 * y]);
      }
    }
    // chi and iota
#pragma unroll
    for (int y = 0; y < 5; y++) {
#pragma unroll
      for (int x = 0; x < 5; x++) {
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
      }
    }
    a[0] ^= KECCAK_RC[r];
  }
}

// Lanes 0..3 of a 32-byte big-endian value in 8 little-endian 32-bit limbs
// (v[7] the most significant): lane j holds bytes 8j..8j+7 little-endian,
// so its low half is bswap32(v[7 - 2j]) and its high half bswap32(v[6 - 2j]).
VG_FN void keccak_lanes_be32(uint64_t lanes[4], const uint32_t v[8]) {
#pragma unroll
  for (int j = 0; j < 4; j++) {
    lanes[j] = ((uint64_t)bswap32(v[6 - 2 * j]) << 32) | bswap32(v[7 - 2 * j]);
  }
}

// h = the Ethereum account keccak256(x_be || y_be)[12:32] as 5 big-endian
// words: lanes 0-3 x, 4-7 y, the 0x01 pad at byte 64 (lane 8), the 0x80
// pad at byte 135 (lane 16's top bit).  The account is digest bytes
// 12..31: the high half of lane 1, then lanes 2 and 3.
VG_FN void eth_account(uint32_t h[5], const uint32_t x[8], const uint32_t y[8]) {
  uint64_t a[25];
  keccak_lanes_be32(a, x);
  keccak_lanes_be32(a + 4, y);
  a[8] = 0x01ull;
#pragma unroll
  for (int i = 9; i < 25; i++) a[i] = 0ull;
  a[16] = 0x8000000000000000ull;
  keccak_f1600(a);
  h[0] = bswap32((uint32_t)(a[1] >> 32));
  h[1] = bswap32((uint32_t)a[2]);
  h[2] = bswap32((uint32_t)(a[2] >> 32));
  h[3] = bswap32((uint32_t)a[3]);
  h[4] = bswap32((uint32_t)(a[3] >> 32));
}

}  // namespace vg
