// Address symbols, per thread: Base58Check for P2PKH (version byte 0) and
// bech32 for P2WPKH (witness version 0) from a hash160, bech32m for P2TR
// (witness version 1) from the output key's x.  The symbols are digit
// values in the format's alphabet, the input of the DFA walk (dfa.cuh), as
// vgen_tpu/ops/encode.py emits them; no ASCII is formed.
//
// Like the other headers this compiles as plain C++ too.
#pragma once

#include "sha256.cuh"

namespace vg {

constexpr int kBase58Syms = 34;  // symbols of a version-0 Base58Check address
constexpr int kBech32Syms = 39;  // [witver] + 32 groups + 6 checksum symbols
constexpr int kBech32mSyms = 59;  // [witver 1] + 52 groups + 6 checksum symbols
constexpr unsigned long long kB58Pow5 = 656356768ull;  // 58^5 < 2^32

// First big-endian word of SHA256d(version || h160): the four Base58Check
// checksum bytes.  h[5] is the hash160 as big-endian words.
VG_FN uint32_t base58check_checksum(uint32_t version, const uint32_t h[5]) {
  uint32_t w[16], st[8];
  w[0] = (version << 24) | (h[0] >> 8);
#pragma unroll
  for (int i = 1; i < 5; i++) w[i] = (h[i - 1] << 24) | (h[i] >> 8);
  w[5] = (h[4] << 24) | 0x00800000u;
#pragma unroll
  for (int i = 6; i < 15; i++) w[i] = 0u;
  w[15] = 168u;  // 21 bytes
  sha256_init(st);
  sha256_compress(st, w);
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = st[i];
  w[8] = 0x80000000u;
#pragma unroll
  for (int i = 9; i < 15; i++) w[i] = 0u;
  w[15] = 256u;
  sha256_init(st);
  sha256_compress(st, w);
  return st[0];
}

// Base58Check symbols of version || h160 || checksum, most significant
// first, with the reference's shift (vgen_tpu/ops/encode.py
// _base58_from_payload25): one digit 0 ('1') per leading zero byte of the
// 25-byte payload, then the significant digits, left-aligned and padded
// with 0.  Returns the length, 34 - (leading zero digits - leading zero
// bytes).
//
// The payload is a 200-bit number in 7 big-endian words (word 0 holds the
// version byte).  Each of 7 rounds divides it by 58^5 with 64-bit
// intermediates and splits the remainder into 5 digits; the 35th digit is
// 0 because the value is below 2^192 < 58^34 for version 0.
VG_FN int base58check_symbols(uint8_t syms[kBase58Syms], uint32_t version,
                              const uint32_t h[5]) {
  uint32_t n[7];
  n[0] = version;
#pragma unroll
  for (int i = 0; i < 5; i++) n[1 + i] = h[i];
  n[6] = base58check_checksum(version, h);
  // leading zero bytes of the payload (n[0] holds one byte)
  int z = 0;
  bool run = n[0] == 0u;
  z += run;
#pragma unroll
  for (int i = 1; i < 7; i++) {
#pragma unroll
    for (int sh = 24; sh >= 0; sh -= 8) {
      run = run && ((n[i] >> sh) & 0xFFu) == 0u;
      z += run;
    }
  }
  uint8_t d[35];  // least significant digit first
#pragma unroll
  for (int r = 0; r < 7; r++) {
    unsigned long long rem = 0;
#pragma unroll
    for (int i = 0; i < 7; i++) {
      const unsigned long long cur = (rem << 32) | n[i];
      const unsigned long long q = cur / kB58Pow5;
      n[i] = (uint32_t)q;
      rem = cur - q * kB58Pow5;
    }
    uint32_t rr = (uint32_t)rem;
#pragma unroll
    for (int j = 0; j < 5; j++) {
      const uint32_t q = rr / 58u;
      d[5 * r + j] = (uint8_t)(rr - q * 58u);
      rr = q;
    }
  }
  int k = 0;  // leading zero digits of the 34
  run = true;
#pragma unroll
  for (int j = 0; j < kBase58Syms; j++) {
    run = run && d[kBase58Syms - 1 - j] == 0;
    k += run;
  }
  const int shift = k - z;
#pragma unroll
  for (int j = 0; j < kBase58Syms; j++) {
    const int src = j + shift;
    syms[j] = src < kBase58Syms ? d[kBase58Syms - 1 - src] : (uint8_t)0;
  }
  return kBase58Syms - shift;
}

VG_CONSTANT uint32_t BECH32_GEN[5] = {0x3B6A57B2u, 0x26508E6Du, 0x1EA119FAu,
                                      0x3D4233DDu, 0x2A1462B3u};

// polymod state after the constant prefix: the expansion of hrp "bc" and
// witness version 0 (vgen_tpu/ops/encode.py _polymod_init("bc", 0))
constexpr uint32_t kBech32InitBcV0 = 0x3D5A5FD2u;
// ... and of "bc" with witness version 1 (_polymod_init("bc", 1))
constexpr uint32_t kBech32InitBcV1 = 0x3D5A5FD3u;
constexpr uint32_t kBech32mConst = 0x2BC830A3u;  // BIP350

VG_FN uint32_t bech32_polymod_step(uint32_t chk, uint32_t v) {
  const uint32_t top = chk >> 25;
  chk = ((chk & 0x1FFFFFFu) << 5) ^ v;
#pragma unroll
  for (int i = 0; i < 5; i++) chk ^= (0u - ((top >> i) & 1u)) & BECH32_GEN[i];
  return chk;
}

// bech32 symbols of a P2WPKH address after "bc1": witness version 0, the
// 160 bits of h[5] as 32 five-bit groups (most significant first; 160 is a
// multiple of 5, so there is no padding), and the 6 checksum symbols
// (bech32 constant 1).  Always 39 symbols.
VG_FN void bech32_p2wpkh_symbols(uint8_t syms[kBech32Syms],
                                 const uint32_t h[5]) {
  syms[0] = 0;
  uint32_t chk = kBech32InitBcV0;
#pragma unroll
  for (int g = 0; g < 32; g++) {
    const int o = 5 * g, i = o >> 5, s = o & 31;
    const unsigned long long two =
        ((unsigned long long)h[i] << 32) | (i + 1 < 5 ? h[i + 1] : 0u);
    const uint32_t v = (uint32_t)(two >> (59 - s)) & 31u;
    syms[1 + g] = (uint8_t)v;
    chk = bech32_polymod_step(chk, v);
  }
#pragma unroll
  for (int i = 0; i < 6; i++) chk = bech32_polymod_step(chk, 0u);
  chk ^= 1u;
#pragma unroll
  for (int i = 0; i < 6; i++) syms[33 + i] = (uint8_t)((chk >> (5 * (5 - i))) & 31u);
}

// bech32m symbols of a P2TR address after "bc1": witness version 1, the
// 256 bits of x (8 little-endian limbs, x[7] the most significant) as 52
// five-bit groups, most significant first, the last padded with 4 zero
// bits, and the 6 checksum symbols (bech32m constant).  Always 59 symbols.
VG_FN void bech32m_p2tr_symbols(uint8_t syms[kBech32mSyms], const uint32_t x[8]) {
  syms[0] = 1;
  uint32_t chk = kBech32InitBcV1;
#pragma unroll
  for (int g = 0; g < 52; g++) {
    const int o = 5 * g, i = o >> 5, s = o & 31;  // word i of x big-endian
    const unsigned long long two =
        ((unsigned long long)x[7 - i] << 32) | (i + 1 < 8 ? x[6 - i] : 0u);
    const uint32_t v = (uint32_t)(two >> (59 - s)) & 31u;
    syms[1 + g] = (uint8_t)v;
    chk = bech32_polymod_step(chk, v);
  }
#pragma unroll
  for (int i = 0; i < 6; i++) chk = bech32_polymod_step(chk, 0u);
  chk ^= kBech32mConst;
#pragma unroll
  for (int i = 0; i < 6; i++) syms[53 + i] = (uint8_t)((chk >> (5 * (5 - i))) & 31u);
}

}  // namespace vg
